"""The fp32 kernels that run on the tensor cores, checked on the CPU: kernel
14's fp32 forward (``csrc/flash_fwd_tf32.cu``, 3xTF32), kernels 15 and 16's
fp32 dq and dk/dv (``csrc/flash_bwd_tf32.cu``, 3xTF32) and kernel 20's
mma.sync instance (``csrc/wo_matmul.cu``, fp32 activations in 2xTF32).

The CUDA kernels cannot run here. What they add to the functions is a route
(``kernels.flash_attention._entry_suffix``, ``kernels.quant.wo_route``), a
geometry (``flash_fwd_fp32_plan`` and ``flash_bwd_fp32_plan``: which walk
the fp32 forward, dq and dk/dv take at each head dim, and the 3xTF32 walks'
tiles and shared memory; ``chip_smoke.py`` holds them equal to the kernels'
``ptt_flash_fwd_fp32_plan`` and ``ptt_flash_bwd_fp32_plan`` on the card) and
an arithmetic, which this file mirrors in PyTorch (``csrc/tf32.cuh``): each
fp32 operand split as ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (the kernels'
round-to-nearest, ties away, on the bits; kernel 20 passes ``x - hi`` whole
and the tensor core reads its top 19 bits), and each TF32 ``mma`` modelled
as its products summed exactly and the result added to the accumulator
with rounding toward zero, the tensor cores' fp32 accumulation. So:

- the TF32 rounding is checked on the bits (13 low bits zero, to nearest,
  ties away) and the split to within 2^-22 of x;
- the plans and the tiles ``flash_tile_shape`` reports at every head dim
  64-512, and the routes of every dtype x (K % 8, N % 16) case;
- emulations of the kernels' arithmetic (the forward's 64-row walk under
  the FlashMask tile classes, q k^T and P V in three passes, each 32
  keys' P V in a zeroed partial added to O, the online softmax in fp32;
  kernel 20's k16 blocks in two passes of split x, each block's partial
  added to the running sum) are held to the plain versions and to the JAX
  package (the Pallas forward in interpret mode, the XLA int8 composition)
  at the chip gates' own tolerances (``chip_smoke.FLASH_GATES["float32"]``:
  1e-5; kernel 20's 2^-16 of ``(|x| @ |w8|) * scale`` plus 1e-6), and the
  same emulations with one TF32 pass (hi only) are shown to fail them;
- the backward's arithmetic likewise (``emulate_bwd_tf32``: every operand
  split with lo = x - hi left whole, as kernel 20's x is; S, dP and their
  transposes over D with the cross terms and hi hi apart, exp, the mask and
  dS in fp32, dq, dk and dv summed a tile at a time in zeroed partials
  added to the accumulators), held to the JAX package's backward (the
  Pallas dq and dk/dv in interpret mode) and to the plain versions at the
  fp32 gate (rel L2 1e-5), and one pass shown to miss it;
- the truncating accumulation is shown to need the partials: chained
  through one accumulator over a 4096-key walk (or 4096 query rows of dk/dv)
  it misses the fp32 gate.
"""

from typing import Tuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import quant as jax_quant
from paddle_tpu.kernels.flash_attention import _pad_to, _run_bwd, _run_fwd

from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import quant as kquant

# chip_smoke.FLASH_GATES["float32"]: P's error over (P|v|)/l, out's over |out|, lse relative
P_REL, OUT_REL, LSE_REL = 1e-5, 1e-5, 1e-5
GRAD_REL_L2 = 1e-5  # chip_smoke.FLASH_GATES["float32"]: dq, dk, dv rel L2
WO_REL, WO_ABS = 2.0 ** -16, 1e-6  # chip_smoke.wo_case's fp32 gate
WO_BLOCK = 16  # csrc/wo_matmul.cu: each k16 block's fp32 products go into a partial added to the sum
MMA_K = 8  # the k of one m16n8k8 TF32 mma
PV_KEYS = 32  # csrc/flash_fwd_tf32.cu: each 32 keys' P V go into a partial added to O
_LOW = 0x1FFF  # the 13 significand bits a TF32 product ignores


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """The kernels' TF32 rounding of fp32 ``x`` (``csrc/tf32.cuh`` ``rna``, the
    rounding of ``cvt.rna.tf32.f32``): the nearest value with the low 13
    significand bits zero, ties away from zero (adding half of the dropped
    unit to the magnitude's bits carries into the exponent as it should);
    infinities and NaNs pass unchanged."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes fp32, not {x.dtype}")
    rounded = ((x.view(torch.int32) + 0x1000) & ~_LOW).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32_round(x)`` and ``lo = tf32_round(x -
    hi)``, both exact TF32 values held in fp32 (``csrc/tf32.cuh`` ``split``)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_split_hi(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/tf32.cuh`` ``split_hi`` as the tensor core reads it: ``hi =
    tf32_round(x)`` and ``x - hi`` with its low 13 bits dropped."""
    hi = tf32_round(x)
    return hi, ((x - hi).view(torch.int32) & ~_LOW).view(torch.float32)


def rz(x: torch.Tensor) -> torch.Tensor:
    """fp64 ``x`` rounded toward zero to fp32."""
    r = x.to(torch.float32)
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``acc + a @ b`` as TF32 ``mma`` steps over k (``a`` [..., M, k], ``b``
    [..., k, N], exact TF32 values): each step's products summed exactly,
    the result rounded toward zero to fp32."""
    for k0 in range(0, a.shape[-1], MMA_K):
        acc = rz(acc.double() + a[..., k0:k0 + MMA_K].double() @ b[..., k0:k0 + MMA_K, :].double())
    return acc


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


# -- the rounding and the split -----------------------------------------------------

def test_tf32_round_on_the_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12,
                      1.0 + 2.0**-10 + 2.0**-11, 3.0e38, float("inf"), -float("inf"), 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2 * 2.0**-10, -(1.0 + 2.0**-10), 1.0,
                         1.0 + 2 * 2.0**-10, float(np.float32(3.0e38)), float("inf"), -float("inf"), 0.0],
                        dtype=torch.float32)
    got = tf32_round(x)
    # ties go away from zero; 3e38 keeps its exponent
    assert torch.equal(got[[0, 1, 2, 3, 4, 5, 7, 8, 9]], want[[0, 1, 2, 3, 4, 5, 7, 8, 9]])
    assert abs(float(got[6]) - 3.0e38) <= 3.0e38 * 2.0**-11
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    with pytest.raises(TypeError):
        tf32_round(torch.zeros(2, dtype=torch.float64))


def test_split_keeps_what_the_tensor_core_reads_and_misses_by_2_pow_minus_22():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=100_000) * 10.0 ** rng.uniform(-20, 20, 100_000)).astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):  # both exact TF32 values: a TF32 mma reads them whole
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= x.abs() * 2.0**-11).all())  # half a TF32 unit
    miss = (x.double() - (hi.double() + lo.double())).abs()
    assert bool((miss <= x.abs().double() * 2.0**-22).all())
    assert bool((miss > 0).any())  # the split is not exact: what it drops is below the gates


# -- kernel 14 in fp32: plan, tiles, route --------------------------------------------

PLAN = {64: (64, 90112), 128: (32, 103424), 192: (32, 152576), 256: (32, 201728)}


@pytest.mark.parametrize("d", list(range(64, 513, 64)))
def test_fp32_forward_plan_and_tiles(d):
    p = kfa.flash_fwd_fp32_plan(d)
    if d <= 256:
        assert p["walk"] == "tf32x3" and p["rows"] == 64 and p["stages"] == 2
        assert (p["keys"], p["smem"]) == PLAN[d]
        # 64 keys where two CTAs fit an SM's 228 KB (1 KB each reserved), and a CTA within 227 KB
        two = 2 * (kfa._tf32_smem(d, 64) + 1024) <= 228 * 1024
        assert p["keys"] == (64 if two else 32) and p["smem"] <= 227 * 1024
        assert p["smem"] == 4 * (64 * (d + 8) + 2 * p["keys"] * (d + 8) + 2 * p["keys"] * (d + 4))
        assert kfa.flash_tile_shape("flash_fwd", d, torch.float32) == (64, p["keys"])
        assert kfa._entry_suffix("flash_fwd", torch.float32, d) == "tf32x3"
    else:  # the 3xTF32 walk's D / 2 accumulators a thread and its q, K, V would not fit: the CUDA cores
        assert p == {"walk": "cuda_cores"}
        assert 4 * (64 * (d + 8) + 2 * 32 * (d + 8) + 2 * 32 * (d + 4)) > 227 * 1024
        assert kfa.flash_tile_shape("flash_fwd", d, torch.float32) == (16, 32)
        assert kfa._entry_suffix("flash_fwd", torch.float32, d) == "fp32"
    # dq and dk/dv take the forward's route (test_fp32_backward_plan_and_tiles); nothing takes the scheduler's counter
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert kfa._entry_suffix(kernel, torch.float32, d) == kfa._entry_suffix("flash_fwd", torch.float32, d)
    assert kfa._sched(kfa._entry_suffix("flash_fwd", torch.float32, d), torch.device("cpu")) is None


@pytest.mark.parametrize("d", [0, 32, 100, 576])
def test_fp32_forward_plan_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        kfa.flash_fwd_fp32_plan(d)


# -- kernels 15 and 16 in fp32: plan, tiles, route -------------------------------------

# (kernel, D) -> (rows, keys, smem bytes, warps): dq's CTA rows and K/V tile keys; dk/dv's q/g tile rows and CTA keys
BWD_PLAN = {
    ("flash_bwd_dq", 64): (128, 32, 104448, 8), ("flash_bwd_dq", 128): (128, 32, 202752, 8),
    ("flash_bwd_dq", 192): (64, 32, 200704, 4), ("flash_bwd_dq", 256): (64, 16, 199680, 4),
    ("flash_bwd_dkv", 64): (64, 64, 121856, 8), ("flash_bwd_dkv", 128): (64, 64, 220160, 8),
    ("flash_bwd_dkv", 192): (32, 64, 209408, 8), ("flash_bwd_dkv", 256): (16, 64, 204032, 8),
}
BWD_PLAN_CASES = [(kernel, d) for kernel in ("flash_bwd_dq", "flash_bwd_dkv") for d in range(64, 513, 64)]


@pytest.mark.parametrize("kernel,d", BWD_PLAN_CASES, ids=[f"{k[10:]}-d{d}" for k, d in BWD_PLAN_CASES])
def test_fp32_backward_plan_and_tiles(kernel, d):
    """Up to 256 fp32 dq and dk/dv take ``csrc/flash_bwd_tf32.cu`` (suffix
    ``tf32x3``, no scheduler counter) on the plan's tiles; from 320 to 512
    the CUDA-core walks of ``csrc/flash_fp32.cu`` and their tiles."""
    p = kfa.flash_bwd_fp32_plan(d, kernel)
    suffix = kfa._entry_suffix(kernel, torch.float32, d)
    assert kfa._sched(suffix, torch.device("cpu")) is None
    if d > 256:
        assert p == {"walk": "cuda_cores"} and suffix == "fp32"
        assert kfa.flash_tile_shape(kernel, d, torch.float32) == ((32, 16) if kernel == "flash_bwd_dkv" else (16, 32))
        return
    assert p["walk"] == "tf32x3" and p["stages"] == 2 and suffix == "tf32x3"
    assert (p["rows"], p["keys"], p["smem"], p["warps"]) == BWD_PLAN[(kernel, d)]
    assert kfa.flash_tile_shape(kernel, d, torch.float32) == (p["rows"], p["keys"])
    assert p["smem"] <= 227 * 1024
    # tiles of whole m16n8k8 steps: a warp's 16 rows (dq) or keys (dk/dv), k steps of 8 over the tile
    assert p["rows"] % 8 == 0 and p["keys"] % 8 == 0
    if kernel == "flash_bwd_dq":
        assert p["rows"] == 16 * p["warps"]
        # q and g resident, two K and two V tiles, rows padded by 4 floats; the first shape that fits
        assert p["smem"] == 4 * (2 * p["rows"] + 4 * p["keys"]) * (d + 4)
        shapes = [(8, 32), (4, 32), (4, 16)]
        earlier = shapes[:shapes.index((p["warps"], p["keys"]))]
        assert all(4 * (32 * w + 4 * n) * (d + 4) > 227 * 1024 for w, n in earlier)
    else:
        assert p["keys"] == 64 == 16 * (p["warps"] // 2)  # two warpgroups over the same 64 keys
        rows = p["rows"]
        # K and V resident, two q and two g tiles, P^T, two lse and two delta rows; the most rows that fit
        assert p["smem"] == 4 * (2 * 64 * (d + 4) + 4 * rows * (d + 4) + 64 * rows + 4 * rows)
        assert rows == 64 or 4 * (2 * 64 * (d + 4) + 8 * rows * (d + 4) + 128 * rows + 8 * rows) > 227 * 1024


@pytest.mark.parametrize("kernel,d", [("flash_bwd_dq", 0), ("flash_bwd_dkv", 96), ("flash_bwd_dq", 576),
                                      ("flash_fwd", 128)])
def test_fp32_backward_plan_refuses_what_the_kernels_do_not_take(kernel, d):
    with pytest.raises(ValueError):
        kfa.flash_bwd_fp32_plan(d, kernel)


# -- kernel 14 in fp32: the arithmetic ----------------------------------------------------

def _qk(qs: torch.Tensor, kt: torch.Tensor, passes: int) -> torch.Tensor:
    """The kernel's S = (q * scale) K^T of one tile: ``passes`` 3 (lo hi +
    hi lo into one accumulator, hi hi into another, each chain over U
    interleaved k phases, summed at the end: the cross terms, the hi hi
    terms, then the two) or 1 (hi hi)."""
    d, bn = kt.shape
    u_phases = 1 if bn >= 64 or d > 128 else 2
    ah, al = tf32_split(qs)
    bh, bl = tf32_split(kt)
    zero = torch.zeros((qs.shape[0], bn))
    sc, sb = [zero] * u_phases, [zero] * u_phases
    for kk in range(d // MMA_K):
        u, ks = kk % u_phases, slice(MMA_K * kk, MMA_K * kk + MMA_K)
        if passes == 3:
            sc[u] = mma(mma(sc[u], al[:, ks], bh[ks]), ah[:, ks], bl[ks])
        sb[u] = mma(sb[u], ah[:, ks], bh[ks])
    c, h = sc[0], sb[0]
    for u in range(1, u_phases):
        c, h = c + sc[u], h + sb[u]
    return c + h if passes == 3 else h


def _pv_add(acc: torch.Tensor, p: torch.Tensor, v: torch.Tensor, passes: int, block: int = PV_KEYS,
            split=tf32_split) -> torch.Tensor:
    """``acc`` plus one key tile's P V as the kernel sums it: each ``block``
    keys into a zeroed partial (each k step's lo hi, hi lo, then hi hi with
    3 passes; hi hi with 1) added to ``acc`` in fp32 to nearest. ``p`` [...,
    M, keys], ``v`` [..., keys, N]; the backward's dq += dS K, dV += P^T g
    and dK += dS^T q are the same sum over a tile of keys or query rows,
    with both operands split by ``split_hi``."""
    ph, pl = split(p)
    vh, vl = split(v)
    for c0 in range(0, p.shape[-1], block):
        part = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + block, p.shape[-1]), MMA_K):
            ks = slice(k0, k0 + MMA_K)
            if passes == 3:
                part = mma(mma(part, pl[..., ks], vh[..., ks, :]), ph[..., ks], vl[..., ks, :])
            part = mma(part, ph[..., ks], vh[..., ks, :])
        acc = acc + part
    return acc


def emulate_fwd_tf32(q, k, v, bounds, causal, scale, passes=3):
    """The kernel's arithmetic: per (batch, head, 64-row tile) the key tiles
    of the plan's size from the first to the causal limit, SKIP tiles passed
    over, the mask on PARTIAL tiles only; S = (q * scale) K^T and P V each
    in ``passes`` TF32 passes of split operands; the online softmax in fp32
    with exp; P V's partials of 32 keys added to acc (fp32, to nearest); out
    = acc / l, lse = m + log(l), a row with nothing visible 0 and +inf."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    bm, bn = kfa.flash_tile_shape("flash_fwd", d, torch.float32)
    cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    out = torch.full(q.shape, float("nan"))
    lse = torch.full((b, h, sq), float("nan"))
    for bi in range(b):
        for hi in range(h):
            hm = hi if cls.shape[1] > 1 else 0
            qh = q[bi, :, hi] * scale
            kh, vh = k[bi, :, hi // (h // hk)], v[bi, :, hi // (h // hk)]
            for qt in range(cls.shape[2]):
                r0, r1 = qt * bm, min(qt * bm + bm, sq)
                hi_t = cls.shape[3]
                if causal:
                    lim = (qt + 1) * bm + sk - sq
                    hi_t = 0 if lim <= 0 else min(-(-lim // bn), hi_t)
                m = torch.full((r1 - r0, 1), float("-inf"))
                l = torch.zeros((r1 - r0, 1))
                acc = torch.zeros((r1 - r0, d))
                for t in range(hi_t):
                    kind = int(cls[min(bi, cls.shape[0] - 1), hm, qt, t])
                    if kind == kfa.SKIP:
                        continue
                    c0, c1 = t * bn, min(t * bn + bn, sk)
                    s = _qk(qh[r0:r1], kh[c0:c1].T.contiguous(), passes)
                    if kind == kfa.PARTIAL:
                        s = s.masked_fill(dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0,
                                                r0:r1, c0:c1], float("-inf"))
                    m_new = torch.maximum(m, s.amax(1, keepdim=True))
                    seen = m_new > float("-inf")
                    alpha = torch.where(seen, torch.exp(m - m_new), torch.ones_like(m))
                    p = torch.where(seen, torch.exp(s - m_new), torch.zeros_like(s))
                    l = l * alpha + p.sum(1, keepdim=True)
                    acc = _pv_add(acc * alpha, p, vh[c0:c1], passes)
                    m = m_new
                ok = l > 0
                out[bi, r0:r1, hi] = torch.where(ok, acc / l.clamp(min=1e-30), torch.zeros_like(acc))
                lse[bi, hi, r0:r1] = torch.where(ok, m + torch.log(l), torch.full_like(m, float("inf")))[:, 0]
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()  # every row written
    return out, lse


def _pallas_fwd(q, k, v, bounds, causal, blk=64):
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh = (jnp.moveaxis(jnp.asarray(x.numpy()), 2, 1) for x in (q, k, v))
    qp, kp, vp = (_pad_to(x, 2, blk) for x in (qh, kh, vh))
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds.numpy()), 2, blk)
    out, lse = _run_fwd(qp, kp, vp, idx, sq=sq, sk=sk, scale=1.0 / d**0.5, causal=causal, blk_q=blk, blk_k=blk,
                        interpret=True)
    return (torch.from_numpy(np.array(jnp.moveaxis(out[:, :, :sq], 1, 2))),
            torch.from_numpy(np.array(lse[:, :, :sq, 0])))


def _band_bounds(rng, s, c):
    """C=2 (a band of rows below the diagonal) or C=4 (and one above) bounds
    [1, 1, s, c] that keep every row's diagonal, as chip_smoke.band_bounds."""
    j = np.arange(s)
    start = np.minimum(j + 1 + rng.integers(0, 40, s), s)
    end = np.minimum(start + rng.integers(0, 60, s), s)
    cols = [start, end]
    if c == 4:
        ute = np.maximum(j - 1 - rng.integers(0, 40, s), 0)
        uts = np.maximum(ute - rng.integers(0, 60, s), 0)
        cols += [uts, ute]
    return torch.from_numpy(np.stack(cols, -1)[None, None].astype(np.int32).copy())


def _doc_bounds(rng, s):
    """C=1 causal document bounds [1, 1, s, 1]: each column's document end."""
    ends = np.zeros((1, 1, s, 1), np.int32)
    pos = 0
    while pos < s:
        end = min(s, pos + int(rng.integers(10, 40)))
        ends[0, 0, pos:end, 0] = end
        pos = end
    return torch.from_numpy(ends)


def _gate_ratio(out, lse, ref_out, ref_lse, spread):
    """The worst error over its limit of out (chip_smoke.flash_case's fp32
    gate) and of lse."""
    limit = P_REL * spread + OUT_REL * torch.maximum(out.abs(), ref_out.abs())
    out_ratio = float(((out - ref_out).abs() / limit.clamp(min=1e-30)).max())
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    lse_ratio = float(((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0))[fin].max()) / LSE_REL
    return out_ratio, lse_ratio


# (D, mask, causal, S, H/HK): the row's case's mask (C=2 causal band, GQA) and C=4, a document mask,
# ragged S, every head dim of the walk
FWD_CASES = [
    (64, "c2", True, 150, (4, 2)),
    (128, "c2", True, 130, (4, 1)),
    (128, "c4", False, 100, (2, 2)),
    (192, "doc", True, 90, (2, 1)),
    (256, None, True, 70, (2, 1)),
    (64, None, False, 65, (2, 2)),
]


@pytest.mark.parametrize("d,mask,causal,s,heads", FWD_CASES,
                         ids=[f"d{d}-{m}-{'causal' if c else 'full'}-s{s}-gqa{h[0]}_{h[1]}"
                              for d, m, c, s, h in FWD_CASES])
def test_three_pass_forward_meets_the_fp32_gate_and_one_pass_does_not(d, mask, causal, s, heads):
    rng = np.random.default_rng(d + s)
    h, hk = heads
    q = torch.from_numpy(rng.normal(size=(1, s, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, s, hk, d)).astype(np.float32)) for _ in range(2))
    bounds = _doc_bounds(rng, s) if mask == "doc" else None if mask is None else _band_bounds(rng, s, int(mask[1]))
    out, lse = emulate_fwd_tf32(q, k, v, bounds, causal, 1.0 / d**0.5)
    ref_out, ref_lse = kfa.flash_fwd_plain(q, k, v, bounds, causal)
    spread = kfa.flash_fwd_plain(q, k, v.abs(), bounds, causal)[0]
    out_r, lse_r = _gate_ratio(out, lse, ref_out, ref_lse, spread)
    assert out_r <= 1.0 and lse_r <= 1.0, (out_r, lse_r)
    if h == hk:  # the JAX Pallas forward (interpret mode) takes MHA
        out_j, lse_j = _pallas_fwd(q, k, v, bounds, causal)
        rows = torch.isfinite(lse_j)  # the Pallas kernel averages V on a fully masked row; the port writes 0
        assert torch.equal(rows, torch.isfinite(ref_lse))
        out_r, lse_r = _gate_ratio(out, lse, out_j, lse_j, spread)
        assert out_r <= 1.0 and lse_r <= 1.0, (out_r, lse_r)
    # one TF32 pass misses the gate: the split is what meets it
    out1, lse1 = emulate_fwd_tf32(q, k, v, bounds, causal, 1.0 / d**0.5, passes=1)
    assert max(_gate_ratio(out1, lse1, ref_out, ref_lse, spread)) > 1.0


# -- kernel 20's routes and its fp32 arithmetic -----------------------------------------

ROUTE_CASES = [(dtype, k, n) for dtype in (torch.bfloat16, torch.float16, torch.float32)
               for k in (4096, 4100) for n in (11008, 11000, 32003)]


@pytest.mark.parametrize("dtype,k,n", ROUTE_CASES,
                         ids=[f"{str(t)[6:]}-k{k}-n{n}" for t, k, n in ROUTE_CASES])
def test_wo_route_for_every_dtype_and_alignment(dtype, k, n):
    want = "wgmma" if dtype != torch.float32 and k % 8 == 0 and n % 16 == 0 else "mma_sync"
    for m in (1, 77, 512):
        assert kquant.wo_route(dtype, m, k, n) == want
    assert kquant.wo_route(dtype, 8, 0, 16) == "mma_sync"  # an empty contraction
    assert set(kquant._ROUTES) == {"wgmma", "mma_sync"}


def emulate_wo_mma(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Kernel 20's mma.sync instance in fp32: per k16 block, its two k8
    steps, each x's lo then hi times the int8 values (exact in TF32), into
    a zeroed partial (one pass: hi only), the partial added to the running
    sum (fp32, to nearest), then one multiply by the scale row. x is split
    as ``split_hi`` does (lo as the tensor core reads ``x - hi``)."""
    m, k = x.shape
    hi, lo = tf32_split_hi(x)
    w = w8.float()
    acc = torch.zeros((m, w8.shape[1]))
    for k0 in range(0, k, WO_BLOCK):
        part = torch.zeros_like(acc)
        for s0 in range(k0, min(k0 + WO_BLOCK, k), MMA_K):
            ks = slice(s0, s0 + MMA_K)
            if passes == 2:
                part = mma(part, lo[:, ks], w[ks])
            part = mma(part, hi[:, ks], w[ks])
        acc = acc + part
    return acc * scale[None, :]


@pytest.mark.parametrize("m,k,n", [(77, 4100, 300), (5, 36, 50), (130, 1024, 1001)],
                         ids=["ragged-k-n", "tiny", "ragged-n"])
def test_two_pass_wo_matmul_meets_the_fp32_gate_and_one_pass_does_not(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.normal(size=(k, n))).astype(np.float32))
    w8, scale = kquant.quantize_weight_int8(w)
    mag = (x.abs() @ w8.abs().float()) * scale[None, :]
    limit = WO_REL * mag + WO_ABS
    got = emulate_wo_mma(x, w8, scale)
    want = jax_quant.int8_weight_matmul(jnp.asarray(x.numpy()), jnp.asarray(w8.numpy()), jnp.asarray(scale.numpy()))
    for ref in (kquant.int8_weight_matmul_plain(x, w8, scale), torch.from_numpy(np.array(want))):
        assert float(((got - ref).abs() / limit).max()) <= 1.0
    one = emulate_wo_mma(x, w8, scale, passes=1)
    assert float(((one - kquant.int8_weight_matmul_plain(x, w8, scale)).abs() / limit).max()) > 1.0


def test_truncating_accumulation_needs_the_partials():
    """The tensor cores' fp32 accumulation rounds toward zero. Summed in one
    accumulator over a 4096-key walk (1536 mma of 3 passes) P V with V of
    mean 1 drifts past the fp32 gate; each 32 keys in a zeroed partial
    added to O to nearest, as ``csrc/flash_fwd_tf32.cu`` sums it, stays far
    inside."""
    rng = np.random.default_rng(7)
    keys = 4096
    p = torch.from_numpy(rng.uniform(0.0, 1.0, (16, keys)).astype(np.float32))
    # values of one sign, as a head's V columns with a mean, keep the sum growing: the bias adds up
    v = torch.from_numpy(rng.normal(1.0, 1.0, (keys, 64)).astype(np.float32))
    exact = p.double() @ v.double()
    spread = p.double() @ v.double().abs()  # P |v|: the gate's scale
    chained = torch.zeros((16, 64))
    ph, pl = tf32_split(p)
    vh, vl = tf32_split(v)
    for k0 in range(0, keys, MMA_K):
        ks = slice(k0, k0 + MMA_K)
        chained = mma(mma(mma(chained, pl[:, ks], vh[ks]), ph[:, ks], vl[ks]), ph[:, ks], vh[ks])
    tiled = _pv_add(torch.zeros((16, 64)), p, v, 3)
    miss = {name: float(((got.double() - exact).abs() / spread).max()) for name, got in
            (("chained", chained), ("tiled", tiled))}
    assert miss["chained"] > P_REL, miss
    assert miss["tiled"] < P_REL / 10, miss


# -- kernels 15 and 16 in fp32: the arithmetic ---------------------------------------------

def _over_d(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b^T`` (``a`` [..., M, D], ``b`` [..., N, D]) as the backward
    kernels take S = q K^T, dP = g V^T and their transposes K q^T, V g^T:
    both operands split by ``split_hi`` (lo = x - hi, read to its top 19
    bits), k steps of 8 in D's order; with 3 passes each step's lo hi then
    hi lo into one accumulator and hi hi into another, summed at the end
    (cross terms first); with 1 pass hi hi alone."""
    ah, al = tf32_split_hi(a)
    bh, bl = (x.transpose(-1, -2) for x in tf32_split_hi(b))
    cross = hh = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for k0 in range(0, a.shape[-1], MMA_K):
        ks = slice(k0, k0 + MMA_K)
        if passes == 3:
            cross = mma(mma(cross, al[..., ks], bh[..., ks, :]), ah[..., ks], bl[..., ks, :])
        hh = mma(hh, ah[..., ks], bh[..., ks, :])
    return cross + hh if passes == 3 else hh


def emulate_bwd_tf32(q, k, v, bounds, g, lse, delta, causal, scale, passes=3):
    """The fp32 dq and dk/dv kernels' arithmetic (``csrc/flash_bwd_tf32.cu``),
    ``(dq [B, Sq, H, D], dk, dv [B, Sk, HK, D])``, every operand split by
    ``split_hi``. dq: per key tile of the
    plan's keys, S = q K^T and dP = g V^T (:func:`_over_d`), P = exp(scale S
    - lse) and dS = P (dP - delta) scale in fp32, 0 where masked, then dq
    += dS K summed over the tile in a zeroed partial added to dq. dk/dv: per
    query head of each group in order and per query tile of the plan's
    rows, S^T = K q^T, P^T (0 where masked), dV += P^T g, dP^T = V g^T, dS^T
    = P^T (dP^T - delta) scale, dK += dS^T q, each sum over the tile in a
    zeroed partial. A tile the kernels skip (SKIP, or past the causal walk)
    is all masked here and adds exact zeros, and a row or key a tile holds
    is computed the same whichever query or key tile the kernel put it in:
    so every row (dq) and every key (dk/dv) is taken at once, and every
    tile is run with the dense mask."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    masked = kfa.flash_masked(sq, sk, causal, bounds, q.device).expand(b, h, sq, sk)
    qh, gh = q.transpose(1, 2), g.transpose(1, 2)  # [B, H, Sq, D]
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)  # [B, HK, Sk, D]
    kq, vq = kh.repeat_interleave(grp, 1), vh.repeat_interleave(grp, 1)  # [B, H, Sk, D]
    lse_r, dl_r = lse[..., None], delta[..., None]
    bn = kfa.flash_bwd_fp32_plan(d, "flash_bwd_dq")["keys"]
    dq = torch.zeros(qh.shape)
    for c0 in range(0, sk, bn):
        cs = slice(c0, c0 + bn)
        p = torch.exp(scale * _over_d(qh, kq[:, :, cs], passes) - lse_r)
        ds = (p * (_over_d(gh, vq[:, :, cs], passes) - dl_r) * scale).masked_fill(masked[..., cs], 0.0)
        dq = _pv_add(dq, ds, kq[:, :, cs], passes, block=bn, split=tf32_split_hi)
    bm = kfa.flash_bwd_fp32_plan(d, "flash_bwd_dkv")["rows"]
    dk, dv = torch.zeros(kh.shape), torch.zeros(vh.shape)
    for gi in range(grp):
        heads = slice(gi, h, grp)  # query head gi of every group: [B, HK, ...]
        for r0 in range(0, sq, bm):
            rs = slice(r0, r0 + bm)
            qt, gt = qh[:, heads, rs], gh[:, heads, rs]
            pt = torch.exp(scale * _over_d(kh, qt, passes) - lse[:, heads, None, rs])
            pt = pt.masked_fill(masked[:, heads, rs].transpose(-1, -2), 0.0)
            dv = _pv_add(dv, pt, gt, passes, block=bm, split=tf32_split_hi)
            dst = pt * (_over_d(vh, gt, passes) - delta[:, heads, None, rs]) * scale
            dk = _pv_add(dk, dst, qt, passes, block=bm, split=tf32_split_hi)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _pallas_bwd(q, k, v, g, bounds, causal, blk=64):
    """The JAX package's forward and backward (``_run_fwd``, ``_run_bwd``:
    the Pallas kernels in interpret mode, GQA groups summed by XLA) on the
    same inputs: out, lse, dq, dk, dv, as torch tensors in the port's
    layouts."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh, gh = (_pad_to(jnp.moveaxis(jnp.asarray(x.numpy()), 2, 1), 2, blk) for x in (q, k, v, g))
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds.numpy()), 2, blk)
    kw = dict(sq=sq, sk=sk, scale=1.0 / d**0.5, causal=causal, blk_q=blk, blk_k=blk, interpret=True)
    out, lse = _run_fwd(qh, kh, vh, idx, **kw)
    dq, dk, dv = _run_bwd(qh, kh, vh, idx, gh, out, lse, **kw)

    def back(x, s):
        return torch.from_numpy(np.array(jnp.moveaxis(x[:, :, :s], 1, 2)))

    return back(out, sq), torch.from_numpy(np.array(lse[:, :, :sq, 0])), back(dq, sq), back(dk, sk), back(dv, sk)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


# (D, mask, causal, S, H/HK): every head dim of the walks, the row's case's C=2 causal band under GQA, a document
# mask, C=4 without causal, ragged S
BWD_CASES = [
    (64, "c2", True, 150, (4, 2)),
    (128, "doc", True, 140, (4, 1)),
    (128, "c4", False, 100, (2, 2)),
    (192, "c2", True, 90, (2, 1)),
    (256, None, True, 70, (2, 1)),
]


@pytest.mark.parametrize("d,mask,causal,s,heads", BWD_CASES,
                         ids=[f"d{d}-{m}-{'causal' if c else 'full'}-s{s}-gqa{h[0]}_{h[1]}"
                              for d, m, c, s, h in BWD_CASES])
def test_three_pass_backward_meets_the_fp32_gate_and_one_pass_does_not(d, mask, causal, s, heads):
    rng = np.random.default_rng(3 * d + s)
    h, hk = heads
    q, g = (torch.from_numpy(rng.normal(size=(1, s, h, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, s, hk, d)).astype(np.float32)) for _ in range(2))
    bounds = _doc_bounds(rng, s) if mask == "doc" else None if mask is None else _band_bounds(rng, s, int(mask[1]))
    out_j, lse_j, dq_j, dk_j, dv_j = _pallas_bwd(q, k, v, g, bounds, causal)
    # the backward on the JAX forward's lse and delta, as _run_bwd computes them
    delta = (g * out_j).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, bounds, g, lse_j, delta, causal)
    got = emulate_bwd_tf32(*args, 1.0 / d**0.5)
    plain = (kfa.flash_bwd_dq_plain(*args), *kfa.flash_bwd_dkv_plain(*args))
    for name, x, want_j, want_p in zip(("dq", "dk", "dv"), got, (dq_j, dk_j, dv_j), plain):
        assert _rel_l2(x, want_j) <= GRAD_REL_L2, (name, _rel_l2(x, want_j))
        assert _rel_l2(x, want_p) <= GRAD_REL_L2, (name, _rel_l2(x, want_p))
    # one TF32 pass misses the gate: the split is what meets it
    one = emulate_bwd_tf32(*args, 1.0 / d**0.5, passes=1)
    assert max(_rel_l2(x, want) for x, want in zip(one, plain)) > GRAD_REL_L2


def test_backward_sums_need_the_partials():
    """dV = P^T g over a key's 4096 query rows (GQA 32/8 at [2, 1024]: the
    group's 4 heads x 1024 rows), with the tensor cores' truncating
    accumulation: chained through one accumulator it misses the fp32 gate;
    each 64-row tile (the plan's dk/dv tile at D 128) in a zeroed partial
    added to dV to nearest, as ``csrc/flash_bwd_tf32.cu`` sums it, stays far
    inside. dq's sum over keys (32-key partials) is the same sum."""
    rng = np.random.default_rng(11)
    rows = 4096
    pt = torch.from_numpy(rng.uniform(0.0, 1.0, (16, rows)).astype(np.float32))  # a warp's 16 keys' P^T
    g = torch.from_numpy(rng.normal(1.0, 1.0, (rows, 64)).astype(np.float32))
    exact = pt.double() @ g.double()
    spread = pt.double() @ g.double().abs()
    bm = kfa.flash_bwd_fp32_plan(128, "flash_bwd_dkv")["rows"]
    miss = {name: float(((got.double() - exact).abs() / spread).max()) for name, got in
            (("chained", _pv_add(torch.zeros((16, 64)), pt, g, 3, block=rows, split=tf32_split_hi)),
             ("tiled", _pv_add(torch.zeros((16, 64)), pt, g, 3, block=bm, split=tf32_split_hi)))}
    assert miss["chained"] > P_REL, miss
    assert miss["tiled"] < P_REL / 10, miss
