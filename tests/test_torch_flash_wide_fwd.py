"""The bf16 / fp16 flash forward above head dim 256 (kernel 14 on the tensor
cores, ``csrc/flash_fwd_wide.cu``), checked on the CPU.

The CUDA kernel cannot run here. What its launch adds to the function is a
route (``kernels.flash_attention._entry_suffix``: the forward above 256
takes the tensor cores, as dq and dk/dv do, ``csrc/flash_bwd_wide.cu``,
checked in ``tests/test_torch_flash_wide_bwd.py``), a tile walk (64 query
rows x 64 keys under the FlashMask tile classes) and a plan of O's columns
(``flash_fwd_wide_plan``: CTAs of two warpgroups over a query tile's D / 64
column boxes, 2 to 4 boxes a warpgroup, the split of least work, each
warpgroup recomputing the scores over all of D; Q resident in shared memory
up to D 1152, then streamed beside K). So:

- the route is checked for every head dim from 64 to 1024, each dtype and
  each kernel;
- the plan is checked at every multiple of 64 from 320 to 2048: every column
  box stored once, the box counts the kernel's instances take, the split of
  least work, shared memory within a block's 227 KB;
- a PyTorch emulation of the kernel's arithmetic (its walk, the scores
  summed over 128-column chunks, the online softmax in log2 units, P
  rounded to the input type, O assembled from the warpgroups' column
  blocks) is held against the Pallas kernel in interpret mode and the
  plain version.

``chip_smoke.py`` holds the kernel against the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import _pad_to, _run_fwd

from paddle_tpu_torch.kernels import flash_attention as kfa

LOG2E = 1.4426950408889634
BM = BN = 64  # the wide forward's tile


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


def test_entry_suffix_routes_the_wide_forward():
    """Above 256 the bf16 / fp16 forward takes the tensor-core entry at
    every head dim, and so do dq and dk/dv (``csrc/flash_bwd_wide.cu``, the
    same suffix); fp32 keeps the CUDA-core instances (to 512) and the
    runtime-D ones (above), except up to 256, where all three take the
    3xTF32 tensor-core entries (``csrc/flash_fwd_tf32.cu``,
    ``csrc/flash_bwd_tf32.cu``); bf16 / fp16 at D <= 256 are unchanged."""
    for d in range(64, 1025, 64):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16"), (torch.float32, "fp32")):
            fwd, dq, dkv = (kfa._entry_suffix(k, dtype, d) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            assert dq == dkv
            if d <= 256 and dtype == torch.float32:
                assert fwd == dq == "tf32x3"
            elif d <= 256:
                assert fwd == dq == name
            elif dtype == torch.float32:
                assert fwd == dq == ("fp32" if d <= 512 else "deep_fp32")
            else:
                assert fwd == dq == f"wgmma_wide_{name}"
            # the persistent kernels take the scheduler's counter, the fp32 instances none
            for suffix in (fwd, dq):
                assert (kfa._sched(suffix, torch.device("cpu")) is None) == (dtype == torch.float32)


def test_wide_forward_tile_shape():
    """The wide forward's walk classes 64 x 64 tiles, as the wide dq and
    dk/dv walks do above 256; up to 256 nothing changes."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in (320, 512, 576, 1024, 2048):
            assert kfa.flash_tile_shape("flash_fwd", d, dtype) == (BM, BN)
            assert kfa.flash_tile_shape("flash_bwd_dq", d, dtype) == (BM, BN)
            assert kfa.flash_tile_shape("flash_bwd_dkv", d, dtype) == (BM, BN)
        assert kfa.flash_tile_shape("flash_fwd", 256, dtype) == (128, 64)
    assert kfa.flash_tile_shape("flash_fwd", 512, torch.float32) == (16, 32)
    with pytest.raises(ValueError, match="above 256"):
        kfa.flash_fwd_wide_plan(256)
    with pytest.raises(ValueError, match="multiples of 64"):
        kfa.flash_fwd_wide_plan(352)


@pytest.mark.parametrize("d", list(range(320, 2049, 64)))
def test_wide_plan_owns_every_column_box_once(d):
    p = kfa.flash_fwd_wide_plan(d)
    boxes, nw, split = d // 64, p["nw"], p["split"]
    assert p["boxes"] == boxes and len(p["wg_boxes"]) == 2 * split
    assert nw in (2, 3, 4) and nw == -(-boxes // (2 * split))  # the kernel's instances: 2, 3 and 4 boxes
    nxt = 0
    for first, count in p["wg_boxes"]:
        # each warpgroup stores its own boxes and computes nw from its first (at most one of its neighbour's)
        assert first == nxt and nw - 1 <= count <= nw and first + nw <= boxes
        nxt = first + count
    assert nxt == boxes
    # the least work of any split: every warpgroup pays the scores over D and its nw boxes of P V
    costs = {sp: 2 * sp * (boxes + -(-boxes // (2 * sp))) for sp in range(-(-boxes // 8), (boxes + 1) // 2 + 1)}
    assert 2 * split * (boxes + nw) == min(costs.values())
    assert p["stream_q"] == (d > 1152)  # Q (64 rows x D) resident while 4 ring slots fit beside it
    assert 4 <= p["stages"] <= 8
    assert p["smem"] <= 227 * 1024
    if not p["stream_q"]:
        assert boxes * 64 * 128 + p["stages"] * 16384 < p["smem"]


def _pallas_fwd(q, k, v, bounds, causal, blk=64):
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh = (jnp.moveaxis(jnp.asarray(x.float().numpy()), 2, 1) for x in (q, k, v))
    qp, kp, vp = (_pad_to(x, 2, blk) for x in (qh, kh, vh))
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds.numpy()), 2, blk)
    out, lse = _run_fwd(qp, kp, vp, idx, sq=sq, sk=sk, scale=1.0 / d**0.5, causal=causal, blk_q=blk, blk_k=blk,
                        interpret=True)
    return (torch.from_numpy(np.array(jnp.moveaxis(out[:, :, :sq], 1, 2))),
            torch.from_numpy(np.array(lse[:, :, :sq, 0])))


def emulate_wide_fwd(q, k, v, bounds, causal, scale):
    """The kernel's arithmetic: per (batch, head, 64-row tile) and per
    warpgroup of the plan, the key tiles from the first to the causal limit,
    SKIP tiles passed over, the mask on PARTIAL tiles only; S in fp32 summed
    over 128-column chunks of D (a K slot each); the online softmax in log2
    units; P rounded to the input type for P V while l sums the fp32 p; the
    warpgroup's boxes of out = acc / l in the input type; lse = m + log(l)
    (the same in every warpgroup), a row with nothing visible 0 and +inf."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    plan = kfa.flash_fwd_wide_plan(d)
    cls = kfa.flash_tile_classes(bounds, sq, sk, BM, BN, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    out = torch.full(q.shape, float("nan"))
    lse = torch.full((b, h, sq), float("nan"))
    for bi in range(b):
        for hi in range(h):
            hm = hi if cls.shape[1] > 1 else 0
            qh, kh, vh = q[bi, :, hi].float(), k[bi, :, hi // (h // hk)].float(), v[bi, :, hi // (h // hk)].float()
            for qt in range(cls.shape[2]):
                r0, r1 = qt * BM, min(qt * BM + BM, sq)
                hi_t = cls.shape[3]
                if causal:
                    lim = (qt + 1) * BM + sk - sq
                    hi_t = 0 if lim <= 0 else min(-(-lim // BN), hi_t)
                for first, count in plan["wg_boxes"]:
                    c_lo, c_hi = 64 * first, 64 * (first + count)
                    m = torch.full((r1 - r0, 1), float("-inf"))
                    l = torch.zeros((r1 - r0, 1))
                    acc = torch.zeros((r1 - r0, c_hi - c_lo))
                    for t in range(hi_t):
                        kind = int(cls[min(bi, cls.shape[0] - 1), hm, qt, t])
                        if kind == kfa.SKIP:
                            continue
                        c0, c1 = t * BN, min(t * BN + BN, sk)
                        s = torch.zeros((r1 - r0, c1 - c0))
                        for x in range(0, d, 128):  # one K slot: two 64-column boxes
                            s = s + qh[r0:r1, x:x + 128] @ kh[c0:c1, x:x + 128].T
                        s = s * (scale * LOG2E)
                        if kind == kfa.PARTIAL:
                            s = s.masked_fill(dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0,
                                                    r0:r1, c0:c1], float("-inf"))
                        m_new = torch.maximum(m, s.amax(1, keepdim=True))
                        seen = m_new > float("-inf")
                        alpha = torch.where(seen, torch.exp2(m - m_new), torch.ones_like(m))
                        p = torch.where(seen, torch.exp2(s - m_new), torch.zeros_like(s))
                        l = l * alpha + p.sum(1, keepdim=True)
                        acc = acc * alpha + p.to(q.dtype).float() @ vh[c0:c1, c_lo:c_hi]
                        m = m_new
                    ok = l > 0
                    out[bi, r0:r1, hi, c_lo:c_hi] = torch.where(ok, acc / l.clamp(min=1e-30), torch.zeros_like(acc))
                    lse[bi, hi, r0:r1] = torch.where(ok, m / LOG2E + torch.log(l),
                                                     torch.full_like(m, float("inf")))[:, 0]
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()  # every column of every row written
    return out.to(q.dtype), lse


def _doc_bounds(rng, s):
    ends = np.zeros((1, 1, s, 1), np.int32)
    pos = 0
    while pos < s:
        end = min(s, pos + int(rng.integers(20, 120)))
        ends[0, 0, pos:end, 0] = end
        pos = end
    return torch.from_numpy(ends)


# P is rounded to the input type for P V: each p moves by at most one ulp of
# itself (bf16 2^-8, fp16 2^-11), out by that times (P|v|)/l, plus out's own
# rounding (one ulp of |out|)
ULP = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}
OUT_ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}

# (dtype, D, document mask, causal, S): two column blocks of 2 + 3 boxes (320),
# four CTAs' warpgroups (576), under causal and a C=1 document mask, ragged S
EMU_CASES = [
    (torch.bfloat16, 320, False, True, 150),
    (torch.float16, 320, True, True, 130),
    (torch.bfloat16, 576, True, True, 140),
    (torch.float16, 576, False, False, 70),
]


@pytest.mark.parametrize("dtype,d,doc,causal,s", EMU_CASES,
                         ids=[f"{str(t)[6:]}-d{d}-{'doc' if m else 'nomask'}-{'causal' if c else 'full'}-s{s}"
                              for t, d, m, c, s in EMU_CASES])
def test_emulated_wide_forward_matches_pallas_and_plain(dtype, d, doc, causal, s):
    rng = np.random.default_rng(d + s)
    q = torch.from_numpy(rng.normal(size=(1, s, 2, d)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.normal(size=(1, s, 1, d)).astype(np.float32)).to(dtype) for _ in range(2))
    bounds = _doc_bounds(rng, s) if doc else None
    out, lse = emulate_wide_fwd(q, k, v, bounds, causal, 1.0 / d**0.5)
    out_j, lse_j = _pallas_fwd(q, k, v, bounds, causal)
    out_p, lse_p = kfa.flash_fwd_plain(*(x.float() for x in (q, k, v)), bounds, causal)
    spread = kfa.flash_fwd_plain(q.float(), k.float(), v.float().abs(), bounds, causal)[0]
    limit = ULP[dtype] * spread + OUT_ULP[dtype] * out_p.abs() + 1e-6
    for want in (out_j, out_p):
        err = (out.float() - want).abs()
        assert bool((err <= limit).all()), f"worst err / limit {float((err / limit).max())}"
    for want in (lse_j, lse_p):
        assert bool(((lse - want).abs() <= 1e-5 * want.abs().clamp(min=1.0)).all())
