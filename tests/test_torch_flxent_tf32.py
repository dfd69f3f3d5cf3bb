"""The fp32 loss head's backward on the TF32 tensor cores, checked on the
CPU: the D recompute that kernels 18 and 19 share, dX (18) and dW (19) for
fp32 x and W on the 3xTF32 instance (``csrc/flxent_tf32.cu``), which the
CPU cannot run.

What the instance adds to the functions is a route, a walk and an
arithmetic:

- the route (``flx_route``, one for kernel 17 and the backward): in fp32
  ``"tf32x3"`` where the split pass can read W in 16-byte vectors (W
  16-byte aligned, rows a multiple of 4 floats), ``"cuda_cores"``
  elsewhere, chosen from the shapes before the launch; every dtype x
  alignment x layout case (kernel 17's TF32 forward:
  ``tests/test_torch_flxent_fwd_tf32.py``);
- the walk: each chunk of ``CHUNK`` columns in sub-chunks of
  ``flx_tf32_sub`` columns, in order, so that the operand planes stay below
  the ``[N, V]`` fp32 logits the unfused head holds; the sub-chunks cover
  every vocab column once and never straddle a chunk;
- the split pass (``tf32_planes``: hi and lo TF32 planes, K-major, of x,
  x^T and W's columns), whose plain version is checked on the bits;
- the arithmetic, emulated here with ``tests/test_torch_tf32_split.py``'s
  ``tf32_split`` and its model of a TF32 mma (each k8 step's products
  summed exactly, the sum added to the accumulator rounded toward zero):
  every product's operands split once, each k block of 32 summed into a
  zeroed cross-term partial (lo hi, then hi lo, each k8 step) and a zeroed
  hi hi partial, each added to the running sum in fp32 to nearest; D's
  exp in fp32; dX summed over the sub-chunks in order. The emulation is
  held to ``flxent_bwd_plain`` / ``flxent_dchunk_plain`` and to JAX's
  Pallas backward (``_make_pallas_core`` in interpret mode) at
  ``chip_smoke.py``'s fp32 gates (``FLXENT_ULP["float32"]`` = 2^-16, D's
  limit scaled by ``fp32_logit_scale``; dx and dw element-wise on
  ``flxent_abs_scales`` and rel L2 <= 2^-17), and the same emulation with
  one TF32 pass (hi only), or with the truncating accumulation chained
  through one accumulator over the dW walk's 2048 rows, is shown to miss
  them.

``chip_smoke.py`` holds the CUDA kernels against the plain versions on the
card at the same gates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.fused_loss import fused_linear_cross_entropy as jax_flce

import chip_smoke
from paddle_tpu_torch.kernels import fused_loss as kloss
from test_torch_tf32_split import MMA_K, mma, tf32_split

IGN = -100
ULP = chip_smoke.FLXENT_ULP["float32"]  # 2^-16
KBLOCK = 32  # csrc/flxent_tf32.cu kBK: each stage's k go into zeroed partials added to the running sum


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


# -- the routes ----------------------------------------------------------------------

# (dtype, h, v, vocab_major, W's offset in elements) -> the route of kernel 17 and the backward
ROUTES = [
    (torch.float32, 4096, 32000, False, 0, "tf32x3"),  # the fp32 train step's head
    (torch.float32, 4096, 32000, True, 0, "tf32x3"),
    (torch.float32, 1024, 32003, False, 0, "cuda_cores"),  # [H, V] rows of 128,012 bytes
    (torch.float32, 1024, 32003, True, 0, "tf32x3"),  # vocab-major rows are H long
    (torch.float32, 512, 3001, False, 0, "cuda_cores"),  # chip_smoke's CUDA-core case
    (torch.float32, 1024, 5000, False, 1, "cuda_cores"),  # W 4 bytes off 16-byte alignment
    (torch.float32, 1024, 5000, True, 2, "cuda_cores"),  # 8 bytes off
    (torch.float32, 1024, 5000, True, 3, "cuda_cores"),  # 12 bytes off
    (torch.float32, 1024, 5000, False, 4, "tf32x3"),  # 16 bytes off: aligned
    (torch.float32, 1024, 5000, True, 8, "tf32x3"),  # 32 bytes off
    (torch.bfloat16, 4096, 32000, False, 0, "wgmma"),
    (torch.bfloat16, 1024, 32003, False, 0, "mma_sync"),
    (torch.bfloat16, 1024, 5000, True, 1, "mma_sync"),
    (torch.float16, 512, 3000, True, 0, "wgmma"),
    (torch.float16, 512, 3000, True, 1, "mma_sync"),
    (torch.float16, 512, 3001, False, 0, "mma_sync"),
]


@pytest.mark.parametrize("dtype,h,v,vocab_major,offset,route", ROUTES,
                         ids=[f"{str(c[0])[6:]}-{c[1]}x{c[2]}-{'vm' if c[3] else 'hv'}-off{c[4]}" for c in ROUTES])
def test_forward_and_backward_routes(dtype, h, v, vocab_major, offset, route):
    """The route kernel 17 and the backward's products take, from the
    tensors (``flx_route_of``) and from the shapes (``flx_route``): fp32
    takes ``"tf32x3"`` exactly where the split pass can read W."""
    buf = torch.zeros(offset + h * v, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    w = buf[offset:].view((v, h) if vocab_major else (h, v))
    x = torch.zeros((4, h), dtype=dtype)
    aligned = offset * buf.element_size() % 16 == 0
    assert kloss.flx_route_of(x, w, vocab_major) == route
    assert kloss.flx_route(dtype, h, v, vocab_major, aligned) == route


@pytest.mark.parametrize("dtype", [torch.int8, torch.float64])
def test_backward_route_refuses_other_dtypes(dtype):
    """The backward's route is :func:`flx_route`'s, which refuses any other
    dtype before a launch."""
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        kloss.flx_route(dtype, 4096, 32000, False)


# -- the walk --------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,v,want", [(2048, 4096, 32000, 1024), (8192, 4096, 32000, 2048),
                                        (160, 256, 1000, 512), (65536, 4096, 32000, 2048),
                                        (8192, 5120, 50304, 4096)])
def test_sub_chunks_keep_the_planes_below_the_logits(n, h, v, want):
    """The sub-chunk is the largest of CHUNK / 2^i (>= 512) whose operand
    planes take fewer bytes than the ``[n, v]`` fp32 logits; at the timed
    fp32 cases, x ``[2048, 4096]`` and the train step's ``[8192, 4096]``,
    1024 and 2048 columns."""
    sub = kloss.flx_tf32_sub(n, h, v)
    assert sub == want and kloss.CHUNK % sub == 0 and sub >= 512
    if sub > 512:
        assert kloss.tf32_planes_bytes(n, h, v, sub) < 4 * n * v
    if sub < kloss.CHUNK:
        assert kloss.tf32_planes_bytes(n, h, v, 2 * sub) >= 4 * n * v
    # the planes as _bwd_tf32 allocates them: x, x^T, W_c^T, W_c, D, D^T (hi and lo each)
    s, n4 = min(sub, v), -(-n // 4) * 4
    shapes = [(n, h), (h, n4), (s, h), (h, -(-s // 4) * 4), (n, -(-s // 4) * 4), (s, n4)]
    assert kloss.tf32_planes_bytes(n, h, v, sub) == sum(2 * 4 * a * b for a, b in shapes)


@pytest.mark.parametrize("v", [1000, 4096, 5000, 32000, 32003])
def test_sub_chunks_cover_every_column_once_in_chunk_order(v):
    """The backward's walk: sub-chunks of ``flx_tf32_sub`` columns from 0 to
    V cover every column once, in order, each inside one chunk of ``CHUNK``
    columns."""
    for n in (300, 2048, 8192):
        sub = kloss.flx_tf32_sub(n, 4096, v)
        starts = list(range(0, v, sub))
        cols = [c for c0 in starts for c in range(c0, min(c0 + sub, v))]
        assert cols == list(range(v))
        assert all(c0 // kloss.CHUNK == (min(c0 + sub, v) - 1) // kloss.CHUNK for c0 in starts)


# -- the split pass ----------------------------------------------------------------------

def test_split_pass_plain_version_on_the_bits():
    """``tf32_planes`` on a CPU tensor (its plain version): hi and lo are TF32
    values (13 low bits zero) with hi + lo within 2^-22 of x, the transposed
    planes hold the same values with their rows padded by zeros to a
    multiple of 4, and the planes equal the test file's ``tf32_split``."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(37, 12)) * 10.0 ** rng.uniform(-8, 8, (37, 12))).astype(np.float32))
    same, trans = kloss.tf32_planes(x, same=True, trans=True)
    assert same.shape == (2, 37, 12) and trans.shape == (2, 12, 40)
    hi, lo = tf32_split(x)
    assert torch.equal(same[0], hi) and torch.equal(same[1], lo)
    assert torch.equal(trans[:, :, :37], same.transpose(1, 2)) and not trans[:, :, 37:].any()
    assert not bool((same.view(torch.int32) & 0x1FFF).any())
    miss = (x.double() - same[0].double() - same[1].double()).abs()
    assert bool((miss <= x.double().abs() * 2.0 ** -22).all())
    assert kloss.tf32_planes(x, same=False, trans=True)[0] is None
    assert kloss.tf32_planes(x, same=True, trans=False)[1] is None


@pytest.mark.parametrize("shape,dtype", [((8, 6), torch.float32), ((8, 8), torch.float64), ((0, 8), torch.float32)])
def test_split_pass_refuses_what_the_kernel_does_not_take(shape, dtype):
    with pytest.raises(ValueError, match="split pass"):
        kloss.tf32_planes(torch.zeros(shape, dtype=dtype, device="meta"), same=True, trans=True)


# -- the arithmetic ----------------------------------------------------------------------

def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int = 3, partials: bool = True) -> torch.Tensor:
    """``a @ b^T`` (``a [M, K]``, ``b [N, K]``, fp32) as the 3xTF32 mainloop
    forms it: both operands split (``tf32_split``), K zero-padded to whole
    k8 steps; per k block of :data:`KBLOCK`, the cross terms (each k8 step
    lo hi, then hi lo) into one zeroed partial and hi hi into another, each
    TF32 mma's sum added rounded toward zero; the running sum takes the
    cross partial, then the hi hi one, in fp32 to nearest. ``passes`` 1:
    hi hi only. ``partials`` False: every pass chained through one
    accumulator over the whole K (the control the partials exist to beat)."""
    k = a.shape[1]
    kp = -(-k // MMA_K) * MMA_K
    a = torch.nn.functional.pad(a.float(), (0, kp - k))
    b = torch.nn.functional.pad(b.float(), (0, kp - k))
    ah, al = tf32_split(a)
    bh, bl = (t.t() for t in tf32_split(b))
    zero = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    steps = [slice(k0, k0 + MMA_K) for k0 in range(0, kp, MMA_K)]
    if not partials:
        acc = zero
        for ks in steps:
            if passes == 3:
                acc = mma(mma(acc, al[:, ks], bh[ks]), ah[:, ks], bl[ks])
            acc = mma(acc, ah[:, ks], bh[ks])
        return acc
    run = zero
    per_block = KBLOCK // MMA_K
    for i in range(0, len(steps), per_block):
        pc, ph = zero, zero
        for ks in steps[i:i + per_block]:
            if passes == 3:
                pc = mma(mma(pc, al[:, ks], bh[ks]), ah[:, ks], bl[ks])
            ph = mma(ph, ah[:, ks], bh[ks])
        run = run + pc + ph if passes == 3 else run + ph
    return run


def emulate_tf32_bwd(x, w, labels, lse, gcoef, vocab_major, passes=3, partials=True):
    """``(dx, dw, ds)`` as the 3xTF32 instance computes them (fp32 ``x [N,
    H]``, ``W`` in either layout): per sub-chunk of ``flx_tf32_sub`` columns
    in order, D = (exp(x W_c - lse) - onehot) gcoef from the product's
    logits, dX's partial D W_c^T added to dx (the first overwrites), dW's
    chunk x^T D (D^T x when vocab-major, as the kernel's operands are
    swapped there). ``ds`` are the sub-chunks' D, by first column."""
    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    sub = kloss.flx_tf32_sub(n, h, v)
    dx, dw, ds = None, torch.empty(w.shape, dtype=torch.float32), {}
    for c0 in range(0, v, sub):
        c1 = min(c0 + sub, v)
        wc = (w[c0:c1] if vocab_major else w[:, c0:c1].t()).float()  # [vc, H]
        logits = tf32_product(x, wc, passes, partials)
        onehot = (torch.arange(c0, c1)[None, :] == labels.long()[:, None]).float()
        d = (torch.exp(logits - lse[:, None]) - onehot) * gcoef[:, None]
        ds[c0] = d
        part = tf32_product(d, wc.t(), passes, partials)  # [N, H]
        dx = part if dx is None else dx + part
        if vocab_major:
            dw[c0:c1] = tf32_product(d.t(), x.t(), passes, partials)  # [vc, H]
        else:
            dw[:, c0:c1] = tf32_product(x.t(), d.t(), passes, partials)  # [H, vc]
    return dx, dw, ds


def _head(n, h, v, vocab_major, seed):
    """x ~ N(0, 1), W ~ N(0, 0.02) (chip_smoke's inputs), labels with every
    tenth ignored, one past V and some on the sub-chunk boundaries; the
    mean's gcoef; lse from the plain forward."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.normal(size=(v, h) if vocab_major else (h, v))).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    lab[::10] = IGN
    lab[1] = v
    sub = kloss.flx_tf32_sub(n, h, v)
    lab[2], lab[3], lab[4] = sub - 1, sub, v - 1
    valid = lab != IGN
    gcoef = torch.where(valid, 1.0 / valid.sum().float(), 0.0)
    lse, _ = kloss.flxent_fwd_plain(x, w, lab, vocab_major)
    return x, w, lab, gcoef, lse


def _jax_grads(x, w, lab, vocab_major):
    """dx, dw of JAX's mean loss through its Pallas kernels in interpret mode."""
    def f(a, b):
        return jax_flce(a, b, jnp.asarray(lab.numpy()), ignore_index=IGN, reduction="mean",
                        vocab_major=vocab_major, interpret=True, block=(16, 128))

    _, vjp = jax.vjp(f, jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    dx, dw = vjp(jnp.float32(1.0))
    return torch.from_numpy(np.array(dx, np.float32)), torch.from_numpy(np.array(dw, np.float32))


def _gates(x, w, lab, lse, gcoef, vocab_major, dx, dw, ds, want_dx, want_dw):
    """``chip_smoke.flxent_case``'s fp32 gates: per sub-chunk D within 2^-16
    max(|got|, |want|) fp32_logit_scale of the plain D; dx and dw within
    2^-16 (|D| scale |W|^T resp. |x|^T |D| scale) + 2^-16 max(|got|,
    |want|) element-wise and a rel L2 of at most 2^-17. Returns each gate's
    worst error over its limit (rel L2 over 2^-17 for ``*_rel_l2``)."""
    readings = {"d": 0.0}
    v = w.shape[0] if vocab_major else w.shape[1]
    for c0, d in ds.items():
        c1 = c0 + d.shape[1]
        want = kloss.flxent_dchunk_plain(x, w, lab, lse, gcoef, c0, c1, vocab_major)
        scale = chip_smoke.fp32_logit_scale(x, w[c0:c1] if vocab_major else w[:, c0:c1].t())
        limit = ULP * torch.maximum(d.abs(), want.abs()) * scale
        readings["d"] = max(readings["d"], chip_smoke.gate_reading(d, want, limit)["worst_err_over_limit"])
    assert c1 == v
    sx, sw = chip_smoke.flxent_abs_scales(x, w, lab, lse, gcoef, vocab_major, ULP, 0.0)
    for name, got, want, scale in (("dx", dx, want_dx, sx), ("dw", dw, want_dw, sw)):
        limit = scale + ULP * torch.maximum(got.abs(), want.abs())
        readings[name] = chip_smoke.gate_reading(got, want, limit)["worst_err_over_limit"]
        readings[name + "_rel_l2"] = chip_smoke.rel_l2(got, want) / (ULP / 2)
    return readings


@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_emulation_meets_the_fp32_gates_against_plain_and_pallas(vocab_major):
    """Rows ragged against the 128-row tiles (160), H 256 (8 k blocks),
    V 1000 in sub-chunks of 512 (the last 488 columns): D, dx and dw of the
    3xTF32 arithmetic within the fp32 gates of both the plain versions and
    JAX's Pallas backward."""
    n, h, v = 160, 256, 1000
    x, w, lab, gcoef, lse = _head(n, h, v, vocab_major, seed=3)
    assert kloss.flx_route(torch.float32, h, v, vocab_major) == "tf32x3"
    assert kloss.flx_tf32_sub(n, h, v) == 512
    dx, dw, ds = emulate_tf32_bwd(x, w, lab, lse, gcoef, vocab_major)
    assert sorted(ds) == [0, 512] and dx.shape == x.shape and dw.shape == w.shape
    plain = kloss.flxent_bwd_plain(x, w, lab, lse, gcoef, vocab_major)
    for want_dx, want_dw in (plain, _jax_grads(x, w, lab, vocab_major)):
        readings = _gates(x, w, lab, lse, gcoef, vocab_major, dx, dw, ds, want_dx, want_dw)
        assert all(r <= 1.0 for r in readings.values()), readings


def test_one_tf32_pass_misses_the_fp32_gates():
    """hi hi alone (one TF32 pass) moves a logit by ~2^-11 of its products:
    D's gate and dx's and dw's rel L2 all fail."""
    n, h, v = 160, 256, 1000
    x, w, lab, gcoef, lse = _head(n, h, v, False, seed=3)
    dx, dw, ds = emulate_tf32_bwd(x, w, lab, lse, gcoef, False, passes=1)
    readings = _gates(x, w, lab, lse, gcoef, False, dx, dw, ds, *kloss.flxent_bwd_plain(x, w, lab, lse, gcoef))
    assert readings["d"] > 1.0 and readings["dx_rel_l2"] > 1.0 and readings["dw_rel_l2"] > 1.0, readings


def test_chained_accumulation_misses_the_gate_over_the_dw_walk():
    """dW sums over the rows: over 2048 of them, the tensor cores' truncating
    accumulation chained through one accumulator drifts past the rel L2
    gate (2^-17); the kernel's zeroed partials of 32 rows, each added to
    nearest, stay far inside it."""
    n, h, v = 2048, 64, 64
    x, w, lab, gcoef, lse = _head(n, h, v, False, seed=5)
    d = kloss.flxent_dchunk_plain(x, w, lab, lse, gcoef, 0, v)
    _, want = kloss.flxent_bwd_plain(x, w, lab, lse, gcoef, need_dx=False)
    with_partials = tf32_product(x.t(), d.t())
    chained = tf32_product(x.t(), d.t(), partials=False)
    assert chip_smoke.rel_l2(with_partials, want) <= ULP / 2 / 8
    assert chip_smoke.rel_l2(chained, want) > ULP / 2
