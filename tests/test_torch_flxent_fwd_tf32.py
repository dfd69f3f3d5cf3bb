"""Kernel 17 in fp32 on the TF32 tensor cores, checked on the CPU: the
forward's partials for fp32 x and W in three TF32 passes (``"tf32x3"``) and
its int8 site for fp32 x against the int8 W in two (``"tf32x2"``), both on
``csrc/flxent_tf32.cu``'s wgmma mainloop, which the CPU cannot run.

What the instance adds to the functions is a route, a walk and an
arithmetic:

- the routes: ``flx_route`` sends fp32 to ``"tf32x3"`` where the split
  pass can read W (kernel 17 and the backward take one route: every dtype
  x alignment x layout case in ``tests/test_torch_flxent_tf32.py``);
  ``flx_int8_route`` sends fp32 activations to ``"tf32x2"`` where the
  widen pass can take the int8 W (W 16-byte aligned, rows a multiple of 16
  bytes, H a multiple of 4), ``"cuda_cores"`` elsewhere (its cases in
  ``tests/test_torch_int8.py``);
- the walk: one split of x, then per sub-chunk of ``flx_fwd_sub`` columns
  (a multiple of 128, so each sub-chunk's partials are whole tiles of the
  ``[3, ceil(V / 128), N]`` scratch) W_c^T laid out K-major (its hi and lo
  planes; the int8 W's values widened exactly, ``int8_plane``) and the
  partials; then the merge. The sub-chunks cover every column once and keep
  the scratch below the ``[N, V]`` fp32 logits of the unfused head;
- the arithmetic, emulated with ``tests/test_torch_tf32_split.py``'s
  ``tf32_split`` and its model of a TF32 mma (each k8 step's products summed
  exactly, the sum added to the accumulator rounded toward zero): x split
  once, each k block of 32 summed into a zeroed cross-term partial (three
  passes: lo hi, then hi lo each k8 step; two: x_lo W, W exact) and a zeroed
  hi hi partial, each added to the running sum to nearest; each logit times
  its column's scale (int8) and NEG_INF past V; per row and 128-column tile
  the max, the sum of exp over it and the target logit; the merge in tile
  order (``ptt_flxent_merge``).

The emulations are held to ``flxent_fwd_plain`` / ``flxent_fwd_int8_plain``
and to JAX's Pallas forward in interpret mode (the public
``fused_linear_cross_entropy`` with ``reduction="none"``) at
``chip_smoke.py``'s fp32 forward gate (``fp32_fwd_gate``: per row 2^-16 of
the value plus the probability-weighted random walk of the logits' fp32
rounding); one TF32 pass (hi only; for the int8 site x's hi plane alone) is
shown to miss it. ``chip_smoke.py`` holds the CUDA kernels against the
plain versions on the card at the same gate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.fused_loss import fused_linear_cross_entropy as jax_flce

import chip_smoke
from paddle_tpu_torch.kernels import fused_loss as kloss
from test_torch_flxent_tf32 import KBLOCK, tf32_product
from test_torch_int8 import _int8_head, _merge_partials
from test_torch_tf32_split import MMA_K, mma, tf32_split

IGN = -100
TILE = kloss.TILE


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


# -- the walk --------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,v,passes,want", [
    (2048, 4096, 32000, 3, 4096), (8192, 4096, 32000, 3, 4096), (2048, 4096, 32000, 2, 4096),
    (300, 128, 1000, 3, 768), (300, 256, 1000, 3, 256), (300, 256, 1000, 2, 512), (160, 256, 1000, 3, 128),
    (70, 128, 300, 2, 128), (65536, 4096, 32000, 3, 4096), (8192, 5120, 50304, 3, 4096),
])
def test_forward_sub_chunks_keep_the_scratch_below_the_logits(n, h, v, passes, want):
    """The sub-chunk is the largest multiple of 128 (at most CHUNK) whose
    scratch takes fewer bytes than the ``[n, v]`` fp32 logits; 128 where none
    does. At the timed fp32 cases, x ``[2048, 4096]`` and the train step's
    ``[8192, 4096]`` against V 32000, the whole CHUNK (the backward takes
    1024 and 2048 there)."""
    sub = kloss.flx_fwd_sub(n, h, v, passes)
    assert sub == want and sub % TILE == 0 and TILE <= sub <= kloss.CHUNK
    if sub > TILE:
        assert kloss.flx_fwd_bytes(n, h, v, sub, passes) < 4 * n * v
    if sub < kloss.CHUNK:
        assert kloss.flx_fwd_bytes(n, h, v, sub + TILE, passes) >= 4 * n * v
    # the scratch as the walk allocates it: x's two planes, W_c^T's (passes - 1), the partials
    shapes = [(2, n, h), (passes - 1, min(sub, v), h), (3, -(-v // TILE), n)]
    assert kloss.flx_fwd_bytes(n, h, v, sub, passes) == sum(4 * a * b * c for a, b, c in shapes)


@pytest.mark.parametrize("v", [300, 1000, 4096, 5000, 32000, 32003])
def test_forward_sub_chunks_cover_every_column_once_on_whole_tiles(v):
    """Sub-chunks of ``flx_fwd_sub`` columns from 0 to V cover every column
    once, in order, each starting on a multiple of 128: the partials of
    sub-chunk c land at tiles c0 / 128 on, and every tile of the scratch is
    written by exactly one sub-chunk."""
    for n, h, passes in ((300, 256, 3), (300, 256, 2), (2048, 4096, 3), (8192, 4096, 2), (160, 1024, 3)):
        sub = kloss.flx_fwd_sub(n, h, v, passes)
        starts = list(range(0, v, sub))
        assert [c for c0 in starts for c in range(c0, min(c0 + sub, v))] == list(range(v))
        assert all(c0 % TILE == 0 for c0 in starts)
        tiles = [t for c0 in starts for t in range(c0 // TILE, -(-min(c0 + sub, v) // TILE))]
        assert tiles == list(range(-(-v // TILE)))


# -- the widen pass ----------------------------------------------------------------------

@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_widen_pass_plain_version_is_the_int8_values(vocab_major):
    """``int8_plane`` on a CPU tensor (its plain version): W_c^T ``[c1 - c0,
    H]`` in fp32, every int8 value exactly (each is a TF32 value: the low 13
    bits are zero, so the "tf32x2" instance needs no lo plane)."""
    rng = np.random.default_rng(2)
    h, v = 48, 400
    w8 = torch.from_numpy(rng.integers(-127, 128, (v, h) if vocab_major else (h, v)).astype(np.int8))
    for c0, c1 in ((0, 400), (128, 256), (384, 400)):
        plane = kloss.int8_plane(w8, vocab_major, c0, c1)
        want = (w8[c0:c1] if vocab_major else w8[:, c0:c1].t()).numpy().astype(np.float32)
        assert plane.dtype == torch.float32 and plane.shape == (c1 - c0, h) and plane.is_contiguous()
        assert np.array_equal(plane.numpy(), want)
        assert not bool((plane.view(torch.int32) & 0x1FFF).any())
        hi, lo = tf32_split(plane)
        assert torch.equal(hi, plane) and not lo.any()


@pytest.mark.parametrize("shape,dtype,vocab_major,c0,c1", [
    ((64, 256), torch.float32, False, 0, 128),  # not int8
    ((64, 250), torch.int8, False, 0, 128),  # [H, V] rows of 250 bytes
    ((250, 72), torch.int8, True, 0, 128),  # vocab-major rows of 72 bytes
    ((66, 256), torch.int8, False, 0, 128),  # [H, V] with H % 4 != 0: the plane's rows of 264 bytes
    ((64, 256), torch.int8, False, 128, 128),  # an empty range
    ((64, 256), torch.int8, False, 0, 257),  # past V
], ids=["fp32", "v-250", "vm-h72", "h-66", "empty", "past-v"])
def test_widen_pass_refuses_what_the_kernel_does_not_take(shape, dtype, vocab_major, c0, c1):
    with pytest.raises(ValueError, match="widen pass"):
        kloss.int8_plane(torch.zeros(shape, dtype=dtype, device="meta"), vocab_major, c0, c1)


# -- the arithmetic ----------------------------------------------------------------------

def fwd_product(x: torch.Tensor, wc: torch.Tensor, passes: int) -> torch.Tensor:
    """``x @ wc^T`` (``x [N, H]``, ``wc [Vc, H]``, fp32) as the forward's
    mainloop forms it: three passes (``tf32_product``: both operands split;
    per k block of 32 the cross terms lo hi, hi lo into one zeroed partial,
    hi hi into another); two (``wc`` exact in TF32, the widened int8 W: x
    split, per k block x_lo wc into the cross partial and x_hi wc into the
    hi hi one, each k8 step's sum added rounded toward zero, the running sum
    taking the cross partial, then the hi hi one, to nearest); one (hi hi
    only: the control)."""
    if passes != 2:
        return tf32_product(x, wc, passes)
    k = x.shape[1]
    kp = -(-k // MMA_K) * MMA_K
    xh, xl = tf32_split(torch.nn.functional.pad(x.float(), (0, kp - k)))
    b = torch.nn.functional.pad(wc.float(), (0, kp - k)).t()
    assert torch.equal(tf32_split(b)[0], b), "two passes take a B operand exact in TF32"
    run = torch.zeros((x.shape[0], wc.shape[0]), dtype=torch.float32)
    for k0 in range(0, kp, KBLOCK):
        pc, ph = torch.zeros_like(run), torch.zeros_like(run)
        for ks in range(k0, min(k0 + KBLOCK, kp), MMA_K):
            s = slice(ks, ks + MMA_K)
            pc = mma(pc, xl[:, s], b[s])
            ph = mma(ph, xh[:, s], b[s])
        run = run + pc + ph
    return run


def emulate_fwd_tf32(x, w, labels, vocab_major, scale=None, passes=None):
    """``(lse, tl)`` as kernel 17's TF32 instance computes them: per
    sub-chunk of ``flx_fwd_sub`` columns in order, the logits of x against
    W_c^T (:func:`fwd_product`; ``scale``: W int8, two passes, each logit
    then times its column's scale), and per 128-column tile the epilogue's
    partials (NEG_INF past V; the max, the sum of exp over it, the logit at
    the label's column) into the ``[3, ceil(V / 128), N]`` scratch at tile
    c0 / 128 on; then the merge in tile order. ``passes`` overrides the
    route's (3 for fp32 W, 2 for int8) for the controls."""
    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    route_passes = 3 if scale is None else 2
    passes = passes or route_passes
    sub = kloss.flx_fwd_sub(n, h, v, route_passes)
    lab = labels.long()
    part = torch.full((3, -(-v // TILE), n), float("nan"))
    for c0 in range(0, v, sub):
        c1 = min(c0 + sub, v)
        wc = (w[c0:c1] if vocab_major else w[:, c0:c1].t()).float()  # [vc, H], the int8 values widened exactly
        logits = fwd_product(x, wc, passes)
        if scale is not None:
            logits = logits * scale[c0:c1][None, :]
        for t0 in range(c0, c1, TILE):
            cols = torch.arange(t0, t0 + TILE)
            vals = torch.full((n, TILE), kloss.NEG_INF)
            vals[:, :min(TILE, c1 - t0)] = logits[:, t0 - c0:t0 - c0 + TILE]
            mx = vals.amax(dim=1)
            hit = (cols[None, :] == lab[:, None]) & (cols[None, :] < v)
            assert part[:, t0 // TILE].isnan().all(), "each tile is written once"
            part[:, t0 // TILE] = torch.stack([mx, torch.exp(vals - mx[:, None]).sum(dim=1),
                                               torch.where(hit, vals, 0.0).sum(dim=1)])
    assert not part.isnan().any()
    return _merge_partials(part)


def _fp32_head(n, h, v, vocab_major, seed):
    """x ~ N(0, 1), W ~ N(0, 0.02) (chip_smoke's inputs), labels with every
    tenth ignored, two past V, and some on the sub-chunk and tile edges."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.normal(size=(v, h) if vocab_major else (h, v))).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
    lab[::10] = IGN
    lab[1], lab[2] = v, v + 700
    return x, w, lab


def _edges(lab, n, h, v, passes):
    """Labels on every sub-chunk's first and last column, a tile edge inside
    a sub-chunk and V - 1."""
    sub = kloss.flx_fwd_sub(n, h, v, passes)
    edges = sorted({c for c0 in range(0, v, sub) for c in (c0, min(c0 + sub, v) - 1)} | {TILE - 1, TILE, v - 1})
    lab[3:3 + len(edges)] = torch.tensor(edges, dtype=lab.dtype)
    return edges


def _jax_loss(x, w, lab, vocab_major, scale=None):
    """JAX's per-row loss through its Pallas forward in interpret mode."""
    kw = {} if scale is None else {"weight_scale": jnp.asarray(scale.numpy())}
    return torch.from_numpy(np.array(jax_flce(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(lab.numpy()), ignore_index=IGN,
        reduction="none", vocab_major=vocab_major, interpret=True, block=(16, 128), **kw), np.float32))


def _readings(x, w, lab, vocab_major, lse, tl, scale=None):
    """The fp32 forward gate's worst errors over their limits against the
    plain version (lse, tl) and against JAX's Pallas forward (the per-row
    loss, its limit the sum of lse's and tl's; rows whose label lies in the
    Pallas padding of V, where it meets a NEG_INF column, left out)."""
    v = w.shape[0] if vocab_major else w.shape[1]
    if scale is None:
        lse_p, tl_p = kloss.flxent_fwd_plain(x, w, lab, vocab_major)
    else:
        lse_p, tl_p = kloss.flxent_fwd_int8_plain(x, w, scale, lab, vocab_major)
    s_lse, s_tl = chip_smoke.fp32_fwd_scales(x, w, lab, lse_p, vocab_major, scale)
    r = chip_smoke.fp32_fwd_gate(lse, tl, lse_p, tl_p, (s_lse, s_tl))
    readings = {name: g["worst_err_over_limit"] for name, g in r.items()}
    valid = lab != IGN
    loss = torch.where(valid, lse - tl, 0.0)
    want = _jax_loss(x, w, lab, vocab_major, scale)
    keep = ~((lab >= v) & (lab < -(-v // TILE) * TILE))
    ulp = chip_smoke.FLXENT_ULP["float32"]
    limit = ulp * (torch.maximum(lse.abs(), lse_p.abs()) + s_lse + torch.maximum(tl.abs(), tl_p.abs()) + s_tl)
    readings["loss vs pallas"] = chip_smoke.gate_reading(loss[keep], want[keep], limit[keep])["worst_err_over_limit"]
    return readings


@pytest.mark.parametrize("n,h,v", [(300, 128, 1000), (300, 256, 1000)], ids=["sub-768", "sub-256"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_fp32_emulation_meets_the_forward_gate_against_plain_and_pallas(vocab_major, n, h, v):
    """Rows ragged against the 128-row tiles (300), V 1000 in sub-chunks of
    768 (a ragged last sub-chunk of 232 columns: a whole tile and a 104-
    column one) or 256 (a 232-column last), labels on every sub-chunk edge,
    a tile edge, V - 1, past V and ignored: the 3xTF32 forward within the
    fp32 forward gate of the plain version and of JAX's Pallas forward."""
    x, w, lab = _fp32_head(n, h, v, vocab_major, seed=4)
    _edges(lab, n, h, v, 3)
    assert kloss.flx_route(torch.float32, h, v, vocab_major) == "tf32x3"
    assert kloss.flx_fwd_sub(n, h, v) == {128: 768, 256: 256}[h]
    lse, tl = emulate_fwd_tf32(x, w, lab, vocab_major)
    assert not tl[lab >= v].any() and not tl[lab == IGN].any()
    readings = _readings(x, w, lab, vocab_major, lse, tl)
    assert all(r <= 1.0 for r in readings.values()), readings


@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_int8_emulation_meets_the_forward_gate_against_plain_and_pallas(vocab_major):
    """The int8 site in fp32 on ``"tf32x2"``: the JAX quantizer's int8 head
    (W ~ N(0, 0.05) per column), H 256 and V 1008 in sub-chunks of 512 (a
    496-column last), rows ragged (300), labels on the edges: two TF32
    passes within the fp32 forward gate of ``flxent_fwd_int8_plain`` and of
    JAX's Pallas forward with ``weight_scale``."""
    n, h, v = 300, 256, 1008
    x, w8, scale, lab = (torch.from_numpy(a.copy()) for a in _int8_head(np.random.default_rng(6), n, h, v,
                                                                        vocab_major))
    _edges(lab, n, h, v, 2)
    assert kloss.flx_int8_route_of(x, w8, vocab_major) == "tf32x2"
    assert kloss.flx_fwd_sub(n, h, v, 2) == 512
    lse, tl = emulate_fwd_tf32(x, w8, lab, vocab_major, scale=scale)
    readings = _readings(x, w8, lab, vocab_major, lse, tl, scale)
    assert all(r <= 1.0 for r in readings.values()), readings


def test_one_tf32_pass_misses_the_fp32_forward_gate():
    """hi hi alone (one TF32 pass) moves a logit by ~2^-11 of its products'
    l2 norm: the target logits fail the gate (lse, a probability-weighted
    mean of many such moves, may pass: the gate reads both)."""
    n, h, v = 300, 256, 1000
    x, w, lab = _fp32_head(n, h, v, False, seed=4)
    lse, tl = emulate_fwd_tf32(x, w, lab, False, passes=1)
    readings = _readings(x, w, lab, False, lse, tl)
    assert readings["tl"] > 1.0 and readings["loss vs pallas"] > 1.0, readings


def test_x_hi_alone_misses_the_int8_forward_gate():
    """At the int8 site the second pass is x_lo W: without it (x's hi plane
    alone) the target logits miss the gate."""
    n, h, v = 300, 256, 1008
    x, w8, scale, lab = (torch.from_numpy(a.copy()) for a in _int8_head(np.random.default_rng(6), n, h, v))
    lse, tl = emulate_fwd_tf32(x, w8, lab, False, scale=scale, passes=1)
    readings = _readings(x, w8, lab, False, lse, tl, scale)
    assert readings["tl"] > 1.0 and readings["loss vs pallas"] > 1.0, readings


def test_plain_forward_meets_its_own_gate_and_the_cpu_routes_take_it():
    """The gate passes the plain forward against itself with the logits
    summed in another order (JAX's Pallas forward), and a CPU tensor on the
    ``"tf32x3"`` route runs the plain version: no launch, no split."""
    n, h, v = 160, 256, 1000
    x, w, lab = _fp32_head(n, h, v, True, seed=8)
    lse, tl = kloss.flxent_fwd(x, w, lab, True)
    assert torch.equal(lse, kloss.flxent_fwd_plain(x, w, lab, True)[0])
    readings = _readings(x, w, lab, True, lse, tl)
    assert all(r <= 1.0 for r in readings.values()), readings
