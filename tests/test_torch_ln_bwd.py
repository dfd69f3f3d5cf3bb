"""Kernel 13 (the residual LayerNorm's adjoint, ``csrc/ln_residual.cu``) on
its two routes, checked on the CPU.

The CUDA kernel cannot run here. What its launch adds to the function is a
route and a shape chosen on the host (``kernels.fused.ln_bwd_plan``: the
row in registers at W warps a row and V vectors a lane, or the loop route
for other widths), and an order of its sums: per row three block sums (the
mean, the variance on the register row, and ``(sum g w, sum g w x^)`` as
one), per block fp32 partials of dw and db over its rows in order, then
``ptt::column_sum_kernel``'s fixed-order column sum. So:

- the plain version (the card's reference) is held against the Pallas
  kernel ``_ln_res_bwd_kernel`` in interpret mode at widths of both routes;
- the plan is checked at the widths the models use and at the edges of the
  register route;
- a PyTorch emulation of the register route's walk and sums (written here)
  is held against the Pallas kernel and the plain version, and two of its
  runs against each other bit for bit.

``chip_smoke.py`` holds the kernel against the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.fused import layer_norm_residual_adjoint_pallas

from paddle_tpu_torch.kernels import fused as kfused

EPS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    arrays given as fp32 values (sign-magnitude bit patterns)."""
    def ordered(x):
        bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _close(got, want, dtype: str, tol: float = 1e-6) -> None:
    """bf16: at most one ulp apart (the fp32 sums in another order can
    round the other way); fp32: ``tol`` (1e-5 for a sum over rows)."""
    if dtype == "bfloat16":
        assert _bf16_ulps(_f32(got), _f32(want)) <= 1
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    g = rng.normal(size=shape).astype(np.float32)
    r = (rng.normal(size=shape) + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
    return _pair(g, dtype), _pair(r, dtype), _pair(w, dtype)


# (dtype, shape, route): GPT-3 13B's width on the register route (bf16 4
# warps x 5 vectors, fp32 8 x 5), a narrow register width, and widths the
# plan sends to the loop route (bf16 384: 48 vectors, not a whole number a
# lane; fp32 8192: 64 vectors a lane)
CASES = [
    ("bfloat16", (2, 7, 5120), "regs"),
    ("float32", (3, 5, 5120), "regs"),
    ("bfloat16", (4, 33, 1024), "regs"),
    ("bfloat16", (130, 384), "loop"),
    ("float32", (2, 9, 8192), "loop"),
]


@pytest.mark.parametrize("dtype,shape,route", CASES, ids=[f"{d}-{'x'.join(map(str, s))}-{r}" for d, s, r in CASES])
def test_plain_matches_pallas_interpret_on_both_routes(dtype, shape, route):
    assert kfused.ln_bwd_plan(shape[-1], getattr(torch, dtype))["route"] == route
    (gj, gt), (rj, rt), (wj, wt) = _inputs(shape, 13 + shape[-1], dtype)
    dxj, dwj, dbj = layer_norm_residual_adjoint_pallas(gj, rj, wj, EPS, interpret=True)
    dxt, dwt, dbt = kfused.ln_residual_bwd(gt, rt, wt, EPS)  # CPU tensors: the plain version
    assert dxt.dtype == dwt.dtype == dbt.dtype == gt.dtype and dxt.shape == shape
    _close(dxt, dxj, dtype)
    _close(dwt, dwj, dtype, 1e-5)
    _close(dbt, dbj, dtype, 1e-5)


def test_ln_bwd_plan_routes():
    """The widths the models use take the register route at the widest
    split that keeps at most LN_BWD_MAX_VECS vectors a lane (4 warps
    first, then 8); the rest take the loop route."""
    bf, f32 = torch.bfloat16, torch.float32
    want = {
        (5120, bf): ("regs", 5, 4),   # GPT-3 13B: 640 vectors = 5 x 4 x 32
        (5120, f32): ("regs", 5, 8),  # 1280 vectors: 10 a lane at 4 warps is too many
        (4096, bf): ("regs", 4, 4),
        (2560, bf): ("regs", 5, 2),   # 320 vectors: 10 lanes' worth, not a multiple of 4
        (6144, bf): ("regs", 6, 4),
        (12288, bf): ("regs", 6, 8),  # GPT-3 175B
        (256, bf): ("regs", 1, 1),
        (384, bf): ("loop", 0, 8),    # 48 vectors: not a whole number a lane
        (384, f32): ("regs", 3, 1),
        (16384, bf): ("loop", 0, 8),  # 8 a lane at 8 warps
        (5128, bf): ("loop", 0, 8),
    }
    for (h, dtype), (route, vecs, warps) in want.items():
        assert kfused.ln_bwd_plan(h, dtype) == {"route": route, "vecs": vecs, "warps_per_row": warps}, (h, dtype)
    for h in range(8, 20000, 8):
        for dtype in (bf, torch.float16, f32):
            p = kfused.ln_bwd_plan(h, dtype)
            if p["route"] == "regs":
                n = 16 // dtype.itemsize
                assert p["vecs"] * p["warps_per_row"] * 32 * n == h
                assert 1 <= p["vecs"] <= kfused.LN_BWD_MAX_VECS and p["warps_per_row"] in kfused.LN_BWD_WARPS


def _column_sum(part: torch.Tensor, slices: int = 8) -> torch.Tensor:
    """``ptt::column_sum_kernel``'s order: slice s sums partials s, s + 8,
    ... in turn, then the 8 slice sums are added in order (fp32)."""
    acc = []
    for s in range(slices):
        t = torch.zeros(part.shape[1], dtype=torch.float32)
        for b in range(s, part.shape[0], slices):
            t = t + part[b]
        acc.append(t)
    out = torch.zeros(part.shape[1], dtype=torch.float32)
    for t in acc:
        out = out + t
    return out


def emulate_regs(g, r, w, eps, nblk):
    """The register route's arithmetic: per row the mean, the variance of
    the row about it and (sum g w, sum g w x^) as three sums; dx in the
    I/O type; per block (``nblk`` blocks of contiguous rows) fp32 dw and db
    partials over its rows in order, then the column sum in the kernel's
    order."""
    h = g.shape[-1]
    g2, r2 = g.reshape(-1, h).float(), r.reshape(-1, h).float()
    wf = w.float()
    rows = g2.shape[0]
    per = -(-rows // nblk)
    dx = torch.empty_like(g2)
    part = torch.zeros((nblk, 2 * h), dtype=torch.float32)
    for b in range(nblk):
        for i in range(b * per, min(rows, (b + 1) * per)):
            mu = r2[i].sum() / h
            rstd = torch.rsqrt(((r2[i] - mu) ** 2).sum() / h + eps)
            xh = (r2[i] - mu) * rstd
            gw = g2[i] * wf
            m1, m2 = gw.sum() / h, (gw * xh).sum() / h
            dx[i] = rstd * (gw - m1 - xh * m2)
            part[b, :h] += g2[i] * xh
            part[b, h:] += g2[i]
    sums = _column_sum(part)
    return dx.to(g.dtype).reshape(g.shape), sums[:h].to(w.dtype), sums[h:].to(w.dtype)


@pytest.mark.parametrize("dtype,nblk", [("bfloat16", 5), ("float32", 9)])
def test_emulated_register_walk_matches_pallas_and_plain(dtype, nblk):
    shape = (3, 15, 1024)
    (gj, gt), (rj, rt), (wj, wt) = _inputs(shape, 29, dtype)
    dx, dw, db = emulate_regs(gt, rt, wt, EPS, nblk)
    dx2, dw2, db2 = emulate_regs(gt, rt, wt, EPS, nblk)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(db, db2)
    dxj, dwj, dbj = layer_norm_residual_adjoint_pallas(gj, rj, wj, EPS, interpret=True)
    dxp, dwp, dbp = kfused.ln_residual_bwd_plain(gt, rt, wt, EPS)
    for want in ((dxj, dwj, dbj), (dxp, dwp, dbp)):
        _close(dx, want[0], dtype, 2e-6)
        _close(dw, want[1], dtype, 1e-5)
        _close(db, want[2], dtype, 1e-5)
