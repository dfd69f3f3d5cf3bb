"""Parity of the port's flash-attention kernels (14 forward, 15 dq, 16 dk/dv)
with the JAX package's Pallas kernels.

The port's plain versions — what its wrappers run for CPU tensors — are held
against ``_run_fwd`` / ``_run_bwd`` run in interpret mode (block 16, inputs
padded to the block as the JAX core pads them), and the port's autograd
``FlashAttentionFunction`` against ``jax.grad`` of
``flash_attention_pallas``, on the same numpy inputs in fp32 at 1e-5. The
masks keep each row's diagonal, as FlashMask's families do (document,
sliding window, global tokens); a fully masked row, where the two packages
deliberately differ, has its own test. The CUDA kernels are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import _pad_to, _run_bwd, _run_fwd, flash_attention_pallas
from paddle_tpu.kernels.flashmask import flashmask_maxmin as jax_maxmin
from paddle_tpu.nn.functional.flash_attention import _xla_attention as jax_xla_attention
from paddle_tpu.nn.functional.flash_attention import make_flashmask_bias as jax_make_bias

import paddle_tpu_torch
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels.flashmask import flashmask_maxmin
from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.flash_attention import _xla_attention

TOL = dict(rtol=1e-5, atol=1e-5)
BLK = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


def _t(a):
    return torch.from_numpy(np.array(a))  # a private writable copy


def _bounds(rng, b, hm, s, c):
    """FlashMask bounds ``[B, Hm, S, C]`` that never mask a column's own
    row (every row keeps its diagonal): C=1 a document end per column, C=2
    a band of rows below the diagonal, C=4 a band below plus a band above."""
    j = np.arange(s)[None, None, :]
    if c == 1:  # documents of 3..12 tokens: column j is seen up to its document's end
        out = np.zeros((b, hm, s), np.int64)
        for bi in range(b):
            for hi in range(hm):
                pos = 0
                while pos < s:
                    end = min(s, pos + int(rng.integers(3, 13)))
                    out[bi, hi, pos:end] = end
                    pos = end
        return out[..., None].astype(np.int32)
    start = j + 1 + rng.integers(0, 6, (b, hm, s))
    end = start + rng.integers(0, 10, (b, hm, s))
    lower = [np.minimum(start, s), np.minimum(end, s)]
    if c == 2:
        return np.stack(lower, -1).astype(np.int32)
    ute = np.maximum(j - rng.integers(2, 8, (b, hm, s)), 0)
    uts = np.maximum(ute - rng.integers(0, 6, (b, hm, s)), 0)
    return np.stack(lower + [uts, ute], -1).astype(np.int32)


def _inputs(seed, s, h, hk, c, hm, b=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    g = rng.normal(size=(b, s, h, d)).astype(np.float32)
    bounds = _bounds(rng, b, 1 if hm == 1 else h, s, c) if c else None
    return q, k, v, g, bounds


def _pallas_fwd_bwd(q, k, v, g, bounds, causal):
    """The Pallas kernels in interpret mode on padded ``[B, H, S, D]``
    arrays, as ``_make_flash_core`` runs them; returns out, lse, dq, dk, dv
    sliced back to the inputs' lengths."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh, gh = (jnp.moveaxis(jnp.asarray(x), 2, 1) for x in (q, k, v, g))
    qp, kp, vp, gp = _pad_to(qh, 2, BLK), _pad_to(kh, 2, BLK), _pad_to(vh, 2, BLK), _pad_to(gh, 2, BLK)
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds), 2, BLK)
    kw = dict(sq=sq, sk=sk, scale=1.0 / d**0.5, causal=causal, blk_q=BLK, blk_k=BLK, interpret=True)
    out, lse = _run_fwd(qp, kp, vp, idx, **kw)
    dq, dk, dv = _run_bwd(qp, kp, vp, idx, gp, out, lse, **kw)

    def back(x, n):  # [B, H, S_pad, D] -> [B, S, H, D]
        return np.asarray(jnp.moveaxis(x[:, :, :n], 1, 2))

    return back(out, sq), np.asarray(lse[:, :, :sq, 0]), back(dq, sq), back(dk, sk), back(dv, sk)


# (S, H, HK, C, Hm, causal): every mask family causal and not, Hm 1 and H,
# MHA and GQA 4/2, S a multiple of the block (32) and ragged (40)
CASES = [
    (32, 4, 4, 0, 1, True),
    (40, 4, 2, 0, 1, False),
    (40, 4, 2, 1, 1, True),
    (32, 4, 4, 1, 4, False),
    (32, 4, 2, 2, 4, True),
    (40, 4, 4, 2, 1, False),
    (40, 4, 4, 4, 4, True),
    (32, 4, 2, 4, 1, False),
]
IDS = [f"s{s}-h{h}/{hk}-c{c}-hm{hm}-{'causal' if causal else 'full'}" for s, h, hk, c, hm, causal in CASES]


@pytest.mark.parametrize("s,h,hk,c,hm,causal", CASES, ids=IDS)
def test_plain_fwd_dq_dkv_match_pallas_interpret(s, h, hk, c, hm, causal):
    q, k, v, g, bounds = _inputs(s + 10 * c + hm, s, h, hk, c, hm)
    out_j, lse_j, dq_j, dk_j, dv_j = _pallas_fwd_bwd(q, k, v, g, bounds, causal)
    bnd = None if bounds is None else _t(bounds)
    out, lse = kfa.flash_fwd_plain(_t(q), _t(k), _t(v), bnd, causal)
    np.testing.assert_allclose(out.numpy(), out_j, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    # the backward kernels on the Pallas forward's own out and lse, as _run_bwd gets them
    lse_t = _t(lse_j)
    delta = (_t(g) * _t(out_j)).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq_plain(_t(q), _t(k), _t(v), bnd, _t(g), lse_t, delta, causal)
    dk, dv = kfa.flash_bwd_dkv_plain(_t(q), _t(k), _t(v), bnd, _t(g), lse_t, delta, causal)
    np.testing.assert_allclose(dq.numpy(), dq_j, **TOL)
    np.testing.assert_allclose(dk.numpy(), dk_j, **TOL)
    np.testing.assert_allclose(dv.numpy(), dv_j, **TOL)


@pytest.mark.parametrize(
    "s,h,hk,c,hm,causal",
    [(40, 4, 2, 1, 1, True), (32, 4, 4, 4, 4, False), (40, 4, 2, 2, 4, True)],
    ids=["doc-gqa-ragged", "c4-hm-full", "c2-gqa-causal"],
)
def test_flashmask_attention_grads_match_jax_grad(s, h, hk, c, hm, causal):
    """The entry and its torch-autograd gradients (the Function's backward
    runs the dq and dk/dv wrappers) against ``jax.grad`` of the Pallas entry."""
    q, k, v, g, bounds = _inputs(100 + c, s, h, hk, c, hm)

    def loss(q_, k_, v_):
        out = flash_attention_pallas(q_, k_, v_, jnp.asarray(bounds), causal=causal,
                                     block_q=BLK, block_k=BLK, interpret=True)
        return (out * jnp.asarray(g)).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = F.flashmask_attention(qt, kt, vt, startend_row_indices=_t(bounds), causal=causal)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_row_is_zero_with_zero_gradients():
    """Row 5 is masked for every column (C=2 bounds [5, 6)). The port writes
    0 there with lse = +inf and gives it no gradient; the Pallas forward
    returns an average of V over the columns it visited instead. Every
    other row, and dk/dv, agree with the Pallas kernels."""
    q, k, v, g, _ = _inputs(7, 32, 4, 2, 0, 1)
    bounds = np.zeros((2, 1, 32, 2), np.int32)
    bounds[..., 0], bounds[..., 1] = 5, 6
    out_j, lse_j, dq_j, dk_j, dv_j = _pallas_fwd_bwd(q, k, v, g, bounds, True)
    assert np.abs(out_j[:, 5]).max() > 0  # the reference's block-dependent average
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = kfa.flash_attention(qt, kt, vt, _t(bounds), causal=True)
    (out * _t(g)).sum().backward()
    _, lse = kfa.flash_fwd_plain(_t(q), _t(k), _t(v), _t(bounds), True)
    rows = np.arange(32) != 5
    assert not out[:, 5].any() and torch.isinf(lse[:, :, 5]).all() and not qt.grad[:, 5].any()
    np.testing.assert_allclose(out.detach().numpy()[:, rows], out_j[:, rows], **TOL)
    np.testing.assert_allclose(lse.numpy()[:, :, rows], lse_j[:, :, rows], **TOL)
    np.testing.assert_allclose(qt.grad.numpy(), dq_j, **TOL)  # dq row 5 is 0 in both
    np.testing.assert_allclose(kt.grad.numpy(), dk_j, **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), dv_j, **TOL)


def test_mask_bias_and_xla_reference_match_jax():
    q, k, v, _, bounds = _inputs(3, 24, 4, 2, 2, 4)
    bias = F.make_flashmask_bias(_t(bounds), 24, 24, True)
    bias_j = jax_make_bias(jnp.asarray(bounds), 24, 24, True)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(bias_j))
    ref = _xla_attention(_t(q), _t(k), _t(v), bias=bias, causal=True)
    ref_j = jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias_j, causal=True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(ref_j), **TOL)
    # the entry agrees with the dense composition where no row is fully masked
    got = F.flashmask_attention(_t(q), _t(k), _t(v), startend_row_indices=_t(bounds), causal=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    lo, hi = flashmask_maxmin(_t(bounds), block_size=16)
    lo_j, hi_j = jax_maxmin(jnp.asarray(bounds), block_size=16)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))


def test_cpu_wrappers_count_no_launch_and_other_devices_raise():
    q, k, v, g, bounds = _inputs(5, 16, 2, 2, 1, 1)
    args = [_t(x) for x in (q, k, v)] + [_t(bounds)]
    reset_launch_counts()
    out, lse = kfa.flash_fwd(*args, causal=True)
    delta = (_t(g) * out).sum(-1).transpose(1, 2).contiguous()
    kfa.flash_bwd_dq(*args, _t(g), lse, delta, causal=True)
    kfa.flash_bwd_dkv(*args, _t(g), lse, delta, causal=True)
    assert {n: launch_counts()[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    # a tensor off the CPU never takes the plain version: it launches or raises
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        kfa.flash_fwd(*meta, causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        kfa.flash_bwd_dq(*meta, meta[0], lse.to("meta"), delta.to("meta"), causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        kfa.flash_bwd_dkv(*meta, meta[0], lse.to("meta"), delta.to("meta"), causal=True)
    with pytest.raises(ValueError, match="Hm in"):
        kfa.flash_fwd(*args[:3], args[3].expand(2, 3, 16, 1), causal=True)


def test_flags_refuse_the_unported_train_kernels():
    assert paddle_tpu_torch.get_flags(["FLAGS_use_pallas_fused", "FLAGS_use_fused_loss",
                                       "FLAGS_use_pallas_attention"]) == {
        "FLAGS_use_pallas_fused": True, "FLAGS_use_fused_loss": True, "FLAGS_use_pallas_attention": True}
    try:  # both values of use_fused_loss are real paths, as in JAX
        for value in (False, True):
            paddle_tpu_torch.set_flags({"FLAGS_use_pallas_fused": True, "FLAGS_use_fused_loss": value})
            assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"]) == {"FLAGS_use_fused_loss": value}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": True})
    for name, value, why in [("FLAGS_use_pallas_fused", False, "outside"),
                             ("FLAGS_use_pallas_attention", False, "flash"),
                             ("FLAGS_use_fused_loss", "False", "bool"), ("FLAGS_use_fused_loss", 0, "bool")]:
        with pytest.raises(ValueError, match=why):
            paddle_tpu_torch.set_flags({name: value})
    # a refused value sets nothing: the string "False" did not turn the fused loss on or off
    assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"]) == {"FLAGS_use_fused_loss": True}
