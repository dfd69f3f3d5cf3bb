"""Kernels 17-19 of the PyTorch port (the fused linear cross entropy:
forward, dX, dW) and the train step that runs them, against the JAX package.

- The plain versions (what the kernel wrappers run for CPU tensors), through
  the port's autograd ``Function``, against ``paddle_tpu``'s
  ``fused_linear_cross_entropy`` run two ways: its ``lax.scan`` reference
  and its Pallas kernels in interpret mode (``block=(16, 128)``), loss by
  value and ``dX``, ``dW`` by ``jax.vjp`` against torch autograd. Both
  weight layouts, the three reductions, a ragged vocab (200, not a multiple
  of 128), ignored rows, a label past V, and all rows ignored.
- Tolerances. fp32: every side forms the same fp32 logits and sums, in
  other orders; each output is a sum of at most max(H, V) = 200 terms, so
  a relative error of 1e-5 (~80 fp32 ulps) bounds the reordering, with an
  absolute floor of 1e-5 of the largest element for entries that cancel.
  bf16: both sides round ``D = (p - onehot) * gcoef`` to bf16 from fp32
  values that agree to a few fp32 ulps, so an element of the rounded D may
  differ by one bf16 ulp (2^-7 of it, the 8-bit significand); dX and dW may
  then differ by 2^-7 of the sum of |D| |W| (resp. |x| |D|) before their
  own rounding to bf16, which adds one ulp of the result: the gate is
  ``2^-7 (|D| |W|) + 2^-7 |ref|`` per element. The loss is fp32 from the
  same bf16 inputs: 1e-5 relative.
- The public entry's gate (kernels only when ``FLAGS_use_fused_loss`` and
  H % 128 == 0; ``weight_scale`` refused) and the model contract: with the
  flag on, ``LlamaForCausalLM(ids, labels=...)`` returns ``(loss, None)`` as
  the JAX model does, and a two-layer hidden-256 model carried across with
  ``from_paddle_tpu_state`` matches the JAX model's loss and every gradient
  in fp32 at 1e-4 (the tolerance the port's other model tests hold: the
  whole forward and backward reorder fp32 sums), with and without the
  document mask, each loss head running once per step.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.kernels.fused_loss import fused_linear_cross_entropy as jax_flce
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch
from paddle_tpu_torch.kernels import fused_loss as kloss
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F

IGN = -100
N, H, V = 24, 128, 200
BF16_ULP = 2.0 ** -7
PLAIN = ("flxent_fwd_plain", "flxent_bwd_plain")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the plain versions' calls (the CPU wrappers' bodies)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        real = getattr(kloss, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(kloss, name, spy)
    return calls


@pytest.fixture()
def fused_loss_on():
    """``FLAGS_use_fused_loss`` on in both packages (the default of each);
    the prior values are put back afterwards."""
    prior = paddle.get_flags(["FLAGS_use_fused_loss"])
    prior_port = paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"])
    paddle.set_flags({"FLAGS_use_fused_loss": True})
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": True})
    try:
        yield
    finally:
        paddle.set_flags(prior)
        paddle_tpu_torch.set_flags(prior_port)


def _data(seed, labels="mixed"):
    """x [N, H], W [H, V] (N(0, 0.05): logits of order 1), int32 labels:
    mostly in range, some ignored, one past V — or all ignored."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.05).astype(np.float32)
    lab = rng.integers(0, V, (N,)).astype(np.int32)
    if labels == "all ignored":
        lab[:] = IGN
    else:
        lab[[2, 9, 17]] = IGN
        lab[5] = 1 << 20  # past V and past any padded vocab of the JAX paths
    return x, w, lab


def _jax_loss_and_grads(x, w, lab, dtype, reduction, vocab_major, way, g):
    wl = w.T if vocab_major else w
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(wl, dtype)
    kw = dict(interpret=True, block=(16, 128)) if way == "pallas interpret" else {}

    def f(a, b):
        return jax_flce(a, b, jnp.asarray(lab), ignore_index=IGN, reduction=reduction,
                        vocab_major=vocab_major, **kw)

    loss, vjp = jax.vjp(f, jx, jw)
    dx, dw = vjp(jnp.asarray(g, jnp.float32))
    return (np.asarray(loss, np.float32), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port_loss_and_grads(x, w, lab, dtype, reduction, vocab_major, g):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T) if vocab_major else w).to(dtype).requires_grad_()
    loss = kloss.linear_cross_entropy(tx, tw, torch.from_numpy(lab), ignore_index=IGN, reduction=reduction,
                                      vocab_major=vocab_major)
    loss.backward(torch.from_numpy(np.asarray(g, np.float32)))
    return loss.detach().numpy(), tx.grad.float().numpy(), tw.grad.float().numpy()


def _d_abs(x, w, lab, reduction, g):
    """|D| = |(softmax - onehot) * gcoef| in fp64, the scale of one ulp of
    the rounded D (for the bf16 gate)."""
    logits = x.astype(np.float64) @ w.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    onehot = (np.arange(V)[None, :] == lab[:, None]).astype(np.float64)
    valid = lab != IGN
    if reduction == "mean":
        gc = np.full(N, float(g) / max(valid.sum(), 1))
    elif reduction == "sum":
        gc = np.full(N, float(g))
    else:
        gc = np.asarray(g, np.float64)
    return np.abs((p - onehot) * np.where(valid, gc, 0.0)[:, None])


@pytest.mark.parametrize("way", ["scan reference", "pallas interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_plain_versions_match_jax(way, dtype, reduction, vocab_major):
    x, w, lab = _data(seed=1)
    rng = np.random.default_rng(2)
    g = rng.normal(size=(N,)).astype(np.float32) if reduction == "none" else np.float32(1.7)
    if dtype == "bfloat16":  # both sides take the same bf16 values
        x, w = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, w))
    want = _jax_loss_and_grads(x, w, lab, getattr(jnp, dtype), reduction, vocab_major, way, g)
    got = _port_loss_and_grads(x, w, lab, getattr(torch, dtype), reduction, vocab_major, g)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    dw_want = want[2].T if vocab_major else want[2]
    dw_got = got[2].T if vocab_major else got[2]
    if dtype == "float32":
        for a, b in ((got[1], want[1]), (dw_got, dw_want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
        return
    d_abs = _d_abs(x, w, lab, reduction, g)
    for a, b, scale in ((got[1], want[1], d_abs @ np.abs(w.T)), (dw_got, dw_want, np.abs(x.T) @ d_abs)):
        limit = BF16_ULP * scale + BF16_ULP * np.abs(b)
        assert (np.abs(a - b) <= limit).all(), float((np.abs(a - b) / np.maximum(limit, 1e-30)).max())


@pytest.mark.parametrize("block", ["first", "ragged last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_d_chunk_matches_jax_block_d(block, dtype, vocab_major):
    """The recompute that the dX and dW kernels share: the port's
    ``flxent_dchunk`` (its plain version, on the CPU) against the JAX
    package's ``_flxent_block_d`` on the same block of vocab columns, from
    the same fp32 ``lse`` and ``gcoef``. fp32: 1e-5 relative (the same
    logits summed in another order), with an absolute floor of 1e-5 of the
    largest element. bf16: both round fp32 values that agree to a few fp32
    ulps, so an element may differ by one bf16 ulp of itself (2^-7)."""
    from paddle_tpu.kernels.fused_loss import _flxent_block_d

    x, w, lab = _data(seed=6)
    if dtype == "bfloat16":
        x, w = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, w))
    blk = 128
    j = 0 if block == "first" else (V - 1) // blk
    c0, c1 = j * blk, min((j + 1) * blk, V)
    wl = np.ascontiguousarray(w.T) if vocab_major else w
    tdt = getattr(torch, dtype)
    tx, tw, tlab = torch.from_numpy(x).to(tdt), torch.from_numpy(wl).to(tdt), torch.from_numpy(lab)
    lse, _ = kloss.flxent_fwd_plain(tx, tw, tlab, vocab_major)
    gcoef = torch.where(tlab != IGN, 1.0 / 21, 0.0)
    got = kloss.flxent_dchunk(tx, tw, tlab, lse, gcoef, c0, c1, vocab_major).float().numpy()
    # the JAX block sees W zero-padded to whole blocks, as its Pallas grid does
    vp = -(-V // blk) * blk
    wpad = np.zeros((vp, H) if vocab_major else (H, vp), np.float32)
    wpad[tuple(slice(0, n) for n in wl.shape)] = wl
    wblk = wpad[c0:c0 + blk] if vocab_major else wpad[:, c0:c0 + blk]
    jdt = getattr(jnp, dtype)
    want = _flxent_block_d(jnp.asarray(x, jdt), jnp.asarray(wblk, jdt), jnp.asarray(lab)[:, None],
                           jnp.asarray(lse.numpy())[:, None], jnp.asarray(gcoef.numpy())[:, None], j,
                           v=V, blk_v=blk, vocab_major=vocab_major)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == (N, c1 - c0) and not want[:, c1 - c0:].any()
    want = want[:, :c1 - c0]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= BF16_ULP * np.maximum(np.abs(got), np.abs(want))).all()


@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_all_rows_ignored_gives_zero_loss_and_gradients(vocab_major):
    x, w, lab = _data(seed=3, labels="all ignored")
    want = _jax_loss_and_grads(x, w, lab, jnp.float32, "mean", vocab_major, "pallas interpret", 1.0)
    got = _port_loss_and_grads(x, w, lab, torch.float32, "mean", vocab_major, 1.0)
    assert float(got[0]) == float(want[0]) == 0.0
    assert not got[1].any() and not got[2].any()


def test_forward_saves_inputs_and_lse_only():
    """Nothing of shape [N, V] outlives the forward: the graph holds x, W,
    the labels and the [N] lse."""
    x, w, lab = _data(seed=4)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = kloss.linear_cross_entropy(tx, tw, torch.from_numpy(lab))
    saved = loss.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(N, H), (H, V), (N,), (N,)]
    assert saved[3].dtype == torch.float32


def test_public_entry_gate_and_refusals(plain_calls, fused_loss_on, monkeypatch):
    x, w, lab = _data(seed=5)
    tx, tw, tl = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(lab)
    # H % 128 == 0 with the flag on: the kernels' wrappers (plain on the CPU);
    # otherwise the plain versions are called directly, as JAX runs its scan
    seen = []
    real_fwd = kloss.flxent_fwd
    monkeypatch.setattr(kloss, "flxent_fwd", lambda *a, **k: seen.append("kernel") or real_fwd(*a, **k))
    F.fused_linear_cross_entropy(tx, tw, tl)
    F.fused_linear_cross_entropy(tx[:, :96], tw[:96], tl)
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": False})
    F.fused_linear_cross_entropy(tx, tw, tl)
    assert seen == ["kernel"] and plain_calls["flxent_fwd_plain"] == 3
    # weight_scale (the int8 lm head) is ported: forward only, a backward raises
    w8 = torch.from_numpy(np.clip(np.round(w * 100), -127, 127).astype(np.int8))
    xg = tx.clone().requires_grad_()
    loss8 = F.fused_linear_cross_entropy(xg, w8, tl, weight_scale=torch.full((V,), 0.01))
    assert loss8.dtype == torch.float32 and torch.isfinite(loss8)
    with pytest.raises(RuntimeError, match="forward-only"):
        loss8.backward()
    with pytest.raises(ValueError, match="reduction"):
        F.fused_linear_cross_entropy(tx, tw, tl, reduction="max")
    per = F.fused_linear_cross_entropy(tx.reshape(2, 12, H), tw, tl.reshape(2, 12), reduction="none")
    assert per.shape == (2, 12) and per.dtype == torch.float32


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w, lab = (torch.from_numpy(a) for a in _data(seed=6))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kloss.flxent_fwd(x.to(**meta), w.to(**meta), lab.to(**meta))
    with pytest.raises(ValueError, match="unsupported device"):
        kloss.flxent_bwd(x.to(**meta), w.to(**meta), lab.to(**meta), torch.zeros(N, **meta), torch.zeros(N, **meta))


# -- the model at kernel widths ------------------------------------------------

B, S = 2, 24


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(41)
    jmodel = JaxLlama(JaxLlamaConfig(
        vocab_size=320, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
    ))
    jmodel.train()
    return jmodel


def _batch(seed=8):
    """Rows packed with documents of 3..10 tokens: ids, next-token labels
    within each document (-100 at its last token), and the C=1 FlashMask
    bounds holding each column's document end."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 320, (B, S)).astype(np.int32)
    labels = np.full((B, S), -100, np.int32)
    ends = np.zeros((B, S), np.int32)
    for b in range(B):
        pos = 0
        while pos < S:
            end = min(S, pos + int(rng.integers(3, 11)))
            ends[b, pos:end] = end
            labels[b, pos:end - 1] = ids[b, pos + 1:end]
            pos = end
    return ids, labels, ends[:, None, :, None].copy()


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "doc-mask"])
def test_two_layer_model_with_the_fused_loss_matches_jax(jax_model, fused_loss_on, plain_calls, masked):
    ids, labels, bounds = _batch()
    bounds = bounds if masked else None
    for p in jax_model.parameters():
        p.clear_grad()
    jloss, jlogits = jax_model(Tensor(ids), labels=Tensor(labels),
                               startend_row_indices=None if bounds is None else Tensor(bounds))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._data) for n, p in jax_model.named_parameters()}
    jcfg = jax_model.config
    model = from_paddle_tpu_state(
        {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()},
        LlamaConfig(vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
                    intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
                    num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
                    max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
                    rope_theta=jcfg.rope_theta, dtype="float32"),
        device="cpu")
    loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                         startend_row_indices=None if bounds is None else torch.from_numpy(bounds))
    loss.backward()
    assert jlogits is None and logits is None
    # one loss head per step: the launch counts chip_smoke.py gates on the card
    assert plain_calls == {"flxent_fwd_plain": 1, "flxent_bwd_plain": 1}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)


def test_fused_loss_is_the_default_and_off_returns_the_logits(jax_model):
    assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"]) == {"FLAGS_use_fused_loss": True}
    ids, labels, _ = _batch(seed=9)
    model = from_paddle_tpu_state(
        {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()},
        LlamaConfig(vocab_size=320, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
                    rms_norm_eps=jax_model.config.rms_norm_eps, dtype="float32"),
        device="cpu")
    fused, none = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": False})
    try:
        plain, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": True})
    assert none is None and logits.shape == (B, S, 320)
    # the same function, two summation orders over fp32 logits
    np.testing.assert_allclose(fused.item(), plain.item(), rtol=1e-5)
