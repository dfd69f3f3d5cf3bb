"""Kernels 7-10 of the PyTorch port (RMSNorm forward and backward, rope
forward and adjoint) and the train step that runs them, against the JAX
package.

- The kernels' plain versions (what their wrappers run for CPU tensors)
  against the Pallas kernels in interpret mode and their ``jax.vjp``, in
  bf16 and fp32: ``y`` and ``dx`` within 1 bf16 ulp in bf16 and 1e-6 in
  fp32; ``dw`` within 1e-5 relative (atol 1e-6 for a reordered fp32 sum of
  a few dozen terms) in fp32, and within 1 bf16 ulp once cast to bf16.
- The JAX dispatch rules: a kernel-eligible shape goes through the
  ``Function`` (seen by spying on the plain versions), other shapes
  through the unfused compositions; ``FLAGS_use_pallas_fused=False`` is
  refused; the serving step runs none of the four.
- A two-layer model whose widths reach the kernels (hidden 256, head dim
  128, GQA 2/1) carried across with ``from_paddle_tpu_state``: loss, logits
  and every gradient match the JAX model in fp32 at 1e-4, with and without
  the document mask and recompute. On the CPU the JAX model runs its XLA
  compositions (Pallas is TPU-only there); in fp32 they agree with the
  kernels' order to rounding.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.kernels.fused import fused_rms_norm_pallas, fused_rope_pallas, rope_adjoint_pallas
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn.functional import fused_rotary_position_embedding
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.kernels import fused as kfused
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F

EPS = 1e-5
PLAIN = ("rms_norm_fwd_plain", "rms_norm_bwd_plain", "rope_fwd_plain", "rope_bwd_plain")


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
    """Counts of the four plain versions' calls (the CPU wrappers' bodies)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        real = getattr(kfused, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(kfused, name, spy)
    return calls


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    arrays given as fp32 values (sign-magnitude bit patterns)."""
    def ordered(x):
        bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _close(got, want, dtype: str) -> None:
    if dtype == "bfloat16":
        assert _bf16_ulps(_f32(got), _f32(want)) <= 1
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)


# -- (a) RMSNorm: kernels 7 and 8 ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 128), (21, 256)], ids=["3x7-rows-H128", "21-rows-H256"])
def test_rms_norm_plain_matches_pallas_interpret_and_its_vjp(dtype, shape):
    rng = np.random.default_rng(40 + shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    (xj, xt), (wj, wt), (gj, gt) = (_pair(a, dtype) for a in (x, w, g))
    yj, vjp = jax.vjp(lambda a, b: fused_rms_norm_pallas(a, b, EPS, interpret=True), xj, wj)
    dxj, dwj = vjp(gj)
    yt, rstd = kfused.rms_norm_fwd(xt, wt, EPS)
    dxt, dwt = kfused.rms_norm_bwd(xt, wt, rstd, gt)
    assert yt.dtype == dxt.dtype == dwt.dtype == xt.dtype
    assert rstd.dtype == torch.float32 and rstd.shape == shape[:-1]
    _close(yt, yj, dtype)
    _close(dxt, dxj, dtype)
    if dtype == "bfloat16":
        assert _bf16_ulps(_f32(dwt), _f32(dwj)) <= 1
    else:
        np.testing.assert_allclose(_f32(dwt), _f32(dwj), rtol=1e-5, atol=1e-6)
    # rstd is the fp32 statistic of the rows
    np.testing.assert_allclose(
        rstd.numpy(), 1 / np.sqrt((_f32(xt) ** 2).mean(-1) + EPS), rtol=1e-6)


def test_rms_norm_function_gradients_are_the_backward_kernels():
    """Autograd through ``RMSNormFunction`` gives ``rms_norm_bwd``'s dx and
    dw, and both agree with autograd's own derivative of the plain forward."""
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.normal(size=(2, 5, 128)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=128)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 5, 128)).astype(np.float32))
    kfused.fused_rms_norm(x, w, EPS).backward(g)
    _, rstd = kfused.rms_norm_fwd_plain(x.detach(), w.detach(), EPS)
    dx, dw = kfused.rms_norm_bwd(x.detach(), w.detach(), rstd, g)
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    xa, wa = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    kfused.rms_norm_fwd_plain(xa, wa, EPS)[0].backward(g)
    np.testing.assert_allclose(dx.numpy(), xa.grad.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), wa.grad.numpy(), rtol=1e-5, atol=1e-6)


# -- (b) rope: kernels 9 and 10 -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_plain_matches_pallas_interpret_for_q_and_k(dtype):
    """q and k with different head counts, asymmetric random tables."""
    rng = np.random.default_rng(45)
    s, d = 6, 128
    cos = np.cos(rng.normal(size=(s, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(s, d))).astype(np.float32)
    cj, ct = _pair(cos, "float32")
    sj, st = _pair(sin, "float32")
    for heads in (4, 2):
        x = rng.normal(size=(2, s, heads, d)).astype(np.float32)
        g = rng.normal(size=(2, s, heads, d)).astype(np.float32)
        (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
        yt, dxt = kfused.rope_fwd(xt, ct, st), kfused.rope_bwd(gt, ct, st)
        assert yt.dtype == dxt.dtype == xt.dtype
        _close(yt, fused_rope_pallas(xj, cj, sj, interpret=True), dtype)
        _close(dxt, rope_adjoint_pallas(gj, cj, sj, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_function_gradients_match_jax_vjp_with_table_cotangents(dtype):
    rng = np.random.default_rng(46)
    s, d = 5, 128
    x = rng.normal(size=(2, s, 3, d)).astype(np.float32)
    g = rng.normal(size=(2, s, 3, d)).astype(np.float32)
    cos = np.cos(rng.normal(size=(s, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(s, d))).astype(np.float32)
    (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
    (cj, ct), (sj, st) = _pair(cos, "float32"), _pair(sin, "float32")
    yj, vjp = jax.vjp(lambda a, c, sn: fused_rope_pallas(a, c, sn, interpret=True), xj, cj, sj)
    dxj, dcj, dsj = vjp(gj)
    xt, ct, st = (t.requires_grad_() for t in (xt, ct, st))
    yt = kfused.fused_rope(xt, ct, st)
    yt.backward(gt)
    _close(yt.detach(), yj, dtype)
    _close(xt.grad, dxj, dtype)
    for got, want in ((ct.grad, dcj), (st.grad, dsj)):
        assert got.dtype == torch.float32 and got.shape == (s, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # tables that need no gradient: only x's, and x is not kept for it
    xt2 = xt.detach().clone().requires_grad_()
    y2 = kfused.fused_rope(xt2, ct.detach(), st.detach())
    assert y2.grad_fn.saved_tensors[0] is None
    y2.backward(gt)
    assert torch.equal(xt2.grad, xt.grad)


# -- (c) dispatch -----------------------------------------------------------------

def test_rms_norm_dispatch_follows_the_jax_rule(plain_calls):
    rng = np.random.default_rng(47)
    x = torch.from_numpy(rng.normal(size=(2, 3, 128)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=128)).astype(np.float32)).requires_grad_()
    F.rms_norm(x, w, EPS).sum().backward()
    assert plain_calls == {**dict.fromkeys(PLAIN, 0), "rms_norm_fwd_plain": 1, "rms_norm_bwd_plain": 1}
    x64 = x.detach()[..., :64]
    ineligible = [
        (x64, w.detach()[:64], True),  # H % 128 != 0
        (x.detach(), None, True),  # no weight
        (x.detach(), w.detach(), False),  # upcast off
        (x.detach(), w.detach().double(), True),  # the weight's dtype differs
    ]
    for xi, wi, upcast in ineligible:
        out = F.rms_norm(xi, wi, EPS, upcast=upcast)
        assert out.shape == xi.shape
    assert plain_calls["rms_norm_fwd_plain"] == 1
    # the composition and the kernel order agree to rounding in fp32
    np.testing.assert_allclose(F.rms_norm(x.detach(), w.detach(), EPS).numpy(),
                               (F.rms_norm(x.detach(), None, EPS) * w.detach()).numpy(), rtol=1e-6, atol=1e-6)


def test_rope_dispatch_follows_the_jax_rule(plain_calls):
    rng = np.random.default_rng(48)
    s = 4

    def tables(d, lead=()):
        c = np.cos(rng.normal(size=(*lead, s, d))).astype(np.float32)
        sn = np.sin(rng.normal(size=(*lead, s, d))).astype(np.float32)
        return torch.from_numpy(c), torch.from_numpy(sn)

    q = torch.from_numpy(rng.normal(size=(2, s, 4, 128)).astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.normal(size=(2, s, 2, 128)).astype(np.float32)).requires_grad_()
    cos, sin = tables(128)
    qr, kr, none = fused_rotary_position_embedding(q, k, None, sin=sin, cos=cos)
    assert none is None
    (qr.sum() + kr.sum()).backward()
    assert plain_calls == {**dict.fromkeys(PLAIN, 0), "rope_fwd_plain": 2, "rope_bwd_plain": 2}
    # [1, S, 1, D] tables collapse to [S, D]: still the kernel
    fused_rotary_position_embedding(q.detach(), None, None, sin=sin[None, :, None], cos=cos[None, :, None])
    assert plain_calls["rope_fwd_plain"] == 3
    # composition: per-batch tables, D % 128 != 0, the interleaved style
    cb, sb = tables(128, (2,))
    q16 = q.detach()[..., :16]
    c16, s16 = tables(16)
    fused_rotary_position_embedding(q.detach(), sin=sb[:, :, None], cos=cb[:, :, None])
    fused_rotary_position_embedding(q16, sin=s16, cos=c16)
    fused_rotary_position_embedding(q.detach(), sin=sin, cos=cos, use_neox_rotary_style=False)
    assert plain_calls["rope_fwd_plain"] == 3
    # in fp32 the kernel's order and the composition agree to rounding
    from paddle_tpu_torch.incubate.nn.functional import _rope_apply_xla

    np.testing.assert_allclose(qr.detach().numpy(), _rope_apply_xla(q.detach(), sin, cos, True).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_use_pallas_fused_is_on_and_off_is_refused():
    assert paddle_tpu_torch.get_flags(["FLAGS_use_pallas_fused"]) == {"FLAGS_use_pallas_fused": True}
    with pytest.raises(ValueError, match="outside"):
        paddle_tpu_torch.set_flags({"FLAGS_use_pallas_fused": False})
    assert paddle_tpu_torch.get_flags(["FLAGS_use_pallas_fused"]) == {"FLAGS_use_pallas_fused": True}


def test_serving_step_runs_none_of_the_train_kernels(plain_calls):
    """One slot (so the rope tables are [1, s, 1, D], kernel-eligible if the
    serving step routed through the dispatch) at widths the kernels take:
    the step's norms are kernels B and C, its rope kernel A's."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
                      dtype="float32")
    model = paddle_tpu_torch.models.LlamaForCausalLM(cfg, device="cpu", seed=3)
    model.eval()
    eng = ContinuousBatchingEngine(model, max_slots=1, block_size=4, prompt_bucket=16,
                                   max_model_len=32, prefill_chunk=8)
    eng.add_request(np.arange(11) % 64, max_new_tokens=3)
    done = eng.run()
    assert [len(r.generated) for r in done.values()] == [3]
    assert plain_calls == dict.fromkeys(PLAIN, 0)


# -- (d) a two-layer model at kernel widths ---------------------------------------

B, S = 2, 24


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(31)
    jmodel = JaxLlama(JaxLlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
    ))
    jmodel.train()
    return jmodel


@pytest.fixture()
def jax_unfused_loss():
    """Both packages with their loss heads unfused (the model returns
    logits); the prior flag values are put back afterwards."""
    prior = paddle.get_flags(["FLAGS_use_fused_loss"])
    prior_port = paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"])
    paddle.set_flags({"FLAGS_use_fused_loss": False})
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": False})
    try:
        yield
    finally:
        paddle.set_flags(prior)
        paddle_tpu_torch.set_flags(prior_port)


def _port_config(jcfg, **kw):
    return LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
        num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
        max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
        rope_theta=jcfg.rope_theta, dtype="float32", **kw,
    )


def _state(jmodel):
    return {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}


def _batch(seed=6):
    """Rows packed with documents of 3..10 tokens: ids, next-token labels
    within each document (-100 at its last token), and the C=1 FlashMask
    bounds holding each column's document end."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, S)).astype(np.int32)
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
def test_two_layer_model_at_kernel_widths_matches_jax(jax_model, jax_unfused_loss, plain_calls, masked):
    ids, labels, bounds = _batch()
    bounds = bounds if masked else None
    layers = jax_model.config.num_hidden_layers
    for recompute in (False, True):
        jmodel = jax_model
        if recompute:  # the same weights under the JAX package's own recompute
            jmodel = JaxLlama(dataclasses.replace(jax_model.config, recompute=True))
            jmodel.set_state_dict(jax_model.state_dict())
            jmodel.train()
        for p in jmodel.parameters():
            p.clear_grad()
        jloss, jlogits = jmodel(Tensor(ids), labels=Tensor(labels),
                                startend_row_indices=None if bounds is None else Tensor(bounds))
        jloss.backward()
        jgrads = {n: np.asarray(p.grad._data) for n, p in jmodel.named_parameters()}
        model = from_paddle_tpu_state(_state(jax_model), _port_config(jax_model.config, recompute=recompute),
                                      device="cpu")
        plain_calls.update(dict.fromkeys(PLAIN, 0))
        loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                             startend_row_indices=None if bounds is None else torch.from_numpy(bounds))
        loss.backward()
        # every norm and rope went through kernels 7-10 (their plain versions
        # on the CPU): the launch counts chip_smoke.py gates on the card
        runs = 2 if recompute else 1
        assert plain_calls == {"rms_norm_fwd_plain": 2 * layers * runs + 1, "rms_norm_bwd_plain": 2 * layers + 1,
                               "rope_fwd_plain": 2 * layers * runs, "rope_bwd_plain": 2 * layers}
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert sorted(grads) == sorted(jgrads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)
