"""The PyTorch port's training slice against the JAX package.

A seeded tiny JAX ``LlamaForCausalLM`` is carried into the port with
``from_paddle_tpu_state``. One train forward and backward (a document-packed
batch, labels ``-100`` at each document's end, with and without the
FlashMask document mask, per-layer recompute on and off) must give JAX's
``(loss, logits)`` and every parameter's gradient in fp32 at 1e-4, with the
JAX package's fused loss head off (``FLAGS_use_fused_loss=False``, the
configuration the port implements). Three ``AdamW(multi_precision=True)``
steps on bf16 parameters, fed the same gradients, must leave the same bf16
parameters (1 bf16 ulp) and fp32 masters as the JAX optimizer. On the CPU
the port's attention runs its kernels' plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jax_F
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn.functional import fused_rotary_position_embedding as jax_rope
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn.functional import fused_rotary_position_embedding
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

B, S = 2, 24


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


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(21)
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    jmodel.train()
    return jmodel


def _state(jmodel):
    return {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}


def _batch(seed=4):
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


def _port_step(model, ids, labels, bounds):
    model.zero_grad(set_to_none=True)
    loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                         startend_row_indices=None if bounds is None else torch.from_numpy(bounds))
    loss.backward()
    return loss, logits, {n: p.grad.clone() for n, p in model.named_parameters()}


def _jax_step(jmodel, ids, labels, bounds):
    for p in jmodel.parameters():
        p.clear_grad()
    jloss, jlogits = jmodel(Tensor(ids), labels=Tensor(labels),
                            startend_row_indices=None if bounds is None else Tensor(bounds))
    jloss.backward()
    return jloss, jlogits, {n: np.asarray(p.grad._data) for n, p in jmodel.named_parameters()}


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "doc-mask"])
def test_train_step_loss_logits_and_grads_match_jax(jax_model, jax_unfused_loss, masked):
    ids, labels, bounds = _batch()
    bounds = bounds if masked else None
    grads = {}
    for recompute in (False, True):
        jmodel = jax_model
        if recompute:  # the same weights under the JAX package's own recompute
            jmodel = JaxLlama(dataclasses.replace(jax_model.config, recompute=True))
            jmodel.set_state_dict(jax_model.state_dict())
            jmodel.train()
        jloss, jlogits, jgrads = _jax_step(jmodel, ids, labels, bounds)
        model = from_paddle_tpu_state(_state(jax_model), _port_config(jax_model.config, recompute=recompute),
                                      device="cpu")
        loss, logits, grads[recompute] = _port_step(model, ids, labels, bounds)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
        assert sorted(grads[recompute]) == sorted(jgrads)
        for name, g in grads[recompute].items():
            np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)
    # recompute reruns the same ops on the same inputs: identical gradients
    assert all(torch.equal(grads[False][n], grads[True][n]) for n in grads[False])


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "doc-mask"])
def test_use_flash_attention_false_converts_and_matches_jax(jax_model, jax_unfused_loss, masked):
    """The reference declares ``use_flash_attention`` and reads it nowhere, so
    a JAX model built with it False attends as with True; the port accepts
    the field and takes the same flash path."""
    jcfg = dataclasses.replace(jax_model.config, use_flash_attention=False)
    jmodel = JaxLlama(jcfg)
    jmodel.set_state_dict(jax_model.state_dict())
    jmodel.train()
    ids, labels, bounds = _batch(6)
    bounds = bounds if masked else None
    jloss, jlogits, _ = _jax_step(jmodel, ids, labels, bounds)
    cfg = _port_config(jcfg, use_flash_attention=jcfg.use_flash_attention)
    assert cfg.use_flash_attention is False
    model = from_paddle_tpu_state(_state(jmodel), cfg, device="cpu")
    loss, logits, _ = _port_step(model, ids, labels, bounds)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)


def test_rope_matches_jax_and_eval_mode_gives_the_train_mode_loss(jax_model):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
    cos = np.cos(rng.normal(size=(6, 16))).astype(np.float32)
    sin = np.sin(rng.normal(size=(6, 16))).astype(np.float32)
    got = fused_rotary_position_embedding(torch.from_numpy(q), torch.from_numpy(k), None,
                                          sin=torch.from_numpy(sin), cos=torch.from_numpy(cos))
    want = jax_rope(Tensor(q), Tensor(k), None, sin=Tensor(sin), cos=Tensor(cos))
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._data), rtol=1e-6, atol=1e-6)
    # train mode only switches recompute on: the loss is the same in eval mode
    model = from_paddle_tpu_state(_state(jax_model), _port_config(jax_model.config, recompute=True), device="cpu")
    ids, labels, bounds = _batch(5)
    with torch.no_grad():
        loss_train, _ = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        model.eval()
        loss_eval, _ = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert float(loss_train) == float(loss_eval)


def test_cross_entropy_matches_jax_for_half_precision_and_ignored_labels():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = -100
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = F.cross_entropy(torch.from_numpy(logits).to(dtype), torch.from_numpy(labels))
        want = jax_F.cross_entropy(jnp.asarray(logits, jdtype), jnp.asarray(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert got.dtype == torch.float32
    none = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), reduction="none")
    assert none.shape == (3, 5) and not none[0, :2].any()
    all_ignored = F.cross_entropy(torch.from_numpy(logits), torch.full((3, 5), -100))
    assert float(all_ignored) == 0.0  # denominator max(count, 1)


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    arrays given as fp32 values (sign-magnitude bit patterns)."""
    def ordered(x):
        bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def test_adamw_multi_precision_matches_jax_on_bf16_params(jax_model):
    """Both optimizers get the same fp32 gradients (rounded to bf16, as a
    bf16 backward leaves them) for three steps with a large learning rate."""
    state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in _state(jax_model).items()}
    jmodel = JaxLlama(JaxLlamaConfig.tiny()).to(dtype="bfloat16")
    jmodel.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    assert all(p.dtype == jnp.bfloat16 for p in jmodel.parameters())
    model = from_paddle_tpu_state(state, _port_config(jax_model.config), device="cpu")
    assert model.dtype == torch.bfloat16
    jparams = dict(jmodel.named_parameters())
    params = dict(model.named_parameters())
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=list(jparams.values()), multi_precision=True)
    opt = AdamW(learning_rate=1e-2, parameters=list(params.values()), multi_precision=True)
    rng = np.random.default_rng(12)
    for _ in range(3):
        for name, p in params.items():
            g = np.asarray(jnp.asarray(rng.normal(size=tuple(p.shape)).astype(np.float32), jnp.bfloat16))
            jparams[name].grad = Tensor(jnp.asarray(g))
            p.grad = torch.from_numpy(g.view(np.uint16).copy()).view(torch.bfloat16)
        jopt.step()
        jopt.clear_grad()
        opt.step()
        opt.clear_grad()
        assert all(p.grad is None for p in params.values())
    for name, p in params.items():
        want = np.asarray(jparams[name]._data, np.float32)
        assert _bf16_ulps(p.detach().float().numpy(), want) <= 1, name
        master = opt._state_for(p)["master_weight"]
        jmaster = np.asarray(jopt._accumulators[id(jparams[name])]["master_weight"])
        np.testing.assert_allclose(master.numpy(), jmaster, rtol=1e-6, atol=1e-7, err_msg=name)


def test_train_entry_points_refuse_what_the_port_lacks(jax_model):
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(), tie_word_embeddings=True), device="cpu")
    model = from_paddle_tpu_state(_state(jax_model), _port_config(jax_model.config), device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    # the dense prefill (use_cache without a past) is ported; static-cache decode is not
    logits, caches = model(ids, use_cache=True)
    assert logits.shape == (1, 4, jax_model.config.vocab_size) and len(caches) == jax_model.config.num_hidden_layers
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        model(ids, cache_position=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        F.flashmask_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                              dropout=0.1)
    with pytest.raises(NotImplementedError):
        AdamW(parameters=model.parameters(), grad_clip=object())


def test_flashmask_and_rope_entries_refuse_malformed_inputs():
    x = torch.zeros(1, 4, 2, 8)
    for dtype in (torch.int64, torch.int16, torch.float32):
        with pytest.raises(TypeError, match="int32"):
            F.flashmask_attention(x, x, x, startend_row_indices=torch.full((1, 1, 4, 1), 4, dtype=dtype))
    with pytest.raises(ValueError, match="sin and cos"):
        fused_rotary_position_embedding(x, x, None)
