"""Kernels 11-13 of the PyTorch port (the residual RMSNorm's adjoint, the
residual LayerNorm and its adjoint), the two incubate residual-norm entries,
and GPT pretraining, against the JAX package on the CPU.

- The kernels' plain versions (what their wrappers run for CPU tensors)
  against the Pallas kernels in interpret mode, at H 256 and 384 over row
  counts that are not a multiple of 128, in bf16 and fp32: ``y``, ``r`` and
  ``dx`` within 1 bf16 ulp in bf16 and 1e-6 in fp32; ``dw``/``db`` within
  1e-5 relative in fp32 (atol 1e-5: a reordered fp32 sum of ~140 terms)
  and within 1 bf16 ulp once cast.
- ``fused_rms_norm_residual`` and ``fused_layer_norm_residual`` against the
  JAX entries, forward and backward with both outputs in the loss: at H
  256 the JAX entries run their Pallas kernels in interpret mode (the test
  lets them, as on a TPU) and the port its kernels' plain versions; at H
  64 both run the composition forward and the fp32 adjoint formula.
- A two-layer GPT (hidden 256, two heads of dim 128, so 12/13 and 14-16
  are on their plain-version path; and ``GPTConfig.tiny()``, which reaches
  none of them) carried across with ``from_paddle_tpu_state``: logits, the
  loss and every gradient match the JAX model in fp32 at 1e-4 with
  ``FLAGS_use_fused_decode_layer`` and ``FLAGS_use_fused_loss`` each on and
  off; spies count one ``ln_residual_plain`` and one
  ``ln_residual_bwd_plain`` call per layer and step where the rule holds
  and none elsewhere; two ``AdamW(multi_precision=True)`` steps match.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as jax_incubate
import paddle_tpu.kernels.fused as jax_fused
import paddle_tpu.kernels.select as jax_select
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.kernels.fused import (
    fused_layer_norm_residual_pallas,
    layer_norm_residual_adjoint_pallas,
    rms_norm_residual_adjoint_pallas,
)
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT

import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn import functional as incubate
from paddle_tpu_torch.kernels import fused as kfused
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Dropout
from paddle_tpu_torch.optimizer import AdamW

EPS = 1e-5
SPIED = ("ln_residual_plain", "ln_residual_bwd_plain", "rms_residual_bwd_plain", "fused_rms_norm_residual_plain")
FLAGS = ("FLAGS_use_fused_decode_layer", "FLAGS_use_fused_loss")


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
    """Counts of the residual norms' plain versions' calls (the CPU
    wrappers' bodies: on the card each is a kernel launch)."""
    calls = dict.fromkeys(SPIED, 0)
    for name in SPIED:
        real = getattr(kfused, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(kfused, name, spy)
    return calls


@pytest.fixture()
def flags():
    """Set the same flags in both packages; the prior values are put back."""
    prior, prior_port = paddle.get_flags(list(FLAGS)), paddle_tpu_torch.get_flags(list(FLAGS))

    def set_both(values):
        paddle.set_flags(values)
        paddle_tpu_torch.set_flags(values)

    try:
        yield set_both
    finally:
        paddle.set_flags(prior)
        paddle_tpu_torch.set_flags(prior_port)


@pytest.fixture()
def jax_pallas_interpret(monkeypatch):
    """The JAX entries take their Pallas branch, as on a TPU, with the
    kernels run in interpret mode (their tests' way on the CPU)."""
    monkeypatch.setattr(jax_select, "pallas_enabled", lambda flag: True)
    for name in ("fused_rms_norm_residual_pallas", "rms_norm_residual_adjoint_pallas",
                 "fused_layer_norm_residual_pallas", "layer_norm_residual_adjoint_pallas"):
        monkeypatch.setattr(jax_fused, name, functools.partial(getattr(jax_fused, name), interpret=True))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _f32(a) -> np.ndarray:
    if isinstance(a, Tensor):
        a = a._data
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


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


def _close_sum(got, want, dtype: str) -> None:
    """A weight or bias gradient: a sum over rows, in fp32 then cast."""
    if dtype == "bfloat16":
        assert _bf16_ulps(_f32(got), _f32(want)) <= 1
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    return dict(
        x=rng.normal(size=shape).astype(np.float32),
        res=(2 * rng.normal(size=shape)).astype(np.float32),
        w=(1 + 0.1 * rng.normal(size=h)).astype(np.float32),
        b=(0.1 * rng.normal(size=h)).astype(np.float32),
        g=rng.normal(size=shape).astype(np.float32),
        gr=rng.normal(size=shape).astype(np.float32),
    )


# -- (a) kernels 11, 12, 13: plain versions against the Pallas kernels ---------------

SHAPES = [(3, 47, 256), (130, 384)]
SHAPE_IDS = ["141-rows-H256", "130-rows-H384"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_ln_residual_plain_matches_pallas_interpret(dtype, shape):
    a = _inputs(shape, 50 + shape[-1])
    (xj, xt), (rj, rt), (wj, wt), (bj, bt), (gj, gt) = (_pair(a[k], dtype) for k in ("x", "res", "w", "b", "g"))
    _, r_j = fused_layer_norm_residual_pallas(xj, rj, wj, bj, EPS, interpret=True)
    yt, r_t = kfused.ln_residual(xt, wt, bt, rt, EPS)
    assert yt.dtype == r_t.dtype == xt.dtype and yt.shape == shape
    np.testing.assert_array_equal(_f32(r_t), _f32(r_j))  # the add in the I/O dtype
    # y from the rounded r: the Pallas kernel rounds r = x + res to the I/O
    # dtype before its statistics, but XLA on the CPU keeps the interpret
    # body's bf16 sum in fp32 (it stores the rounded r and normalises the
    # unrounded one), so the statistics are held with x = r and res = 0
    yj, _ = fused_layer_norm_residual_pallas(r_j, jnp.zeros_like(r_j), wj, bj, EPS, interpret=True)
    _close(yt, yj, dtype)
    dxj, dwj, dbj = layer_norm_residual_adjoint_pallas(gj, r_j, wj, EPS, interpret=True)
    dxt, dwt, dbt = kfused.ln_residual_bwd(gt, r_t, wt, EPS)
    assert dxt.dtype == dwt.dtype == dbt.dtype == xt.dtype
    _close(dxt, dxj, dtype)
    _close_sum(dwt, dwj, dtype)
    _close_sum(dbt, dbj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_residual_without_bias_is_a_zero_bias(dtype):
    a = _inputs((2, 9, 256), 53)
    (xj, xt), (rj, rt), (wj, wt) = (_pair(a[k], dtype) for k in ("x", "res", "w"))
    yt, r_t = kfused.ln_residual(xt, wt, None, rt, EPS)
    yj, _ = fused_layer_norm_residual_pallas(xj + rj, jnp.zeros_like(rj), wj, None, EPS, interpret=True)
    _close(yt, yj, dtype)
    assert torch.equal(yt, kfused.ln_residual(xt, wt, torch.zeros_like(wt), rt, EPS)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_rms_residual_bwd_plain_matches_pallas_interpret(dtype, shape):
    a = _inputs(shape, 60 + shape[-1])
    (xj, xt), (rj, rt), (wj, wt), (gj, gt) = (_pair(a[k], dtype) for k in ("x", "res", "w", "g"))
    r_j, r_t = xj + rj, xt + rt
    np.testing.assert_array_equal(_f32(r_t), _f32(r_j))
    dxj, dwj = rms_norm_residual_adjoint_pallas(gj, r_j, wj, EPS, interpret=True)
    dxt, dwt = kfused.rms_residual_bwd(gt, r_t, wt, EPS)
    assert dxt.dtype == dwt.dtype == xt.dtype
    _close(dxt, dxj, dtype)
    _close_sum(dwt, dwj, dtype)


# -- (b) the incubate entries against JAX's ---------------------------------------------

def _entry_grads(is_rms: bool, dtype: str, h: int):
    """Both packages' entry on the same inputs, forward and backward with
    both outputs' cotangents; returns ``(port, jax)`` lists of y, r and the
    x, residual, weight (and bias) gradients."""
    a = _inputs((2, 5, h), 70 + h)
    # x and residual on a grid of 1/32 below 4 in magnitude: their sum is
    # exact in bf16, so XLA's unrounded interpret sum (see above) is the
    # kernel's rounded one
    rng = np.random.default_rng(71 + h)
    a["x"], a["res"] = (rng.integers(-127, 128, (2, 5, h)).astype(np.float32) / 32 for _ in range(2))
    names = ("x", "w", "res") if is_rms else ("x", "w", "b", "res")
    pairs = {k: _pair(a[k], dtype) for k in (*names, "g", "gr")}
    jin = [Tensor(pairs[k][0], stop_gradient=False) for k in names]
    tin = [pairs[k][1].requires_grad_() for k in names]
    if is_rms:
        jy, jr = jax_incubate.fused_rms_norm_residual(*jin, EPS)
        ty, tr = incubate.fused_rms_norm_residual(*tin, EPS)
    else:
        jy, jr = jax_incubate.fused_layer_norm_residual(*jin, EPS)
        ty, tr = incubate.fused_layer_norm_residual(*tin, EPS)
    assert type(ty.grad_fn).__name__ == "ResidualNormFunctionBackward"
    paddle.autograd.backward([jy, jr], [Tensor(pairs["g"][0]), Tensor(pairs["gr"][0])])
    torch.autograd.backward([ty, tr], [pairs["g"][1], pairs["gr"][1]])
    port = [ty, tr] + [t.grad for t in tin]
    ref = [jy, jr] + [t.grad for t in jin]
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_rms", [False, True], ids=["layer_norm", "rms_norm"])
def test_entries_match_jax_with_the_kernel_rule_on(jax_pallas_interpret, plain_calls, is_rms, dtype):
    port, ref = _entry_grads(is_rms, dtype, 256)
    if is_rms:
        assert plain_calls == {**dict.fromkeys(SPIED, 0), "fused_rms_norm_residual_plain": 1,
                               "rms_residual_bwd_plain": 1}
    else:
        assert plain_calls == {**dict.fromkeys(SPIED, 0), "ln_residual_plain": 1, "ln_residual_bwd_plain": 1}
    for i, (got, want) in enumerate(zip(port, ref)):
        (_close_sum if i >= 4 else _close)(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_rms", [False, True], ids=["layer_norm", "rms_norm"])
def test_entries_match_jax_outside_the_kernel_rule(plain_calls, is_rms, dtype):
    """H 64: the composition forward (LayerNorm's statistics in the I/O
    dtype) and JAX's fp32 adjoint formula, never autograd of the
    composition: the same numbers as the JAX entries, no kernel."""
    port, ref = _entry_grads(is_rms, dtype, 64)
    assert plain_calls == dict.fromkeys(SPIED, 0)
    for i, (got, want) in enumerate(zip(port, ref)):
        (_close_sum if i >= 4 else _close)(got, want, dtype)


def test_entry_without_grad_runs_the_forward_only(plain_calls):
    a = _inputs((2, 3, 256), 80)
    x, w, b, res = (torch.from_numpy(a[k]) for k in ("x", "w", "b", "res"))
    w.requires_grad_()
    with torch.no_grad():
        y, r = incubate.fused_layer_norm_residual(x, w, b, res, EPS)
    assert y.grad_fn is None and r.grad_fn is None
    y2, _ = incubate.fused_layer_norm_residual(x, w.detach(), b, res, EPS)  # nothing needs a gradient
    assert y2.grad_fn is None and torch.equal(y, y2)
    assert plain_calls["ln_residual_plain"] == 2 and plain_calls["ln_residual_bwd_plain"] == 0


def test_layer_norm_is_the_jax_composition_in_bf16():
    """``F.layer_norm`` keeps JAX's statistics in the I/O dtype (PyTorch's
    ``layer_norm`` computes in fp32 and rounds a bf16 row differently)."""
    a = _inputs((4, 7, 96), 81)
    (xj, xt), (wj, wt), (bj, bt) = (_pair(a[k], "bfloat16") for k in ("x", "w", "b"))
    want = paddle.nn.functional.layer_norm(Tensor(xj), [96], Tensor(wj), Tensor(bj), EPS)
    got = F.layer_norm(xt, [96], wt, bt, EPS)
    assert _bf16_ulps(_f32(got), _f32(want)) <= 1
    lib = torch.nn.functional.layer_norm(xt, (96,), wt, bt, EPS)
    assert not torch.equal(got, lib)


# -- (c) a two-layer GPT against the JAX model --------------------------------------------

B, S = 2, 24
WIDE = dict(vocab_size=320, hidden_size=256, num_layers=2, num_heads=2, max_position=64)


def _jax_gpt(cfg_kw, seed=41):
    """A JAX GPT with every parameter made non-trivial (LayerNorm weights
    near 1, biases and embeddings small random), and its state as numpy."""
    paddle.seed(seed)
    jmodel = JaxGPT(JaxGPTConfig(**cfg_kw))
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jmodel.state_dict().items():
        a = np.asarray(v._data)
        if k.endswith("embeddings.weight"):
            a = 0.05 * rng.normal(size=a.shape)
        elif k.endswith(".bias"):
            a = 0.05 * rng.normal(size=a.shape)
        elif "ln_" in k:
            a = 1 + 0.1 * rng.normal(size=a.shape)
        state[k] = a.astype(np.float32)
    jmodel.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    jmodel.train()
    return jmodel, state


def _batch(vocab, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.full((B, S), -100, np.int32)
    labels[:, :-1] = ids[:, 1:]
    labels[0, 5] = -100
    return ids, labels


@pytest.mark.parametrize("fused_loss", [True, False], ids=["fused-loss", "unfused-loss"])
@pytest.mark.parametrize("fused_layer", [True, False], ids=["fused-ln2", "unfused-ln2"])
@pytest.mark.parametrize("width", ["h256", "tiny"])
def test_two_layer_gpt_matches_jax(flags, plain_calls, width, fused_layer, fused_loss):
    cfg_kw = WIDE if width == "h256" else dict(vars(JaxGPTConfig.tiny(vocab=320)))
    flags({"FLAGS_use_fused_decode_layer": fused_layer, "FLAGS_use_fused_loss": fused_loss})
    jmodel, state = _jax_gpt(cfg_kw)
    model = from_paddle_tpu_state(state, GPTConfig(**cfg_kw), device="cpu")
    assert isinstance(model, GPTForPretraining) and model.dtype == torch.float32
    ids, labels = _batch(cfg_kw["vocab_size"])
    jloss, jlogits = jmodel(Tensor(ids), labels=Tensor(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._data) for n, p in jmodel.named_parameters()}
    loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    kernel_width = width == "h256" and fused_layer
    layers = cfg_kw["num_layers"]
    assert plain_calls == {**dict.fromkeys(SPIED, 0), "ln_residual_plain": layers * kernel_width,
                           "ln_residual_bwd_plain": layers * kernel_width}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    if fused_loss:
        assert logits is None and jlogits is None
    else:
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)
    with torch.no_grad():
        plain = model(torch.from_numpy(ids))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jmodel(Tensor(ids))._data), rtol=1e-4, atol=1e-4)


def test_two_adamw_steps_match_jax(flags):
    """Two train steps (forward, backward, ``AdamW(multi_precision=True)``)
    on the fp32 model: each step's loss matches JAX's within 1e-5, so the
    first update agrees. Then the optimizer alone on GPT's parameters in
    bf16 with fp32 masters, fed the same seeded gradients in both packages
    (a gradient at rounding-noise level, as the key bias's exact zero,
    makes Adam step by the noise's sign, so the model's own gradients
    cannot hold the parameters to 1e-5): masters within 1e-5, each bf16
    parameter its master rounded."""
    flags({"FLAGS_use_fused_decode_layer": True, "FLAGS_use_fused_loss": True})
    jmodel, state = _jax_gpt(WIDE, seed=43)
    model = from_paddle_tpu_state(state, GPTConfig(**WIDE), device="cpu")
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jmodel.parameters(), multi_precision=True)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(), multi_precision=True)
    ids, labels = _batch(WIDE["vocab_size"], seed=8)
    for _ in range(2):
        jloss, _ = jmodel(Tensor(ids), labels=Tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        loss, _ = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    bf_state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in state.items()}
    jmodel = JaxGPT(JaxGPTConfig(**WIDE)).to(dtype="bfloat16")
    jmodel.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in bf_state.items()})
    model = from_paddle_tpu_state(bf_state, GPTConfig(**WIDE), device="cpu")
    assert model.dtype == torch.bfloat16
    jparams, params = dict(jmodel.named_parameters()), dict(model.named_parameters())
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=list(jparams.values()), multi_precision=True)
    opt = AdamW(learning_rate=1e-2, parameters=list(params.values()), multi_precision=True)
    rng = np.random.default_rng(13)
    for _ in range(2):
        for name, p in params.items():
            g = np.asarray(jnp.asarray(rng.normal(size=tuple(p.shape)).astype(np.float32), jnp.bfloat16))
            jparams[name].grad = Tensor(jnp.asarray(g))
            p.grad = torch.from_numpy(g.view(np.uint16).copy()).view(torch.bfloat16)
        jopt.step()
        jopt.clear_grad()
        opt.step()
        opt.clear_grad()
    for name, p in params.items():
        master = opt._state_for(p)["master_weight"]
        jmaster = np.asarray(jopt._accumulators[id(jparams[name])]["master_weight"])
        np.testing.assert_allclose(master.numpy(), jmaster, rtol=1e-5, atol=1e-5, err_msg=name)
        assert torch.equal(p.detach(), master.to(torch.bfloat16)), name


def test_gpt_entry_points():
    cfg = GPTConfig(**WIDE)
    model = GPTForPretraining(cfg, device="cpu", seed=3)
    names = dict(model.named_parameters())
    assert float(names["gpt.layers.0.ln_2.weight"].detach().min()) == 1.0 and not names["gpt.ln_f.bias"].any()
    assert not names["gpt.layers.1.attn.qkv_proj.bias"].any()
    assert abs(float(names["gpt.embeddings.word_embeddings.weight"].detach().std()) - 0.02) < 2e-3
    again = GPTForPretraining(cfg, device="cpu", seed=3)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))
    assert GPTConfig.gpt3_13b() == GPTConfig() and GPTConfig.gpt3_13b().hidden_size == 5120
    # dropout runs in train mode (once refused here); the identity in eval mode
    x = torch.ones(4096)
    y = Dropout(0.1)(x)
    assert set(torch.unique(y).tolist()) <= {0.0, float(x[0] / torch.tensor(0.9))} and 0 < int((y == 0).sum()) < 4096
    assert torch.equal(Dropout(0.1).eval()(x), x)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        from_paddle_tpu_state({k: v for k, v in state.items() if "ln_f" not in k}, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        from_paddle_tpu_state({**state, "gpt.ln_f.bias": np.zeros(3, np.float32)}, cfg, device="cpu")
