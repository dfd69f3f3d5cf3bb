"""The port's training surface against the JAX package: learning-rate
schedulers, gradient clipping, parameter groups, AdamW's decay rule and
``amsgrad``, the optimizer ``state_dict`` and its resume (also of a JAX
optimizer's state), dropout and attention dropout, ``recompute`` replaying
the port's generators, the full ``cross_entropy``, the tied-embedding
Llama (training and the engine), and the entries' accepted-and-ignored
arguments (``flashmask_attention``, fused rope).

Every comparison runs on the CPU, where the port's wrappers run their plain
versions. Dropout draws PyTorch's random numbers, not JAX's, so it is held
by statistics and against a numpy composition fed the port's own mask. The
tests use one torch thread and put back every flag and generator they
touch.
"""

import contextlib
import copy
import dataclasses
import io
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jax_clip
import paddle_tpu.nn.functional as jax_F
import paddle_tpu.optimizer.lr as jax_lr
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn.functional import fused_rotary_position_embedding as jax_rope
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.kernels.quant import quantize_module_weights as jax_quantize_module_weights
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.incubate.nn.functional import fused_rotary_position_embedding
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.kernels.quant import quantize_module_weights
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state, optimizer_state_from_paddle_tpu
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Dropout
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

from test_torch_serving import ENGINE_KW, JAX_ONLY_KW, _jax_engine_globals_preserved



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


@pytest.fixture(autouse=True)
def _port_generators_restored():
    """Every generator of the port as it was before the test."""
    before = rng.get_rng_state()
    try:
        yield
    finally:
        rng.set_rng_state(before)


@contextlib.contextmanager
def _flags(**values):
    """``FLAGS_<name>`` set in BOTH packages, put back afterwards."""
    names = [f"FLAGS_{k}" for k in values]
    prior, prior_port = paddle.get_flags(names), paddle_tpu_torch.get_flags(names)
    paddle.set_flags({f"FLAGS_{k}": v for k, v in values.items()})
    paddle_tpu_torch.set_flags({f"FLAGS_{k}": v for k, v in values.items()})
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
        rope_theta=jcfg.rope_theta, tie_word_embeddings=jcfg.tie_word_embeddings, dtype="float32", **kw,
    )


def _state(jmodel):
    return {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    def ordered(x):
        bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


# -- learning-rate schedulers ---------------------------------------------------------

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.93),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.07),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.3),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 20, end_lr=0.01, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(0.5, 7, end_lr=0.01, power=1.5, cycle=True),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 17, 30], [0.4, 0.2, 0.1, 0.05]),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(3e-4, T_max=23, eta_min=3e-5),
    "LinearWarmup": lambda m: m.LinearWarmup(0.3, 8, 0.0, 0.3),
    "LinearWarmup-cosine": lambda m: m.LinearWarmup(m.CosineAnnealingDecay(3e-4, T_max=30, eta_min=3e-5), 6, 0.0,
                                                    3e-4),
    "StepDecay": lambda m: m.StepDecay(0.5, 7, gamma=0.6),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [4, 11, 40], gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.5, lambda e: 0.97),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, factor=0.5, patience=2, cooldown=1),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 40, phase_pct=0.25),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(0.1, 40, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 6, step_size_down=4, mode="triangular2"),
    "CyclicLR-exp": lambda m: m.CyclicLR(0.01, 0.1, 5, mode="exp_range", exp_gamma=0.97),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(0.2, 5, T_mult=2, eta_min=0.01),
    "LinearLR": lambda m: m.LinearLR(0.2, 30, start_factor=0.25),
}


def _advance(sched, k):
    metric = 1.0 / (1 + k % 7)  # ReduceOnPlateau reads a metric: plateaus every 7 steps
    if isinstance(sched, (jax_lr.ReduceOnPlateau, port_lr.ReduceOnPlateau)):
        sched.step(metric)
    else:
        sched.step()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequences_equal_jax_and_survive_a_state_dict_round_trip(name):
    """50 steps, the learning rates equal as floats; after 25 a fresh
    scheduler restored from the state dict goes on as the first one does."""
    make = SCHEDULERS[name]
    ours, theirs = make(port_lr), make(jax_lr)
    assert type(ours).__name__ == type(theirs).__name__
    seq, want = [], []
    for k in range(50):
        seq.append(ours())
        want.append(theirs())
        if k == 25:
            sd = copy.deepcopy(ours.state_dict())
            restored = make(port_lr)
            restored.set_state_dict(sd)
            assert sd == ours.state_dict()  # set_state_dict leaves the dict as it was
            ours = restored
        _advance(ours, k)
        _advance(theirs, k)
    assert seq == want


def test_every_jax_scheduler_has_its_port():
    want = set(jax_lr.__all__)
    assert want == set(port_lr.__all__) and len(want) == 18
    assert {type(SCHEDULERS[n](port_lr)).__name__ for n in SCHEDULERS} == want - {"LRScheduler"}


# -- gradient clipping ---------------------------------------------------------------

def _params_grads(seed=3):
    """Four parameters (fp32 and bf16), one with need_clip=False, one
    without a grad, as (port, JAX) lists of (param, grad)."""
    r = np.random.default_rng(seed)
    shapes = [(7, 5), (11,), (3, 4, 2), (6, 6)]
    port, theirs = [], []
    for i, shape in enumerate(shapes):
        w = r.normal(size=shape).astype(np.float32)
        g = (3 * r.normal(size=shape)).astype(np.float32)
        if i == 1:  # a bf16 parameter and grad
            w, g = _bf16(w), _bf16(g)
        p = torch.nn.Parameter(_torch_of(w))
        jp = JaxParameter(jnp.asarray(w))
        if i == 2:
            p.need_clip = jp.need_clip = False
        grad, jgrad = (None, None) if i == 3 else (_torch_of(g), Tensor(jnp.asarray(g)))
        port.append((p, grad))
        theirs.append((jp, jgrad))
    return port, theirs


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_clip_classes_match_jax(kind):
    port, theirs = _params_grads()
    make = {"value": lambda m: m.ClipGradByValue(2.5, min=-1.5), "norm": lambda m: m.ClipGradByNorm(4.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0)}[kind]
    got, want = make(clip)(port), make(jax_clip)(theirs)
    for i, ((p, g), (jp, jg), (_, g0)) in enumerate(zip(got, want, port)):
        if jg is None:
            assert g is None
            continue
        assert g.dtype == g0.dtype and (g is g0) == (kind == "global_norm" and i == 2)  # new grads, p.grad kept
        np.testing.assert_allclose(g.float().numpy(), np.asarray(jg._data, np.float32), rtol=1e-6, atol=1e-7)
    if kind == "global_norm":  # need_clip=False: out of the norm and unscaled
        assert got[2][1] is port[2][1]
        gnorm = clip.ClipGradByGlobalNorm(1.0).global_norm([port[0][1], port[1][1]])
        jnorm = jax_clip.ClipGradByGlobalNorm(1.0).global_norm([theirs[0][1], theirs[1][1]])
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, 3.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    port, theirs = _params_grads(5)
    for (p, g), (jp, jg) in zip(port, theirs):
        p.grad, jp.grad = g, jg
    total = clip.clip_grad_norm_([p for p, _ in port], 2.0, norm_type=norm_type)
    jtotal = jax_clip.clip_grad_norm_([jp for jp, _ in theirs], 2.0, norm_type=norm_type)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    for (p, _), (jp, _) in zip(port, theirs):
        if jp.grad is not None:
            np.testing.assert_allclose(p.grad.float().numpy(), np.asarray(jp.grad._data, np.float32),
                                       rtol=1e-6, atol=1e-7)


# -- the recipe: groups, decay rule, clip, schedule, amsgrad ----------------------------

@pytest.fixture(scope="module")
def jax_bf16_state():
    paddle.seed(31)
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    return {k: _bf16(v) for k, v in _state(jmodel).items()}


def _recipe(pkg, model_params, names, amsgrad, decay_names):
    """Llama 2's recipe at a tiny scale in either package: warmup then
    cosine, the global-norm clip at 1.0, two groups (the lm head with its
    own weight decay), the norms undecayed, a per-parameter lr factor."""
    lr_mod = port_lr if pkg == "port" else jax_lr
    sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(3e-2, T_max=4, eta_min=3e-3), 2, 0.0, 3e-2)
    head = [p for n, p in zip(names, model_params) if n == "lm_head.weight"]
    rest = [p for n, p in zip(names, model_params) if n != "lm_head.weight"]
    groups = [{"params": rest}, {"params": head, "weight_decay": 0.05}]
    kw = dict(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-5, parameters=groups, weight_decay=0.1,
              apply_decay_param_fun=lambda n: n in decay_names, multi_precision=True, amsgrad=amsgrad)
    if pkg == "port":
        return AdamW(grad_clip=clip.ClipGradByGlobalNorm(1.0), lr_ratio=lambda p: 0.5, **kw), sched
    return paddle.optimizer.AdamW(grad_clip=jax_clip.ClipGradByGlobalNorm(1.0), lr_ratio=lambda p: 0.5, **kw), sched


def _paired(state, amsgrad):
    """The port's and JAX's bf16 tiny Llama from one state, each with the
    recipe's optimizer (names differ: the JAX package's are automatic)."""
    jmodel = JaxLlama(JaxLlamaConfig.tiny()).to(dtype="bfloat16")
    jmodel.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    model = from_paddle_tpu_state(state, _port_config(JaxLlamaConfig.tiny()), device="cpu")
    jparams = dict(jmodel.named_parameters())
    params = dict(model.named_parameters())
    names = list(params)
    assert names == list(jparams)
    for name in ("llama.layers.1.mlp.up_proj.weight",):  # a per-parameter lr factor, in both
        params[name].optimize_attr = {"learning_rate": 0.5}
        jparams[name].optimize_attr = {"learning_rate": 0.5}
    decayed = [n for n in names if not n.endswith("norm.weight")]
    opt, sched = _recipe("port", list(params.values()), names, amsgrad, set(decayed))
    jopt, jsched = _recipe("jax", list(jparams.values()), names, amsgrad,
                           {jparams[n].name for n in decayed})
    return (model, params, opt, sched), (jmodel, jparams, jopt, jsched)


def _feed(params, jparams, r):
    """The same bf16 gradients into both models (norm ~40: the clip acts);
    ``jparams`` None: the port's model only, the same draws."""
    for name, p in params.items():
        g = _bf16((0.3 * r.normal(size=tuple(p.shape))).astype(np.float32))
        if jparams is not None:
            jparams[name].grad = Tensor(jnp.asarray(g))
        p.grad = _torch_of(g)


def _assert_same(params, jparams, opt, jopt):
    for name, p in params.items():
        assert _bf16_ulps(p.detach().float().numpy(), np.asarray(jparams[name]._data, np.float32)) <= 1, name
        st, jst = opt._state_for(p), jopt._accumulators[id(jparams[name])]
        assert sorted(st) == sorted(jst), name
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=1e-6, atol=1e-7, err_msg=f"{name} {k}")


@pytest.mark.parametrize("amsgrad", [False, True], ids=["adamw", "amsgrad"])
def test_recipe_steps_match_jax(jax_bf16_state, amsgrad):
    (model, params, opt, sched), (jmodel, jparams, jopt, jsched) = _paired(jax_bf16_state, amsgrad)
    undecayed = [n for n, p in params.items() if opt._param_weight_decay(p, 0.1) == 0.0]
    assert undecayed and all(n.endswith("norm.weight") for n in undecayed)
    assert len(undecayed) == 2 * JaxLlamaConfig.tiny().num_hidden_layers + 1
    r = np.random.default_rng(17)
    for _ in range(3):
        assert opt.get_lr() == jopt.get_lr()
        _feed(params, jparams, r)
        grads = [p.grad for p in params.values()]
        norm = clip.ClipGradByGlobalNorm(1.0).global_norm(grads)
        assert float(norm) > 1.0  # the clip scales this step
        opt.step()
        jopt.step()
        assert all(p.grad is g for p, g in zip(params.values(), grads))  # the clip leaves p.grad as it was
        opt.clear_grad()
        jopt.clear_grad()
        sched.step()
        jsched.step()
        _assert_same(params, jparams, opt, jopt)
    assert opt._step_count == jopt._step_count == 3


def test_state_dict_resume_is_bitwise_and_carries_a_jax_run(jax_bf16_state):
    """Two steps, ``torch.save`` of the model and optimizer, a fresh model
    and optimizer restored from it, two more steps: bit for bit the four
    steps of one run. Then a JAX run's optimizer state after two steps,
    carried across, continues as the JAX run does."""
    def run(steps, model, opt, sched, r):
        for _ in range(steps):
            _feed(dict(model.named_parameters()), None, r)
            opt.step()
            opt.clear_grad()
            sched.step()

    (model, params, opt, sched), _ = _paired(jax_bf16_state, amsgrad=True)
    r = np.random.default_rng(23)
    run(4, model, opt, sched, r)

    (m2, _, o2, s2), _ = _paired(jax_bf16_state, amsgrad=True)
    r2 = np.random.default_rng(23)
    run(2, m2, o2, s2, r2)
    buf = io.BytesIO()
    torch.save({"model": m2.state_dict(), "opt": o2.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf)
    assert saved["opt"]["_step_count"] == 2 and "LR_Scheduler" in saved["opt"]
    assert "llama.norm.weight__moment2_max" in saved["opt"]
    (m3, _, o3, s3), _ = _paired(jax_bf16_state, amsgrad=True)
    m3.load_state_dict(saved["model"])
    o3.set_state_dict(saved["opt"])
    assert s3() == s2() and o3._step_count == 2
    run(2, m3, o3, s3, r2)
    for (name, p), q in zip(model.named_parameters(), m3.parameters()):
        assert torch.equal(p, q), name
        for k, v in opt._state_for(p).items():
            assert torch.equal(v, o3._state_for(q)[k]), f"{name} {k}"

    # a JAX run's state carried into the port after 2 steps, then 2 more steps in each package
    (model, params, opt, sched), (jmodel, jparams, jopt, jsched) = _paired(jax_bf16_state, amsgrad=True)
    r = np.random.default_rng(29)
    for _ in range(2):
        _feed(params, jparams, r)
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        for p in params.values():
            p.grad = None
    jsd = {k: (v if k in ("_step_count", "LR_Scheduler") else np.asarray(v._data)) for k, v in jopt.state_dict().items()}
    carried = optimizer_state_from_paddle_tpu(
        jsd, [(n, p.name) for n, p in jmodel.named_parameters()], model)
    model.load_state_dict({k: _torch_of(np.asarray(v._data)) for k, v in jmodel.state_dict().items()
                           if not k.endswith(("cos_cached", "sin_cached"))})
    opt.set_state_dict(carried)
    assert opt._step_count == 2 and sched() == jsched()
    for _ in range(2):
        _feed(params, jparams, r)
        opt.step()
        jopt.step()
        opt.clear_grad()
        jopt.clear_grad()
        sched.step()
        jsched.step()
        _assert_same(params, jparams, opt, jopt)
    with pytest.raises(KeyError, match="names no parameter"):
        optimizer_state_from_paddle_tpu({"param_nowhere__moment1": np.zeros(1)},
                                        [(n, p.name) for n, p in jmodel.named_parameters()], model)


# -- dropout -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_statistics(dtype, mode):
    n, p = 1_000_000, 0.3
    x = (torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.5).to(dtype)
    rng.seed(7)
    y = F.dropout(x, p, mode=mode)
    kept = y != 0
    sigma = math.sqrt(n * p * (1 - p))
    assert abs(int(kept.sum()) - n * (1 - p)) < 4 * sigma
    want = x / float(torch.tensor(1 - p, dtype=dtype)) if mode == "upscale_in_train" else x
    assert torch.equal(y[kept], want[kept]) and y.dtype == dtype
    rng.seed(7)
    assert torch.equal(F.dropout(x, p, mode=mode), y)  # the same generator state, the same mask
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(F.dropout(x, p, mode=mode, generator=gen), y)  # the port's generator is seeded alike
    assert not torch.equal(F.dropout(x, p, mode=mode), y)  # the state moved on
    for same in (F.dropout(x, p, training=False, mode=mode), F.dropout(x, 0.0, mode=mode)):
        assert same is x  # identity in eval mode and at p == 0 (JAX scales nothing at inference)
    layer = Dropout(p, mode=mode)
    assert layer.eval()(x) is x


def test_dropout_axis_broadcasts_the_mask():
    x = torch.ones(64, 40, 32)
    y = F.dropout(x, 0.5, axis=[0, 2])
    mask = y != 0
    assert torch.equal(mask, mask[:, :1, :].expand_as(mask))  # one mask value along dim 1
    frac = float(mask[:, 0, :].float().mean())
    assert 0.4 < frac < 0.6
    z = Dropout(0.5, axis=1)(x)
    assert torch.equal(z != 0, (z != 0)[:1, :, :1].expand_as(z))
    with pytest.raises(ValueError):
        F.dropout(x, 0.5, mode="dropout_everything")


def test_recompute_replays_the_dropout_mask():
    """A segment with two dropouts under ``recompute``: the rerun's dropout
    outputs (so their masks) equal the forward's bit for bit, and the
    gradients equal those of the same segment run without recompute from
    the same generator state."""
    torch.manual_seed(0)
    lin1, lin2 = torch.nn.Linear(16, 32), torch.nn.Linear(32, 8)
    drop1, drop2 = Dropout(0.4), Dropout(0.2)

    def segment(x):
        return lin2(drop2(torch.relu(drop1(lin1(x)))))

    seen = {drop1: [], drop2: []}
    for d in seen:
        d.register_forward_hook(lambda m, i, o: seen[m].append(o.detach().clone()))
    x0 = torch.randn(10, 16)
    grads = {}
    for use in (True, False):
        rng.seed(3)
        x = x0.clone().requires_grad_(True)
        for m in (lin1, lin2):
            m.zero_grad(set_to_none=True)
        out = recompute(segment, x) if use else segment(x)
        torch.randn(4, generator=rng.default_generator())  # a draw between the forward and the backward
        (out * torch.arange(8.0)).sum().backward()
        grads[use] = [x.grad.clone(), lin1.weight.grad.clone(), lin2.weight.grad.clone()]
    for outs in seen.values():  # recompute: the forward and the rerun; plain: the forward
        assert len(outs) == 3 and torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    # the rerun puts the generator back where the forward left it
    rng.seed(3)
    segment(x0)
    after_plain = rng.get_rng_state("cpu")
    rng.seed(3)
    recompute(segment, x0.clone().requires_grad_(True)).sum().backward()
    assert torch.equal(rng.get_rng_state("cpu"), after_plain)


def test_attention_dropout_matches_a_numpy_composition_fed_the_same_mask():
    r = np.random.default_rng(41)
    b, s, h, d, p = 2, 12, 2, 64, 0.25
    q, k, v = (r.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    rng.seed(9)
    state = rng.get_rng_state("cpu")
    out, _ = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), dropout=p, causal=True)
    rng.set_rng_state(state, "cpu")
    keep = torch.empty(b, h, s, s).bernoulli_(1 - p, generator=rng.default_generator()).bool().numpy()
    qh, kh, vh = (np.moveaxis(a, 2, 1).astype(np.float64) for a in (q, k, v))
    logits = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(d)
    logits = np.where(np.tril(np.ones((s, s), bool)), logits, -1e30)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.moveaxis(np.where(keep, probs / (1 - p), 0.0) @ vh, 1, 2)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    # without training, or at p == 0: the flash path, the same output as dropout 0
    plain, _ = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), dropout=0.0, causal=True)
    off, _ = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), dropout=p, causal=True, training=False)
    assert torch.equal(plain, off)


# -- cross entropy -----------------------------------------------------------------------

CE_CASES = [(w, soft, sm, ls, ign) for w in (False, True) for soft in (False, True) for sm in (True, False)
            for ls in (0.0, 0.1) for ign in (False, True) if not (soft and ign)]


@pytest.mark.parametrize("weighted,soft,use_softmax,smoothing,ignored", CE_CASES)
def test_cross_entropy_matches_jax_loss_and_grad(weighted, soft, use_softmax, smoothing, ignored):
    r = np.random.default_rng(13)
    n, c = 9, 7
    x = r.normal(size=(n, c)).astype(np.float32)
    if not use_softmax:  # probabilities in
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    if soft:
        lab = r.random(size=(n, c)).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = r.integers(0, c, n).astype(np.int64)
        if ignored:
            lab[[1, 4]] = -100
    w = (0.5 + r.random(c)).astype(np.float32) if weighted else None
    kw = dict(soft_label=soft, use_softmax=use_softmax, label_smoothing=smoothing)
    for reduction in ("mean", "sum", "none"):
        t = torch.from_numpy(x).requires_grad_(True)
        loss = F.cross_entropy(t, torch.from_numpy(lab), weight=None if w is None else torch.from_numpy(w),
                               reduction=reduction, **kw)
        jt = Tensor(jnp.asarray(x), stop_gradient=False)
        jloss = jax_F.cross_entropy(jt, Tensor(jnp.asarray(lab)), weight=None if w is None else Tensor(jnp.asarray(w)),
                                    reduction=reduction, **kw)
        np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss._data), rtol=1e-5, atol=1e-6)
        (loss * torch.arange(1.0, 1.0 + loss.numel()).reshape(loss.shape)).sum().backward()
        cot = np.arange(1.0, 1.0 + loss.numel(), dtype=np.float32).reshape(tuple(loss.shape))
        (jloss * Tensor(jnp.asarray(cot))).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt.grad._data), rtol=1e-5, atol=1e-6)


def test_cross_entropy_axis_and_half_precision():
    r = np.random.default_rng(19)
    x = r.normal(size=(3, 6, 5)).astype(np.float32)
    lab = r.random(size=(3, 6, 5)).astype(np.float32)
    lab /= lab.sum(1, keepdims=True)
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab), soft_label=True, axis=1, label_smoothing=0.2)
    want = jax_F.cross_entropy(jnp.asarray(x), jnp.asarray(lab), soft_label=True, axis=1, label_smoothing=0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    hard = r.integers(0, 5, (3, 6))
    for axis in (-1, 2):  # the hard label's class axis is the last
        got = F.cross_entropy(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(hard), axis=axis,
                              label_smoothing=0.1)
        want = jax_F.cross_entropy(jnp.asarray(x, jnp.bfloat16), jnp.asarray(hard), axis=axis, label_smoothing=0.1)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the tied-embedding Llama ------------------------------------------------------------

@pytest.fixture(scope="module")
def tied_models():
    paddle.seed(37)
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), tie_word_embeddings=True)
    jmodel = JaxLlama(jcfg)
    state = _state(jmodel)
    assert not any(k.startswith("lm_head") for k in state)
    return jmodel, state, jcfg


@pytest.mark.parametrize("fused", [True, False], ids=["fused-loss", "unfused-loss"])
def test_tied_llama_loss_logits_and_embedding_grad_match_jax(tied_models, fused):
    jmodel, state, jcfg = tied_models
    model = from_paddle_tpu_state(state, _port_config(jcfg), device="cpu")
    assert model.lm_head is None
    r = np.random.default_rng(43)
    ids = r.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    with _flags(use_fused_loss=fused):
        jmodel.train()
        for p in jmodel.parameters():
            p.clear_grad()
        jloss, jlogits = jmodel(Tensor(ids), labels=Tensor(labels))
        jloss.backward()
        loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert (logits is None) == (jlogits is None) == fused
    if not fused:
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jmodel.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)
    with torch.no_grad():
        plain = model(torch.from_numpy(ids))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jmodel(Tensor(ids))._data), rtol=1e-4, atol=1e-4)


def _drive(eng, prompts, budgets):
    ids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    out = {}
    while eng.has_work():
        out.update({req.req_id: list(req.generated) for req in eng.step()})
    return [out[i] for i in ids]


def test_tied_llama_engine_streams_equal_the_jax_engine(tied_models):
    jmodel, state, jcfg = tied_models
    jmodel.eval()
    model = from_paddle_tpu_state(state, _port_config(jcfg), device="cpu").eval()
    r = np.random.default_rng(47)
    prompts = [r.integers(0, jcfg.vocab_size, n) for n in (19, 3, 11)]
    budgets = [7, 9, 5]
    with _jax_engine_globals_preserved():
        want = _drive(JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW), prompts, budgets)
    got = _drive(ContinuousBatchingEngine(model, **ENGINE_KW), prompts, budgets)
    assert [len(g) for g in got] == budgets and got == want
    # weight-only int8 with a tied head: what the JAX quantizer takes (the MLP projections; there is no
    # lm_head leaf, and the shared embedding stays floating)
    jfresh = JaxLlama(jcfg)
    jfresh.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    jnames = {id(p): n for n, p in jfresh.named_parameters()}
    want = sorted(jnames[id(p)] for p in jax_quantize_module_weights(jfresh))
    fresh = from_paddle_tpu_state(state, _port_config(jcfg), device="cpu")
    got = sorted(quantize_module_weights(fresh))
    assert got == want and len(got) == 3 * jcfg.num_hidden_layers
    assert fresh.llama.embed_tokens.weight.is_floating_point()


# -- the entries' accepted-and-ignored arguments ---------------------------------------------

def test_flashmask_and_rope_accept_and_ignore_what_jax_ignores():
    r = np.random.default_rng(53)
    b, s, h, d = 2, 16, 2, 64
    q, k, v = (r.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    bounds = np.full((b, 1, s, 1), s, np.int32)
    bounds[:, :, :5] = 9
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    jq = [Tensor(jnp.asarray(a)) for a in (q, k, v)]
    extra = dict(window_size=(4, 0), return_softmax_lse=True, return_seed_offset=True, fixed_seed_offset=(1, 2),
                 rng_name="x", dropout=0.3)
    got = F.flashmask_attention(*tq, startend_row_indices=torch.from_numpy(bounds), **extra)
    want = jax_F.flashmask_attention(*jq, startend_row_indices=Tensor(jnp.asarray(bounds)), **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), rtol=1e-5, atol=1e-5)
    plain = F.flashmask_attention(*tq, startend_row_indices=torch.from_numpy(bounds))
    assert torch.equal(got, plain)  # every extra, dropout included, ignored with the bounds
    cos = np.cos(r.normal(size=(s, d))).astype(np.float32)
    sin = np.sin(r.normal(size=(s, d))).astype(np.float32)
    rope_kw = dict(position_ids=np.arange(s)[None], time_major=True)
    got = fused_rotary_position_embedding(tq[0], tq[1], None, sin=torch.from_numpy(sin), cos=torch.from_numpy(cos),
                                          **rope_kw)
    want = jax_rope(jq[0], jq[1], None, sin=Tensor(sin), cos=Tensor(cos), **rope_kw)
    for a, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w._data), rtol=1e-6, atol=1e-6)
    got = fused_rotary_position_embedding(tq[0], None, None, rotary_emb_base=500000.0)
    want = jax_rope(jq[0], None, None, rotary_emb_base=500000.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]._data), rtol=1e-6, atol=1e-6)
