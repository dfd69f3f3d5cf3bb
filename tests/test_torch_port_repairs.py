"""Three behaviours of the PyTorch port brought to the JAX package's, on the
CPU:

1. The serving call. The JAX engine calls its model as ``model(ids,
   past_key_values=pasts, use_cache=True, cache_position=lens)`` and takes
   ``(logits, pasts)`` back; the port's model takes the same call (its pools
   are updated in place, so the pasts returned are the tensors passed in)
   and its engine makes it.
2. The dispatch of kernels B and C. Like the JAX entries, the port's
   ``fused_embed_rms_norm`` and ``fused_rms_norm_residual`` reach the kernel
   only with a weight of the input's dtype and a last axis that is a
   multiple of 128, and otherwise run JAX's composition (fp32 statistics,
   downcast, then the weight) — bit for bit the JAX result in fp16. A
   model served in fp16 or fp32 emits the JAX engine's tokens.
3. The KV append without a host synchronisation. The JAX scatter drops
   invalid rows (past ``q_lens``, masked slots) by sending them out of
   bounds; the port writes no row through a boolean mask (whose output
   shape depends on the data, the host sync on a CUDA tensor), which shows
   on the CPU as an append that runs on ``meta`` tensors. The pools it
   leaves are bit-identical to the JAX append's.
4. The residual RMSNorm's gradient. The JAX entry records a tape node whose
   backward is the standalone adjoint kernel (11); the port's entry is a
   ``torch.autograd.Function`` whose backward is kernel 11's wrapper (on
   the card a raw launch would leave outputs with no ``grad_fn`` and lose
   every gradient), giving JAX's x, residual and weight gradients. And
   ``fused_embed_rms_norm`` returns both outputs cut from the graph, as the
   JAX entry returns them with ``stop_gradient``.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as jax_incubate
import paddle_tpu.incubate.nn.functional.block_attention as jax_ba
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.flight_recorder import GLOBAL_FLIGHT_RECORDER
from paddle_tpu.observability.recompile import GLOBAL_WATCHDOG

from paddle_tpu_torch.incubate.nn import functional as incubate
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.kernels import fused as kfused
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state

ENGINE_KW = dict(max_slots=3, block_size=4, prompt_bucket=24, max_model_len=64, prefill_chunk=8)
JAX_ONLY_KW = dict(enable_prefix_cache=False, spec_decode=False, kv_cache_dtype="bf16", tp=1)
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


@contextlib.contextmanager
def _jax_engine_globals_preserved():
    """Put the process-wide compile watchdog and flight recorder back as
    they were, so no other test in this worker sees this file's engines."""
    with GLOBAL_WATCHDOG._lock:
        ledger = copy.deepcopy(GLOBAL_WATCHDOG._fns)
    events = GLOBAL_FLIGHT_RECORDER.snapshot()
    try:
        yield
    finally:
        with GLOBAL_WATCHDOG._lock:
            GLOBAL_WATCHDOG._fns.clear()
            GLOBAL_WATCHDOG._fns.update(ledger)
        GLOBAL_FLIGHT_RECORDER.clear()
        GLOBAL_FLIGHT_RECORDER._events.extend(events)


def _port_config(jcfg, dtype):
    return LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
        num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
        max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
        rope_theta=jcfg.rope_theta, dtype=dtype,
    )


def _models(dtype: str):
    paddle.seed(11)
    jcfg = JaxLlamaConfig.tiny()
    jmodel = JaxLlama(jcfg)
    jmodel.eval()
    if dtype != "float32":
        jmodel.to(dtype=dtype)
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    return jmodel, from_paddle_tpu_state(state, _port_config(jcfg, dtype), device="cpu"), jcfg


# -- 1. the serving call --------------------------------------------------------

def test_reference_serving_call_returns_logits_and_the_pools_passed_in():
    jmodel, model, jcfg = _models("float32")
    kvh, hd = jcfg.num_key_value_heads, jcfg.hidden_size // jcfg.num_attention_heads
    shape = (8, kvh, 4, hd)
    toks = np.array([[5, 17, 3, 99, 0, 0], [8, 1, 2, 3, 4, 250], [0] * 6], np.int32)
    lens = np.zeros(3, np.int32)
    q_lens = np.array([4, 6, 0], np.int32)
    tables = np.array([[2, 0, 0, 0], [5, 1, 3, 0], [0, 0, 0, 0]], np.int32)
    active = np.array([True, True, False])
    jpkv = [tuple(Tensor(a) for a in (jnp.zeros(shape), jnp.zeros(shape), tables, lens, active, q_lens))
            for _ in range(jcfg.num_hidden_layers)]
    with paddle.no_grad():
        jlogits, jpast = jmodel(Tensor(toks), past_key_values=jpkv, use_cache=True, cache_position=Tensor(lens))
    t = [torch.from_numpy(a) for a in (tables, lens, active, q_lens)]
    pkv = [(torch.zeros(shape), torch.zeros(shape), *t) for _ in range(jcfg.num_hidden_layers)]
    with torch.inference_mode():
        logits, past = model(torch.from_numpy(toks), past_key_values=pkv, use_cache=True,
                             cache_position=torch.from_numpy(lens))
    assert past is pkv and all(a is b for p, q in zip(past, pkv) for a, b in zip(p, q))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    for p, jp in zip(past, jpast):
        np.testing.assert_allclose(p[0].numpy(), np.asarray(jp[0]._data), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p[1].numpy(), np.asarray(jp[1]._data), rtol=1e-5, atol=1e-5)
    # without a past, use_cache is the dense prefill: (logits, one (k, v) per layer), as in JAX
    with paddle.no_grad():
        jlogits, jcaches = jmodel(Tensor(toks), use_cache=True)
    with torch.inference_mode():
        logits, caches = model(torch.from_numpy(toks), use_cache=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    assert len(caches) == len(jcaches) == jcfg.num_hidden_layers
    for (k, v), (jk, jv) in zip(caches, jcaches):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk._data), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv._data), rtol=1e-5, atol=1e-5)
    # cache_position without a past is static-cache decoding, not ported yet
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        model(torch.from_numpy(toks), cache_position=torch.from_numpy(lens))
    # a paged past is the reference call's alone: no second, logits-only form
    for kw in (dict(), dict(use_cache=True), dict(cache_position=torch.from_numpy(lens))):
        with pytest.raises(NotImplementedError, match="use_cache=True, cache_position"):
            model(torch.from_numpy(toks), past_key_values=pkv, **kw)


def test_engine_makes_the_reference_call(monkeypatch):
    _, model, jcfg = _models("float32")
    calls = []
    forward = type(model).forward

    def spy(self, *args, **kwargs):
        calls.append(sorted(kwargs))
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(type(model), "forward", spy)
    eng = ContinuousBatchingEngine(model, **ENGINE_KW)
    eng.add_request(np.arange(5) + 1, max_new_tokens=3)
    eng.run()
    assert calls and all(c == ["cache_position", "past_key_values", "use_cache"] for c in calls)


# -- 2. kernels B and C follow the JAX rule -----------------------------------------

@pytest.fixture()
def kernel_calls(monkeypatch):
    """Calls of kernels B and C's wrappers (their plain versions run on the CPU)."""
    calls = {"fused_rms_norm_residual": 0, "fused_embed_rms_norm": 0}
    for name in calls:
        real = getattr(kfused, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(kfused, name, spy)
    return calls


@pytest.mark.parametrize("h,dtype,wdtype,kernel", [
    (128, torch.bfloat16, torch.bfloat16, True),
    (256, torch.float16, torch.float16, True),
    (128, torch.float32, torch.float32, True),
    (96, torch.bfloat16, torch.bfloat16, False),   # H % 128 != 0
    (128, torch.bfloat16, torch.float32, False),   # a weight of another dtype
])
def test_b_and_c_dispatch_follows_the_jax_rule(kernel_calls, h, dtype, wdtype, kernel):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, h)).astype(np.float32)).to(dtype)
    res = torch.from_numpy(rng.normal(size=(2, 3, h)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(1 + 0.1 * rng.normal(size=(h,)).astype(np.float32)).to(wdtype)
    table = torch.from_numpy(rng.normal(size=(10, h)).astype(np.float32)).to(dtype)
    incubate.fused_rms_norm_residual(x, w, res, EPS)
    incubate.fused_embed_rms_norm(torch.tensor([[1, 9, 3]]), table, w, EPS)
    assert kernel_calls == {"fused_rms_norm_residual": int(kernel), "fused_embed_rms_norm": int(kernel)}


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_b_and_c_composition_is_the_jax_composition_bit_for_bit(dtype):
    """H 64 and a weight of the input's dtype: both packages run the
    composition, whose every op rounds alike (fp32 statistics, one
    downcast, then the weight in the input dtype)."""
    rng = np.random.default_rng(2)
    x, res, table = (rng.normal(size=s).astype(np.float32) for s in ((2, 5, 64), (2, 5, 64), (12, 64)))
    w = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    ids = np.array([[0, 11, 4], [-2, 30, 7]], np.int32)  # a negative id and one past V

    def port(a):
        return torch.from_numpy(a).to(getattr(torch, dtype))

    def jax(a):
        return jnp.asarray(a, getattr(jnp, dtype))

    y, r = incubate.fused_rms_norm_residual(port(x), port(w), port(res), EPS)
    jy, jr = jax_incubate.fused_rms_norm_residual(Tensor(jax(x)), Tensor(jax(w)), Tensor(jax(res)), EPS)
    emb, ye = incubate.fused_embed_rms_norm(torch.from_numpy(ids), port(table), port(w), EPS)
    jemb, jye = jax_incubate.fused_embed_rms_norm(jnp.asarray(ids), jax(table), jax(w), EPS)
    for got, want in ((y, jy), (r, jr), (emb, jemb), (ye, jye)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want._data, np.float32))


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_engine_in_fp16_and_fp32_emits_the_jax_engine_tokens(dtype):
    jmodel, model, jcfg = _models(dtype)
    assert model.dtype == getattr(torch, dtype)
    rng = np.random.default_rng(5)
    prompts = [(rng.integers(0, jcfg.vocab_size, n), budget) for n, budget in ((19, 7), (3, 9), (11, 5))]

    def drive(eng):
        ids = [eng.add_request(p, max_new_tokens=b) for p, b in prompts]
        out = eng.run()
        return [list(out[i].generated) for i in ids]

    with _jax_engine_globals_preserved():
        want = drive(JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW))
    got = drive(ContinuousBatchingEngine(model, **ENGINE_KW))
    assert [len(g) for g in got] == [7, 9, 5]
    assert got == want


# -- 3. the KV append without a host synchronisation -------------------------------

def _append_inputs(rng, nb=10, h=2, bs=4, d=8):
    b, c = 4, 5
    k = rng.normal(size=(b, c, h, d)).astype(np.float32)
    v = rng.normal(size=(b, c, h, d)).astype(np.float32)
    kc = rng.normal(size=(nb, h, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, h, bs, d)).astype(np.float32)
    # slot 2 is masked off and its table aliases live blocks; slot 3 has q_lens 0
    tables = np.array([[3, 7, 0], [1, 4, 9], [3, 7, 1], [5, 6, 2]], np.int32)
    lens = np.array([2, 5, 1, 6], np.int32)
    q_lens = np.array([5, 3, 4, 0], np.int32)
    mask = np.array([True, True, False, True])
    return kc, vc, k, v, tables, lens, q_lens, mask


@pytest.mark.parametrize("case", ["mixed", "nothing valid"])
def test_append_matches_jax_bit_for_bit_and_writes_only_valid_rows(case):
    kc, vc, k, v, tables, lens, q_lens, mask = _append_inputs(np.random.default_rng(3))
    if case == "nothing valid":
        q_lens = np.array([0, 3, 4, 0], np.int32)
        mask = np.array([True, False, False, True])
    jk, jv = jax_ba.block_cache_append_chunk(*map(jnp.asarray, (kc, vc, k, v, tables, lens, q_lens)),
                                             slot_mask=jnp.asarray(mask))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    incubate.block_cache_append_chunk(tk, tv, *map(torch.from_numpy, (k, v, tables, lens, q_lens)),
                                      slot_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "nothing valid":
        np.testing.assert_array_equal(tk.numpy(), kc)


def test_append_has_no_data_dependent_shape():
    """Runs on ``meta`` tensors, which hold no data: a boolean-mask select
    (``nonzero``) cannot, and on a CUDA tensor it is a host sync."""
    kc, vc, k, v, tables, lens, q_lens, mask = _append_inputs(np.random.default_rng(4))
    meta = [torch.from_numpy(a).to("meta") for a in (kc, vc, k, v, tables, lens, q_lens, mask)]
    incubate.block_cache_append_chunk(*meta[:7], slot_mask=meta[7])


# -- 4. the residual RMSNorm's gradient; the embed norm's stop-gradient -------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_residual_backward_is_kernel_11_with_jax_gradients(monkeypatch, dtype):
    calls = []
    real = kfused.rms_residual_bwd_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(kfused, "rms_residual_bwd_plain", spy)
    rng = np.random.default_rng(21)
    h = 256
    # on a grid of 1/32 below 4 in magnitude: x + residual is exact in bf16
    x, res = (rng.integers(-127, 128, (2, 5, h)).astype(np.float32) / 32 for _ in range(2))
    w = (1 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    g, gr = (rng.normal(size=(2, 5, h)).astype(np.float32) for _ in range(2))

    def pair(a):
        j = jnp.asarray(a, getattr(jnp, dtype))
        t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
        return j, t

    (xj, xt), (rj, rt), (wj, wt), (gj, gt), (grj, grt) = map(pair, (x, res, w, g, gr))
    jin = [Tensor(a, stop_gradient=False) for a in (xj, wj, rj)]
    tin = [t.requires_grad_() for t in (xt, wt, rt)]
    jy, jr = jax_incubate.fused_rms_norm_residual(*jin, EPS)
    y, r = incubate.fused_rms_norm_residual(*tin, EPS)
    assert type(y.grad_fn).__name__ == "ResidualNormFunctionBackward" and r.grad_fn is y.grad_fn
    paddle.autograd.backward([jy, jr], [Tensor(gj), Tensor(grj)])
    torch.autograd.backward([y, r], [gt, grt])
    assert calls == [1]
    for t, j in zip(tin, jin):
        got, want = t.grad.float().numpy(), np.asarray(j.grad._data, np.float32)
        assert t.grad.dtype == t.dtype
        if dtype == "bfloat16":
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)  # 1 bf16 ulp
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the residual add's adjoint is the identity: x and residual get the same
    assert torch.equal(tin[0].grad, tin[2].grad)


@pytest.mark.parametrize("h", [128, 64], ids=["kernel-B", "composition"])
def test_embed_rms_norm_outputs_carry_no_gradient(h):
    rng = np.random.default_rng(22)
    table = torch.from_numpy(rng.normal(size=(10, h)).astype(np.float32)).requires_grad_()
    w = torch.ones(h, requires_grad=True)
    for fn in (incubate.fused_embed_rms_norm, kfused.fused_embed_rms_norm):
        emb, y = fn(torch.tensor([[1, 9, 3]]), table, w, EPS)
        assert not emb.requires_grad and not y.requires_grad
