"""The PyTorch port's serving slice against the JAX package, end to end.

A seeded tiny JAX ``LlamaForCausalLM`` is carried into the port with
``from_paddle_tpu_state``; both engines (prefix cache and speculation off,
unquantized pool, one device) serve the same staggered requests, and every
request's greedy stream must be identical. The step's logits are compared
directly (fp32, 1e-4), as are the KV pools the steps leave behind. On the
CPU the port runs its kernels' plain versions.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.engine import IntakeError as JaxIntakeError
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.flight_recorder import GLOBAL_FLIGHT_RECORDER
from paddle_tpu.observability.recompile import GLOBAL_WATCHDOG

from paddle_tpu_torch.inference import ContinuousBatchingEngine, IntakeError
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state

ENGINE_KW = dict(max_slots=3, block_size=4, prompt_bucket=24, max_model_len=64, prefill_chunk=8)
JAX_ONLY_KW = dict(enable_prefix_cache=False, spec_decode=False, kv_cache_dtype="bf16", tp=1)


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
    """The JAX engine records its compile in the process-wide watchdog and
    its admits in the global flight recorder; put both back as they were so
    no other test in this worker sees this file's engines."""
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


def _port_config(jcfg):
    return LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
        num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
        max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
        rope_theta=jcfg.rope_theta, dtype="float32",
    )


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jcfg = JaxLlamaConfig.tiny()
    jmodel = JaxLlama(jcfg)
    jmodel.eval()
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    return jmodel, from_paddle_tpu_state(state, _port_config(jcfg), device="cpu"), jcfg


def _drive(eng, schedule):
    """Feed ``schedule`` (step index -> prompts to add before that step) and
    step to completion; returns {submission order: generated tokens}."""
    ids, out, step = [], {}, 0
    while step in schedule or eng.has_work() or any(s > step for s in schedule):
        for prompt, budget in schedule.get(step, ()):
            ids.append(eng.add_request(prompt, max_new_tokens=budget))
        for req in eng.step():
            out[req.req_id] = list(req.generated)
        step += 1
    return [out[i] for i in ids]


def test_engine_streams_identical_to_jax_engine(models):
    jmodel, model, jcfg = models
    rng = np.random.default_rng(5)
    schedule = {
        0: [(rng.integers(0, jcfg.vocab_size, 19), 7), (rng.integers(0, jcfg.vocab_size, 3), 9)],
        2: [(rng.integers(0, jcfg.vocab_size, 11), 5)],
        4: [(rng.integers(0, jcfg.vocab_size, 24), 6), (rng.integers(0, jcfg.vocab_size, 1), 4)],
    }
    with _jax_engine_globals_preserved():
        want = _drive(JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW), schedule)
    got = _drive(ContinuousBatchingEngine(model, **ENGINE_KW), schedule)
    assert [len(g) for g in got] == [7, 9, 5, 6, 4]
    assert got == want


def _step_inputs():
    """Two steps over three slots: step 1 prefills chunks (slot 2 idle);
    step 2 carries a decode row, a continuing chunk and an idle slot."""
    toks1 = np.array([[5, 17, 3, 99, 0, 0], [8, 1, 2, 3, 4, 250], [0] * 6], np.int32)
    q1 = np.array([4, 6, 0], np.int32)
    toks2 = np.array([[42, 0, 0, 0, 0, 0], [7, 7, 9, 0, 0, 0], [0] * 6], np.int32)
    q2 = np.array([1, 3, 0], np.int32)
    tables = np.array([[2, 0, 0, 0], [5, 1, 3, 0], [0, 0, 0, 0]], np.int32)
    active = np.array([True, True, False])
    return [(toks1, np.zeros(3, np.int32), q1), (toks2, q1, q2)], tables, active


def test_step_logits_and_pools_match_jax_model(models):
    jmodel, model, jcfg = models
    steps, tables, active = _step_inputs()
    kvh = jcfg.num_key_value_heads
    hd = jcfg.hidden_size // jcfg.num_attention_heads
    shape = (8, kvh, 4, hd)
    jcaches = [(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))] * jcfg.num_hidden_layers
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(jcfg.num_hidden_layers)]
    for toks, lens, q_lens in steps:
        pkv = [
            tuple(Tensor(a) for a in (kc, vc, tables, lens, active, q_lens)) for kc, vc in jcaches
        ]
        with paddle.no_grad():
            jlogits, jpast = jmodel(
                Tensor(toks), past_key_values=pkv, use_cache=True, cache_position=Tensor(lens)
            )
        jcaches = [(p[0]._data, p[1]._data) for p in jpast]
        t = [torch.from_numpy(a) for a in (tables, lens, active, q_lens)]
        with torch.inference_mode():
            logits, _ = model(torch.from_numpy(toks), past_key_values=[(kc, vc, *t) for kc, vc in caches],
                              use_cache=True, cache_position=t[1])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    for (kc, vc), (jkc, jvc) in zip(caches, jcaches):
        np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vc.numpy(), np.asarray(jvc), rtol=1e-5, atol=1e-5)


def _assert_pool_exact(eng):
    s = eng.pool_stats()
    assert s["allocated"] + s["free"] == s["total"], s
    live = {}
    for slot, req in enumerate(eng._slot_req):
        if req is not None:
            for blk in eng._blocks[slot]:
                live[blk] = live.get(blk, 0) + 1
            # every token in the pool has a block
            assert len(eng._blocks[slot]) * eng.block_size >= eng._ntok[slot]
    assert eng._mgr.refcounts() == live


def test_pool_accounting_exact_every_step_and_drains(models):
    _, model, jcfg = models
    eng = ContinuousBatchingEngine(model, **{**ENGINE_KW, "num_blocks": 14})
    rng = np.random.default_rng(9)
    for n, budget in [(20, 9), (13, 12), (6, 3), (24, 8), (2, 2), (17, 5)]:
        eng.add_request(rng.integers(0, jcfg.vocab_size, n), max_new_tokens=budget)
    done = {}
    while eng.has_work():
        for req in eng.step():
            done[req.req_id] = req
        _assert_pool_exact(eng)
    assert sorted(done) == list(range(6))
    assert all(r.finish_reason == "length" for r in done.values())
    assert eng.pool_stats()["free"] == eng.num_blocks


@pytest.mark.parametrize(
    "prompt,budget",
    [([], 4), ([1, 2], 0), (list(range(25)), 4), (list(range(20)), 60)],
    ids=["empty", "zero-budget", "over-bucket", "over-model-len"],
)
def test_intake_errors_match_jax_engine(models, prompt, budget):
    jmodel, model, _ = models
    with _jax_engine_globals_preserved():
        with pytest.raises(JaxIntakeError) as jerr:
            JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW).add_request(prompt, max_new_tokens=budget)
    with pytest.raises(IntakeError) as err:
        ContinuousBatchingEngine(model, **ENGINE_KW).add_request(prompt, max_new_tokens=budget)
    assert type(err.value).__name__ == type(jerr.value).__name__


def test_engine_refuses_what_the_port_lacks(models):
    _, model, _ = models
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(model, enable_prefix_cache=True)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousBatchingEngine(model, kv_cache_dtype="fp8")
    # the int8 pool is ported: 4 planes per layer, int8 payload, fp32 scales at ones
    eng = ContinuousBatchingEngine(model, **ENGINE_KW, kv_cache_dtype="int8")
    kc, vc, ks, vs = eng._caches[0]
    assert kc.dtype == vc.dtype == torch.int8 and not kc.any()
    assert ks.shape == kc.shape[:3] and ks.dtype == torch.float32 and bool((ks == 1).all() and (vs == 1).all())
    assert eng.pool_stats()["kv_cache_dtype"] == "int8" and model.dtype == torch.float32


def test_convert_rejects_a_mismatched_state_and_reads_bfloat16(models):
    jmodel, _, jcfg = models
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    with pytest.raises(KeyError):
        from_paddle_tpu_state({k: v for k, v in state.items() if "lm_head" not in k},
                              _port_config(jcfg), device="cpu")
    bf16 = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in state.items()}
    model = from_paddle_tpu_state(bf16, _port_config(jcfg), device="cpu")
    assert model.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.lm_head.weight.detach().float().numpy(), np.asarray(bf16["lm_head.weight"], np.float32)
    )
