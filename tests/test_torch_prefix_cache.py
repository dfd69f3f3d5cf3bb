"""The PyTorch port's prefix cache against the JAX package's, on the CPU.

A seeded tiny JAX ``LlamaForCausalLM`` is carried into the port with
``from_paddle_tpu_state``; the same prompts go through the JAX engine and the
port's, the prefix cache on in both (the default of both), and after every
operation the two engines must agree: the generated tokens, each request's
``cached_tokens``, the engine's counters, the cache's counters, the pool's
accounting, the block tables and the pools themselves (fp32 at 1e-5; the
int8 pool's payload to one step, its scales at 1e-6). The port's pool
invariant (refcounts equal to the slots' mappings plus pending-fork pins
plus chain ownership, no table entry on a freed block, nodes a prefix of
each table) holds after every operation. The engine cases run with the
pool in the model's dtype, with the int8 pool (whose forks copy the scale
planes) and with ``FLAGS_use_fused_decode_layer=False`` (kernel 4's plain
version instead of A's). On the CPU the port runs its kernels' plain
versions.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import BlockKVCache as JaxBlockKVCache
from paddle_tpu.incubate.nn.functional import block_cache_cow_copy as jax_cow_copy
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.prefix_cache import chain_digest as jax_chain_digest
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.flight_recorder import GLOBAL_FLIGHT_RECORDER
from paddle_tpu.observability.recompile import GLOBAL_WATCHDOG
from paddle_tpu.testing import faults

import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn.functional import BlockKVCache, block_cache_cow_copy
from paddle_tpu_torch.inference import ContinuousBatchingEngine, PrefixCache
from paddle_tpu_torch.inference import engine as engine_mod
from paddle_tpu_torch.inference.prefix_cache import _ROOT_DIGEST, chain_digest
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state

from test_torch_serving import _assert_pool_exact

JAX_ONLY_KW = dict(spec_decode=False, tp=1)
VARIANTS = {"fused": ("bf16", True), "int8_pool": ("int8", True), "unfused": ("bf16", False)}
STAT_KEYS = ("steps", "admitted", "prompt_tokens_computed", "prompt_tokens_reused", "gen_blocks_registered")
CACHE_KEYS = ("enabled", "hits", "misses", "hit_rate", "tokens_reused", "bytes_saved", "cow_forks", "evictions",
              "nodes", "evictable_blocks", "blocks_shared")
POOL_KEYS = ("total", "free", "allocated", "cached_blocks", "cached_reusable", "bytes_per_token", "kv_cache_dtype")


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


@contextlib.contextmanager
def _flags(**values):
    """Flags set in both packages (``FLAGS_`` added), the prior values put
    back afterwards."""
    names = [f"FLAGS_{k}" for k in values]
    jprior, prior = paddle.get_flags(names), paddle_tpu_torch.get_flags(names)
    new = {f"FLAGS_{k}": v for k, v in values.items()}
    paddle.set_flags(new)
    paddle_tpu_torch.set_flags(new)
    try:
        yield
    finally:
        paddle.set_flags(jprior)
        paddle_tpu_torch.set_flags(prior)


@pytest.fixture(scope="module")
def models():
    paddle.seed(17)
    jcfg = JaxLlamaConfig.tiny()
    jmodel = JaxLlama(jcfg)
    jmodel.eval()
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    cfg = LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
        num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
        max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
        rope_theta=jcfg.rope_theta, dtype="float32",
    )
    return jmodel, from_paddle_tpu_state(state, cfg, device="cpu"), jcfg


def _view(eng):
    """What both engines must agree on between operations."""
    cache = eng.prefix_cache_stats()
    pool = eng.pool_stats()
    return {
        "stats": {k: eng.stats[k] for k in STAT_KEYS},
        "cache": {k: cache[k] for k in CACHE_KEYS if k in cache},
        "pool": {k: pool[k] for k in POOL_KEYS},
        "live": [(r.req_id, list(r.generated), int(r.cached_tokens)) for r in eng.live_requests()],
        "waiting": [r.req_id for r in eng._waiting],
        "tables": [list(map(int, b)) for b in eng._blocks],
        "ntok": [int(n) for n in eng._ntok],
    }


class Pair:
    """The JAX engine and the port's over the same model, driven operation
    by operation and compared after each."""

    def __init__(self, models, kv_cache_dtype="bf16", **kw):
        jmodel, model, _ = models
        self.jeng = JaxEngine(jmodel, **kw, **JAX_ONLY_KW, kv_cache_dtype=kv_cache_dtype)
        self.eng = ContinuousBatchingEngine(model, **kw, kv_cache_dtype=kv_cache_dtype)
        self.done = {}

    def check(self):
        assert _view(self.eng) == _view(self.jeng)
        _assert_pool_exact(self.eng)
        if self.eng._quant_kv:
            for planes, jplanes in zip(self.eng._caches, self.jeng._caches):
                for got, want in zip(planes[:2], jplanes[:2]):
                    assert np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32)).max() <= 1
                for got, want in zip(planes[2:], jplanes[2:]):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        else:
            for planes, jplanes in zip(self.eng._caches, self.jeng._caches):
                for got, want in zip(planes, jplanes):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def add(self, prompt, budget):
        rid = self.eng.add_request(prompt, max_new_tokens=budget)
        assert self.jeng.add_request(prompt, max_new_tokens=budget) == rid
        self.check()
        return rid

    def step(self):
        got = [(r.req_id, list(r.generated), r.cached_tokens, r.finish_reason) for r in self.eng.step()]
        want = [(r.req_id, list(r.generated), r.cached_tokens, r.finish_reason) for r in self.jeng.step()]
        assert got == want
        self.check()
        for rid, gen, cached, _ in got:
            assert rid not in self.done, "delivered twice"
            self.done[rid] = (gen, cached)
        return {rid: (gen, cached) for rid, gen, cached, _ in got}

    def run(self):
        out = {}
        while self.eng.has_work() or self.jeng.has_work():
            out.update(self.step())
        return out

    def cancel(self, rid):
        got, want = self.eng.cancel_request(rid), self.jeng.cancel_request(rid)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.req_id, list(got.generated), got.finish_reason) == (
                want.req_id, list(want.generated), want.finish_reason)
            self.done[rid] = (list(got.generated), got.cached_tokens)
        self.check()

    def evict(self, n):
        assert self.eng._cache.evict_blocks(n) == self.jeng._cache.evict_blocks(n)
        self.check()


@contextlib.contextmanager
def _variant(name):
    kvd, fused = VARIANTS[name]
    with _flags(use_fused_decode_layer=fused):
        yield kvd


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)


def _node_of(eng, prompt, n_blocks):
    """The port cache's node of ``prompt``'s block ``n_blocks - 1``."""
    digest, node, bs = _ROOT_DIGEST, None, eng.block_size
    for i in range(n_blocks):
        node = eng._cache._nodes[(digest, prompt[i * bs: (i + 1) * bs].tobytes())]
        digest = node.digest
    return node


# -- hashing and the defaults --------------------------------------------------

@pytest.mark.parametrize("n,max_blocks", [(3, None), (12, None), (13, 2), (16, 10)],
                         ids=["short", "whole_blocks", "capped", "cap_past_end"])
def test_chain_digest_and_prefix_chain_hash_match_jax(models, n, max_blocks):
    jmodel, model, cfg = models
    prompt = _prompt(np.random.default_rng(n), cfg, n)
    assert chain_digest(prompt, 4, max_blocks) == jax_chain_digest(prompt, 4, max_blocks)
    assert PrefixCache._digest(b"p", prompt.tobytes()) == JaxPrefixCache._digest(b"p", prompt.tobytes())
    eng = ContinuousBatchingEngine(model, max_slots=2, block_size=4, prompt_bucket=16)
    jeng = JaxEngine(jmodel, max_slots=2, block_size=4, prompt_bucket=16, **JAX_ONLY_KW)
    assert eng.prefix_chain_hash(prompt, max_blocks) == jeng.prefix_chain_hash(prompt, max_blocks)


def test_prefix_cache_is_on_by_default_and_the_flag_and_keyword_turn_it_off(models):
    _, model, _ = models
    assert paddle_tpu_torch.get_flags(["FLAGS_enable_prefix_cache"]) == {"FLAGS_enable_prefix_cache": True}
    eng = ContinuousBatchingEngine(model, max_slots=2, block_size=4, prompt_bucket=16)
    assert eng._cache is not None and eng.prefix_cache_stats()["enabled"]
    assert ContinuousBatchingEngine(model, enable_prefix_cache=False).prefix_cache_stats() == {"enabled": False}
    with _flags(enable_prefix_cache=False):
        assert ContinuousBatchingEngine(model)._cache is None
        assert ContinuousBatchingEngine(model, enable_prefix_cache=True)._cache is not None
    ContinuousBatchingEngine(model, kv_host_tier_bytes=0)
    with pytest.raises(NotImplementedError, match="host tier"):
        ContinuousBatchingEngine(model, kv_host_tier_bytes=1 << 20)


# -- the engine, in lockstep with the JAX engine ----------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hit_parity_against_cold_and_cache_off(models, variant):
    """The same prompt cold, then from the cache (two full blocks and a fork
    of three tokens: the cap holds the twelfth back), then through engines
    with the cache off: the same tokens everywhere."""
    with _variant(variant) as kvd:
        rng = np.random.default_rng(42)
        prompt = _prompt(rng, models[2], 12)
        pair = Pair(models, kvd, max_slots=2, block_size=4, prompt_bucket=16)
        cold = pair.add(prompt, 6)
        pair.run()
        assert pair.done[cold][1] == 0 and pair.eng.prefix_cache_stats()["nodes"] >= 3
        warm = pair.add(prompt, 6)
        pair.run()
        assert pair.done[warm] == (pair.done[cold][0], 11)
        assert pair.eng.prefix_cache_stats()["cow_forks"] == 1
        off = Pair(models, kvd, max_slots=2, block_size=4, prompt_bucket=16, enable_prefix_cache=False)
        rid = off.add(prompt, 6)
        off.run()
        assert off.done[rid][0] == pair.done[cold][0]
        assert off.eng.pool_stats()["free"] == off.eng.num_blocks


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_shared_prefix_computed_once(models, variant):
    with _variant(variant) as kvd:
        rng = np.random.default_rng(43)
        shared = _prompt(rng, models[2], 8)
        pair = Pair(models, kvd, max_slots=2, block_size=4, prompt_bucket=16)
        pair.add(np.concatenate([shared, _prompt(rng, models[2], 3)]), 3)
        pair.run()
        assert pair.eng.stats["prompt_tokens_computed"] == 11
        rids = [pair.add(np.concatenate([shared, _prompt(rng, models[2], 3)]), 3) for _ in range(3)]
        pair.run()
        assert pair.eng.stats["prompt_tokens_computed"] == 11 + 3 * 3
        assert [pair.done[r][1] for r in rids] == [8, 8, 8]
        assert pair.eng.stats["prompt_tokens_reused"] == 3 * 8
        assert pair.eng.prefix_cache_stats()["hit_rate"] == pytest.approx(3 / 4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_in_flight_insertion_shares_with_a_later_admission(models, variant):
    with _variant(variant) as kvd:
        rng = np.random.default_rng(44)
        shared = _prompt(rng, models[2], 8)
        pair = Pair(models, kvd, max_slots=2, block_size=4, prompt_bucket=16)
        ra = pair.add(np.concatenate([shared, _prompt(rng, models[2], 2)]), 8)
        for _ in range(4):
            pair.step()
        assert ra in [r.req_id for r in pair.eng.live_requests()]
        rb = pair.add(np.concatenate([shared, _prompt(rng, models[2], 2)]), 2)
        pair.run()
        assert pair.done[rb][1] == 8


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fork_never_writes_the_shared_block(models, variant):
    """X cached; Y shares X's first block and diverges inside the second: Y
    forks that block. The forked block starts as the source's bytes (scale
    planes included), the source's bytes never change, Y's tokens are a
    cache-off engine's, and X again gives X's tokens."""
    with _variant(variant) as kvd:
        rng = np.random.default_rng(45)
        x = _prompt(rng, models[2], 12)
        y = x[:11].copy()
        y[6:] = _prompt(rng, models[2], 5)
        pair = Pair(models, kvd, max_slots=2, block_size=4, prompt_bucket=16)
        rx = pair.add(x, 5)
        pair.run()
        src = _node_of(pair.eng, x, 2).block
        before = [p[src].clone() for planes in pair.eng._caches for p in planes]
        ry = pair.add(y, 5)
        pair.step()  # admits Y, copies the fork, appends Y's rows after the 2 reused
        dst = pair.eng._blocks[0][1]
        assert dst != src and pair.eng.prefix_cache_stats()["cow_forks"] == 1
        for planes in pair.eng._caches:
            for p in planes:
                assert torch.equal(p[dst][:, :2], p[src][:, :2])
        pair.run()
        assert pair.done[ry][1] == 4 + 2
        after = [p[src] for planes in pair.eng._caches for p in planes]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        off = Pair(models, kvd, max_slots=2, block_size=4, prompt_bucket=16, enable_prefix_cache=False)
        r_off = off.add(y, 5)
        off.run()
        assert off.done[r_off][0] == pair.done[ry][0]
        rx2 = pair.add(x, 5)
        pair.run()
        assert pair.done[rx2][0] == pair.done[rx][0]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lru_evicts_zero_reference_chains_only_under_pressure(models, variant, monkeypatch):
    """Distinct prompts through a pool too small to keep them all: the cache
    evicts, but only when the free list is empty, and live requests never
    lose a block (the invariant after every step)."""
    with _variant(variant) as kvd:
        rng = np.random.default_rng(46)
        pair = Pair(models, kvd, max_slots=2, block_size=4, num_blocks=8, prompt_bucket=8, max_model_len=16)
        cache, free_at_eviction = pair.eng._cache, []
        evict = cache._evict_locked

        def recorded(n):
            free_at_eviction.append(pair.eng._mgr.free_blocks)
            return evict(n)

        monkeypatch.setattr(cache, "_evict_locked", recorded)
        for _ in range(6):
            rid = pair.add(_prompt(rng, models[2], 8), 3)
            pair.run()
            assert rid in pair.done
        assert pair.eng.prefix_cache_stats()["evictions"] > 0
        assert free_at_eviction and set(free_at_eviction) == {0}
        s = pair.eng.pool_stats()
        assert s["free"] + s["cached_blocks"] == s["total"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_multi_turn_maps_the_generated_chain_and_forks_inside_it(models, variant):
    """Turn 1 registers its prompt and generated blocks at finish; turn 2
    (turn 1's stream and new text) maps every full block of it, and a turn
    that diverges inside a generated block forks that block."""
    with _variant(variant) as kvd:
        rng = np.random.default_rng(57)
        x = _prompt(rng, models[2], 14)
        pair = Pair(models, kvd, max_slots=2, block_size=4, num_blocks=64, prompt_bucket=32, max_model_len=48)
        rx = pair.add(x, 7)
        pair.run()
        stream = np.concatenate([x, np.asarray(pair.done[rx][0], np.int32)])
        # 14 + 7 - 1 = 20 tokens in the pool: 5 full blocks, 2 of them holding generated tokens
        assert pair.eng.stats["gen_blocks_registered"] == 2
        r2 = pair.add(np.concatenate([stream, _prompt(rng, models[2], 5)]), 3)
        r3 = pair.add(np.concatenate([stream[:18], _prompt(rng, models[2], 4)]), 3)
        pair.run()
        assert pair.done[r2][1] == 20
        assert pair.done[r3][1] == 18  # blocks 0-3 and 2 tokens of the generated block 4, forked
        assert pair.eng.prefix_cache_stats()["cow_forks"] == 1


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_200_op_seeded_churn_against_the_jax_engine(models, variant):
    """Seeded submit / step / cancel / evict churn with heavy prefix sharing
    over a small pool, the two engines compared and the port's invariant
    checked after every operation; every request is delivered once."""
    with _variant(variant) as kvd:
        cfg = models[2]
        rng = np.random.default_rng(40)
        pair = Pair(models, kvd, max_slots=3, block_size=4, num_blocks=24, prompt_bucket=16, max_model_len=32)
        families = [_prompt(rng, cfg, n) for n in (9, 6, 12)]
        submitted, cancelled = set(), 0
        for _ in range(200):
            r = rng.random()
            if r < 0.40 and len(pair.eng._waiting) < 6:
                fam = families[int(rng.integers(0, len(families)))]
                prompt = np.concatenate([fam, _prompt(rng, cfg, int(rng.integers(0, 4)))])[:16]
                submitted.add(pair.add(prompt, int(rng.integers(1, 6))))
            elif r < 0.85:
                if pair.eng.has_work():
                    pair.step()
            elif r < 0.93:
                live = [q.req_id for q in pair.eng.live_requests()] + [q.req_id for q in pair.eng._waiting]
                if live:
                    pair.cancel(int(rng.choice(live)))
                    cancelled += 1
            else:
                pair.evict(1)
        pair.run()
        assert set(pair.done) == submitted and cancelled > 0
        s = pair.eng.pool_stats()
        assert s["free"] + s["cached_blocks"] == s["total"]
        assert pair.eng.prefix_cache_stats()["cow_forks"] > 0
        pair.evict(s["total"])
        assert pair.eng.pool_stats()["free"] == s["total"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_a_fork_from_the_lru_head_with_the_free_list_empty(models, variant):
    """The fork's source at the head of the LRU (its only child evicted) and
    no free block: the fork's allocation evicts another node, never its own
    source, and the port neither fails nor drifts. Not held against the JAX
    engine, whose match allocates before it pins the source."""
    with _variant(variant) as kvd:
        cfg = models[2]
        rng = np.random.default_rng(58)
        x, z = _prompt(rng, cfg, 8), _prompt(rng, cfg, 12)
        y = np.concatenate([x[:2], _prompt(rng, cfg, 4)])
        kw = dict(max_slots=1, block_size=4, num_blocks=4, prompt_bucket=16, max_model_len=16, kv_cache_dtype=kvd)
        eng = ContinuousBatchingEngine(models[1], **kw)
        cache = eng._cache
        eng.add_request(x, max_new_tokens=1)
        eng.run()
        assert cache.evict_blocks(1) == 1  # x's second block: its first goes to the eviction head
        src = _node_of(eng, x, 1)
        eng.add_request(z, max_new_tokens=1)
        eng.run()
        assert next(iter(cache._evictable.values())) is src and eng.pool_stats()["free"] == 0
        rid = eng.add_request(y, max_new_tokens=3)
        out = {}
        while eng.has_work():
            out.update({r.req_id: r for r in eng.step()})
            _assert_pool_exact(eng)
            assert cache._nodes.get(src.key) is src
        assert out[rid].cached_tokens == 2 and eng.prefix_cache_stats()["cow_forks"] == 1
        off = ContinuousBatchingEngine(models[1], **kw, enable_prefix_cache=False)
        rid_off = off.add_request(y, max_new_tokens=3)
        assert off.run()[rid_off].generated == out[rid].generated
        s = eng.pool_stats()
        assert s["free"] + s["cached_blocks"] == s["total"]
        cache.evict_blocks(s["total"])
        assert eng.pool_stats()["free"] == s["total"] and cache.node_count == 0


# -- the degrade paths and the fork's timing ------------------------------------

def test_match_failure_degrades_to_a_cold_miss(models, monkeypatch):
    rng = np.random.default_rng(47)
    prompt = _prompt(rng, models[2], 9)
    pair = Pair(models, max_slots=2, block_size=4, prompt_bucket=16)
    r1 = pair.add(prompt, 4)
    pair.run()

    def broken(_prompt):
        raise RuntimeError("index unavailable")

    monkeypatch.setattr(pair.eng._cache, "match", broken)
    with faults.inject(faults.FaultPlan.single("prefix_cache.match", 0)):
        r2 = pair.add(prompt, 4)
        with pytest.warns(RuntimeWarning, match="prefix cache lookup failed"):
            pair.run()
    assert pair.done[r2] == (pair.done[r1][0], 0)


def test_fork_allocation_failure_recomputes_the_partial(models, monkeypatch):
    rng = np.random.default_rng(48)
    prompt = _prompt(rng, models[2], 12)
    pair = Pair(models, max_slots=2, block_size=4, prompt_bucket=16)
    r1 = pair.add(prompt, 4)
    pair.run()
    alloc, calls = pair.eng._cache._alloc_block_locked, []

    def first_fails():
        calls.append(1)
        if len(calls) == 1:  # the fork's: admission allocates before the step grows
            raise MemoryError("no block for the fork")
        return alloc()

    monkeypatch.setattr(pair.eng._cache, "_alloc_block_locked", first_fails)
    with faults.inject(faults.FaultPlan.single("prefix_cache.cow", 0)):
        r2 = pair.add(prompt, 4)
        pair.run()
    assert pair.done[r2] == (pair.done[r1][0], 8)  # blocks 0 and 1 mapped, the partial recomputed
    assert pair.eng.prefix_cache_stats()["cow_forks"] == 0


def _failed_first_step(models, monkeypatch):
    """An engine whose warm request was admitted with a fork, then whose
    first step failed before the device ran: the fork is still pending."""
    rng = np.random.default_rng(49)
    prompt = _prompt(rng, models[2], 12)
    eng = ContinuousBatchingEngine(models[1], max_slots=2, block_size=4, prompt_bucket=16)
    eng.add_request(prompt, max_new_tokens=4)
    cold = eng.run()
    nodes = eng.prefix_cache_stats()["nodes"]
    impl = eng._step_impl

    def fails(*args):
        monkeypatch.setattr(eng, "_step_impl", impl)
        raise RuntimeError("the step failed")

    monkeypatch.setattr(eng, "_step_impl", fails)
    rid = eng.add_request(prompt, max_new_tokens=4)
    with pytest.raises(RuntimeError, match="the step failed"):
        eng.step()
    slot = [r.req_id if r is not None else None for r in eng._slot_req].index(rid)
    src, dst, partial = eng._pending_cow[slot]
    assert partial == 3 and src.req_refs == 1  # the fork's pin
    _assert_pool_exact(eng)
    return eng, rid, slot, (src, dst), nodes, list(cold.values())[0].generated


def test_a_request_cancelled_with_its_fork_pending_registers_nothing(models, monkeypatch):
    eng, rid, slot, (src, dst), nodes, _ = _failed_first_step(models, monkeypatch)
    req = eng.cancel_request(rid)
    assert req.finish_reason == "cancelled" and eng._pending_cow[slot] is None
    assert eng.prefix_cache_stats()["nodes"] == nodes  # the unfilled fork was not hashed
    assert src.req_refs == 0 and dst in eng._mgr._free
    _assert_pool_exact(eng)
    s = eng.pool_stats()
    assert s["free"] + s["cached_blocks"] == s["total"]


def test_a_failed_step_keeps_its_fork_pending_and_the_retry_copies_it(models, monkeypatch):
    eng, rid, slot, (src, dst), _, cold_tokens = _failed_first_step(models, monkeypatch)
    out = eng.run()
    assert out[rid].generated == cold_tokens and out[rid].cached_tokens == 11
    assert src.req_refs == 0
    _assert_pool_exact(eng)


def test_a_step_without_a_pending_fork_copies_nothing(models, monkeypatch):
    calls = []

    def spy(planes, src, dst):
        calls.append((src.tolist(), dst.tolist()))
        return copy_blocks(planes, src, dst)

    copy_blocks = engine_mod.copy_blocks
    monkeypatch.setattr(engine_mod, "copy_blocks", spy)
    rng = np.random.default_rng(50)
    prompt = _prompt(rng, models[2], 10)
    eng = ContinuousBatchingEngine(models[1], max_slots=2, block_size=4, prompt_bucket=16)
    eng.add_request(prompt, max_new_tokens=3)
    eng.run()
    assert calls == []  # a cold request: no fork, no copy
    eng.add_request(prompt, max_new_tokens=3)
    eng.add_request(np.concatenate([prompt[:5], _prompt(rng, models[2], 3)]), max_new_tokens=3)
    eng.step()  # both admitted: two forks, one copy each layer
    layers = models[1].config.num_hidden_layers
    assert len(calls) == layers and all(len(s) == 2 for s, _ in calls)
    eng.run()
    assert len(calls) == layers


# -- the cache on its own, beside the JAX package's -------------------------------

def _caches():
    jpool = JaxBlockKVCache(8, 4, 2, 8, 4, dtype=np.float32)
    pool = BlockKVCache(8, 4)
    return (pool, PrefixCache(pool, 4, bytes_per_token=1)), (jpool, JaxPrefixCache(jpool, 4, bytes_per_token=1))


def test_evict_blocks_never_touches_referenced_nodes():
    t1, t2 = np.arange(4, dtype=np.int32), np.arange(4, 8, dtype=np.int32)
    for pool, cache in _caches():
        n1 = cache.insert(None, t1, pool.acquire_block())
        n2 = cache.insert(n1, t2, pool.acquire_block())
        assert cache.evict_blocks(5) == 0  # both referenced
        cache.release([n1, n2])
        assert cache.evictable_blocks == 2
        assert cache.evict_blocks(5) == 2 and cache.node_count == 0 and pool.free_blocks == 8
        assert cache.stats_snapshot()["evictions"] == 2


def test_match_is_capped_at_prompt_len_minus_one():
    toks = np.arange(8, dtype=np.int32)
    got = []
    for pool, cache in _caches():
        n1 = cache.insert(None, toks[:4], pool.acquire_block())
        cache.insert(n1, toks[4:], pool.acquire_block())
        res = cache.match(toks)
        got.append((len(res.nodes), res.cow[2], res.cached_tokens, res.cow[0].block, res.cow[1]))
    assert got[0] == got[1] and got[0][:3] == (1, 3, 7)


def test_insert_dedup_returns_none_for_an_existing_key():
    toks = np.arange(4, dtype=np.int32)
    for pool, cache in _caches():
        b1 = pool.acquire_block()
        assert cache.insert(None, toks, b1) is not None
        b2 = pool.acquire_block()
        assert cache.insert(None, toks, b2) is None
        assert pool.refcounts()[b1] == 2 and pool.refcounts()[b2] == 1


def test_the_fork_source_is_pinned_before_its_block_is_allocated():
    """The cache alone, the free list empty and the fork's source first in
    the LRU: the fork takes the next node's block; with nothing else to
    evict it falls back to recomputing, and the source stays cached."""
    pool = BlockKVCache(4, 4)
    cache = PrefixCache(pool, 4)
    toks = np.arange(12, dtype=np.int32)
    n0 = cache.insert(None, toks[:4], pool.acquire_block())
    n1 = cache.insert(n0, toks[4:8], pool.acquire_block())
    cache.release([n0, n1])
    assert cache.evict_blocks(1) == 1 and list(cache._evictable.values()) == [n0]
    other = cache.insert(None, toks[8:], pool.acquire_block())
    cache.release([other])
    held = [pool.acquire_block() for _ in range(pool.free_blocks)]
    res = cache.match(np.concatenate([toks[:2], toks[10:]]))
    src, dst, partial = res.cow
    assert (src, partial, dst) == (n0, 2, other.block) and cache._nodes.get(n0.key) is n0
    cache.release_cow_source(src)
    assert cache.match(np.concatenate([toks[:3], toks[9:]])).cow is None  # nothing left to evict
    assert n0.req_refs == 0 and list(cache._evictable.values()) == [n0] and pool.refcounts()[n0.block] == 1
    for b in held + [dst]:
        pool.decref(b)
    assert cache.evict_blocks(4) == 1 and pool.free_blocks == 4


@pytest.mark.parametrize("case", ["mid_chain_partial", "partial_block_start", "exact_prefix_mid_block"])
def test_partial_block_suffix_reuse(models, case):
    """Every full cached block before the first divergent block maps, and
    the divergent block's leading run forks: ``cached == min(lcp, plen - 1)``."""
    rng = np.random.default_rng(53)
    x = _prompt(rng, models[2], 16)
    pair = Pair(models, max_slots=2, block_size=4, num_blocks=64, prompt_bucket=32, max_model_len=48)
    pair.add(x, 2)
    pair.run()
    if case == "mid_chain_partial":
        y = x[:13].copy()
        y[10:] = (y[10:] + 1) % models[2].vocab_size
        want = (2, 2, 10)
    elif case == "partial_block_start":
        y = x[:11].copy()
        y[8:] = (y[8:] + 1) % models[2].vocab_size
        want = (2, None, 8)
    else:
        y = x[:14]
        want = (3, 1, 13)
    for eng in (pair.eng, pair.jeng):
        res = eng._cache.match(y)
        assert (len(res.nodes), res.cow[2] if res.cow else None, res.cached_tokens) == want
        eng._cache.release(res.nodes)
        if res.cow is not None:
            eng._cache.release_cow_source(res.cow[0])
            eng._mgr.decref(res.cow[1])
    pair.check()


# -- the public fork copy ------------------------------------------------------

@pytest.mark.parametrize("dst", [[8, 5, 2], [8, 8, 8]], ids=["leading_no_fork", "no_fork"])
def test_block_cache_cow_copy_matches_jax(dst):
    """Cases beside the other files' cow-copy tests: the first entry forks
    nothing, and no entry forks (the pools come back unchanged)."""
    planes = 4
    rng = np.random.default_rng(len(set(dst)))
    shape = (8, 2, 4, 16)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    arrays += [rng.random(shape[:3]).astype(np.float32) + 0.5 for _ in range(planes - 2)]
    src, dst = np.array([1, 6, 3], np.int32), np.array(dst, np.int32)
    want = jax_cow_copy(*[jnp.asarray(a) for a in arrays[:2]], jnp.asarray(src), jnp.asarray(dst),
                        *[jnp.asarray(a) for a in arrays[2:]])
    got = block_cache_cow_copy(*[torch.from_numpy(a.copy()) for a in arrays[:2]], torch.from_numpy(src),
                               torch.from_numpy(dst), *[torch.from_numpy(a.copy()) for a in arrays[2:]])
    assert len(got) == planes
    for g, w, a in zip(got, want, arrays):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if (dst == 8).all():
        for g, a in zip(got, arrays):
            np.testing.assert_array_equal(g.numpy(), a)
