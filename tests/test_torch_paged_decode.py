"""The PyTorch port's decode over the paged cache against the JAX package.

- Kernels 4, 5 and 6 (``paged_flash_chunk``, ``paged_flash_decode``,
  ``paged_flash_decode_fused``): their plain PyTorch versions (what the
  wrappers run for CPU tensors) against the Pallas kernels in interpret
  mode on the same numpy inputs — head dim 64, 128, 192 and 256, MHA and GQA, ragged
  lengths including 0 and exact multiples of the block size (a decode
  length counts the current token, a chunk length does not: an off-by-one
  there reads a garbage table entry), garbage table tails. fp32 at 1e-5
  (kernel 6 at 2e-5, as the JAX suite holds it); bf16 within one bf16 ulp
  of the output's largest magnitude.
- The cache appends (bitwise), the three ``block_multihead_*`` entries (out
  and both pools) and the ``BlockKVCache`` tables against JAX's.
- A tiny fp32 Llama carried over with ``from_paddle_tpu_state``: the dense
  prefill ``(logits, caches)``; ``generate_paged`` token for token against
  JAX's ``generate_paged`` and greedy ``generate``; the engine with
  ``FLAGS_use_fused_decode_layer=False`` stream for stream against the JAX
  engine under the same flag and against the port's fused engine.
- A two-layer hidden-256 / head-dim-128 model (in reach of the kernels) in
  fp32 and fp16: spying on the plain versions shows kernel 5 once per layer
  per decode step, kernel 4 once per layer per unfused engine step, RMSNorm
  (kernel 7) 2L + 1 times per step, and nothing else of the paged kernels.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional.block_attention as jax_ba
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.kernels import paged_attention as jax_paged
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.flight_recorder import GLOBAL_FLIGHT_RECORDER
from paddle_tpu.observability.recompile import GLOBAL_WATCHDOG

import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn import functional as incubate
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.kernels import fused as kfused
from paddle_tpu_torch.kernels import paged_attention as kpaged
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state

TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE_KW = dict(max_slots=3, block_size=4, prompt_bucket=24, max_model_len=64, prefill_chunk=8)
JAX_ONLY_KW = dict(enable_prefix_cache=False, spec_decode=False, kv_cache_dtype="bf16", tp=1)
GEOMETRIES = [(64, 4, 4), (64, 8, 2), (128, 4, 4), (128, 8, 2)]  # (D, HQ, HKV)
GEOMETRY_IDS = ["d64-mha", "d64-gqa", "d128-mha", "d128-gqa"]


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


@contextlib.contextmanager
def _unfused_decode_layer():
    """``FLAGS_use_fused_decode_layer=False`` in both packages, restored."""
    jprior = paddle.get_flags(["FLAGS_use_fused_decode_layer"])
    prior = paddle_tpu_torch.get_flags(["FLAGS_use_fused_decode_layer"])
    paddle.set_flags({"FLAGS_use_fused_decode_layer": False})
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": False})
    try:
        yield
    finally:
        paddle.set_flags(jprior)
        paddle_tpu_torch.set_flags(prior)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype.kind == "f":
        t = t.to(getattr(torch, dtype))
        return t, jnp.asarray(a, getattr(jnp, dtype))
    return t, jnp.asarray(a)


def _close(got: torch.Tensor, want, dtype: str, fp32_tol: float = 1e-5) -> None:
    """fp32: ``fp32_tol``; bf16: within one bf16 ulp of the largest output
    magnitude (the two sum the same fp32 products in another order, then
    round to bf16)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=fp32_tol, atol=fp32_tol)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


def _tables(rng, lens_after, b, bs, mbs, nb):
    """Distinct blocks for each slot's used positions; every entry past them
    is out-of-range garbage that must never be dereferenced."""
    tables = rng.permutation(nb)[: b * mbs].reshape(b, mbs).astype(np.int32)
    for i in range(b):
        tables[i, -(-int(lens_after[i]) // bs):] = nb + 1000 + i
    return tables


def _cache_inputs(seed, d, hq, hkv, b=4, bs=8, mbs=4, nb=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kc = rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)
    cos = np.cos(rng.normal(size=(b, 1, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(b, 1, d))).astype(np.float32)
    return rng, q, kc, vc, cos, sin


# -- kernels 4, 5, 6: plain versions against the Pallas kernels -----------------------

# head dims 192 and 256 too (the JAX package's D % 64 gate; kernels 5 and 6 take them with 16-lane row groups)
DTYPE_CASES = [(g, "float32") for g in GEOMETRIES] + [(GEOMETRIES[0], "bfloat16"), (GEOMETRIES[3], "bfloat16"),
                                                      ((192, 4, 4), "bfloat16"), ((256, 8, 2), "bfloat16"),
                                                      ((256, 4, 4), "float32")]
DTYPE_IDS = [f"{i}-fp32" for i in GEOMETRY_IDS] + [f"{GEOMETRY_IDS[0]}-bf16", f"{GEOMETRY_IDS[3]}-bf16",
                                                   "d192-mha-bf16", "d256-gqa-bf16", "d256-mha-fp32"]


@pytest.mark.parametrize("geometry,dtype", DTYPE_CASES, ids=DTYPE_IDS)
def test_chunk_plain_matches_pallas_interpret(geometry, dtype):
    d, hq, hkv = geometry
    rng, _, kc, vc, _, _ = _cache_inputs(0, d, hq, hkv)
    c = 4
    q = rng.normal(size=(4, c, hq, d)).astype(np.float32)
    # lens EXCLUDE the chunk: slot 1 ends exactly on a block edge (4 + 4 = 8)
    lens = np.array([13, 4, 0, 16], np.int32)
    q_lens = np.array([1, 4, 0, 3], np.int32)
    tables = _tables(rng, lens + q_lens, 4, 8, 4, 16)
    args = [_pair(a, dtype) for a in (q, kc, vc, tables, lens, q_lens)]
    want = jax_paged.paged_flash_chunk(*(j for _, j in args), interpret=True)
    got = kpaged.paged_flash_chunk(*(t for t, _ in args))
    _close(got, want, dtype)
    assert not got[2].any() and not got[0, 1:].any() and not got[3, 3:].any()  # rows past q_lens: exact 0


@pytest.mark.parametrize("geometry,dtype", DTYPE_CASES, ids=DTYPE_IDS)
def test_decode_plain_matches_pallas_interpret(geometry, dtype):
    d, hq, hkv = geometry
    rng, q, kc, vc, _, _ = _cache_inputs(1, d, hq, hkv)
    # lens INCLUDE the current token: 16 and 24 end exactly on block edges, 0 is idle
    lens = np.array([13, 0, 16, 24], np.int32)
    tables = _tables(rng, lens, 4, 8, 4, 16)
    args = [_pair(a, dtype) for a in (q, kc, vc, tables, lens)]
    want = jax_paged.paged_flash_decode(*(j for _, j in args), interpret=True)
    got = kpaged.paged_flash_decode(*(t for t, _ in args))
    _close(got, want, dtype)
    assert not got[1].any()  # a slot of length 0: exact 0


@pytest.mark.parametrize("geometry,dtype", DTYPE_CASES, ids=DTYPE_IDS)
def test_decode_fused_plain_matches_pallas_interpret(geometry, dtype):
    d, hq, hkv = geometry
    rng, q, kc, vc, cos, sin = _cache_inputs(2, d, hq, hkv)
    lens = np.array([8, 21, 0, 32], np.int32)
    tables = _tables(rng, lens, 4, 8, 4, 16)
    args = [_pair(a, dtype) for a in (q, cos, sin, kc, vc, tables, lens)]
    want = jax_paged.paged_flash_decode_fused(*(j for _, j in args), interpret=True)
    got = kpaged.paged_flash_decode_fused(*(t for t, _ in args))
    _close(got, want, dtype, fp32_tol=2e-5)
    assert not got[2].any()


def test_wrappers_refuse_scale_planes():
    """A lone scale plane is refused; the pair (the int8 pool) is the JAX
    package's: kernel 5's plain version against the Pallas kernel in
    interpret mode, and the decode entry (quantizing append, dequantizing
    attention) against JAX's, pools and scale planes included."""
    rng, q, kc, vc, _, _ = _cache_inputs(3, 64, 4, 4)
    kq, ksc = (np.clip(np.round(kc * 40), -127, 127).astype(np.int8), np.abs(rng.normal(size=kc.shape[:3])) / 40)
    vq, vsc = (np.clip(np.round(vc * 40), -127, 127).astype(np.int8), np.abs(rng.normal(size=kc.shape[:3])) / 40)
    ksc, vsc = ksc.astype(np.float32), vsc.astype(np.float32)
    lens = np.array([13, 0, 16, 24], np.int32)
    tables = _tables(rng, lens, 4, 8, 4, 16)
    t = [torch.from_numpy(a) for a in (q, kq, vq, tables, lens, ksc, vsc)]
    with pytest.raises(ValueError, match="both scale planes"):
        kpaged.paged_flash_decode(*t[:5], k_scale=t[5])
    with pytest.raises(ValueError, match="both scale planes"):
        incubate.block_multihead_attention(t[0][:, None], t[0][:, None], t[0][:, None], *t[1:5], value_scale=t[6])
    want = jax_paged.paged_flash_decode(*map(jnp.asarray, (q, kq, vq, tables, lens)), k_scale=jnp.asarray(ksc),
                                        v_scale=jnp.asarray(vsc), interpret=True)
    got = kpaged.paged_flash_decode(*t[:5], k_scale=t[5], v_scale=t[6])
    _close(got, want, "float32")
    assert not got[1].any()
    k_new, v_new = (rng.normal(size=(4, 1, 4, 64)).astype(np.float32) for _ in range(2))
    cached = np.maximum(lens - 1, 0)
    mask = lens > 0
    jout = jax_ba.block_multihead_attention(
        *map(jnp.asarray, (q[:, None], k_new, v_new, kq, vq, tables, cached)), slot_mask=jnp.asarray(mask),
        key_scale=jnp.asarray(ksc), value_scale=jnp.asarray(vsc))
    pools = [a.clone() for a in (t[1], t[2], t[5], t[6])]
    tout = incubate.block_multihead_attention(
        t[0][:, None], torch.from_numpy(k_new), torch.from_numpy(v_new), pools[0], pools[1], t[3],
        torch.from_numpy(cached), slot_mask=torch.from_numpy(mask), key_scale=pools[2], value_scale=pools[3])
    assert len(tout) == 5 and all(a is b for a, b in zip(tout[1:], pools))
    _close(tout[0], jout[0], "float32")
    for got_p, want_p in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


# -- the cache appends -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "slot-mask"])
def test_append_and_prefill_match_jax_bit_for_bit(masked):
    rng = np.random.default_rng(4)
    b, s, h, d, bs, nb = 4, 7, 2, 8, 4, 12
    kc = rng.normal(size=(nb, h, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, h, bs, d)).astype(np.float32)
    # masked, slot 3's row aliases slot 0's blocks: it must write nothing
    tables = np.array([[3, 7, 0], [9, 1, 5], [2, 11, 4], [3, 7, 0] if masked else [6, 8, 10]], np.int32)
    k1, v1 = (rng.normal(size=(b, h, d)).astype(np.float32) for _ in range(2))
    positions = np.array([5, 8, 0, 3], np.int32)  # 8: the first slot of a new block
    mask = np.array([True, True, True, not masked])
    jk, jv = jax_ba.block_cache_append(*map(jnp.asarray, (kc, vc, k1, v1, tables, positions)),
                                       slot_mask=jnp.asarray(mask) if masked else None)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = incubate.block_cache_append(tk, tv, *map(torch.from_numpy, (k1, v1, tables, positions)),
                                      slot_mask=torch.from_numpy(mask) if masked else None)
    assert out[0] is tk and out[1] is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    seq_lens = np.array([7, 2, 4, 0] if masked else [5, 7, 1, 3], np.int32)  # up to S, 0 writes nothing
    jk, jv = jax_ba.block_cache_prefill(*map(jnp.asarray, (kc, vc, k, v, tables, seq_lens)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    incubate.block_cache_prefill(tk, tv, *map(torch.from_numpy, (k, v, tables, seq_lens)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- the block_multihead entries --------------------------------------------------------

@pytest.mark.parametrize("entry", ["chunk", "decode", "decode_fused"])
@pytest.mark.parametrize("d", [32, 64], ids=["d32-composition", "d64-kernel"])
def test_block_multihead_entries_match_jax(entry, d):
    """Append then attend, out and both pools. Slot 2 is masked off and its
    table aliases slot 0's blocks; slot 1's lengths end on a block edge."""
    rng = np.random.default_rng(5)
    b, hq, hkv, bs, nb = 3, 4, 2, 8, 16
    c = 4 if entry == "chunk" else 1
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, c, hkv, d)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.normal(size=(nb, hkv, bs, d)).astype(np.float32) for _ in range(2))
    cos = np.cos(rng.normal(size=(b, c, 1, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(b, c, 1, d))).astype(np.float32)
    tables = np.array([[3, 7, 0, 0], [9, 1, 12, 0], [3, 7, 0, 0]], np.int32)
    lens = np.array([6, 12 if entry == "chunk" else 15, 6], np.int32)
    q_lens = np.array([3, 4, 2], np.int32)
    mask = np.array([True, True, False])
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    if entry == "chunk":
        want = jax_ba.block_multihead_chunk_attention(*map(jnp.asarray, (q, k, v, kc, vc, tables, lens, q_lens)),
                                                      slot_mask=jnp.asarray(mask))
        got = incubate.block_multihead_chunk_attention(*map(torch.from_numpy, (q, k, v)), kc_t, vc_t,
                                                       *map(torch.from_numpy, (tables, lens, q_lens)),
                                                       slot_mask=torch.from_numpy(mask))
    elif entry == "decode":
        want = jax_ba.block_multihead_attention(*map(jnp.asarray, (q, k, v, kc, vc, tables, lens)),
                                                slot_mask=jnp.asarray(mask))
        got = incubate.block_multihead_attention(*map(torch.from_numpy, (q, k, v)), kc_t, vc_t,
                                                 *map(torch.from_numpy, (tables, lens)),
                                                 slot_mask=torch.from_numpy(mask))
    else:
        want = jax_ba.block_multihead_attention_fused(
            *map(jnp.asarray, (q, k, v, cos, sin, kc, vc, tables, lens)), slot_mask=jnp.asarray(mask))
        got = incubate.block_multihead_attention_fused(*map(torch.from_numpy, (q, k, v, cos, sin)), kc_t, vc_t,
                                                       *map(torch.from_numpy, (tables, lens)),
                                                       slot_mask=torch.from_numpy(mask))
    assert got[1] is kc_t and got[2] is vc_t and got[0].shape == (b, c, hq, d)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **(TOL if entry != "decode_fused" else
                                                                      dict(rtol=2e-5, atol=2e-5)))
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(want[2]))
    assert not got[0][2].any()


def test_block_kv_cache_tables_match_jax():
    kw = dict(num_heads=2, head_dim=8, max_blocks_per_seq=5)
    jmgr, mgr = jax_ba.BlockKVCache(12, 4, **kw), incubate.BlockKVCache(12, 4, max_blocks_per_seq=5)
    ops = [("allocate", 0, 6), ("allocate", 1, 1), ("allocate", 0, 3), ("allocate", 2, 8), ("free", 1),
           ("allocate", 3, 5), ("truncate", 2, 3), ("allocate", 1, 2)]
    for op, *args in ops:
        getattr(jmgr, op)(*args)
        getattr(mgr, op)(*args)
        ids = [0, 1, 2, 3]
        np.testing.assert_array_equal(mgr.block_table(ids).numpy(), np.asarray(jmgr.block_table(ids)))
        np.testing.assert_array_equal(mgr.seq_lens(ids).numpy(), np.asarray(jmgr.seq_lens(ids)))
        assert [mgr.seq_len(i) for i in ids] == [jmgr.seq_len(i) for i in ids]
        assert [mgr.blocks_allocated(i) for i in ids] == [jmgr.blocks_allocated(i) for i in ids]
        assert mgr.blocks_allocated() == jmgr.blocks_allocated() and mgr.free_blocks == jmgr.free_blocks
    with pytest.raises(MemoryError):
        mgr.allocate(0, 20)  # past max_blocks_per_seq
    for i in range(4):
        mgr.free(i)
    assert mgr.free_blocks == 12 and mgr.block_table([0]).abs().sum() == 0


# -- the tiny Llama ----------------------------------------------------------------------

def _port_config(jcfg, dtype="float32"):
    return LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
        num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
        max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
        rope_theta=jcfg.rope_theta, dtype=dtype,
    )


def _carry(jcfg, dtype="float32", seed=11):
    paddle.seed(seed)
    jmodel = JaxLlama(jcfg)
    jmodel.eval()
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    state = {k: a.astype(np.dtype(dtype)) if a.dtype.kind == "f" else a for k, a in state.items()}
    return jmodel, from_paddle_tpu_state(state, _port_config(jcfg, dtype), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxLlamaConfig.tiny()
    return (*_carry(jcfg), jcfg)


def test_dense_prefill_matches_jax(tiny):
    jmodel, model, jcfg = tiny
    ids = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    with paddle.no_grad():
        jlogits, jcaches = jmodel(Tensor(jnp.asarray(ids)), use_cache=True)
    with torch.inference_mode():
        logits, caches = model(torch.from_numpy(ids), use_cache=True)
    assert logits.shape == tuple(jlogits.shape) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    for (k, v), (jk, jv) in zip(caches, jcaches):
        assert k.shape == tuple(jk.shape) and v.shape == tuple(jv.shape)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk._data), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv._data), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block_size,eos", [(4, False), (16, False), (4, True)], ids=["bs4", "bs16", "bs4-eos"])
def test_generate_paged_matches_jax(tiny, block_size, eos):
    jmodel, model, jcfg = tiny
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    kw = dict(max_new_tokens=10)
    if eos:  # a token the greedy stream of row 1 emits midway: rows stop, then pad
        plain = model.generate_paged(ids, block_size=block_size, **kw).numpy()
        kw.update(eos_token_id=int(plain[1, 7 + 3]), pad_token_id=3)
    want = np.asarray(jmodel.generate_paged(Tensor(jnp.asarray(ids)), block_size=block_size, **kw)._data)
    got = model.generate_paged(ids, block_size=block_size, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 17)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = np.asarray(jmodel.generate(Tensor(jnp.asarray(ids)), do_sample=False, **kw)._data)
    np.testing.assert_array_equal(got.numpy(), greedy)
    if eos:
        row = got[1, 7:].tolist()
        stop = row.index(kw["eos_token_id"])
        assert stop < 9 and row[stop + 1:] == [3] * (9 - stop)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.generate_paged(ids, max_new_tokens=jcfg.max_position_embeddings)


def _drive(eng, schedule):
    """Feed ``schedule`` (step index -> prompts to add before that step) and
    step to completion; returns the generated tokens in submission order."""
    ids, out, step = [], {}, 0
    while step in schedule or eng.has_work() or any(s > step for s in schedule):
        for prompt, budget in schedule.get(step, ()):
            ids.append(eng.add_request(prompt, max_new_tokens=budget))
        for req in eng.step():
            out[req.req_id] = list(req.generated)
        step += 1
    return [out[i] for i in ids]


def test_unfused_engine_matches_jax_engine_and_fused_engine(tiny):
    jmodel, model, jcfg = tiny
    rng = np.random.default_rng(8)
    schedule = {
        0: [(rng.integers(0, jcfg.vocab_size, 19), 7), (rng.integers(0, jcfg.vocab_size, 3), 9)],
        2: [(rng.integers(0, jcfg.vocab_size, 11), 5)],
        3: [(rng.integers(0, jcfg.vocab_size, 24), 6), (rng.integers(0, jcfg.vocab_size, 1), 4)],
    }
    fused = _drive(ContinuousBatchingEngine(model, **ENGINE_KW), schedule)
    with _unfused_decode_layer():
        with _jax_engine_globals_preserved():
            want = _drive(JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW), schedule)
        got = _drive(ContinuousBatchingEngine(model, **ENGINE_KW), schedule)
    assert [len(g) for g in got] == [7, 9, 5, 6, 4]
    assert got == want
    assert got == fused


# -- the dispatch at a width within the kernels' reach ------------------------------------

SPIED = ("paged_flash_chunk_fused_plain", "paged_flash_chunk_plain", "paged_flash_decode_plain",
         "paged_flash_decode_fused_plain")


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain versions the wrappers run on the CPU — on the card
    each would be one launch of its kernel."""
    calls = {name: 0 for name in (*SPIED, "rms_norm_fwd_plain")}
    for mod, names in ((kpaged, SPIED), (kfused, ("rms_norm_fwd_plain",))):
        for name in names:
            real = getattr(mod, name)

            def spy(*args, _name=name, _real=real, **kwargs):
                calls[_name] += 1
                return _real(*args, **kwargs)

            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_decode_and_unfused_step_dispatch(plain_calls, dtype):
    jcfg = JaxLlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128)
    _, model = _carry(jcfg, dtype)
    layers = jcfg.num_hidden_layers
    ids = np.random.default_rng(9).integers(0, 256, (2, 6)).astype(np.int32)
    out = model.generate_paged(ids, max_new_tokens=4, block_size=4)
    assert out.shape == (2, 10)
    # prefill: the flash forward and RMSNorm; then 3 decode steps through kernel 5
    assert plain_calls == {"paged_flash_chunk_fused_plain": 0, "paged_flash_chunk_plain": 0,
                           "paged_flash_decode_plain": 3 * layers, "paged_flash_decode_fused_plain": 0,
                           "rms_norm_fwd_plain": 4 * (2 * layers + 1)}
    for name in plain_calls:
        plain_calls[name] = 0
    with _unfused_decode_layer():
        eng = ContinuousBatchingEngine(model, **ENGINE_KW)
        eng.add_request(ids[0], max_new_tokens=3)
        eng.add_request(ids[1, :3], max_new_tokens=2)
        eng.run()
    steps = eng.stats["steps"]
    assert plain_calls == {"paged_flash_chunk_fused_plain": 0, "paged_flash_chunk_plain": steps * layers,
                           "paged_flash_decode_plain": 0, "paged_flash_decode_fused_plain": 0,
                           "rms_norm_fwd_plain": steps * (2 * layers + 1)}
