"""Head dims 320 to 512, and 576 above them, in the port against the JAX
package, and the launch
plans of kernels A/4 and 7.

The JAX package's ``D % 64`` gate sends every multiple of 64 to its Pallas
kernels; so do the port's CUDA kernels (the bf16 / fp16 flash forward 14 on
the tensor cores in ``csrc/flash_fwd_wide.cu``, 15-16 and fp32 on the
CUDA-core instances of ``csrc/flash_fp32.cu`` up to 512 and
``csrc/flash_deep.cu`` above, A/4 with O's columns split over CTAs, 5/6 at
any head dim). On the
CPU the wrappers run their
plain versions, so these tests hold the plain versions at D 320, 512 and 576
against the Pallas kernels in interpret mode on the same numpy inputs:

- flash forward, dq and dk/dv (causal, and FlashMask C=1 and C=2), and the
  autograd entry against ``jax.grad``: fp32 at 1e-5, the flash suite's;
- the paged chunk (A, 4) and decode (5, 6) functions in bf16, over a bf16
  pool and over the int8 pool: within one bf16 ulp of the output's largest
  magnitude (both sum the same fp32 products in another order, then round
  once; XLA on the CPU ropes A's q without rounding its products);
- a tiny Llama at head dim 320 (hidden 640, 2 heads, 2 layers) carried over
  with ``from_paddle_tpu_state``: its train loss, logits and every gradient
  at 1e-4 in fp32 (the training suite's), and its engine streams against
  the JAX engine's, token for token.

The plans are host functions: ``rms_fwd_plan`` (kernel 7's route and
shape) and ``chunk_plan`` (A/4's column split, tile rows and cluster size)
are checked here without a card, and so is that A's and 4's wrappers
launch with ``chunk_plan``'s cluster size (the card gives only the cap:
the CTAs it holds at once).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.kernels import paged_attention as jax_paged
from paddle_tpu.kernels.flash_attention import _pad_to, _run_bwd, _run_fwd, flash_attention_pallas
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.flight_recorder import GLOBAL_FLIGHT_RECORDER
from paddle_tpu.observability.recompile import GLOBAL_WATCHDOG
import paddle_tpu.incubate.nn.functional.block_attention as jax_ba

import paddle_tpu_torch
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.kernels import flash_attention as kfa
from paddle_tpu_torch.kernels import fused as kfused
from paddle_tpu_torch.kernels import paged_attention as kpaged
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-5, atol=1e-5)
BLK = 16
WIDE = (320, 512, 576)


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


# -- flash attention, kernels 14-16 ---------------------------------------------------

def _flash_inputs(seed, d, c, s=40, h=2, hk=1, b=2):
    """q, k, v, g ``[B, S, H|HK, D]`` and FlashMask bounds that keep every
    row's diagonal: C=1 documents of 3..12 tokens, C=2 a band below the
    diagonal; C=0 none."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, hk, d)).astype(np.float32) for _ in range(2))
    bounds = None
    if c == 1:
        ends = np.zeros((b, s), np.int32)
        for bi in range(b):
            pos = 0
            while pos < s:
                end = min(s, pos + int(rng.integers(3, 13)))
                ends[bi, pos:end] = end
                pos = end
        bounds = ends[:, None, :, None].copy()
    elif c == 2:
        j = np.arange(s)[None, None, :]
        start = np.minimum(j + 1 + rng.integers(0, 6, (b, 1, s)), s)
        end = np.minimum(start + rng.integers(0, 10, (b, 1, s)), s)
        bounds = np.stack([start, end], -1).astype(np.int32)
    return q, k, v, g, bounds


def _pallas_fwd_bwd(q, k, v, g, bounds, causal):
    """The Pallas kernels in interpret mode on ``[B, H, S, D]`` arrays padded
    to the block, as ``_make_flash_core`` runs them; out, lse, dq, dk, dv."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh, gh = (_pad_to(jnp.moveaxis(jnp.asarray(x), 2, 1), 2, BLK) for x in (q, k, v, g))
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds), 2, BLK)
    kw = dict(sq=sq, sk=sk, scale=1.0 / d**0.5, causal=causal, blk_q=BLK, blk_k=BLK, interpret=True)
    out, lse = _run_fwd(qh, kh, vh, idx, **kw)
    dq, dk, dv = _run_bwd(qh, kh, vh, idx, gh, out, lse, **kw)

    def back(x, n):
        return np.asarray(jnp.moveaxis(x[:, :, :n], 1, 2))

    return back(out, sq), np.asarray(lse[:, :, :sq, 0]), back(dq, sq), back(dk, sk), back(dv, sk)


FLASH_CASES = [(d, c, causal) for d in WIDE for c, causal in ((0, True), (1, True), (2, False))]


@pytest.mark.parametrize("d,c,causal", FLASH_CASES,
                         ids=[f"d{d}-c{c}-{'causal' if k else 'full'}" for d, c, k in FLASH_CASES])
def test_flash_plain_versions_match_pallas_at_wide_head_dims(d, c, causal):
    q, k, v, g, bounds = _flash_inputs(d + c, d, c)
    out_j, lse_j, dq_j, dk_j, dv_j = _pallas_fwd_bwd(q, k, v, g, bounds, causal)
    bnd = None if bounds is None else _t(bounds)
    out, lse = kfa.flash_fwd(_t(q), _t(k), _t(v), bnd, causal)
    np.testing.assert_allclose(out.numpy(), out_j, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    lse_t = _t(lse_j)
    delta = (_t(g) * _t(out_j)).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq(_t(q), _t(k), _t(v), bnd, _t(g), lse_t, delta, causal)
    dk, dv = kfa.flash_bwd_dkv(_t(q), _t(k), _t(v), bnd, _t(g), lse_t, delta, causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", WIDE)
def test_flashmask_entry_grads_match_jax_grad_at_wide_head_dims(d):
    """``flashmask_attention`` (``D % 64 == 0``: the kernel path, whose
    backward is the dq and dk/dv wrappers) and its gradients against
    ``jax.grad`` of the Pallas entry under a document mask."""
    q, k, v, g, bounds = _flash_inputs(7 + d, d, 1)

    def loss(q_, k_, v_):
        out = flash_attention_pallas(q_, k_, v_, jnp.asarray(bounds), causal=True,
                                     block_q=BLK, block_k=BLK, interpret=True)
        return (out * jnp.asarray(g)).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = F.flashmask_attention(qt, kt, vt, startend_row_indices=_t(bounds), causal=True)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_wide_head_dims_take_the_cuda_core_walk():
    """Above D 256 fp32 takes the CUDA-core instances' tiles, as it does at
    every head dim, and bf16 and fp16 the tensor-core kernels' 64 x 64 tiles
    in all three kernels (``csrc/flash_fwd_wide.cu``,
    ``csrc/flash_bwd_wide.cu``); up to 256 the wgmma tiles stay."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in (320, 384, 448, 512, 576, 1024):
            simt = dtype == torch.float32
            assert kfa.flash_tile_shape("flash_fwd", d, dtype) == ((16, 32) if simt else (64, 64))
            assert kfa.flash_tile_shape("flash_bwd_dq", d, dtype) == ((16, 32) if simt else (64, 64))
            assert kfa.flash_tile_shape("flash_bwd_dkv", d, dtype) == ((32, 16) if simt else (64, 64))
    assert kfa.flash_tile_shape("flash_fwd", 256, torch.bfloat16) == (128, 64)
    assert kfa.flash_tile_shape("flash_bwd_dkv", 256, torch.float16) == (64, 64)


# -- paged attention, kernels A, 4, 5, 6 ----------------------------------------------

def _tables(rng, lens_after, b, bs, mbs, nb):
    """Distinct blocks for each slot's used positions; every entry past them
    is out-of-range garbage that must never be dereferenced."""
    tables = rng.permutation(nb)[: b * mbs].reshape(b, mbs).astype(np.int32)
    for i in range(b):
        tables[i, -(-int(lens_after[i]) // bs):] = nb + 1000 + i
    return tables


def _within_ulp_of_max(got: torch.Tensor, want) -> None:
    """Within one bf16 ulp of the largest output magnitude."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


PAGED_CASES = [(kernel, d, int8) for kernel in ("chunk_fused", "chunk", "decode", "decode_fused")
               for d in WIDE for int8 in (False, True)]


@pytest.mark.parametrize("kernel,d,int8", PAGED_CASES,
                         ids=[f"{k}-d{d}-{'int8' if i else 'bf16'}" for k, d, i in PAGED_CASES])
def test_paged_plain_versions_match_pallas_at_wide_head_dims(kernel, d, int8):
    """bf16 q, GQA 4/2, a bf16 pool or the int8 pool (quantized by the JAX
    package's own quantizer); lengths on a block edge, an idle slot and
    garbage table tails."""
    rng = np.random.default_rng(d + int8)
    hq, hkv, nb, bs = 4, 2, 16, 8
    kv = [rng.normal(size=(nb, hkv, bs, d)).astype(np.float32) for _ in range(2)]
    scales = {}
    if int8:
        k8, ks = jax_ba._quantize_kv_rows(jnp.asarray(kv[0]))
        v8, vs = jax_ba._quantize_kv_rows(jnp.asarray(kv[1]))
        pools = [(_t(a), jnp.asarray(a)) for a in (k8, v8)]
        scales = {"k_scale": (_t(ks), ks), "v_scale": (_t(vs), vs)}
    else:
        pools = [(_t(a).bfloat16(), jnp.asarray(a, jnp.bfloat16)) for a in kv]
    if kernel.startswith("chunk"):
        c = 4
        q = rng.normal(size=(4, c, hq, d)).astype(np.float32)
        lens, q_lens = np.array([13, 4, 0, 16], np.int32), np.array([1, 4, 0, 3], np.int32)  # EXCLUDE the chunk
        rope = [f(rng.normal(size=(4, c, d))).astype(np.float32) for f in (np.cos, np.sin)]
        tail = [_tables(rng, lens + q_lens, 4, bs, 4, nb), lens, q_lens]
    else:
        q = rng.normal(size=(4, hq, d)).astype(np.float32)
        lens = np.array([13, 0, 16, 24], np.int32)  # INCLUDE the current token; 0 is idle
        rope = [f(rng.normal(size=(4, 1, d))).astype(np.float32) for f in (np.cos, np.sin)]
        tail = [_tables(rng, lens, 4, bs, 4, nb), lens]
    head = [(_t(q).bfloat16(), jnp.asarray(q, jnp.bfloat16))]
    if kernel.endswith("fused"):
        head += [(_t(a).bfloat16(), jnp.asarray(a, jnp.bfloat16)) for a in rope]
    args = head + pools + [(_t(a), jnp.asarray(a)) for a in tail]
    want = getattr(jax_paged, f"paged_flash_{kernel}")(*(j for _, j in args), interpret=True,
                                                         **{n: j for n, (_, j) in scales.items()})
    got = getattr(kpaged, f"paged_flash_{kernel}")(*(t for t, _ in args), **{n: t for n, (t, _) in scales.items()})
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    _within_ulp_of_max(got, want)
    if kernel.startswith("chunk"):
        assert not got[2].any() and not got[0, 1:].any() and not got[3, 3:].any()  # rows past q_lens: exact 0
    else:
        assert not got[1].any()  # a slot of length 0: exact 0


@pytest.mark.parametrize("entry", ["paged_flash_chunk_fused", "paged_flash_chunk", "paged_flash_decode",
                                   "paged_flash_decode_fused"])
def test_paged_wrappers_refuse_head_dims_above_512(entry):
    """No longer refused: D 576 and 1024 (multiples of 64, which the JAX
    package's gate sends to its kernels) pass the head-dim check and stop
    at the device check, as D 512 does."""
    for d, why in ((576, "unsupported device meta"), (1024, "unsupported device meta"),
                   (512, "unsupported device meta")):
        if entry.startswith("paged_flash_chunk"):
            q = torch.empty((2, 4, 4, d), dtype=torch.bfloat16, device="meta")
            rest = [torch.empty((2, 4, d), device="meta")] * 2 if entry.endswith("fused") else []
            lens = [torch.zeros(2, dtype=torch.int32, device="meta")] * 2
        else:
            q = torch.empty((2, 4, d), dtype=torch.bfloat16, device="meta")
            rest = [torch.empty((2, 1, d), device="meta")] * 2 if entry.endswith("fused") else []
            lens = [torch.zeros(2, dtype=torch.int32, device="meta")]
        kc = torch.empty((8, 2, 16, d), dtype=torch.bfloat16, device="meta")
        tables = torch.zeros((2, 4), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match=why):
            getattr(kpaged, entry)(q, *rest, kc, kc, tables, *lens)


# -- the launch plans ---------------------------------------------------------------------

PLAN_CASES = [  # (H, dtype) -> route, vectors a lane, warps a row
    (4096, torch.bfloat16, "regs", 4, 4),  # Llama-2-7B's norms: the train step's 8192 rows and the serve's 8 / 512
    (5120, torch.bfloat16, "regs", 5, 4),  # GPT-3 13B's width
    (5120, torch.float32, "regs", 10, 4),
    (2560, torch.bfloat16, "regs", 5, 2),  # 10 vectors a lane: 4 warps would not split them whole
    (384, torch.bfloat16, "loop", 0, 1),  # 48 vectors: not a whole number a lane
    (384, torch.float16, "loop", 0, 1),
    (384, torch.float32, "regs", 3, 1),  # fp32: 96 vectors, 3 a lane, not split
    (16384, torch.bfloat16, "regs", 16, 4),  # the widest register instance
    (32768, torch.bfloat16, "loop", 0, 1),  # 32 vectors a lane even over 4 warps: too wide
]


@pytest.mark.parametrize("h,dtype,route,vecs,warps", PLAN_CASES,
                         ids=[f"h{h}-{str(t)[6:]}" for h, t, *_ in PLAN_CASES])
def test_rms_fwd_plan_routes_and_shapes(h, dtype, route, vecs, warps):
    """Kernel 7's plan: the route, and for the register route the widest
    split of the row into whole 16-byte vectors, at most 16 a lane. It
    depends on no row count (one row a group of warps at 8, 512 and 8192
    rows alike: chip_smoke.py times all three) and on no card."""
    plan = kfused.rms_fwd_plan(h, dtype)
    assert (plan["route"], plan["vecs"], plan["warps_per_row"]) == (route, vecs, warps)
    n = 16 // torch.empty((), dtype=dtype).element_size()
    if route == "regs":
        assert vecs * warps * 32 * n == h and vecs <= kfused.RMS_FWD_MAX_VECS
        assert warps == kfused.RMS_FWD_BLOCK_WARPS or (h // n // 32) % (2 * warps)  # no wider split is whole


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 64), (torch.float32, 32)])
def test_chunk_plan_splits_columns_above_256(dtype, rows):
    """A/4 at the wide_heads serve step (8 slots, chunk 64, GQA 8/2, MBS
    128): above D 256 two CTAs share each tile's columns, the grid doubles
    and the cluster size halves where the doubled grid outgrows the card's
    capacity; fp32 tiles hold 32 rows above 256."""
    cap = 132 * 2  # two CTAs an SM
    base = kpaged.chunk_plan(8, 64, 8, 2, 256, dtype, 128, cap)
    assert (base["split"], base["columns"], base["rows"]) == (1, 256, 64)
    for d in (320, 384, 448, 512):
        plan = kpaged.chunk_plan(8, 64, 8, 2, d, dtype, 128, cap)
        assert (plan["split"], plan["columns"], plan["rows"]) == (2, d // 2, rows)
        assert plan["tiles"] == 64 * 4 // rows
        assert plan["grid"] == (plan["tiles"] * 2 * plan["ranks"], 2, 8)
        # the most of 8, 4, 2, 1 ranks whose clusters the card holds at once
        work = plan["tiles"] * 2 * 2 * 8
        assert work * plan["ranks"] <= cap or plan["ranks"] == 1
        assert plan["ranks"] == 8 or work * plan["ranks"] * 2 > cap
    if dtype == torch.bfloat16:
        assert base["ranks"] == 4 and kpaged.chunk_plan(8, 64, 8, 2, 512, dtype, 128, cap)["ranks"] == 2
    # a one-slot prompt keeps room for the most ranks; the table's width caps them
    assert kpaged.chunk_plan(1, 128, 8, 2, 512, dtype, 128, cap)["ranks"] == (8 if rows == 64 else 4)
    assert kpaged.chunk_plan(1, 1, 8, 2, 512, dtype, 2, cap)["ranks"] == 2


@pytest.mark.parametrize("fused", [True, False], ids=["A", "4"])
@pytest.mark.parametrize("d,int8", [(256, False), (512, False), (512, True), (576, True), (1024, False)])
def test_chunk_wrappers_launch_with_chunk_plan(monkeypatch, fused, d, int8):
    """Kernels A and 4 get their column split and cluster size from
    ``chunk_plan`` on the card's cap (asked of the instance of q's type, the
    pool and the rope): the launch's last int dims are ``chunk_plan``'s
    ``split``, ``columns``, ``rows`` and ``ranks``. Meta tensors
    stand in for the card's; the launch itself is recorded, not run."""
    b, c, hq, hkv, mbs = 8, 64, 8, 2, 128
    cap = 132 * 2
    meta = torch.device("meta")
    q = torch.empty((b, c, hq, d), dtype=torch.bfloat16, device=meta)
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    kc = torch.empty((64, hkv, 16, d), dtype=kv_dtype, device=meta)
    tables = torch.empty((b, mbs), dtype=torch.int32, device=meta)
    lens = torch.empty((b,), dtype=torch.int32, device=meta)
    pools = [kc, kc] + [torch.empty((64, hkv, 16), device=meta)] * 2 * int8
    asked, launched = [], []
    monkeypatch.setattr(kpaged, "_io_dtype", lambda what, x: 1)
    monkeypatch.setattr(kpaged, "_launch_operands", lambda *a, **k: (1, q, pools, tables, lens, lens))
    monkeypatch.setattr(kpaged, "_rope_operands", lambda what, q_, cos, sin, shape: (cos, sin))
    monkeypatch.setattr(kpaged, "_chunk_cap", lambda *key: asked.append(key) or cap)
    monkeypatch.setattr(kpaged, "_launch", lambda name, io, ptrs, dims, scale, dev: launched.append((name, dims)))
    planes = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    if fused:
        rows = torch.empty((b, c, d), device=meta)
        kpaged.paged_flash_chunk_fused(q, rows, rows, kc, kc, tables, lens, lens, **planes)
    else:
        kpaged.paged_flash_chunk(q, kc, kc, tables, lens, lens, **planes)
    plan = kpaged.chunk_plan(b, c, hq, hkv, d, torch.bfloat16, mbs, cap, kv_int8=int8)
    assert asked == [(meta, 1, int8, fused, d, mbs, 0)]  # rows 0: the instance's own
    name = ("paged_chunk_fused" if fused else "paged_chunk") + "_int8" * int8
    assert launched == [(name, (b, c, hq, hkv, d, 16, mbs, plan["split"], plan["columns"], plan["rows"],
                                plan["ranks"]))]
    # above 512: 3 / 4 CTAs a tile, the grid may fill CHUNK_DEEP_WAVES waves of the cap
    assert plan["ranks"] == {256: 4, 512: 2, 576: 4, 1024: 2}[d]


# -- a tiny Llama at head dim 320 ----------------------------------------------------------

JCFG = dict(vocab_size=256, hidden_size=640, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, max_position_embeddings=64)
ENGINE_KW = dict(max_slots=2, block_size=4, prompt_bucket=16, max_model_len=48, prefill_chunk=8,
                 enable_prefix_cache=False)
JAX_ONLY_KW = dict(spec_decode=False, kv_cache_dtype="bf16", tp=1)


def _port_config(jcfg):
    return LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size, intermediate_size=jcfg.intermediate_size,
        num_hidden_layers=jcfg.num_hidden_layers, num_attention_heads=jcfg.num_attention_heads,
        num_key_value_heads=jcfg.num_key_value_heads, max_position_embeddings=jcfg.max_position_embeddings,
        rms_norm_eps=jcfg.rms_norm_eps, rope_theta=jcfg.rope_theta, dtype="float32",
    )


@pytest.fixture(scope="module")
def wide_llama():
    paddle.seed(31)
    jcfg = JaxLlamaConfig(**JCFG)
    jmodel = JaxLlama(jcfg)
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    return jmodel, state, jcfg


@contextlib.contextmanager
def _flags(**values):
    """``values`` set in both packages, the prior values put back."""
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


def test_wide_llama_train_step_matches_jax(wide_llama):
    """Loss, logits and every gradient of one document-masked train step
    (the loss heads unfused in both packages, so the logits compare too)."""
    jmodel, state, jcfg = wide_llama
    assert jcfg.hidden_size // jcfg.num_attention_heads == 320
    rng = np.random.default_rng(4)
    b, s = 2, 24
    ids = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.full((b, s), -100, np.int32)
    ends = np.zeros((b, s), np.int32)
    for bi in range(b):
        pos = 0
        while pos < s:
            end = min(s, pos + int(rng.integers(3, 11)))
            ends[bi, pos:end] = end
            labels[bi, pos:end - 1] = ids[bi, pos + 1:end]
            pos = end
    bounds = ends[:, None, :, None].copy()
    with _flags(use_fused_loss=False):
        jmodel.train()
        for p in jmodel.parameters():
            p.clear_grad()
        jloss, jlogits = jmodel(Tensor(ids), labels=Tensor(labels), startend_row_indices=Tensor(bounds))
        jloss.backward()
        jgrads = {n: np.asarray(p.grad._data) for n, p in jmodel.named_parameters()}
        model = from_paddle_tpu_state(state, _port_config(jcfg), device="cpu")
        loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                             startend_row_indices=torch.from_numpy(bounds))
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4, atol=1e-4, err_msg=name)


@contextlib.contextmanager
def _jax_engine_globals_preserved():
    """Put the process-wide compile watchdog and flight recorder back as
    they were, so no other test in this worker sees this file's engine."""
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


def _drive(eng, prompts):
    ids = [eng.add_request(p, max_new_tokens=n) for p, n in prompts]
    out = {}
    while eng.has_work():
        for req in eng.step():
            out[req.req_id] = list(req.generated)
    return [out[i] for i in ids]


def test_wide_llama_engine_matches_jax_engine(wide_llama):
    """A prompt chunk and a decode row in one step (two requests of 11 and
    3 tokens): the unfused engines of both packages stream the same greedy
    tokens, and so does the port's fused engine (kernel A's path)."""
    jmodel, state, jcfg = wide_llama
    jmodel.eval()
    model = from_paddle_tpu_state(state, _port_config(jcfg), device="cpu")
    rng = np.random.default_rng(8)
    prompts = [(rng.integers(0, jcfg.vocab_size, 11), 4), (rng.integers(0, jcfg.vocab_size, 3), 5)]
    fused = _drive(ContinuousBatchingEngine(model, **ENGINE_KW), prompts)
    with _flags(use_fused_decode_layer=False):
        with _jax_engine_globals_preserved():
            want = _drive(JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW), prompts)
        got = _drive(ContinuousBatchingEngine(model, **ENGINE_KW), prompts)
    assert [len(g) for g in got] == [4, 5]
    assert got == want
    assert fused == want
