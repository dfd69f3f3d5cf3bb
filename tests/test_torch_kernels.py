"""Parity of the PyTorch port's kernel modules with the JAX package.

Each ported kernel's plain PyTorch version (what its wrapper runs for CPU
tensors) is held against the JAX package's Pallas kernel run in interpret
mode, and against the JAX XLA fallback where the serving path uses one, on
the same numpy inputs, in fp32 at rtol/atol 1e-5. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.

Also here: the port's import rule (no JAX, no ``paddle_tpu``), its device
rule (no silent CPU fallback), and its flag and allocator contracts.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.incubate.nn.functional as jax_incubate
import paddle_tpu.incubate.nn.functional.block_attention as jax_ba
import paddle_tpu.nn.functional as jax_F
from paddle_tpu.kernels.fused import (
    fused_embed_rms_norm_pallas,
    fused_rms_norm_residual_pallas,
)
from paddle_tpu.kernels.paged_attention import paged_flash_chunk_fused as jax_chunk_fused

import paddle_tpu_torch
from paddle_tpu_torch.core import default_device
from paddle_tpu_torch.incubate.nn.functional import (
    BlockKVCache,
    _rope_apply_xla,
    block_cache_cow_copy,
    block_multihead_chunk_attention_fused,
)
from paddle_tpu_torch.kernels import fused as kfused
from paddle_tpu_torch.kernels import fused_loss as kloss
from paddle_tpu_torch.kernels import paged_attention as kpaged
from paddle_tpu_torch.kernels import quant as kquant
from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


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
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_inputs(seed, hq, hkv, b=4, c=4, d=32, bs=8, mbs=4, nb=16):
    """A mixed ragged batch: a decode row, a full chunk, an idle slot
    (q_lens 0) and a partial chunk. Table entries past each slot's used
    blocks hold out-of-range garbage that must never be dereferenced."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    cos = np.cos(rng.normal(size=(b, c, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(b, c, d))).astype(np.float32)
    kc = rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)
    q_lens = np.array([1, c, 0, 3][:b], np.int32)
    lens = np.array([13, 5, 0, 20][:b], np.int32)
    tables = rng.permutation(nb)[: b * mbs].reshape(b, mbs).astype(np.int32)
    for i in range(b):
        used = -(-(lens[i] + q_lens[i]) // bs)
        tables[i, used:] = nb + 1000 + i
    return q, cos, sin, kc, vc, tables, lens, q_lens


# -- kernel A: rope-fused paged chunk attention --------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_chunk_plain_matches_pallas_interpret(hq, hkv):
    q, cos, sin, kc, vc, tables, lens, q_lens = _paged_inputs(0, hq, hkv)
    ref = jax_chunk_fused(
        jnp.asarray(q), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(q_lens),
        interpret=True,
    )
    got = kpaged.paged_flash_chunk_fused(*map(_t, (q, cos, sin, kc, vc, tables, lens, q_lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert not got[2].any() and not got[0, 1:].any()  # rows past q_lens are exact 0


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_chunk_attention_fused_matches_xla_fallback_with_append(hq, hkv):
    """The whole per-layer attention (k rope, chunk append, attend) against
    the JAX XLA path, caches included. Slot 2 is masked off and its table
    aliases slot 0's blocks: its rows must be dropped, not written."""
    rng = np.random.default_rng(1)
    b, c, d, bs, mbs, nb = 3, 4, 32, 8, 4, 16
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, c, hkv, d)).astype(np.float32)
    cos = np.cos(rng.normal(size=(b, c, 1, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(b, c, 1, d))).astype(np.float32)
    kc = rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)
    tables = np.array([[3, 7, 0, 0], [9, 1, 12, 0], [3, 7, 0, 0]], np.int32)
    lens = np.array([6, 17, 6], np.int32)
    q_lens = np.array([3, 1, 4], np.int32)
    mask = np.array([True, True, False])
    out_j, kc_j, vc_j = jax_ba.block_multihead_chunk_attention_fused(
        *map(jnp.asarray, (q, k, v, cos, sin, kc, vc, tables, lens, q_lens)),
        slot_mask=jnp.asarray(mask),
    )
    kc_t, vc_t = _t(kc.copy()), _t(vc.copy())
    out_t, kc_r, vc_r = block_multihead_chunk_attention_fused(
        *map(_t, (q, k, v, cos, sin)), kc_t, vc_t,
        *map(_t, (tables, lens, q_lens)), slot_mask=_t(mask),
    )
    assert kc_r is kc_t and vc_r is vc_t  # the pools, updated in place
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), **TOL)
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))
    assert not out_t[2].any()


def test_cow_copy_matches_jax_and_skips_no_fork_rows():
    rng = np.random.default_rng(2)
    kc = rng.normal(size=(6, 2, 4, 8)).astype(np.float32)
    vc = rng.normal(size=(6, 2, 4, 8)).astype(np.float32)
    src = np.array([1, 4, 0], np.int32)
    dst = np.array([5, 6, 2], np.int32)  # 6 == NB: no fork for that slot
    kc_j, vc_j = jax_ba.block_cache_cow_copy(*map(jnp.asarray, (kc, vc, src, dst)))
    kc_t, vc_t = _t(kc.copy()), _t(vc.copy())
    block_cache_cow_copy(kc_t, vc_t, _t(src), _t(dst))
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))


@pytest.mark.parametrize("neox", [True, False])
def test_rope_apply_matches_jax(neox):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    sin = rng.normal(size=(5, 16)).astype(np.float32)
    cos = rng.normal(size=(5, 16)).astype(np.float32)
    ref = jax_incubate._rope_apply_xla(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos), neox)
    got = _rope_apply_xla(_t(x), _t(sin), _t(cos), neox)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# -- kernels B and C ---------------------------------------------------------

def test_embed_rms_plain_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(40, 128)).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32)
    ids = rng.integers(0, 40, (3, 5)).astype(np.int32)
    ids[0, 0], ids[1, 2] = -3, 45  # out of range: clipped to [0, V-1]
    emb_j, y_j = fused_embed_rms_norm_pallas(
        jnp.asarray(ids), jnp.asarray(table), jnp.asarray(w), 1e-5, interpret=True
    )
    emb_t, y_t = kfused.fused_embed_rms_norm(_t(ids), _t(table), _t(w), 1e-5)
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


def test_rms_residual_plain_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 128)).astype(np.float32)
    res = rng.normal(size=(2, 7, 128)).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32)
    y_j, r_j = fused_rms_norm_residual_pallas(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(w), 1e-5, interpret=True
    )
    y_t, r_t = kfused.fused_rms_norm_residual(_t(x), _t(w), _t(res), 1e-5)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    reset_launch_counts()
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(3, 16)).astype(np.float32))
    w = _t(np.ones(16, np.float32))
    kfused.fused_rms_norm_residual(x, w, x)
    kfused.fused_embed_rms_norm(torch.tensor([[1, 2]]), x, w)
    q, cos, sin, kc, vc, tables, lens, q_lens = map(_t, _paged_inputs(0, 4, 4))
    kpaged.paged_flash_chunk_fused(q, cos, sin, kc, vc, tables, lens, q_lens)
    kpaged.paged_flash_chunk(q, kc, vc, tables, lens, q_lens)
    kpaged.paged_flash_decode(q[:, 0], kc, vc, tables, lens)
    kpaged.paged_flash_decode_fused(q[:, 0], cos[:, :1], sin[:, :1], kc, vc, tables, lens)
    y, rstd = kfused.rms_norm_fwd(x, w)
    kfused.rms_norm_bwd(x, w, rstd, y)
    kfused.rms_residual_bwd(y, x, w)
    kfused.ln_residual_bwd(kfused.ln_residual(x, w, None, x)[0], x, w)
    xr = x.reshape(1, 3, 1, 16)
    kfused.rope_bwd(kfused.rope_fwd(xr, x, x), x, x)
    lab = torch.tensor([0, 5, -100])
    lse, _ = kloss.flxent_fwd(x, w.reshape(16, 1).expand(16, 8), lab)
    kloss.flxent_bwd(x, w.reshape(16, 1).expand(16, 8), lab, lse, torch.ones(3))
    kloss.flxent_dchunk(x, w.reshape(16, 1).expand(16, 8), lab, lse, torch.ones(3), 2, 7)
    kloss.tf32_planes(x, same=True, trans=True)  # the fp32 backward's split pass
    # the int8 serving path's wrappers
    k8, v8 = (torch.zeros(t.shape, dtype=torch.int8) for t in (kc, vc))
    ks = torch.ones(kc.shape[:3])
    kpaged.paged_flash_chunk_fused(q, cos, sin, k8, v8, tables, lens, q_lens, k_scale=ks, v_scale=ks)
    kpaged.paged_flash_chunk(q, k8, v8, tables, lens, q_lens, k_scale=ks, v_scale=ks)
    kpaged.paged_flash_decode(q[:, 0], k8, v8, tables, lens, k_scale=ks, v_scale=ks)
    kpaged.paged_flash_decode_fused(q[:, 0], cos[:, :1], sin[:, :1], k8, v8, tables, lens, k_scale=ks, v_scale=ks)
    w8 = torch.ones((16, 8), dtype=torch.int8)
    kquant.int8_weight_matmul(x, w8, torch.ones(8))
    kloss.flxent_fwd_int8(x, w8, torch.ones(8), lab)
    kloss.int8_plane(w8, False, 0, 8)  # the fp32 int8 site's widen pass
    assert launch_counts() == {"paged_chunk_fused": 0, "paged_chunk": 0, "paged_decode": 0,
                               "paged_decode_fused": 0, "embed_rms": 0, "rms_residual": 0,
                               "flash_fwd": 0, "flash_fwd_wide": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                               "flash_bwd_dq_wide": 0, "flash_bwd_dkv_wide": 0,
                               "rms_norm_fwd": 0, "rms_norm_bwd": 0, "rope_fwd": 0, "rope_bwd": 0,
                               "rms_residual_bwd": 0, "ln_residual": 0, "ln_residual_bwd": 0,
                               "flxent_fwd": 0, "flxent_dchunk": 0, "flxent_dx": 0, "flxent_dw": 0,
                               "flxent_split": 0, "wo_matmul": 0, "paged_chunk_fused_int8": 0, "paged_chunk_int8": 0,
                               "paged_decode_int8": 0, "paged_decode_fused_int8": 0, "flxent_fwd_int8": 0,
                               "flxent_widen": 0}


# -- nn functionals ----------------------------------------------------------

def test_nn_functionals_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 4, 32)).astype(np.float32)
    y = rng.normal(size=(3, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    g = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        F.linear(_t(x), _t(w)).numpy(), np.asarray(jax_F.linear(jnp.asarray(x), jnp.asarray(w))), **TOL
    )
    np.testing.assert_allclose(
        F.swiglu(_t(x), _t(y)).numpy(), np.asarray(jax_F.swiglu(jnp.asarray(x), jnp.asarray(y))), **TOL
    )
    np.testing.assert_allclose(
        F.rms_norm(_t(x), _t(g), 1e-5).numpy(),
        np.asarray(jax_F.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)), **TOL,
    )


# -- allocator, flags, device and import rules --------------------------------

def test_block_pool_refcounts():
    pool = BlockKVCache(3, 4)
    a, b = pool.acquire_block(), pool.acquire_block()
    assert (a, b) == (0, 1) and pool.free_blocks == 1
    assert pool.incref(a) == 2 and pool.refcounts() == {0: 2, 1: 1}
    assert not pool.decref(a) and pool.decref(a) and pool.free_blocks == 2
    pool.acquire_block(), pool.acquire_block()
    with pytest.raises(MemoryError):
        pool.acquire_block()
    with pytest.raises(ValueError):
        pool.decref(a + 100)


def test_flags_refuse_what_the_port_lacks():
    assert paddle_tpu_torch.get_flags(["FLAGS_kv_cache_dtype"]) == {"FLAGS_kv_cache_dtype": "bf16"}
    paddle_tpu_torch.set_flags({"FLAGS_kv_cache_dtype": "bf16"})
    for name, value in [("FLAGS_kv_cache_dtype", "fp8"), ("FLAGS_enable_prefix_cache", "True"),
                        ("FLAGS_use_fused_decode_layer", "False"), ("FLAGS_weight_only_int8", "True")]:
        with pytest.raises(ValueError):
            paddle_tpu_torch.set_flags({name: value})
    # the prefix cache is ported: accepted, and on by default as in JAX
    assert paddle_tpu_torch.get_flags(["FLAGS_enable_prefix_cache"]) == {"FLAGS_enable_prefix_cache": True}
    paddle_tpu_torch.set_flags({"FLAGS_enable_prefix_cache": False})
    try:
        assert paddle_tpu_torch.get_flags(["FLAGS_enable_prefix_cache"]) == {"FLAGS_enable_prefix_cache": False}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_enable_prefix_cache": True})
    # the int8 pool and the weight-only int8 projections are ported: accepted, off by default
    assert paddle_tpu_torch.get_flags(["FLAGS_weight_only_int8"]) == {"FLAGS_weight_only_int8": False}
    paddle_tpu_torch.set_flags({"FLAGS_kv_cache_dtype": "int8", "FLAGS_weight_only_int8": True})
    try:
        assert paddle_tpu_torch.get_flags(["FLAGS_kv_cache_dtype", "FLAGS_weight_only_int8"]) == {
            "FLAGS_kv_cache_dtype": "int8", "FLAGS_weight_only_int8": True}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_kv_cache_dtype": "bf16", "FLAGS_weight_only_int8": False})
    # the unfused decode layer loop is ported: False is accepted, True is the default
    assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_decode_layer"]) == {"FLAGS_use_fused_decode_layer": True}
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": False})
    try:
        assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_decode_layer"]) == {"FLAGS_use_fused_decode_layer": False}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": True})
    assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_decode_layer"]) == {"FLAGS_use_fused_decode_layer": True}
    with pytest.raises(KeyError):
        paddle_tpu_torch.get_flags(["FLAGS_no_such_flag"])


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "paddle_tpu"):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
    return bad


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert bad == []
