"""The PyTorch port's int8 serving path against the JAX package.

- The quantizers (``quantize_weight_int8``, ``_quantize_kv_rows``): bit for
  bit, all-zero columns and rows included; ``quantize_module_weights``
  picks JAX's leaves and never a shared or tied weight.
- Kernel 20's plain version (``int8_weight_matmul`` on CPU tensors) against
  the JAX XLA composition and the Pallas kernel in interpret mode: fp32 at
  1e-5 relative, bf16 and fp16 within one ulp of the type at the output's
  largest magnitude; also at the shapes and dtype the card takes on its
  mma.sync instance (fp32, K % 8 and N % 16 non-zero, a vocab of 32003).
- Kernel 20's wgmma instance, which the CPU cannot run: ``emulate_wo`` (its
  tiles, k steps, fp32 partials, one scale multiply and one rounding)
  against the interpret kernel and the plain version at M 1, 8, 77 and 512
  and a tile-ragged N and K; numpy mirrors of its int8 widening (every
  int8 value exact in bf16 and fp16) and of its A fragments (the swizzled W
  box through ldmatrix.trans to the permuted weight columns); ``wo_route``
  (every main-path shape takes wgmma in bf16) and ``wo_plan`` (every output
  tile covered once; the serving shapes' plans).
- The four cache writes with scale planes (chunk append, decode append,
  prefill, copy-on-write fork): payload and scales bit for bit, masked
  slots and rows past ``q_lens`` included.
- The plain versions of kernels A, 4, 5 and 6 over int8 pools against the
  Pallas kernels in interpret mode, MHA and GQA, head dim 64 and 128 (and
  192 and 256 in bf16), at the paged tests' tolerances (fp32 1e-5, kernel 6
  2e-5; bf16 one ulp).
- The weight-only int8 loss (kernel 17's int8 site): the public entry,
  H-major and vocab-major, every reduction, against ``_reference_quant_path``
  and the interpret ``_pallas_quant_path`` at 1e-5; its routes
  (``flx_int8_route``: kernel 20's wgmma mainloop for bf16 / fp16 ``W [H,
  V]`` with V % 16 == 0, mma.sync otherwise; for fp32 the TF32 instance
  where its widen pass takes W (16-byte aligned, rows a multiple of 16
  bytes, H a multiple of 4), else the CUDA cores);
  ``emulate_flx_int8_fwd`` (the wgmma route's tiles and transposed
  epilogue: scale before the mask, the reduction over vocab rows) and the
  CUDA-core instance's emulation in fp32 against the plain version and
  the Pallas kernel in interpret mode.
- End to end on a tiny fp32 Llama carried across: both engines with
  ``kv_cache_dtype="int8", weight_only_int8=True``, fused and unfused, give
  the same greedy streams and ``bytes_per_token``; one step's logits
  agree at 1e-4 (the serving tests' tolerance); a JAX-quantized model
  carried across with ``quant_scales`` gives the port-quantized model's
  logits; a bf16 weight-only engine keeps bf16 pools (``model.dtype`` is the
  embedding's, not the int8 head's).
- At a width within the kernels' reach (hidden 256, head dim 128), spying
  on the plain versions shows each int8 step runs kernel A's int8 instance
  once per layer and kernel 20 for every MLP projection and the head.
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
from paddle_tpu.kernels import fused_loss as jax_loss
from paddle_tpu.kernels import paged_attention as jax_paged
from paddle_tpu.kernels import quant as jax_quant
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.flight_recorder import GLOBAL_FLIGHT_RECORDER
from paddle_tpu.observability.recompile import GLOBAL_WATCHDOG

import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn import functional as incubate
from paddle_tpu_torch.incubate.nn.functional.block_attention import _quantize_kv_rows
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.kernels import fused_loss as kloss
from paddle_tpu_torch.kernels import paged_attention as kpaged
from paddle_tpu_torch.kernels import quant as kquant
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Linear

ENGINE_KW = dict(max_slots=3, block_size=4, prompt_bucket=24, max_model_len=64, prefill_chunk=8,
                 enable_prefix_cache=False)
JAX_ONLY_KW = dict(spec_decode=False, tp=1)
INT8_KW = dict(kv_cache_dtype="int8", weight_only_int8=True)
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


def _port_config(jcfg, dtype="float32"):
    return LlamaConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
        intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
        num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
        max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
        rope_theta=jcfg.rope_theta, dtype=dtype,
    )


def _jax_tiny(seed):
    paddle.seed(seed)
    jcfg = JaxLlamaConfig.tiny()
    jmodel = JaxLlama(jcfg)
    jmodel.eval()
    return jmodel, jcfg


def _state(jmodel):
    return {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``
    (integer arrays keep their type)."""
    t = torch.from_numpy(np.array(a))
    if a.dtype.kind == "f":
        return t.to(getattr(torch, dtype)), jnp.asarray(a, getattr(jnp, dtype))
    return t, jnp.asarray(a)


def _close(got: torch.Tensor, want, dtype: str, fp32_tol: float = 1e-5) -> None:
    """fp32: ``fp32_tol`` relative and absolute; bf16 and fp16: within one ulp
    of the type at the largest output magnitude (the same fp32 products
    summed in another order, then rounded to the type)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=fp32_tol, atol=fp32_tol)
    else:
        mantissa = {"bfloat16": 7, "float16": 10}[dtype]
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - mantissa)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


def _bits(t: torch.Tensor, a) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


# -- the quantizers ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_int8_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(48, 40)) * rng.uniform(0.01, 3.0, size=(1, 40))).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1, int8 zeros
    w[:, 6] = 0.0
    w[:4, 6] = [127.0, 0.5, 1.5, -2.5]  # scale 1: exact halves, rounded half to even as jnp.round does
    t, j = _pair(w, dtype)
    w8, scale = kquant.quantize_weight_int8(t)
    jw8, jscale = jax_quant.quantize_weight_int8(j)
    assert w8.dtype == torch.int8 and scale.dtype == torch.float32 and float(scale[3]) == 1.0
    _bits(w8, jw8)
    _bits(scale, jscale)
    assert not w8[:, 3].any() and int(w8.abs().max()) == 127
    assert w8[:4, 6].tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 3, 4, 32)).astype(np.float32) * 3
    x[1, 2, 0] = 0.0  # an all-zero row
    x[4, 0, 3, :] = np.linspace(-0.5, 0.5, 32)  # exact halves after the scale
    t, j = _pair(x, dtype)
    q, s = _quantize_kv_rows(t)
    jq, js = jax_ba._quantize_kv_rows(j)
    _bits(q, jq)
    _bits(s, js)
    assert float(s[1, 2, 0]) == 1.0 and not q[1, 2, 0].any()


def test_quantize_module_weights_picks_jax_leaves_and_skips_shared():
    jmodel, jcfg = _jax_tiny(3)
    model = from_paddle_tpu_state(_state(jmodel), _port_config(jcfg), device="cpu")
    ids = {id(p): name for name, p in jmodel.named_parameters()}
    jnames = [ids[id(p)] for p in jax_quant.quantize_module_weights(jmodel)]
    names = kquant.quantize_module_weights(model)
    assert names == jnames and len(names) == 3 * jcfg.num_hidden_layers + 1
    params = dict(model.named_parameters())
    for name, p in params.items():
        assert (p.dtype == torch.int8) == (name in names), name
        assert p.requires_grad == (name not in names)
    for name in names:
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        jp = dict(jmodel.named_parameters())[name]
        _bits(mod.weight, jp._data)
        _bits(mod.weight_scale, jp._quant_scale)
    assert set(model.state_dict()) == set(params) | {n + "_scale" for n in names}
    assert kquant.quantize_module_weights(model) == []  # idempotent
    with pytest.raises(RuntimeError, match="int8"):
        model.reset_parameters(0)

    class Tied(torch.nn.Module):  # a parameter shared by an lm_head and a non-target layer
        def __init__(self):
            super().__init__()
            self.lm_head = Linear(8, 16, bias=False, device="cpu")
            self.proj = Linear(8, 16, bias=False, device="cpu")
            self.proj.weight = self.lm_head.weight

    tied = Tied()
    assert kquant.quantize_module_weights(tied) == [] and tied.lm_head.weight.is_floating_point()
    assert tied.lm_head.weight_scale is None


# -- kernel 20 --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64, 32), (3, 5, 48, 80)], ids=["2d", "3d-ragged"])
def test_int8_weight_matmul_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(2)
    *lead, k, n = shape
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    w8, scale = jax_quant.quantize_weight_int8(jnp.asarray(rng.normal(size=(k, n)), jnp.float32))
    tx, jx = _pair(x, dtype)
    tw8, ts = torch.from_numpy(np.array(w8)), torch.from_numpy(np.array(scale))
    got = kquant.int8_weight_matmul(tx, tw8, ts)
    assert got.dtype == tx.dtype and got.shape == (*lead, n)
    xla = jax_quant.int8_weight_matmul(jx, w8, scale)
    _close(got, xla, dtype)
    if len(lead) == 1:  # the interpret kernel takes the 2-D geometry its blocks divide
        _close(got, jax_quant.int8_weight_matmul(jx, w8, scale, interpret=True), dtype)
    # the public functional and a quantized layer take the same path
    _close(F.weight_only_linear(tx, tw8, ts), xla, dtype)


@pytest.mark.parametrize("dtype,shape", [("float32", (3, 5, 36, 50)), ("bfloat16", (77, 4100, 32003))],
                         ids=["fp32-ragged-k-n", "bf16-vocab-32003"])
def test_int8_weight_matmul_fp32_and_ragged_match_jax_composition(dtype, shape):
    """The shapes and the dtype the card takes on its mma.sync instance
    (K % 8 and N % 16 non-zero; fp32 activations) against JAX's XLA
    composition, which takes any of them."""
    rng = np.random.default_rng(5)
    *lead, k, n = shape
    m = int(np.prod(lead))
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    w8 = rng.integers(-127, 128, size=(k, n), dtype=np.int8)  # the quantizer's range
    scale = rng.uniform(1e-4, 1e-3, size=n).astype(np.float32)
    tx, jx = _pair(x, dtype)
    assert kquant.wo_route(tx.dtype, m, k, n) == "mma_sync"
    got = kquant.int8_weight_matmul(tx, torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == (*lead, n)
    _close(got, jax_quant.int8_weight_matmul(jx, jnp.asarray(w8), jnp.asarray(scale)), dtype)


# -- kernel 20's wgmma instance: its arithmetic, its fragments, its routes ----------------

WO_BK, WO_BN = 64, 128  # csrc/wo_matmul.cu kBK, kBN: k a ring stage, weight columns a tile


def emulate_wo(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, bk: int, bm_x: int, bn_w: int) -> torch.Tensor:
    """Kernel 20's wgmma instance in PyTorch: output tiles of ``bm_x`` x rows
    by ``bn_w`` weight columns, walked k step by k step (``bk``; the last
    step zero-filled past K, as TMA fills it), the int8 values widened to x's
    type (exact), each step's fp32 partial added to the tile's fp32
    accumulator in order, the scale row multiplied once, one rounding to x's
    type."""
    m, k = x.shape
    n = w8.shape[1]
    xf, wf = x.float(), w8.to(x.dtype).float()
    out = torch.empty((m, n), dtype=x.dtype)
    for m0 in range(0, m, bm_x):
        for n0 in range(0, n, bn_w):
            acc = torch.zeros((min(bm_x, m - m0), min(bn_w, n - n0)))
            for k0 in range(0, k, bk):
                acc += xf[m0:m0 + bm_x, k0:k0 + bk] @ wf[k0:k0 + bk, n0:n0 + bn_w]
            out[m0:m0 + bm_x, n0:n0 + bn_w] = (acc * scale[n0:n0 + bn_w].float()).to(x.dtype)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m", [1, 8, 77, 512])
def test_wo_emulation_matches_jax_interpret_and_plain(m, dtype):
    rng = np.random.default_rng(11)
    k, n = 200, 208  # three full k steps and a ragged one; a full and a ragged 128-column tile
    x = rng.normal(size=(m, k)).astype(np.float32)
    w8, scale = jax_quant.quantize_weight_int8(jnp.asarray(0.02 * rng.normal(size=(k, n)), jnp.float32))
    tx, jx = _pair(x, dtype)
    tw8, ts = torch.from_numpy(np.array(w8)), torch.from_numpy(np.array(scale))
    assert kquant.wo_route(tx.dtype, m, k, n) == "wgmma"
    got = emulate_wo(tx, tw8, ts, WO_BK, kquant.wo_plan(m, n, 132)["bm"], WO_BN)
    _close(got, jax_quant.int8_weight_matmul(jx, w8, scale, interpret=True), dtype)
    _close(got, kquant.int8_weight_matmul_plain(tx, tw8, ts).float().numpy(), dtype)


def _byte_perm(x: np.ndarray, y, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte i of the
    result is byte ``(sel >> 4 i) & 7`` of the eight bytes y:x."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = np.uint64(8 * ((sel >> (4 * i)) & 7))
        out |= ((both >> src) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _halves(r: np.ndarray, dtype: str) -> np.ndarray:
    """The two 16-bit halves of each uint32 (low first) as float32 values."""
    h = r.view(np.uint16).reshape(-1, 2)
    if dtype == "float16":
        return h.view(np.float16).astype(np.float32)
    return (h.astype(np.uint32) << 16).view(np.float32)


def _widen_pairs(t: np.ndarray, dtype: str):
    """``widen_pairs`` (csrc/wo_matmul.cu) in numpy, op for op: the A
    registers of columns c0 and c1 from ``t`` = [c0@k, c1@k, c0@k+1,
    c1@k+1], each as its (k, k+1) values."""
    if dtype == "float16":
        t = t ^ np.uint32(0x80808080)
        bias = np.float32(np.float16(1152.0))
        return [(_halves(_byte_perm(t, 0x64646464, sel), dtype) - bias).astype(np.float16).astype(np.float32)
                for sel in (0x4240, 0x4341)]
    regs = []
    for sel in (0x4240, 0x4341):
        y = _byte_perm(t, 0x43434343, sel)
        diff = _halves(y & np.uint32(0xFF7FFF7F), dtype) - _halves(y & np.uint32(0xFF80FF80), dtype)
        regs.append(diff)  # sub.rn.bf16x2 of two bf16 values whose difference is an integer of at most 128
    return regs


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_widening_bit_tricks_map_every_int8_exactly(dtype):
    v = np.arange(-128, 128)
    b = [(v + 32 * j) % 256 - 128 for j in range(4)]  # every value in every byte
    t = sum(((b[j] & 0xFF).astype(np.uint64) << np.uint64(8 * j)) for j in range(4)).astype(np.uint32)
    r0, r1 = _widen_pairs(t, dtype)
    np.testing.assert_array_equal(r0, np.stack([b[0], b[2]], 1).astype(np.float32))
    np.testing.assert_array_equal(r1, np.stack([b[1], b[3]], 1).astype(np.float32))
    # the widened values are exact in the type: the kernel's registers hold float(v)
    exact = r0.astype(np.float16) if dtype == "float16" else torch.from_numpy(r0).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(np.asarray(exact, np.float32), r0)


def _ldsm_x4_trans(smem: np.ndarray, rows) -> np.ndarray:
    """``ldmatrix.m8n8.x4.trans.b16`` in numpy: ``rows[8 i + r]`` is the byte
    address of row r of matrix i (16 bytes); lane (gid, tig) gets, for
    matrix i, 16-bit column gid of rows 2 tig (low half) and 2 tig + 1."""
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for i in range(4):
            lo = smem[rows[8 * i + 2 * tig] + 2 * gid:][:2].astype(np.uint32)
            hi = smem[rows[8 * i + 2 * tig + 1] + 2 * gid:][:2].astype(np.uint32)
            out[lane, i] = lo[0] | lo[1] << 8 | hi[0] << 16 | hi[1] << 24
    return out


def test_wgmma_a_fragments_hold_the_permuted_weight_columns():
    """The wgmma instance's A fragments, from a W box as TMA leaves it in
    shared memory (128-byte swizzle: 16-byte chunk c of row k at c ^ (k % 8)),
    through ``load_slab``'s ldmatrix addresses and ``widen_step``'s word
    order: register j of k16 step kk holds, in the m16n8k16 A layout,
    fragment row gid (+ 8 for j odd) at k = 16 kk + 2 tig (+ 8 for j >= 2),
    k + 1; fragment row i < 8 of a warp is weight column 2 i of its 16, row
    i + 8 column 2 i + 1 (the epilogue's n_lo, n_lo + 1)."""
    rng = np.random.default_rng(3)
    box = rng.integers(-128, 128, size=(64, 128)).astype(np.int8)  # [64 k][128 weight columns]
    smem = np.zeros(64 * 128, np.uint8)
    for kr in range(64):
        for c in range(8):
            dst = kr * 128 + ((c ^ (kr % 8)) << 4)
            smem[dst:dst + 16] = box[kr, 16 * c:16 * c + 16].view(np.uint8)
    for dtype in ("bfloat16", "float16"):
        for wg in range(2):
            for wl in range(4):
                chunk = 4 * wg + wl
                off = [lane * 128 + ((chunk ^ (lane & 7)) << 4) for lane in range(32)]
                words = [_ldsm_x4_trans(smem, [o + 32 * 128 * p for o in off]) for p in range(2)]
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    cols = (64 * wg + 16 * wl + 2 * gid, 64 * wg + 16 * wl + 2 * gid + 1)
                    for kk in range(4):
                        w = words[kk >> 1][lane]
                        a = [*_widen_pairs(w[2 * (kk & 1)][None], dtype), *_widen_pairs(w[2 * (kk & 1) + 1][None], dtype)]
                        for j in range(4):
                            k0 = 16 * kk + 2 * tig + 8 * (j >> 1)
                            want = box[k0:k0 + 2, cols[j & 1]].astype(np.float32)
                            np.testing.assert_array_equal(a[j][0], want)


MAIN_PATH_WO = {  # Llama-2-7B's weight-only projections, [K, N]
    "gate_up": (4096, 11008), "down": (11008, 4096), "lm_head": (4096, 32000),
}


@pytest.mark.parametrize("m", [1, 8, 512, 4096], ids=["decode-1", "decode-8", "serve-step", "eval-rows"])
@pytest.mark.parametrize("proj", sorted(MAIN_PATH_WO))
def test_wo_main_path_shapes_take_wgmma_in_bf16_and_fp16(proj, m):
    k, n = MAIN_PATH_WO[proj]
    assert kquant.wo_route(torch.bfloat16, m, k, n) == "wgmma"
    assert kquant.wo_route(torch.float16, m, k, n) == "wgmma"
    assert kquant.wo_route(torch.float32, m, k, n) == "mma_sync"


@pytest.mark.parametrize("dtype,k,n,route", [
    (torch.bfloat16, 4104, 4096, "wgmma"),        # K % 8 == 0 is enough for x's rows
    (torch.bfloat16, 4100, 4096, "mma_sync"),   # K % 8 != 0
    (torch.float16, 4096, 32008, "mma_sync"),   # N % 16 != 0
    (torch.bfloat16, 4100, 32003, "mma_sync"),  # both: a Llama vocab of 32003
    (torch.float32, 4096, 4096, "mma_sync"),
    (torch.bfloat16, 0, 16, "mma_sync"),        # an empty contraction
], ids=["k-mult-8", "k-ragged", "n-ragged", "vocab-32003", "fp32", "k-0"])
def test_wo_route_by_dtype_and_alignment(dtype, k, n, route):
    assert kquant.wo_route(dtype, 77, k, n) == route


def _plan_items(plan: dict, m: int):
    """``item_at`` (csrc/wo_matmul.cu) over a plan: (first row, rows, first column) of every item."""
    bm, blocks, nt, big = plan["bm"], plan["blocks"], plan["nt"], plan["big"]
    items, split = [], 2 * (blocks * nt - big)
    for i in range(plan["items"]):
        if i < big:
            items.append(((i % blocks) * bm, bm, (i // blocks) * WO_BN))
        elif i - big < split:
            s = i - big
            q = big + s // 2
            items.append(((q % blocks) * bm + (s & 1) * (bm // 2), bm // 2, (q // blocks) * WO_BN))
        else:
            items.append((blocks * bm, bm // 2, (i - big - split) * WO_BN))
    return items


@pytest.mark.parametrize("m,n", [(512, 11008), (512, 4096), (512, 32000), (8, 11008), (4096, 11008), (77, 208),
                                 (300, 400), (777, 1040)])
def test_wo_plan_covers_every_output_tile_once(m, n):
    plan = kquant.wo_plan(m, n, 132)
    covered = np.zeros((-(-m // 8) * 8 + 256, n + WO_BN), np.int32)
    for r0, rows, c0 in _plan_items(plan, m):
        assert r0 < m and c0 < n
        covered[r0:r0 + rows, c0:c0 + WO_BN] += 1
    assert (covered[:m, :n] == 1).all()
    assert plan["grid"] == min(plan["items"], 132)


def test_wo_plan_at_the_serving_shapes():
    """gate/up: one round of 256-row tiles, then the rest as 128-row tiles
    (13 units of work for the longest CTA against 16 whole); down: every
    tile 128 rows, one a CTA on 128 SMs; the lm head: 500 256-row tiles."""
    assert kquant.wo_plan(512, 11008, 132) == dict(bm=256, blocks=2, nt=86, big=132, items=212, grid=132)
    assert kquant.wo_plan(512, 4096, 132) == dict(bm=128, blocks=4, nt=32, big=128, items=128, grid=128)
    assert kquant.wo_plan(512, 32000, 132) == dict(bm=256, blocks=2, nt=250, big=500, items=500, grid=132)
    assert kquant.wo_plan(8, 11008, 132)["bm"] == 8 and kquant.wo_plan(64, 11008, 132)["bm"] == 64


# -- the cache writes with scale planes ----------------------------------------------------

def _int8_pools(rng, nb=16, h=2, bs=4, d=16):
    kq = rng.integers(-127, 128, size=(nb, h, bs, d)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(nb, h, bs, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, size=(nb, h, bs)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, size=(nb, h, bs)).astype(np.float32)
    return kq, vq, ks, vs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "slot-mask"])
def test_cache_writes_with_planes_bit_identical_to_jax(masked):
    rng = np.random.default_rng(4)
    pools = _int8_pools(rng)
    b, c, h, d = 3, 5, 2, 16
    k = rng.normal(size=(b, c, h, d)).astype(np.float32)
    v = rng.normal(size=(b, c, h, d)).astype(np.float32)
    k[0, 1, 1] = 0.0  # an all-zero row
    # masked: slot 2's table aliases slot 0's blocks, and its rows must be dropped
    tables = np.array([[3, 7, 0, 0], [9, 1, 12, 0], [3, 7, 0, 0] if masked else [10, 11, 0, 0]], np.int32)
    lens = np.array([2, 5, 2], np.int32)
    q_lens = np.array([5, 2, 3], np.int32)
    mask = np.array([True, True, not masked])
    kw = dict(slot_mask=mask) if masked else {}

    want = jax_ba.block_cache_append_chunk(*map(jnp.asarray, (*pools[:2], k, v, tables, lens, q_lens)),
                                           key_scale=jnp.asarray(pools[2]), value_scale=jnp.asarray(pools[3]),
                                           **{n: jnp.asarray(a) for n, a in kw.items()})
    t = [_t(a) for a in pools]
    got = incubate.block_cache_append_chunk(t[0], t[1], _t(k), _t(v), _t(tables), _t(lens), _t(q_lens),
                                            key_scale=t[2], value_scale=t[3], **{n: _t(a) for n, a in kw.items()})
    assert len(got) == 4 and all(g is p for g, p in zip(got, t))
    for g, w in zip(got, want):
        _bits(g, w)

    pos = np.array([6, 1, 3], np.int32)  # decode append: one row per slot
    want = jax_ba.block_cache_append(*map(jnp.asarray, (*pools[:2], k[:, 0], v[:, 0], tables, pos)),
                                     key_scale=jnp.asarray(pools[2]), value_scale=jnp.asarray(pools[3]),
                                     **{n: jnp.asarray(a) for n, a in kw.items()})
    t = [_t(a) for a in pools]
    got = incubate.block_cache_append(t[0], t[1], _t(k[:, 0]), _t(v[:, 0]), _t(tables), _t(pos),
                                      key_scale=t[2], value_scale=t[3], **{n: _t(a) for n, a in kw.items()})
    for g, w in zip(got, want):
        _bits(g, w)

    plens = np.array([5, 3, 0], np.int32)  # prefill: lengths shorter than S, one 0
    want = jax_ba.block_cache_prefill(*map(jnp.asarray, (*pools[:2], k, v, tables, plens)),
                                      key_scale=jnp.asarray(pools[2]), value_scale=jnp.asarray(pools[3]))
    t = [_t(a) for a in pools]
    got = incubate.block_cache_prefill(t[0], t[1], _t(k), _t(v), _t(tables), _t(plens),
                                       key_scale=t[2], value_scale=t[3])
    for g, w in zip(got, want):
        _bits(g, w)

    src, dst = np.array([3, 9, 1], np.int32), np.array([5, 16, 14], np.int32)  # 16 == NB: no fork
    want = jax_ba.block_cache_cow_copy(*map(jnp.asarray, (*pools[:2], src, dst)),
                                       key_scale=jnp.asarray(pools[2]), value_scale=jnp.asarray(pools[3]))
    t = [_t(a) for a in pools]
    got = incubate.block_cache_cow_copy(t[0], t[1], _t(src), _t(dst), key_scale=t[2], value_scale=t[3])
    for g, w in zip(got, want):
        _bits(g, w)


# -- kernels A, 4, 5, 6 over int8 pools ------------------------------------------------------

def _tables(rng, lens_after, b, bs, mbs, nb):
    """Distinct blocks for each slot's used positions; every entry past them
    is out-of-range garbage that must never be dereferenced."""
    tables = rng.permutation(nb)[: b * mbs].reshape(b, mbs).astype(np.int32)
    for i in range(b):
        tables[i, -(-int(lens_after[i]) // bs):] = nb + 1000 + i
    return tables


def _quant_cache(rng, d, hkv, nb=16, bs=8):
    """An int8 pool from normal rows through the JAX quantizer: payload and
    per-token scales."""
    k8, ks = jax_ba._quantize_kv_rows(jnp.asarray(rng.normal(size=(nb, hkv, bs, d)), jnp.float32))
    v8, vs = jax_ba._quantize_kv_rows(jnp.asarray(rng.normal(size=(nb, hkv, bs, d)), jnp.float32))
    return [np.asarray(a) for a in (k8, v8, ks, vs)]


# head dims 192 and 256 too: the JAX package's D % 64 gate sends them to every paged kernel, and so
# does the port (kernels 5 and 6's 16-lane row groups)
PAGED_CASES = [(g, "float32") for g in GEOMETRIES] + [(GEOMETRIES[1], "bfloat16"), (GEOMETRIES[3], "bfloat16"),
                                                      ((192, 4, 4), "bfloat16"), ((256, 8, 2), "bfloat16")]
PAGED_IDS = [f"{i}-fp32" for i in GEOMETRY_IDS] + [f"{GEOMETRY_IDS[1]}-bf16", f"{GEOMETRY_IDS[3]}-bf16",
                                                   "d192-mha-bf16", "d256-gqa-bf16"]


@pytest.mark.parametrize("geometry,dtype", PAGED_CASES, ids=PAGED_IDS)
@pytest.mark.parametrize("kernel", ["chunk_fused", "chunk", "decode", "decode_fused"])
def test_int8_paged_plain_matches_pallas_interpret(kernel, geometry, dtype):
    d, hq, hkv = geometry
    rng = np.random.default_rng(5)
    k8, v8, ks, vs = _quant_cache(rng, d, hkv)
    planes = [_pair(a, dtype) for a in (k8, v8)]
    scales = [(torch.from_numpy(np.array(a)), jnp.asarray(a)) for a in (ks, vs)]
    if kernel.startswith("chunk"):
        c = 4
        q = rng.normal(size=(4, c, hq, d)).astype(np.float32)
        lens = np.array([13, 4, 0, 16], np.int32)  # EXCLUDE the chunk; slot 1 ends on a block edge
        q_lens = np.array([1, 4, 0, 3], np.int32)
        tables = _tables(rng, lens + q_lens, 4, 8, 4, 16)
        rope = [np.cos(rng.normal(size=(4, c, d))).astype(np.float32),
                np.sin(rng.normal(size=(4, c, d))).astype(np.float32)]
        tail = [tables, lens, q_lens]
    else:
        q = rng.normal(size=(4, hq, d)).astype(np.float32)
        lens = np.array([13, 0, 16, 24], np.int32)  # INCLUDE the current token; 0 is idle
        tables = _tables(rng, lens, 4, 8, 4, 16)
        rope = [np.cos(rng.normal(size=(4, 1, d))).astype(np.float32),
                np.sin(rng.normal(size=(4, 1, d))).astype(np.float32)]
        tail = [tables, lens]
    head = [_pair(q, dtype)] + ([_pair(a, dtype) for a in rope] if kernel.endswith("fused") else [])
    args = head + planes + [_pair(a, dtype) for a in tail]
    jfn, tfn = getattr(jax_paged, f"paged_flash_{kernel}"), getattr(kpaged, f"paged_flash_{kernel}")
    want = jfn(*(j for _, j in args), interpret=True, k_scale=scales[0][1], v_scale=scales[1][1])
    got = tfn(*(t for t, _ in args), k_scale=scales[0][0], v_scale=scales[1][0])
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, fp32_tol=2e-5 if kernel == "decode_fused" else 1e-5)
    if kernel.startswith("chunk"):
        assert not got[2].any() and not got[0, 1:].any() and not got[3, 3:].any()  # rows past q_lens
    else:
        assert not got[1].any()  # a slot of length 0


@pytest.mark.parametrize("fused", [False, True], ids=["decode", "decode-fused"])
def test_int8_decode_entries_match_jax(fused):
    """The public decode entries with scale planes (kernels 5 and 6's
    callers): the quantizing append (k quantized after the rope in the
    fused entry), the dequantizing attention and all four planes."""
    rng = np.random.default_rng(6)
    d, hq, hkv = 64, 8, 2
    pools = _quant_cache(rng, d, hkv)
    q = rng.normal(size=(4, 1, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(4, 1, hkv, d)).astype(np.float32) for _ in range(2))
    cos = np.cos(rng.normal(size=(4, 1, 1, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(4, 1, 1, d))).astype(np.float32)
    cached = np.array([12, 0, 15, 23], np.int32)
    tables = _tables(rng, cached + 1, 4, 8, 4, 16)
    mask = np.array([True, False, True, True])
    rope = (cos, sin) if fused else ()
    name = "block_multihead_attention_fused" if fused else "block_multihead_attention"
    jout = getattr(jax_ba, name)(*map(jnp.asarray, (q, k, v, *rope, pools[0], pools[1], tables, cached)),
                                 slot_mask=jnp.asarray(mask), key_scale=jnp.asarray(pools[2]),
                                 value_scale=jnp.asarray(pools[3]))
    t = [_t(a) for a in pools]
    tout = getattr(incubate, name)(*map(_t, (q, k, v, *rope)), t[0], t[1], _t(tables), _t(cached),
                                   slot_mask=_t(mask), key_scale=t[2], value_scale=t[3])
    _close(tout[0], jout[0], "float32", fp32_tol=2e-5)
    assert not tout[0][1].any()
    for g, w in zip(tout[1:], jout[1:]):
        _bits(g, w)


# -- kernel 17's int8 site ---------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["h-major", "vocab-major"])
@pytest.mark.parametrize("h", [128, 96], ids=["kernel-gate", "plain-gate"])
def test_int8_loss_matches_jax_reference_and_interpret_kernel(h, vocab_major, reduction):
    rng = np.random.default_rng(7)
    n, v = 40, 300
    x = rng.normal(size=(n, h)).astype(np.float32)
    w = rng.normal(size=(v, h) if vocab_major else (h, v)) * 0.05
    w8, scale = jax_quant.quantize_weight_int8(jnp.asarray(w.T if vocab_major else w, jnp.float32))
    w8 = jnp.asarray(np.asarray(w8).T) if vocab_major else w8  # [V, H] for the vocab-major layout
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    lab[[3, 11, 30]] = -100
    kw = dict(ignore_index=-100, reduction=reduction, vocab_major=vocab_major)
    ref = jax_loss._reference_quant_path(jnp.asarray(x), w8, scale, jnp.asarray(lab), v=v, h=h, **kw)
    interp = jax_loss._pallas_quant_path(jnp.asarray(x), w8, scale, jnp.asarray(lab), v=v, h=h, interpret=True,
                                         block=(16, 128), **kw)
    with _flags(use_fused_loss=True):
        got = F.fused_linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(np.asarray(w8)),
                                           torch.from_numpy(lab), ignore_index=-100, reduction=reduction,
                                           weight_vocab_major=vocab_major,
                                           weight_scale=torch.from_numpy(np.asarray(scale)))
    assert got.dtype == torch.float32 and got.shape == ((n,) if reduction == "none" else ())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), rtol=1e-5, atol=1e-5)


LOG2E = 1.4426950408889634


def _merge_partials(part):
    """``ptt_flxent_merge``: per row, the vocab tiles' partials in tile
    order: ``lse = m + log(sum_t l_t exp(m_t - m))``, ``tl = sum_t tl_t``."""
    m = part[0].amax(dim=0)
    l, tl = torch.zeros_like(m), torch.zeros_like(m)
    for t in range(part.shape[1]):
        l = l + part[1, t] * torch.exp(part[0, t] - m)
        tl = tl + part[2, t]
    return m + torch.log(l), tl


def emulate_flx_int8_fwd(x, w8, scale, labels, sms=132, bk=WO_BK):
    """Kernel 17's int8 site on its wgmma route in PyTorch: kernel 20's
    tiles (``wo_plan``: 128 vocab columns by 8, 64, 128 or 256 tokens), each
    the transposed product ``W^T x^T`` of the int8 values widened exactly,
    summed k step by k step (zero past K and past V, as TMA fills them);
    then the transposed epilogue: each value times its column's scale, then
    NEG_INF past V; per token the max over the 128 columns (a warp's 16 —
    two a thread, then a tree across its 8 lane groups — then the 8 warps);
    the sums of 2^(v log2 e - m log2 e) the same way, the warps added in
    order; the target logit from its column; one partial column a tile;
    then the merge in tile order."""
    n, h = x.shape
    v = w8.shape[1]
    xf, wf = x.float(), w8.to(x.dtype).float()
    part = torch.full((3, -(-v // WO_BN), n), float("nan"))
    for r0, rows, c0 in _plan_items(kquant.wo_plan(n, v, sms), n):
        rows = min(rows, n - r0)
        real = min(WO_BN, v - c0)
        wb = torch.zeros((h, WO_BN))
        wb[:, :real] = wf[:, c0:c0 + real]
        acc = torch.zeros((WO_BN, rows))  # [vocab column, token]
        for k0 in range(0, h, bk):
            acc += wb[k0:k0 + bk].t() @ xf[r0:r0 + rows, k0:k0 + bk].t()
        sc = torch.zeros(WO_BN)
        sc[:real] = scale[c0:c0 + real]
        cols = torch.arange(c0, c0 + WO_BN)
        acc = torch.where(cols[:, None] < v, acc * sc[:, None], kloss.NEG_INF)
        a = acc.reshape(8, 8, 2, rows)  # [warp, lane group gid, the thread's two columns, token]
        m = a.amax(dim=(1, 2)).amax(dim=0)  # [token]
        e = torch.exp2(a * LOG2E - (m * LOG2E)[None, None, None, :])
        lanes = e[:, :, 0] + e[:, :, 1]  # [warp, gid, token]
        while lanes.shape[1] > 1:  # shfl_xor 4, 8, 16: gid bits 0, 1, 2
            lanes = lanes[:, 0::2] + lanes[:, 1::2]
        l = torch.zeros(rows)
        for w in range(8):
            l = l + lanes[w, 0]
        lab = labels[r0:r0 + rows].long()
        hit = (cols[:, None] == lab[None, :]) & (cols[:, None] < v)
        t = c0 // WO_BN
        part[0, t, r0:r0 + rows] = m
        part[1, t, r0:r0 + rows] = l
        part[2, t, r0:r0 + rows] = torch.where(hit, acc, 0.0).sum(dim=0)
    assert not part.isnan().any()  # every partial column written once
    return _merge_partials(part)


def _int8_head(rng, n, h, v, vocab_major=False):
    """x [n, h] fp32, the JAX quantizer's int8 head (W [h, v] or [v, h]) and
    scales, and labels: ignored rows, past V, on tile edges and V - 1."""
    x = rng.normal(size=(n, h)).astype(np.float32)
    w8, scale = jax_quant.quantize_weight_int8(jnp.asarray(rng.normal(size=(h, v)) * 0.05, jnp.float32))
    w8 = np.asarray(w8).T.copy() if vocab_major else np.asarray(w8)
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    lab[::7] = -100
    special = [v + 3, 1 << 20, 127, 128, v - 1]
    lab[1:1 + len(special)] = special[:n - 1]
    return x, w8, np.asarray(scale), lab


@pytest.mark.parametrize("n", [300, 40, 5], ids=["256-and-128-row-tiles", "64-row-tiles", "8-row-tiles"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_int8_site_wgmma_emulation_matches_plain_and_pallas(dtype, n):
    """The int8 site's wgmma route (the int8 Llama head's ``W [H, V]``): H
    200 (a partial k box), V 400 (the last 128-column tile holds 16 real
    columns); 300 rows take a 256-row tile and an odd 128-row block's, 40 the
    64-row tiles, 5 the 8-row ones. Gate: lse and tl within 1e-5 of max(1,
    |v|) of the plain version (the same fp32 logits, scaled, summed and
    exponentiated (2^x) in another order), and the per-row loss against the
    Pallas ``_pallas_quant_path`` in interpret mode at 1e-5 (rows whose
    label falls in the Pallas path's padding of V to 512 aside: a padded
    NEG_INF column matches them there)."""
    h, v = 200, 400
    rng = np.random.default_rng(17)
    x, w8, scale, lab = _int8_head(rng, n, h, v)
    tx, jx = _pair(x, dtype)
    tw8, ts, tl = (torch.from_numpy(a.copy()) for a in (w8, scale, lab))
    assert kloss.flx_int8_route_of(tx, tw8, False) == "wgmma"
    lse, tlg = emulate_flx_int8_fwd(tx, tw8, ts, tl)
    lse_p, tl_p = kloss.flxent_fwd_int8_plain(tx, tw8, ts, tl)
    for got, want in ((lse, lse_p), (tlg, tl_p)):
        assert ((got - want).abs() <= 1e-5 * want.abs().clamp(min=1.0)).all(), float((got - want).abs().max())
    assert not tlg[tl == -100].any() and not tlg[tl >= v].any()
    loss = torch.where(tl != -100, lse - tlg, 0.0).numpy()
    want = np.asarray(jax_loss._pallas_quant_path(jx, jnp.asarray(w8), jnp.asarray(scale), jnp.asarray(lab), v=v,
                                                  h=h, ignore_index=-100, reduction="none", vocab_major=False,
                                                  interpret=True, block=(16, 128)))
    keep = ~((lab >= v) & (lab < 512))
    np.testing.assert_allclose(loss[keep], want[keep], rtol=1e-5, atol=1e-5)


def emulate_flx_int8_fwd_f32(x, w8, scale, labels, vocab_major):
    """The int8 site's CUDA-core instance in PyTorch (fp32 x): 128 x 128
    tiles of the fp32 product of x and the int8 values, each k tile of 16
    summed apart and then added; per row and tile the partials of the
    logits times their columns' scales, NEG_INF past V; then the merge."""
    n, h = x.shape
    wt = (w8.t() if vocab_major else w8).float()  # [H, V]
    v = wt.shape[1]
    part = torch.empty((3, -(-v // 128), n))
    for c0 in range(0, v, 128):
        cols = torch.arange(c0, c0 + 128)
        wb = torch.zeros((h, 128))
        wb[:, :min(128, v - c0)] = wt[:, c0:c0 + 128]
        acc = torch.zeros((n, 128))
        for k0 in range(0, h, 16):
            acc += x[:, k0:k0 + 16] @ wb[k0:k0 + 16]
        sc = torch.ones(128)
        sc[:min(128, v - c0)] = scale[c0:c0 + 128]
        logit = torch.where(cols[None, :] < v, acc * sc[None, :], kloss.NEG_INF)
        mx = logit.amax(dim=1)
        hit = (cols[None, :] == labels.long()[:, None]) & (cols[None, :] < v)
        part[:, c0 // 128] = torch.stack([mx, torch.exp(logit - mx[:, None]).sum(dim=1),
                                          torch.where(hit, logit, 0.0).sum(dim=1)])
    return _merge_partials(part)


@pytest.mark.parametrize("vocab_major", [False, True], ids=["h-major", "vocab-major"])
def test_int8_site_in_fp32_takes_the_cuda_cores_and_matches_jax(vocab_major):
    """fp32 activations at the int8 site (JAX's ``_pallas_quant_path`` takes
    any dtype and upcasts x in its body): ``flx_int8_route`` sends them to
    the CUDA-core instance where the int8 W is not 16-byte aligned (the
    TF32 instance elsewhere: ``tests/test_torch_flxent_fwd_tf32.py``); its
    emulation (:func:`emulate_flx_int8_fwd_f32`)
    and the plain version against JAX's public ``fused_linear_cross_entropy``
    with ``weight_scale`` in interpret mode, per row, at 1e-5 (the same fp32
    sums in other orders); labels in the Pallas padding of V aside."""
    n, h, v = 70, 128, 300
    rng = np.random.default_rng(19)
    x, w8, scale, lab = _int8_head(rng, n, h, v, vocab_major)
    tx, ts, tl = (torch.from_numpy(a.copy()) for a in (x, scale, lab))
    # W 8 bytes off 16-byte alignment: the widen pass of "tf32x2" cannot take it
    tw8 = torch.zeros(8 + w8.size, dtype=torch.int8)[8:].view(w8.shape)
    tw8.copy_(torch.from_numpy(w8))
    assert kloss.flx_int8_route_of(tx, tw8, vocab_major) == "cuda_cores"
    want = np.asarray(jax_loss.fused_linear_cross_entropy(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(lab), ignore_index=-100, reduction="none",
        vocab_major=vocab_major, weight_scale=jnp.asarray(scale), interpret=True, block=(16, 128)))
    keep = ~((lab >= v) & (lab < 384))
    for lse, tlg in (emulate_flx_int8_fwd_f32(tx, tw8, ts, tl, vocab_major),
                     kloss.flxent_fwd_int8_plain(tx, tw8, ts, tl, vocab_major)):
        loss = torch.where(tl != -100, lse - tlg, 0.0).numpy()
        np.testing.assert_allclose(loss[keep], want[keep], rtol=1e-5, atol=1e-5)
        assert not tlg[tl >= v].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_int8_site_main_path_takes_wgmma(dtype):
    """The int8 Llama head (``W [4096, 32000]``, lm_head's ``[in, out]``
    layout) takes kernel 20's wgmma mainloop in bf16 and fp16; fp32 takes the
    TF32 instance in two passes."""
    assert kloss.flx_int8_route(dtype, 4096, 32000, False) == "wgmma"
    assert kloss.flx_int8_route(torch.float32, 4096, 32000, False) == "tf32x2"


@pytest.mark.parametrize("dtype,h,v,vocab_major,route", [
    (torch.bfloat16, 1024, 32003, False, "mma_sync"),   # V % 16 != 0: W's rows of V bytes TMA cannot address
    (torch.float16, 1024, 5000, False, "mma_sync"),     # 5000 % 16 == 8
    (torch.bfloat16, 1024, 5008, False, "wgmma"),
    (torch.bfloat16, 1020, 5008, False, "mma_sync"),    # H % 8 != 0
    (torch.bfloat16, 1024, 5008, True, "mma_sync"),     # vocab-major: not kernel 20's layout
    (torch.float32, 1024, 5008, True, "tf32x2"),        # the widen pass reads rows of 1024 bytes
    (torch.bfloat16, 0, 5008, False, "mma_sync"),       # an empty contraction
    (torch.float32, 1032, 5008, True, "cuda_cores"),    # vocab-major rows of 1032 bytes
    (torch.float32, 1024, 5000, False, "cuda_cores"),   # [H, V] rows of 5000 bytes
    (torch.float32, 0, 5008, False, "cuda_cores"),
    (torch.float32, 4096, 32000, True, "tf32x2"),       # the Llama head vocab-major
    (torch.float32, 1024, 5008, False, "tf32x2"),
    (torch.float32, 1024, 32003, False, "cuda_cores"),  # [H, V] rows of 32003 bytes
    (torch.float32, 1024, 5001, True, "tf32x2"),        # vocab-major: V does not matter
    (torch.float32, 1022, 5008, False, "cuda_cores"),   # the widened plane's rows of 1022 floats: H % 4 != 0
], ids=["v-32003", "v-5000", "v-5008", "h-ragged", "vocab-major", "fp32", "h-0", "fp32-vm-h1032", "fp32-v5000",
        "fp32-h-0", "fp32-vm-llama", "fp32-v5008", "fp32-v32003", "fp32-vm-v5001", "fp32-h1022"])
def test_flx_int8_route_by_dtype_layout_and_alignment(dtype, h, v, vocab_major, route):
    assert kloss.flx_int8_route(dtype, h, v, vocab_major) == route


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (1, "mma_sync"), (8, "mma_sync"), (16, "wgmma")])
def test_flx_int8_route_of_sends_a_misaligned_weight_to_mma_sync(offset, route):
    """The int8 W ``offset`` bytes into its storage: TMA needs a 16-byte
    aligned base, and so does the fp32 instance's widen pass: fp32
    activations take "tf32x2" where bf16 takes "wgmma", in either layout
    (a vocab-major W takes "mma_sync" in bf16 at any offset)."""
    h, v = 64, 256
    buf = torch.zeros(offset + h * v, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    w8 = buf[offset:].view(h, v)
    assert kloss.flx_int8_route_of(torch.zeros((4, h), dtype=torch.bfloat16), w8, False) == route
    fp32 = "tf32x2" if route == "wgmma" else "cuda_cores"
    assert kloss.flx_int8_route_of(torch.zeros((4, h)), w8, False) == fp32
    wv = buf[offset:].view(v, h)  # vocab-major
    assert kloss.flx_int8_route_of(torch.zeros((4, h), dtype=torch.bfloat16), wv, True) == "mma_sync"
    assert kloss.flx_int8_route_of(torch.zeros((4, h)), wv, True) == fp32


@pytest.mark.parametrize("dtype", [torch.int8, torch.float64])
def test_flx_int8_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        kloss.flx_int8_route(dtype, 4096, 32000, False)


# -- end to end on a tiny Llama ----------------------------------------------------------------

@pytest.fixture(scope="module")
def quantized_pair():
    """A seeded tiny JAX Llama and its port twin, both quantized by their
    own engines' ``weight_only_int8`` (in place, as in JAX)."""
    jmodel, jcfg = _jax_tiny(21)
    model = from_paddle_tpu_state(_state(jmodel), _port_config(jcfg), device="cpu")
    return jmodel, model, jcfg


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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_int8_engine_streams_identical_to_jax_engine(quantized_pair, fused):
    jmodel, model, jcfg = quantized_pair
    rng = np.random.default_rng(8)
    schedule = {
        0: [(rng.integers(0, jcfg.vocab_size, 19), 7), (rng.integers(0, jcfg.vocab_size, 3), 9)],
        2: [(rng.integers(0, jcfg.vocab_size, 11), 5)],
        3: [(rng.integers(0, jcfg.vocab_size, 24), 6), (rng.integers(0, jcfg.vocab_size, 1), 4)],
    }
    with _flags(use_fused_decode_layer=fused):
        with _jax_engine_globals_preserved():
            jeng = JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW, **INT8_KW)
            want = _drive(jeng, schedule)
        eng = ContinuousBatchingEngine(model, **ENGINE_KW, **INT8_KW)
        got = _drive(eng, schedule)
    assert [len(g) for g in got] == [7, 9, 5, 6, 4]
    assert got == want
    assert eng.pool_stats()["bytes_per_token"] == jeng.pool_stats()["bytes_per_token"] == 160
    assert eng.pool_stats()["free"] == eng.num_blocks
    assert model.lm_head.weight.dtype == torch.int8 and len(eng._caches[0]) == 4


def test_int8_step_logits_and_planes_match_jax_model(quantized_pair):
    """Two steps of the engine's call with 8-tuple pasts (fused loop) on
    identical int8 weights: logits at 1e-4; the planes the steps leave
    behind agree (the payload to one int8 step where a k of the two
    packages sits on a rounding edge, the scales at 1e-6)."""
    jmodel, model, jcfg = quantized_pair
    kquant.quantize_module_weights(model)
    jax_quant.quantize_module_weights(jmodel)
    toks1 = np.array([[5, 17, 3, 99, 0, 0], [8, 1, 2, 3, 4, 250], [0] * 6], np.int32)
    toks2 = np.array([[42, 0, 0, 0, 0, 0], [7, 7, 9, 0, 0, 0], [0] * 6], np.int32)
    q1, q2 = np.array([4, 6, 0], np.int32), np.array([1, 3, 0], np.int32)
    tables = np.array([[2, 0, 0, 0], [5, 1, 3, 0], [0, 0, 0, 0]], np.int32)
    active = np.array([True, True, False])
    kvh, hd = jcfg.num_key_value_heads, jcfg.hidden_size // jcfg.num_attention_heads
    shape = (8, kvh, 4, hd)
    jcaches = [(jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8), jnp.ones(shape[:3], jnp.float32),
                jnp.ones(shape[:3], jnp.float32))] * jcfg.num_hidden_layers
    caches = [(torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
               torch.ones(shape[:3]), torch.ones(shape[:3])) for _ in range(jcfg.num_hidden_layers)]
    for toks, lens, q_lens in ((toks1, np.zeros(3, np.int32), q1), (toks2, q1, q2)):
        pkv = [tuple(Tensor(a) for a in (kc, vc, tables, lens, active, q_lens, ks, vs))
               for kc, vc, ks, vs in jcaches]
        with paddle.no_grad():
            jlogits, jpast = jmodel(Tensor(toks), past_key_values=pkv, use_cache=True, cache_position=Tensor(lens))
        jcaches = [(p[0]._data, p[1]._data, p[6]._data, p[7]._data) for p in jpast]
        t = [torch.from_numpy(a) for a in (tables, lens, active, q_lens)]
        with torch.inference_mode():
            logits, _ = model(torch.from_numpy(toks), past_key_values=[(kc, vc, *t, ks, vs) for kc, vc, ks, vs in caches],
                              use_cache=True, cache_position=t[1])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    for got, want in zip(caches, jcaches):
        for g, w in zip(got[:2], want[:2]):
            assert np.abs(g.numpy().astype(np.int32) - np.asarray(w, np.int32)).max() <= 1
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_from_paddle_tpu_state_carries_a_jax_quantized_model():
    jmodel, jcfg = _jax_tiny(22)
    port_quant = from_paddle_tpu_state(_state(jmodel), _port_config(jcfg), device="cpu")
    kquant.quantize_module_weights(port_quant)
    params = dict(jmodel.named_parameters())
    quantized = {id(p) for p in jax_quant.quantize_module_weights(jmodel)}
    scales = {n: np.asarray(p._quant_scale) for n, p in params.items() if id(p) in quantized}
    carried = from_paddle_tpu_state(_state(jmodel), _port_config(jcfg), device="cpu", quant_scales=scales)
    assert carried.lm_head.weight.dtype == torch.int8
    ids = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    with torch.inference_mode():
        got = carried(torch.from_numpy(ids))
        want = port_quant(torch.from_numpy(ids))
    assert torch.equal(got, want)
    with paddle.no_grad():
        jlogits = jmodel(Tensor(jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits._data), rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="quant_scales"):  # int8 arrays without their scales
        from_paddle_tpu_state(_state(jmodel), _port_config(jcfg), device="cpu")
    with pytest.raises(KeyError, match="quant_scales"):
        from_paddle_tpu_state(_state(jmodel), _port_config(jcfg), device="cpu",
                              quant_scales={k: v for k, v in scales.items() if "lm_head" not in k})


def test_weight_only_bf16_engine_keeps_bf16_pools_and_jax_bytes_per_token():
    """A weight-only int8 model's dtype is its embedding's: the engine's bf16
    pool stays bf16 (sized from ``model.dtype``, which an int8 lm head must
    not decide), with JAX's ``bytes_per_token``."""
    jmodel, jcfg = _jax_tiny(23)
    bf16 = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in _state(jmodel).items()}
    model = from_paddle_tpu_state(bf16, _port_config(jcfg), device="cpu")
    eng = ContinuousBatchingEngine(model, **ENGINE_KW, kv_cache_dtype="bf16", weight_only_int8=True)
    assert model.lm_head.weight.dtype == torch.int8 and model.dtype == torch.bfloat16
    assert [t.dtype for t in eng._caches[0]] == [torch.bfloat16, torch.bfloat16]
    jmodel.bfloat16()
    with _jax_engine_globals_preserved():
        jeng = JaxEngine(jmodel, **ENGINE_KW, **JAX_ONLY_KW, kv_cache_dtype="bf16", weight_only_int8=True)
    assert eng.pool_stats()["bytes_per_token"] == jeng.pool_stats()["bytes_per_token"] == 2 * 2 * 2 * 16 * 2
    eng.add_request(np.arange(9), max_new_tokens=3)
    assert [len(r.generated) for r in eng.run().values()] == [3]


# -- the dispatch at a width within the kernels' reach -------------------------------------------

SPIED = {kpaged: ("paged_flash_chunk_fused_plain", "paged_flash_chunk_plain"),
         kquant: ("int8_weight_matmul_plain",), kloss: ("flxent_fwd_int8_plain",)}


@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of the plain versions the wrappers run on the CPU, with whether
    each got an int8 operand — on the card each would be one launch of its
    kernel's int8 instance."""
    calls = []
    for mod, names in SPIED.items():
        for name in names:
            real = getattr(mod, name)

            def spy(*args, _name=name, _real=real, **kwargs):
                calls.append((_name, any(torch.is_tensor(a) and a.dtype == torch.int8 for a in args)))
                return _real(*args, **kwargs)

            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_int8_step_dispatch_at_kernel_width(plain_calls, fused):
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=128, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cpu", seed=1)
    with _flags(use_fused_decode_layer=fused):
        eng = ContinuousBatchingEngine(model, max_slots=2, block_size=16, prompt_bucket=32, max_model_len=64,
                                       prefill_chunk=16, **INT8_KW)
        eng.add_request(np.arange(20), max_new_tokens=2)
        eng.step()
        del plain_calls[:]
        eng.step()  # one step: the prompt's second chunk
    attention = "paged_flash_chunk_fused_plain" if fused else "paged_flash_chunk_plain"
    layers = cfg.num_hidden_layers
    assert sorted(plain_calls) == sorted([(attention, True)] * layers + [("int8_weight_matmul_plain", True)]
                                         * (3 * layers + 1))
    del plain_calls[:]
    ids = torch.from_numpy(np.arange(32).reshape(2, 16))
    with _flags(use_fused_loss=True), torch.no_grad():
        loss, none = model(ids, labels=ids)
    assert none is None and torch.isfinite(loss)
    assert [c for c, _ in plain_calls].count("flxent_fwd_int8_plain") == 1
    assert [c for c, _ in plain_calls].count("int8_weight_matmul_plain") == 3 * layers
