"""Kernels 17-19 of the PyTorch port (the fused linear cross entropy:
forward, dX, dW) and the train step that runs them, against the JAX package.

- The plain versions (what the kernel wrappers run for CPU tensors), through
  the port's autograd ``Function``, against ``paddle_tpu``'s
  ``fused_linear_cross_entropy`` run two ways: its ``lax.scan`` reference
  and its Pallas kernels in interpret mode (``block=(16, 128)``), loss by
  value and ``dX``, ``dW`` by ``jax.vjp`` against torch autograd. Both
  weight layouts, the three reductions, a ragged vocab (200, not a multiple
  of 128), ignored rows, a label past V, and all rows ignored.
- Tolerances. fp32: every side forms the same fp32 logits and sums, in
  other orders; each output is a sum of at most max(H, V) = 200 terms, so
  a relative error of 1e-5 (~80 fp32 ulps) bounds the reordering, with an
  absolute floor of 1e-5 of the largest element for entries that cancel.
  bf16: both sides round ``D = (p - onehot) * gcoef`` to bf16 from fp32
  values that agree to a few fp32 ulps, so an element of the rounded D may
  differ by one bf16 ulp (2^-7 of it, the 8-bit significand); dX and dW may
  then differ by 2^-7 of the sum of |D| |W| (resp. |x| |D|) before their
  own rounding to bf16, which adds one ulp of the result: the gate is
  ``2^-7 (|D| |W|) + 2^-7 |ref|`` per element. The loss is fp32 from the
  same bf16 inputs: 1e-5 relative.
- The public entry's gate (kernels only when ``FLAGS_use_fused_loss`` and
  H % 128 == 0; ``weight_scale`` refused) and the model contract: with the
  flag on, ``LlamaForCausalLM(ids, labels=...)`` returns ``(loss, None)`` as
  the JAX model does, and a two-layer hidden-256 model carried across with
  ``from_paddle_tpu_state`` matches the JAX model's loss and every gradient
  in fp32 at 1e-4 (the tolerance the port's other model tests hold: the
  whole forward and backward reorder fp32 sums), with and without the
  document mask, each loss head running once per step.

- The backward's wgmma instance, which the CPU cannot run: ``flx_route``,
  one route for kernel 17 and the backward (every main-path shape, Llama's ``[H, V]`` and
  GPT's ``[V, H]``, takes ``"wgmma"`` in bf16 and fp16; in fp32 kernel 17
  and the backward take ``"tf32x3"``, the CUDA cores where the split pass
  cannot read W in 16-byte vectors; a ``[H, V]`` W
  whose rows TMA cannot address, or a W that is not 16-byte aligned, takes
  ``"mma_sync"``; ``tests/test_torch_flxent_tf32.py`` holds the 3xTF32
  instance's arithmetic), ``flx_plan`` and ``flx_items`` (every output tile
  of every launch, the ragged last chunk's included, covered exactly once;
  the train shapes' plans; ``chip_smoke.py`` holds both against the
  kernels' own plan on the card), and ``emulate_flx_bwd``,
  a PyTorch walk of its chunks, tiles, k steps and three epilogues (the V
  mask on padded columns, the one-hot, gcoef, the rounding of D, the
  fixed-order fp32 dX partials and dW's block writes) against
  ``flxent_bwd_plain`` and the Pallas kernels in interpret mode, both
  layouts, at the bf16 gate above (the walk forms the same fp32 logits in
  another order, so D may round to the other neighbour).
- The public entry in fp32 (the kernels' gate, the flag at its default;
  the card runs the CUDA-core instance): loss and gradients against JAX's
  fp32 path at 1e-5 relative, the wrappers called once each.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.kernels.fused_loss import fused_linear_cross_entropy as jax_flce
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch
from paddle_tpu_torch.kernels import fused_loss as kloss
from paddle_tpu_torch.models import LlamaConfig, from_paddle_tpu_state
from paddle_tpu_torch.nn import functional as F

IGN = -100
N, H, V = 24, 128, 200
BF16_ULP = 2.0 ** -7
PLAIN = ("flxent_fwd_plain", "flxent_bwd_plain")


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
    """Counts of the plain versions' calls (the CPU wrappers' bodies)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        real = getattr(kloss, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(kloss, name, spy)
    return calls


@pytest.fixture()
def fused_loss_on():
    """``FLAGS_use_fused_loss`` on in both packages (the default of each);
    the prior values are put back afterwards."""
    prior = paddle.get_flags(["FLAGS_use_fused_loss"])
    prior_port = paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"])
    paddle.set_flags({"FLAGS_use_fused_loss": True})
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": True})
    try:
        yield
    finally:
        paddle.set_flags(prior)
        paddle_tpu_torch.set_flags(prior_port)


def _data(seed, labels="mixed"):
    """x [N, H], W [H, V] (N(0, 0.05): logits of order 1), int32 labels:
    mostly in range, some ignored, one past V — or all ignored."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.05).astype(np.float32)
    lab = rng.integers(0, V, (N,)).astype(np.int32)
    if labels == "all ignored":
        lab[:] = IGN
    else:
        lab[[2, 9, 17]] = IGN
        lab[5] = 1 << 20  # past V and past any padded vocab of the JAX paths
    return x, w, lab


def _jax_loss_and_grads(x, w, lab, dtype, reduction, vocab_major, way, g):
    wl = w.T if vocab_major else w
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(wl, dtype)
    kw = dict(interpret=True, block=(16, 128)) if way == "pallas interpret" else {}

    def f(a, b):
        return jax_flce(a, b, jnp.asarray(lab), ignore_index=IGN, reduction=reduction,
                        vocab_major=vocab_major, **kw)

    loss, vjp = jax.vjp(f, jx, jw)
    dx, dw = vjp(jnp.asarray(g, jnp.float32))
    return (np.asarray(loss, np.float32), np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port_loss_and_grads(x, w, lab, dtype, reduction, vocab_major, g):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T) if vocab_major else w).to(dtype).requires_grad_()
    loss = kloss.linear_cross_entropy(tx, tw, torch.from_numpy(lab), ignore_index=IGN, reduction=reduction,
                                      vocab_major=vocab_major)
    loss.backward(torch.from_numpy(np.asarray(g, np.float32)))
    return loss.detach().numpy(), tx.grad.float().numpy(), tw.grad.float().numpy()


def _d_abs(x, w, lab, reduction, g):
    """|D| = |(softmax - onehot) * gcoef| in fp64, the scale of one ulp of
    the rounded D (for the bf16 gate)."""
    logits = x.astype(np.float64) @ w.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    onehot = (np.arange(V)[None, :] == lab[:, None]).astype(np.float64)
    valid = lab != IGN
    if reduction == "mean":
        gc = np.full(N, float(g) / max(valid.sum(), 1))
    elif reduction == "sum":
        gc = np.full(N, float(g))
    else:
        gc = np.asarray(g, np.float64)
    return np.abs((p - onehot) * np.where(valid, gc, 0.0)[:, None])


@pytest.mark.parametrize("way", ["scan reference", "pallas interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_plain_versions_match_jax(way, dtype, reduction, vocab_major):
    x, w, lab = _data(seed=1)
    rng = np.random.default_rng(2)
    g = rng.normal(size=(N,)).astype(np.float32) if reduction == "none" else np.float32(1.7)
    if dtype == "bfloat16":  # both sides take the same bf16 values
        x, w = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, w))
    want = _jax_loss_and_grads(x, w, lab, getattr(jnp, dtype), reduction, vocab_major, way, g)
    got = _port_loss_and_grads(x, w, lab, getattr(torch, dtype), reduction, vocab_major, g)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    dw_want = want[2].T if vocab_major else want[2]
    dw_got = got[2].T if vocab_major else got[2]
    if dtype == "float32":
        for a, b in ((got[1], want[1]), (dw_got, dw_want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
        return
    d_abs = _d_abs(x, w, lab, reduction, g)
    for a, b, scale in ((got[1], want[1], d_abs @ np.abs(w.T)), (dw_got, dw_want, np.abs(x.T) @ d_abs)):
        limit = BF16_ULP * scale + BF16_ULP * np.abs(b)
        assert (np.abs(a - b) <= limit).all(), float((np.abs(a - b) / np.maximum(limit, 1e-30)).max())


@pytest.mark.parametrize("block", ["first", "ragged last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_d_chunk_matches_jax_block_d(block, dtype, vocab_major):
    """The recompute that the dX and dW kernels share: the port's
    ``flxent_dchunk`` (its plain version, on the CPU) against the JAX
    package's ``_flxent_block_d`` on the same block of vocab columns, from
    the same fp32 ``lse`` and ``gcoef``. fp32: 1e-5 relative (the same
    logits summed in another order), with an absolute floor of 1e-5 of the
    largest element. bf16: both round fp32 values that agree to a few fp32
    ulps, so an element may differ by one bf16 ulp of itself (2^-7)."""
    from paddle_tpu.kernels.fused_loss import _flxent_block_d

    x, w, lab = _data(seed=6)
    if dtype == "bfloat16":
        x, w = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, w))
    blk = 128
    j = 0 if block == "first" else (V - 1) // blk
    c0, c1 = j * blk, min((j + 1) * blk, V)
    wl = np.ascontiguousarray(w.T) if vocab_major else w
    tdt = getattr(torch, dtype)
    tx, tw, tlab = torch.from_numpy(x).to(tdt), torch.from_numpy(wl).to(tdt), torch.from_numpy(lab)
    lse, _ = kloss.flxent_fwd_plain(tx, tw, tlab, vocab_major)
    gcoef = torch.where(tlab != IGN, 1.0 / 21, 0.0)
    got = kloss.flxent_dchunk(tx, tw, tlab, lse, gcoef, c0, c1, vocab_major).float().numpy()
    # the JAX block sees W zero-padded to whole blocks, as its Pallas grid does
    vp = -(-V // blk) * blk
    wpad = np.zeros((vp, H) if vocab_major else (H, vp), np.float32)
    wpad[tuple(slice(0, n) for n in wl.shape)] = wl
    wblk = wpad[c0:c0 + blk] if vocab_major else wpad[:, c0:c0 + blk]
    jdt = getattr(jnp, dtype)
    want = _flxent_block_d(jnp.asarray(x, jdt), jnp.asarray(wblk, jdt), jnp.asarray(lab)[:, None],
                           jnp.asarray(lse.numpy())[:, None], jnp.asarray(gcoef.numpy())[:, None], j,
                           v=V, blk_v=blk, vocab_major=vocab_major)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == (N, c1 - c0) and not want[:, c1 - c0:].any()
    want = want[:, :c1 - c0]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= BF16_ULP * np.maximum(np.abs(got), np.abs(want))).all()


@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_all_rows_ignored_gives_zero_loss_and_gradients(vocab_major):
    x, w, lab = _data(seed=3, labels="all ignored")
    want = _jax_loss_and_grads(x, w, lab, jnp.float32, "mean", vocab_major, "pallas interpret", 1.0)
    got = _port_loss_and_grads(x, w, lab, torch.float32, "mean", vocab_major, 1.0)
    assert float(got[0]) == float(want[0]) == 0.0
    assert not got[1].any() and not got[2].any()


def test_forward_saves_inputs_and_lse_only():
    """Nothing of shape [N, V] outlives the forward: the graph holds x, W,
    the labels and the [N] lse."""
    x, w, lab = _data(seed=4)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = kloss.linear_cross_entropy(tx, tw, torch.from_numpy(lab))
    saved = loss.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(N, H), (H, V), (N,), (N,)]
    assert saved[3].dtype == torch.float32


def test_public_entry_gate_and_refusals(plain_calls, fused_loss_on, monkeypatch):
    x, w, lab = _data(seed=5)
    tx, tw, tl = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(lab)
    # H % 128 == 0 with the flag on: the kernels' wrappers (plain on the CPU);
    # otherwise the plain versions are called directly, as JAX runs its scan
    seen = []
    real_fwd = kloss.flxent_fwd
    monkeypatch.setattr(kloss, "flxent_fwd", lambda *a, **k: seen.append("kernel") or real_fwd(*a, **k))
    F.fused_linear_cross_entropy(tx, tw, tl)
    F.fused_linear_cross_entropy(tx[:, :96], tw[:96], tl)
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": False})
    F.fused_linear_cross_entropy(tx, tw, tl)
    assert seen == ["kernel"] and plain_calls["flxent_fwd_plain"] == 3
    # weight_scale (the int8 lm head) is ported: forward only, a backward raises
    w8 = torch.from_numpy(np.clip(np.round(w * 100), -127, 127).astype(np.int8))
    xg = tx.clone().requires_grad_()
    loss8 = F.fused_linear_cross_entropy(xg, w8, tl, weight_scale=torch.full((V,), 0.01))
    assert loss8.dtype == torch.float32 and torch.isfinite(loss8)
    with pytest.raises(RuntimeError, match="forward-only"):
        loss8.backward()
    with pytest.raises(ValueError, match="reduction"):
        F.fused_linear_cross_entropy(tx, tw, tl, reduction="max")
    per = F.fused_linear_cross_entropy(tx.reshape(2, 12, H), tw, tl.reshape(2, 12), reduction="none")
    assert per.shape == (2, 12) and per.dtype == torch.float32


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, w, lab = (torch.from_numpy(a) for a in _data(seed=6))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kloss.flxent_fwd(x.to(**meta), w.to(**meta), lab.to(**meta))
    with pytest.raises(ValueError, match="unsupported device"):
        kloss.flxent_bwd(x.to(**meta), w.to(**meta), lab.to(**meta), torch.zeros(N, **meta), torch.zeros(N, **meta))


# -- the backward's wgmma instance: route, tile plan, and its walk in PyTorch ----

@pytest.mark.parametrize("h,v,vocab_major", [(4096, 32000, False), (5120, 50304, True), (1024, 5000, True),
                                             (256, 200, False)],
                         ids=["llama [H,V]", "gpt [V,H]", "vocab-major 5000", "small [H,V]"])
def test_flx_route_takes_wgmma_on_the_main_paths(h, v, vocab_major):
    """bf16 and fp16 take the wgmma mainloop forward and backward; fp32 runs
    kernel 17 and the backward on the 3xTF32 instance."""
    for dtype in (torch.bfloat16, torch.float16):
        assert kloss.flx_route(dtype, h, v, vocab_major) == "wgmma"
    assert kloss.flx_route(torch.float32, h, v, vocab_major) == "tf32x3"


@pytest.mark.parametrize("dtype,h,v,vocab_major,route,bwd_route", [
    # W [H, V] rows of 64,006 bytes: TMA needs multiples of 16
    (torch.bfloat16, 1024, 32003, False, "mma_sync", "mma_sync"),
    (torch.float16, 512, 3001, False, "mma_sync", "mma_sync"),
    (torch.bfloat16, 1024, 32003, True, "wgmma", "wgmma"),  # vocab-major rows are H long
    (torch.bfloat16, 1004, 5000, True, "mma_sync", "mma_sync"),  # H % 8 != 0
    # fp32 rows of 128,012 bytes: the split pass reads W in 16-byte vectors
    (torch.float32, 1024, 32003, False, "cuda_cores", "cuda_cores"),
    (torch.float32, 1024, 32003, True, "tf32x3", "tf32x3"),
    (torch.bfloat16, 0, 5000, False, "mma_sync", "mma_sync"),  # an empty contraction: the wgmma accumulators start at k step 0
    (torch.float32, 0, 5000, False, "cuda_cores", "cuda_cores"),
])
def test_flx_route_by_dtype_alignment_and_layout(dtype, h, v, vocab_major, route, bwd_route):
    assert kloss.flx_route(dtype, h, v, vocab_major) == route == bwd_route


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (1, "mma_sync"), (4, "mma_sync"), (8, "wgmma")])
@pytest.mark.parametrize("vocab_major", [False, True])
def test_flx_route_of_sends_a_misaligned_weight_to_mma_sync(offset, route, vocab_major):
    """W at ``offset`` bf16 elements into its storage: TMA maps need a
    16-byte aligned base, so W 2 or 8 bytes off takes the mma.sync route
    (chosen before the launch; the forward's mma.sync kernel takes the same
    W) and W 16 bytes off the wgmma route; fp32 takes, for kernel 17 and the
    backward alike, the 3xTF32 instance where W's address is a multiple of
    16 bytes (0, 16 or 32 bytes off), the CUDA cores 4 bytes off."""
    h, v = 64, 256
    fp32 = "tf32x3" if offset != 1 else "cuda_cores"
    for dtype, want in ((torch.bfloat16, route), (torch.float16, route), (torch.float32, fp32)):
        buf = torch.zeros(offset + h * v, dtype=dtype)
        assert buf.data_ptr() % 16 == 0
        w = buf[offset:].view((v, h) if vocab_major else (h, v))
        assert w.is_contiguous()
        x = torch.zeros((4, h), dtype=dtype)
        aligned = offset * buf.element_size() % 16 == 0
        assert kloss.flx_route_of(x, w, vocab_major) == want
        assert kloss.flx_route(dtype, h, v, vocab_major, w_aligned=aligned) == want


@pytest.mark.parametrize("dtype", [torch.int8, torch.float64])
def test_flx_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        kloss.flx_route(dtype, 4096, 32000, False)


# (rows, columns) of each launch's output: D and dX at the train shape ([8192, 4096] chunks; Llama's last
# chunk of 3328 columns), dW in both layouts, GPT's H 5120 and 1152-column tail, and ragged shapes
FLX_LAUNCHES = [(8192, 4096), (8192, 3328), (4096, 4096), (4096, 3328), (8192, 5120), (4096, 5120), (8192, 1152),
                (1152, 5120), (1000, 5000), (300, 400), (160, 8)]


@pytest.mark.parametrize("m,n", FLX_LAUNCHES)
def test_flx_plan_covers_every_output_tile_once(m, n):
    plan = kloss.flx_plan(m, n, 132)
    covered = np.zeros((-(-m // 128) * 128, -(-n // 256) * 256 + 256), np.int32)
    for r0, c0, cols in kloss.flx_items(plan):
        assert r0 < m
        if c0 >= n:  # the empty half of a ragged last column tile: the kernel skips it
            assert cols == kloss.FLX_BN // 2
            continue
        covered[r0:r0 + kloss.FLX_BM, c0:c0 + cols] += 1
    assert (covered[:m, :n] == 1).all()
    assert plan["grid"] == min(plan["items"], 132)
    assert plan["tiles_m"] * plan["tiles_n"] == plan["big"] + (plan["items"] - plan["big"]) // 2


def test_flx_plan_at_the_train_shapes():
    """D and dX at the train shape: 1024 whole tiles (7.8 rounds: splitting
    the last would not shorten the longest CTA); the last chunk's D (832
    tiles) and Llama's dW (512; its last chunk 416) split what lies past
    the last full round, so no SM idles for most of a tile; GPT's dW tail
    (9 x 20 tiles) too."""
    assert kloss.flx_plan(8192, 4096, 132) == dict(tiles_m=64, tiles_n=16, big=1024, items=1024, grid=132)
    assert kloss.flx_plan(8192, 3328, 132) == dict(tiles_m=64, tiles_n=13, big=792, items=872, grid=132)
    assert kloss.flx_plan(4096, 4096, 132) == dict(tiles_m=32, tiles_n=16, big=512, items=512, grid=132)
    assert kloss.flx_plan(4096, 3328, 132) == dict(tiles_m=32, tiles_n=13, big=396, items=436, grid=132)
    assert kloss.flx_plan(1152, 5120, 132) == dict(tiles_m=9, tiles_n=20, big=132, items=228, grid=132)


def emulate_flx_bwd(x, w, labels, lse, gcoef, vocab_major, chunk, sms=132, bk=64):
    """The wgmma route of ``flxent_bwd`` in PyTorch: per vocab chunk of
    ``chunk`` columns (in order), three launches over the tiles of
    ``flx_plan``, each tile's fp32 product summed k step by k step (``bk``;
    the last step zero-filled past K, as TMA fills it), then its epilogue:
    D = (exp(logit - lse) - onehot) * gcoef rounded to x's dtype, 0 past
    the chunk; dX adds the fp32 partial of the chunks before and rounds on
    the last chunk; dW's block rounded to W's dtype and written in place."""
    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    xf = x.float()
    dx_acc = torch.zeros((n, h))
    dx = torch.empty_like(x)
    dw = torch.full_like(w, float("nan"))
    chunks = list(range(0, v, chunk))

    def walk(a, b, m_out, n_out, epilogue):
        """a [M, K], b [K, N] (fp32): every tile of the plan, k step by k step."""
        k = a.shape[1]
        for r0, c0, cols in kloss.flx_items(kloss.flx_plan(m_out, n_out, sms)):
            if c0 >= n_out:
                continue
            acc = torch.zeros((min(kloss.FLX_BM, m_out - r0), min(cols, n_out - c0)))
            for k0 in range(0, k, bk):
                acc += a[r0:r0 + kloss.FLX_BM, k0:k0 + bk] @ b[k0:k0 + bk, c0:c0 + cols]
            epilogue(r0, c0, acc)

    for i, c0 in enumerate(chunks):
        vc = min(chunk, v - c0)
        wc = (w[c0:c0 + vc].t() if vocab_major else w[:, c0:c0 + vc]).float()  # [H, Vc]
        d = torch.empty((n, vc), dtype=x.dtype)

        def d_epi(r0, n0, acc, c0=c0, vc=vc, d=d):
            rows = slice(r0, r0 + acc.shape[0])
            cols = torch.arange(n0, n0 + acc.shape[1])
            inside = cols[None, :] < vc  # the V mask: columns past the chunk are 0
            p = torch.where(inside, torch.exp(acc - lse[rows, None]), 0.0)
            onehot = ((c0 + cols)[None, :] == labels[rows].long()[:, None]) & inside
            d[rows, n0:n0 + acc.shape[1]] = ((p - onehot.float()) * gcoef[rows, None]).to(x.dtype)

        walk(xf, wc, n, vc, d_epi)
        df = d.float()

        def dx_epi(r0, n0, acc, first=i == 0, last=i == len(chunks) - 1):
            blk = (slice(r0, r0 + acc.shape[0]), slice(n0, n0 + acc.shape[1]))
            total = acc if first else acc + dx_acc[blk]
            dx_acc[blk] = total
            if last:
                dx[blk] = total.to(x.dtype)

        walk(df, wc.t(), n, h, dx_epi)

        def dw_epi(r0, n0, acc, c0=c0):
            block = acc.to(w.dtype)
            if vocab_major:  # dW[c0 + v][h] = sum_r D[r][v] x[r][h]
                dw[c0 + r0:c0 + r0 + acc.shape[0], n0:n0 + acc.shape[1]] = block
            else:            # dW[h][c0 + v] = sum_r x[r][h] D[r][v]
                dw[r0:r0 + acc.shape[0], c0 + n0:c0 + n0 + acc.shape[1]] = block

        if vocab_major:
            walk(df.t(), xf, vc, h, dw_epi)
        else:
            walk(xf.t(), df, h, vc, dw_epi)
    return dx, dw


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_wgmma_walk_emulation_matches_plain_and_pallas(vocab_major, dtype):
    """Rows ragged against the 128-row tiles (160), H 256, V 520 in chunks
    of 256 (the last 8 columns: a tile mostly past the chunk), labels ignored,
    past V and on every chunk; six CTAs, so the plans split tiles into
    halves. Gate: the bf16 / fp16 gate of ``test_plain_versions_match_jax``
    (one ulp of the type on the sum of |D| |W| resp. |x| |D|, plus one ulp of
    the result)."""
    n, h, v, chunk = 160, 256, 520, 256
    rng = np.random.default_rng(12)
    jdt = getattr(jnp, dtype)
    x = np.array(jnp.asarray(rng.normal(size=(n, h)), jdt).astype(jnp.float32))
    w = np.array(jnp.asarray(rng.normal(size=(h, v)) * 0.05, jdt).astype(jnp.float32))
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    lab[::9] = IGN
    lab[4] = v + 3
    lab[5], lab[6], lab[7] = 255, 256, 519  # a chunk's last column, the next one's first, V - 1
    tdt = getattr(torch, dtype)
    wl = np.ascontiguousarray(w.T) if vocab_major else w
    tx, tw, tl = torch.from_numpy(x).to(tdt), torch.from_numpy(wl).to(tdt), torch.from_numpy(lab)
    lse, _ = kloss.flxent_fwd_plain(tx, tw, tl, vocab_major)
    valid = tl != IGN
    gcoef = torch.where(valid, 1.0 / valid.sum().float(), 0.0)
    assert kloss.flx_route(tdt, h, v, vocab_major) == "wgmma"
    dx, dw = emulate_flx_bwd(tx, tw, tl, lse, gcoef, vocab_major, chunk, sms=6)
    plan = kloss.flx_plan(n, h, 6)  # dX's launches: both tiles split into halves
    assert plan["big"] == 0 and plan["items"] == 4
    dx_p, dw_p = kloss.flxent_bwd_plain(tx, tw, tl, lse, gcoef, vocab_major)

    # |D| for the gate (the mean's gcoef, fp64)
    logits = x.astype(np.float64) @ w.astype(np.float64)
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    onehot = (np.arange(v)[None, :] == lab[:, None]).astype(np.float64)
    d_abs = np.abs((prob - onehot) * np.where(lab != IGN, 1.0 / (lab != IGN).sum(), 0.0)[:, None])
    ulp = BF16_ULP if dtype == "bfloat16" else 2.0 ** -10
    _, jdx, jdw = _jax_loss_and_grads(x, w, lab, jdt, "mean", vocab_major, "pallas interpret", 1.0)
    dw_scale = np.abs(x.T) @ d_abs  # [H, V]; dW is compared in W's layout
    dw_scale = dw_scale.T if vocab_major else dw_scale
    for want_dx, want_dw in ((dx_p.float().numpy(), dw_p.float().numpy()), (jdx, jdw)):
        for a, b, scale in ((dx.float().numpy(), want_dx, d_abs @ np.abs(w.T)),
                            (dw.float().numpy(), want_dw, dw_scale)):
            assert a.shape == b.shape and np.isfinite(a).all()
            limit = ulp * scale + ulp * np.abs(b)
            assert (np.abs(a - b) <= limit).all(), float((np.abs(a - b) / np.maximum(limit, 1e-30)).max())


LOG2E = 1.4426950408889634


def merge_partials(part):
    """``ptt_flxent_merge``: per row, the vocab tiles' partials in tile
    order: ``lse = m + log(sum_t l_t exp(m_t - m))``, ``tl = sum_t tl_t``."""
    m = part[0].amax(dim=0)
    l = torch.zeros_like(m)
    tl = torch.zeros_like(m)
    for t in range(part.shape[1]):
        l = l + part[1, t] * torch.exp(part[0, t] - m)
        tl = tl + part[2, t]
    return m + torch.log(l), tl


def emulate_flx_fwd(x, w, labels, vocab_major, sms=132, bk=64):
    """The wgmma route of ``flxent_fwd`` (kernel 17) in PyTorch: one launch
    over the items of ``flx_plan(N, V)``, each tile's fp32 logits summed k
    step by k step (``bk``; zero past K and past V, as TMA fills them), then
    the epilogue from registers: columns >= V become NEG_INF; per row, each
    of the quad's four threads (columns 8 j + 2 tig and + 1 of the half)
    walks the half's two 64-column boxes, the box max first, then its exps
    as 2^(v log2 e - m log2 e) added to the earlier boxes' sum rescaled onto
    the running max; the four states merged across the quad (xor 1, then
    2); one partial column per 128-column half (none for a half past V);
    then the merge in tile order."""
    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    xf = x.float()
    wt = (w.t() if vocab_major else w).float()  # [H, V]
    part = torch.full((3, -(-v // kloss.TILE), n), float("nan"))
    for r0, c0, cols in kloss.flx_items(kloss.flx_plan(n, v, sms)):
        if c0 >= v:  # the empty half of the last column tile: the kernel skips it
            continue
        rows = min(kloss.FLX_BM, n - r0)
        wb = torch.zeros((h, cols))
        wb[:, :min(cols, v - c0)] = wt[:, c0:c0 + cols]
        acc = torch.zeros((rows, cols))
        for k0 in range(0, h, bk):
            acc += xf[r0:r0 + rows, k0:k0 + bk] @ wb[k0:k0 + bk]
        acc = torch.where(torch.arange(c0, c0 + cols)[None, :] < v, acc, kloss.NEG_INF)
        lab = labels[r0:r0 + rows].long()
        for half in range(cols // 128):
            hc0 = c0 + 128 * half
            if hc0 >= v:  # no partial column past V
                continue
            # [rows, box, jj, tig, e]: thread tig of the quad holds columns 64 box + 8 jj + 2 tig + e
            seg = acc[:, 128 * half:128 * half + 128].reshape(rows, 2, 8, 4, 2)
            col = (hc0 + torch.arange(128)).reshape(2, 8, 4, 2)
            hit = (col[None] == lab[:, None, None, None, None]) & (col[None] < v)
            m = torch.full((rows, 4), kloss.NEG_INF)
            l = torch.zeros((rows, 4))
            for b in range(2):
                vals = seg[:, b].permute(0, 2, 1, 3).reshape(rows, 4, 16)  # [rows, tig, 16]
                mn = torch.maximum(m, vals.amax(dim=-1))
                ml = mn * LOG2E
                l = l * torch.exp2((m - mn) * LOG2E) + torch.exp2(vals * LOG2E - ml[..., None]).sum(dim=-1)
                m = mn
            t = torch.where(hit, seg, 0.0).sum(dim=(1, 2, 4))  # [rows, tig]
            mq = m.amax(dim=1, keepdim=True)
            lq = l * torch.exp2((m - mq) * LOG2E)
            part[0, hc0 // 128, r0:r0 + rows] = mq[:, 0]
            part[1, hc0 // 128, r0:r0 + rows] = (lq[:, 0] + lq[:, 1]) + (lq[:, 2] + lq[:, 3])
            part[2, hc0 // 128, r0:r0 + rows] = (t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])
    assert not part.isnan().any()  # every partial column written once
    return merge_partials(part)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_wgmma_forward_emulation_matches_plain_and_pallas(vocab_major, dtype):
    """Kernel 17's wgmma route: rows ragged against the 128-row tiles (160),
    H 200 (a partial k box), V 520 (the last 256-column tile holds 8 real
    columns, its second half none); four CTAs, so the plan splits the last
    tiles into halves, one of them past V. Labels ignored, past V, and on
    tile and half edges. Gate: lse and tl within 1e-5 of max(1, |v|) of the
    plain version (the same fp32 logits, summed and exponentiated (2^x) in
    another order), and the per-row loss against the Pallas kernels in
    interpret mode at 1e-5."""
    n, h, v = 160, 200, 520
    rng = np.random.default_rng(14)
    jdt = getattr(jnp, dtype)
    x = np.array(jnp.asarray(rng.normal(size=(n, h)), jdt).astype(jnp.float32))
    w = np.array(jnp.asarray(rng.normal(size=(h, v)) * 0.2, jdt).astype(jnp.float32))
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    lab[::9] = IGN
    lab[4], lab[13], lab[14] = v, v + 3, 1 << 20
    lab[5], lab[6], lab[7], lab[8], lab[10] = 127, 128, 255, 256, 519
    tdt = getattr(torch, dtype)
    wl = np.ascontiguousarray(w.T) if vocab_major else w
    tx, tw, tl = torch.from_numpy(x).to(tdt), torch.from_numpy(wl).to(tdt), torch.from_numpy(lab)
    assert kloss.flx_route_of(tx, tw, vocab_major) == "wgmma"
    items = kloss.flx_items(kloss.flx_plan(n, v, 4))
    assert any(cols == 128 and c0 >= v for _, c0, cols in items)  # a half past V
    assert any(cols == 128 and c0 < v for _, c0, cols in items)  # and a real one
    lse, tlg = emulate_flx_fwd(tx, tw, tl, vocab_major, sms=4)
    lse_p, tl_p = kloss.flxent_fwd_plain(tx, tw, tl, vocab_major)
    for got, want in ((lse, lse_p), (tlg, tl_p)):
        assert ((got - want).abs() <= 1e-5 * want.abs().clamp(min=1.0)).all(), float((got - want).abs().max())
    assert not tlg[lab == IGN].any() and tlg[4] == 0 and tlg[13] == 0 and tlg[14] == 0
    loss = torch.where(tl != IGN, lse - tlg, 0.0).numpy()
    want, _, _ = _jax_loss_and_grads(x, w, lab, jdt, "none", vocab_major, "pallas interpret", np.ones(n, np.float32))
    # the Pallas path pads V to whole 128-column blocks, where a label in [V, 640) meets a NEG_INF column
    padded = (lab >= v) & (lab < 640)
    np.testing.assert_allclose(loss[~padded], want[~padded], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vocab_major", [False, True], ids=["[H,V]", "[V,H]"])
def test_public_entry_in_fp32_matches_jax(fused_loss_on, vocab_major, monkeypatch):
    """``F.fused_linear_cross_entropy`` on fp32 ``[2, 12, H]`` inputs with
    H % 128 == 0 and the flag on (the default): the kernel wrappers, which
    take fp32 (on the card the CUDA-core instance), once forward and once
    backward; loss and gradients against JAX's fp32 path (its scan
    reference) at 1e-5 relative, as ``test_plain_versions_match_jax``."""
    x, w, lab = _data(seed=13)
    calls = []
    for name in ("flxent_fwd", "flxent_bwd"):
        real = getattr(kloss, name)
        monkeypatch.setattr(kloss, name, lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    wl = np.ascontiguousarray(w.T) if vocab_major else w
    tx = torch.from_numpy(x).reshape(2, 12, H).requires_grad_()
    tw = torch.from_numpy(wl).requires_grad_()
    loss = F.fused_linear_cross_entropy(tx, tw, torch.from_numpy(lab).reshape(2, 12), ignore_index=IGN,
                                        weight_vocab_major=vocab_major)
    loss.backward()
    assert calls == ["flxent_fwd", "flxent_bwd"] and loss.dtype == torch.float32
    want = _jax_loss_and_grads(x, w, lab, jnp.float32, "mean", vocab_major, "scan reference", 1.0)
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.reshape(N, H).numpy(), want[1], rtol=1e-5, atol=1e-5 * np.abs(want[1]).max())
    np.testing.assert_allclose(tw.grad.numpy(), want[2], rtol=1e-5, atol=1e-5 * np.abs(want[2]).max())


# -- the model at kernel widths ------------------------------------------------

B, S = 2, 24


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(41)
    jmodel = JaxLlama(JaxLlamaConfig(
        vocab_size=320, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
    ))
    jmodel.train()
    return jmodel


def _batch(seed=8):
    """Rows packed with documents of 3..10 tokens: ids, next-token labels
    within each document (-100 at its last token), and the C=1 FlashMask
    bounds holding each column's document end."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 320, (B, S)).astype(np.int32)
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


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "doc-mask"])
def test_two_layer_model_with_the_fused_loss_matches_jax(jax_model, fused_loss_on, plain_calls, masked):
    ids, labels, bounds = _batch()
    bounds = bounds if masked else None
    for p in jax_model.parameters():
        p.clear_grad()
    jloss, jlogits = jax_model(Tensor(ids), labels=Tensor(labels),
                               startend_row_indices=None if bounds is None else Tensor(bounds))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._data) for n, p in jax_model.named_parameters()}
    jcfg = jax_model.config
    model = from_paddle_tpu_state(
        {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()},
        LlamaConfig(vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size,
                    intermediate_size=jcfg.intermediate_size, num_hidden_layers=jcfg.num_hidden_layers,
                    num_attention_heads=jcfg.num_attention_heads, num_key_value_heads=jcfg.num_key_value_heads,
                    max_position_embeddings=jcfg.max_position_embeddings, rms_norm_eps=jcfg.rms_norm_eps,
                    rope_theta=jcfg.rope_theta, dtype="float32"),
        device="cpu")
    loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                         startend_row_indices=None if bounds is None else torch.from_numpy(bounds))
    loss.backward()
    assert jlogits is None and logits is None
    # one loss head per step: the launch counts chip_smoke.py gates on the card
    assert plain_calls == {"flxent_fwd_plain": 1, "flxent_bwd_plain": 1}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=1e-4, atol=1e-5, err_msg=name)


def test_fused_loss_is_the_default_and_off_returns_the_logits(jax_model):
    assert paddle_tpu_torch.get_flags(["FLAGS_use_fused_loss"]) == {"FLAGS_use_fused_loss": True}
    ids, labels, _ = _batch(seed=9)
    model = from_paddle_tpu_state(
        {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()},
        LlamaConfig(vocab_size=320, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128,
                    rms_norm_eps=jax_model.config.rms_norm_eps, dtype="float32"),
        device="cpu")
    fused, none = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": False})
    try:
        plain, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": True})
    assert none is None and logits.shape == (B, S, 320)
    # the same function, two summation orders over fp32 logits
    np.testing.assert_allclose(fused.item(), plain.item(), rtol=1e-5)
