"""The bf16 / fp16 flash backward above head dim 256 (kernels 15 and 16 on the
tensor cores, ``csrc/flash_bwd_wide.cu``), checked on the CPU.

The CUDA kernels cannot run here. What their launch adds to the function is
a route (``kernels.flash_attention._entry_suffix``: bf16 and fp16 dq and
dk/dv above 256 leave the CUDA-core instances at every head dim), a tile
walk (64 x 64 tiles under the FlashMask tile classes: dq walks the key
tiles of a query tile, dk/dv the query tiles of its group's heads for a
key tile) and a plan of the outputs' columns (``flash_bwd_wide_plan``: dq's
D / 64 column boxes over the two warpgroups of ceil(D / 512) CTAs, dk/dv's
over ceil(D / 256) CTAs, 3 or 4 boxes an owner, every owner recomputing the
reductions S and dP over all of D; the resident pair, dq's Q and g or
dk/dv's K and V, streamed through the ring where it leaves no room for 4
slots). So:

- the route is checked for every head dim from 64 to 1024, each dtype and
  each kernel;
- the plan is checked at every multiple of 64 from 320 to 2048: every
  column box stored by one owner, the box counts the kernel's instances
  take, shared memory within a block's 227 KB;
- a PyTorch emulation of the kernels' arithmetic (the walks, S and dP
  summed over D box by box, P^T and dS (dS^T) rounded to the input type for
  the output products, the column blocks assembled from their owners, the
  GQA heads summed inside a dk/dv item) is held against the Pallas backward
  in interpret mode and the plain versions, at D 320 and 576, bf16 and
  fp16, causal and under a document mask, ragged S and GQA.

``chip_smoke.py`` holds the kernels against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import _pad_to, _run_bwd, _run_fwd

from paddle_tpu_torch.kernels import flash_attention as kfa

LOG2E = 1.4426950408889634
BM = BN = 64  # the wide backward's tiles
KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "fp16", "fp32"])
def test_route_of_every_head_dim(dtype):
    """Above 256 bf16 / fp16 dq and dk/dv take the tensor-core entries (the
    forward's suffix, ``wgmma_wide_*``) at every head dim, with the
    scheduler's counter and 64 x 64 tiles; fp32 dq and dk/dv, like the fp32
    forward, take the 3xTF32 entries (``tf32x3``) to 256 and keep the
    CUDA-core instances above (``fp32`` to 512, ``deep_fp32`` above); bf16 /
    fp16 up to 256 are unchanged."""
    name = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[dtype]
    for d in range(64, 1025, 64):
        fwd, dq, dkv = (kfa._entry_suffix(k, dtype, d) for k in ("flash_fwd", *KERNELS))
        if d <= 256:
            want = "tf32x3" if dtype == torch.float32 else name
        elif dtype == torch.float32:
            want = "fp32" if d <= 512 else "deep_fp32"
        else:
            want = f"wgmma_wide_{name}"
        assert fwd == dq == dkv == want
        assert (kfa._sched(dq, torch.device("cpu")) is None) == (dtype == torch.float32)
        if d > 256:
            tile = (16, 32) if dtype == torch.float32 else (BM, BN)
            assert kfa.flash_tile_shape("flash_bwd_dq", d, dtype) == tile
            assert kfa.flash_tile_shape("flash_bwd_dkv", d, dtype) == ((32, 16) if dtype == torch.float32 else tile)


def test_plan_refuses_what_the_kernels_do_not_take():
    for kernel in KERNELS:
        with pytest.raises(ValueError, match="above 256"):
            kfa.flash_bwd_wide_plan(256, kernel)
        with pytest.raises(ValueError, match="multiples of 64"):
            kfa.flash_bwd_wide_plan(352, kernel)
    with pytest.raises(ValueError, match="not a flash backward kernel"):
        kfa.flash_bwd_wide_plan(512, "flash_fwd")


PLAN_CASES = [(d, kernel) for d in range(320, 2049, 64) for kernel in KERNELS]


@pytest.mark.parametrize("d,kernel", PLAN_CASES, ids=[f"{k[10:]}-d{d}" for d, k in PLAN_CASES])
def test_plan_owns_every_column_box_once(d, kernel):
    p = kfa.flash_bwd_wide_plan(d, kernel)
    boxes, nw, split, groups = d // 64, p["nw"], p["split"], p["groups"]
    dkv = kernel == "flash_bwd_dkv"
    assert p["boxes"] == boxes and len(p["owner_boxes"]) == groups
    # dq: two warpgroups a CTA own boxes; dk/dv: a CTA owns a block (both warpgroups, one of dk / dv each)
    assert groups == (split if dkv else 2 * split)
    assert split == -(-boxes // (4 if dkv else 8))
    assert nw in (3, 4) and nw == -(-boxes // groups)  # the kernel's instances: 3 and 4 boxes
    nxt = 0
    for first, count in p["owner_boxes"]:
        # each owner stores its own boxes and computes nw from its first (at most one of its neighbour's)
        assert first == nxt and nw - 1 <= count <= nw and first + nw <= boxes
        nxt = first + count
    assert nxt == boxes
    # the resident pair (2 x 64 rows x D) stays while 4 ring slots fit beside it (and dk/dv's P^T buffer)
    assert p["stream"] == (d > (512 if dkv else 576))
    assert 4 <= p["stages"] <= 8
    assert p["smem"] <= 227 * 1024
    resident = 0 if p["stream"] else 2 * boxes * 64 * 128
    slot = (4 if p["stream"] else 2) * 64 * 128
    assert resident + p["stages"] * slot + (64 * 64 * 4 if dkv else 0) < p["smem"]


def test_recompute_factor_of_the_plan():
    """The flops the plan spends per visible pair against the minimum (dq 3
    products of 2 D, dk/dv 4): every owner of dq pays S and dP over D and
    its nw boxes; every dk/dv CTA pays S^T and dP^T over D and 2 nw boxes."""

    def factor(d, kernel):
        p = kfa.flash_bwd_wide_plan(d, kernel)
        boxes = d // 64
        if kernel == "flash_bwd_dq":
            return p["groups"] * (2 * boxes + p["nw"]) / (3 * boxes)
        return p["split"] * (2 * boxes + 2 * p["nw"]) / (4 * boxes)

    assert factor(512, "flash_bwd_dq") == pytest.approx(5 / 3)
    assert factor(1024, "flash_bwd_dq") == pytest.approx(3.0)
    assert factor(512, "flash_bwd_dkv") == pytest.approx(1.5)
    assert factor(1024, "flash_bwd_dkv") == pytest.approx(2.5)
    assert factor(320, "flash_bwd_dkv") == pytest.approx(1.6)


# -- the emulation ---------------------------------------------------------------------

def _masked_tile(dense, bi, hm, r0, r1, c0, c1):
    return dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0, r0:r1, c0:c1]


def _reduce(a, b):
    """A B^T summed over D one 64-column box at a time (the kernels' slots)."""
    acc = torch.zeros((a.shape[0], b.shape[0]))
    for x in range(0, a.shape[1], 64):
        acc = acc + a[:, x:x + 64] @ b[:, x:x + 64].T
    return acc


def emulate_wide_dq(q, k, v, bounds, g, lse, delta, causal, scale):
    """Kernel 15's arithmetic: per (batch, head, 64-row query tile) and per
    owner of the plan (a warpgroup), the key tiles from the first to the
    causal limit, SKIP tiles passed over, the mask on PARTIAL tiles only; S
    and dP in fp32 summed over D box by box, p = exp2(S scale log2e - lse
    log2e), dS = p (dP - delta) scale rounded to the input type before dq
    += dS K over the owner's nw boxes in fp32; the owner's own boxes written
    once, in the input type."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    plan = kfa.flash_bwd_wide_plan(d, "flash_bwd_dq")
    cls = kfa.flash_tile_classes(bounds, sq, sk, BM, BN, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    dq = torch.full(q.shape, float("nan"))
    for bi in range(b):
        for hi in range(h):
            hm = hi if cls.shape[1] > 1 else 0
            kv = hi // (h // hk)
            qh, gh = q[bi, :, hi].float(), g[bi, :, hi].float()
            kh, vh = k[bi, :, kv].float(), v[bi, :, kv].float()
            for qt in range(cls.shape[2]):
                r0, r1 = qt * BM, min(qt * BM + BM, sq)
                hi_t = cls.shape[3]
                if causal:
                    lim = (qt + 1) * BM + sk - sq
                    hi_t = 0 if lim <= 0 else min(-(-lim // BN), hi_t)
                lse2 = lse[bi, hi, r0:r1, None] * LOG2E
                dl = delta[bi, hi, r0:r1, None]
                for first, count in plan["owner_boxes"]:
                    cols = slice(64 * first, 64 * (first + plan["nw"]))
                    acc = torch.zeros((r1 - r0, 64 * plan["nw"]))
                    for t in range(hi_t):
                        kind = int(cls[min(bi, cls.shape[0] - 1), hm, qt, t])
                        if kind == kfa.SKIP:
                            continue
                        c0, c1 = t * BN, min(t * BN + BN, sk)
                        p = torch.exp2(_reduce(qh[r0:r1], kh[c0:c1]) * (scale * LOG2E) - lse2)
                        if kind == kfa.PARTIAL:
                            p = p.masked_fill(_masked_tile(dense, bi, hm, r0, r1, c0, c1), 0.0)
                        ds = p * (_reduce(gh[r0:r1], vh[c0:c1]) - dl) * scale
                        acc = acc + ds.to(q.dtype).float() @ kh[c0:c1, cols]
                    dq[bi, r0:r1, hi, 64 * first:64 * (first + count)] = acc[:, :64 * count]
    assert not torch.isnan(dq).any()  # every column of every row written
    return dq.to(q.dtype)


def _key_walk(bounds, bi, hm, k0, c1, sq, sk, causal):
    """Kernel 16's walk of one key tile: the causal floor and the early end
    (``csrc/flash_common.cuh`` ``key_walk_floor``, ``key_walk_end``)."""
    n_qt = -(-sq // BM)
    lo = max(k0 - (sk - sq), 0) // BM if causal else 0
    if bounds is None:
        return lo, n_qt
    cols = bounds[min(bi, bounds.shape[0] - 1), hm, k0:c1].long()
    mn, mx = cols.amin(0), cols.amax(0)
    c = bounds.shape[-1]
    if c == 1 or (c == 2 and int(mn[1]) >= sq):
        return lo, 0 if int(mx[0]) <= 0 else min(-(-int(mx[0]) // BM), n_qt)
    return lo, n_qt


def emulate_wide_dkv(q, k, v, bounds, g, lse, delta, causal, scale):
    """Kernel 16's arithmetic: per (batch, KV head, 64-key tile) and per
    column block of the plan (a CTA), the group's query heads in order and,
    for each, the 64-row query tiles from the causal floor to the walk's
    end, SKIP tiles passed over, the mask on PARTIAL tiles only; S^T and
    dP^T in fp32 summed over D box by box, P^T = exp2(S^T scale log2e - lse
    log2e) and dS^T = P^T (dP^T - delta) scale, each rounded to the input
    type before dV += P^T g and dK += dS^T q over the block's nw boxes in
    fp32 (the heads summed in the item); the block's own boxes written
    once, in the input type."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    plan = kfa.flash_bwd_wide_plan(d, "flash_bwd_dkv")
    cls = kfa.flash_tile_classes(bounds, sq, sk, BM, BN, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    dk, dv = torch.full(k.shape, float("nan")), torch.full(v.shape, float("nan"))
    for bi in range(b):
        bb = min(bi, cls.shape[0] - 1)
        for kvh in range(hk):
            kh, vh = k[bi, :, kvh].float(), v[bi, :, kvh].float()
            for t in range(cls.shape[3]):
                k0, k1 = t * BN, min(t * BN + BN, sk)
                for first, count in plan["owner_boxes"]:
                    cols = slice(64 * first, 64 * (first + plan["nw"]))
                    acc_k = torch.zeros((k1 - k0, 64 * plan["nw"]))
                    acc_v = torch.zeros_like(acc_k)
                    for hi in range(kvh * (h // hk), (kvh + 1) * (h // hk)):
                        hm = hi if cls.shape[1] > 1 else 0
                        qh, gh = q[bi, :, hi].float(), g[bi, :, hi].float()
                        lo, end = _key_walk(bounds, bi, hm, k0, k1, sq, sk, causal)
                        for qt in range(lo, end):
                            kind = int(cls[bb, hm, qt, t])
                            if kind == kfa.SKIP:
                                continue
                            r0, r1 = qt * BM, min(qt * BM + BM, sq)
                            p_t = torch.exp2(_reduce(kh[k0:k1], qh[r0:r1]) * (scale * LOG2E)
                                             - lse[bi, hi, None, r0:r1] * LOG2E)
                            if kind == kfa.PARTIAL:
                                p_t = p_t.masked_fill(_masked_tile(dense, bi, hm, r0, r1, k0, k1).T, 0.0)
                            ds_t = p_t * (_reduce(vh[k0:k1], gh[r0:r1]) - delta[bi, hi, None, r0:r1]) * scale
                            acc_v = acc_v + p_t.to(q.dtype).float() @ gh[r0:r1, cols]
                            acc_k = acc_k + ds_t.to(q.dtype).float() @ qh[r0:r1, cols]
                    dk[bi, k0:k1, kvh, 64 * first:64 * (first + count)] = acc_k[:, :64 * count]
                    dv[bi, k0:k1, kvh, 64 * first:64 * (first + count)] = acc_v[:, :64 * count]
    assert not torch.isnan(dk).any() and not torch.isnan(dv).any()
    return dk.to(k.dtype), dv.to(v.dtype)


def _pallas_bwd(q, k, v, g, bounds, causal, blk=64):
    """The Pallas forward and backward in interpret mode on fp32 copies of
    the inputs: lse, dq, dk, dv sliced back, as fp32 tensors."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh, gh = (jnp.moveaxis(jnp.asarray(x.float().numpy()), 2, 1) for x in (q, k, v, g))
    qp, kp, vp, gp = (_pad_to(x, 2, blk) for x in (qh, kh, vh, gh))
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds.numpy()), 2, blk)
    kw = dict(sq=sq, sk=sk, scale=1.0 / d**0.5, causal=causal, blk_q=blk, blk_k=blk, interpret=True)
    out, lse = _run_fwd(qp, kp, vp, idx, **kw)
    dq, dk, dv = _run_bwd(qp, kp, vp, idx, gp, out, lse, **kw)

    def back(x, n):
        return torch.from_numpy(np.array(jnp.moveaxis(x[:, :, :n], 1, 2)))

    return (back(out, sq), torch.from_numpy(np.array(lse[:, :, :sq, 0])), back(dq, sq), back(dk, sk),
            back(dv, sk))


def _doc_bounds(rng, s):
    ends = np.zeros((1, 1, s, 1), np.int32)
    pos = 0
    while pos < s:
        end = min(s, pos + int(rng.integers(20, 120)))
        ends[0, 0, pos:end, 0] = end
        pos = end
    return torch.from_numpy(ends)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


# dS (dS^T) and P^T are rounded to the input type before their products: a
# relative L2 error of a few of its ulps (bf16 2^-8, fp16 2^-11), as the
# D <= 256 kernels' emulations are held (tests/test_torch_flash_tiles.py)
GRAD_REL_L2 = {torch.bfloat16: 1e-2, torch.float16: 2e-3}

# (dtype, D, document mask, causal, S, H, HK): D 320 one CTA of two 2 + 3 box
# warpgroups (dq) and two CTAs of 3 + 2 boxes (dk/dv); D 576 two CTAs a
# query tile (dq) and three a key tile with K and V streamed (dk/dv); causal
# and a C=1 document mask; ragged S; GQA groups of 2 and 1
EMU_CASES = [
    (torch.bfloat16, 320, False, True, 150, 4, 2),
    (torch.float16, 320, True, True, 130, 4, 2),
    (torch.bfloat16, 576, True, True, 140, 2, 1),
    (torch.float16, 576, False, True, 100, 4, 2),
    (torch.bfloat16, 320, False, False, 70, 2, 1),
]


@pytest.mark.parametrize("dtype,d,doc,causal,s,h,hk", EMU_CASES,
                         ids=[f"{str(t)[6:]}-d{d}-{'doc' if m else 'nomask'}-{'causal' if c else 'full'}-s{s}-g{h // hk}"
                              for t, d, m, c, s, h, hk in EMU_CASES])
def test_emulated_wide_backward_matches_pallas_and_plain(dtype, d, doc, causal, s, h, hk):
    """The emulated kernels on the Pallas forward's lse and on delta =
    rowsum(g out), as the port's autograd gives them, against the Pallas
    dq, dk, dv in interpret mode and the plain versions: relative L2 within
    :data:`GRAD_REL_L2`."""
    rng = np.random.default_rng(d + s + h)
    q, g = (torch.from_numpy(rng.normal(size=(1, s, h, d)).astype(np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, s, hk, d)).astype(np.float32)).to(dtype) for _ in range(2))
    bounds = _doc_bounds(rng, s) if doc else None
    out_j, lse_j, dq_j, dk_j, dv_j = _pallas_bwd(q, k, v, g, bounds, causal)
    delta = (g.float() * out_j).sum(-1).transpose(1, 2).contiguous()
    scale = 1.0 / d**0.5
    dq = emulate_wide_dq(q, k, v, bounds, g, lse_j, delta, causal, scale)
    dk, dv = emulate_wide_dkv(q, k, v, bounds, g, lse_j, delta, causal, scale)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    args = (*(x.float() for x in (q, k, v)), bounds, g.float(), lse_j, delta, causal)
    dq_p = kfa.flash_bwd_dq_plain(*args)
    dk_p, dv_p = kfa.flash_bwd_dkv_plain(*args)
    for got, pallas, plain in ((dq, dq_j, dq_p), (dk, dk_j, dk_p), (dv, dv_j, dv_p)):
        assert _rel_l2(got, pallas) <= GRAD_REL_L2[dtype]
        assert _rel_l2(got, plain) <= GRAD_REL_L2[dtype]
