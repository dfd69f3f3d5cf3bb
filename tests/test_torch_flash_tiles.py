"""The tile walk of the port's redesigned flash kernels (14 forward, 15 dq
and 16 dk/dv on wgmma, and the fp32 instances of 14, 15 and 16), checked on
the CPU.

The CUDA kernels cannot run here. What they add to the function is the
FlashMask tile classing (``csrc/flash_common.cuh`` ``warp_tile_class``:
SKIP tiles are neither loaded nor multiplied, FULL tiles run without the
mask) and their rounding (P and dS in the input type before their second
product, the fp32 product scaled). So:

- ``flash_tile_classes``, the classing's PyTorch mirror, is held against the
  dense mask (``flash_masked``) on seeded random bounds: no tile may be
  called SKIP or FULL where the dense mask disagrees;
- a PyTorch emulation of the kernels' arithmetic, written here, walks the
  tiles in the kernels' order at their BM x BN under those classes and is
  held against the Pallas kernels in interpret mode and the port's plain
  versions; for dk/dv that is the transposed walk (per key tile, the query
  tiles of its group's heads from the causal floor to the walk's early
  end, ``dkv_walk``), whose skipped tiles are held to the dense mask;
- the train phase's document mask has FULL, PARTIAL and SKIP tiles;
- the plain versions are held against the Pallas kernels at fp16 inputs and
  at head dims 192 and 256, which the card now takes, and the wrappers'
  input rules are checked on ``meta`` tensors.

``chip_smoke.py`` holds the CUDA kernels against the plain versions on the
card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import _pad_to, _run_bwd, _run_fwd

from paddle_tpu_torch.kernels import flash_attention as kfa

LOG2E = 1.4426950408889634
# fwd D<=128, fwd D>128 and dq, fp32 fwd/dq, fp32 dk/dv, dk/dv
TILE_SHAPES = [(128, 128), (128, 64), (16, 32), (32, 16), (64, 64)]


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


# -- the classing against the dense mask ---------------------------------------

def _random_bounds(rng, b, hm, sq, sk, c):
    """Bounds of every kind a caller may pass, not only FlashMask's
    families: in most cases runs of 1-300 columns share their values (as a
    document's or a band's columns do), so that whole tiles are SKIP or
    FULL; else every column draws its own. Bands anywhere in [0, Sq],
    empty ones (start >= end), and for C=4 an upper band that may cover
    every row."""
    out = np.zeros((b, hm, sk, c), np.int64)
    runs = rng.random() < 0.7
    for bi in range(b):
        for hi in range(hm):
            pos = 0
            while pos < sk:
                end = min(sk, pos + (int(rng.integers(1, 300)) if runs else 1))
                start = int(rng.integers(0, sq + 1))
                vals = [start, int(rng.integers(0, sq + 1)) if rng.random() < 0.1 else int(rng.integers(start, sq + 1))]
                if rng.random() < 0.2:
                    vals += [0, sq]
                else:
                    s2 = int(rng.integers(0, sq + 1))
                    vals += [s2, int(rng.integers(s2, sq + 1))]
                out[bi, hi, pos:end] = vals[:c]
                pos = end
    return out.astype(np.int32)


def _dense_tile_truth(masked, bm, bn):
    """(every logit masked, no logit masked) per tile of a dense mask
    ``[B, Hm, Sq, Sk]``, padding rows and columns counted as masked."""
    b, hm, sq, sk = masked.shape
    nq, nk = -(-sq // bm), -(-sk // bn)
    pad = torch.ones((b, hm, nq * bm, nk * bn), dtype=torch.bool)
    pad[:, :, :sq, :sk] = masked
    t = pad.reshape(b, hm, nq, bm, nk, bn)
    return t.all(5).all(3), (~t).all(5).all(3)


# (C, causal, Hm) x 20 seeded cases each: 240 cases, every tile shape, Sq != Sk and ragged S
CLASS_CASES = [(c, causal, hm) for c in (1, 2, 4) for causal in (True, False) for hm in (1, 3)]


@pytest.mark.parametrize("c,causal,hm", CLASS_CASES, ids=[f"c{c}-{'causal' if k else 'full'}-hm{h}"
                                                         for c, k, h in CLASS_CASES])
def test_tile_classes_never_contradict_the_dense_mask(c, causal, hm):
    rng = np.random.default_rng(100 * c + 10 * causal + hm)
    seen = torch.zeros(3, dtype=torch.long)
    for case in range(20):
        bm, bn = TILE_SHAPES[case % len(TILE_SHAPES)]
        sq = int(rng.integers(1, 420))
        sk = sq if case % 5 == 0 else int(rng.integers(1, 420))
        bounds = _t(_random_bounds(rng, 2, hm, sq, sk, c))
        cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
        all_masked, none_masked = _dense_tile_truth(kfa.flash_masked(sq, sk, causal, bounds, torch.device("cpu")),
                                                    bm, bn)
        assert cls.shape == (2, hm, -(-sq // bm), -(-sk // bn))
        assert not ((cls == kfa.SKIP) & ~all_masked).any(), f"case {case}: a SKIP tile has a visible logit"
        assert not ((cls == kfa.FULL) & ~none_masked).any(), f"case {case}: a FULL tile has a masked logit"
        seen += torch.bincount(cls.flatten().long(), minlength=3)
    assert (seen > 0).all(), f"the cases never produced every class: {seen.tolist()}"


@pytest.mark.parametrize("causal", [True, False])
def test_tile_classes_without_bounds(causal):
    """No FlashMask: only the causal limit and padding class tiles; a
    causal walk skips exactly the tiles past each query tile's limit."""
    for sq, sk, (bm, bn) in [(4096, 4096, (128, 128)), (1000, 1000, (128, 64)), (300, 700, (16, 32))]:
        cls = kfa.flash_tile_classes(None, sq, sk, bm, bn, causal)
        all_masked, none_masked = _dense_tile_truth(kfa.flash_masked(sq, sk, causal, None, torch.device("cpu")),
                                                    bm, bn)
        assert not ((cls == kfa.SKIP) & ~all_masked).any() and not ((cls == kfa.FULL) & ~none_masked).any()
        if causal:
            assert torch.equal(cls == kfa.SKIP, all_masked)  # the causal skip is exact
        else:
            assert not (cls == kfa.SKIP).any()


# -- the kernels' arithmetic, emulated -----------------------------------------

def emulate_fwd(q, k, v, bounds, causal, scale, bm, bn):
    """Kernel 14's walk: per (batch, head, BM-row query tile) the key tiles
    from the first to the causal limit, SKIP tiles passed over, the mask
    applied on PARTIAL tiles only; the fp32 product of q and k (in their own
    type) scaled; the online softmax in fp32; P rounded to the input type
    for P V while l sums the fp32 p; out = acc / l in the input type,
    lse = m + log(l), a row with nothing visible 0 and +inf."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    out = torch.zeros(q.shape, dtype=torch.float32)
    lse = torch.full((b, h, sq), float("inf"))
    for bi in range(b):
        for hi in range(h):
            hm = hi if cls.shape[1] > 1 else 0
            qh, kh, vh = q[bi, :, hi].float(), k[bi, :, hi // (h // hk)].float(), v[bi, :, hi // (h // hk)].float()
            for qt in range(cls.shape[2]):
                r0, r1 = qt * bm, min(qt * bm + bm, sq)
                m = torch.full((r1 - r0, 1), float("-inf"))
                l = torch.zeros((r1 - r0, 1))
                acc = torch.zeros((r1 - r0, d))
                hi_t = cls.shape[3]
                if causal:
                    lim = (qt + 1) * bm + sk - sq
                    hi_t = 0 if lim <= 0 else min(-(-lim // bn), hi_t)
                for t in range(hi_t):
                    kind = int(cls[min(bi, cls.shape[0] - 1), hm, qt, t])
                    if kind == kfa.SKIP:
                        continue
                    c0, c1 = t * bn, min(t * bn + bn, sk)
                    x = (qh[r0:r1] @ kh[c0:c1].T) * (scale * LOG2E)  # the kernel's log2 units
                    if kind == kfa.PARTIAL:
                        x = x.masked_fill(dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0,
                                                r0:r1, c0:c1], float("-inf"))
                    m_new = torch.maximum(m, x.amax(1, keepdim=True))
                    seen = m_new > float("-inf")
                    alpha = torch.where(seen, torch.exp2(m - m_new), torch.ones_like(m))
                    p = torch.where(seen, torch.exp2(x - m_new), torch.zeros_like(x))
                    l = l * alpha + p.sum(1, keepdim=True)
                    acc = acc * alpha + p.to(q.dtype).float() @ vh[c0:c1]
                    m = m_new
                ok = l > 0
                out[bi, r0:r1, hi] = torch.where(ok, acc / l.clamp(min=1e-30), torch.zeros_like(acc))
                lse[bi, hi, r0:r1] = torch.where(ok, m / LOG2E + torch.log(l), torch.full_like(m, float("inf")))[:, 0]
    return out.to(q.dtype), lse


def emulate_dq(q, k, v, bounds, g, lse, delta, causal, scale, bm, bn):
    """Kernel 15's walk (the forward's tiles): p = exp(scale q k^T - lse),
    0 where masked on PARTIAL tiles, dS = p (g v^T - delta) scale rounded to
    the input type, dq += dS k in fp32, written in the input type."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32)
    for bi in range(b):
        for hi in range(h):
            hm = hi if cls.shape[1] > 1 else 0
            kv = hi // (h // hk)
            qh, gh, kh, vh = q[bi, :, hi].float(), g[bi, :, hi].float(), k[bi, :, kv].float(), v[bi, :, kv].float()
            for qt in range(cls.shape[2]):
                r0, r1 = qt * bm, min(qt * bm + bm, sq)
                hi_t = cls.shape[3]
                if causal:
                    lim = (qt + 1) * bm + sk - sq
                    hi_t = 0 if lim <= 0 else min(-(-lim // bn), hi_t)
                for t in range(hi_t):
                    kind = int(cls[min(bi, cls.shape[0] - 1), hm, qt, t])
                    if kind == kfa.SKIP:
                        continue
                    c0, c1 = t * bn, min(t * bn + bn, sk)
                    p = torch.exp(scale * (qh[r0:r1] @ kh[c0:c1].T) - lse[bi, hi, r0:r1, None])
                    if kind == kfa.PARTIAL:
                        p = p.masked_fill(dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0,
                                                r0:r1, c0:c1], 0.0)
                    ds = p * (gh[r0:r1] @ vh[c0:c1].T - delta[bi, hi, r0:r1, None]) * scale
                    dq[bi, r0:r1, hi] += ds.to(q.dtype).float() @ kh[c0:c1]
    return dq.to(q.dtype)


def emulate_dkv_fp32(q, k, v, bounds, g, lse, delta, causal, scale, bm=32, bn=16):
    """The fp32 dk/dv kernel's walk: per (batch, KV head, BN-key tile) the
    group's query heads and the BM-row query tiles from the causal start,
    SKIP tiles passed over, the mask on PARTIAL tiles only."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for bi in range(b):
        for kvh in range(hk):
            for t in range(cls.shape[3]):
                c0, c1 = t * bn, min(t * bn + bn, sk)
                lo = max((c0 - (sk - sq)) // bm, 0) if causal else 0
                for hi in range(kvh * (h // hk), (kvh + 1) * (h // hk)):
                    hm = hi if cls.shape[1] > 1 else 0
                    for qt in range(lo, cls.shape[2]):
                        kind = int(cls[min(bi, cls.shape[0] - 1), hm, qt, t])
                        if kind == kfa.SKIP:
                            continue
                        r0, r1 = qt * bm, min(qt * bm + bm, sq)
                        qh, gh = q[bi, r0:r1, hi], g[bi, r0:r1, hi]
                        p = torch.exp(scale * (qh @ k[bi, c0:c1, kvh].T) - lse[bi, hi, r0:r1, None])
                        if kind == kfa.PARTIAL:
                            p = p.masked_fill(dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0,
                                                    r0:r1, c0:c1], 0.0)
                        ds = p * (gh @ v[bi, c0:c1, kvh].T - delta[bi, hi, r0:r1, None]) * scale
                        dv[bi, c0:c1, kvh] += p.T @ gh
                        dk[bi, c0:c1, kvh] += ds.T @ qh
    return dk, dv


def dkv_walk(bounds, sq, sk, bm, bn, causal):
    """Kernel 16's walk of each key tile (``csrc/flash_common.cuh``
    ``key_walk_floor`` and ``key_walk_end``), int ``[B|1, Hm|1, n_kt, 2]``:
    the first query tile, the causal floor ``(k0 - (Sk - Sq)) // bm``
    (clamped at 0), and the end, cut under C=1, or C=2 with every band
    reaching Sq, at the tile holding the key tile's last visible row
    ``max s - 1``, from the per-slot min and max of the tile's real
    columns."""
    n_qt, n_kt = -(-sq // bm), -(-sk // bn)
    b, hm = (1, 1) if bounds is None else bounds.shape[:2]
    walk = torch.zeros((b, hm, n_kt, 2), dtype=torch.long)
    for t in range(n_kt):
        c0, c1 = t * bn, min(t * bn + bn, sk)
        walk[:, :, t, 0] = max(c0 - (sk - sq), 0) // bm if causal else 0
        walk[:, :, t, 1] = n_qt
        if bounds is None:
            continue
        c = bounds.shape[-1]
        cols = bounds[:, :, c0:c1].long()
        mn, mx = cols.amin(2), cols.amax(2)  # [B, Hm, C]
        cut = torch.full((b, hm), c == 1, dtype=torch.bool)
        if c == 2:
            cut = mn[..., 1] >= sq
        end = torch.where(mx[..., 0] <= 0, 0, -(-mx[..., 0] // bm)).clamp(max=n_qt)
        walk[:, :, t, 1] = torch.where(cut, end, n_qt)
    return walk


def emulate_dkv(q, k, v, bounds, g, lse, delta, causal, scale, bm, bn):
    """Kernel 16's walk: per (batch, KV head, BN-key tile) the group's query
    heads in order and, for each, the BM-row query tiles of ``dkv_walk``,
    SKIP tiles passed over, the mask on PARTIAL tiles only; the fp32
    products K q^T and V g^T of the input-type values, the first scaled,
    P^T = exp2(s scale log2e - lse log2e) and dS^T = P^T (dP^T - delta)
    scale in fp32, each rounded to the input type before dV += P^T g and
    dK += dS^T q in fp32; dk and dv written once, in the input type."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
    walk = dkv_walk(bounds, sq, sk, bm, bn, causal)
    dense = kfa.flash_masked(sq, sk, causal, bounds, q.device)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for bi in range(b):
        bb = min(bi, cls.shape[0] - 1)
        for kvh in range(hk):
            kh, vh = k[bi, :, kvh].float(), v[bi, :, kvh].float()
            for t in range(cls.shape[3]):
                c0, c1 = t * bn, min(t * bn + bn, sk)
                acc_k, acc_v = torch.zeros((c1 - c0, d)), torch.zeros((c1 - c0, d))
                for hi in range(kvh * (h // hk), (kvh + 1) * (h // hk)):
                    hm = hi if cls.shape[1] > 1 else 0
                    qh, gh = q[bi, :, hi].float(), g[bi, :, hi].float()
                    lo, end = (int(x) for x in walk[min(bi, walk.shape[0] - 1), hm, t])
                    for qt in range(lo, end):
                        kind = int(cls[bb, hm, qt, t])
                        if kind == kfa.SKIP:
                            continue
                        r0, r1 = qt * bm, min(qt * bm + bm, sq)
                        s_t = kh[c0:c1] @ qh[r0:r1].T  # [keys, rows]
                        p = torch.exp2(s_t * (scale * LOG2E) - lse[bi, hi, None, r0:r1] * LOG2E)
                        if kind == kfa.PARTIAL:
                            p = p.masked_fill(dense[min(bi, dense.shape[0] - 1), hm if dense.shape[1] > 1 else 0,
                                                    r0:r1, c0:c1].T, 0.0)
                        ds = p * (vh[c0:c1] @ gh[r0:r1].T - delta[bi, hi, None, r0:r1]) * scale
                        acc_v += p.to(q.dtype).float() @ gh[r0:r1]
                        acc_k += ds.to(q.dtype).float() @ qh[r0:r1]
                dk[bi, c0:c1, kvh], dv[bi, c0:c1, kvh] = acc_k, acc_v
    return dk.to(k.dtype), dv.to(v.dtype)


def _dkv_limits(q, k, v, bounds, g, lse, delta, causal, dtype):
    """Elementwise limits for dk and dv of a walk that rounds P^T and dS^T
    to ``dtype`` (each by at most ULP of itself) and then dk and dv (OUT_ULP
    of the value), plus 1e-5 of the fp32 terms before cancellation for the
    fp32 summation order: ULP (|P|^T |g|) and ULP (|dS|^T |q|) summed over
    the group, as fp32 ``[B, Sk, HK, D]``."""
    qh, kh, gh, p, ds = kfa._probs_and_ds(*(x.float() for x in (q, k, v)), bounds, g.float(), lse, delta, causal,
                                          None)
    scale = 1.0 / q.shape[-1] ** 0.5
    vh = kfa._heads(v, k.shape[2])
    dp_abs = (gh @ vh.transpose(-1, -2)).abs() + delta.float().reshape(p.shape[:-1] + (1,)).abs()
    terms = [(p.transpose(-1, -2) @ gh.abs(), p.transpose(-1, -2) @ gh.abs()),
             (ds.abs().transpose(-1, -2) @ qh.abs(), (p * dp_abs * scale).transpose(-1, -2) @ qh.abs())]
    dk_ref, dv_ref = kfa.flash_bwd_dkv_plain(*(x.float() for x in (q, k, v)), bounds, g.float(), lse, delta, causal)
    out = []
    for (rounded, raw), ref in zip(terms[::-1], (dk_ref, dv_ref)):
        lim = ULP[dtype] * rounded.sum(2) + 1e-5 * raw.sum(2)  # [B, HK, Sk, D]
        out.append(lim.permute(0, 2, 1, 3) + OUT_ULP[dtype] * ref.abs() + 1e-6)
    return out


def _pallas(q, k, v, g, bounds, causal, blk=64):
    """The Pallas kernels in interpret mode (block ``blk``) on fp32 copies of
    the inputs; out, lse, dq, dk, dv sliced back, as fp32 tensors."""
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


def _ffn_bounds(rng, b, hm, s, c):
    """FlashMask bounds that keep every row's diagonal (so the Pallas
    kernels and the port agree on every row): C=1 documents of 20-200
    tokens, C=2 a band below the diagonal, C=4 a band below and one above."""
    j = np.arange(s)[None, None, :]
    if c == 1:
        ends = np.zeros((b, hm, s), np.int64)
        for bi in range(b):
            for hi in range(hm):
                pos = 0
                while pos < s:
                    end = min(s, pos + int(rng.integers(20, 200)))
                    ends[bi, hi, pos:end] = end
                    pos = end
        return ends[..., None].astype(np.int32)
    start = np.minimum(j + 1 + rng.integers(0, 40, (b, hm, s)), s)
    end = np.minimum(start + rng.integers(0, 150, (b, hm, s)), s)
    cols = [start, end]
    if c == 4:
        ute = np.maximum(j - rng.integers(1, 40, (b, hm, s)), 0)
        uts = np.maximum(ute - rng.integers(0, 150, (b, hm, s)), 0)
        cols += [uts, ute]
    return np.stack(cols, -1).astype(np.int32)


def _inputs(seed, s, h, hk, d, dtype, c=0, hm=1, b=1):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32)).to(dtype)
                  for n in (h, hk, hk, h))
    bounds = _t(_ffn_bounds(rng, b, 1 if hm == 1 else h, s, c)) if c else None
    return q, k, v, g, bounds


def _gate(got, want, limit):
    """Every element within ``limit`` (a tensor or a number) of ``want``."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), f"max err {float(err.max())}, worst err/limit {float((err / limit).max())}"


# per dtype: P (or dS) is rounded to the input type before its second product,
# so each p moves by at most one unit in the last place (bf16 2^-8, fp16
# 2^-11 of itself) and out by at most that times (P|v|)/l, plus the rounding
# of out itself (one ulp of |out|); fp32 rounds nothing: 1e-5 relative
ULP = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11, torch.float32: 0.0}
OUT_ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, torch.float32: 1e-5}
GRAD_REL_L2 = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def _out_limit(q, k, v, bounds, causal, out_ref, dtype):
    f = [x.float() for x in (q, k, v)]
    spread = kfa.flash_fwd_plain(f[0], f[1], f[2].abs(), bounds, causal)[0]
    return ULP[dtype] * spread + OUT_ULP[dtype] * out_ref.abs() + 1e-6


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


# (dtype, BM, BN, C, Hm, causal, S): the forward's 128 x 128 and 128 x 64
# walks (dq always 128 x 64), every mask family, Hm 1 and H, ragged S
EMU_CASES = [
    (torch.bfloat16, 128, 128, 0, 1, True, 300),
    (torch.bfloat16, 128, 64, 1, 1, True, 333),
    (torch.float16, 128, 128, 2, 2, True, 270),
    (torch.float16, 128, 64, 4, 1, False, 300),
    (torch.float32, 16, 32, 1, 2, True, 150),
    (torch.float32, 16, 32, 4, 1, False, 129),
]


@pytest.mark.parametrize("dtype,bm,bn,c,hm,causal,s", EMU_CASES,
                         ids=[f"{str(t)[6:]}-{bm}x{bn}-c{c}-hm{hm}-{'causal' if k else 'full'}-s{s}"
                              for t, bm, bn, c, hm, k, s in EMU_CASES])
def test_emulated_kernels_match_pallas_and_plain(dtype, bm, bn, c, hm, causal, s):
    q, k, v, g, bounds = _inputs(7 * s + c, s, 2, 1, 64, dtype, c, hm)
    scale = 1.0 / 64**0.5
    out_j, lse_j, dq_j, dk_j, dv_j = _pallas(q, k, v, g, bounds, causal)
    out, lse = emulate_fwd(q, k, v, bounds, causal, scale, bm, bn)
    out_p, lse_p = kfa.flash_fwd_plain(*(x.float() for x in (q, k, v)), bounds, causal)
    limit = _out_limit(q, k, v, bounds, causal, out_j, dtype)
    _gate(out, out_j, limit)
    _gate(out, out_p, limit)
    _gate(lse, lse_j, 1e-5 * lse_j.abs().clamp(min=1.0))
    _gate(lse, lse_p, 1e-5 * lse_p.abs().clamp(min=1.0))
    # the backward on the Pallas forward's lse and delta, as _run_bwd computes them
    delta = (g.float() * out_j).sum(-1).transpose(1, 2).contiguous()
    dq = emulate_dq(q, k, v, bounds, g, lse_j, delta, causal, scale, 128 if dtype != torch.float32 else bm,
                    64 if dtype != torch.float32 else bn)
    dq_p = kfa.flash_bwd_dq_plain(*(x.float() for x in (q, k, v)), bounds, g.float(), lse_j, delta, causal)
    assert _rel_l2(dq, dq_j) <= GRAD_REL_L2[dtype] and _rel_l2(dq, dq_p) <= GRAD_REL_L2[dtype]
    if dtype == torch.float32:
        dk, dv = emulate_dkv_fp32(q, k, v, bounds, g, lse_j, delta, causal, scale)
        for got, want in ((dk, dk_j), (dv, dv_j)):
            assert _rel_l2(got, want) <= GRAD_REL_L2[dtype]


# (dtype, C, Hm, causal, S, H, HK): kernel 16's 64 x 64 walk (the same at
# every head dim), every mask family, Hm 1 and H, groups of 1, 2 and 4 query
# heads, ragged S
DKV_CASES = [
    (torch.bfloat16, 0, 1, True, 300, 2, 2),
    (torch.bfloat16, 1, 1, True, 333, 4, 2),
    (torch.float16, 2, 4, True, 270, 4, 1),
    (torch.bfloat16, 4, 1, False, 300, 2, 1),
    (torch.bfloat16, 1, 2, True, 200, 2, 1),
    (torch.float16, 4, 4, False, 190, 4, 2),
]


@pytest.mark.parametrize("dtype,c,hm,causal,s,h,hk", DKV_CASES,
                         ids=[f"{str(t)[6:]}-c{c}-hm{hm}-{'causal' if k else 'full'}-s{s}-g{h // hk}"
                              for t, c, hm, k, s, h, hk in DKV_CASES])
def test_emulated_dkv_matches_pallas_and_plain(dtype, c, hm, causal, s, h, hk):
    """Kernel 16's transposed walk and rounding against the Pallas dk/dv in
    interpret mode and the plain version, on the Pallas forward's lse and
    delta, elementwise within the rounding of P^T and dS^T (``_dkv_limits``)."""
    q, k, v, g, bounds = _inputs(3 * s + c + h, s, h, hk, 64, dtype, c, hm)
    out_j, lse_j, _, dk_j, dv_j = _pallas(q, k, v, g, bounds, causal)
    delta = (g.float() * out_j).sum(-1).transpose(1, 2).contiguous()
    bm, bn = kfa.flash_tile_shape("flash_bwd_dkv", 64, dtype)
    dk, dv = emulate_dkv(q, k, v, bounds, g, lse_j, delta, causal, 1.0 / 64**0.5, bm, bn)
    assert dk.dtype == dtype and dv.dtype == dtype
    lim_k, lim_v = _dkv_limits(q, k, v, bounds, g, lse_j, delta, causal, dtype)
    dk_p, dv_p = kfa.flash_bwd_dkv_plain(*(x.float() for x in (q, k, v)), bounds, g.float(), lse_j, delta, causal)
    _gate(dk, dk_j, lim_k)
    _gate(dv, dv_j, lim_v)
    _gate(dk, dk_p, lim_k)
    _gate(dv, dv_p, lim_v)
    assert _rel_l2(dk, dk_j) <= GRAD_REL_L2[dtype] and _rel_l2(dv, dv_j) <= GRAD_REL_L2[dtype]


WALK_CASES = [(c, causal) for c in (1, 2, 4) for causal in (True, False)]


@pytest.mark.parametrize("c,causal", WALK_CASES, ids=[f"c{c}-{'causal' if k else 'full'}" for c, k in WALK_CASES])
def test_dkv_walk_skips_only_masked_tiles(c, causal):
    """Kernel 16's walk (``dkv_walk``) leaves out only query tiles that are
    fully masked in the dense mask and SKIP in ``flash_tile_classes``: those
    before the causal floor and those at or past the early end. On seeded
    random bounds at the dk/dv tile (``flash_tile_shape``, the same at every
    head dim), Hm 1 and 3, Sq != Sk and ragged S; under C=1 the early end
    cuts some walks."""
    for d in (64, 128, 192, 256):
        for dtype in (torch.bfloat16, torch.float16):
            assert kfa.flash_tile_shape("flash_bwd_dkv", d, dtype) == (64, 64)
    bm, bn = kfa.flash_tile_shape("flash_bwd_dkv", 128)
    rng = np.random.default_rng(50 + 10 * c + causal)
    cut = 0
    for case in range(12):
        hm = 1 if case % 3 else 3
        sq = int(rng.integers(1, 420))
        sk = sq if case % 4 == 0 else int(rng.integers(1, 420))
        bounds = _t(_random_bounds(rng, 2, hm, sq, sk, c))
        walk = dkv_walk(bounds, sq, sk, bm, bn, causal)
        cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
        all_masked, _ = _dense_tile_truth(kfa.flash_masked(sq, sk, causal, bounds, torch.device("cpu")), bm, bn)
        n_qt = cls.shape[2]
        qt = torch.arange(n_qt)[None, None, :, None]
        left_out = (qt < walk[..., 0][:, :, None, :]) | (qt >= walk[..., 1][:, :, None, :])
        assert not (left_out & ~all_masked).any(), f"case {case}: the walk leaves out a visible tile"
        assert not (left_out & (cls != kfa.SKIP)).any(), f"case {case}: the walk disagrees with the classes"
        cut += int((walk[..., 1] < n_qt).sum())
    if c == 1:
        assert cut > 0, "the early end never cut a walk"


def test_the_walk_alone_is_exact_and_p_rounding_shows():
    """The tile walk itself (classes, skips, unmasked FULL tiles, the
    log2-unit softmax) costs nothing: on fp32 inputs the emulated forward
    agrees with the unrounded Pallas forward at fp32 precision. On bf16
    inputs it rounds P, and the distance that leaves is a visible fraction
    of the bf16 gate's limit, so that gate is not vacuous."""
    q, k, v, g, bounds = _inputs(5, 300, 2, 1, 64, torch.bfloat16, 1, 1)
    out_j = _pallas(q, k, v, g, bounds, True)[0]
    exact, _ = emulate_fwd(q.float(), k.float(), v.float(), bounds, True, 1 / 8, 128, 128)
    _gate(exact, out_j, 1e-5 * out_j.abs() + 1e-6)
    limit = _out_limit(q, k, v, bounds, True, out_j, torch.bfloat16)
    got, _ = emulate_fwd(q, k, v, bounds, True, 1 / 8, 128, 128)
    assert float(((got.float() - out_j).abs() / limit).max()) > 0.01


# -- the document mask of the train phase --------------------------------------

def test_document_mask_tiles_and_walk():
    """Two documents, [0, 300) and [300, 512), as the train phase's C=1
    bounds (each column's document end). At 128 x 128: query tile 1 x key
    tile 0 lies inside the first document (FULL), query tile 2 x key tile 1
    holds the boundary at row 300 (PARTIAL), query tile 3 x key tile 0 sees
    only the second document's rows (SKIP). The emulated forward and dq walk
    over them and match the plain versions."""
    ends = np.r_[np.full(300, 300), np.full(212, 512)].astype(np.int32)
    bounds = _t(ends[None, None, :, None])
    cls = kfa.flash_tile_classes(bounds, 512, 512, 128, 128, True)[0, 0]
    assert int(cls[1, 0]) == kfa.FULL and int(cls[2, 1]) == kfa.PARTIAL and int(cls[3, 0]) == kfa.SKIP
    assert int(cls[0, 1]) == kfa.SKIP  # past the causal limit
    visited = int((cls != kfa.SKIP).sum())
    assert visited < int((kfa.flash_tile_classes(None, 512, 512, 128, 128, True) != kfa.SKIP).sum())
    q, k, v, g, _ = _inputs(11, 512, 2, 2, 64, torch.bfloat16)
    out, lse = emulate_fwd(q, k, v, bounds, True, 1 / 8, 128, 128)
    f = [x.float() for x in (q, k, v)]
    out_p, lse_p = kfa.flash_fwd_plain(*f, bounds, True)
    _gate(out, out_p, _out_limit(q, k, v, bounds, True, out_p, torch.bfloat16))
    _gate(lse, lse_p, 1e-5 * lse_p.abs().clamp(min=1.0))
    delta = (g.float() * out_p).sum(-1).transpose(1, 2).contiguous()
    dq = emulate_dq(q, k, v, bounds, g, lse_p, delta, True, 1 / 8, 128, 64)
    dq_p = kfa.flash_bwd_dq_plain(*f, bounds, g.float(), lse_p, delta, True)
    assert _rel_l2(dq, dq_p) <= GRAD_REL_L2[torch.bfloat16]


def test_train_document_mask_skips_most_tiles():
    """The train phase's bounds (2 x 4096 tokens of 128-2048-token
    documents, chip_smoke.py's seed): the forward's 128 x 128 walk and the
    dk/dv kernel's 64 x 64 walk each visit about a third of the causal
    walk's tiles, and every SKIP tile is fully masked in the dense mask."""
    rng = np.random.default_rng(0)
    ends = np.zeros((2, 4096), np.int32)
    for i in range(2):  # chip_smoke.doc_bounds
        pos = 0
        while pos < 4096:
            end = min(4096, pos + int(rng.integers(128, 2049)))
            ends[i, pos:end] = end
            pos = end
    bounds = _t(ends[:, None, :, None])
    cls = kfa.flash_tile_classes(bounds, 4096, 4096, 128, 128, True)
    causal = kfa.flash_tile_classes(None, 4096, 4096, 128, 128, True)
    share = float((cls != kfa.SKIP).sum()) / (2 * float((causal != kfa.SKIP).sum()))
    assert 0.2 < share < 0.5, share
    # the dk/dv walk (64 x 64) visits a like share of the causal walk's tiles
    dkv = kfa.flash_tile_classes(bounds, 4096, 4096, 64, 64, True)
    dkv_causal = kfa.flash_tile_classes(None, 4096, 4096, 64, 64, True)
    dkv_share = float((dkv != kfa.SKIP).sum()) / (2 * float((dkv_causal != kfa.SKIP).sum()))
    assert 0.2 < dkv_share < 0.5, dkv_share
    for bi in range(2):
        all_masked, none_masked = _dense_tile_truth(
            kfa.flash_masked(4096, 4096, True, bounds[bi:bi + 1], torch.device("cpu")), 128, 128)
        assert not ((cls[bi:bi + 1] == kfa.SKIP) & ~all_masked).any()
        assert not ((cls[bi:bi + 1] == kfa.FULL) & ~none_masked).any()


# -- the plain versions at the new dtypes and head dims ------------------------

PLAIN_CASES = [(torch.float16, 64, 2, True), (torch.float16, 128, 4, False),
               (torch.float32, 192, 1, True), (torch.float32, 256, 2, False)]


@pytest.mark.parametrize("dtype,d,c,causal", PLAIN_CASES,
                         ids=[f"{str(t)[6:]}-d{d}-c{c}-{'causal' if k else 'full'}" for t, d, c, k in PLAIN_CASES])
def test_plain_versions_match_pallas_at_new_dtypes_and_head_dims(dtype, d, c, causal):
    """fp16 inputs: both packages compute in fp32 and round each output to
    fp16 once, so they agree to one fp16 ulp (2^-10 of the value, 1e-5
    absolute near 0); fp32 at D 192 and 256: 1e-5, as the suite's fp32
    parity."""
    s = 96
    q, k, v, g, bounds = _inputs(d + c, s, 4, 2, d, dtype, c, 4 if c == 2 else 1, b=2)
    sq, d_ = q.shape[1], q.shape[-1]
    qh, kh, vh, gh = (jnp.moveaxis(jnp.asarray(x.numpy()), 2, 1) for x in (q, k, v, g))
    blk = 32
    qp, kp, vp, gp = (_pad_to(x, 2, blk) for x in (qh, kh, vh, gh))
    idx = None if bounds is None else _pad_to(jnp.asarray(bounds.numpy()), 2, blk)
    kw = dict(sq=sq, sk=sq, scale=1.0 / d_**0.5, causal=causal, blk_q=blk, blk_k=blk, interpret=True)
    out_j, lse_j = _run_fwd(qp, kp, vp, idx, **kw)
    dq_j, dk_j, dv_j = _run_bwd(qp, kp, vp, idx, gp, out_j, lse_j, **kw)

    def back(x):
        return torch.from_numpy(np.array(jnp.moveaxis(x[:, :, :sq], 1, 2)))

    tol = dict(rtol=2.0**-10, atol=1e-5) if dtype == torch.float16 else dict(rtol=1e-5, atol=1e-5)
    out, lse = kfa.flash_fwd_plain(q, k, v, bounds, causal)
    assert out.dtype == dtype
    torch.testing.assert_close(out, back(out_j), **tol)
    torch.testing.assert_close(lse, torch.from_numpy(np.array(lse_j[:, :, :sq, 0])), rtol=1e-5, atol=1e-5)
    lse_t = torch.from_numpy(np.array(lse_j[:, :, :sq, 0]))
    delta = (g.float() * back(out_j).float()).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq_plain(q, k, v, bounds, g, lse_t, delta, causal)
    dk, dv = kfa.flash_bwd_dkv_plain(q, k, v, bounds, g, lse_t, delta, causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == dtype
        torch.testing.assert_close(got, back(want), **tol)


def test_cuda_inputs_rules_on_meta_tensors():
    """fp16 and fp32 (and bf16) q, k, v, g pass the wrappers' checks up to
    the device check, at every head dim in KERNEL_HEAD_DIMS (the template
    instances) and at 576 and 1024 above them (``csrc/flash_deep.cu``: no
    head dim that is a multiple of 64 is refused); mixed dtypes raise."""
    assert kfa.KERNEL_HEAD_DIMS == (64, 128, 192, 256, 320, 384, 448, 512)

    def meta(d, dtype, kdtype=None):
        q = torch.empty((1, 8, 4, d), dtype=dtype, device="meta")
        k = torch.empty((1, 8, 2, d), dtype=kdtype or dtype, device="meta")
        return q, k, k.clone()

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in kfa.KERNEL_HEAD_DIMS:
            q, k, v = meta(d, dtype)
            with pytest.raises(ValueError, match="unsupported device meta"):
                kfa.flash_fwd(q, k, v, None, True)
            lse = torch.empty((1, 4, 8), device="meta")
            with pytest.raises(ValueError, match="unsupported device meta"):
                kfa.flash_bwd_dq(q, k, v, None, q, lse, lse, True)
            with pytest.raises(ValueError, match="unsupported device meta"):
                kfa.flash_bwd_dkv(q, k, v, None, q, lse, lse, True)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in (576, 1024):
            q, k, v = meta(d, dtype)
            lse = torch.empty((1, 4, 8), device="meta")
            with pytest.raises(ValueError, match="unsupported device meta"):
                kfa.flash_fwd(q, k, v, None, True)
            with pytest.raises(ValueError, match="unsupported device meta"):
                kfa.flash_bwd_dq(q, k, v, None, q, lse, lse, True)
            with pytest.raises(ValueError, match="unsupported device meta"):
                kfa.flash_bwd_dkv(q, k, v, None, q, lse, lse, True)
    q, k, v = meta(128, torch.float16, torch.bfloat16)
    with pytest.raises(ValueError, match="share one of bf16, fp16 and fp32"):
        kfa.flash_fwd(q, k, v, None, True)
    q, k, v = meta(128, torch.float64)
    with pytest.raises(ValueError, match="share one of bf16, fp16 and fp32"):
        kfa.flash_fwd(q, k, v, None, True)
