"""The decomposition that kernels 5 and 6 (``csrc/paged_decode.cu``) run on
the card, emulated in PyTorch on the CPU and held against the JAX package.

The CUDA kernel cannot run here, so :func:`emulate_decode` repeats its
arithmetic step for step from the launch plan the wrapper launches with
(``decode_plan``): each slot's ``ceil(lens / BS)`` table entries cut into
contiguous ranges of ``ceil(blocks / ranks)`` (the cluster's ranks, a range
possibly empty), each rank's positions walked in stages of ``stage_rows``
(a stage may span pages), four warps taking a stage's positions in turn
(warp w: w, w + 4, ..., in batches of 4), each with its own fp32 online
softmax on exp2 over q rows scaled in fp32 by ``scale * log2(e)``, the
int8 pool's scales folded into the scores and into p, the warps merged in
warp order and the ranks in rank order, the query heads of a KV head in
row groups and O's columns in slices (``split`` above head dim 512).
It is held against the port's plain versions at the gates ``chip_smoke.py``
holds the card to (``PAGED_TOL``) and against the Pallas kernels in
interpret mode (``paged_flash_decode``, ``paged_flash_decode_fused``) on
numpy-seeded inputs: lengths 0, 1, BS, lengths that end on every rank's
boundary, one shorter than the rank count and a ragged one; garbage table
entries past each slot's used blocks (the emulation indexes the pool with
every entry it reads, so reading one raises); MHA and GQA 32/8; head dims
64, 128 and 576; bf16 and fp32 pools and the int8 pool.

The plan itself is a host function of the shapes and the card's capacity
(never of a length); its ranges, grid and cluster are checked here too.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.incubate.nn.functional.block_attention as jax_ba
from paddle_tpu.kernels import paged_attention as jax_paged

from paddle_tpu_torch.kernels import paged_attention as kpaged

NEG_INF = -1e30
LOG2E = 1.4426950408889634
WARPS = 4  # the kernel's consumer warps
# chip_smoke.py's PAGED_TOL: |got - want| <= atol + rel * max(|got|, |want|)
PAGED_TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float16": (1e-4, 2.0 ** -10), "float32": (2e-5, 1e-5)}

# 8 slots, block 4, MBS 8. Lengths INCLUDE the current token. At 4 ranks: an
# idle slot, one position, one block (BS) that ends rank 0's range, 8 / 12 /
# 16 positions that end ranks 1 / 2 / 3 (one block a rank), 3 positions
# (fewer blocks than ranks: ranks 1-3 empty), and 29 (8 blocks, 2 a rank,
# the last page ragged)
BS, MBS = 4, 8
LENS = np.array([0, 1, 4, 8, 12, 16, 3, 29], np.int32)
GEOMETRIES = [(4, 4), (32, 8)]  # (HQ, HKV): MHA, GQA 32/8
POOLS = ["bf16", "fp32", "int8"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


def rank_range(n_blk: int, ranks: int, rank: int) -> tuple:
    """The table entries ``[blk0, blk1)`` rank ``rank`` walks (the kernel's
    rule: ``ceil(blocks / ranks)`` a rank, in order)."""
    per = -(-n_blk // ranks)
    blk0 = min(rank * per, n_blk)
    return blk0, min(blk0 + per, n_blk)


def emulate_decode(q, key_cache, value_cache, block_tables, seq_lens, scale, plan, k_scale=None, v_scale=None):
    """Kernel 5's arithmetic on the card (kernel 6's after q's rope): ``q``
    ``[B, HQ, D]`` in its dtype T (already roped), the pool in T or int8
    with fp32 scale planes, ``plan`` a :func:`kpaged.decode_plan`. Scores
    are in log2 units (q scaled by ``scale * log2(e)``) and the softmax runs
    on exp2, as the kernel's does. Returns ``[B, HQ, D]`` in T."""
    b, hq, d = q.shape
    _, hkv, bs, _ = key_cache.shape
    g = hq // hkv
    rows, cols, ranks, sp = plan["rows"], plan["columns"], plan["ranks"], plan["stage_rows"]
    qf = (q.float() * (scale * LOG2E)).reshape(b, hkv, g, d)  # q scaled in fp32 once
    out = torch.zeros(b, hkv, g, d)
    for bi in range(b):
        ln = int(seq_lens[bi])
        n_blk = -(-ln // bs)
        for g0 in range(0, g, rows):
            qr = qf[bi, :, g0:g0 + rows]  # [HKV, R, D]
            nr = qr.shape[1]
            for c0 in range(0, d, cols):
                ch = min(cols, d - c0)
                parts = []  # the CTAs' partials, in rank order
                for r in range(ranks):
                    blk0, blk1 = rank_range(n_blk, ranks, r)
                    beg, end = blk0 * bs, min(blk1 * bs, ln)
                    warps = [(torch.full((hkv, nr), NEG_INF), torch.zeros(hkv, nr), torch.zeros(hkv, nr, ch))
                             for _ in range(WARPS)]
                    for p0 in range(beg, end, sp):  # a stage: up to sp positions, possibly over several pages
                        n = min(sp, end - p0)
                        for w in range(min(WARPS, n)):
                            for t0 in range(w, n, 4 * WARPS):  # a batch: positions t0, t0 + 4, ... (up to 4)
                                pos = p0 + torch.arange(t0, min(t0 + 4 * WARPS, n), WARPS)
                                blk = block_tables[bi, pos // bs].long()  # entries below ceil(lens / BS) only
                                m, l, acc = warps[w]
                                k = key_cache[blk, :, pos % bs].float().transpose(0, 1)  # [HKV, n, D]
                                s = torch.einsum("hrd,hnd->hrn", qr, k)
                                if k_scale is not None:
                                    s = s * k_scale[blk, :, pos % bs].T[:, None, :]
                                mx = torch.maximum(m, s.max(-1).values)
                                alpha = torch.exp2(m - mx)
                                p = torch.exp2(s - mx[..., None])
                                l = l * alpha + p.sum(-1)
                                if v_scale is not None:
                                    p = p * v_scale[blk, :, pos % bs].T[:, None, :]
                                v = value_cache[blk, :, pos % bs, c0:c0 + ch].float().transpose(0, 1)
                                acc = acc * alpha[..., None] + torch.einsum("hrn,hnc->hrc", p, v)
                                warps[w] = (mx, l, acc)
                    top = torch.stack([m for m, _, _ in warps]).max(0).values
                    lsum, asum = torch.zeros(hkv, nr), torch.zeros(hkv, nr, ch)
                    for m, l, acc in warps:  # warp order; a warp that saw nothing adds nothing
                        f = torch.where(m > NEG_INF, torch.exp2(m - top), torch.zeros_like(m))
                        lsum, asum = lsum + f * l, asum + f[..., None] * acc
                    parts.append((top, lsum, asum))
                top = torch.stack([m for m, _, _ in parts]).max(0).values
                den, num = torch.zeros(hkv, nr), torch.zeros(hkv, nr, ch)
                for m, l, acc in parts:  # rank order; a rank that saw nothing adds nothing
                    w = torch.where(m > NEG_INF, torch.exp2(m - top), torch.zeros_like(m))
                    den, num = den + w * l, num + w[..., None] * acc
                out[bi, :, g0:g0 + nr, c0:c0 + ch] = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def _tables(rng, nb):
    """Distinct blocks for each slot's used positions; every entry past them
    is out-of-range garbage that must never be dereferenced."""
    used = [-(-int(n) // BS) for n in LENS]
    tables = np.full((len(LENS), MBS), nb + 1000, np.int32) + np.arange(MBS, dtype=np.int32)[None]
    perm = rng.permutation(nb).astype(np.int32)
    at = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[at:at + u]
        at += u
    return tables


def _inputs(seed, hq, hkv, d, pool):
    """numpy-seeded (torch, jax) pairs: q, the fp32 rope rows, the pools
    (the int8 pool through the JAX quantizer), the scale planes, tables and
    lengths."""
    rng = np.random.default_rng(seed)
    nb = sum(-(-int(n) // BS) for n in LENS) + 3
    qdt = "float32" if pool == "fp32" else "bfloat16"

    def pair(a, dtype=qdt):
        return torch.from_numpy(a).to(getattr(torch, dtype)), jnp.asarray(a, getattr(jnp, dtype))

    q = pair(rng.normal(size=(len(LENS), hq, d)).astype(np.float32))
    rope = [pair(f(rng.normal(size=(len(LENS), 1, d))).astype(np.float32), "float32") for f in (np.cos, np.sin)]
    kv = [rng.normal(size=(nb, hkv, BS, d)).astype(np.float32) for _ in range(2)]
    scales = [(None, None), (None, None)]
    if pool == "int8":
        quant = [jax_ba._quantize_kv_rows(jnp.asarray(a)) for a in kv]
        pools = [(torch.from_numpy(np.array(a8)), a8) for a8, _ in quant]
        scales = [(torch.from_numpy(np.array(sc)), sc) for _, sc in quant]
    else:
        pools = [pair(a) for a in kv]
    ints = [(torch.from_numpy(a), jnp.asarray(a)) for a in (_tables(rng, nb), LENS)]
    return q, rope, pools, scales, ints, qdt


def _within(got: torch.Tensor, want, dtype: str) -> None:
    atol, rel = PAGED_TOL[dtype]
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(want, torch.Tensor) else want.float().numpy()
    err = np.abs(g - w)
    limit = atol + rel * np.maximum(np.abs(g), np.abs(w))
    assert (err <= limit).all(), f"max err {err.max()}, worst err/limit {(err / limit).max()}"


def _within_ulp_of_max(got: torch.Tensor, want) -> None:
    """Within one bf16 ulp of the largest output magnitude: the bound the
    suite holds the rope-fused kernels' plain versions to against the
    Pallas interpret kernels in bf16, where XLA on the CPU keeps the rope's
    products unrounded."""
    w = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0, atol=ulp)


def _plan(hq, hkv, d, pool, ranks):
    """The plan at ``ranks``: a card that holds the grid's clusters at once
    up to that cluster size, and not above it."""
    kv_bytes = {"bf16": 2, "fp32": 4, "int8": 1}[pool]
    geo = kpaged.decode_plan(len(LENS), hq, hkv, d, BS, MBS, kv_bytes, None)
    work = geo["groups"] * geo["split"] * hkv * len(LENS)
    cap = tuple(work if r <= ranks else work - 1 for r in range(1, 9))
    plan = kpaged.decode_plan(len(LENS), hq, hkv, d, BS, MBS, kv_bytes, cap)
    assert plan["ranks"] == ranks
    return plan


CASES = [(kernel, hq, hkv, d, pool) for kernel in ("decode", "decode_fused") for hq, hkv in GEOMETRIES
         for d in (64, 128, 576) for pool in POOLS]


@pytest.mark.parametrize("kernel,hq,hkv,d,pool", CASES,
                         ids=[f"{k}-{hq}x{hkv}-d{d}-{p}" for k, hq, hkv, d, p in CASES])
def test_split_decode_matches_interpret_kernel_and_plain(kernel, hq, hkv, d, pool):
    q, rope, pools, scales, ints, qdt = _inputs(d + hq, hq, hkv, d, pool)
    fused = kernel == "decode_fused"
    args = [q] + (rope if fused else []) + pools + ints
    planes = dict(k_scale=scales[0][0], v_scale=scales[1][0])
    want = getattr(jax_paged, f"paged_flash_{kernel}")(*(j for _, j in args), interpret=True,
                                                      k_scale=scales[0][1], v_scale=scales[1][1])
    plain = getattr(kpaged, f"paged_flash_{kernel}_plain")(*(t for t, _ in args), **planes)
    q_in = kpaged.rope_rows(q[0], rope[0][0], rope[1][0]) if fused else q[0]
    plan = _plan(hq, hkv, d, pool, 4)
    got = emulate_decode(q_in, pools[0][0], pools[1][0], *(t for t, _ in ints), 1.0 / d ** 0.5, plan, **planes)
    assert got.dtype == getattr(torch, qdt) and got.shape == q[0].shape
    _within(got, plain, qdt)
    if fused and qdt != "float32":
        _within_ulp_of_max(got, want)
    else:
        _within(got, want, qdt)
    assert not got[0].any() and not plain[0].any()  # a slot of length 0: exact 0


@pytest.mark.parametrize("ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("hq,hkv", GEOMETRIES, ids=["mha", "gqa"])
def test_every_cluster_size_gives_the_plain_result(hq, hkv, ranks):
    """The other cluster sizes the plan can take (3 cuts the ranges
    unevenly; 8 leaves ranks empty in every slot but the longest), bf16 at
    head dim 128."""
    q, _, pools, _, ints, qdt = _inputs(ranks, hq, hkv, 128, "bf16")
    plain = kpaged.paged_flash_decode_plain(q[0], pools[0][0], pools[1][0], *(t for t, _ in ints))
    got = emulate_decode(q[0], pools[0][0], pools[1][0], *(t for t, _ in ints), 128 ** -0.5,
                         _plan(hq, hkv, 128, "bf16", ranks))
    _within(got, plain, qdt)
    assert not got[0].any()


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 8])
def test_rank_ranges_cover_every_used_entry_once(ranks):
    """Every table entry below ``ceil(lens / BS)`` lies in exactly one
    rank's range and no range reaches past it; ranges may be empty (a slot
    shorter than the rank count, or an idle one)."""
    for n_blk in range(0, 3 * MBS + 1):
        seen = []
        for r in range(ranks):
            blk0, blk1 = rank_range(n_blk, ranks, r)
            assert 0 <= blk0 <= blk1 <= n_blk
            seen += list(range(blk0, blk1))
        assert seen == list(range(n_blk))
        empty = [rank_range(n_blk, ranks, r)[0] == rank_range(n_blk, ranks, r)[1] for r in range(ranks)]
        if n_blk < ranks:  # an idle slot, or one shorter than the rank count: the last ranks walk nothing
            assert empty[-1] and not any(empty[:n_blk])


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512, 576, 1024, 4096])
def test_decode_plan_fits_the_card_for_every_batch(d):
    """For B 1-64, MBS 1-128, G 1-8 and caps from one CTA to ten an SM
    (a card of ``ctas`` CTAs holding ``ctas // r`` clusters of r): a
    cluster of 1-8 ranks, at most MBS, the most whose clusters the card
    holds at once (or 1); a grid
    the card takes, a multiple of the cluster; every query head in a row
    group the instances hold (4 rows up to 256 columns, 2 above); O's
    columns whole 64-column units, at most 512 a CTA, covering D; stages
    of at most 32 positions (a stage may span pages), 2 to 8 of them."""
    for b in (1, 2, 7, 8, 64):
        for mbs in (1, 2, 16, 128):
            for g in (1, 2, 3, 4, 8):
                for hkv in (1, 8, 32):
                    for bs, kv_bytes in ((16, 2), (4, 1), (64, 4)):
                        for ctas in (1, 132, 1320):
                            cap = tuple(ctas // r for r in range(1, 9))
                            p = kpaged.decode_plan(b, g * hkv, hkv, d, bs, mbs, kv_bytes, cap)
                            work = p["groups"] * p["split"] * hkv * b
                            assert 1 <= p["ranks"] <= 8 and p["ranks"] <= mbs
                            assert work <= cap[p["ranks"] - 1] or p["ranks"] == 1
                            assert p["ranks"] == min(8, mbs) or work > cap[p["ranks"]]
                            assert p["grid"] == (work // (hkv * b) * p["ranks"], hkv, b)
                            assert p["grid"][0] % p["ranks"] == 0 and p["grid"][0] < 2 ** 31
                            assert p["grid"][1] < 65536 and p["grid"][2] < 65536
                            assert p["rows"] * p["groups"] >= g and p["rows"] * (p["groups"] - 1) < g
                            assert p["rows"] == 1 or p["rows"] <= (4 if p["columns"] <= 256 else 2)
                            assert p["columns"] % 64 == 0 and p["columns"] <= kpaged.DECODE_MAX_COLUMNS
                            assert (p["split"] - 1) * p["columns"] < d <= p["split"] * p["columns"]
                            assert 1 <= p["stage_rows"] <= kpaged.DECODE_STAGE_ROWS and 2 <= p["stages"] <= 8


@pytest.mark.parametrize("fused", [True, False], ids=["6", "5"])
@pytest.mark.parametrize("d,int8", [(128, False), (576, False), (128, True)])
def test_decode_wrappers_launch_with_decode_plan(monkeypatch, fused, d, int8):
    """Kernels 5 and 6 launch with ``decode_plan`` on the card's cap (asked
    of the instance of q's type, the pool, the rope and the plan's stage
    geometry): the launch's int dims after MBS are the plan's rows, split,
    columns, ranks, stage rows and stages, and two batches of other lengths
    launch with the same dims (the plan reads no length), the cap asked
    once for both (the plan is made once per instance and shapes). Meta
    tensors stand in for the card's; the launch is recorded, not run."""
    b, hq, hkv, bs, mbs = 8, 32, 8, 16, 128
    cap = tuple(132 * 9 // r for r in range(1, 9))
    meta = torch.device("meta")
    q = torch.empty((b, hq, d), dtype=torch.bfloat16, device=meta)
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    kc = torch.empty((64, hkv, bs, d), dtype=kv_dtype, device=meta)
    tables = torch.empty((b, mbs), dtype=torch.int32, device=meta)
    pools = [kc, kc] + [torch.empty((64, hkv, bs), device=meta)] * 2 * int8
    asked, launched = [], []
    monkeypatch.setattr(kpaged, "_io_dtype", lambda what, x: 1)
    monkeypatch.setattr(kpaged, "_rope_operands", lambda what, q_, cos, sin, shape: (cos, sin))
    monkeypatch.setattr(kpaged, "_decode_cap", lambda *key: asked.append(key) or cap)
    # a cache of its own: no plan made under another cap, and none left behind
    monkeypatch.setattr(kpaged, "_decode_plan_on", functools.lru_cache(maxsize=None)(
        kpaged._decode_plan_on.__wrapped__))
    monkeypatch.setattr(kpaged, "_launch", lambda name, io, ptrs, dims, scale, dev: launched.append((name, dims)))
    planes = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    rows = torch.empty((b, 1, d), device=meta)
    for lens in (torch.zeros(b, dtype=torch.int32, device=meta), torch.ones(b, dtype=torch.int32, device=meta)):
        monkeypatch.setattr(kpaged, "_launch_operands", lambda *a, _l=lens, **k: (1, q, pools, tables, _l))
        if fused:
            kpaged.paged_flash_decode_fused(q, rows, rows, kc, kc, tables, lens, **planes)
        else:
            kpaged.paged_flash_decode(q, kc, kc, tables, lens, **planes)
    plan = kpaged.decode_plan(b, hq, hkv, d, bs, mbs, 1 if int8 else 2, cap)
    geo = (plan["rows"], plan["columns"], plan["stage_rows"], plan["stages"])
    assert asked == [(meta, 1, int8, fused, d, *geo)]
    name = ("paged_decode_fused" if fused else "paged_decode") + "_int8" * int8
    dims = (b, hq, hkv, d, bs, mbs, plan["rows"], plan["split"], plan["columns"], plan["ranks"],
            plan["stage_rows"], plan["stages"])
    assert launched == [(name, dims)] * 2
    assert plan["ranks"] == (8 if d == 128 else 4)
