"""The decomposition that kernels A and 4 (``csrc/paged_chunk_fused.cu``) run
on the card, emulated in PyTorch on the CPU and held against the JAX package.

The CUDA kernel cannot run here, so this file repeats its arithmetic step
for step in :func:`emulate_chunk`: packed GQA rows in tiles of 64, each
tile's used blocks split over the cluster's ranks (``ceil(blocks /
ranks)`` blocks a rank; 8 and 2 ranks here), each rank's online softmax
over steps of 16 positions, p split into two halves rounded to q's dtype before
the PV product (one rounding fails the card's gates, see below), the int8
pool's scales folded into the scores and into p, and the ranks' partials
merged in rank order. The emulation is held against the port's plain
versions and the Pallas kernels in interpret mode
(``paged_flash_chunk_fused``, ``paged_flash_chunk``) on numpy-seeded
inputs at the gates ``chip_smoke.py`` holds the card to (``PAGED_TOL``);
against the interpret kernel A in bf16 / fp16 at one ulp of the largest
output, since XLA on the CPU ropes q there without rounding its products. The batch has a rank
with an empty range, rows fully masked within a rank, lengths on exact
multiples of the block size, a length of 1, an idle slot, garbage table
entries past the used blocks (the emulation indexes the pool with them, so
reading one raises), GQA 4 and head dims 64, 128 and 256, in bf16 and fp16
with a pool of q's dtype and an int8 pool, and in fp32.

The plain versions at head dim 256 are also held against the interpret
kernels directly (the head dims of the redesign: 64 to 256). Above 256 the
kernels split O's columns over two CTAs and fp32 tiles hold 32 rows
(``chunk_plan``); the emulation repeats that at head dims 320 and 512.
Above 512 (``csrc/paged_chunk_deep.cu``) ``ceil(D / 256)`` CTAs share O's
columns, q stays resident and the tile rows are what fits the shared-memory
budget (``chunk_geometry``, mirrored here byte for byte at head dims 576 to
2048); the emulation repeats that at 576 and 640.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.incubate.nn.functional.block_attention as jax_ba
from paddle_tpu.kernels import paged_attention as jax_paged

from paddle_tpu_torch.kernels import paged_attention as kpaged

NEG_INF = -1e30
ROWS, STEP, MAX_RANKS = 64, 16, 8  # the kernel's row tile, positions a step, most CTAs a cluster
# chip_smoke.py's PAGED_TOL: |got - want| <= atol + rel * max(|got|, |want|)
PAGED_TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float16": (1e-4, 2.0 ** -10), "float32": (2e-5, 1e-5)}

# 5 slots, chunk width 8, block 4, MBS 16. Lengths EXCLUDE the chunk.
C, BS, MBS = 8, 4, 16
LENS = np.array([0, 31, 0, 9, 45], np.int32)
Q_LENS = np.array([8, 1, 1, 0, 3], np.int32)
# At 8 ranks: slot 0 has 8 positions, 2 blocks, per 1: ranks 2-7 empty, rows 0-3 fully
# masked in rank 1; slot 1 32 positions, 8 whole blocks, one a rank; slot 2 length 1;
# slot 3 is idle; slot 4 48 positions, 12 blocks, per 2: ranks 6-7 empty
GEOMETRIES = [(64, 4, 4), (128, 8, 2), (256, 4, 4)]  # (D, HQ, HKV)
GEOMETRY_IDS = ["d64-mha", "d128-gqa4", "d256-mha"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


def emulate_chunk(q, key_cache, value_cache, block_tables, seq_lens, q_lens, scale, k_scale=None, v_scale=None,
                  ranks=MAX_RANKS, rows=ROWS, split=1, columns=None, round_p=True):
    """Kernel 4's arithmetic on the card (kernel A's after q's rope): ``q``
    ``[B, C, HQ, D]`` in its dtype T, the pool in T or int8 with fp32 scale
    planes, ``ranks`` CTAs a cluster (at most MBS; the card picks 8, 4, 2
    or 1 from its occupancy), tiles of ``rows`` packed rows, and O's
    columns over ``split`` CTAs of ``columns`` each (``kpaged.chunk_plan``'s:
    2 above head dim 256, ``ceil(D / 256)`` above 512, each computing the
    scores over all of D and PV over its own columns of V). ``round_p``:
    p split into two halves rounded to T before PV (the bf16 / fp16
    instances, tensor cores); off, p stays fp32 (the CUDA-core walks of
    fp32). Returns ``[B, C, HQ, D]`` in T."""
    if split > 1:
        dv = columns or value_cache.shape[-1] // split
        return torch.cat([emulate_chunk(q, key_cache, value_cache[..., i * dv:(i + 1) * dv], block_tables, seq_lens,
                                        q_lens, scale, k_scale, v_scale, ranks, rows, round_p=round_p)
                          for i in range(split)], -1)
    dt = q.dtype
    b, c, hq, d = q.shape
    nb, hkv, bs, _ = key_cache.shape
    dv = value_cache.shape[-1]
    g = hq // hkv
    ranks = max(1, min(ranks, block_tables.shape[1]))
    packed = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(b, hkv, c * g, d).float()
    out = torch.zeros(b, hkv, c * g, dv)
    for bi in range(b):
        ln, ql = int(seq_lens[bi]), int(q_lens[bi])
        for row0 in range(0, c * g, rows):
            if row0 // g >= ql:
                continue  # every row past q_lens: exact 0, nothing read
            nr = min(rows, c * g - row0)
            j = (row0 + torch.arange(nr)) // g
            n_pos = ln + min((row0 + nr - 1) // g, ql - 1) + 1
            per = -(-(-(-n_pos // bs)) // ranks)
            qt = packed[bi, :, row0:row0 + nr]  # [HKV, rows, D]
            parts = []  # in rank order
            for r in range(ranks):
                beg, end = r * per * bs, min((r + 1) * per * bs, n_pos)
                m, l, acc = torch.full((hkv, nr), NEG_INF), torch.zeros(hkv, nr), torch.zeros(hkv, nr, dv)
                for p0 in range(beg, end, STEP):
                    pos = torch.arange(p0, min(p0 + STEP, end))  # positions past the range are zero-filled
                    blk = block_tables[bi, pos // bs].long()  # no entry at or past ceil(end / BS)
                    k = key_cache[blk, :, pos % bs].float().transpose(0, 1)  # [HKV, n, D]
                    v = value_cache[blk, :, pos % bs].float().transpose(0, 1)
                    s = qt @ k.transpose(1, 2)  # q unscaled, fp32 accumulate
                    if k_scale is not None:
                        s = s * k_scale[blk, :, pos % bs].T[:, None, :]
                    s = s * scale
                    valid = (pos[None, :] < ln + j[:, None] + 1) & (j[:, None] < ql)
                    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
                    l, m = l * alpha + p.sum(-1), m_new
                    if v_scale is not None:
                        p = p * v_scale[blk, :, pos % bs].T[:, None, :]
                    if round_p:
                        hi = p.to(dt).float()  # p = hi + lo, each rounded to T
                        lo = (p - hi).to(dt).float()
                        acc = acc * alpha[..., None] + (hi @ v + lo @ v)
                    else:
                        acc = acc * alpha[..., None] + p @ v
                parts.append((m, l, acc))
            top = torch.stack([pm for pm, _, _ in parts]).max(0).values
            den, num = torch.zeros(hkv, nr), torch.zeros(hkv, nr, dv)
            for pm, pl, pa in parts:  # rank order; a rank with no valid position adds nothing
                w = torch.where(pm > NEG_INF, torch.exp(pm - top), torch.zeros_like(pm))
                den, num = den + w * pl, num + w[..., None] * pa
            res = num / torch.clamp(den, min=1e-30)[..., None]
            out[bi, :, row0:row0 + nr] = torch.where((j < ql)[None, :, None], res, torch.zeros_like(res))
    return out.reshape(b, hkv, c, g, dv).permute(0, 2, 1, 3, 4).reshape(b, c, hq, dv).to(dt)


def _inputs(rng, d, hq, hkv, dtype, int8):
    """numpy-seeded inputs as (torch, jax) pairs, tables with garbage past
    each slot's used blocks, and the int8 pool through the JAX quantizer."""
    used = [-(-(int(n) + int(m)) // BS) if m else 0 for n, m in zip(LENS, Q_LENS)]
    nb = sum(used) + 3
    tables = np.full((len(LENS), MBS), nb + 1000, np.int32)
    tables[:, :] += np.arange(MBS, dtype=np.int32)[None]
    perm = rng.permutation(nb).astype(np.int32)
    at = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[at:at + u]
        at += u
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def pair(a):
        return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)

    q = pair(rng.normal(size=(len(LENS), C, hq, d)).astype(np.float32))
    cos = np.cos(rng.normal(size=(len(LENS), C, d))).astype(np.float32)
    sin = np.sin(rng.normal(size=(len(LENS), C, d))).astype(np.float32)
    rope = [(torch.from_numpy(a), jnp.asarray(a)) for a in (cos, sin)]  # fp32, as the engine gathers them
    kv = [rng.normal(size=(nb, hkv, BS, d)).astype(np.float32) for _ in range(2)]
    scales = [(None, None), (None, None)]
    if int8:
        quant = [jax_ba._quantize_kv_rows(jnp.asarray(a)) for a in kv]
        pools = [(torch.from_numpy(np.array(a8)), a8) for a8, _ in quant]
        scales = [(torch.from_numpy(np.array(sc)), sc) for _, sc in quant]
    else:
        pools = [pair(a) for a in kv]
    ints = [(torch.from_numpy(a), jnp.asarray(a)) for a in (tables, LENS, Q_LENS)]
    return q, rope, pools, ints, scales


def _within(got: torch.Tensor, want, dtype: str) -> None:
    atol, rel = PAGED_TOL[dtype]
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(want, torch.Tensor) else want.float().numpy()
    err = np.abs(g - w)
    limit = atol + rel * np.maximum(np.abs(g), np.abs(w))
    assert (err <= limit).all(), f"max err {err.max()}, worst err/limit {(err / limit).max()}"


def _within_ulp_of_max(got: torch.Tensor, want) -> None:
    """Within one ulp (of got's type) of the largest output magnitude: the
    bound the suite holds kernel A's plain version to against the Pallas
    interpret kernel in bf16 / fp16, where XLA on the CPU keeps the rope's
    products unrounded (``tests/test_fused_decode_layer.py``'s bitwise
    chunk tests fail on that)."""
    w = np.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - (7 if got.dtype == torch.bfloat16 else 10))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0, atol=ulp)


CASES = [(dt, int8) for dt in ("bfloat16", "float16") for int8 in (False, True)] + [("float32", False)]
CASE_IDS = ["bf16", "bf16-int8", "fp16", "fp16-int8", "fp32"]


@pytest.mark.parametrize("ranks", [8, 2])
@pytest.mark.parametrize("dtype,int8", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
@pytest.mark.parametrize("kernel", ["chunk_fused", "chunk"])
def test_split_decomposition_matches_interpret_kernel_and_plain(kernel, geometry, dtype, int8, ranks):
    d, hq, hkv = geometry
    rng = np.random.default_rng(11)
    q, rope, pools, ints, scales = _inputs(rng, d, hq, hkv, dtype, int8)
    fused = kernel == "chunk_fused"
    head = [q] + (rope if fused else [])
    args = head + pools + ints
    planes = dict(k_scale=scales[0][0], v_scale=scales[1][0])
    want = getattr(jax_paged, f"paged_flash_{kernel}")(*(j for _, j in args), interpret=True,
                                                      k_scale=scales[0][1], v_scale=scales[1][1])
    plain = getattr(kpaged, f"paged_flash_{kernel}_plain")(*(t for t, _ in args), **planes)
    q_in = kpaged.rope_rows(q[0], rope[0][0][:, :, None], rope[1][0][:, :, None]) if fused else q[0]
    got = emulate_chunk(q_in, pools[0][0], pools[1][0], *(t for t, _ in ints), 1.0 / d ** 0.5, **planes, ranks=ranks)
    assert got.dtype == getattr(torch, dtype)
    _within(got, plain, dtype)
    if fused and dtype != "float32":
        _within_ulp_of_max(got, want)
    else:
        _within(got, want, dtype)
    past = torch.arange(C)[None, :] >= torch.from_numpy(Q_LENS)[:, None].long()
    assert not got[past].any() and not plain[past].any()  # rows past q_lens: exact 0


WIDE_CASES = [(d, dt, int8) for d in (320, 512, 576) for dt, int8 in (("bfloat16", False), ("bfloat16", True),
                                                                       ("float32", False))]
WIDE_CASES += [(576, "float16", False), (640, "bfloat16", False)]
DT_IDS = {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}


@pytest.mark.parametrize("kernel", ["chunk_fused", "chunk"])
@pytest.mark.parametrize("d,dtype,int8", WIDE_CASES, ids=[f"d{d}-{DT_IDS[dt]}{'-int8' * i}" for d, dt, i in WIDE_CASES])
def test_column_split_above_256_matches_interpret_kernel_and_plain(kernel, d, dtype, int8):
    """Head dims 320 and 512: the kernels' column split (two CTAs, each the
    scores over all of D and PV, the merge and the writes over half of O's
    columns) and their tile rows (``chunk_plan``: 64, or 32 for fp32), at 8
    and 2 ranks, against the plain version at the card's gate and the
    interpret kernel as in the narrower cases. Head dims 576 and 640: the
    runtime instance (``csrc/paged_chunk_deep.cu``): three CTAs of 192
    columns (640: 256, 256 and the last 128), q resident, 64-row tiles (640
    and fp32: 32), p split into two halves of T in bf16 / fp16 as below
    512."""
    rng = np.random.default_rng(d)
    q, rope, pools, ints, scales = _inputs(rng, d, 8, 2, dtype, int8)
    fused = kernel == "chunk_fused"
    args = [q] + (rope if fused else []) + pools + ints
    planes = dict(k_scale=scales[0][0], v_scale=scales[1][0])
    want = getattr(jax_paged, f"paged_flash_{kernel}")(*(j for _, j in args), interpret=True,
                                                      k_scale=scales[0][1], v_scale=scales[1][1])
    plain = getattr(kpaged, f"paged_flash_{kernel}_plain")(*(t for t, _ in args), **planes)
    q_in = kpaged.rope_rows(q[0], rope[0][0][:, :, None], rope[1][0][:, :, None]) if fused else q[0]
    tdt = getattr(torch, dtype)
    base = kpaged.chunk_plan(len(LENS), C, 8, 2, d, tdt, MBS, cap=1, kv_int8=int8)
    deep = d > kpaged.CHUNK_HEAD_DIMS[-1]
    for ranks in (8, 2):  # a card holding ranks clusters of the grid's (tile, column slice, KV head, slot) items
        cap = ranks * base["tiles"] * base["split"] * 2 * len(LENS) // (kpaged.CHUNK_DEEP_WAVES if deep else 1)
        plan = kpaged.chunk_plan(len(LENS), C, 8, 2, d, tdt, MBS, cap=cap, kv_int8=int8)
        want_split = {576: (3, 192), 640: (3, 256)}[d] if deep else (2, d // 2)
        want_rows = 32 if dtype == "float32" or d == 640 else 64  # 640: half of 64, two CTAs an SM
        assert (plan["split"], plan["columns"], plan["rows"]) == (*want_split, want_rows) and plan["ranks"] == ranks
        got = emulate_chunk(q_in, pools[0][0], pools[1][0], *(t for t, _ in ints), 1.0 / d ** 0.5, **planes,
                            ranks=plan["ranks"], rows=plan["rows"], split=plan["split"], columns=plan["columns"],
                            round_p=dtype != "float32")
        assert got.dtype == tdt and got.shape == q_in.shape
        _within(got, plain, dtype)
        if fused and dtype != "float32":
            _within_ulp_of_max(got, want)
        else:
            _within(got, want, dtype)
        past = torch.arange(C)[None, :] >= torch.from_numpy(Q_LENS)[:, None].long()
        assert not got[past].any()  # rows past q_lens: exact 0


# (head dim, split, columns, tile rows in bf16 / fp16 and over the int8 pool, tile rows in fp32)
DEEP_PLANS = [(576, 3, 192, 64, 32), (640, 3, 256, 32, 32), (1024, 4, 256, 32, 32), (1280, 5, 256, 64, 16),
              (1536, 6, 256, 16, 16), (2048, 8, 256, 16, 16)]
STORAGES = [("bfloat16", False), ("float16", False), ("float32", False), ("bfloat16", True)]


@pytest.mark.parametrize("dtype,int8", STORAGES, ids=["bf16", "fp16", "fp32", "bf16-int8"])
@pytest.mark.parametrize("d,split,columns,rows16,rows32", DEEP_PLANS, ids=[f"d{p[0]}" for p in DEEP_PLANS])
def test_chunk_plan_above_512_fits_the_deep_instance(d, split, columns, rows16, rows32, dtype, int8):
    """``chunk_plan`` above head dim 512 at the wide_heads serve step (8
    slots, chunk 64, GQA 8/2, MBS 128): ``ceil(D / 256)`` CTAs of whole
    64-column units, and tile rows whose layout in
    ``csrc/paged_chunk_deep.cu`` fits the 200 KB budget, counted here from
    its pieces: q resident in its own type (rows x (D + 16 bytes)), a ring of
    4 slots (else 3) of 16 positions x 256 columns of the pool's type (the
    int8 pool's slots also carry 32 fp32 scales), and for the int8 pool two
    slots upcast to q's type; the merge's fp32 partials reuse the bytes. The
    rows are the most that fit (64, 32, 16; fp32 32, 16), or in bf16 / fp16
    half of them where only the half's layout is one of which an SM holds
    two CTAs (108 KB)."""
    tdt = getattr(torch, dtype)
    t = torch.empty((), dtype=tdt).element_size()
    kv = 1 if int8 else t
    plan = kpaged.chunk_plan(8, 64, 8, 2, d, tdt, 128, 132 * 2, kv_int8=int8)
    rows = rows32 if t == 4 else rows16
    assert (plan["split"], plan["columns"], plan["rows"], plan["walk"]) == (split, columns, rows, "resident")
    assert (split - 1) * columns < d <= split * columns
    assert plan["tiles"] == -(-64 * 4 // rows) and plan["grid"] == (plan["tiles"] * split * plan["ranks"], 2, 8)

    budget, pair = 200 * 1024, 108 * 1024

    def layout(r):  # (bytes, slots) with 4 ring slots, else 3
        q_bytes = r * (d + 16 // t) * t
        slot = 16 * (256 + 16 // kv) * kv + (2 * 16 * 4 if int8 else 0)
        upcast = 2 * 16 * (256 + 16 // t) * t if int8 else 0
        sizes = [max(q_bytes + n * slot + upcast, r * (256 + 8) * 4) for n in (4, 3)]
        return (sizes[0], 4) if sizes[0] <= budget else (sizes[1], 3)

    assert (plan["smem"], plan["slots"]) == layout(rows) and plan["smem"] <= budget
    most = next(r for r in ((32, 16) if t == 4 else (64, 32, 16)) if layout(r)[0] <= budget)
    halved = t == 2 and layout(most)[0] > pair >= layout(most // 2)[0]
    assert rows == (most // 2 if halved else most)


def test_chunk_plan_rows_asked_above_512():
    """The walk above 512 takes other tile rows when asked (chip_smoke.py
    times 64 against 32 at D 1024, where the plan takes 32) and refuses rows
    whose layout does not fit; up to 512 only the instance's own rows
    exist."""
    plan = kpaged.chunk_plan(8, 64, 8, 2, 1024, torch.bfloat16, 128, 132, rows=64)
    assert (plan["rows"], plan["tiles"], plan["slots"]) == (64, 4, 4) and plan["smem"] == 64 * 1032 * 2 + 4 * 8448
    own = kpaged.chunk_plan(8, 64, 8, 2, 1024, torch.bfloat16, 128, 264)
    assert (own["rows"], own["tiles"], own["ranks"]) == (32, 8, 2)
    assert kpaged.chunk_geometry(4096, torch.bfloat16, rows=32) is None
    assert kpaged.chunk_geometry(512, torch.bfloat16, rows=32) is None
    assert kpaged.chunk_geometry(512, torch.bfloat16, rows=64)["rows"] == 64
    with pytest.raises(ValueError, match="cannot hold tiles of 32 rows"):
        kpaged.chunk_plan(8, 64, 8, 2, 4096, torch.bfloat16, 128, 264, rows=32)
    # where not even 16 rows of q fit, the chunked walk (64 rows, no ring)
    far = kpaged.chunk_geometry(2688, torch.float32)
    assert (far["walk"], far["rows"], far["slots"]) == ("chunked", 64, 0)
    assert kpaged.chunk_geometry(5312, torch.bfloat16)["walk"] == "resident"


def test_one_rounding_of_p_misses_the_bf16_gate():
    """Why the kernel splits p: with p rounded once to bf16 before the PV
    product, a long row of the emulated walk leaves the plain version's
    fp32 softmax by more than ``1e-4 + 2^-7 |x|``; the split stays within."""
    rng = np.random.default_rng(3)
    d, hkv, n = 128, 2, 592
    q = torch.from_numpy(rng.normal(size=(1, 1, hkv, d)).astype(np.float32)).bfloat16()
    kc, vc = (torch.from_numpy(rng.normal(size=(n // 16, hkv, 16, d)).astype(np.float32)).bfloat16() for _ in "kv")
    tables = torch.arange(n // 16, dtype=torch.int32)[None]
    lens, qlens = torch.tensor([n - 1], dtype=torch.int32), torch.tensor([1], dtype=torch.int32)
    plain = kpaged.paged_flash_chunk_plain(q, kc, vc, tables, lens, qlens).float()
    split = emulate_chunk(q, kc, vc, tables, lens, qlens, 1 / d ** 0.5).float()
    # one rounding: p itself in bf16, the same walk otherwise
    s = (q.float()[0, 0, :, None] @ kc.float().permute(1, 0, 2, 3).reshape(hkv, n, d).transpose(1, 2)) / d ** 0.5
    p = torch.softmax(s, dim=-1)  # [HKV, 1, n]
    once = (p.bfloat16().float() @ vc.float().permute(1, 0, 2, 3).reshape(hkv, n, d))[:, 0].bfloat16().float()
    atol, rel = PAGED_TOL["bfloat16"]
    limit = atol + rel * torch.maximum(plain[0, 0].abs(), once.abs())
    assert ((once - plain[0, 0]).abs() > limit).any()
    _within(split, plain, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["chunk_fused", "chunk"])
def test_plain_versions_at_head_dim_256_match_interpret_kernels(kernel, dtype):
    rng = np.random.default_rng(7)
    q, rope, pools, ints, _ = _inputs(rng, 256, 8, 2, dtype, False)
    args = [q] + (rope if kernel == "chunk_fused" else []) + pools + ints
    want = getattr(jax_paged, f"paged_flash_{kernel}")(*(j for _, j in args), interpret=True)
    got = getattr(kpaged, f"paged_flash_{kernel}_plain")(*(t for t, _ in args))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    elif kernel == "chunk_fused":
        _within_ulp_of_max(got, want)
    else:
        _within(got, want, dtype)


def test_rope_rows_reach_the_kernel_in_fp32_without_a_cast():
    """The engine's fp32 rope rows go to kernels A and 6 as they are (no
    cast kernel); a bf16 row widens exactly. The kernels round them to q's
    dtype in registers, which is ``rope_rows``' ``cos.to(q.dtype)``."""
    q = torch.zeros((2, 3, 4, 64), dtype=torch.bfloat16)
    cos, sin = torch.rand((2, 3, 64)), torch.rand((2, 3, 64))
    cos32, sin32 = kpaged._rope_operands("t", q, cos, sin, (2, 3, 64))
    assert cos32.data_ptr() == cos.data_ptr() and sin32.data_ptr() == sin.data_ptr()
    cos_b = cos.bfloat16()
    widened, _ = kpaged._rope_operands("t", q, cos_b, sin.bfloat16(), (2, 3, 64))
    assert widened.dtype == torch.float32 and torch.equal(widened.bfloat16(), cos_b)
    with pytest.raises(ValueError, match="rope rows"):
        kpaged._rope_operands("t", q, cos[:, :2], sin, (2, 3, 64))


def test_head_dims_of_each_kernel():
    """A, 4, 5 and 6 take every multiple of 64 on the card, as the JAX
    package's ``D % 64`` gate sends them to its kernels: A and 4 as template
    instances up to 512 and one runtime instance above (whose column split
    ``_chunk_columns`` gives), 5 and 6 with D a runtime value whose column
    split ``decode_plan`` gives."""
    assert kpaged.CHUNK_HEAD_DIMS == (64, 128, 192, 256, 320, 384, 448, 512)
    assert not hasattr(kpaged, "DECODE_HEAD_DIMS")
    for d in range(64, 4097, 64):
        split, cols = kpaged._chunk_columns(d)
        assert cols % 64 == 0 or d <= kpaged.CHUNK_HEAD_DIMS[-1]
        assert (split - 1) * cols < d <= split * cols and cols <= kpaged.CHUNK_MAX_COLUMNS
        plan = kpaged.decode_plan(8, 32, 8, d, 16, 128, 2, (1000,) * 8)
        assert (plan["split"] - 1) * plan["columns"] < d <= plan["split"] * plan["columns"]
        assert plan["columns"] % 64 == 0 and plan["columns"] <= kpaged.DECODE_MAX_COLUMNS
