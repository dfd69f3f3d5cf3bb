"""Kernels A and 4 sum a query row's history in an order set by its
positions alone, so the prefix cache's warm tail decodes as the cold
prefill does.

The kernels (``csrc/paged_chunk.cuh``, ``csrc/paged_chunk_deep.cu``) split
each row tile's history over a cluster of ranks: the 16-position tile ``t``
is rank ``t % ranks``'s, walked in increasing order, whatever the chunk
start, ``lens``, ``q_lens`` or the tile's causal limit
(``kpaged.chunk_rank_tiles`` is the host mirror). The mirror is checked for
every ``lens`` in 0..80 and ``q_lens`` in 1..24 at block sizes 4 and 16; then
the kernels' arithmetic, emulated step for step by
``test_torch_paged_split.emulate_chunk``, is held to the same bits for the
same rows at three chunk starts (the card's ``same_row_readings``).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as kpaged

from test_torch_paged_split import STEP, emulate_chunk


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests share CPU workers with timing-sensitive JAX tests."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prior)


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_each_position_has_one_rank_and_place_whatever_the_chunk(bs, g):
    """For every row of every chunk, each position up to the row's own
    limit lies in rank ``(p // 16) % ranks`` at place ``(p // 16) // ranks``
    of that rank's walk, every tile a rank walks before it starts at or
    below the row's limit, and the table entries read stay below
    ``ceil((lens + q_lens) / BS)``."""
    rows = 64  # packed query rows a tile
    for ranks in (1, 2, 4, 8):
        for lens in range(81):
            for q_lens in range(1, 25):
                used = -(-(lens + q_lens) // bs)
                for row0 in range(0, q_lens * g, rows):
                    last = min(row0 + rows, q_lens * g) - 1
                    walks = kpaged.chunk_rank_tiles(lens, q_lens, last, ranks, g)
                    n_pos = lens + last // g + 1
                    assert sorted(t for w in walks for t in w) == list(range(-(-n_pos // STEP)))
                    for rank, walk in enumerate(walks):
                        assert walk == sorted(walk) and all(t % ranks == rank for t in walk)
                        assert all((min(t * STEP + STEP, n_pos) - 1) // bs < used for t in walk)
                    for j in range(row0 // g, last // g + 1):
                        limit = lens + j + 1  # the row attends to positions < limit
                        for p in range(limit):
                            t = p // STEP
                            assert walks[t % ranks].index(t) == t // ranks
                        for walk in walks:  # a row's valid tiles lead its rank's walk
                            mine = [t * STEP < limit for t in walk]
                            assert mine == sorted(mine, reverse=True)


def _same_rows_batch(rng, d, hq, hkv, dtype, int8):
    """Three slots holding the same history (shared blocks of 16) and the
    same query rows for positions 100-107: 8 rows at lens 100, 36 at lens 72
    and 48 at lens 96 (chunk width 48)."""
    bs, mbs, c = 16, 10, 48
    starts, q_lens = (100, 72, 96), (8, 36, 48)
    nb = mbs
    tables = torch.arange(mbs, dtype=torch.int32)[None].repeat(3, 1)
    kv = [torch.from_numpy(rng.normal(size=(nb, hkv, bs, d)).astype(np.float32)) for _ in range(2)]
    hist_q = torch.from_numpy(rng.normal(size=(c + 100, hq, d)).astype(np.float32))
    q = torch.zeros(3, c, hq, d)
    for i, (n, m) in enumerate(zip(starts, q_lens)):
        q[i, :m] = hist_q[n:n + m]
    planes = {}
    if int8:
        amax = torch.stack(kv).abs().amax(-1).clamp(min=1e-6)  # [2, NB, HKV, BS]
        pools = [torch.round(a / (s / 127.0)[..., None]).clamp(-127, 127).to(torch.int8) for a, s in zip(kv, amax)]
        planes = {"k_scale": amax[0] / 127.0, "v_scale": amax[1] / 127.0}
    else:
        pools = [a.to(dtype) for a in kv]
    return (q.to(dtype), pools[0], pools[1], tables, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(q_lens, dtype=torch.int32), planes)


@pytest.mark.parametrize("ranks", [8, 2])
@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)],
                         ids=["bf16", "bf16-int8", "fp32"])
def test_same_rows_get_the_same_bits_at_three_chunk_starts(ranks, dtype, int8):
    """Positions 100-107 at lens 100, 72 and 96: the three chunks' tiles end
    at causal limits 108, 108 and 144 (7, 7 and 9 blocks of 16), where the
    old contiguous split (a range of ceil(blocks / ranks) blocks a rank, cut
    at that limit) put them in other ranks at the third start."""
    q, kc, vc, tables, lens, q_lens, planes = _same_rows_batch(np.random.default_rng(26), 64, 2, 2, dtype, int8)
    out = emulate_chunk(q, kc, vc, tables, lens, q_lens, 1.0 / 8.0, ranks=ranks, round_p=dtype != torch.float32,
                        **planes)
    ref = out[0, :8]
    assert torch.equal(out[1, 28:36], ref) and torch.equal(out[2, 4:12], ref)
    assert not out[0, 8:].any() and not out[1, 36:].any()
