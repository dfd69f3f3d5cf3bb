"""Paged attention over the serving KV cache: CUDA kernels and their plain
versions.

Port of ``paddle_tpu/kernels/paged_attention.py``. The cache is one
``[NB, HKV, BS, D]`` key pool and one value pool, addressed by ``[B, MBS]``
block tables; keys are stored roped. Four kernels:

- ``paged_flash_chunk_fused`` (kernel A, ``_chunk_fused_kernel``): a mixed
  ragged chunk — each slot carries up to ``C`` new query tokens (a decode
  row has ``q_lens == 1``, a prompt chunk up to ``C``, an idle slot 0).
  Query row ``j`` of slot ``b`` is roped (neox, in q's dtype) and attends
  over positions ``< lens[b] + j + 1``; rows ``j >= q_lens[b]`` are exact
  zeros. ``lens`` EXCLUDES the chunk.
- ``paged_flash_chunk`` (kernel 4, ``_chunk_kernel``): the same with q
  already roped (the unfused serving step).
- ``paged_flash_decode`` (kernel 5, ``_decode_kernel``): one query token per
  slot attends over positions ``< lens[b]``, where ``lens`` INCLUDES that
  token; a slot with ``lens == 0`` is exact zeros.
- ``paged_flash_decode_fused`` (kernel 6, ``_decode_fused_kernel``): kernel 5
  with q roped first, from the slots' rope rows ``[B, 1, D]``.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel (``csrc/paged_chunk_fused.cu`` for A and 4,
``csrc/paged_decode.cu`` for 5 and 6) for CUDA tensors, or raises. The
kernels take bf16, fp16 or fp32 storage and every head dim that is a
multiple of 64, as the JAX package's ``D % 64`` gate sends every one to its
kernels. Above 256, A and 4 split O's columns over CTAs
(:func:`chunk_plan`: two up to 512, ``ceil(D / 256)`` above, where
``csrc/paged_chunk_deep.cu`` keeps q resident and streams K and V through a
ring of 256-column slots: :func:`chunk_geometry`); 5 and 6
split each history over a cluster and O's columns over ``ceil(D / 512)``
CTAs (:func:`decode_plan`). The rope rows reach A and 6 in
fp32, as the engine gathers them; the kernels round them to q's dtype.

The int8 pool: with ``k_scale``/``v_scale`` (fp32 ``[NB, HKV, BS]``, one
scale per cached token and head, addressed by the same physical block as
its row) the pools are int8 and every gathered K/V element is dequantized
as ``float(int8) * scale`` (the Pallas ``_dequant_tile``) before the
attention; q and the output keep their dtype. Each kernel then launches its
``_int8`` instance, counted under its own name (``paged_chunk_fused_int8``,
``paged_chunk_int8``, ``paged_decode_int8``, ``paged_decode_fused_int8``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.fused import _io_dtype, _kernel_operand
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "chunk_cluster_size",
    "chunk_plan",
    "decode_plan",
    "paged_flash_chunk",
    "paged_flash_chunk_fused",
    "paged_flash_chunk_fused_plain",
    "paged_flash_chunk_plain",
    "paged_flash_decode",
    "paged_flash_decode_fused",
    "paged_flash_decode_fused_plain",
    "paged_flash_decode_plain",
    "rope_rows",
    "_gather_chunk_attend",
    "_scale_planes",
]

NEG_INF = -1e30  # the Pallas kernel's masked score
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the head dims of the template instances of A and 4 (csrc/paged_chunk.cuh);
# every other multiple of 64 (above 512) runs csrc/paged_chunk_deep.cu, whose
# head dim is a runtime value. Kernels 5 and 6 take D at run time.
CHUNK_HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512)
# kernels A and 4 (csrc/paged_chunk.cuh): the most ranks a cluster, the
# largest accumulator (O's columns) one CTA holds, the shared memory a CTA's
# layout may take (kSmemBudget), positions a step; above head dim 512
# (csrc/paged_chunk_deep.cu) the columns of K or V a ring slot holds
CHUNK_MAX_RANKS = 8
CHUNK_MAX_COLUMNS = 256
CHUNK_SMEM_BUDGET = 200 * 1024
CHUNK_SMEM_PAIR = 108 * 1024  # a layout of which an SM holds two CTAs (kSmemPair)
CHUNK_STEP = 16
CHUNK_SLOT_COLUMNS = 256
# above head dim 512 the cluster size may fill this many waves of the card's
# cap: a deep step costs 4-5 ring slots, so the longest history's walk sets
# the time, and tiles whose rows are all past q_lens leave at once
CHUNK_DEEP_WAVES = 4
# kernels 5 and 6 (csrc/paged_decode.cu): the most ranks a cluster, O's
# columns a CTA, positions a stage, and the bytes a stage and a ring aim at
DECODE_MAX_RANKS = 8
DECODE_MAX_COLUMNS = 512
DECODE_STAGE_ROWS = 16
DECODE_STAGE_BYTES = 16384
DECODE_RING_BYTES = 24576


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Neox rotate-half in ``x``'s dtype: ``x*cos + concat(-x2, x1)*sin``
    (the tables are cast to ``x``'s dtype first, as the kernels do)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


def _gather_chunk_attend(
    q: torch.Tensor,  # [B, C, HQ, D], already roped
    key_cache: torch.Tensor,  # [NB, HKV, BS, D]
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS] int
    seq_lens: torch.Tensor,  # [B] tokens cached before the chunk
    attend_q: torch.Tensor,  # [B] valid new rows (0 = masked slot: exact zeros)
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # [NB, HKV, BS] fp32 (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense-gather attention, the JAX package's ``_gather_chunk_attend``:
    gather each slot's used blocks, mask row ``j`` to positions
    ``< seq_lens + j + 1``, fp32 softmax; rows past ``attend_q`` are exact
    zeros. Table entries past the used blocks are clamped into range for the
    gather; what they point at is masked. With scale planes the gathered
    rows are dequantized right after the gather, ``x.float() * scale``."""
    b, c, hq, d = q.shape
    nb, hkv, bs, _ = key_cache.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    lens = seq_lens.long()
    qlens = attend_q.long()
    n_blk = max(int(((lens + qlens).max() + bs - 1) // bs), 1)
    tables = block_tables[:, :n_blk].long().clamp(0, nb - 1)
    L = n_blk * bs
    # [B, n_blk, HKV, BS, D] -> [B, HKV, L, D]
    gk = key_cache[tables].permute(0, 2, 1, 3, 4).reshape(b, hkv, L, d).float()
    gv = value_cache[tables].permute(0, 2, 1, 3, 4).reshape(b, hkv, L, d).float()
    if k_scale is not None:  # the per-token scales ride the same gather
        gk = gk * k_scale[tables].permute(0, 2, 1, 3).reshape(b, hkv, L)[..., None]
        gv = gv * v_scale[tables].permute(0, 2, 1, 3).reshape(b, hkv, L)[..., None]
    qf = (q.float() * scale).reshape(b, c, hkv, g, d)
    scores = torch.einsum("bchgd,bhld->bchgl", qf, gk)
    j = torch.arange(c, device=q.device)
    pos = torch.arange(L, device=q.device)
    limit = lens[:, None] + j[None, :] + 1  # [B, C]
    valid = pos[None, None, :] < limit[:, :, None]  # [B, C, L]
    scores = scores.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bchgl,bhld->bchgd", probs, gv)
    row_valid = j[None, :] < qlens[:, None]  # [B, C]
    out = out.masked_fill(~row_valid[:, :, None, None, None], 0.0)
    return out.reshape(b, c, hq, d).to(q.dtype)


def _scale_or_default(scale: Optional[float], d: int) -> float:
    return 1.0 / d**0.5 if scale is None else float(scale)


def _scale_planes(what: str, k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor]) -> bool:
    """Whether the int8 pool's scale planes were given: both or neither."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: the int8 pool takes both scale planes, key and value, or neither")
    return k_scale is not None


# -- plain versions (each calls only the shared compositions, never another) ----

def paged_flash_chunk_plain(q, key_cache, value_cache, block_tables, seq_lens, q_lens, scale=None,
                            k_scale=None, v_scale=None):
    """Kernel 4's plain version: :func:`_gather_chunk_attend` of q as given."""
    return _gather_chunk_attend(q, key_cache, value_cache, block_tables, seq_lens, q_lens,
                                _scale_or_default(scale, q.shape[-1]), k_scale, v_scale)


def paged_flash_chunk_fused_plain(
    q: torch.Tensor,  # [B, C, HQ, D] pre-rope
    cos: torch.Tensor,  # [B, C, D]
    sin: torch.Tensor,
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], keys roped on append
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS] int
    seq_lens: torch.Tensor,  # [B] tokens cached before the chunk
    q_lens: torch.Tensor,  # [B] valid new rows
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel A's plain version: rope q in its dtype, then
    :func:`_gather_chunk_attend`."""
    qr = rope_rows(q, cos[:, :, None, :], sin[:, :, None, :])
    return _gather_chunk_attend(qr, key_cache, value_cache, block_tables, seq_lens, q_lens,
                                _scale_or_default(scale, q.shape[-1]), k_scale, v_scale)


def _decode_attend(q, key_cache, value_cache, block_tables, seq_lens, scale, k_scale, v_scale) -> torch.Tensor:
    """One-token attention as the one-row chunk of a slot whose ``seq_lens``
    include the token (``seq_lens - 1`` cached before it; a slot of length 0
    has no valid row)."""
    lens = seq_lens.long()
    return _gather_chunk_attend(q[:, None], key_cache, value_cache, block_tables, lens - 1, (lens > 0).long(),
                                _scale_or_default(scale, q.shape[-1]), k_scale, v_scale)[:, 0]


def paged_flash_decode_plain(q, key_cache, value_cache, block_tables, seq_lens, scale=None, k_scale=None,
                             v_scale=None):
    """Kernel 5's plain version (``q [B, HQ, D]``)."""
    return _decode_attend(q, key_cache, value_cache, block_tables, seq_lens, scale, k_scale, v_scale)


def paged_flash_decode_fused_plain(q, cos, sin, key_cache, value_cache, block_tables, seq_lens, scale=None,
                                   k_scale=None, v_scale=None):
    """Kernel 6's plain version: rope q (``[B, HQ, D]``, rows ``cos``/``sin``
    ``[B, 1, D]``) in its dtype, then the one-token attention."""
    return _decode_attend(rope_rows(q, cos, sin), key_cache, value_cache, block_tables, seq_lens, scale,
                          k_scale, v_scale)


# -- the kernels -----------------------------------------------------------------

def _launch_operands(what: str, q: torch.Tensor, key_cache: torch.Tensor, value_cache: torch.Tensor,
                     block_tables: torch.Tensor, *lens: torch.Tensor, k_scale=None, v_scale=None):
    """Check what every paged kernel takes (a head dim that is a multiple
    of 64, any of them); returns ``(io, q, pools, tables32, *lens32)``
    ready for the launch: ``pools`` is ``[kc, vc]``, and ``[kc, vc,
    k_scale, v_scale]`` for the int8 pool (``lens``: the ``[B]`` length
    vectors)."""
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    io = _io_dtype(what, q)
    nb, hkv, bs, d_c = key_cache.shape
    if d_c != d or hq % hkv or value_cache.shape != key_cache.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(key_cache.shape)} / {tuple(value_cache.shape)}")
    if d <= 0 or d % 64:
        raise ValueError(f"{what}: the CUDA kernel takes head dims that are multiples of 64, not {d} "
                         "(a head dim that is not a multiple of 64 takes the composition)")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or any(t.shape != (b,) for t in lens):
        raise ValueError(f"{what}: tables {tuple(block_tables.shape)} / lengths "
                         f"{[tuple(t.shape) for t in lens]} do not match the batch of {b}")
    dev = q.device
    kv_dtype = q.dtype if k_scale is None else torch.int8
    q = _kernel_operand(q, "q", what, q.dtype, dev)
    pools = [_kernel_operand(t, name, what, kv_dtype, dev)
             for name, t in (("key_cache", key_cache), ("value_cache", value_cache))]
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != (nb, hkv, bs):
                raise ValueError(f"{what}: {name} must be [{nb}, {hkv}, {bs}], got {tuple(t.shape)}")
            pools.append(_kernel_operand(t, name, what, torch.float32, dev))
    ints = (t.to(device=dev, dtype=torch.int32).contiguous() for t in (block_tables, *lens))
    return (io, q, pools, *ints)


def _rope_operands(what: str, q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, shape) -> tuple:
    """The rope rows in fp32, as the kernels read them (the engine's rows
    are fp32 already: no cast; a bf16 or fp16 row widens exactly). Each
    kernel rounds them to q's dtype, as the Pallas kernels cast them."""
    if cos.shape != shape or sin.shape != shape:
        raise ValueError(f"{what}: rope rows must be {list(shape)}, got {tuple(cos.shape)} / {tuple(sin.shape)}")
    return tuple(_kernel_operand(t.to(device=q.device, dtype=torch.float32), name, what, torch.float32, q.device)
                 for name, t in (("cos", cos), ("sin", sin)))


def _chunk_columns(d: int) -> tuple:
    """``(split, columns)``: the CTAs over O's columns of A and 4 and the
    columns each owns (the last one the rest): 1 up to head dim 256, 2 up
    to 512 (D / 2 each), above that ``ceil(D / 256)`` CTAs of whole
    64-column units, as even as whole units allow."""
    if d <= CHUNK_MAX_COLUMNS:
        return 1, d
    if d <= CHUNK_HEAD_DIMS[-1]:
        return 2, d // 2
    units = d // 64
    split = -(-d // CHUNK_MAX_COLUMNS)
    return split, 64 * -(-units // split)


def chunk_geometry(d: int, dtype: torch.dtype, kv_int8: bool = False, rows: Optional[int] = None) -> Optional[dict]:
    """Kernels A and 4's launch geometry at head dim ``d`` for q of
    ``dtype`` over a pool of q's dtype or the int8 pool (``kv_int8``), as
    ``csrc/paged_chunk_fused.cu`` ``ptt_paged_chunk_plan`` reports it:

    - ``split`` and ``columns`` (:func:`_chunk_columns`);
    - ``rows``, packed query rows a tile: up to 512 the instance's (64, or 32
      for fp32 above 256); above 512 the most of 64, 32, 16 (fp32: 32, 16)
      whose layout fits :data:`CHUNK_SMEM_BUDGET` (q resident in its own
      type, a ring of 4 slots of 16 positions x 256 columns, else 3, and for
      the int8 pool two slots upcast to q's type), and in bf16 / fp16 half
      of them where that layout is over :data:`CHUNK_SMEM_PAIR` and half
      the rows' is within it (an SM then holds two CTAs, whose walks hide
      each other's latency);
    - ``slots``, the ring's depth (up to 512 the (K, V) stages, 3 or 2);
    - ``smem``, the layout's bytes (the merge's fp32 partials reuse them;
      the table entries come on top);
    - ``walk``: "resident" (q staged once), or above 512 "chunked" where
      not even 16 rows of q fit (q and K staged 64 columns at a time every
      step, 64 rows, on the CUDA cores).

    ``rows`` asks the walk above 512 for that many tile rows instead (64,
    32 or 16; None when its layout does not fit)."""
    t = torch.empty((), dtype=dtype).element_size()
    kv = 1 if kv_int8 else t
    split, columns = _chunk_columns(d)
    scales = 2 * CHUNK_STEP * 4 if kv_int8 else 0  # a slot's k and v scale rows (fp32)
    ldq = d + 16 // t  # q's rows, padded by 16 bytes
    if d <= CHUNK_HEAD_DIMS[-1]:
        own = 32 if t == 4 and d > CHUNK_MAX_COLUMNS else 64
        if rows not in (None, own):
            return None
        stage = CHUNK_STEP * ((d + 16 // kv) + (columns + 16 // kv)) * kv + scales
        fixed = own * ldq * t + (CHUNK_STEP * (ldq + columns + 16 // t) * t if kv_int8 else 0)
        slots = 3 if fixed + 3 * stage <= CHUNK_SMEM_BUDGET else 2
        smem = max(fixed + slots * stage, own * (columns + 8) * 4)
        return {"split": split, "columns": columns, "rows": own, "slots": slots, "smem": smem, "walk": "resident"}
    slot = CHUNK_STEP * (CHUNK_SLOT_COLUMNS + 16 // kv) * kv + scales
    up = 2 * CHUNK_STEP * (CHUNK_SLOT_COLUMNS + 16 // t) * t if kv_int8 else 0

    def fit(r):  # the resident layout at r rows with 4 ring slots, else 3 (None: neither fits)
        for slots in (4, 3):
            smem = max(r * ldq * t + slots * slot + up, r * (CHUNK_MAX_COLUMNS + 8) * 4)
            if smem <= CHUNK_SMEM_BUDGET:
                return {"split": split, "columns": columns, "rows": r, "slots": slots, "smem": smem,
                        "walk": "resident"}
        return None

    if rows:
        return fit(rows) if rows in (64, 32, 16) else None
    for r in (64, 32, 16) if t == 2 else (32, 16):
        geo = fit(r)
        if geo is None:
            continue
        half = fit(r // 2) if t == 2 and r > 16 and geo["smem"] > CHUNK_SMEM_PAIR else None
        return half if half is not None and half["smem"] <= CHUNK_SMEM_PAIR else geo
    # the chunked walk: q [64][68], K [16][68], V [16][260] fp32 and the scales, or the merge's partials
    smem = max((64 * 68 + 16 * 68 + 16 * 260 + 32) * 4, 64 * (CHUNK_MAX_COLUMNS + 8) * 4)
    return {"split": split, "columns": columns, "rows": 64, "slots": 0, "smem": smem, "walk": "chunked"}


def chunk_plan(b: int, c: int, hq: int, hkv: int, d: int, dtype: torch.dtype, mbs: int, cap: int,
               kv_int8: bool = False, rows: Optional[int] = None) -> dict:
    """Kernels A and 4's launch plan, the one they launch with (a host
    function of the shapes and ``cap``, the CTAs of the instance the card
    holds at once: ``csrc/paged_chunk_fused.cu`` ``ptt_paged_chunk_cap``):
    :func:`chunk_geometry`'s ``split`` CTAs over O's columns (2 above head
    dim 256, each owning ``columns`` = D / 2; ``ceil(D / 256)`` above 512),
    tiles of ``rows`` packed query rows (32 for fp32 at head dims 320 to
    512, else 64; above 512 what fits), its ring ``slots``, ``smem`` and
    ``walk``, ``tiles`` of them per (KV head, slot), the cluster size
    ``ranks`` (the most of 8, 4, 2, 1 whose ``tiles * split * hkv * b``
    clusters fit ``cap``, at most ``mbs``: long histories get the most CTAs
    that still run as one wave, above head dim 512 as
    :data:`CHUNK_DEEP_WAVES` waves; never a length) and the ``grid``.
    ``rows`` asks the walk above 512 for other tile rows (timing only; the
    cap must be that layout's)."""
    geo = chunk_geometry(d, dtype, kv_int8, rows)
    if geo is None:
        raise ValueError(f"kernels A / 4 at head dim {d} in {dtype} cannot hold tiles of {rows} rows")
    split, rows = geo["split"], geo["rows"]
    tiles = -(-c * (hq // hkv) // rows)
    work = tiles * split * hkv * b
    waves = CHUNK_DEEP_WAVES if d > CHUNK_HEAD_DIMS[-1] else 1
    ranks = CHUNK_MAX_RANKS
    while ranks > 1 and work * ranks > waves * cap:
        ranks //= 2
    ranks = max(1, min(ranks, mbs))
    return {**geo, "tiles": tiles, "ranks": ranks, "grid": (tiles * split * ranks, hkv, b)}


@functools.lru_cache(maxsize=None)
def _chunk_cap(device: torch.device, io: int, quant: bool, rope: bool, d: int, mbs: int, rows: int = 0) -> int:
    """The CTAs of kernel A's (``rope``) or 4's instance the card ``device``
    holds at once with ``mbs`` table entries staged (its occupancy times the
    SMs, ``ptt_paged_chunk_cap``), at its own tile rows (``rows`` 0) or at
    ``rows`` above head dim 512; asked once per instance and ``mbs``."""
    cap = ctypes.c_int(0)
    fn = build.kernel_fn("ptt_paged_chunk_cap", [_I] * 6 + [_P])
    with torch.cuda.device(device):
        err = fn(io, int(quant), int(rope), d, mbs, rows, ctypes.addressof(cap))
    build.check(err, "paged_chunk_cap")
    return cap.value


def _chunk_launch_plan(q: torch.Tensor, key_cache: torch.Tensor, block_tables: torch.Tensor,
                       rope: bool = True, rows: Optional[int] = None) -> dict:
    """:func:`chunk_plan` of kernel A's (``rope``) or 4's launch for these
    shapes on this card, with the ``cap`` it was chosen under (at ``rows``
    tile rows when given); nothing runs."""
    b, c, hq, d = q.shape
    mbs = block_tables.shape[1]
    quant = key_cache.dtype == torch.int8
    io = _io_dtype("paged_chunk", q)
    cap = _chunk_cap(q.device, io, quant, rope, d, mbs, rows or 0)
    return {**chunk_plan(b, c, hq, key_cache.shape[1], d, q.dtype, mbs, cap, quant, rows), "cap": cap}


def chunk_cluster_size(q: torch.Tensor, key_cache: torch.Tensor, block_tables: torch.Tensor) -> int:
    """The CTAs of one cluster over which kernel A splits each history for
    these shapes on this card (``q`` ``[B, C, HQ, D]`` on the card; an int8
    ``key_cache`` asks for A's int8 instance): :func:`chunk_plan`'s
    ``ranks``, from the shapes and the kernel's occupancy only; nothing
    runs."""
    return _chunk_launch_plan(q, key_cache, block_tables)["ranks"]


def decode_plan(b: int, hq: int, hkv: int, d: int, bs: int, mbs: int, kv_bytes: int, cap) -> dict:
    """Kernels 5 and 6's launch plan, the one they launch with (a host
    function of the shapes, the pool's element size ``kv_bytes`` (1: the
    int8 pool, whose scale rows ride each stage) and ``cap``: ``cap[r -
    1]`` the clusters of ``r`` CTAs of the instance the card holds at once,
    for ``r`` = 1 to 8 (``csrc/paged_decode.cu`` ``ptt_paged_decode_cap``,
    asked with this plan's geometry); ``cap`` None gives the geometry alone,
    with ``ranks`` 1):

    - ``split`` CTAs over O's columns (1 up to head dim 512, else
      ``ceil(D / 512)``), each owning ``columns`` (whole 64-column units,
      the last CTA the rest);
    - ``rows`` query heads of a KV head a CTA (1 for MHA, else at most 4,
      or 2 where a CTA holds more than 256 columns), ``groups`` of them;
    - ``stage_rows`` positions a ring stage (at most 16, and at most
      :data:`DECODE_STAGE_BYTES` of K and V; a stage may span pages) and
      ``stages`` of them (about :data:`DECODE_RING_BYTES`, 2 to 8);
    - the cluster size ``ranks``: the most, 1 to 8 and at most ``mbs``,
      whose ``groups * split * hkv * b`` clusters the card holds at once
      (one wave, as :func:`chunk_plan` chooses; never a length: each rank
      walks ``ceil(blocks / ranks)`` table entries of its slot, whatever
      the slot holds), and the ``grid``."""
    g = hq // hkv
    units = d // 64
    split = -(-d // DECODE_MAX_COLUMNS)
    columns = 64 * -(-units // split)
    rows = 1 if g == 1 else min(g, 4 if columns <= 256 else 2)
    groups = -(-g // rows)
    row_bytes = (d + columns) * kv_bytes + (8 if kv_bytes == 1 else 0)
    stage_rows = max(1, min(DECODE_STAGE_ROWS, DECODE_STAGE_BYTES // row_bytes))
    stages = max(2, min(8, DECODE_RING_BYTES // (stage_rows * row_bytes)))
    work = groups * split * hkv * b
    ranks = min(DECODE_MAX_RANKS, mbs) if cap is not None else 1
    while ranks > 1 and work > cap[ranks - 1]:
        ranks -= 1
    return {"split": split, "columns": columns, "rows": rows, "groups": groups, "stage_rows": stage_rows,
            "stages": stages, "ranks": ranks, "grid": (groups * split * ranks, hkv, b)}


def _decode_cap(device: torch.device, io: int, quant: bool, rope: bool, d: int, rows: int, columns: int,
                stage_rows: int, stages: int) -> tuple:
    """The clusters of 1 to 8 CTAs of kernel 6's (``rope``) or 5's instance
    that the card ``device`` holds at once with this stage geometry
    (``ptt_paged_decode_cap``)."""
    cap = (ctypes.c_int * DECODE_MAX_RANKS)()
    fn = build.kernel_fn("ptt_paged_decode_cap", [_I] * 8 + [_P])
    with torch.cuda.device(device):
        err = fn(io, int(quant), int(rope), d, rows, columns, stage_rows, stages, ctypes.addressof(cap))
    build.check(err, "paged_decode_cap")
    return tuple(cap)


@functools.lru_cache(maxsize=None)
def _decode_plan_on(device: torch.device, io: int, rope: bool, b: int, hq: int, hkv: int, d: int, bs: int,
                    mbs: int, kv_bytes: int) -> dict:
    """:func:`decode_plan` of kernel 6's (``rope``) or 5's launch on the
    card ``device`` (``kv_bytes`` 1: the int8 pool), with the ``cap`` it was
    chosen under; made once per instance and shapes, so a decode step's
    launches pay one cache lookup for it. Callers must not change it."""
    geo = decode_plan(b, hq, hkv, d, bs, mbs, kv_bytes, None)
    cap = _decode_cap(device, io, kv_bytes == 1, rope, d, geo["rows"], geo["columns"], geo["stage_rows"],
                      geo["stages"])
    return {**decode_plan(b, hq, hkv, d, bs, mbs, kv_bytes, cap), "cap": cap}


def _decode_launch_plan(q: torch.Tensor, key_cache: torch.Tensor, block_tables: torch.Tensor,
                        rope: bool) -> dict:
    """:func:`decode_plan` of kernel 6's (``rope``) or 5's launch for these
    shapes on this card, with the ``cap`` it was chosen under; nothing
    runs."""
    b, hq, d = q.shape
    _, hkv, bs, _ = key_cache.shape
    return dict(_decode_plan_on(q.device, _io_dtype("paged_decode", q), rope, b, hq, hkv, d, bs,
                                block_tables.shape[1], key_cache.element_size()))


def _launch(name: str, io: int, ptrs: list, dims: tuple, scale: float, device: torch.device) -> None:
    """One launch of the C entry ``ptt_<name>`` (the pointers, then the int
    dims, the softmax scale and the stream), checked and counted under
    ``name``."""
    fn = build.kernel_fn(f"ptt_{name}", [_I] + [_P] * len(ptrs) + [_I] * len(dims) + [_F, _P])
    with torch.cuda.device(device):
        err = fn(io, *ptrs, *dims, scale, torch.cuda.current_stream().cuda_stream)
    build.check(err, name)
    count_launch(name)


def paged_flash_chunk_fused(
    q: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    q_lens: torch.Tensor,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of a ragged chunk over the paged cache with q-rope folded
    in (kernel A); the signature of the JAX package's
    ``paged_flash_chunk_fused``. ``cos``/``sin`` are the per-token rope rows
    ``[B, C, D]``."""
    _scale_planes("paged_flash_chunk_fused", k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_chunk_fused_plain(q, cos, sin, key_cache, value_cache, block_tables, seq_lens,
                                             q_lens, scale, k_scale, v_scale)
    return _chunk_launch("paged_flash_chunk_fused", q, cos, sin, key_cache, value_cache, block_tables, seq_lens,
                         q_lens, scale, k_scale, v_scale)


def paged_flash_chunk(
    q: torch.Tensor,  # [B, C, HQ, D] ragged chunk, already roped
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], the chunk's KV already appended
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS] int
    seq_lens: torch.Tensor,  # [B] tokens cached BEFORE the chunk
    q_lens: torch.Tensor,  # [B] valid new rows (0 = inactive slot)
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of one mixed prefill/decode step over the paged cache
    (kernel 4); the JAX package's ``paged_flash_chunk``. Returns
    ``[B, C, HQ, D]`` with rows past ``q_lens`` exactly 0."""
    _scale_planes("paged_flash_chunk", k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_chunk_plain(q, key_cache, value_cache, block_tables, seq_lens, q_lens, scale,
                                       k_scale, v_scale)
    return _chunk_launch("paged_flash_chunk", q, None, None, key_cache, value_cache, block_tables, seq_lens,
                         q_lens, scale, k_scale, v_scale)


def _chunk_launch(what, q, cos, sin, key_cache, value_cache, block_tables, seq_lens, q_lens, scale, k_scale,
                  v_scale, rows: Optional[int] = None) -> torch.Tensor:
    """One launch of kernel A (``cos`` given) or 4 with :func:`chunk_plan`'s
    plan; ``rows`` sets other tile rows than the plan's above head dim 512,
    to time the rows rule against the other counts (the wrappers pass
    none)."""
    io, q, pools, tables32, lens32, qlens32 = _launch_operands(
        what, q, key_cache, value_cache, block_tables, seq_lens, q_lens, k_scale=k_scale, v_scale=v_scale)
    b, c, hq, d = q.shape
    rope = ()
    if cos is not None:
        rope = _rope_operands(what, q, cos, sin, (b, c, d))
    out = torch.empty_like(q)
    if b and c:
        kc = pools[0]
        plan = _chunk_launch_plan(q, kc, tables32, rope=cos is not None, rows=rows)
        name = ("paged_chunk_fused" if cos is not None else "paged_chunk") + "_int8" * (k_scale is not None)
        _launch(name, io, [t.data_ptr() for t in (q, *rope, *pools, tables32, lens32, qlens32, out)],
                (b, c, hq, kc.shape[1], d, kc.shape[2], tables32.shape[1], plan["split"], plan["columns"],
                 plan["rows"], plan["ranks"]), _scale_or_default(scale, d), q.device)
    return out


def paged_flash_decode(
    q: torch.Tensor,  # [B, HQ, D]
    key_cache: torch.Tensor,  # [NB, HKV, BS, D]
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS] int
    seq_lens: torch.Tensor,  # [B] length INCLUDING the current token
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash decode over the paged cache (kernel 5); the JAX package's
    ``paged_flash_decode``. Returns ``[B, HQ, D]``."""
    _scale_planes("paged_flash_decode", k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, key_cache, value_cache, block_tables, seq_lens, scale, k_scale, v_scale)
    return _decode_launch("paged_flash_decode", q, None, None, key_cache, value_cache, block_tables,
                          seq_lens, scale, k_scale, v_scale)


def paged_flash_decode_fused(
    q: torch.Tensor,  # [B, HQ, D] PRE-rope
    cos: torch.Tensor,  # [B, 1, D] the slots' rope rows
    sin: torch.Tensor,
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], keys roped on append
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,  # [B] length INCLUDING the current token
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`paged_flash_decode` with q-rope folded into the walk (kernel
    6); the JAX package's ``paged_flash_decode_fused``."""
    _scale_planes("paged_flash_decode_fused", k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_decode_fused_plain(q, cos, sin, key_cache, value_cache, block_tables, seq_lens, scale,
                                              k_scale, v_scale)
    return _decode_launch("paged_flash_decode_fused", q, cos, sin, key_cache, value_cache, block_tables,
                          seq_lens, scale, k_scale, v_scale)


def _decode_launch(what, q, cos, sin, key_cache, value_cache, block_tables, seq_lens, scale, k_scale,
                   v_scale, ranks: Optional[int] = None) -> torch.Tensor:
    """One launch of kernel 6 (``cos`` given) or 5 with :func:`decode_plan`'s
    plan; ``ranks`` sets another cluster size (1 to 8) than the plan's, to
    time the rank rule against the others (the wrappers pass none)."""
    io, q, pools, tables32, lens32 = _launch_operands(what, q, key_cache, value_cache, block_tables, seq_lens,
                                                      k_scale=k_scale, v_scale=v_scale)
    b, hq, d = q.shape
    out = torch.empty_like(q)
    if not b:
        return out
    rope = ()
    if cos is not None:
        rope = _rope_operands(what, q, cos, sin, (b, 1, d))
    name = ("paged_decode_fused" if cos is not None else "paged_decode") + "_int8" * (k_scale is not None)
    kc = pools[0]
    _, hkv, bs, _ = kc.shape
    mbs = tables32.shape[1]
    plan = _decode_plan_on(q.device, io, cos is not None, b, hq, hkv, d, bs, mbs, kc.element_size())
    _launch(name, io, [t.data_ptr() for t in (q, *rope, *pools, tables32, lens32, out)],
            (b, hq, hkv, d, bs, mbs, plan["rows"], plan["split"], plan["columns"], ranks or plan["ranks"],
             plan["stage_rows"], plan["stages"]), _scale_or_default(scale, d), q.device)
    return out
