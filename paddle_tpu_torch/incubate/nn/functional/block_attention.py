"""Paged KV cache for serving: the host-side block allocator and the
device-side cache operations of a decode or serving step.

Port of ``paddle_tpu/incubate/nn/functional/block_attention.py`` (the
pool on one device). The cache layout is the JAX package's: one
``[NB, HKV, BS, D]`` key pool and one value pool per layer, addressed by
``[B, MBS]`` block tables. Where the JAX functions return updated caches
(JAX arrays are immutable), these update the caches in place and return the
same tensors. Every append is sync-free: no data-dependent shape, so a step
never waits on the device. The attention entries run the paged kernels (A,
4, 5, 6) for a head dim that is a multiple of 64, and the dense-gather
composition otherwise, as the JAX package does.

The int8 pool (the engine's ``kv_cache_dtype="int8"``): int8 pools plus two
fp32 scale planes ``[NB, HKV, BS]`` (``key_scale``, ``value_scale``), one
scale per cached token and head. Every write quantizes its rows on the way
in (:func:`_quantize_kv_rows`, per token over D) and places the scales with
the same indices as the rows; the attention dequantizes inside the kernels'
block walk (or right after the composition's gather). Given the planes, a
function returns them too: ``(kc, vc, ks, vs)``, ``(out, kc, vc, ks, vs)``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.incubate.nn.functional import _rope_apply_xla
from paddle_tpu_torch.kernels.paged_attention import (  # noqa: F401  (re-export)
    _gather_chunk_attend,
    _scale_planes,
    paged_flash_chunk,
    paged_flash_chunk_fused,
    paged_flash_decode,
    paged_flash_decode_fused,
)

__all__ = [
    "BlockKVCache",
    "block_cache_append",
    "block_cache_append_chunk",
    "block_cache_cow_copy",
    "block_cache_prefill",
    "block_multihead_attention",
    "block_multihead_attention_fused",
    "block_multihead_chunk_attention",
    "block_multihead_chunk_attention_fused",
    "_gather_chunk_attend",
    "_quantize_kv_rows",
]

Caches = Tuple[torch.Tensor, ...]  # (kc, vc), or (kc, vc, ks, vs) for the int8 pool


class BlockKVCache:
    """Host-side paged-cache manager over the physical block pool.

    Two allocation surfaces share the one free list, as in the JAX package:

    - per-sequence tables (:meth:`allocate`, :meth:`free`, :meth:`truncate`,
      :meth:`block_table`, :meth:`seq_lens`), used by ``generate_paged``,
      where a sequence owns its blocks exclusively;
    - refcounted blocks (:meth:`acquire_block`, :meth:`incref`,
      :meth:`decref`), used by the serving engine, where a block returns to
      the free list only when its last owner drops it.

    Accounting is guarded by one lock (a serving front end may size requests
    against ``free_blocks`` from another thread). The device pools belong to
    the caller, one pair per layer. ``max_blocks_per_seq`` bounds a table
    (default: the whole pool)."""

    def __init__(self, num_blocks: int, block_size: int, max_blocks_per_seq: Optional[int] = None) -> None:
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(self.num_blocks if max_blocks_per_seq is None else max_blocks_per_seq)
        self._lock = threading.Lock()
        # LIFO over block ids, lowest id first out — the JAX allocator's order
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._tables: Dict[int, List[int]] = {}  # seq id -> physical block ids
        self._lens: Dict[int, int] = {}  # seq id -> tokens stored

    # -- per-sequence tables ---------------------------------------------------
    def allocate(self, seq_id: int, num_tokens: int) -> None:
        """Ensure ``seq_id`` has blocks for ``num_tokens`` more tokens."""
        with self._lock:
            table = self._tables.setdefault(seq_id, [])
            cur = self._lens.get(seq_id, 0)
            need = -(-(cur + num_tokens) // self.block_size)
            while len(table) < need:
                if not self._free:
                    raise MemoryError("paged KV cache out of physical blocks")
                if len(table) >= self.max_blocks_per_seq:
                    raise MemoryError(f"sequence {seq_id} exceeds max_blocks_per_seq={self.max_blocks_per_seq}")
                table.append(self._free.pop())
            self._lens[seq_id] = cur + num_tokens

    def free(self, seq_id: int) -> None:
        """Return a finished sequence's blocks to the pool."""
        with self._lock:
            self._free.extend(self._tables.pop(seq_id, []))
            self._lens.pop(seq_id, None)

    def truncate(self, seq_id: int, num_tokens: int) -> None:
        """Roll ``seq_id`` back to ``num_tokens`` stored tokens, returning
        now-unused tail blocks to the pool."""
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                return
            keep = -(-num_tokens // self.block_size) if num_tokens > 0 else 0
            while len(table) > keep:
                self._free.append(table.pop())
            self._lens[seq_id] = num_tokens

    def seq_len(self, seq_id: int) -> int:
        with self._lock:
            return self._lens.get(seq_id, 0)

    def blocks_allocated(self, seq_id: Optional[int] = None) -> int:
        """Blocks held by ``seq_id`` (all sequences when None); refcounted
        blocks belong to no sequence."""
        with self._lock:
            if seq_id is not None:
                return len(self._tables.get(seq_id, ()))
            return sum(len(t) for t in self._tables.values())

    def block_table(self, seq_ids: Sequence[int]) -> torch.Tensor:
        """Dense ``[B, max_blocks_per_seq]`` int32 table on the host; entries
        past a sequence's blocks are 0 (the kernels never read them)."""
        out = torch.zeros((len(seq_ids), self.max_blocks_per_seq), dtype=torch.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                t = self._tables.get(sid, [])
                out[i, : len(t)] = torch.tensor(t, dtype=torch.int32)
        return out

    def seq_lens(self, seq_ids: Sequence[int]) -> torch.Tensor:
        """``[B]`` int32 tokens stored, on the host."""
        with self._lock:
            return torch.tensor([self._lens.get(s, 0) for s in seq_ids], dtype=torch.int32)

    # -- refcounted blocks -----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def acquire_block(self) -> int:
        """Take one block off the free list with refcount 1."""
        with self._lock:
            if not self._free:
                raise MemoryError("paged KV cache out of physical blocks")
            blk = self._free.pop()
            self._ref[blk] = 1
            return blk

    def incref(self, block: int) -> int:
        """Add one owner; returns the new count."""
        with self._lock:
            cur = self._ref.get(block)
            if cur is None:
                raise ValueError(f"block {block} is not refcount-managed")
            self._ref[block] = cur + 1
            return cur + 1

    def decref(self, block: int) -> bool:
        """Drop one owner; returns True when this freed the block."""
        with self._lock:
            cur = self._ref.get(block)
            if cur is None:
                raise ValueError(f"block {block} is not refcount-managed")
            if cur <= 1:
                del self._ref[block]
                self._free.append(block)
                return True
            self._ref[block] = cur - 1
            return False

    def refcounts(self) -> Dict[int, int]:
        """Snapshot of every held block's owner count."""
        with self._lock:
            return dict(self._ref)


def _quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token absmax int8 quantization over the head dim: each
    ``[..., D]`` row gets its own fp32 scale (``absmax / 127``; 1.0 for an
    all-zero row, so it dequantizes to exact zeros). The JAX package's
    arithmetic op for op, so the two give the same bits."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def block_cache_append_chunk(
    key_cache: torch.Tensor,  # [NB, H, BS, D], updated in place
    value_cache: torch.Tensor,
    k: torch.Tensor,  # [B, C, H, D] up to C new tokens per sequence
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] tokens already stored (the chunk goes after them)
    q_lens: torch.Tensor,  # [B] valid new tokens (0 = none)
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
    key_scale: Optional[torch.Tensor] = None,  # [NB, H, BS] fp32 (int8 pool), updated in place
    value_scale: Optional[torch.Tensor] = None,
) -> Caches:
    """Write token ``j`` of sequence ``b`` at position ``seq_lens[b] + j``;
    returns the pools (updated in place), with the scale planes when given.

    Rows past ``q_lens`` and rows of masked-off slots must never land on a
    block (a padded slot's table row may alias blocks of live sequences).
    The JAX scatter routes them out of bounds and drops them; PyTorch's has
    no drop mode, and selecting the valid rows with a boolean mask costs a
    host synchronisation on a CUDA tensor. Here every row is written, with
    no data-dependent shape: an invalid row takes the target and the value
    of the first valid row (a duplicate write of the same bits), and when
    no row is valid, the first row's clamped target and the bits already
    stored there. So the pools change exactly at the valid rows' positions.
    With scale planes the rows are quantized first and their scales take
    the same targets by the same rule."""
    quant = _scale_planes("block_cache_append_chunk", key_scale, value_scale)
    b, c, h, d = k.shape
    n = b * c
    planes = (key_cache, value_cache) + ((key_scale, value_scale) if quant else ())
    if not n:
        return planes
    nb, bs = key_cache.shape[0], key_cache.shape[2]
    j = torch.arange(c, device=k.device)[None, :]
    pos = seq_lens.long()[:, None] + j
    valid = j < q_lens.long()[:, None]
    if slot_mask is not None:
        valid = valid & slot_mask.bool()[:, None]
    blk_idx = (pos // bs).clamp(max=block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.long(), 1, blk_idx).clamp(0, nb - 1).reshape(n)
    off = (pos % bs).reshape(n)
    valid = valid.reshape(n)
    donor = torch.argmax(valid.to(torch.int32)).reshape(1)  # the first valid row, or row 0
    any_valid = valid.any()
    d_phys, d_off = phys.index_select(0, donor), off.index_select(0, donor)
    phys = torch.where(valid, phys, d_phys)
    off = torch.where(valid, off, d_off)
    if quant:
        qk, sk = _quantize_kv_rows(k.reshape(n, h, d))
        qv, sv = _quantize_kv_rows(v.reshape(n, h, d))
        rows = (qk, qv, sk, sv)
    else:
        rows = (k.reshape(n, h, d), v.reshape(n, h, d))
    for plane, new in zip(planes, rows):
        new = new.to(plane.dtype)
        keep = valid.reshape(n, *([1] * (new.dim() - 1)))
        fill = torch.where(any_valid, new.index_select(0, donor), plane[d_phys, :, d_off])
        plane[phys, :, off] = torch.where(keep, new, fill)
    return planes


def block_cache_append(
    key_cache: torch.Tensor,  # [NB, H, BS, D], updated in place
    value_cache: torch.Tensor,
    k: torch.Tensor,  # [B, H, D] one new token per sequence
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    positions: torch.Tensor,  # [B] index of the token being written
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
    key_scale: Optional[torch.Tensor] = None,  # [NB, H, BS] fp32 (int8 pool)
    value_scale: Optional[torch.Tensor] = None,
) -> Caches:
    """Write one new token per sequence at ``positions``; a masked slot
    writes nothing (its table row may alias live sequences' blocks). The
    one-row case of :func:`block_cache_append_chunk`, so just as sync-free.
    Returns the pools (updated in place), with the scale planes when given."""
    ones = torch.ones_like(positions)
    return block_cache_append_chunk(key_cache, value_cache, k[:, None], v[:, None], block_tables, positions,
                                    ones, slot_mask=slot_mask, key_scale=key_scale, value_scale=value_scale)


def block_cache_prefill(
    key_cache: torch.Tensor,  # [NB, H, BS, D], updated in place
    value_cache: torch.Tensor,
    k: torch.Tensor,  # [B, S, H, D] prompt KV
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] prompt lengths (<= S)
    key_scale: Optional[torch.Tensor] = None,  # [NB, H, BS] fp32 (int8 pool)
    value_scale: Optional[torch.Tensor] = None,
) -> Caches:
    """Write whole prompts into the paged cache: token ``t < seq_lens[b]``
    of sequence ``b`` at position ``t``; positions past ``seq_lens`` write
    nothing. The chunk append from position 0, so just as sync-free.
    Returns the pools (updated in place), with the scale planes when given."""
    return block_cache_append_chunk(key_cache, value_cache, k, v, block_tables, torch.zeros_like(seq_lens),
                                    seq_lens, key_scale=key_scale, value_scale=value_scale)


def block_cache_cow_copy(
    key_cache: torch.Tensor,  # [NB, H, BS, D], updated in place
    value_cache: torch.Tensor,
    src: torch.Tensor,  # [B] physical block to fork from
    dst: torch.Tensor,  # [B] private destination; == NB means no fork
    key_scale: Optional[torch.Tensor] = None,  # [NB, H, BS] fp32 (int8 pool), updated in place
    value_scale: Optional[torch.Tensor] = None,
) -> Caches:
    """Copy-on-write fork: duplicate whole blocks ``src`` into ``dst`` so a
    request diverging inside a shared block never writes the shared copy.
    Entries with ``dst == NB`` are no-ops (the JAX scatter's dropped rows).
    All sources are read before any destination is written. With scale
    planes the same fork copies them: a forked int8 block is its source's
    bits, scales included. Returns the pools (updated in place)."""
    quant = _scale_planes("block_cache_cow_copy", key_scale, value_scale)
    planes = (key_cache, value_cache) + ((key_scale, value_scale) if quant else ())
    nb = key_cache.shape[0]
    dst = dst.long()
    fork = dst < nb
    src = src.long().clamp(0, nb - 1)[fork]
    dst = dst[fork]
    if dst.numel():
        for plane in planes:
            plane[dst] = plane[src]
    return planes


def _attend_q(q_lens: torch.Tensor, slot_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The chunk kernels' valid rows: ``q_lens``, 0 for a padded slot."""
    return q_lens if slot_mask is None else torch.where(slot_mask.bool(), q_lens, torch.zeros_like(q_lens))


def block_multihead_chunk_attention_fused(
    q: torch.Tensor,  # [B, C, HQ, D] PRE-rope ragged chunk
    k: torch.Tensor,  # [B, C, HKV, D] PRE-rope new keys
    v: torch.Tensor,
    cos: torch.Tensor,  # [B, C, 1, D] offset-gathered rope rows (model layout)
    sin: torch.Tensor,
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], updated in place
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] tokens cached, EXCLUDING this chunk
    q_lens: torch.Tensor,  # [B] valid new tokens (1 = decode row)
    scale: Optional[float] = None,
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
    key_scale: Optional[torch.Tensor] = None,  # [NB, HKV, BS] fp32 (int8 pool), updated in place
    value_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One mixed prefill/decode step of one layer: rope k, append the chunk's
    KV to the cache (in place; quantized after the rope for the int8 pool),
    then attend with q's rope folded into the paged kernel (A). Returns
    ``(out [B, C, HQ, D], key_cache, value_cache)`` plus the scale planes
    when given; rows past ``q_lens`` and masked slots are exact zeros. A head
    dim that is not a multiple of 64, which the JAX package cannot lower to
    its kernel, takes its composition here too: q roped by
    ``_rope_apply_xla``, then the dense-gather attention."""
    b, c, _, d = q.shape
    k = _rope_apply_xla(k, sin, cos, True)
    pools = block_cache_append_chunk(key_cache, value_cache, k, v, block_tables, seq_lens, q_lens,
                                     slot_mask=slot_mask, key_scale=key_scale, value_scale=value_scale)
    attend_q = _attend_q(q_lens, slot_mask)
    if d % 64:
        out = _gather_chunk_attend(
            _rope_apply_xla(q, sin, cos, True), key_cache, value_cache, block_tables, seq_lens,
            attend_q, 1.0 / d**0.5 if scale is None else scale, key_scale, value_scale,
        )
    else:
        out = paged_flash_chunk_fused(
            q, cos.reshape(b, c, d), sin.reshape(b, c, d), key_cache, value_cache,
            block_tables, seq_lens, attend_q, scale=scale, k_scale=key_scale, v_scale=value_scale,
        )
    return (out, *pools)


def block_multihead_chunk_attention(
    q: torch.Tensor,  # [B, C, HQ, D] ragged chunk, roped
    k: torch.Tensor,  # [B, C, HKV, D] roped new keys
    v: torch.Tensor,
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], updated in place
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] tokens cached, EXCLUDING this chunk
    q_lens: torch.Tensor,  # [B] valid new tokens (1 = decode row)
    scale: Optional[float] = None,
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
    key_scale: Optional[torch.Tensor] = None,  # [NB, HKV, BS] fp32 (int8 pool), updated in place
    value_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One mixed prefill/decode step of one layer over the paged cache (the
    unfused serving step): append the chunk's KV, then attend — kernel 4,
    or the dense-gather composition for a head dim that is not a multiple
    of 64. Query token ``j`` sees positions ``<= seq_lens + j``; rows past
    ``q_lens`` and masked slots are exact zeros. Returns ``(out [B, C, HQ,
    D], key_cache, value_cache)`` plus the scale planes when given."""
    pools = block_cache_append_chunk(key_cache, value_cache, k, v, block_tables, seq_lens, q_lens,
                                     slot_mask=slot_mask, key_scale=key_scale, value_scale=value_scale)
    attend_q = _attend_q(q_lens, slot_mask)
    d = q.shape[-1]
    if d % 64:
        out = _gather_chunk_attend(q, key_cache, value_cache, block_tables, seq_lens, attend_q,
                                   1.0 / d**0.5 if scale is None else scale, key_scale, value_scale)
    else:
        out = paged_flash_chunk(q, key_cache, value_cache, block_tables, seq_lens, attend_q, scale=scale,
                                k_scale=key_scale, v_scale=value_scale)
    return (out, *pools)


def _decode_lens(seq_lens: torch.Tensor, slot_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The decode kernels' lengths: INCLUDING the token just appended, 0 for
    a padded slot."""
    attend = seq_lens + 1
    return attend if slot_mask is None else torch.where(slot_mask.bool(), attend, torch.zeros_like(attend))


def block_multihead_attention(
    q: torch.Tensor,  # [B, 1, HQ, D] decode query, roped
    k: torch.Tensor,  # [B, 1, HKV, D] roped new key
    v: torch.Tensor,
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], updated in place
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] tokens cached, EXCLUDING this one
    scale: Optional[float] = None,
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
    key_scale: Optional[torch.Tensor] = None,  # [NB, HKV, BS] fp32 (int8 pool), updated in place
    value_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One paged decode step of one layer: append the new KV, attend over
    the sequence's blocks with lengths ``seq_lens + 1`` — kernel 5, or the
    dense-gather composition for a head dim that is not a multiple of 64.
    A masked slot appends nothing and returns exact zeros. Returns ``(out
    [B, 1, HQ, D], key_cache, value_cache)`` plus the scale planes when
    given."""
    pools = block_cache_append(key_cache, value_cache, k[:, 0], v[:, 0], block_tables, seq_lens,
                               slot_mask=slot_mask, key_scale=key_scale, value_scale=value_scale)
    attend_lens = _decode_lens(seq_lens, slot_mask)
    d = q.shape[-1]
    if d % 64:
        out = _gather_chunk_attend(q, key_cache, value_cache, block_tables, seq_lens,
                                   (attend_lens > 0).to(seq_lens.dtype), 1.0 / d**0.5 if scale is None else scale,
                                   key_scale, value_scale)
    else:
        out = paged_flash_decode(q[:, 0], key_cache, value_cache, block_tables, attend_lens, scale=scale,
                                 k_scale=key_scale, v_scale=value_scale)[:, None]
    return (out, *pools)


def block_multihead_attention_fused(
    q: torch.Tensor,  # [B, 1, HQ, D] PRE-rope decode query
    k: torch.Tensor,  # [B, 1, HKV, D] PRE-rope new key
    v: torch.Tensor,
    cos: torch.Tensor,  # [B, 1, 1, D] the slots' rope rows (model layout)
    sin: torch.Tensor,
    key_cache: torch.Tensor,  # [NB, HKV, BS, D], updated in place
    value_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] tokens cached, EXCLUDING this one
    scale: Optional[float] = None,
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
    key_scale: Optional[torch.Tensor] = None,  # [NB, HKV, BS] fp32 (int8 pool), updated in place
    value_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """:func:`block_multihead_attention` with rope folded in: k is roped by
    ``_rope_apply_xla`` and appended (quantized after the rope for the int8
    pool), q is roped inside the decode walk (kernel 6); a head dim that is
    not a multiple of 64 takes the composition (q roped the same way, then
    the dense gather)."""
    b, _, _, d = q.shape
    k = _rope_apply_xla(k, sin, cos, True)
    pools = block_cache_append(key_cache, value_cache, k[:, 0], v[:, 0], block_tables, seq_lens,
                               slot_mask=slot_mask, key_scale=key_scale, value_scale=value_scale)
    attend_lens = _decode_lens(seq_lens, slot_mask)
    if d % 64:
        out = _gather_chunk_attend(_rope_apply_xla(q, sin, cos, True), key_cache, value_cache, block_tables,
                                   seq_lens, (attend_lens > 0).to(seq_lens.dtype),
                                   1.0 / d**0.5 if scale is None else scale, key_scale, value_scale)
    else:
        out = paged_flash_decode_fused(q[:, 0], cos.reshape(b, 1, d), sin.reshape(b, 1, d), key_cache,
                                       value_cache, block_tables, attend_lens, scale=scale,
                                       k_scale=key_scale, v_scale=value_scale)[:, None]
    return (out, *pools)
