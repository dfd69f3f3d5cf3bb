"""Paged KV cache for the continuous-batching engine: the host-side block
allocator and the device-side cache operations of one serving step.

Port of the serving half of ``paddle_tpu/incubate/nn/functional/
block_attention.py``. The cache layout is the JAX package's: one
``[NB, HKV, BS, D]`` key pool and one value pool per layer, addressed by
``[B, MBS]`` block tables. Where the JAX functions return updated caches
(JAX arrays are immutable), these update the caches in place and say so.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.incubate.nn.functional import _rope_apply_xla
from paddle_tpu_torch.kernels.paged_attention import (  # noqa: F401  (re-export)
    _gather_chunk_attend,
    paged_flash_chunk_fused,
)

__all__ = [
    "BlockKVCache",
    "block_cache_append_chunk",
    "block_cache_cow_copy",
    "block_multihead_chunk_attention_fused",
    "_gather_chunk_attend",
]


class BlockKVCache:
    """Host-side refcounted allocator over the physical block pool.

    The serving engine maps blocks into per-slot tables with
    :meth:`acquire_block` and hands them back with :meth:`decref`; a block
    returns to the free list only when its last owner drops it. Accounting is
    guarded by one lock (a serving front end may size requests against
    ``free_blocks`` from another thread). The device pools themselves belong
    to the engine, one pair per layer."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO over block ids, lowest id first out — the JAX allocator's order
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}

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


def block_cache_append_chunk(
    key_cache: torch.Tensor,  # [NB, H, BS, D], updated in place
    value_cache: torch.Tensor,
    k: torch.Tensor,  # [B, C, H, D] up to C new tokens per sequence
    v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MBS]
    seq_lens: torch.Tensor,  # [B] tokens already stored (the chunk goes after them)
    q_lens: torch.Tensor,  # [B] valid new tokens (0 = none)
    slot_mask: Optional[torch.Tensor] = None,  # [B] bool; False = padded slot
) -> None:
    """Write token ``j`` of sequence ``b`` at position ``seq_lens[b] + j``.

    Rows past ``q_lens`` and rows of masked-off slots must never land on a
    block (a padded slot's table row may alias blocks of live sequences).
    The JAX scatter routes them out of bounds and drops them; PyTorch's has
    no drop mode, and selecting the valid rows with a boolean mask costs a
    host synchronisation on a CUDA tensor. Here every row is written, with
    no data-dependent shape: an invalid row takes the target and the value
    of the first valid row (a duplicate write of the same bits), and when
    no row is valid, the first row's clamped target and the bits already
    stored there. So the pools change exactly at the valid rows' positions."""
    b, c, h, d = k.shape
    n = b * c
    if not n:
        return
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
    for cache, new in ((key_cache, k), (value_cache, v)):
        rows = new.reshape(n, h, d).to(cache.dtype)
        fill = torch.where(any_valid, rows.index_select(0, donor), cache[d_phys, :, d_off])
        cache[phys, :, off] = torch.where(valid[:, None, None], rows, fill)


def block_cache_cow_copy(
    key_cache: torch.Tensor,  # [NB, H, BS, D], updated in place
    value_cache: torch.Tensor,
    src: torch.Tensor,  # [B] physical block to fork from
    dst: torch.Tensor,  # [B] private destination; == NB means no fork
) -> None:
    """Copy-on-write fork: duplicate whole blocks ``src`` into ``dst`` so a
    request diverging inside a shared block never writes the shared copy.
    Entries with ``dst == NB`` are no-ops (the JAX scatter's dropped rows).
    All sources are read before any destination is written."""
    nb = key_cache.shape[0]
    dst = dst.long()
    fork = dst < nb
    src = src.long().clamp(0, nb - 1)[fork]
    dst = dst[fork]
    if dst.numel():
        key_cache[dst] = key_cache[src]
        value_cache[dst] = value_cache[src]


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
) -> torch.Tensor:
    """One mixed prefill/decode step of one layer: rope k, append the chunk's
    KV to the cache (in place), then attend with q's rope folded into the
    paged kernel (A). Returns the attention output ``[B, C, HQ, D]``; rows
    past ``q_lens`` and masked slots are exact zeros. A head dim that is not
    a multiple of 64, which the JAX package cannot lower to its kernel,
    takes its composition here too: q roped by ``_rope_apply_xla``, then
    the dense-gather attention."""
    b, c, _, d = q.shape
    k = _rope_apply_xla(k, sin, cos, True)
    block_cache_append_chunk(
        key_cache, value_cache, k, v, block_tables, seq_lens, q_lens, slot_mask=slot_mask
    )
    attend_q = q_lens
    if slot_mask is not None:
        attend_q = torch.where(slot_mask.bool(), q_lens, torch.zeros_like(q_lens))
    if d % 64:
        return _gather_chunk_attend(
            _rope_apply_xla(q, sin, cos, True), key_cache, value_cache, block_tables, seq_lens,
            attend_q, 1.0 / d**0.5 if scale is None else scale,
        )
    return paged_flash_chunk_fused(
        q, cos.reshape(b, c, d), sin.reshape(b, c, d), key_cache, value_cache,
        block_tables, seq_lens, attend_q, scale=scale,
    )
