"""FlashMask attention entry (port of ``paddle_tpu/kernels/flashmask.py``).

FlashMask encodes a column-sparse attention mask as row bounds per key
column, ``startend_row_indices [B, Hm, Sk, C]`` with ``C`` in ``{1, 2, 4}``
— O(S) mask memory for the causal, document, sliding-window and
global-token mask families. The flash-attention kernels
(:mod:`paddle_tpu_torch.kernels.flash_attention`) read the bounds per key
tile; the dense mask never exists.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.kernels.flash_attention import flash_attention

__all__ = ["flashmask_attention", "flashmask_maxmin"]


def flashmask_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    startend_row_indices: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """FlashMask attention over ``[B, S, H, D]``.

    ``startend_row_indices``: int32 ``[B, Hm, Sk, C]``, ``Hm`` in ``{1, H}``:

    - C == 1 (causal): query rows ``[start_j, Sq)`` masked for column j;
    - C == 2 (causal): rows ``[start_j, end_j)`` masked;
    - C == 4: ``[LTS, LTE, UTS, UTE]`` lower/upper-triangle row bands.
    """
    if startend_row_indices.dtype != torch.int32:
        raise TypeError(f"startend_row_indices must be int32, got {startend_row_indices.dtype}")
    return flash_attention(q, k, v, startend_row_indices, causal=causal, scale=scale)


def flashmask_maxmin(startend_row_indices: torch.Tensor, block_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key-block min and max of the mask bounds, ``[B, Hm, num_blocks, C]``
    each (the last block padded with its edge value): the block-skip
    metadata of the reference's ``flashmask_maxmin`` precompute."""
    b, hm, sk, c = startend_row_indices.shape
    pad = (-sk) % block_size
    idx = startend_row_indices
    if pad:
        idx = torch.cat([idx, idx[:, :, -1:].expand(b, hm, pad, c)], dim=2)
    blocks = idx.reshape(b, hm, -1, block_size, c)
    return blocks.amin(dim=3), blocks.amax(dim=3)
