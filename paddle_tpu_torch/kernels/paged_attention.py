"""Rope-fused paged attention over a mixed ragged chunk: CUDA kernel and
plain version.

Port of ``paddle_tpu/kernels/paged_attention.py`` ``_chunk_fused_kernel``
(launched by ``paged_flash_chunk_fused``, kernel A of the serving step).
Each slot carries up to ``C`` new query tokens — a decode row has
``q_lens == 1``, a prompt chunk up to ``C``, an idle slot 0. Query row ``j``
of slot ``b`` is roped (neox, in q's dtype) and attends over positions
``< lens[b] + j + 1`` of the slot's paged KV blocks (keys were roped on
append); rows ``j >= q_lens[b]`` are exact zeros.

:func:`paged_flash_chunk_fused` runs :func:`paged_flash_chunk_fused_plain`
for CPU tensors and launches ``csrc/paged_chunk_fused.cu`` for CUDA tensors,
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "paged_flash_chunk_fused",
    "paged_flash_chunk_fused_plain",
    "rope_rows",
    "_gather_chunk_attend",
]

NEG_INF = -1e30  # the Pallas kernel's masked score
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL_HEAD_DIMS = (64, 128)


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
) -> torch.Tensor:
    """Dense-gather attention, the JAX package's ``_gather_chunk_attend``:
    gather each slot's used blocks, mask row ``j`` to positions
    ``< seq_lens + j + 1``, fp32 softmax; rows past ``attend_q`` are exact
    zeros. Table entries past the used blocks are clamped into range for the
    gather; what they point at is masked."""
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
) -> torch.Tensor:
    """The kernel's plain version: rope q in its dtype, then
    :func:`_gather_chunk_attend`."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    qr = rope_rows(q, cos[:, :, None, :], sin[:, :, None, :])
    return _gather_chunk_attend(
        qr, key_cache, value_cache, block_tables, seq_lens, q_lens, scale
    )


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
) -> torch.Tensor:
    """Attention of a ragged chunk over the paged cache with q-rope folded
    in; the signature of the JAX package's ``paged_flash_chunk_fused``.
    ``cos``/``sin`` are the per-token rope rows ``[B, C, D]``."""
    if q.device.type == "cpu":
        return paged_flash_chunk_fused_plain(
            q, cos, sin, key_cache, value_cache, block_tables, seq_lens, q_lens, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_chunk_fused: unsupported device {q.device}")
    b, c, hq, d = q.shape
    nb, hkv, bs, d_c = key_cache.shape
    mbs = block_tables.shape[1]
    if d_c != d or hq % hkv or value_cache.shape != key_cache.shape:
        raise ValueError(
            f"paged_flash_chunk_fused: q {tuple(q.shape)} does not fit the cache "
            f"{tuple(key_cache.shape)} / {tuple(value_cache.shape)}"
        )
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_flash_chunk_fused: the CUDA kernel takes head dim 64 or 128, not {d} "
                         "(a head dim that is not a multiple of 64 takes the composition)")
    if cos.shape != (b, c, d) or sin.shape != (b, c, d):
        raise ValueError(f"paged_flash_chunk_fused: rope rows must be [{b}, {c}, {d}]")
    if block_tables.shape[0] != b or seq_lens.shape != (b,) or q_lens.shape != (b,):
        raise ValueError("paged_flash_chunk_fused: tables/lens/q_lens do not match the batch")
    if scale is None:
        scale = 1.0 / d**0.5
    dev = q.device
    for name, t in (("q", q), ("key_cache", key_cache), ("value_cache", value_cache)):
        if t.device != dev or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"paged_flash_chunk_fused: the CUDA kernel takes bf16 only: {name} must be a "
                             f"contiguous bf16 tensor on {dev}, got {t.dtype} on {t.device}")
    # the kernel reads the rope rows in q's dtype, as the Pallas kernel casts them
    cos_q = cos.to(device=dev, dtype=q.dtype).contiguous()
    sin_q = sin.to(device=dev, dtype=q.dtype).contiguous()
    tables32 = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens32 = seq_lens.to(device=dev, dtype=torch.int32).contiguous()
    qlens32 = q_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b and c:
        fn = build.kernel_fn(
            "ptt_paged_chunk_fused_bf16",
            [_P] * 9 + [_I] * 7 + [_F, _P],
        )
        with torch.cuda.device(dev):
            err = fn(
                q.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(), key_cache.data_ptr(),
                value_cache.data_ptr(), tables32.data_ptr(), lens32.data_ptr(),
                qlens32.data_ptr(), out.data_ptr(), b, c, hq, hkv, d, bs, mbs, float(scale),
                torch.cuda.current_stream().cuda_stream,
            )
        build.check(err, "paged_chunk_fused")
        count_launch("paged_chunk_fused")
    return out
