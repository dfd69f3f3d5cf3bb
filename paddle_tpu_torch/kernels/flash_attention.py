"""Flash attention with FlashMask bounds — forward, dq and dk/dv: CUDA
kernels, their plain versions, and the autograd ``Function`` that joins them.

Port of ``paddle_tpu/kernels/flash_attention.py``:

- :func:`flash_fwd` — ``_fwd_kernel`` (kernel 14): online softmax over key
  tiles up to the causal limit, FlashMask bounds read per key column; writes
  ``out`` and the row logsumexp ``lse``;
- :func:`flash_bwd_dq` — ``_bwd_dq_kernel`` (kernel 15): ``dq`` from ``lse``
  and ``delta = sum(g * out)``;
- :func:`flash_bwd_dkv` — ``_bwd_dkv_kernel`` (kernel 16): ``dk``/``dv``,
  here per KV head with the group's query heads summed inside the kernel (the
  Pallas kernel writes fp32 per-query-head partials and sums them outside).

Layouts are the public ones: ``q [B, Sq, H, D]``, ``k``/``v [B, Sk, HK, D]``
(``H % HK == 0``; query head ``h`` reads KV head ``h // (H // HK)``),
FlashMask ``bounds [B, Hm, Sk, C]`` int32 with ``Hm`` in ``{1, H}`` and ``C``
in ``{1, 2, 4}``, ``lse`` and ``delta [B, H, Sq]`` fp32.

Semantics kept from the Pallas kernels: the forward scales q before
``q k^T``, the backward kernels scale the product; a masked logit
contributes exactly 0. One deliberate difference: a row whose every column
is masked (only a FlashMask that masks the row's own diagonal makes one) is
written as 0 with ``lse = +inf`` and gets zero gradients; the Pallas forward
returns there an average of V over the columns it visited, which depends on
its block size (the XLA path a uniform average over all columns).

Each wrapper runs its plain PyTorch version for CPU tensors; for CUDA
tensors it launches ``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` or
``csrc/flash_bwd_dkv.cu`` (bf16 and fp16 up to head dim 256); above 256 in
bf16 and fp16 the forward ``csrc/flash_fwd_wide.cu`` and dq and dk/dv
``csrc/flash_bwd_wide.cu`` (tensor cores, the outputs' columns over
warpgroups and CTAs: :func:`flash_fwd_wide_plan`,
:func:`flash_bwd_wide_plan`); in fp32 up to head dim 256 the forward
``csrc/flash_fwd_tf32.cu`` and dq and dk/dv ``csrc/flash_bwd_tf32.cu``
(tensor cores, each product in three TF32 passes of split operands:
:func:`flash_fwd_fp32_plan`, :func:`flash_bwd_fp32_plan`), all three at
320 to 512 ``csrc/flash_fp32.cu``, every kernel above 512
``csrc/flash_deep.cu`` (CUDA cores, its head dim a runtime value) — or
raises; it never falls back. On the card
the kernels take q, k, v (and g) of one dtype, bf16, fp16 or fp32, and every
head dim that is a multiple of 64, as the JAX package's gate sends them.

Kernels 14 and 15 walk the key tiles of a query tile, kernel 16 the query
tiles of a key tile (and the fp32 instances of all three likewise), under
FlashMask *tile classes* computed on the card from the bounds: a tile whose
every logit is masked is skipped (no copy, no product), one with no masked
logit runs without the mask.
:func:`flash_tile_classes` is the same classing in PyTorch, for the tests
and for ``chip_smoke.py``'s share of tiles visited; no wrapper calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "FlashAttentionFunction",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_bwd_fp32_plan",
    "flash_bwd_wide_plan",
    "flash_fwd",
    "flash_fwd_fp32_plan",
    "flash_fwd_plain",
    "flash_fwd_wide_plan",
    "flash_masked",
    "flash_tile_classes",
    "flash_tile_shape",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the head dims of the template instances (the wgmma kernels to 256, csrc/flash_fp32.cu's fp32 ones to 512);
# every multiple of 64 above them runs a runtime-D kernel: csrc/flash_fwd_wide.cu and csrc/flash_bwd_wide.cu
# in bf16 / fp16 above 256, csrc/flash_deep.cu in fp32 above 512
KERNEL_HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512)
WGMMA_HEAD_DIM_MAX = 256  # above it bf16 and fp16 take the wide kernels (csrc/flash_fwd_wide.cu, flash_bwd_wide.cu)
# csrc/flash_fwd_wide.cu's shared-memory plan (WidePlan there)
_WIDE_BOX = 64 * 128  # a [64 rows][64 columns] box of a 2-byte type
_WIDE_WG_BOXES = 4  # a consumer warpgroup's O: at most 4 boxes (256 columns) (kMaxWgBoxes there)
_WIDE_MIN_STAGES, _WIDE_MAX_STAGES = 4, 8
_WIDE_STG_INTS = 2048
_WIDE_SMEM = 227 * 1024
_WIDE_SLOT_SIDE = 64 * 2 * 4 + 8  # a slot's row masks and info word
_WIDE_FIXED = _WIDE_STG_INTS * 4 + (2 + 2 * _WIDE_MAX_STAGES) * 8 + 16 + 1024
# csrc/flash_bwd_wide.cu's plan (BwdPlan there): the same boxes, staging and limits, a slot's side also
# carries the rows' lse / delta, and dk/dv hands an fp32 64 x 64 P^T tile between its warpgroups
_BWD_SLOT_SIDE = 64 * 8 + 2 * 64 * 4 + 8
_BWD_XBYTES = 64 * 64 * 4
# fp32 flash kernels: csrc/flash_fwd_tf32.cu and csrc/flash_bwd_tf32.cu to here, csrc/flash_fp32.cu's CUDA cores above
TF32_HEAD_DIM_MAX = 256
# csrc/flash_fwd_tf32.cu's shared-memory rule (tf32_smem / tf32_keys there)
_TF32_ROWS = 64
_SMEM_PER_SM, _SMEM_RESERVED, _SMEM_PER_BLOCK = 228 * 1024, 1024, 227 * 1024
# csrc/flash_bwd_tf32.cu's plan: dq's (warps, keys) candidates in order; dk/dv's CTA of 8 warps over 64 keys
_DQ_SHAPES = ((8, 32), (4, 32), (4, 16))
_DKV_KEYS, _DKV_WARPS = 64, 8
_MASK_C = (1, 2, 4)
_KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}

# tile classes (csrc/flash_common.cuh TileClass)
SKIP, PARTIAL, FULL = 0, 1, 2


def _simt(dtype: torch.dtype) -> bool:
    """Whether the flash kernels in ``dtype`` run on the fp32 instances
    (``csrc/flash_fwd_tf32.cu``, ``csrc/flash_bwd_tf32.cu``,
    ``csrc/flash_fp32.cu``, ``csrc/flash_deep.cu``): fp32, at every head
    dim; bf16 and fp16 run on the wgmma kernels at every head dim."""
    return dtype == torch.float32


def _tf32_smem(d: int, keys: int) -> int:
    return 4 * (_TF32_ROWS * (d + 8) + 2 * keys * (d + 8) + 2 * keys * (d + 4))


def flash_fwd_fp32_plan(d: int) -> dict:
    """Which walk the fp32 forward takes at head dim ``d`` (64 to 512), a
    mirror of ``ptt_flash_fwd_fp32_plan`` in ``csrc/flash_fwd_tf32.cu``
    (``chip_smoke.py`` holds the two equal on the card). Up to 256
    ``"tf32x3"`` (``csrc/flash_fwd_tf32.cu``) with its geometry: a CTA of 4
    warps owns 64 query rows, K / V tiles of 64 keys where two CTAs fit an
    SM's 228 KB, else 32, two buffers of each, q, K and V in fp32 shared
    memory with rows padded by 8, 8 and 4 floats (``smem`` bytes). From 320
    to 512 ``"cuda_cores"`` alone (``csrc/flash_fp32.cu``'s forward, whose
    geometry is its own): the 3xTF32 walk would hold D / 2 fp32
    accumulators a thread and 64 rows of q beside two K / V buffers, past
    the 255 registers and the 227 KB a CTA has. Above 512 the forward runs
    ``csrc/flash_deep.cu``, which this plan does not cover."""
    if d <= 0 or d % 64 or d > KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"the fp32 forward plan covers the multiples of 64 up to {KERNEL_HEAD_DIMS[-1]}, not {d}")
    if d <= TF32_HEAD_DIM_MAX:
        keys = 64 if 2 * (_tf32_smem(d, 64) + _SMEM_RESERVED) <= _SMEM_PER_SM else 32
        return {"walk": "tf32x3", "rows": _TF32_ROWS, "keys": keys, "stages": 2, "smem": _tf32_smem(d, keys)}
    return {"walk": "cuda_cores"}


def _dq_smem(d: int, warps: int, keys: int) -> int:
    return 4 * (2 * 16 * warps + 4 * keys) * (d + 4)


def _dkv_smem(d: int, rows: int) -> int:
    return 4 * (2 * _DKV_KEYS * (d + 4) + 4 * rows * (d + 4) + _DKV_KEYS * rows + 4 * rows)


def flash_bwd_fp32_plan(d: int, kernel: str) -> dict:
    """Which walk the fp32 dq (``kernel`` ``"flash_bwd_dq"``) or dk/dv
    (``"flash_bwd_dkv"``) takes at head dim ``d`` (64 to 512), a mirror of
    ``ptt_flash_bwd_fp32_plan`` in ``csrc/flash_bwd_tf32.cu``
    (``chip_smoke.py`` holds the two equal on the card). Up to 256
    ``"tf32x3"`` (``csrc/flash_bwd_tf32.cu``) with its geometry, every fp32
    row staged with 4 floats of padding. dq: a CTA of ``warps`` warps owns
    ``rows`` = 16 x warps query rows with q and g resident and walks K / V
    tiles of ``keys`` keys in two buffers; (warps, keys) the first of (8,
    32), (4, 32), (4, 16) whose CTA fits 227 KB. dk/dv: a CTA of 8 warps (two
    warpgroups: P^T handed from the first to the second) owns ``keys`` = 64
    keys with K and V resident and walks q / g tiles of ``rows`` query rows
    in two buffers; rows the first of 64, 32, 16 whose CTA fits 227 KB.
    ``stages`` the buffers, ``smem`` the CTA's dynamic shared-memory bytes.
    From 320 to 512 ``"cuda_cores"`` alone (``csrc/flash_fp32.cu``, whose
    geometry is its own): the 3xTF32 walks would hold D / 2 fp32
    accumulators a thread beside their products, past the 255 registers a
    thread has. Above 512 dq and dk/dv run ``csrc/flash_deep.cu``, which
    this plan does not cover."""
    if kernel not in ("flash_bwd_dq", "flash_bwd_dkv"):
        raise ValueError(f"{kernel} is not a flash backward kernel")
    if d <= 0 or d % 64 or d > KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"the fp32 backward plan covers the multiples of 64 up to {KERNEL_HEAD_DIMS[-1]}, not {d}")
    if d > TF32_HEAD_DIM_MAX:
        return {"walk": "cuda_cores"}
    if kernel == "flash_bwd_dq":
        warps, keys = next((w, n) for w, n in _DQ_SHAPES if _dq_smem(d, w, n) <= _SMEM_PER_BLOCK)
        return {"walk": "tf32x3", "rows": 16 * warps, "keys": keys, "stages": 2, "smem": _dq_smem(d, warps, keys),
                "warps": warps}
    rows = next(r for r in (64, 32, 16) if _dkv_smem(d, r) <= _SMEM_PER_BLOCK)
    return {"walk": "tf32x3", "rows": rows, "keys": _DKV_KEYS, "stages": 2, "smem": _dkv_smem(d, rows),
            "warps": _DKV_WARPS}


def flash_tile_shape(kernel: str, d: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """``(BM, BN)`` of the tile walk that ``kernel`` (``"flash_fwd"``,
    ``"flash_bwd_dq"`` or ``"flash_bwd_dkv"``) classes at head dim ``d``:
    the query rows and keys of one (query tile, key tile) pair. bf16/fp16
    up to D 256: the forward 128 x 128 (128 x 64 at D 192 and 256), dq 128
    x 64, dk/dv 64 query rows x 64 keys; bf16/fp16 above 256 (the wide
    kernels, ``csrc/flash_fwd_wide.cu`` and ``csrc/flash_bwd_wide.cu``) 64
    x 64 for all three; fp32 up to 256: the forward (``csrc/flash_fwd_tf32.cu``)
    64 x :func:`flash_fwd_fp32_plan`'s keys (64 at D 64, else 32), dq and
    dk/dv (``csrc/flash_bwd_tf32.cu``) :func:`flash_bwd_fp32_plan`'s rows x
    keys; above 256 the CUDA-core instances forward and dq 16 x 32, dk/dv 32
    query rows x 16 keys."""
    if kernel not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        raise ValueError(f"{kernel} is not a flash kernel")
    if _simt(dtype):
        if d <= TF32_HEAD_DIM_MAX:
            plan = flash_fwd_fp32_plan(d) if kernel == "flash_fwd" else flash_bwd_fp32_plan(d, kernel)
            return (plan["rows"], plan["keys"])
        return (32, 16) if kernel == "flash_bwd_dkv" else (16, 32)
    if d > WGMMA_HEAD_DIM_MAX:
        return (64, 64)
    if kernel == "flash_fwd":
        return (128, 128) if d <= 128 else (128, 64)
    if kernel == "flash_bwd_dq":
        return (128, 64)
    return (64, 64)


def flash_fwd_wide_plan(d: int) -> dict:
    """The launch plan of ``csrc/flash_fwd_wide.cu`` (the bf16 / fp16
    forward above head dim 256) at head dim ``d``, a mirror of its
    ``wide_plan`` (``chip_smoke.py`` holds the two equal on the card): a
    CTA owns 64 query rows, and its two consumer warpgroups each own a
    share of O's D / 64 column boxes (``boxes``), each computing the scores
    over all of D. ``split`` CTAs a query tile and ``nw`` boxes each
    warpgroup computes (the kernel's instance): of 1 to ceil(boxes / 2)
    CTAs the one whose products cost least, 2 split (boxes + nw), nw at most
    4; ``wg_boxes`` the (first box, count) each of the 2 split warpgroups
    stores, as even as floors allow (one with count nw - 1 recomputes its
    neighbour's first box); ``stream_q`` True where Q (64 rows x D) cannot
    stay resident beside 4 ring slots and rides in the K slots instead;
    ``stages`` the ring's slots; ``smem`` the CTA's dynamic shared-memory
    bytes."""
    if d <= WGMMA_HEAD_DIM_MAX or d % 64:
        raise ValueError(f"the wide forward takes head dims above {WGMMA_HEAD_DIM_MAX} that are multiples of 64, "
                         f"not {d}")
    boxes = d // 64
    best = None
    for sp in range(-(-boxes // (2 * _WIDE_WG_BOXES)), (boxes + 1) // 2 + 1):
        w = -(-boxes // (2 * sp))
        cost = 2 * sp * (boxes + w)
        if best is None or cost < best[0]:
            best = (cost, sp, w)
    _, split, nw = best
    q = boxes * _WIDE_BOX
    stream_q = _WIDE_SMEM - _WIDE_FIXED - q < _WIDE_MIN_STAGES * (2 * _WIDE_BOX + _WIDE_SLOT_SIDE)
    if stream_q:
        q = 0
    slot = (4 if stream_q else 2) * _WIDE_BOX
    stages = min(_WIDE_MAX_STAGES, (_WIDE_SMEM - _WIDE_FIXED - q) // (slot + _WIDE_SLOT_SIDE))
    mask = q + stages * slot
    info = mask + stages * 64 * 2 * 4
    stg = info + (stages * 8 + 15) // 16 * 16
    bar = stg + _WIDE_STG_INTS * 4
    item = bar + (2 + 2 * stages) * 8
    n = 2 * split
    wg = [(g * boxes // n, (g + 1) * boxes // n - g * boxes // n) for g in range(n)]
    return {"boxes": boxes, "nw": nw, "split": split, "wg_boxes": wg, "stream_q": stream_q, "stages": stages,
            "smem": item + 16 + 1024}


def flash_bwd_wide_plan(d: int, kernel: str) -> dict:
    """The launch plan of ``csrc/flash_bwd_wide.cu`` (the bf16 / fp16 dq,
    ``kernel`` ``"flash_bwd_dq"``, and dk/dv, ``"flash_bwd_dkv"``, above
    head dim 256) at head dim ``d``, a mirror of its ``bwd_plan``
    (``chip_smoke.py`` holds the two equal on the card). A tile of 64 rows
    (dq: query rows; dk/dv: keys) is split over ``split`` CTAs, and the
    output's D / 64 column boxes (``boxes``) over ``groups`` owners, each at
    most 4 boxes: dq's owners are the 2 split consumer warpgroups (split =
    ceil(boxes / 8)), each computing S and dP over all of D; dk/dv's are the
    split CTAs (split = ceil(boxes / 4)), whose warpgroup 0 computes S^T
    and dV and warpgroup 1 dP^T and dK on the CTA's block. ``nw`` the boxes
    each owner computes (the kernel's instance, 3 or 4); ``owner_boxes`` the
    (first box, count) each owner stores, as even as floors allow (one with
    count nw - 1 recomputes its neighbour's first box); ``stream`` True
    where the resident pair (dq: Q and g; dk/dv: K and V, 64 rows x D each)
    cannot stay beside 4 ring slots (and dk/dv's 16 KB P^T buffer) and
    rides in the ring instead; ``stages`` the ring's slots; ``smem`` the
    CTA's dynamic shared-memory bytes."""
    if kernel not in ("flash_bwd_dq", "flash_bwd_dkv"):
        raise ValueError(f"{kernel} is not a flash backward kernel")
    if d <= WGMMA_HEAD_DIM_MAX or d % 64:
        raise ValueError(f"the wide backward takes head dims above {WGMMA_HEAD_DIM_MAX} that are multiples of 64, "
                         f"not {d}")
    dkv = kernel == "flash_bwd_dkv"
    boxes = d // 64
    split = -(-boxes // _WIDE_WG_BOXES) if dkv else -(-boxes // (2 * _WIDE_WG_BOXES))
    groups = split if dkv else 2 * split
    nw = -(-boxes // groups)
    xbytes = _BWD_XBYTES if dkv else 0
    res = 2 * boxes * _WIDE_BOX
    stream = _WIDE_SMEM - _WIDE_FIXED - xbytes - res < _WIDE_MIN_STAGES * (2 * _WIDE_BOX + _BWD_SLOT_SIDE)
    if stream:
        res = 0
    slot = (4 if stream else 2) * _WIDE_BOX
    stages = min(_WIDE_MAX_STAGES, (_WIDE_SMEM - _WIDE_FIXED - xbytes - res) // (slot + _BWD_SLOT_SIDE))
    mask = res + stages * slot + xbytes
    info = mask + stages * 64 * 8 + stages * 2 * 64 * 4
    stg = info + (stages * 8 + 15) // 16 * 16
    bar = stg + _WIDE_STG_INTS * 4
    item = bar + (2 + 2 * stages) * 8
    owners = [(g * boxes // groups, (g + 1) * boxes // groups - g * boxes // groups) for g in range(groups)]
    return {"boxes": boxes, "nw": nw, "split": split, "groups": groups, "owner_boxes": owners, "stream": stream,
            "stages": stages, "smem": item + 16 + 1024}


# -- the mask ----------------------------------------------------------------

def flash_masked(sq: int, sk: int, causal: bool, bounds: Optional[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """True where a logit is masked, ``[B|1, Hm|1, Sq, Sk]`` — the dense form
    of the Pallas kernels' ``_mask_block``: causal ``col > row + (Sk - Sq)``,
    and per key column ``j`` of ``bounds``: C=1 rows ``>= start_j``; C=2 rows
    in ``[start_j, end_j)``; C=4 rows in ``[LTS, LTE)`` or ``[UTS, UTE)``."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    if causal:
        masked = cols > rows + (sk - sq)
    else:
        masked = torch.zeros((sq, sk), dtype=torch.bool, device=device)
    masked = masked[None, None]
    if bounds is None:
        return masked
    c = bounds.shape[-1]
    if c not in _MASK_C:
        raise ValueError(f"FlashMask C must be 1/2/4, got {c}")
    bnd = bounds.to(device=device, dtype=torch.long)
    r = rows[None, None]  # [1, 1, Sq, 1]

    def col(i: int) -> torch.Tensor:
        return bnd[..., i][:, :, None, :]  # [B, Hm, 1, Sk]

    if c == 1:
        m = r >= col(0)
    elif c == 2:
        m = (r >= col(0)) & (r < col(1))
    else:
        m = ((r >= col(0)) & (r < col(1))) | ((r >= col(2)) & (r < col(3)))
    return masked | m


def flash_tile_classes(bounds: Optional[torch.Tensor], sq: int, sk: int, bm: int, bn: int,
                       causal: bool) -> torch.Tensor:
    """The kernels' FlashMask tile classes (``csrc/flash_common.cuh``
    ``warp_tile_class``), int ``[B|1, Hm|1, ceil(Sq / bm), ceil(Sk / bn)]``:
    :data:`SKIP` where every logit of the (query tile, key tile) pair is
    masked, :data:`FULL` where none is, :data:`PARTIAL` otherwise. The same
    conservative rules from the same per-tile min and max of each bounds
    slot over the tile's real columns: SKIP causally when the tile starts
    past the last real row's limit, or when one band covers every real row
    for every column (C=1 ``max s <= r0``; C=2 ``max s <= r0`` and
    ``min e >= r1``; C=4 either band so); FULL when no row or column is
    padding, the tile is causally clear, and every band lies outside the
    tile's rows (C=1 ``min s >= r1``; C=2 ``min s >= r1`` or ``max e <= r0``;
    C=4 both bands so)."""
    n_qt, n_kt = -(-sq // bm), -(-sk // bn)
    dev = bounds.device if bounds is not None else torch.device("cpu")
    r0 = torch.arange(n_qt, device=dev)[:, None] * bm  # [n_qt, 1]
    c0 = torch.arange(n_kt, device=dev)[None, :] * bn  # [1, n_kt]
    r1 = (r0 + bm).clamp(max=sq)  # the real rows end here
    rb = r0 + bm  # FULL needs every row real
    shift = sk - sq
    skip = torch.zeros((n_qt, n_kt), dtype=torch.bool, device=dev)
    if causal:
        skip |= c0 > r1 - 1 + shift
    full = (rb <= sq) & (c0 + bn <= sk)
    if causal:
        full &= c0 + bn - 1 <= r0 + shift
    skip, full = skip[None, None], full[None, None]
    if bounds is not None:
        b, hm, _, c = bounds.shape
        if c not in _MASK_C:
            raise ValueError(f"FlashMask C must be 1/2/4, got {c}")
        pad = n_kt * bn - sk
        bnd = bounds.to(torch.long)
        big = torch.iinfo(torch.long).max // 2
        lo = torch.cat([bnd, bnd.new_full((b, hm, pad, c), big)], 2).reshape(b, hm, n_kt, bn, c).amin(3)
        hi = torch.cat([bnd, bnd.new_full((b, hm, pad, c), -big)], 2).reshape(b, hm, n_kt, bn, c).amax(3)
        mn = [lo[..., j][:, :, None, :] for j in range(c)]  # [B, Hm, 1, n_kt]
        mx = [hi[..., j][:, :, None, :] for j in range(c)]
        r0_, r1_, rb_ = r0[None, None], r1[None, None], rb[None, None]

        def covers(i):  # band i ([s, e) in slots i, i + 1) masks every real row
            return (mx[i] <= r0_) & (mn[i + 1] >= r1_)

        def clear(i):  # band i masks no row of the tile
            return (mn[i] >= rb_) | (mx[i + 1] <= r0_)

        if c == 1:
            skip = skip | (mx[0] <= r0_)
            full = full & (mn[0] >= rb_)
        elif c == 2:
            skip = skip | covers(0)
            full = full & clear(0)
        else:
            skip = skip | covers(0) | covers(2)
            full = full & clear(0) & clear(2)
    cls = torch.full(torch.broadcast_shapes(skip.shape, full.shape), PARTIAL, dtype=torch.int8, device=dev)
    cls = cls.masked_fill(full, FULL)
    return cls.masked_fill(skip, SKIP)


def _heads(x: torch.Tensor, hk: int) -> torch.Tensor:
    """``[B, S, H, D]`` -> fp32 ``[B, HK, H // HK, S, D]``."""
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b, hk, h // hk, s, d)


def _grouped(t: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    """``[B, H|1, ...]`` -> ``[B, HK|1, H // HK|1, ...]``."""
    if t.shape[1] == h and h > 1:
        return t.reshape(t.shape[0], hk, h // hk, *t.shape[2:])
    return t[:, :, None]


def _check_geometry(q, k, v, bounds) -> Tuple[int, int, int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must be [B, S, H, D] with k and v alike")
    b, sq, h, d = q.shape
    _, sk, hk, d_k = k.shape
    if k.shape[0] != b or d_k != d or hk == 0 or h % hk:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    hm, c = 0, 0
    if bounds is not None:
        if bounds.dim() != 4 or bounds.shape[0] != b or bounds.shape[2] != sk:
            raise ValueError(f"flash attention: bounds {tuple(bounds.shape)} must be [{b}, Hm, {sk}, C]")
        hm, c = bounds.shape[1], bounds.shape[3]
        if hm not in (1, h) or c not in _MASK_C:
            raise ValueError(f"flash attention: bounds need Hm in (1, {h}) and C in {_MASK_C}, "
                             f"got {tuple(bounds.shape)}")
    return b, sq, sk, h, hk, d, hm, c


# -- plain versions ------------------------------------------------------------

def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor] = None,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)``, computed in
    fp32 with the forward kernel's order (q scaled before ``q k^T``).
    Differentiable by autograd (a plain reference path uses that)."""
    b, sq, sk, h, hk, d, _, _ = _check_geometry(q, k, v, bounds)
    scale = 1.0 / d**0.5 if scale is None else scale
    qh = _heads(q, hk) * scale
    kh, vh = _heads(k, hk), _heads(v, hk)  # [B, HK, 1, Sk, D]
    logits = qh @ kh.transpose(-1, -2)  # [B, HK, G, Sq, Sk]
    masked = _grouped(flash_masked(sq, sk, causal, bounds, q.device), h, hk)
    logits = logits.masked_fill(masked, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    seen = m > float("-inf")  # rows with at least one visible column
    m = torch.where(seen, m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = torch.where(seen, p.sum(dim=-1, keepdim=True), torch.ones_like(m))
    out = (p @ vh) / l
    lse = torch.where(seen, m + torch.log(l), torch.full_like(m, float("inf")))
    out = out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def _probs_and_ds(q, k, v, bounds, g, lse, delta, causal, scale):
    """The backward kernels' shared recomputation, fp32 ``[B, HK, G, Sq, Sk]``:
    ``p = exp(scale * q k^T - lse)`` (0 where masked) and
    ``ds = p * (g v^T - delta) * scale``."""
    b, sq, sk, h, hk, d, _, _ = _check_geometry(q, k, v, bounds)
    scale = 1.0 / d**0.5 if scale is None else scale
    qh, gh = _heads(q, hk), _heads(g, hk)
    kh, vh = _heads(k, hk), _heads(v, hk)
    logits = scale * (qh @ kh.transpose(-1, -2))
    masked = _grouped(flash_masked(sq, sk, causal, bounds, q.device), h, hk)
    lse5 = lse.float().reshape(b, hk, h // hk, sq, 1)
    p = torch.exp(logits - lse5).masked_fill(masked, 0.0)
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - delta.float().reshape(b, hk, h // hk, sq, 1)) * scale
    return qh, kh, gh, p, ds


def flash_bwd_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor],
    g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> torch.Tensor:
    """``dq [B, Sq, H, D]`` in q's dtype: ``ds k``, accumulated in fp32."""
    _, kh, _, _, ds = _probs_and_ds(q, k, v, bounds, g, lse, delta, causal, scale)
    b, sq, h, d = q.shape
    dq = ds @ kh
    return dq.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def flash_bwd_dkv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor],
    g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv) [B, Sk, HK, D]`` in k's dtype: ``ds^T q`` and ``p^T g``,
    accumulated in fp32 and summed over each KV head's query heads."""
    qh, _, gh, p, ds = _probs_and_ds(q, k, v, bounds, g, lse, delta, causal, scale)
    dk = (ds.transpose(-1, -2) @ qh).sum(dim=2)  # [B, HK, Sk, D]
    dv = (p.transpose(-1, -2) @ gh).sum(dim=2)
    return dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


# -- CUDA wrappers -------------------------------------------------------------

def _entry_suffix(what: str, dtype: torch.dtype, d: int) -> str:
    """The C entry's suffix of kernel ``what`` at head dim ``d`` in
    ``dtype``: ``bf16`` / ``fp16`` for the wgmma kernels up to D 256; above
    it ``wgmma_wide_bf16`` / ``wgmma_wide_fp16`` for all three (the forward
    ``csrc/flash_fwd_wide.cu``, dq and dk/dv ``csrc/flash_bwd_wide.cu``);
    in fp32 ``tf32x3`` for all three up to 256 (``csrc/flash_fwd_tf32.cu``,
    ``csrc/flash_bwd_tf32.cu``), else ``fp32`` to 512 and ``deep_fp32``
    above (the CUDA-core instances)."""
    suffix = _KERNEL_DTYPES[dtype]
    if suffix == "fp32":
        if d <= TF32_HEAD_DIM_MAX:
            return "tf32x3"
        return "deep_fp32" if d > KERNEL_HEAD_DIMS[-1] else "fp32"
    return suffix if d <= WGMMA_HEAD_DIM_MAX else f"wgmma_wide_{suffix}"


def _cuda_inputs(what: str, tensors, bounds, d: int):
    """Contiguous, 16-byte-aligned views of ``tensors`` (one dtype of
    bf16, fp16 and fp32) and int32 bounds on one card, with the C entry's
    suffix (:func:`_entry_suffix`); or an exception naming what the
    kernels do not take."""
    dtype = tensors[0][1].dtype
    for name, t in tensors:
        if t.dtype not in _KERNEL_DTYPES or t.dtype != dtype:
            raise ValueError(f"{what}: q, k, v and g must share one of bf16, fp16 and fp32; "
                             f"{name} is {t.dtype} beside {tensors[0][0]} {dtype}")
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if d <= 0 or d % 64:
        raise ValueError(f"{what}: the CUDA kernels take head dims that are multiples of 64, not {d}")
    out = []
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())  # TMA reads 16-byte-aligned rows
    bnd = None
    if bounds is not None:
        if bounds.device != dev or bounds.dtype != torch.int32:
            raise ValueError(f"{what}: bounds must be an int32 tensor on {dev}")
        bnd = bounds.contiguous()
    return dev, out, bnd, _entry_suffix(what, dtype, d)


def _stats(what: str, t: torch.Tensor, shape, dev) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape) or t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{what}: expected fp32 {list(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _sched(suffix: str, dev: torch.device) -> Optional[torch.Tensor]:
    """The item scheduler's counter of the persistent bf16/fp16 kernels 14,
    15 and 16 (their wide instances too; one int32, zero before each
    launch); the fp32 instances take none."""
    if suffix.endswith("fp32") or suffix == "tf32x3":
        return None
    return torch.zeros(1, dtype=torch.int32, device=dev)


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor] = None,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward; returns ``(out [B, Sq, H, D], lse [B, H, Sq])``.
    A launch counts as ``flash_fwd``, or as ``flash_fwd_wide`` where the
    bf16 / fp16 forward above head dim 256 (``csrc/flash_fwd_wide.cu``)
    ran."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, bounds, causal, scale)
    b, sq, sk, h, hk, d, hm, c = _check_geometry(q, k, v, bounds)
    scale = 1.0 / d**0.5 if scale is None else scale
    dev, (q, k, v), bnd, suffix = _cuda_inputs("flash_fwd", [("q", q), ("k", k), ("v", v)], bounds, d)
    launch = bool(b and sq and sk and h)
    out = torch.empty_like(q) if launch else torch.zeros_like(q)
    lse = torch.full((b, h, sq), float("inf"), dtype=torch.float32, device=dev)
    if launch:
        fn = build.kernel_fn(f"ptt_flash_fwd_{suffix}", [_P] * 7 + [_I] * 9 + [_F, _P])
        with torch.cuda.device(dev):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bnd), out.data_ptr(),
                     lse.data_ptr(), _ptr(_sched(suffix, dev)), b, sq, sk, h, hk, d, hm, c, int(bool(causal)),
                     float(scale), torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash_fwd")
        count_launch("flash_fwd_wide" if suffix.startswith("wgmma_wide") else "flash_fwd")
    return out, lse


def flash_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor],
    g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> torch.Tensor:
    """``dq [B, Sq, H, D]`` of flash attention, given the forward's ``lse``
    and ``delta = sum(g * out, -1)`` as ``[B, H, Sq]``. A launch counts as
    ``flash_bwd_dq``, or as ``flash_bwd_dq_wide`` where the bf16 / fp16
    kernel above head dim 256 (``csrc/flash_bwd_wide.cu``) ran."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, bounds, g, lse, delta, causal, scale)
    b, sq, sk, h, hk, d, hm, c = _check_geometry(q, k, v, bounds)
    if g.shape != q.shape:
        raise ValueError(f"flash_bwd_dq: g {tuple(g.shape)} is not q's shape {tuple(q.shape)}")
    scale = 1.0 / d**0.5 if scale is None else scale
    dev, (q, k, v, g), bnd, suffix = _cuda_inputs("flash_bwd_dq", [("q", q), ("k", k), ("v", v), ("g", g)], bounds, d)
    lse = _stats("flash_bwd_dq: lse", lse, (b, h, sq), dev)
    delta = _stats("flash_bwd_dq: delta", delta, (b, h, sq), dev)
    launch = bool(b and sq and sk and h)
    dq = torch.empty_like(q) if launch else torch.zeros_like(q)
    if launch:
        fn = build.kernel_fn(f"ptt_flash_bwd_dq_{suffix}", [_P] * 9 + [_I] * 9 + [_F, _P])
        with torch.cuda.device(dev):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bnd), g.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(_sched(suffix, dev)), b, sq, sk, h,
                     hk, d, hm, c, int(bool(causal)), float(scale), torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash_bwd_dq")
        count_launch("flash_bwd_dq_wide" if suffix.startswith("wgmma_wide") else "flash_bwd_dq")
    return dq


def flash_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor],
    g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
    causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv) [B, Sk, HK, D]`` of flash attention (GQA groups summed).
    A launch counts as ``flash_bwd_dkv``, or as ``flash_bwd_dkv_wide``
    where the bf16 / fp16 kernel above head dim 256
    (``csrc/flash_bwd_wide.cu``) ran."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, bounds, g, lse, delta, causal, scale)
    b, sq, sk, h, hk, d, hm, c = _check_geometry(q, k, v, bounds)
    if g.shape != q.shape:
        raise ValueError(f"flash_bwd_dkv: g {tuple(g.shape)} is not q's shape {tuple(q.shape)}")
    scale = 1.0 / d**0.5 if scale is None else scale
    dev, (q, k, v, g), bnd, suffix = _cuda_inputs("flash_bwd_dkv", [("q", q), ("k", k), ("v", v), ("g", g)], bounds, d)
    lse = _stats("flash_bwd_dkv: lse", lse, (b, h, sq), dev)
    delta = _stats("flash_bwd_dkv: delta", delta, (b, h, sq), dev)
    launch = bool(b and sq and sk and h)
    alloc = torch.empty_like if launch else torch.zeros_like
    dk, dv = alloc(k), alloc(v)
    if launch:
        fn = build.kernel_fn(f"ptt_flash_bwd_dkv_{suffix}", [_P] * 10 + [_I] * 9 + [_F, _P])
        with torch.cuda.device(dev):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bnd), g.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(_sched(suffix, dev)),
                     b, sq, sk, h, hk, d, hm, c, int(bool(causal)), float(scale),
                     torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash_bwd_dkv")
        count_launch("flash_bwd_dkv_wide" if suffix.startswith("wgmma_wide") else "flash_bwd_dkv")
    return dk, dv


# -- autograd ------------------------------------------------------------------

class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention whose backward is the dq and dk/dv kernels (the
    Pallas package's ``custom_vjp`` pair). The forward saves q, k, v, the
    bounds, out and lse and nothing else, so a recompute rerun and the
    backward see the same inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bounds, causal, scale):  # noqa: D401 - autograd signature
        out, lse = flash_fwd(q, k, v, bounds, causal, scale)
        ctx.save_for_backward(q, k, v, bounds, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bounds, out, lse = ctx.saved_tensors
        # delta = rowsum(g * out) outside the kernels, as the Pallas _run_bwd does
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, bounds, g, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, bounds, g, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bounds: Optional[torch.Tensor] = None,
    causal: bool = False, scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention over ``[B, S, H, D]`` with optional
    FlashMask ``bounds``; the counterpart of ``flash_attention_pallas``."""
    d = q.shape[-1]
    scale = 1.0 / d**0.5 if scale is None else float(scale)
    return FlashAttentionFunction.apply(q, k, v, bounds, bool(causal), scale)
