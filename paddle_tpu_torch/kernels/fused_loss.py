"""Fused linear cross entropy — forward, dX and dW: CUDA kernels, their plain
versions, and the autograd ``Function`` that joins them.

Port of ``paddle_tpu/kernels/fused_loss.py``:

- :func:`flxent_fwd` — ``_flxent_fwd_kernel`` (kernel 17): per row of
  ``x [N, H]`` the fp32 logsumexp ``lse`` of the logits ``x W`` and the
  target logit ``tl``, without the ``[N, V]`` logits in device memory;
- :func:`flxent_dchunk` — ``_flxent_block_d``, which kernels 18 and 19
  share: ``D = (softmax - onehot) * gcoef`` of a range of vocab columns,
  rounded to the input dtype;
- :func:`flxent_bwd` — ``_flxent_dx_kernel`` (kernel 18) and
  ``_flxent_dw_kernel`` (kernel 19): ``dX = D W^T`` and ``dW = x^T D``. On
  the card the vocab is walked in chunks of :data:`CHUNK` columns; each
  chunk's ``D`` is computed once and feeds both products (the Pallas split
  recomputes the logits in each kernel). Either product runs alone when
  only one gradient is wanted;
- :class:`FusedLinearCrossEntropyFunction` — the custom-VJP shell
  ``_build_core``: the forward saves ``x``, ``W``, the labels and the
  ``[N]`` fp32 ``lse`` only; the backward builds the per-row ``gcoef``
  from the reduction and the ``ignore_index`` mask (``mean`` divides by
  ``max(#valid, 1)``).

- :func:`flxent_fwd_int8` — kernel 17's int8 site (``_make_pallas_quant_fwd``):
  the forward of a weight-only int8 head, ``W`` int8 with one fp32 scale
  per vocab column, each logit scaled before the softmax statistics, for
  bf16, fp16 or fp32 activations (JAX sends any dtype there). It has
  no backward (nothing differentiates through an int8 weight, as in JAX):
  :func:`linear_cross_entropy` with ``weight_scale`` runs it forward only,
  and a gradient request raises.

``W`` is ``[H, V]`` (``nn.Linear``'s layout) or ``[V, H]`` with
``vocab_major=True`` (a tied embedding), read in place either way. Columns
``>= V`` are ``NEG_INF`` in the forward and have probability 0 in the
backward; a label equal to ``ignore_index`` or outside ``[0, V)`` matches
no column (its ``tl`` is 0). The plain versions walk the vocab in the JAX
scan reference's chunks (``_REF_BLOCK``), in fp32 from the inputs' values.
Each wrapper runs its plain version for CPU tensors; for CUDA tensors it
launches a kernel or raises. Kernel 17 and the backward's products (the
D recompute, 18 and 19) take the instance :func:`flx_route` names from the
dtype, W's shape and W's alignment before the launch: ``csrc/flxent_wgmma.cu`` (the wgmma
mainloop fed by TMA, tiles planned by :func:`flx_plan` and walked as
:func:`flx_items` says; the forward's per-row partials reduced in
registers, :data:`TILE` columns a partial), the mma.sync mainloop
(``csrc/flxent_fwd.cu``, ``flxent_dx.cu``, ``flxent_dw.cu``) where TMA
cannot address W, in fp32 the 3xTF32 wgmma mainloop (``csrc/flxent_tf32.cu``:
every operand split once into hi and lo TF32 planes laid out K-major,
launches counted as ``flxent_split``, then three TF32 passes a product,
the vocab walked in sub-chunks so that the planes stay below the unfused
head's logits) where the split pass can read W in 16-byte vectors, or the
CUDA cores (``csrc/flxent_fp32.cu``) for other fp32 W. Kernel 17's int8
site takes the instance :func:`flx_int8_route` names: kernel 20's wgmma
mainloop (``csrc/wo_mainloop.cuh``, epilogue in ``csrc/flxent_int8.cu``)
for the int8 Llama head's ``[H, V]`` layout, the mma.sync mainloop for a
vocab-major or ragged int8 W, and for fp32 activations the same TF32
mainloop in two passes (each sub-chunk of the int8 W widened exactly into
one K-major plane, launches counted as ``flxent_widen``: an int8 value is
a TF32 value) where the widen pass takes W (16-byte aligned, rows a
multiple of 16 bytes, H a multiple of 4), else the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.quant import plan_makespan
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "CHUNK",
    "FusedLinearCrossEntropyFunction",
    "Int8HeadLossFunction",
    "flx_fwd_bytes",
    "flx_fwd_sub",
    "flx_int8_route",
    "flx_int8_route_of",
    "flx_items",
    "flx_plan",
    "flx_route",
    "flx_route_of",
    "flx_tf32_sub",
    "flxent_bwd",
    "flxent_bwd_plain",
    "flxent_dchunk",
    "flxent_dchunk_plain",
    "flxent_fwd",
    "flxent_fwd_int8",
    "flxent_fwd_int8_plain",
    "flxent_fwd_plain",
    "int8_plane",
    "int8_plane_plain",
    "linear_cross_entropy",
    "tf32_planes",
    "tf32_planes_bytes",
    "tf32_planes_plain",
    "tf32_split_plain",
]

NEG_INF = -1e30  # the Pallas kernels' masked logit
REF_BLOCK = 512  # the JAX scan reference's vocab chunk, which the plain versions follow
CHUNK = 4096  # vocab columns per backward chunk on the card: D is [N, CHUNK]
TILE = 128  # kernel 17's vocab tile: its partials are [3, ceil(V / TILE), N]
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # ptt::IoType
_ROUTES = {"wgmma": 0, "mma_sync": 1, "cuda_cores": 2}  # ptt::flx::Route


def flx_route(dtype: torch.dtype, h: int, v: int, vocab_major: bool, w_aligned: bool = True) -> str:
    """Which instance of kernel 17 and of the backward's products (the D
    recompute, kernels 18 and 19) takes ``x [N, h]`` against ``W`` (``[h, v]``, or
    ``[v, h]`` with ``vocab_major``) of ``dtype``: for bf16 and fp16
    ``"wgmma"`` (the wgmma mainloop fed by TMA) when TMA can address every
    operand's rows (``2 h`` and, for ``[h, v]``, ``2 v`` bytes, multiples of
    16: ``h % 8 == 0`` and ``v % 8 == 0``; ``h > 0``) and W's first element
    (``w_aligned``: its address a multiple of 16), else ``"mma_sync"`` (the
    mma.sync mainloop, which stages any row); for fp32 ``"tf32x3"``
    (``csrc/flxent_tf32.cu``: three TF32 passes on a wgmma mainloop, its
    operands split first by a pass that reads W in 16-byte vectors) when W
    is 16-byte aligned and its rows are a multiple of 4 floats (``h % 4 ==
    0``, ``h > 0`` and, for ``[h, v]``, ``v % 4 == 0``), else
    ``"cuda_cores"``. Any other dtype raises."""
    if dtype == torch.float32:
        tf32 = w_aligned and h > 0 and h % 4 == 0 and (vocab_major or v % 4 == 0)
        return "tf32x3" if tf32 else "cuda_cores"
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"the loss head's CUDA kernels take bf16, fp16 or fp32, not {dtype}")
    return "wgmma" if w_aligned and h > 0 and h % 8 == 0 and (vocab_major or v % 8 == 0) else "mma_sync"


def flx_route_of(x: torch.Tensor, w: torch.Tensor, vocab_major: bool) -> str:
    """:func:`flx_route` of the contiguous ``x [N, H]`` and ``W`` that kernel
    17 launches on."""
    return flx_route(x.dtype, x.shape[1], _vocab(w, vocab_major), vocab_major, w.data_ptr() % 16 == 0)


def flx_int8_route(dtype: torch.dtype, h: int, v: int, vocab_major: bool, w_aligned: bool = True) -> str:
    """Which instance of kernel 17's int8 site takes activations of
    ``dtype`` ``[N, h]`` against the int8 ``W`` (``[h, v]``, or ``[v, h]``
    with ``vocab_major``): ``"wgmma"`` (kernel 20's mainloop: the int8 W
    widened in registers as wgmma's A operand, x streamed by TMA) for bf16
    and fp16 with ``W [h, v]`` whose rows TMA can address (``h % 8 == 0``,
    ``h > 0``, ``v % 16 == 0`` and W 16-byte aligned: kernel 20's
    :func:`~paddle_tpu_torch.kernels.quant.wo_route` conditions);
    ``"mma_sync"`` (the int8 slabs widened in shared memory) for the other
    bf16 and fp16 shapes, the vocab-major layout included; for fp32
    ``"tf32x2"`` (``csrc/flxent_tf32.cu``: two TF32 passes on the 3xTF32
    mainloop, each sub-chunk of W first widened into one K-major fp32
    plane) when W is 16-byte aligned and its rows
    are a multiple of 16 bytes (``v % 16 == 0`` for ``[h, v]``, ``h % 16 ==
    0`` when vocab-major) and the widened plane's rows of ``h`` floats are a
    multiple of 16 bytes too (``h % 4 == 0``, ``h > 0``), else
    ``"cuda_cores"``. Any other dtype raises."""
    if dtype == torch.float32:
        tf32 = w_aligned and h > 0 and (h % 16 == 0 if vocab_major else h % 4 == 0 and v % 16 == 0)
        return "tf32x2" if tf32 else "cuda_cores"
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"the int8 head's CUDA kernels take bf16, fp16 or fp32 activations, not {dtype}")
    wgmma = not vocab_major and w_aligned and h > 0 and h % 8 == 0 and v % 16 == 0
    return "wgmma" if wgmma else "mma_sync"


def flx_int8_route_of(x: torch.Tensor, w8: torch.Tensor, vocab_major: bool) -> str:
    """:func:`flx_int8_route` of the contiguous ``x [N, H]`` and int8 ``W``
    that the int8 site launches on."""
    return flx_int8_route(x.dtype, x.shape[1], _vocab(w8, vocab_major), vocab_major, w8.data_ptr() % 16 == 0)


FLX_BM, FLX_BN = 128, 256  # the wgmma instance's output tile; a half tile is 128 x 128
FLX_GROUP = 16  # row tiles per sweep of the column tiles (L2 reuse)


def flx_plan(m: int, n: int, sms: int) -> Dict[str, int]:
    """The work items of one launch of the wgmma instance over an ``[m, n]``
    output on ``sms`` SMs (``make_plan`` in ``csrc/flxent_wgmma.cu``):
    ``tiles_m`` x ``tiles_n`` tiles of 128 x 256, walked :data:`FLX_GROUP`
    row tiles at a time across the column tiles; the tiles past the last
    full round over the SMs are split into two 128 x 128 halves where that
    shortens the longest CTA's work (:func:`plan_makespan`, kernel 20's cost
    model: a half costs ~5/8 of a whole tile).
    Items ``[0, big)`` are whole tiles, the rest halves; ``grid`` persistent
    CTAs take items ``b, b + grid, ...``."""
    tiles_m, tiles_n = -(-m // FLX_BM), -(-n // FLX_BN)
    whole = tiles_m * tiles_n
    keep = whole - whole % sms
    items_split = keep + 2 * (whole - keep)
    if keep < whole and plan_makespan(keep, items_split, min(items_split, sms)) < plan_makespan(
            whole, whole, min(whole, sms)):
        big, items = keep, items_split
    else:
        big, items = whole, whole
    return dict(tiles_m=tiles_m, tiles_n=tiles_n, big=big, items=items, grid=min(items, sms))


def flx_items(plan: Dict[str, int]) -> List[Tuple[int, int, int]]:
    """``item_at`` (csrc/flxent_wgmma.cu) over a :func:`flx_plan`: (first
    row, first column, columns) of every item, in launch order; a half
    whose first column lies past the output is empty (the kernel skips
    it)."""
    big, per_group = plan["big"], FLX_GROUP * plan["tiles_n"]
    items = []
    for i in range(plan["items"]):
        half = i >= big
        t = big + (i - big) // 2 if half else i
        first = (t // per_group) * FLX_GROUP
        size = min(plan["tiles_m"] - first, FLX_GROUP)
        within = t % per_group
        n0 = (within // size) * FLX_BN + (((i - big) & 1) * FLX_BN // 2 if half else 0)
        items.append(((first + within % size) * FLX_BM, n0, FLX_BN // 2 if half else FLX_BN))
    return items


def _vocab(w: torch.Tensor, vocab_major: bool) -> int:
    return w.shape[0] if vocab_major else w.shape[1]


def _w_block(w: torch.Tensor, vocab_major: bool, j0: int, j1: int) -> torch.Tensor:
    """The vocab rows ``j0:j1`` of ``W`` as fp32 ``[j1 - j0, H]``."""
    return (w[j0:j1] if vocab_major else w[:, j0:j1].t()).float()


def flxent_fwd_plain(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab_major: bool = False,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tl)`` fp32 ``[N]``: the JAX scan reference's online softmax
    over vocab chunks of :data:`REF_BLOCK`, logits in fp32 from the inputs'
    values (the Pallas kernel's fp32 accumulation); with ``scale`` (``[V]``
    fp32, ``W`` int8) each chunk's logits times their columns' scales, the
    walk of ``_reference_quant_path``."""
    n = x.shape[0]
    v = _vocab(w, vocab_major)
    xf = x.float()
    lab = labels.long()
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tl = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for j0 in range(0, v, REF_BLOCK):
        j1 = min(j0 + REF_BLOCK, v)
        logits = xf @ _w_block(w, vocab_major, j0, j1).t()
        if scale is not None:  # per-column dequant factors out of the contraction
            logits = logits * scale[j0:j1].float()[None, :]
        cols = torch.arange(j0, j1, device=x.device)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        tl = tl + torch.where(cols[None, :] == lab[:, None], logits, 0.0).sum(dim=-1)
        m = m_new
    return m + torch.log(l), tl


def flxent_fwd_int8_plain(
    x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, labels: torch.Tensor, vocab_major: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 17's int8 site's plain version: :func:`flxent_fwd_plain` of
    the int8 values with the per-column scales."""
    return flxent_fwd_plain(x, w8, labels, vocab_major, scale=scale)


def flxent_dchunk_plain(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, gcoef: torch.Tensor,
    c0: int, c1: int, vocab_major: bool = False,
) -> torch.Tensor:
    """``D [N, c1 - c0]`` of the vocab columns ``c0:c1`` (``c1 <= V``):
    ``(exp(logits - lse) - onehot) * gcoef`` from fp32 logits, rounded to
    ``x``'s dtype (``_flxent_block_d``)."""
    p = torch.exp(x.float() @ _w_block(w, vocab_major, c0, c1).t() - lse[:, None])
    onehot = (torch.arange(c0, c1, device=x.device)[None, :] == labels.long()[:, None]).float()
    return ((p - onehot) * gcoef[:, None]).to(x.dtype)


def flxent_bwd_plain(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, gcoef: torch.Tensor,
    vocab_major: bool = False, need_dx: bool = True, need_dw: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dx, dw)``: per vocab chunk ``D = ((exp(logits - lse) - onehot) *
    gcoef)`` rounded to ``x``'s dtype, ``dx += D W_c^T`` in fp32 (cast to
    ``x``'s dtype at the end) and ``dW_c = x^T D`` in fp32 (cast to ``W``'s
    dtype) — the scan reference's ``engine_bwd``. A gradient not asked for
    is None."""
    n, h = x.shape
    v = _vocab(w, vocab_major)
    xf = x.float()
    dx = torch.zeros((n, h), dtype=torch.float32, device=x.device) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    for j0 in range(0, v, REF_BLOCK):
        j1 = min(j0 + REF_BLOCK, v)
        d = flxent_dchunk_plain(x, w, labels, lse, gcoef, j0, j1, vocab_major).float()
        if need_dx:
            dx += d @ _w_block(w, vocab_major, j0, j1)
        if need_dw:
            dwj = (d.t() @ xf).to(w.dtype)
            if vocab_major:
                dw[j0:j1] = dwj
            else:
                dw[:, j0:j1] = dwj.t()
    return (dx.to(x.dtype) if need_dx else None), dw


def _io_dtype(what: str, x: torch.Tensor, w: torch.Tensor, w_dtype: Optional[torch.dtype] = None) -> int:
    """x's kernel type code (bf16, fp16 or fp32); W must be of x's dtype (or
    ``w_dtype``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernels take bf16, fp16 or fp32, not {x.dtype}")
    want = x.dtype if w_dtype is None else w_dtype
    if w.dtype != want:
        raise TypeError(f"{what}: x is {x.dtype} and the weight {w.dtype}; the kernel takes a {want} weight")
    return _KERNEL_DTYPES[x.dtype]


def _operands(what: str, x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab_major: bool,
              w_dtype: Optional[torch.dtype] = None):
    """Contiguous x and W and int32 labels on one card with their geometry,
    or an exception naming what the kernels do not take."""
    io = _io_dtype(what, x, w, w_dtype)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{what}: x must be [N, H] and the weight 2-D, got {tuple(x.shape)}, {tuple(w.shape)}")
    n, h = x.shape
    hw = w.shape[1] if vocab_major else w.shape[0]
    if hw != h or h % 8:
        raise ValueError(f"{what}: the weight {tuple(w.shape)} does not fit x {tuple(x.shape)} "
                         f"(vocab_major={vocab_major}), or H % 8 != 0")
    if labels.shape != (n,):
        raise ValueError(f"{what}: labels {tuple(labels.shape)} are not [{n}]")
    dev = x.device
    if w.device != dev or labels.device != dev:
        raise ValueError(f"{what}: x, the weight and the labels must be on {dev}")
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned for the CUDA kernels")
    return io, x, w, labels.to(torch.int32).contiguous(), n, h, _vocab(w, vocab_major)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flxent_fwd(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab_major: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tl)`` fp32 ``[N]`` of ``x [N, H]`` against ``W``. Kernel 17 on
    the instance :func:`flx_route` names, each launch counted: the logits
    tiles' partials, then their fixed-order merge, as ``flxent_fwd``; on
    ``"tf32x3"`` the partials are one launch per sub-chunk, after the split
    launches of :func:`_fwd_tf32`."""
    if x.device.type == "cpu":
        return flxent_fwd_plain(x, w, labels, vocab_major)
    io, x, w, lab, n, h, v = _operands("flxent_fwd", x, w, labels, vocab_major)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    tl = torch.empty_like(lse)
    if n and v:
        route = flx_route_of(x, w, vocab_major)
        tiles = -(-v // TILE)
        part = torch.empty((3, tiles, n), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            if route == "tf32x3":
                _fwd_tf32(x, w, None, lab, vocab_major, part, n, h, v, "flxent_fwd")
            else:
                fn = build.kernel_fn("ptt_flxent_fwd", [_I, _I, _I] + [_P] * 4 + [_I] * 3 + [_P])
                build.check(fn(io, _ROUTES[route], int(vocab_major), x.data_ptr(), w.data_ptr(), lab.data_ptr(),
                               part.data_ptr(), n, h, v, _stream()), f"flxent_fwd ({route})")
                count_launch("flxent_fwd")
            _merge(part, lse, tl, "flxent_fwd")
    return lse, tl


def _merge(part: torch.Tensor, lse: torch.Tensor, tl: torch.Tensor, what: str) -> None:
    """One counted launch: the partials ``[3, tiles, N]`` merged in tile order into ``lse`` and ``tl``."""
    merge = build.kernel_fn("ptt_flxent_merge", [_P, _I, _I, _P, _P, _P])
    build.check(merge(part.data_ptr(), part.shape[1], part.shape[2], lse.data_ptr(), tl.data_ptr(), _stream()),
                f"{what} merge")
    count_launch(what)


def flxent_fwd_int8(
    x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, labels: torch.Tensor, vocab_major: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tl)`` fp32 ``[N]`` of ``x [N, H]`` (bf16, fp16 or fp32)
    against the int8 ``W`` with per-column fp32 ``scale [V]``: kernel 17's
    int8 site on the instance :func:`flx_int8_route` names, each launch
    counted as ``flxent_fwd_int8`` (the logits tiles' partials, then the
    bf16 forward's merge); on ``"tf32x2"`` the partials are one launch per
    sub-chunk, after the split launch of x and each sub-chunk's widen launch
    (:func:`_fwd_tf32`)."""
    if x.device.type == "cpu":
        return flxent_fwd_int8_plain(x, w8, scale, labels, vocab_major)
    what = "flxent_fwd_int8"
    io, x, w8, lab, n, h, v = _operands(what, x, w8, labels, vocab_major, w_dtype=torch.int8)
    if scale.shape != (v,) or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError(f"{what}: the scale must be fp32 [{v}] on {x.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    scale = scale.contiguous()
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    tl = torch.empty_like(lse)
    if n and v:
        tiles = -(-v // TILE)
        part = torch.empty((3, tiles, n), dtype=torch.float32, device=x.device)
        route = flx_int8_route_of(x, w8, vocab_major)
        with torch.cuda.device(x.device):
            if route == "tf32x2":
                _fwd_tf32(x, w8, scale, lab, vocab_major, part, n, h, v, what)
            else:
                fn = build.kernel_fn("ptt_flxent_fwd_int8", [_I, _I, _I] + [_P] * 5 + [_I] * 3 + [_P])
                build.check(fn(io, _ROUTES[route], int(vocab_major), x.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                               lab.data_ptr(), part.data_ptr(), n, h, v, _stream()), f"{what} ({route})")
                count_launch(what)
            _merge(part, lse, tl, what)
    return lse, tl


def _backward_operands(what, x, w, labels, lse, gcoef, vocab_major):
    """:func:`_operands` with the fp32 ``lse`` and ``gcoef``, and the route
    of the backward's products (:func:`flx_route`)."""
    io, x, w, lab, n, h, v = _operands(what, x, w, labels, vocab_major)
    for name, t in (("lse", lse), ("gcoef", gcoef)):
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{what}: {name} must be fp32 [{n}] on {x.device}")
    return io, flx_route_of(x, w, vocab_major), x, w, lab, lse.contiguous(), gcoef.contiguous(), n, h, v


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def _planes(rows: int, ld: int, dev) -> torch.Tensor:
    """Scratch for one operand's hi and lo TF32 planes, ``[2, rows, ld]``."""
    return torch.empty((2, rows, ld), dtype=torch.float32, device=dev)


def _pl(t: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """A plane pair as the 3xTF32 entry points take it: (pointer, floats a
    row, floats from the hi plane to the lo plane); (0, 0, 0) for none."""
    return (0, 0, 0) if t is None else (t.data_ptr(), t.shape[2], t.shape[1] * t.shape[2])


def tf32_split_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of fp32 ``x`` as the split pass makes them
    (``csrc/tf32.cuh`` ``split``): ``hi`` is ``x`` rounded to TF32 on the
    bits (to nearest, ties away: add half of the 13 dropped bits' unit, clear
    them), ``lo`` the same rounding of ``x - hi``; infinities pass as they
    are."""
    def rna(t: torch.Tensor) -> torch.Tensor:
        r = ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(t), r, t)

    hi = rna(x)
    return hi, rna(x - hi)


def tf32_planes_plain(x: torch.Tensor, same: bool = True, trans: bool = False):
    """The plain version of :func:`tf32_planes`."""
    hi, lo = tf32_split_plain(x.float())
    out_same = torch.stack([hi, lo]) if same else None
    out_trans = None
    if trans:
        rows = x.shape[0]
        out_trans = torch.zeros((2, x.shape[1], _up4(rows)), dtype=torch.float32, device=x.device)
        out_trans[0, :, :rows], out_trans[1, :, :rows] = hi.t(), lo.t()
    return out_same, out_trans


def tf32_planes(x: torch.Tensor, same: bool = True, trans: bool = False):
    """The 3xTF32 instance's split pass over fp32 ``x [R, C]`` (``C % 4 ==
    0``): ``(same, trans)``, the hi and lo planes of ``x`` (``[2, R, C]``)
    and of ``x^T`` (``[2, C, R]``, rows padded with zeros to a multiple of
    4), each None when not asked for. One counted launch for a CUDA tensor
    (``flxent_split``); the plain version for a CPU one."""
    if x.device.type == "cpu":
        return tf32_planes_plain(x, same, trans)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] % 4 or not (same or trans) or not x.numel():
        raise ValueError(f"tf32_planes: the split pass takes a non-empty fp32 [R, C] with C % 4 == 0, got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    rows, cols = x.shape
    out_same = _planes(rows, cols, x.device) if same else None
    out_trans = _planes(cols, _up4(rows), x.device) if trans else None
    with torch.cuda.device(x.device):
        _launch_split(x.data_ptr(), cols, rows, cols, out_same, out_trans)
    return out_same, out_trans


def _launch_split(src: int, ld: int, rows: int, cols: int, same: Optional[torch.Tensor],
                  trans: Optional[torch.Tensor]) -> None:
    """One launch of the 3xTF32 instance's split pass: the hi and lo planes
    of the fp32 matrix at address ``src`` viewed as ``[rows, cols]`` (``ld``
    floats a row) into ``same [2, rows, .]`` and / or ``trans [2, cols, .]``."""
    fn = build.kernel_fn("ptt_flxent_split", [_P, _L, _I, _I, _P, _L, _L, _P, _L, _L, _P])
    build.check(fn(src, ld, rows, cols, *_pl(same), *_pl(trans), _stream()), "flxent_split")
    count_launch("flxent_split")


def _split_w(w: torch.Tensor, vocab_major: bool, h: int, v: int, c0: int, vc: int, wd: Optional[torch.Tensor],
             wx: Optional[torch.Tensor]) -> None:
    """The sub-chunk's W planes: ``wd [2, vc, H]`` (W_c^T: kernel 17's and
    D's operand) and / or ``wx [2, H, .]`` (dX's, W_c), in one split launch."""
    base = w.data_ptr() + w.element_size() * (c0 * h if vocab_major else c0)
    if vocab_major:  # W[c0:c0 + vc] is [vc, H]
        _launch_split(base, h, vc, h, wd, wx)
    else:  # W[:, c0:c0 + vc] is [H, vc], rows V apart
        _launch_split(base, v, h, vc, wx, wd)


def _launch_tf32_dchunk(xp, wd, lab, lse, gcoef, d, ldd, dp, dtp, n, h, c0, vc) -> None:
    """One launch of the 3xTF32 D: into ``d [N, ldd]``, D's planes ``dp``
    and D^T's ``dtp`` (each may be None)."""
    fn = build.kernel_fn("ptt_flxent_tf32_dchunk", [_P, _L, _L] * 2 + [_P] * 4 + [_L] + [_P, _L, _L] * 2
                         + [_I] * 4 + [_P])
    build.check(fn(*_pl(xp), *_pl(wd), lab.data_ptr(), lse.data_ptr(), gcoef.data_ptr(),
                   0 if d is None else d.data_ptr(), ldd, *_pl(dp), *_pl(dtp), n, h, c0, vc, _stream()),
                "flxent_dchunk (tf32x3)")
    count_launch("flxent_dchunk")


def _dchunk_tf32(x, w, lab, lse, gcoef, vocab_major, n, h, v, c0, c1) -> torch.Tensor:
    """:func:`flxent_dchunk` on the 3xTF32 instance: x's planes and the
    chunk's W_c^T planes (two split launches), then D."""
    vc = c1 - c0
    ldd = -(-vc // 8) * 8
    d = torch.empty((n, ldd), dtype=torch.float32, device=x.device)
    xp, wd = tf32_planes(x)[0], _planes(vc, h, x.device)
    _split_w(w, vocab_major, h, v, c0, vc, wd, None)
    _launch_tf32_dchunk(xp, wd, lab, lse, gcoef, d, ldd, None, None, n, h, c0, vc)
    return d[:, :vc]


def tf32_planes_bytes(n: int, h: int, v: int, sub: int) -> int:
    """Device bytes of the 3xTF32 backward's operand planes at sub-chunks
    of ``sub`` columns: hi and lo fp32 planes of x and x^T (``[n, h]``),
    of W_c in both orientations (``[min(sub, v), h]``) and of D and D^T
    (``[n, min(sub, v)]``), rows padded to 4 floats."""
    s, n4 = min(sub, v), _up4(n)
    return 8 * (n * h + h * n4 + s * h + h * _up4(s) + n * _up4(s) + s * n4)


def flx_tf32_sub(n: int, h: int, v: int) -> int:
    """The columns of one sub-chunk of the 3xTF32 backward for ``x [n, h]``
    against a vocab of ``v``: the largest of :data:`CHUNK`, ``CHUNK / 2``,
    ..., 512 whose operand planes (:func:`tf32_planes_bytes`) take fewer
    bytes than the ``[n, v]`` fp32 logits the unfused head holds, so that
    the fused head's peak memory stays below the unfused head's; 512 where
    none does. Each chunk of :data:`CHUNK` columns runs as its sub-chunks,
    in order."""
    sub = CHUNK
    while sub > 512 and tf32_planes_bytes(n, h, v, sub) >= 4 * n * v:
        sub //= 2
    return sub


def flx_fwd_bytes(n: int, h: int, v: int, sub: int, passes: int = 3) -> int:
    """Device bytes of the TF32 forward's scratch at sub-chunks of ``sub``
    columns: x's hi and lo planes (``[n, h]``), W_c^T's planes (``[min(sub,
    v), h]``: two in three passes, the int8 W's one widened plane in two)
    and the ``[3, ceil(v / TILE), n]`` partials."""
    return 4 * (2 * n * h + (passes - 1) * min(sub, v) * h + 3 * -(-v // TILE) * n)


def flx_fwd_sub(n: int, h: int, v: int, passes: int = 3) -> int:
    """The columns of one sub-chunk of kernel 17's TF32 walk (``passes`` 3:
    fp32 W, ``"tf32x3"``; 2: the int8 W, ``"tf32x2"``) for ``x [n, h]``
    against a vocab of ``v``: the largest multiple of :data:`TILE`, at most
    :data:`CHUNK`, whose scratch (:func:`flx_fwd_bytes`) takes fewer bytes
    than the ``[n, v]`` fp32 logits the unfused head holds; :data:`TILE`
    where none does. A rule of its own beside the backward's
    :func:`flx_tf32_sub`: the forward holds x's planes and one orientation
    of W_c only, so its sub-chunks may be larger (4096 columns at x
    ``[2048, 4096]`` against V 32000, where the backward takes 1024). Each
    sub-chunk starts at a multiple of :data:`TILE`, so its partials are
    whole tiles of the ``[3, ceil(v / TILE), n]`` scratch."""
    sub = CHUNK
    while sub > TILE and flx_fwd_bytes(n, h, v, sub, passes) >= 4 * n * v:
        sub -= TILE
    return sub


def int8_plane_plain(w8: torch.Tensor, vocab_major: bool, c0: int, c1: int) -> torch.Tensor:
    """The widen pass's plain version: the int8 W's vocab columns ``c0:c1``
    as fp32 ``[c1 - c0, H]`` (W_c^T, K-major), exact."""
    return _w_block(w8, vocab_major, c0, c1).contiguous()


def _launch_widen(w8: torch.Tensor, vocab_major: bool, h: int, v: int, c0: int, vc: int, out: torch.Tensor) -> None:
    """One counted launch of the widen pass: the int8 W's columns ``[c0, c0 +
    vc)`` into ``out`` (fp32, ``vc`` rows of ``H``)."""
    fn = build.kernel_fn("ptt_flxent_widen", [_P, _L, _I, _I, _I, _P, _L, _P])
    if vocab_major:  # W[c0:c0 + vc] is [vc, H] as it lies
        args = (w8.data_ptr() + c0 * h, h, vc, h, 0)
    else:  # W[:, c0:c0 + vc] is [H, vc], rows V bytes apart: transposed
        args = (w8.data_ptr() + c0, v, h, vc, 1)
    build.check(fn(*args, out.data_ptr(), h, _stream()), "flxent_widen")
    count_launch("flxent_widen")


def int8_plane(w8: torch.Tensor, vocab_major: bool, c0: int, c1: int) -> torch.Tensor:
    """The int8 W's vocab columns ``c0:c1`` widened to fp32 ``[c1 - c0, H]``
    (W_c^T, K-major), the ``"tf32x2"`` forward's B operand: one counted
    launch (``flxent_widen``) for a CUDA tensor on that route; the plain
    version for a CPU one."""
    if w8.device.type == "cpu":
        return int8_plane_plain(w8, vocab_major, c0, c1)
    if w8.dtype != torch.int8 or w8.dim() != 2 or not w8.is_contiguous():
        raise ValueError(f"int8_plane: the widen pass takes a contiguous int8 W, got {w8.dtype} {tuple(w8.shape)}")
    h, v = (w8.shape[1], w8.shape[0]) if vocab_major else w8.shape
    if flx_int8_route(torch.float32, h, v, vocab_major, w8.data_ptr() % 16 == 0) != "tf32x2" or not 0 <= c0 < c1 <= v:
        raise ValueError(f"int8_plane: the widen pass cannot take W {tuple(w8.shape)} (vocab_major={vocab_major}): "
                         f"it needs W 16-byte aligned, rows a multiple of 16 bytes and H % 4 == 0; or {c0}:{c1} is "
                         f"not a range of its {v} columns")
    out = torch.empty((c1 - c0, h), dtype=torch.float32, device=w8.device)
    with torch.cuda.device(w8.device):
        _launch_widen(w8, vocab_major, h, v, c0, c1 - c0, out)
    return out


def _fwd_tf32(x, w, scale, lab, vocab_major, part, n, h, v, what) -> None:
    """Kernel 17's partials on the TF32 instance (``csrc/flxent_tf32.cu``)
    into ``part``: one split launch for x's planes, then per sub-chunk of
    :func:`flx_fwd_sub` columns in order one launch laying W_c^T out K-major
    (an fp32 W: its hi and lo planes by the split pass, three passes; the
    int8 W with its ``scale``: its values widened by the widen pass, two
    passes) and one partials launch (counted as ``what``)."""
    passes = 3 if scale is None else 2
    sub = flx_fwd_sub(n, h, v, passes)
    xp = tf32_planes(x)[0]
    wp = torch.empty((passes - 1, min(sub, v), h), dtype=torch.float32, device=x.device)
    fn = build.kernel_fn("ptt_flxent_tf32_fwd", [_I] + [_P, _L, _L] * 2 + [_P] * 3 + [_I] * 5 + [_P])
    for c0 in range(0, v, sub):
        vc = min(sub, v - c0)
        if scale is None:
            _split_w(w, vocab_major, h, v, c0, vc, wp, None)
        else:
            _launch_widen(w, vocab_major, h, v, c0, vc, wp[0])
        build.check(fn(passes, *_pl(xp), *_pl(wp), 0 if scale is None else scale.data_ptr(), lab.data_ptr(),
                       part.data_ptr(), part.shape[1], n, h, c0, vc, _stream()), f"{what} (tf32x{passes})")
        count_launch(what)


def _bwd_tf32(x, w, lab, lse, gcoef, vocab_major, dx, dw, n, h, v):
    """:func:`flxent_bwd` on the 3xTF32 instance (``csrc/flxent_tf32.cu``).
    One split launch for x (its planes, and x^T's when dW is wanted), then
    per sub-chunk of :func:`flx_tf32_sub` columns in order: one split
    launch for W_c (W_c^T's planes for D, W_c's for dX), D (writing D's
    planes for dX and D^T's for dW), dX into ``dx`` (the first sub-chunk
    overwrites, the rest add) and dW_c. Every operand plane is K-major:
    ``[rows, K]`` with K contiguous. ``dx`` and ``dw`` are the outputs
    (None: not wanted)."""
    dev = x.device
    need_dx, need_dw = dx is not None, dw is not None
    sub = flx_tf32_sub(n, h, v)
    vmax, ldn = min(sub, v), _up4(n)
    ldk = _up4(vmax)
    xp, xt = tf32_planes(x, same=True, trans=need_dw)  # D's A: x [N][H]; dW's x^T [H][N]
    wd = _planes(vmax, h, dev)  # D's B: W_c^T [vc][H]
    wx = _planes(h, ldk, dev) if need_dx else None  # dX's B: W_c [H][vc]
    dp = _planes(n, ldk, dev) if need_dx else None  # dX's A: D [N][vc]
    dt = _planes(vmax, ldn, dev) if need_dw else None  # dW's D^T [vc][N]
    fn_dx = build.kernel_fn("ptt_flxent_tf32_dx", [_P, _L, _L] * 2 + [_P] + [_I] * 4 + [_P])
    fn_dw = build.kernel_fn("ptt_flxent_tf32_dw", [_P, _L, _L] * 2 + [_P, _L] + [_I] * 3 + [_P])
    with torch.cuda.device(dev):
        for i, c0 in enumerate(range(0, v, sub)):
            vc = min(sub, v - c0)
            _split_w(w, vocab_major, h, v, c0, vc, wd, wx)
            _launch_tf32_dchunk(xp, wd, lab, lse, gcoef, None, 0, dp, dt, n, h, c0, vc)
            if need_dx:
                build.check(fn_dx(*_pl(dp), *_pl(wx), dx.data_ptr(), n, h, vc, int(i == 0), _stream()),
                            "flxent_dx (tf32x3)")
                count_launch("flxent_dx")
            if need_dw:
                if vocab_major:  # dW[c0 + v][h] = sum_r D[r][v] x[r][h]
                    args = (*_pl(dt), *_pl(xt), dw.data_ptr() + 4 * c0 * h, h, vc, h, n)
                else:  # dW[h][c0 + v] = sum_r x[r][h] D[r][v]
                    args = (*_pl(xt), *_pl(dt), dw.data_ptr() + 4 * c0, v, h, vc, n)
                build.check(fn_dw(*args, _stream()), "flxent_dw (tf32x3)")
                count_launch("flxent_dw")
    return dx, dw


def _launch_dchunk(io, route, vocab_major, x, w, lab, lse, gcoef, d, ldd, n, h, v, c0, vc) -> None:
    """One launch: ``D`` of the vocab columns ``[c0, c0 + vc)`` into ``d [N, ldd]``."""
    fn = build.kernel_fn("ptt_flxent_dchunk", [_I, _I, _I] + [_P] * 6 + [_L] + [_I] * 5 + [_P])
    build.check(fn(io, _ROUTES[route], int(vocab_major), x.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                   gcoef.data_ptr(), d.data_ptr(), ldd, n, h, v, c0, vc, _stream()), "flxent_dchunk")
    count_launch("flxent_dchunk")


def flxent_dchunk(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, gcoef: torch.Tensor,
    c0: int, c1: int, vocab_major: bool = False,
) -> torch.Tensor:
    """``D [N, c1 - c0]`` in ``x``'s dtype of the vocab columns ``c0:c1``
    (``0 <= c0 < c1 <= V``; one launch of the recompute that kernels 18
    and 19 share, on :func:`flx_route`'s instance: on ``"tf32x3"`` after
    two split launches, x's planes and the chunk's W_c^T's)."""
    if x.device.type == "cpu":
        return flxent_dchunk_plain(x, w, labels, lse, gcoef, c0, c1, vocab_major)
    io, route, x, w, lab, lse, gcoef, n, h, v = _backward_operands("flxent_dchunk", x, w, labels, lse, gcoef,
                                                                   vocab_major)
    if not 0 <= c0 < c1 <= v:
        raise ValueError(f"flxent_dchunk: columns {c0}:{c1} are not a range of [0, {v})")
    if route == "tf32x3":
        if not n:
            return torch.empty((0, c1 - c0), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            return _dchunk_tf32(x, w, lab, lse, gcoef, vocab_major, n, h, v, c0, c1)
    ldd = -(-(c1 - c0) // 8) * 8
    d = torch.empty((n, ldd), dtype=x.dtype, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            _launch_dchunk(io, route, vocab_major, x, w, lab, lse, gcoef, d, ldd, n, h, v, c0, c1 - c0)
    return d[:, :c1 - c0]


def flxent_bwd(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, gcoef: torch.Tensor,
    vocab_major: bool = False, need_dx: bool = True, need_dw: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dx, dw)`` of the loss given the forward's ``lse`` and the per-row
    ``gcoef`` (fp32 ``[N]``); a gradient not asked for is None. Per vocab
    chunk of :data:`CHUNK` columns, three launches on the instance
    :func:`flx_route` names, each counted: the chunk's ``D`` (``[N,
    CHUNK]`` in x's dtype), then kernel 18 adds ``D W_c^T`` into an fp32
    ``[N, H]`` partial (the last chunk writes ``dx``; in fp32 the partial is
    ``dx`` itself) and kernel 19 writes ``dW_c = x^T D``; on ``"tf32x3"``
    the split launches before them (:func:`_bwd_tf32`). The chunks run in
    order: two calls give the same bits."""
    if x.device.type == "cpu":
        return flxent_bwd_plain(x, w, labels, lse, gcoef, vocab_major, need_dx, need_dw)
    io, route, x, w, lab, lse, gcoef, n, h, v = _backward_operands("flxent_bwd", x, w, labels, lse, gcoef,
                                                                   vocab_major)
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if not (need_dx or need_dw):
        return dx, dw
    if not (n and v):
        return (None if dx is None else dx.zero_()), (None if dw is None else dw.zero_())
    if route == "tf32x3":
        return _bwd_tf32(x, w, lab, lse, gcoef, vocab_major, dx, dw, n, h, v)
    chunks = list(range(0, v, CHUNK))
    ldd = -(-min(CHUNK, v) // 8) * 8
    d = torch.empty((n, ldd), dtype=x.dtype, device=x.device)
    acc = None  # fp32 accumulates in dx itself
    if need_dx and len(chunks) > 1 and x.dtype != torch.float32:
        acc = torch.empty((n, h), dtype=torch.float32, device=x.device)
    fn_dx = build.kernel_fn("ptt_flxent_dx", [_I, _I, _I, _P, _L, _P, _P, _P] + [_I] * 7 + [_P])
    fn_dw = build.kernel_fn("ptt_flxent_dw", [_I, _I, _I, _P, _P, _L, _P] + [_I] * 5 + [_P])
    with torch.cuda.device(x.device):
        for i, c0 in enumerate(chunks):
            vc = min(CHUNK, v - c0)
            _launch_dchunk(io, route, vocab_major, x, w, lab, lse, gcoef, d, ldd, n, h, v, c0, vc)
            if need_dx:
                build.check(fn_dx(io, _ROUTES[route], int(vocab_major), d.data_ptr(), ldd, w.data_ptr(),
                                  0 if acc is None else acc.data_ptr(), dx.data_ptr(), n, h, v, c0, vc,
                                  int(i == 0), int(i == len(chunks) - 1), _stream()), "flxent_dx")
                count_launch("flxent_dx")
            if need_dw:
                build.check(fn_dw(io, _ROUTES[route], int(vocab_major), x.data_ptr(), d.data_ptr(), ldd, dw.data_ptr(),
                                  n, h, v, c0, vc, _stream()), "flxent_dw")
                count_launch("flxent_dw")
    return dx, dw


def _reduce(per: torch.Tensor, valid: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return per.sum() / valid.sum().to(torch.float32).clamp(min=1.0)
    if reduction == "sum":
        return per.sum()
    return per


class FusedLinearCrossEntropyFunction(torch.autograd.Function):
    """The loss of ``x2 [N, H]``, ``W`` and int32 labels ``[N]`` (the JAX
    package's ``_build_core`` shell) on either engine: the kernels
    (:func:`flxent_fwd`, :func:`flxent_bwd`) or their plain versions. The
    forward saves ``x``, ``W``, the labels and the ``[N]`` fp32 ``lse``
    only; no ``[N, V]`` tensor outlives a call."""

    @staticmethod
    def forward(ctx, x2, w, lab, ignore_index, reduction, vocab_major, use_kernels):  # noqa: D401
        fwd = flxent_fwd if use_kernels else flxent_fwd_plain
        lse, tl = fwd(x2, w, lab, vocab_major)
        valid = lab != ignore_index
        ctx.save_for_backward(x2, w, lab, lse)
        ctx.cfg = (ignore_index, reduction, vocab_major, use_kernels)
        return _reduce(torch.where(valid, lse - tl, 0.0), valid, reduction)

    @staticmethod
    def backward(ctx, g):
        x2, w, lab, lse = ctx.saved_tensors
        ignore_index, reduction, vocab_major, use_kernels = ctx.cfg
        valid = lab != ignore_index
        g = g.float()
        if reduction == "mean":
            g_row = (g / valid.sum().to(torch.float32).clamp(min=1.0)).expand(lse.shape)
        elif reduction == "sum":
            g_row = g.expand(lse.shape)
        else:
            g_row = g  # the [N] cotangent of reduction="none"
        gcoef = torch.where(valid, g_row, 0.0).contiguous()
        bwd = flxent_bwd if use_kernels else flxent_bwd_plain
        dx, dw = bwd(x2, w, lab, lse, gcoef, vocab_major, ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dx, dw, None, None, None, None, None


class Int8HeadLossFunction(torch.autograd.Function):
    """The loss of ``x2 [N, H]`` against an int8 ``W`` with per-column
    ``scale`` (the JAX package's forward-only quantized walk and its
    ``_quant_epilogue``): kernel 17's int8 site or its plain version. Its
    backward raises: the JAX package has no VJP there either."""

    @staticmethod
    def forward(ctx, x2, w8, scale, lab, ignore_index, reduction, vocab_major, use_kernels):  # noqa: D401
        fwd = flxent_fwd_int8 if use_kernels else flxent_fwd_int8_plain
        lse, tl = fwd(x2, w8, scale, lab, vocab_major)
        valid = lab != ignore_index
        return _reduce(torch.where(valid, lse - tl, 0.0), valid, reduction)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("fused_linear_cross_entropy with weight_scale (a weight-only int8 lm head) is "
                           "forward-only: it has no gradient")


def linear_cross_entropy(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
    reduction: str = "mean", vocab_major: bool = False, use_kernels: bool = True,
    weight_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``cross_entropy(x @ W, labels)`` through
    :class:`FusedLinearCrossEntropyFunction` for any leading shape of ``x``
    (``[..., H]``) and ``labels`` (``[...]``); fp32, ``[...]`` for
    ``reduction="none"``. ``use_kernels=False`` runs the plain versions on
    any device. With ``weight_scale`` (``W`` int8) it is
    :class:`Int8HeadLossFunction`, forward only."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"fused_linear_cross_entropy: unsupported reduction {reduction!r}")
    lead, h = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, h)
    lab = labels.reshape(-1).to(device=x.device, dtype=torch.int32)
    if lab.shape[0] != x2.shape[0]:
        raise ValueError(f"fused_linear_cross_entropy: labels {tuple(labels.shape)} do not fit x {tuple(x.shape)}")
    if weight_scale is not None:
        loss = Int8HeadLossFunction.apply(
            x2, w, weight_scale, lab, int(ignore_index), reduction, bool(vocab_major), bool(use_kernels))
    else:
        loss = FusedLinearCrossEntropyFunction.apply(
            x2, w, lab, int(ignore_index), reduction, bool(vocab_major), bool(use_kernels))
    return loss.reshape(lead) if reduction == "none" else loss
