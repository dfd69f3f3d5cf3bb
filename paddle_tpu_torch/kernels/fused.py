"""RMSNorm, rope and the fused RMSNorm epilogues: CUDA kernels, their plain
versions, and the autograd ``Function``s of the training norms and rope.

Ports of Pallas kernels of ``paddle_tpu/kernels/fused.py``:

- :func:`fused_rms_norm_residual` — ``_rms_res_fwd_kernel`` (kernel C):
  ``r = x + residual`` in the I/O dtype, then ``y = rms(r) * w``;
  :func:`rms_residual_bwd` — ``_rms_res_bwd_kernel`` (kernel 11): its
  adjoint, ``dx``, ``dw`` from the saved ``r`` (rstd recomputed);
- :func:`ln_residual` / :func:`ln_residual_bwd` — ``_ln_res_fwd_kernel``
  and ``_ln_res_bwd_kernel`` (kernels 12 and 13): ``r = x + residual``,
  LayerNorm with bias, and its adjoint ``dx``, ``dw``, ``db`` from ``r``;
- :func:`fused_embed_rms_norm` — ``_embed_rms_kernel`` (kernel B): token-id
  gather (ids clipped to ``[0, V-1]``), the raw row, and its RMSNorm;
- :func:`rms_norm_fwd` / :func:`rms_norm_bwd` — ``_rms_fwd_kernel`` and
  ``_rms_bwd_kernel`` (kernels 7 and 8): RMSNorm saving the fp32 ``rstd``
  per row, and its ``dx``, ``dw``; :class:`RMSNormFunction` joins them;
- :func:`rope_fwd` / :func:`rope_bwd` — ``_rope_kernel`` and
  ``_rope_bwd_kernel`` (kernels 9 and 10): neox rope of ``[B, S, H, D]``
  with fp32 ``[S, D]`` tables, and its adjoint; :class:`RopeFunction`
  joins them.

Every kernel here takes bf16, fp16 or fp32. Every norm here multiplies the
weight in fp32 BEFORE the downcast, the Pallas order (the unfused composition of ``nn.functional.rms_norm``
downcasts first; in fp32 the two agree to rounding). The rope computes in
fp32 from fp32 tables and casts once (the composition casts the tables to
``x``'s dtype first). Each wrapper runs its plain PyTorch version for CPU
tensors; for CUDA tensors it launches its kernel (``csrc/rms_residual.cu``,
``csrc/embed_rms.cu``, ``csrc/rms_norm.cu``, ``csrc/ln_residual.cu``,
``csrc/rope.cu``) or raises — it never falls back. The residual norms'
plain adjoints are also the JAX package's fp32 adjoint formulas, which its
incubate entries run for shapes outside the kernels' gate.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "RMSNormFunction",
    "RopeFunction",
    "fused_embed_rms_norm",
    "fused_embed_rms_norm_plain",
    "fused_rms_norm",
    "fused_rms_norm_residual",
    "fused_rms_norm_residual_plain",
    "fused_rope",
    "ln_residual",
    "ln_residual_adjoint",
    "ln_residual_bwd",
    "ln_residual_bwd_plain",
    "ln_residual_plain",
    "rms_norm_bwd",
    "rms_norm_bwd_plain",
    "rms_norm_fwd",
    "rms_norm_fwd_plain",
    "ln_bwd_plan",
    "rms_fwd_plan",
    "rms_residual_adjoint",
    "rms_residual_bwd",
    "rms_residual_bwd_plain",
    "rope_bwd",
    "rope_bwd_plain",
    "rope_fwd",
    "rope_fwd_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# the I/O types of kernels 7-10 -> the C entry points' type code (ptt::IoType)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block can use
_SMEM_PER_SM = 233472  # bytes of shared memory an SM shares among its blocks
_SMEM_RESERVED = 1024 + 256  # per block: the runtime's reserve and the static reduction buffers
_BWD_BLOCKS_PER_SM = 4  # norm backward row blocks: at most 4 of 256 threads per SM
# kernel 7's register route (csrc/rms_norm.cu `rms_fwd_kernel_regs`)
RMS_FWD_BLOCK_WARPS = 4  # warps per block: a row takes 1, 2 or 4 of them
RMS_FWD_MAX_VECS = 16  # 16-byte vectors of x a lane holds, at most (and as many of w): 128 registers
# kernel 13's register route (csrc/ln_residual.cu `ln_residual_bwd_kernel_regs`)
LN_BWD_MAX_VECS = 6  # 16-byte vectors of r (and of g, w) a lane holds, at most, beside 2 x 8 fp32 partials each
LN_BWD_WARPS = (4, 8, 2, 1)  # warps a row, in the order the plan tries them


def _rms_rows(x: torch.Tensor, weight: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rms(x) * w, rstd)``: fp32 rows, the weight applied before the
    downcast to ``x``'s dtype (every norm kernel's order)."""
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def rms_norm_fwd_plain(
    x: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)``: ``y = x * rstd * w`` in fp32, cast to ``x``'s dtype,
    and the fp32 ``rstd = rsqrt(mean(x^2) + eps)`` of shape ``x.shape[:-1]``.
    Differentiable by autograd (a plain reference path uses that)."""
    y, rstd = _rms_rows(x, weight, epsilon)
    return y, rstd.squeeze(-1)


def rms_norm_bwd_plain(
    x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rms_norm_fwd_plain` given its ``rstd``:
    ``dx = rstd (g w - x^ mean(g w x^))`` with ``x^ = x rstd``, in ``x``'s
    dtype; ``dw = sum over rows of g x^`` in fp32, cast to ``w``'s dtype."""
    xf, gf = x.float(), g.float()
    r = rstd.float().unsqueeze(-1)
    xhat = xf * r
    gw = gf * weight.float()
    dot = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (gw - xhat * dot)).to(x.dtype)
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0).to(weight.dtype)
    return dx, dw


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """``[x1, x2] -> [-x2, x1]`` over the last axis (neox)."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _unrotate_half(v: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_rotate_half`: ``[v1, v2] -> [v2, -v1]``."""
    half = v.shape[-1] // 2
    return torch.cat([v[..., half:], -v[..., :half]], dim=-1)


def _tables4(cos: torch.Tensor, sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return cos.float()[None, :, None, :], sin.float()[None, :, None, :]


def rope_fwd_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Neox rope ``x * cos + rot(x) * sin`` of ``x [B, S, H, D]`` with
    ``[S, D]`` tables, in fp32, cast once to ``x``'s dtype."""
    c, s = _tables4(cos, sin)
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def rope_bwd_plain(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rope's adjoint in ``x``: ``g * cos + unrot(g * sin)`` (exact for
    any tables), in fp32, cast once to ``g``'s dtype."""
    c, s = _tables4(cos, sin)
    gf = g.float()
    return (gf * c + _unrotate_half(gf * s)).to(g.dtype)


def fused_rms_norm_residual_plain(
    x: torch.Tensor, weight: torch.Tensor, residual: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    r = x + residual
    return _rms_rows(r, weight, epsilon)[0], r


def fused_embed_rms_norm_plain(
    ids: torch.Tensor, table: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    emb = table[ids.long().clamp(0, table.shape[0] - 1)]
    return emb, _rms_rows(emb, weight, epsilon)[0]


def rms_residual_adjoint(
    g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of the norm half of :func:`fused_rms_norm_residual` given
    ``y``'s cotangent ``g`` and the saved residual stream ``r``, in fp32:
    ``rstd = rsqrt(mean(r^2) + eps)``, ``x^ = r rstd``, ``dx = rstd (g w -
    x^ mean(g w x^))`` in ``g``'s dtype, ``dw = sum over rows of g x^`` cast
    to ``w``'s dtype. The JAX package's fp32 adjoint formula, which its
    incubate entry runs outside kernel 11's gate."""
    rf, gf = r.float(), g.float()
    rstd = torch.rsqrt(rf.square().mean(dim=-1, keepdim=True) + epsilon)
    xhat = rf * rstd
    gw = gf * weight.float()
    dot = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gw - xhat * dot)).to(g.dtype)
    dw = (gf * xhat).reshape(-1, r.shape[-1]).sum(dim=0).to(weight.dtype)
    return dx, dw


def rms_residual_bwd_plain(
    g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11's plain version: :func:`rms_residual_adjoint`, the
    arithmetic of the Pallas kernel."""
    return rms_residual_adjoint(g, r, weight, epsilon)


def ln_residual_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], residual: torch.Tensor,
    epsilon: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, r)``: ``r = x + residual`` in the I/O dtype, then in fp32 ``y =
    (r - mean) rsqrt(var + eps) w + b`` cast once to ``x``'s dtype (a
    missing bias counts as zeros). Differentiable by autograd."""
    r = x + residual
    rf = r.float()
    mu = rf.mean(dim=-1, keepdim=True)
    var = (rf - mu).square().mean(dim=-1, keepdim=True)
    y = (rf - mu) * torch.rsqrt(var + epsilon) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), r


def ln_residual_adjoint(
    g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` of :func:`ln_residual_plain`'s norm half given ``y``'s
    cotangent ``g`` and the saved ``r``, in fp32: mean and rstd recomputed
    from ``r``, ``x^ = (r - mean) rstd``, ``dx = rstd (g w - mean(g w) -
    x^ mean(g w x^))`` in ``g``'s dtype; ``dw = sum g x^`` and ``db = sum
    g`` over rows, cast to ``w``'s dtype. The JAX package's fp32 adjoint
    formula, which its incubate entry runs outside kernel 13's gate."""
    rf, gf = r.float(), g.float()
    mu = rf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((rf - mu).square().mean(dim=-1, keepdim=True) + epsilon)
    xhat = (rf - mu) * rstd
    gw = gf * weight.float()
    m1 = gw.mean(dim=-1, keepdim=True)
    m2 = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gw - m1 - xhat * m2)).to(g.dtype)
    h = r.shape[-1]
    dw = (gf * xhat).reshape(-1, h).sum(dim=0).to(weight.dtype)
    db = gf.reshape(-1, h).sum(dim=0).to(weight.dtype)
    return dx, dw, db


def ln_residual_bwd_plain(
    g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 13's plain version: :func:`ln_residual_adjoint`, the
    arithmetic of the Pallas kernel."""
    return ln_residual_adjoint(g, r, weight, epsilon)


def _kernel_operand(t: torch.Tensor, name: str, what: str, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte aligned ``dtype`` tensor on ``device``,
    or an exception naming what the kernel does not take."""
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned for the CUDA kernel")
    return t


def fused_rms_norm_residual(
    x: torch.Tensor, weight: torch.Tensor, residual: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + residual; y = rms_norm(r) * weight``; returns ``(y, r)``,
    any leading shape, the norm over the last axis, bf16, fp16 or fp32 (all
    three of one type). The argument order is the JAX package's incubate
    entry's."""
    if x.device.type == "cpu":
        return fused_rms_norm_residual_plain(x, weight, residual, epsilon)
    io = _io_dtype("fused_rms_norm_residual", x)
    h = x.shape[-1]
    if (h * x.element_size()) % 16:
        raise ValueError(f"fused_rms_norm_residual: a row of {h} {x.dtype} is not a whole number of 16 bytes")
    if residual.shape != x.shape or weight.shape != (h,):
        raise ValueError(
            f"fused_rms_norm_residual: shapes x {tuple(x.shape)}, residual "
            f"{tuple(residual.shape)}, weight {tuple(weight.shape)} do not match"
        )
    dev = x.device
    x, residual, weight = (_kernel_operand(t, name, "fused_rms_norm_residual", x.dtype, dev)
                           for name, t in (("x", x), ("residual", residual), ("weight", weight)))
    y = torch.empty_like(x)
    r = torch.empty_like(x)
    rows = x.numel() // h
    if rows:
        fn = build.kernel_fn("ptt_rms_residual", [_I, _P, _P, _P, _P, _P, _I, _I, _F, _P])
        with torch.cuda.device(x.device):
            err = fn(io, x.data_ptr(), residual.data_ptr(), weight.data_ptr(), y.data_ptr(),
                     r.data_ptr(), rows, h, float(epsilon), torch.cuda.current_stream().cuda_stream)
        build.check(err, "rms_residual")
        count_launch("rms_residual")
    return y, r


def fused_embed_rms_norm(
    ids: torch.Tensor, table: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather ``table`` rows for ``ids`` (clipped to ``[0, V-1]``) and norm
    them with ``weight``; returns ``(emb, y)``, both ``[*ids.shape, H]``;
    bf16, fp16 or fp32 (table and weight of one type). Inference only: the
    outputs carry no gradient on any device (the kernel's never could)."""
    if table.device.type == "cpu":
        with torch.no_grad():
            return fused_embed_rms_norm_plain(ids, table, weight, epsilon)
    io = _io_dtype("fused_embed_rms_norm", table)
    v, h = table.shape
    if (h * table.element_size()) % 16:
        raise ValueError(f"fused_embed_rms_norm: a row of {h} {table.dtype} is not a whole number of 16 bytes")
    if weight.shape != (h,):
        raise ValueError(f"fused_embed_rms_norm: weight {tuple(weight.shape)} is not [{h}]")
    ids32 = ids.to(device=table.device, dtype=torch.int32).contiguous()
    dev = table.device
    table, weight = (_kernel_operand(t, name, "fused_embed_rms_norm", table.dtype, dev)
                     for name, t in (("table", table), ("weight", weight)))
    emb = torch.empty((*ids.shape, h), dtype=table.dtype, device=table.device)
    y = torch.empty_like(emb)
    rows = ids32.numel()
    if rows:
        fn = build.kernel_fn("ptt_embed_rms", [_I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P])
        with torch.cuda.device(table.device):
            err = fn(io, ids32.data_ptr(), table.data_ptr(), weight.data_ptr(), emb.data_ptr(),
                     y.data_ptr(), rows, v, h, float(epsilon), torch.cuda.current_stream().cuda_stream)
        build.check(err, "embed_rms")
        count_launch("embed_rms")
    return emb, y


# -- kernels 7-10: RMSNorm forward/backward, rope forward/adjoint -------------

def _io_dtype(what: str, x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes bf16, fp16 or fp32, not {x.dtype}")
    return _KERNEL_DTYPES[x.dtype]


def _norm_width(what: str, x: torch.Tensor, weight: torch.Tensor, row_buffers: int = 1) -> int:
    """The last axis, checked: a multiple of 8, the weight ``[H]``, and
    ``row_buffers`` fp32 ``[H]`` buffers within a block's shared memory."""
    h = x.shape[-1]
    if h % 8 or weight.shape != (h,):
        raise ValueError(f"{what}: needs the last axis a multiple of 8 and weight [{h}], "
                         f"got x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    if row_buffers * h * 4 + 256 > _SMEM_PER_BLOCK:
        raise ValueError(f"{what}: hidden size {h} needs more shared memory than a block has")
    return h


def _row_blocks(dev: torch.device, rows: int, smem: int) -> Tuple[int, int]:
    """``(rows_per_block, blocks)`` of a norm backward: at most
    ``_BWD_BLOCKS_PER_SM`` blocks per SM, fewer where ``smem`` bytes each
    do not fit an SM together, each owning a contiguous range of rows."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_sm = max(1, min(_BWD_BLOCKS_PER_SM, _SMEM_PER_SM // (smem + _SMEM_RESERVED)))
    nblk = min(rows, per_sm * _sm_count(index))
    per_block = -(-rows // nblk)
    return per_block, -(-rows // per_block)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rms_fwd_plan(h: int, dtype: torch.dtype) -> dict:
    """Kernel 7's launch plan for rows of width ``h`` in ``dtype`` (a host
    function: no card needed).

    ``route`` is ``"regs"`` when a row is a whole number ``vecs * W * 32``
    of 16-byte vectors with ``vecs`` at most :data:`RMS_FWD_MAX_VECS` for
    some W of 4, 2, 1 (the most that divides the row): a group of
    ``warps_per_row`` (W) warps holds a row in registers, ``vecs`` vectors
    a lane, :data:`RMS_FWD_BLOCK_WARPS` / W rows a block. The widest split
    is the fastest on an H100 (more warps keep more loads in flight:
    ``chip_smoke.py``'s ``rms_norm_fwd_rows`` times 1, 2 and 4 warps a
    row), so the plan depends on no row count or card. Otherwise
    ``"loop"``: one warp a row, 8 rows a block, over a runtime width
    (``vecs`` 0)."""
    n = 16 // dtype.itemsize
    lane_vecs = h // n // 32 if h % (n * 32) == 0 else 0
    for w in (4, 2, 1):
        if lane_vecs and lane_vecs % w == 0 and lane_vecs // w <= RMS_FWD_MAX_VECS:
            return {"route": "regs", "vecs": lane_vecs // w, "warps_per_row": w}
    return {"route": "loop", "vecs": 0, "warps_per_row": 1}


def ln_bwd_plan(h: int, dtype: torch.dtype) -> dict:
    """Kernel 13's launch plan for rows of width ``h`` in ``dtype`` (a host
    function: no card needed).

    ``route`` is ``"regs"`` when a row is a whole number ``vecs * W * 32``
    of 16-byte vectors with ``vecs`` at most :data:`LN_BWD_MAX_VECS` for
    some W of :data:`LN_BWD_WARPS` (4 first, then 8, 2, 1): a block of
    ``warps_per_row`` (W) warps walks its rows with each lane's ``vecs``
    vectors of the row, and the fp32 dw and db partials of their columns,
    in registers (H 5120 bf16: 4 warps, 5 vectors). Otherwise ``"loop"``:
    256 threads a row over a runtime width, the row and the partials in
    shared memory (``vecs`` 0)."""
    n = 16 // dtype.itemsize
    lane_vecs = h // n // 32 if h % (n * 32) == 0 else 0
    for w in LN_BWD_WARPS:
        if lane_vecs and lane_vecs % w == 0 and lane_vecs // w <= LN_BWD_MAX_VECS:
            return {"route": "regs", "vecs": lane_vecs // w, "warps_per_row": w}
    return {"route": "loop", "vecs": 0, "warps_per_row": 8}


@functools.lru_cache(maxsize=None)
def _ln_bwd_blocks_per_sm(index: int, io: int, h: int, vecs: int, warps: int) -> int:
    """The register route's blocks an SM holds at once on card ``index``
    (the kernel's occupancy of registers and its ring's shared memory), at
    most ``_BWD_BLOCKS_PER_SM``: each block writes 2H fp32 partials."""
    per_sm = ctypes.c_int(0)
    fn = build.kernel_fn("ptt_ln_residual_bwd_blocks", [_I] * 4 + [_P])
    with torch.cuda.device(index):
        build.check(fn(io, h, vecs, warps, ctypes.byref(per_sm)), "ln_residual_bwd (occupancy)")
    if per_sm.value < 1:
        raise RuntimeError(f"ln_residual_bwd: no block of width {h} fits an SM")
    return min(per_sm.value, _BWD_BLOCKS_PER_SM)


def rms_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last axis, any leading shape (kernel 7); returns
    ``(y, rstd)`` with ``rstd`` fp32 of shape ``x.shape[:-1]``."""
    if x.device.type == "cpu":
        return rms_norm_fwd_plain(x, weight, epsilon)
    io = _io_dtype("rms_norm_fwd", x)
    h = _norm_width("rms_norm_fwd", x, weight)
    x = _kernel_operand(x, "x", "rms_norm_fwd", x.dtype, x.device)
    weight = _kernel_operand(weight, "weight", "rms_norm_fwd", x.dtype, x.device)
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rows = x.numel() // h if h else 0
    if rows:
        plan = rms_fwd_plan(h, x.dtype)
        fn = build.kernel_fn("ptt_rms_norm_fwd", [_I, _P, _P, _P, _P] + [_I] * 4 + [_F, _P])
        with torch.cuda.device(x.device):
            err = fn(io, x.data_ptr(), weight.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows, h, plan["vecs"],
                     plan["warps_per_row"], float(epsilon), torch.cuda.current_stream().cuda_stream)
        build.check(err, "rms_norm_fwd")
        count_launch("rms_norm_fwd")
    return y, rstd


def rms_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rms_norm_fwd` given its ``rstd`` (kernel 8).
    ``dw`` is summed over rows in fp32 from per-block partials in a fixed
    order (no atomics: two runs give the same bits). The row pass and the
    partials' sum are two launches and count as one call."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, rstd, g)
    io = _io_dtype("rms_norm_bwd", x)
    h = _norm_width("rms_norm_bwd", x, weight)
    if g.shape != x.shape or rstd.shape != x.shape[:-1]:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} and rstd {tuple(rstd.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    dev = x.device
    x = _kernel_operand(x, "x", "rms_norm_bwd", x.dtype, dev)
    weight = _kernel_operand(weight, "weight", "rms_norm_bwd", x.dtype, dev)
    g = _kernel_operand(g, "g", "rms_norm_bwd", x.dtype, dev)
    rstd = _kernel_operand(rstd, "rstd", "rms_norm_bwd", torch.float32, dev)
    dx = torch.empty_like(x)
    rows = x.numel() // h if h else 0
    if not rows:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    per_block, nblk = _row_blocks(dev, rows, h * 4)
    partials = torch.empty((nblk, h), dtype=torch.float32, device=dev)
    fn = build.kernel_fn("ptt_rms_norm_bwd", [_I] + [_P] * 7 + [_I] * 4 + [_P])
    with torch.cuda.device(dev):
        err = fn(io, x.data_ptr(), weight.data_ptr(), rstd.data_ptr(), g.data_ptr(),
                 dx.data_ptr(), dw.data_ptr(), partials.data_ptr(), rows, h, per_block, nblk,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rms_norm_bwd")
    count_launch("rms_norm_bwd")
    return dx, dw


def _adjoint_operands(what: str, g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                      row_buffers: int) -> Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(io, h, g, r, weight)`` of a residual norm's adjoint kernel, checked
    and contiguous, or an exception naming what the kernel does not take."""
    io = _io_dtype(what, g)
    h = _norm_width(what, g, weight, row_buffers)
    if r.shape != g.shape:
        raise ValueError(f"{what}: g {tuple(g.shape)} and r {tuple(r.shape)} differ")
    dev = g.device
    g, r, weight = (_kernel_operand(t, name, what, g.dtype, dev)
                    for name, t in (("g", g), ("r", r), ("weight", weight)))
    return io, h, g, r, weight


def rms_residual_bwd(
    g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`fused_rms_norm_residual`'s norm half from the
    saved residual stream ``r`` (kernel 11; rstd recomputed per row). ``dw``
    is summed as kernel 8's is (per-block fp32 partials, a fixed-order
    column sum: two launches, one call)."""
    if g.device.type == "cpu":
        return rms_residual_bwd_plain(g, r, weight, epsilon)
    io, h, g, r, weight = _adjoint_operands("rms_residual_bwd", g, r, weight, 1)
    dx = torch.empty_like(g)
    rows = g.numel() // h if h else 0
    if not rows:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    per_block, nblk = _row_blocks(g.device, rows, h * 4)
    partials = torch.empty((nblk, h), dtype=torch.float32, device=g.device)
    fn = build.kernel_fn("ptt_rms_residual_bwd", [_I] + [_P] * 6 + [_I] * 4 + [_F, _P])
    with torch.cuda.device(g.device):
        err = fn(io, r.data_ptr(), weight.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                 partials.data_ptr(), rows, h, per_block, nblk, float(epsilon),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "rms_residual_bwd")
    count_launch("rms_residual_bwd")
    return dx, dw


def ln_residual(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], residual: torch.Tensor,
    epsilon: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + residual; y = layer_norm(r) * weight + bias`` (kernel 12);
    returns ``(y, r)``, any leading shape, bf16, fp16 or fp32 (x, residual
    and weight of one type; the bias of that type, fp32, or None for
    zeros). The argument order is the JAX package's incubate entry's."""
    if x.device.type == "cpu":
        return ln_residual_plain(x, weight, bias, residual, epsilon)
    io = _io_dtype("ln_residual", x)
    h = _norm_width("ln_residual", x, weight)
    if residual.shape != x.shape or (bias is not None and bias.shape != (h,)):
        raise ValueError(f"ln_residual: shapes x {tuple(x.shape)}, residual {tuple(residual.shape)}, "
                         f"bias {None if bias is None else tuple(bias.shape)} do not match")
    dev = x.device
    x, residual, weight = (_kernel_operand(t, name, "ln_residual", x.dtype, dev)
                           for name, t in (("x", x), ("residual", residual), ("weight", weight)))
    bias_f32 = bias is not None and bias.dtype != x.dtype
    if bias is not None:
        # a bias of another type is read in fp32, as the Pallas kernel reads it
        bias = _kernel_operand(bias.float() if bias_f32 else bias, "bias", "ln_residual",
                               torch.float32 if bias_f32 else x.dtype, dev)
    y = torch.empty_like(x)
    r = torch.empty_like(x)
    rows = x.numel() // h if h else 0
    if rows:
        fn = build.kernel_fn("ptt_ln_residual", [_I, _I] + [_P] * 6 + [_I, _I, _F, _P])
        with torch.cuda.device(dev):
            err = fn(io, int(bias_f32), x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
                     None if bias is None else bias.data_ptr(), y.data_ptr(), r.data_ptr(), rows, h,
                     float(epsilon), torch.cuda.current_stream().cuda_stream)
        build.check(err, "ln_residual")
        count_launch("ln_residual")
    return y, r


def ln_residual_bwd(
    g: torch.Tensor, r: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)`` of :func:`ln_residual`'s norm half from the saved
    ``r`` (kernel 13; mean and rstd recomputed per row), on the route and
    shape of :func:`ln_bwd_plan`. ``dw`` and ``db`` come from per-block
    fp32 partials summed per column in a fixed order (no atomics: two runs
    give the same bits); the row pass and the column sum are two launches
    and count as one call."""
    if g.device.type == "cpu":
        return ln_residual_bwd_plain(g, r, weight, epsilon)
    plan = ln_bwd_plan(g.shape[-1], g.dtype)
    io, h, g, r, weight = _adjoint_operands("ln_residual_bwd", g, r, weight, 3 if plan["route"] == "loop" else 1)
    dx = torch.empty_like(g)
    rows = g.numel() // h if h else 0
    if not rows:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dwdb = torch.empty((2, h), dtype=weight.dtype, device=g.device)
    if plan["route"] == "loop":
        per_block, nblk = _row_blocks(g.device, rows, 3 * h * 4)
    else:
        index = g.device.index if g.device.index is not None else torch.cuda.current_device()
        per_sm = _ln_bwd_blocks_per_sm(index, io, h, plan["vecs"], plan["warps_per_row"])
        per_block = -(-rows // min(rows, per_sm * _sm_count(index)))
        nblk = -(-rows // per_block)
    partials = torch.empty((nblk, 2 * h), dtype=torch.float32, device=g.device)
    fn = build.kernel_fn("ptt_ln_residual_bwd", [_I] + [_P] * 6 + [_I] * 6 + [_F, _P])
    with torch.cuda.device(g.device):
        err = fn(io, r.data_ptr(), weight.data_ptr(), g.data_ptr(), dx.data_ptr(), dwdb.data_ptr(),
                 partials.data_ptr(), rows, h, per_block, nblk, plan["vecs"], plan["warps_per_row"],
                 float(epsilon), torch.cuda.current_stream().cuda_stream)
    build.check(err, "ln_residual_bwd")
    count_launch("ln_residual_bwd")
    return dx, dwdb[0], dwdb[1]


def _rope_launch(what: str, adjoint: bool, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    io = _io_dtype(what, x)
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be [B, S, H, D], got {tuple(x.shape)}")
    b, s, h, d = x.shape
    if d % 16 or cos.shape != (s, d) or sin.shape != (s, d):
        raise ValueError(f"{what}: needs D % 16 == 0 and cos/sin [{s}, {d}], got x {tuple(x.shape)}, "
                         f"cos {tuple(cos.shape)}, sin {tuple(sin.shape)}")
    x = _kernel_operand(x, "x", what, x.dtype, x.device)
    cos = _kernel_operand(cos.float(), "cos", what, torch.float32, x.device)
    sin = _kernel_operand(sin.float(), "sin", what, torch.float32, x.device)
    y = torch.empty_like(x)
    if x.numel():
        fn = build.kernel_fn("ptt_rope", [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P])
        with torch.cuda.device(x.device):
            err = fn(io, int(adjoint), x.data_ptr(), cos.data_ptr(), sin.data_ptr(), y.data_ptr(),
                     b, s, h, d, torch.cuda.current_stream().cuda_stream)
        build.check(err, what)
        count_launch(what)
    return y


def rope_fwd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Neox rope of ``x [B, S, H, D]`` with ``[S, D]`` tables (kernel 9)."""
    if x.device.type == "cpu":
        return rope_fwd_plain(x, cos, sin)
    return _rope_launch("rope_fwd", False, x, cos, sin)


def rope_bwd(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rope's adjoint in ``x``, ``g * cos + unrot(g * sin)`` (kernel 10)."""
    if g.device.type == "cpu":
        return rope_bwd_plain(g, cos, sin)
    return _rope_launch("rope_bwd", True, g, cos, sin)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm whose backward is kernel 8 (the Pallas package's
    ``custom_vjp`` of ``_make_rms``). The forward saves x, w and rstd and
    nothing else, so a recompute rerun and the backward see the same
    inputs."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):  # noqa: D401 - autograd signature
        y, rstd = rms_norm_fwd(x, weight, epsilon)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, rstd, g)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


class RopeFunction(torch.autograd.Function):
    """Neox rope whose ``x`` gradient is kernel 10. The table cotangents
    (tables are buffers in every real model) are computed only when a table
    requires a gradient, as the exact fp32 sums over batch and heads of
    ``g * x`` (cos) and ``g * rot(x)`` (sin) that the JAX package's
    ``custom_vjp`` computes; ``x`` is saved only then."""

    @staticmethod
    def forward(ctx, x, cos, sin):  # noqa: D401 - autograd signature
        y = rope_fwd(x, cos, sin)
        tables_grad = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(x if tables_grad else None, cos, sin)
        return y

    @staticmethod
    def backward(ctx, g):
        x, cos, sin = ctx.saved_tensors
        dx = rope_bwd(g, cos, sin) if ctx.needs_input_grad[0] else None
        dcos = dsin = None
        if x is not None:
            gf, xf = g.float(), x.float()
            if ctx.needs_input_grad[1]:
                dcos = (gf * xf).sum(dim=(0, 2)).to(cos.dtype)
            if ctx.needs_input_grad[2]:
                dsin = (gf * _rotate_half(xf)).sum(dim=(0, 2)).to(sin.dtype)
        return dx, dcos, dsin


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Differentiable RMSNorm through kernels 7 and 8; the counterpart of
    ``fused_rms_norm_pallas``."""
    return RMSNormFunction.apply(x, weight, float(epsilon))


def fused_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Differentiable neox rope of ``x [B, S, H, D]`` with ``[S, D]`` tables
    through kernels 9 and 10; the counterpart of ``fused_rope_pallas``."""
    return RopeFunction.apply(x, cos, sin)
