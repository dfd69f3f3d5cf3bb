"""Fused residual+RMSNorm and embed+RMSNorm: CUDA kernels and plain versions.

Ports of the two Pallas epilogue kernels of the serving step
(``paddle_tpu/kernels/fused.py``):

- :func:`fused_rms_norm_residual` — ``_rms_res_fwd_kernel`` (kernel C):
  ``r = x + residual`` in the I/O dtype, then ``y = rms(r) * w``;
- :func:`fused_embed_rms_norm` — ``_embed_rms_kernel`` (kernel B): token-id
  gather (ids clipped to ``[0, V-1]``), the raw row, and its RMSNorm.

Both multiply the weight in fp32 BEFORE the downcast, the Pallas order (the
JAX package's XLA path downcasts first; in fp32 the two agree to rounding).
Each wrapper runs its plain PyTorch version for CPU tensors; for CUDA tensors
it launches the kernel (``csrc/rms_residual.cu``, ``csrc/embed_rms.cu``) or
raises — it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "fused_embed_rms_norm",
    "fused_embed_rms_norm_plain",
    "fused_rms_norm_residual",
    "fused_rms_norm_residual_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _rms_rows(xf: torch.Tensor, weight: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """``rms(xf) * w`` on fp32 rows, the weight applied before the downcast."""
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * weight.float()).to(dtype)


def fused_rms_norm_residual_plain(
    x: torch.Tensor, weight: torch.Tensor, residual: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    r = x + residual
    return _rms_rows(r.float(), weight, epsilon, r.dtype), r


def fused_embed_rms_norm_plain(
    ids: torch.Tensor, table: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    emb = table[ids.long().clamp(0, table.shape[0] - 1)]
    return emb, _rms_rows(emb.float(), weight, epsilon, emb.dtype)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned for the CUDA kernel")


def fused_rms_norm_residual(
    x: torch.Tensor, weight: torch.Tensor, residual: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``r = x + residual; y = rms_norm(r) * weight``; returns ``(y, r)``,
    any leading shape, the norm over the last axis. The argument order is the
    JAX package's incubate entry's."""
    if x.device.type == "cpu":
        return fused_rms_norm_residual_plain(x, weight, residual, epsilon)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rms_norm_residual: unsupported device {x.device}")
    h = x.shape[-1]
    if h % 8:
        raise ValueError(f"fused_rms_norm_residual: hidden size {h} is not a multiple of 8")
    if residual.shape != x.shape or weight.shape != (h,):
        raise ValueError(
            f"fused_rms_norm_residual: shapes x {tuple(x.shape)}, residual "
            f"{tuple(residual.shape)}, weight {tuple(weight.shape)} do not match"
        )
    for name, t in (("x", x), ("residual", residual), ("weight", weight)):
        _require(t, name, torch.bfloat16, x.device)
    y = torch.empty_like(x)
    r = torch.empty_like(x)
    rows = x.numel() // h
    if rows:
        fn = build.kernel_fn("ptt_rms_residual_bf16", [_P, _P, _P, _P, _P, _I, _I, _F, _P])
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(), y.data_ptr(),
                     r.data_ptr(), rows, h, float(epsilon),
                     torch.cuda.current_stream().cuda_stream)
        build.check(err, "rms_residual")
        count_launch("rms_residual")
    return y, r


def fused_embed_rms_norm(
    ids: torch.Tensor, table: torch.Tensor, weight: torch.Tensor, epsilon: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather ``table`` rows for ``ids`` (clipped to ``[0, V-1]``) and norm
    them with ``weight``; returns ``(emb, y)``, both ``[*ids.shape, H]``."""
    if table.device.type == "cpu":
        return fused_embed_rms_norm_plain(ids, table, weight, epsilon)
    if table.device.type != "cuda":
        raise ValueError(f"fused_embed_rms_norm: unsupported device {table.device}")
    v, h = table.shape
    if h % 8:
        raise ValueError(f"fused_embed_rms_norm: hidden size {h} is not a multiple of 8")
    if weight.shape != (h,):
        raise ValueError(f"fused_embed_rms_norm: weight {tuple(weight.shape)} is not [{h}]")
    ids32 = ids.to(device=table.device, dtype=torch.int32).contiguous()
    for name, t in (("table", table), ("weight", weight)):
        _require(t, name, torch.bfloat16, table.device)
    emb = torch.empty((*ids.shape, h), dtype=table.dtype, device=table.device)
    y = torch.empty_like(emb)
    rows = ids32.numel()
    if rows:
        fn = build.kernel_fn("ptt_embed_rms_bf16", [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P])
        with torch.cuda.device(table.device):
            err = fn(ids32.data_ptr(), table.data_ptr(), weight.data_ptr(), emb.data_ptr(),
                     y.data_ptr(), rows, v, h, float(epsilon),
                     torch.cuda.current_stream().cuda_stream)
        build.check(err, "embed_rms")
        count_launch("embed_rms")
    return emb, y
