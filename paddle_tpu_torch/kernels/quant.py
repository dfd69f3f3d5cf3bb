"""Weight-only int8 projections: the quantizer, the in-place model pass, and
the matmul — a CUDA kernel and its plain version.

Port of ``paddle_tpu/kernels/quant.py``. A projection weight ``[K, N]`` (the
MLP's and the lm head's, Paddle's ``[in, out]`` layout) is stored int8 with
one fp32 scale per output column, and ``x @ W`` becomes ``(x @ w8) * scale``:
the scale factors out of the contraction, so the dequantized weight never
exists. Inference only: nothing differentiates through an int8 weight.

:func:`int8_weight_matmul` runs its plain version (the JAX package's XLA
composition, ``(x.f32 @ w8.f32) * scale`` cast to x's dtype) for CPU
tensors and launches ``csrc/wo_matmul.cu`` (kernel 20, ``_wo_matmul_kernel``)
for CUDA tensors: bf16, fp16 or fp32 activations, any K and N. Which of the
kernel's two instances runs is fixed by the dtype and the shape before the
launch (:func:`wo_route`): the wgmma instance for bf16 and fp16 with
``K % 8 == 0`` and ``N % 16 == 0``, the mma.sync instance otherwise (fp32
activations in two TF32 passes of split x, any shape and row alignment).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
from torch import nn

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.fused import _kernel_operand
from paddle_tpu_torch.kernels.select import count_launch

__all__ = [
    "WEIGHT_ONLY_LEAVES",
    "int8_weight_matmul",
    "int8_weight_matmul_plain",
    "plan_makespan",
    "quantize_module_weights",
    "quantize_weight_int8",
    "wo_plan",
    "wo_route",
]

# Leaf names of the layers whose weights the engine quantizes under
# weight_only_int8: the MLP projections and the lm head. Attention
# projections and embeddings stay in their dtype (an embedding also feeds the
# token gather).
WEIGHT_ONLY_LEAVES = ("gate_proj", "up_proj", "down_proj", "fc1", "fc2", "lm_head")

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # ptt::IoType
_ROUTES = {"wgmma": 0, "mma_sync": 1}  # ptt_wo_matmul's route argument


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel absmax quantization of a ``[K, N]``
    weight: ``(w8 [K, N] int8, scale [N] fp32)`` with ``w ~ w8 * scale``
    column by column; an all-zero column gets scale 1. The JAX package's
    arithmetic op for op (fp32 ``absmax / 127``, a division, round half to
    even, clip to +-127), so the two give the same bits."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w8 = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return w8, scale


def quantize_module_weights(model: nn.Module) -> List[str]:
    """Quantize a model's projection weights to int8 in place (what the
    engine does under ``weight_only_int8``), and return the names of the
    parameters quantized, in module order.

    Every module whose leaf name is in :data:`WEIGHT_ONLY_LEAVES` and that
    owns a floating 2-D ``weight`` gets that parameter's data replaced by
    the int8 array (the same ``nn.Parameter``, now ``requires_grad=False``,
    so ``state_dict`` keys are unchanged) and an fp32 ``weight_scale`` buffer
    beside it, which ``Linear.forward`` dispatches on. A parameter that a
    module outside the leaf set also owns (a tied embedding) is left as it
    is: the other owner needs it in full precision. Idempotent: a second
    call finds nothing left and returns ``[]``."""
    # owners from every module's own parameters, shared modules included
    owners: Dict[int, set] = {}
    for name, module in model.named_modules(remove_duplicate=False):
        leaf = name.rsplit(".", 1)[-1]
        for p in module._parameters.values():
            if p is not None:
                owners.setdefault(id(p), set()).add(leaf)
    scales: Dict[int, torch.Tensor] = {}
    quantized: List[str] = []
    with torch.no_grad():
        for name, module in model.named_modules():
            if name.rsplit(".", 1)[-1] not in WEIGHT_ONLY_LEAVES:
                continue
            w = module._parameters.get("weight")
            if w is None or getattr(module, "weight_scale", None) is not None:
                continue
            if id(w) not in scales:
                if w.dim() != 2 or not w.is_floating_point():
                    continue
                if any(o not in WEIGHT_ONLY_LEAVES for o in owners[id(w)]):
                    continue
                w8, scales[id(w)] = quantize_weight_int8(w)
                w.requires_grad_(False)
                w.data = w8
                quantized.append(f"{name}.weight")
            module.register_buffer("weight_scale", scales[id(w)])
    return quantized


def int8_weight_matmul_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel 20's plain version, the JAX package's composition: the fp32
    product of ``x`` and the int8 values, one multiply by the scale row,
    cast to x's dtype. ``x [..., K]``, ``w8 [K, N]``, ``scale [N]``."""
    k, n = w8.shape
    out = (x.reshape(-1, k).float() @ w8.float()) * scale.float()[None, :]
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def wo_route(dtype: torch.dtype, m: int, k: int, n: int) -> str:
    """Which instance of kernel 20 takes ``[m, k] x [k, n]`` with
    activations of ``dtype``: ``"wgmma"`` (tensor cores, the int8 weight
    widened in registers) for bf16 and fp16 when the TMA maps can address
    the operands (x's rows ``2 k`` bytes and W's ``n`` bytes, multiples of 16:
    ``k % 8 == 0`` and ``n % 16 == 0``; ``k > 0``), else ``"mma_sync"``
    (tensor cores through registers, any shape and row alignment: bf16 /
    fp16 on m16n8k16 with the weight widened to x's type, fp32 on TF32
    m16n8k8 in two passes of x split into hi + lo). ``m`` does not change
    the route, only the instances' tiles (:func:`wo_plan` for wgmma)."""
    del m
    if dtype in (torch.bfloat16, torch.float16) and k > 0 and k % 8 == 0 and n % 16 == 0:
        return "wgmma"
    return "mma_sync"


_COST_256, _COST_128 = 8, 5  # a 128-row tile takes ~0.63 of a 256-row one on the card


def plan_makespan(big: int, items: int, grid: int) -> int:
    """The longest persistent CTA's cost when items ``[0, big)`` cost a
    256-row tile's and the rest a 128-row (or half) tile's, CTA ``b`` taking
    items ``b, b + grid, ...`` (``hp::plan_makespan``: the tile plans of
    kernel 20 and of the loss head's backward weigh a split by it)."""
    worst = 0
    for b in range(min(grid, items)):
        nb = (big - 1 - b) // grid + 1 if b < big else 0
        total = (items - 1 - b) // grid + 1
        worst = max(worst, nb * _COST_256 + (total - nb) * _COST_128)
    return worst


def _uniform_plan(m: int, n: int, bm: int, sms: int) -> Dict[str, int]:
    blocks, nt = -(-m // bm), -(-n // 128)
    return dict(bm=bm, blocks=blocks, nt=nt, big=blocks * nt, items=blocks * nt, grid=min(blocks * nt, sms))


def wo_plan(m: int, n: int, sms: int) -> Dict[str, int]:
    """The work items of kernel 20's wgmma instance for ``[m, k] x [k, n]``
    on ``sms`` SMs (``make_plan`` in ``csrc/wo_matmul.cu``): output tiles
    of 128 weight columns by ``bm`` x rows (the wgmma N): 8 at decode
    sizes, 64 up to 64 rows, else 256, with the 256-row tiles past the last
    full round over the SMs split into 128-row ones where that shortens the
    longest CTA's work, and an odd last 128-row block's tiles of 128 rows;
    ``big`` items of ``bm`` rows, ``items - big`` of 128, ``grid``
    persistent CTAs.
    A plan left with no 256-row tile is the 128-row instance's."""
    if m <= 8:
        return _uniform_plan(m, n, 8, sms)
    if m <= 64:
        return _uniform_plan(m, n, 64, sms)
    halves, nt = -(-m // 128), -(-n // 128)
    blocks = halves // 2
    whole, odd = blocks * nt, (halves % 2) * nt
    grid_all = min(whole + odd, sms)
    keep = whole - whole % sms
    items_split = keep + 2 * (whole - keep) + odd
    grid_split = min(items_split, sms)
    if keep < whole and plan_makespan(keep, items_split, grid_split) < plan_makespan(whole, whole + odd,
                                                                                     grid_all):
        plan = dict(bm=256, blocks=blocks, nt=nt, big=keep, items=items_split, grid=grid_split)
    else:
        plan = dict(bm=256, blocks=blocks, nt=nt, big=whole, items=whole + odd, grid=grid_all)
    return plan if plan["big"] else _uniform_plan(m, n, 128, sms)


def int8_weight_matmul(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w8) * scale`` without the dequantized weight: ``x [..., K]``
    (bf16, fp16 or fp32), ``w8 [K, N]`` int8, ``scale [N]`` fp32; returns
    ``[..., N]`` in x's dtype. One launch of kernel 20, counted as
    ``wo_matmul``, on the instance :func:`wo_route` names."""
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, w8, scale)
    what = "int8_weight_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes bf16, fp16 or fp32 activations, not {x.dtype}")
    if w8.dim() != 2 or scale.shape != (w8.shape[1],) or x.shape[-1] != w8.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)}, weight {tuple(w8.shape)} and scale {tuple(scale.shape)} "
                         "do not fit [..., K] x [K, N] with [N] scales")
    k, n = w8.shape
    dev = x.device
    x2 = _kernel_operand(x.reshape(-1, k), "x", what, x.dtype, dev)
    w8 = _kernel_operand(w8, "weight", what, torch.int8, dev)
    scale = _kernel_operand(scale, "scale", what, torch.float32, dev)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m and n:
        route = wo_route(x.dtype, m, k, n)
        fn = build.kernel_fn("ptt_wo_matmul", [_I, _I] + [_P] * 4 + [_I] * 3 + [_P])
        with torch.cuda.device(dev):
            err = fn(_KERNEL_DTYPES[x.dtype], _ROUTES[route], x2.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), m, k, n, torch.cuda.current_stream().cuda_stream)
        build.check(err, f"wo_matmul ({route})")
        count_launch("wo_matmul")
    return out.reshape(*x.shape[:-1], n)
