"""Per-kernel launch counters.

Each kernel wrapper adds one to its counter where it launches its CUDA
kernel, and nowhere else: a plain-version call on a CPU tensor does not
count. A run reads the counters to show that its main paths went through
the kernels (``chip_smoke.py`` resets them just before driving each path —
the engine, the unfused engine, ``generate_paged``, the train steps, the
residual-norm backward, the int8 engines and the int8 evaluation loss — and
reads them just after). There is no fallback
counter: on a CUDA tensor a wrapper launches its kernel or raises.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["KERNELS", "LAYOUT_PASSES", "count_launch", "launch_counts", "reset_launch_counts"]

# kernel name -> the TPU kernel it replaces (file:line of the Pallas body)
KERNELS: Dict[str, str] = {
    "paged_chunk_fused": "paddle_tpu/kernels/paged_attention.py:656",
    "paged_chunk": "paddle_tpu/kernels/paged_attention.py:246",
    "paged_decode": "paddle_tpu/kernels/paged_attention.py:54",
    "paged_decode_fused": "paddle_tpu/kernels/paged_attention.py:472",
    "embed_rms": "paddle_tpu/kernels/fused.py:618",
    "rms_residual": "paddle_tpu/kernels/fused.py:338",
    "rms_norm_fwd": "paddle_tpu/kernels/fused.py:74",
    "rms_norm_bwd": "paddle_tpu/kernels/fused.py:83",
    "rope_fwd": "paddle_tpu/kernels/fused.py:204",
    "rope_bwd": "paddle_tpu/kernels/fused.py:215",
    # kernels 11-13: the residual norms' adjoints and the residual LayerNorm;
    # each backward is two launches per call (row pass, column sum)
    "rms_residual_bwd": "paddle_tpu/kernels/fused.py:351",
    "ln_residual": "paddle_tpu/kernels/fused.py:372",
    "ln_residual_bwd": "paddle_tpu/kernels/fused.py:383",
    "flash_fwd": "paddle_tpu/kernels/flash_attention.py:87",
    # the same body above head dim 256 in bf16 / fp16: csrc/flash_fwd_wide.cu
    "flash_fwd_wide": "paddle_tpu/kernels/flash_attention.py:87",
    "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:201",
    "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:244",
    # the same bodies above head dim 256 in bf16 / fp16: csrc/flash_bwd_wide.cu
    "flash_bwd_dq_wide": "paddle_tpu/kernels/flash_attention.py:201",
    "flash_bwd_dkv_wide": "paddle_tpu/kernels/flash_attention.py:244",
    # kernel 17: two launches per call (the logits tiles' partials, their merge)
    "flxent_fwd": "paddle_tpu/kernels/fused_loss.py:261",
    # the recompute of D that kernels 18 and 19 share, one launch per vocab chunk
    "flxent_dchunk": "paddle_tpu/kernels/fused_loss.py:302",
    "flxent_dx": "paddle_tpu/kernels/fused_loss.py:322",
    "flxent_dw": "paddle_tpu/kernels/fused_loss.py:343",
    # the fp32 loss head's 3xTF32 instance (csrc/flxent_tf32.cu) splits its
    # operands first into K-major hi / lo planes: x once a forward and once a
    # backward, W's sub-chunks once each; kernel 17's partials and the D
    # recompute are the first products to read them
    "flxent_split": "paddle_tpu/kernels/fused_loss.py:302",
    # the int8 serving path. Kernel 20, the weight-only int8 matmul:
    "wo_matmul": "paddle_tpu/kernels/quant.py:107",
    # kernels A, 4, 5, 6 over the int8 KV pool: each Pallas body with its
    # `_dequant_tile` (paged_attention.py:39) in the block walk
    "paged_chunk_fused_int8": "paddle_tpu/kernels/paged_attention.py:656",
    "paged_chunk_int8": "paddle_tpu/kernels/paged_attention.py:246",
    "paged_decode_int8": "paddle_tpu/kernels/paged_attention.py:54",
    "paged_decode_fused_int8": "paddle_tpu/kernels/paged_attention.py:472",
    # kernel 17's int8 site (`_make_pallas_quant_fwd`, the weight-only int8
    # lm head's forward-only loss): two launches per call, as flxent_fwd
    "flxent_fwd_int8": "paddle_tpu/kernels/fused_loss.py:464",
    # its fp32 instance on the TF32 tensor cores (csrc/flxent_tf32.cu,
    # two passes) widens each sub-chunk of the int8 W first into one K-major
    # fp32 plane
    "flxent_widen": "paddle_tpu/kernels/fused_loss.py:464",
}

# the passes above that only lay out another kernel's operands: no Pallas
# body is theirs, and each is listed under the body whose operands it lays
# out (not a second port of it)
LAYOUT_PASSES: Dict[str, str] = {
    "flxent_split": "layout pass, no TPU body: the fp32 TF32 instances' hi / lo operand planes",
    "flxent_widen": "layout pass, no TPU body: the int8 W widened into the 2xTF32 instance's fp32 plane",
}

_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    with _lock:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0
