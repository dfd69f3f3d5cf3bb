"""GPT-3-style decoder LM (port of ``paddle_tpu/models/gpt.py``; BASELINE
config #4, GPT-3 13B): learned position embeddings, pre-LN blocks, an
exact-erf GELU MLP (4x), causal attention, biases on every projection, and
an lm head tied to the word embedding.

- Attention: one fused qkv projection, reshaped to ``[B, S, 3, heads, D]``;
  its strided q/k/v slices go to ``F.flash_attention(causal=True)``, the
  flash-attention kernels 14-16 at head dims 64 and 128 (the wrappers make
  the slices contiguous; autograd carries the gradients back through them).
- ``FLAGS_use_fused_decode_layer`` on (the JAX default): each block's
  residual add and ``ln_2`` are one ``fused_layer_norm_residual`` call,
  kernel 12 forward and kernel 13 backward where the JAX rule allows (the
  weight in the input's dtype, ``H % 128 == 0``). ``ln_1`` and ``ln_f`` are
  the JAX composition, statistics in the I/O dtype.
- ``FLAGS_use_fused_loss`` on (the JAX default): with labels the model
  returns ``(loss, None)`` from the fused loss head, kernels 17-19 in the
  vocab-major layout (the tied ``[V, H]`` table); with the flag off
  ``(loss, logits)``. Without labels the logits ``h @ W^T``.

Module and parameter names follow the JAX package, so its ``state_dict``
loads by name (``models/convert.py``). ``gpt_shard_fn`` and
``build_gpt_pipeline`` are not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from paddle_tpu_torch.core.device import DeviceLike, resolve_device
from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.incubate.nn.functional import fused_layer_norm_residual
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.optimizer.optimizer import name_parameters

__all__ = [
    "GPTAttention",
    "GPTBlock",
    "GPTConfig",
    "GPTEmbeddings",
    "GPTForPretraining",
    "GPTMLP",
    "GPTModel",
]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 5120
    num_layers: int = 40
    num_heads: int = 40
    max_position: int = 2048
    ffn_ratio: int = 4
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5

    @staticmethod
    def gpt3_13b() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def tiny(vocab: int = 128) -> "GPTConfig":
        return GPTConfig(
            vocab_size=vocab, hidden_size=64, num_layers=2, num_heads=4, max_position=128
        )


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size, device, dtype)
        self.position_embeddings = Embedding(config.max_position, config.hidden_size, device, dtype)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], dtype=torch.int32, device=input_ids.device)[None]
        h = self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
        return self.dropout(h)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        h = config.hidden_size
        self.qkv_proj = Linear(h, 3 * h, device=device, dtype=dtype)
        self.out_proj = Linear(h, h, device=device, dtype=dtype)
        self.dropout = config.dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, _ = F.flash_attention(q, k, v, dropout=self.dropout, causal=True, training=self.training)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        h = config.hidden_size
        self.fc1 = Linear(h, config.ffn_ratio * h, device=device, dtype=dtype)
        self.fc2 = Linear(config.ffn_ratio * h, h, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class GPTBlock(nn.Module):
    """Pre-LN decoder block."""

    def __init__(self, config: GPTConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.attn = GPTAttention(config, device, dtype)
        self.ln_2 = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.mlp = GPTMLP(config, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if flag("use_fused_decode_layer"):
            # the residual add and ln_2 in one call; both outputs reach the
            # loss (h2 through the MLP, x2 along the residual stream)
            attn_out = self.attn(self.ln_1(x))
            h2, x2 = fused_layer_norm_residual(attn_out, self.ln_2.weight, self.ln_2.bias, x, self.ln_2.epsilon)
            return x2 + self.mlp(h2)
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, device, dtype)
        self.layers = nn.ModuleList([GPTBlock(config, device, dtype) for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon, device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            h = layer(h)
        return self.ln_f(h)


class GPTForPretraining(nn.Module):
    """GPT with the lm head tied to the word embedding.

    ``device`` defaults to ``cuda`` (and raises without one); ``dtype``
    defaults to fp32, the JAX package's default. The weights are drawn from
    ``torch.Generator(device).manual_seed(seed)``: N(0, 0.02) matrices and
    embeddings, LayerNorm weights 1, every bias 0."""

    def __init__(
        self,
        config: GPTConfig,
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, dev, dtype or torch.float32)
        self.reset_parameters(seed)
        name_parameters(self)

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.word_embeddings.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.embeddings.word_embeddings.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, (Linear, Embedding)):
                module.reset_parameters(gen)
            elif isinstance(module, LayerNorm):
                module.reset_parameters()

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
    ) -> Any:
        """``input_ids [B, S]``. Without ``labels``: the ``[B, S, V]``
        logits. With ``labels`` (``-100`` is ignored): ``(loss, None)`` with
        the mean cross entropy in fp32 from the fused loss head while
        ``FLAGS_use_fused_loss`` is on (the logits never exist), else
        ``(loss, logits)``."""
        h = self.gpt(input_ids, position_ids)
        w = self.gpt.embeddings.word_embeddings.weight
        if labels is not None:
            if flag("use_fused_loss"):
                loss = F.fused_linear_cross_entropy(h, w, labels, ignore_index=-100, reduction="mean",
                                                    weight_vocab_major=True)
                return loss, None
            logits = torch.matmul(h, w.t())
            return F.cross_entropy(logits, labels, ignore_index=-100, reduction="mean"), logits
        return torch.matmul(h, w.t())
