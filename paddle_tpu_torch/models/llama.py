"""Llama-2 (port of ``paddle_tpu/models/llama.py``): the training forward,
the dense prefill, and the paged serving and decode steps (the engine's
fused decode-layer loop and the layer modules).

- Training: ``LlamaForCausalLM(input_ids, labels=..., startend_row_indices=...)``
  runs the layer modules — RMSNorm and rope through their kernels (7-10,
  ``FLAGS_use_pallas_fused`` on; widths outside the kernels' reach take the
  unfused compositions, as in JAX), attention through the flash-attention
  kernels with the FlashMask bounds, per-layer
  recompute when ``config.recompute`` and the model is in train mode — and
  returns ``(loss, None)`` from the fused loss head (kernels 17-19,
  ``FLAGS_use_fused_loss`` on, the JAX default), or ``(loss, logits)`` with
  the flag off.
- Prefill: ``LlamaForCausalLM(input_ids, use_cache=True)`` runs the layer
  modules and returns ``(logits, caches)``, one ``(k, v)`` pair of
  ``[B, S, HKV, D]`` per layer, keys roped (``generate_paged``'s prefill).
- Paged serving and decode: ``LlamaForCausalLM(input_ids,
  past_key_values=..., use_cache=True, cache_position=lens)`` (the JAX
  engine's and ``generate_paged``'s call) runs one step over the paged KV
  pools and returns ``(logits, past_key_values)``. With the engine's
  6-tuple pasts and ``FLAGS_use_fused_decode_layer`` on (the JAX default)
  it is the fused decode layer loop (kernels A, B, C); otherwise the layer
  modules, where attention is kernel 4 (with ``q_lens``) or kernel 5 (the
  4- and 5-tuple pasts of ``generate_paged``). The engine's int8 pool
  passes 8-tuples (the two scale planes appended) down the same paths.
  ``generate_paged`` itself is in ``generation.py``.
- Weight-only int8: ``kernels.quant.quantize_module_weights(model)`` (the
  engine's ``weight_only_int8``) quantizes the MLP projections and the lm
  head in place; their ``Linear`` then runs kernel 20, and the loss head
  with labels kernel 17's int8 site.

Module and parameter names follow the JAX package, so its ``state_dict``
loads by name (``models/convert.py``); linear weights keep Paddle's
``[in, out]`` layout. Parameters are made on the model's device, in its
dtype, from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.device import DeviceLike, resolve_device
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.generation import GenerationMixin
from paddle_tpu_torch.incubate.nn.functional import (
    block_multihead_attention,
    block_multihead_chunk_attention,
    block_multihead_chunk_attention_fused,
    fused_embed_rms_norm,
    fused_rms_norm_residual,
    fused_rotary_position_embedding,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import linear_forward
from paddle_tpu_torch.optimizer.optimizer import name_parameters

__all__ = [
    "LlamaAttention",
    "LlamaConfig",
    "LlamaDecoderLayer",
    "LlamaForCausalLM",
    "LlamaMLP",
    "LlamaModel",
    "LlamaRotaryEmbedding",
]

INITIALIZER_RANGE = 0.02  # std of the seeded random weights (Llama's init range)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False  # True: no lm_head, the logits are h @ embed_tokens.weight^T
    # kept for the reference's configs, which declare it and read it nowhere: attention is the flash
    # kernels whatever its value, as FLAGS_use_pallas_attention alone chooses it there
    use_flash_attention: bool = True
    recompute: bool = False  # per-decoder-layer activation checkpointing (train mode)
    dtype: str = "bfloat16"

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab: int = 256) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128,
        )


def _param(shape: Tuple[int, ...], device: torch.device, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """Bias-free projection with Paddle's ``[in, out]`` weight; weight-only
    int8 (kernel 20) once ``quantize_module_weights`` gave it a
    ``weight_scale``."""

    def __init__(self, in_features: int, out_features: int, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = _param((in_features, out_features), device, dtype)
        self.register_buffer("weight_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_forward(self, x)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = _param((num, dim), device, dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.embedding(ids.long(), self.weight)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, epsilon: float, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = _param((dim,), device, dtype)
        self.epsilon = float(epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)


class LlamaRotaryEmbedding(nn.Module):
    """Neox rope tables ``[max_position, D]`` in fp32, computed with the JAX
    package's numpy expressions (so both hold the same values)."""

    def __init__(self, head_dim: int, max_position: int, theta: float, device: torch.device) -> None:
        super().__init__()
        inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
        t = np.arange(max_position, dtype=np.float32)
        emb = np.concatenate([np.outer(t, inv)] * 2, axis=-1)
        self.register_buffer("cos_cached", torch.from_numpy(np.cos(emb)).to(device), persistent=False)
        self.register_buffer("sin_cached", torch.from_numpy(np.sin(emb)).to(device), persistent=False)

    def forward(self, seq_len: int, offset: Any = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """With an int ``offset``: the table rows ``offset .. offset +
        seq_len - 1`` as ``[s, D]`` (the training forward). With a ``[B]``
        tensor: rows for positions ``offset[b] + 0..seq_len-1`` as
        ``[B, s, 1, D]``, an exact per-position gather; positions past the
        table clip to its last row (those rows are masked or beyond
        ``max_position`` anyway)."""
        if not isinstance(offset, torch.Tensor):
            return self.cos_cached[offset: offset + seq_len], self.sin_cached[offset: offset + seq_len]
        pos = offset.long()[:, None] + torch.arange(seq_len, device=offset.device)[None, :]
        pos = pos.clamp(0, self.cos_cached.shape[0] - 1)
        return self.cos_cached[pos][:, :, None, :], self.sin_cached[pos][:, :, None, :]


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.q_proj = Linear(h, self.num_heads * self.head_dim, device, dtype)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, device, dtype)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, device, dtype)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, device, dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,  # normed [B, S, H]
        startend_row_indices: Optional[torch.Tensor],  # FlashMask bounds [B, Hm, S, C] or None
        cos: torch.Tensor,  # [S, D] rope rows of positions 0..S-1, or [B, S, 1, D] per slot
        sin: torch.Tensor,
        past_key_value: Optional[Sequence[Any]] = None,  # a paged 4-, 5-, 6- or 8-tuple
        use_cache: bool = False,
    ) -> Any:
        """qkv projections, rope on q and k, attention, ``o_proj``. Without
        a past: causal FlashMask attention (kernels 14-16), and with
        ``use_cache`` also the ``(k, v)`` cache (keys roped). With a paged
        past ``(key_cache, value_cache, block_tables, seq_lens[, slot_mask[,
        q_lens[, key_scale, value_scale]]])``: append this step's KV to the
        pools in place, then attend over them — the chunk entry (kernel 4)
        when ``q_lens`` is given, else the decode entry (kernel 5); the
        8-tuple's scale planes make it the int8 pool. Returns ``(out,
        past)``. The rope rows come from the model (one table; every JAX
        layer holds an identical copy)."""
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k, _ = fused_rotary_position_embedding(q, k, None, sin=sin, cos=cos)
        if past_key_value is not None:
            kc, vc, tables, lens = past_key_value[:4]
            slot_mask = past_key_value[4] if len(past_key_value) >= 5 else None
            if len(past_key_value) >= 6:
                ks, vs = past_key_value[6:8] if len(past_key_value) == 8 else (None, None)
                out = block_multihead_chunk_attention(
                    q, k, v, kc, vc, tables, lens, past_key_value[5], slot_mask=slot_mask,
                    key_scale=ks, value_scale=vs)[0]
            else:
                out = block_multihead_attention(q, k, v, kc, vc, tables, lens, slot_mask=slot_mask)[0]
            return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim)), past_key_value
        out = F.flashmask_attention(q, k, v, startend_row_indices=startend_row_indices, causal=True)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return (out, (k, v)) if use_cache else out

    def forward_paged_fused(
        self,
        hidden_states: torch.Tensor,  # pre-normed [B, s, H]
        past_key_value: Sequence[Any],  # (kc, vc, tables, lens, slot_mask, q_lens[, ks, vs])
        cos: torch.Tensor,  # [B, s, 1, D], gathered once per step
        sin: torch.Tensor,
    ) -> torch.Tensor:
        """qkv projections, the rope-fused paged attention (k roped and
        appended in place — quantized after the rope into the int8 pool of
        an 8-tuple — q roped inside kernel A), then ``o_proj``."""
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden_states).reshape(b, s, self.num_kv_heads, self.head_dim)
        kc, vc, tables, lens, slot_mask, q_lens = past_key_value[:6]
        ks, vs = past_key_value[6:8] if len(past_key_value) == 8 else (None, None)
        out = block_multihead_chunk_attention_fused(
            q, k, v, cos, sin, kc, vc, tables, lens, q_lens, slot_mask=slot_mask, key_scale=ks, value_scale=vs
        )[0]
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, device, dtype)
        self.up_proj = Linear(h, i, device, dtype)
        self.down_proj = Linear(i, h, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    """One layer. :meth:`forward` is the training, prefill and unfused paged
    layer; the fused serving step runs in
    :meth:`LlamaModel._forward_paged_fused`, which pairs each residual add
    with the norm that follows it."""

    def __init__(self, config: LlamaConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        eps = config.rms_norm_eps
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,
        startend_row_indices: Optional[torch.Tensor],
        cos: torch.Tensor,
        sin: torch.Tensor,
        past_key_value: Optional[Sequence[Any]] = None,
        use_cache: bool = False,
    ) -> Any:
        """``h`` — or ``(h, cache)`` with a paged past or ``use_cache``."""
        residual = hidden_states
        h = self.self_attn(self.input_layernorm(hidden_states), startend_row_indices, cos, sin,
                           past_key_value, use_cache)
        cache = None
        if past_key_value is not None or use_cache:
            h, cache = h
        h = residual + h
        h = h + self.mlp(self.post_attention_layernorm(h))
        return h if cache is None else (h, cache)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device: torch.device, dtype: torch.dtype) -> None:
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size, device, dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype) for _ in range(config.num_hidden_layers)]
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device, dtype)
        # one table for the model: every JAX layer holds an identical copy
        self.rotary_emb = LlamaRotaryEmbedding(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta, device,
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        startend_row_indices: Optional[torch.Tensor] = None,
        past_key_values: Optional[Sequence[Sequence[Any]]] = None,
        use_cache: bool = False,
        cache_position: Optional[torch.Tensor] = None,
    ) -> Any:
        """The final-normed hidden states ``[B, S, H]``; with ``use_cache``
        ``(h, caches)``. Given paged ``past_key_values`` (one tuple per
        layer, in the reference call ``use_cache=True,
        cache_position=lens``; the pools are updated in place, so the pasts
        returned are the tensors passed in), the dispatch is JAX's: the
        fused decode layer loop only while ``FLAGS_use_fused_decode_layer``
        is on and every past is the engine's 6-tuple, else the layer
        modules. An 8-tuple past (the engine's int8 pool) adds the scale
        planes and takes the same paths."""
        if past_key_values is None:
            if cache_position is not None:
                raise NotImplementedError(
                    "cache_position without a paged past (static-cache decode) is not ported yet "
                    "(ROADMAP Queue 1 item 3)")
        else:
            if startend_row_indices is not None:
                raise ValueError("startend_row_indices does not apply to the paged serving step")
            if not use_cache or cache_position is None:
                raise NotImplementedError(
                    "the paged step is ported for the reference call only: "
                    "past_key_values=<paged tuples>, use_cache=True, cache_position=seq_lens")
            if len(past_key_values) != len(self.layers):
                raise ValueError(f"{len(past_key_values)} layer pasts for {len(self.layers)} layers")
            sizes = {len(p) if p is not None else 0 for p in past_key_values}
            if not sizes <= {4, 5, 6, 8}:
                raise NotImplementedError("only paged pasts (4-, 5-, 6- and 8-tuples) are ported; a dense past "
                                          "(static-cache decode) is ROADMAP Queue 1 item 3")
            if flag("use_fused_decode_layer") and sizes <= {6, 8}:
                return self._forward_paged_fused(input_ids, past_key_values), past_key_values
        h = self.embed_tokens(input_ids)
        if past_key_values is None:
            cos, sin = self.rotary_emb(input_ids.shape[1])
        else:  # ragged positions: rows gathered per slot, shared by every layer
            cos, sin = self.rotary_emb(input_ids.shape[1], past_key_values[0][3])
        use_recompute = self.config.recompute and self.training and not use_cache and past_key_values is None
        caches = [] if use_cache else None
        for i, layer in enumerate(self.layers):
            if use_recompute:
                h = recompute(layer, h, startend_row_indices, cos, sin)
                continue
            past = past_key_values[i] if past_key_values is not None else None
            h = layer(h, startend_row_indices, cos, sin, past, use_cache)
            if use_cache:
                h, cache = h
                caches.append(cache)
        h = self.norm(h)
        return (h, caches) if use_cache else h

    def _forward_paged_fused(self, input_ids: torch.Tensor, past_key_values: Sequence[Sequence[Any]]) -> torch.Tensor:
        """The serving step's fused layer loop: the token gather + embedding +
        layer 0's input norm is kernel B; the rope rows are gathered once per
        step; per layer the rope-fused paged attention (kernel A), then
        residual + post-attention norm (kernel C), the MLP, and residual + the
        NEXT layer's input norm (kernel C) — the last layer pairs with the
        final norm, so the loop returns ``h`` already normed."""
        layers = list(self.layers)
        first = layers[0].input_layernorm
        residual, h = fused_embed_rms_norm(input_ids, self.embed_tokens.weight, first.weight, first.epsilon)
        cos, sin = self.rotary_emb(input_ids.shape[1], past_key_values[0][3])
        for i, layer in enumerate(layers):
            attn_out = layer.self_attn.forward_paged_fused(h, past_key_values[i], cos, sin)
            post = layer.post_attention_layernorm
            h, residual = fused_rms_norm_residual(attn_out, post.weight, residual, post.epsilon)
            mlp_out = layer.mlp(h)
            nxt = layers[i + 1].input_layernorm if i + 1 < len(layers) else self.norm
            h, residual = fused_rms_norm_residual(mlp_out, nxt.weight, residual, nxt.epsilon)
        return h


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """Causal LM. With ``labels`` ``forward`` returns ``(loss, None)``
    (``(loss, logits)`` with ``FLAGS_use_fused_loss`` off); without,
    ``[B, S, V]`` logits, and with ``use_cache`` ``(logits, caches)`` — of
    one paged step (appending the step's KV to the caches in place) when
    ``past_key_values`` is given. ``generate_paged`` (the mixin) decodes
    greedily over the paged cache.

    ``device`` defaults to ``cuda`` (and raises without one); ``dtype``
    defaults to ``config.dtype``. The weights are drawn from
    ``torch.Generator(device).manual_seed(seed)``: N(0, 0.02) matrices, unit
    norm weights. With ``config.tie_word_embeddings`` there is no
    ``lm_head``: the logits are ``h @ embed_tokens.weight^T`` and the fused
    loss takes the embedding vocab-major, as in the JAX package. Each
    parameter carries its structured name as ``paddle_name`` (the
    optimizers' state keys). The model starts in train mode, as a Paddle
    layer does (train mode only turns on ``config.recompute``)."""

    def __init__(
        self,
        config: LlamaConfig,
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
        seed: int = 0,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, config.dtype)
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        self.lm_head = None if config.tie_word_embeddings else Linear(config.hidden_size, config.vocab_size, dev, dtype)
        self.reset_parameters(seed)
        name_parameters(self)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the embedding's, which weight-only int8 never
        quantizes (the projections it does quantize become int8)."""
        return self.llama.embed_tokens.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """N(0, 0.02) matrices and unit norm weights from ``seed``; refused
        once the projections are quantized to int8."""
        int8 = [name for name, p in self.named_parameters() if not p.is_floating_point()]
        if int8:
            raise RuntimeError(f"reset_parameters: {len(int8)} weights are quantized to int8 ({int8[0]}, ...); "
                               "draw the weights before quantize_module_weights")
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, INITIALIZER_RANGE, generator=gen)

    def forward(
        self,
        input_ids: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        startend_row_indices: Optional[torch.Tensor] = None,
        past_key_values: Optional[Sequence[Sequence[Any]]] = None,
        use_cache: bool = False,
        cache_position: Optional[torch.Tensor] = None,
    ) -> Any:
        """``input_ids [B, S]``. Training: ``labels [B, S]`` (``-100`` is
        ignored) and optionally the FlashMask ``startend_row_indices
        [B, Hm, S, C]`` int32; returns ``(loss, None)`` with the mean cross
        entropy in fp32 from the fused loss head (kernels 17-19) while
        ``FLAGS_use_fused_loss`` is on (the default: the ``[B, S, V]``
        logits never exist), ``(loss, logits)`` with it off. Serving:
        ``past_key_values`` one ``(key_cache, value_cache, block_tables,
        seq_lens, slot_mask, q_lens)`` per layer (the JAX engine's paged
        6-tuple; ``generate_paged`` passes the first four) with
        ``use_cache=True, cache_position=seq_lens`` (the JAX engine's call);
        returns ``(logits, past_key_values)``. Without ``past_key_values``,
        ``labels=None`` returns the logits, and ``(logits, caches)`` with
        ``use_cache``."""
        out = self.llama(input_ids, startend_row_indices, past_key_values, use_cache, cache_position)
        caches = None
        if use_cache:
            out, caches = out
        if labels is not None and flag("use_fused_loss"):
            if self.lm_head is None:  # tied: the embedding, vocab-major, as the head
                loss = F.fused_linear_cross_entropy(out, self.llama.embed_tokens.weight, labels, ignore_index=-100,
                                                    reduction="mean", weight_vocab_major=True)
            else:  # a weight-only int8 head takes kernel 17's int8 site (forward only)
                loss = F.fused_linear_cross_entropy(out, self.lm_head.weight, labels, ignore_index=-100,
                                                    reduction="mean", weight_scale=self.lm_head.weight_scale)
            return loss, None
        if self.lm_head is None:
            logits = torch.matmul(out, self.llama.embed_tokens.weight.t())
        else:
            logits = self.lm_head(out)
        if labels is not None:
            # cross_entropy upcasts bf16 logits to fp32 itself
            return F.cross_entropy(logits, labels, ignore_index=-100, reduction="mean"), logits
        if use_cache:
            return logits, caches
        return logits
