"""Greedy decode over the paged KV cache (port of ``paddle_tpu/generation.py``
``GenerationMixin.generate_paged``).

One static batch runs to completion: the prompts are prefilled by one dense
forward (``use_cache=True``), each layer's K/V is poured into its paged pools
(``block_cache_prefill``), then every decode step is one model call with
the 4-tuple paged pasts ``(key_cache, value_cache, block_tables, seq_lens)``
— the layer modules with kernel 5 as attention. The block allocator and the
tables are host state; lengths, tokens and the ``done`` mask stay on the
device, so the loop reads nothing back until the end (a table is copied up
only when a sequence crosses into a new block). That holds for head dims
that are a multiple of 64: any other head dim takes the dense-gather
composition, which reads the longest length back once per layer and step
to size its gather. The JAX package jits one
program per geometry; eager PyTorch needs no step cache.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = ["GenerationMixin"]


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the device: from
    pinned memory, asynchronously, on the current stream."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class GenerationMixin:
    """Adds :meth:`generate_paged` to a causal LM whose ``forward`` takes the
    dense prefill call ``(ids, use_cache=True) -> (logits, [(k, v), ...])``
    and the paged call ``(ids, past_key_values=..., use_cache=True,
    cache_position=lens) -> (logits, pasts)``, and which has ``config``,
    ``device`` and ``dtype``."""

    @torch.inference_mode()
    def generate_paged(
        self,
        input_ids: Any,
        max_new_tokens: int = 32,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        pad_token_id: Optional[int] = None,
    ) -> torch.Tensor:
        """Greedy decode; returns ``[B, prompt + max_new_tokens]`` int32 ids
        on the model's device, prompt included. After ``eos_token_id`` a
        sequence is padded with ``pad_token_id`` (default: eos, else 0); a
        finished sequence keeps its slot and blocks until all are done, and
        every block returns to the allocator at the end."""
        from paddle_tpu_torch.incubate.nn.functional import BlockKVCache, block_cache_prefill

        dev = self.device
        if isinstance(input_ids, torch.Tensor):
            ids = input_ids.to(device=dev, dtype=torch.int32)
        else:
            ids = _upload(torch.as_tensor(np.asarray(input_ids, np.int32)), dev)
        b, prompt = ids.shape
        if max_new_tokens <= 0:
            return ids
        cfg = self.config
        kvh = cfg.num_key_value_heads
        hd = cfg.hidden_size // cfg.num_attention_heads
        max_len = prompt + max_new_tokens
        if getattr(cfg, "max_position_embeddings", None) and max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({prompt}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_position_embeddings ({cfg.max_position_embeddings})"
            )
        mbs = -(-max_len // block_size)
        if num_blocks is None:
            num_blocks = b * mbs
        mgr = BlockKVCache(num_blocks, block_size, max_blocks_per_seq=mbs)
        for i in range(b):
            mgr.allocate(i, prompt)
        host_tables = mgr.block_table(range(b))
        tables = _upload(host_tables, dev)
        lens = torch.full((b,), prompt, dtype=torch.int32, device=dev)
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0

        # prefill: one dense forward, then each layer's K/V into its pools
        logits, dense_caches = self(ids, use_cache=True)
        pools = []
        for k, v in dense_caches:
            kc = torch.zeros((num_blocks, kvh, block_size, hd), dtype=self.dtype, device=dev)
            vc = torch.zeros_like(kc)
            pools.append(block_cache_prefill(kc, vc, k, v, tables, lens))
        tok = logits[:, -1, :].float().argmax(dim=-1).to(torch.int32)
        done = tok == eos_token_id if eos_token_id is not None else torch.zeros((b,), dtype=torch.bool, device=dev)

        out_toks = [tok]
        for _ in range(max_new_tokens - 1):
            for i in range(b):
                mgr.allocate(i, 1)
            new_tables = mgr.block_table(range(b))
            if not torch.equal(new_tables, host_tables):
                host_tables, tables = new_tables, _upload(new_tables, dev)
            step_logits, _ = self(tok[:, None], past_key_values=[(kc, vc, tables, lens) for kc, vc in pools],
                                  use_cache=True, cache_position=lens)
            nxt = step_logits[:, -1, :].float().argmax(dim=-1).to(torch.int32)
            lens = lens + 1
            nxt = torch.where(done, torch.full_like(nxt, pad_token_id), nxt)
            if eos_token_id is not None:
                done = done | (nxt == eos_token_id)
            out_toks.append(nxt)
            tok = nxt
        for i in range(b):
            mgr.free(i)
        return torch.cat([ids] + [t[:, None] for t in out_toks], dim=1)
