"""Continuous-batching engine over a ragged paged KV pool (port of
``paddle_tpu/inference/engine.py``).

The host-side scheduler is the JAX engine's: requests queue FIFO, a request
is admitted into a free slot only when the pool's unreserved blocks cover
its worst-case private need (so a step can never run out of blocks), and
every step is one ``[max_slots, prefill_chunk]`` mixed ragged dispatch — a
decode slot contributes one row, a slot still prefilling up to
``prefill_chunk`` prompt tokens, an idle slot none. A finished request's
blocks return to the pool at once. Each step's per-row greedy argmax comes
back to the host, where tokens are emitted.

This slice serves without the prefix cache (so there are no copy-on-write
forks), speculative decoding, recovery, the KV host tier, tensor
parallelism or metrics; asking for the prefix cache raises. The device pools
are one ``[NB, HKV, BS, D]`` key and value tensor per layer, in the model's
dtype, updated in place by each step. The model follows
``FLAGS_use_fused_decode_layer`` at every step (the JAX engine reads it
once, when it traces its step), so an engine serves unfused while the
flag is off.

The JAX engine's int8 configuration is ported: ``kv_cache_dtype="int8"``
makes each layer's pool ``(kc, vc, ks, vs)`` — int8 K/V and fp32 per-token
scale planes ``[NB, HKV, BS]`` that start at ones, so an empty block
dequantizes to exact zeros — and the step passes 8-tuple pasts (the kernels'
``_int8`` instances: quantize on write, dequantize in the block walk);
``weight_only_int8=True`` quantizes the model's MLP projections and lm head
to int8 in place at construction (kernel 20 in every projection).
``pool_stats()["bytes_per_token"]`` counts the int8 pool's true footprint,
``2 L KVH (D + 4)``.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.incubate.nn.functional import BlockKVCache
from paddle_tpu_torch.kernels.quant import quantize_module_weights

__all__ = [
    "AdmissionPolicy",
    "ContinuousBatchingEngine",
    "EmptyPromptError",
    "FIFOAdmission",
    "InferenceRequest",
    "IntakeError",
    "InvalidTokenBudgetError",
    "PromptTooLongError",
    "RequestTooLongError",
    "RequestUnservableError",
]


class IntakeError(ValueError):
    """A request rejected at intake (validation), before any device work."""


class EmptyPromptError(IntakeError):
    """The prompt has zero tokens."""


class InvalidTokenBudgetError(IntakeError):
    """``max_new_tokens`` is not a positive integer."""


class PromptTooLongError(IntakeError):
    """The prompt does not fit the configured ``prompt_bucket`` intake cap."""


class RequestTooLongError(IntakeError):
    """prompt + ``max_new_tokens`` exceeds ``max_model_len``."""


class RequestUnservableError(IntakeError):
    """Worst-case KV demand exceeds the whole pool."""


class InferenceRequest:
    """One queued generation request and, after finishing, its result."""

    def __init__(self, req_id: int, prompt: np.ndarray, max_new_tokens: int,
                 eos_token_id: Optional[int]) -> None:
        self.req_id = req_id
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.generated: List[int] = []
        self.finish_reason: Optional[str] = None  # "stop" | "length"
        self.arrival_time = time.perf_counter()  # TTFT anchor
        self.admit_time: Optional[float] = None  # set at the first token

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


class AdmissionPolicy:
    """Admission order for the waiting queue: :meth:`select` returns the next
    request to admit (drawn from ``waiting`` and satisfying ``can_fit``) or
    None to admit nothing at this boundary."""

    def select(self, waiting: Sequence[InferenceRequest],
               can_fit: Callable[[InferenceRequest], bool]) -> Optional[InferenceRequest]:
        raise NotImplementedError


class FIFOAdmission(AdmissionPolicy):
    """Strict arrival order with no head-of-line skipping: a large request is
    never starved by smaller ones behind it."""

    def select(self, waiting: Sequence[InferenceRequest],
               can_fit: Callable[[InferenceRequest], bool]) -> Optional[InferenceRequest]:
        if waiting and can_fit(waiting[0]):
            return waiting[0]
        return None


class ContinuousBatchingEngine:
    """Host-side scheduler driving one unified prefill/decode step.

    ``max_slots`` bounds the live batch; ``num_blocks`` sizes the KV pool
    shared by all slots (default: ``max_slots`` full-length sequences);
    ``prompt_bucket`` caps prompt length at intake; ``prefill_chunk`` is the
    chunk width ``C`` of the ``[max_slots, C]`` step (default: one block).
    The pools live on the model's device, in its dtype — or int8 with scale
    planes under ``kv_cache_dtype="int8"``. ``kv_cache_dtype`` and
    ``weight_only_int8`` default to their flags (``FLAGS_kv_cache_dtype``,
    ``FLAGS_weight_only_int8``); ``weight_only_int8`` quantizes the model in
    place, as the JAX engine does."""

    def __init__(
        self,
        model: Any,
        max_slots: int = 4,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prompt_bucket: int = 32,
        max_model_len: Optional[int] = None,
        admission_policy: Optional[AdmissionPolicy] = None,
        prefill_chunk: Optional[int] = None,
        enable_prefix_cache: Optional[bool] = None,
        kv_cache_dtype: Optional[str] = None,
        weight_only_int8: Optional[bool] = None,
    ) -> None:
        cfg = model.config
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.prompt_bucket = int(prompt_bucket)
        self.prefill_chunk = int(prefill_chunk or self.block_size)
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        self.max_model_len = int(
            max_model_len or getattr(cfg, "max_position_embeddings", None) or self.prompt_bucket * 4
        )
        if self.prompt_bucket > self.max_model_len:
            raise ValueError(
                f"prompt_bucket ({self.prompt_bucket}) exceeds max_model_len ({self.max_model_len})"
            )
        self.max_blocks_per_seq = -(-self.max_model_len // self.block_size)
        self.num_blocks = int(
            num_blocks if num_blocks is not None else self.max_slots * self.max_blocks_per_seq
        )
        if enable_prefix_cache is None:
            enable_prefix_cache = flag("enable_prefix_cache")
        if enable_prefix_cache:
            raise NotImplementedError("paddle_tpu_torch has no prefix cache yet")
        kvd = str(flag("kv_cache_dtype") if kv_cache_dtype is None else kv_cache_dtype)
        if kvd not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {kvd!r}")
        self.kv_cache_dtype = kvd
        self._quant_kv = kvd == "int8"
        if weight_only_int8 is None:
            weight_only_int8 = flag("weight_only_int8")
        # the projections quantized in place (the JAX engine's _wq_params)
        self._wq_params: List[str] = quantize_module_weights(model) if weight_only_int8 else []

        self._kvh = cfg.num_key_value_heads
        self._hd = cfg.hidden_size // cfg.num_attention_heads
        self._num_layers = cfg.num_hidden_layers
        self._cache_dtype = torch.int8 if self._quant_kv else model.dtype
        self._mgr = BlockKVCache(self.num_blocks, self.block_size)
        self._caches = [self._new_cache_pair() for _ in range(self._num_layers)]
        # per-slot host state, rewritten between steps
        self._slot_req: List[Optional[InferenceRequest]] = [None] * self.max_slots
        self._blocks: List[List[int]] = [[] for _ in range(self.max_slots)]
        self._ntok = np.zeros((self.max_slots,), np.int32)  # tokens in the pool
        self._last_tok = np.zeros((self.max_slots,), np.int32)
        self._reserved = np.zeros((self.max_slots,), np.int64)  # worst-case blocks
        self._waiting: deque = deque()
        self._ids = itertools.count()
        self._policy: AdmissionPolicy = admission_policy or FIFOAdmission()
        self._pending_done: List[InferenceRequest] = []
        self.stats = {"steps": 0, "prompt_tokens_computed": 0}

    def _new_cache_pair(self) -> tuple:
        """One layer's pools: ``(kc, vc)`` zeros of the pool dtype, or under
        ``kv_cache_dtype="int8"`` ``(kc, vc, ks, vs)`` with the scale planes
        ``[NB, KVH, BS]`` fp32 at ones (quantizing zeros gives ``q = 0,
        scale = 1``, so a fresh pool dequantizes to exact zeros)."""
        shape = (self.num_blocks, self._kvh, self.block_size, self._hd)
        pools = tuple(torch.zeros(shape, dtype=self._cache_dtype, device=self.device) for _ in range(2))
        if self._quant_kv:
            pools += tuple(torch.ones(shape[:3], dtype=torch.float32, device=self.device) for _ in range(2))
        return pools

    # -- pool accounting -----------------------------------------------------
    def _bytes_per_token(self) -> int:
        """KV bytes across all layers for one token: ``2 L KVH D`` elements,
        and under int8 one fp32 scale per (token, head) beside each int8
        row, ``2 L KVH (D + 4)`` bytes."""
        if self._quant_kv:
            return 2 * self._num_layers * self._kvh * (self._hd + 4)
        return 2 * self._num_layers * self._kvh * self._hd * self._cache_dtype.itemsize

    def pool_stats(self) -> Dict[str, Any]:
        free = self._mgr.free_blocks
        return {
            "total": self.num_blocks,
            "free": free,
            "allocated": self.num_blocks - free,
            "kv_cache_dtype": self.kv_cache_dtype,
            "bytes_per_token": self._bytes_per_token(),
        }

    def _unreserved_free(self) -> int:
        """Free blocks minus live sequences' outstanding worst-case growth."""
        outstanding = 0
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                outstanding += int(self._reserved[slot]) - len(self._blocks[slot])
        return self._mgr.free_blocks - outstanding

    # -- request intake ------------------------------------------------------
    def validate_request(self, prompt_ids: Any, max_new_tokens: int = 32) -> np.ndarray:
        """Check one prompt against the engine's static limits without queueing
        it; returns the ``int32`` prompt. Raises a typed :class:`IntakeError`."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise EmptyPromptError("empty prompt")
        if max_new_tokens < 1:
            raise InvalidTokenBudgetError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size > self.prompt_bucket:
            raise PromptTooLongError(
                f"prompt ({prompt.size} tokens) exceeds prompt_bucket ({self.prompt_bucket}); "
                "configure a larger bucket"
            )
        if prompt.size + max_new_tokens > self.max_model_len:
            raise RequestTooLongError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_model_len ({self.max_model_len})"
            )
        need = -(-(prompt.size + max_new_tokens - 1) // self.block_size)
        if need > self.num_blocks:
            raise RequestUnservableError(
                f"request needs {need} KV blocks worst-case but the pool only has {self.num_blocks}"
            )
        return prompt

    def add_request(self, prompt_ids: Any, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None) -> int:
        """Queue one prompt; returns the request id."""
        prompt = self.validate_request(prompt_ids, max_new_tokens)
        req = InferenceRequest(next(self._ids), prompt, max_new_tokens, eos_token_id)
        self._waiting.append(req)
        return req.req_id

    def has_work(self) -> bool:
        return bool(self._waiting) or any(r is not None for r in self._slot_req)

    # -- scheduling ----------------------------------------------------------
    def _blocks_needed(self, req: InferenceRequest) -> int:
        # tokens stored by the end: prompt + (max_new - 1); the last token is
        # emitted, never appended
        return -(-(req.prompt.size + req.max_new_tokens - 1) // self.block_size)

    def _can_fit(self, req: InferenceRequest) -> bool:
        return self._unreserved_free() >= self._blocks_needed(req)

    def _admit_waiting(self) -> None:
        while self._waiting:
            free_slots = [i for i, r in enumerate(self._slot_req) if r is None]
            if not free_slots:
                return
            req = self._policy.select(tuple(self._waiting), self._can_fit)
            if req is None:
                return
            # a buggy policy fails loudly instead of breaking the reservation
            if req not in self._waiting or not self._can_fit(req):
                raise RuntimeError(
                    f"admission policy {type(self._policy).__name__} selected request "
                    f"{req.req_id}, which is not waiting or does not fit"
                )
            self._waiting.remove(req)
            self._admit(req, free_slots[0])

    def _admit(self, req: InferenceRequest, slot: int) -> None:
        self._blocks[slot] = []
        self._reserved[slot] = self._blocks_needed(req)
        self._ntok[slot] = 0
        self._last_tok[slot] = 0
        self._slot_req[slot] = req

    def _release(self, slot: int) -> None:
        for blk in self._blocks[slot]:
            self._mgr.decref(blk)  # private blocks free immediately
        self._blocks[slot] = []
        self._reserved[slot] = 0
        self._slot_req[slot] = None
        self._ntok[slot] = 0
        self._last_tok[slot] = 0

    def step(self) -> List[InferenceRequest]:
        """Admit, then run one unified prefill/decode step over all active
        slots. Returns the requests that finished during this step (the only
        hand-back: the engine keeps no reference to them)."""
        self._step_attempt()
        out, self._pending_done = self._pending_done, []
        return out

    def run(self) -> Dict[int, InferenceRequest]:
        """Drain the queue; returns ``{req_id: request}`` for everything that
        finished during this call."""
        out: Dict[int, InferenceRequest] = {}
        while self.has_work():
            for req in self.step():
                out[req.req_id] = req
        return out

    # -- the unified dispatch ------------------------------------------------
    def _dense_tables(self) -> np.ndarray:
        out = np.zeros((self.max_slots, self.max_blocks_per_seq), np.int32)
        for s, blocks in enumerate(self._blocks):
            if blocks:
                out[s, : len(blocks)] = blocks
        return out

    @torch.inference_mode()
    def _step_impl(self, toks: np.ndarray, tables: np.ndarray, lens: np.ndarray,
                   q_lens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """The device step: ``toks [S, C]`` ragged new tokens, ``tables [S,
        MBS]``, ``lens`` tokens already cached, ``q_lens`` valid new tokens,
        ``active`` the slot mask. Appends the chunk KV to the pools in place,
        attends, and returns every row's greedy argmax ``[S, C]`` (rows past
        ``q_lens`` are garbage and never read)."""
        dev = self.device
        ids = torch.from_numpy(toks).to(dev)
        tables_t = torch.from_numpy(tables).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        qlens_t = torch.from_numpy(q_lens).to(dev)
        mask_t = torch.from_numpy(active).to(dev)
        # 6-tuples, or the int8 pool's 8-tuples with the two scale planes last
        pkv = [(kc, vc, tables_t, lens_t, mask_t, qlens_t, *planes) for kc, vc, *planes in self._caches]
        # the JAX engine's call; the pools come back updated in place
        logits, _ = self.model(ids, past_key_values=pkv, use_cache=True, cache_position=lens_t)
        nxt = logits.float().argmax(dim=-1).to(torch.int32)
        return nxt.cpu().numpy()  # device sync: the step's tokens are real here

    def _dispatch(self, toks: np.ndarray, q_lens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """Grow block tables for the new tokens, run one step, then advance
        ``_ntok``. On failure every block allocated for this step is
        returned, so a failed step cannot drift the reservation invariant."""
        appended = []
        try:
            for i in np.flatnonzero(active):
                need = int(self._ntok[i]) + int(q_lens[i])
                while len(self._blocks[i]) * self.block_size < need:
                    blk = self._mgr.acquire_block()
                    self._blocks[i].append(blk)
                    appended.append((i, blk))
            nxt = self._step_impl(toks, self._dense_tables(), self._ntok.copy(), q_lens, active)
        except BaseException:
            for slot, blk in appended:
                self._blocks[slot].remove(blk)
                self._mgr.decref(blk)
            raise
        self._ntok += q_lens  # idle slots carry q_lens == 0
        return nxt

    def _step_attempt(self) -> None:
        self._admit_waiting()
        active_slots = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active_slots:
            return
        C = self.prefill_chunk
        toks = np.zeros((self.max_slots, C), np.int32)
        q_lens = np.zeros((self.max_slots,), np.int32)
        active = np.zeros((self.max_slots,), bool)
        prefill_tokens = 0
        for i in active_slots:
            req = self._slot_req[i]
            plen, cur = req.prompt.size, int(self._ntok[i])
            active[i] = True
            if cur < plen:  # a chunk of the prompt
                n = min(C, plen - cur)
                toks[i, :n] = req.prompt[cur: cur + n]
                q_lens[i] = n
                prefill_tokens += n
            else:  # one decode row
                toks[i, 0] = self._last_tok[i]
                q_lens[i] = 1
        nxt = self._dispatch(toks, q_lens, active)
        self.stats["steps"] += 1
        self.stats["prompt_tokens_computed"] += prefill_tokens
        for i in active_slots:
            req = self._slot_req[i]
            if int(self._ntok[i]) < req.prompt.size:
                continue  # prompt not fully prefilled yet: no emission
            tok = int(nxt[i, int(q_lens[i]) - 1])  # the last valid row
            if not req.generated:
                req.admit_time = time.perf_counter()  # TTFT ends at the first token
            req.generated.append(tok)
            self._last_tok[i] = tok
            if req.eos_token_id is not None and tok == req.eos_token_id:
                req.finish_reason = "stop"
            elif len(req.generated) >= req.max_new_tokens:
                req.finish_reason = "length"
            if req.finished:
                self._release(i)
                self._pending_done.append(req)
