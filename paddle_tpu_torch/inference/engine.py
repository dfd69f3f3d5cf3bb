"""Continuous-batching engine over a ragged paged KV pool (port of
``paddle_tpu/inference/engine.py``).

The host-side scheduler is the JAX engine's: requests queue FIFO, a request
is admitted into a free slot only when the pool's unreserved blocks cover
its worst-case private need (so a step can never run out of blocks), and
every step is one ``[max_slots, prefill_chunk]`` mixed ragged dispatch — a
decode slot contributes one row, a slot still prefilling up to
``prefill_chunk`` prompt tokens, an idle slot none. A finished request's
private blocks return to the pool at once. Each step's per-row greedy argmax comes
back to the host, where tokens are emitted.

The JAX engine's prefix cache is ported and on by default, as in JAX
(``FLAGS_enable_prefix_cache``): a request maps the longest cached chain of
full blocks matching its prompt (``inference/prefix_cache.py``), forks the
first divergent block copy-on-write (the step copies the forked blocks
before it appends; the pools' scale planes too under the int8 pool) and
computes only the rest; its computed prompt blocks join the cache as they
complete and its generated blocks when it finishes; a finished request's
blocks stay warm until eviction needs them. Speculative decoding, recovery,
the KV host tier (``kv_host_tier_bytes`` must be None or 0), tensor
parallelism and metrics are not ported. The device pools
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
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.incubate.nn.functional import BlockKVCache
from paddle_tpu_torch.incubate.nn.functional.block_attention import copy_blocks
from paddle_tpu_torch.inference.prefix_cache import ChainNode, PrefixCache, chain_digest
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
        # prompt tokens served from the prefix cache at admission (0 = cold)
        self.cached_tokens = 0

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
    planes under ``kv_cache_dtype="int8"``. ``enable_prefix_cache``,
    ``kv_cache_dtype`` and ``weight_only_int8`` default to their flags
    (``FLAGS_enable_prefix_cache``, ``FLAGS_kv_cache_dtype``,
    ``FLAGS_weight_only_int8``); ``weight_only_int8`` quantizes the model in
    place, as the JAX engine does. ``kv_host_tier_bytes`` takes only None or
    0: the port has no host tier."""

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
        kv_host_tier_bytes: Optional[int] = None,
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
        if kv_host_tier_bytes:
            raise NotImplementedError(
                f"kv_host_tier_bytes={kv_host_tier_bytes!r}: paddle_tpu_torch has no KV host tier yet"
            )
        if enable_prefix_cache is None:
            enable_prefix_cache = flag("enable_prefix_cache")
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
        self._cache: Optional[PrefixCache] = (
            PrefixCache(self._mgr, self.block_size, self._bytes_per_token()) if enable_prefix_cache else None
        )
        self._caches = [self._new_cache_pair() for _ in range(self._num_layers)]
        # per-slot host state, rewritten between steps
        self._slot_req: List[Optional[InferenceRequest]] = [None] * self.max_slots
        self._blocks: List[List[int]] = [[] for _ in range(self.max_slots)]
        # the leading part of _blocks owned by cache chain nodes (references
        # held): _nodes[s][i].block == _blocks[s][i]
        self._nodes: List[List[ChainNode]] = [[] for _ in range(self.max_slots)]
        self._no_insert = [False] * self.max_slots  # stop chain growth (insert race)
        self._matched_blocks = np.zeros((self.max_slots,), np.int64)  # at admission
        # (source node, destination block, tokens reused) until the step that copies it returns
        self._pending_cow: List[Optional[Tuple[ChainNode, int, int]]] = [None] * self.max_slots
        self._ntok = np.zeros((self.max_slots,), np.int32)  # tokens in the pool
        self._last_tok = np.zeros((self.max_slots,), np.int32)
        self._reserved = np.zeros((self.max_slots,), np.int64)  # worst-case private blocks
        self._waiting: deque = deque()
        self._ids = itertools.count()
        self._policy: AdmissionPolicy = admission_policy or FIFOAdmission()
        self._pending_done: List[InferenceRequest] = []
        self.stats = {"steps": 0, "admitted": 0, "prompt_tokens_computed": 0, "prompt_tokens_reused": 0,
                      "gen_blocks_registered": 0}

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
        """Pool accounting. ``cached_reusable``: blocks the prefix cache holds
        warm but surrenders under pressure (headroom, not load);
        ``cached_blocks``: every cache-owned block, so with no live work
        ``free + cached_blocks == total``."""
        free = self._mgr.free_blocks
        return {
            "total": self.num_blocks,
            "free": free,
            "allocated": self.num_blocks - free,
            "kv_cache_dtype": self.kv_cache_dtype,
            "bytes_per_token": self._bytes_per_token(),
            "cached_reusable": self._cache.evictable_blocks if self._cache is not None else 0,
            "cached_blocks": self._cache.node_count if self._cache is not None else 0,
        }

    def prefix_cache_stats(self) -> Dict[str, Any]:
        """The cache's counters (``{"enabled": False}`` when it is off)."""
        if self._cache is None:
            return {"enabled": False}
        return {"enabled": True, **self._cache.stats_snapshot()}

    def prefix_chain_hash(self, prompt_ids: Any, max_blocks: Optional[int] = None) -> str:
        """Hex digest of the prompt's block-aligned prefix chain: the digest
        the cache keys chain nodes by (a router's affinity key; ``max_blocks``
        caps the walk)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        return chain_digest(prompt, self.block_size, max_blocks).hex()

    def _unreserved_free(self) -> int:
        """Blocks available to new admissions: free plus evictable cached,
        minus live sequences' outstanding worst-case private growth (mapped
        shared blocks never grow)."""
        outstanding = 0
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                private = len(self._blocks[slot]) - int(self._matched_blocks[slot])
                outstanding += int(self._reserved[slot]) - private
        reusable = self._cache.evictable_blocks if self._cache is not None else 0
        return self._mgr.free_blocks + reusable - outstanding

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

    def live_requests(self) -> List[InferenceRequest]:
        """Requests holding a slot, in slot order."""
        return [r for r in self._slot_req if r is not None]

    def cancel_request(self, req_id: int, reason: str = "cancelled") -> Optional[InferenceRequest]:
        """Remove ``req_id`` wherever it is: a queued request is dropped before
        any prefill, a live one leaves its slot and its private blocks return
        at once. The request (``finish_reason = reason``) is returned here and
        not also by :meth:`step`. None when the id is unknown."""
        for req in self._waiting:
            if req.req_id == req_id:
                self._waiting.remove(req)
                req.finish_reason = reason
                return req
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.req_id == req_id:
                req.finish_reason = reason
                self._release(slot, req)
                return req
        return None

    # -- scheduling ----------------------------------------------------------
    def _blocks_needed(self, req: InferenceRequest) -> int:
        # tokens stored by the end: prompt + (max_new - 1); the last token is
        # emitted, never appended
        return -(-(req.prompt.size + req.max_new_tokens - 1) // self.block_size)

    def _can_fit(self, req: InferenceRequest) -> bool:
        need = self._blocks_needed(req)
        avail = self._unreserved_free()
        if self._cache is not None:
            # matched blocks are mapped, not allocated; but a matched block now
            # in the evictable LRU was counted as headroom, which pinning it uses up
            matched, matched_evictable = self._cache.peek_cached_blocks(req.prompt)
            need -= matched
            avail -= matched_evictable
        return avail >= need

    def _alloc_private_block(self) -> int:
        """One request-private block, evicting zero-reference cached chains
        under pressure (the reservation guarantees live slots' growth)."""
        if self._cache is not None:
            return self._cache.alloc_private_block()
        return self._mgr.acquire_block()

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

    def _match_and_map(self, req: InferenceRequest, slot: int) -> None:
        """Map the longest cached prefix into ``slot``'s block table (host
        bookkeeping; a fork's copy rides the slot's first step). A failing
        lookup degrades to a cold miss: the prompt is recomputed."""
        result = None
        if self._cache is not None:
            try:
                result = self._cache.match(req.prompt)
            except Exception as exc:  # noqa: BLE001 - a lookup never kills an admission
                warnings.warn(f"prefix cache lookup failed for request {req.req_id}; its prompt is recomputed: "
                              f"{type(exc).__name__}: {exc}", RuntimeWarning, stacklevel=2)
        nodes = result.nodes if result is not None else []
        cached = result.cached_tokens if result is not None else 0
        cow = result.cow if result is not None else None
        self._nodes[slot] = list(nodes)
        self._blocks[slot] = [n.block for n in nodes]
        self._no_insert[slot] = False
        self._pending_cow[slot] = cow
        if cow is not None:
            self._blocks[slot].append(cow[1])
        self._matched_blocks[slot] = len(nodes)
        self._reserved[slot] = self._blocks_needed(req) - len(nodes)
        self._ntok[slot] = cached
        req.cached_tokens = cached
        self.stats["prompt_tokens_reused"] += cached

    def _admit(self, req: InferenceRequest, slot: int) -> None:
        try:
            self._match_and_map(req, slot)
        except BaseException:
            # whatever kills the admission, the slot is unwound so the pool's
            # accounting is as before it, and the request keeps its place
            self._rollback_admit(slot)
            self._waiting.appendleft(req)
            raise
        self._slot_req[slot] = req
        self._last_tok[slot] = 0
        self.stats["admitted"] += 1

    def _rollback_admit(self, slot: int) -> None:
        """Undo a partly mapped admission."""
        if self._cache is not None:
            if self._pending_cow[slot] is not None:
                src_node, dst_block, _ = self._pending_cow[slot]
                self._cache.release_cow_source(src_node)
                self._mgr.decref(dst_block)
                if self._blocks[slot] and self._blocks[slot][-1] == dst_block:
                    self._blocks[slot].pop()
            if self._nodes[slot]:
                self._cache.release(self._nodes[slot])
        for blk in self._blocks[slot][len(self._nodes[slot]):]:
            self._mgr.decref(blk)
        self._nodes[slot] = []
        self._blocks[slot] = []
        self._matched_blocks[slot] = 0
        self._pending_cow[slot] = None
        self._reserved[slot] = 0
        self._ntok[slot] = 0

    def _release(self, slot: int, req: InferenceRequest) -> None:
        """Hand a finished or cancelled slot back. Its committed full blocks
        join the cache first, unless a fork is still pending: that fork's
        copy never ran, so its block holds garbage and must not be hashed."""
        pending = self._pending_cow[slot]
        if pending is not None and self._cache is not None:
            self._cache.release_cow_source(pending[0])  # cancelled before its first step
        self._pending_cow[slot] = None
        if pending is None:
            self._register_finished_chain(slot, req)
        nodes = self._nodes[slot]
        if self._cache is not None and nodes:
            self._cache.release(nodes)
        for blk in self._blocks[slot][len(nodes):]:
            self._mgr.decref(blk)  # private blocks free at once
        self._nodes[slot] = []
        self._blocks[slot] = []
        self._matched_blocks[slot] = 0
        self._no_insert[slot] = False
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

    def _copy_forks(self, cow_src: np.ndarray, cow_dst: np.ndarray) -> None:
        """The copy-on-write forks of this step: block ``cow_src[i]`` into
        ``cow_dst[i]`` in every layer's pools (the scale planes too under the
        int8 pool). The index arrays are built on the host from the slots
        with a pending fork, so nothing is selected on the device; on a CUDA
        device they go up from pinned memory without waiting for the device."""
        idx = torch.from_numpy(np.stack([cow_src, cow_dst]).astype(np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        for planes in self._caches:
            copy_blocks(planes, idx[0], idx[1])

    @torch.inference_mode()
    def _step_impl(self, toks: np.ndarray, tables: np.ndarray, lens: np.ndarray,
                   q_lens: np.ndarray, active: np.ndarray, cow_src: np.ndarray,
                   cow_dst: np.ndarray) -> np.ndarray:
        """The device step: ``toks [S, C]`` ragged new tokens, ``tables [S,
        MBS]``, ``lens`` tokens already cached, ``q_lens`` valid new tokens,
        ``active`` the slot mask, ``cow_src`` / ``cow_dst`` this step's forks
        (empty: no copy, nothing launched). Copies the forks, appends the
        chunk KV to the pools in place, attends, and returns every row's
        greedy argmax ``[S, C]`` (rows past ``q_lens`` are garbage and never
        read)."""
        if cow_dst.size:
            self._copy_forks(cow_src, cow_dst)
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
        """Grow block tables for the new tokens, fold in the pending forks,
        run one step, then advance ``_ntok``, unpin the forks' sources and
        register the newly completed prompt blocks with the cache. On failure
        every block allocated for this step is returned (a failed step cannot
        drift the reservation) and the forks stay pending."""
        appended = []
        active_slots = [int(i) for i in np.flatnonzero(active)]
        forks = []
        try:
            for i in active_slots:
                need = int(self._ntok[i]) + int(q_lens[i])
                while len(self._blocks[i]) * self.block_size < need:
                    blk = self._alloc_private_block()
                    self._blocks[i].append(blk)
                    appended.append((i, blk))
                if self._pending_cow[i] is not None:
                    forks.append((self._pending_cow[i][0].block, self._pending_cow[i][1]))
            cow = np.asarray(forks, np.int32).reshape(-1, 2)
            nxt = self._step_impl(toks, self._dense_tables(), self._ntok.copy(), q_lens, active,
                                  cow[:, 0], cow[:, 1])
        except BaseException:
            for slot, blk in appended:
                self._blocks[slot].remove(blk)
                self._mgr.decref(blk)
            raise
        for i in active_slots:
            pending = self._pending_cow[i]
            if pending is not None:  # its copy has run
                self._cache.release_cow_source(pending[0])
                self._pending_cow[i] = None
            self._ntok[i] += int(q_lens[i])
            self._extend_chain(i)
        return nxt

    def _register_finished_chain(self, slot: int, req: InferenceRequest) -> None:
        """At finish, extend the slot's chain over its full blocks of the
        prompt and the generated tokens the pool holds (``_ntok``), so a next
        turn (this prompt, its reply and new text) maps them. The release
        that follows drops only this request's references."""
        if self._cache is None or self._no_insert[slot]:
            return
        valid = int(self._ntok[slot])
        full = np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
        bs = self.block_size
        while True:
            idx = len(self._nodes[slot])
            end = (idx + 1) * bs
            if end > valid or end > full.size or idx >= len(self._blocks[slot]):
                return
            parent = self._nodes[slot][-1] if self._nodes[slot] else None
            node = self._cache.insert(parent, full[idx * bs: end], self._blocks[slot][idx])
            if node is None:
                return  # the same chain is cached already; ours stays private
            self._nodes[slot].append(node)
            if end > req.prompt.size:
                self.stats["gen_blocks_registered"] += 1

    def _extend_chain(self, slot: int) -> None:
        """Register the slot's newly completed full prompt blocks as chain
        nodes (in flight: later admissions share them at once). A block that
        holds a generated token waits for :meth:`_register_finished_chain`."""
        if self._cache is None or self._no_insert[slot]:
            return
        req = self._slot_req[slot]
        if req is None:
            return
        plen = req.prompt.size
        bs = self.block_size
        while True:
            idx = len(self._nodes[slot])
            end = (idx + 1) * bs
            if end > plen or end > int(self._ntok[slot]) or idx >= len(self._blocks[slot]):
                return
            parent = self._nodes[slot][-1] if self._nodes[slot] else None
            node = self._cache.insert(parent, req.prompt[idx * bs: end], self._blocks[slot][idx])
            if node is None:
                # another request registered this block first; keep ours
                # private and stop, so nodes stay a prefix of the table
                self._no_insert[slot] = True
                return
            self._nodes[slot].append(node)

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
                self._release(i, req)
                self._pending_done.append(req)
