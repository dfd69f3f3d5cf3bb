"""Content-addressed prefix cache over the paged KV block pool (port of
``paddle_tpu/inference/prefix_cache.py``).

Shared prefixes (system prompts, few-shot templates, earlier turns of a
conversation) are computed once and mapped by every request that repeats
them:

- **Chain nodes.** A token stream is cut into block-aligned segments; each
  full block is keyed by a rolling content digest ``H(parent_digest,
  token_bytes)``, so a node names the whole prefix that produced its KV,
  not only its own tokens. Prompt blocks register in flight (the step that
  completes them returns); blocks holding generated tokens register when
  their request finishes (``engine._register_finished_chain``).
- **Match + map.** At admission the longest chain of cached nodes that
  matches the prompt is mapped into the request's block table, references
  taken; those tokens are never recomputed. The match stops at
  ``prompt_len - 1``: the first generated token comes from the last prompt
  position's logits, so that position is always computed.
- **Copy-on-write.** When the first divergent block shares a leading run of
  tokens with a cached child block (a ragged prompt tail, the one token held
  back by the cap, a mid-block divergence), that child's block is forked:
  the engine copies it on the device in its next step and the request writes
  into its private copy. The source node stays pinned until that step has
  returned.
- **Refcounts + eviction.** A node's block returns to the free list only
  when no request maps it, no child chains under it, and the LRU evicts it;
  until then a finished request's blocks stay warm for the next match.
  Eviction walks zero-reference chain tails only, so a live request never
  loses a block.

One lock, ordered above the pool's (cache -> pool, never the reverse).

Left out, as the port has no layer for them yet: the host spill tier (an
evicted node is dropped), the metric families and the flight recorder (the
counters of :meth:`PrefixCache.stats_snapshot` are plain host ints). The two
degrade paths stay: a failing :meth:`~PrefixCache.match` is the engine's
cold miss, and a ``MemoryError`` on the fork's allocation recomputes the
partial block.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ChainNode", "MatchResult", "PrefixCache", "chain_digest", "leading_run"]

_ROOT_DIGEST = b"prefix-cache-root"


def leading_run(cand: np.ndarray, remaining: np.ndarray) -> int:
    """Length of the leading token run ``remaining`` shares with candidate
    block ``cand``: the partial-match rule of the copy-on-write arm."""
    cand = cand[: remaining.size]
    neq = np.nonzero(cand != remaining)[0]
    return int(neq[0]) if neq.size else int(remaining.size)


def _digest(parent_digest: bytes, token_bytes: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_digest)
    h.update(token_bytes)
    return h.digest()


def chain_digest(prompt: np.ndarray, block_size: int, max_blocks: Optional[int] = None) -> bytes:
    """Rolling content digest of ``prompt``'s block-aligned prefix chain:
    the recurrence :meth:`PrefixCache.match` walks, so two prompts that would
    map the same cached chain give the same digest (a router's affinity
    key). ``max_blocks`` caps the walk; a prompt shorter than one block
    hashes its raw tokens under the root."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    bs = int(block_size)
    n_full = prompt.size // bs
    if max_blocks is not None:
        n_full = min(n_full, int(max_blocks))
    digest = _ROOT_DIGEST
    if n_full == 0:
        return _digest(digest, prompt.tobytes())
    for i in range(n_full):
        digest = _digest(digest, prompt[i * bs: (i + 1) * bs].tobytes())
    return digest


class ChainNode:
    """One cached full block of KV: a link in a content-hash chain.

    ``req_refs`` counts live request mappings (a pending fork reading from
    this block included); ``child_refs`` counts cached child nodes. The node
    is evictable only when both are zero."""

    __slots__ = ("key", "digest", "block", "parent", "token_bytes", "req_refs", "child_refs")

    def __init__(self, key: Tuple[bytes, bytes], digest: bytes, block: int, parent: Optional["ChainNode"],
                 token_bytes: bytes) -> None:
        self.key = key
        self.digest = digest
        self.block = block
        self.parent = parent
        self.token_bytes = token_bytes
        self.req_refs = 0
        self.child_refs = 0


class MatchResult:
    """Outcome of :meth:`PrefixCache.match`, references already held.

    ``nodes`` are the matched full-block chain; ``cached_tokens`` counts every
    token served from the cache, the forked partial included; ``cow`` is
    ``(src_node, dst_block, partial_len)`` when the first divergent block was
    forked (``src_node`` pinned until :meth:`PrefixCache.release_cow_source`)."""

    __slots__ = ("nodes", "cached_tokens", "cow")

    def __init__(self, nodes: List[ChainNode], cached_tokens: int, cow: Optional[Tuple[ChainNode, int, int]]) -> None:
        self.nodes = nodes
        self.cached_tokens = cached_tokens
        self.cow = cow


class PrefixCache:
    """Content-addressed, reference-counted block cache over a
    :class:`~paddle_tpu_torch.incubate.nn.functional.BlockKVCache` pool.

    ``bytes_per_token`` sizes ``bytes_saved``: the KV bytes of one token
    across all layers."""

    def __init__(self, pool: Any, block_size: int, bytes_per_token: int = 0) -> None:
        self._pool = pool
        self.block_size = int(block_size)
        self.bytes_per_token = int(bytes_per_token)
        self._lock = threading.Lock()
        self._nodes: Dict[Tuple[bytes, bytes], ChainNode] = {}
        # parent digest -> insertion-ordered child keys (the partial-match scan)
        self._children: Dict[bytes, List[Tuple[bytes, bytes]]] = {}
        # zero-reference chain TAILS in LRU order (oldest first): the eviction
        # walk; interior dead nodes join when their last child leaves
        self._evictable: "OrderedDict[Tuple[bytes, bytes], ChainNode]" = OrderedDict()
        # a request that maps a node maps its whole ancestor chain, so every
        # node with req_refs == 0 is reachable by the leaf-first cascade:
        # the dead count is the headroom admission may reclaim
        self._dead = 0  # nodes with req_refs == 0
        self._shared = 0  # nodes with req_refs >= 2
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._tokens_reused = 0
        self._cow_forks = 0

    @staticmethod
    def _digest(parent_digest: bytes, token_bytes: bytes) -> bytes:
        return _digest(parent_digest, token_bytes)

    # -- introspection -------------------------------------------------------
    @property
    def evictable_blocks(self) -> int:
        """Blocks the cache holds but surrenders under pressure: every node
        with zero request references."""
        with self._lock:
            return self._dead

    @property
    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def stats_snapshot(self) -> Dict[str, Any]:
        """Counters only (no scan of the node table under the lock). The
        keys of the JAX package's; ``host_hits`` and ``spilled`` stay 0, as
        the port has no host tier."""
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "hits": self._hits,
                "host_hits": 0,
                "misses": self._misses,
                "hit_rate": (self._hits / lookups) if lookups else 0.0,
                "tokens_reused": self._tokens_reused,
                "bytes_saved": self._tokens_reused * self.bytes_per_token,
                "cow_forks": self._cow_forks,
                "evictions": self._evictions,
                "spilled": 0,
                "nodes": len(self._nodes),
                "evictable_blocks": self._dead,
                "blocks_shared": self._shared,
            }

    def peek_cached_blocks(self, prompt: np.ndarray) -> Tuple[int, int]:
        """``(matched, matched_evictable)``: the full blocks a :meth:`match`
        of ``prompt`` would map, without taking references; the second
        counts those now dead (zero request references), whose pinning
        consumes headroom admission would otherwise count as free."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = prompt.size - 1
        bs = self.block_size
        with self._lock:
            parent_digest, pos, n, n_evictable = _ROOT_DIGEST, 0, 0, 0
            while pos + bs <= cap:
                node = self._nodes.get((parent_digest, prompt[pos: pos + bs].tobytes()))
                if node is None:
                    break
                n += 1
                n_evictable += node.req_refs == 0
                pos += bs
                parent_digest = node.digest
            return n, n_evictable

    # -- match / acquire -----------------------------------------------------
    def match(self, prompt: np.ndarray) -> MatchResult:
        """Map the longest cached prefix chain of ``prompt``, references taken
        under the lock (a matched node cannot be evicted between match and
        use), then the copy-on-write arm for the first divergent block."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = prompt.size - 1  # at least one token is computed, for the logits
        bs = self.block_size
        with self._lock:
            nodes: List[ChainNode] = []
            parent_digest, pos = _ROOT_DIGEST, 0
            while pos + bs <= cap:
                node = self._nodes.get((parent_digest, prompt[pos: pos + bs].tobytes()))
                if node is None:
                    break
                nodes.append(node)
                pos += bs
                parent_digest = node.digest
            # the chain is pinned before the fork's allocation, which may
            # evict: an unpinned node could leave the cache and its block come
            # back as the fork's destination
            for node in nodes:
                self._acquire_locked(node)
            cow = self._match_partial_locked(prompt, pos, cap, parent_digest)
            cached = pos + (cow[2] if cow is not None else 0)
            if cached > 0:
                self._hits += 1
                self._tokens_reused += cached
            else:
                self._misses += 1
            return MatchResult(nodes, cached, cow)

    def _match_partial_locked(self, prompt: np.ndarray, pos: int, cap: int,
                              parent_digest: bytes) -> Optional[Tuple[ChainNode, int, int]]:
        """The copy-on-write arm: fork the cached child of ``parent_digest``
        with the longest leading run in common with the rest of the prompt
        (up to the cap) into a private block. Returns ``(src_node, dst_block,
        partial_len)``, or None when no child shares a token or the pool
        cannot give a block even after eviction (the partial is then
        recomputed)."""
        remaining = prompt[pos: min(cap, pos + self.block_size)]
        if remaining.size < 1:
            return None
        src: Optional[ChainNode] = None
        best = 0
        for key in self._children.get(parent_digest, ()):
            node = self._nodes.get(key)
            if node is None:
                continue
            k = leading_run(np.frombuffer(node.token_bytes, np.int32), remaining)
            if k > best:
                best, src = k, node
        if src is None:
            return None
        self._acquire_locked(src)  # pinned through the allocation and until the copy has run
        try:
            dst = self._alloc_block_locked()
        except MemoryError:
            self._release_locked(src)
            return None
        self._cow_forks += 1
        return (src, dst, best)

    def _acquire_locked(self, node: ChainNode) -> None:
        if node.req_refs == 0:
            self._dead -= 1
        elif node.req_refs == 1:
            self._shared += 1
        node.req_refs += 1
        self._pool.incref(node.block)
        self._evictable.pop(node.key, None)

    # -- insert (in-flight registration) -------------------------------------
    def insert(self, parent: Optional[ChainNode], tokens: np.ndarray, block: int) -> Optional[ChainNode]:
        """Register a request's computed full block as a chain node. The
        cache becomes a co-owner of the block (pool incref); the request
        keeps its own reference. Returns None when the key exists already
        (two requests computed the same block): the caller keeps its copy
        private and the cache keeps the first."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size != self.block_size:
            raise ValueError(f"only full blocks are cacheable: got {tokens.size} tokens, "
                             f"block_size={self.block_size}")
        token_bytes = tokens.tobytes()
        parent_digest = parent.digest if parent is not None else _ROOT_DIGEST
        key = (parent_digest, token_bytes)
        with self._lock:
            if key in self._nodes:
                return None
            node = ChainNode(key, _digest(parent_digest, token_bytes), int(block), parent, token_bytes)
            node.req_refs = 1
            self._pool.incref(block)  # the cache's ownership
            if parent is not None:
                parent.child_refs += 1
                self._evictable.pop(parent.key, None)
            self._nodes[key] = node
            self._children.setdefault(parent_digest, []).append(key)
            return node

    # -- release / evict -----------------------------------------------------
    def release(self, nodes: List[ChainNode]) -> None:
        """Drop one request reference per node. Blocks are not freed: a
        zero-reference chain tail enters the LRU and stays warm."""
        with self._lock:
            for node in reversed(nodes):
                self._release_locked(node)

    def release_cow_source(self, node: ChainNode) -> None:
        """Drop the pin on a fork's source once its copy has run."""
        with self._lock:
            self._release_locked(node)

    def _release_locked(self, node: ChainNode) -> None:
        if node.req_refs <= 0:
            raise RuntimeError(f"refcount underflow on cached block {node.block}")
        node.req_refs -= 1
        if node.req_refs == 0:
            self._dead += 1
        elif node.req_refs == 1:
            self._shared -= 1
        self._pool.decref(node.block)
        if node.req_refs == 0 and node.child_refs == 0:
            self._evictable[node.key] = node  # the most recent end

    def evict_blocks(self, n: int) -> int:
        """Evict up to ``n`` zero-reference nodes, LRU first, returning their
        blocks to the pool (a parent whose last child left follows). Returns
        the number evicted."""
        with self._lock:
            return self._evict_locked(n)

    def _evict_locked(self, n: int) -> int:
        done = 0
        while done < n and self._evictable:
            _key, node = self._evictable.popitem(last=False)  # the oldest
            self._drop_node_locked(node)
            done += 1
        self._evictions += done
        return done

    def _drop_node_locked(self, node: ChainNode) -> None:
        self._dead -= 1  # only dead nodes reach the eviction walk
        del self._nodes[node.key]
        siblings = self._children.get(node.key[0])
        if siblings is not None:
            siblings.remove(node.key)
            if not siblings:
                del self._children[node.key[0]]
        self._pool.decref(node.block)  # the cache's ownership; frees at zero
        parent = node.parent
        if parent is not None:
            parent.child_refs -= 1
            if parent.child_refs == 0 and parent.req_refs == 0:
                # pinned only by this child, so older than anything in the
                # LRU: it goes to the eviction head
                self._evictable[parent.key] = parent
                self._evictable.move_to_end(parent.key, last=False)

    def _alloc_block_locked(self) -> int:
        """One private block, evicting one LRU node under pressure."""
        try:
            return self._pool.acquire_block()
        except MemoryError:
            if self._evict_locked(1) == 0:
                raise
            return self._pool.acquire_block()

    def alloc_private_block(self) -> int:
        """One request-private block, evicting zero-reference chains LRU
        first under pressure: the engine's one allocation seam, so the
        cache's retention never starves a live request."""
        with self._lock:
            return self._alloc_block_locked()
