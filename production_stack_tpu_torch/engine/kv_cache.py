"""Paged KV cache: the device block pool + the host-side block allocator.

- The pool is one fused tensor ``(L, num_blocks, block_size, 2*KH, D)`` on
  the device, in the reference's layout (ops/paged_attention.py), so blocks
  stay byte-compatible with the JAX engine's. It is allocated once, as
  zeros, and updated in place.
- The allocator (a copy of the reference's) runs on the host and does
  vLLM-style prefix caching: full blocks are content-hashed by their token
  chain, a new request reuses cached prefix blocks and computes only the
  tail, and freed hashed blocks stay matchable on an LRU list until
  evicted. ``_chain_hash`` is bit-identical to the reference's, so both
  engines give a prefix the same block identity. A chain starts at
  ``HASH_SEED`` for the base model; a LoRA request's starts at its
  adapter's root (``adapter_root``, a digest of the adapter's weights, so
  every process and every engine gives one adapter one root), so KV
  computed under one adapter never serves another or the base model, in
  the pool or in the host and remote tiers (the reference roots every
  chain at the seed and shares such blocks).
- When the allocator evicts a cached block it first calls ``evict_hook``
  with the block's id and content hash, while the block's KV is intact:
  the engine demotes it to the host tier there.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import CacheConfig, ModelConfig


def init_kv_cache(model: ModelConfig, cache: CacheConfig, num_blocks: int,
                  device: torch.device | str) -> torch.Tensor:
    """Allocate the fused block pool as zeros on ``device``."""
    if num_blocks <= 0:
        raise ValueError("num_blocks must be resolved before init (see sizing)")
    shape = (model.num_layers, num_blocks, cache.block_size,
             2 * model.num_kv_heads, model.head_dim)
    return torch.zeros(shape, dtype=model.torch_dtype, device=device)


def kv_cache_bytes_per_block(model: ModelConfig, cache: CacheConfig) -> int:
    itemsize = torch.empty((), dtype=model.torch_dtype).element_size()
    return (
        2 * model.num_layers * cache.block_size * model.num_kv_heads
        * model.head_dim * itemsize
    )


# ---------------------------------------------------------------------------
# Host-side allocator with prefix caching
# ---------------------------------------------------------------------------

HASH_SEED = 0x9E3779B97F4A7C15


def _chain_hash(prev: int, tokens: tuple[int, ...]) -> int:
    return hash((prev, tokens)) & 0x7FFFFFFFFFFFFFFF


def adapter_root(bank: dict) -> int:
    """The hash-chain root of requests on the adapter whose stacked
    ``{target: (A, B)}`` arrays are ``bank`` (``lora.load_adapter_raw``):
    a SHA-256 of the targets' names, dtypes, shapes and bytes, so it is the
    same in every process and on every engine that loads the same weights,
    and never ``HASH_SEED``. The base model roots at ``HASH_SEED``."""
    h = hashlib.sha256()
    for key in sorted(bank):
        for arr in bank[key]:
            a = np.ascontiguousarray(arr)
            h.update(f"{key}:{a.dtype.str}:{a.shape};".encode())
            h.update(a.tobytes())
    root = int.from_bytes(h.digest()[:8], "little") & 0x7FFFFFFFFFFFFFFF
    return root if root != HASH_SEED else root ^ 1


@dataclasses.dataclass
class Block:
    block_id: int
    ref_count: int = 0
    content_hash: Optional[int] = None  # set only for full, hashable blocks


class PrefixCachingBlockAllocator:
    """Block pool with content-hash prefix reuse and LRU eviction."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self.blocks = [Block(i) for i in range(num_blocks)]
        self.free_ids: collections.deque[int] = collections.deque(range(num_blocks))
        self.hash_to_block: dict[int, int] = {}
        self.lru: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.evictions = 0
        # called with (block_id, content_hash) before an evicted block
        # returns to the free list, while its KV is intact; it must not
        # allocate from this pool
        self.evict_hook = None

    # -- internals ---------------------------------------------------------
    def _evict_one(self) -> bool:
        if not self.lru:
            return False
        bid, _ = self.lru.popitem(last=False)
        blk = self.blocks[bid]
        if blk.content_hash is not None:
            if self.evict_hook is not None:
                self.evict_hook(bid, blk.content_hash)
            self.hash_to_block.pop(blk.content_hash, None)
            blk.content_hash = None
        self.free_ids.append(bid)
        self.evictions += 1
        return True

    def _pop_free(self) -> Optional[int]:
        if not self.free_ids and not self._evict_one():
            return None
        bid = self.free_ids.popleft()
        blk = self.blocks[bid]
        blk.ref_count = 1
        blk.content_hash = None
        return bid

    def _take_cached(self, bid: int) -> None:
        blk = self.blocks[bid]
        if blk.ref_count == 0:
            self.lru.pop(bid, None)
        blk.ref_count += 1

    # -- public API --------------------------------------------------------
    @property
    def num_free_blocks(self) -> int:
        return len(self.free_ids) + len(self.lru)

    @property
    def usage(self) -> float:
        return 1.0 - self.num_free_blocks / max(self.num_blocks, 1)

    def match_prefix(self, tokens: Sequence[int],
                     root: int = HASH_SEED) -> tuple[list[int], int]:
        """Longest chain of cached full blocks for this token sequence,
        hashed from ``root``. Returns (block_ids, num_cached_tokens). Takes
        no references."""
        if not self.enable_prefix_caching:
            return [], 0
        matched: list[int] = []
        prev = root
        n_full = len(tokens) // self.block_size
        for i in range(n_full):
            chunk = tuple(tokens[i * self.block_size : (i + 1) * self.block_size])
            prev = _chain_hash(prev, chunk)
            bid = self.hash_to_block.get(prev)
            if bid is None:
                break
            matched.append(bid)
        return matched, len(matched) * self.block_size

    def allocate_sequence(
        self, tokens: Sequence[int], root: int = HASH_SEED
    ) -> Optional[tuple[list[int], int]]:
        """Allocate blocks to cover ``tokens`` (a prompt), reusing cached
        prefix blocks. Returns (block_ids, num_cached_tokens) or None if out
        of blocks. At least one token is always left uncached so the
        forward pass emits a next-token logit."""
        needed_blocks = max((len(tokens) + self.block_size - 1) // self.block_size, 1)
        matched, _ = self.match_prefix(tokens, root)
        self.prefix_queries += len(tokens) // self.block_size
        # never treat the whole prompt as cached: recompute the last token
        max_matched = max((len(tokens) - 1) // self.block_size, 0)
        matched = matched[:max_matched]
        cached_tokens = len(matched) * self.block_size
        self.prefix_hits += len(matched)

        fresh_needed = needed_blocks - len(matched)
        if fresh_needed > self.num_free_blocks:
            return None
        for bid in matched:
            self._take_cached(bid)
        block_ids = list(matched)
        for _ in range(fresh_needed):
            bid = self._pop_free()
            if bid is None:  # cannot happen after the check above
                self.free_blocks(block_ids)
                return None
            block_ids.append(bid)
        return block_ids, cached_tokens

    def append_block(self) -> Optional[int]:
        """One more block for a growing (decoding) sequence."""
        return self._pop_free()

    def take_free_blocks(self, n: int) -> Optional[list[int]]:
        """``n`` fresh blocks (refcount 1) for a KV import; None if the
        pool cannot give them."""
        if n > self.num_free_blocks:
            return None
        out = []
        for _ in range(n):
            bid = self._pop_free()
            if bid is None:  # cannot happen after the check above
                self.free_blocks(out)
                return None
            out.append(bid)
        return out

    def pin_blocks(self, block_ids: Sequence[int]) -> None:
        """Take a reference on live or cached blocks (for a streamed
        export), so eviction and reallocation cannot tear them mid-use;
        release with ``free_blocks``. A block on the free list holds
        nothing to pin: it raises ValueError and pins none. (The
        reference's ``pin_blocks`` leaves such a block on the free list
        with a reference, so it can be handed out twice.)"""
        for bid in block_ids:
            blk = self.blocks[bid]
            if blk.ref_count == 0 and bid not in self.lru:
                raise ValueError(f"block {bid} is free: nothing to pin")
        for bid in block_ids:
            self._take_cached(bid)

    def commit_full_blocks(
        self, tokens: Sequence[int], block_ids: Sequence[int],
        root: int = HASH_SEED,
    ) -> None:
        """Register content hashes (chained from ``root``) for every
        now-full block of a sequence so future requests can prefix-match
        them."""
        if not self.enable_prefix_caching:
            return
        prev = root
        n_full = len(tokens) // self.block_size
        for i in range(min(n_full, len(block_ids))):
            chunk = tuple(tokens[i * self.block_size : (i + 1) * self.block_size])
            prev = _chain_hash(prev, chunk)
            blk = self.blocks[block_ids[i]]
            if blk.content_hash is None and prev not in self.hash_to_block:
                blk.content_hash = prev
                self.hash_to_block[prev] = blk.block_id

    def free_blocks(self, block_ids: Sequence[int]) -> None:
        for bid in block_ids:
            blk = self.blocks[bid]
            blk.ref_count -= 1
            if blk.ref_count < 0:
                raise RuntimeError(f"double free of block {bid}")
            if blk.ref_count == 0:
                if blk.content_hash is not None:
                    self.lru[bid] = None  # reusable, evictable
                else:
                    self.free_ids.append(bid)


def slot_mapping_for(
    block_ids: Sequence[int], start: int, count: int, block_size: int
) -> np.ndarray:
    """Flat pool-slot index (block*block_size + offset) for token positions
    [start, start+count) of a sequence."""
    positions = np.arange(start, start + count)
    blocks = np.asarray(block_ids, np.int32)[positions // block_size]
    return (blocks * block_size + positions % block_size).astype(np.int32)
