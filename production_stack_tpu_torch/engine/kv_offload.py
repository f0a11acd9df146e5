"""The host-DRAM and remote KV tiers behind the device pool.

Ports production_stack_tpu/engine/kv_offload.py with the same byte
accounting, LRU order, locking and counters. The pool's prefix cache is the
hot tier, :class:`HostKVStore` the warm one, a shared ``kv_server`` the
remote one. Blocks move on demand both ways:

- down: when the pool's allocator evicts a cached block, the engine copies
  its slab to the host first (``evict_hook``); when the host store evicts
  under byte pressure, the slab moves on to the remote tier
  (``demote_hook``, a bounded fire-and-forget put). Finished sequences are
  also offloaded whole, so the tiers fill before pressure comes;
- up: at admission, a chain that misses the pool is looked up host first,
  then remote, by :class:`KVPrefetcher` on its own threads; the engine
  commits the fetched slabs into the sequence's blocks while it waits in
  ``PREFETCHING``, so the serving loop never blocks on a tier.

A slab is one block's ``(L, bs, 2KH, D)`` KV as a host ``torch.Tensor``
(bfloat16 included). Every tier keys a block by its chain hash from the
sequence's own root (``kv_cache.adapter_root`` for a LoRA request), so an
adapter's blocks never serve the base model or another adapter; the
reference keys every block by the base chain. The remote client speaks
the reference's ``kv_server`` protocol on the standard library (the card's
machine has no ``requests``), bf16 as raw 2-byte words tagged
``"bfloat16"``, so a JAX engine and this package's engine share one store.

Under tensor parallelism the tiers live in rank 0's process and hold
whole slabs, every rank's KV heads joined in the reference's pool layout
at that tensor-parallel size (engine/multihost.py). That layout depends on
the size, so each slab's ``X-KV-Meta`` names its KV head grouping
(``head_groups``, kv_transfer.py); a slab of another grouping is a clean
miss, counted in ``refused``, never imported as other heads (the
reference's meta carries no grouping, and a missing one is read as the
client's own).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import logging
import http.client
import threading
import time
import urllib.parse
from typing import Callable, Optional, Sequence

import torch

from production_stack_tpu_torch.engine.kv_cache import HASH_SEED, _chain_hash
from production_stack_tpu_torch.engine.kv_transfer import (
    HEAD_GROUPS_META,
    read_exactly,
    tensor_bytes,
    tensor_from_bytes,
)

_log = logging.getLogger(__name__)

DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.float32: "float32"}


def _observe_put(fut) -> None:
    """Done-callback of fire-and-forget puts: log what a dropped future
    would swallow."""
    exc = fut.exception()
    if exc is not None:
        _log.debug("fire-and-forget put worker raised", exc_info=exc)


def chain_hashes(tokens: Sequence[int], block_size: int,
                 root: int = HASH_SEED) -> list[int]:
    """The allocator's content-hash chain, from ``root``, for every full
    block: a block's identity in the pool and in both tiers."""
    out, prev = [], root
    for i in range(len(tokens) // block_size):
        chunk = tuple(tokens[i * block_size : (i + 1) * block_size])
        prev = _chain_hash(prev, chunk)
        out.append(prev)
    return out


class HostKVStore:
    """A byte-accounted LRU of block slabs keyed by chain hash.

    ``capacity_bytes`` is authoritative. The block-count knob
    ``capacity_blocks`` is converted when the first slab fixes a block's
    byte size, unless ``bytes_per_block`` or ``capacity_bytes`` is given."""

    def __init__(self, capacity_blocks: int, block_size: int,
                 bytes_per_block: int = 0, capacity_bytes: int = 0):
        self.capacity = capacity_blocks
        self.block_size = block_size
        self.capacity_bytes = (capacity_bytes if capacity_bytes > 0
                               else capacity_blocks * bytes_per_block)
        self.used_bytes = 0  # guarded-by: _lock
        # chain hash -> (L, bs, 2KH, D) slab; guarded-by: _lock
        self.store: "collections.OrderedDict[int, torch.Tensor]" = (
            collections.OrderedDict())
        self.stores = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.queries = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        # bumped after the lock is released, where the demote hook runs
        self.demotions = 0
        # called with (chain_hash, slab) for each LRU-evicted slab: the
        # engine points it at the remote tier's put
        self.demote_hook: Optional[Callable[[int, torch.Tensor], None]] = None
        self._lock = threading.RLock()

    @property
    def usage(self) -> float:
        """Byte occupancy (``vllm:cpu_cache_usage_perc``)."""
        return self.used_bytes / max(self.capacity_bytes, 1)

    def chain_hashes(self, tokens: Sequence[int],
                     root: int = HASH_SEED) -> list[int]:
        return chain_hashes(tokens, self.block_size, root)

    def __contains__(self, chain_hash: int) -> bool:
        with self._lock:
            return chain_hash in self.store

    def _evict_for(self, nbytes: int) -> list:
        """Pop LRU entries until ``nbytes`` fits (under the lock); the
        demoted entries go to the hook outside it."""
        demoted = []
        while self.store and self.used_bytes + nbytes > self.capacity_bytes:
            h, slab = self.store.popitem(last=False)
            self.used_bytes -= slab.nbytes
            self.evictions += 1
            demoted.append((h, slab))
        return demoted

    def put(self, chain_hash: int, slab: torch.Tensor) -> bool:
        """Store one slab (a re-put refreshes its LRU place). True if it
        was added."""
        demoted = []
        try:
            with self._lock:
                if self.capacity_bytes <= 0:
                    self.capacity_bytes = self.capacity * slab.nbytes
                if chain_hash in self.store:
                    self.store.move_to_end(chain_hash)
                    return False
                if slab.nbytes > self.capacity_bytes:
                    return False  # one slab over capacity never fits
                demoted = self._evict_for(slab.nbytes)
                self.store[chain_hash] = slab
                self.used_bytes += slab.nbytes
                self.stores += 1
                return True
        finally:
            if demoted and self.demote_hook is not None:
                self.demotions += len(demoted)
                for h, s in demoted:
                    self.demote_hook(h, s)

    def put_sequence(self, tokens: Sequence[int], slabs,
                     root: int = HASH_SEED) -> int:
        """Store a finished sequence's full-block slabs, one a block;
        returns how many were added."""
        added = 0
        for h, slab in zip(self.chain_hashes(tokens, root), slabs):
            if self.put(h, slab):
                added += 1
        return added

    def probe_extension(self, tokens: Sequence[int], start_block: int,
                        root: int = HASH_SEED) -> int:
        """How many blocks this store could continue the chain with, for a
        routing lookup: touches neither the LRU order nor the counters."""
        hashes = self.chain_hashes(tokens, root)
        max_usable = max((len(tokens) - 1) // self.block_size, 0)
        n = 0
        with self._lock:
            for i in range(start_block, min(len(hashes), max_usable)):
                if hashes[i] not in self.store:
                    break
                n += 1
        return n

    def match_extension(self, tokens: Sequence[int], start_block: int,
                        root: int = HASH_SEED) -> tuple[list, int]:
        """The longest run of stored blocks continuing the chain from
        ``start_block`` (the blocks the pool already covers), never past
        the last full block before the final token. (slabs, n_blocks)."""
        hashes = self.chain_hashes(tokens, root)
        max_usable = max((len(tokens) - 1) // self.block_size, 0)
        slabs = []
        with self._lock:
            for i in range(start_block, min(len(hashes), max_usable)):
                self.queries += 1
                slab = self.store.get(hashes[i])
                if slab is None:
                    break
                self.store.move_to_end(hashes[i])
                self.hits += 1
                slabs.append(slab)
        return slabs, len(slabs)


class RemoteKVClient:
    """The engine's client of the shared remote tier (``kv_server``).

    Network IO runs on its own thread pool, never on the serving thread,
    each thread on one kept-alive connection (the reference keeps a
    ``requests.Session`` a thread). Puts are fire-and-forget with a
    bounded backlog (past it they are dropped: the tier is best-effort).
    At admission the whole candidate chain is fetched concurrently and
    consumed in order under one deadline, so a cold tier costs at most
    ``get_timeout`` an admission."""

    _MAX_PENDING_PUTS = 1024

    def __init__(self, base_url: str, block_size: int,
                 get_timeout: float = 2.0, io_threads: int = 4,
                 head_groups: int = 1):
        self.base_url = base_url.rstrip("/")
        self.block_size = block_size
        self.get_timeout = get_timeout
        self.head_groups = head_groups
        self.hits = 0
        self.queries = 0
        self.refused = 0  # fetched slabs of another KV head grouping
        u = urllib.parse.urlsplit(self.base_url)
        self._host, self._port = u.hostname, u.port or 80
        self._prefix = u.path.rstrip("/")
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=io_threads, thread_name_prefix="remote-kv")
        self._local = threading.local()  # one connection an IO thread
        self._pending_puts = 0  # guarded-by: _pending_lock
        self._pending_lock = threading.Lock()

    def _request(self, method: str, key: str, timeout: float, body=None,
                 headers=None) -> tuple[int, dict, bytearray]:
        """One request on this thread's kept-alive connection, read to
        its end: (status, headers, body). A connection the server closed
        meanwhile is reopened once."""
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = self._local.conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=timeout)
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            try:
                conn.request(method, f"{self._prefix}/blocks/{key}",
                             body=body, headers=headers or {})
                resp = conn.getresponse()
                data = read_exactly(resp, int(resp.headers.get(
                    "Content-Length") or 0))
                return resp.status, resp.headers, data
            except (OSError, http.client.HTTPException, EOFError):
                conn.close()
                self._local.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _put_one(self, key: str, data, meta: str) -> None:
        try:
            self._request("PUT", key, 10.0, body=data, headers={
                "X-KV-Meta": meta,
                "Content-Type": "application/octet-stream"})
        except Exception:
            # best-effort: a failed put costs a later recompute
            _log.debug("remote put %s failed (best-effort)", key,
                       exc_info=True)
        finally:
            with self._pending_lock:
                self._pending_puts -= 1

    def put_slab(self, chain_hash: int, slab: torch.Tensor) -> None:
        with self._pending_lock:
            if self._pending_puts >= self._MAX_PENDING_PUTS:
                return  # backlog: drop rather than grow without bound
            self._pending_puts += 1
        meta = json.dumps({"shape": list(slab.shape),
                           "dtype": DTYPE_NAMES[slab.dtype],
                           HEAD_GROUPS_META: self.head_groups})
        try:
            fut = self._io.submit(self._put_one, str(chain_hash),
                                  bytes(tensor_bytes(slab)), meta)
        except RuntimeError:  # the pool was shut down
            with self._pending_lock:
                self._pending_puts -= 1
        else:
            fut.add_done_callback(_observe_put)

    def _fetch_one(self, chain_hash: int) -> Optional[torch.Tensor]:
        try:
            status, headers, body = self._request("GET", str(chain_hash),
                                                  self.get_timeout)
            if status != 200:
                return None
            meta = json.loads(headers.get("X-KV-Meta") or "{}")
            if int(meta.get(HEAD_GROUPS_META,
                            self.head_groups)) != self.head_groups:
                with self._pending_lock:
                    self.refused += 1
                return None
            return tensor_from_bytes(body, meta.get("dtype", "float32"),
                                     meta["shape"])
        except Exception:  # a timeout or a bad entry: a miss
            return None

    def get_slab(self, chain_hash: int) -> Optional[torch.Tensor]:
        self.queries += 1
        slab = self._fetch_one(chain_hash)
        if slab is not None:
            self.hits += 1
        return slab

    def match_extension(self, hashes: list[int], start: int,
                        max_usable: int) -> list:
        """The longest remote run continuing the chain from ``start``:
        every candidate is fetched concurrently, results are taken in
        chain order up to the first miss, under one batch deadline."""
        todo = list(range(start, min(len(hashes), max_usable)))
        if not todo:
            return []
        futures = [self._io.submit(self._fetch_one, hashes[i]) for i in todo]
        deadline = time.monotonic() + self.get_timeout
        slabs = []
        for fut in futures:
            self.queries += 1
            try:
                slab = fut.result(timeout=max(deadline - time.monotonic(),
                                              0.0))
            except Exception:  # a timeout or a fetch error: a miss
                slab = None
            if slab is None:
                break
            self.hits += 1
            slabs.append(slab)
        for fut in futures[len(slabs):]:
            fut.cancel()  # not yet started: never reaches the network
        return slabs

    def shutdown(self) -> None:
        self._io.shutdown(wait=False)


@dataclasses.dataclass
class PrefetchJob:
    """One in-flight tier fetch for an admitted sequence. The engine
    commits it only while the sequence is still PREFETCHING and still owns
    the blocks it held at submit (an abort may have freed and reassigned
    them)."""

    request_id: str
    start_block: int
    block_snapshot: tuple  # seq.block_ids at submit
    future: "concurrent.futures.Future"  # -> (slabs, host_n, remote_n)
    submit_time: float


class KVPrefetcher:
    """The tier lookup pipeline (host first, then remote) on its own
    threads: the serving thread submits at admission and commits finished
    jobs at the top of ``step()``."""

    def __init__(self, host_kv: Optional[HostKVStore],
                 remote_kv: Optional[RemoteKVClient],
                 block_size: int, workers: int = 2):
        self.host_kv = host_kv
        self.remote_kv = remote_kv
        self.block_size = block_size
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(workers, 1), thread_name_prefix="kv-prefetch")
        self.jobs: list[PrefetchJob] = []
        self.submitted = 0
        self.committed = 0
        self.dropped = 0  # aborted or superseded in flight: discarded

    def _lookup(self, token_ids: list[int], start_block: int,
                root: int) -> tuple[list, int, int]:
        """On a pool thread: the longest tier run continuing the chain."""
        slabs = []
        cursor = start_block
        host_n = remote_n = 0
        if self.host_kv is not None:
            h_slabs, host_n = self.host_kv.match_extension(token_ids, cursor,
                                                           root)
            slabs.extend(h_slabs)
            cursor += host_n
        max_usable = max((len(token_ids) - 1) // self.block_size, 0)
        if self.remote_kv is not None and cursor < max_usable:
            hashes = chain_hashes(token_ids, self.block_size, root)
            r_slabs = self.remote_kv.match_extension(hashes, cursor,
                                                     max_usable)
            slabs.extend(r_slabs)
            remote_n = len(r_slabs)
        return slabs, host_n, remote_n

    def submit(self, seq) -> Optional[PrefetchJob]:
        """Start a lookup for a just-admitted sequence; the job (the caller
        parks the sequence in PREFETCHING), or None when the pool already
        covers every block a tier could add."""
        bs = self.block_size
        if seq.num_computed_tokens % bs:
            return None
        start_block = seq.num_computed_tokens // bs
        max_usable = max((len(seq.token_ids) - 1) // bs, 0)
        if start_block >= max_usable:
            return None
        try:
            fut = self._io.submit(self._lookup, list(seq.token_ids),
                                  start_block, seq.prefix_root)
        except RuntimeError:  # the pool was shut down
            return None
        job = PrefetchJob(seq.request_id, start_block, tuple(seq.block_ids),
                          fut, time.monotonic())
        self.jobs.append(job)
        self.submitted += 1
        return job

    def pop_done(self) -> list[PrefetchJob]:
        """The finished jobs, split from the rest in one pass. (The
        reference tests ``done()`` twice, so a job that finishes between
        the two tests is in neither list and its sequence stays
        PREFETCHING.)"""
        done, running = [], []
        for j in self.jobs:
            (done if j.future.done() else running).append(j)
        self.jobs = running
        return done

    def wait_any(self, timeout: float) -> None:
        """A bounded wait for an in-flight job, called only when nothing
        else is runnable."""
        if self.jobs:
            concurrent.futures.wait(
                [j.future for j in self.jobs], timeout=timeout,
                return_when=concurrent.futures.FIRST_COMPLETED)

    def shutdown(self) -> None:
        self._io.shutdown(wait=False)


def maybe_make_store(cache_config,
                     bytes_per_block: int = 0) -> Optional[HostKVStore]:
    cap_bytes = cache_config.kv_host_cache_bytes
    if cache_config.host_offload_blocks > 0 or cap_bytes > 0:
        return HostKVStore(cache_config.host_offload_blocks,
                           cache_config.block_size,
                           bytes_per_block=bytes_per_block,
                           capacity_bytes=cap_bytes)
    return None


def maybe_make_remote(cache_config,
                      head_groups: int = 1) -> Optional[RemoteKVClient]:
    if cache_config.remote_kv_url:
        return RemoteKVClient(cache_config.remote_kv_url,
                              cache_config.block_size,
                              head_groups=head_groups)
    return None
