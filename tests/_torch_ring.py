"""Helpers of the ring tests.

- ``run_ring`` (``test_torch_ring``): the ring run by ``n`` CPU processes
  over gloo, as the engine's seq ranks run it. This process is rank 0 and
  spawns the others (``ring_follower``, a function of this module so that
  a spawned process can import it). Each rank joins a ``RankGroup`` on
  the seq axis, runs ``parallel/ring_attention.ring_attention`` on its
  shard of the same inputs, and sends its output to rank 0 over the
  control group.
- The serving tests' (``test_torch_ring_serving``, ``test_torch_ring_tp``)
  spy on a runner's ring calls, one request served to its end, and the
  HTTP and port helpers of their servers.
"""

import json
import multiprocessing
import socket
import urllib.error
import urllib.request

import numpy as np
import torch

from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel.mesh import AXIS_SEQ
from production_stack_tpu_torch.parallel.ring_attention import ring_attention


def _shard(x: np.ndarray, r: int, n: int) -> torch.Tensor:
    Sl = x.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(x[:, r * Sl:(r + 1) * Sl]))


def _ring(ranks, q, k, v, soft_cap) -> np.ndarray:
    r, n = ranks.rank, ranks.size
    return ring_attention(_shard(q, r, n), _shard(k, r, n), _shard(v, r, n),
                          ranks, soft_cap).numpy()


def ring_follower(rank: int, n: int, port: int, q, k, v,
                  soft_cap: float) -> None:
    torch.set_num_threads(1)
    ranks = pdist.init_rank(rank, n, port, ["cpu"] * n, "gloo",
                            axis=AXIS_SEQ)
    try:
        ranks.gather(_ring(ranks, q, k, v, soft_cap))
    finally:
        ranks.close()


def run_ring(n: int, q: np.ndarray, k: np.ndarray, v: np.ndarray,
             soft_cap: float = 0.0) -> tuple:
    """The ring over ``n`` processes: (the ranks' outputs joined along
    the sequence, rank 0's ``RankGroup.wire``). Run it under
    ``_torch_tp.rank_limit``, which kills the followers of a hung ring."""
    store = pdist.open_store(n)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ring_follower, daemon=True,
                         args=(r, n, store.port, q, k, v, soft_cap))
             for r in range(1, n)]
    for p in procs:
        p.start()
    pdist.await_ranks(store, procs)
    ranks = pdist.init_rank(0, n, store.port, ["cpu"] * n, "gloo",
                            store=store, axis=AXIS_SEQ)
    try:
        outs = ranks.gather(_ring(ranks, q, k, v, soft_cap))
        wire = dict(ranks.wire)
    finally:
        ranks.close()
    for p in procs:
        p.join(10)
    return np.concatenate(outs, axis=1), wire


def spy_lengths(runner) -> list:
    """Record the padded length of each ``prefill_ring`` call on
    ``runner`` (a JAX runner or the port's rank 0)."""
    lengths = []
    inner = runner.prefill_ring

    def spy(tokens, *args, **kwargs):
        lengths.append(int(tokens.shape[1]))
        return inner(tokens, *args, **kwargs)

    runner.prefill_ring = spy
    return lengths


def serve_one(eng, prompt, sp, adapter=0, rid="r0") -> tuple:
    """Serve one request to its end: (tokens, the largest cached count
    its outputs reported)."""
    eng.add_request(rid, prompt_token_ids=prompt, sampling=sp,
                    adapter_slot=adapter)
    toks, cached = [], 0
    while eng.has_unfinished():
        for o in eng.step():
            toks.extend(o.new_token_ids)
            cached = max(cached, o.num_cached_tokens)
    return toks, cached


def http(base, path, body=None):
    """(status, raw body) of a GET, or of a POST of ``body``."""
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
