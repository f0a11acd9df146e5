"""Helper of the ring attention tests (``test_torch_ring``): the ring run
by ``n`` CPU processes over gloo, as the engine's seq ranks run it.

This process is rank 0 and spawns the others (``ring_follower``, a
function of this module so that a spawned process can import it). Each
rank joins a ``RankGroup`` on the seq axis, runs
``parallel/ring_attention.ring_attention`` on its shard of the same
inputs, and sends its output to rank 0 over the control group.
"""

import multiprocessing

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
