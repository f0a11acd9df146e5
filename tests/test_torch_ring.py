"""Ring attention (parallel/ring_attention.py) against the reference's
``ring_causal_attention`` (production_stack_tpu/parallel/ring_attention.py)
and against itself across processes.

- The plain ring (``ring_causal_attention_plain``, every rank's shard in
  one process) equals the reference's within 2e-5 on the same numpy
  inputs: seq 4 x tensor 2 as ``tests/test_ring_attention.py`` runs it,
  with the heads sharded over ``tensor`` too, seq 1, a soft cap, grouped
  queries, and the queries in small tiles.
- The ring run by 2 and 4 CPU processes over gloo (``_torch_ring``, seq
  ranks of a ``RankGroup``) equals the plain ring within 1e-6, and rank
  0's wire counts are the bytes it sent: n - 1 rotations of its K/V
  shard.
- A query tile's float32 scores stay under ``ATTN_SCORE_BYTES`` at
  llama-3-8b's widths and an 8K prompt over 2 ranks, so a rank never
  holds a whole Sl x Sl block per head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ring import run_ring
from _torch_tp import rank_limit
from production_stack_tpu.engine.jax_compat import set_mesh
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu.parallel.ring_attention import (
    ring_causal_attention,
)
from production_stack_tpu_torch.parallel.ring_attention import (
    ATTN_SCORE_BYTES,
    q_tile,
    ring_causal_attention_plain,
    ring_length,
)

TOL = 2e-5


def _qkv(seed: int, B: int, S: int, H: int, KH: int, D: int) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))


def _reference(q, k, v, seq: int, tensor: int, head_axis, soft_cap: float):
    mesh = build_mesh(MeshConfig(data=1, seq=seq, tensor=tensor))
    with set_mesh(mesh):
        got = jax.jit(lambda q, k, v: ring_causal_attention(
            q, k, v, mesh, "seq", head_axis=head_axis,
            soft_cap=soft_cap))(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    return np.asarray(got)


def _plain(q, k, v, n: int, soft_cap: float = 0.0, tile=None):
    return ring_causal_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n,
        soft_cap, tile).numpy()


# (seq, tensor, head_axis, soft cap, (B, S, H, KH, D), query tile)
CASES = {
    "seq4-tp2": (4, 2, None, 0.0, (2, 32, 4, 2, 16), None),
    "seq4-tp2-heads": (4, 2, "tensor", 0.0, (2, 32, 4, 2, 16), None),
    "seq1": (1, 1, None, 0.0, (1, 8, 4, 2, 8), None),
    "softcap": (4, 1, None, 2.0, (1, 32, 4, 2, 16), None),
    "seq2-gqa4": (2, 1, None, 0.0, (1, 48, 8, 2, 32), None),
    "tiles": (4, 2, None, 2.0, (2, 32, 4, 2, 16), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_ring_matches_the_reference(case):
    seq, tensor, head_axis, cap, shape, tile = CASES[case]
    q, k, v = _qkv(0, *shape)
    want = _reference(q, k, v, seq, tensor, head_axis, cap)
    got = _plain(q, k, v, seq, cap, tile)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_plain_ring_refuses_an_uneven_split():
    q, k, v = _qkv(1, 1, 30, 4, 2, 8)
    with pytest.raises(ValueError, match="multiple"):
        _plain(q, k, v, 4)


@pytest.mark.parametrize("n,cap", [(2, 0.0), (4, 0.0), (4, 2.0)],
                         ids=["seq2", "seq4", "seq4-softcap"])
def test_gloo_ring_equals_the_plain_ring(n, cap):
    B, S, H, KH, D = 2, 32, 4, 2, 16
    q, k, v = _qkv(2, B, S, H, KH, D)
    with rank_limit(90):
        got, wire = run_ring(n, q, k, v, cap)
    np.testing.assert_allclose(got, _plain(q, k, v, n, cap), rtol=0,
                               atol=1e-6)
    # K and V of one shard (float32) to the next rank, n - 1 times
    shard = 2 * B * (S // n) * KH * D * 4
    assert wire == {"ring_rotate": (n - 1) * shard}


def test_query_tiles_bound_the_scores_at_llama_3_8b():
    """An 8K prompt over 2 seq ranks at 32 heads: Sl = 4096, a whole
    block's float32 scores would be 2.15 GB."""
    B, H, Sl = 1, 32, ring_length(8000, 2) // 2
    assert Sl == 4096
    t = q_tile(B, H, Sl)
    assert t < Sl
    assert B * H * t * Sl * 4 <= ATTN_SCORE_BYTES < B * H * Sl * Sl * 4


@pytest.mark.parametrize("n,ranks,want", [
    (45, 4, 64), (45, 2, 64), (5, 4, 8), (3, 4, 8), (9, 3, 18),
    (4500, 2, 8192), (8000, 2, 8192), (8192, 2, 8192), (4096, 2, 4096)])
def test_ring_length_pads_as_the_reference(n, ranks, want):
    """The reference's ``_run_prefill_ring``: the next power of two, at
    least two tokens a rank, then a multiple of the ranks."""
    assert ring_length(n, ranks) == want
