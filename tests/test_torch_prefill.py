"""K4's plain version against the JAX package's prefill kernels on the CPU.

``paged_prefill_attention`` (the port's wrapper, which takes its plain
version for CPU tensors) is held against ``paged_prefill_attention_pallas``
run in interpret mode at the JAX tests' shapes (block size 4, ``q_tile=8``,
``windows=2``), within 2e-5 in float32 (the Pallas kernel sums its softmax
window by window, the plain version over the whole context), on every row:
padding rows past a chunk attend the whole context and inactive chunks
output exact zeros in both. Against the XLA reference ``paged_attention``
it matches on live rows only, since that reference leaves finite garbage on
padding rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops.paged_attention import paged_attention
from production_stack_tpu.ops.paged_attention_pallas import (
    paged_prefill_attention_pallas,
)
from production_stack_tpu_torch.ops import paged_prefill_attention as k4

torch.set_num_threads(2)

BS = 4
KH, D, H = 4, 16, 8
ATOL = 2e-5

# (q_start, chunk_len) per chunk, None = inactive; S is the padded bucket
CASES = [
    # a fresh chunk, a continuation with padding rows, a short chunk and an
    # inactive row, as the engine batches them
    ([(0, 8), (5, 6), (0, 3), None], 8),
    # a continuation past several blocks, an inactive row between active
    # ones, a one-token chunk
    ([(0, 16), (13, 9), None, (0, 1)], 16),
    # every row active, chunks continuing at block boundaries and inside
    ([(8, 8), (4, 2), (17, 5), (0, 7)], 8),
]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(rng, chunks, S, poison=False, scale=1.0):
    """A fused pool whose chunks own distinct blocks (tables 0-padded past
    them; block 0 belongs to no chunk), and the chunks' queries. With
    ``poison``, every never-written slot holds NaN and the in-block tail
    past each context holds inf."""
    P = len(chunks)
    ctx = np.asarray([sum(c) if c else 0 for c in chunks], np.int32)
    q_starts = np.asarray([c[0] if c else -1 for c in chunks], np.int32)
    M = max(-(-int(c) // BS) for c in ctx) + 1
    M = -(-M // 2) * 2  # the Pallas kernel reads whole 2-block windows
    N = P * M + 1
    cache = rng.standard_normal((2, N, BS, 2 * KH, D)).astype(np.float32)
    cache *= scale
    tables = np.zeros((P, M), np.int32)
    nxt = 1
    for p in range(P):
        nb = -(-int(ctx[p]) // BS)
        tables[p, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    if poison:
        written = np.zeros((N, BS), bool)
        tail = np.zeros((N, BS), bool)
        for p in range(P):
            for pos in range(int(ctx[p])):
                written[tables[p, pos // BS], pos % BS] = True
            last = -(-int(ctx[p]) // BS) - 1
            if ctx[p] % BS:
                tail[tables[p, last], ctx[p] % BS:] = True
        cache[1][~written] = np.nan
        cache[1][tail] = np.inf
    q = rng.standard_normal((P, S, H, D)).astype(np.float32) * scale
    return q, cache, tables, q_starts, ctx


def _pallas(q, cache, tables, q_starts, ctx, soft_cap=0.0):
    return np.asarray(paged_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(tables),
        jnp.asarray(q_starts), jnp.asarray(ctx), 1, q_tile=8, windows=2,
        interpret=True, soft_cap=soft_cap))


def _port(q, cache, tables, q_starts, ctx, soft_cap=0.0):
    return k4.paged_prefill_attention(t(q), t(cache), t(tables), t(q_starts),
                                      t(ctx), 1, soft_cap=soft_cap).numpy()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_prefill_matches_pallas_every_row(case, seed):
    chunks, S = CASES[case]
    args = _case(np.random.default_rng(10 * case + seed), chunks, S)
    k4.LAUNCHES.n = 0
    got = _port(*args)
    assert k4.LAUNCHES.n == 0  # the plain version launches nothing
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _pallas(*args), rtol=0, atol=ATOL)
    inactive = args[4] == 0
    assert (got[inactive] == 0).all()  # inactive chunks: exact zeros


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_prefill_poisoned_tail_blocks_ignored(case, seed):
    """NaN in every never-written slot (the tables' pad block 0 included)
    and inf past each context inside its last block: no row reads them."""
    chunks, S = CASES[case]
    args = _case(np.random.default_rng(100 + 10 * case + seed), chunks, S,
                 poison=True)
    got = _port(*args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _pallas(*args), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", range(2))
def test_prefill_soft_cap_matches_pallas(seed):
    chunks, S = CASES[0]
    args = _case(np.random.default_rng(200 + seed), chunks, S, scale=3.0)
    got = _port(*args, soft_cap=2.0)
    np.testing.assert_allclose(got, _pallas(*args, soft_cap=2.0), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_prefill_matches_xla_reference_on_live_rows(case):
    chunks, S = CASES[case]
    q, cache, tables, q_starts, ctx = _case(np.random.default_rng(300 + case),
                                            chunks, S)
    got = _port(q, cache, tables, q_starts, ctx)
    positions = np.full((len(chunks), S), -1, np.int32)
    for p, c in enumerate(chunks):
        if c:
            positions[p, :c[1]] = np.arange(c[0], c[0] + c[1])
    want = np.asarray(paged_attention(
        jnp.asarray(q), jnp.asarray(cache[1]), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(positions)))
    live = positions >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)
