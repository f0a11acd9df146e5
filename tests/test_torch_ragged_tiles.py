"""K2's work map and K3's split-KV plan, on the CPU.

``ragged_work_map`` (ops/ragged_paged_attention.py) is the host side of the
bf16 K2 launch ``csrc/ragged_paged_attention.cu`` makes: spans of two or
more tokens are cut into row tiles of (token, g) rows that never cross a
span, one-token spans are decode items of the split-KV walk, and the tail
past the last span is cut into tiles that write zeros. ``split_plan``
(ops/paged_decode_attention.py) fixes the split-KV walk's (n_splits,
span) once a step. These tests hold, at every preset the paged engine
serves:

- the work map covers every (token, g) row of the stream exactly once;
- the split plan covers [0, ctx) of every sequence exactly once, for every
  context a multi-step decode reaches after the plan is made;
- split-KV itself, emulated in plain PyTorch (partials per split, then the
  log-sum-exp merge the kernels do, splits wholly past a context
  included), equals ``paged_decode_attention_plain`` and the JAX
  reference's ``paged_attention`` within 1e-5 in float32;
- every preset's CTAs fit Hopper's 227 KB of shared memory at the default
  tiles, and the constants the Python side uses are the CUDA source's.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from production_stack_tpu_torch.engine import model_runner
from production_stack_tpu_torch.engine.config import (
    MODEL_PRESETS,
    CacheConfig,
    EngineConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops import paged_decode_attention as k3
from production_stack_tpu_torch.ops import paged_prefill_attention as k4
from production_stack_tpu_torch.ops import ragged_paged_attention as k2
from production_stack_tpu_torch.ops.paged_attention import split_kv

torch.set_num_threads(2)

CSRC = Path(_build.CSRC)
# the presets whose attention runs the paged kernels (Whisper's run none)
PAGED_PRESETS = sorted(n for n, c in MODEL_PRESETS.items()
                       if c.architecture != "whisper")
LOG2E = 1.4426950408889634


def _stream(rng, S, T_extra):
    """Random span offsets and contexts over S slots: empty slots,
    one-token spans (decode rows and a one-token prefill), short and long
    prefill spans, fresh and continued; then 0 .. T_extra tail rows."""
    q_lens, ctx = np.zeros(S, np.int64), np.zeros(S, np.int64)
    for s in range(S):
        kind = rng.integers(0, 5)
        if kind == 1:
            q_lens[s], ctx[s] = 1, rng.integers(1, 3000)
        elif kind == 2:
            q_lens[s] = rng.integers(2, 9)
            ctx[s] = q_lens[s] + rng.integers(0, 500)
        elif kind >= 3:
            q_lens[s] = rng.integers(9, 700)
            ctx[s] = q_lens[s] + rng.integers(0, 2) * rng.integers(1, 900)
    q_lens[0], ctx[0] = 1, 1  # a one-token prefill
    cu = np.concatenate([[0], np.cumsum(q_lens)])
    return cu, ctx, int(cu[-1] + rng.integers(0, T_extra + 1))


def _decode(work_map):
    """(tiles (n, 2), decode slots) of a bf16 work map."""
    w = work_map.work.numpy()
    n = work_map.n_tiles
    return w[:2 * n].reshape(n, 2), w[2 * n:]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("preset", PAGED_PRESETS)
def test_work_map_covers_every_row_once(preset, seed):
    cfg = MODEL_PRESETS[preset]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KH
    rng = np.random.default_rng(seed)
    cu, ctx, T = _stream(rng, 24, 40)
    wm = k2.ragged_work_map(cu, ctx, T, H, KH, D, torch.bfloat16, "cpu")
    rows, _ = wm.tile
    assert wm.tile == k4.DEFAULT_TILE[D] and (wm.T, wm.G) == (T, G)
    tiles, decode = _decode(wm)
    q_lens = np.diff(cu)
    seen = np.zeros((T, G), np.int64)
    for s, r0 in tiles:
        assert r0 % rows == 0
        if s < 0:  # a tile of the tail: rows of no span, written as zeros
            tok0, n = cu[-1], (T - cu[-1]) * G
        else:  # a prefill tile stays inside its span
            assert q_lens[s] >= 2
            tok0, n = cu[s], q_lens[s] * G
        assert 0 <= r0 < n
        for r in range(r0, min(r0 + rows, n)):
            seen[tok0 + r // G, r % G] += 1
    for s in decode:  # a decode item: the G heads of its one token
        seen[cu[s]] += 1
    assert (seen == 1).all()
    # exactly the one-token spans are decode items; empty spans get nothing
    assert sorted(decode) == list(np.flatnonzero(q_lens == 1))
    assert not set(np.flatnonzero(q_lens == 0)) & set(tiles[:, 0])
    n_splits, span = wm.plan
    assert n_splits * span >= ctx[decode].max()
    assert wm.n_decode == len(decode)


@pytest.mark.parametrize("tile", [(64, 32), (128, 128)])
def test_work_map_takes_every_built_tile_and_split_span(tile):
    cu, ctx = np.array([0, 300, 301, 301, 330]), np.array([300, 900, 0, 40])
    wm = k2.ragged_work_map(cu, ctx, 400, 32, 8, 128, torch.bfloat16, "cpu",
                            tile=tile, split_span=128)
    tiles, decode = _decode(wm)
    assert wm.tile == tile and wm.plan == (math.ceil(900 / 128), 128)
    assert list(decode) == [1]
    # 300 and 29 tokens of 4 rows each, then 70 tail tokens
    n = [math.ceil(300 * 4 / tile[0]), math.ceil(29 * 4 / tile[0]),
         math.ceil(70 * 4 / tile[0])]
    assert list(tiles[:, 0]) == [0] * n[0] + [3] * n[1] + [-1] * n[2]


@pytest.mark.parametrize("tile,span", [((32, 64), None), ((64, 48), None),
                                       (None, 100), (None, 0)])
def test_work_map_refuses_unbuilt_tiles_and_spans(tile, span):
    with pytest.raises(ValueError):
        k2.ragged_work_map([0, 5, 6], [5, 9], 8, 32, 8, 128, torch.bfloat16,
                           "cpu", tile=tile, split_span=span)


def test_float32_work_map_is_tile_metadata():
    """float32 keeps the CUDA-core walk over tiles of Q_TILE tokens."""
    cu = np.asarray([0, 5, 5, 6, 13, 14], np.int32)
    wm = k2.ragged_work_map(cu, [9, 0, 13, 7, 1], 20, 4, 2, 32, torch.float32,
                            "cpu")
    first, count = k2.tile_metadata(torch.from_numpy(cu), 5, k2.Q_TILE)
    assert wm.tile == (k2.Q_TILE, k4.WALK_POSITIONS) and wm.n_tiles == 5
    assert wm.work.tolist() == torch.stack([first, count], 1).flatten().tolist()


def _splits(ctx, plan):
    """The positions each split walks, as csrc/split_decode.cuh computes
    them: split i covers [i * span, min((i + 1) * span, ctx))."""
    n_splits, span = plan
    return [(i * span, min((i + 1) * span, ctx)) for i in range(n_splits)]


def test_split_rule_is_the_kernels():
    src = (CSRC / "split_decode.cuh").read_text()
    assert "const int p0 = split * span;" in src
    assert "const int p1 = min(ctx, p0 + span);" in src


@pytest.mark.parametrize("multi_step", [1, 4, 8])
@pytest.mark.parametrize("ctx_at_plan,n_items,span", [
    (0, 0, None), (1, 64, None), (150, 64, None), (2047, 56, None),
    (8192, 4, None), (8000, 1, None), (300, 3, 256), (1000, 8, 64)])
def test_split_plan_covers_every_context_once(ctx_at_plan, n_items, span,
                                              multi_step):
    """The runner plans for its step's largest context plus multi_step, and
    the contexts then grow on the device: every length up to there is
    covered once, splits past a context walk nothing."""
    plan = k3.split_plan(ctx_at_plan + multi_step, n_items, 8, span)
    n_splits, got_span = plan
    assert got_span % k3.SPAN_GRANULE == 0 and n_splits >= 1
    if span is None:
        assert got_span >= k3.MIN_SPAN
    for ctx in range(ctx_at_plan + multi_step + 1):
        covered = [p for p0, p1 in _splits(ctx, plan) for p in range(p0, p1)]
        assert covered == list(range(ctx))


@pytest.mark.parametrize("max_ctx,n_items,KH,want", [
    (8192, 4, 8, (8, 1024)),   # a few long contexts: one wave of 256 CTAs
    (8192, 1, 8, (32, 256)),
    (100, 1, 8, (1, 256)),     # no split shorter than MIN_SPAN
    (2048, 64, 8, (4, 512)),   # a wave already: splits of BALANCE_SPAN
    (170, 64, 8, (1, 256)),    # short contexts: one split, no merge
    (0, 0, 8, (1, 256)),
])
def test_split_plan_default(max_ctx, n_items, KH, want):
    """A few long contexts are split until their CTAs fill one wave
    (TARGET_CTAS) and no more; a batch whose unsplit CTAs fill a wave
    splits its long contexts at BALANCE_SPAN."""
    n_splits, span = k3.split_plan(max_ctx, n_items, KH)
    assert (n_splits, span) == want
    if n_items * KH < k3.TARGET_CTAS and max_ctx > k3.MIN_SPAN:
        assert n_items * KH * n_splits <= k3.TARGET_CTAS


def _emulate_split_kv(q, pool, tables, lens, layer, plan, soft_cap=0.0):
    """Split-KV decode in plain PyTorch, as the kernels do it: each split's
    float32 partial (m in log2 units, l, acc) over its positions, then the
    log-sum-exp merge. A split wholly past its context leaves m = -inf and
    an acc that holds NaN, which the merge must never read."""
    B, H, D = q.shape
    _, _, bs, KH2, _ = pool.shape
    KH = KH2 // 2
    G = H // KH
    n_splits, _ = plan
    m = torch.full((B, H, n_splits), -math.inf, dtype=torch.float64)
    l = torch.zeros((B, H, n_splits), dtype=torch.float64)
    acc = torch.full((B, H, n_splits, D), math.nan, dtype=torch.float64)
    for b, ctx in enumerate(lens):
        for i, (p0, p1) in enumerate(_splits(int(ctx), plan)):
            if p0 >= p1:
                continue
            pos = torch.arange(p0, p1)
            slab = pool[layer][tables[b, pos // bs].long(), pos % bs]
            k, v = (x.double() for x in split_kv(slab))  # (n, KH, D)
            s = torch.einsum("kgd,nkd->kgn", q[b].reshape(KH, G, D).double(),
                             k) * D ** -0.5
            if soft_cap:
                s = soft_cap * torch.tanh(s / soft_cap)
            s = (s * LOG2E).reshape(H, -1)
            m[b, :, i] = s.max(-1).values
            p = torch.exp2(s - m[b, :, i, None])
            l[b, :, i] = p.sum(-1)
            acc[b, :, i] = torch.einsum(
                "kgn,nkd->kgd", p.reshape(KH, G, -1), v).reshape(H, D)
    top = m.max(-1, keepdim=True).values
    live = m > -math.inf
    w = torch.where(live, torch.exp2(m - torch.where(live, top, 0.0)), 0.0)
    num = torch.where(live[..., None], acc * w[..., None], 0.0).sum(2)
    den = (l * w).sum(2)
    out = torch.where(den[..., None] > 0, num / den.clamp_min(1e-300)[..., None],
                      0.0)
    return out.float()


@pytest.mark.parametrize("lens,plan,soft_cap", [
    ([0, 5, 300, 1000], (4, 256), 0.0),
    ([1, 64, 65, 200], (7, 64), 0.0),     # splits wholly past every context
    ([700], (6, 128), 0.0),
    ([17, 0, 255, 256, 257], (2, 256), 0.0),
    ([33, 500], (9, 64), 5.0),
    ([129, 3], (1, 256), 5.0),             # one split: no merge
])
def test_split_kv_matches_plain_and_reference(lens, plan, soft_cap):
    rng = np.random.default_rng(sum(lens))
    H, KH, D, bs, M = 8, 2, 16, 4, 256
    B, N = len(lens), len(lens) * M
    cache = rng.standard_normal((2, N, bs, 2 * KH, D)).astype(np.float32)
    tables = np.arange(N, dtype=np.int32).reshape(B, M)
    for b, c in enumerate(lens):  # NaN past every context
        flat = cache[1, tables[b]].reshape(M * bs, 2 * KH, D)
        flat[c:] = np.nan
        cache[1, tables[b]] = flat.reshape(M, bs, 2 * KH, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    t = torch.from_numpy
    got = _emulate_split_kv(t(q), t(cache), t(tables), lens, 1, plan,
                            soft_cap)
    assert torch.isfinite(got).all()
    ctx = t(np.asarray(lens, np.int32))
    plain = k3.paged_decode_attention_plain(t(q), t(cache), t(tables), ctx,
                                            1, soft_cap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    live = np.asarray(lens) > 0
    assert (got.numpy()[~live] == 0).all()
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q[:, None]), jnp.asarray(np.nan_to_num(cache[1])),
        jnp.asarray(tables), jnp.asarray(np.asarray(lens, np.int32)),
        jnp.asarray(np.asarray(lens, np.int32)[:, None] - 1),
        soft_cap=soft_cap))[:, 0]
    np.testing.assert_allclose(got.numpy()[live], ref[live], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("preset", PAGED_PRESETS)
def test_default_tiles_fit_shared_memory(preset):
    """bf16 K2's row tile (K4's geometry) and the split-KV walk of K2 and K3
    at every preset's head geometry: within 227 KB a CTA, one m16 tile of
    query heads a KV head, and a split span that is whole stages."""
    cfg = MODEL_PRESETS[preset]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tile = k4.launch_geometry(1, 40, H, KH, D, torch.bfloat16)
    assert tile["smem_bytes"] <= k4.SMEM_LIMIT
    geo = k3.decode_geometry(D)
    assert geo["smem_bytes"] <= k4.SMEM_LIMIT
    assert H // KH <= k3.MAX_GROUP
    assert k3.SPAN_GRANULE % geo["positions"] == 0
    assert k3.MIN_SPAN % k3.SPAN_GRANULE == 0
    if D == 128:  # two CTAs an SM, as TARGET_CTAS assumes
        assert 2 * (geo["smem_bytes"] + 1024) <= 228 * 1024


def test_decode_geometry_matches_the_cuda_source():
    src = (CSRC / "split_decode.cuh").read_text()
    assert re.search(rf"constexpr int kMaxGroup = {k3.MAX_GROUP};", src)
    assert re.search(rf"constexpr int kStages = {k3.STAGES};", src)
    assert "kWarps = D <= 128 ? 4 : 2;" in src
    assert "kPositions = 16 * kWarps;" in src
    assert "(16 * kStride + 2 * kStageElems) * sizeof(__nv_bfloat16)" in src
    for D in _build.HEAD_DIMS:
        warps = 4 if D <= 128 else 2
        assert k3.decode_geometry(D)["positions"] == 16 * warps
        assert k3.decode_geometry(D)["threads"] == 32 * warps


@pytest.mark.parametrize("multi_step", [1, 4])
def test_runner_makes_its_work_map_and_plan_once_a_step(monkeypatch,
                                                        multi_step):
    """ragged_step makes one work map a step, decode_multi one split plan a
    step (at the plan ladder's rung that holds the step's contexts plus
    multi_step), whatever the layer count."""
    calls = {"map": 0, "plan": []}
    make_map, make_plan = model_runner.ragged_work_map, model_runner.split_plan

    def counted_map(*a, **kw):
        calls["map"] += 1
        return make_map(*a, **kw)

    def counted_plan(max_ctx, *a, **kw):
        calls["plan"].append(max_ctx)
        return make_plan(max_ctx, *a, **kw)

    monkeypatch.setattr(model_runner, "ragged_work_map", counted_map)
    monkeypatch.setattr(model_runner, "split_plan", counted_plan)
    cfg = EngineConfig.for_model(
        "tiny-llama", cache=CacheConfig(block_size=16, num_blocks=64),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32,
                                  multi_step=multi_step))
    eng = LLMEngine(cfg, device="cpu")
    eng.generate([[1, 2, 3], list(range(40))],
                 SamplingParams(temperature=0.0, max_tokens=9,
                                ignore_eos=True))
    assert calls["map"] == eng.ragged_dispatches > 0
    assert len(calls["plan"]) == eng.decode_dispatches > 0
    assert all(c > multi_step for c in calls["plan"])
    assert set(calls["plan"]) <= set(eng.runner.decode_rungs)
