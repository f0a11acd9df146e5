"""The port's CUDA kernels and kernel path on the card (marker ``cuda``).

These skip without a card. On a machine with one, run them without the
suite's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same card inputs:
float32 within 1e-5 (sums in another order); bf16 K1 bit for bit. bf16 K2,
K3 and K4 run on the tensor cores: both versions accumulate in float32 and
round the output once (one bf16 rounding step, rtol 2^-7, atol 1e-5), and
the kernels also round P to bf16 before P V, which moves an output by up
to 2^-8 of the softmax-weighted mean of |V|. They are held to ``|got -
plain| <= atol + rtol |plain| + 2^-8 plain(|V|)``, where plain(|V|) is the
plain version on the same inputs with V replaced by its absolute value.
``chip_smoke.py`` does the same at the llama-3-8b serving shapes.
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops import kv_write as k1
from production_stack_tpu_torch.ops import paged_decode_attention as k3
from production_stack_tpu_torch.ops import paged_prefill_attention as k4
from production_stack_tpu_torch.ops import ragged_paged_attention as k2

pytestmark = pytest.mark.cuda

BS = 16
F32_TOL = (1e-5, 1e-5)
BF16_TOL = (1e-5, 2.0 ** -7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); the plain versions are tested on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dtype, H=8, KH=2, D=128, S=6, M=8):
    """A NaN-poisoned pool and a mixed stream: a chunk, decode rows, an
    empty slot and tail padding."""
    g = torch.Generator().manual_seed(0)
    spans = {0: (20, 37), 1: (1, 90), 3: (1, 1), 4: (5, 5), 5: (1, 128)}
    N = 64
    pool = torch.full((2, N, BS, 2 * KH, D), float("nan"), dtype=dtype)
    tables = torch.zeros((S, M), dtype=torch.int32)
    ctx = torch.zeros(S, dtype=torch.int32)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    nxt = 0
    for s in range(S):
        q_len, c = spans.get(s, (0, 0))
        nb = -(-c // BS)
        tables[s, :nb] = torch.arange(nxt, nxt + nb)
        nxt += nb
        ctx[s] = c
        cu[s + 1] = cu[s] + q_len
        for p in range(c):
            pool[1, tables[s, p // BS], p % BS] = torch.randn(
                (2 * KH, D), generator=g).to(dtype)
    T = int(cu[-1]) + 7
    q = torch.randn((T, H, D), generator=g).to(dtype)
    return pool, tables, cu, ctx, q


def _prefill_case(dtype, H=8, KH=2, D=128, S=40, M=8, chunks=None):
    """A NaN-poisoned pool and a batch of chunks padded to S, by default
    four: a fresh chunk, a continuation at q_start 37, a chunk 13 tokens
    short of the bucket (padding rows) and an inactive row (ctx 0, q_start
    -1)."""
    g = torch.Generator().manual_seed(1)
    chunks = chunks or [(0, S), (37, S), (0, S - 13), None]
    P, N = len(chunks), 64
    pool = torch.full((2, N, BS, 2 * KH, D), float("nan"), dtype=dtype)
    tables = torch.zeros((P, M), dtype=torch.int32)
    q_starts = torch.full((P,), -1, dtype=torch.int32)
    ctx = torch.zeros(P, dtype=torch.int32)
    nxt = 0
    for p, chunk in enumerate(chunks):
        if chunk is None:
            continue
        q_starts[p], ctx[p] = chunk[0], sum(chunk)
        nb = -(-int(ctx[p]) // BS)
        tables[p, :nb] = torch.arange(nxt, nxt + nb)
        nxt += nb
        for pos in range(int(ctx[p])):
            pool[1, tables[p, pos // BS], pos % BS] = torch.randn(
                (2 * KH, D), generator=g).to(dtype)
    q = torch.randn((P, S, H, D), generator=g).to(dtype)
    return pool, tables, q_starts, ctx, q


def _assert_p_rounded_close(got, want, tol, plain, args, soft_cap):
    """float32: within ``tol``; bf16: within ``tol`` plus 2^-8 of the plain
    version ``plain`` run on ``args`` with |V| (P is rounded to bf16 before
    P V)."""
    atol, rtol = tol
    got_f, want_f = got.float(), want.float()
    assert torch.isfinite(got_f).all()  # padding rows included
    limit = atol + rtol * want_f.abs()
    if got.dtype == torch.bfloat16:
        q, pool, *rest = args
        KH = pool.shape[3] // 2
        abs_v = pool.clone()
        abs_v[:, :, :, KH:] = abs_v[:, :, :, KH:].abs()
        mean_abs_v = plain(q, abs_v, *rest, soft_cap=soft_cap)
        limit = limit + 2.0 ** -8 * mean_abs_v.float()
    err = (got_f - want_f).abs()
    assert (err <= limit).all(), (
        f"{int((err > limit).sum())} elements off; worst "
        f"{float((err / limit).max()):.3f} of its limit")


def _assert_prefill_close(got, want, tol, args, soft_cap):
    _assert_p_rounded_close(got, want, tol, k4.paged_prefill_attention_plain,
                            args, soft_cap)


def _tiles(dtype, G, D):
    """Every tile a test runs besides the default: each bf16 tile built for
    D, and the float32 walk at 2, 16 and 32 tokens a CTA and at 7 rows
    (rows that cross token boundaries)."""
    if dtype == torch.bfloat16:
        return [t for t in k4.TILES[D] if t != k4.DEFAULT_TILE[D]]
    return [(r, k4.WALK_POSITIONS) for r in (2 * G, 16 * G, 32 * G, 7)]


def _check_prefill(cuda, dtype, tol, soft_cap=0.0, **geometry):
    case = [x.to(cuda) for x in _prefill_case(dtype, **geometry)]
    pool, tables, q_starts, ctx, q = case
    args = (q, pool, tables, q_starts, ctx, 1)
    n = k4.LAUNCHES.n
    got = k4.paged_prefill_attention(*args, soft_cap=soft_cap)
    assert k4.LAUNCHES.n == n + 1
    want = k4.paged_prefill_attention_plain(*args, soft_cap=soft_cap)
    _assert_prefill_close(got, want, tol, args, soft_cap)
    assert (got[ctx == 0] == 0).all()
    G = q.shape[2] // (pool.shape[3] // 2)
    for tile in _tiles(dtype, G, q.shape[3]):  # the output is the same
        other = k4.paged_prefill_attention(*args, soft_cap=soft_cap,
                                           tile=tile)
        _assert_prefill_close(other, want, tol, args, soft_cap)
        assert (other[ctx == 0] == 0).all()


@pytest.mark.parametrize("soft_cap", [0.0, 50.0])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("D", [32, 48, 64, 96, 128, 256])
def test_tensor_core_prefill_matches_plain(cuda, D, G, soft_cap):
    """bf16 K4 (the tensor-core kernel) at every built head dim and tile,
    at the GQA groups of the presets, on a bucket of 40 that no tile's rows
    divide (S * G rows): a fresh chunk, a continuation at q_start 37, a
    chunk 13 tokens short of the bucket (padding rows), an inactive row, a
    continuation at q_start 150 reaching across several staged tiles, and
    a one-token chunk; unwritten blocks hold NaN."""
    S = 40
    chunks = [(0, S), (37, S), (0, S - 13), None, (150, 25), (0, 1)]
    _check_prefill(cuda, torch.bfloat16, BF16_TOL, soft_cap=soft_cap,
                   H=2 * G, KH=2, D=D, S=S, M=16, chunks=chunks)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_prefill_kernel_matches_plain(cuda, dtype, tol):
    _check_prefill(cuda, dtype, tol, D=32 if dtype == torch.float32 else 128)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("D", [48, 96, 256])
def test_every_preset_head_dim(cuda, D, dtype, tol):
    """K2, K3 and K4 at the head dims of tiny-gemma (48), phi3-mini-class
    (96) and the Gemma classes (256), at G = 2 with Gemma-2's soft cap."""
    pool, tables, cu, ctx, q = (x.to(cuda) for x in _case(dtype, H=4, KH=2,
                                                          D=D))
    args = (q, pool, tables, cu, ctx, 1)
    got = k2.ragged_paged_attention(*args, soft_cap=50.0)
    want = k2.ragged_paged_attention_plain(*args, soft_cap=50.0)
    _assert_p_rounded_close(got, want, tol, k2.ragged_paged_attention_plain,
                            args, 50.0)
    dq = q[: tables.shape[0]].contiguous()
    dargs = (dq, pool, tables, ctx, 1)
    got = k3.paged_decode_attention(*dargs, soft_cap=50.0)
    want = k3.paged_decode_attention_plain(*dargs, soft_cap=50.0)
    _assert_p_rounded_close(got, want, tol, k3.paged_decode_attention_plain,
                            dargs, 50.0)
    _check_prefill(cuda, dtype, tol, soft_cap=50.0, H=4, KH=2, D=D)


@pytest.mark.parametrize("dtype,D,tol", [(torch.float32, 32, (1e-5, 1e-5)),
                                         (torch.bfloat16, 128,
                                          (1e-5, 2.0 ** -7))])
def test_kernels_match_plain(cuda, dtype, D, tol):
    pool, tables, cu, ctx, q = _case(dtype, D=D)
    dev = [x.to(cuda) for x in (pool, tables, cu, ctx, q)]
    pool_d, tables_d, cu_d, ctx_d, q_d = dev
    T = q.shape[0]
    newkv = torch.randn((T, pool.shape[3], D), device=cuda).to(dtype)
    slots = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    slots[: T - 7] = torch.randperm(pool.shape[1] * BS, device=cuda)[
        : T - 7].to(torch.int32)
    ref = pool_d.clone()
    n = k1.LAUNCHES.n
    k1.kv_write(pool_d, newkv, slots, 1)
    assert k1.LAUNCHES.n == n + 1
    k1.kv_write_plain(ref, newkv, slots, 1)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(pool_d.view(bits), ref.view(bits))

    args = (q_d, pool_d, tables_d, cu_d, ctx_d, 1)
    got = k2.ragged_paged_attention(*args)
    want = k2.ragged_paged_attention_plain(*args)
    _assert_p_rounded_close(got, want, tol, k2.ragged_paged_attention_plain,
                            args, 0.0)
    assert (got[int(cu[-1]):] == 0).all()

    dq = q_d[: tables.shape[0]].contiguous()
    dargs = (dq, pool_d, tables_d, ctx_d, 1)
    got = k3.paged_decode_attention(*dargs)
    want = k3.paged_decode_attention_plain(*dargs)
    _assert_p_rounded_close(got, want, tol, k3.paged_decode_attention_plain,
                            dargs, 0.0)
    assert (got[ctx_d == 0] == 0).all()


def test_wrappers_refuse_bad_input(cuda):
    pool, tables, cu, ctx, q = _case(torch.float32, D=32)
    pool_d, tables_d, cu_d, ctx_d = (x.to(cuda) for x in (pool, tables, cu,
                                                          ctx))
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        k2.ragged_paged_attention(q.to(cuda), pool_d, tables, cu_d, ctx_d, 1)
    with pytest.raises(ValueError):  # a work map made for another stream
        k2.ragged_paged_attention(
            q.to(cuda), pool_d, tables_d, cu_d, ctx_d, 1,
            tiles=k2.ragged_work_map(cu, ctx, q.shape[0] + 8, 8, 2, 32,
                                     torch.float32, cuda))
    with pytest.raises(TypeError):  # int64 index tensors
        k3.paged_decode_attention(q[:6].to(cuda), pool_d, tables_d.long(),
                                  ctx_d, 1)
    with pytest.raises(ValueError):  # non-contiguous query
        k3.paged_decode_attention(q.to(cuda)[:12:2], pool_d, tables_d,
                                  ctx_d, 1)
    with pytest.raises(TypeError):  # dtype mismatch
        k3.paged_decode_attention(q[:6].to(cuda).double(), pool_d, tables_d,
                                  ctx_d, 1)


def test_wrappers_refuse_uninstantiated_head_dim(cuda):
    pool, tables, cu, ctx, q = (x.to(cuda) for x in _case(torch.float32,
                                                          D=80))
    with pytest.raises(ValueError, match="head_dim 80"):
        k2.ragged_paged_attention(q, pool, tables, cu, ctx, 1)
    with pytest.raises(ValueError, match="head_dim 80"):
        k3.paged_decode_attention(q[:6].contiguous(), pool, tables, ctx, 1)
    with pytest.raises(ValueError, match="head_dim 80"):
        k4.paged_prefill_attention(q[None, :8].contiguous(), pool,
                                   tables[:1], ctx[:1], ctx[:1], 1)


def _stream(cuda, dtype, H, KH, D, spans, S, M, tail):
    """A pool on the card whose every unwritten slot is NaN, and a packed
    stream of ``spans`` = {slot: (q_len, ctx)} with ``tail`` rows of no
    span after the last: slots own distinct blocks, tables are 0-padded past
    their live blocks (block 0 belongs to a slot), and each slot's
    positions below its context hold random values."""
    g = torch.Generator(device=cuda).manual_seed(0)
    N = sum(-(-c // BS) for _, c in spans.values()) + 4
    pool = torch.full((2, N, BS, 2 * KH, D), float("nan"), dtype=dtype,
                      device=cuda)
    tables = torch.zeros((S, M), dtype=torch.int32)
    ctx = torch.zeros(S, dtype=torch.int32)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    written, nxt = [], 0
    for s in range(S):
        q_len, c = spans.get(s, (0, 0))
        nb = -(-c // BS)
        tables[s, :nb] = torch.arange(nxt, nxt + nb)
        nxt += nb
        ctx[s], cu[s + 1] = c, cu[s] + q_len
        pos = torch.arange(c)
        written.append(tables[s, pos // BS].long() * BS + pos % BS)
    idx = torch.cat(written).to(cuda)
    pool[1].view(N * BS, 2 * KH, D)[idx] = torch.randn(
        (idx.numel(), 2 * KH, D), generator=g, device=cuda).to(dtype)
    q = torch.randn((int(cu[-1]) + tail, H, D), generator=g,
                    device=cuda).to(dtype)
    return pool, tables.to(cuda), cu.to(cuda), ctx.to(cuda), q


# slot: (q_len, ctx). A fresh chunk, one-token spans at contexts 700, 1
# (a one-token prefill) and 300, continuations at q_start 113 and 350, a
# two-token span at q_start 18; slots 2 and 8 empty
RAGGED_SPANS = {0: (40, 40), 1: (1, 700), 3: (1, 1), 4: (37, 150),
                5: (2, 20), 6: (1, 300), 7: (100, 450)}


@pytest.mark.parametrize("soft_cap", [0.0, 50.0])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("D", [32, 48, 64, 96, 128, 256])
def test_tensor_core_ragged_matches_plain(cuda, D, G, soft_cap):
    """bf16 K2 at every built head dim, the presets' GQA groups, with and
    without soft cap, on a stream of prefill spans, one-token spans, empty
    slots and 9 rows of tail padding, NaN in every unwritten pool slot:
    with the default work map, with the one-token spans cut into splits of
    256 positions (merged), and at every other built tile. Tail rows are
    exactly 0."""
    H, KH = 2 * G, 2
    pool, tables, cu, ctx, q = _stream(cuda, torch.bfloat16, H, KH, D,
                                       RAGGED_SPANS, 9, 48, 9)
    args = (q, pool, tables, cu, ctx, 1)
    want = k2.ragged_paged_attention_plain(*args, soft_cap=soft_cap)
    T = q.shape[0]
    maps = [k2.ragged_work_map(cu.cpu(), ctx.cpu(), T, H, KH, D,
                               torch.bfloat16, cuda, split_span=span)
            for span in (None, 256)]
    assert maps[1].plan[0] > 1
    maps += [k2.ragged_work_map(cu.cpu(), ctx.cpu(), T, H, KH, D,
                                torch.bfloat16, cuda, tile=tile)
             for tile in k4.TILES[D] if tile != k4.DEFAULT_TILE[D]]
    for work in maps:
        n = k2.LAUNCHES.n
        got = k2.ragged_paged_attention(*args, soft_cap=soft_cap, tiles=work)
        assert k2.LAUNCHES.n == n + 1
        _assert_p_rounded_close(got, want, BF16_TOL,
                                k2.ragged_paged_attention_plain, args,
                                soft_cap)
        assert (got[int(cu[-1]):] == 0).all()


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("B", [1, 4, 64])
def test_split_decode_matches_plain(cuda, B, long):
    """bf16 K3 (the split-KV walk) at contexts up to 300 and up to 8192, at
    batch 1, 4 and 64 (H 8, KH 2, D 128): by its own split plan, with
    splits of 256 positions, and with a plan made for contexts 8 longer,
    as a multi-step decode fixes it (splits wholly past a context). Slots
    with context 0 output exactly 0."""
    rng = np.random.default_rng(B)
    top = 8192 if long else 300
    lens = [top if b % 2 == 0 else int(rng.integers(1, top))
            for b in range(B)]
    for b in range(1, B, 9):
        lens[b] = 0
    H, KH, D = 8, 2, 128
    pool, tables, _, ctx, q = _stream(cuda, torch.bfloat16, H, KH, D,
                                      {b: (1, c) for b, c in enumerate(lens)},
                                      B, -(-top // BS), 0)
    args = (q, pool, tables, ctx, 1)
    want = k3.paged_decode_attention_plain(*args)
    live = sum(c > 0 for c in lens)
    for plan in (None, k3.split_plan(top, live, KH, 256),
                 k3.split_plan(top + 8, live, KH)):
        n = k3.LAUNCHES.n
        got = k3.paged_decode_attention(*args, plan=plan)
        assert k3.LAUNCHES.n == n + 1
        _assert_p_rounded_close(got, want, BF16_TOL,
                                k3.paged_decode_attention_plain, args, 0.0)
        assert (got[ctx == 0] == 0).all()


def test_engine_kernel_path_matches_plain_path(cuda):
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = EngineConfig.for_model(
        "tiny-llama", cache=CacheConfig(block_size=16, num_blocks=128),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32))
    params = init_random(cfg.model, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 259, n).tolist() for n in (3, 40, 9)]
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    cpu = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sp)
    on_card = {k: (v.to(cuda) if not isinstance(v, dict)
                   else {n: w.to(cuda) for n, w in v.items()})
               for k, v in params.items()}
    before = (k1.LAUNCHES.n, k2.LAUNCHES.n, k3.LAUNCHES.n)
    gpu = LLMEngine(cfg, params=on_card, device=cuda).generate(prompts, sp)
    after = (k1.LAUNCHES.n, k2.LAUNCHES.n, k3.LAUNCHES.n)
    assert all(a > b for a, b in zip(after, before))
    assert gpu == cpu


def test_bucketed_engine_kernel_path_matches_plain_path(cuda):
    """The bucketed path on the card runs K1, K4 and K3, never K2, and gives
    the CPU plain path's greedy tokens."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = EngineConfig.for_model(
        "tiny-llama", cache=CacheConfig(block_size=16, num_blocks=128),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32,
                                  prefill_buckets=(8, 16, 32)),
        attention_impl="bucketed")
    params = init_random(cfg.model, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 259, n).tolist() for n in (3, 40, 9)]
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    cpu = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sp)
    on_card = {k: (v.to(cuda) if not isinstance(v, dict)
                   else {n: w.to(cuda) for n, w in v.items()})
               for k, v in params.items()}
    counters = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES)
    before = [c.n for c in counters]
    gpu = LLMEngine(cfg, params=on_card, device=cuda).generate(prompts, sp)
    d1, d2, d3, d4 = (c.n - b for c, b in zip(counters, before))
    assert d1 > 0 and d3 > 0 and d4 > 0 and d2 == 0
    assert gpu == cpu


def test_pipeline_stages_sharing_the_card_match_pp1(cuda):
    """tiny-llama at pipeline-parallel size 2, both stages on cuda:0: the
    bucketed path's K1, K4 and K3 launch and K2 does not, the greedy
    tokens equal pp 1's on the card, and both stages' pools, sized from
    the card's free memory once every stage's weights are placed, hold
    the same block count."""
    import gc

    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    def engine(stage):
        cfg = EngineConfig.for_model(
            "tiny-llama", seed=0,
            cache=CacheConfig(block_size=16, hbm_utilization=0.1),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32,
                                      prefill_buckets=(8, 16, 32)),
            attention_impl="bucketed", mesh=MeshConfig(stage=stage, tensor=1))
        return LLMEngine(cfg, device=cuda,
                         stage_devices=["cuda:0"] * 2 if stage > 1 else None)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 259, n).tolist() for n in (3, 40, 9)]
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    eng = engine(1)
    want = eng.generate(prompts, sp)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    counters = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES)
    before = [c.n for c in counters]
    eng = engine(2)
    got = eng.generate(prompts, sp)
    d1, d2, d3, d4 = (c.n - b for c, b in zip(counters, before))
    assert d1 > 0 and d3 > 0 and d4 > 0 and d2 == 0
    assert got == want
    pools = [r.kv.shape[1] for r in eng.runner.stages]
    assert pools == [eng.runner.num_blocks] * 2 and pools[0] >= 16


# slot: (q_len, ctx). Verify spans of 1 + 4 tokens over contexts 130-537
# (the causal edge inside the last five positions), one-token spans at
# contexts 779-938, and an empty slot between them
VERIFY_SPANS = {**{s: (5, 130 + 37 * s) for s in range(12)},
                **{s: (1, 90 + 53 * s) for s in range(13, 17)}}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_ragged_verify_stream_matches_plain(cuda, dtype, tol, D):
    """K2 on a speculative-verify-shaped stream (spans of 1 + drafts each
    ending at its context, mixed with one-token spans in one launch) against
    its plain version; tail rows exactly 0."""
    H, KH = 8, 2
    pool, tables, cu, ctx, q = _stream(cuda, dtype, H, KH, D, VERIFY_SPANS,
                                       17, 64, 6)
    args = (q, pool, tables, cu, ctx, 1)
    want = k2.ragged_paged_attention_plain(*args)
    work = k2.ragged_work_map(cu.cpu(), ctx.cpu(), q.shape[0], H, KH, D,
                              dtype, cuda)
    n = k2.LAUNCHES.n
    got = k2.ragged_paged_attention(*args, tiles=work)
    assert k2.LAUNCHES.n == n + 1
    _assert_p_rounded_close(got, want, tol, k2.ragged_paged_attention_plain,
                            args, 0.0)
    assert (got[int(cu[-1]):] == 0).all()


def test_engine_features_kernel_path_matches_plain_path(cuda, tmp_path):
    """float32 tiny-llama on the ragged path with n-gram speculation, a
    LoRA adapter and grammars: the card's greedy tokens are the CPU plain
    path's, and K1, K2 and K3 launch (K2 with verify spans)."""
    from production_stack_tpu_torch.engine import lora
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random

    cfg = EngineConfig.for_model(
        "tiny-llama", cache=CacheConfig(block_size=16, num_blocks=128),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=64,
                                  multi_step=2, spec_ngram_k=4))
    m = cfg.model
    rng = np.random.default_rng(0)
    dims = {"q_proj": (m.hidden_size, m.num_heads * m.head_dim),
            "v_proj": (m.hidden_size, m.num_kv_heads * m.head_dim),
            "down_proj": (m.intermediate_size, m.hidden_size)}
    tensors = {}
    for layer in range(m.num_layers):
        for mod, (i, o) in dims.items():
            base = f"model.layers.{layer}.{'mlp' if 'down' in mod else 'self_attn'}.{mod}"
            tensors[f"{base}.lora_A.weight"] = rng.standard_normal(
                (8, i)).astype(np.float32) * 0.3
            tensors[f"{base}.lora_B.weight"] = rng.standard_normal(
                (o, 8)).astype(np.float32) * 0.3
    lora.write_safetensors(str(tmp_path / "adapter_model.safetensors"),
                           tensors)
    params = init_random(m, seed=0)
    semi = [1, 2, 3, 4, 1, 2, 5, 6, 1, 2]
    greedy = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    reqs = [("semi", semi, greedy, 0), ("lora", semi[::-1] * 2, greedy, 1),
            ("re", [5, 6, 7], SamplingParams(
                temperature=0.0, max_tokens=16,
                guided_regex=r"(yes|no)( indeed)?")),
            ("re-lora", [9, 9], SamplingParams(
                temperature=0.0, max_tokens=16, guided_regex=r"[a-f]{3,9}"), 1),
            ("plain", rng.integers(0, 259, 40).tolist(), greedy, 0)]

    def run(device):
        p = {k: (v.to(device) if not isinstance(v, dict)
                 else {n: w.to(device) for n, w in v.items()})
             for k, v in params.items()}
        eng = LLMEngine(cfg, params=p, device=device)
        lora.LoraManager(eng).load("a", str(tmp_path))
        for rid, prompt, sp, *slot in reqs:
            eng.add_request(rid, prompt_token_ids=prompt, sampling=sp,
                            adapter_slot=slot[0] if slot else 0)
        toks = {r[0]: [] for r in reqs}
        while eng.has_unfinished():
            for o in eng.step():
                toks[o.request_id].extend(o.new_token_ids)
        return toks, eng.spec_drafted

    cpu, cpu_drafted = run("cpu")
    counters = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES)
    before = [c.n for c in counters]
    gpu, gpu_drafted = run(cuda)
    assert all(c.n > b for c, b in zip(counters, before))
    assert gpu == cpu and gpu_drafted == cpu_drafted > 0


# -- int8 and the MoE block on the card ---------------------------------------

@pytest.mark.parametrize("rows", [1, 5, 16, 17, 40, 64])
def test_int8_mm_on_card_matches_cpu(cuda, rows):
    """cuBLAS's int8 GEMM through ``int8_mm``: any row count (padded to
    what the weight's layout takes), both weight layouts, the CPU's int32
    result bit for bit; K or N off a multiple of 8 raises."""
    from production_stack_tpu_torch.engine import quant

    g = torch.Generator().manual_seed(rows)
    x = torch.randint(-127, 128, (rows, 64), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (64, 40), dtype=torch.int8, generator=g)
    want = torch._int_mm(x, w)
    for layout in (w, w.t().contiguous().t()):
        got = quant.int8_mm(x.to(cuda), layout.to(cuda))
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_mm(x[:, :60].to(cuda), w[:60].to(cuda))


@pytest.mark.parametrize("tokens", [None, 4096])
def test_quant_matmul_on_card_matches_cpu(cuda, tokens):
    """A quantized product, W8A8 (the rows' own count) and W8A16 (told
    4096 tokens), float32 on the card against the CPU."""
    from production_stack_tpu_torch.engine import quant

    g = torch.Generator().manual_seed(0)
    x = torch.randn(24, 128, generator=g)
    w = quant.quantize_array(torch.randn(128, 4, 32, generator=g), (0,))
    want = quant.quant_matmul(x, w, tokens=tokens)
    got = quant.quant_matmul(x.to(cuda), {k: v.to(cuda) for k, v in
                                          w.items()}, tokens=tokens)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("rows,ref_tokens", [(40, 64), (600, 1024)])
def test_moe_block_on_card_matches_cpu(cuda, quantized, rows, ref_tokens):
    """tiny-mixtral's MoE block at X = 8 with a router biased toward
    expert 0, so slots are dropped: float32, plain and int8 (W8A8 at 64
    reference tokens, W8A16 at 1024), the card against the CPU."""
    import dataclasses

    from production_stack_tpu_torch.engine import quant
    from production_stack_tpu_torch.engine.config import ModelConfig
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.models import llama

    cfg = dataclasses.replace(ModelConfig.from_pretrained("tiny-mixtral"),
                              num_experts=8, num_layers=1,
                              quant="int8" if quantized else None)
    lp = {k: llama._layer(v, 0)
          for k, v in init_random(cfg, seed=1)["layers"].items()}
    lp["router"][0, 0] += 20.0
    x = torch.randn(rows, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(2))
    x[:, 0] = x[:, 0].abs() + 1.0
    want = llama._moe_mlp(cfg, lp, x, ref_tokens)
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if quant.is_quantized(v) else v.to(cuda))
               for k, v in lp.items()}
    got = llama._moe_mlp(cfg, on_card, x.to(cuda), ref_tokens)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-5)


def test_kv_export_import_round_trip_is_bitwise(cuda):
    """The KV plane's gathers and scatters on the card, bf16: blocks in a
    non-contiguous order leave the pool (whole, as one layer group, and as
    per-block slabs) and land in other blocks bit for bit, through the
    wire's raw 2-byte words too."""
    from production_stack_tpu_torch.engine import kv_transfer as tkt
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine

    cfg = EngineConfig.for_model("tiny-llama", dtype="bfloat16",
                                 cache=CacheConfig(num_blocks=64))
    runner = LLMEngine(cfg, device="cuda").runner
    g = torch.Generator(device="cuda").manual_seed(0)
    runner.kv.copy_(torch.randn(runner.kv.shape, generator=g, device="cuda")
                    .to(torch.bfloat16))
    src, dst = [41, 3, 17, 8, 60], [5, 50, 9, 33, 2]
    data = runner.export_blocks(src)
    assert data.device.type == "cpu" and data.is_pinned()
    want = runner.kv[:, src].cpu()
    assert torch.equal(data.view(torch.int16), want.view(torch.int16))
    wire = tkt.tensor_from_bytes(bytearray(tkt.tensor_bytes(data)),
                                 "bfloat16", data.shape)
    runner.import_blocks(dst, wire)
    assert torch.equal(runner.kv[:, dst].view(torch.int16),
                       runner.kv[:, src].view(torch.int16))
    part = runner.export_blocks_range(src[::-1], 1, 1)
    assert torch.equal(part.view(torch.int16),
                       want[1:2].flip(1).view(torch.int16))
    before = runner.kv.clone()
    runner.import_blocks_range([7, 6], 1, part[:, :2])
    assert torch.equal(runner.kv[1, [7, 6]].view(torch.int16),
                       part[0, :2].cuda().view(torch.int16))
    assert torch.equal(runner.kv[0].view(torch.int16),
                       before[0].view(torch.int16))
    slabs = runner.export_slabs(src)
    assert all(torch.equal(s.view(torch.int16), want[:, i].view(torch.int16))
               for i, s in enumerate(slabs))


@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_attention_on_card_matches_cpu(cuda, dtype, soft_cap):
    """The scoring path's dense attention (plain PyTorch on either
    device): on the card against its CPU run on the same inputs, and query
    blocks of 7 against one block of all 96 queries on the card. float32
    within 1e-5; bf16 within one bf16 step of the output (both round once
    from float32)."""
    from production_stack_tpu_torch.ops.attention import (
        dense_causal_attention,
    )

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 96, 8, 64, generator=g).to(dtype)
    k = torch.randn(2, 96, 2, 64, generator=g).to(dtype)
    v = torch.randn(2, 96, 2, 64, generator=g).to(dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want = dense_causal_attention(q, k, v, soft_cap=soft_cap)
    whole = dense_causal_attention(q.cuda(), k.cuda(), v.cuda(),
                                   soft_cap=soft_cap)
    blocked = dense_causal_attention(q.cuda(), k.cuda(), v.cuda(),
                                     soft_cap=soft_cap, q_block=7)
    assert blocked.dtype == dtype and blocked.device.type == "cuda"
    for got in (whole, blocked):
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(blocked.float(), whole.float(), atol=tol[0],
                               rtol=tol[1])


def test_scoring_engine_on_card_matches_cpu(cuda):
    """float32 tiny-llama's embed, choice_logprobs and prompt_logprobs on
    the card equal the CPU engine's on the same weights within 1e-4."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.weights import to_device

    cfg = EngineConfig.for_model("tiny-llama", cache=CacheConfig(
        num_blocks=64))
    cpu = LLMEngine(cfg, device="cpu")
    card = LLMEngine(cfg, params=to_device(cpu.runner.params, "cuda"),
                     device="cuda")
    ids = list(range(3, 140))
    np.testing.assert_allclose(card.embed(ids), cpu.embed(ids), atol=1e-4,
                               rtol=1e-4)
    choices = [[10, 11], [12], [13, 14, 15]]
    np.testing.assert_allclose(card.choice_logprobs(ids, choices),
                               cpu.choice_logprobs(ids, choices), atol=1e-4)
    a, b = card.prompt_logprobs(ids), cpu.prompt_logprobs(ids)
    np.testing.assert_allclose([x[0] for x in a], [x[0] for x in b],
                               atol=1e-4)


@pytest.mark.parametrize("wav", ["tone-8k", "noise-44k-stereo",
                                 "silence-16k"])
def test_whisper_on_card_matches_cpu(cuda, wav):
    """float32 tiny-whisper on the card against the CPU runner on the same
    weights: greedy tokens equal up to a near-tie (the CPU run's top-2
    logprob gap under TIE_GAP), the detected language equal,
    ``no_speech_prob`` and token logprobs within 1e-4, for transcription
    with detection, translation, timestamp mode and a prompt. cuDNN's
    TF32 convolutions are off for the comparison."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.weights import to_device
    from production_stack_tpu_torch.engine.whisper_runner import (
        WhisperRunner,
    )
    from _torch_whisper import TIE_GAP, features, top2_gap

    cfg = EngineConfig.for_model("tiny-whisper")
    cpu = WhisperRunner(cfg, device="cpu")
    card = WhisperRunner(cfg, device="cuda",
                         params=to_device(cpu.params, "cuda"))
    feats = features(cpu, wav)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for kw in (dict(), dict(language="en", task="translate"),
                   dict(language="en", timestamps=True),
                   dict(language="en", prompt="a prompt")):
            want_info, got_info = {}, {}
            want = cpu.transcribe(feats, info=want_info, **kw)
            got = card.transcribe(feats, info=got_info, **kw)
            n = len(want)
            for i, (a, b) in enumerate(zip(want, got)):
                if a != b:
                    assert top2_gap(cpu, feats, kw, want[:i]) < TIE_GAP
                    n = i
                    break
            else:
                assert got == want
            assert got_info["language"] == want_info["language"]
            assert abs(got_info["no_speech_prob"]
                       - want_info["no_speech_prob"]) <= 1e-4
            np.testing.assert_allclose(got_info["logprobs"][:n],
                                       want_info["logprobs"][:n], atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_whisper_server_refuses_cuda_without_a_card(cuda, monkeypatch):
    """``--device cuda`` (the default) raises when the card is not there,
    rather than serving on the CPU."""
    from production_stack_tpu_torch.engine.server import (
        build_parser,
        server_from_args,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        server_from_args(build_parser().parse_args(
            ["--model", "tiny-whisper"]))


def test_whisper_tensor_parallel_on_one_card_matches_cpu(cuda):
    """Float32 tiny-whisper at tensor-parallel size 2, both ranks on this
    card over gloo, against the CPU runner at tp 1 on the same weights:
    greedy tokens equal up to a near-tie (the CPU's top-2 gap under
    TIE_GAP), the language equal, ``no_speech_prob`` and logprobs within
    1e-4; every rank's digest rank 0's and no handle left. cuDNN's TF32
    convolutions are off for the comparison."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.whisper_runner import (
        WhisperRunner,
    )
    from production_stack_tpu_torch.parallel.mesh import MeshConfig
    from _torch_whisper import TIE_GAP, WAVS, features, top2_gap

    cpu = WhisperRunner(EngineConfig.for_model("tiny-whisper"), device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    card = WhisperRunner(
        EngineConfig.for_model("tiny-whisper", mesh=MeshConfig(tensor=2)),
        device=cuda, params=cpu.params, rank_devices=["cuda:0"] * 2,
        backend="gloo")
    try:
        for wav in WAVS:
            feats = features(cpu, wav)
            for kw in (dict(), dict(language="en", task="translate"),
                       dict(language="en", timestamps=True)):
                want_info, got_info = {}, {}
                want = cpu.transcribe(feats, info=want_info, **kw)
                got = card.transcribe(feats, info=got_info, **kw)
                n = len(want)
                for i, (a, b) in enumerate(zip(want, got)):
                    if a != b:
                        assert top2_gap(cpu, feats, kw, want[:i]) < TIE_GAP
                        n = i
                        break
                else:
                    assert got == want
                assert got_info["language"] == want_info["language"]
                assert abs(got_info["no_speech_prob"]
                           - want_info["no_speech_prob"]) <= 1e-4
                np.testing.assert_allclose(got_info["logprobs"][:n],
                                           want_info["logprobs"][:n],
                                           atol=1e-4)
        reports = card.follower_reports()
        assert card.dev.device.type == "cuda"
    finally:
        card.close()
        torch.backends.cudnn.allow_tf32 = tf32
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert all(r["live"] == [] for r in reports)


# -- the decode step as CUDA graphs -------------------------------------------

def _graph_config(impl="ragged", graphs=True, chain=False):
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )

    return EngineConfig.for_model(
        "tiny-llama", dtype="bfloat16",
        cache=CacheConfig(block_size=16, num_blocks=256),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=64,
                                  prefill_buckets=(32, 64), multi_step=2,
                                  decode_graphs=graphs, chain_decode=chain),
        attention_impl=impl)


def _graph_engine(cuda, impl="ragged", graphs=True, chain=False):
    """bf16 tiny-llama with weights from seed 0, made on the card."""
    from production_stack_tpu_torch.engine.engine import LLMEngine

    return LLMEngine(_graph_config(impl, graphs, chain), device=cuda)


def _graph_wave(eng, lora=None, logprobs=2):
    """Eight requests in two waves, the first of contexts under the plan
    ladder's 256 rung and the second over it (prompts up to 300 tokens, 24
    out): greedy, seeded sampling, penalties, a logit bias, a grammar and,
    with ``lora``, an adapter. Returns each request's tokens and logprob
    entries."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    rng = np.random.default_rng(7)
    kinds = [dict(temperature=0.0), dict(temperature=0.8, seed=3, top_k=40),
             dict(temperature=0.0, presence_penalty=0.4),
             dict(temperature=0.7, seed=5, frequency_penalty=0.3),
             dict(temperature=0.0, logit_bias={5: 3.0, 17: -2.0}),
             dict(temperature=0.0, guided_regex="[a-z ]{8,40}"),
             dict(temperature=0.9, seed=11), dict(temperature=0.0)]
    out = {}
    for wave in ((9, 140, 30, 33), (250, 5, 120, 280)):
        for n in wave:
            i = len(out)
            kw = kinds[i]
            eng.add_request(str(i), prompt_token_ids=rng.integers(
                0, 259, n).tolist(), sampling=SamplingParams(
                    max_tokens=24, ignore_eos="guided_regex" not in kw,
                    logprobs=logprobs, **kw),
                adapter_slot=1 if lora and i % 3 == 0 else 0)
            out[str(i)] = ([], [])
        while eng.has_unfinished():
            for o in eng.step():
                out[o.request_id][0].extend(o.new_token_ids)
                out[o.request_id][1].extend(o.new_logprobs or ())
    return out


def _adapter(cfg, rank=8):
    from production_stack_tpu_torch.engine.lora import target_shapes

    rng = np.random.default_rng(3)
    L = cfg.num_layers
    return {t: (rng.normal(0, 0.1, (L, i, rank)).astype(np.float32),
                rng.normal(0, 0.1, (L, rank, *o)).astype(np.float32))
            for t, (i, o) in target_shapes(cfg).items()}


@pytest.mark.parametrize("impl", ["ragged", "bucketed"])
def test_decode_graphs_equal_eager_bit_for_bit(cuda, impl):
    """bf16 tiny-llama on the card: the graphed decode step gives the eager
    step's tokens and logprobs bit for bit over every flag variant and
    two rungs, and K1 and K3 launch through the replays."""
    runs = {}
    for graphs in (False, True):
        eng = _graph_engine(cuda, impl, graphs)
        eng.runner.register_lora(1, _adapter(eng.config.model))
        before = (k1.LAUNCHES.n, k3.LAUNCHES.n)
        runs[graphs] = _graph_wave(eng, lora=True)
        after = (k1.LAUNCHES.n, k3.LAUNCHES.n)
        assert all(a > b for a, b in zip(after, before))
        if graphs:
            keys = set(eng.runner.graphs.entries)
            assert {k.rung for k in keys} == {256, 512}
            assert any(k.lora for k in keys) and any(k.grammar for k in keys)
            assert eng.runner.graphs.captures == len(keys)
        else:
            assert eng.runner.graphs is None
    assert runs[True] == runs[False]


def test_no_capture_after_warmup_on_a_mixed_run(cuda):
    eng = _graph_engine(cuda)
    eng.warmup()
    graphs = eng.runner.graphs
    n = graphs.captures
    assert len(graphs) == n == 32 * len(eng.runner.decode_rungs)
    _graph_wave(eng, logprobs=None)
    _graph_wave(eng)
    assert graphs.captures == n
    assert eng.perf.stats_fields()["unexpected_recompiles"] == 0


def test_chained_graphs_equal_unchained(cuda):
    runs = {}
    for chain in (False, True):
        eng = _graph_engine(cuda, chain=chain)
        runs[chain] = _graph_wave(eng, logprobs=None)
        assert eng._pending_decode is None
    assert runs[True] == runs[False]


# -- tensor parallelism: ranks sharing this card over gloo --------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_ranks_on_one_card_match_cpu(cuda, tp):
    """float32 tiny-llama at tensor-parallel size ``tp``, every rank on
    this card over gloo (at tp 4 its two KV heads are replicated, so the
    kernels run at a local group size of 1): greedy tokens equal the CPU's
    at tp 1 on the ragged and the bucketed path, every rank's token digest
    is rank 0's, and every rank launched K1 and K3, with K2 on the ragged
    path and K4 on the bucketed one."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    params = init_random(EngineConfig.for_model("tiny-llama").model, seed=0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 259, int(n)).tolist()
               for n in rng.integers(3, 90, 8)]
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)

    def serve(eng):
        for i, p in enumerate(prompts):
            eng.add_request(str(i), prompt_token_ids=p, sampling=sp)
        toks = {}
        while eng.has_unfinished():
            for o in eng.step():
                toks.setdefault(o.request_id, []).extend(o.new_token_ids)
        return toks

    for impl, attn in (("ragged", "K2"), ("bucketed", "K4")):
        def cfg(n):
            return EngineConfig.for_model(
                "tiny-llama", cache=CacheConfig(block_size=16,
                                                num_blocks=128),
                scheduler=SchedulerConfig(max_num_seqs=8,
                                          max_num_batched_tokens=64),
                attention_impl=impl, mesh=MeshConfig(tensor=n))

        cpu = serve(LLMEngine(cfg(1), params=params, device="cpu"))
        eng = LLMEngine(cfg(tp), params=params, device=cuda,
                        rank_devices=["cuda:0"] * tp, backend="gloo")
        try:
            card = serve(eng)
            reports = eng.runner.follower_reports()
        finally:
            eng.close()
        assert card == cpu, impl
        assert len({(r["calls"], r["digest"]) for r in reports}) == 1
        for r in reports:
            launched = {k for k, n in r["launches"].items() if n}
            assert {"K1", "K3", attn} <= launched, (impl, r)


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_kv_moves_on_one_card(cuda, tp):
    """The KV plane at tensor-parallel size ``tp``, every rank on this card
    over gloo, bf16 tiny-llama: whole blocks out (whole, in layer groups
    and as slabs) are every rank's heads joined (the shares side by side
    at tp 2; at tp 4 each of the two replicated heads once), and land in
    other blocks bit for bit, through the wire's raw 2-byte words."""
    from production_stack_tpu_torch.engine import kv_transfer as tkt
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    cfg = EngineConfig.for_model("tiny-llama", dtype="bfloat16",
                                 cache=CacheConfig(num_blocks=64),
                                 mesh=MeshConfig(tensor=tp))
    eng = LLMEngine(cfg, device=cuda, rank_devices=["cuda:0"] * tp,
                    backend="gloo")
    try:
        prompt = list(range(3, 70))
        eng.generate([prompt], SamplingParams(temperature=0.0, max_tokens=2,
                                              ignore_eos=True))
        src, _ = eng.scheduler.allocator.match_prefix(prompt)
        # every rank's own heads (bf16 widened to float32, exactly)
        shares = [torch.from_numpy(x).to(torch.bfloat16) for x in
                  eng.runner.gather("export_blocks", src)]
        KH = cfg.model.num_kv_heads
        if tp == 2:
            want = torch.cat(shares, dim=3)
        else:  # rank r holds head r // 2: [K_h, V_h]
            k = [shares[2 * h][:, :, :, :1] for h in range(KH)]
            v = [shares[2 * h][:, :, :, 1:] for h in range(KH)]
            want = torch.cat(k + v, dim=3)
        data = eng.export_kv(src)
        assert data.is_pinned()
        assert torch.equal(data.view(torch.int16), want.view(torch.int16))
        groups = torch.cat([eng.runner.export_blocks_range(src, lo, 1)
                            for lo in range(cfg.model.num_layers)])
        assert torch.equal(groups.view(torch.int16), data.view(torch.int16))
        slabs = eng.runner.export_slabs(src)
        assert all(torch.equal(sl.view(torch.int16),
                               data[:, i].view(torch.int16))
                   for i, sl in enumerate(slabs))
        dst = eng.scheduler.allocator.take_free_blocks(len(src))
        wire = tkt.tensor_from_bytes(bytearray(tkt.tensor_bytes(data)),
                                     "bfloat16", data.shape)
        eng.runner.import_blocks(dst, wire)
        assert torch.equal(eng.export_kv(dst).view(torch.int16),
                           data.view(torch.int16))
        eng.runner.import_slabs(dst[::-1], slabs)
        assert torch.equal(eng.export_kv(dst[::-1]).view(torch.int16),
                           data.view(torch.int16))
        reports = eng.runner.follower_reports()
        assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    finally:
        eng.close()


# the model's features at tp 2 on this card: the CPU's top-2 gap under
# which a greedy flip is a near-tie (int8: an activation on a rounding
# boundary rounds either way on the card and on the CPU)
TP_FEATURE_GAPS = {"tiny-mixtral": 1e-4, "int8-w8a8": 0.05,
                   "int8-w8a16": 0.05, "lora": 1e-4}


@pytest.mark.parametrize("case", list(TP_FEATURE_GAPS))
def test_tensor_parallel_features_on_one_card_match_cpu(cuda, case,
                                                        monkeypatch):
    """float32 at tensor-parallel size 2, both ranks on this card over
    gloo, against the CPU at tp 1 on the ragged path: tiny-mixtral,
    tiny-llama int8 on the W8A8 route and on the W8A16 one
    (``PSTPU_QUANT_A16_THRESHOLD=1``, which the spawned ranks inherit),
    tiny-llama with a rank-8 adapter on every other request (each rank
    sent its share). Greedy tokens equal up to a near-tie
    (``TP_FEATURE_GAPS``); every rank's token digest is rank 0's; K1-K3
    launch on every rank."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    preset = "tiny-mixtral" if case == "tiny-mixtral" else "tiny-llama"
    quant = "int8" if case.startswith("int8") else None
    if case == "int8-w8a16":
        monkeypatch.setenv("PSTPU_QUANT_A16_THRESHOLD", "1")
    params = init_random(EngineConfig.for_model(preset).model, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 259, int(n)).tolist()
               for n in rng.integers(3, 90, 8)]
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True,
                        logprobs=2)

    def serve(eng):
        if case == "lora":
            eng.runner.register_lora(1, _adapter(eng.config.model))
        for i, p in enumerate(prompts):
            eng.add_request(str(i), prompt_token_ids=p, sampling=sp,
                            adapter_slot=i % 2 if case == "lora" else 0)
        out = {str(i): ([], []) for i in range(len(prompts))}
        while eng.has_unfinished():
            for o in eng.step():
                out[o.request_id][0].extend(o.new_token_ids)
                out[o.request_id][1].extend(o.new_logprobs or ())
        return out

    def cfg(n):
        return EngineConfig.for_model(
            preset, quant=quant,
            cache=CacheConfig(block_size=16, num_blocks=128),
            scheduler=SchedulerConfig(max_num_seqs=8,
                                      max_num_batched_tokens=64),
            mesh=MeshConfig(tensor=n))

    cpu = serve(LLMEngine(cfg(1), params=params, device="cpu"))
    eng = LLMEngine(cfg(2), params=params, device=cuda,
                    rank_devices=["cuda:0"] * 2, backend="gloo")
    try:
        card = serve(eng)
        reports = eng.runner.follower_reports()
    finally:
        eng.close()
    for rid, (want, lps) in cpu.items():
        got = card[rid][0]
        assert len(got) == len(want), rid
        for i, (a, b) in enumerate(zip(want, got)):
            if a != b:
                gap = lps[i][1][0][1] - lps[i][1][1][1]
                assert gap < TP_FEATURE_GAPS[case], (case, rid, i, gap)
                break
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    for r in reports:
        launched = {k for k, n in r["launches"].items() if n}
        assert {"K1", "K2", "K3"} <= launched, (case, r)


# -- sequence parallelism: seq ranks sharing this card over gloo --------------

def test_sequence_parallel_ring_on_one_card_matches_cpu(cuda):
    """float32 tiny-llama at sequence-parallel size 2, both ranks on this
    card over gloo, ring threshold 16: the long prompts prefill through
    the ring (one call each, padded to 64) and the greedy tokens equal
    the CPU's chunked prefill at seq 1; each ring call wrote its pool
    through K1, once a layer; every rank's digest is rank 0's and every
    rank launched K1 and K3; and every rank's pool holds, for the first
    prompt's cached blocks, the CPU engine's K/V within 1e-5, the ranks'
    bit for bit alike."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    params = init_random(EngineConfig.for_model("tiny-llama").model, seed=0)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, 259, n).tolist() for n in (45, 5, 37)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)

    def cfg(seq):
        return EngineConfig.for_model(
            "tiny-llama", cache=CacheConfig(block_size=16, num_blocks=128),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32,
                                      ring_prefill_threshold=16),
            mesh=MeshConfig(seq=seq, tensor=1))

    cpu = LLMEngine(cfg(1), params=params, device="cpu")
    want = cpu.generate(prompts, sp)
    blocks, _ = cpu.scheduler.allocator.match_prefix(prompts[0])
    cpu_pool = cpu.runner.export_blocks(blocks)
    eng = LLMEngine(cfg(2), params=params, device=cuda,
                    rank_devices=["cuda:0"] * 2, backend="gloo")
    try:
        k1_per_call = []
        inner = eng.runner.prefill_ring

        def ring(tokens, *args, **kwargs):
            n0 = k1.LAUNCHES.n
            out = inner(tokens, *args, **kwargs)
            k1_per_call.append((int(tokens.shape[1]), k1.LAUNCHES.n - n0))
            return out

        eng.runner.prefill_ring = ring
        got = eng.generate(prompts, sp)
        reports = eng.runner.follower_reports()
        mine, _ = eng.scheduler.allocator.match_prefix(prompts[0])
        pools = eng.runner.gather("export_blocks", mine)
    finally:
        eng.close()
    assert got == want
    layers = cfg(2).model.num_layers
    assert k1_per_call == [(64, layers), (64, layers)]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    for r in reports:
        assert {"K1", "K3"} <= {k for k, n in r["launches"].items() if n}
    assert list(mine) and len(mine) == len(blocks)
    assert np.array_equal(pools[0], pools[1])
    np.testing.assert_allclose(pools[0], cpu_pool.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sequence_tensor_grid_on_one_card_matches_cpu(cuda):
    """float32 tiny-llama at seq 2 x tp 2, all four processes on this card
    over gloo, ring threshold 16: the long prompts prefill through the
    ring over each tensor rank's seq ranks (one call each, padded to 64)
    and the greedy tokens equal the CPU's chunked prefill at seq 1 and tp
    1; decode graphs are off (the tensor group's collectives run in
    decode); every process's digest and launches are rank 0's, K1 and K3
    launched; and the two seq ranks of a tensor rank hold its KV heads of
    the first prompt's cached blocks bit for bit alike, the CPU engine's
    within 1e-5."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    params = init_random(EngineConfig.for_model("tiny-llama").model, seed=0)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 259, n).tolist() for n in (45, 5, 37)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)

    def cfg(seq, tp):
        return EngineConfig.for_model(
            "tiny-llama", cache=CacheConfig(block_size=16, num_blocks=128),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32,
                                      ring_prefill_threshold=16),
            mesh=MeshConfig(seq=seq, tensor=tp))

    cpu = LLMEngine(cfg(1, 1), params=params, device="cpu")
    want = cpu.generate(prompts, sp)
    blocks, _ = cpu.scheduler.allocator.match_prefix(prompts[0])
    cpu_pool = cpu.runner.export_blocks(blocks)
    eng = LLMEngine(cfg(2, 2), params=params, device=cuda,
                    rank_devices=["cuda:0"] * 4, backend="gloo")
    try:
        calls = []
        inner = eng.runner.prefill_ring

        def ring(tokens, *args, **kwargs):
            calls.append(int(tokens.shape[1]))
            return inner(tokens, *args, **kwargs)

        eng.runner.prefill_ring = ring
        got = eng.generate(prompts, sp)
        reports = eng.runner.follower_reports()
        info = eng.rank_info()
        mine, _ = eng.scheduler.allocator.match_prefix(prompts[0])
        pools = eng.runner.gather("export_blocks", mine)
    finally:
        eng.close()
    assert got == want
    assert calls == [64, 64]
    assert (info["shape"], info["decode_graphs"]) == (
        {"seq": 2, "tensor": 2}, False)
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert len({tuple(sorted(r["launches"].items()))
                for r in reports}) == 1
    assert {"K1", "K3"} <= {k for k, n in reports[0]["launches"].items()
                            if n}
    assert list(mine) and len(mine) == len(blocks)
    # tensor rank t holds KV head t: rows t and KH + t of the tp 1 pool
    KH = cfg(1, 1).model.num_kv_heads
    for g, pool in enumerate(pools):
        assert np.array_equal(pool, pools[g % 2])
        np.testing.assert_allclose(
            pool, cpu_pool.numpy()[..., [g % 2, KH + g % 2], :],
            rtol=1e-5, atol=1e-5)


def test_sequence_parallel_moe_ring_on_one_card_matches_cpu(cuda):
    """float32 tiny-mixtral at sequence-parallel size 2, both ranks on
    this card over gloo, ring threshold 16: the long prompts prefill
    through the ring (one call each, padded to 64), each MoE layer's slot
    counts exchanged between the ranks (``ring_moe_counts``: L (n - 1) X
    4 bytes a call), and the greedy tokens equal the CPU's chunked
    prefill at seq 1; every rank's digest and launches are rank 0's, K1
    and K3 launched."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    model = EngineConfig.for_model("tiny-mixtral").model
    params = init_random(model, seed=0)
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, 259, n).tolist() for n in (45, 5, 37)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)

    def cfg(seq):
        return EngineConfig.for_model(
            "tiny-mixtral", cache=CacheConfig(block_size=16, num_blocks=128),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32,
                                      ring_prefill_threshold=16),
            mesh=MeshConfig(seq=seq, tensor=1))

    want = LLMEngine(cfg(1), params=params, device="cpu").generate(
        prompts, sp)
    eng = LLMEngine(cfg(2), params=params, device=cuda,
                    rank_devices=["cuda:0"] * 2, backend="gloo")
    try:
        calls = []
        inner = eng.runner.prefill_ring

        def ring(tokens, *args, **kwargs):
            calls.append(int(tokens.shape[1]))
            return inner(tokens, *args, **kwargs)

        eng.runner.prefill_ring = ring
        got = eng.generate(prompts, sp)
        reports = eng.runner.follower_reports()
        wire = dict(eng.runner.ranks.wire)
    finally:
        eng.close()
    assert got == want
    assert calls == [64, 64]
    assert wire["ring_moe_counts"] == (len(calls) * model.num_layers
                                       * model.num_experts * 4)
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert len({tuple(sorted(r["launches"].items()))
                for r in reports}) == 1
    assert {"K1", "K3"} <= {k for k, n in reports[0]["launches"].items()
                            if n}


def test_multihost_pair_on_one_card_matches_cpu(cuda, tmp_path):
    """The multi-host harness (float32 tiny-llama at tp 2) as two
    processes started on their own, both on this card over gloo, the
    calls on the authenticated channel: the greedy, guided and adapter
    tokens equal the same pair's on the CPU, logprobs within 1e-4, both
    ranks' digests and launches agree, and K1, K2 and K3 launched."""
    from _torch_multihost import line, run_pair
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.testing import multihost_harness as h

    # one weight set for both runs: a seeded init differs by device
    params = str(tmp_path / "params.npz")
    h.save_params(init_random(EngineConfig.for_model("tiny-llama").model,
                              seed=0), params)
    runs = {}
    for dev in ("cpu", "cuda:0"):
        (l_rc, l_out), (f_rc, f_out) = run_pair(
            ["--params", params], timeout=300, device=dev)
        assert l_rc == 0 and f_rc == 0, (l_out[-3000:], f_out[-3000:])
        assert "FOLLOWER DONE" in f_out
        runs[dev] = line(l_out, "TOKENS")
    cpu, card = runs["cpu"], runs["cuda:0"]
    assert card["tokens"] == cpu["tokens"]
    for rid, entries in cpu["logprobs"].items():
        for (a, _), (b, _) in zip(entries, card["logprobs"][rid]):
            assert abs(a - b) <= 1e-4, rid
    reports = card["reports"]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert reports[0]["launches"] == reports[1]["launches"]
    assert {"K1", "K2", "K3"} <= {k for k, n in reports[0]["launches"].items()
                                  if n}


def test_pipeline_tensor_grid_on_one_card_matches_tp2(cuda):
    """bf16 tiny-llama at pp 2 x tp 2, all four processes on this card
    over gloo, against tp 2 bucketed on the same card and weights: greedy
    tokens equal token for token (stage after stage runs tp 2's
    operations); every process's digest is rank 0's and each launched K1,
    K3 and K4 and no K2; the KV export equals tp 2's bit for bit."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    def cfg(stage):
        return EngineConfig.for_model(
            "tiny-llama", dtype="bfloat16",
            cache=CacheConfig(block_size=16, num_blocks=128,
                              enable_prefix_caching=False),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32,
                                      prefill_buckets=(8, 16, 32)),
            attention_impl="bucketed", mesh=MeshConfig(stage=stage, tensor=2))

    params = init_random(cfg(1).model, seed=0)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 259, n).tolist() for n in (3, 40, 9, 21)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    runs = {}
    for stage in (1, 2):
        eng = LLMEngine(cfg(stage), params=params, device=cuda,
                        rank_devices=["cuda:0"] * 2 * stage, backend="gloo")
        try:
            # the same allocations on both: blocks 0 and 1 end up holding
            # the same tokens' K/V
            runs[stage] = {"tokens": eng.generate(prompts, sp),
                           "kv": eng.export_kv([0, 1]),
                           "reports": eng.runner.follower_reports()}
        finally:
            eng.close()
    assert runs[2]["tokens"] == runs[1]["tokens"]
    assert torch.equal(runs[2]["kv"].view(torch.int16),
                       runs[1]["kv"].view(torch.int16))
    reports = runs[2]["reports"]
    assert [r["place"] for r in reports] == [
        {"stage": s, "tensor": t} for s in (0, 1) for t in (0, 1)]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    for r in reports:
        n = r["launches"]
        assert n["K1"] > 0 and n["K3"] > 0 and n["K4"] > 0 and n["K2"] == 0


@pytest.mark.parametrize("tp", [1, 2], ids=["ep2", "ep2tp2"])
def test_expert_ranks_on_one_card_match_expert1(cuda, tp):
    """bf16 tiny-mixtral at expert 2 (x tp 2), every process on this card
    over gloo, against expert 1 at the same tensor size on the same card
    and weights, ragged path: greedy tokens and logprobs equal bit for
    bit (each rank's float32 combine partial holds at most a token's two
    weighted rows and zeros); every process's digest is rank 0's, each
    launched K1, K2 and K3; rank 0's ``moe_combine`` bytes are positive
    and equal every follower's; the KV export equals expert 1's bit for
    bit."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import (
        init_random,
        to_device,
    )
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    def cfg(ep):
        return EngineConfig.for_model(
            "tiny-mixtral", dtype="bfloat16",
            cache=CacheConfig(block_size=16, num_blocks=128,
                              enable_prefix_caching=False),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32),
            mesh=MeshConfig(tensor=tp, expert=ep))

    params = init_random(cfg(1).model, seed=0)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, 259, n).tolist() for n in (3, 40, 9, 21)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True,
                        logprobs=2)
    runs = {}
    for ep in (1, 2):
        n = tp * ep
        # one process takes its weights on its device; ranks cut theirs
        # from the whole dict on the CPU
        eng = (LLMEngine(cfg(ep), params=to_device(params, cuda),
                         device=cuda) if n == 1
               else LLMEngine(cfg(ep), params=params, device=cuda,
                              rank_devices=["cuda:0"] * n, backend="gloo"))
        try:
            toks = {i: [] for i in range(len(prompts))}
            lps = {i: [] for i in range(len(prompts))}
            for i, p in enumerate(prompts):
                eng.add_request(str(i), prompt_token_ids=p, sampling=sp)
            while eng.has_unfinished():
                for o in eng.step():
                    toks[int(o.request_id)] += o.new_token_ids
                    lps[int(o.request_id)] += o.new_logprobs or []
            runs[ep] = {"tokens": toks, "logprobs": lps,
                        "kv": eng.export_kv([0, 1]),
                        "reports": (eng.runner.follower_reports() if n > 1
                                    else None)}
        finally:
            if n > 1:
                eng.close()
    assert runs[2]["tokens"] == runs[1]["tokens"]
    assert runs[2]["logprobs"] == runs[1]["logprobs"]
    assert torch.equal(runs[2]["kv"].view(torch.int16),
                       runs[1]["kv"].view(torch.int16))
    reports = runs[2]["reports"]
    assert [r["place"] for r in reports] == (
        [{"expert": e, "tensor": t} for e in (0, 1) for t in (0, 1)]
        if tp > 1 else [{"expert": 0}, {"expert": 1}])
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    combine = {r["wire"].get("moe_combine", 0.0) for r in reports}
    assert len(combine) == 1 and combine.pop() > 0
    for r in reports:
        n = r["launches"]
        assert n["K1"] > 0 and n["K2"] > 0 and n["K3"] > 0


# the process grid's combinations (tests/test_torch_grid_engine.py on the
# CPU): (preset, path, the grid's mesh, its one-axis counterpart's)
GRID_CASES = {
    "seq2ep2": ("tiny-mixtral", "ragged", dict(seq=2, expert=2),
                dict(seq=2)),
    "pp2ep2": ("tiny-mixtral", "bucketed", dict(stage=2, expert=2),
               dict(stage=2)),
    "seq2pp2": ("tiny-llama", "bucketed", dict(stage=2, seq=2),
                dict(stage=2)),
}


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_grid_on_one_card_matches_its_one_axis_counterpart(cuda, name):
    """bf16 at seq 2 x expert 2 (the ring, ragged), stage 2 x expert 2 and
    seq 2 x stage 2 (bucketed), every process on this card over gloo,
    against the same card at the other axis alone (seq 2 at expert 1, and
    pp 2 in one process) on the same weights: greedy tokens (and, on the
    ragged path, logprobs) equal bit for bit; every process's digest is
    rank 0's and each launched its path's kernels; no ring runs beside
    stages."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig,
        EngineConfig,
        SchedulerConfig,
    )
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.weights import init_random
    from production_stack_tpu_torch.parallel.distributed import Grid
    from production_stack_tpu_torch.parallel.mesh import MeshConfig

    preset, impl, grid_mesh, one_mesh = GRID_CASES[name]

    def cfg(mesh):
        return EngineConfig.for_model(
            preset, dtype="bfloat16", attention_impl=impl,
            cache=CacheConfig(block_size=16, num_blocks=128,
                              enable_prefix_caching=False),
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_num_batched_tokens=32,
                                      ring_prefill_threshold=16),
            mesh=MeshConfig(**{"tensor": 1, **mesh}))

    params = init_random(cfg({}).model, seed=0)
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, 259, n).tolist() for n in (3, 40, 9, 21)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True,
                        logprobs=2 if impl == "ragged" else None)
    runs = {}
    for key, mesh in (("one", one_mesh), ("grid", grid_mesh)):
        grid = Grid.of(cfg(mesh).mesh, 1)
        staged = grid.axes == ("stage",)
        eng = (LLMEngine(cfg(mesh), params=params, device=cuda,
                         stage_devices=["cuda:0"] * grid.stage) if staged
               else LLMEngine(cfg(mesh), params=params, device=cuda,
                              rank_devices=["cuda:0"] * grid.size,
                              backend="gloo"))
        try:
            toks = {i: [] for i in range(len(prompts))}
            lps = {i: [] for i in range(len(prompts))}
            for i, p in enumerate(prompts):
                eng.add_request(str(i), prompt_token_ids=p, sampling=sp)
            while eng.has_unfinished():
                for o in eng.step():
                    toks[int(o.request_id)] += o.new_token_ids
                    lps[int(o.request_id)] += o.new_logprobs or []
            runs[key] = {"tokens": toks, "logprobs": lps,
                         "ring": eng.scheduler.ring_enabled,
                         "reports": (None if staged else
                                     eng.runner.follower_reports())}
        finally:
            eng.close()
    assert runs["grid"]["tokens"] == runs["one"]["tokens"]
    assert runs["grid"]["logprobs"] == runs["one"]["logprobs"]
    assert all(len(t) == 12 for t in runs["grid"]["tokens"].values())
    grid = Grid(**grid_mesh)
    reports = runs["grid"]["reports"]
    assert [r["place"] for r in reports] == [
        {a: grid.coords(g)[a] for a in grid.axes} for g in range(grid.size)]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert runs["grid"]["ring"] == (grid.stage == 1)
    for r in reports:
        n = r["launches"]
        if impl == "ragged":
            assert n["K1"] > 0 and n["K2"] > 0 and n["K3"] > 0
        else:
            assert n["K1"] > 0 and n["K3"] > 0 and n["K4"] > 0
            assert n["K2"] == 0
        if grid.expert > 1:
            assert r["wire"]["moe_combine"] > 0
        if grid.seq > 1 and grid.stage == 1:
            assert r["wire"]["ring_rotate"] > 0
