"""The port's dense scoring path and sleep mode against the JAX package's,
on the CPU.

- ``ops/attention.dense_causal_attention`` against the reference's (GQA,
  Gemma-2's soft cap, a batch of two) at query blocks of 1, 3, S and
  None, float32, atol = rtol = 1e-5.
- The runner's ``pooled_embed``, ``sequence_logprobs`` and
  ``prompt_logprobs`` against the JAX runner's on the same padded numpy
  inputs: tiny-llama, tiny-gemma2 (soft caps, query scale), tiny-mixtral
  and tiny-llama in int8. Logprobs within ``LP_TOL`` (1e-4), int8 within
  PR 7's band of 0.05; pooled vectors within rtol 1e-4 / atol 1e-5. The
  forwards are longer than the step budget of 32 tokens,
  so the MLP runs in chunks, and 64 choices run in row groups.
- The engine's ``embed``, ``choice_logprobs`` (past the top bucket, as
  ``tests/test_guided_choice.py::test_choice_logprobs_beyond_top_bucket``)
  and ``prompt_logprobs`` against the JAX engine's.
- The reference's ``embed`` fault, pinned: with buckets (16, 32, 64) the
  JAX engine raises on 100 tokens; the port returns the JAX runner's
  vector of the same tokens padded to 128.
- Sleep mode at levels 1 and 2: the pool (and at 2 the weights) are None
  while asleep, greedy tokens are the same after wake, a sleep with a
  request unfinished is refused, and the rebuilt allocator still demotes
  evicted blocks to the host tier.
- The runner's reserve covers the scoring path's peak.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    LP_TOL,
    drain,
    engine_configs,
    jax_engine,
    port_engine,
    tiny_weights,
)
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.ops.attention import (
    dense_causal_attention as jax_attention,
)
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import ATTN_SCORE_BYTES
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.ops.attention import dense_causal_attention

torch.set_num_threads(2)

INT8_BAND = 0.05
BUCKETS = (16, 32, 64)
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=32,
             prefill_buckets=BUCKETS)
CACHE = dict(block_size=4, num_blocks=128)


# -- ops/attention.py --------------------------------------------------------

ATTN_CASES = {
    "gqa": (1, 19, 8, 2, 16, 0.0),
    "softcap": (1, 23, 4, 2, 32, 5.0),
    "batch": (2, 17, 6, 3, 8, 0.0),
}


@pytest.mark.parametrize("q_block", [1, 3, "S", None])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_dense_attention_matches_reference(case, q_block):
    B, S, H, KH, D, cap = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, KH, KH))
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), soft_cap=cap))
    got = dense_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        soft_cap=cap, q_block=S if q_block == "S" else q_block)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_dense_attention_keeps_q_dtype():
    q = torch.randn(1, 5, 4, 8, dtype=torch.bfloat16)
    k = torch.randn(1, 5, 2, 8, dtype=torch.bfloat16)
    out = dense_causal_attention(q, k, k, q_block=2)
    assert out.dtype == torch.bfloat16
    want = dense_causal_attention(q.float(), k.float(), k.float())
    torch.testing.assert_close(out.float(), want, atol=1e-2, rtol=2 ** -7)


# -- the runner's three functions, four models --------------------------------

MODELS = {
    "tiny-llama": ("tiny-llama", None),
    "tiny-gemma2": ("tiny-gemma2", None),
    "tiny-mixtral": ("tiny-mixtral", None),
    "tiny-llama-int8": ("tiny-llama", "int8"),
}


@pytest.fixture(scope="module")
def pairs():
    """Model name -> (JAX engine, port engine) on one weight set."""
    mesh = build_mesh(MeshConfig(data=1, tensor=1))
    cache = {}

    def get(name):
        if name not in cache:
            preset, quant = MODELS[name]
            jm = jcfg.ModelConfig.from_pretrained(preset, quant=quant)
            tm = tcfg.ModelConfig.from_pretrained(preset, quant=quant)
            params = jax_init(jcfg.ModelConfig.from_pretrained(preset), mesh,
                              seed=0)
            np_params = jax.tree.map(np.asarray, jax.device_get(params))
            jeng = JaxEngine(jcfg.EngineConfig(
                model=jm, cache=jcfg.CacheConfig(**CACHE),
                scheduler=jcfg.SchedulerConfig(**SCHED),
                mesh=MeshConfig(data=1, tensor=1)),
                mesh=mesh, params=params, num_blocks=CACHE["num_blocks"])
            teng = LLMEngine(tcfg.EngineConfig(
                model=tm, cache=tcfg.CacheConfig(**CACHE),
                scheduler=tcfg.SchedulerConfig(**SCHED)),
                params=params_from_jax(np_params, tm, "cpu"), device="cpu")
            cache[name] = (jeng, teng)
        return cache[name]

    return get


def _lp_tol(name):
    return INT8_BAND if name.endswith("int8") else LP_TOL


def _tokens(rng, n, S):
    t = np.zeros((1, S), np.int32)
    t[0, :n] = rng.integers(1, 500, n)
    return t


@pytest.mark.parametrize("name", sorted(MODELS))
def test_runner_pooled_embed_matches_reference(pairs, name):
    jeng, teng = pairs(name)
    rng = np.random.default_rng(1)
    tokens = _tokens(rng, 45, 64)
    mask = (tokens != 0).astype(np.int32)
    want = np.asarray(jeng.runner.pooled_embed(tokens, mask))
    got = teng.runner.pooled_embed(tokens, mask)
    assert got.shape == want.shape == (1, teng.config.model.hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_runner_sequence_logprobs_matches_reference(pairs, name):
    """64 choices over a 9-token prompt (row groups), and 3 over a
    40-token one (forwards longer than the 32-token MLP chunk)."""
    jeng, teng = pairs(name)
    rng = np.random.default_rng(2)
    for n_choices, p_len, S in ((64, 9, 16), (3, 40, 64)):
        tokens = np.zeros((n_choices, S), np.int32)
        cont = np.zeros((n_choices, S), bool)
        prompt = rng.integers(1, 500, p_len)
        for i in range(n_choices):
            c = rng.integers(1, 500, 1 + i % 5)
            tokens[i, :p_len + len(c)] = np.concatenate([prompt, c])
            cont[i, p_len:p_len + len(c)] = True
        want = np.asarray(jeng.runner.sequence_logprobs(tokens, cont))
        got = teng.runner.sequence_logprobs(tokens, cont)
        assert got.shape == (n_choices,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=_lp_tol(name))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_runner_prompt_logprobs_matches_reference(pairs, name):
    """A 150-token prompt padded to 256: two LM-head chunks of 128."""
    jeng, teng = pairs(name)
    tokens = _tokens(np.random.default_rng(3), 150, 256)
    w_lp, w_ids, w_lps = (np.asarray(x) for x in
                          jeng.runner.prompt_logprobs(tokens))
    g_lp, g_ids, g_lps = teng.runner.prompt_logprobs(tokens)
    assert g_lp.shape == (255,) and g_ids.shape == w_ids.shape
    live = slice(0, 149)
    tol = _lp_tol(name)
    np.testing.assert_allclose(g_lp[live], w_lp[live], rtol=0, atol=tol)
    np.testing.assert_allclose(g_lps[live], w_lps[live], rtol=0, atol=tol)
    # a rank's id agrees wherever the reference's logprob there is clear
    # of both neighbours' by more than twice the tolerance
    gap = np.abs(np.diff(w_lps[live], axis=1)) > 2 * tol
    edge = np.ones((gap.shape[0], 1), bool)
    clear = np.concatenate([edge, gap], 1) & np.concatenate([gap, edge], 1)
    assert clear[:, 0].sum() > 100
    np.testing.assert_array_equal(g_ids[live][clear], w_ids[live][clear])


# -- the engine's scoring surface ---------------------------------------------

@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


@pytest.fixture(scope="module")
def llama_pair(weights):
    jconf, tconf = engine_configs("ragged", block_size=4, num_blocks=128,
                                  **SCHED)
    return jax_engine(weights, jconf), port_engine(weights, tconf)


PROMPT = list(np.random.default_rng(4).integers(1, 500, 37))
LONG = list(np.arange(1, 101) % 500)  # 100 tokens > the top bucket


@pytest.mark.parametrize("prompt,choices", [
    (PROMPT, [[10, 11], [12], [13, 14, 15]]),
    (LONG, [[10, 11], [12]]),  # past the top bucket: padded to 128
    (PROMPT[:3], [[i, i + 1] for i in range(1, 65)]),  # 64 choices
])
def test_engine_choice_logprobs_matches_reference(llama_pair, prompt,
                                                  choices):
    jeng, teng = llama_pair
    want = jeng.choice_logprobs(prompt, choices)
    got = teng.choice_logprobs(prompt, choices)
    assert len(got) == len(choices)
    np.testing.assert_allclose(got, want, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_engine_prompt_logprobs_matches_reference(llama_pair, n):
    jeng, teng = llama_pair
    ids = PROMPT[:n] if n <= len(PROMPT) else LONG[:n]
    want = jeng.prompt_logprobs(ids)
    got = teng.prompt_logprobs(ids)
    assert len(got) == len(want) == max(n - 1, 0)
    for (wl, wtop), (gl, gtop) in zip(want, got):
        assert abs(wl - gl) <= LP_TOL
        assert len(gtop) == len(wtop)
        for (_, a), (_, b) in zip(wtop, gtop):
            assert abs(a - b) <= LP_TOL


@pytest.mark.parametrize("n", [1, 16, 37, 64])
def test_engine_embed_matches_reference(llama_pair, n):
    jeng, teng = llama_pair
    ids = (PROMPT + LONG)[:n]
    np.testing.assert_allclose(teng.embed(ids), np.asarray(jeng.embed(ids)),
                               rtol=1e-4, atol=1e-5)


def test_embed_past_the_top_bucket_is_the_reference_runner_vector(
        llama_pair):
    """The reference's fault, not carried over: its embed pads to the
    clamped bucket (64) and raises on 100 tokens; the port pads to 128 and
    returns what the reference's own runner gives on those tokens."""
    jeng, teng = llama_pair
    with pytest.raises(ValueError, match="broadcast"):
        jeng.embed(LONG)
    tokens = np.zeros((1, 128), np.int32)
    tokens[0, :100] = LONG
    mask = (np.arange(128) < 100).astype(np.int32)[None]
    want = np.asarray(jeng.runner.pooled_embed(tokens, mask))[0]
    np.testing.assert_allclose(teng.embed(LONG), want, rtol=1e-4, atol=1e-5)


# -- sleep mode ---------------------------------------------------------------

GREEDY = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True)
SLEEP_PROMPTS = [PROMPT[:11], LONG[:29]]


def _greedy(eng, tag):
    reqs = [(f"{tag}{i}", p, GREEDY) for i, p in enumerate(SLEEP_PROMPTS)]
    return [drain(eng, reqs)[0][r[0]] for r in reqs]


@pytest.mark.parametrize("level", [1, 2])
def test_sleep_and_wake(level):
    """The port's engine from its own seeded weights, so a level-2 wake
    makes the same weights again."""
    _, tconf = engine_configs("ragged", block_size=4, num_blocks=64, **SCHED)
    eng = LLMEngine(tconf, device="cpu")
    before = _greedy(eng, "a")
    pool_blocks = eng.runner.num_blocks
    eng.sleep_mode(level)
    assert eng.sleep_level == level and eng.runner.kv is None
    assert not eng.runner.kv_alive
    assert (eng.runner.params is None) == (level == 2)
    assert eng.runner.params_alive == (level == 1)
    # the prefix cache went with the pool
    assert eng.scheduler.allocator.num_free_blocks == pool_blocks
    eng.wake_mode()
    assert eng.sleep_level == 0 and eng.runner.kv_alive
    assert eng.runner.params_alive
    assert _greedy(eng, "b") == before


def test_sleep_refused_with_unfinished_requests(weights):
    _, tconf = engine_configs("ragged", block_size=4, num_blocks=64, **SCHED)
    eng = port_engine(weights, tconf)
    eng.add_request("r", prompt_token_ids=PROMPT[:9], sampling=GREEDY)
    eng.step()
    with pytest.raises(RuntimeError, match="unfinished"):
        eng.sleep_mode(1)
    assert eng.runner.kv_alive and eng.sleep_level == 0
    while eng.has_unfinished():
        eng.step()


def test_host_tier_still_demotes_after_sleep(weights):
    """A pool of 24 blocks with a host tier: after a level-1 sleep and a
    wake, the rebuilt allocator's evictions are copied down to the host,
    and a prompt the pool lost comes back from the host tier with the
    tokens it had before."""
    _, tconf = engine_configs("ragged", block_size=4, num_blocks=24,
                              max_num_seqs=4, max_num_batched_tokens=64)
    tconf.cache.host_offload_blocks = 64
    eng = port_engine(weights, tconf)
    rng = np.random.default_rng(7)
    wave_a = [rng.integers(1, 500, 30).tolist() for _ in range(2)]
    wave_b = [rng.integers(1, 500, 30).tolist() for _ in range(4)]
    sp = dataclasses.replace(GREEDY, max_tokens=4)
    try:
        first = drain(eng, [(f"a{i}", p, sp) for i, p in enumerate(wave_a)])
        eng.sleep_mode(1)
        assert eng.scheduler.allocator.evict_hook == eng._demote_evicted_block
        eng.wake_mode()
        drain(eng, [(f"w{i}", p, sp) for i, p in enumerate(wave_a)])
        # empty the host copies of A, so the pool's evictions must demote
        with eng.host_kv._lock:
            for h in [h for p in wave_a for h in eng.host_kv.chain_hashes(p)]:
                slab = eng.host_kv.store.pop(h, None)
                if slab is not None:
                    eng.host_kv.used_bytes -= slab.nbytes
        demoted = eng.hbm_demotions
        drain(eng, [(f"b{i}", p, sp) for i, p in enumerate(wave_b)])
        assert eng.hbm_demotions > demoted
        hits = eng.host_kv.hits
        again = drain(eng, [(f"c{i}", p, sp) for i, p in enumerate(wave_a)])
        assert eng.host_kv.hits > hits
        assert [again[0][f"c{i}"] for i in range(2)] == [
            first[0][f"a{i}"] for i in range(2)]
    finally:
        eng.shutdown_tiers()


# -- the reserve ---------------------------------------------------------------

def test_reserve_covers_the_scoring_peak(weights):
    """The runner reserves the larger of a step's and the scoring path's
    transients, and a query block's float32 scores stay within
    ``ATTN_SCORE_BYTES`` at every admitted length."""
    _, tconf = engine_configs("ragged", block_size=4, num_blocks=64, **SCHED)
    runner = port_engine(weights, tconf).runner
    assert runner.score_tokens() == 512  # tiny-llama's max_model_len
    assert runner._transient_bytes() >= runner.score_bytes()
    H = runner.cfg.num_heads
    for N, S in ((1, 512), (64, 16), (3, 64), (1, 1)):
        g, blk = runner._score_groups(N, S)
        assert 1 <= g <= N and g * S <= max(S, runner.score_tokens())
        assert g * H * blk * S * 4 <= max(ATTN_SCORE_BYTES, g * H * S * 4)
