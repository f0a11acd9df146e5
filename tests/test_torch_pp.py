"""Pipeline parallelism in the port against the JAX engine's, on the CPU.

The port's counterpart of ``tests/test_pp_engine.py`` (every case but
pp 2 x tp 2, which tests/test_torch_pp_tp.py holds) at its configs: tiny-llama
in float32 with ``params_from_jax`` weights, ``block_size=4``,
``prefill_buckets=(16, 32)``, ``max_num_seqs=4``, prompts from a numpy
seed.

- The engine: at ``MeshConfig(stage=2)`` the runner holds two stages of
  one layer each, each with its own KV pool; greedy tokens equal the JAX
  engine's at ``stage=2`` and the port's at pp 1 up to a near-tie (a
  top-2 gap under ``TIE_GAP`` in pp 1's run, which alone can ask for
  logprobs); so do multi-step 4, seeded sampling and penalties, a LoRA
  adapter and one tiny-mixtral case (against the JAX engine at stage 2).
  The prefix cache serves 8 tokens of a repeated 9-token prompt. A KV
  export joins the layer axis (equal, bit for bit, to pp 1's) and an
  import into another pp 2 engine is a prefix hit; so for the tiers'
  slabs. Sleep level 2 and wake give the same tokens, seeded weights
  equal to pp 1's. Pooled embeddings are within 2e-3 of pp 1's and the
  JAX engine's at stage 2, ``guided_choice`` scores within 1e-4 of pp
  1's. pp 4 over four layers equals pp 1; a layer count S does not
  divide is refused.
- Weights: a stage's seeded (and int8) share, its ``params_from_jax``
  share and its checkpoint share are bit for bit the slices of the whole.
- Refusals, as the reference's: logprobs (a ValueError, a 400), guided
  regex and JSON; Whisper at pp 2 (and at pp 2 x tp 2), seq x pp,
  multi-host with stages and a stage device that does not exist exit at
  start, naming what was refused. pp x tp serves: tests/test_torch_pp_tp.py.
- The server at ``--pipeline-parallel-size 2 --device cpu``: completions,
  a stream, chat, embeddings, sleep and wake, an adapter, the KV routes.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain, tiny_weights, top2_gaps
from test_torch_lora import make_adapter_dir
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.parallel.mesh import MeshConfig as JaxMesh
from production_stack_tpu.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine import weights as tweights
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import LoraManager
from production_stack_tpu_torch.engine.pp_runner import StagedModelRunner
from production_stack_tpu_torch.engine.quant import quantize_params
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.whisper_runner import WhisperRunner
from production_stack_tpu_torch.parallel.mesh import MeshConfig

torch.set_num_threads(1)

NUM_BLOCKS = 128
SCHED = dict(max_num_seqs=4, max_num_batched_tokens=64,
             prefill_buckets=(16, 32))
GREEDY = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
LP = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True,
                    logprobs=2)
_rng = np.random.default_rng(19)
# five requests on four slots, one longer than the top bucket (chunked)
PROMPTS = [_rng.integers(1, 500, int(n)).tolist() for n in (5, 3, 7, 40, 12)]


def reqs(sp, prompts=PROMPTS, adapters=None):
    return [(f"r{i}", p, sp, adapters[i] if adapters else 0)
            for i, p in enumerate(prompts)]


def port_engine(stage: int, params=None, model="tiny-llama",
                multi_step: int = 1, **model_kw) -> LLMEngine:
    cfg = tcfg.EngineConfig.for_model(
        model, cache=tcfg.CacheConfig(block_size=4, num_blocks=NUM_BLOCKS),
        scheduler=tcfg.SchedulerConfig(multi_step=multi_step, **SCHED),
        attention_impl="bucketed", mesh=MeshConfig(stage=stage, tensor=1),
        **model_kw)
    return LLMEngine(cfg, params=params, num_blocks=NUM_BLOCKS, device="cpu")


def jax_engine(stage: int, params, model="tiny-llama") -> JaxEngine:
    cfg = jcfg.EngineConfig(
        model=jcfg.ModelConfig.from_pretrained(model),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=NUM_BLOCKS),
        scheduler=jcfg.SchedulerConfig(**SCHED),
        mesh=JaxMesh(data=1, stage=stage, tensor=1))
    mesh = build_mesh(cfg.mesh, devices=jax.devices()[:stage])
    return JaxEngine(cfg, mesh=mesh, params=params, num_blocks=NUM_BLOCKS)


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


@pytest.fixture(scope="module")
def pp1(weights):
    return port_engine(1, weights[2])


@pytest.fixture(scope="module")
def pp2(weights):
    return port_engine(2, weights[2])


@pytest.fixture(scope="module")
def jax2(weights):
    return jax_engine(2, weights[1])


@pytest.fixture(scope="module")
def ref(pp1):
    """pp 1's greedy run with logprobs: the near-tie gaps."""
    return drain(pp1, reqs(LP))


# -- the engine ---------------------------------------------------------------

def test_pp2_equals_jax_stage2_and_pp1(pp2, jax2, ref):
    runner = pp2.runner
    assert isinstance(runner, StagedModelRunner)
    assert [r.cfg.num_layers for r in runner.stages] == [1, 1]
    pools = [r.kv for r in runner.stages]
    assert pools[0] is not pools[1]
    assert [tuple(p.shape[:2]) for p in pools] == [(1, NUM_BLOCKS)] * 2
    gaps = top2_gaps(ref[1])
    got = drain(pp2, reqs(GREEDY))
    assert_same(drain(jax2, reqs(GREEDY)), got, gaps)
    assert_same(ref, got)


def test_pp2_multi_step_token_identical(weights, ref):
    got = drain(port_engine(2, weights[2], multi_step=4), reqs(GREEDY))
    assert_same(ref, got)


@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.8, top_k=40, seed=123, max_tokens=6,
                   ignore_eos=True),
    SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True,
                   presence_penalty=1.5, frequency_penalty=0.5)],
    ids=["seeded-sampling", "penalties"])
def test_pp2_sampling_matches_pp1(pp1, pp2, sp):
    assert drain(pp2, reqs(sp)) == drain(pp1, reqs(sp))


def test_pp2_prefix_cache_and_decode(pp2):
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    prompt = list(range(101, 110))
    first = drain(pp2, [("first", prompt, sp)])[0]["first"]
    pp2.add_request("again", prompt_token_ids=prompt, sampling=sp)
    toks, cached = [], 0
    while pp2.has_unfinished():
        for out in pp2.step():
            toks.extend(out.new_token_ids)
            cached = max(cached, out.num_cached_tokens)
    assert toks == first
    assert cached == 8  # two full blocks of the 9-token prompt


def test_pp2_kv_export_import_joins_the_layers(weights):
    prompt = list(range(201, 213))
    sp = SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True)
    exports = []
    for stage in (1, 2):
        eng = port_engine(stage, weights[2])
        seq = eng.add_request("p", prompt_token_ids=prompt, sampling=sp)
        eng.step()
        blocks = list(seq.block_ids[:2])
        while eng.has_unfinished():
            eng.step()
        exports.append((eng.export_kv(blocks),
                        eng.runner.export_slabs(blocks)))
    (want, want_slabs), (data, slabs) = exports
    # the layer axis joined across the stages: (L, n, bs, 2KH, D)
    assert tuple(data.shape[:2]) == (2, 2)
    assert torch.equal(data, want)
    assert all(torch.equal(a, b) for a, b in zip(slabs, want_slabs))
    fresh = port_engine(2, weights[2])
    assert fresh.import_kv(prompt, data) == 8
    got = drain(fresh, [("p", prompt, sp)])
    assert got[0]["p"] == drain(port_engine(1, weights[2]),
                                [("p", prompt, sp)])[0]["p"]
    # the tiers' slabs go back in, cut by layer, as they came out
    fresh.runner.import_slabs([5, 6], slabs)
    assert torch.equal(fresh.export_kv([5, 6]), data)


def test_pp2_sleep_wake():
    """Seeded weights (sleep level 2 makes them again from the seed): a
    stage's share is the slice of pp 1's."""
    eng = port_engine(2)
    sp = SamplingParams(temperature=0.0, max_tokens=3, ignore_eos=True)
    before = drain(eng, reqs(sp, PROMPTS[:1]))
    assert before == drain(port_engine(1), reqs(sp, PROMPTS[:1]))
    eng.sleep_mode(2)
    assert not eng.runner.kv_alive and not eng.runner.params_alive
    eng.wake_mode()
    assert eng.runner.kv_alive and eng.runner.params_alive
    assert drain(eng, reqs(sp, PROMPTS[:1])) == before


def test_pp2_pooled_embed_matches(pp1, pp2, jax2):
    tokens = PROMPTS[2]
    want = pp1.embed(tokens)
    got = pp2.embed(tokens)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, jax2.embed(tokens), rtol=2e-3,
                               atol=2e-3)


def test_pp2_guided_choice_scores_match(pp1, pp2):
    prompt, choices = PROMPTS[0], [[7, 8], [9], [10, 11, 12]]
    np.testing.assert_allclose(pp2.choice_logprobs(prompt, choices),
                               pp1.choice_logprobs(prompt, choices),
                               rtol=0, atol=1e-4)


def test_pp2_lora_matches_pp1(tmp_path, pp1, pp2):
    adapter = make_adapter_dir(str(tmp_path), tcfg.ModelConfig.from_pretrained(
        "tiny-llama"), seed=5)
    managers = [LoraManager(e) for e in (pp1, pp2)]
    for m in managers:
        m.load("a", adapter)
    slots = [1, 0, 1, 1, 0]
    try:
        assert pp2.runner.lora_roots[1] == pp1.runner.lora_roots[1]
        want = drain(pp1, reqs(LP, adapters=slots))
        got = drain(pp2, reqs(GREEDY, adapters=slots))
        base = drain(pp2, reqs(GREEDY))
    finally:
        for m in managers:
            m.unload("a")
    assert_same(want, got)
    assert got[0]["r0"] != base[0]["r0"]


def test_pp2_tiny_mixtral_matches_jax_stage2():
    jc = jcfg.ModelConfig.from_pretrained("tiny-mixtral")
    mesh = build_mesh(JaxMesh(data=1, tensor=1))
    jparams = jax_init(jc, mesh, seed=0)
    params = tweights.params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(jparams)),
        tcfg.ModelConfig.from_pretrained("tiny-mixtral"))
    ref = drain(port_engine(1, params, "tiny-mixtral"), reqs(LP))
    got = drain(port_engine(2, params, "tiny-mixtral"), reqs(GREEDY))
    assert_same(ref, got)
    want = drain(jax_engine(2, jparams, "tiny-mixtral"), reqs(GREEDY))
    assert_same(want, got, top2_gaps(ref[1]))


def test_pp4_equals_pp1_and_uneven_stages_are_refused():
    ref = drain(port_engine(1, num_layers=4), reqs(LP))
    eng = port_engine(4, num_layers=4)
    assert [r.cfg.num_layers for r in eng.runner.stages] == [1] * 4
    assert_same(ref, drain(eng, reqs(GREEDY)))
    with pytest.raises(ValueError, match="4 layers not divisible by 3"):
        port_engine(3, num_layers=4)


def test_pp2_warmup_skips_what_it_lacks(weights):
    eng = port_engine(2, weights[2])
    eng.warmup()
    assert not eng.has_unfinished()


# -- weights ------------------------------------------------------------------

def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("name,quant", [("tiny-llama", None),
                                        ("tiny-gemma", None),
                                        ("tiny-llama", "int8")])
def test_seeded_stage_share_is_the_slice(name, quant):
    cfg = tcfg.ModelConfig.from_pretrained(name, num_layers=4)
    if quant:
        cfg = tcfg.ModelConfig.from_pretrained(name, num_layers=4,
                                               quant=quant)
    whole = tweights.init_random(cfg, seed=3)
    for stage in [(0, 2), (1, 2), (2, 4), (3, 4)]:
        share = tweights.init_random(cfg, 3, stage=stage)
        assert _equal(share, tweights.stage_params(whole, cfg, stage))
    tied = cfg.tie_word_embeddings
    last = tweights.init_random(cfg, 3, stage=(1, 2))
    assert ("embed" in last) == tied and ("lm_head" in last) != tied


def test_jax_and_checkpoint_stage_shares_are_the_slices(tmp_path, weights):
    from test_torch_checkpoint import write_checkpoint

    cfg = tcfg.ModelConfig.from_pretrained("tiny-llama")
    np_params = jax.tree.map(np.asarray, jax.device_get(weights[1]))
    whole = tweights.params_from_jax(np_params, cfg)
    ck = tcfg.ModelConfig.from_pretrained(
        write_checkpoint(str(tmp_path), "tiny-llama"))
    ck_whole = tweights.load_safetensors(ck)
    for stage in [(0, 2), (1, 2)]:
        assert _equal(tweights.params_from_jax(np_params, cfg, stage=stage),
                      tweights.stage_params(whole, cfg, stage))
        assert _equal(tweights.load_safetensors(ck, stage=stage),
                      tweights.stage_params(ck_whole, ck, stage))
    q = quantize_params(cfg, whole)
    share = tweights.stage_params(q, cfg, (1, 2))
    assert torch.equal(share["layers"]["wq"]["q"], q["layers"]["wq"]["q"][1:])


# -- refusals -------------------------------------------------------------------

def test_pp2_refuses_logprobs_and_guided(pp2):
    with pytest.raises(ValueError, match="pipeline parallelism"):
        pp2.add_request("lp", prompt_token_ids=[1, 2, 3],
                        sampling=SamplingParams(logprobs=2))
    for kw in ({"guided_regex": "[a-z]+"},
               {"guided_json": {"type": "object"}}):
        with pytest.raises(ValueError, match="pipeline parallelism"):
            pp2.add_request("g", prompt_token_ids=[1, 2, 3],
                            sampling=SamplingParams(max_tokens=4, **kw))
    assert not pp2.has_unfinished()
    out = pp2.generate([[1, 2, 3]], SamplingParams(temperature=0.0,
                                                   max_tokens=2))
    assert len(out["offline-0"]) == 2


def _args(*extra):
    return tserver.build_parser().parse_args(
        ["--model", "tiny-llama", "--device", "cpu", *extra])


def test_pp_times_tp_and_whisper_exit_at_start():
    """What still exits at start once pp x tp serves
    (tests/test_torch_pp_tp.py): Whisper at pp 2 and at pp 2 x tp 2, and
    at seq x pp with or without tensor ranks, and multi-host serving with
    stages; each names what it refuses, and no process starts."""
    import multiprocessing

    from production_stack_tpu_torch.parallel.distributed import (
        DistributedConfig,
    )

    assert tserver.config_from_args(_args(
        "--pipeline-parallel-size", "2", "--tensor-parallel-size",
        "2")).mesh == MeshConfig(stage=2, tensor=2)
    for tp in ("1", "2"):
        args = tserver.build_parser().parse_args(
            ["--model", "tiny-whisper", "--device", "cpu",
             "--pipeline-parallel-size", "2", "--tensor-parallel-size", tp])
        with pytest.raises(SystemExit, match="Whisper under pipeline"):
            tserver.server_from_args(args)
        # seq x pp serves a text model (tests/test_torch_grid_engine.py);
        # a Whisper model there exits, naming the grid
        seq_pp = ("--pipeline-parallel-size", "2", "--sequence-parallel-size",
                  "2", "--tensor-parallel-size", tp)
        assert tserver.config_from_args(_args(*seq_pp)).mesh == MeshConfig(
            stage=2, seq=2, tensor=int(tp))
        with pytest.raises(SystemExit, match="Whisper under sequence(,| "
                           "and) pipeline"):
            tserver.config_from_args(_args(*seq_pp, "--model",
                                           "tiny-whisper"))
        with pytest.raises(ValueError, match="Whisper.*sequence(,| and) "
                           "pipeline"):
            LLMEngine(tcfg.EngineConfig.for_model(
                "tiny-whisper", mesh=MeshConfig(stage=2, seq=2,
                                                tensor=int(tp))),
                device="cpu")
    with pytest.raises(ValueError, match="Whisper under pipeline"):
        WhisperRunner(tcfg.EngineConfig.for_model(
            "tiny-whisper", mesh=MeshConfig(stage=2, tensor=1)),
            device="cpu")
    from production_stack_tpu_torch.engine.multihost import check_group

    with pytest.raises(ValueError, match="staged pipeline runner"):
        check_group(tcfg.EngineConfig.for_model(
            "tiny-llama", mesh=MeshConfig(stage=2, tensor=2)),
            DistributedConfig("127.0.0.1:1", 4, 0), "tensor", 2)
    assert multiprocessing.active_children() == []


def test_a_stage_without_its_card_exits():
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"stage 1 on cuda:{n}, but this "
                       f"machine has {n} CUDA card"):
        tserver.server_from_args(_args("--pipeline-parallel-size", "2"),
                                 stage_devices=["cpu", f"cuda:{n}"])


# -- the server -----------------------------------------------------------------

def _http(base, path, body=None):
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_serves_at_pp2(tmp_path):
    server = tserver.server_from_args(_args(
        "--skip-warmup", "--num-blocks", "64", "--max-num-seqs", "4",
        "--pipeline-parallel-size", "2"))
    assert server.config.mesh == MeshConfig(stage=2, tensor=1)
    try:
        base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
        status, raw = _http(base, "/debug/perf")
        assert status == 200 and json.loads(raw)["ranks"]["decode_graphs"] \
            is False
        body = {"model": "tiny-llama", "prompt": [1, 2, 3, 4],
                "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
        status, raw = _http(base, "/v1/completions", body)
        assert status == 200
        assert json.loads(raw)["usage"]["completion_tokens"] == 6
        status, raw = _http(base, "/v1/completions", {**body, "logprobs": 2})
        assert status == 400 and b"pipeline parallelism" in raw
        status, raw = _http(base, "/v1/completions",
                            {**body, "guided_regex": "[a-z]+"})
        assert status == 400 and b"pipeline parallelism" in raw
        status, raw = _http(base, "/v1/completions",
                            {**body, "guided_choice": ["yes", "no"]})
        assert status == 200
        status, raw = _http(base, "/v1/completions", {**body, "stream": True})
        assert status == 200 and raw.rstrip().endswith(b"data: [DONE]")
        status, _ = _http(base, "/v1/chat/completions", {
            "model": "tiny-llama", "max_tokens": 4,
            "messages": [{"role": "user", "content": "hi"}]})
        assert status == 200
        status, raw = _http(base, "/v1/embeddings",
                            {"model": "tiny-llama", "input": [[5, 6]]})
        assert status == 200
        assert len(json.loads(raw)["data"][0]["embedding"]) == 128
        assert _http(base, "/sleep?level=2", {})[0] == 200
        assert _http(base, "/wake_up", {})[0] == 200
        assert _http(base, "/v1/completions", body)[0] == 200
        adapter = make_adapter_dir(str(tmp_path),
                                   tcfg.ModelConfig.from_pretrained(
                                       "tiny-llama"), seed=1)
        lora = {"lora_name": "a", "lora_path": adapter}
        assert _http(base, "/v1/load_lora_adapter", lora)[0] == 200
        assert _http(base, "/v1/completions", {**body, "model": "a"})[0] == 200
        assert _http(base, "/v1/unload_lora_adapter", lora)[0] == 200
        # a real block out of /kv/export, equal to the engine's joined one
        prompt = list(range(1, 41))
        status, raw = _http(base, "/v1/completions", {
            **body, "prompt": prompt, "max_tokens": 1,
            "kv_transfer_params": {"do_remote_decode": True}})
        assert status == 200
        ids = json.loads(raw)["kv_transfer_params"]["remote_block_ids"]
        status, raw = _http(base, "/kv/export", {"blocks": ids[:2]})
        want = server.async_engine.run_on_engine(
            lambda e: e.export_kv(ids[:2]))
        assert status == 200 and raw == bytes(tkt.tensor_bytes(want))
        assert want.shape[0] == 2
    finally:
        server.shutdown()
