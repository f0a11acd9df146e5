"""Whisper under tensor parallelism in the port, against the JAX package's
``WhisperRunner`` at ``MeshConfig(tensor=2/4)`` and the port at tp 1, on
the CPU (float32 tiny-whisper).

- The logical axes (``whisper.param_specs``) are the reference's, the conv
  weights' in this package's ``(out, in, k)`` order; the rules for the
  Whisper presets are the reference's; a rank's seeded shard is bit for
  bit the slice of the tp 1 init.
- The sharded forward with one rank a thread (``_threads``), on weights
  whose biases and norms are not 0 and 1: encode, cross K/V and a decoder
  prefill and step at tp 2 and 4 equal tp 1 within 1e-5, so ``bo``,
  ``cbo`` and ``fc2_b`` are added once, after the sum.
- The runner: tp 2 and tp 4 on the reference's weights against the JAX
  runner at ``tensor=2/4`` and the port at tp 1, three clips (two at tp
  4), four modes:
  greedy tokens identical up to a near-tie (top-2 gap < 1e-4),
  ``no_speech_prob`` and logprobs within 1e-4, the language equal. A
  vocabulary of 418 at tp 4 (418 % 4 != 0) runs the replicated-vocab path,
  as whisper-large-v3-class's 51866 does at 4.
- Handles: three concurrent streams at ``--max-num-seqs 2``, one closed
  mid-stream, equal their sequential runs, and afterwards every rank's
  digest is rank 0's and no rank holds a live handle; nor after an SSE
  client of the tp 2 server leaves mid-stream.
- The tp 2 ``WhisperServer`` over HTTP answers the tp 1 server's bodies;
  the command line serves at ``--tensor-parallel-size 2`` and its
  followers leave within 3 s of SIGTERM.
- The runner at ``tensor=2`` never holds the whole model on one rank; a
  lost follower raises ``RankLost``; two ranks on cards this machine lacks
  raise before any process starts.

Every test that starts ranks runs under ``rank_limit`` (``_torch_tp``).
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from _torch_tp import alive, kill_pids, rank_limit, wait_gone
from _torch_whisper import TIE_GAP, WAVS, features, top2_gap
from test_torch_whisper_server import (
    CASES as SERVER_CASES,
    CTYPE as SERVER_CASE_CTYPE,
    TRANSLATE,
    _close,
    _get,
    _post,
    _sse_text,
    form,
)
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.whisper_runner import WhisperRunner as JaxRunner
from production_stack_tpu.models import whisper as jwhisper
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import shardings as jshard
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import multihost
from production_stack_tpu_torch.engine import whisper_runner as TWR
from production_stack_tpu_torch.engine.weights import (
    init_random,
    params_from_jax,
    shard_params,
)
from production_stack_tpu_torch.engine.whisper_server import WhisperServer
from production_stack_tpu_torch.models import whisper as TW
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import MeshConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LP_TOL = 1e-4
F32_TOL = 1e-5
# the runner's modes each clip is transcribed in
MODES = {
    "detect": dict(),
    "translate": dict(language="en", task="translate"),
    "timestamps": dict(language="en", timestamps=True),
    "prompt": dict(language="en", prompt="hello context"),
}


def _conf(tp: int, **model) -> tcfg.EngineConfig:
    return tcfg.EngineConfig.for_model("tiny-whisper", mesh=MeshConfig(
        tensor=tp), **model)


def _jax_runner(tp: int, **model):
    """The JAX runner at ``tensor=tp`` (its seed-0 init) and its weights
    as numpy."""
    jr = JaxRunner(jcfg.EngineConfig.for_model(
        "tiny-whisper", mesh=jmesh.MeshConfig(data=1, tensor=tp), **model))
    return jr, jax.tree.map(np.asarray, jax.device_get(jr.params))


def _port(tp: int, np_params: dict, **model):
    conf = _conf(tp, **model)
    return TWR.WhisperRunner(conf, device="cpu", params=params_from_jax(
        np_params, conf.model, "cpu"))


def assert_same_run(ref, feats, kw, want, got, want_info, got_info):
    """Tokens identical up to a near-tie (``ref``, a tp 1 runner,
    measures the gap); the logprobs before it within LP_TOL; language and
    no_speech_prob equal."""
    n = len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            gap = top2_gap(ref, feats, kw, want[:i])
            assert gap < TIE_GAP, (i, a, b, gap)
            n = i
            break
    else:
        assert want == got
    assert got_info["language"] == want_info["language"]
    assert abs(got_info["no_speech_prob"]
               - want_info["no_speech_prob"]) <= LP_TOL
    assert len(got_info["logprobs"]) == len(got)
    np.testing.assert_allclose(got_info["logprobs"][:n],
                               want_info["logprobs"][:n], atol=LP_TOL, rtol=0)


def _agree(runner, tp: int) -> list:
    """Every rank's report: rank 0's digest and call count on each, no
    divergence and no live handle anywhere."""
    reports = runner.follower_reports()
    assert [r["rank"] for r in reports] == list(range(tp))
    for r in reports:
        assert (r["digest"], r["calls"]) == (reports[0]["digest"],
                                            reports[0]["calls"]), r
        assert r["diverged_at"] is None and r["live"] == [], r
    return reports


# -- the logical axes and the shards ------------------------------------------

def _ref_mesh(tp: int):
    shape = {a: 1 for a in jmesh.MESH_AXES}
    shape[jmesh.AXIS_TENSOR] = tp
    return types.SimpleNamespace(shape=shape)


def test_param_specs_are_the_reference():
    cfg = tcfg.ModelConfig.from_pretrained("tiny-whisper")
    got = TW.param_specs(cfg)
    want = jwhisper.param_specs(jcfg.ModelConfig.from_pretrained(
        "tiny-whisper"))
    for name in ("conv1_w", "conv2_w"):  # (k, in, out) there
        want["enc"][name] = want["enc"][name][::-1]
    assert got == want
    shapes = TW.param_shapes(cfg)

    def same_tree(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                same_tree(a[k], b[k])
            else:
                assert len(a[k]) == len(b[k]), k

    same_tree(got, shapes)


@pytest.mark.parametrize("name,tp", [
    ("tiny-whisper", 2), ("tiny-whisper", 4), ("tiny-whisper", 3),
    ("whisper-small-class", 2), ("whisper-large-v3-class", 2),
    ("whisper-large-v3-class", 4)])
def test_rules_match_the_reference(name, tp):
    want = jshard.rules_for_model(jcfg.ModelConfig.from_pretrained(name),
                                  _ref_mesh(tp))
    got = tshard.rules_for_model(tcfg.ModelConfig.from_pretrained(name), tp)
    assert dict(got.rules) == dict(want.rules)
    vocab = tcfg.ModelConfig.from_pretrained(name).vocab_size
    assert (got.rules[tshard.VOCAB] is None) == bool(vocab % tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_seeded_and_converted_shards_are_slices(tp):
    cfg = tcfg.ModelConfig.from_pretrained("tiny-whisper")
    whole = init_random(cfg, seed=3)
    specs = TW.param_specs(cfg)
    np_whole = jax.tree.map(lambda t: t.numpy(), whole)
    np_whole["enc"]["conv1_w"] = np_whole["enc"]["conv1_w"].transpose(2, 1, 0)
    np_whole["enc"]["conv2_w"] = np_whole["enc"]["conv2_w"].transpose(2, 1, 0)
    for rank in range(tp):
        shard = tshard.Shard.of(cfg, rank, tp)
        seeded = init_random(cfg, seed=3, rank=rank, tp=tp)
        cut = shard_params(whole, cfg, rank, tp)
        conv = params_from_jax(np_whole, cfg, "cpu", rank, tp)

        def check(w, s, c, v, spec):
            for k in w:
                if isinstance(w[k], dict):
                    check(w[k], s[k], c[k], v[k], spec[k])
                    continue
                want = shard.cut(w[k], spec[k])
                for got in (s[k], c[k], v[k]):
                    assert got.is_contiguous() and torch.equal(got, want), k

        check(whole, seeded, cut, conv, specs)
        lp = seeded["dec"]["layers"]
        assert lp["cwq"].shape[2] == cfg.num_heads // tp
        assert lp["fc1"].shape[2] == cfg.intermediate_size // tp
        assert seeded["dec"]["embed"].shape[0] == cfg.vocab_size // tp
        assert seeded["dec"]["layers"]["bo"].shape == lp["bo"].shape


def test_followers_take_the_leaders_float32_math():
    """A follower sets the float32 math it is started with (the leader's
    ``float32_math``): a rank whose convolutions ran in TF32 where rank
    0's did not would feed the row-parallel sums other hidden states."""
    before = multihost.float32_math()
    want = {"precision": "high", "matmul_tf32": True, "cudnn_tf32": False}
    try:
        multihost.set_float32_math(want)
        assert multihost.float32_math() == want
    finally:
        multihost.set_float32_math(before)
    assert multihost.float32_math() == before


# -- the sharded forward, one rank a thread -----------------------------------

class _Exchange:
    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def swap(self, rank: int, x: torch.Tensor) -> list:
        self.slots[rank] = x.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _ThreadRank:
    """A RankGroup's collectives over threads (the sum in rank order)."""

    def __init__(self, ex: _Exchange, shard):
        self.ex, self.shard = ex, shard

    def all_reduce(self, x):
        parts = self.ex.swap(self.shard.rank, x.float())
        out = parts[0]
        for y in parts[1:]:
            out = out + y
        return out.to(x.dtype)

    def all_gather_last(self, x):
        return torch.cat(self.ex.swap(self.shard.rank, x), dim=-1)


def _threads(cfg, tp: int, fn) -> list:
    ex = _Exchange(tp)
    out, errors = [None] * tp, []

    def run(r):
        try:
            out[r] = fn(r, _ThreadRank(ex, tshard.Shard.of(cfg, r, tp)))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def _busy_params(cfg, seed: int) -> dict:
    """Seeded weights with biases and norm shifts drawn too (init makes
    them 0 and 1, which would hide a bias added on every rank)."""
    params = TW.init_params(cfg, seed)
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k.endswith("_b") or k in ("bq", "bv", "bo", "cbq", "cbv",
                                           "cbo"):
                tree[k] = torch.from_numpy(rng.normal(
                    0.0, 0.5, v.shape).astype(np.float32))

    fill(params)
    return params


def _forward(cfg, params, mel, tokens, group=None):
    """Encode, cross K/V, a prefill of ``tokens`` and one step after it."""
    local = cfg if group is None else dataclasses.replace(
        cfg, num_heads=group.shard.local(tshard.HEADS, cfg.num_heads))
    enc = TW.encode(cfg, params, mel, group)
    ck, cv = TW.cross_kv(cfg, params, enc)
    kv = TW.init_self_kv(local, 1, cfg.max_model_len)
    pre, kv = TW.decode_tokens(cfg, params, torch.tensor([tokens]), [0], kv,
                               ck, cv, [len(tokens) - 2], group)
    nxt = torch.tensor([[int(pre[0, len(tokens) - 3].argmax())]])
    step, kv = TW.decode_tokens(cfg, params, nxt, [len(tokens) - 2], kv,
                                ck, cv, [1], group)
    return enc, ck, cv, pre, step


@pytest.mark.parametrize("tp,vocab", [(2, 416), (4, 416), (4, 418)])
def test_sharded_forward_adds_the_biases_once(tp, vocab):
    cfg = dataclasses.replace(tcfg.ModelConfig.from_pretrained(
        "tiny-whisper"), vocab_size=vocab)
    params = _busy_params(cfg, seed=5)
    rng = np.random.default_rng(5)
    mel = torch.from_numpy(rng.normal(0, 1, (1, cfg.num_mel_bins, 100))
                           .astype(np.float32))
    tokens = [cfg.sot_id, cfg.lang_base_id, cfg.transcribe_id,
              cfg.notimestamps_id, 7, 9, 0, 0]
    with torch.inference_mode():
        want = _forward(cfg, params, mel, tokens)
        got = _threads(cfg, tp, lambda r, g: _forward(
            cfg, shard_params(params, cfg, r, tp), mel, tokens, g))
    sharded_vocab = vocab % tp == 0
    for r, (enc, ck, cv, pre, step) in enumerate(got):
        lo, hi = tshard.Shard.of(cfg, r, tp).cuts[tshard.HEADS]
        torch.testing.assert_close(enc, want[0], atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(ck, want[1][:, :, lo:hi], atol=F32_TOL,
                                   rtol=F32_TOL)
        torch.testing.assert_close(cv, want[2][:, :, lo:hi], atol=F32_TOL,
                                   rtol=F32_TOL)
        n = len(tokens) - 2
        torch.testing.assert_close(pre[:, :n], want[3][:, :n], atol=F32_TOL,
                                   rtol=F32_TOL)
        torch.testing.assert_close(step, want[4], atol=F32_TOL, rtol=F32_TOL)
    assert (tshard.VOCAB in tshard.Shard.of(cfg, 0, tp).sharded) == \
        sharded_vocab
    # the check has teeth: the encoder's biases counted on every rank
    twice = _busy_params(cfg, seed=5)
    twice["enc"]["layers"]["bo"] = twice["enc"]["layers"]["bo"] * tp
    with torch.inference_mode():
        assert (TW.encode(cfg, twice, mel) - want[0]).abs().max() > 1e-2


# -- runners that start ranks of their own ---------------------------------

@pytest.mark.parametrize("vocab", [416, 418])
def test_tp4_matches_the_reference_and_tp1(vocab):
    """418 % 4 != 0: the vocabulary is whole on every rank, its products
    not summed and its logits not gathered."""
    jr, npp = _jax_runner(4, vocab_size=vocab)
    one = _port(1, npp, vocab_size=vocab)
    with rank_limit(120):
        four = _port(4, npp, vocab_size=vocab)
        try:
            assert four.dev.params["dec"]["embed"].shape[0] == (
                vocab // 4 if vocab % 4 == 0 else vocab)
            assert four.dev.params["dec"]["layers"]["cwk"].shape[2] == 1
            # tp 2 runs all three clips; one at 418, where the replicated
            # vocabulary is what the case adds
            _against(jr, one, four,
                     ("tone-8k", "noise-44k-stereo") if vocab == 416
                     else ("noise-44k-stereo",))
            _agree(four, 4)
        finally:
            four.close()


def test_a_lost_follower_raises_rank_lost():
    conf = _conf(2)
    with rank_limit(60):
        runner = TWR.WhisperRunner(conf, device="cpu")
        try:
            feats = features(runner, "tone-8k")
            assert runner.transcribe(feats, language="en", max_tokens=2)
            (proc,) = runner.dev.procs
            proc.kill()
            proc.join(10)
            with pytest.raises(multihost.RankLost, match="rank 1"):
                runner.transcribe(feats, language="en", max_tokens=2)
            # the admission slot came back all the same
            assert runner.admit.acquire(timeout=1)
            runner.admit.release()
        finally:
            runner.close()


def test_ranks_on_cards_this_machine_lacks_raise_before_starting():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    import multiprocessing

    with pytest.raises(RuntimeError, match="CUDA card"):
        TWR.WhisperRunner(_conf(2), device="cuda")
    assert multiprocessing.active_children() == []


def _followers(pid: int) -> list:
    """The spawned rank processes whose parent is ``pid``."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid and b"spawn_main" in cmd:
            out.append(int(d))
    return out


def test_command_line_serves_at_tp2_and_its_ranks_leave_on_sigterm():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", "tiny-whisper", "--device", "cpu", "--host",
         "127.0.0.1", "--port", str(port), "--tensor-parallel-size", "2"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"
    pids = []
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                _get(base, "/health")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        pids = _followers(proc.pid)
        assert len(pids) == 1 and alive(pids[0])
        status, _, _ = _post(base, TRANSLATE, form(
            language="en", response_format="verbose_json"))
        assert status == 200
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert wait_gone(pids, 3.0) == [], "a rank outlived SIGTERM by 3 s"
        assert time.monotonic() - t0 < 3.0
        assert proc.wait(timeout=30) == 0
        assert b"(whisper)" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        kill_pids(pids)


# -- one tp 2 runner for the rest of the module ------------------------------
#
# Its follower lives until the module ends: every test that starts ranks
# of its own runs above, since ``rank_limit`` kills every child on its way
# out.

@pytest.fixture(scope="module")
def tp2():
    """The JAX runner at tensor=2, and the port at tp 2 and tp 1 on its
    weights."""
    jr, npp = _jax_runner(2)
    one = _port(1, npp)
    with rank_limit(180):
        two = _port(2, npp)
        yield jr, one, two
        two.close()


def _against(jr, one, tn, wavs=tuple(WAVS)) -> None:
    for wav in wavs:
        feats = features(one, wav)
        for kw in MODES.values():
            runs = []
            for r in (jr, one, tn):
                info: dict = {}
                runs.append((r.transcribe(feats, info=info, **kw), info))
            (jt, ji), (ot, oi), (nt, ni) = runs
            assert nt, "nothing generated"
            assert_same_run(one, feats, kw, jt, nt, ji, ni)
            assert_same_run(one, feats, kw, ot, nt, oi, ni)


def test_tp2_matches_the_reference_and_tp1(tp2):
    jr, one, two = tp2
    _against(jr, one, two)
    assert two.detect_language(features(one, "noise-44k-stereo")) == \
        jr.detect_language(features(jr, "noise-44k-stereo"))
    _agree(two, 2)


def test_tp2_never_runs_the_whole_model_alone(tp2):
    """At ``tensor=2`` the runner holds no parameters, and each rank
    holds half of the heads, the MLP and the vocabulary: the reference's
    construction (tests/test_whisper.py) must not serve unsharded."""
    _, one, two = tp2
    assert two.params is None
    cfg = two.cfg
    held = two.held_by_rank()
    whole = one.held_bytes()["params"]
    assert len(held) == 2
    for h in held:
        assert h["params"] < 0.6 * whole
    dec = two.dev.params["dec"]
    assert dec["embed"].shape == (cfg.vocab_size // 2, cfg.hidden_size)
    assert dec["layers"]["wq"].shape[2] == cfg.num_heads // 2
    assert dec["layers"]["fc1"].shape[2] == cfg.intermediate_size // 2
    # a live request holds half of tp 1's cross and self K/V on each rank
    feats = features(one, "tone-8k")
    stream = two.transcribe_stream(feats, language="en")
    next(stream)
    one_stream = one.transcribe_stream(feats, language="en")
    next(one_stream)
    (tp1_bytes,) = one.held_bytes()["requests"].values()
    for h in two.held_by_rank():
        (got,) = h["requests"].values()
        assert got * 2 == tp1_bytes
    stream.close()
    one_stream.close()
    assert all(h["requests"] == {} for h in two.held_by_rank())


def test_concurrent_streams_free_every_handle(tp2, monkeypatch):
    """Three streams at ``--max-num-seqs 2`` (the third waits for a slot),
    one closed after its first chunk: each equals its sequential run, and
    no rank holds a handle afterwards."""
    monkeypatch.setattr(TWR, "DECODE_CHUNK", 4)  # many chunks a clip
    jr, one, two = tp2
    monkeypatch.setattr(two, "admit", threading.BoundedSemaphore(2))
    clips = [(features(one, w), dict(language="en", task=t))
             for w, t in zip(WAVS, ("transcribe", "translate",
                                    "transcribe"))]
    want = [one.transcribe(f, **kw) for f, kw in clips]
    got: dict = {}
    # the first two hold both slots; the third waits on one until the
    # second, closed once both are mid-stream, gives its slot back
    started = threading.Barrier(2)

    def run(i):
        f, kw = clips[i]
        stream = two.transcribe_stream(f, **kw)
        toks = []
        for n, piece in enumerate(stream):
            toks += piece
            if n == 0 and i < 2:
                started.wait(30)
                if i == 1:  # the client leaves mid-stream
                    stream.close()
                    break
        got[i] = toks

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1] == want[1][:4]
    _agree(two, 2)


@pytest.fixture(scope="module")
def servers(tp2):
    """The tp 1 and the tp 2 server, each on its runner of ``tp2``."""
    _, one, two = tp2
    conf = tcfg.EngineConfig.for_model("tiny-whisper")
    out = [WhisperServer(conf, runner=r) for r in (one, two)]
    bases = [f"http://127.0.0.1:{s.start('127.0.0.1', 0)}" for s in out]
    yield bases, two
    for s in out:
        s.shutdown()


@pytest.mark.parametrize("case", ["json", "verbose_json", "translate-verbose",
                                  "detect-verbose", "srt", "sse",
                                  "sse-detect", "bad-language"])
def test_tp2_server_answers_the_tp1_bodies(servers, case):
    bases, two = servers
    path, body = SERVER_CASES[case]
    (s1, t1, b1), (s2, t2, b2) = [_post(b, path, body) for b in bases]
    assert (s2, t2) == (s1, t1), b2
    if case.startswith("sse") and s1 == 200:
        assert _sse_text(b2) == _sse_text(b1)
    elif t1.startswith("application/json"):
        _close(json.loads(b1), json.loads(b2))
    else:
        assert b2 == b1
    _agree(two, 2)


def test_a_client_that_leaves_frees_its_handle_on_every_rank(servers,
                                                              monkeypatch):
    """An SSE client of the tp 2 server that closes its socket
    mid-stream: the abort is counted, and no rank holds the request's
    state afterwards (the first chunk waits until the client has left, so
    the stream cannot end first)."""
    monkeypatch.setattr(TWR, "DECODE_CHUNK", 2)  # many chunks a clip
    bases, two = servers
    base = bases[1]
    chunk, calls, left = two.dev.chunk_request, [], threading.Event()

    def chunk_after_close(*args):
        calls.append(args)
        if len(calls) == 1:
            left.wait(30)
            time.sleep(0.05)  # the FIN reaches the server's socket
        return chunk(*args)

    monkeypatch.setattr(two.dev, "chunk_request", chunk_after_close)
    key = ('pstpu_transcription_aborted_requests_total'
           '{endpoint="audio.transcribe"}')

    def aborted() -> float:
        for line in _get(base, "/metrics")[1].decode().splitlines():
            if line.startswith(key):
                return float(line.split()[-1])
        return 0.0

    before = aborted()
    path, body = SERVER_CASES["sse"]
    host, port = base.split("//")[1].split(":")
    sock = socket.create_connection((host, int(port)), timeout=60)
    sock.sendall((f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: "
                  f"{SERVER_CASE_CTYPE}\r\nContent-Length: {len(body)}"
                  "\r\n\r\n").encode() + body)
    head = b""
    while b"\r\n\r\n" not in head:
        head += sock.recv(4096)
    assert head.startswith(b"HTTP/1.1 200")
    sock.close()
    left.set()
    deadline = time.monotonic() + 30
    while aborted() == before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert aborted() == before + 1
    _agree(two, 2)
