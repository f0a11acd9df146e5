"""Multi-host serving drills on the CPU: processes started on their own,
one a rank, joined through a coordinator, the calls on the authenticated
step-plan channel (the counterparts of ``tests/test_multihost.py``'s
process tests).

- The harness (``testing/multihost_harness.py``, tiny-llama in float32)
  as a leader and a follower at tp 2 and at seq 2 (a prompt above the
  ring threshold; and tiny-mixtral at seq 2, its MoE slots ranked
  across the seq ranks), and as four processes on the seq 2 x tp 2 grid:
  greedy tokens identical, up to a near-tie (top-2 gap under 1e-4), to
  the JAX engine at ``tensor=2`` / ``seq=2`` / ``seq=2, tensor=2`` in
  this process on the same weights, logprobs within 1e-4, and to the
  port's spawned ranks at the same size; a guided request and one on a
  rank-4 adapter among them; every rank's digest and call count equal;
  the followers print ``FOLLOWER DONE`` and all exit 0.
- No pickling collective and no plain ``pickle.loads`` runs in either
  harness process (``_torch_multihost.trapped_harness``).
- The real server at tp 2 as two processes: the leader answers
  ``/v1/completions``, the follower's ``/health`` gives the reference's
  body and 404 elsewhere; SIGTERM to the leader and both exit 0; SIGKILL
  to the leader and the follower exits 0 on the closed channel within
  5 s.
- Start-up exits: pipeline stages, the host and remote KV tiers, Whisper,
  no secret, no coordinator, and a process count that is not the mesh's.
- A follower killed between calls makes the leader's next call raise
  ``RankLost`` within 5 s.
"""

import json
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_multihost import (
    ROOT,
    free_port,
    group_env,
    line,
    run_pair,
)
from _torch_parity import assert_same, engine_configs
from _torch_tp import rank_limit, wait_gone
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import lora as jlora
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import multihost as mh
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.weights import params_from_jax
from production_stack_tpu_torch.parallel.distributed import DistributedConfig
from production_stack_tpu_torch.testing import multihost_harness as h

torch.set_num_threads(2)

AXES = ["tensor", "seq", "grid", "seq-moe"]
# each case's harness axis, model, JAX mesh and processes
AXIS = {"tensor": "tensor", "seq": "seq", "grid": "grid", "seq-moe": "seq"}
MODEL = {"seq-moe": "tiny-mixtral"}
JAX_MESH = {"tensor": dict(tensor=2), "seq": dict(seq=2, tensor=1),
            "grid": dict(seq=2, tensor=2), "seq-moe": dict(seq=2, tensor=1)}
PROCESSES = {"tensor": 2, "seq": 2, "grid": 4, "seq-moe": 2}


def _jax_engine(axis: str):
    """The JAX engine of the harness's config for case ``axis`` on its
    mesh, one of this process's CPU devices a process."""
    sched = dict(max_num_seqs=4, max_num_batched_tokens=32,
                 prefill_buckets=(16, 32, 64))
    if axis != "tensor":
        sched["ring_prefill_threshold"] = h.RING_THRESHOLD
    jconf, tconf = engine_configs("ragged", block_size=4, num_blocks=128,
                                  **sched)
    if axis in MODEL:
        jconf.model = jcfg.ModelConfig.from_pretrained(MODEL[axis])
        tconf.model = tcfg.ModelConfig.from_pretrained(MODEL[axis])
    jconf.mesh = jmesh.MeshConfig(data=1, **JAX_MESH[axis])
    return JaxEngine(jconf, mesh=jmesh.build_mesh(
        jconf.mesh, devices=jax.devices()[:PROCESSES[axis]]),
        num_blocks=128), tconf


def _tokens(out: dict) -> tuple:
    return out["tokens"], out["logprobs"], out["reasons"]


_RUNS: dict = {}


def _run(axis: str, tmp_path_factory) -> dict:
    """The JAX engine, the harness pair on its weights, and the port's
    spawned ranks, on the harness's requests; cached for the module."""
    if axis in _RUNS:
        return _RUNS[axis]
    tmp = tmp_path_factory.mktemp(f"mh-{axis}")
    jeng, tconf = _jax_engine(axis)
    params = params_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jeng.runner.params)), tconf.model)
    path = str(tmp / "params.npz")
    h.save_params(params, path)

    def jax_adapter():
        manager = jlora.LoraManager(jeng)
        manager.load("mh-adapter", h.write_adapter(str(tmp / "jax"),
                                                   tconf.model))
        return manager.slot_of("mh-adapter")

    ring = axis != "tensor"
    out = {"jax": h.generate_greedy(jeng, jax_adapter, JaxSP, ring=ring)}
    model = MODEL.get(axis, "tiny-llama")
    (l_rc, l_out), (f_rc, f_out) = run_pair(
        ["--axis", AXIS[axis], "--model", model, "--params", path],
        n=PROCESSES[axis])
    out["pair"] = {"leader_rc": l_rc, "follower_rc": f_rc, "leader": l_out,
                   "follower": f_out}
    cfg = h.engine_config(AXIS[axis], model)
    with rank_limit(90):
        eng = LLMEngine(cfg, params=h.load_params(path, torch.float32),
                        device="cpu")
        try:
            out["spawned"] = h.generate_greedy(
                eng, h.port_adapter(eng, str(tmp / "spawned")), ring=ring)
        finally:
            eng.close()
    _RUNS[axis] = out
    return out


def _pair(axis, tmp_path_factory) -> dict:
    pair = _run(axis, tmp_path_factory)["pair"]
    assert pair["leader_rc"] == 0, pair["leader"][-3000:]
    assert pair["follower_rc"] == 0, pair["follower"][-3000:]
    return line(pair["leader"], "TOKENS")


@pytest.mark.parametrize("axis", AXES)
def test_pair_matches_the_jax_engine(axis, tmp_path_factory):
    got = _pair(axis, tmp_path_factory)
    want = _run(axis, tmp_path_factory)["jax"]
    assert_same(_tokens(want), _tokens(got))
    assert got["kv-export-shape"] == want["kv-export-shape"]
    assert set(got["tokens"]) == {"mh-0", "mh-1", "mh-guided",
                                  "mh-adapter"} | (
        set() if axis == "tensor" else {"mh-2"})


@pytest.mark.parametrize("axis", AXES)
def test_pair_matches_the_spawned_ranks(axis, tmp_path_factory):
    got = _pair(axis, tmp_path_factory)
    want = _run(axis, tmp_path_factory)["spawned"]
    assert_same(_tokens(want), _tokens(got))
    assert got["kv-export-shape"] == want["kv-export-shape"]


@pytest.mark.parametrize("axis", AXES)
def test_pair_ranks_agree_and_the_follower_leaves(axis, tmp_path_factory):
    got = _pair(axis, tmp_path_factory)
    reports = got["reports"]
    assert len(reports) == PROCESSES[axis]
    assert len({(r["calls"], r["digest"]) for r in reports}) == 1
    assert all(r["diverged_at"] is None for r in reports)
    assert reports[0]["calls"] > 0
    follower = _run(axis, tmp_path_factory)["pair"]["follower"]
    assert "FOLLOWER DONE" in follower
    # the calls that crossed the channel, the adapter's shares among them
    frames = got["frame_bytes"]
    assert {"ragged_step", "decode_multi", "register_grammar",
            "register_lora"} <= set(frames)
    assert ("prefill_ring" in frames) == (axis != "tensor")


@pytest.mark.parametrize("axis", AXES)
def test_no_object_pickle_runs_in_a_multihost_process(axis,
                                                      tmp_path_factory):
    pair = _run(axis, tmp_path_factory)["pair"]
    for who in ("leader", "follower"):
        assert line(pair[who], "TRAP") == [], pair[who][-3000:]


# -- the real server ---------------------------------------------------------

def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("stop", ["sigterm", "sigkill"])
def test_real_server_pair_serves_completions_and_the_follower_health(stop):
    coord, control, lport, fport = (free_port() for _ in range(4))
    base = [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
            "--model", "tiny-llama", "--device", "cpu", "--host",
            "127.0.0.1", "--num-blocks", "128", "--max-num-seqs", "4",
            "--tensor-parallel-size", "2", "--skip-warmup"]
    follower = subprocess.Popen(
        base + ["--port", str(fport)], env=group_env(1, coord, control),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    leader = subprocess.Popen(
        base + ["--port", str(lport)], env=group_env(0, coord, control),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            for p, who in ((leader, "leader"), (follower, "follower")):
                if p.poll() is not None:
                    raise AssertionError(f"{who} died: "
                                         f"{p.stdout.read()[-3000:]}")
            try:
                if _get(f"http://127.0.0.1:{lport}/health")[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "the leader never came up"
                time.sleep(0.2)
        req = urllib.request.Request(
            f"http://127.0.0.1:{lport}/v1/completions",
            data=json.dumps({"model": "tiny-llama", "prompt": "hi there",
                             "max_tokens": 4, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["usage"]["completion_tokens"] == 4
        assert _get(f"http://127.0.0.1:{fport}/health") == (
            200, {"status": "follower", "process_id": 1})
        assert _get(f"http://127.0.0.1:{fport}/v1/models")[0] == 404
        ranks = _get(f"http://127.0.0.1:{lport}/debug/perf")[1]["ranks"]
        assert ranks["size"] == 2 and ranks["pids"][1] == follower.pid
        if stop == "sigterm":
            # the leader drains and exits 0; its _shutdown ends the follower
            leader.send_signal(signal.SIGTERM)
            assert leader.wait(30) == 0
        else:
            # the follower leaves on the closed channel
            leader.kill()
            leader.wait(10)
        assert follower.wait(5) == 0
    finally:
        for p in (leader, follower):
            if p.poll() is None:
                p.kill()
                p.wait()


# -- start-up exits ----------------------------------------------------------

BASE = ["--model", "tiny-llama", "--device", "cpu", "--port", "0",
        "--skip-warmup", "--num-processes", "2", "--process-id", "0",
        "--distributed-coordinator", "127.0.0.1:1"]


@pytest.mark.parametrize("extra,named,secret", [
    (["--pipeline-parallel-size", "2"], "pipeline", "s"),
    (["--kv-host-cache-bytes", "1000000"], "host-offload", "s"),
    (["--remote-kv-url", "http://127.0.0.1:1"], "remote-KV", "s"),
    (["--model", "tiny-whisper"], "Whisper", "s"),
    ([], "PSTPU_CONTROL_SECRET", None),
    (["--distributed-coordinator", "127.0.0.1"], "host:port", "s"),
    (["--tensor-parallel-size", "4"], "--num-processes 2 does not match the "
     "mesh's 4", "s"),
    (["--sequence-parallel-size", "2", "--tensor-parallel-size", "2"],
     "--num-processes 2 does not match the mesh's 4", "s"),
], ids=["pipeline", "host-tier", "remote-tier", "whisper", "no-secret",
        "no-coordinator-port", "tp4", "grid"])
def test_multihost_exits_at_start(extra, named, secret, monkeypatch):
    monkeypatch.delenv("PSTPU_CONTROL_SECRET", raising=False)
    if secret is not None:
        monkeypatch.setenv("PSTPU_CONTROL_SECRET", secret)
    for k in ("PSTPU_COORDINATOR", "PSTPU_NUM_PROCESSES", "PSTPU_PROCESS_ID",
              "PSTPU_CONTROL_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as e:
        tserver.main(BASE + extra)
    assert named in str(e.value)


def test_no_coordinator_exits(monkeypatch):
    monkeypatch.setenv("PSTPU_CONTROL_SECRET", "s")
    monkeypatch.delenv("PSTPU_COORDINATOR", raising=False)
    with pytest.raises(SystemExit, match="--distributed-coordinator"):
        tserver.main(["--device", "cpu", "--num-processes", "2"])


def test_process_count_and_tensor_size_resolve_from_the_flags(monkeypatch):
    monkeypatch.setenv("PSTPU_NUM_PROCESSES", "4")
    args = tserver.build_parser().parse_args(["--device", "cpu"])
    dcfg = tserver.distributed_from_args(args)
    assert dcfg.num_processes == 4 and dcfg.control_port == 18100
    # -1 resolves to the processes over the seq ranks
    assert tserver.config_from_args(args, 4).mesh.tensor == 4
    args.sequence_parallel_size = 2
    mesh = tserver.config_from_args(args, 4).mesh
    assert (mesh.seq, mesh.tensor) == (2, 2)


# -- a lost rank -------------------------------------------------------------

def test_a_killed_follower_is_rank_lost_at_the_next_call(monkeypatch):
    coord, control = free_port(), free_port()
    env = group_env(1, coord, control)
    follower = subprocess.Popen(
        [sys.executable, "-m",
         "production_stack_tpu_torch.testing.multihost_harness",
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    monkeypatch.setenv("PSTPU_CONTROL_SECRET", env["PSTPU_CONTROL_SECRET"])
    dcfg = DistributedConfig(f"127.0.0.1:{coord}", 2, 0, control)
    try:
        with rank_limit(60):
            eng = LLMEngine(h.engine_config("tensor"), device="cpu",
                            distributed=dcfg)
            try:
                assert len(eng.runner.follower_reports()) == 2
                follower.kill()
                assert wait_gone([follower.pid], 5) == []
                t0 = time.monotonic()
                with pytest.raises(mh.RankLost):
                    eng.runner.follower_reports()
                assert time.monotonic() - t0 < 5
            finally:
                eng.close()
    finally:
        if follower.poll() is None:
            follower.kill()
        follower.wait()
