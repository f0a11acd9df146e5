"""Disaggregated serving between tensor-parallel servers, on the CPU.

A prefill server at ``--tensor-parallel-size 2`` in a subprocess (its
own torch.distributed group) and a decode server at tp 2 in this process,
both tiny-llama from seed 0 (float32), and a decode server at tp 1 beside
them:

- pull (``/kv/export`` streamed into the decode server's prefix cache)
  and push-and-splice (``/kv/recv``, then the decode hop attaches it):
  the tokens are the prefill server's own unified run's (greedy identical
  up to a near-tie, logprobs within 1e-4); the landed blocks are the
  producer's, bit for bit; ``vllm:kv_transfer_*`` counts whole blocks, as
  at tp 1;
- a corrupted frame answers 409 with the layer to resume from, and the
  push resumes there;
- a ``/kv/export`` leaves every dispatch's collective bytes as they were;
- the KV head grouping travels with the bytes: tp 2's transfers (grouped
  in 2) are refused by the tp 1 server (grouped in 1), the pull with a
  cold prefill and the push with a 422 that names both groupings, never
  retried, each counted;
- no rank survives either server's stop.

Requests allow only printable byte tokens, so equal texts are equal
tokens (``test_torch_disagg``'s helpers).
"""

import http.client
import io
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from _torch_tp import alive, kill_pids, rank_limit, wait_gone
from test_torch_disagg import _assert_run_same, _body, _post, _run
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine import server as tserver

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BS = 4
FLAGS = ["--model", "tiny-llama", "--device", "cpu", "--skip-warmup",
         "--block-size", str(BS), "--num-blocks", "128",
         "--max-num-seqs", "4", "--max-num-batched-tokens", "64"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _local(*extra):
    server = tserver.server_from_args(
        tserver.build_parser().parse_args(FLAGS + list(extra)))
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


@pytest.fixture(scope="module")
def servers():
    """The tp 2 prefill server (a subprocess), the tp 2 decode server and
    a tp 1 decode server (this process)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         *FLAGS, "--tensor-parallel-size", "2", "--role", "prefill",
         "--port", str(port), "--host", "127.0.0.1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    p_url = f"http://127.0.0.1:{port}"
    out = {"proc": proc, "p": p_url, "p_pids": []}
    with rank_limit(240):
        try:
            t_end = time.monotonic() + 90
            while time.monotonic() < t_end:
                try:
                    out["p_pids"] = _get(f"{p_url}/debug/perf")["ranks"][
                        "pids"][1:]
                    break
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.3)
            assert out["p_pids"], "the prefill server did not come up"
            out["D"], out["d"] = _local("--tensor-parallel-size", "2",
                                        "--role", "decode")
            out["d_pids"] = out["D"].engine.rank_info()["pids"][1:]
            out["D1"], out["d1"] = _local("--role", "decode")
            yield out
        finally:
            for key in ("D", "D1"):
                if key in out and not out.get(f"{key}_down"):
                    out[key].shutdown()
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            kill_pids(out["p_pids"])


def _unified(url, prompt, n):
    return _run(_post(f"{url}/v1/completions", _body(prompt, n))[1])


def _full_blocks(kv, prompt):
    return kv["remote_block_ids"][:(len(prompt) - 1) // BS]


def _export(url, blocks) -> bytes:
    req = urllib.request.Request(
        f"{url}/kv/export", data=json.dumps({"blocks": blocks}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers[tkt.HEAD_GROUPS_HEADER] == "2"
        return r.read()


def _engine_bytes(server, blocks) -> bytes:
    """The whole blocks' bytes as ``server``'s engine exports them, on its
    engine thread (the ranks take one call at a time)."""
    return bytes(tkt.tensor_bytes(server.async_engine.run_on_engine(
        lambda e: e.export_kv(blocks))))


def test_pull_between_tp2_servers(servers):
    P, D = servers["p"], servers["D"]
    prompt = list(range(150, 181))
    want = _unified(P, prompt, 6)
    status, pre = _post(f"{P}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    assert status == 200
    kv = dict(pre["kv_transfer_params"], remote_host=P)
    totals = D.metrics.transfer_snapshot().get("import", {})
    status, dec = _post(f"{servers['d']}/v1/completions",
                        _body(prompt, 6, kv_transfer_params=kv))
    assert status == 200
    n_full = (len(prompt) - 1) // BS
    assert dec["usage"]["prompt_tokens_details"]["cached_tokens"] == (
        n_full * BS)
    _assert_run_same(want, _run(dec))
    # whole blocks counted, as at tp 1
    got = D.metrics.transfer_snapshot()["import"]
    assert got["count"] == totals.get("count", 0) + 1
    assert got["bytes"] - totals.get("bytes", 0) == tkt.nbytes_of(
        D._kv_shape(n_full), "float32")
    # the imported blocks are the producer's, bit for bit
    mine, _ = D.engine.scheduler.allocator.match_prefix(prompt)
    assert len(mine) == n_full
    assert _engine_bytes(D, mine) == _export(
        P, _full_blocks(pre["kv_transfer_params"], prompt))


def test_push_splice_between_tp2_servers(servers):
    P, D, d = servers["p"], servers["D"], servers["d"]
    prompt = list(range(60, 98))  # 9 full blocks and a partial one
    want = _unified(P, prompt, 8)
    spliced0 = D.engine.spliced_seqs
    recv0 = D.metrics.transfer_snapshot().get("recv", {})
    status, pre = _post(f"{P}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True,
                                            "push_url": d,
                                            "transfer_id": "tp-push"}))
    assert status == 200
    kv = pre["kv_transfer_params"]
    assert kv["pushed"] is True
    n = len(kv["remote_block_ids"])
    recv = D.metrics.transfer_snapshot()["recv"]
    assert recv["bytes"] - recv0.get("bytes", 0) == tkt.nbytes_of(
        D._kv_shape(n), "float32")
    # the landed blocks, before the decode hop attaches them, are the
    # producer's full blocks bit for bit
    with D._kv_lock:
        landed = list(D._kv_transfers["tp-push"]["blocks"])
    n_full = len(prompt) // BS
    assert _engine_bytes(D, landed[:n_full]) == _export(
        P, kv["remote_block_ids"][:n_full])
    first = _run(pre)
    status, dec = _post(f"{d}/v1/completions", _body(
        prompt + [ord(first[0])], 7, kv_transfer_params={
            "do_remote_prefill": True, "transfer_id": "tp-push",
            "remote_block_ids": kv["remote_block_ids"], "remote_host": P}))
    assert status == 200 and D.engine.spliced_seqs == spliced0 + 1
    rest = _run(dec)
    _assert_run_same(want, (first[0] + rest[0], first[1] + rest[1]))
    perf = _get(f"{P}/debug/perf")["kv_transfer"]
    assert perf["head_groups"] == 2
    assert perf["transfers"]["push"]["bytes"] >= tkt.nbytes_of(
        D._kv_shape(n), "float32")


def _frames(url, blocks):
    """The producer's streamed export of ``blocks`` in one-layer groups,
    as (headers, frames)."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("POST", "/kv/export", json.dumps(
            {"blocks": blocks, "stream": True, "group_layers": 1}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        body = io.BytesIO(resp.read())
        frames = []
        while (payload := tkt.read_frame(body)) is not None:
            frames.append(tkt.frame(payload))
        return resp.headers, frames
    finally:
        conn.close()


def test_corrupted_frame_gets_409_then_resumes_at_tp2(servers):
    P, D, d = servers["p"], servers["D"], servers["d"]
    prompt = list(range(200, 232))  # whole blocks: all cached on P
    status, pre = _post(f"{P}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    blocks = pre["kv_transfer_params"]["remote_block_ids"][:len(prompt)
                                                            // BS]
    got, frames = _frames(P, blocks)
    meta = tkt.frame(json.dumps({
        "transfer_id": "tp-409", "prompt_token_ids": prompt,
        "first_token": ord(_run(pre)[0])}).encode())
    headers = {"X-KV-Transfer-Id": "tp-409", "X-KV-Group-Layers": "1",
               **{k: got[k] for k in ("X-KV-Shape", "X-KV-Dtype",
                                      tkt.HEAD_GROUPS_HEADER)}}
    bad = bytearray(frames[1])
    bad[tkt.FRAME_HEADER.size + 3] ^= 0x01

    def post(start, body):
        status, text = tkt._post_chunked(
            d, "/kv/recv", dict(headers, **{"X-KV-Start-Layer": str(start)}),
            [meta] + body + [tkt.END_FRAME], 30)
        return status, json.loads(text)

    assert post(0, [frames[0], bytes(bad)]) == (409, {"resume_layer": 1})
    # a retry that disagrees with the receiver's progress is re-anchored
    assert post(0, frames) == (409, {"resume_layer": 1})
    status, out = post(1, frames[1:])
    assert status == 200 and out["layers"] == 2
    # the unified run after the hop: it would have cached the prompt's
    # last block, which the hop then recomputes into a block of its own
    want = _unified(P, prompt, 5)
    spliced0 = D.engine.spliced_seqs
    status, dec = _post(f"{d}/v1/completions", _body(
        prompt + [ord(_run(pre)[0])], 4,
        kv_transfer_params={"transfer_id": "tp-409"}))
    assert D.engine.spliced_seqs == spliced0 + 1
    first, rest = _run(pre), _run(dec)
    _assert_run_same(want, (first[0] + rest[0], first[1] + rest[1]))


def test_kv_export_leaves_dispatch_collectives_alone(servers):
    """A ``/kv/export`` moves rank 1's share on the device group, counted
    under ``kv_gather``, and bills no dispatch."""
    D, d = servers["D"], servers["d"]
    prompt = list(range(300, 321))
    assert _post(f"{d}/v1/completions", _body(prompt, 2))[0] == 200
    blocks, _ = D.engine.scheduler.allocator.match_prefix(prompt)
    wire = D.engine.runner.ranks.wire
    before = _get(f"{d}/debug/perf")["collective_bytes_total"]
    gathered = wire.get("kv_gather", 0.0)
    raw = _export(d, blocks)
    assert len(raw) == tkt.nbytes_of(D._kv_shape(len(blocks)), "float32")
    assert _get(f"{d}/debug/perf")["collective_bytes_total"] == before
    assert wire["kv_gather"] - gathered == len(raw) / 2
    assert not any(op.startswith("kv_") for op in before)


def test_tp2_kv_is_refused_by_a_tp1_server(servers):
    """tiny-llama's bytes at tp 2 are grouped (K_0, V_0, K_1, V_1), at tp
    1 (K_0, K_1, V_0, V_1): the tp 1 server imports none of them. The
    pull prefills cold, the push gets a 422 naming both groupings and is
    not retried; each refusal counted."""
    P, D1, d1 = servers["p"], servers["D1"], servers["d1"]
    prompt = list(range(400, 431))
    want = _unified(P, prompt, 6)
    status, pre = _post(f"{P}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    kv = dict(pre["kv_transfer_params"], remote_host=P)
    status, dec = _post(f"{d1}/v1/completions",
                        _body(prompt, 6, kv_transfer_params=kv))
    assert status == 200
    assert dec["usage"]["prompt_tokens_details"]["cached_tokens"] == 0
    assert "import" not in D1.metrics.transfer_snapshot()
    assert D1.metrics.transfer_refused == {"import": 1}
    _assert_run_same(want, _run(dec))  # a cold prefill at tp 1
    status, pre = _post(f"{P}/v1/completions", _body(
        list(range(440, 471)), 1, kv_transfer_params={
            "do_remote_decode": True, "push_url": d1,
            "transfer_id": "tp-refused"}))
    assert status == 200 and pre["kv_transfer_params"]["pushed"] is False
    assert D1.metrics.transfer_refused == {"import": 1, "recv": 1}
    assert not D1._kv_transfers
    assert D1.engine.scheduler.num_free_blocks == \
        D1.engine.runner.num_blocks
    # the 422 names both groupings
    headers = {"X-KV-Transfer-Id": "x", "X-KV-Shape":
               ",".join(map(str, D1._kv_shape(1))), "X-KV-Dtype": "float32",
               "X-KV-Group-Layers": "1", tkt.HEAD_GROUPS_HEADER: "2"}
    status, text = tkt._post_chunked(d1, "/kv/recv", headers,
                                     [tkt.END_FRAME], 30)
    msg = json.loads(text)["error"]["message"]
    assert status == 422 and "2 head groups" in msg and "in 1" in msg


def test_no_rank_survives_either_stop(servers):
    D = servers["D"]
    d_pids, p_pids = servers["d_pids"], servers["p_pids"]
    assert all(alive(p) for p in d_pids + p_pids)
    D.shutdown()
    servers["D_down"] = True
    servers["proc"].send_signal(signal.SIGTERM)
    assert servers["proc"].wait(30) == 0
    assert wait_gone(d_pids + p_pids, 10) == []
