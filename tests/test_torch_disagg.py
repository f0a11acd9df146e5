"""P->D disaggregation on the port, against the JAX package, on the CPU.

Tiny-llama, float32, one weight set for every engine:

- the runner's ``export_blocks`` / ``export_blocks_range`` read the same
  KV as the JAX runner's after the same prompt (1e-5);
- a JAX engine's exported blocks, imported by a port engine (the pull
  form, ``import_kv``) or spliced into it with the JAX prefill's first
  token (``splice_request``), and the reverse, continue greedy exactly as
  the JAX engine's unified run (up to a near-tie; logprobs within 1e-4);
- two port servers over HTTP: a pushed transfer is spliced
  (``spliced_seqs_total`` rises, the tokens are the unified ones), a
  corrupted frame answers 409 with the layer to resume from and the push
  resumes there, a full pool answers 503, and the TTL sweep frees the
  blocks of a transfer nobody attached;
- the port's servers and the JAX package's aiohttp servers push to and
  pull from each other (chunked bodies both ways);
- the unchanged router fronts a port prefill and a port decode server
  (``--routing-logic disaggregated_prefill_orchestrated
  --static-backend-roles prefill,decode``), streamed (push and splice)
  and not (pull), with the unified text.

Requests over HTTP allow only 64 printable byte tokens, so the byte
tokenizer's text is one character a token and equal texts are equal
tokens. Logprobs report the raw distribution, so the top-2 entries there
need not be allowed tokens: a flip between two runs counts as a near-tie
when each run's logprob of its own token at that step is within
``TIE_GAP`` of the other's (the two tokens were within float noise of
each other in both runs).
"""

import asyncio
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_parity import (
    LP_TOL,
    TIE_GAP,
    assert_same,
    drain,
    engine_configs,
    jax_engine,
    port_engine,
    tiny_weights,
)
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu.engine.server import EngineServer as JaxServer
from production_stack_tpu.router.app import RouterApp, build_parser
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)

BS = 4
GREEDY = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True,
                        logprobs=2)
PROMPTS = [list(range(5, 5 + n)) for n in (9, 23, 40)]
ALLOWED = list(range(48, 112))


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _configs(**engine_kw):
    return engine_configs("ragged", block_size=BS, num_blocks=128,
                          max_num_seqs=4, max_num_batched_tokens=64,
                          engine_kw=engine_kw or None)


def _unified(weights):
    jconf, _ = _configs()
    reqs = [(f"r{i}", p, GREEDY) for i, p in enumerate(PROMPTS)]
    return drain(jax_engine(weights, jconf), reqs)


def test_export_blocks_match_reference(weights):
    jconf, tconf = _configs()
    jeng, teng = jax_engine(weights, jconf), port_engine(weights, tconf)
    sp = SamplingParams(temperature=0.0, max_tokens=3, ignore_eos=True)
    drain(jeng, [("a", PROMPTS[2], sp)])
    drain(teng, [("a", PROMPTS[2], sp)])
    blocks, _ = teng.scheduler.allocator.match_prefix(PROMPTS[2])
    assert blocks == jeng.scheduler.allocator.match_prefix(PROMPTS[2])[0]
    order = blocks[::-1]  # any order, as a transfer asks
    want = np.asarray(jeng.runner.export_blocks(order))
    got = teng.runner.export_blocks(order)
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    part = teng.runner.export_blocks_range(order, 1, 1)
    assert torch.equal(part, got[1:2])
    slabs = teng.runner.export_slabs(order)
    assert all(torch.equal(s, got[:, i]) for i, s in enumerate(slabs))


def _prefill(eng, prompt, jax_side):
    sp = (JaxSP if jax_side else SamplingParams)(
        temperature=0.0, max_tokens=1, ignore_eos=True)
    out = eng.generate([prompt], sp)["offline-0"]
    blocks, _ = eng.scheduler.allocator.match_prefix(prompt)
    data = eng.export_kv(blocks)
    return out[0], (data if jax_side else data.numpy())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pulled_blocks_continue_as_unified(weights, direction):
    """The producer prefills each prompt, its full blocks are imported as
    the consumer's prefix cache, and the consumer's greedy continuation is
    the JAX engine's unified run."""
    jconf, tconf = _configs()
    want = _unified(weights)
    jax_producer = direction == "jax_to_port"
    prod = (jax_engine(weights, jconf) if jax_producer
            else port_engine(weights, tconf))
    cons = (port_engine(weights, tconf) if jax_producer
            else jax_engine(weights, jconf))
    for p in PROMPTS:
        _, data = _prefill(prod, p, jax_producer)
        n_full = (len(p) - 1) // BS
        got = cons.import_kv(p, data if not jax_producer
                             else torch.from_numpy(np.ascontiguousarray(data)))
        assert got == n_full * BS
    reqs = [(f"r{i}", p, GREEDY) for i, p in enumerate(PROMPTS)]
    got = drain(cons, reqs)
    # admission computed only each prompt's tail
    assert cons.scheduler.allocator.prefix_hits == sum(
        (len(p) - 1) // BS for p in PROMPTS)
    assert_same(want, got)


def test_jax_prefill_spliced_into_port_decode(weights):
    """The push form: the JAX engine's prefill (blocks of the whole
    prompt and its first token) lands in fresh port blocks and is spliced
    in decode-ready; no prefill runs on the port engine."""
    jconf, tconf = _configs()
    want = _unified(weights)
    jeng, teng = jax_engine(weights, jconf), port_engine(weights, tconf)
    for i, p in enumerate(PROMPTS):
        jeng.add_request(f"p{i}", prompt_token_ids=p,
                         sampling=JaxSP(temperature=0.0, max_tokens=1,
                                        ignore_eos=True))
    finals = {}
    while jeng.has_unfinished():
        for o in jeng.step():
            if o.finished:
                finals[o.request_id] = (o.new_token_ids[-1], o.block_ids)
    for i, p in enumerate(PROMPTS):
        first, blocks = finals[f"p{i}"]
        data = jeng.export_kv(blocks)
        local = teng.begin_kv_receive(len(blocks))
        teng.runner.import_blocks(local, torch.from_numpy(
            np.ascontiguousarray(data)))
        sp = SamplingParams(temperature=0.0, max_tokens=GREEDY.max_tokens,
                            ignore_eos=True, logprobs=2)
        teng.splice_request(f"r{i}", p, first, sp, local)
    assert teng.spliced_seqs == len(PROMPTS)
    toks = {f"r{i}": [finals[f"p{i}"][0]] for i in range(3)}
    lps = {f"r{i}": [] for i in range(3)}
    while teng.has_unfinished():
        for o in teng.step():
            toks[o.request_id].extend(o.new_token_ids)
            lps[o.request_id].extend(o.new_logprobs or ())
    assert teng.ragged_dispatches + teng.decode_dispatches > 0
    assert teng.stats()["prompt_tokens_total"] == sum(map(len, PROMPTS))
    wt, wl, _ = want
    for rid in wt:
        assert toks[rid][:1] == wt[rid][:1]
        assert_same(({rid: wt[rid][1:]}, {rid: wl[rid][1:]}, {}),
                    ({rid: toks[rid][1:]}, {rid: lps[rid]}, {}))


# -- over HTTP ---------------------------------------------------------------

def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _body(prompt, max_tokens, **kw):
    return {"model": "tiny-llama", "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0.0, "ignore_eos": True, "logprobs": 2,
            "allowed_token_ids": ALLOWED, **kw}


def _run(out):
    """(text, token logprobs) of a completion."""
    c = out["choices"][0]
    return c["text"], c["logprobs"]["token_logprobs"]


def _assert_run_same(want, got):
    (wt, wl), (gt, gl) = want, got
    assert len(wt) == len(gt)
    n = len(wt)
    for j, (a, b) in enumerate(zip(wt, gt)):
        if a != b:
            assert abs(wl[j] - gl[j]) < TIE_GAP, (j, a, b, wl[j], gl[j])
            n = j
            break
    for a, b in zip(wl[:n], gl[:n]):
        assert abs(a - b) <= LP_TOL


def _port_server(weights, role="unified", num_blocks=128, ttl=120.0):
    _, tconf = _configs(role=role, kv_transfer_ttl=ttl)
    tconf.cache.num_blocks = num_blocks
    srv = EngineServer(tconf, engine=port_engine(weights, tconf))
    return srv, f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"


@pytest.fixture(scope="module")
def pd(weights):
    """A unified, a prefill and a decode port server."""
    servers = [_port_server(weights, role) for role in
               ("unified", "prefill", "decode")]
    yield servers
    for srv, _ in servers:
        srv.shutdown()


PROMPT = list(range(60, 98))  # 38 tokens: 9 full blocks and a partial


def test_push_splice_between_port_servers(pd):
    (_, u), (P, p), (D, d) = pd
    want = _run(_post(f"{u}/v1/completions", _body(PROMPT, 8))[1])
    spliced0 = D.engine.spliced_seqs
    status, pre = _post(f"{p}/v1/completions", _body(PROMPT, 1,
                        kv_transfer_params={"do_remote_decode": True,
                                            "push_url": d,
                                            "transfer_id": "t-push"}))
    assert status == 200
    kv = pre["kv_transfer_params"]
    assert kv["pushed"] is True and kv["transfer_id"] == "t-push"
    assert len(kv["remote_block_ids"]) >= len(PROMPT) // BS + 1
    first = _run(pre)
    # the router's continuation body: the prompt plus the first token
    status, dec = _post(f"{d}/v1/completions", _body(
        PROMPT + [ord(first[0])], 7, kv_transfer_params={
            "do_remote_prefill": True, "transfer_id": "t-push",
            "remote_block_ids": kv["remote_block_ids"], "remote_host": p}))
    assert status == 200 and D.engine.spliced_seqs == spliced0 + 1
    assert dec["usage"]["prompt_tokens"] == len(PROMPT) + 1
    assert dec["usage"]["prompt_tokens_details"]["cached_tokens"] == len(
        PROMPT)
    rest = _run(dec)
    _assert_run_same(want, (first[0] + rest[0], first[1] + rest[1]))
    # the producer let its pinned blocks go after the push
    assert P.engine.scheduler.num_free_blocks == P.engine.runner.num_blocks
    assert not D._kv_transfers
    assert P.metrics.transfer_totals["push"]["count"] >= 1
    assert D.metrics.transfer_totals["recv"]["count"] >= 1
    status, models = 200, json.loads(urllib.request.urlopen(
        f"{d}/v1/models").read())
    assert models["data"][0]["role"] == "decode"
    perf = json.loads(urllib.request.urlopen(f"{p}/debug/perf").read())
    assert perf["kv_transfer"]["role"] == "prefill"
    assert perf["kv_transfer"]["transfers"]["push"]["count"] >= 1


def test_pull_between_port_servers(pd):
    (_, u), (P, p), (D, d) = pd
    prompt = list(range(150, 181))
    want = _run(_post(f"{u}/v1/completions", _body(prompt, 6))[1])
    status, pre = _post(f"{p}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    kv = dict(pre["kv_transfer_params"], remote_host=p)
    assert "pushed" not in kv
    n0 = D.metrics.transfer_totals.get("import", {}).get("count", 0)
    status, dec = _post(f"{d}/v1/completions",
                        _body(prompt, 6, kv_transfer_params=kv))
    assert status == 200
    assert D.metrics.transfer_totals["import"]["count"] == n0 + 1
    assert dec["usage"]["prompt_tokens_details"]["cached_tokens"] == (
        (len(prompt) - 1) // BS * BS)
    _assert_run_same(want, _run(dec))
    # a stale block id (a free block) is refused, and the pull is skipped
    status, _ = _post(f"{p}/kv/export", {"blocks": [P.engine.runner.num_blocks
                                                   - 1], "stream": True})
    assert status == 409
    status, _ = _post(f"{p}/kv/export", {"blocks": [10 ** 6]})
    assert status == 400


def _push_frames(P, blocks, meta, group, corrupt=None, start=0):
    frames = [tkt.frame(json.dumps(meta).encode())] + list(
        tkt.produce_frames(P.async_engine.run_on_engine, blocks,
                           P.config.model.num_layers, group,
                           start_layer=start))
    if corrupt is not None:
        bad = bytearray(frames[1 + corrupt])
        bad[tkt.FRAME_HEADER.size + 3] ^= 0x01
        frames[1 + corrupt] = bytes(bad)
    return frames


def test_corrupted_frame_gets_409_then_resumes(pd):
    (_, u), (P, p), (D, d) = pd
    prompt = list(range(200, 232))  # whole blocks: all cached on P
    want = _run(_post(f"{u}/v1/completions", _body(prompt, 5))[1])
    status, pre = _post(f"{p}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    blocks = pre["kv_transfer_params"]["remote_block_ids"]
    n_full = len(prompt) // BS
    P.async_engine.run_on_engine(
        lambda e: e.scheduler.allocator.pin_blocks(blocks[:n_full]))
    shape = P._kv_shape(n_full)
    meta = {"transfer_id": "t-409", "prompt_token_ids": prompt,
            "first_token": ord(_run(pre)[0])}
    headers = {"X-KV-Transfer-Id": "t-409", "X-KV-Shape":
               ",".join(map(str, shape)), "X-KV-Dtype": "float32",
               "X-KV-Group-Layers": "1"}
    url = d
    # the second layer group is corrupt: 409, resume at layer 1
    status, text = tkt._post_chunked(
        url, "/kv/recv", dict(headers, **{"X-KV-Start-Layer": "0"}),
        _push_frames(P, blocks[:n_full], meta, 1, corrupt=1), 30)
    assert status == 409 and json.loads(text) == {"resume_layer": 1}
    # a retry that disagrees with the receiver's progress is re-anchored
    status, text = tkt._post_chunked(
        url, "/kv/recv", dict(headers, **{"X-KV-Start-Layer": "0"}),
        _push_frames(P, blocks[:n_full], meta, 1), 30)
    assert status == 409 and json.loads(text) == {"resume_layer": 1}
    status, text = tkt._post_chunked(
        url, "/kv/recv", dict(headers, **{"X-KV-Start-Layer": "1"}),
        _push_frames(P, blocks[:n_full], meta, 1, start=1), 30)
    assert status == 200 and json.loads(text)["layers"] == 2
    P.async_engine.run_on_engine(
        lambda e: e.scheduler.allocator.free_blocks(blocks[:n_full]))
    spliced0 = D.engine.spliced_seqs
    status, dec = _post(f"{d}/v1/completions", _body(
        prompt + [meta["first_token"]], 4,
        kv_transfer_params={"transfer_id": "t-409"}))
    assert D.engine.spliced_seqs == spliced0 + 1
    rest = _run(dec)
    first = _run(pre)
    _assert_run_same(want, (first[0] + rest[0], first[1] + rest[1]))


def test_push_kv_resumes_after_a_digest_error(pd, monkeypatch):
    """``push_kv`` itself: its first attempt sends a corrupt group, the
    receiver answers 409, the second attempt starts at that group."""
    (_, u), (P, p), (D, d) = pd
    prompt = list(range(300, 321))
    status, pre = _post(f"{p}/v1/completions", _body(prompt, 1,
                        kv_transfer_params={"do_remote_decode": True}))
    blocks = pre["kv_transfer_params"]["remote_block_ids"][:len(prompt) // BS]
    real = tkt.produce_frames
    starts = []

    def flaky(*a, start_layer=0, **kw):
        starts.append(start_layer)
        for i, fr in enumerate(real(*a, start_layer=start_layer, **kw)):
            if len(starts) == 1 and i == 1:
                fr = fr[:-1] + bytes([fr[-1] ^ 1])  # a bad CRC
            yield fr

    monkeypatch.setattr(tkt, "produce_frames", flaky)
    out = tkt.push_kv(d, P.async_engine.run_on_engine, blocks,
                      P._kv_shape(len(blocks)), "float32",
                      {"transfer_id": "t-retry", "prompt_token_ids": prompt,
                       "first_token": 50}, group=1)
    assert out["ok"] and starts == [0, 1]
    D._sweep_kv_transfers()
    with D._kv_lock:
        st = D._kv_transfers.pop("t-retry")
    D.async_engine.run_on_engine(
        lambda e: e.scheduler.allocator.free_blocks(st["blocks"]))


def test_full_pool_503_and_ttl_sweep(weights):
    P, p = _port_server(weights, "prefill")
    small, s_url = _port_server(weights, "decode", num_blocks=6, ttl=0.3)
    try:
        prompt = list(range(10, 50))  # 10 blocks: more than 6
        status, pre = _post(f"{p}/v1/completions", _body(prompt, 1,
                            kv_transfer_params={"do_remote_decode": True,
                                                "push_url": s_url,
                                                "transfer_id": "t-full"}))
        assert status == 200 and pre["kv_transfer_params"]["pushed"] is False
        blocks = pre["kv_transfer_params"]["remote_block_ids"]
        headers = {"X-KV-Transfer-Id": "t-direct",
                   "X-KV-Shape": ",".join(map(str, P._kv_shape(len(blocks)))),
                   "X-KV-Dtype": "float32", "X-KV-Group-Layers": "1"}
        P.async_engine.run_on_engine(
            lambda e: e.scheduler.allocator.pin_blocks(blocks[:10]))
        try:
            status, text = tkt._post_chunked(
                s_url, "/kv/recv", headers,
                _push_frames(P, blocks, {"transfer_id": "t-direct"}, 1), 30)
        finally:
            P.async_engine.run_on_engine(
                lambda e: e.scheduler.allocator.free_blocks(blocks[:10]))
        assert status == 503
        # a transfer that fits, never attached: the sweep frees it
        short = list(range(10, 25))
        status, pre = _post(f"{p}/v1/completions", _body(short, 1,
                            kv_transfer_params={"do_remote_decode": True,
                                                "push_url": s_url,
                                                "transfer_id": "t-ttl"}))
        assert pre["kv_transfer_params"]["pushed"] is True
        free = small.engine.scheduler.num_free_blocks
        assert free < 6 and "t-ttl" in small._kv_transfers
        time.sleep(0.4)
        small._sweep_kv_transfers()
        assert not small._kv_transfers
        assert small.engine.scheduler.num_free_blocks == 6
        # a decode hop for the swept transfer prefills instead
        status, dec = _post(f"{s_url}/v1/completions", _body(
            short + [65], 2, kv_transfer_params={"transfer_id": "t-ttl"}))
        assert status == 200 and small.engine.spliced_seqs == 0
        status, bad = _post(f"{s_url}/v1/completions", _body(
            short, 2, n=2, kv_transfer_params={"transfer_id": "t-ttl"}))
        assert status == 400
    finally:
        P.shutdown()
        small.shutdown()


# -- the JAX package's aiohttp servers as peers ------------------------------

@pytest.mark.parametrize("producer", ["jax", "port"])
@pytest.mark.parametrize("flow", ["push", "pull"])
def test_jax_and_port_servers_transfer(weights, producer, flow):
    """One engine of each package: the producer prefills, the KV crosses
    between aiohttp and the port's stdlib server (chunked bodies both
    ways), and the consumer's continuation is the unified run."""
    from aiohttp.test_utils import TestServer

    jconf, tconf = _configs()
    prompt = list(range(40, 73))
    n_out = 6

    async def main():
        import aiohttp

        js = JaxServer(jconf, engine=jax_engine(weights, jconf))
        jts = TestServer(js.build_app())
        await jts.start_server()
        j_url = f"http://127.0.0.1:{jts.port}"
        ts, t_url = _port_server(weights)
        prod_url, cons_url = ((j_url, t_url) if producer == "jax"
                              else (t_url, j_url))
        cons = ts if producer == "jax" else js
        try:
            async with aiohttp.ClientSession() as s:
                async def post(url, body):
                    async with s.post(f"{url}/v1/completions",
                                      json=body) as r:
                        assert r.status == 200, await r.text()
                        return await r.json()

                want = _run(await post(j_url, _body(prompt, n_out)))
                kv = {"do_remote_decode": True}
                if flow == "push":
                    kv.update(push_url=cons_url, transfer_id="x-1")
                pre = await post(prod_url, _body(prompt, 1,
                                                 kv_transfer_params=kv))
                pkv = pre["kv_transfer_params"]
                first = _run(pre)
                spliced0 = cons.engine.stats()["spliced_seqs_total"]
                if flow == "push":
                    assert pkv["pushed"] is True
                    dec = await post(cons_url, _body(
                        prompt + [ord(first[0])], n_out - 1,
                        kv_transfer_params={"do_remote_prefill": True,
                                            "transfer_id": "x-1"}))
                    assert (cons.engine.stats()["spliced_seqs_total"]
                            == spliced0 + 1)
                    rest = _run(dec)
                    got = (first[0] + rest[0], first[1] + rest[1])
                else:
                    dec = await post(cons_url, _body(prompt, n_out,
                                     kv_transfer_params=dict(
                                         pkv, remote_host=prod_url)))
                    assert dec["usage"]["prompt_tokens_details"][
                        "cached_tokens"] == (len(prompt) - 1) // BS * BS
                    if cons is ts:  # the reference counts no import leg
                        assert cons.metrics.transfer_totals["import"][
                            "count"] == 1
                    got = _run(dec)
                _assert_run_same(want, got)
        finally:
            await asyncio.get_running_loop().run_in_executor(None,
                                                             ts.shutdown)
            await jts.close()

    asyncio.run(main())


# -- the unchanged router in front of two port servers -----------------------

@pytest.mark.parametrize("stream", [False, True])
def test_router_orchestrates_port_pair(pd, stream):
    from aiohttp.test_utils import TestClient, TestServer

    (_, u), (P, p), (D, d) = pd
    prompt = "the port serves both hops of a disaggregated request"
    n_out = 7

    async def main():
        args = build_parser().parse_args([
            "--service-discovery", "static",
            "--static-backends", f"{p},{d}",
            "--static-models", "tiny-llama,tiny-llama",
            "--static-backend-roles", "prefill,decode",
            "--routing-logic", "disaggregated_prefill_orchestrated",
        ])
        client = TestClient(TestServer(RouterApp(args).build_app()))
        await client.start_server()
        try:
            body = {"model": "tiny-llama", "prompt": prompt,
                    "max_tokens": n_out, "temperature": 0,
                    "ignore_eos": True, "allowed_token_ids": ALLOWED,
                    "stream": stream}
            async with client.post("/v1/completions", json=body) as r:
                assert r.status == 200, await r.text()
                raw = await r.read()
        finally:
            await client.close()
        if not stream:
            return json.loads(raw)["choices"][0]["text"]
        events = [json.loads(b[len(b"data: "):]) for b in raw.split(b"\n\n")
                  if b.startswith(b"data: ") and b != b"data: [DONE]"]
        assert raw.rstrip().endswith(b"data: [DONE]")
        return "".join(e["choices"][0]["text"] for e in events
                       if e.get("choices"))

    loop = asyncio.new_event_loop()
    spliced0 = D.engine.spliced_seqs
    imports0 = D.metrics.transfer_totals.get("import", {}).get("count", 0)
    try:
        text = loop.run_until_complete(main())
    finally:
        loop.close()
    want = _post(f"{u}/v1/completions", {
        "model": "tiny-llama", "prompt": prompt, "max_tokens": n_out,
        "temperature": 0, "ignore_eos": True,
        "allowed_token_ids": ALLOWED})[1]["choices"][0]["text"]
    assert text == want
    if stream:  # pushed and spliced
        assert D.engine.spliced_seqs == spliced0 + 1
    else:  # pulled into the decode engine's prefix cache
        assert D.metrics.transfer_totals["import"]["count"] == imports0 + 1
