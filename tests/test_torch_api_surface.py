"""The port's server against the JAX package's, endpoint by endpoint, on
the CPU: the scoring routes, echo, guided_choice, the Messages and
Responses APIs and sleep mode.

Both servers serve tiny-llama (float32) on one weight set with the same
options: the JAX server as an aiohttp test server on an event loop of its
own thread, the port's on its threads. Each request goes to both over
HTTP. JSON bodies must be equal except ``id``, ``created``,
``created_at`` and ``item_id`` (random or clock values), with floats
within 1e-4; SSE streams must have the same events in the same order,
each equal by the same rule. Generation is greedy, so both engines emit
the same tokens; ``guided_choice`` at temperature 0.8 draws from the same
``numpy`` generator over the same scores. A table of malformed bodies
gets the same status codes from both. Sleep runs on a fresh pair of
servers: the 409 with a stream in flight, a request admitted while asleep
that waits for ``/wake_up``, and levels 1 and 2.
"""

import asyncio
import http.client
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from _torch_parity import engine_configs, jax_engine, port_engine, tiny_weights
from production_stack_tpu.engine.server import EngineServer as JaxServer
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)

FLOAT_TOL = 1e-4
VOLATILE = {"id", "created", "created_at", "item_id"}


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


class _Pair:
    """A JAX server and a port server on one weight set."""

    def __init__(self, weights):
        from aiohttp.test_utils import TestServer

        jconf, tconf = engine_configs(
            "ragged", block_size=4, num_blocks=512, max_num_seqs=4,
            max_num_batched_tokens=64, prefill_buckets=(32, 64, 128))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.jax = JaxServer(jconf, engine=jax_engine(weights, jconf))
        self.jts = self._on(self._start(TestServer, self.jax))
        self.port = EngineServer(tconf, engine=port_engine(weights, tconf))
        self.urls = (f"http://127.0.0.1:{self.jts.port}",
                     f"http://127.0.0.1:{self.port.start('127.0.0.1', 0)}")

    @staticmethod
    async def _start(test_server, server):
        ts = test_server(server.build_app())
        await ts.start_server()
        return ts

    def _on(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(300)

    def close(self):
        self.port.shutdown()
        self._on(self.jts.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def pair(weights):
    p = _Pair(weights)
    yield p
    p.close()


def call(url, path, body=None, method=None):
    """(status, text) of a request; an HTTP error status is returned."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def sse(text: str) -> list:
    """The events of an SSE body: (event name or None, data)."""
    out = []
    for block in text.strip().split("\n\n"):
        name, data = None, None
        for line in block.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                raw = line[len("data: "):]
                data = raw if raw == "[DONE]" else json.loads(raw)
        out.append((name, data))
    return out


def same(a, b, where="$"):
    """a == b but for VOLATILE keys and floats within FLOAT_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict), where
        assert set(a) - VOLATILE == set(b) - VOLATILE, (where, a, b)
        for k in a:
            if k not in VOLATILE:
                same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a,
                                                                   b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float))
        assert abs(a - b) <= FLOAT_TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def both(pair, path, body, stream=False):
    """The JAX server's and the port's answer, held equal; returns the
    port's (status, parsed body)."""
    (js, jt), (ps, pt) = (call(u, path, body) for u in pair.urls)
    assert js == ps, (path, body, jt, pt)
    if stream and js == 200:
        want, got = sse(jt), sse(pt)
        assert [n for n, _ in want] == [n for n, _ in got]
    else:
        want, got = json.loads(jt), json.loads(pt)
    same(want, got)
    return ps, got


CHAT = [{"role": "user", "content": "name three colours"}]
GREEDY = {"temperature": 0, "ignore_eos": True}

SCORING = {
    "embeddings": ("/v1/embeddings", {"model": "tiny-llama",
                                      "input": ["alpha", "beta gamma"]}),
    "embeddings-ids": ("/v1/embeddings", {"input": [5, 6, 7, 8]}),
    "embeddings-id-batch": ("/v1/embeddings",
                            {"input": [[5, 6], [7, 8, 9, 10, 11]]}),
    "embeddings-long": ("/v1/embeddings", {"input": "x" * 120}),
    "pooling": ("/pooling", {"input": ["alpha", "beta gamma"]}),
    "score": ("/v1/score", {"text_1": "a cat", "text_2": [
        "a cat", "a dog", "stock prices"]}),
    "score-pairwise": ("/v1/score", {"text_1": ["q one", "q two"],
                                     "text_2": ["d one", "d two"]}),
    "rerank": ("/v1/rerank", {"query": "a cat", "documents": [
        "stock prices", {"text": "a cat"}, "a dog"], "top_n": 2}),
    "rerank-no-documents": ("/v1/rerank", {
        "query": "a cat", "documents": ["x", "a cat"],
        "return_documents": False}),
    "rerank-alias": ("/rerank", {"query": "q", "documents": ["a", "q"]}),
}


@pytest.mark.parametrize("case", sorted(SCORING))
def test_scoring_routes(pair, case):
    path, body = SCORING[case]
    status, out = both(pair, path, body)
    assert status == 200
    if "embeddings" in case or case == "pooling":
        key = "data" if case == "pooling" else "embedding"
        assert all(len(d[key]) == 128 for d in out["data"])


ECHO = {
    "score-only": {"prompt": "the cat sat", "echo": True, "max_tokens": 0},
    "score-only-logprobs": {"prompt": "the cat sat", "echo": True,
                            "max_tokens": 0, "logprobs": 2},
    "score-only-batch-n2": {"prompt": [[256, 40, 41, 42], [256, 50, 51]],
                            "echo": True, "max_tokens": 0, "logprobs": 1,
                            "n": 2},
    "generate": {"prompt": "the cat sat", "echo": True, "max_tokens": 5,
                 **GREEDY},
    "generate-logprobs": {"prompt": "the cat sat", "echo": True,
                          "max_tokens": 5, "logprobs": 3, **GREEDY},
    "logprobs-zero": {"prompt": "hi there", "echo": True, "max_tokens": 0,
                      "logprobs": 0},
}


@pytest.mark.parametrize("case", sorted(ECHO))
def test_echo(pair, case):
    status, out = both(pair, "/v1/completions", ECHO[case])
    assert status == 200
    assert out["choices"][0]["text"].startswith("the cat sat") or \
        "batch" in case or "zero" in case


def test_echo_is_ignored_by_chat(pair):
    status, _ = both(pair, "/v1/chat/completions", {
        "messages": CHAT, "echo": True, "max_tokens": 3, **GREEDY})
    assert status == 200


GUIDED = {
    "completions": ("/v1/completions", {"prompt": "is it red?"}),
    "chat": ("/v1/chat/completions", {"messages": CHAT}),
}


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("temperature", [0, 0.8])
@pytest.mark.parametrize("kind", sorted(GUIDED))
def test_guided_choice(pair, kind, temperature, stream):
    path, body = GUIDED[kind]
    choices = ["yes", "no", "maybe so", "red"]
    status, out = both(pair, path, dict(
        body, guided_choice=choices, temperature=temperature, seed=3,
        stream=stream), stream=stream)
    assert status == 200
    if stream:
        assert out[-1] == (None, "[DONE]") and len(out) == 3
        first = out[0][1]["choices"][0]
        text = first["delta"]["content"] if kind == "chat" else first["text"]
    else:
        c = out["choices"][0]
        text = c["message"]["content"] if kind == "chat" else c["text"]
    assert text in choices


MESSAGES = {
    "plain": {"messages": CHAT, "max_tokens": 6, **GREEDY},
    "system-and-blocks": {
        "system": "be brief", "max_tokens": 6, **GREEDY,
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "hello "},
            {"type": "image", "source": {}},
            {"type": "text", "text": "world"}]}]},
    "stop-sequences": {"messages": CHAT, "max_tokens": 12,
                       "stop_sequences": ["\x00", "e"], **GREEDY},
}


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_messages(pair, case, stream):
    status, out = both(pair, "/v1/messages", dict(MESSAGES[case],
                                                  stream=stream),
                       stream=stream)
    assert status == 200
    if stream:
        names = [n for n, _ in out]
        assert names[:2] == ["message_start", "content_block_start"]
        assert names[-3:] == ["content_block_stop", "message_delta",
                              "message_stop"]


RESPONSES = {
    "string": {"input": "name three colours", "max_output_tokens": 6,
               **GREEDY},
    "items": {"instructions": "be brief", "max_output_tokens": 6, **GREEDY,
              "input": [{"role": "user", "content": [
                  {"type": "input_text", "text": "hi"},
                  {"type": "input_image", "image_url": "x"}]},
                  {"type": "message", "role": "assistant",
                   "content": "hello"}]},
    "finished-by-length": {"input": "x", "max_output_tokens": 3, **GREEDY},
}


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", sorted(RESPONSES))
def test_responses(pair, case, stream):
    status, out = both(pair, "/v1/responses", dict(RESPONSES[case],
                                                   stream=stream),
                       stream=stream)
    assert status == 200
    if stream:
        names = [n for n, _ in out]
        assert names[:2] == ["response.created",
                             "response.output_item.added"]
        assert names[-2:] == ["response.output_text.done",
                              "response.completed"]
        assert [d["sequence_number"] for _, d in out] == list(
            range(len(out)))


def test_responses_stop_string_holdback(pair):
    """``tests/test_engine_server.py``'s holdback case on both servers: a
    stop string taken from the greedy output never leaks into the
    stream, the deltas add up to the final text, and usage counts only
    the tokens the kept text covers."""
    body = {"model": "tiny-llama", "input": "probe", "temperature": 0,
            "max_output_tokens": 12, "ignore_eos": True}
    _, full = both(pair, "/v1/responses", body)
    text = full["output"][0]["content"][0]["text"]
    assert len(text) >= 4
    stop = text[2:4]
    _, events = both(pair, "/v1/responses", dict(body, stop=[stop],
                                                 stream=True), stream=True)
    final = events[-1][1]["response"]
    kept = final["output"][0]["content"][0]["text"]
    assert stop not in kept
    assert "".join(d["delta"] for n, d in events
                   if n == "response.output_text.delta") == kept
    _, cut = both(pair, "/v1/responses", dict(body, stop=[stop]))
    assert cut["output"][0]["content"][0]["text"] == kept
    assert cut["usage"]["output_tokens"] < 12


MALFORMED = {
    "embeddings-no-input": ("/v1/embeddings", {}),
    "embeddings-int": ("/v1/embeddings", {"input": 123}),
    "embeddings-object": ("/v1/embeddings", {"input": {"x": 1}}),
    "embeddings-mixed": ("/v1/embeddings", {"input": ["a", [1, "b"]]}),
    "pooling-no-input": ("/pooling", {"model": "tiny-llama"}),
    "score-missing": ("/v1/score", {"text_1": "a"}),
    "score-lengths": ("/v1/score", {"text_1": ["a", "b"],
                                    "text_2": ["c", "d", "e"]}),
    "score-types": ("/v1/score", {"text_1": 1, "text_2": "b"}),
    "score-unserved-alias": ("/score", {"text_1": "a", "text_2": "b"}),
    "rerank-no-documents": ("/v1/rerank", {"query": "q"}),
    "rerank-empty": ("/v1/rerank", {"query": "q", "documents": []}),
    "rerank-bad-document": ("/rerank", {"query": "q", "documents": [1]}),
    "rerank-top-n-text": ("/v1/rerank", {"query": "q", "documents": ["a"],
                                         "top_n": "x"}),
    "rerank-top-n-negative": ("/v1/rerank", {"query": "q",
                                             "documents": ["a"],
                                             "top_n": -1}),
    "echo-stream": ("/v1/completions", {"prompt": "x", "echo": True,
                                        "stream": True}),
    "echo-guided-choice": ("/v1/completions", {
        "prompt": "x", "echo": True, "guided_choice": ["a"]}),
    "guided-choice-n2": ("/v1/completions", {"prompt": "x", "n": 2,
                                             "guided_choice": ["a", "b"]}),
    "guided-choice-65": ("/v1/completions", {
        "prompt": "x", "guided_choice": [f"c{i}" for i in range(65)]}),
    "guided-choice-empty-string": ("/v1/completions", {
        "prompt": "x", "guided_choice": ["a", ""]}),
    "guided-choice-not-list": ("/v1/chat/completions", {
        "messages": CHAT, "guided_choice": "abc"}),
    "guided-choice-two-prompts": ("/v1/completions", {
        "prompt": ["x", "y"], "guided_choice": ["a"]}),
    "guided-choice-and-regex": ("/v1/completions", {
        "prompt": "x", "guided_choice": ["a"], "guided_regex": "a"}),
    "guided-choice-too-long": ("/v1/completions", {
        "prompt": "x" * 500, "guided_choice": ["y" * 20]}),
    "messages-missing": ("/v1/messages", {}),
    "messages-empty": ("/v1/messages", {"messages": []}),
    "messages-bad-temperature": ("/v1/messages", {
        "messages": CHAT, "temperature": "hot"}),
    "messages-too-long": ("/v1/messages", {
        "messages": [{"role": "user", "content": "x" * 600}]}),
    "messages-not-objects": ("/v1/messages", {"messages": "hi"}),
    "responses-missing": ("/v1/responses", {}),
    "responses-int": ("/v1/responses", {"input": 5}),
    "responses-item-not-object": ("/v1/responses", {"input": [1]}),
    "responses-image-item": ("/v1/responses", {
        "input": [{"type": "input_image"}]}),
    "responses-part-not-object": ("/v1/responses", {
        "input": [{"content": [1]}]}),
    "responses-bad-top-k": ("/v1/responses", {"input": "x",
                                              "top_k": "k"}),
    "responses-too-long": ("/v1/responses", {"input": "x" * 600}),
    "sleep-bad-level": ("/sleep?level=x", {}),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_bodies_get_the_same_status(pair, case):
    path, body = MALFORMED[case]
    (js, jt), (ps, pt) = (call(u, path, body) for u in pair.urls)
    assert js == ps, (case, jt, pt)
    assert js >= 400


def test_invalid_json_gets_400(pair):
    for path in ("/v1/messages", "/v1/responses", "/v1/embeddings",
                 "/v1/score", "/v1/rerank", "/pooling"):
        statuses = [call(u, path, b"{not json")[0] for u in pair.urls]
        assert statuses == [400, 400], (path, statuses)


def test_models_card(pair):
    cards = [json.loads(call(u, "/v1/models")[1])["data"][0]
             for u in pair.urls]
    assert cards[0]["capabilities"] == cards[1]["capabilities"]


# -- sleep mode ---------------------------------------------------------------

def _open_stream(url):
    """A streamed completion of 400 tokens, its first chunk read."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt": "go", "max_tokens": 400, "stream": True, **GREEDY}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.read(6) == b"data: "
    return conn, resp


def test_sleep_wake_and_is_sleeping(weights):
    pair = _Pair(weights)
    try:
        for u in pair.urls:
            assert call(u, "/is_sleeping") == (200, '{"is_sleeping": false}')
        # a stream in flight: both refuse with 409
        streams = [_open_stream(u) for u in pair.urls]
        answers = [call(u, "/sleep", {}) for u in pair.urls]
        assert [s for s, _ in answers] == [409, 409]
        same(*(json.loads(t) for _, t in answers))
        for conn, resp in streams:
            assert resp.read().rstrip().endswith(b"data: [DONE]")
            conn.close()
        for u in pair.urls:
            assert call(u, "/is_sleeping")[1] == '{"is_sleeping": false}'
        status, _ = both(pair, "/sleep?level=1", {})
        assert status == 200
        assert pair.port.engine.runner.kv is None
        for u in pair.urls:
            assert json.loads(call(u, "/is_sleeping")[1]) == {
                "is_sleeping": True}
        # admitted while asleep, served after wake_up
        got = [None, None]
        body = {"prompt": "after the nap", "max_tokens": 4, **GREEDY}

        def send(i):
            got[i] = call(pair.urls[i], "/v1/completions", body)

        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        assert got == [None, None]
        assert pair.port.engine.has_unfinished()
        same(*(json.loads(call(u, "/wake_up", {})[1]) for u in pair.urls))
        for t in threads:
            t.join(60)
        assert [s for s, _ in got] == [200, 200]
        same(*(json.loads(t) for _, t in got))
        # level 2: the weights go too
        status, out = both(pair, "/sleep?level=2", {})
        assert status == 200 and out["level"] == 2
        assert pair.port.engine.runner.params is None
        both(pair, "/wake_up", {})
        assert pair.port.engine.runner.params_alive
        for u in pair.urls:
            assert call(u, "/is_sleeping")[1] == '{"is_sleeping": false}'
    finally:
        pair.close()
