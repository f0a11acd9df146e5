"""The unchanged router fronts the PyTorch port's server, on the CPU.

The port's server (tiny-llama, ``device="cpu"``) listens on a free port
from a background thread; the router of the JAX package runs as an
aiohttp test server in front of it, as in tests/test_router_e2e.py. The
router's stats scraper reads the port's /metrics, and its discovery reads
the port's /ready (draining after ``POST /drain``).
"""

import asyncio
import json
import time
import urllib.request

import pytest
import torch

from production_stack_tpu.router.app import RouterApp, build_parser
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.server import EngineServer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engine_url():
    cfg = EngineConfig.for_model(
        "tiny-llama",
        cache=CacheConfig(block_size=4, num_blocks=512),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
    )
    server = EngineServer(cfg, device="cpu")
    port = server.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}"
    server.shutdown()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def test_direct_completion_chat_and_stream(engine_url):
    status, body = _post(f"{engine_url}/v1/completions", {
        "model": "tiny-llama", "prompt": "hello", "max_tokens": 5,
        "temperature": 0, "ignore_eos": True, "logprobs": 2})
    out = json.loads(body)
    assert status == 200 and out["object"] == "text_completion"
    assert out["usage"]["completion_tokens"] == 5
    assert len(out["choices"][0]["logprobs"]["token_logprobs"]) == 5

    status, body = _post(f"{engine_url}/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
        "temperature": 0.8, "top_p": 0.95, "ignore_eos": True, "stream": True,
        "stream_options": {"include_usage": True}})
    assert status == 200
    events = [ln[len("data: "):] for ln in body.split("\n")
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["usage"]["completion_tokens"] == 4
    assert chunks[-2]["choices"][0]["finish_reason"] == "length"

    req = urllib.request.Request(f"{engine_url}/v1/completions",
                                 data=b'{"max_tokens": 2}')
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_models_and_completion_through_router(engine_url):
    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        args = build_parser().parse_args([
            "--service-discovery", "static",
            "--static-backends", engine_url,
            "--static-models", "tiny-llama",
        ])
        client = TestClient(TestServer(RouterApp(args).build_app()))
        await client.start_server()
        try:
            r = await client.get("/v1/models")
            assert r.status == 200
            data = await r.json()
            assert [m["id"] for m in data["data"]] == ["tiny-llama"]
            r = await client.post("/v1/completions", json={
                "model": "tiny-llama", "prompt": "hello", "max_tokens": 4,
                "temperature": 0, "ignore_eos": True})
            assert r.status == 200
            body = await r.json()
            assert body["usage"]["completion_tokens"] == 4
            r = await client.post("/v1/chat/completions", json={
                "model": "tiny-llama", "stream": True, "max_tokens": 3,
                "messages": [{"role": "user", "content": "hey"}],
                "ignore_eos": True})
            assert r.status == 200
            assert (await r.text()).rstrip().endswith("data: [DONE]")
        finally:
            await client.close()

    asyncio.run(main())


def test_router_scraper_reads_port_stats(engine_url):
    """The router's EngineStatsScraper reads the port's /metrics into
    non-empty EngineStats (prefix-cache queries of the requests above and
    of this test's own)."""
    for _ in range(2):
        status, _ = _post(f"{engine_url}/v1/completions", {
            "prompt": "scraped twice, the second time from the cache",
            "max_tokens": 2, "temperature": 0})
        assert status == 200

    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        from production_stack_tpu.router.stats import (
            get_engine_stats_scraper,
        )

        args = build_parser().parse_args([
            "--service-discovery", "static",
            "--static-backends", engine_url,
            "--static-models", "tiny-llama",
        ])
        client = TestClient(TestServer(RouterApp(args).build_app()))
        await client.start_server()
        try:
            scraper = get_engine_stats_scraper()
            await scraper.scrape_once()
            stats = scraper.get_engine_stats()[engine_url]
            assert stats.gpu_prefix_cache_queries_total > 0
            assert stats.gpu_prefix_cache_hits_total > 0
            assert 0 < stats.gpu_prefix_cache_hit_rate <= 1
            assert 0 <= stats.gpu_cache_usage_perc < 1
        finally:
            await client.close()

    asyncio.run(main())


def test_discovery_sees_a_draining_port():
    """After ``POST /drain`` the router's discovery (health checks on)
    classifies the port's engine as draining, from its /ready."""
    cfg = EngineConfig.for_model(
        "tiny-llama",
        cache=CacheConfig(block_size=4, num_blocks=256),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
    )
    server = EngineServer(cfg, device="cpu")
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"

    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        from production_stack_tpu.router.service_discovery import (
            get_service_discovery,
        )

        args = build_parser().parse_args([
            "--service-discovery", "static",
            "--static-backends", url,
            "--static-models", "tiny-llama",
            "--static-backend-health-checks",
            "--health-check-interval", "0.1",
        ])
        client = TestClient(TestServer(RouterApp(args).build_app()))
        await client.start_server()
        try:
            disc = get_service_discovery()
            await asyncio.sleep(0.3)
            assert url not in disc.draining_urls
            status, _ = _post(f"{url}/drain", {})
            assert status == 200
            deadline = time.monotonic() + 5.0
            while (time.monotonic() < deadline
                   and url not in disc.draining_urls):
                await asyncio.sleep(0.05)
            assert url in disc.draining_urls
        finally:
            await client.close()

    try:
        asyncio.run(main())
    finally:
        server.shutdown()
