"""The unchanged router in front of the port's Whisper server, on the CPU.

The port's server (tiny-whisper, ``device="cpu"``) listens on a free port
from a background thread; the router of the JAX package runs as an aiohttp
test server in front of it, as in tests/test_whisper.py. The router reads
the ``audio.*`` capabilities from the port's model card, relays a
multipart transcription byte for byte (the port's server records the body
it parsed), and answers a text request for that model with 501 from its
capability filter before it reaches the engine.
"""

import asyncio

import pytest
import torch

from production_stack_tpu.router.app import RouterApp, build_parser
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.whisper_server import WhisperServer
from test_torch_whisper_server import CTYPE, TRANSCRIBE, form

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engine():
    server = WhisperServer(EngineConfig.for_model("tiny-whisper"),
                           device="cpu")
    seen = []
    parse = server.parse_request

    def recording(body, content_type, task):
        seen.append((body, content_type, task))
        return parse(body, content_type, task)

    server.parse_request = recording
    port = server.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}", seen
    server.shutdown()


def test_transcription_relayed_byte_for_byte_and_text_refused(engine):
    url, seen = engine

    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        from production_stack_tpu.router.service_discovery import (
            get_service_discovery,
        )

        args = build_parser().parse_args([
            "--service-discovery", "static",
            "--static-backends", url,
            "--static-models", "tiny-whisper",
            "--static-query-models",
            "--static-backend-health-checks",
            "--health-check-interval", "0.2",
        ])
        client = TestClient(TestServer(RouterApp(args).build_app()))
        await client.start_server()
        try:
            for _ in range(100):
                eps = get_service_discovery().get_endpoint_info()
                if eps and eps[0].capabilities is not None:
                    break
                await asyncio.sleep(0.1)
            assert eps and "audio.transcriptions" in eps[0].capabilities
            body = form(language="en", response_format="verbose_json")
            r = await client.post(TRANSCRIBE, data=body,
                                  headers={"Content-Type": CTYPE})
            assert r.status == 200, await r.text()
            out = await r.json()
            assert out["language"] == "en" and out["segments"]
            assert seen[-1] == (body, CTYPE, "transcribe")

            r = await client.post("/v1/completions", json={
                "model": "tiny-whisper", "prompt": "hi", "max_tokens": 2})
            assert r.status == 501, await r.text()
            r = await client.post("/v1/chat/completions", json={
                "model": "tiny-whisper",
                "messages": [{"role": "user", "content": "hi"}]})
            assert r.status == 501
            assert len(seen) == 1  # neither reached the engine
        finally:
            await client.close()

    asyncio.run(main())
