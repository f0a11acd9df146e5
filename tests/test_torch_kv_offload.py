"""The port's host and remote KV tiers against the JAX package's, on the CPU.

- ``HostKVStore``: one op sequence (puts, sequence puts, probes, matches)
  drives the JAX store (numpy slabs) and the port's (torch slabs); after
  every op the LRU order, the byte and hit counters, each op's result and
  the demote-hook calls are equal;
- ``chain_hashes`` equals the JAX function's (from the base seed);
- the remote tier: the port's ``RemoteKVClient`` against the port's
  ``kv_server`` and against the JAX ``KVServer`` app, the JAX client
  against the port's server, and slabs written by either client read back
  bit for bit by the other (float32 and bf16 words);
- the port's ``kv_server``: capacity LRU, the TTL sweep, 413, ``/lookup``,
  ``/stats`` and ``/metrics`` with the JAX server's keys and names.
"""

import asyncio
import contextlib
import json
import threading
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import kv_offload as jko
from production_stack_tpu.kv_server import KVServer as JaxKVServer
from production_stack_tpu_torch.engine import kv_offload as tko
from production_stack_tpu_torch.engine.kv_cache import HASH_SEED
from production_stack_tpu_torch.kv_server import KVServer

BS = 4
SLAB = (2, BS, 4, 8)  # (L, bs, 2KH, D)


def _slab_pair(rng, dtype="float32"):
    """The same slab as numpy (for the JAX side) and torch (the port)."""
    x = rng.standard_normal(SLAB)
    if dtype == "bfloat16":
        a = x.astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    a = x.astype(np.float32)
    return a, torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("tokens,bs", [
    (list(range(17)), 4), ([5] * 32, 8), (list(range(100, 3, -1)), 16),
    ([1, 2, 3], 4)])
def test_chain_hashes_equal(tokens, bs):
    assert tko.chain_hashes(tokens, bs) == jko.chain_hashes(tokens, bs)
    assert tko.chain_hashes(tokens, bs, HASH_SEED) == jko.chain_hashes(
        tokens, bs)
    if len(tokens) >= bs:  # another root, another chain
        assert tko.chain_hashes(tokens, bs, 12345)[0] != jko.chain_hashes(
            tokens, bs)[0]


def _ops(seed: int, n_ops: int = 60):
    """A seeded op sequence over a few shared prefixes (so chains extend,
    hit and break)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 50, 6 * BS).tolist() for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        base = prefixes[int(rng.integers(0, 3))]
        n = int(rng.integers(1, 7)) * BS + int(rng.integers(0, BS))
        tokens = (base + rng.integers(0, 50, 8 * BS).tolist())[:n]
        kind = int(rng.integers(0, 4))
        start = int(rng.integers(0, 3))
        n_full = len(tokens) // BS
        slabs = [_slab_pair(rng) for _ in range(n_full)]
        ops.append((kind, tokens, start, slabs))
    return ops


@pytest.mark.parametrize("seed,sizing", [
    (0, {"capacity_blocks": 8}),
    (1, {"capacity_blocks": 5}),
    (2, {"capacity_blocks": 0, "capacity_bytes": 6 * 2 * 4 * 4 * 8 * 4}),
    (3, {"capacity_blocks": 7, "bytes_per_block": 2 * 4 * 4 * 8 * 4}),
    (4, {"capacity_blocks": 64}),
])
def test_host_store_equals_reference(seed, sizing):
    jstore = jko.HostKVStore(block_size=BS, **sizing)
    tstore = tko.HostKVStore(block_size=BS, **sizing)
    jdemoted, tdemoted = [], []
    jstore.demote_hook = lambda h, s: jdemoted.append((h, _bits(s).copy()))
    tstore.demote_hook = lambda h, s: tdemoted.append((h, _bits(s).copy()))
    for kind, tokens, start, slabs in _ops(seed):
        if kind == 0:
            got = [s.put_sequence(tokens, [p[i] for p in slabs])
                   for s, i in ((jstore, 0), (tstore, 1))]
            assert got[0] == got[1]
        elif kind == 1:
            h = jko.chain_hashes(tokens, BS)
            if h:
                assert (jstore.put(h[-1], slabs[-1][0])
                        == tstore.put(h[-1], slabs[-1][1]))
        elif kind == 2:
            assert (jstore.probe_extension(tokens, start)
                    == tstore.probe_extension(tokens, start))
        else:
            (js, jn), (ts, tn) = (jstore.match_extension(tokens, start),
                                  tstore.match_extension(tokens, start))
            assert jn == tn
            for a, b in zip(js, ts):
                assert np.array_equal(_bits(a), _bits(b))
        assert list(jstore.store) == list(tstore.store)
        for key in ("used_bytes", "capacity_bytes", "stores", "hits",
                    "queries", "evictions", "demotions", "usage"):
            assert getattr(jstore, key) == getattr(tstore, key), key
    assert [h for h, _ in jdemoted] == [h for h, _ in tdemoted]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(jdemoted,
                                                               tdemoted))
    assert jstore.evictions > 0 or sizing.get("capacity_blocks") == 64


def test_host_store_keys_by_root():
    """A chain from another root (an adapter's) is another block: it
    never matches the base chain's lookups."""
    store = tko.HostKVStore(16, BS)
    rng = np.random.default_rng(0)
    tokens = list(range(1, 13))
    store.put_sequence(tokens, [_slab_pair(rng)[1] for _ in range(3)],
                       root=987654321)
    assert store.match_extension(tokens + [99], 0) == ([], 0)
    assert store.probe_extension(tokens + [99], 0, root=987654321) == 3
    _, n = store.match_extension(tokens + [99], 0, root=987654321)
    assert n == 3


@contextlib.contextmanager
def _jax_server(**kw):
    """The JAX package's aiohttp KVServer app on a loop in a thread."""
    from aiohttp import web

    srv = JaxKVServer(**kw)
    loop = asyncio.new_event_loop()
    ready, box = threading.Event(), {}

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(srv.build_app())
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"] = runner.addresses[0][1]
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(30)
    try:
        yield srv, f"http://127.0.0.1:{box['port']}"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(30)


@contextlib.contextmanager
def _port_server(**kw):
    srv = KVServer(**kw)
    url = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
    try:
        yield srv, url
    finally:
        srv.shutdown()


def _drain_puts(client, store, n):
    """Wait until ``n`` puts reached ``store``."""
    import time

    t_end = time.monotonic() + 30
    while store.puts < n:
        assert time.monotonic() < t_end, "remote puts never landed"
        time.sleep(0.01)


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_client_against_either_server(server, dtype):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 100, 5 * BS + 1).tolist()
    hashes = tko.chain_hashes(tokens, BS)
    pairs = [_slab_pair(rng, dtype) for _ in hashes]
    ctx = _port_server() if server == "port" else _jax_server()
    with ctx as (store, url):
        client = tko.RemoteKVClient(url, BS)
        try:
            for h, (_, t) in zip(hashes[:4], pairs):
                client.put_slab(h, t)
            _drain_puts(client, store, 4)
            got = client.match_extension(hashes, 0, len(hashes))
            assert len(got) == 4  # the run stops at the first miss
            for g, (a, t) in zip(got, pairs):
                assert g.dtype == t.dtype and torch.equal(g, t)
                assert np.array_equal(_bits(g), _bits(a))
            assert (client.hits, client.queries) == (4, 5)
            assert client.match_extension(hashes, 1, 3) and \
                client.get_slab(hashes[4]) is None
            # the JAX client reads what the port's wrote, bit for bit
            jclient = jko.RemoteKVClient(url, BS)
            jgot = jclient.match_extension(hashes, 0, 4)
            assert [np.array_equal(_bits(np.asarray(g)), _bits(a))
                    for g, (a, _) in zip(jgot, pairs)] == [True] * 4
        finally:
            client.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_client_against_port_server(dtype):
    rng = np.random.default_rng(2)
    hashes = tko.chain_hashes(rng.integers(0, 100, 3 * BS).tolist(), BS)
    pairs = [_slab_pair(rng, dtype) for _ in hashes]
    with _port_server() as (store, url):
        jclient = jko.RemoteKVClient(url, BS)
        for h, (a, _) in zip(hashes, pairs):
            jclient.put_slab(h, a)
        _drain_puts(jclient, store, len(hashes))
        got = jclient.match_extension(hashes, 0, len(hashes))
        assert len(got) == len(hashes) and jclient.hits == len(hashes)
        for g, (a, _) in zip(got, pairs):
            assert np.array_equal(_bits(np.asarray(g)), _bits(a))
        # and the port's client reads the JAX client's slabs
        client = tko.RemoteKVClient(url, BS)
        try:
            for h, (_, t) in zip(hashes, pairs):
                assert torch.equal(client.get_slab(h), t)
        finally:
            client.shutdown()


def _req(url, data=None, method=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_kv_server_routes_lru_ttl_and_limits():
    with _port_server(capacity_blocks=3, max_block_bytes=64,
                      ttl_seconds=100.0) as (srv, url):
        for k in "abcd":
            status, _, body = _req(f"{url}/blocks/{k}", k.encode() * 8, "PUT",
                                   {"X-KV-Meta": json.dumps({"k": k})})
            assert status == 200 and json.loads(body) == {"stored": True}
        assert list(srv.blocks) == ["b", "c", "d"] and srv.evictions == 1
        status, headers, body = _req(f"{url}/blocks/c")
        assert status == 200 and body == b"cccccccc"
        assert json.loads(headers["X-KV-Meta"]) == {"k": "c"}
        assert list(srv.blocks) == ["b", "d", "c"]  # a read refreshes LRU
        assert _req(f"{url}/blocks/a")[0] == 404
        status, _, body = _req(f"{url}/blocks/big", b"x" * 65, "PUT")
        assert status == 413 and srv.rejected == 1
        status, _, body = _req(f"{url}/lookup", json.dumps(
            {"keys": ["a", "b", "c"]}).encode(), "POST")
        assert json.loads(body) == {"present": ["b", "c"]}
        status, _, body = _req(f"{url}/stats")
        with _jax_server() as (jsrv, _):
            assert set(json.loads(body)) == set(jsrv.stats_dict())
        stats = json.loads(body)
        assert (stats["blocks"], stats["bytes"], stats["hits"],
                stats["misses"], stats["puts"]) == (3, 24, 1, 1, 4)
        _, _, text = _req(f"{url}/metrics")
        names = {ln.split()[0] for ln in text.decode().splitlines()
                 if not ln.startswith("#")}
        assert names == {"kvserver:blocks", "kvserver:usage_perc",
                         "kvserver:bytes", "kvserver:hits_total",
                         "kvserver:misses_total", "kvserver:puts_total",
                         "kvserver:evictions_total",
                         "kvserver:expired_total",
                         "kvserver:rejected_total"}
        assert _req(f"{url}/health")[2] == b'{"status": "healthy"}'
        # idle TTL: everything not read within it expires, LRU front first
        last = srv.blocks["c"][2]
        assert srv.sweep_expired(now=last + 99.0) == 0
        assert srv.sweep_expired(now=last + 100.5) == 3
        assert not srv.blocks and srv.expired == 3 and srv.used_bytes == 0


def test_kv_server_takes_a_chunked_put():
    import http.client

    with _port_server() as (srv, url):
        conn = http.client.HTTPConnection("127.0.0.1", int(url.rsplit(":", 1)[1]))
        conn.putrequest("PUT", "/blocks/k")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        for part in (b"abc", b"defgh"):
            conn.send(f"{len(part):x}\r\n".encode() + part + b"\r\n")
        conn.send(b"0\r\n\r\n")
        assert conn.getresponse().status == 200
        conn.close()
        assert srv.blocks["k"][0] == b"abcdefgh"
