"""The remote KV cache server: the shared warm tier behind many engines.

Ports production_stack_tpu/kv_server.py from aiohttp to the standard
library (``http.server.ThreadingHTTPServer``) with the same routes, so an
engine of either package can use either server:

- ``PUT /blocks/{key}`` stores a block slab's bytes with its ``X-KV-Meta``
  header (shape and dtype); ``GET /blocks/{key}`` returns them, or 404;
- ``POST /lookup`` ``{"keys": [...]}`` answers ``{"present": [...]}``;
- ``GET /health``, ``GET /stats`` (JSON) and ``GET /metrics`` (the
  ``kvserver:*`` counters as Prometheus text).

Keys are the engines' chain hashes. The store is an LRU bounded by
``capacity_blocks``; a body over ``max_block_bytes`` gets 413; with
``ttl_seconds`` > 0 a sweeper thread expires blocks not read within the
TTL. One lock guards the store: handlers run on their own threads.

Run: ``python -m production_stack_tpu_torch.kv_server --port 8100``.
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_SWEEP_INTERVAL = 30.0  # seconds between TTL sweeps


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = 1024
    daemon_threads = True


class KVServer:
    def __init__(self, capacity_blocks: int = 65536,
                 max_block_bytes: int = 64 * 1024 * 1024,
                 ttl_seconds: float = 0.0):
        self.capacity = capacity_blocks
        self.max_block_bytes = max_block_bytes
        self.ttl_seconds = ttl_seconds  # 0 = no idle expiry
        # key -> (bytes, meta JSON, last access); guarded-by: _lock
        self.blocks: "collections.OrderedDict[str, tuple[bytes, str, float]]" = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.expired = 0
        self.rejected = 0
        self.used_bytes = 0
        self.start_time = time.time()
        self._lock = threading.Lock()
        self._httpd: Optional[_HTTPServer] = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # -- the store -----------------------------------------------------------
    def sweep_expired(self, now: Optional[float] = None) -> int:
        """Drop blocks idle past the TTL; returns how many. The LRU front
        holds the stalest entries, so the sweep stops at the first fresh
        one."""
        if self.ttl_seconds <= 0:
            return 0
        now = time.time() if now is None else now
        dropped = 0
        with self._lock:
            while self.blocks:
                key = next(iter(self.blocks))
                data, _, last = self.blocks[key]
                if now - last < self.ttl_seconds:
                    break
                del self.blocks[key]
                self.used_bytes -= len(data)
                self.expired += 1
                dropped += 1
        return dropped

    def put_block(self, key: str, data: bytes, meta: str) -> None:
        now = time.time()
        with self._lock:
            if key in self.blocks:
                old, _, _ = self.blocks[key]
                self.used_bytes -= len(old)
                self.blocks[key] = (data, meta, now)
                self.used_bytes += len(data)
                self.blocks.move_to_end(key)
                return
            while len(self.blocks) >= self.capacity:
                _, (old, _, _) = self.blocks.popitem(last=False)
                self.used_bytes -= len(old)
                self.evictions += 1
            self.blocks[key] = (data, meta, now)
            self.used_bytes += len(data)
            self.puts += 1

    def get_block(self, key: str) -> Optional[tuple[bytes, str]]:
        with self._lock:
            entry = self.blocks.get(key)
            if entry is None:
                self.misses += 1
                return None
            data, meta, _ = entry
            self.blocks[key] = (data, meta, time.time())
            self.blocks.move_to_end(key)
            self.hits += 1
            return data, meta

    def lookup(self, keys: list) -> list:
        with self._lock:
            return [k for k in keys if k in self.blocks]

    def stats_dict(self) -> dict:
        with self._lock:
            n = len(self.blocks)
            used = self.used_bytes
        return {
            "blocks": n,
            "capacity_blocks": self.capacity,
            "usage": n / max(self.capacity, 1),
            "bytes": used,
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "evictions": self.evictions,
            "expired": self.expired,
            "rejected": self.rejected,
            "ttl_seconds": self.ttl_seconds,
            "max_block_bytes": self.max_block_bytes,
            "uptime": time.time() - self.start_time,
        }

    def metrics_text(self) -> str:
        s = self.stats_dict()
        rows = [("blocks", "gauge", s["blocks"]),
                ("usage_perc", "gauge", s["usage"]),
                ("bytes", "gauge", s["bytes"]),
                ("hits_total", "counter", s["hits"]),
                ("misses_total", "counter", s["misses"]),
                ("puts_total", "counter", s["puts"]),
                ("evictions_total", "counter", s["evictions"]),
                ("expired_total", "counter", s["expired"]),
                ("rejected_total", "counter", s["rejected"])]
        lines = []
        for name, kind, value in rows:
            lines += [f"# TYPE kvserver:{name} {kind}",
                      f"kvserver:{name} {value}"]
        return "\n".join(lines) + "\n"

    # -- HTTP ----------------------------------------------------------------
    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, status: int, body: bytes, content_type: str,
                      headers: Optional[dict] = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, payload: dict, status: int = 200) -> None:
                self._send(status, json.dumps(payload).encode(),
                           "application/json")

            def _read_body(self) -> Optional[bytes]:
                """The body (Content-Length or chunked), or None past the
                bound (the connection then closes: its rest is unread)."""
                limit = server.max_block_bytes
                if "chunked" in (self.headers.get("Transfer-Encoding")
                                 or "").lower():
                    parts, total = [], 0
                    while True:
                        size = int(self.rfile.readline().split(b";")[0], 16)
                        if size == 0:
                            self.rfile.readline()
                            return b"".join(parts)
                        total += size
                        if total > limit:
                            self.close_connection = True
                            return None
                        parts.append(self.rfile.read(size))
                        self.rfile.readline()
                length = int(self.headers.get("Content-Length") or 0)
                if length > limit:
                    self.close_connection = True
                    return None
                return self.rfile.read(length)

            def _key(self) -> Optional[str]:
                path = urllib.parse.urlsplit(self.path).path
                if path.startswith("/blocks/") and len(path) > 8:
                    return urllib.parse.unquote(path[8:])
                return None

            def do_PUT(self):  # noqa: N802 (http.server API)
                key = self._key()
                if key is None:
                    self._json({"error": "not found"}, 404)
                    return
                data = self._read_body()
                if data is None:
                    server.rejected += 1
                    self._json({"error": "block exceeds max_block_bytes",
                                "limit": server.max_block_bytes}, 413)
                    return
                server.put_block(key, data,
                                 self.headers.get("X-KV-Meta", "{}"))
                self._json({"stored": True})

            def do_GET(self):  # noqa: N802 (http.server API)
                path = urllib.parse.urlsplit(self.path).path
                key = self._key()
                if key is not None:
                    got = server.get_block(key)
                    if got is None:
                        self._json({"error": "not found"}, 404)
                    else:
                        self._send(200, got[0], "application/octet-stream",
                                   {"X-KV-Meta": got[1]})
                elif path == "/health":
                    self._json({"status": "healthy"})
                elif path == "/stats":
                    self._json(server.stats_dict())
                elif path == "/metrics":
                    self._send(200, server.metrics_text().encode(),
                               "text/plain; charset=utf-8")
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802 (http.server API)
                if urllib.parse.urlsplit(self.path).path != "/lookup":
                    self._json({"error": "not found"}, 404)
                    return
                raw = self._read_body()
                try:
                    body = json.loads(raw or b"{}")
                    keys = list(body.get("keys") or [])
                except (ValueError, TypeError, AttributeError):
                    self._json({"error": "invalid JSON body"}, 400)
                    return
                self._json({"present": server.lookup(keys)})

        return Handler

    def _sweep_loop(self) -> None:
        interval = min(_SWEEP_INTERVAL, max(self.ttl_seconds / 2, 1.0))
        while not self._stop.wait(interval):
            self.sweep_expired()

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on background threads (and sweep, with a TTL); returns
        the bound port."""
        self._httpd = _HTTPServer((host, port), self._handler_class())
        self._stop.clear()
        self._threads = [threading.Thread(target=self._httpd.serve_forever,
                                          daemon=True, name="kv-server")]
        if self.ttl_seconds > 0:
            self._threads.append(threading.Thread(
                target=self._sweep_loop, daemon=True, name="kv-sweep"))
        for t in self._threads:
            t.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(10)
        self._threads = []


def main(argv=None) -> None:
    p = argparse.ArgumentParser("kv-server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--capacity-blocks", type=int, default=65536)
    p.add_argument("--max-block-bytes", type=int, default=64 * 1024 * 1024,
                   help="reject PUT bodies larger than this (413)")
    p.add_argument("--ttl-seconds", type=float, default=0.0,
                   help="expire blocks not read within this many seconds "
                        "(0 = never)")
    args = p.parse_args(argv)
    server = KVServer(args.capacity_blocks, args.max_block_bytes,
                      args.ttl_seconds)
    server.start(args.host, args.port)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
