"""Stdlib-HTTP exposition of the obs layer (no third-party server).

``start_obs_server(port, registry=..., health_fn=..., tracer=...)``
spins up a daemon-threaded ``ThreadingHTTPServer`` serving

* ``/metrics`` — Prometheus text exposition of the registry;
* ``/health``  — JSON snapshot of ``engine.health()`` (O(1), never
  dispatches — safe for load-balancer probes every second);
* ``/trace``   — the current span ring as Chrome-trace JSON (load in
  Perfetto), when a tracer is attached.

Reads race benignly with the engine thread: every exposed value is a
plain Python float guarded by the GIL, so a scrape sees a consistent-
enough point-in-time view without ever blocking the serving loop.
Port 0 binds an ephemeral port (tests); ``server.server_address[1]``
reports the bound port either way.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer

__all__ = ["start_obs_server"]


def _make_handler(registry: Optional[MetricsRegistry],
                  health_fn: Optional[Callable[[], dict]],
                  tracer: Optional[SpanTracer]):
    class ObsHandler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:            # noqa: N802 (stdlib API name)
            path = self.path.split("?", 1)[0]
            if path == "/metrics" and registry is not None:
                self._send(200, registry.to_prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/health" and health_fn is not None:
                snap = {k: (v if v == v and abs(v) != float("inf")
                            else None)              # NaN/inf -> JSON null
                        for k, v in health_fn().items()}
                self._send(200, json.dumps(snap).encode(),
                           "application/json")
            elif path == "/trace" and tracer is not None:
                self._send(200,
                           json.dumps(tracer.to_chrome_trace()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")

        def log_message(self, *a) -> None:   # keep the serving stdout clean
            pass

    return ObsHandler


def start_obs_server(port: int, *,
                     registry: Optional[MetricsRegistry] = None,
                     health_fn: Optional[Callable[[], dict]] = None,
                     tracer: Optional[SpanTracer] = None,
                     host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind and start the obs endpoint in a daemon thread; returns the
    server (``.server_address[1]`` is the bound port, ``.shutdown()``
    stops it)."""
    server = ThreadingHTTPServer(
        (host, port), _make_handler(registry, health_fn, tracer))
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever,
                         name="repro-obs-http", daemon=True)
    t.start()
    return server
