"""Stdlib-HTTP ``/metrics`` endpoint for scrape-based deployments.

``MetricsServer`` wraps a ``MetricsRegistry`` (or any zero-arg callable
returning Prometheus text) in a ``ThreadingHTTPServer`` on a daemon
thread: ``GET /metrics`` renders the registry at scrape time, so a
long-running training loop is observable without touching the round path
-- the handler only ever *reads* registry state that the host-side
telemetry hooks already wrote.

The JAX package's ``launch/metrics_endpoint.py`` for the port.  No
third-party dependency: the exposition format is produced by
``repro_torch.obs.metrics.MetricsRegistry.to_prometheus`` and served with
the conventional ``text/plain; version=0.0.4`` content type.

CLI mode serves a previously flushed ``metrics.prom`` artifact from a
``--trace-dir`` (post-hoc scraping of a finished run)::

    python -m repro_torch.launch.metrics_endpoint --trace-dir TRACE_DIR --port 9100
"""
from __future__ import annotations

import argparse
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _make_handler(render: Callable[[], str]):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404, "only /metrics is served")
                return
            try:
                body = render().encode()
            except Exception as exc:      # surface render bugs to the scraper
                self.send_error(500, f"metrics render failed: {exc}")
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):     # keep scrapes out of stdout
            pass

    return Handler


class MetricsServer:
    """Daemon-thread ``/metrics`` server around a registry or callable.

    ``port=0`` binds an ephemeral port (tests); read it back from
    ``server.port`` / ``server.url`` after ``start()``.
    """

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0):
        self._render = (registry if callable(registry)
                        else registry.to_prometheus)
        self.host, self.port = host, port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _make_handler(self._render))
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-endpoint", daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", required=True,
                    help="directory holding a flushed metrics.prom")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9100)
    args = ap.parse_args(argv)
    prom = os.path.join(args.trace_dir, "metrics.prom")

    def render() -> str:
        with open(prom) as f:
            return f.read()

    server = MetricsServer(render, host=args.host, port=args.port).start()
    print(f"serving {prom} at {server.url}")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
