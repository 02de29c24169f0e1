"""Exporters for serving telemetry: a /metrics HTTP endpoint, a JSONL sink
and Chrome traces; a stdlib copy of the reference's ``serving/exporters.py``.

The exporters only read a ``MetricsRegistry``: they never touch the device
and never block the serving loop (the HTTP server runs on a daemon thread
and renders from the registry at request time).

- ``MetricsHTTPServer``: Prometheus text exposition 0.0.4 at ``/metrics``
  (and a JSON snapshot at ``/metrics.json``).
- ``JsonlSink``: appends one JSON object per line; registry snapshots and
  the end-of-run summary of ``launch/serve.py``.
- ``write_chrome_trace``: ``TraceRecorder.save``; the file opens in
  Perfetto (https://ui.perfetto.dev) or chrome://tracing.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import IO, Any, Optional, Union

from repro_torch.serving.telemetry import MetricsRegistry, TraceRecorder

__all__ = [
    "MetricsHTTPServer",
    "JsonlSink",
    "write_chrome_trace",
]


def write_chrome_trace(trace: TraceRecorder, path: str) -> None:
    """Write recorded spans as Chrome trace-event JSON (Perfetto-viewable)."""
    trace.save(path)


class _MetricsHandler(BaseHTTPRequestHandler):
    # the registry is attached to the *server* instance (one per
    # MetricsHTTPServer); handlers are constructed per-request
    server: "_Server"

    def do_GET(self) -> None:  # noqa: N802 - http.server API name
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = self.server.registry.render_prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = json.dumps(self.server.registry.snapshot()).encode("utf-8")
            ctype = "application/json"
        else:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args: Any) -> None:
        # default handler logs every scrape to stderr — silence it; the
        # serving loop owns stdout/stderr
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    registry: MetricsRegistry


class MetricsHTTPServer:
    """Prometheus text-exposition endpoint over a daemon thread.

    ``port=0`` binds an ephemeral port (use ``.port`` to discover it —
    tests rely on this). ``close()`` shuts the listener down; it is also
    safe to leave running, the thread is a daemon.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = _Server((host, port), _MetricsHandler)
        self._httpd.registry = registry
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class JsonlSink:
    """Append-mode JSONL writer for registry snapshots and summaries.

    Accepts a path (opened lazily, append mode) or an already-open text
    stream. Each ``write`` emits exactly one line; ``write_registry``
    wraps a registry snapshot with a record kind so mixed streams stay
    greppable.
    """

    def __init__(self, path_or_stream: Union[str, IO[str]]):
        if isinstance(path_or_stream, str):
            self._path: Optional[str] = path_or_stream
            self._stream: Optional[IO[str]] = None
        else:
            self._path = None
            self._stream = path_or_stream

    def _out(self) -> IO[str]:
        if self._stream is None:
            assert self._path is not None
            self._stream = open(self._path, "a", encoding="utf-8")
        return self._stream

    def write(self, record: dict) -> None:
        out = self._out()
        out.write(json.dumps(record, sort_keys=True) + "\n")
        out.flush()

    def write_registry(self, registry: MetricsRegistry, **extra: Any) -> None:
        rec = {"kind": "metrics_snapshot", **extra, "metrics": registry.snapshot()}
        self.write(rec)

    def close(self) -> None:
        if self._stream is not None and self._path is not None:
            self._stream.close()
            self._stream = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
