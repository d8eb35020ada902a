"""Live metrics endpoint: a Prometheus-text HTTP exporter and the live
telemetry plane; port of ``srnn_tpu/telemetry/exporter.py``.

A stdlib ``ThreadingHTTPServer`` on a ``utils.pipeline.spawn_thread``
serves the same per-run ``MetricsRegistry`` that the chunk finisher
flushes to ``metrics.prom``, so a scrape and the file agree by
construction.  Endpoints (GET only):

  * ``/metrics`` -- the registry's text exposition (format 0.0.4),
    rendered per request; each scrape counts into ``soup_scrapes_total``
    after its body renders, so a response never includes its own scrape.
  * ``/healthz`` -- one JSON liveness object from the caller's
    ``healthz()`` provider (with ``uptime_s`` / ``port`` / ``scrapes``);
    ``ok: false`` answers 503.

The accept loop runs on one registered thread; the per-request handler
threads are the stdlib server's daemons, so a stalled scraper cannot hang
``close()``.  The whole plane is host-side: ``--no-export`` never builds
it, and a run's results are bitwise the same either way.  The worker
liveness of a multi-process run waits for multi-GPU runs (ROADMAP.md,
A.6).
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

#: registry names a /healthz body surfaces as its ``metrics`` field
HEALTHZ_METRICS = (
    "heartbeat_generation",
    "gens_per_sec",
    "serve_queue_depth",
    "soup_health_nan_frac",
    "soup_alerts_active",
)

#: exposition content type (Prometheus text format 0.0.4, as metrics.prom)
_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def healthz_metrics(registry) -> Dict[str, float]:
    """The :data:`HEALTHZ_METRICS` slice of one registry's flat rows."""
    rows = registry.rows()
    out: Dict[str, float] = {}
    for name in HEALTHZ_METRICS:
        prefix = f"srnn_{name}"
        for key, value in rows.items():
            if key == prefix or key.startswith(prefix + "{"):
                out[key] = value
    return out


class _Handler(BaseHTTPRequestHandler):
    # failures surface as HTTP statuses, not stderr lines
    def log_message(self, fmt, *args):  # noqa: ARG002
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        exporter: "MetricsExporter" = self.server.exporter  # type: ignore
        path = self.path.split("?", 1)[0]
        # count after rendering, before sending: the next scrape must see
        # this one
        if path == "/metrics":
            body = exporter.registry.to_prometheus().encode("utf-8")
            exporter.count_scrape("metrics")
            self._send(200, body, _CONTENT_TYPE)
        elif path == "/healthz":
            doc = exporter.healthz_doc()
            body = (json.dumps(doc, default=str) + "\n").encode("utf-8")
            exporter.count_scrape("healthz")
            self._send(200 if doc.get("ok", True) else 503, body,
                       "application/json")
        else:
            self._send(404, b"not found\n", "text/plain; charset=utf-8")


class _Server(ThreadingHTTPServer):
    #: handler threads serve one short response each and own no buffered
    #: I/O; as daemons a stalled connection cannot hang close()
    daemon_threads = True
    allow_reuse_address = True


class MetricsExporter:
    """One process's live ``/metrics`` and ``/healthz`` endpoint.

    >>> ex = MetricsExporter(registry, port=9100,
    ...                      healthz=lambda: {"ok": True, "stage": "run"})
    >>> ex.port        # the bound port (an ephemeral one for port=0)
    >>> ex.close()     # shutdown and join, idempotent

    ``healthz`` is a zero-argument callable returning the liveness dict; it
    runs on handler threads and reads only thread-safe state."""

    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1",
                 healthz: Optional[Callable[[], dict]] = None):
        from ..utils.pipeline import spawn_thread

        self.registry = registry
        self._healthz = healthz
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._scrapes = 0
        self._closed = False
        self._server = _Server((host, int(port)), _Handler)
        self._server.exporter = self  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = spawn_thread(self._server.serve_forever,
                                    name=f"srnn-metrics-exporter-{self.port}")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def count_scrape(self, endpoint: str) -> None:
        with self._lock:
            self._scrapes += 1
        self.registry.counter(
            "soup_scrapes_total",
            help="HTTP scrapes served by the live exporter").inc(
                1, endpoint=endpoint)

    @property
    def scrapes(self) -> int:
        with self._lock:
            return self._scrapes

    def healthz_doc(self) -> dict:
        doc = {"ok": True}
        if self._healthz is not None:
            try:
                doc.update(self._healthz() or {})
            except Exception as e:  # a broken provider is itself unhealth
                doc = {"ok": False,
                       "error": f"healthz provider: {type(e).__name__}: {e}"}
        doc.setdefault("uptime_s", round(time.monotonic() - self._t0, 1))
        doc.setdefault("port", self.port)
        doc.setdefault("scrapes", self.scrapes)
        return doc

    def close(self) -> None:
        """Stop serving and join the accept thread; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._thread.join()
        self._server.server_close()

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LivePlane:
    """One process's live telemetry plane: the history ring
    (``timeseries.MetricHistory``), the alert engine
    (``alerts.AlertEngine``) and the optional HTTP exporter.  ``sample()``
    is the once-a-chunk turn -- ring and jsonl row, then rule evaluation,
    every transition emitted as a ``{"kind": "alert"}`` events row -- as
    one ordered job on the run's ``BackgroundWriter``, so an alert never
    cites registry state newer than its chunk.  An optional
    ``profiler.AnomalyCapture`` rides the same job: firing edges publish
    their bundle from the writer thread."""

    def __init__(self, history=None, engine=None, exporter=None,
                 capture=None):
        self.history = history
        self.engine = engine
        self.exporter = exporter
        self.capture = capture

    def sample(self, exp, writer=None, **context) -> None:
        from ..utils.pipeline import submit_or_run

        def job():
            if self.history is not None:
                self.history.sample()
            transitions = []
            if self.engine is not None:
                for transition in self.engine.evaluate():
                    exp.event(kind="alert", **context, **transition)
                    transitions.append(transition)
            if self.capture is not None:
                self.capture.on_transitions(transitions, **context)

        submit_or_run(writer, job)

    def close(self) -> None:
        """Exporter first (no scrape may outlive the run), then the history
        file.  Call after the run's writer drained: queued sample jobs
        hold the history."""
        if self.exporter is not None:
            self.exporter.close()
        if self.history is not None:
            self.history.close()
        if self.capture is not None:
            self.capture.close()
