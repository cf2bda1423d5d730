"""Mountable observability surface: ``/metrics`` + ``/debug/*`` routes.

The port's copy of ``kubeflow_tpu/runtime/obs.py``. ``mount_observability(app)``
adds, idempotently, to any ``web.http.App``:

- ``GET /metrics``        — OpenMetrics text exposition (trace-id exemplars
  on histogram buckets, the stdlib process collector), ending in ``# EOF``;
- ``GET /debug/traces``   — recent spans as OTLP-shaped JSON, filterable by
  ``?trace_id=`` / ``?name=`` / ``?service=`` / ``?limit=`` (most recent
  last);
- ``GET /debug/vars``     — expvar-style process snapshot (pid, uptime,
  RSS, threads, GC, trace-buffer depth, metric families);
- ``GET /debug/<source>`` — every source registered with
  :func:`register_debug_source`, ``stacks`` (all-thread stack dumps) among
  them.

The ``ModelServer`` mounts it, so the serving SLO histograms
(``serving_ttft_seconds`` and friends) and the per-request
``serving.request`` spans are scrapeable on the serving port.
"""

from __future__ import annotations

import collections
import gc
import os
import re
import sys
import threading
import time
import traceback
from typing import Any, Callable, Deque, Dict, List, Optional

from ..web.http import App, HttpError, JsonResponse, Request
from .metrics import METRICS, MetricsRegistry, _PROCESS_START, _rss_bytes, install_process_collector
from .tracing import TRACER, Tracer

#: exposition content type: OpenMetrics, since render() emits exemplar
#: suffixes and the ``# EOF`` terminator
EXPOSITION_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: hard ceiling on one /debug/traces response (the ring holds 4096 spans)
MAX_TRACE_SPANS = 4096

#: named debug sources served at ``/debug/<name>``: process-global, so a
#: subsystem can register before or after an app mounts observability; the
#: last registration of a name wins
_DEBUG_SOURCES: Dict[str, Callable[[Request], Any]] = {}


def register_debug_source(name: str, handler: Callable[[Request], Any]) -> None:
    """Expose ``handler(req) -> JSON-able`` at ``GET /debug/<name>`` on every
    app that mounts observability."""
    _DEBUG_SOURCES[name] = handler


def unregister_debug_source(name: str, handler: Callable[[Request], Any]) -> None:
    """Remove ``name``'s registration if it is still ``handler`` (a later
    registration of the name stays)."""
    if _DEBUG_SOURCES.get(name) is handler:
        _DEBUG_SOURCES.pop(name, None)


# -- /debug/stacks: all-thread stack dumps -------------------------------------

#: bounded history of captured dumps, newest last
MAX_STACK_DUMPS = 32
_STACK_HISTORY: Deque[Dict[str, Any]] = collections.deque(maxlen=MAX_STACK_DUMPS)
_STACK_LOCK = threading.Lock()


def _thread_label(name: str) -> str:
    """Collapse digit runs (``worker-3`` → ``worker-N``): bounded cardinality."""
    return re.sub(r"\d+", "N", name or "unnamed")


def capture_stacks(reason: str = "manual") -> Dict[str, Any]:
    """Snapshot every live thread's Python stack (``sys._current_frames``)
    into the bounded dump ring, and return the dump."""
    names = {t.ident: t.name for t in threading.enumerate()}
    threads: List[Dict[str, Any]] = []
    for ident, frame in sys._current_frames().items():
        stack = traceback.extract_stack(frame)
        threads.append({
            "thread": _thread_label(names.get(ident, "")),
            "threadName": names.get(ident, "unnamed"),
            "frames": [{"file": os.path.basename(f.filename), "line": f.lineno,
                        "function": f.name} for f in stack],
            # innermost frame last in `frames`; surfaced for quick triage
            "current": stack[-1].name if stack else None,
        })
    dump = {"reason": reason, "capturedAt": time.time(), "pid": os.getpid(),
            "threadCount": len(threads), "threads": threads}
    with _STACK_LOCK:
        _STACK_HISTORY.append(dump)
    return dump


def _stacks_source(req: Request) -> Dict[str, Any]:
    """``GET /debug/stacks``: a fresh capture plus the bounded history
    (``?history=0`` suppresses it; ``?capture=0`` serves history only)."""
    live = capture_stacks(reason="debug-endpoint") if req.query1("capture", "1") != "0" \
        else None
    with _STACK_LOCK:
        history = list(_STACK_HISTORY) if req.query1("history", "1") != "0" else []
    return {"live": live, "history": history, "maxDumps": MAX_STACK_DUMPS}


register_debug_source("stacks", _stacks_source)


def otlp_traces(tracer: Tracer, trace_id: Optional[str] = None,
                name: Optional[str] = None, limit: int = 256,
                service: Optional[str] = None) -> dict:
    """The ring buffer's tail as one OTLP-shaped resourceSpans document.
    ``service`` filters by each span's ``service.name`` attribute."""
    spans = tracer.finished_spans(name=name, trace_id=trace_id)
    if service is not None:
        spans = [s for s in spans if s.attributes.get("service.name") == service]
    spans = spans[-max(0, min(limit, MAX_TRACE_SPANS)):]
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name", "value": {"stringValue": tracer.service}},
            {"key": "service.instance.id", "value": {"stringValue": tracer.instance}},
        ]},
        "scopeSpans": [{"scope": {"name": "kubeflow_tpu_torch.runtime.tracing"},
                        "spans": [s.to_dict() for s in spans]}],
    }]}


def mount_observability(app: App, registry: Optional[MetricsRegistry] = None,
                        tracer: Optional[Tracer] = None) -> App:
    """Add the observability routes to ``app`` (no-op if already mounted)."""
    reg = registry if registry is not None else METRICS
    trc = tracer if tracer is not None else TRACER
    if any(pattern == "/metrics" for _m, pattern, _fn in app.iter_routes()):
        return app
    install_process_collector(reg)

    @app.route("/metrics")
    def metrics(req: Request) -> JsonResponse:
        return JsonResponse(reg.render(), headers={"Content-Type": EXPOSITION_CONTENT_TYPE})

    @app.route("/debug/traces")
    def debug_traces(req: Request) -> dict:
        try:
            limit = int(req.query1("limit", "256"))
        except ValueError:
            raise HttpError(400, "limit must be an integer") from None
        return otlp_traces(trc, trace_id=req.query1("trace_id") or None,
                           name=req.query1("name") or None, limit=limit,
                           service=req.query1("service") or None)

    @app.route("/debug/vars")
    def debug_vars(req: Request) -> dict:
        with reg._lock:
            families = len(reg._metrics)
        return {
            "pid": os.getpid(),
            "argv": sys.argv,
            "python_version": sys.version.split()[0],
            "uptime_seconds": round(time.time() - _PROCESS_START, 3),
            "resident_memory_bytes": _rss_bytes(),
            "threads": threading.active_count(),
            "gc": {str(i): s for i, s in enumerate(gc.get_stats())},
            "trace_buffer_spans": len(trc.finished_spans()),
            "metric_families": families,
            "app": app.name,
            "debug_sources": sorted(_DEBUG_SOURCES),
        }

    # registered LAST: dispatch matches in registration order, so the
    # specific /debug/traces and /debug/vars routes win over this catch-all
    @app.route("/debug/<source>")
    def debug_source(req: Request):
        handler = _DEBUG_SOURCES.get(req.params["source"])
        if handler is None:
            raise HttpError(404, f"unknown debug source {req.params['source']!r}; "
                                 f"registered: {sorted(_DEBUG_SOURCES)}")
        return handler(req)

    return app
