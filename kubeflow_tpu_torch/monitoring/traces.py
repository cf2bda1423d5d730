"""Trace federation: pull per-process span buffers into cross-process
traces — the port's copy of ``kubeflow_tpu/monitoring/traces.py``.

Each role serves its own Tracer ring at ``/debug/traces`` (``runtime/obs.py``
``otlp_traces``)
— useful for one process, useless for a gang bind whose spans live in the
loadgen client, the apiserver, the scheduler, and a podlet.  The
``TraceCollector`` closes that gap the same way the metrics Scraper does:
it discovers every annotated Pod (the ``monitoring.kubeflow.org/scrape``
idiom, URL rewritten ``/metrics`` → ``/debug/traces``) plus a static target
list, pulls each process's OTLP-shaped buffer, and assembles spans by
``traceId`` — deduplicated by ``spanId``, stamped with the emitting
process's resource identity (``service.name`` / ``service.instance.id``).

The store is bounded with **tail sampling**: when the span budget is
exceeded, traces that are *interesting* — any span errored, or the trace is
in the slowest decile of gang binds — are protected and boring traces are
dropped oldest-first.  ``tracing_collector_traces_dropped_total`` counts
what tail sampling threw away, ``tracing_collector_spans`` gauges the live
store, ``tracing_collector_fetches_total`` tracks pull health.

``critical_path()`` decomposes an assembled gang-bind trace into the
segments operators actually page on — queue (submit → first reconcile),
cycle (reconcile → bind start), bind (the bind write loop) — and checks
they reconstruct the ``scheduler_bind_latency_seconds`` observation the
scheduler recorded on the root span.  ``pod.start`` time is reported
separately: it happens after the bind SLI stops ticking.
"""

from __future__ import annotations

import logging
import threading
import urllib.request
from typing import Any, Dict, List, Optional, Sequence
from urllib.parse import urlsplit, urlunsplit

from ..runtime.metrics import METRICS, MetricsRegistry
from ..scheduler.gang import annotations_of, name_of
from ..web.http import App, HttpError, Request
from .scrape import (
    SCRAPE_ANNOTATION,
    SCRAPE_JOB_ANNOTATION,
    SCRAPE_URL_ANNOTATION,
    Target,
)

log = logging.getLogger("kubeflow_tpu_torch.monitoring")

#: default span budget for the federated store (tail sampling enforces it)
MAX_FEDERATED_SPANS = 20_000


def traces_url(url: str) -> str:
    """The trace endpoint co-served with a scrape URL: same host/port, path
    ``/debug/traces`` (every app that mounts observability serves both)."""
    parts = urlsplit(url)
    return urlunsplit((parts.scheme, parts.netloc, "/debug/traces",
                       "limit=4096", ""))


def _resource_attrs(resource: dict) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for kv in resource.get("attributes", []):
        value = kv.get("value", {})
        out[kv.get("key", "")] = str(value.get("stringValue", ""))
    return out


class TraceCollector:
    """Scraper-shaped federation for spans: static targets + annotated-Pod
    discovery, one bounded tail-sampled store, assembly by trace id."""

    def __init__(
        self,
        targets: Sequence[Target] = (),
        client=None,
        timeout_s: float = 5.0,
        max_spans: int = MAX_FEDERATED_SPANS,
        registry: MetricsRegistry = METRICS,
    ) -> None:
        self._static = list(targets)
        self._client = client
        self._timeout_s = timeout_s
        self.max_spans = int(max_spans)
        self._registry = registry
        # trace_id -> span_id -> span dict (augmented with resource identity)
        self._traces: Dict[str, Dict[str, dict]] = {}
        # trace_id -> monotonic counter of last update (oldest-first drops)
        self._seen_at: Dict[str, int] = {}
        # trace_id -> detector verdicts attached out-of-band (hang forensics)
        self._verdicts: Dict[str, List[dict]] = {}
        self._clock = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- discovery / fetch ---------------------------------------------------
    def add_target(self, target: Target) -> None:
        with self._lock:
            self._static.append(target)

    def discover(self) -> List[Target]:
        """Same target universe as the metrics Scraper — every process worth
        scraping is worth tracing — with the URL pointed at its trace
        buffer instead of its exposition."""
        with self._lock:
            targets: Dict[str, Target] = {t.instance: t for t in self._static}
        if self._client is not None:
            try:
                pods = self._client.list("v1", "Pod")
            except Exception:
                log.exception("trace discovery: Pod list failed")
                pods = []
            for pod in pods:
                ann = annotations_of(pod)
                if ann.get(SCRAPE_ANNOTATION) != "true":
                    continue
                url = ann.get(SCRAPE_URL_ANNOTATION)
                if not url:
                    continue
                t = Target(job=ann.get(SCRAPE_JOB_ANNOTATION) or name_of(pod),
                           url=traces_url(url))
                targets.setdefault(t.instance, t)
        return list(targets.values())

    def fetch(self, target: Target) -> dict:
        import json

        with urllib.request.urlopen(target.url, timeout=self._timeout_s) as resp:
            if resp.status != 200:
                raise IOError(f"{target.url}: HTTP {resp.status}")
            return json.loads(resp.read().decode("utf-8"))

    def collect_once(self) -> Dict[str, bool]:
        """One federation pass over the discovered targets; instance → ok."""
        results: Dict[str, bool] = {}
        for target in self.discover():
            try:
                doc = self.fetch(target)
                self.ingest(doc, job=target.job)
            except Exception as e:
                log.warning("trace fetch %s failed: %s", target.instance, e)
                self._registry.counter("tracing_collector_fetches_total",
                                       result="error").inc()
                results[target.instance] = False
                continue
            self._registry.counter("tracing_collector_fetches_total",
                                   result="ok").inc()
            results[target.instance] = True
        self._enforce_bound()
        return results

    def ingest(self, doc: dict, job: str = "") -> int:
        """Merge one OTLP resourceSpans document into the store; spans are
        deduplicated by spanId (repeated pulls of an unchanged ring are
        idempotent) and stamped with the emitting process's resource
        identity so the assembled view says where each hop ran."""
        added = 0
        with self._lock:
            for rs in doc.get("resourceSpans", []):
                res = _resource_attrs(rs.get("resource", {}))
                service = res.get("service.name", job or "unknown")
                instance = res.get("service.instance.id", "")
                for scope in rs.get("scopeSpans", []):
                    for span in scope.get("spans", []):
                        tid, sid = span.get("traceId"), span.get("spanId")
                        if not tid or not sid:
                            continue
                        merged = dict(span)
                        # span-level service.name (set per-span by the
                        # Tracer) outranks the process resource: a fleet
                        # replica's engine spans keep the engine identity
                        merged.setdefault("attributes", {})
                        merged["service"] = merged["attributes"].get(
                            "service.name", service)
                        merged["instance"] = instance
                        if sid not in self._traces.setdefault(tid, {}):
                            added += 1
                        self._traces[tid][sid] = merged
                        self._clock += 1
                        self._seen_at[tid] = self._clock
            self._registry.gauge("tracing_collector_spans").set(
                float(sum(len(v) for v in self._traces.values())))
        return added

    # -- tail sampling -------------------------------------------------------
    def _interesting(self) -> set:
        """Trace ids tail sampling must keep: every trace with an errored
        span, plus the slowest decile of gang binds (callers hold _lock)."""
        keep = set()
        bind_latency: Dict[str, float] = {}
        for tid, spans in self._traces.items():
            for s in spans.values():
                if (s.get("status") or {}).get("code") == "ERROR":
                    keep.add(tid)
                if s.get("name") == "gang.lifecycle":
                    lat = s.get("attributes", {}).get("gang.bind_latency_s")
                    if isinstance(lat, (int, float)):
                        bind_latency[tid] = float(lat)
        if bind_latency:
            ranked = sorted(bind_latency, key=bind_latency.get)
            decile = max(1, len(ranked) // 10)
            keep.update(ranked[-decile:])
        return keep

    def _enforce_bound(self) -> int:
        """Drop whole traces, boring and oldest first, until the span budget
        holds.  Protected traces go last — but they DO go if the budget
        demands it: a bounded store is the invariant, sampling the policy."""
        dropped = 0
        with self._lock:
            total = sum(len(v) for v in self._traces.values())
            if total <= self.max_spans:
                return 0
            keep = self._interesting()
            by_age = sorted(self._traces, key=lambda t: self._seen_at.get(t, 0))
            for protected in (False, True):
                for tid in by_age:
                    if total <= self.max_spans:
                        break
                    if tid not in self._traces or (tid in keep) != protected:
                        continue
                    total -= len(self._traces.pop(tid))
                    self._seen_at.pop(tid, None)
                    self._verdicts.pop(tid, None)
                    dropped += 1
                    self._registry.counter(
                        "tracing_collector_traces_dropped_total",
                        protected=str(protected).lower()).inc()
            self._registry.gauge("tracing_collector_spans").set(float(total))
        return dropped

    # -- out-of-band verdicts ------------------------------------------------
    def attach_verdict(self, trace_id: str, verdict: dict) -> None:
        """Attach a detector verdict (a hang/straggler forensic record) to a
        federated trace. Verdicts are not spans — they arrive from the
        monitoring plane, not a scraped ring — but they ride the assembled
        ``trace()`` view so the gang's trace tells the whole story. Verdicts
        for traces the tail sampler has dropped (or never saw) are held
        until the trace shows up or the store drops it."""
        with self._lock:
            self._verdicts.setdefault(trace_id, []).append(dict(verdict))

    # -- assembled views -----------------------------------------------------
    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def trace(self, trace_id: str) -> Optional[dict]:
        """One assembled cross-process trace: spans time-ordered, with the
        set of services that contributed (≥3 for a full gang-bind journey:
        client, apiserver, scheduler)."""
        with self._lock:
            spans = list(self._traces.get(trace_id, {}).values())
            verdicts = [dict(v) for v in self._verdicts.get(trace_id, ())]
        if not spans:
            return None
        spans.sort(key=lambda s: s.get("startTimeUnixNano", 0))
        ends = [s.get("endTimeUnixNano", 0) for s in spans]
        out = {
            "traceId": trace_id,
            "spans": spans,
            "services": sorted({s.get("service", "unknown") for s in spans}),
            "spanCount": len(spans),
            "durationMs": round(
                (max(ends) - spans[0].get("startTimeUnixNano", 0)) / 1e6, 3),
        }
        if verdicts:
            out["verdicts"] = verdicts
        return out

    def slowest_binds(self, n: int = 10) -> List[dict]:
        """Gang-bind traces ranked by the scheduler's recorded bind latency
        — the index an operator opens before asking for any trace by id."""
        rows: List[dict] = []
        with self._lock:
            for tid, spans in self._traces.items():
                for s in spans.values():
                    if s.get("name") != "gang.lifecycle":
                        continue
                    attrs = s.get("attributes", {})
                    lat = attrs.get("gang.bind_latency_s")
                    if not isinstance(lat, (int, float)):
                        continue
                    rows.append({
                        "traceId": tid,
                        "gang": attrs.get("gang", ""),
                        "bindLatencySeconds": float(lat),
                        "bound": bool(attrs.get("gang.bound", False)),
                    })
        rows.sort(key=lambda r: r["bindLatencySeconds"], reverse=True)
        return rows[:max(0, n)]

    # -- serving / loop ------------------------------------------------------
    def mount(self, app: App) -> App:
        """``GET /debug/trace/<trace_id>`` (assembled, with critical path
        when it is a gang bind) + the slowest-binds index.  Safe alongside
        obs's ``/debug/<source>`` catch-all: that pattern is single-segment,
        so the two-segment route here never collides."""
        from ..runtime.obs import register_debug_source

        register_debug_source(
            "slowest-binds",
            lambda req: {"binds": self.slowest_binds(
                int(req.query1("n", "10") or 10))})
        if any(pattern == "/debug/trace/<trace_id>"
               for _m, pattern, _fn in app.iter_routes()):
            return app

        @app.route("/debug/trace/<trace_id>")
        def debug_trace(req: Request) -> dict:
            assembled = self.trace(req.params["trace_id"])
            if assembled is None:
                raise HttpError(404, f"unknown trace {req.params['trace_id']!r}")
            path = critical_path(assembled)
            if path is not None:
                assembled["criticalPath"] = path
            return assembled

        return app

    def start(self, interval_s: float = 5.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.collect_once()
                except Exception:
                    log.exception("trace federation pass failed")
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, name="trace-collector",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# -- critical-path attribution ------------------------------------------------

def critical_path(assembled: dict) -> Optional[dict]:
    """Decompose an assembled gang-bind trace into the segments that sum to
    ``scheduler_bind_latency_seconds``:

    - ``queue``  — client submit (the root's ``gang.submitted_unix`` anchor,
      the same creationTimestamp epoch the SLI measures from) to the first
      reconcile of the gang (the ``gang.lifecycle`` root opening),
    - ``cycle``  — reconcile start to the successful bind loop opening
      (scheduling cycles, quota checks, preemption attempts),
    - ``bind``   — the ``schedule.bind`` write loop itself.

    The sum is checked against ``gang.bind_latency_s`` (the observation the
    scheduler actually recorded) — ``reconstructionError`` is the gap, and
    honest: if the segments don't explain the SLI, the trace says so.
    ``pod.start`` runs after the bind SLI stops ticking, so it is reported
    as ``postBindPodStart``, not a segment."""
    spans = assembled.get("spans", [])
    roots = [s for s in spans if s.get("name") == "gang.lifecycle"]
    if not roots:
        return None
    root = min(roots, key=lambda s: s.get("startTimeUnixNano", 0))
    attrs = root.get("attributes", {})
    submitted = attrs.get("gang.submitted_unix")
    measured = attrs.get("gang.bind_latency_s")
    if not isinstance(submitted, (int, float)):
        return None
    root_start_s = root.get("startTimeUnixNano", 0) / 1e9
    binds = [s for s in spans if s.get("name") == "schedule.bind"
             and s.get("traceId") == root.get("traceId")]
    segments: List[dict] = []
    segments.append({"name": "queue",
                     "seconds": max(0.0, root_start_s - float(submitted))})
    if binds:
        bind = max(binds, key=lambda s: s.get("endTimeUnixNano", 0))
        bind_start_s = bind.get("startTimeUnixNano", 0) / 1e9
        bind_end_s = bind.get("endTimeUnixNano", 0) / 1e9
        segments.append({"name": "cycle",
                         "seconds": max(0.0, bind_start_s - root_start_s)})
        segments.append({"name": "bind",
                         "seconds": max(0.0, bind_end_s - bind_start_s)})
    total = sum(seg["seconds"] for seg in segments)
    out: Dict[str, Any] = {
        "gang": attrs.get("gang", ""),
        "segments": [{"name": s["name"], "seconds": round(s["seconds"], 6)}
                     for s in segments],
        "totalSeconds": round(total, 6),
    }
    if isinstance(measured, (int, float)):
        out["measuredBindLatencySeconds"] = float(measured)
        out["reconstructionError"] = round(abs(total - float(measured)), 6)
    starts = [s for s in spans if s.get("name") == "pod.start"]
    if starts:
        out["postBindPodStart"] = {
            "pods": len(starts),
            "seconds": round(max(
                (s.get("endTimeUnixNano", 0) - s.get("startTimeUnixNano", 0))
                for s in starts) / 1e9, 6),
        }
    return out
