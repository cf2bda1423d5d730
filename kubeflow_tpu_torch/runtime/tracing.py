"""Tracing: spans over serving requests and HTTP handlers.

A trimmed copy of ``kubeflow_tpu/runtime/tracing.py``: the OpenTelemetry
vocabulary (traceId/spanId/parentSpanId, nanosecond epochs, status,
attributes), an in-memory ring buffer, a thread-local current span, the
manual ``start_span``/``end_span`` lifecycle a serving request needs (it
starts on the HTTP thread and ends on the engine worker) with JAX's
open-span map (a span never ended is swept after ``open_span_ttl_s``, or
evicted past ``max_open_spans``, recorded as ERROR and counted by
``tracing_spans_abandoned_total``), ``emit_span``
for an interval already elapsed (a training step), the W3C
``traceparent`` codec, ``Span.to_dict`` in the OTLP field names that
``/debug/traces`` serves (``runtime/obs.py``), ``detached`` for work that
must not inherit the thread's trace (an informer's relist), and the two
annotations that carry a trace across the control plane's object hops.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Iterator, List, Optional

_local = threading.local()

#: annotation carrying the creating request's W3C ``traceparent``: stamped
#: by the apiserver on create, so watch-driven reconciles (and the gang
#: lifecycle trace) parent to the client call that caused the object
TRACEPARENT_ANNOTATION = "tracing.kubeflow.org/traceparent"

#: annotation the scheduler stamps on the bind write (the update that sets
#: ``spec.nodeName``): the gang trace's bind span, so spans started off the
#: bound pod join the same trace
BIND_TRACEPARENT_ANNOTATION = "tracing.kubeflow.org/bind-traceparent"

#: default TTL for ``start_span()`` spans never ended (a crashed worker):
#: past it the sweep force-closes them as ERROR and counts
#: ``tracing_spans_abandoned_total``
OPEN_SPAN_TTL_S = 600.0


def _rand_hex(nbytes: int) -> str:
    # os.urandom, not the random module: seeded tests must not mint
    # colliding ids
    return os.urandom(nbytes).hex()


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "OK"  # OK | ERROR
    status_message: str = ""

    def set(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs: Any) -> "Span":
        self.events.append({"name": name, "timeUnixNano": time.time_ns(),
                            "attributes": attrs})
        return self

    def record_error(self, exc: BaseException) -> "Span":
        self.status = "ERROR"
        self.status_message = f"{type(exc).__name__}: {exc}"
        return self

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "startTimeUnixNano": self.start_ns,
            "endTimeUnixNano": self.end_ns,
            "status": {"code": self.status, "message": self.status_message},
            "attributes": self.attributes,
        }
        if self.parent_span_id:
            d["parentSpanId"] = self.parent_span_id
        if self.events:
            d["events"] = self.events
        return d


class Tracer:
    """Span factory + ring-buffer store."""

    def __init__(self, service: str = "kubeflow-tpu-torch", capacity: int = 4096,
                 open_span_ttl_s: float = OPEN_SPAN_TTL_S):
        self.service = service
        #: OTLP resource identity (``service.instance.id``): which process a
        #: span came from
        self.instance = f"{socket.gethostname()}:{os.getpid()}"
        self._spans: Deque[Span] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        # cross-thread open-span map: every start_span() registers here and
        # end_span() removes; bounded by the TTL sweep plus a hard cap so a
        # caller that never calls end_span can't grow memory forever
        self.open_span_ttl_s = open_span_ttl_s
        self.max_open_spans = capacity
        self._open: Dict[str, Span] = {}
        self._open_lock = threading.Lock()
        self._last_sweep = time.monotonic()

    @staticmethod
    def current_span() -> Optional[Span]:
        return getattr(_local, "span", None)

    def start_span(self, name: str, parent: Optional[Span] = None,
                   traceparent: Optional[str] = None, **attributes: Any) -> Span:
        """Manual span lifecycle: parents to (in order) the explicit parent,
        a ``traceparent`` header, or the thread-local current span, but does
        NOT become the current span. Pair with ``end_span()``."""
        if parent is None and traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed:
                parent = Span("remote", parsed[0], parsed[1])
        if parent is None:
            parent = self.current_span()
        span = Span(
            name=name,
            trace_id=parent.trace_id if parent else _rand_hex(16),
            span_id=_rand_hex(8),
            parent_span_id=parent.span_id if parent else None,
            start_ns=time.time_ns(),
            attributes={"service.name": self.service, **attributes},
        )
        with self._open_lock:
            self._open[span.span_id] = span
            over = len(self._open) - self.max_open_spans
            oldest = (sorted(self._open.values(), key=lambda s: s.start_ns)[:over]
                      if over > 0 else [])
            for stale in oldest:
                del self._open[stale.span_id]
        if oldest:
            self._abandon(oldest, f"evicted: >{self.max_open_spans} open spans")
        self._maybe_sweep()
        return span

    def open_spans(self) -> List[Span]:
        """Spans started but not yet ended (debug/test view)."""
        with self._open_lock:
            return list(self._open.values())

    def _maybe_sweep(self) -> None:
        # amortized: at most one sweep per quarter-TTL, checked with one
        # monotonic read on the start_span hot path
        if time.monotonic() - self._last_sweep < self.open_span_ttl_s / 4:
            return
        self.sweep_abandoned()

    def sweep_abandoned(self, ttl_s: Optional[float] = None) -> int:
        """Force-close open spans older than the TTL (their worker crashed or
        forgot end_span): recorded as ERROR and counted by
        ``tracing_spans_abandoned_total``, so the leak is visible while the
        open-span map stays bounded."""
        ttl = self.open_span_ttl_s if ttl_s is None else ttl_s
        self._last_sweep = time.monotonic()
        cutoff = time.time_ns() - int(ttl * 1e9)
        with self._open_lock:
            stale = [s for s in self._open.values() if s.start_ns <= cutoff]
            for s in stale:
                del self._open[s.span_id]
        self._abandon(stale, f"abandoned: not ended within {ttl:.0f}s")
        return len(stale)

    def _abandon(self, spans: List[Span], message: str) -> None:
        if not spans:
            return
        # lazy: metrics reaches back into this module for exemplar trace ids
        from .metrics import METRICS

        for s in spans:
            s.status = "ERROR"
            s.status_message = message
            s.end_ns = time.time_ns()
            with self._lock:
                self._spans.append(s)
            METRICS.counter("tracing_spans_abandoned_total").inc()

    def emit_span(self, name: str, start_ns: int, end_ns: int,
                  events: Optional[List[Dict[str, Any]]] = None,
                  parent: Optional[Span] = None, **attributes: Any) -> Span:
        """Record an already-elapsed interval as a span (StepClock's per-step
        hook: the step is only known to be a span at ``end_step()``)."""
        if parent is None:
            parent = self.current_span()
        span = Span(
            name=name,
            trace_id=parent.trace_id if parent else _rand_hex(16),
            span_id=_rand_hex(8),
            parent_span_id=parent.span_id if parent else None,
            start_ns=start_ns,
            end_ns=end_ns,
            attributes={"service.name": self.service, **attributes},
        )
        if events:
            span.events = list(events)
        with self._lock:
            self._spans.append(span)
        return span

    def end_span(self, span: Span, error: Optional[BaseException] = None) -> Span:
        """Close and record a ``start_span()`` span."""
        with self._open_lock:
            self._open.pop(span.span_id, None)
        if error is not None:
            span.record_error(error)
        span.end_ns = time.time_ns()
        with self._lock:
            self._spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             traceparent: Optional[str] = None, **attributes: Any) -> Iterator[Span]:
        """Open a span that is the thread's current span for the body."""
        span = self.start_span(name, parent=parent, traceparent=traceparent,
                               **attributes)
        prev = self.current_span()
        _local.span = span
        try:
            yield span
        except BaseException as e:
            span.record_error(e)
            raise
        finally:
            _local.span = prev
            self.end_span(span)

    @contextmanager
    def detached(self) -> Iterator[None]:
        """Run with NO current span: for work started inside a request's
        context that is not part of that request (an informer's 410 relist
        re-syncs the world for every consumer; its LISTs must not inherit
        the triggering stream's trace)."""
        prev = self.current_span()
        _local.span = None
        try:
            yield
        finally:
            _local.span = prev

    def finished_spans(self, name: Optional[str] = None,
                       trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._spans)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return spans

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
        with self._open_lock:
            self._open.clear()


def format_traceparent(span: Span) -> str:
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(header: str) -> Optional[tuple]:
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


#: process-global tracer (mirrors METRICS's process-global registry)
TRACER = Tracer()
