"""Tracing: spans over serving requests and HTTP handlers.

A trimmed copy of ``kubeflow_tpu/runtime/tracing.py``: the OpenTelemetry
vocabulary (traceId/spanId/parentSpanId, nanosecond epochs, status,
attributes), an in-memory ring buffer, a thread-local current span, the
manual ``start_span``/``end_span`` lifecycle a serving request needs (it
starts on the HTTP thread and ends on the engine worker), ``emit_span``
for an interval already elapsed (a training step), the W3C
``traceparent`` codec, and ``Span.to_dict`` in the OTLP field names that
``/debug/traces`` serves (``runtime/obs.py``).
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

    def __init__(self, service: str = "kubeflow-tpu-torch", capacity: int = 4096):
        self.service = service
        #: OTLP resource identity (``service.instance.id``): which process a
        #: span came from
        self.instance = f"{socket.gethostname()}:{os.getpid()}"
        self._spans: Deque[Span] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

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
        return Span(
            name=name,
            trace_id=parent.trace_id if parent else _rand_hex(16),
            span_id=_rand_hex(8),
            parent_span_id=parent.span_id if parent else None,
            start_ns=time.time_ns(),
            attributes={"service.name": self.service, **attributes},
        )

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


def format_traceparent(span: Span) -> str:
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(header: str) -> Optional[tuple]:
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


#: process-global tracer (mirrors METRICS's process-global registry)
TRACER = Tracer()
