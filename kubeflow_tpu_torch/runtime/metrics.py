"""Prometheus-style metrics registry with text exposition.

A trimmed copy of ``kubeflow_tpu/runtime/metrics.py``: the subset the
serving slice uses — counters, gauges, histograms with explicit bucket
ladders and exemplars, namespaced views and ``render()``. Same names and
exposition format, so a scrape of the port reads like a scrape of the JAX
server.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _current_trace_id() -> Optional[str]:
    """Trace id of the calling thread's current span (exemplar source)."""
    from .tracing import TRACER  # lazy: tracing never imports metrics

    span = TRACER.current_span()
    return span.trace_id if span is not None else None


class _Counter:
    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class _Gauge:
    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class _Histogram:
    #: default ladder — serving SLO series override per metric
    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0)

    def __init__(self, buckets: Optional[Sequence[float]] = None) -> None:
        self.buckets: Tuple[float, ...] = tuple(buckets) if buckets else self.BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        #: per-bucket exemplar: (observed value, trace_id, unix seconds)
        self.exemplars: List[Optional[Tuple[float, str, float]]] = [None] * (
            len(self.buckets) + 1)

    def _index(self, value: float) -> int:
        for i, b in enumerate(self.buckets):
            if value <= b:
                return i
        return len(self.buckets)

    def observe(self, value: float, count: int = 1,
                trace_id: Optional[str] = None) -> None:
        """Record ``count`` observations of ``value`` (count>1 amortizes a
        block of identical observations — the chunked decode path records
        per-token inter-token latency this way)."""
        self.sum += value * count
        self.total += count
        i = self._index(value)
        self.counts[i] += count
        if trace_id is None:
            trace_id = _current_trace_id()
        if trace_id is not None:
            self.exemplars[i] = (float(value), trace_id, time.time())


class NamespacedRegistry:
    """A registry view that prefixes every metric name with ``<prefix>_``."""

    def __init__(self, registry: "MetricsRegistry", prefix: str) -> None:
        self._registry = registry
        self._prefix = prefix

    def _name(self, name: str) -> str:
        return f"{self._prefix}_{name}"

    def counter(self, name: str, **labels: str) -> _Counter:
        return self._registry.counter(self._name(name), **labels)

    def gauge(self, name: str, **labels: str) -> _Gauge:
        return self._registry.gauge(self._name(name), **labels)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  **labels: str) -> _Histogram:
        return self._registry.histogram(self._name(name), buckets=buckets, **labels)

    def value(self, name: str, **labels: str) -> float:
        return self._registry.value(self._name(name), **labels)


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Dict[Tuple[Tuple[str, str], ...], object]] = {}
        self._types: Dict[str, str] = {}
        #: first-registration bucket ladder per histogram name — every label
        #: series of a name shares one ladder or the exposition is corrupt
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}

    def _get(self, name: str, kind: str, factory, labels: Dict[str, str]):
        with self._lock:
            if name in self._types and self._types[name] != kind:
                raise ValueError(f"metric {name} already registered as {self._types[name]}")
            self._types[name] = kind
            series = self._metrics.setdefault(name, {})
            key = _label_key(labels)
            if key not in series:
                series[key] = factory()
            return series[key]

    def counter(self, name: str, **labels: str) -> _Counter:
        return self._get(name, "counter", _Counter, labels)

    def gauge(self, name: str, **labels: str) -> _Gauge:
        return self._get(name, "gauge", _Gauge, labels)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  **labels: str) -> _Histogram:
        """``buckets`` fixes the name's ladder at first registration; a later
        call may omit them (reuses the registered ladder) but re-registering
        with a DIFFERENT ladder raises."""
        with self._lock:
            if name in self._types and self._types[name] != "histogram":
                raise ValueError(f"metric {name} already registered as {self._types[name]}")
            requested = tuple(sorted(float(b) for b in buckets)) if buckets else None
            registered = self._hist_buckets.get(name)
            if registered is not None and requested is not None and requested != registered:
                raise ValueError(
                    f"histogram {name} already registered with buckets {registered}; "
                    f"cannot re-register with {requested}")
            effective = registered or requested or _Histogram.BUCKETS
            self._hist_buckets[name] = effective
            self._types[name] = "histogram"
            series = self._metrics.setdefault(name, {})
            key = _label_key(labels)
            if key not in series:
                series[key] = _Histogram(effective)
            return series[key]

    def value(self, name: str, **labels: str) -> float:
        with self._lock:
            m = self._metrics.get(name, {}).get(_label_key(labels))
            return getattr(m, "value", 0.0) if m else 0.0

    def render(self) -> str:
        """OpenMetrics-flavored text exposition, terminated by ``# EOF``."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                kind = self._types[name]
                lines.append(f"# TYPE {name} {kind}")
                for key, m in sorted(self._metrics[name].items()):
                    label_str = ",".join(f'{k}="{v}"' for k, v in key)
                    suffix = f"{{{label_str}}}" if label_str else ""
                    if isinstance(m, _Histogram):
                        cum = 0
                        bounds = [str(b) for b in m.buckets] + ["+Inf"]
                        for i, b in enumerate(bounds):
                            cum += m.counts[i]
                            le = ("," if label_str else "") + f'le="{b}"'
                            lines.append(f"{name}_bucket{{{label_str}{le}}} {cum}"
                                         + _exemplar_suffix(m.exemplars[i]))
                        lines.append(f"{name}_sum{suffix} {m.sum}")
                        lines.append(f"{name}_count{suffix} {m.total}")
                    else:
                        lines.append(f"{name}{suffix} {m.value}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def namespace(self, prefix: str) -> NamespacedRegistry:
        return NamespacedRegistry(self, prefix)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._types.clear()
            self._hist_buckets.clear()


def _exemplar_suffix(ex: Optional[Tuple[float, str, float]]) -> str:
    if ex is None:
        return ""
    value, trace_id, ts = ex
    return f' # {{trace_id="{trace_id}"}} {value} {round(ts, 3)}'


METRICS = MetricsRegistry()
