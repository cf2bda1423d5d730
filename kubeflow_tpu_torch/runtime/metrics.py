"""Prometheus-style metrics registry with text exposition.

A trimmed copy of ``kubeflow_tpu/runtime/metrics.py``: the subset the
serving path uses — counters, gauges, histograms with explicit bucket
ladders and exemplars, namespaced views, bucket-interpolated quantiles
(``quantile``, ``quantile_from_counts``), scrape-time collectors with the
stdlib process collector (``install_process_collector``) and ``render()``.
Same names and exposition format, so a scrape of the port reads like a
scrape of the JAX server.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _current_trace_id() -> Optional[str]:
    """Trace id of the calling thread's current span (exemplar source)."""
    from .tracing import TRACER  # lazy: tracing never imports metrics

    span = TRACER.current_span()
    return span.trace_id if span is not None else None


class _Counter:
    """Engine worker threads of a fleet add to one series at once, so each
    read-modify-write holds the series' lock."""

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class _Gauge:
    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
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
        self._lock = threading.Lock()

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
        i = self._index(value)
        with self._lock:
            self.sum += value * count
            self.total += count
            self.counts[i] += count
        if trace_id is None:
            trace_id = _current_trace_id()
        if trace_id is not None:
            self.exemplars[i] = (float(value), trace_id, time.time())

    @property
    def mean(self) -> float:
        """Mean observed value; 0.0 before the first observation."""
        return self.sum / self.total if self.total else 0.0


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
        #: scrape-time callbacks, keyed for idempotence; they survive reset()
        self._collectors: Dict[str, Callable[[], None]] = {}

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

    def histogram_counts(self, name: str) -> Optional[Tuple[Tuple[float, ...], List[int], int]]:
        """Aggregated ``(buckets, counts, total)`` of histogram ``name``
        across every label series; None when it has no series."""
        with self._lock:
            hists = [m for m in self._metrics.get(name, {}).values()
                     if isinstance(m, _Histogram)]
            if not hists:
                return None
            buckets = hists[0].buckets
            counts = [0] * (len(buckets) + 1)
            total = 0
            for h in hists:
                for i, c in enumerate(h.counts):
                    counts[i] += c
                total += h.total
            return buckets, counts, total

    def quantile(self, name: str, q: float) -> Optional[float]:
        """The q-quantile (0..1) of histogram ``name`` across every label
        series, interpolated inside the bucket that holds the rank (PromQL's
        histogram_quantile). None for a missing or never-observed histogram:
        no data is not zero latency."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q={q} outside [0, 1]")
        snap = self.histogram_counts(name)
        if snap is None:
            return None
        buckets, counts, total = snap
        return quantile_from_counts(buckets, counts, total, q)

    def register_collector(self, key: str, fn: Callable[[], None]) -> None:
        """Run ``fn`` at every render() before the exposition is built.
        Re-registering a key replaces it; collectors survive reset()."""
        with self._lock:
            self._collectors[key] = fn

    def render(self) -> str:
        """OpenMetrics-flavored text exposition, terminated by ``# EOF``."""
        for fn in list(self._collectors.values()):
            try:
                fn()  # outside self._lock: collectors call gauge()/counter()
            except Exception:
                pass  # a broken collector must not take /metrics down
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


def quantile_from_counts(buckets: Sequence[float], counts: Sequence[int],
                         total: int, q: float) -> Optional[float]:
    """The histogram_quantile() interpolation over an explicit bucket-count
    vector (``len(counts) == len(buckets) + 1``, the last slot +Inf). None
    on an empty vector; a rank in the +Inf bucket clamps to the largest
    finite bound."""
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    for i, bound in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            lo = buckets[i - 1] if i > 0 else 0.0
            if counts[i] == 0:
                return bound
            return lo + (bound - lo) * ((rank - prev) / counts[i])
    return buckets[-1]


METRICS = MetricsRegistry()


# -- stdlib process collector -------------------------------------------------

_PROCESS_START = time.time()


def _rss_bytes() -> Optional[float]:
    try:  # Linux: the current RSS
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:  # elsewhere: the peak RSS
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    except Exception:
        return None


def install_process_collector(registry: Optional[MetricsRegistry] = None) -> None:
    """Register the ``process_*`` series (RSS, threads, GC collections, CPU
    seconds, uptime) on ``registry``, refreshed at every scrape."""
    reg = registry if registry is not None else METRICS

    def collect() -> None:
        reg.gauge("process_uptime_seconds").set(time.time() - _PROCESS_START)
        reg.gauge("process_threads").set(float(threading.active_count()))
        t = os.times()
        reg.counter("process_cpu_seconds_total").value = float(t.user + t.system)
        rss = _rss_bytes()
        if rss is not None:
            reg.gauge("process_resident_memory_bytes").set(rss)
        for gen, stats in enumerate(gc.get_stats()):
            reg.counter("process_gc_collections_total",
                        generation=str(gen)).value = float(stats.get("collections", 0))

    reg.register_collector("process", collect)
