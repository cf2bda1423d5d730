"""Bounded in-memory time-series store for the monitoring plane: the
port's copy of ``kubeflow_tpu/monitoring/tsdb.py``.

One series = one (metric name, label set); points live in a fixed-size ring
buffer so a long-running monitor holds a sliding window, never the whole
history. Query power is deliberately small — exact/regex label matchers,
``latest``, ``increase``/``rate`` with counter-reset handling, and a
windowed ``histogram_quantile`` over ``<name>_bucket`` series — because the
rule engine and the federated autoscaler source need exactly that and
nothing else.

Staleness is explicit rather than timestamp-heuristic: the scraper marks a
target's series stale after N missed scrapes, and every read path skips
stale series unless asked not to. That is what lets consumers distinguish
"the fleet is idle" from "we stopped seeing the fleet" (the autoscaler
no-flap requirement).
"""

from __future__ import annotations

import re
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Tuple, Union

from ..runtime.metrics import quantile_from_counts

#: label matcher values: exact string or compiled regex (fullmatch semantics)
Matchers = Dict[str, Union[str, re.Pattern]]


@dataclass
class Series:
    name: str
    labels: Dict[str, str]
    points: Deque[Tuple[float, float]] = field(default_factory=deque)  # (ts, value)
    stale: bool = False

    @property
    def last_ts(self) -> float:
        return self.points[-1][0] if self.points else 0.0


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _matches(labels: Dict[str, str], matchers: Optional[Matchers]) -> bool:
    if not matchers:
        return True
    for k, want in matchers.items():
        got = labels.get(k)
        if got is None:
            return False
        if isinstance(want, str):
            if got != want:
                return False
        elif not want.fullmatch(got):
            return False
    return True


class TSDB:
    """Thread-safe store of append-only series with per-series ring buffers.

    ``max_points`` bounds each series' ring; ``max_series`` bounds the store
    — when a new series would exceed it, the series with the oldest last
    write is evicted (a scrape-churn guard, not an LRU cache)."""

    def __init__(self, max_points: int = 512, max_series: int = 8192) -> None:
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        #: name → label-key → Series
        self._series: Dict[str, Dict[Tuple[Tuple[str, str], ...], Series]] = {}
        #: family kinds (counter/gauge/histogram/untyped), keyed by family name
        self._kinds: Dict[str, str] = {}
        #: sample name → family name (histogram _bucket/_sum/_count fold back)
        self._families: Dict[str, str] = {}
        self._count = 0

    # -- writes --------------------------------------------------------------
    def set_kind(self, family: str, kind: str,
                 sample_names: Iterable[str] = ()) -> None:
        with self._lock:
            self._kinds[family] = kind
            self._families[family] = family
            for s in sample_names:
                self._families[s] = family

    def kind(self, family: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(family)

    def family_of(self, sample_name: str) -> str:
        with self._lock:
            return self._families.get(sample_name, sample_name)

    def add_sample(self, name: str, labels: Dict[str, str], ts: float,
                   value: float) -> None:
        """Append one point; a fresh write always clears the series' stale
        flag (recovery is implicit — seeing data again IS the signal)."""
        key = _label_key(labels)
        with self._lock:
            by_key = self._series.setdefault(name, {})
            s = by_key.get(key)
            if s is None:
                if self._count >= self.max_series:
                    self._evict_oldest_locked()
                s = Series(name=name, labels=dict(labels),
                           points=deque(maxlen=self.max_points))
                by_key[key] = s
                self._count += 1
            s.points.append((float(ts), float(value)))
            s.stale = False

    def _evict_oldest_locked(self) -> None:
        oldest: Optional[Tuple[str, Tuple[Tuple[str, str], ...]]] = None
        oldest_ts = float("inf")
        for name, by_key in self._series.items():
            for key, s in by_key.items():
                if s.last_ts < oldest_ts:
                    oldest_ts = s.last_ts
                    oldest = (name, key)
        if oldest is not None:
            del self._series[oldest[0]][oldest[1]]
            if not self._series[oldest[0]]:
                del self._series[oldest[0]]
            self._count -= 1

    def mark_stale(self, **labels: str) -> int:
        """Flag every series whose labels match (exactly, on the given keys)
        as stale; returns how many flipped. The scraper calls this with
        ``instance=...`` when a target exceeds its missed-scrape budget."""
        flipped = 0
        with self._lock:
            for by_key in self._series.values():
                for s in by_key.values():
                    if not s.stale and _matches(s.labels, labels):
                        s.stale = True
                        flipped += 1
        return flipped

    # -- reads ---------------------------------------------------------------
    def series(self, name: str, matchers: Optional[Matchers] = None,
               include_stale: bool = False) -> List[Series]:
        with self._lock:
            out = []
            for s in self._series.get(name, {}).values():
                if s.stale and not include_stale:
                    continue
                if _matches(s.labels, matchers):
                    out.append(s)
            return out

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, name: str, matchers: Optional[Matchers] = None,
               include_stale: bool = False) -> List[Tuple[Dict[str, str], float, float]]:
        """Newest ``(labels, ts, value)`` per matching series."""
        return [
            (dict(s.labels), *s.points[-1])
            for s in self.series(name, matchers, include_stale)
            if s.points
        ]

    def newest_ts(self, name: str, matchers: Optional[Matchers] = None,
                  include_stale: bool = False) -> Optional[float]:
        stamps = [ts for _l, ts, _v in self.latest(name, matchers, include_stale)]
        return max(stamps) if stamps else None

    def increase(self, name: str, window_s: float, now: float,
                 matchers: Optional[Matchers] = None) -> float:
        """PromQL-style ``increase()``: per-series sum of positive deltas
        between consecutive points inside the window, summed across series.
        A drop between points is a counter reset — the post-reset value IS
        the increase since the reset, matching Prometheus semantics."""
        lo = now - window_s
        total = 0.0
        for s in self.series(name, matchers):
            prev: Optional[float] = None
            for ts, value in s.points:
                if ts < lo or ts > now:
                    prev = value if ts < lo else prev
                    continue
                if prev is not None:
                    total += value - prev if value >= prev else value
                prev = value
        return total

    def rate(self, name: str, window_s: float, now: float,
             matchers: Optional[Matchers] = None) -> float:
        return self.increase(name, window_s, now, matchers) / window_s if window_s > 0 else 0.0

    def windowed_bucket_counts(
        self, name: str, window_s: float, now: float,
        matchers: Optional[Matchers] = None,
    ) -> Optional[Tuple[Tuple[float, ...], List[int], int]]:
        """``(buckets, counts, total)`` of a histogram family's increase over
        the window, aggregated across every matching ``<name>_bucket``
        series. Cumulative ``le`` counts are de-cumulated into the per-bucket
        vector ``quantile_from_counts`` expects. None when no fresh series
        carried any increase (no data ≠ zero latency)."""
        per_le: Dict[float, float] = {}
        lo = now - window_s
        for s in self.series(f"{name}_bucket", matchers):
            le_raw = s.labels.get("le")
            if le_raw is None:
                continue
            le = float("inf") if le_raw in ("+Inf", "inf") else float(le_raw)
            last: Optional[float] = None
            prev: Optional[float] = None
            inc = 0.0
            for ts, value in s.points:
                if ts < lo:
                    prev = value
                    continue
                if ts > now:
                    break
                if prev is not None:
                    inc += value - prev if value >= prev else value
                prev = value
                last = value
            if last is None:
                continue
            per_le[le] = per_le.get(le, 0.0) + inc
        if not per_le or float("inf") not in per_le:
            return None
        finite = sorted(b for b in per_le if b != float("inf"))
        total = per_le[float("inf")]
        counts: List[int] = []
        prev_cum = 0.0
        for b in finite:
            counts.append(int(round(per_le[b] - prev_cum)))
            prev_cum = per_le[b]
        counts.append(int(round(total - prev_cum)))
        total_i = int(round(total))
        if total_i <= 0:
            return None
        return tuple(finite), counts, total_i

    def histogram_quantile(
        self, name: str, q: float, window_s: float, now: float,
        matchers: Optional[Matchers] = None,
    ) -> Optional[float]:
        """Windowed PromQL ``histogram_quantile(q, rate(<name>_bucket[w]))``
        across matching instances. None when the window holds no data."""
        snap = self.windowed_bucket_counts(name, window_s, now, matchers)
        if snap is None:
            return None
        buckets, counts, total = snap
        return quantile_from_counts(buckets, counts, total, q)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "series": self._count,
                "names": len(self._series),
                "stale": sum(
                    1 for by_key in self._series.values()
                    for s in by_key.values() if s.stale
                ),
            }
