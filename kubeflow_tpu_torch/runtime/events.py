"""Event pipeline: a K8s-style EventRecorder with correlation, spam
protection and bounded retention — the port's copy of
``kubeflow_tpu/runtime/events.py``.

Kubernetes solved Event spam in client-go's EventCorrelator (record/event.go
+ events_cache.go): correlate duplicates onto one object, rate-limit noisy
sources, and let old Events go. The recorder rebuilds those three layers
over any client with ``create`` (honouring ``metadata.generateName``),
``patch`` (a merge patch; a missing object raises ``LookupError``, as the
port's store's ``NotFound`` does) and ``delete_opt``:

- **Aggregation** — events are keyed on (involved uid, reason, component,
  type). A duplicate emit patches the existing Event — bump ``count``,
  refresh ``lastTimestamp``/``message`` — instead of creating a new
  object, so "FailedScheduling × 40 attempts" is ONE Event with
  ``count=40``.
- **Spam filter** — a token bucket per (component, involved uid), the
  shape of client-go's EventSourceObjectSpamFilter: ``burst`` emits up
  front, then ``refill_per_second``. Dropped emits are counted in
  ``events_discarded_total`` and return None; they never block or fail
  the caller.
- **Retention GC** — the recorder remembers the Events it created in
  insertion order and deletes the oldest once more than ``max_events``
  correlation entries are live.

The port's ``apiserver.client.Client`` holds one recorder as ``events``
and routes ``emit_event`` through it, so its ``list("v1", "Event",
namespace)`` returns the aggregated Event objects.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .metrics import METRICS

#: correlation key: involved object identity + what happened + who said it
AggKey = Tuple[str, str, str, str]


@dataclass
class _AggEntry:
    namespace: str
    name: str  # Event object name in the store
    count: int
    #: spam bookkeeping rides the entry so both caches expire together
    first_seen: float = field(default_factory=time.monotonic)
    #: last emit that touched this key — evicting a recently-active entry
    #: means the cap, not natural quiescence, forced it out
    last_seen: float = field(default_factory=time.monotonic)


class _TokenBucket:
    def __init__(self, burst: int, refill_per_second: float) -> None:
        self.capacity = float(burst)
        self.tokens = float(burst)
        self.refill = refill_per_second
        self.last = time.monotonic()

    def take(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self.tokens = min(self.capacity, self.tokens + (now - self.last) * self.refill)
        self.last = now
        if self.tokens < 1.0:
            return False
        self.tokens -= 1.0
        return True


def _meta(obj: Dict[str, Any]) -> Dict[str, Any]:
    return obj.get("metadata") or {}


def now_rfc3339() -> str:
    """The apiserver's timestamp: UTC, to the second (JAX's ``Store.now``)."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _involved_ref(involved: Dict[str, Any]) -> Dict[str, Any]:
    meta = _meta(involved)
    return {
        "apiVersion": involved.get("apiVersion", ""),
        "kind": involved.get("kind"),
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace") or "default",
        "uid": meta.get("uid"),
    }


def _involved_id(involved: Dict[str, Any]) -> str:
    """Stable identity for correlation: uid when the object carries one,
    else the (kind, ns, name) triple — fixture objects in unit tests are
    often emitted before they ever hit the store."""
    meta = _meta(involved)
    uid = meta.get("uid")
    if uid:
        return str(uid)
    ns = meta.get("namespace") or "default"
    return f"{involved.get('kind')}/{ns}/{meta.get('name', '')}"


class EventRecorder:
    """Correlating, spam-filtered, retention-bounded Event writer.

    One instance per client; all methods are thread-safe (detectors and
    rule engines emit from their own threads).
    """

    def __init__(
        self,
        client,
        max_events: int = 256,
        burst: int = 25,
        refill_per_second: float = 1.0 / 30.0,
        live_window_s: float = 60.0,
    ) -> None:
        self.client = client
        self.max_events = max_events
        self.burst = burst
        self.refill_per_second = refill_per_second
        #: an evicted entry emitted within this window counts as still-live
        #: (events_retention_saturated_total) — the cap is too small for
        #: the active set, not merely sweeping out dead history
        self.live_window_s = live_window_s
        self._lock = threading.Lock()
        #: insertion-ordered correlation cache — doubles as the GC ledger
        self._agg: Dict[AggKey, _AggEntry] = {}
        self._buckets: Dict[Tuple[str, str], _TokenBucket] = {}

    # -- the one public verb --------------------------------------------------
    def emit(
        self,
        involved: Dict[str, Any],
        reason: str,
        message: str,
        type_: str = "Normal",
        component: str = "kubeflow-tpu",
    ) -> Optional[Dict[str, Any]]:
        """Record an Event against ``involved``; returns the stored Event,
        or None when the source's spam budget dropped it."""
        key: AggKey = (_involved_id(involved), reason, component, type_)
        with self._lock:
            if not self._spam_ok(component, key[0]):
                METRICS.counter("events_discarded_total", component=component).inc()
                return None
            entry = self._agg.get(key)
        if entry is not None:
            ev = self._bump(key, entry, message, component)
            if ev is not None:
                return ev
            # the aggregated Event vanished under us (deleted externally);
            # fall through and start a fresh correlation entry
            with self._lock:
                self._agg.pop(key, None)
        ev = self._create(involved, reason, message, type_, component)
        doomed = []
        with self._lock:
            self._agg[key] = _AggEntry(
                namespace=ev["metadata"]["namespace"],
                name=ev["metadata"]["name"],
                count=1,
            )
            while len(self._agg) > self.max_events:
                old_key = next(iter(self._agg))
                doomed.append(self._agg.pop(old_key))
        now = time.monotonic()
        for old in doomed:  # retention GC: store deletes happen off-lock
            METRICS.counter("events_retention_deleted_total").inc()
            if now - old.last_seen < self.live_window_s:
                # the cap forced out a dedup key that was still taking
                # emits — its next duplicate will mint a brand-new Event
                # (count resets), so aggregation quality degrades; raise
                # max_events when this counter moves under load
                METRICS.counter("events_retention_saturated_total").inc()
            self.client.delete_opt("v1", "Event", old.name, old.namespace)
        return ev

    # -- internals -------------------------------------------------------------
    def _spam_ok(self, component: str, involved_id: str) -> bool:
        """Caller holds the lock. Per-(source, object) budget, the
        EventSourceObjectSpamFilter shape — one chatty pod cannot starve
        every other object's events from the same component."""
        bkey = (component, involved_id)
        bucket = self._buckets.get(bkey)
        if bucket is None:
            bucket = self._buckets[bkey] = _TokenBucket(self.burst, self.refill_per_second)
            # the bucket map tracks the agg cache's bound: drop stale buckets
            # once it outgrows the retention budget by a wide margin
            if len(self._buckets) > 4 * self.max_events:
                for stale in list(self._buckets)[: len(self._buckets) // 2]:
                    del self._buckets[stale]
        return bucket.take()

    def _bump(
        self, key: AggKey, entry: _AggEntry, message: str, component: str
    ) -> Optional[Dict[str, Any]]:
        """Aggregate a duplicate onto the existing Event via merge-patch."""
        with self._lock:
            entry.count += 1
            entry.last_seen = time.monotonic()
            count = entry.count
        try:
            ev = self.client.patch(
                "v1",
                "Event",
                entry.name,
                {"count": count, "lastTimestamp": now_rfc3339(), "message": message},
                entry.namespace,
            )
        except LookupError:
            return None
        METRICS.counter("events_emitted_total", component=component, outcome="aggregated").inc()
        return ev

    def _create(
        self,
        involved: Dict[str, Any],
        reason: str,
        message: str,
        type_: str,
        component: str,
    ) -> Dict[str, Any]:
        ns = _meta(involved).get("namespace") or "default"
        ev: Dict[str, Any] = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": "", "namespace": ns,
                         "generateName": f"{_meta(involved).get('name', '')}."},
        }
        # ONE timestamp for both fields: two reads can straddle a second
        # boundary and mint a fresh Event whose firstTimestamp !=
        # lastTimestamp
        now = now_rfc3339()
        ev.update(
            {
                "involvedObject": _involved_ref(involved),
                "reason": reason,
                "message": message,
                "type": type_,
                "source": {"component": component},
                "firstTimestamp": now,
                "lastTimestamp": now,
                "count": 1,
            }
        )
        created = self.client.create(ev)
        METRICS.counter("events_emitted_total", component=component, outcome="created").inc()
        return created

    # -- introspection (tests / debug) ----------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"correlated": len(self._agg), "buckets": len(self._buckets)}
