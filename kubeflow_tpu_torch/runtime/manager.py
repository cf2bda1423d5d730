"""Controller runtime: watch-driven, level-triggered reconcile loops.

A trimmed copy of ``kubeflow_tpu/runtime/manager.py``, with JAX's trace
behaviour. A reconciler names the kind it is *for*, the kinds it *owns*
(changes map back to the controller owner) and extra *watches* with
mapping functions. Events land in a deduplicating, sharded workqueue; one
worker per reconciler makes each key single-flight; a failed reconcile
requeues with exponential backoff; ``Result(requeue_after=...)`` schedules
periodic work. The reconcile span parents to the object's creation
traceparent (``TRACEPARENT_ANNOTATION``), and the workqueue carries the
last enqueuer's trace beside a deduplicated key.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import meta as apimeta
from ..apiserver.client import Client
from ..apiserver.store import Store
from .metrics import METRICS
from .tracing import (
    TRACEPARENT_ANNOTATION,
    TRACER,
    format_traceparent,
    parse_traceparent,
)

log = logging.getLogger("kubeflow_tpu_torch.runtime")


@dataclass(frozen=True)
class Request:
    namespace: Optional[str]
    name: str


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


class Reconciler:
    """Subclass and override reconcile(); set FOR = (apiVersion, kind).

    ``cache`` is injected by the Manager: a shared InformerCache for
    watch-backed reads on hot paths (see runtime/informer.py). It is None
    when the reconciler runs outside a manager (unit tests) — fall back to
    direct client lists then.
    """

    cache = None  # set by Manager.add

    FOR: Tuple[str, str] = ("", "")
    OWNS: List[Tuple[str, str]] = []

    def reconcile(self, client: Client, req: Request) -> Result:  # pragma: no cover
        raise NotImplementedError

    def watches(self) -> List[Tuple[Tuple[str, str], Callable[[Dict[str, Any]], List[Request]]]]:
        """Extra (kind, mapper) watches beyond FOR/OWNS."""
        return []


class _Shard:
    """One lock domain of a sharded workqueue: its own pending dict (dedup),
    delayed heap, deadline/failure/enqueue-time maps."""

    __slots__ = ("lock", "pending", "delayed", "deadlines", "failures",
                 "added_at", "traces", "seq")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.pending: Dict[Request, None] = {}
        self.delayed: List[Tuple[float, int, Request]] = []
        #: authoritative earliest deadline per request — heap entries whose
        #: deadline disagrees are superseded duplicates and get dropped on pop
        self.deadlines: Dict[Request, float] = {}
        self.failures: Dict[Request, int] = {}
        #: enqueue time per pending request (queue-duration histogram)
        self.added_at: Dict[Request, float] = {}
        #: trace context per pending request (the Request key is frozen, so
        #: the causing event's traceparent rides beside it; last enqueuer
        #: wins — the dedup'd item parents to the freshest cause)
        self.traces: Dict[Request, str] = {}
        self.seq = 0


class _WorkQueue:
    """Deduplicating delayed workqueue, SHARDED by key hash.

    With one queue-wide condition every watch pump and the worker would
    serialize: under heavy pod churn the producers (N watch streams mapping
    events to keys) convoy behind each other. Keys hash to ``shards``
    independent lock domains — dedup, delay heaps and
    failure counts are all per-shard, so two pumps enqueueing different keys
    never contend. One queue-wide condition remains solely as the consumer
    wakeup signal (producers touch it only to notify, never to do work
    under it); ``_version`` closes the scan-then-sleep lost-wakeup window.

    Instrumented with the controller-runtime workqueue metric family
    (``workqueue_depth``/``adds``/``queue_duration``/``retries``/
    ``unfinished_work``), labeled by the owning controller's name and
    AGGREGATED across shards — the dashboard contract is unchanged.
    """

    SHARDS = 8

    def __init__(self, name: str = "", shards: int = SHARDS) -> None:
        self.name = name
        self._cond = threading.Condition()
        self._shards = [_Shard() for _ in range(max(1, shards))]
        self._rr = 0  # consumer scan cursor: rotate so no shard starves
        self._version = 0  # bumped under _cond on every enqueue/shutdown
        self._processing = 0
        #: start times of in-flight items, FIFO-drained by task_done()
        self._inflight: Dict[int, float] = {}
        self._inflight_seq = 0
        #: traceparent captured at get() per in-flight request, consumed by
        #: trace_of() on the worker before it opens the reconcile span
        self._popped_traces: Dict[Request, str] = {}
        self._shutdown = False
        # unfinished-work must grow while a reconcile hangs, so it is
        # computed at scrape time; keyed registration keeps remounts (and
        # per-test Managers reusing controller names) from stacking up
        METRICS.register_collector(f"workqueue_{name}", self._collect)

    def _shard(self, req: Request) -> _Shard:
        return self._shards[hash(req) % len(self._shards)]

    def _depth(self) -> int:
        # len() per shard without locks: a point-in-time gauge may be off by
        # an in-flight add, never corrupt
        return sum(len(s.pending) for s in self._shards)

    @property
    def _delayed(self) -> List[Tuple[float, int, Request]]:
        # debug/test view of the delayed heaps, flattened across shards (a
        # request hashes to exactly one shard, so dedup invariants — one
        # heap entry per hot-requeued key — read the same as pre-sharding)
        return [entry for s in self._shards for entry in s.delayed]

    def _collect(self) -> None:
        now = time.monotonic()
        depth = self._depth()
        with self._cond:
            unfinished = sum(now - t for t in self._inflight.values())
        METRICS.gauge("workqueue_depth", queue=self.name).set(depth)
        METRICS.gauge("workqueue_unfinished_work_seconds", queue=self.name).set(unfinished)
        # backlog pressure in [0, 1): 0 when the worker keeps up (nothing
        # queued), -> 1 as keys pile up faster than the single worker
        # drains them — depth/(depth+workers) for this one-worker queue; a
        # busy worker with an empty queue is healthy, not saturated.
        METRICS.gauge("workqueue_saturation", queue=self.name).set(
            round(depth / (depth + 1.0), 6))

    def _wake(self) -> None:
        with self._cond:
            self._version += 1
            self._cond.notify()

    def add(self, req: Request, traceparent: Optional[str] = None) -> None:
        if traceparent is None:
            cur = TRACER.current_span()
            traceparent = format_traceparent(cur) if cur is not None else None
        sh = self._shard(req)
        with sh.lock:
            if traceparent:
                # last-enqueuer wins: a dedup'd key carries the trace of the
                # most recent event that (re)queued it, so the reconcile span
                # parents to the cause the worker is actually reacting to
                sh.traces[req] = traceparent
            if req in sh.pending:
                return
            sh.pending[req] = None
            sh.added_at.setdefault(req, time.monotonic())
        METRICS.counter("workqueue_adds_total", queue=self.name).inc()
        METRICS.gauge("workqueue_depth", queue=self.name).set(self._depth())
        self._wake()

    def add_after(self, req: Request, delay: float) -> None:
        deadline = time.monotonic() + delay
        sh = self._shard(req)
        with sh.lock:
            cur = sh.deadlines.get(req)
            if cur is not None and cur <= deadline:
                return  # already scheduled at least as early; no new entry
            sh.deadlines[req] = deadline
            sh.seq += 1
            heapq.heappush(sh.delayed, (deadline, sh.seq, req))
        self._wake()

    def add_rate_limited(self, req: Request) -> None:
        sh = self._shard(req)
        with sh.lock:
            n = sh.failures.get(req, 0)
            sh.failures[req] = n + 1
        METRICS.counter("workqueue_retries_total", queue=self.name).inc()
        self.add_after(req, min(0.005 * (2**n), 30.0))

    def forget(self, req: Request) -> None:
        sh = self._shard(req)
        with sh.lock:
            sh.failures.pop(req, None)

    def _try_pop(
        self, now: float
    ) -> Tuple[Optional[Request], Optional[str], Optional[float]]:
        """One pass over all shards from the rotation cursor: promote due
        delayed items, pop the first pending request. Returns (request or
        None, its carried traceparent or None, earliest future delayed
        deadline or None)."""
        n = len(self._shards)
        start = self._rr
        next_due: Optional[float] = None
        for i in range(n):
            sh = self._shards[(start + i) % n]
            with sh.lock:
                while sh.delayed and sh.delayed[0][0] <= now:
                    due, _, dreq = heapq.heappop(sh.delayed)
                    if sh.deadlines.get(dreq) != due:
                        continue  # superseded by an earlier add_after
                    del sh.deadlines[dreq]
                    if dreq not in sh.pending:
                        sh.pending[dreq] = None
                        sh.added_at.setdefault(dreq, now)
                        METRICS.counter("workqueue_adds_total", queue=self.name).inc()
                if sh.delayed:
                    due = sh.delayed[0][0]
                    next_due = due if next_due is None else min(next_due, due)
                if sh.pending:
                    req = next(iter(sh.pending))
                    del sh.pending[req]
                    added = sh.added_at.pop(req, None)
                    trace = sh.traces.pop(req, None)
                    if added is not None:
                        parsed = parse_traceparent(trace) if trace else None
                        # exemplar: a bad queue-duration bucket links straight
                        # to the trace of the event that sat in it
                        METRICS.histogram(
                            "workqueue_queue_duration_seconds", queue=self.name
                        ).observe(now - added,
                                  trace_id=parsed[0] if parsed else None)
                    self._rr = (start + i + 1) % n
                    return req, trace, next_due
        return None, None, next_due

    def get(self, timeout: Optional[float] = None) -> Optional[Request]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                v0 = self._version
            now = time.monotonic()
            req, trace, next_due = self._try_pop(now)
            if req is not None:
                with self._cond:
                    self._processing += 1
                    self._inflight_seq += 1
                    self._inflight[self._inflight_seq] = now
                    if trace:
                        self._popped_traces[req] = trace
                    else:
                        self._popped_traces.pop(req, None)
                METRICS.gauge("workqueue_depth", queue=self.name).set(self._depth())
                return req
            with self._cond:
                if self._shutdown:
                    return None
                if self._version != v0:
                    continue  # an add raced our scan; rescan before sleeping
                wait = None
                if next_due is not None:
                    wait = max(0.0, next_due - now)
                if deadline is not None:
                    rem = deadline - now
                    if rem <= 0:
                        return None
                    wait = rem if wait is None else min(wait, rem)
                self._cond.wait(wait)

    def trace_of(self, req: Request) -> Optional[str]:
        """The trace context carried by the last ``get()`` of this request
        (consumed — a second call returns None)."""
        with self._cond:
            return self._popped_traces.pop(req, None)

    def task_done(self) -> None:
        with self._cond:
            self._processing -= 1
            if self._inflight:
                del self._inflight[next(iter(self._inflight))]

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._version += 1
            self._cond.notify_all()

    def empty(self) -> bool:
        """Idle = nothing queued and nothing in flight. Delayed items
        (periodic requeues: culling cadence, scheduler retries) don't count —
        they represent scheduled future work, not outstanding work."""
        with self._cond:
            if self._processing != 0:
                return False
        for sh in self._shards:
            with sh.lock:
                if sh.pending:
                    return False
        return True


class _Controller:
    def __init__(self, mgr: "Manager", reconciler: Reconciler):
        self.mgr = mgr
        self.reconciler = reconciler
        self.name = type(reconciler).__name__
        self.queue = _WorkQueue(self.name)
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()
        self._watchers: List[Any] = []
        self._watchers_lock = threading.Lock()

    def _map_owned(self, obj: Dict[str, Any]) -> List[Request]:
        for_api, for_kind = self.reconciler.FOR
        ref = apimeta.controller_owner_of(obj)
        if ref and ref.get("kind") == for_kind and ref.get("apiVersion") == for_api:
            return [Request(apimeta.namespace_of(obj), ref["name"])]
        return []

    def start(self) -> None:
        store = self.mgr.store
        for_api, for_kind = self.reconciler.FOR
        res = apimeta.REGISTRY.for_kind(for_api, for_kind)
        self._spawn_watch(store, res, lambda o: [Request(apimeta.namespace_of(o), apimeta.name_of(o))])
        for api_version, kind in self.reconciler.OWNS:
            owned = apimeta.REGISTRY.for_kind(api_version, kind)
            self._spawn_watch(store, owned, self._map_owned)
        for (api_version, kind), mapper in self.reconciler.watches():
            wres = apimeta.REGISTRY.for_kind(api_version, kind)
            self._spawn_watch(store, wres, mapper)
        t = threading.Thread(target=self._worker, name=f"{self.name}-worker", daemon=True)
        t.start()
        self._threads.append(t)

    def _spawn_watch(self, store: Store, res, mapper) -> None:
        def pump() -> None:
            # Re-watch loop: in-process watch streams are infinite, but a
            # remote stream ends on apiserver restart, idle socket timeout,
            # or a dropped slow watcher — without reconnection the controller
            # would go permanently deaf. Each (re)connect relists
            # (send_initial=True): level-triggered reconciles make replays
            # harmless, exactly like an informer resync.
            while not self._stopped.is_set():
                try:
                    watcher = store.watch(res, send_initial=True)
                except Exception:
                    log.warning("%s: watch connect failed for %s; retrying", self.name, res.plural)
                    self._stopped.wait(1.0)
                    continue
                with self._watchers_lock:
                    self._watchers.append(watcher)
                # Re-check after registration: stop() may have snapshotted
                # the watcher list between our loop check and the append —
                # without this, a freshly opened remote stream leaks.
                if self._stopped.is_set():
                    watcher.close()
                    with self._watchers_lock:
                        if watcher in self._watchers:
                            self._watchers.remove(watcher)
                    return
                try:
                    for event in watcher:
                        try:
                            # The object's creation traceparent (stamped by
                            # the apiserver) is the causing trace: carry it
                            # through the queue so the reconcile span joins
                            # the client call that made the object.
                            tp = apimeta.annotations_of(event.object).get(
                                TRACEPARENT_ANNOTATION)
                            for req in mapper(event.object) or []:
                                self.queue.add(req, traceparent=tp)
                        except Exception:  # mapper bugs must not kill the pump
                            log.exception("%s: watch mapper failed", self.name)
                except Exception:
                    # a stream that fails mid-read ends like a closed one: a
                    # pump that died here would leave the controller deaf
                    if not self._stopped.is_set():
                        log.warning("%s: watch on %s failed; re-establishing", self.name,
                                    res.plural, exc_info=True)
                finally:
                    with self._watchers_lock:
                        if watcher in self._watchers:
                            self._watchers.remove(watcher)
                if not self._stopped.is_set():
                    log.debug("%s: watch on %s ended; re-establishing", self.name, res.plural)
                    self._stopped.wait(0.2)

        t = threading.Thread(target=pump, name=f"{self.name}-watch-{res.plural}", daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        with self._watchers_lock:
            watchers = list(self._watchers)
        for w in watchers:
            try:
                w.close()
            except Exception:
                pass
        self.queue.shutdown()
        # Join, so no watch or worker thread outlives stop()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    def _worker(self) -> None:
        client = self.mgr.client
        while True:
            req = self.queue.get()
            if req is None:
                return
            start = time.monotonic()
            try:
                with TRACER.span(
                    "reconcile",
                    traceparent=self.queue.trace_of(req),
                    controller=self.name,
                    request=f"{req.namespace or ''}/{req.name}",
                ) as span:
                    result = self.reconciler.reconcile(client, req) or Result()
                    if result.requeue_after > 0:
                        span.set("requeue_after_s", result.requeue_after)
                self.queue.forget(req)
                if result.requeue_after > 0:
                    self.queue.add_after(req, result.requeue_after)
                elif result.requeue:
                    self.queue.add(req)
                METRICS.counter("controller_reconcile_total", controller=self.name, result="success").inc()
            except Exception:
                METRICS.counter("controller_reconcile_total", controller=self.name, result="error").inc()
                log.debug("%s: reconcile %s failed:\n%s", self.name, req, traceback.format_exc())
                self.queue.add_rate_limited(req)
            finally:
                self.queue.task_done()
                METRICS.histogram("controller_reconcile_seconds", controller=self.name).observe(
                    time.monotonic() - start
                )


class Manager:
    """Hosts controllers over one Store; runs the GC sweep the way
    kube-controller-manager would."""

    def __init__(self, store: Optional[Store] = None):
        from .informer import InformerCache  # late import: manager ↛ informer cycle

        self.store = store or Store()
        self.client = Client(self.store)
        self.cache = InformerCache(self.client)
        self._controllers: List[_Controller] = []
        self._started = False
        self._stop = threading.Event()

    def add(self, reconciler: Reconciler) -> "Manager":
        reconciler.cache = self.cache
        self._controllers.append(_Controller(self, reconciler))
        if self._started:
            self._controllers[-1].start()
        return self

    def start(self) -> "Manager":
        from .informer import InformerCache

        if self._started:
            return self
        if self._stop.is_set():
            # Restarting after stop() (a leader-election standby regaining
            # the lease): stopped controllers' queues and watch streams are
            # terminally shut down, so rebuild them around the same
            # reconcilers with a fresh stop event.
            self._stop = threading.Event()
            self._controllers = [_Controller(self, c.reconciler) for c in self._controllers]
            self.cache = InformerCache(self.client)
            for c in self._controllers:
                c.reconciler.cache = self.cache
        self._started = True
        for c in self._controllers:
            c.start()
        self._gc_thread = threading.Thread(target=self._gc_loop, name="garbage-collector", daemon=True)
        self._gc_thread.start()
        return self

    def _gc_loop(self) -> None:
        while not self._stop.wait(0.05):
            try:
                self.store.collect_garbage()
            except Exception:
                log.exception("gc sweep failed")

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        self._stop.set()
        for c in self._controllers:
            c.stop()
        self.cache.stop()
        gc_thread = getattr(self, "_gc_thread", None)
        if gc_thread is not None:
            gc_thread.join(timeout=2.0)

    def wait_idle(self, timeout: float = 10.0, settle: float = 0.15) -> bool:
        """Block until all queues drain and stay drained for ``settle`` seconds.

        Test helper — the envtest analog of 'eventually consistent'.
        """
        deadline = time.monotonic() + timeout
        quiet_since = None
        while time.monotonic() < deadline:
            if all(c.queue.empty() for c in self._controllers):
                if quiet_since is None:
                    quiet_since = time.monotonic()
                elif time.monotonic() - quiet_since >= settle:
                    return True
            else:
                quiet_since = None
            time.sleep(0.01)
        return False
