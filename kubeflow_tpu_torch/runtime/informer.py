"""Shared informers: watch-backed cached listers for reconcile hot paths.

A copy of ``kubeflow_tpu/runtime/informer.py``. ``SharedInformer`` keeps a
local mirror of one (apiVersion, kind) fed by one watch stream
(``send_initial=True`` doubles as the initial list). A lost stream resumes
from the last resourceVersion it saw; a ``410 Expired`` resume (the
window compacted away) falls back to a paginated relist that fires
synthetic DELETED events for what vanished. ``stop`` closes the stream
and joins the pump thread. ``InformerCache`` builds one informer per kind
on first use and serves client-shaped ``list``/``get`` from memory.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import meta as apimeta
from ..apiserver.client import Client
from ..apiserver.store import Expired
from .metrics import METRICS
from .tracing import TRACER

log = logging.getLogger("kubeflow_tpu_torch.informer")


def _matches(labels: Dict[str, str], selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


class SharedInformer:
    """One watch stream → one in-memory mirror of a collection.

    Thread-safe; many consumers share one informer (hence "shared"). Event
    handlers (``on_event(type, obj)``) fire on the watch thread after the
    cache is updated.
    """

    def __init__(self, client: Client, api_version: str, kind: str):
        self.client = client
        self.api_version = api_version
        self.kind = kind
        self._items: Dict[Tuple[Optional[str], str], Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._synced = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._handlers: List[Callable[[str, Dict[str, Any]], None]] = []
        # Secondary indexes (client-go Indexer shape): scanning the whole
        # mirror per reconcile is still O(collection). name -> key_fn(obj)
        # -> [keys].
        self._index_fns: Dict[str, Callable[[Dict[str, Any]], List[str]]] = {}
        self._indexes: Dict[str, Dict[str, Dict[Tuple[Optional[str], str], Dict[str, Any]]]] = {}
        self._item_keys: Dict[Tuple[Optional[str], str], Dict[str, List[str]]] = {}
        # Highest store resourceVersion this mirror reflects: bumped by every
        # event's object RV and jumped to the snapshot RV at each SYNC
        # marker. wait_rv() is the read-your-writes barrier built on it.
        self._rv_cond = threading.Condition()
        self._last_rv = 0
        self._last_sync_mono: Optional[float] = None
        self._warned_malformed_rv = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SharedInformer":
        if self._thread is not None:
            return self
        # Staleness is the informer failure mode operators actually hit — a
        # wedged watch serves reads forever without erroring. Scrape-time
        # collector so the age keeps growing between syncs; keyed per kind
        # so a replacement informer takes over the series.
        METRICS.register_collector(f"informer_{self.kind}", self._collect)
        self._thread = threading.Thread(
            target=self._pump, name=f"informer-{self.kind}", daemon=True
        )
        self._thread.start()
        return self

    def _collect(self) -> None:
        last = self._last_sync_mono
        if last is not None:
            METRICS.gauge("informer_last_sync_age_seconds", kind=self.kind).set(
                time.monotonic() - last
            )

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            watcher = getattr(self, "_watcher", None)
        if watcher is not None:
            try:
                watcher.close()
            except Exception:
                pass
        # Join the pump, so no thread outlives stop()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)

    def wait_synced(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def wait_rv(self, rv: int, timeout: float = 10.0) -> bool:
        """Block until the mirror reflects store resourceVersion >= rv — a
        read-your-writes barrier (K8s resourceVersionMatch=NotOlderThan).
        Only meaningful for an rv produced by a write to THIS kind (or any
        rv ≤ a sync snapshot): the informer never observes other kinds'
        RVs, so a foreign rv may only resolve at the next reconnect."""
        with self._rv_cond:
            return self._rv_cond.wait_for(lambda: self._last_rv >= rv, timeout)

    def _note_rv(self, rv_str: Any) -> None:
        try:
            rv = int(rv_str)
        except (TypeError, ValueError):
            # A malformed RV quietly disables the wait_rv() barrier for this
            # write — readers fall back to sync timeouts. Count every one,
            # log once per informer so a misbehaving backend is visible
            # without flooding.
            METRICS.counter("informer_malformed_rv_total", kind=self.kind).inc()
            if not self._warned_malformed_rv:
                self._warned_malformed_rv = True
                log.warning(
                    "informer %s: malformed resourceVersion %r; "
                    "read-your-writes barrier degraded for such events",
                    self.kind,
                    rv_str,
                )
            return
        with self._rv_cond:
            if rv > self._last_rv:
                self._last_rv = rv
                self._rv_cond.notify_all()

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    def add_event_handler(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        self._handlers.append(fn)

    # -- secondary indexes ----------------------------------------------------
    def add_index(self, name: str, key_fn: Callable[[Dict[str, Any]], List[str]]) -> None:
        """Register (idempotently) an index; existing items are back-filled."""
        with self._lock:
            if name in self._index_fns:
                return
            self._index_fns[name] = key_fn
            self._indexes[name] = {}
            for item_key, obj in self._items.items():
                self._index_add(name, item_key, obj)

    def by_index(self, name: str, key: str) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._indexes.get(name, {}).get(key, {}).values())

    def _index_add(self, name: str, item_key, obj: Dict[str, Any]) -> None:
        try:
            keys = list(self._index_fns[name](obj) or [])
        except Exception:
            log.exception("informer %s: index %s key_fn failed", self.kind, name)
            keys = []
        for k in keys:
            self._indexes[name].setdefault(k, {})[item_key] = obj
        self._item_keys.setdefault(item_key, {})[name] = keys

    def _index_remove(self, item_key) -> None:
        for name, keys in self._item_keys.pop(item_key, {}).items():
            for k in keys:
                bucket = self._indexes[name].get(k)
                if bucket is not None:
                    bucket.pop(item_key, None)
                    if not bucket:
                        del self._indexes[name][k]

    def _apply(self, event_type: str, item_key, obj: Dict[str, Any]) -> None:
        """Cache + index update; caller holds the lock."""
        self._index_remove(item_key)
        if event_type == "DELETED":
            self._items.pop(item_key, None)
        else:
            self._items[item_key] = obj
            for name in self._index_fns:
                self._index_add(name, item_key, obj)

    # -- reads (in-memory, no apiserver round-trip) ---------------------------
    def list(
        self,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                obj
                for (ns, _name), obj in self._items.items()
                if (namespace is None or ns == namespace)
                and _matches(apimeta.labels_of(obj), label_selector)
            ]

    def get(self, name: str, namespace: Optional[str] = None) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._items.get((namespace, name))

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    # -- the pump ------------------------------------------------------------
    def _relist(self) -> None:
        """Recover from a compacted watch window (410 Gone): rebuild the
        mirror through the PAGINATED list path — a storm of relisting
        informers must not each issue one giant unbounded LIST — firing
        synthetic DELETED for vanished keys and ADDED/MODIFIED for the rest,
        then resume watching from the snapshot RV."""
        items, rv = self.client.list_paged(self.api_version, self.kind)
        with self._lock:
            fresh = {
                (apimeta.namespace_of(o), apimeta.name_of(o)): o for o in items
            }
            vanished = [
                (k, self._items[k]) for k in list(self._items) if k not in fresh
            ]
            for key, old in vanished:
                self._apply("DELETED", key, old)
            arrived = []
            for key, obj in fresh.items():
                arrived.append(("MODIFIED" if key in self._items else "ADDED", obj))
                self._apply("MODIFIED", key, obj)
        self._note_rv(rv)
        self._last_sync_mono = time.monotonic()
        self._synced.set()
        for _key, old in vanished:
            METRICS.counter("informer_events_total", kind=self.kind, type="DELETED").inc()
            self._dispatch("DELETED", old)
        for type_, obj in arrived:
            METRICS.counter("informer_events_total", kind=self.kind, type=type_).inc()
            self._dispatch(type_, obj)

    def _pump(self) -> None:
        while not self._stopped.is_set():
            # Resume from the last seen RV when we have one: reconnects replay
            # only the missed window (watch cache / journal) instead of
            # re-listing the world. A compacted window (Expired, 410) falls
            # back to the paginated relist. Read under _rv_cond — _note_rv
            # publishes under it, and a stale resume point replays (or with
            # a torn read, skips) part of the window.
            with self._rv_cond:
                resume_rv = self._last_rv
            # a never-synced mirror may be mid-initial-list: resume could
            # permanently miss the unapplied remainder — relist instead
            initial = resume_rv <= 0 or not self._synced.is_set()
            try:
                if initial:
                    watcher = self.client.watch(
                        self.api_version, self.kind, send_initial=True, sync_marker=True
                    )
                else:
                    watcher = self.client.watch(
                        self.api_version, self.kind, since_rv=resume_rv, sync_marker=True
                    )
            except Expired as e:
                log.warning("informer %s: watch window expired (%s); relisting", self.kind, e)
                METRICS.counter("informer_relists_total", kind=self.kind).inc()
                try:
                    # Detached: a relist re-syncs the world for every
                    # consumer; its paginated LISTs must not inherit (and
                    # bill their latency to) whatever request's trace
                    # happens to be current on this thread.
                    with TRACER.detached():
                        self._relist()
                except Exception as e2:
                    log.warning("informer %s: relist failed: %s", self.kind, e2)
                    METRICS.counter("informer_watch_reconnects_total", kind=self.kind).inc()
                    self._stopped.wait(1.0)
                continue
            except Exception as e:
                log.warning("informer %s: watch connect failed: %s", self.kind, e)
                METRICS.counter("informer_watch_reconnects_total", kind=self.kind).inc()
                self._stopped.wait(1.0)
                continue
            with self._lock:
                self._watcher = watcher
            # Re-check after publishing: a stop() that landed while this
            # watch was opening closed the previous stream (or none), never
            # this one, and a remote stream's heartbeats would keep the
            # loop below from ever returning to the check above.
            if self._stopped.is_set():
                watcher.close()
                return
            # Relist semantics: the initial ADDED burst overlays the old
            # mirror (no empty-cache window); at the SYNC boundary, every
            # cached key NOT re-sent vanished while we were disconnected —
            # fire synthetic DELETED so handler-maintained state (gauge
            # indexes etc.) can't go stale. client-go emits deletes on
            # relist for exactly this reason. Vanished-key detection is only
            # sound when the stream carried a FULL initial list; an RV-resume
            # stream replays deltas, where absence means "unchanged".
            seen: set = set()
            syncing = True
            try:
                for event in watcher:
                    if event.type == "SYNC":
                        syncing = False
                        vanished = []
                        if initial:
                            with self._lock:
                                vanished = [
                                    (k, self._items[k]) for k in list(self._items) if k not in seen
                                ]
                                for key, old in vanished:
                                    self._apply("DELETED", key, old)
                        self._note_rv((event.object or {}).get("resourceVersion"))
                        self._last_sync_mono = time.monotonic()
                        self._synced.set()
                        for _key, old in vanished:
                            self._dispatch("DELETED", old)
                        continue
                    obj = event.object
                    METRICS.counter(
                        "informer_events_total", kind=self.kind, type=event.type
                    ).inc()
                    key = (apimeta.namespace_of(obj), apimeta.name_of(obj))
                    if syncing:
                        seen.add(key)
                    with self._lock:
                        self._apply(event.type, key, obj)
                    self._note_rv(obj.get("metadata", {}).get("resourceVersion"))
                    self._dispatch(event.type, obj)
            except Exception as e:
                log.warning("informer %s: watch stream error: %s", self.kind, e)
            if not self._stopped.is_set():
                METRICS.counter("informer_watch_reconnects_total", kind=self.kind).inc()
                self._stopped.wait(0.2)

    def _dispatch(self, event_type: str, obj: Dict[str, Any]) -> None:
        for fn in self._handlers:
            try:
                fn(event_type, obj)
            except Exception:
                METRICS.counter("informer_handler_failures_total", kind=self.kind).inc()
                log.exception("informer %s: handler failed", self.kind)


class InformerCache:
    """Lazily-started shared informers keyed by (apiVersion, kind) —
    the read side of a controller-runtime manager's cache."""

    def __init__(self, client: Client):
        self.client = client
        self._informers: Dict[Tuple[str, str], SharedInformer] = {}
        self._lock = threading.Lock()

    def informer_for(self, api_version: str, kind: str) -> SharedInformer:
        key = (api_version, kind)
        with self._lock:
            inf = self._informers.get(key)
            if inf is None:
                inf = SharedInformer(self.client, api_version, kind)
                self._informers[key] = inf
                inf.start()
        return inf

    def list(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        sync_timeout: float = 10.0,
        min_rv: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """``min_rv`` is a read-your-writes barrier: wait until the mirror
        reflects that store RV (pass the RV returned by your own write to
        the same kind). On barrier/sync timeout, degrade to a direct list —
        a live read is always fresh enough."""
        inf = self.informer_for(api_version, kind)
        if not inf.wait_synced(sync_timeout) or (
            min_rv is not None and not inf.wait_rv(min_rv, sync_timeout)
        ):
            # Degrade to a direct list rather than serving a stale/empty cache.
            log.warning("informer %s/%s: sync/rv timeout; direct list", api_version, kind)
            return self.client.list(api_version, kind, namespace, label_selector=label_selector)
        return inf.list(namespace, label_selector)

    def get(
        self, api_version: str, kind: str, name: str, namespace: Optional[str] = None,
        sync_timeout: float = 10.0,
    ) -> Optional[Dict[str, Any]]:
        inf = self.informer_for(api_version, kind)
        if not inf.wait_synced(sync_timeout):
            return self.client.get_opt(api_version, kind, name, namespace)
        return inf.get(name, namespace)

    def stop(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                inf.stop()
            self._informers.clear()
