"""In-process API storage: an MVCC object store with watch streams.

A trimmed copy of ``kubeflow_tpu/apiserver/store.py``, the platform's
etcd-and-apiserver analog. Every object lives under a
``group/version/plural`` bucket keyed by ``(namespace, name)``; one
monotonically increasing resourceVersion stamps each write; watchers get
ADDED/MODIFIED/DELETED events through bounded queues. Deletion honours
finalizers as Kubernetes does (``deletionTimestamp`` first, the delete when
the last finalizer goes), status writes merge only ``.status``, admission
hooks run before a write persists, and ``collect_garbage`` cascades
ownerReferences.

The port stores through ``DictBackend`` only (``backend.py``). A watch
resumes from a resourceVersion through the watch-cache ring; a
resourceVersion the ring has compacted away is ``410 Expired`` and the
client relists, as against an etcd watch window.
"""

from __future__ import annotations

import base64
import collections
import fnmatch
import json
import queue
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import conversion
from ..api import meta as apimeta
from ..api.meta import REGISTRY, Resource
from ..runtime.metrics import METRICS
from .backend import DictBackend


def _to_hub(obj: Dict[str, Any]) -> Tuple[Resource, Dict[str, Any]]:
    """Resolve an object's Resource, routing spoke versions to the storage
    hub — a spoke-stamped object must never land in a spoke bucket where hub
    controllers and the REST surface would not see it (split-brain)."""
    res = REGISTRY.for_object(obj)
    hub = conversion.hub_resource(res)
    if hub is not res:
        obj = conversion.convert(obj, res.group, res.kind, hub.version)
        res = hub
    return res, obj


class ApiError(Exception):
    code = 500
    reason = "InternalError"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def to_status(self) -> Dict[str, Any]:
        return {
            "apiVersion": "v1",
            "kind": "Status",
            "status": "Failure",
            "code": self.code,
            "reason": self.reason,
            "message": self.message,
        }


class NotFound(ApiError, LookupError):
    """404. Also a ``LookupError``: the port's ``EventRecorder`` treats a
    vanished aggregated Event as one, whatever client it writes through."""

    code = 404
    reason = "NotFound"


class Conflict(ApiError):
    code = 409
    reason = "Conflict"


class Invalid(ApiError):
    code = 422
    reason = "Invalid"


class Forbidden(ApiError):
    code = 403
    reason = "Forbidden"


class Expired(ApiError):
    code = 410
    reason = "Expired"


class TooManyRequests(ApiError):
    """429: the fairness layer shed this request. ``retry_after_s`` carries
    the server's Retry-After so clients can honor it instead of guessing."""

    code = 429
    reason = "TooManyRequests"

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ServiceUnavailable(ApiError):
    """503: transient server-side overload/outage — retryable, unlike the
    fatal 4xx family."""

    code = 503
    reason = "ServiceUnavailable"

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Dict[str, Any]


# Admission hook signature: (operation, resource, obj) -> mutated obj (or raise
# ApiError to reject). operation in {"CREATE", "UPDATE", "DELETE"}.
AdmissionHook = Callable[[str, Resource, Dict[str, Any]], Dict[str, Any]]


class _Watcher:
    def __init__(self, key: str, namespace: Optional[str], selector: Optional[Dict[str, str]]):
        self.key = key
        self.namespace = namespace
        self.selector = selector
        # LIVE events only. Sized for a 1k-notebook churn wave (~2k pods ×
        # several writes each): overflow closes the watcher and forces a
        # full relist, so drops must be rare, not routine.
        self.queue: "queue.Queue[Optional[WatchEvent]]" = queue.Queue(maxsize=16384)
        # Initial-list / ring-replay events: unbounded, drained before the
        # live queue. These MUST NOT count against the slow-watcher drop
        # policy — a collection larger than the queue bound would otherwise
        # close every watcher mid-relist and informers could never sync.
        # Contract: replay/initial delivery is COMPLETE (etcd streams the
        # whole watch window; a K8s initial list is never truncated); only
        # live events are subject to the bounded-queue drop-close policy.
        # Consumers must read through next_event()/iteration, never
        # self.queue directly, or preloaded events are silently skipped.
        self._preload: "collections.deque[WatchEvent]" = collections.deque()
        self.closed = False

    def preload(self, event: WatchEvent) -> None:
        self._preload.append(event)

    def next_event(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Next event: preloaded (initial list / ring replay) first, then
        live. Returns None at end-of-stream; raises queue.Empty on timeout.
        This is the ONLY correct read path — the REST streaming handler and
        __iter__ both go through it: reading .queue directly skips every
        preloaded event, so remote informers would sync empty caches and
        RV-resume watches would hang."""
        if self._preload:
            return self._preload.popleft()
        return self.queue.get(timeout=timeout)

    def matches(self, res_key: str, obj: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatch(res_key, self.key):
            return False
        if self.namespace is not None and apimeta.namespace_of(obj) != self.namespace:
            return False
        if self.selector:
            labels = apimeta.labels_of(obj)
            if any(labels.get(k) != v for k, v in self.selector.items()):
                return False
        return True

    def send(self, event: WatchEvent) -> None:
        if self.closed:
            return
        try:
            self.queue.put_nowait(event)
        except queue.Full:
            # Slow watcher: drop it rather than block the write path; informers
            # relist on close, same as an expired etcd watch window.
            self.close()

    def close(self) -> None:
        self.closed = True
        # The end-of-stream sentinel must ALWAYS arrive, or `for e in w`
        # blocks forever after draining — evict events until it fits (the
        # consumer is relisting anyway once it sees the stream closed).
        while True:
            try:
                self.queue.put_nowait(None)
                return
            except queue.Full:
                try:
                    self.queue.get_nowait()
                except queue.Empty:
                    pass

    def __iter__(self):
        while True:
            item = self.next_event()
            if item is None:
                return
            yield item


#: default watch-cache ring length — sized to ride out a 1k-notebook churn
#: wave between informer reconnects; override per Store for tests.
WATCH_CACHE_SIZE = 4096

#: LIST continue-token snapshots: how many concurrent paginated LISTs may be
#: in flight, and how long an abandoned one is kept before its token expires.
PAGE_SNAPSHOT_CAP = 64
PAGE_SNAPSHOT_TTL_S = 60.0


class Store:
    def __init__(self, backend=None, watch_cache_size: int = WATCH_CACHE_SIZE) -> None:
        self._lock = threading.RLock()
        self.backend = backend if backend is not None else DictBackend()
        self._watchers: List[_Watcher] = []
        self._admission: List[AdmissionHook] = []
        # Watch cache (etcd watch-window analog, backend-independent): a
        # bounded ring of (rv, res_key, type, obj) fed by _notify. A watch
        # with since_rv replays from the ring when it still covers that RV;
        # compaction past it surfaces 410 Expired so the client relists.
        # Size 0 disables the ring (no since_rv resumes, see watch()).
        self._wc_size = max(0, int(watch_cache_size))
        self._wc_events: "collections.deque[Tuple[int, str, str, Dict[str, Any]]]" = (
            collections.deque())
        # Highest RV compacted out of the ring. Seeded with the backend's
        # current RV: history a pre-populated backend holds is not in the
        # ring, so resuming inside it is 410.
        self._wc_trimmed_rv = self.backend.current_rv()
        # Per-bucket object mirror serving send_initial watches without a
        # backend read per client (the watch-storm amplification fix).
        # Lazily built on first use, then maintained inline by _notify.
        self._wc_mirror: Dict[str, Dict[Tuple[Optional[str], str], Dict[str, Any]]] = {}
        # LIST pagination snapshots: token id -> (expires_mono, rv, items).
        self._page_snaps: "collections.OrderedDict[str, Tuple[float, int, List[Dict[str, Any]]]]" = (
            collections.OrderedDict())
        # GC ownership index, maintained at write time so a sweep never has
        # to decode the whole store (the old full-scan sweep at 20Hz was the
        # top cost in the 500-notebook loadtest profile):
        #   uid -> (res_key, name, namespace) for every live object,
        #   uid -> [owner uids] only for objects that HAVE ownerReferences.
        # _gc_dirty gates sweeps: set on any delete (may orphan children)
        # and on creates/updates that carry ownerReferences.
        self._gc_uids: Dict[str, Tuple[str, str, Optional[str]]] = {}
        self._gc_owners: Dict[str, List[str]] = {}
        self._gc_dirty = True
        self._gc_index_built = False

    # -- GC index maintenance (caller holds the lock) ------------------------
    def _gc_track(self, res: Resource, obj: Dict[str, Any]) -> None:
        md = obj.get("metadata", {})
        uid = md.get("uid")
        if not uid:
            return
        self._gc_uids[uid] = (res.key, md.get("name", ""), md.get("namespace"))
        refs = [r.get("uid") for r in (md.get("ownerReferences") or []) if r.get("uid")]
        if refs:
            self._gc_owners[uid] = refs
            self._gc_dirty = True
        else:
            self._gc_owners.pop(uid, None)

    def _gc_untrack(self, obj: Dict[str, Any]) -> None:
        uid = obj.get("metadata", {}).get("uid")
        if uid:
            self._gc_uids.pop(uid, None)
            self._gc_owners.pop(uid, None)
        self._gc_dirty = True

    def _gc_rebuild(self) -> None:
        """One full decode at startup for pre-populated (persistent) backends."""
        self._gc_uids.clear()
        self._gc_owners.clear()
        for res_key, obj in self.backend.list_all():
            res = next((r for r in REGISTRY.all() if r.key == res_key), None)
            if res is not None:
                self._gc_track(res, obj)
        self._gc_index_built = True
        self._gc_dirty = True

    # -- admission ----------------------------------------------------------
    def register_admission(self, hook: AdmissionHook) -> None:
        self._admission.append(hook)

    def _admit(self, op: str, res: Resource, obj: Dict[str, Any]) -> Dict[str, Any]:
        for hook in self._admission:
            obj = hook(op, res, obj)
        return obj

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _obj_key(res: Resource, namespace: Optional[str], name: str) -> Tuple[str, str]:
        return (namespace or "") if res.namespaced else "", name

    def _notify(self, res: Resource, event: WatchEvent) -> None:
        obj = event.object
        self._wc_record(res, event.type, obj)
        for w in list(self._watchers):
            if w.closed:
                self._watchers.remove(w)
                continue
            if w.matches(res.key, obj):
                w.send(WatchEvent(event.type, apimeta.deepcopy(obj)))

    # -- watch cache (caller holds the lock) ---------------------------------
    def _wc_record(self, res: Resource, type_: str, obj: Dict[str, Any]) -> None:
        snap = apimeta.deepcopy(obj)
        mirror = self._wc_mirror.get(res.key)
        if mirror is not None:
            mkey = (apimeta.namespace_of(snap), apimeta.name_of(snap))
            if type_ == "DELETED":
                mirror.pop(mkey, None)
            else:
                mirror[mkey] = snap
        if self._wc_size <= 0:
            return
        try:
            rv = int(snap.get("metadata", {}).get("resourceVersion"))
        except (TypeError, ValueError):
            return  # un-versioned event: not replayable, skip the ring
        self._wc_events.append((rv, res.key, type_, snap))
        while len(self._wc_events) > self._wc_size:
            self._wc_trimmed_rv = self._wc_events.popleft()[0]

    def _wc_initial(self, res: Resource) -> List[Dict[str, Any]]:
        """Current bucket contents from the mirror (built once per bucket via
        a single backend read, maintained by _notify thereafter) — a watch
        storm of send_initial clients costs zero backend list reads."""
        mirror = self._wc_mirror.get(res.key)
        if mirror is None:
            mirror = {}
            for obj in self.backend.list(res.key, None, None):
                mirror[(apimeta.namespace_of(obj), apimeta.name_of(obj))] = (
                    apimeta.deepcopy(obj))
            self._wc_mirror[res.key] = mirror
        return list(mirror.values())

    @staticmethod
    def now() -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

    # -- CRUD ---------------------------------------------------------------
    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        res, obj = _to_hub(obj)
        obj = apimeta.deepcopy(obj)
        md = obj.setdefault("metadata", {})
        name = md.get("name") or ""
        if not name and md.get("generateName"):
            name = md["generateName"] + uuid.uuid4().hex[:6]
            md["name"] = name
        if not name:
            raise Invalid(f"{res.kind}: metadata.name required")
        if res.namespaced and not md.get("namespace"):
            raise Invalid(f"{res.kind} {name}: metadata.namespace required")
        obj = self._admit("CREATE", res, obj)
        md = obj.setdefault("metadata", {})  # hooks may return a fresh copy
        with self._lock:
            ns, name = self._obj_key(res, md.get("namespace"), name)
            if self.backend.contains(res.key, ns, name):
                where = f"{ns}/{name}" if ns else name
                raise Conflict(f"{res.kind} {where} already exists")
            md["uid"] = md.get("uid") or str(uuid.uuid4())
            md["creationTimestamp"] = self.now()
            rv = self.backend.next_rv()
            md["resourceVersion"] = str(rv)
            md.setdefault("generation", 1)
            self.backend.put(res.key, ns, name, obj, rv, "ADDED")
            self._gc_track(res, obj)
            self._notify(res, WatchEvent("ADDED", obj))
            return apimeta.deepcopy(obj)

    def get(self, res: Resource, name: str, namespace: Optional[str] = None) -> Dict[str, Any]:
        res = conversion.hub_resource(res)
        with self._lock:
            ns, name = self._obj_key(res, namespace, name)
            obj = self.backend.get(res.key, ns, name)
            if obj is None:
                where = f" in {namespace}" if res.namespaced else ""
                raise NotFound(f'{res.kind} "{name}" not found{where}')
            return obj

    def list(
        self,
        res: Resource,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        field_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        return self.list_with_rv(res, namespace, label_selector, field_selector)[0]

    def list_with_rv(
        self,
        res: Resource,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        field_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Dict[str, Any]], int]:
        """Snapshot list plus the store resourceVersion AT the snapshot.

        The RV is read under the same lock as the list so a client doing
        list→watch(resourceVersion=<list RV>) observes every write that lands
        after the snapshot (etcd returns the revision atomically with a range
        read for the same reason). Reading ``backend.current_rv()`` after the
        lock is released would open a gap in which writes are permanently
        missed by the informer pattern.
        """
        res = conversion.hub_resource(res)
        with self._lock:
            # every read that reaches the backing store — the counter the
            # scale harness watches to prove watch storms stay in the cache
            METRICS.counter("apiserver_store_list_total", resource=res.plural).inc()
            ns = namespace if (res.namespaced and namespace is not None) else None
            out = self.backend.list(res.key, ns, label_selector)
            rv = self.backend.current_rv()
            if field_selector:
                out = [o for o in out if _match_fields(o, field_selector)]
            return out, rv

    def list_page(
        self,
        res: Resource,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        field_selector: Optional[Dict[str, str]] = None,
        limit: Optional[int] = None,
        continue_token: Optional[str] = None,
    ) -> Tuple[List[Dict[str, Any]], int, Optional[str]]:
        """Paginated LIST pinned to a consistent resourceVersion snapshot.

        Page 1 takes one store snapshot (items + RV atomically, like
        list_with_rv) and parks it under an opaque continue token;
        continuation pages serve slices of that parked snapshot, so every
        page reflects the SAME RV no matter how much the store moved in
        between. Tokens are bounded (PAGE_SNAPSHOT_CAP) and expire
        (PAGE_SNAPSHOT_TTL_S); a stale/garbled token raises Expired (410
        ``Expired`` — K8s "continue token is too old"), telling the client
        to restart the list from scratch.
        """
        with self._lock:
            now = time.monotonic()
            for tid in [t for t, (exp, _, _) in self._page_snaps.items() if exp < now]:
                del self._page_snaps[tid]
            if continue_token:
                try:
                    tok = json.loads(base64.urlsafe_b64decode(
                        continue_token.encode()).decode())
                    tid, off = str(tok["id"]), int(tok["off"])
                except (ValueError, KeyError, TypeError):
                    raise Expired("malformed continue token; restart the list") from None
                snap = self._page_snaps.get(tid)
                if snap is None:
                    raise Expired(
                        "the provided continue token has expired; restart the list")
                _, rv, items = snap
            else:
                items, rv = self.list_with_rv(
                    res, namespace, label_selector, field_selector)
                tid, off = uuid.uuid4().hex[:16], 0
            if limit is None or off + limit >= len(items):
                if continue_token:
                    self._page_snaps.pop(tid, None)  # fully consumed
                return [apimeta.deepcopy(o) for o in items[off:]], rv, None
            if not continue_token:
                self._page_snaps[tid] = (now + PAGE_SNAPSHOT_TTL_S, rv, items)
                while len(self._page_snaps) > PAGE_SNAPSHOT_CAP:
                    self._page_snaps.popitem(last=False)
            next_token = base64.urlsafe_b64encode(
                json.dumps({"id": tid, "off": off + limit}).encode()).decode()
            return [apimeta.deepcopy(o) for o in items[off:off + limit]], rv, next_token

    def update(self, obj: Dict[str, Any], subresource: Optional[str] = None) -> Dict[str, Any]:
        res, obj = _to_hub(obj)
        obj = apimeta.deepcopy(obj)
        md = obj.setdefault("metadata", {})
        with self._lock:
            ns, name = self._obj_key(res, md.get("namespace"), md.get("name", ""))
            current = self.backend.get(res.key, ns, name)
            if current is None:
                raise NotFound(f'{res.kind} "{md.get("name")}" not found')
            cur_md = current["metadata"]
            if md.get("resourceVersion") and md["resourceVersion"] != cur_md["resourceVersion"]:
                raise Conflict(
                    f"{res.kind} {md.get('name')}: resourceVersion mismatch "
                    f"({md['resourceVersion']} != {cur_md['resourceVersion']})"
                )
            if subresource == "status":
                # Status updates only replace .status.
                merged = apimeta.deepcopy(current)
                merged["status"] = obj.get("status", {})
                obj = merged
                md = obj["metadata"]
            else:
                obj = self._admit("UPDATE", res, obj)
                md = obj.setdefault("metadata", {})
                # Immutable fields survive.
                md["uid"] = cur_md["uid"]
                md["creationTimestamp"] = cur_md["creationTimestamp"]
                if cur_md.get("deletionTimestamp"):
                    md["deletionTimestamp"] = cur_md["deletionTimestamp"]
                if _spec_changed(current, obj):
                    md["generation"] = cur_md.get("generation", 1) + 1
                else:
                    md["generation"] = cur_md.get("generation", 1)
            # No-op writes neither bump resourceVersion nor notify — without
            # this, a controller that unconditionally writes status would
            # requeue itself forever (controllers in the reference rely on
            # apiserver-side semantic no-op detection the same way).
            if _equal_ignoring_rv(current, obj):
                return current
            rv = self.backend.next_rv()
            md["resourceVersion"] = str(rv)
            self.backend.put(res.key, ns, name, obj, rv, "MODIFIED")
            self._gc_track(res, obj)
            self._notify(res, WatchEvent("MODIFIED", obj))
            # Finalizer removal on a deleting object completes the delete.
            if md.get("deletionTimestamp") and not md.get("finalizers"):
                drv = self.backend.next_rv()
                # DELETED events carry the deletion RV (etcd tombstone mod
                # revision) so watch consumers can order them against the
                # global RV stream — informer read-your-writes depends on it.
                md["resourceVersion"] = str(drv)
                self.backend.delete(res.key, ns, name, obj, drv)
                self._gc_untrack(obj)
                self._notify(res, WatchEvent("DELETED", obj))
            return apimeta.deepcopy(obj)

    def update_status(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self.update(obj, subresource="status")

    def patch(
        self,
        res: Resource,
        name: str,
        patch: Dict[str, Any],
        namespace: Optional[str] = None,
    ) -> Dict[str, Any]:
        """RFC 7386 JSON merge patch (null deletes a key)."""
        with self._lock:
            current = self.get(res, name, namespace)
            merged = _merge_patch(current, patch)
            merged["metadata"]["resourceVersion"] = current["metadata"]["resourceVersion"]
            return self.update(merged)

    def delete(self, res: Resource, name: str, namespace: Optional[str] = None) -> Dict[str, Any]:
        res = conversion.hub_resource(res)
        with self._lock:
            ns, name = self._obj_key(res, namespace, name)
            obj = self.backend.get(res.key, ns, name)
            if obj is None:
                where = f" in {namespace}" if res.namespaced else ""
                raise NotFound(f'{res.kind} "{name}" not found{where}')
            md = obj["metadata"]
            if md.get("finalizers"):
                if not md.get("deletionTimestamp"):
                    md["deletionTimestamp"] = self.now()
                    rv = self.backend.next_rv()
                    md["resourceVersion"] = str(rv)
                    self.backend.put(res.key, ns, name, obj, rv, "MODIFIED")
                    self._notify(res, WatchEvent("MODIFIED", obj))
                return apimeta.deepcopy(obj)
            drv = self.backend.next_rv()
            md["resourceVersion"] = str(drv)  # tombstone RV, see update()
            self.backend.delete(res.key, ns, name, obj, drv)
            self._gc_untrack(obj)
            self._notify(res, WatchEvent("DELETED", obj))
            return apimeta.deepcopy(obj)

    def delete_collection(
        self, res: Resource, namespace: Optional[str] = None, label_selector: Optional[Dict[str, str]] = None
    ) -> int:
        n = 0
        for obj in self.list(res, namespace=namespace, label_selector=label_selector):
            try:
                self.delete(res, apimeta.name_of(obj), apimeta.namespace_of(obj))
                n += 1
            except NotFound:
                pass
        return n

    # -- watch --------------------------------------------------------------
    def watch(
        self,
        res: Optional[Resource] = None,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        send_initial: bool = False,
        since_rv: Optional[int] = None,
        sync_marker: bool = False,
    ) -> _Watcher:
        """Open a watch stream. ``since_rv`` replays history from the bounded
        watch-cache ring before going live (etcd watch-window semantics);
        an RV the ring has compacted raises Expired (410 "too old resource
        version") and the caller relists. ``watch_cache_size=0`` disables
        the ring, and then ``since_rv`` is refused (Invalid): the port's
        backend keeps no journal to fall back to.

        ``sync_marker`` appends a ``SYNC`` event (empty object) after the
        initial-list/replay burst and before any live event. Informers use
        the marker as the relist boundary: everything cached that was NOT
        re-sent before SYNC vanished while disconnected, so synthetic
        DELETED events can fire (client-go emits deletes on relist for the
        same reason)."""
        if res is not None:
            res = conversion.hub_resource(res)
        key = res.key if res else "*"
        w = _Watcher(key, namespace, label_selector)
        with self._lock:
            if since_rv is not None:
                if self._wc_size <= 0:
                    raise Invalid("the watch cache is off; watch without since_rv")
                if since_rv < self._wc_trimmed_rv:
                    raise Expired(
                        f"too old resource version: {since_rv} "
                        f"(oldest retained: {self._wc_trimmed_rv})")
                for rv, res_key, type_, obj in self._wc_events:
                    if rv > since_rv and w.matches(res_key, obj):
                        w.preload(WatchEvent(type_, apimeta.deepcopy(obj)))
            elif send_initial and res is not None:
                for obj in self._wc_initial(res):
                    if w.matches(res.key, obj):
                        w.preload(WatchEvent("ADDED", apimeta.deepcopy(obj)))
            if sync_marker:
                # The marker carries the store RV at the snapshot: informers
                # use it to jump their seen-RV to "current" on (re)connect,
                # making min-RV read barriers resolve immediately after sync.
                w.preload(
                    WatchEvent("SYNC", {"resourceVersion": str(self.backend.current_rv())})
                )
            self._watchers.append(w)
        return w

    # -- garbage collection (ownerReference cascade) ------------------------
    def collect_garbage(self) -> int:
        """Delete objects whose controller owner is gone (one sweep).

        Kubernetes runs this in kube-controller-manager; here it is invoked by
        the manager loop so e2e deletes cascade (Notebook → StatefulSet → Pod).
        Sweeps read the write-time ownership index — no store decode — and
        no-op entirely unless a write since the last sweep could have
        orphaned something (``_gc_dirty``).
        """
        deleted = 0
        with self._lock:
            if not self._gc_index_built:
                self._gc_rebuild()
            if not self._gc_dirty:
                return 0
            self._gc_dirty = False
            doomed: List[Tuple[Resource, str, Optional[str]]] = []
            for uid, owners in self._gc_owners.items():
                if all(o not in self._gc_uids for o in owners):
                    res_key, name, ns = self._gc_uids[uid]
                    res = next(r for r in REGISTRY.all() if r.key == res_key)
                    doomed.append((res, name, ns))
        for res, name, ns in doomed:
            try:
                # Each delete re-marks dirty, so grandchildren cascade on the
                # next sweep.
                self.delete(res, name, ns)
                deleted += 1
            except NotFound:
                pass
        return deleted


def _equal_ignoring_rv(old: Dict[str, Any], new: Dict[str, Any]) -> bool:
    a = apimeta.deepcopy(old)
    b = apimeta.deepcopy(new)
    for o in (a, b):
        o.get("metadata", {}).pop("resourceVersion", None)
        o.get("metadata", {}).pop("generation", None)
    return a == b


def _match_fields(obj: Dict[str, Any], field_selector: Dict[str, str]) -> bool:
    for path, want in field_selector.items():
        cur: Any = obj
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return False
            cur = cur[part]
        if str(cur) != want:
            return False
    return True


def _spec_changed(old: Dict[str, Any], new: Dict[str, Any]) -> bool:
    for section in ("spec", "data"):
        if old.get(section) != new.get(section):
            return True
    for field in ("labels", "annotations", "finalizers", "ownerReferences"):
        if old["metadata"].get(field) != new.get("metadata", {}).get(field):
            return True
    return False


def _merge_patch(target: Any, patch: Any) -> Any:
    if not isinstance(patch, dict):
        return apimeta.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    out = apimeta.deepcopy(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out
