"""The port's shared informers and controller runtime: sync, live updates,
relist after a 410, read-your-writes, and a clean close.

``tests/test_informer.py``'s cases run on the port's ``SharedInformer``
and ``InformerCache``; then the 410 path (a resume below the watch ring's
floor relists through the paginated LIST, detached from any trace, and
fires synthetic DELETED events), and the stop path over real HTTP: an
informer and a ``Manager`` on ``RemoteStore`` stop with no thread of
theirs left running (threads an earlier test left in the process are not
counted) and no thread crash or traceback on stderr (the informers' watch
streams race ``http.client``'s close, which the port's ``RemoteWatch``
ends quietly); a stop() that lands while the pump opens its watch closes
the new stream.
"""

import threading
import time

import pytest

from kubeflow_tpu_torch.api.meta import REGISTRY, new_object
from kubeflow_tpu_torch.apiserver.client import Client
from kubeflow_tpu_torch.apiserver.remote import RemoteStore
from kubeflow_tpu_torch.apiserver.server import make_apiserver_app
from kubeflow_tpu_torch.apiserver.store import Store
from kubeflow_tpu_torch.controllers.builtin import PodletReconciler, make_gpu_node
from kubeflow_tpu_torch.runtime import tracing as tracing_mod
from kubeflow_tpu_torch.runtime.informer import InformerCache, SharedInformer
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.runtime.tracing import TRACER
from kubeflow_tpu_torch.scheduler.core import SchedulerReconciler
from kubeflow_tpu_torch.scheduler.gang import POD_GROUP_LABEL, POD_GROUP_SIZE_ANNOTATION

PODS = REGISTRY.for_kind("v1", "Pod")


def wait_for(cond, timeout=5.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


class TestSharedInformer:
    def test_initial_sync_and_live_updates(self):
        client = Client(Store())
        client.create(new_object("v1", "Pod", "p0", "ns1", labels={"app": "a"}))
        inf = SharedInformer(client, "v1", "Pod").start()
        try:
            assert inf.wait_synced()
            assert wait_for(lambda: len(inf) == 1)
            client.create(new_object("v1", "Pod", "p1", "ns1", labels={"app": "b"}))
            assert wait_for(lambda: len(inf) == 2)
            p0 = client.get("v1", "Pod", "p0", "ns1")
            p0["metadata"]["labels"]["app"] = "c"
            client.update(p0)
            assert wait_for(lambda: (inf.get("p0", "ns1") or {}).get("metadata", {})
                            .get("labels", {}).get("app") == "c")
            client.delete("v1", "Pod", "p1", "ns1")
            assert wait_for(lambda: len(inf) == 1)
        finally:
            inf.stop()

    def test_namespace_and_label_filtering(self):
        client = Client(Store())
        client.create(new_object("v1", "Pod", "a", "ns1", labels={"app": "x"}))
        client.create(new_object("v1", "Pod", "b", "ns1", labels={"app": "y"}))
        client.create(new_object("v1", "Pod", "c", "ns2", labels={"app": "x"}))
        inf = SharedInformer(client, "v1", "Pod").start()
        try:
            assert inf.wait_synced()
            assert wait_for(lambda: len(inf) == 3)
            assert {p["metadata"]["name"] for p in inf.list("ns1")} == {"a", "b"}
            assert {p["metadata"]["name"]
                    for p in inf.list(label_selector={"app": "x"})} == {"a", "c"}
            assert [p["metadata"]["name"] for p in inf.list("ns2", {"app": "x"})] == ["c"]
        finally:
            inf.stop()

    def test_event_handlers_fire(self):
        client = Client(Store())
        inf = SharedInformer(client, "v1", "Pod").start()
        seen = []
        inf.add_event_handler(lambda t, o: seen.append((t, o["metadata"]["name"])))
        try:
            assert inf.wait_synced()
            client.create(new_object("v1", "Pod", "p0", "ns1"))
            assert wait_for(lambda: ("ADDED", "p0") in seen)
            client.delete("v1", "Pod", "p0", "ns1")
            assert wait_for(lambda: ("DELETED", "p0") in seen)
        finally:
            inf.stop()

    def test_delete_while_deaf_reaches_handlers(self):
        store = Store()
        client = Client(store)
        client.create(new_object("v1", "Pod", "stays", "ns1"))
        client.create(new_object("v1", "Pod", "vanishes", "ns1"))
        inf = SharedInformer(client, "v1", "Pod").start()
        seen = []
        inf.add_event_handler(lambda t, o: seen.append((t, o["metadata"]["name"])))
        try:
            assert inf.wait_synced()
            assert wait_for(lambda: len(inf) == 2)
            inf._watcher.close()
            store.delete(PODS, "vanishes", "ns1")
            assert wait_for(lambda: ("DELETED", "vanishes") in seen, timeout=10)
            assert wait_for(lambda: len(inf) == 1)
            assert inf.get("stays", "ns1") is not None and inf.get("vanishes", "ns1") is None
        finally:
            inf.stop()

    def test_wait_rv_read_your_writes_barrier(self):
        client = Client(Store())
        inf = SharedInformer(client, "v1", "Pod").start()
        try:
            assert inf.wait_synced()
            created = client.create(new_object("v1", "Pod", "rw", "ns1"))
            rv = int(created["metadata"]["resourceVersion"])
            assert inf.wait_rv(rv, timeout=5) and inf.get("rw", "ns1") is not None
            gone = client.delete("v1", "Pod", "rw", "ns1")
            drv = int(gone["metadata"]["resourceVersion"])
            assert drv > rv
            assert inf.wait_rv(drv, timeout=5) and inf.get("rw", "ns1") is None
        finally:
            inf.stop()

    def test_no_empty_cache_window_during_reconnect(self):
        client = Client(Store())
        client.create(new_object("v1", "Pod", "p0", "ns1"))
        inf = SharedInformer(client, "v1", "Pod").start()
        try:
            assert inf.wait_synced()
            assert wait_for(lambda: len(inf) == 1)
            for _ in range(5):  # churn reconnects; the cache never dips to 0
                inf._watcher.close()
                deadline = time.time() + 2
                while time.time() < deadline and inf._watcher.closed:
                    assert len(inf) == 1
                    time.sleep(0.005)
        finally:
            inf.stop()


class TestRelistAfter410:
    def test_compacted_window_relists_and_synthesizes_deletes(self):
        """A resume below the ring's floor is 410: the pump relists through
        the paginated LIST, and what vanished meanwhile fires DELETED."""
        store = Store(watch_cache_size=4)
        client = Client(store)
        for name in ("stays", "vanishes"):
            client.create(new_object("v1", "Pod", name, "ns1"))
        inf = SharedInformer(client, "v1", "Pod").start()
        seen = []
        inf.add_event_handler(lambda t, o: seen.append((t, o["metadata"]["name"])))
        relists = METRICS.value("informer_relists_total", kind="Pod")
        try:
            assert inf.wait_synced() and wait_for(lambda: len(inf) == 2)
            inf._watcher.close()
            store.delete(PODS, "vanishes", "ns1")
            for i in range(6):  # push the resume RV out of the 4-event ring
                client.create(new_object("v1", "Pod", f"new{i}", "ns1"))
            assert wait_for(lambda: ("DELETED", "vanishes") in seen, timeout=10)
            assert wait_for(lambda: len(inf) == 7)
            assert METRICS.value("informer_relists_total", kind="Pod") >= relists + 1
        finally:
            inf.stop()

    def test_relist_runs_detached(self):
        """The relist's LISTs inherit no trace left current on the pump
        thread by a handler that never restored it."""
        relist_contexts = []

        class SpyClient(Client):
            def list_paged(self, *args, **kwargs):
                relist_contexts.append(TRACER.current_span())
                return super().list_paged(*args, **kwargs)

        store = Store()
        client = SpyClient(store)
        client.create(new_object("v1", "Pod", "p0", "ns1"))
        inf = SharedInformer(client, "v1", "Pod").start()
        leaked = []

        def leak(_type, _obj):
            if not leaked:
                leaked.append(TRACER.start_span("leaky-handler"))
                tracing_mod._local.span = leaked[0]

        inf.add_event_handler(leak)
        try:
            assert inf.wait_synced()
            client.create(new_object("v1", "Pod", "p1", "ns1"))
            assert wait_for(lambda: leaked)
            store._wc_trimmed_rv = store.backend.current_rv() + 10_000
            inf._watcher.close()
            assert wait_for(lambda: relist_contexts, timeout=10)
            assert all(ctx is None for ctx in relist_contexts)
        finally:
            inf.stop()
            tracing_mod._local.span = None


class TestStopRace:
    def test_stop_while_the_watch_opens_closes_the_new_stream(self):
        """stop() lands while the pump is opening its watch: the client's
        watch() returns only once stop() has set the flag, and the stream
        it returns never ends unless closed (a remote stream's heartbeats
        are swallowed the same way). The pump must close that stream and
        leave, so the thread is gone when stop() returns."""

        class Stream:
            def __init__(self):
                self.closed = threading.Event()

            def close(self):
                self.closed.set()

            def __iter__(self):
                self.closed.wait(10)
                return iter(())

        class GatedClient:
            def __init__(self):
                self.informer = None
                self.streams = []
                self.opening = threading.Event()

            def watch(self, *args, **kw):
                self.opening.set()
                assert self.informer._stopped.wait(10), "stop() never ran"
                self.streams.append(Stream())
                return self.streams[-1]

        client = GatedClient()
        inf = client.informer = SharedInformer(client, "v1", "Pod")
        inf.start()
        assert client.opening.wait(10)
        t0 = time.monotonic()
        inf.stop()
        assert not inf._thread.is_alive(), "the pump outlived stop()"
        assert time.monotonic() - t0 < 1.5, "stop() waited out its join timeout"
        assert len(client.streams) == 1 and client.streams[0].closed.is_set()


class TestInformerCache:
    def test_lazy_shared_instances(self):
        cache = InformerCache(Client(Store()))
        try:
            a = cache.informer_for("v1", "Pod")
            assert cache.informer_for("v1", "Pod") is a
            assert cache.informer_for("v1", "Event") is not a
        finally:
            cache.stop()

    def test_list_and_get_read_through(self):
        client = Client(Store())
        client.create(new_object("v1", "Pod", "p0", "ns1"))
        cache = InformerCache(client)
        try:
            assert [p["metadata"]["name"] for p in cache.list("v1", "Pod", "ns1")] == ["p0"]
            assert cache.get("v1", "Pod", "p0", "ns1")["metadata"]["name"] == "p0"
            assert cache.get("v1", "Pod", "missing", "ns1") is None
        finally:
            cache.stop()


# -- the stop path over real HTTP ---------------------------------------------


@pytest.fixture()
def apiserver():
    store = Store()
    server = make_apiserver_app(store).serve(0)
    yield store, f"http://127.0.0.1:{server.port}"
    server.close()


@pytest.fixture()
def crashes():
    """Thread crashes (``threading.excepthook``) seen during the test."""
    seen = []
    prev = threading.excepthook
    threading.excepthook = lambda args: seen.append(args)
    yield seen
    threading.excepthook = prev


@pytest.fixture()
def before():
    """The threads alive when the test began: a thread an earlier test
    left running in this process (the JAX package's informers and
    controllers carry the same names) is not this test's."""
    return set(threading.enumerate())


def _ours(prefixes, before):
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefixes) and t not in before]


def test_remote_informer_stops_cleanly(apiserver, crashes, capfd, before):
    store, base = apiserver
    client = Client(RemoteStore(base))
    client.create(new_object("v1", "Pod", "p0", "ns1"))
    infs = [SharedInformer(client, "v1", kind).start() for kind in ("Pod", "Node")]
    assert all(inf.wait_synced(10) for inf in infs)
    assert wait_for(lambda: len(infs[0]) == 1)
    for inf in infs:
        inf.stop()
    assert wait_for(lambda: not _ours(("informer-",), before), timeout=5), \
        _ours(("informer-",), before)
    assert crashes == []
    assert "Traceback" not in capfd.readouterr().err


def test_remote_manager_binds_a_gang_and_stops_cleanly(apiserver, crashes, capfd, before):
    """The scheduler and the podlet on RemoteStore, as in their own process:
    a 2-member gang binds all-or-nothing on GPU nodes, then stop() leaves
    no watch, worker or informer thread and no crash."""
    store, base = apiserver
    mgr = Manager(store=RemoteStore(base))
    mgr.add(SchedulerReconciler(backoff_base=0.02, backoff_cap=0.5)).add(PodletReconciler())
    local = Client(store)
    for i in range(2):
        local.create(make_gpu_node(f"gpu-node-{i}", "h100", 8))
    mgr.start()
    try:
        for i in range(2):
            local.create(new_object(
                "v1", "Pod", f"g-{i}", "default", labels={POD_GROUP_LABEL: "g"},
                annotations={POD_GROUP_SIZE_ANNOTATION: "2"},
                spec={"containers": [{"name": "c", "resources": {
                    "limits": {"nvidia.com/gpu": "8"}}}]}))
        assert wait_for(lambda: all(
            (local.get("v1", "Pod", f"g-{i}", "default").get("status") or {})
            .get("phase") == "Running" for i in range(2)), timeout=15)
        assert {local.get("v1", "Pod", f"g-{i}", "default")["spec"]["nodeName"]
                for i in range(2)} == {"gpu-node-0", "gpu-node-1"}
    finally:
        mgr.stop()
    prefixes = ("informer-", "SchedulerReconciler-", "PodletReconciler-", "garbage-collector")
    assert wait_for(lambda: not _ours(prefixes, before), timeout=5), _ours(prefixes, before)
    assert crashes == []
    assert "Traceback" not in capfd.readouterr().err
