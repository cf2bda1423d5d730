"""The port's apiserver against the JAX package's: the Store's verbs, the
REST app and RemoteStore.

- The same scripted verbs on both ``Store``s (JAX's over its
  ``DictBackend``, the port's) give the same status codes, resourceVersions
  and objects: create, update conflicts, status merge, no-op writes, merge
  patch, selectors, pagination, finalizers, GC, and watch resume from the
  ring with 410 past it. uids and second-resolution timestamps are the
  only fields normalized away.
- JAX's REST cases (``tests/test_apiserver_rest.py``: CRUD, watch, request
  validation, hub-and-spoke conversion, JSON patch) run against both apps.
- Each package's ``RemoteStore`` round-trips objects and watches against
  the other package's app.
- ``runtime/reconcile.reconcile_object`` creates and updates as JAX's does
  (the cluster-managed ``clusterIP`` kept).
"""

import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import kubeflow_tpu.api.conversion as j_conversion
import kubeflow_tpu.api.meta as j_meta
import kubeflow_tpu.apiserver.backend as j_backend
import kubeflow_tpu.apiserver.client as j_client
import kubeflow_tpu.apiserver.remote as j_remote
import kubeflow_tpu.apiserver.server as j_server
import kubeflow_tpu.apiserver.store as j_store
import kubeflow_tpu.runtime.informer as j_informer
import kubeflow_tpu.runtime.tracing as j_tracing
import kubeflow_tpu_torch.api.conversion as t_conversion
import kubeflow_tpu_torch.api.meta as t_meta
import kubeflow_tpu_torch.apiserver.client as t_client
import kubeflow_tpu_torch.apiserver.remote as t_remote
import kubeflow_tpu_torch.apiserver.server as t_server
import kubeflow_tpu_torch.apiserver.store as t_store
import kubeflow_tpu_torch.runtime.informer as t_informer
import kubeflow_tpu_torch.runtime.tracing as t_tracing

PKGS = {
    "jax": SimpleNamespace(
        meta=j_meta, conversion=j_conversion, store=j_store, server=j_server,
        remote=j_remote, client=j_client, informer=j_informer, tracing=j_tracing,
        new_store=lambda **kw: j_store.Store(backend=j_backend.DictBackend(), **kw)),
    "torch": SimpleNamespace(
        meta=t_meta, conversion=t_conversion, store=t_store, server=t_server,
        remote=t_remote, client=t_client, informer=t_informer, tracing=t_tracing,
        new_store=lambda **kw: t_store.Store(**kw)),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def rest(pkg):
    """(pkg, local store, RemoteStore client, base_url); server torn down after."""
    store = pkg.new_store()
    server = pkg.server.make_apiserver_app(store).serve(0)
    base = f"http://127.0.0.1:{server.port}"
    yield pkg, store, pkg.remote.RemoteStore(base), base
    server.close()


def mkpod(pkg, name, ns="default", labels=None):
    return pkg.meta.new_object("v1", "Pod", name, ns, labels=labels,
                               spec={"containers": [{"name": "c"}]})


def pods(pkg):
    return pkg.meta.REGISTRY.for_kind("v1", "Pod")


# -- the scripted verbs, differential ------------------------------------------


def _script(pkg):
    """Drive one Store through every verb; return the log of outcomes."""
    meta, S = pkg.meta, pkg.store
    store = pkg.new_store(watch_cache_size=6)
    PODS, CMS = meta.REGISTRY.for_kind("v1", "Pod"), meta.REGISTRY.for_kind("v1", "ConfigMap")
    log = []

    def do(label, fn):
        try:
            out = fn()
        except S.ApiError as e:
            log.append((label, e.code, e.reason))
            return None
        log.append((label, "ok", out))
        return out

    do("create p1", lambda: store.create(mkpod(pkg, "p1", labels={"app": "x"})))
    do("create p1 again", lambda: store.create(mkpod(pkg, "p1")))
    do("create without ns", lambda: store.create(meta.new_object("v1", "Pod", "nons")))
    do("create without name", lambda: store.create(meta.new_object("v1", "Pod", "", "default")))
    do("create p2", lambda: store.create(mkpod(pkg, "p2", labels={"app": "y"})))
    p1 = do("get p1", lambda: store.get(PODS, "p1", "default"))
    stale = meta.deepcopy(p1)
    p1["spec"]["nodeName"] = "n1"
    do("update p1", lambda: store.update(p1))
    stale["spec"]["nodeName"] = "n2"
    do("update stale", lambda: store.update(stale))
    live = store.get(PODS, "p1", "default")
    do("no-op update", lambda: store.update(live))
    live["status"] = {"phase": "Running"}
    live["spec"] = {}  # ignored by the status subresource
    do("update_status", lambda: store.update_status(live))
    do("patch add", lambda: store.patch(PODS, "p1", {"metadata": {"annotations": {"k": "v"}}},
                                        "default"))
    do("patch null", lambda: store.patch(PODS, "p1", {"metadata": {"annotations": {"k": None}}},
                                         "default"))
    do("list selector", lambda: store.list(PODS, "default", {"app": "x"}))
    do("list fields", lambda: store.list(PODS, "default", field_selector={"spec.nodeName": "n1"}))
    do("list all ns", lambda: store.list(PODS))
    do("get missing", lambda: store.get(PODS, "ghost", "default"))
    do("delete missing", lambda: store.delete(PODS, "ghost", "default"))
    page1 = do("page 1", lambda: store.list_page(PODS, "default", limit=1))
    do("page 2", lambda: store.list_page(PODS, "default", limit=1, continue_token=page1[2]))
    do("bad token", lambda: store.list_page(PODS, "default", limit=1, continue_token="x"))
    # finalizers: delete marks, the last finalizer's removal completes it
    do("create fin", lambda: store.create(meta.new_object(
        "v1", "ConfigMap", "fin", "default", data={"a": "1"})))
    fin = store.get(CMS, "fin", "default")
    fin["metadata"]["finalizers"] = ["kubeflow.org/keep"]
    do("add finalizer", lambda: store.update(fin))
    marked = do("delete fin", lambda: store.delete(CMS, "fin", "default"))
    do("still there", lambda: store.get(CMS, "fin", "default")["metadata"]["name"])
    marked = store.get(CMS, "fin", "default")
    marked["metadata"]["finalizers"] = []
    do("drop finalizer", lambda: store.update(marked))
    do("gone", lambda: store.get(CMS, "fin", "default"))
    # GC: a child whose controller owner is deleted is collected
    owner = do("create owner", lambda: store.create(meta.new_object(
        "v1", "ConfigMap", "owner", "default")))
    child = meta.new_object("v1", "ConfigMap", "child", "default")
    meta.set_owner_reference(child, owner)
    do("create child", lambda: store.create(child))
    do("gc idle", lambda: store.collect_garbage())
    do("delete owner", lambda: store.delete(CMS, "owner", "default"))
    do("gc", lambda: store.collect_garbage())
    do("child gone", lambda: store.get(CMS, "child", "default"))
    # the watch ring (6 events): resume inside it replays, past it is 410
    rv_now = store.backend.current_rv()
    for i in range(3):
        store.create(mkpod(pkg, f"w{i}", labels={"app": "w"}))

    def resume(since):
        w = store.watch(PODS, since_rv=since, sync_marker=True)
        w.close()
        return [(e.type, e.object.get("metadata", {}).get("name"),
                 e.object.get("resourceVersion")) for e in w]

    do("resume in ring", lambda: resume(rv_now))
    do("resume past ring", lambda: resume(1))

    def initial():
        w = store.watch(PODS, namespace="default", label_selector={"app": "w"},
                        send_initial=True, sync_marker=True)
        w.close()
        return sorted((e.type, e.object.get("metadata", {}).get("name") or "") for e in w)

    do("send_initial", initial)
    do("rv", lambda: store.backend.current_rv())
    return log


def _normalize(log):
    """uids become their order of first appearance; timestamps a marker."""
    uids = {}

    def norm(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in ("creationTimestamp", "deletionTimestamp"):
                    out[k] = "<ts>"
                elif k == "uid" and isinstance(v, str):
                    out[k] = uids.setdefault(v, f"uid{len(uids)}")
                else:
                    out[k] = norm(v)
            return out
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        if isinstance(x, str) and x in uids:
            return uids[x]
        return x

    return norm(log)


def test_store_verbs_match_jax():
    got = _normalize(_script(PKGS["torch"]))
    want = _normalize(_script(PKGS["jax"]))
    assert [e[0] for e in got] == [e[0] for e in want]
    for g, w in zip(got, want):
        if g[0].startswith("page"):  # continue tokens hold random ids
            g, w = [g[0], g[1], g[2][:2]], [w[0], w[1], w[2][:2]]
        assert g == w, g[0]
    outcomes = {e[0]: e[1] for e in got}
    assert outcomes["create p1 again"] == 409 and outcomes["update stale"] == 409
    assert outcomes["resume past ring"] == 410 and outcomes["gone"] == 404
    assert outcomes["create without ns"] == 422 and outcomes["bad token"] == 410


def test_watch_cache_off_refuses_resume(pkg):
    store = pkg.new_store(watch_cache_size=0)
    with pytest.raises(pkg.store.Invalid):
        store.watch(pods(pkg), since_rv=0)


def test_notfound_is_a_lookup_error():
    """The port's EventRecorder catches LookupError on a vanished Event."""
    assert issubclass(t_store.NotFound, LookupError)
    store = t_store.Store()
    with pytest.raises(LookupError):
        t_client.Client(store).patch("v1", "Event", "gone", {"count": 2}, "default")


# -- JAX's REST cases against both apps ---------------------------------------


class TestRestCrud:
    def test_create_get_list_delete_roundtrip(self, rest):
        pkg, store, remote, base = rest
        created = remote.create(mkpod(pkg, "p1", labels={"app": "x"}))
        assert created["metadata"]["uid"] and created["metadata"]["resourceVersion"]
        got = remote.get(pods(pkg), "p1", "default")
        assert got["metadata"]["uid"] == created["metadata"]["uid"]
        remote.create(mkpod(pkg, "p2", labels={"app": "y"}))
        assert len(remote.list(pods(pkg), "default")) == 2
        assert [p["metadata"]["name"]
                for p in remote.list(pods(pkg), "default", {"app": "x"})] == ["p1"]
        remote.delete(pods(pkg), "p1", "default")
        with pytest.raises(pkg.store.NotFound):
            remote.get(pods(pkg), "p1", "default")

    def test_update_conflict_and_status_subresource(self, rest):
        pkg, store, remote, base = rest
        pod = remote.create(mkpod(pkg, "u1"))
        stale = dict(pod, metadata={**pod["metadata"]})
        pod["spec"]["nodeName"] = "n1"
        assert remote.update(pod)["spec"]["nodeName"] == "n1"
        stale["spec"] = {"containers": [{"name": "other"}]}
        with pytest.raises(pkg.store.Conflict):
            remote.update(stale)
        live = remote.get(pods(pkg), "u1", "default")
        live["status"] = {"phase": "Running"}
        live["spec"] = {}  # must be ignored by the status endpoint
        after = remote.update_status(live)
        assert after["status"]["phase"] == "Running"
        assert after["spec"]["nodeName"] == "n1"

    def test_merge_patch(self, rest):
        pkg, store, remote, base = rest
        remote.create(mkpod(pkg, "m1"))
        out = remote.patch(pods(pkg), "m1", {"metadata": {"annotations": {"k": "v"}}}, "default")
        assert out["metadata"]["annotations"]["k"] == "v"
        # HTTP-created objects carry the creating request's trace context
        assert pkg.tracing.TRACEPARENT_ANNOTATION in out["metadata"]["annotations"]
        out = remote.patch(pods(pkg), "m1", {"metadata": {"annotations": {"k": None}}}, "default")
        assert "k" not in (out["metadata"].get("annotations") or {})

    def test_cluster_scoped_paths(self, rest):
        pkg, store, remote, base = rest
        ns_res = pkg.meta.REGISTRY.for_kind("v1", "Namespace")
        remote.create(pkg.meta.new_object("v1", "Namespace", "team-x"))
        assert remote.get(ns_res, "team-x")["metadata"]["name"] == "team-x"
        assert "team-x" in [n["metadata"]["name"] for n in remote.list(ns_res)]

    def test_group_api_paths_and_errors(self, rest):
        pkg, store, remote, base = rest
        nb_res = pkg.meta.REGISTRY.for_kind("kubeflow.org/v1beta1", "Notebook")
        remote.create(pkg.meta.new_object("kubeflow.org/v1beta1", "Notebook", "nb", "default",
                                          spec={"template": {}}))
        assert remote.get(nb_res, "nb", "default")["kind"] == "Notebook"
        with pytest.raises(pkg.store.NotFound):
            remote.get(nb_res, "ghost", "default")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/apis/nope.io/v1/widgets", timeout=5)
        assert err.value.code == 404

    def test_list_wire_shape_and_healthz(self, rest):
        pkg, store, remote, base = rest
        remote.create(mkpod(pkg, "w1"))
        body = json.loads(urllib.request.urlopen(base + "/api/v1/pods", timeout=5).read())
        assert body["kind"] == "PodList" and len(body["items"]) == 1
        assert int(body["metadata"]["resourceVersion"]) >= 1
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=5).read())
        assert health == {"status": "ok", "resourceVersion": body["metadata"]["resourceVersion"]}
        metrics = urllib.request.urlopen(base + "/metrics", timeout=5).read().decode()
        assert "apiserver_request_seconds" in metrics

    def test_paginated_list_over_the_wire(self, rest):
        pkg, store, remote, base = rest
        for i in range(5):
            remote.create(mkpod(pkg, f"pg{i}"))
        names, token, rvs = [], None, set()
        while True:
            items, rv, token = remote.list_page(pods(pkg), "default", limit=2,
                                                continue_token=token)
            names += [o["metadata"]["name"] for o in items]
            rvs.add(rv)
            if not token:
                break
        assert sorted(names) == [f"pg{i}" for i in range(5)] and len(rvs) == 1
        with pytest.raises(pkg.store.Expired):
            remote.list_page(pods(pkg), "default", limit=2, continue_token="garbage")


class TestRestWatch:
    def test_watch_streams_events(self, rest):
        pkg, store, remote, base = rest
        watcher = remote.watch(pods(pkg), namespace="default")
        events = []
        done = threading.Event()

        def consume():
            for ev in watcher:
                events.append((ev.type, ev.object["metadata"]["name"]))
                if len(events) >= 3:
                    done.set()
                    return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.2)  # let the stream register server-side
        remote.create(mkpod(pkg, "w1"))
        pod = remote.get(pods(pkg), "w1", "default")
        pod["spec"]["nodeName"] = "n"
        remote.update(pod)
        remote.delete(pods(pkg), "w1", "default")
        assert done.wait(10), events
        assert events == [("ADDED", "w1"), ("MODIFIED", "w1"), ("DELETED", "w1")]
        watcher.close()

    def test_watch_send_initial_and_selector(self, rest):
        pkg, store, remote, base = rest
        remote.create(mkpod(pkg, "a", labels={"app": "x"}))
        remote.create(mkpod(pkg, "b", labels={"app": "y"}))
        watcher = remote.watch(pods(pkg), namespace="default", label_selector={"app": "x"},
                               send_initial=True)
        first = next(iter(watcher))
        assert first.type == "ADDED" and first.object["metadata"]["name"] == "a"
        watcher.close()

    def test_watch_resume_from_resource_version(self, rest):
        """Both stores keep a watch-cache ring: a resume replays from it."""
        pkg, store, remote, base = rest
        remote.create(mkpod(pkg, "r1"))
        rv = int(remote.get(pods(pkg), "r1", "default")["metadata"]["resourceVersion"])
        remote.create(mkpod(pkg, "r2"))
        watcher = remote.watch(pods(pkg), since_rv=rv)
        first = next(iter(watcher))
        assert (first.type, first.object["metadata"]["name"]) == ("ADDED", "r2")
        watcher.close()

    def test_watch_resume_past_the_ring_is_410(self, pkg):
        store = pkg.new_store(watch_cache_size=2)
        server = pkg.server.make_apiserver_app(store).serve(0)
        remote = pkg.remote.RemoteStore(f"http://127.0.0.1:{server.port}")
        try:
            for i in range(4):
                remote.create(mkpod(pkg, f"x{i}"))
            with pytest.raises(pkg.store.Expired):
                remote.watch(pods(pkg), since_rv=1)
        finally:
            server.close()

    def test_remote_informer_syncs_prepopulated_store(self, rest):
        pkg, store, remote, base = rest
        remote.create(mkpod(pkg, "pre1", labels={"app": "x"}))
        remote.create(mkpod(pkg, "pre2"))
        inf = pkg.informer.SharedInformer(pkg.client.Client(remote), "v1", "Pod").start()
        try:
            assert inf.wait_synced(timeout=10)
            deadline = time.time() + 10
            while time.time() < deadline and len(inf) < 2:
                time.sleep(0.05)
            assert {o["metadata"]["name"] for o in inf.list()} == {"pre1", "pre2"}
            remote.create(mkpod(pkg, "post1"))
            deadline = time.time() + 10
            while time.time() < deadline and len(inf) < 3:
                time.sleep(0.05)
            assert {o["metadata"]["name"] for o in inf.list()} == {"pre1", "pre2", "post1"}
        finally:
            inf.stop()


class TestRequestValidation:
    def test_put_body_path_mismatch_is_400(self, rest):
        pkg, store, remote, base = rest
        remote.create(mkpod(pkg, "victim"))
        remote.create(mkpod(pkg, "attacker"))
        victim = remote.get(pods(pkg), "victim", "default")
        victim["spec"]["nodeName"] = "evil"
        req = urllib.request.Request(
            base + "/api/v1/namespaces/default/pods/attacker", json.dumps(victim).encode(),
            {"content-type": "application/json"}, method="PUT")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=5)
        assert err.value.code == 400
        assert "nodeName" not in remote.get(pods(pkg), "victim", "default")["spec"]

    def test_remote_error_mapping_preserves_status(self, pkg):
        with pytest.raises(pkg.store.ApiError) as err:
            pkg.remote._raise_for({"message": "body/path mismatch", "reason": "BadRequest"}, 400)
        assert type(err.value) is pkg.store.ApiError
        assert err.value.code == 400 and err.value.reason == "BadRequest"
        with pytest.raises(pkg.store.Conflict):
            pkg.remote._raise_for({"message": "rv mismatch"}, 409)

    def test_bad_resource_version_is_400(self, rest):
        pkg, store, remote, base = rest
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/api/v1/pods?watch=true&resourceVersion=abc",
                                   timeout=5)
        assert err.value.code == 400


class TestVersionConversion:
    """Hub-and-spoke versions: the Notebook kind's v1 and v1alpha1 convert
    through the v1beta1 hub at the REST layer."""

    def _res(self, pkg, version):
        return pkg.meta.REGISTRY.for_kind(f"kubeflow.org/{version}", "Notebook")

    def test_create_at_spoke_read_at_hub_and_other_spoke(self, rest):
        pkg, store, remote, base = rest
        remote.create(pkg.meta.new_object(
            "kubeflow.org/v1", "Notebook", "conv", "default",
            spec={"template": {"spec": {"containers": [{"name": "c"}]}}}))
        assert store.get(self._res(pkg, "v1beta1"), "conv", "default")["apiVersion"] == \
            "kubeflow.org/v1beta1"
        for version in ("v1", "v1alpha1", "v1beta1"):
            assert remote.get(self._res(pkg, version), "conv", "default")["apiVersion"] == \
                f"kubeflow.org/{version}"
        items = remote.list(self._res(pkg, "v1"), "default")
        assert items and all(o["apiVersion"] == "kubeflow.org/v1" for o in items)

    def test_spoke_update_roundtrip(self, rest):
        pkg, store, remote, base = rest
        remote.create(pkg.meta.new_object("kubeflow.org/v1", "Notebook", "upd", "default",
                                          spec={"template": {}}))
        obj = remote.get(self._res(pkg, "v1"), "upd", "default")
        obj["spec"]["gpu"] = {"product": "NVIDIA-H100-80GB-HBM3", "count": 2}
        assert remote.update(obj)["apiVersion"] == "kubeflow.org/v1"
        assert store.get(self._res(pkg, "v1beta1"), "upd", "default")["spec"]["gpu"]["count"] == 2

    def test_spoke_watch_converts_events(self, rest):
        pkg, store, remote, base = rest
        watcher = remote.watch(self._res(pkg, "v1"), namespace="default", send_initial=True)
        remote.create(pkg.meta.new_object("kubeflow.org/v1beta1", "Notebook", "w", "default",
                                          spec={}))
        assert next(iter(watcher)).object["apiVersion"] == "kubeflow.org/v1"
        watcher.close()

    def test_bogus_body_api_version_rejected(self, rest):
        pkg, store, remote, base = rest
        req = urllib.request.Request(
            base + "/apis/kubeflow.org/v1/namespaces/default/notebooks",
            json.dumps({"apiVersion": "kubeflow.org/v999", "kind": "Notebook",
                        "metadata": {"name": "bad", "namespace": "default"},
                        "spec": {}}).encode(),
            {"content-type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=5)
        assert err.value.code == 400
        with pytest.raises(pkg.store.NotFound):
            remote.get(self._res(pkg, "v1beta1"), "bad", "default")

    def test_spoke_patch_with_api_version_in_body(self, rest):
        pkg, store, remote, base = rest
        remote.create(pkg.meta.new_object("kubeflow.org/v1", "Notebook", "pv", "default",
                                          spec={}))
        out = remote.patch(self._res(pkg, "v1"), "pv",
                           {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
                            "metadata": {"annotations": {"a": "1"}}}, "default")
        assert out["apiVersion"] == "kubeflow.org/v1"
        stored = store.get(self._res(pkg, "v1beta1"), "pv", "default")
        assert stored["apiVersion"] == "kubeflow.org/v1beta1"
        assert stored["metadata"]["annotations"]["a"] == "1"

    def test_registered_mapper_runs_on_spoke_patch_fragment(self, rest):
        pkg, store, remote, base = rest

        def v1_to_beta(obj):
            spec = obj.get("spec")
            if spec and "gpuSlice" in spec:  # v1 name -> hub name
                spec["gpu"] = spec.pop("gpuSlice")
            return obj

        key = ("kubeflow.org", "Notebook", "v1", "v1beta1")
        pkg.conversion._MAPPERS[key] = v1_to_beta
        try:
            remote.create(pkg.meta.new_object("kubeflow.org/v1", "Notebook", "mapped", "default",
                                              spec={}))
            remote.patch(self._res(pkg, "v1"), "mapped", {"spec": {"gpuSlice": {"count": 2}}},
                         "default")
            stored = store.get(self._res(pkg, "v1beta1"), "mapped", "default")
            assert stored["spec"].get("gpu") == {"count": 2} and "gpuSlice" not in stored["spec"]
        finally:
            pkg.conversion._MAPPERS.pop(key, None)

    def test_in_process_spoke_write_routes_to_hub(self, rest):
        pkg, store, remote, base = rest
        store.create(pkg.meta.new_object("kubeflow.org/v1", "Notebook", "direct", "default",
                                         spec={}))
        hub, v1 = self._res(pkg, "v1beta1"), self._res(pkg, "v1")
        assert store.get(hub, "direct", "default")["apiVersion"] == "kubeflow.org/v1beta1"
        assert store.get(v1, "direct", "default")["metadata"]["name"] == "direct"
        assert len(store.list(v1, "default")) == len(store.list(hub, "default"))

    def test_spoke_events_reach_hub_watchers(self, rest):
        pkg, store, remote, base = rest
        w = store.watch(self._res(pkg, "v1beta1"), send_initial=False)
        remote.create(pkg.meta.new_object("kubeflow.org/v1alpha1", "Notebook", "legacy",
                                          "default", spec={}))
        w.close()
        assert any(e.object["metadata"]["name"] == "legacy" for e in list(w))


def test_apply_json_patch(pkg):
    obj = {"a": {"b": 1}, "arr": [1, 2]}
    out = pkg.server.apply_json_patch(obj, [
        {"op": "replace", "path": "/a/b", "value": 2},
        {"op": "add", "path": "/a/c", "value": 3},
        {"op": "add", "path": "/arr/-", "value": 9},
        {"op": "remove", "path": "/arr/0"},
    ])
    assert out == {"a": {"b": 2, "c": 3}, "arr": [2, 9]}
    assert obj == {"a": {"b": 1}, "arr": [1, 2]}  # input untouched


def test_registries_hold_the_same_kinds():
    def kinds(meta):
        return sorted((r.group, r.version, r.kind, r.plural, r.namespaced)
                      for r in meta.REGISTRY.all())

    assert kinds(t_meta) == kinds(j_meta)


# -- across the packages: each RemoteStore against the other package's app ----


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "torch"), ("torch", "jax")])
def test_remote_store_across_packages(client_pkg, server_pkg):
    cp, sp = PKGS[client_pkg], PKGS[server_pkg]
    store = sp.new_store()
    server = sp.server.make_apiserver_app(store).serve(0)
    remote = cp.remote.RemoteStore(f"http://127.0.0.1:{server.port}")
    res = pods(cp)
    try:
        watcher = remote.watch(res, namespace="default", send_initial=True, sync_marker=True)
        events = []
        done = threading.Event()

        def consume():
            for ev in watcher:
                events.append((ev.type, (ev.object.get("metadata") or {}).get("name")))
                if len(events) >= 4:
                    done.set()
                    return

        threading.Thread(target=consume, daemon=True).start()
        created = remote.create(mkpod(cp, "x", labels={"app": "a"}))
        assert store.get(pods(sp), "x", "default")["metadata"]["uid"] == \
            created["metadata"]["uid"]
        got = remote.get(res, "x", "default")
        got["spec"]["nodeName"] = "n0"
        assert remote.update(got)["spec"]["nodeName"] == "n0"
        assert [p["metadata"]["name"] for p in remote.list(res, "default", {"app": "a"})] == ["x"]
        remote.delete(res, "x", "default")
        with pytest.raises(cp.store.NotFound):
            remote.get(res, "x", "default")
        assert done.wait(10), events
        assert events == [("SYNC", None), ("ADDED", "x"), ("MODIFIED", "x"), ("DELETED", "x")]
        watcher.close()
    finally:
        server.close()


def _reconcile_script(pkg, reconcile):
    store = pkg.new_store()
    client = pkg.client.Client(store)
    owner = client.create(pkg.meta.new_object("v1", "ConfigMap", "owner", "ns"))
    log = []
    for desired in (
        pkg.meta.new_object("apps/v1", "StatefulSet", "ss", "ns", labels={"a": "1"},
                            spec={"replicas": 1, "template": {"spec": {"x": 1}}}),
        pkg.meta.new_object("apps/v1", "StatefulSet", "ss", "ns", labels={"a": "1"},
                            spec={"replicas": 2, "template": {"spec": {"x": 1}}}),
        pkg.meta.new_object("v1", "Service", "svc", "ns", spec={"ports": [{"port": 80}]}),
        pkg.meta.new_object("v1", "Service", "svc", "ns", spec={"ports": [{"port": 8080}]}),
        pkg.meta.new_object("rbac.authorization.k8s.io/v1", "RoleBinding", "rb", "ns",
                            roleRef={"name": "r"}, subjects=[{"name": "u"}]),
        pkg.meta.new_object("networking.istio.io/v1beta1", "VirtualService", "vs", "ns",
                            spec={"hosts": ["*"]}),
    ):
        if desired["kind"] == "Service" and client.get_opt("v1", "Service", "svc", "ns"):
            live = client.get("v1", "Service", "svc", "ns")
            live["spec"]["clusterIP"] = "10.0.0.7"  # cluster-managed: must survive
            client.update(live)
        out = reconcile(client, desired, owner=owner)
        log.append({k: out.get(k) for k in ("kind", "spec", "roleRef", "subjects")}
                   | {"rv": out["metadata"]["resourceVersion"],
                      "owners": [r["name"] for r in out["metadata"]["ownerReferences"]]})
    return log


def test_reconcile_object_matches_jax():
    import kubeflow_tpu.runtime.reconcile as j_reconcile
    import kubeflow_tpu_torch.runtime.reconcile as t_reconcile

    got = _reconcile_script(PKGS["torch"], t_reconcile.reconcile_object)
    assert got == _reconcile_script(PKGS["jax"], j_reconcile.reconcile_object)
    assert got[3]["spec"] == {"ports": [{"port": 8080}], "clusterIP": "10.0.0.7"}
    assert got[1]["spec"]["replicas"] == 2 and got[1]["rv"] != got[0]["rv"]
