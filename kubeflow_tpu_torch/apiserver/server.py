"""REST apiserver: the Kubernetes-wire HTTP surface over the Store.

A trimmed copy of ``kubeflow_tpu/apiserver/server.py``. Every registered
resource is served at the standard paths — ``/api/v1/...`` for core,
``/apis/<group>/<version>/...`` for groups — with ``namespaces/<ns>``
scoping, the ``/status`` subresource, label selectors, paginated lists
(``limit``/``continue``), JSON merge patch, and ``?watch=true`` NDJSON
streams that resume from a resourceVersion through the store's watch
cache. ``/healthz`` reports the store's resourceVersion; ``/metrics`` and
``/debug/*`` (traces included) come from ``runtime/obs.mount_observability``.
A create stamps the request's trace onto the object
(``TRACEPARENT_ANNOTATION``), so the reconciles it causes join the trace.

Not in the port yet: the bearer-token and RBAC gate (``auth``), priority
and fairness (``fairness``) and dynamic admission webhooks
(MutatingWebhookConfiguration objects, ``webhook_url``). The server runs
open, and an in-process admission hook registered on the Store still runs.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from ..api import meta as apimeta
from ..api.conversion import convert, convert_fragment, hub_resource
from ..api.meta import REGISTRY, Resource
from ..runtime.metrics import METRICS
from ..runtime.tracing import TRACEPARENT_ANNOTATION, TRACER, format_traceparent
from ..runtime.obs import mount_observability
from ..web.http import App, HttpError, JsonResponse, Request, StreamingResponse
from .store import ApiError, Store


def _selector_of(req: Request) -> Optional[Dict[str, str]]:
    raw = req.query1("labelSelector")
    if not raw:
        return None
    return apimeta.parse_selector_string(raw)


def apply_json_patch(obj: Dict[str, Any], ops: List[Dict[str, Any]]) -> Dict[str, Any]:
    """RFC 6902 subset: add/replace/remove with object/array paths."""
    out = apimeta.deepcopy(obj)
    for op in ops:
        path = [p.replace("~1", "/").replace("~0", "~") for p in op["path"].split("/")[1:]]
        parent: Any = out
        for seg in path[:-1]:
            parent = parent[int(seg)] if isinstance(parent, list) else parent.setdefault(seg, {})
        leaf = path[-1]
        kind = op["op"]
        if isinstance(parent, list):
            idx = len(parent) if leaf == "-" else int(leaf)
            if kind == "add":
                parent.insert(idx, op["value"])
            elif kind == "replace":
                parent[idx] = op["value"]
            elif kind == "remove":
                del parent[idx]
            else:
                raise ValueError(f"unsupported patch op {kind!r}")
        else:
            if kind in ("add", "replace"):
                parent[leaf] = op["value"]
            elif kind == "remove":
                parent.pop(leaf, None)
            else:
                raise ValueError(f"unsupported patch op {kind!r}")
    return out


def make_apiserver_app(store: Store) -> App:
    """The REST app over ``store`` (serve it with ``.serve(port)``)."""
    app = App("apiserver")

    def res_of(req: Request) -> Resource:
        """Resource addressed by the URL. May be a SPOKE version — handlers
        store/watch via ``hub_resource(res)`` and convert responses back to
        the requested version (hub-and-spoke, conversion.py)."""
        group = req.params.get("group", "")
        version = req.params["version"]
        api_version = f"{group}/{version}" if group else version
        try:
            return REGISTRY.for_plural(api_version, req.params["plural"])
        except KeyError as e:
            raise HttpError(404, str(e)) from None

    def outbound(obj: Dict[str, Any], res: Resource) -> Dict[str, Any]:
        return convert(obj, res.group, res.kind, res.version)

    def inbound(obj: Dict[str, Any], res: Resource) -> Dict[str, Any]:
        # The body must name the version the endpoint serves — blind
        # restamping would accept bogus versions and skip the registered
        # (endpoint-version → hub) field mappers.
        body_version = obj.get("apiVersion", "")
        if body_version != res.api_version:
            raise HttpError(
                400,
                f"body apiVersion {body_version!r} does not match endpoint {res.api_version!r}",
            )
        return convert(obj, res.group, res.kind, hub_resource(res).version)

    def error(e: ApiError) -> JsonResponse:
        return JsonResponse(e.to_status(), status=e.code)

    # -- handlers (shared by core + group paths) -----------------------------
    def list_or_watch(req: Request):
        res = res_of(req)
        ns = req.params.get("ns")
        selector = _selector_of(req)
        if req.query1("watch") in ("true", "1"):
            return _watch_stream(store, res, ns, selector, req)
        limit_param = req.query1("limit")
        cont = req.query1("continue") or None
        try:
            if limit_param or cont:
                try:
                    limit = int(limit_param) if limit_param else None
                except ValueError:
                    raise HttpError(400, f"invalid limit {limit_param!r}") from None
                items, rv, next_token = store.list_page(
                    hub_resource(res), namespace=ns, label_selector=selector,
                    limit=limit, continue_token=cont)
            else:
                items, rv = store.list_with_rv(
                    hub_resource(res), namespace=ns, label_selector=selector)
                next_token = None
        except ApiError as e:
            return error(e)
        # RV captured atomically with the snapshot (store.list_with_rv /
        # the page's pinned snapshot) so list+watch-from-RV never misses
        # interleaved writes — and every page of one list reports the SAME RV.
        metadata: Dict[str, Any] = {"resourceVersion": str(rv)}
        if next_token:
            metadata["continue"] = next_token
        return {
            "apiVersion": res.api_version,
            "kind": res.list_kind or f"{res.kind}List",
            "metadata": metadata,
            "items": [outbound(o, res) for o in items],
        }

    def create(req: Request):
        res = res_of(req)
        obj = req.json or {}
        obj.setdefault("apiVersion", res.api_version)
        obj.setdefault("kind", res.kind)
        if req.params.get("ns"):
            obj.setdefault("metadata", {}).setdefault("namespace", req.params["ns"])
        # Stamp the creating request's trace context on the object: the hop
        # from a client's POST to the watch-driven reconcile it causes has
        # no header to carry, so the object itself carries it (a client's
        # own traceparent survives verbatim via the dispatch span).
        cur = TRACER.current_span()
        if cur is not None:
            md = obj.setdefault("metadata", {})
            ann = dict(md.get("annotations") or {})
            ann.setdefault(TRACEPARENT_ANNOTATION, format_traceparent(cur))
            md["annotations"] = ann
        try:
            return JsonResponse(outbound(store.create(inbound(obj, res)), res), status=201)
        except ApiError as e:
            return error(e)

    def get_item(req: Request):
        res = res_of(req)
        try:
            return outbound(store.get(hub_resource(res), req.params["name"], req.params.get("ns")), res)
        except ApiError as e:
            return error(e)

    def _check_body_matches_path(req: Request, obj: Dict[str, Any]) -> None:
        """The body must name the object the URL addresses — a mismatched
        client write must 400, not silently update a different object."""
        md = obj.get("metadata") or {}
        if md.get("name") != req.params["name"]:
            raise HttpError(400, f"body names {md.get('name')!r}, path names {req.params['name']!r}")
        path_ns = req.params.get("ns")
        if path_ns is not None and md.get("namespace") not in (None, path_ns):
            raise HttpError(
                400, f"body namespace {md.get('namespace')!r} != path namespace {path_ns!r}"
            )

    def put_item(req: Request):
        res = res_of(req)
        obj = req.json or {}
        _check_body_matches_path(req, obj)
        try:
            return outbound(store.update(inbound(obj, res)), res)
        except ApiError as e:
            return error(e)

    def put_status(req: Request):
        res = res_of(req)
        obj = req.json or {}
        _check_body_matches_path(req, obj)
        try:
            return outbound(store.update_status(inbound(obj, res)), res)
        except ApiError as e:
            return error(e)

    def patch_item(req: Request):
        res = res_of(req)
        patch = dict(req.json or {})
        # apiVersion/kind are endpoint-determined; merging a spoke version
        # into the stored hub object would corrupt its storage key.
        patch.pop("apiVersion", None)
        patch.pop("kind", None)
        # spoke→hub field mappers apply to the fragment before the merge
        patch = convert_fragment(
            patch, res.group, res.kind, res.version, hub_resource(res).version
        )
        try:
            return outbound(
                store.patch(hub_resource(res), req.params["name"], patch, req.params.get("ns")),
                res,
            )
        except ApiError as e:
            return error(e)

    def delete_item(req: Request):
        res = res_of(req)
        try:
            return outbound(store.delete(hub_resource(res), req.params["name"], req.params.get("ns")), res)
        except ApiError as e:
            return error(e)

    def instrumented(verb: str, handler):
        """kube-apiserver's request SLI surface: one histogram + in-flight
        gauge per (verb, resource), plus a child span under the dispatch
        span (which already continues any inbound ``traceparent``, so a
        controller's write shows up inside its reconcile trace)."""

        def wrapped(req: Request):
            v = verb
            if v == "list" and req.query1("watch") in ("true", "1"):
                v = "watch"
            resource = req.params.get("plural", "")
            gauge = METRICS.gauge("apiserver_inflight_requests", verb=v)
            gauge.inc()
            start = time.monotonic()
            dec_on_exit = True
            try:
                with TRACER.span(f"apiserver.{v}", resource=resource, verb=v):
                    resp = handler(req)
                if v == "watch" and isinstance(resp, StreamingResponse):
                    # a watch is long-running: it stays in-flight until the
                    # stream closes, and its "duration" is the stream
                    # lifetime — ~0s dispatch samples would pollute the
                    # latency ladder, so the histogram skips watches
                    dec_on_exit = False
                    prev_close = resp.on_close

                    def close() -> None:
                        gauge.dec()
                        if prev_close is not None:
                            prev_close()

                    resp.on_close = close
                return resp
            finally:
                if dec_on_exit:
                    gauge.dec()
                if v != "watch":
                    METRICS.histogram(
                        "apiserver_request_seconds", verb=v, resource=resource
                    ).observe(time.monotonic() - start)

        wrapped.__name__ = getattr(handler, "__name__", verb)
        return wrapped

    # -- route table ---------------------------------------------------------
    # /api/v1/... (core) and /apis/<group>/<version>/... share handlers; the
    # core prefix hard-pins version into the pattern params via defaults.
    prefixes = [
        "/api/<version>",
        "/apis/<group>/<version>",
    ]
    for prefix in prefixes:
        for scope in (f"{prefix}/namespaces/<ns>", prefix):
            app.route(f"{scope}/<plural>", methods=("GET",))(instrumented("list", list_or_watch))
            app.route(f"{scope}/<plural>", methods=("POST",))(instrumented("create", create))
            app.route(f"{scope}/<plural>/<name>", methods=("GET",))(instrumented("get", get_item))
            app.route(f"{scope}/<plural>/<name>", methods=("PUT",))(instrumented("update", put_item))
            app.route(f"{scope}/<plural>/<name>/status", methods=("PUT",))(
                instrumented("update_status", put_status))
            app.route(f"{scope}/<plural>/<name>", methods=("PATCH",))(instrumented("patch", patch_item))
            app.route(f"{scope}/<plural>/<name>", methods=("DELETE",))(instrumented("delete", delete_item))

    @app.route("/healthz")
    def healthz(req: Request):
        return {"status": "ok", "resourceVersion": str(store.backend.current_rv())}

    @app.route("/apis")
    def discovery(req: Request):
        groups: Dict[str, List[str]] = {}
        for res in REGISTRY.all():
            groups.setdefault(res.group or "core", []).append(f"{res.plural}.{res.version}")
        return {"groups": {g: sorted(v) for g, v in groups.items()}}

    # /metrics + /debug/* on the API port, as kube-apiserver serves
    # /metrics and /debug/pprof
    mount_observability(app)

    return app


def _watch_stream(
    store: Store, res: Resource, ns: Optional[str], selector: Optional[Dict[str, str]], req: Request
):
    since_rv: Optional[int] = None
    rv_param = req.query1("resourceVersion")
    if rv_param:
        try:
            since_rv = int(rv_param)
        except ValueError:
            raise HttpError(400, f"invalid resourceVersion {rv_param!r}") from None
    send_initial = req.query1("sendInitial") in ("true", "1")
    sync_marker = req.query1("syncMarker") in ("true", "1")
    try:
        watcher = store.watch(
            hub_resource(res),
            namespace=ns,
            label_selector=selector,
            send_initial=send_initial,
            since_rv=since_rv,
            sync_marker=sync_marker,
        )
    except ApiError as e:
        return JsonResponse(e.to_status(), status=e.code)

    def chunks() -> Iterator[bytes]:
        # Heartbeat BOOKMARKs on idle streams: a broken socket is only
        # detected on write, so without periodic writes a watcher whose
        # client vanished (controller rollout) would leak its handler
        # thread + Store registration forever on a quiet resource.

        # per-event fanout counter: N watchers on a busy resource multiply
        # every write by N here — the storm SLI the scale harness reads
        sent = METRICS.counter("apiserver_watch_events_sent_total", resource=res.plural)
        while True:
            try:
                # next_event, never .queue: preloaded initial-list/RV-replay
                # events must reach remote clients too
                item = watcher.next_event(timeout=15.0)
            except queue.Empty:
                yield json.dumps({"type": "BOOKMARK", "object": {}}).encode() + b"\n"
                continue
            if item is None:
                return
            if item.type == "SYNC":  # protocol marker, not an object — no conversion
                yield json.dumps({"type": "SYNC", "object": item.object}).encode() + b"\n"
                continue
            obj = convert(item.object, res.group, res.kind, res.version)
            sent.inc()
            yield json.dumps({"type": item.type, "object": obj}).encode() + b"\n"

    return StreamingResponse(
        chunks(),
        headers={"Content-Type": "application/json; stream=watch"},
        on_close=watcher.close,
    )


def run_gc_loop(store: Store, interval: float = 0.1) -> threading.Thread:
    """The kube-controller-manager GC role, hosted by the apiserver process
    (remote controllers must not each run their own sweep)."""

    def loop() -> None:
        while True:
            time.sleep(interval)
            try:
                store.collect_garbage()
            except Exception:
                pass

    t = threading.Thread(target=loop, name="apiserver-gc", daemon=True)
    t.start()
    return t
