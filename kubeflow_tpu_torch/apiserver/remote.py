"""Remote store: the Store surface over the REST apiserver.

A trimmed copy of ``kubeflow_tpu/apiserver/remote.py``. A control-plane
role in its own process (the scheduler) talks to ``python -m
kubeflow_tpu_torch.apiserver`` through this class: it implements the Store
methods that ``Client`` and ``Manager`` call, so the controller runtime
runs unchanged against a remote apiserver. Watches are NDJSON over chunked
HTTP, errors map back to the store's ``ApiError`` classes, and
``collect_garbage`` is a no-op because the apiserver process runs the GC
sweep (``server.run_gc_loop``). Every request carries the caller's current
span as a ``traceparent`` header, so a reconcile's writes join its trace.

Not in the port yet: bearer tokens, TLS and the fairness flow header
(the JAX apiserver's ``auth``, ``web/tls`` and ``fairness``).
"""

from __future__ import annotations

import json
import socket
import time
import urllib.error
import urllib.request
from http.client import HTTPException
from typing import Any, Dict, Iterator, List, Optional

from ..api import meta as apimeta
from ..api.meta import Resource
from ..runtime.tracing import TRACER, format_traceparent
from .store import (ApiError, Conflict, Expired, Forbidden, Invalid, NotFound,
                    ServiceUnavailable, TooManyRequests, WatchEvent, _match_fields)

_ERRORS = {404: NotFound, 409: Conflict, 422: Invalid, 403: Forbidden, 410: Expired,
           429: TooManyRequests, 503: ServiceUnavailable}


def _raise_for(status_body: Dict[str, Any], code: int, headers: Optional[Any] = None) -> None:
    cls = _ERRORS.get(code, ApiError)
    err = cls(status_body.get("message", f"HTTP {code}"))
    # a code without its own class (a server-side 400) keeps its status
    # rather than ApiError's class-level 500
    if cls is ApiError:
        err.code = code
        err.reason = status_body.get("reason", err.reason)
    # the shed pair carries the server's Retry-After into the typed error,
    # so the client's backoff honours it
    if headers is not None and hasattr(err, "retry_after_s"):
        raw = headers.get("Retry-After") if hasattr(headers, "get") else None
        if raw:
            try:
                err.retry_after_s = float(raw)
            except ValueError:
                pass
    raise err


class RemoteWatch:
    """Iterator of WatchEvents over one streaming HTTP response.

    ``close`` may run on another thread while ``__iter__`` is blocked in a
    read. It shuts the socket down first (a reader blocked in ``readinto``
    holds the response's buffer lock, and ``HTTPResponse.close`` would wait
    for it), so the read returns EOF. Both threads then race to close the
    response: ``http.client`` sets ``fp`` to None in one of them and the
    other's read or close raises ``AttributeError``. That is a torn-down
    stream like any other, and the iterator ends quietly on it.
    """

    def __init__(self, resp):
        self._resp = resp
        self.closed = False

    def close(self) -> None:
        self.closed = True
        try:
            raw = getattr(getattr(self._resp, "fp", None), "raw", None)
            sock = getattr(raw, "_sock", None)
            if sock is not None:
                sock.shutdown(socket.SHUT_RDWR)
        except (OSError, AttributeError):
            pass
        try:
            self._resp.close()
        except (OSError, AttributeError, HTTPException):
            pass

    def __iter__(self) -> Iterator[WatchEvent]:
        try:
            for line in self._resp:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec["type"] == "BOOKMARK":  # the server's liveness heartbeat
                    continue
                yield WatchEvent(rec["type"], rec["object"])
        except (OSError, ValueError, HTTPException, AttributeError):
            # a torn-down connection (an IncompleteRead mid-chunk, or the
            # close race above): the stream ends and the consumer re-watches
            return
        finally:
            self.close()


class RemoteStore:
    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- wire helpers --------------------------------------------------------
    @staticmethod
    def now() -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

    def _path(self, res: Resource, namespace: Optional[str], name: Optional[str] = None,
              subresource: Optional[str] = None) -> str:
        prefix = f"/api/{res.version}" if not res.group else f"/apis/{res.group}/{res.version}"
        parts = [prefix]
        if res.namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(res.plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 query: str = "", timeout: Optional[float] = None):
        url = self.base_url + path + (f"?{query}" if query else "")
        data = json.dumps(body).encode() if body is not None else None
        headers = {"content-type": "application/json"}
        # the apiserver's dispatch span continues this header, so the
        # caller's trace crosses the process boundary
        cur = TRACER.current_span()
        if cur is not None:
            headers["traceparent"] = format_traceparent(cur)
        req = urllib.request.Request(url, data=data, method=method, headers=headers)
        try:
            return urllib.request.urlopen(req, timeout=timeout or self.timeout)
        except urllib.error.HTTPError as e:
            payload = e.read()
            try:
                status = json.loads(payload)
            except ValueError:
                status = {"message": payload.decode(errors="replace")}
            _raise_for(status, e.code, headers=e.headers)

    def _json(self, method: str, path: str, body: Optional[Dict] = None, query: str = "") -> Any:
        with self._request(method, path, body, query) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else None

    @staticmethod
    def _selector_query(label_selector: Optional[Dict[str, str]]) -> str:
        sel = ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))
        return "labelSelector=" + urllib.request.quote(sel)

    # -- Store surface -------------------------------------------------------
    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        res = apimeta.REGISTRY.for_object(obj)
        return self._json("POST", self._path(res, apimeta.namespace_of(obj)), obj)

    def get(self, res: Resource, name: str, namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("GET", self._path(res, namespace, name))

    def list(self, res: Resource, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             field_selector: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
        query = self._selector_query(label_selector) if label_selector else ""
        items = self._json("GET", self._path(res, namespace), query=query)["items"]
        if field_selector:
            items = [o for o in items if _match_fields(o, field_selector)]
        return items

    def list_page(self, res: Resource, namespace: Optional[str] = None,
                  label_selector: Optional[Dict[str, str]] = None,
                  field_selector: Optional[Dict[str, str]] = None,
                  limit: Optional[int] = None, continue_token: Optional[str] = None):
        """One page of a paginated LIST (``limit``/``continue``): returns
        (items, rv, next_token); a stale token surfaces as Expired (410)."""
        params = []
        if limit is not None:
            params.append(f"limit={int(limit)}")
        if continue_token:
            params.append("continue=" + urllib.request.quote(continue_token))
        if label_selector:
            params.append(self._selector_query(label_selector))
        doc = self._json("GET", self._path(res, namespace), query="&".join(params))
        items = doc["items"]
        if field_selector:
            items = [o for o in items if _match_fields(o, field_selector)]
        md = doc.get("metadata") or {}
        try:
            rv = int(md.get("resourceVersion") or 0)
        except ValueError:
            rv = 0
        return items, rv, md.get("continue") or None

    def update(self, obj: Dict[str, Any], subresource: Optional[str] = None) -> Dict[str, Any]:
        res = apimeta.REGISTRY.for_object(obj)
        path = self._path(res, apimeta.namespace_of(obj), apimeta.name_of(obj), subresource)
        return self._json("PUT", path, obj)

    def update_status(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self.update(obj, subresource="status")

    def patch(self, res: Resource, name: str, patch: Dict[str, Any],
              namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("PATCH", self._path(res, namespace, name), patch)

    def delete(self, res: Resource, name: str, namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("DELETE", self._path(res, namespace, name))

    def delete_collection(self, res: Resource, namespace: Optional[str] = None,
                          label_selector: Optional[Dict[str, str]] = None) -> int:
        n = 0
        for obj in self.list(res, namespace=namespace, label_selector=label_selector):
            try:
                self.delete(res, apimeta.name_of(obj), apimeta.namespace_of(obj))
                n += 1
            except NotFound:
                pass
        return n

    def watch(self, res: Optional[Resource] = None, namespace: Optional[str] = None,
              label_selector: Optional[Dict[str, str]] = None, send_initial: bool = False,
              since_rv: Optional[int] = None, sync_marker: bool = False) -> RemoteWatch:
        if res is None:
            raise Invalid("remote watch requires a resource (no cross-kind wildcard on the wire)")
        params = ["watch=true"]
        if send_initial:
            params.append("sendInitial=true")
        if sync_marker:
            params.append("syncMarker=true")
        if since_rv is not None:
            params.append(f"resourceVersion={since_rv}")
        if label_selector:
            params.append(self._selector_query(label_selector))
        resp = self._request("GET", self._path(res, namespace), query="&".join(params),
                             timeout=3600.0)
        return RemoteWatch(resp)

    def collect_garbage(self) -> int:
        return 0  # the apiserver process runs the sweep

    def register_admission(self, hook) -> None:
        raise RuntimeError("admission runs server-side; register the hook on the "
                           "apiserver's Store")

    def wait_ready(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                with self._request("GET", "/healthz", timeout=2.0) as resp:
                    resp.read()
                return
            except Exception as e:
                last = e
                time.sleep(0.2)
        raise TimeoutError(f"apiserver at {self.base_url} not ready: {last}")
