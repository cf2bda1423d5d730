"""The controllers' client over a Store (in-process or ``RemoteStore``).

A trimmed copy of ``kubeflow_tpu/apiserver/client.py``: the verbs a
controller uses, addressed by ``(apiVersion, kind)``, so the same code runs
against the in-process store and against the REST apiserver. Every verb
retries the shed pair (429 TooManyRequests, 503 ServiceUnavailable) and
transient connection failures (refused or reset while the apiserver
restarts) with capped exponential backoff and full jitter, a server's
``Retry-After`` as the floor; timeouts and the fatal 4xx family are not
retried. ``events`` is the port's ``runtime/events.EventRecorder``.
"""

from __future__ import annotations

import http.client
import random
import time
import urllib.error
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import meta as apimeta
from ..api.meta import REGISTRY, Resource
from ..runtime.metrics import METRICS
from .store import NotFound, ServiceUnavailable, Store, TooManyRequests

#: retry policy defaults — bounded so a dead apiserver fails a verb in
#: seconds, not minutes; informers/reconcilers have their own outer loops
RETRY_MAX_ATTEMPTS = 4
RETRY_BASE_S = 0.1
RETRY_CAP_S = 5.0
#: a malicious/buggy Retry-After must not park a controller for an hour
RETRY_AFTER_CLAMP_S = 30.0


def is_transient_conn_error(exc: BaseException) -> bool:
    """True for connection-refused/reset/aborted-mid-response failures — the
    apiserver-restart window. HTTPError (a real server response) and
    timeouts (a hung, not restarting, server) are excluded on purpose."""
    if isinstance(exc, urllib.error.HTTPError):
        return False
    if isinstance(exc, urllib.error.URLError):
        exc = exc.reason if isinstance(exc.reason, BaseException) else exc
    if isinstance(exc, TimeoutError):  # socket.timeout is an alias
        return False
    return isinstance(exc, (ConnectionRefusedError, ConnectionResetError,
                            BrokenPipeError, ConnectionAbortedError,
                            http.client.RemoteDisconnected,
                            http.client.BadStatusLine))


class Client:
    def __init__(self, store: Store, event_retention: Optional[int] = None,
                 max_retries: int = RETRY_MAX_ATTEMPTS,
                 backoff_base_s: float = RETRY_BASE_S,
                 backoff_cap_s: float = RETRY_CAP_S,
                 retry_sleep: Callable[[float], None] = time.sleep,
                 retry_rng: Optional[random.Random] = None):
        self.store = store
        self._events: Optional["EventRecorder"] = None
        #: overrides EventRecorder's max_events GC cap when set — scale
        #: harnesses raise it so thousands of live gangs keep aggregating
        #: instead of churning the retention GC (see runtime/events.py)
        self.event_retention = event_retention
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        #: injectable for fake-clock tests; defaults are the real thing
        self._retry_sleep = retry_sleep
        self._retry_rng = retry_rng if retry_rng is not None else random.Random()

    def _res(self, api_version: str, kind: str) -> Resource:
        return REGISTRY.for_kind(api_version, kind)

    def backoff_delay(self, attempt: int, retry_after_s: Optional[float]) -> float:
        """Full-jitter delay for the given (0-based) attempt; a server
        Retry-After is the floor, clamped so it can't park us forever."""
        delay = self._retry_rng.uniform(
            0.0, min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt)))
        if retry_after_s:
            delay = max(delay, min(float(retry_after_s), RETRY_AFTER_CLAMP_S))
        return delay

    def _retrying(self, fn: Callable[[], Any]) -> Any:
        attempt = 0
        while True:
            try:
                return fn()
            except (TooManyRequests, ServiceUnavailable) as e:
                if attempt >= self.max_retries:
                    raise
                METRICS.counter("apiserver_client_retries_total",
                                code=str(e.code)).inc()
                self._retry_sleep(self.backoff_delay(
                    attempt, getattr(e, "retry_after_s", None)))
                attempt += 1
            except (urllib.error.URLError, http.client.BadStatusLine, OSError) as e:
                # connection refused/reset while the apiserver restarts:
                # same jittered schedule, no Retry-After to honor
                if attempt >= self.max_retries or not is_transient_conn_error(e):
                    raise
                METRICS.counter("apiserver_client_retries_total",
                                code="conn").inc()
                self._retry_sleep(self.backoff_delay(attempt, None))
                attempt += 1

    # -- verbs --------------------------------------------------------------
    def create(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self._retrying(lambda: self.store.create(obj))

    def get(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._retrying(
            lambda: self.store.get(self._res(api_version, kind), name, namespace))

    def get_opt(
        self, api_version: str, kind: str, name: str, namespace: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        try:
            return self.get(api_version, kind, name, namespace)
        except NotFound:
            return None

    def list(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        field_selector: Optional[Dict[str, str]] = None,
    ) -> List[Dict[str, Any]]:
        return self._retrying(lambda: self.store.list(
            self._res(api_version, kind),
            namespace=namespace,
            label_selector=label_selector,
            field_selector=field_selector,
        ))

    def list_paged(
        self,
        api_version: str,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        limit: int = 500,
    ) -> Tuple[List[Dict[str, Any]], int]:
        """Full collection via the paginated LIST path (limit/continue
        tokens, every page pinned to one consistent snapshot). Returns
        (items, snapshot rv) — the informer relist primitive. A stale
        continue token surfaces as Expired (410): restart from page one."""
        res = self._res(api_version, kind)
        items: List[Dict[str, Any]] = []
        token: Optional[str] = None
        rv = 0
        while True:
            page, rv, token = self._retrying(lambda tok=token: self.store.list_page(
                res, namespace=namespace, label_selector=label_selector,
                limit=limit, continue_token=tok))
            items.extend(page)
            if not token:
                return items, rv

    def update(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self._retrying(lambda: self.store.update(obj))

    def update_status(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        return self._retrying(lambda: self.store.update_status(obj))

    def patch(
        self, api_version: str, kind: str, name: str, patch: Dict[str, Any], namespace: Optional[str] = None
    ) -> Dict[str, Any]:
        return self._retrying(
            lambda: self.store.patch(self._res(api_version, kind), name, patch, namespace))

    def delete(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._retrying(
            lambda: self.store.delete(self._res(api_version, kind), name, namespace))

    def delete_opt(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> None:
        try:
            self.delete(api_version, kind, name, namespace)
        except NotFound:
            pass

    def watch(self, api_version: str, kind: str, namespace: Optional[str] = None, **kw):
        return self.store.watch(self._res(api_version, kind), namespace=namespace, **kw)

    # -- helpers ------------------------------------------------------------
    def create_or_get(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        try:
            return self.create(obj)
        except Exception:
            return self.get(
                apimeta.api_version_of(obj), obj["kind"], apimeta.name_of(obj), apimeta.namespace_of(obj)
            )

    @property
    def events(self) -> "EventRecorder":
        """The client's EventRecorder, built at first use (most clients never
        emit)."""
        if self._events is None:
            from ..runtime.events import EventRecorder

            if self.event_retention is not None:
                self._events = EventRecorder(self, max_events=self.event_retention)
            else:
                self._events = EventRecorder(self)
        return self._events

    def emit_event(
        self,
        involved: Dict[str, Any],
        reason: str,
        message: str,
        type_: str = "Normal",
        component: str = "kubeflow-tpu",
    ) -> Optional[Dict[str, Any]]:
        """Record a v1 Event against an object (reference mirrors pod events
        onto Notebook CRs — notebook_controller.go:90-109). Routed through
        the correlating :class:`EventRecorder`: a duplicate (same involved
        object, reason, component, type) bumps ``count``/``lastTimestamp``
        on the existing Event instead of minting a new object. Returns the
        stored Event, or None when the spam filter dropped it."""
        return self.events.emit(involved, reason, message, type_=type_, component=component)
