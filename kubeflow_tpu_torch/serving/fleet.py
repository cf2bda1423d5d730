"""Serving fleet: N engine replicas behind one routing plane — the port of
``kubeflow_tpu/serving/fleet.py``.

Each replica is one :class:`~kubeflow_tpu_torch.serving.continuous.ContinuousBatcher`
(its gauges labelled ``replica=<fleet name>-<id>``); every replica of one
model shares that model's parameter tensors, as the JAX fleet passes one
``params`` to every replica. On one card the replicas' worker threads all
launch on the process's current stream and wait only on their own events.

The fleet composes:

- :class:`~kubeflow_tpu_torch.serving.router.PrefixRouter`, which picks a
  replica per request (warm-prefix affinity, least-loaded fallback, 503
  when saturated);
- :class:`~kubeflow_tpu_torch.serving.autoscaler.SLOAutoscaler`, which
  calls ``scale_to`` from windowed SLO quantiles;
- per-replica :class:`ReplicaBreaker` circuit breakers fed by each
  request's ``on_done``, and a fleet-wide :class:`RetryBudget`.

Drain: ``drain_replica`` takes the replica out of the routing set, lets
its engine finish its in-flight slots (``ContinuousBatcher.drain``), then
re-submits the unserved requests to survivors. The ORIGINAL request
objects stay the callers' futures: a bridge thread copies a survivor's
result back into each, and a request that already carries its KV wire
blob (a decode replica's unadmitted import) is imported again on a
surviving decode replica rather than prefilled again.

Disaggregation: ``pools={"prefill": p, "decode": d}`` splits the fleet by
phase. Requests enter through ``role="prefill"`` engines, which hand each
finished prefill over the KV wire to the fleet's handoff sink; the sink
sends it to the least-loaded decode replica of the same model through
``submit_handoff``. ``models={model_id: (cfg, params)}`` multiplexes
several models over the same pools; ``model_slo`` maps a model to its
default admission class.

Pods: with ``client`` set (a duck type with JAX's ``create_or_get``,
``get_opt`` and ``delete_opt``), each replica also gets a Pod of a gang of
one asking for ``replica_chips`` ``nvidia.com/gpu`` cards at
``priority_class``. The replica starts ``pending`` and becomes routable
when the Pod binds to a node (its cold start ends there); a watcher thread
turns a deleted, ``Failed`` or ``Succeeded`` Pod into a drain (reason
``preempted``) and re-creates a replica up to the last ``scale_to``
target, so it re-enters the scheduler's queue. Drains and ``close`` delete
the Pod. With ``metrics_url`` the Pods also carry JAX's scrape annotations
(``monitoring.kubeflow.org/{scrape,url,job}``, the job the fleet's name),
so the monitoring plane's scraper discovers the serving process through
them; every replica shares the process, so all advertise one URL and the
scraper dedups them to one instance.
"""

from __future__ import annotations

import collections
import inspect
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..gpu.topology import RESOURCE_GPU
from ..monitoring.scrape import SCRAPE_ANNOTATION, SCRAPE_JOB_ANNOTATION, SCRAPE_URL_ANNOTATION
from ..runtime.metrics import METRICS
from ..runtime.obs import register_debug_source, unregister_debug_source
from ..runtime.tracing import TRACER
from ..scheduler.gang import POD_GROUP_LABEL, POD_GROUP_SIZE_ANNOTATION
from .errors import DeadlineExceeded, FleetSaturated
from .router import PrefixRouter

#: drain wall time: the slowest in-flight request sets it
DRAIN_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: replica created → first routable, engine construction included
COLD_START_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: how long a bridge waits on the survivor for a request with NO deadline
BRIDGE_TIMEOUT_S = 600.0

#: ceiling for the Pod watcher's crash-restart backoff
WATCHER_BACKOFF_CAP_S = 5.0

#: the client methods the Pod path calls
POD_CLIENT_METHODS = ("create_or_get", "get_opt", "delete_opt")

#: breaker gauge encoding for ``fleet_breaker_state{replica}``
BREAKER_STATE_CODES = {"closed": 0, "open": 1, "half_open": 2}

LOG = logging.getLogger(__name__)


class ReplicaBreaker:
    """Per-replica circuit breaker (closed → open → half_open → closed).

    ``record_failure`` counts CONSECUTIVE bad outcomes (errors and deadline
    expiries: a slow replica trips it as a crashing one does); at
    ``failure_threshold`` the breaker opens and ``allow()`` refuses the
    replica for ``open_s`` seconds. The first ``allow()`` after that admits
    ONE probe (half_open), whose outcome closes or re-opens it; a probe
    whose outcome never comes is presumed lost after another ``open_s``.
    ``clock`` is injectable so tests step it without sleeping.
    """

    def __init__(self, failure_threshold: int = 3, open_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_s = float(open_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def state_code(self) -> int:
        return BREAKER_STATE_CODES[self.state]

    def allow(self) -> bool:
        """May a request route to this replica now? open → half_open once
        ``open_s`` has passed (this caller is the probe); half_open refuses
        while its probe is out."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.open_s:
                    self._state = "half_open"
                    self._probe_at = self._clock()
                    return True
                return False
            if self._clock() - self._probe_at >= self.open_s:
                self._probe_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                # the probe failed: open again, with a fresh window
                self._state = "open"
                self._opened_at = self._clock()
                return
            self._consecutive_failures += 1
            if (self._state == "closed"
                    and self._consecutive_failures >= self.failure_threshold):
                self._state = "open"
                self._opened_at = self._clock()


class RetryBudget:
    """Token bucket bounding fleet-level retries: every first submission
    deposits ``ratio`` tokens (up to ``cap``), every retry withdraws one, so
    retries stay within ``ratio`` × the request rate. Starts full."""

    def __init__(self, ratio: float = 0.1, cap: float = 10.0):
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = float(cap)
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_withdraw(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
        METRICS.counter("fleet_retry_budget_exhausted_total").inc()
        return False


@dataclass
class ReplicaHandle:
    """Fleet-side record of one engine replica."""

    id: str
    engine: Any
    gauge_id: str  # the engine's ``replica`` gauge label
    state: str = "pending"  # pending | ready | draining | stopped
    role: str = "unified"  # unified | prefill | decode
    model_id: str = ""  # the multiplexed model it serves ("" = the only one)
    #: LRU of prefix keys routed here (contents owned by PrefixRouter)
    prefixes: "collections.OrderedDict" = field(default_factory=collections.OrderedDict)
    started_at: float = field(default_factory=time.monotonic)
    breaker: ReplicaBreaker = field(default_factory=ReplicaBreaker)
    pod_name: Optional[str] = None
    node: Optional[str] = None


class EngineFleet:
    """Replica manager for continuous-batching engines.

    ``engine_factory(engine_id, role=..., model_id=...) -> engine``
    defaults to building a :class:`ContinuousBatcher` on ``device`` from
    ``cfg``/``params`` (or ``models[model_id]``) with ``slots``, ``chunk``,
    ``pipeline`` and ``engine_kwargs``; tests inject fakes (a factory that
    takes only the engine id builds unified, single-model fleets). Without
    ``client`` every replica is routable as soon as its engine is built;
    with one, once its Pod binds (the module's docstring).
    """

    #: attempts per submit (first + retries); each retry also needs a
    #: retry-budget token
    MAX_ATTEMPTS = 3

    def __init__(self, cfg: Any = None, params: Any = None, *,
                 replicas: int = 1, min_replicas: int = 1,
                 max_replicas: int = 8, slots: int = 8, chunk: int = 16,
                 pipeline: int = 3, name: str = "fleet",
                 router: Optional[PrefixRouter] = None,
                 engine_factory: Optional[Callable[..., Any]] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 pools: Optional[Dict[str, int]] = None,
                 models: Optional[Dict[str, Tuple[Any, Any]]] = None,
                 model_slo: Optional[Dict[str, str]] = None,
                 client: Any = None, namespace: str = "default",
                 replica_chips: int = 0, priority_class: str = "default",
                 poll_interval: float = 0.2, register_debug: bool = True,
                 breaker_factory: Optional[Callable[[], ReplicaBreaker]] = None,
                 retry_budget: Optional[RetryBudget] = None,
                 metrics_url: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        if client is not None:
            missing = [m for m in POD_CLIENT_METHODS if not callable(getattr(client, m, None))]
            if missing:
                raise TypeError(f"EngineFleet(client=...): the client lacks {missing}")
        self.device = resolve_device(device)
        self.name = name
        #: /metrics URL the replica Pods advertise for scrape discovery
        self._metrics_url = metrics_url
        self._breaker_factory = breaker_factory or ReplicaBreaker
        self.retry_budget = retry_budget or RetryBudget()
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.router = router or PrefixRouter()
        self._client = client
        self._namespace = namespace
        self._replica_chips = int(replica_chips)
        self._priority_class = priority_class
        self._poll_interval = poll_interval
        if pools is not None:
            if (set(pools) != {"prefill", "decode"}
                    or any(int(n) < 1 for n in pools.values())):
                raise ValueError("pools must map BOTH 'prefill' and 'decode' to >= 1 "
                                 f"replicas, got {pools!r}")
        self._pools_cfg = {k: int(v) for k, v in pools.items()} if pools else None
        self._models = dict(models) if models else None
        #: model ids replicas are built for ("" = the single anonymous one)
        self._model_ids = list(self._models) if self._models else [""]
        self._model_slo = dict(model_slo or {})
        for mid in self._model_slo:
            if self._models is not None and mid not in self._models:
                raise ValueError(f"model_slo names unknown model {mid!r}")
        if engine_factory is None:
            if self._models is None and (cfg is None or params is None):
                raise ValueError("EngineFleet needs cfg+params, models=, or an engine_factory")

            def engine_factory(engine_id: str, role: str = "unified", model_id: str = ""):
                from .continuous import ContinuousBatcher

                mcfg, mparams = self._models[model_id] if self._models else (cfg, params)
                return ContinuousBatcher(
                    mcfg, mparams, slots=slots, chunk=chunk, pipeline=pipeline,
                    engine_id=engine_id, role=role, model_id=model_id,
                    handoff_sink=self._handoff_sink if role == "prefill" else None,
                    device=self.device, **(engine_kwargs or {}))

        self._factory = engine_factory
        # a factory that cannot take role=/model_id= builds unified,
        # single-model fleets only
        try:
            sig = inspect.signature(self._factory)
            self._factory_pool_aware = (
                "role" in sig.parameters
                or any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values()))
        except (TypeError, ValueError):
            self._factory_pool_aware = False
        self._lock = threading.RLock()
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._next_id = 0
        self._closed = False
        #: recent drains and scale actions for /debug/fleet
        self._drains: "collections.deque" = collections.deque(maxlen=32)
        self._scale_log: "collections.deque" = collections.deque(maxlen=32)
        #: the last scale_to target a (role, model): the watcher restores a
        #: preempted replica's pool to it
        self._targets: Dict[Tuple[str, str], int] = {}
        if self._pools_cfg:
            # each pool keeps >= 1 replica per model: a fleet without a
            # prefill (or a decode) replica can serve nothing
            self._pool_min = {r: 1 for r in self._pools_cfg}
            self._pool_max = {r: self.max_replicas for r in self._pools_cfg}
            for role, count in self._pools_cfg.items():
                self.scale_to(count, reason="initial", pool=role)
        else:
            self._pool_min = {"unified": self.min_replicas}
            self._pool_max = {"unified": self.max_replicas}
            self.scale_to(max(self.min_replicas, min(int(replicas), self.max_replicas)),
                          reason="initial")
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if client is not None:
            self._watcher = threading.Thread(target=self._watch_pods,
                                             name=f"{name}-pod-watcher", daemon=True)
            self._watcher.start()
        #: the /debug/fleet handler, unregistered by close(): the registry is
        #: process-global, and a closed fleet it held would keep its engines'
        #: weights alive
        self._debug_handler: Optional[Callable[[Any], Dict[str, Any]]] = None
        if register_debug:
            self._debug_handler = lambda query: self.debug_snapshot()
            register_debug_source("fleet", self._debug_handler)

    # -- sizing --------------------------------------------------------------
    @property
    def desired_replicas(self) -> int:
        with self._lock:
            return sum(1 for h in self._replicas.values() if h.state in ("pending", "ready"))

    def live_handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return [h for h in self._replicas.values() if h.state in ("pending", "ready")]

    @property
    def pools(self) -> Optional[Dict[str, int]]:
        """Configured role pools (None: a unified fleet); the autoscaler
        evaluates per pool when this is set."""
        return dict(self._pools_cfg) if self._pools_cfg else None

    def _default_pool(self) -> str:
        # the pool callers compete for: decode's slots when disaggregated
        return "decode" if self._pools_cfg else "unified"

    def _pool_handles(self, role: str, model_id: str) -> List[ReplicaHandle]:
        """Caller holds the lock."""
        return [h for h in self._replicas.values()
                if h.role == role and h.model_id == model_id
                and h.state in ("pending", "ready")]

    def pool_size(self, pool: Optional[str] = None) -> int:
        """Live replicas in ``pool``, per model (every model keeps the same
        per-pool count, so this is the max)."""
        role = pool or self._default_pool()
        with self._lock:
            return max((len(self._pool_handles(role, mid)) for mid in self._model_ids),
                       default=0)

    def scale_to(self, n: int, reason: str = "", pool: Optional[str] = None) -> None:
        """Grow or shrink ``pool`` to ``n`` live replicas PER MODEL, clamped
        to the pool's bounds (``pool=None``: the unified pool, or decode
        when disaggregated). Shrinking drains the newest replicas; their
        unserved requests re-queue to the survivors."""
        role = pool or self._default_pool()
        lo = self._pool_min.get(role, 1)
        hi = self._pool_max.get(role, self.max_replicas)
        n = max(lo, min(int(n), hi))
        victims: List[str] = []
        with self._lock:
            if self._closed:
                return
            for mid in self._model_ids:
                self._targets[(role, mid)] = n
                handles = self._pool_handles(role, mid)
                current = len(handles)
                while current < n:
                    self._add_replica(role=role, model_id=mid)
                    current += 1
                if current > n:
                    handles.sort(key=lambda h: h.started_at, reverse=True)
                    victims.extend(h.id for h in handles[: current - n])
            self._scale_log.append({"at": time.time(), "to": n, "pool": role,
                                    "reason": reason})
        for rid in victims:
            self.drain_replica(rid, reason=reason or "scale_down")
        self._set_replica_gauge()

    def _add_replica(self, role: str = "unified", model_id: str = "") -> ReplicaHandle:
        """Caller holds the lock."""
        created_at = time.monotonic()
        rid = str(self._next_id)
        self._next_id += 1
        gauge_id = f"{self.name}-{rid}"
        if self._factory_pool_aware:
            engine = self._factory(gauge_id, role=role, model_id=model_id)
        elif role != "unified" or model_id:
            raise ValueError("engine_factory must accept role=/model_id= keywords to "
                             "build pooled or multi-model replicas")
        else:
            engine = self._factory(gauge_id)
        # cold start runs from before the engine was built: its allocations
        # and worker start are inside the measurement
        handle = ReplicaHandle(id=rid, engine=engine, gauge_id=gauge_id, role=role,
                               model_id=model_id, started_at=created_at,
                               breaker=self._breaker_factory())
        METRICS.gauge("fleet_breaker_state", replica=gauge_id).set(handle.breaker.state_code)
        if self._client is not None:
            handle.pod_name = gauge_id
            self._client.create_or_get(self._pod_body(handle))
            handle.state = "pending"  # routable once its Pod binds
        else:
            handle.state = "ready"
            self._observe_cold_start(handle)
        self._replicas[rid] = handle
        return handle

    @staticmethod
    def _observe_cold_start(handle: ReplicaHandle) -> None:
        METRICS.histogram("fleet_replica_cold_start_seconds", buckets=COLD_START_BUCKETS
                          ).observe(time.monotonic() - handle.started_at)

    def _set_replica_gauge(self) -> None:
        METRICS.gauge("fleet_replicas").set(self.desired_replicas)
        if self._pools_cfg:
            with self._lock:
                for role in self._pools_cfg:
                    n = sum(1 for h in self._replicas.values()
                            if h.role == role and h.state in ("pending", "ready"))
                    METRICS.gauge("fleet_pool_replicas", pool=role).set(n)

    # -- Pods ------------------------------------------------------------------
    def _pod_body(self, handle: ReplicaHandle) -> Dict[str, Any]:
        """JAX's replica Pod, field for field, asking for ``nvidia.com/gpu``
        cards where JAX asks for ``google.com/tpu`` chips; with
        ``metrics_url``, JAX's three scrape annotations too."""
        container: Dict[str, Any] = {"name": "engine", "image": "kubeflow-tpu/model-server"}
        if self._replica_chips > 0:
            container["resources"] = {"limits": {RESOURCE_GPU: str(self._replica_chips)}}
        meta: Dict[str, Any] = {"name": handle.pod_name}
        if self._namespace is not None:
            meta["namespace"] = self._namespace
        meta["labels"] = {POD_GROUP_LABEL: handle.pod_name, "app": "serving-fleet",
                          "fleet": self.name}
        meta["annotations"] = {POD_GROUP_SIZE_ANNOTATION: "1"}
        if self._metrics_url:
            meta["annotations"].update({SCRAPE_ANNOTATION: "true",
                                        SCRAPE_URL_ANNOTATION: self._metrics_url,
                                        SCRAPE_JOB_ANNOTATION: self.name})
        return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                "spec": {"priorityClassName": self._priority_class,
                         "containers": [container]}}

    def _watch_pods(self) -> None:
        """Thread target: the poll loop, restarted with exponential backoff
        (and counted) when it raises, so the one thread that notices
        preempted replicas never dies silently."""
        backoff = max(self._poll_interval, 0.01)
        while not self._stop.is_set():
            try:
                self._watch_pods_loop()
                return  # _stop set: clean shutdown
            except Exception:
                LOG.exception("fleet %s: pod watcher crashed; restarting in %.2fs",
                              self.name, backoff)
                METRICS.counter("fleet_watcher_restarts_total").inc()
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, WATCHER_BACKOFF_CAP_S)

    def _watch_pods_loop(self) -> None:
        """Poll the replicas' Pods: a bind promotes pending → ready; a
        deleted or finished Pod drains the replica and re-creates one up to
        the pool's last target."""
        while not self._stop.wait(self._poll_interval):
            with self._lock:
                handles = list(self._replicas.values())
            for h in handles:
                if h.pod_name is None or h.state in ("draining", "stopped"):
                    continue
                try:
                    pod = self._client.get_opt("v1", "Pod", h.pod_name, self._namespace)
                except Exception:
                    continue  # an apiserver hiccup: keep the last known state
                phase = ((pod or {}).get("status") or {}).get("phase")
                if pod is None or phase in ("Failed", "Succeeded"):
                    self.drain_replica(h.id, reason="preempted")
                    with self._lock:
                        tgt = self._targets.get((h.role, h.model_id), 0)
                        if (not self._closed
                                and len(self._pool_handles(h.role, h.model_id)) < tgt):
                            self._add_replica(role=h.role, model_id=h.model_id)
                    self._set_replica_gauge()
                    continue
                node = (pod.get("spec") or {}).get("nodeName")
                if h.state == "pending" and node:
                    promoted = False
                    with self._lock:
                        if h.state == "pending":
                            h.state = "ready"
                            h.node = node
                            promoted = True
                    if promoted:
                        self._observe_cold_start(h)

    def wait_ready(self, n: Optional[int] = None, timeout: float = 30.0) -> bool:
        """Block until ``n`` (default: every live one) replicas are routable."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                ready = sum(1 for h in self._replicas.values() if h.state == "ready")
                want = n if n is not None else self.desired_replicas
            if ready >= want:
                return True
            time.sleep(0.02)
        return False

    # -- request path --------------------------------------------------------
    def _record_outcome(self, handle: ReplicaHandle, ok: bool) -> None:
        """Breaker feedback: errors and deadline expiries are failures."""
        (handle.breaker.record_success if ok else handle.breaker.record_failure)()
        METRICS.gauge("fleet_breaker_state", replica=handle.gauge_id).set(
            handle.breaker.state_code)

    def _note_tenant_tokens(self, direction: str, n: int) -> None:
        """Per-tenant token metering (the fleet's namespace is the tenant):
        ``in`` = prompt tokens admitted, ``out`` = tokens delivered."""
        if n > 0:
            METRICS.counter("tenant_tokens_total", namespace=self._namespace or "default",
                            direction=direction).inc(n)

    def _outcome_cb(self, handle: ReplicaHandle) -> Callable[[Any], None]:
        def on_done(req: Any) -> None:
            # delivered tokens count whatever the outcome: a cancelled
            # request delivered what it streamed
            self._note_tenant_tokens("out", len(getattr(req, "tokens", ()) or ()))
            reason = getattr(req, "finish_reason", None)
            if reason == "cancelled":
                return  # the client walked away: nothing about the replica
            if isinstance(getattr(req, "error", None), FleetSaturated):
                return  # a queue-full shed is back-pressure, not ill health
            self._record_outcome(handle, ok=req.error is None and reason != "deadline")
        return on_done

    def _admissible(self) -> List[ReplicaHandle]:
        """Live handles whose breaker admits traffic now (``allow()`` flips
        an expired open breaker to half_open: the request is the probe)."""
        out = []
        for h in self.live_handles():
            allowed = h.breaker.allow()
            METRICS.gauge("fleet_breaker_state", replica=h.gauge_id).set(
                h.breaker.state_code)
            if allowed:
                out.append(h)
        return out

    def submit(self, prompt_ids, max_new_tokens: int, eos_id: Optional[int] = None,
               temperature: float = 0.0, traceparent: Optional[str] = None,
               deadline: Optional[float] = None, priority: Optional[str] = None,
               model: str = ""):
        """Route and submit; the signature and return of
        ``ContinuousBatcher.submit``, plus ``model`` (required with
        ``models=``). ``priority=None`` takes the model's class from
        ``model_slo`` (default interactive). With pools the request enters
        through the prefill pool and continues on a decode replica behind
        the same returned request. Replicas whose breaker is open are not
        routed to; retries after the first attempt draw on the retry
        budget. Raises :class:`FleetSaturated` (HTTP 503) when no replica
        can take the request."""
        if self._models is not None and model not in self._models:
            raise ValueError(f"unknown model {model!r}: fleet serves {sorted(self._models)}")
        if priority is None:
            priority = self._model_slo.get(model, "interactive")
        entry_role = "prefill" if self._pools_cfg else "unified"
        self.retry_budget.deposit()
        last_err: Optional[BaseException] = None
        for attempt in range(self.MAX_ATTEMPTS):
            if attempt > 0 and not self.retry_budget.try_withdraw():
                raise FleetSaturated(f"retry budget exhausted after replica failure: {last_err}")
            with self._lock:
                if self._closed:
                    raise RuntimeError("fleet closed")
                live = [h for h in self.live_handles()
                        if h.role == entry_role and h.model_id == model]
                admissible = [h for h in self._admissible()
                              if h.role == entry_role and h.model_id == model]
                if live and not admissible:
                    raise FleetSaturated(f"all {len(live)} replica breakers open",
                                         retry_after_s=self.router.retry_after_hint(live))
                handle, _policy = self.router.route(admissible, prompt_ids,
                                                    priority=priority, model_id=model)
                try:
                    fut = handle.engine.submit(
                        prompt_ids, max_new_tokens, eos_id=eos_id, temperature=temperature,
                        traceparent=traceparent, deadline=deadline, priority=priority,
                        on_done=self._outcome_cb(handle))
                    self._note_tenant_tokens("in", len(prompt_ids))
                    return fut
                except RuntimeError as e:
                    # the engine closed outside the fleet (a poisoned step):
                    # retire the handle and route again among the survivors
                    handle.state = "stopped"
                    self._record_outcome(handle, ok=False)
                    last_err = e
        raise FleetSaturated(f"no replica accepted the request: {last_err}")

    def _handoff_sink(self, req: Any, blob: bytes) -> None:
        """Prefill engines call this from their worker thread with a
        finished prefill's KV wire blob: route it to the least-loaded decode
        replica of the same model. ``submit_handoff`` continues the
        ORIGINAL request object. If no decode replica takes it, the request
        fails (the client's retry enters through the prefill pool again)."""
        model = getattr(req, "model_id", "") or ""
        last_err: Optional[BaseException] = None
        for _ in range(self.MAX_ATTEMPTS):
            with self._lock:
                if self._closed:
                    last_err = RuntimeError("fleet closed mid-handoff")
                    break
                cands = [h for h in self._admissible()
                         if h.role == "decode" and h.model_id == model]
            if not cands:
                last_err = FleetSaturated(f"no decode replica for model {model!r}")
                break
            handle = min(cands, key=self.router.load_score)
            try:
                # the decode replica owns the outcome now: rebind before the
                # import can finish
                req.on_done = self._outcome_cb(handle)
                handle.engine.submit_handoff(req, blob)
            except Exception as e:  # a refused blob or a closed replica: try another
                req.on_done = None
                last_err = e
                continue
            # the warm KV lives on the decode replica now
            self.router.note_prefix(handle, req.prompt, model)
            return
        self._fail_request(req, last_err or RuntimeError("KV handoff found no route"))

    # -- drain ----------------------------------------------------------------
    def drain_replica(self, rid: str, reason: str = "scale_down") -> int:
        """Drain one replica and re-queue its unserved requests to the
        survivors; returns how many were re-queued. Blocks until the engine
        has finished its in-flight slots."""
        with self._lock:
            handle = self._replicas.get(rid)
            if handle is None or handle.state in ("draining", "stopped"):
                return 0
            handle.state = "draining"
        t0 = time.perf_counter()
        try:
            unserved = handle.engine.drain()
        except Exception:  # a dead engine hands back nothing; its requests already failed
            LOG.exception("fleet %s: drain of replica %s failed", self.name, handle.gauge_id)
            unserved = []
        drain_s = time.perf_counter() - t0
        METRICS.histogram("fleet_drain_seconds", buckets=DRAIN_BUCKETS).observe(drain_s)
        requeued = self._requeue(unserved, exclude=rid)
        with self._lock:
            handle.state = "stopped"
            handle.prefixes.clear()  # its KV is gone with it
            self._replicas.pop(rid, None)
        if handle.pod_name is not None:
            try:
                self._client.delete_opt("v1", "Pod", handle.pod_name, self._namespace)
            except Exception:  # a preemption may have deleted it already
                LOG.exception("fleet %s: delete of pod %s failed", self.name, handle.pod_name)
        self._drains.append({"replica": handle.gauge_id, "reason": reason,
                             "seconds": round(drain_s, 4), "requeued": requeued,
                             "at": time.time()})
        self._set_replica_gauge()
        return requeued

    def _requeue(self, unserved: List[Any], exclude: str) -> int:
        """Re-submit drained requests to surviving replicas. A request that
        carries its KV blob is imported again on a surviving decode replica
        (its prefill is paid for; the same request object continues);
        otherwise it is submitted afresh, and a bridge thread copies the
        survivor's outcome into the original request."""
        requeued = 0
        entry_role = "prefill" if self._pools_cfg else "unified"
        for req in unserved:
            # the outcome belongs to the survivor, which gets its own callback
            if hasattr(req, "on_done"):
                req.on_done = None
            model = getattr(req, "model_id", "") or ""
            blob = getattr(req, "kv_blob", None)
            if blob is not None and self._pools_cfg:
                with self._lock:
                    cands = [h for h in self.live_handles()
                             if h.role == "decode" and h.model_id == model and h.id != exclude]
                imported = False
                for handle in sorted(cands, key=self.router.load_score):
                    try:
                        req.on_done = self._outcome_cb(handle)
                        handle.engine.submit_handoff(req, blob)
                        imported = True
                        break
                    except Exception:  # this survivor refused it: try the next
                        req.on_done = None
                if imported:
                    requeued += 1
                    METRICS.counter("fleet_requeued_total").inc()
                    continue
                # no decode survivor took it: submit afresh (prefill again)
            try:
                with self._lock:
                    handles = [h for h in self.live_handles()
                               if h.role == entry_role and h.model_id == model]
                    handle, _policy = self.router.route(
                        handles, req.prompt, exclude=exclude,
                        priority=getattr(req, "priority", "interactive"), model_id=model)
                    shadow = handle.engine.submit(
                        req.prompt, req.max_new_tokens, eos_id=req.eos_id,
                        temperature=req.temperature, deadline=getattr(req, "deadline", None),
                        priority=getattr(req, "priority", "interactive"),
                        on_done=self._outcome_cb(handle))
            except Exception as e:  # no survivor took it: fail it, never hang it
                self._fail_request(req, e)
                continue
            requeued += 1
            METRICS.counter("fleet_requeued_total").inc()
            threading.Thread(target=self._bridge, args=(req, shadow),
                             name=f"{self.name}-handoff", daemon=True).start()
        return requeued

    @staticmethod
    def _bridge(original: Any, shadow: Any) -> None:
        """Wait for the survivor's ``shadow`` (its remaining deadline plus
        5 s, or ``BRIDGE_TIMEOUT_S`` without one) and copy its outcome into
        ``original``."""
        deadline = getattr(shadow, "deadline", None)
        if deadline is not None:
            timeout = max(0.0, deadline - time.monotonic()) + 5.0
        else:
            timeout = BRIDGE_TIMEOUT_S
        done = shadow.done.wait(timeout=timeout)
        original.tokens = list(shadow.tokens)
        original.finish_reason = getattr(shadow, "finish_reason", None)
        if done:
            error = shadow.error
        elif deadline is not None:
            error = DeadlineExceeded("handoff request missed its deadline")
        else:
            error = TimeoutError("handoff request not finished")
        span = getattr(original, "span", None)
        if span is not None:
            span.add_event("requeued")
            TRACER.end_span(span, error=error)
            original.span = None
        original.error = error
        original.done.set()

    @staticmethod
    def _fail_request(req: Any, error: BaseException) -> None:
        span = getattr(req, "span", None)
        if span is not None:
            TRACER.end_span(span, error=error)
            req.span = None
        req.error = error
        req.done.set()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._closed = True
            handles = list(self._replicas.values())
            self._replicas.clear()
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10)
        if self._debug_handler is not None:
            unregister_debug_source("fleet", self._debug_handler)
        for h in handles:
            try:
                h.engine.close()
            except Exception:  # one replica's close must not leave the others running
                LOG.exception("fleet %s: close of replica %s failed", self.name, h.gauge_id)
            if h.pod_name is not None:
                try:
                    self._client.delete_opt("v1", "Pod", h.pod_name, self._namespace)
                except Exception:
                    LOG.exception("fleet %s: delete of pod %s failed", self.name, h.pod_name)
        self._set_replica_gauge()

    # -- debug surface -------------------------------------------------------
    def debug_snapshot(self) -> Dict[str, Any]:
        reg = self.router._registry
        with self._lock:
            replicas = [{
                "id": h.gauge_id,
                "state": h.state,
                "role": h.role,
                "model": h.model_id,
                "queue_depth": reg.value("serving_queue_depth", replica=h.gauge_id),
                "active_slots": reg.value("serving_continuous_active_slots",
                                          replica=h.gauge_id),
                "slot_occupancy": reg.value("serving_slot_occupancy", replica=h.gauge_id),
                "warm_prefixes": len(h.prefixes),
                "breaker": h.breaker.state,
                "pod": h.pod_name,
                "node": h.node,
            } for h in self._replicas.values()]
            scale_log = list(self._scale_log)
            drains = list(self._drains)
        return {
            "fleet": self.name,
            "desired_replicas": self.desired_replicas,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "replicas": replicas,
            "retry_budget_tokens": round(self.retry_budget.tokens, 3),
            "router": {
                "max_queue_depth": self.router.max_queue_depth,
                "prefix_len": self.router.prefix_len,
                "routed": {p: METRICS.value("fleet_routed_total", policy=p)
                           for p in ("prefix", "prefix_spill", "least_loaded")},
                "prefix_hits": METRICS.value("fleet_prefix_hits_total"),
                "saturated": METRICS.value("fleet_saturated_total"),
            },
            "scale_log": scale_log,
            "drains": drains,
        }
