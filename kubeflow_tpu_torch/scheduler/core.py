"""SchedulerReconciler: gang-aware pod-to-node binding on ``nvidia.com/gpu``
nodes.

The port of ``kubeflow_tpu/scheduler/core.py``, the one writer of
``spec.nodeName`` in the control plane. One scheduling cycle:

1. derive the pod's gang (labelled pod group or implicit gang of one) and
   list its members;
2. while the gang is still assembling, hold a reservation for the FULL
   expected size, so interleaved arrivals cannot strand it half placed,
   and wait (the hold is released on the assembly timeout);
3. admit against the namespace ResourceQuota: cards bound in the namespace
   plus the gang's ask against ``requests.nvidia.com/gpu``;
4. place all members all-or-nothing against the ledger's cached free
   cards (selector match, best fit), bind each with an optimistic-
   concurrency retry, and release the hold;
5. infeasible: preempt the lowest-priority running gang whose cards make
   the placement feasible (reserve first, then evict, or ask a victim that
   opted into drain grace to checkpoint and wait for its ack);
6. still stuck: mark the pods Unschedulable, write ONE aggregated
   ``FailedScheduling`` Event per pod, and requeue with per-gang
   exponential backoff.

Metrics live under ``scheduler_`` (``bind_latency_seconds`` carries the
gang's trace id as an exemplar); every gang's journey is one
``gang.lifecycle`` trace, parented to the pod's creation traceparent, with
the bind traceparent stamped on each bound pod. Its Events come from the
component ``gpu-scheduler`` (JAX: ``tpu-scheduler``).
``python -m kubeflow_tpu_torch.scheduler.core`` runs it as its own process
(``runtime/bootstrap.run_role``); it imports no torch.
"""

from __future__ import annotations

import calendar
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..api import meta as apimeta
from ..apiserver.client import Client
from ..apiserver.store import Conflict, NotFound
from ..runtime.manager import Reconciler, Request, Result
from ..runtime.metrics import METRICS
from ..runtime.tracing import (
    BIND_TRACEPARENT_ANNOTATION,
    TRACEPARENT_ANNOTATION,
    TRACER,
    Span,
    format_traceparent,
)
from ..gpu.topology import chips_in_quota, pod_gpu_chips
from .flight import (
    Decision,
    FlightRecorder,
    dominant_node_reason,
    failed_scheduling_message,
    truncate_node_verdicts,
)
from .gang import (
    DRAIN_ACK_ANNOTATION,
    DRAIN_DEADLINE_ANNOTATION,
    POD_GROUP_LABEL,
    QUOTA_NAME,
    GPU_QUOTA_KEY,
    Gang,
    drain_grace_of,
    gang_of,
    is_terminal,
    requires_scheduling,
)
from .ledger import ChipLedger, GangKey

SCHED = METRICS.namespace("scheduler")

#: Event source.component for everything this scheduler writes
COMPONENT = "gpu-scheduler"


class BackoffQueue:
    """Per-gang exponential scheduling backoff, capped.

    Each consecutive failure doubles the delay up to ``cap`` (a flat
    requeue would poll every stuck pod forever); any success (or the gang
    vanishing) forgets the entry so the next contention starts fast
    again.
    """

    def __init__(self, base: float = 0.05, cap: float = 5.0) -> None:
        self.base = base
        self.cap = cap
        self._fails: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def next_delay(self, key: Any) -> float:
        with self._lock:
            n = self._fails.get(key, 0)
            self._fails[key] = n + 1
        return min(self.base * (2 ** n), self.cap)

    def forget(self, key: Any) -> None:
        with self._lock:
            self._fails.pop(key, None)

    def failures(self, key: Any) -> int:
        with self._lock:
            return self._fails.get(key, 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._fails)


class SchedulerReconciler(Reconciler):
    FOR = ("v1", "Pod")

    def __init__(
        self,
        assembly_timeout: float = 30.0,
        reservation_ttl: float = 10.0,
        backoff_base: float = 0.05,
        backoff_cap: float = 5.0,
        verdict_top_k: int = 8,
        cycles_window_s: float = 30.0,
    ) -> None:
        self.ledger = ChipLedger()
        self.backoff = BackoffQueue(backoff_base, backoff_cap)
        # every cycle's verdict, served at GET /debug/scheduler (flight.py)
        self.flight = FlightRecorder()
        self.assembly_timeout = assembly_timeout
        self.reservation_ttl = reservation_ttl
        #: per-decision node-verdict cap; beyond it, verdicts aggregate into
        #: one summary row per reason (flight.truncate_node_verdicts)
        self.verdict_top_k = verdict_top_k
        self.cycles_window_s = cycles_window_s
        self._wired = False
        self._lock = threading.Lock()
        #: monotonic completion times of recent scheduling cycles, feeding
        #: the scheduler_cycles_per_sec gauge at scrape time
        self._cycle_times: "deque[float]" = deque(maxlen=65536)
        METRICS.register_collector("scheduler_cycle_rate", self._collect_cycle_rate)
        #: gang → a member pod to requeue when a node appears
        self._pending: Dict[GangKey, Tuple[Optional[str], str]] = {}
        #: gang → monotonic time of its first scheduling attempt
        self._first_attempt: Dict[GangKey, float] = {}
        #: pod key → gang key, for cleanup when a pod vanishes
        self._gang_of_pod: Dict[Tuple[Optional[str], str], GangKey] = {}
        #: victim gang → in-flight drain (docs/ELASTICITY.md): who asked,
        #: the grace deadline, and the pods/chips the eviction will free
        self._draining: Dict[GangKey, Dict[str, Any]] = {}
        #: gang → its lifecycle root span: opened at gang submit (first
        #: scheduling attempt), parented to the submitting client's trace
        #: via the creation-traceparent annotation, closed by _gang_done /
        #: _pod_gone; every cycle/quota/preempt/bind span hangs under it
        self._gang_spans: Dict[GangKey, Span] = {}

    def watches(self):
        def wake_pending(_node: Dict[str, Any]) -> List[Request]:
            # New/changed capacity: re-kick one representative per pending
            # gang instead of waiting out its backoff.
            with self._lock:
                return [Request(ns, name) for (ns, name) in self._pending.values()]

        return [(("v1", "Node"), wake_pending)]

    # -- ledger wiring -------------------------------------------------------

    def _ensure_wired(self, client: Client) -> None:
        if self._wired:
            return
        if self.cache is None:
            # Unit-test mode: no informers; sync_from runs per cycle instead.
            self._wired = True
            return
        node_inf = self.cache.informer_for("v1", "Node")
        pod_inf = self.cache.informer_for("v1", "Pod")
        node_inf.add_event_handler(self.ledger.on_node_event)
        pod_inf.add_event_handler(self.ledger.on_pod_event)
        node_inf.wait_synced()
        pod_inf.wait_synced()
        # Handlers only see future events; backfill the synced mirror. A
        # double-apply from the overlap window is harmless — records are
        # keyed by pod identity and writes are idempotent.
        for node in node_inf.list():
            self.ledger.on_node_event("ADDED", node)
        for pod in pod_inf.list():
            self.ledger.on_pod_event("ADDED", pod)
        self._wired = True

    # -- reconcile -----------------------------------------------------------

    def reconcile(self, client: Client, req: Request) -> Result:
        self._ensure_wired(client)
        if self.cache is None:
            self.ledger.sync_from(client.list("v1", "Node"), client.list("v1", "Pod"))
        pod = client.get_opt("v1", "Pod", req.name, req.namespace)
        if pod is None or is_terminal(pod):
            self._pod_gone((req.namespace, req.name))
            return Result()
        if (pod.get("spec") or {}).get("nodeName"):
            self._gang_done(gang_of(pod).key, bound=False)
            return Result()
        if not requires_scheduling(pod, self.ledger.has_nodes()):
            return Result()

        gang = gang_of(pod)
        key = gang.key
        with self._lock:
            self._gang_of_pod[(req.namespace, req.name)] = key
            self._first_attempt.setdefault(key, time.monotonic())
            root = self._gang_spans.get(key)
        if root is None:
            # Gang submit: open the lifecycle root. Parent preference is the
            # pod's creation traceparent (the client call that submitted the
            # gang), falling back to the current reconcile span — either way
            # the whole gang journey shares one trace id.
            root = TRACER.start_span(
                "gang.lifecycle",
                traceparent=apimeta.annotations_of(pod).get(
                    TRACEPARENT_ANNOTATION),
                gang=f"{key[0]}/{key[1]}", size=gang.size)
            with self._lock:
                root = self._gang_spans.setdefault(key, root)
        with TRACER.span(
            "schedule", parent=root, controller=type(self).__name__,
            gang=f"{key[0]}/{key[1]}"
        ) as span:
            outcome, delay = self._schedule_gang(client, gang, pod, span)
            span.set("outcome", outcome)
        with self._lock:
            self._cycle_times.append(time.monotonic())
        SCHED.counter("attempts_total", result=outcome).inc()
        with self._lock:
            SCHED.gauge("pending_gangs").set(len(self._pending))
        return Result(requeue_after=delay) if delay else Result()

    def _schedule_gang(
        self, client: Client, gang: Gang, pod: Dict[str, Any], span
    ) -> Tuple[str, float]:
        key = gang.key
        members = self._members(client, gang, pod)
        unbound = [
            p for p in members
            if not (p.get("spec") or {}).get("nodeName") and not is_terminal(p)
        ]
        span.set("members", len(members))
        span.set("unbound", len(unbound))
        if not unbound:
            self._gang_done(key, bound=False)
            return "noop", 0.0

        if len(members) < gang.size:
            return self._await_assembly(client, gang, pod, span)

        # Quota admission: cards already bound in the namespace plus this
        # gang's ask must fit the Profile's hard GPU limit.
        needed = sum(pod_gpu_chips(p) for p in unbound)
        if needed:
            with TRACER.span("schedule.quota", namespace=str(gang.namespace),
                             chips=needed) as qspan:
                hard = self._quota_hard(client, gang.namespace)
                denied = False
                if hard is not None:
                    bound_ns = self.ledger.used_in_namespace(gang.namespace)
                    denied = bound_ns + needed > hard
                qspan.set("admitted", not denied)
            if denied:
                msg = (
                    f"namespace GPU quota exceeded: {bound_ns} chips bound + "
                    f"{needed} requested > {hard} allowed"
                )
                self._mark_unschedulable(client, unbound, msg)
                self._note_pending(key, unbound[0])
                delay = self.backoff.next_delay(key)
                self._record(
                    client, gang, unbound, "quota_denied", "quota", msg, delay,
                    quota={"boundChips": bound_ns, "requestedChips": needed,
                           "hardLimit": hard, "admitted": False},
                    failed_event=True,
                )
                return "quota_denied", delay

        requirements = [
            (pod_gpu_chips(p), (p.get("spec") or {}).get("nodeSelector") or {})
            for p in unbound
        ]
        placement = self.ledger.place_and_reserve(key, requirements, self.reservation_ttl)
        if placement is None:
            with TRACER.span("schedule.preempt", gang=f"{key[0]}/{key[1]}"):
                preemption = self._try_preempt(client, gang, requirements, span)
            if preemption.get("victim"):
                # Victim evicted; its chips free asynchronously while our
                # reservation (taken before the eviction) holds the claim.
                self._note_pending(key, unbound[0])
                self._record(
                    client, gang, unbound, "preempted", "preemption",
                    f"preempting lower-priority gang {preemption['victim']}",
                    self.backoff.base, preemption=preemption,
                )
                return "preempted", self.backoff.base
            if preemption.get("draining"):
                # Victim is checkpointing under its drain grace; our
                # reservation (refreshed each cycle) holds the claim until
                # it acks or the deadline passes, then we evict and bind.
                d = preemption["draining"]
                self._note_pending(key, unbound[0])
                delay = max(0.05, min(d["graceDeadline"] - time.time(), 1.0))
                self._record(
                    client, gang, unbound, "awaiting_drain", "draining",
                    f"victim gang {d['gang']} draining "
                    f"(grace deadline {d['graceDeadline']:.3f})",
                    delay, preemption=preemption,
                )
                return "awaiting_drain", delay
            self.ledger.release(key)
            # Re-judge each node AFTER releasing our own hold so the
            # verdicts describe the world the next attempt will see.
            nodes = self.ledger.explain(key, requirements)
            msg = failed_scheduling_message(gang.size, nodes)
            self._mark_unschedulable(client, unbound, msg)
            self._note_pending(key, unbound[0])
            delay = self.backoff.next_delay(key)
            self._record(
                client, gang, unbound, "unschedulable",
                dominant_node_reason(nodes), msg, delay,
                nodes=nodes,
                preemption=preemption if preemption["considered"] else None,
                failed_event=True,
            )
            return "unschedulable", delay

        return self._bind(client, key, unbound, placement, span, members)

    def _await_assembly(
        self, client: Client, gang: Gang, pod: Dict[str, Any], span
    ) -> Tuple[str, float]:
        """Gang not fully created yet: hold capacity for the FULL slice."""
        key = gang.key
        with self._lock:
            waited = time.monotonic() - self._first_attempt.get(key, time.monotonic())
        if waited > self.assembly_timeout:
            # Slice owner never produced the rest (stuck controller, scaled
            # down mid-flight): stop hoarding chips, keep retrying slowly.
            self.ledger.release(key)
            span.set("assembly_timeout", True)
            self._note_pending(key, pod)
            delay = self.backoff.next_delay(key)
            self._record(
                client, gang, [pod], "assembly_timeout", "assembly_timeout",
                f"gang incomplete after {waited:.1f}s (size {gang.size}); "
                "capacity reservation released", delay, failed_event=True,
            )
            return "assembly_timeout", delay
        template = (
            pod_gpu_chips(pod),
            (pod.get("spec") or {}).get("nodeSelector") or {},
        )
        self.ledger.place_and_reserve(key, [template] * gang.size, self.reservation_ttl)
        self._note_pending(key, pod)
        delay = min(self.reservation_ttl / 2, 1.0)
        self._record(
            client, gang, [pod], "waiting_gang", "assembling",
            f"waiting for gang members (size {gang.size}); chips reserved", delay,
        )
        # The missing members' ADDED events re-trigger scheduling; this
        # requeue only refreshes the reservation TTL / catches timeouts.
        return "waiting_gang", delay

    def _bind(
        self,
        client: Client,
        key: GangKey,
        unbound: List[Dict[str, Any]],
        placement: List[str],
        span,
        members: Optional[List[Dict[str, Any]]] = None,
    ) -> Tuple[str, float]:
        gang = gang_of(unbound[0])
        with TRACER.span("schedule.bind", gang=f"{key[0]}/{key[1]}",
                         pods=len(unbound)) as bspan:
            for target, node in zip(unbound, placement):
                ns, name = apimeta.namespace_of(target), apimeta.name_of(target)
                fresh = client.get_opt("v1", "Pod", name, ns)
                if fresh is None or (fresh.get("spec") or {}).get("nodeName"):
                    continue
                fresh["spec"]["nodeName"] = node
                # The bind traceparent rides the same write that sets
                # nodeName: podlet/engine/training spans started off the
                # bound pod join the gang's trace through this annotation.
                md = fresh.setdefault("metadata", {})
                ann = dict(md.get("annotations") or {})
                ann[BIND_TRACEPARENT_ANNOTATION] = format_traceparent(bspan)
                md["annotations"] = ann
                try:
                    bound = client.update(fresh)
                except Conflict:
                    # Raced a concurrent write; the reservation keeps the
                    # gang's chips held while we retry the remainder next
                    # cycle.
                    self._record(
                        client, gang, [], "bind_conflict", "conflict",
                        f"optimistic-concurrency conflict binding {ns}/{name}; retrying",
                        self.backoff.base,
                    )
                    return "bind_conflict", self.backoff.base
                self.ledger.record_bind(bound)
                client.emit_event(
                    bound, "Scheduled",
                    f"Successfully assigned {ns}/{name} to {node}",
                    component=COMPONENT,
                )
        self.ledger.release(key)
        with self._lock:
            root = self._gang_spans.get(key)
        self._observe_bind_latency(members or unbound, root)
        self._gang_done(key, bound=True)
        span.set("nodes", ",".join(sorted(set(placement))))
        self._record(
            client, gang, [], "bound", "scheduled",
            f"all {len(placement)} members bound", 0.0,
            placement=list(placement),
        )
        return "bound", 0.0

    def _try_preempt(
        self, client: Client, gang: Gang, requirements, span
    ) -> Dict[str, Any]:
        """Evict the lowest-priority running gang whose chips make this
        gang's placement feasible. Reserve first, then evict — and when the
        victim opted into drain grace (gang.DRAIN_GRACE_ANNOTATION), evict
        in two phases: signal a drain deadline, give the workload until ack
        or deadline to checkpoint, THEN delete (docs/ELASTICITY.md).

        Returns the flight-recorder preemption record: every candidate
        considered, the victim chosen with its identity + grace deadline
        (``victim`` is None when nothing helps), or ``draining`` while a
        victim's grace window is still open."""
        in_flight = self._check_draining(client, gang, requirements, span)
        if in_flight is not None:
            return in_flight
        candidates = sorted(
            (
                (info["priority"], sum(info["by_node"].values()), vkey, info)
                for vkey, info in self.ledger.running_gangs().items()
                if info["priority"] < gang.priority and vkey != gang.key
                and sum(info["by_node"].values()) > 0
            ),
        )
        considered: List[Dict[str, Any]] = []
        for prio, chips, vkey, info in candidates:
            considered.append(
                {"gang": f"{vkey[0]}/{vkey[1]}", "priority": prio, "chips": chips}
            )
            with self._lock:
                claimed = vkey in self._draining
            if claimed:
                # Already draining for some other preemptor; its chips are
                # spoken for, so evicting it twice would double-count them.
                considered[-1]["verdict"] = "already_draining"
                continue
            placement = self.ledger.place_and_reserve(
                gang.key, requirements, self.reservation_ttl, assume_freed=info["by_node"]
            )
            if placement is None:
                considered[-1]["verdict"] = "would_not_help"
                continue
            considered[-1]["verdict"] = "chosen"
            victim_id = f"{vkey[0]}/{vkey[1]}"
            grace = self._victim_grace(client, info["pods"])
            if grace <= 0:
                self._evict_pods(client, gang, info["pods"])
                SCHED.counter("preemptions_total").inc()
                span.set("preempted", victim_id)
                return {
                    "considered": considered,
                    "victim": victim_id,
                    "graceDeadline": None,
                }
            deadline = time.time() + grace
            self._request_drain(client, gang, victim_id, info["pods"], grace, deadline)
            with self._lock:
                self._draining[vkey] = {
                    "for": gang.key,
                    "victim": victim_id,
                    "deadline": deadline,
                    "pods": list(info["pods"]),
                    "by_node": dict(info["by_node"]),
                }
            span.set("draining", victim_id)
            return {
                "considered": considered,
                "victim": None,
                "draining": {
                    "gang": victim_id,
                    "preemptor": f"{gang.namespace}/{gang.name}",
                    "graceDeadline": deadline,
                },
            }
        return {"considered": considered, "victim": None}

    def _check_draining(
        self, client: Client, gang: Gang, requirements, span
    ) -> Optional[Dict[str, Any]]:
        """Phase 2 of the drain protocol: if this gang already signalled a
        victim, either finish the eviction (all live pods acked, pods gone,
        or deadline passed) or keep waiting with the reservation alive."""
        with self._lock:
            item = next(
                ((vk, d) for vk, d in self._draining.items() if d["for"] == gang.key),
                None,
            )
        if item is None:
            return None
        vkey, drain = item
        if drain.get("evicted"):
            # Eviction already issued, but the informer-fed ledger may not
            # have echoed the deletes yet — the victim's chips still look
            # used. Hold the claim (refreshing the reservation) until they
            # actually free, so this gang neither re-preempts the ghost nor
            # loses the capacity to a third gang in the lag window.
            info = self.ledger.running_gangs().get(vkey)
            if info is None or sum(info["by_node"].values()) == 0:
                with self._lock:
                    self._draining.pop(vkey, None)
                return None
            self.ledger.place_and_reserve(
                gang.key, requirements, self.reservation_ttl,
                assume_freed=drain["by_node"],
            )
            return {
                "considered": [],
                "victim": None,
                "draining": {
                    "gang": drain["victim"],
                    "preemptor": f"{gang.namespace}/{gang.name}",
                    "graceDeadline": drain["deadline"],
                    "freeing": True,
                },
            }
        # Refresh our claim on the victim's chips each cycle so the TTL
        # cannot lapse while the victim checkpoints.
        self.ledger.place_and_reserve(
            gang.key, requirements, self.reservation_ttl, assume_freed=drain["by_node"]
        )
        acked, live = self._drain_progress(client, drain["pods"])
        if live == 0 or acked == live or time.time() >= drain["deadline"]:
            self._evict_pods(client, gang, drain["pods"])
            with self._lock:
                # Keep the entry in an "evicted" state (see above) until the
                # ledger stops counting the victim's chips.
                drain["evicted"] = True
            SCHED.counter("preemptions_total").inc()
            SCHED.counter(
                "drains_completed_total",
                outcome="acked" if live and acked == live else
                ("gone" if live == 0 else "deadline"),
            ).inc()
            span.set("preempted", drain["victim"])
            return {
                "considered": [],
                "victim": drain["victim"],
                "graceDeadline": drain["deadline"],
                "drainAckedPods": acked,
            }
        return {
            "considered": [],
            "victim": None,
            "draining": {
                "gang": drain["victim"],
                "preemptor": f"{gang.namespace}/{gang.name}",
                "graceDeadline": drain["deadline"],
                "ackedPods": acked,
                "livePods": live,
            },
        }

    def _victim_grace(self, client: Client, pods) -> float:
        grace = 0.0
        for vns, vname in pods:
            victim = client.get_opt("v1", "Pod", vname, vns)
            if victim is not None:
                grace = max(grace, drain_grace_of(victim))
        return grace

    def _request_drain(
        self, client: Client, gang: Gang, victim_id: str, pods, grace: float,
        deadline: float,
    ) -> None:
        """Phase 1: stamp the deadline on every live victim pod, tell the
        workload (TrainingPreempted Event), and flight-record the drain
        under the VICTIM's gang so its operator sees who preempted it."""
        for vns, vname in pods:
            victim = client.get_opt("v1", "Pod", vname, vns)
            if victim is None:
                continue
            try:
                client.patch(
                    "v1", "Pod", vname,
                    {"metadata": {"annotations": {
                        DRAIN_DEADLINE_ANNOTATION: f"{deadline:.3f}"}}},
                    vns,
                )
            except (Conflict, NotFound):
                continue
            client.emit_event(
                victim,
                "TrainingPreempted",
                f"drain requested by higher-priority gang "
                f"{gang.namespace}/{gang.name}: checkpoint within {grace:.1f}s "
                f"(deadline {deadline:.3f}) or be evicted",
                type_="Warning",
                component=COMPONENT,
            )
        SCHED.counter("drains_requested_total").inc()
        self.flight.record(
            Decision(
                gang=victim_id,
                outcome="drain_requested",
                reason="preemption",
                message=(
                    f"draining for higher-priority gang "
                    f"{gang.namespace}/{gang.name}; grace {grace:.1f}s"
                ),
                attempt=0,
                backoff_seconds=0.0,
                wall_time=time.time(),
                nodes=[],
                quota=None,
                preemption={
                    "victim": victim_id,
                    "preemptor": f"{gang.namespace}/{gang.name}",
                    "graceDeadline": deadline,
                },
                placement=None,
            )
        )

    def _drain_progress(self, client: Client, pods) -> Tuple[int, int]:
        """(acked, live) across the victim's pods; terminal/vanished pods
        count as neither (their chips free on their own)."""
        acked = live = 0
        for vns, vname in pods:
            victim = client.get_opt("v1", "Pod", vname, vns)
            if victim is None or is_terminal(victim):
                continue
            live += 1
            if apimeta.annotations_of(victim).get(DRAIN_ACK_ANNOTATION):
                acked += 1
        return acked, live

    def _evict_pods(self, client: Client, gang: Gang, pods) -> None:
        for vns, vname in pods:
            victim = client.get_opt("v1", "Pod", vname, vns)
            if victim is not None:
                client.emit_event(
                    victim,
                    "Preempted",
                    f"evicted by higher-priority gang {gang.namespace}/{gang.name}",
                    type_="Warning",
                    component=COMPONENT,
                )
            client.delete_opt("v1", "Pod", vname, vns)

    # -- helpers -------------------------------------------------------------

    def _record(
        self,
        client: Client,
        gang: Gang,
        unbound: List[Dict[str, Any]],
        outcome: str,
        reason: str,
        message: str,
        delay: float,
        nodes: Optional[List[Dict[str, Any]]] = None,
        quota: Optional[Dict[str, Any]] = None,
        preemption: Optional[Dict[str, Any]] = None,
        placement: Optional[List[str]] = None,
        failed_event: bool = False,
    ) -> None:
        """Flight-record this cycle's verdict; with ``failed_event``, also
        summarize it as ONE aggregated FailedScheduling Warning per unbound
        pod (the recorder bumps ``count`` on repeats, so a gang stuck for
        an hour carries one Event whose count is the attempt tally)."""
        key = gang.key
        self.flight.record(
            Decision(
                gang=f"{key[0]}/{key[1]}",
                outcome=outcome,
                reason=reason,
                message=message,
                attempt=self.backoff.failures(key),
                backoff_seconds=delay,
                wall_time=time.time(),
                # dominant_node_reason/failed_scheduling_message were computed
                # from the FULL verdict list by the caller; the stored copy is
                # capped so one unschedulable cycle on a 10k-node cluster
                # doesn't pin thousands of dicts in the recorder ring
                nodes=truncate_node_verdicts(nodes or [], self.verdict_top_k),
                quota=quota,
                preemption=preemption,
                placement=placement,
            )
        )
        if failed_event:
            for p in unbound:
                client.emit_event(
                    p, "FailedScheduling", message, type_="Warning",
                    component=COMPONENT,
                )

    def _members(self, client: Client, gang: Gang, pod: Dict[str, Any]) -> List[Dict[str, Any]]:
        if not gang.labeled:
            return [pod]
        selector = {POD_GROUP_LABEL: gang.name}
        if self.cache is not None:
            members = self.cache.list("v1", "Pod", gang.namespace, label_selector=selector)
        else:
            members = client.list("v1", "Pod", gang.namespace, label_selector=selector)
        # The informer mirror can lag the triggering pod's own creation.
        if not any(apimeta.name_of(m) == apimeta.name_of(pod) for m in members):
            members = list(members) + [pod]
        return sorted(members, key=apimeta.name_of)

    def _quota_hard(self, client: Client, namespace: Optional[str]) -> Optional[int]:
        quota = client.get_opt("v1", "ResourceQuota", QUOTA_NAME, namespace)
        if quota is None:
            return None
        hard = ((quota.get("spec") or {}).get("hard") or {}).get(GPU_QUOTA_KEY)
        if hard is None:
            return None
        return chips_in_quota(hard)

    def _mark_unschedulable(self, client: Client, pods: List[Dict[str, Any]], message: str) -> None:
        status = {
            "phase": "Pending",
            "conditions": [
                {
                    "type": "PodScheduled",
                    "status": "False",
                    "reason": "Unschedulable",
                    "message": message,
                }
            ],
        }
        for p in pods:
            fresh = client.get_opt("v1", "Pod", apimeta.name_of(p), apimeta.namespace_of(p))
            if fresh is None:
                continue
            fresh["status"] = apimeta.deepcopy(status)
            try:
                # Identical writes are no-ops in the store (no watch event),
                # so re-marking per backoff attempt causes no event storms.
                client.update_status(fresh)
            except (Conflict, NotFound):
                pass

    def _note_pending(self, key: GangKey, pod: Dict[str, Any]) -> None:
        with self._lock:
            self._pending[key] = (apimeta.namespace_of(pod), apimeta.name_of(pod))

    def _gang_done(self, key: GangKey, bound: bool) -> None:
        self.backoff.forget(key)
        self.ledger.release(key)
        self._cancel_drains_for(key)
        with self._lock:
            self._pending.pop(key, None)
            first = self._first_attempt.pop(key, None)
            root = self._gang_spans.pop(key, None)
        if root is not None and not root.end_ns:
            # end_ns set means the abandoned-span sweep beat us to it (an
            # hour-pending gang) — don't record the root twice
            root.set("gang.bound", bound)
            TRACER.end_span(root)
        if bound and first is not None:
            SCHED.histogram("time_to_bind_seconds").observe(time.monotonic() - first)

    #: bucket ladder for the end-to-end bind SLI; creationTimestamps have
    #: 1 s resolution, so the sub-second buckets catch same-second binds
    BIND_LATENCY_BUCKETS = (0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

    def _observe_bind_latency(
        self, members: List[Dict[str, Any]], root: Optional[Span] = None
    ) -> None:
        """End-to-end bind SLI: earliest gang member creationTimestamp (the
        submit, stamped by the apiserver in wall time) → last pod bound
        (now). Unlike time_to_bind_seconds — first *attempt* to bind — this
        includes apiserver/informer/workqueue time before the scheduler ever
        saw the gang, which is exactly the control-plane latency the scale
        harness loads. The gang root span gets the same anchors as
        attributes (and the histogram an exemplar with its trace id) so the
        critical-path analyzer can reconstruct this exact observation from
        the assembled trace."""
        submitted: Optional[float] = None
        for p in members:
            stamp = (p.get("metadata") or {}).get("creationTimestamp")
            if not stamp:
                continue
            try:
                ts = calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ"))
            except ValueError:
                continue
            submitted = ts if submitted is None else min(submitted, ts)
        if submitted is None:
            return
        latency = max(0.0, time.time() - submitted)
        if root is not None:
            root.set("gang.submitted_unix", submitted)
            root.set("gang.bind_latency_s", round(latency, 6))
        SCHED.histogram(
            "bind_latency_seconds", buckets=self.BIND_LATENCY_BUCKETS
        ).observe(latency, trace_id=root.trace_id if root else None)

    def _collect_cycle_rate(self) -> None:
        """Scrape-time collector: scheduling cycles completed per second
        over the trailing window."""
        now = time.monotonic()
        cutoff = now - self.cycles_window_s
        with self._lock:
            while self._cycle_times and self._cycle_times[0] < cutoff:
                self._cycle_times.popleft()
            n = len(self._cycle_times)
        SCHED.gauge("cycles_per_sec").set(round(n / self.cycles_window_s, 6))

    def _pod_gone(self, pod_key: Tuple[Optional[str], str]) -> None:
        with self._lock:
            gkey = self._gang_of_pod.pop(pod_key, None)
            orphaned = gkey is not None and gkey not in self._gang_of_pod.values()
        if orphaned:
            self.backoff.forget(gkey)
            self.ledger.release(gkey)
            self._cancel_drains_for(gkey)
            with self._lock:
                self._pending.pop(gkey, None)
                self._first_attempt.pop(gkey, None)
                root = self._gang_spans.pop(gkey, None)
                SCHED.gauge("pending_gangs").set(len(self._pending))
            if root is not None and not root.end_ns:
                root.set("gang.bound", False)
                TRACER.end_span(root)

    def _cancel_drains_for(self, key: GangKey) -> None:
        """Preemptor bound or vanished: forget drains it requested so the
        victim is no longer claimed (the stale deadline annotation is
        harmless — without a deletion the workload just keeps training)."""
        with self._lock:
            stale = [vk for vk, d in self._draining.items() if d["for"] == key]
            for vk in stale:
                self._draining.pop(vk, None)


def main() -> None:  # python -m kubeflow_tpu_torch.scheduler.core
    from ..runtime.bootstrap import run_role

    run_role("scheduler", SchedulerReconciler())


if __name__ == "__main__":
    main()
