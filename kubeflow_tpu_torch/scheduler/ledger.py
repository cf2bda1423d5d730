"""Incremental cards-in-use ledger and gang reservations.

A copy of ``kubeflow_tpu/scheduler/ledger.py`` that counts
``nvidia.com/gpu`` cards (``gpu/topology.pod_gpu_chips``; a node's
capacity is ``status.capacity["nvidia.com/gpu"]``) where JAX counts
``google.com/tpu`` chips. Informer pod and node events adjust per-node use
in O(1), and every placement query reads the cached totals under one lock.

- **records** — one per bound, non-terminal pod: its node, cards, gang and
  priority. Fed by informer events and by the scheduler's own binds (the
  informer's echo of a bind lands on the identical record). Terminal
  phases and deletions free the cards; a MODIFIED without a nodeName never
  erases a record (binds are never undone, and a stale pre-bind replay
  must not undercount). Each record opens the namespace's interval on the
  tenant meter (``monitoring/goodput.TENANT_METER``), and its drop closes
  it, as JAX's ledger does.
- **reservations** — per-gang, TTL-bounded holds on capacity not yet
  bound: while a gang assembles, while its binds are written, and across a
  preemption. They make all-or-nothing placement compose with
  first-come-first-served arrivals: without them two 2-node gangs
  interleave to one node each and deadlock.

Placement (``place_and_reserve``) runs under the same lock, so the
feasibility check and the hold are atomic against informer updates. It is
JAX's full scan over every node; JAX's free-chip index (pools by label
fingerprint, free-chip buckets) is not ported, as it pays only at
thousands of nodes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..api import meta as apimeta
from ..gpu.topology import RESOURCE_GPU, pod_gpu_chips
from ..monitoring.goodput import TENANT_METER
from .gang import TERMINAL_PHASES, gang_of, is_quarantined

PodKey = Tuple[Optional[str], str]
GangKey = Tuple[Optional[str], str]

# Stamped per node (see on_node_event), so by-name pinning works.
HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclass
class _PodRecord:
    node: str
    chips: int
    namespace: Optional[str]
    gang: GangKey
    priority: int


def node_gpu_capacity(node: Dict[str, Any]) -> int:
    """A node's ``nvidia.com/gpu`` capacity (JAX: ``node_tpu_capacity``)."""
    raw = ((node.get("status") or {}).get("capacity") or {}).get(RESOURCE_GPU, 0)
    try:
        return int(raw or 0)
    except (TypeError, ValueError):
        return 0


class ChipLedger:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._capacity: Dict[str, int] = {}
        self._labels: Dict[str, Dict[str, str]] = {}
        self._records: Dict[PodKey, _PodRecord] = {}
        self._used: Dict[str, int] = {}
        self._reserved: Dict[GangKey, Tuple[float, Dict[str, int]]] = {}
        # Nodes cordoned by the straggler detector's quarantine annotation
        # (gang.QUARANTINE_ANNOTATION): excluded from placement, still
        # tracked for capacity/used so explain() can say why. Maintained
        # from node events; an annotation clear un-cordons on the next event.
        self._cordoned: Set[str] = set()

    # -- event feeds ---------------------------------------------------------

    def on_node_event(self, event_type: str, node: Dict[str, Any]) -> None:
        name = apimeta.name_of(node)
        with self._lock:
            if event_type == "DELETED":
                self._capacity.pop(name, None)
                self._labels.pop(name, None)
                self._cordoned.discard(name)
            else:
                if is_quarantined(node):
                    self._cordoned.add(name)
                else:
                    self._cordoned.discard(name)
                self._capacity[name] = node_gpu_capacity(node)
                labels = dict(apimeta.labels_of(node))
                # kubelets stamp every node with its hostname; synthesize it so
                # by-name nodeSelector pinning works against fixture nodes too
                labels.setdefault(HOSTNAME_LABEL, name)
                self._labels[name] = labels

    def on_pod_event(self, event_type: str, pod: Dict[str, Any]) -> None:
        key = (apimeta.namespace_of(pod), apimeta.name_of(pod))
        phase = (pod.get("status") or {}).get("phase")
        node = (pod.get("spec") or {}).get("nodeName")
        with self._lock:
            if event_type == "DELETED" or phase in TERMINAL_PHASES:
                self._drop(key)
            elif node:
                g = gang_of(pod)
                self._put(key, _PodRecord(node, pod_gpu_chips(pod), key[0], g.key, g.priority))
            # else: live unbound pod — keep any existing record (see module doc)

    def record_bind(self, pod: Dict[str, Any]) -> None:
        """Assume a bind this scheduler just wrote, ahead of the informer echo."""
        self.on_pod_event("MODIFIED", pod)

    def sync_from(self, nodes: Iterable[Dict[str, Any]], pods: Iterable[Dict[str, Any]]) -> None:
        """Cacheless fallback (no Manager/informer): rebuild from a fresh list.
        Reservations are kept — they are scheduler state, not cluster state."""
        with self._lock:
            stale = list(self._records)
            self._capacity.clear()
            self._labels.clear()
            self._records.clear()
            self._used.clear()
            self._cordoned.clear()
        # settle tenant meter intervals for everything we just forgot; pods
        # still bound re-open their interval when re-listed below
        for key in stale:
            TENANT_METER.on_unbind(key)
        for n in nodes:
            self.on_node_event("ADDED", n)
        for p in pods:
            self.on_pod_event("ADDED", p)

    # -- reads ---------------------------------------------------------------

    def has_nodes(self) -> bool:
        with self._lock:
            return bool(self._capacity)

    def used_on(self, node: str) -> int:
        with self._lock:
            return self._used.get(node, 0)

    def used_in_namespace(self, namespace: Optional[str]) -> int:
        with self._lock:
            return sum(r.chips for r in self._records.values() if r.namespace == namespace)

    def running_gangs(self) -> Dict[GangKey, Dict[str, Any]]:
        """Bound, non-terminal pods grouped by gang — the preemption candidates."""
        with self._lock:
            out: Dict[GangKey, Dict[str, Any]] = {}
            for key, r in self._records.items():
                g = out.setdefault(r.gang, {"priority": r.priority, "pods": [], "by_node": {}})
                g["priority"] = max(g["priority"], r.priority)
                g["pods"].append(key)
                g["by_node"][r.node] = g["by_node"].get(r.node, 0) + r.chips
            return out

    def free_chips(self, exclude_gang: Optional[GangKey] = None,
                   now: Optional[float] = None) -> Dict[str, int]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._free_locked(exclude_gang, now)

    def reservations(self) -> Dict[GangKey, Dict[str, int]]:
        now = time.monotonic()
        with self._lock:
            self._purge_expired(now)
            return {k: dict(v[1]) for k, v in self._reserved.items()}

    # -- placement + reservations -------------------------------------------

    def place_and_reserve(
        self,
        gang_key: GangKey,
        requirements: List[Tuple[int, Dict[str, str]]],
        ttl: Optional[float] = None,
        assume_freed: Optional[Dict[str, int]] = None,
        now: Optional[float] = None,
    ) -> Optional[List[str]]:
        """All-or-nothing placement for ``requirements`` = [(chips, nodeSelector)].

        Returns one node name per requirement, or None if the whole set
        cannot fit. Free capacity excludes every other gang's reservation
        but includes this gang's own (it is re-planning its own hold).
        With ``ttl`` set, a feasible plan atomically replaces the gang's
        reservation; ``ttl=None`` is a pure feasibility query.
        ``assume_freed`` adds hypothetical capacity (a preemption victim's
        chips) before planning.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            free = self._free_locked(gang_key, now)
            for node, chips in (assume_freed or {}).items():
                free[node] = free.get(node, 0) + chips
            placement = self._select(requirements, free)
            if placement is None:
                return None
            if ttl is not None:
                hold: Dict[str, int] = {}
                for node, (chips, _sel) in zip(placement, requirements):
                    if chips:
                        hold[node] = hold.get(node, 0) + chips
                if hold:
                    self._reserved[gang_key] = (now + ttl, hold)
                else:
                    self._reserved.pop(gang_key, None)
            return placement

    def explain(
        self,
        gang_key: GangKey,
        requirements: List[Tuple[int, Dict[str, str]]],
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Per-node feasibility verdict for the flight recorder: why each
        candidate node can or cannot host (part of) the gang. Reasons are
        machine-readable — ``feasible``, ``selector_mismatch``,
        ``insufficient_chips``, ``reserved_by_other_gang``, ``quarantined``
        — the scheduler analog of kube-scheduler's per-plugin filter
        failure messages.

        A node is judged against the *smallest* matching requirement: "can
        this node host ANY member" — per-member assignment is the placer's
        job, the verdict only explains infeasibility.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            free = self._free_locked(gang_key, now)
            raw_free = {n: cap - self._used.get(n, 0) for n, cap in self._capacity.items()}
            verdicts: List[Dict[str, Any]] = []
            for node in sorted(self._capacity):
                labels = self._labels.get(node, {})
                matching = [
                    chips
                    for chips, selector in requirements
                    if not any(labels.get(k) != v for k, v in (selector or {}).items())
                ]
                if node in self._cordoned:
                    # quarantine outranks every other verdict: the node may
                    # have free matching chips, the detector said never mind
                    reason = "quarantined"
                    need = min(matching or [c for c, _s in requirements] or [0])
                elif not matching:
                    reason = "selector_mismatch"
                    need = min((c for c, _s in requirements), default=0)
                else:
                    need = min(matching)
                    if free.get(node, 0) >= need:
                        reason = "feasible"
                    elif raw_free.get(node, 0) >= need:
                        # only reservations held by OTHER gangs separate
                        # raw free capacity from schedulable free capacity
                        reason = "reserved_by_other_gang"
                    else:
                        reason = "insufficient_chips"
                verdicts.append(
                    {
                        "node": node,
                        "reason": reason,
                        "free_chips": free.get(node, 0),
                        "capacity": self._capacity[node],
                        "needed": need,
                    }
                )
            return verdicts

    def reserve(self, gang_key: GangKey, by_node: Dict[str, int], ttl: float,
                now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._reserved[gang_key] = (now + ttl, dict(by_node))

    def release(self, gang_key: GangKey) -> None:
        with self._lock:
            self._reserved.pop(gang_key, None)

    # -- internals (lock held) -----------------------------------------------

    def _select(
        self, requirements: List[Tuple[int, Dict[str, str]]], free: Dict[str, int]
    ) -> Optional[List[str]]:
        """Best-fit placement: a full scan over every node per requirement;
        ties go to the node seen first."""
        placement: List[str] = []
        for chips, selector in requirements:
            best: Optional[str] = None
            for node in self._capacity:
                if node in self._cordoned:
                    continue
                labels = self._labels.get(node, {})
                if any(labels.get(k) != v for k, v in (selector or {}).items()):
                    continue
                if chips:
                    if free.get(node, 0) < chips:
                        continue
                    # best-fit: pack slices tightly so whole nodes stay
                    # free for the next multi-chip gang
                    if best is None or free[node] < free[best]:
                        best = node
                elif best is None:
                    best = node
            if best is None:
                return None
            placement.append(best)
            if chips:
                free[best] -= chips
        return placement

    def _free_locked(self, exclude_gang: Optional[GangKey], now: float) -> Dict[str, int]:
        self._purge_expired(now)
        free = {n: cap - self._used.get(n, 0) for n, cap in self._capacity.items()}
        for gkey, (_deadline, by_node) in self._reserved.items():
            if gkey == exclude_gang:
                continue
            for node, chips in by_node.items():
                free[node] = free.get(node, 0) - chips
        return free

    def _purge_expired(self, now: float) -> None:
        expired = [k for k, (deadline, _hold) in self._reserved.items() if deadline <= now]
        for k in expired:
            del self._reserved[k]

    def _put(self, key: PodKey, rec: _PodRecord) -> None:
        old = self._records.get(key)
        if old is not None:
            self._adjust(old.node, -old.chips)
        self._records[key] = rec
        self._adjust(rec.node, rec.chips)
        # tenant chip-second accrual opens at bind; the meter is idempotent
        # for the informer echo of a bind this scheduler already assumed
        TENANT_METER.on_bind(key, rec.namespace, rec.chips)

    def _drop(self, key: PodKey) -> None:
        old = self._records.pop(key, None)
        if old is not None:
            self._adjust(old.node, -old.chips)
            TENANT_METER.on_unbind(key)

    def _adjust(self, node: str, delta: int) -> None:
        n = self._used.get(node, 0) + delta
        if n:
            self._used[node] = n
        else:
            self._used.pop(node, None)

    # -- test/debug ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": dict(self._capacity),
                "used": dict(self._used),
                "records": {k: vars(v).copy() for k, v in self._records.items()},
                "reserved": {k: dict(v[1]) for k, v in self._reserved.items()},
                "cordoned": sorted(self._cordoned),
            }
