"""Scheduler flight recorder: structured decision traces for "why is my
gang Pending?".

A copy of ``kubeflow_tpu/scheduler/flight.py``. Every scheduling cycle
appends one :class:`Decision` to a bounded ring, served as JSON at
``GET /debug/scheduler`` (``?gang=ns/name``, ``?limit=``) on every app that
mounts ``runtime/obs.py``, and counted in
``scheduler_decision_total{outcome,reason}``. Node verdict reasons come
from :meth:`ChipLedger.explain`: ``feasible``, ``selector_mismatch``,
``insufficient_chips``, ``reserved_by_other_gang``, ``quarantined``.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..runtime.metrics import METRICS
from ..runtime.obs import register_debug_source
from ..web.http import HttpError, Request

SCHED = METRICS.namespace("scheduler")

#: default ring size — at the scheduler's backoff cap (5 s) this covers
#: tens of minutes of a stuck gang's attempts, plus surrounding traffic
DEFAULT_CAPACITY = 512


@dataclass
class Decision:
    """One scheduling cycle's verdict, fully self-describing."""

    gang: str  # "ns/name"
    outcome: str  # SchedulerReconciler outcome: bound/unschedulable/...
    reason: str  # dominant machine-readable cause within the outcome
    message: str  # the human summary (what the Event says)
    attempt: int  # consecutive failures per the backoff queue
    backoff_seconds: float  # requeue delay chosen for this cycle
    wall_time: float  # unix seconds of the decision
    nodes: List[Dict[str, Any]] = field(default_factory=list)  # ledger.explain()
    quota: Optional[Dict[str, Any]] = None  # admission arithmetic when checked
    preemption: Optional[Dict[str, Any]] = None  # candidates considered, victim
    placement: Optional[List[str]] = None  # node per member when bound

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "gang": self.gang,
            "outcome": self.outcome,
            "reason": self.reason,
            "message": self.message,
            "attempt": self.attempt,
            "backoffSeconds": round(self.backoff_seconds, 4),
            "wallTime": self.wall_time,
            "nodes": self.nodes,
        }
        if self.quota is not None:
            out["quota"] = self.quota
        if self.preemption is not None:
            out["preemption"] = self.preemption
        if self.placement is not None:
            out["placement"] = self.placement
        return out


#: node verdicts kept verbatim per decision before aggregation kicks in
DEFAULT_VERDICT_TOP_K = 8


def truncate_node_verdicts(
    nodes: List[Dict[str, Any]], top_k: int = DEFAULT_VERDICT_TOP_K
) -> List[Dict[str, Any]]:
    """Cap a decision's per-node verdict list for storage.

    At thousands of nodes one unschedulable cycle would otherwise pin one
    dict per rejected node in the recorder ring (512 decisions × 10k nodes).
    The first ``top_k`` verdicts survive verbatim; the tail collapses into
    one summary row per reason — ``...and N more nodes: insufficient_chips``
    — so the debug surface still shows the full shape of the rejection.
    Callers must derive ``dominant_node_reason`` / the Event message from
    the full list *before* truncating; those stay exact.
    """
    if top_k < 0 or len(nodes) <= top_k:
        return list(nodes)
    kept = list(nodes[:top_k])
    tail = Counter(v.get("reason", "unknown") for v in nodes[top_k:])
    for reason, count in sorted(tail.items(), key=lambda kv: (-kv[1], kv[0])):
        kept.append({
            "node": f"...and {count} more nodes",
            "reason": reason,
            "truncated": count,
            "summary": f"...and {count} more nodes: {reason}",
        })
    return kept


def dominant_node_reason(nodes: List[Dict[str, Any]]) -> str:
    """The single most common rejection among non-feasible verdicts — what
    the ``reason`` label carries for an unschedulable decision."""
    tally = Counter(v["reason"] for v in nodes if v.get("reason") != "feasible")
    if not tally:
        return "no_nodes"
    return tally.most_common(1)[0][0]


def failed_scheduling_message(gang_size: int, nodes: List[Dict[str, Any]]) -> str:
    """kube-scheduler's classic summary line: ``0/N nodes are available:
    X insufficient chips, ...`` — built from the same verdicts the debug
    surface serves, so the Event and the trace can never disagree."""
    tally = Counter(v["reason"] for v in nodes if v.get("reason") != "feasible")
    if not nodes:
        return f"0/{gang_size} hosts bindable: no GPU nodes registered"
    parts = [
        f"{count} {reason.replace('_', ' ')}"
        for reason, count in sorted(tally.items(), key=lambda kv: (-kv[1], kv[0]))
    ]
    feasible = sum(1 for v in nodes if v.get("reason") == "feasible")
    if feasible:
        # individually feasible nodes exist, but not enough of them for
        # the whole gang at once — name that explicitly
        parts.append(f"{feasible} feasible but gang needs all-or-nothing placement")
    return f"0/{len(nodes)} nodes can host the gang: " + ", ".join(parts)


class FlightRecorder:
    """Bounded ring of scheduling decisions + the /debug/scheduler handler."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        register_debug_source("scheduler", self.debug_handler)

    def record(self, decision: Decision) -> None:
        if not decision.wall_time:
            decision.wall_time = time.time()
        with self._lock:
            self._ring.append(decision)
        SCHED.counter(
            "decision_total", outcome=decision.outcome, reason=decision.reason
        ).inc()

    def decisions(
        self, gang: Optional[str] = None, limit: int = 128
    ) -> List[Decision]:
        """Most recent last; ``gang`` filters on the "ns/name" string."""
        with self._lock:
            items = list(self._ring)
        if gang is not None:
            items = [d for d in items if d.gang == gang]
        return items[-max(0, limit):]

    def last_for(self, gang: str) -> Optional[Decision]:
        with self._lock:
            for d in reversed(self._ring):
                if d.gang == gang:
                    return d
        return None

    def debug_handler(self, req: Request) -> Dict[str, Any]:
        try:
            limit = int(req.query1("limit", "128"))
        except ValueError:
            raise HttpError(400, "limit must be an integer") from None
        gang = req.query1("gang") or None
        decisions = self.decisions(gang=gang, limit=limit)
        return {
            "scheduler": "kubeflow-tpu-torch",
            "gang": gang,
            "count": len(decisions),
            "decisions": [d.to_dict() for d in decisions],
        }
