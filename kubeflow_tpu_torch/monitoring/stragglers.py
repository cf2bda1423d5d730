"""Straggler & hang detection over worker beacons: the port's copy of
``kubeflow_tpu/monitoring/stragglers.py``.

A :class:`~kubeflow_tpu_torch.training.heartbeat.WorkerBeacon` publishes
per-worker step telemetry; each :meth:`StragglerDetector.tick`
cross-sections the gang from ``tsdb.latest(name)``: the monitoring
plane's scraped :class:`~kubeflow_tpu_torch.monitoring.tsdb.TSDB` (JAX's
source), or :class:`RegistrySource` over an in-process
``MetricsRegistry``:

- **skew** — a worker whose step wall exceeds the gang median by
  ``skew_factor`` in at least ``k`` of the last ``n`` observation windows
  is flagged a persistent straggler (``training_straggler_score{worker}``
  + a ``WorkerStraggling`` Warning Event). Single-worker gangs have no
  peers to skew against and never self-flag.
- **hang** — a worker that previously made progress but has published no
  new step within ``hang_deadline_s`` gets a hang verdict:
  ``training_hangs_detected_total`` bumps, an all-thread stack dump lands
  in the ``/debug/stacks`` ring (the forensic that names the wedged
  frame), and remediation kicks in through the duck-typed ``client``
  (``get_opt``, ``patch``, ``list``, ``emit_event``): the hosting node is
  quarantined (``scheduling.kubeflow.org/quarantined``) and the gang's
  pods get drain deadlines so ``ElasticTrainer`` reshards around the loss.

Both detectors are restart/counter-reset aware: an incarnation bump or a
step index moving backwards resets the worker's skew window AND hang
clock. Quarantine is idempotent under informer echo.

:func:`straggler_rules` is the rule-engine bundle: the gang's max/median
step-wall skew as a recording rule and a burn-rate alert on per-worker
step latency. Not ported: the verdict's attachment to the gang's
federated bind trace (JAX's ``traces=``; nothing in the port stamps the
bind-traceparent annotation it reads).
"""

from __future__ import annotations

import json
import logging
import statistics
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..runtime.metrics import METRICS, MetricsRegistry
from ..runtime.obs import capture_stacks
from ..scheduler.gang import (
    DRAIN_DEADLINE_ANNOTATION,
    POD_GROUP_LABEL,
    QUARANTINE_ANNOTATION,
    annotations_of,
    drain_grace_of,
    gang_of,
    is_quarantined,
    is_terminal,
    name_of,
    namespace_of,
)
from .rules import RecordingRule, SLOBurnRateAlert

LOG = logging.getLogger(__name__)


class RegistrySource:
    """``latest(name)`` over a :class:`MetricsRegistry`: every series of a
    counter or gauge as ``(labels, now, value)``, the shape of JAX's
    ``TSDB.latest`` (the port's counterpart of the scrape into it)."""

    def __init__(self, registry: MetricsRegistry = METRICS) -> None:
        self._registry = registry

    def latest(self, name: str) -> List[Tuple[Dict[str, str], float, float]]:
        now = time.time()
        reg = self._registry
        with reg._lock:
            series = list(reg._metrics.get(name, {}).items())
        return [(dict(key), now, float(m.value)) for key, m in series if hasattr(m, "value")]


class _WorkerState:
    """Per-worker detector bookkeeping (all mutation under the detector's
    single tick, which its caller serializes)."""

    __slots__ = (
        "window", "incarnation", "step", "progress_at", "hang_base",
        "flagged", "hung",
    )

    def __init__(self, now: float, window_n: int) -> None:
        self.window: Deque[bool] = deque(maxlen=window_n)
        self.incarnation: Optional[float] = None
        self.step: Optional[float] = None
        self.progress_at = now
        #: hang clock floor — reset on restart so the restore/replay gap of
        #: a new incarnation can never mature into a hang verdict
        self.hang_base = now
        self.flagged = False
        self.hung = False


class StragglerDetector:
    """Cross-sectional straggler/hang detector over a ``latest`` source."""

    def __init__(
        self,
        tsdb: Any,
        *,
        client: Any = None,
        namespace: Optional[str] = "default",
        skew_factor: float = 2.0,
        k: int = 3,
        n: int = 5,
        hang_deadline_s: float = 5.0,
        default_grace_s: float = 5.0,
        registry: Any = METRICS,
        component: str = "straggler-detector",
    ) -> None:
        self.tsdb = tsdb
        self._client = client
        self._namespace = namespace
        self.skew_factor = float(skew_factor)
        self.k = int(k)
        self.n = int(n)
        self.hang_deadline_s = float(hang_deadline_s)
        self.default_grace_s = float(default_grace_s)
        self.component = component
        self._ns = registry.namespace("training")
        self._lock = threading.Lock()
        #: guarded by _lock: _state, _quarantined, last_hang_verdict
        self._state: Dict[str, _WorkerState] = {}
        self._quarantined: set = set()
        self.last_hang_verdict: Optional[Dict[str, Any]] = None

    # -- the tick ------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One detection pass. Returns the hang verdicts minted this tick
        (empty on a healthy gang)."""
        now = time.time() if now is None else float(now)
        walls = self._latest("training_worker_step_wall_seconds")
        steps = self._latest("training_worker_step_index")
        incs = self._latest("training_worker_incarnation")
        lasts = self._latest("training_worker_last_step_timestamp_seconds")
        verdicts: List[Dict[str, Any]] = []
        with self._lock:
            workers = sorted(set(steps) | set(walls))
            restarted = set()
            for w in workers:
                if self._observe_locked(w, now, steps.get(w), incs.get(w)):
                    restarted.add(w)
            self._skew_locked(now, walls, workers)
            for w in workers:
                if w in restarted:
                    continue
                v = self._hang_locked(w, now, lasts.get(w))
                if v is not None:
                    verdicts.append(v)
        # remediation outside the lock: it does client I/O (patches,
        # events, pod lists) — never block the detector's state under it
        for v in verdicts:
            self._remediate(v, now)
        return verdicts

    def _latest(self, name: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for labels, _ts, value in self.tsdb.latest(name):
            worker = labels.get("worker")
            if worker:
                out[worker] = float(value)
        return out

    def _observe_locked(
        self, w: str, now: float,
        step: Optional[float], inc: Optional[float],
    ) -> bool:
        """Fold one worker's latest counters in; returns True when this tick
        observed a restart (incarnation bump or step index reset)."""
        st = self._state.get(w)
        if st is None:
            st = self._state[w] = _WorkerState(now, self.n)
        restarted = False
        if inc is not None and st.incarnation is not None and inc > st.incarnation:
            restarted = True
        elif (
            step is not None and st.step is not None and step < st.step
        ):
            # counter reset seen before the incarnation gauge federated —
            # same meaning: the worker restarted, it did not hang
            restarted = True
        if restarted:
            st.window.clear()
            st.hang_base = now
            st.progress_at = now
            st.hung = False
            st.flagged = False
        elif step is not None and step != st.step:
            st.progress_at = now
            st.hung = False
        if inc is not None:
            st.incarnation = inc
        if step is not None:
            st.step = step
        return restarted

    def _skew_locked(
        self, now: float, walls: Dict[str, float], workers: List[str]
    ) -> None:
        fresh = {w: walls[w] for w in workers if walls.get(w, 0.0) > 0.0}
        if len(fresh) < 2:
            # a gang of one has no peers to be slower than — never self-flag
            return
        median = statistics.median(fresh.values())
        if median <= 0.0:
            return
        threshold = median * self.skew_factor
        for w, wall in fresh.items():
            st = self._state[w]
            st.window.append(wall > threshold)
            hits = sum(st.window)
            score = hits / float(self.n)
            self._ns.gauge("straggler_score", worker=w).set(score)
            if hits >= self.k and not st.flagged:
                st.flagged = True
                self._ns.counter("stragglers_flagged_total", worker=w).inc()
                LOG.warning(
                    "straggler: worker %s at %.3fs vs gang median %.3fs "
                    "(%d/%d windows above %.1fx)",
                    w, wall, median, hits, self.n, self.skew_factor,
                )
                self._emit_worker_event(
                    w, "WorkerStraggling",
                    f"worker {w} step wall {wall:.3f}s exceeds gang median "
                    f"{median:.3f}s x{self.skew_factor:g} in {hits}/{self.n} windows",
                )
            elif hits < self.k:
                st.flagged = False

    def _hang_locked(
        self, w: str, now: float, last_ts: Optional[float]
    ) -> Optional[Dict[str, Any]]:
        st = self._state[w]
        if st.hung or st.step is None or st.step < 0:
            return None  # never progressed (or already verdicted): not a hang
        floor = max(st.hang_base, st.progress_at, last_ts or 0.0)
        stalled = now - floor
        if stalled <= self.hang_deadline_s:
            return None
        st.hung = True
        self._ns.counter("hangs_detected_total", worker=w).inc()
        dump = capture_stacks(reason=f"hang:{w}")
        verdict = {
            "kind": "hang",
            "worker": w,
            "stepIndex": st.step,
            "incarnation": st.incarnation,
            "stalledSeconds": round(stalled, 3),
            "deadlineSeconds": self.hang_deadline_s,
            "detectedAt": now,
            # the innermost few frames of every thread: deep enough that a
            # worker parked in WorkerBeacon._wedge_wait is named even though
            # its literal innermost frame is the stdlib Event.wait
            "stackThreads": sorted({
                f["function"]
                for t in dump["threads"]
                for f in t["frames"][-3:]
            }),
        }
        self.last_hang_verdict = verdict
        LOG.error(
            "hang: worker %s stalled %.2fs past step %s (deadline %.2fs); "
            "stack dump captured",
            w, stalled, st.step, self.hang_deadline_s,
        )
        return verdict

    # -- remediation (client I/O, outside the lock) -------------------------
    def _remediate(self, verdict: Dict[str, Any], now: float) -> None:
        if self._client is None:
            return
        w = verdict["worker"]
        pod = self._client.get_opt("v1", "Pod", w, self._namespace)
        if pod is None:
            LOG.warning("hang remediation: no pod named %r to act on", w)
            return
        node = (pod.get("spec") or {}).get("nodeName")
        verdict["node"] = node
        verdict["gang"] = gang_of(pod).name
        self._emit_event(
            pod, "WorkerHung",
            f"worker {w} made no step progress for "
            f"{verdict['stalledSeconds']}s (deadline {self.hang_deadline_s}s)",
        )
        if node:
            self._cordon(node, verdict)
        self._drain_gang(pod, now)

    def _cordon(self, node: str, verdict: Dict[str, Any]) -> None:
        with self._lock:
            if node in self._quarantined:
                return
        nobj = self._client.get_opt("v1", "Node", node, None)
        if nobj is None:
            return
        if is_quarantined(nobj):
            # informer echo / a prior detector instance already cordoned it
            with self._lock:
                self._quarantined.add(node)
            return
        payload = json.dumps({
            "worker": verdict["worker"],
            "reason": "hang",
            "at": verdict["detectedAt"],
        })
        try:
            self._client.patch(
                "v1", "Node", node,
                {"metadata": {"annotations": {QUARANTINE_ANNOTATION: payload}}},
                None,
            )
        except Exception:
            LOG.exception("failed to quarantine node %s", node)
            return
        with self._lock:
            self._quarantined.add(node)
        self._emit_event(
            nobj, "NodeQuarantined",
            f"node {node} quarantined: worker {verdict['worker']} hang verdict",
        )

    def _drain_gang(self, pod: Dict[str, Any], now: float) -> None:
        gang = gang_of(pod)
        if gang.labeled:
            members = self._client.list(
                "v1", "Pod", gang.namespace,
                label_selector={POD_GROUP_LABEL: gang.name},
            )
        else:
            members = [pod]
        for m in members:
            if is_terminal(m):
                continue
            anns = annotations_of(m)
            if DRAIN_DEADLINE_ANNOTATION in anns:
                continue  # a drain is already in flight — idempotent
            grace = drain_grace_of(m) or self.default_grace_s
            try:
                self._client.patch(
                    "v1", "Pod", name_of(m),
                    {"metadata": {"annotations": {
                        DRAIN_DEADLINE_ANNOTATION: str(now + grace),
                    }}},
                    namespace_of(m),
                )
            except Exception:
                LOG.exception("failed to drain pod %s", name_of(m))

    def _emit_worker_event(self, worker: str, reason: str, message: str) -> None:
        if self._client is None:
            return
        pod = self._client.get_opt("v1", "Pod", worker, self._namespace)
        if pod is not None:
            self._emit_event(pod, reason, message)

    def _emit_event(self, obj: Dict[str, Any], reason: str, message: str) -> None:
        try:
            self._client.emit_event(
                obj, reason, message, type_="Warning", component=self.component,
            )
        except Exception:
            LOG.exception("failed to emit %s event", reason)

    # -- read side -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The detector's view: per-worker scores and verdicts, the
        quarantined nodes, the last hang verdict and the configuration."""
        with self._lock:
            workers = {
                w: {
                    "score": sum(st.window) / float(self.n),
                    "flagged": st.flagged,
                    "hung": st.hung,
                    "stepIndex": st.step,
                    "incarnation": st.incarnation,
                    "lastProgressAt": st.progress_at,
                }
                for w, st in self._state.items()
            }
            return {
                "workers": workers,
                "quarantined": sorted(self._quarantined),
                "lastHangVerdict": (
                    dict(self.last_hang_verdict)
                    if self.last_hang_verdict else None
                ),
                "config": {
                    "skewFactor": self.skew_factor,
                    "k": self.k,
                    "n": self.n,
                    "hangDeadlineSeconds": self.hang_deadline_s,
                },
            }


def straggler_rules(
    *, step_slo_s: float = 1.0, objective: float = 0.99
) -> List[Any]:
    """The straggler plane's rule-engine bundle: a recording rule tracking
    the gang's max/median step-wall skew ratio, plus an SRE-workbook SLO
    burn-rate alert on per-worker step latency."""

    def _skew(tsdb: Any, now: float):
        rows = tsdb.latest("training_worker_step_wall_seconds")
        vals = [float(v) for _labels, _ts, v in rows if float(v) > 0.0]
        if len(vals) < 2:
            return []
        median = statistics.median(vals)
        if median <= 0.0:
            return []
        return [({}, max(vals) / median)]

    return [
        RecordingRule("platform:training_worker_step_skew", _skew),
        SLOBurnRateAlert(
            "TrainingWorkerStepLatency",
            "training_worker_step_seconds",
            step_slo_s,
            objective=objective,
        ),
    ]
