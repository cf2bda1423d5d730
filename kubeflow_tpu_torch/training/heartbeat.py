"""Per-worker step beacons — the straggler plane's raw signal. The port of
``kubeflow_tpu/training/heartbeat.py``.

A :class:`WorkerBeacon` is a worker's heartbeat: each training step
publishes the worker's step index, incarnation, step wall time and
per-phase split (including the ``collective_wait`` phase from the port's
:meth:`StepClock.collective <kubeflow_tpu_torch.gpu.profiling.StepClock.collective>`)
as JAX's ``training_worker_*`` metrics, which
:class:`~kubeflow_tpu_torch.monitoring.stragglers.StragglerDetector`
cross-sections per tick.

The beacon doubles as the chaos handle of a worker: ``slow_factor``
stretches the worker's per-step pacing and ``wedge()`` parks it inside
:meth:`WorkerBeacon._wedge_wait` until released — so an injected hang
produces a ``/debug/stacks`` dump (``runtime/obs.py``) that names the
wedged frame. ``GET /debug/beacon`` shows every registered worker's latest
heartbeat.

Metric names are constant; per-worker dimensions ride in the ``worker``
label so cardinality is one series per gang member, not per name.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..runtime.metrics import METRICS
from ..runtime.obs import register_debug_source

#: the phases a beacon breaks a step into (superset is fine — anything the
#: StepClock measured is forwarded; these always exist, zero when unmeasured)
CANONICAL_PHASES = ("data_wait", "compute", "fetch", "collective_wait")

#: process-global beacon registry backing the ``/debug/beacon`` source —
#: keyed by worker id, last registration per id wins (what per-test and
#: per-incarnation rebuilds need)
_BEACONS: Dict[str, "WorkerBeacon"] = {}
_BEACONS_LOCK = threading.Lock()


class WorkerBeacon:
    """One worker's per-step heartbeat publisher + chaos throttle point.

    ``publish(rec)`` takes a StepClock ``end_step()`` record (or any dict
    with a ``total`` and phase keys) and lands it in the metrics registry;
    ``throttle()`` is the chaos interposition point the workload calls
    under its ``collective_wait`` phase — a slowed worker sleeps there, a
    wedged worker blocks there until released.
    """

    def __init__(
        self,
        worker: str,
        *,
        registry: Any = METRICS,
        step_delay_s: float = 0.0,
        expected_collective_s: Optional[Callable[[], float]] = None,
    ) -> None:
        self.worker = str(worker)
        self._ns = registry.namespace("training_worker")
        #: base per-step pacing (the simulated collective) — chaos multiplies
        self.step_delay_s = float(step_delay_s)
        #: chaos handle: >1.0 stretches every step's pacing sleep
        self.slow_factor = 1.0
        #: chaos handle: set → the worker parks in _wedge_wait until cleared
        self._wedge = threading.Event()
        self._released = threading.Event()
        self._released.set()
        #: analytic collective-wait floor (parallel/comm.py) reported when
        #: the workload has no measured collective phase
        self._expected_collective = expected_collective_s
        self.incarnation = 0
        self.step_index = -1
        self.last_step_at = 0.0
        self.last_rec: Dict[str, float] = {}
        with _BEACONS_LOCK:
            _BEACONS[self.worker] = self

    # -- chaos handles -------------------------------------------------------
    def wedge(self) -> None:
        """Park the worker at its next ``throttle()`` until ``release()``."""
        self._released.clear()
        self._wedge.set()

    def release(self) -> None:
        """Undo ``wedge()`` — the parked worker resumes immediately."""
        self._wedge.clear()
        self._released.set()

    @property
    def wedged(self) -> bool:
        return self._wedge.is_set()

    def _wedge_wait(self) -> None:
        # A dedicated frame so the hang forensics stack dump names it: a
        # wedged worker's dump reads ``... throttle -> _wedge_wait``.
        while not self._released.wait(timeout=0.05):
            pass

    def throttle(self) -> float:
        """The chaos interposition point, called once per step (under the
        workload's ``collective_wait`` phase): applies the pacing sleep
        stretched by ``slow_factor``, then blocks while wedged. Returns the
        wall seconds spent."""
        t0 = time.perf_counter()
        delay = self.step_delay_s * max(1.0, self.slow_factor)
        if delay > 0.0:
            time.sleep(delay)
        if self._wedge.is_set():
            self._wedge_wait()
        return time.perf_counter() - t0

    # -- publishing ----------------------------------------------------------
    def begin_incarnation(self, attempt: int) -> None:
        """A new incarnation restarts the step index from its checkpoint —
        the beacon bumps the incarnation gauge FIRST so the detector can
        tell a restart from a counter going backwards."""
        self.incarnation = int(attempt)
        self.step_index = -1
        self._ns.gauge("incarnation", worker=self.worker).set(float(attempt))

    def publish(self, rec: Dict[str, float], step: Optional[int] = None) -> None:
        """Land one step's record in the registry. ``rec`` is a StepClock
        ``end_step()`` dict (phase seconds + ``total``); ``step`` overrides
        the monotonic local counter (the restore path starts mid-run)."""
        self.step_index = self.step_index + 1 if step is None else int(step)
        total = float(rec.get("total", 0.0))
        now = time.time()
        self.last_step_at = now
        self.last_rec = {k: float(v) for k, v in rec.items()}
        ns = self._ns
        w = self.worker
        ns.counter("step_total", worker=w).inc()
        ns.histogram("step_seconds", worker=w).observe(total)
        ns.gauge("step_wall_seconds", worker=w).set(total)
        ns.gauge("step_index", worker=w).set(float(self.step_index))
        ns.gauge("last_step_timestamp_seconds", worker=w).set(now)
        for phase in CANONICAL_PHASES:
            measured = float(rec.get(phase, 0.0))
            if (
                phase == "collective_wait"
                and measured == 0.0
                and self._expected_collective is not None
            ):
                # no measured collective phase: report the analytic floor
                # (parallel/comm.collective_wait_seconds) so the skew view
                # still has a baseline column
                measured = float(self._expected_collective())
            ns.gauge("phase_seconds", worker=w, phase=phase).set(measured)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "worker": self.worker,
            "incarnation": self.incarnation,
            "stepIndex": self.step_index,
            "lastStepAt": self.last_step_at,
            "slowFactor": self.slow_factor,
            "wedged": self.wedged,
            "lastStep": dict(self.last_rec),
        }


def beacons() -> Dict[str, WorkerBeacon]:
    """The live beacon registry (worker id → beacon), for chaos targeting."""
    with _BEACONS_LOCK:
        return dict(_BEACONS)


def clear_beacons() -> None:
    """Drop all registered beacons (test isolation)."""
    with _BEACONS_LOCK:
        _BEACONS.clear()


def _beacon_source(req: Any) -> Dict[str, Any]:
    """``GET /debug/beacon`` — every registered worker's latest heartbeat."""
    with _BEACONS_LOCK:
        items = list(_BEACONS.values())
    return {"workers": {b.worker: b.snapshot() for b in items}}


register_debug_source("beacon", _beacon_source)
