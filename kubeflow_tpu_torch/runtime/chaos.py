"""Seeded fault injection for the serving fleet: a trimmed copy of
``kubeflow_tpu/runtime/chaos.py``.

The JAX harness breaks a whole control plane on purpose; the port keeps
its serving kinds, which act on an :class:`~kubeflow_tpu_torch.serving.fleet.EngineFleet`
(or anything exposing ``live_handles()``) through the engine hooks
``step_delay_s``, ``fail_next_step`` and ``cancel_requests``:

- ``slow_replica``            — add ``param`` seconds of latency to every
  engine iteration of one replica for ``duration`` seconds (a throttled or
  noisy-neighbour card): deadlines expire, the fleet breaker opens;
- ``crash_replica_mid_decode`` — poison one replica's next engine
  iteration so it dies as a device failure would, its in-flight requests
  failing with ``EngineClosed``;
- ``client_abandon``          — cancel up to ``param`` in-flight or queued
  requests (clients disconnecting mid-generation); the engine reaps the
  slots.

:class:`Fault` and :meth:`ChaosSchedule.seeded` are JAX's, arithmetic
unchanged, so the same seed and spec give the same faults. The kinds that
act on the apiserver, informers, processes or Nodes (``kill_node``,
``preempt_gang``, ``drop_informer_watch``, ``delay_apiserver``,
``flood_apiserver``, ``kill9_*``) and the training-worker kinds
(``slow_worker``, ``wedge_worker``) are not ported: ``Fault`` refuses them
as JAX's refuses an unknown kind. ``stop()`` resets every slowed engine,
and every firing bumps ``chaos_faults_injected_total{kind}``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .metrics import METRICS

LOG = logging.getLogger(__name__)

KINDS = ("slow_replica", "crash_replica_mid_decode", "client_abandon")


@dataclass(frozen=True)
class Fault:
    """One scheduled failure: fire ``kind`` against ``target`` (a replica's
    gauge id or id; None = the first live one) ``at`` seconds after the
    monkey starts. ``param`` is the per-iteration delay in seconds for
    slow_replica and the request count for client_abandon; ``duration``
    bounds how long slow_replica stays applied (0 = until the monkey
    stops)."""

    at: float
    kind: str
    target: Optional[str] = None
    param: float = 0.0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {KINDS}")


class ChaosSchedule:
    """An ordered fault list, built explicitly or derived from a seed with
    :meth:`seeded`: the same (seed, spec) always yields the same schedule."""

    def __init__(self, faults: Sequence[Fault]) -> None:
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.at)

    @classmethod
    def seeded(
        cls,
        seed: int,
        n: int,
        duration: float,
        targets: Dict[str, Sequence[str]],
        param: Dict[str, float] = None,
    ) -> "ChaosSchedule":
        """``n`` faults uniformly over ``duration`` seconds, kinds drawn
        from ``targets``' keys, target drawn per kind."""
        rng = random.Random(seed)
        kinds = sorted(targets)
        faults = []
        for _ in range(n):
            kind = rng.choice(kinds)
            choices = list(targets[kind])
            faults.append(
                Fault(
                    at=rng.uniform(0.0, duration),
                    kind=kind,
                    target=rng.choice(choices) if choices else None,
                    param=(param or {}).get(kind, 0.0),
                )
            )
        return cls(faults)


class ChaosMonkey:
    """Fires a :class:`ChaosSchedule` at a serving fleet. A fault that
    cannot be injected (no fleet, no live replica, nothing to abandon) is
    logged and skipped, as JAX's are: a harness asserts each fault's effect."""

    def __init__(self, schedule: ChaosSchedule, *, fleet: Any = None) -> None:
        self._schedule = schedule
        #: EngineFleet (or anything with ``live_handles()``): the target set
        self._fleet = fleet
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        #: engines slowed by slow_replica, reset on stop() so a finished
        #: chaos run never leaves a replica degraded
        self._slowed: List[Any] = []
        self.fired: List[Fault] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ChaosMonkey":
        t = threading.Thread(target=self._run, name="chaos-monkey", daemon=True)
        self._threads.append(t)
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for eng in self._slowed:
            eng.step_delay_s = 0.0
        for t in self._threads:
            t.join(timeout=5.0)

    def join(self, timeout: Optional[float] = None) -> None:
        for t in list(self._threads):
            t.join(timeout=timeout)

    def _run(self) -> None:
        t0 = time.monotonic()
        for fault in self._schedule.faults:
            delay = fault.at - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            self.inject(fault)

    # -- injectors -----------------------------------------------------------
    def inject(self, fault: Fault) -> None:
        LOG.warning("chaos: injecting %s target=%s param=%s",
                    fault.kind, fault.target, fault.param)
        try:
            getattr(self, f"_{fault.kind}")(fault)
        except Exception as e:  # a failed injection must not kill the monkey
            LOG.warning("chaos: %s failed: %s", fault.kind, e)
            return
        METRICS.counter("chaos_faults_injected_total", kind=fault.kind).inc()
        self.fired.append(fault)

    def _find_replica(self, target: Optional[str]):
        """Resolve ``target`` against the fleet's live replicas by gauge id
        or replica id; None picks the first live replica."""
        if self._fleet is None:
            raise RuntimeError("serving faults need a fleet")
        handles = list(self._fleet.live_handles())
        if not handles:
            raise RuntimeError("no live replica to target")
        if target is None:
            return handles[0]
        for h in handles:
            if target in (getattr(h, "gauge_id", None), getattr(h, "id", None)):
                return h
        raise RuntimeError(f"no live replica matches {target!r}")

    def _slow_replica(self, fault: Fault) -> None:
        """Every engine iteration on the replica gains ``param`` seconds;
        after ``duration`` seconds (or stop()) the replica recovers."""
        eng = self._find_replica(fault.target).engine
        eng.step_delay_s = max(0.0, fault.param)
        self._slowed.append(eng)
        if fault.duration > 0:

            def recover():
                self._stop.wait(fault.duration)
                eng.step_delay_s = 0.0

            t = threading.Thread(target=recover, name="chaos-slow-recover", daemon=True)
            self._threads.append(t)
            t.start()

    def _crash_replica_mid_decode(self, fault: Fault) -> None:
        """Poison the replica's next engine iteration: it raises mid-decode,
        the engine shuts down, and every in-flight request fails with
        EngineClosed. An idle engine is poked so that it crashes now: JAX's
        waits for its next request and fails it, so a fleet could route
        there and answer 503 after the crash."""
        engine = self._find_replica(fault.target).engine
        engine.fail_next_step = True
        poke = getattr(engine, "poke", None)
        if poke is not None:
            poke()

    def _client_abandon(self, fault: Fault) -> None:
        """Cancel up to ``param`` in-flight or queued requests on the target
        replica, then on the others (all replicas when no target is named)."""
        want = max(1, int(fault.param or 1))
        if self._fleet is None:
            raise RuntimeError("serving faults need a fleet")
        handles = list(self._fleet.live_handles())
        if fault.target is not None:
            handles = [self._find_replica(fault.target)] + [
                h for h in handles
                if fault.target not in (getattr(h, "gauge_id", None),
                                        getattr(h, "id", None))
            ]
        cancelled = 0
        for h in handles:
            cancelled += h.engine.cancel_requests(want - cancelled)
            if cancelled >= want:
                break
        if cancelled == 0:
            raise RuntimeError("no in-flight request to abandon")
