"""Goodput ledger: where did the workload's wallclock go? A trimmed copy
of ``kubeflow_tpu/monitoring/goodput.py``.

:class:`GoodputLedger` decomposes an incarnation-spanning run into goodput
plus named badput buckets with JAX's honesty contract:

- every bucket is MEASURED, never modeled; the unmeasured residual lands in
  ``other`` instead of inflating a named bucket,
- the emitted fractions sum to exactly 1.0, in any order (each is a
  multiple of 2⁻⁵²; JAX's close only the left-to-right sum: ROADMAP C),
- ``reconstructionError`` reports how much of the measured wallclock the
  named (non-``other``) parts reconstruct — the goodput e2e gates it ≤ 5%.

Producers (``training.elastic.ElasticTrainer``) feed the ledger through
JAX's calls: ``note(bucket, seconds)`` for directly-timed intervals,
``step(index, seconds)`` for per-step wall time (replayed step indices — at
or below the high-water mark of a previous incarnation — are badput,
bucket ``preemption_replay``), ``begin_incarnation``/``end_incarnation``
for the per-incarnation section, and ``attach_step_clock`` (the port's
``gpu.profiling.StepClock``) whose separately-accumulated compile and
``data_wait`` phases are drained out of step wall time into their own
buckets. The port has no ahead-of-time compile: its ``compile`` bucket
holds what a workload times under ``StepClock.compile`` (ROADMAP C.4).

Surfaces, JAX's: ``training_badput_seconds_total{bucket}`` /
``training_goodput_seconds_total`` counters, the
``training_goodput_fraction{workload}`` gauge (refreshed at every render by
a ``goodput:<workload>`` collector), ``GET /debug/goodput`` on every app
that mounts the port's observability, :func:`serving_goodput_view` over
the serving waste counters, :class:`TenantChipMeter`
(``tenant_chip_seconds_total{namespace}`` from bind/unbind calls; the
process-wide ``TENANT_METER``, whose bound chips ``/debug/goodput`` shows
under ``tenants``) and :func:`goodput_recording_rules` (the monitoring
plane's ``platform:training_goodput_fraction``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Tuple

from ..runtime.metrics import METRICS, MetricsRegistry
from ..runtime.obs import register_debug_source
from .rules import RecordingRule

#: badput buckets in display order; ``other`` is always the computed
#: residual (wallclock minus everything measured), never written directly
BADPUT_BUCKETS = (
    "scheduling_wait",
    "compile",
    "checkpoint_save",
    "checkpoint_restore",
    "preemption_replay",
    "reshard",
    "data_wait",
    "other",
)

MEASURED_BUCKETS = tuple(b for b in BADPUT_BUCKETS if b != "other")

#: the fractions' grid: multiples of it in [0, 2) add exactly in binary64
_GRID = 2.0 ** -52


def _on_grid(x: float) -> float:
    return round(x / _GRID) * _GRID


class GoodputLedger:
    """Incarnation-spanning goodput/badput decomposition for one workload.

    Thread-safe; registry writes (counters, the fraction gauge) happen
    outside the internal lock so no lock order ties this to the metrics
    registry. A collector keyed ``goodput:<workload>`` refreshes the
    ``training_goodput_fraction`` gauge at every exposition render, so a
    mid-run scrape sees the live fraction, not the last ``finish()``.
    """

    def __init__(
        self,
        workload: str = "training",
        *,
        registry: MetricsRegistry = METRICS,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        self.workload = workload
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._started: Optional[float] = None
        self._ended: Optional[float] = None
        self._goodput = 0.0
        self._badput: Dict[str, float] = {b: 0.0 for b in MEASURED_BUCKETS}
        self._high_water = -1
        self._incarnations: List[Dict[str, Any]] = []
        self._open: Optional[Dict[str, Any]] = None
        self._step_clock: Optional[Any] = None
        self._compile_seen = 0.0
        self._clock_steps_seen = 0
        _register_ledger(self)
        registry.register_collector(f"goodput:{workload}", self._refresh_gauge)

    # -- producer API --------------------------------------------------------
    def start(self) -> None:
        """Anchor the workload wallclock (idempotent: first call wins)."""
        with self._lock:
            if self._started is None:
                self._started = self._clock()
            self._ended = None

    def attach_step_clock(self, step_clock: Any) -> None:
        """Adopt a StepClock-shaped source (``compile_s`` accumulator +
        ``steps`` phase records): compile and ``data_wait`` time recorded
        during a step is drained out of that step's wall time into the
        matching badput buckets."""
        with self._lock:
            self._step_clock = step_clock
            self._compile_seen = float(getattr(step_clock, "compile_s", 0.0))
            self._clock_steps_seen = len(getattr(step_clock, "steps", ()))

    def begin_incarnation(self, attempt: int) -> None:
        with self._lock:
            if self._started is None:
                self._started = self._clock()
            if self._open is not None:
                self._close_incarnation_locked("abandoned", None)
            self._open = {
                "attempt": int(attempt),
                "startedAt": self._clock(),
                "goodputSeconds": 0.0,
                "badputSeconds": {b: 0.0 for b in MEASURED_BUCKETS},
                "replaySteps": 0,
            }

    def note(self, bucket: str, seconds: float) -> None:
        """Account a directly-measured badput interval."""
        if bucket not in MEASURED_BUCKETS:
            raise ValueError(f"unknown badput bucket {bucket!r} "
                             f"(one of {MEASURED_BUCKETS})")
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._note_locked(bucket, seconds)
        self._registry.counter(
            "training_badput_seconds_total", bucket=bucket).inc(seconds)

    def step(self, index: int, wall_seconds: float) -> None:
        """Account one training step's wall time. Compile/data_wait drained
        from the attached StepClock come off the top; the remainder is
        goodput for a first-time step index, ``preemption_replay`` for a
        step at or below a previous incarnation's high-water mark."""
        wall_seconds = max(0.0, float(wall_seconds))
        emit: List[Tuple[str, float]] = []
        with self._lock:
            compile_d, data_d = self._drain_clock_locked()
            productive = max(0.0, wall_seconds - compile_d - data_d)
            if compile_d > 0.0:
                self._note_locked("compile", compile_d)
                emit.append(("compile", compile_d))
            if data_d > 0.0:
                self._note_locked("data_wait", data_d)
                emit.append(("data_wait", data_d))
            if index <= self._high_water:
                self._note_locked("preemption_replay", productive)
                emit.append(("preemption_replay", productive))
                if self._open is not None:
                    self._open["replaySteps"] += 1
            else:
                self._high_water = index
                self._goodput += productive
                if self._open is not None:
                    self._open["goodputSeconds"] += productive
        for bucket, seconds in emit:
            self._registry.counter(
                "training_badput_seconds_total", bucket=bucket).inc(seconds)
        if not any(b == "preemption_replay" for b, _s in emit):
            self._registry.counter("training_goodput_seconds_total").inc(
                max(0.0, wall_seconds - sum(s for _b, s in emit)))

    def end_incarnation(self, outcome: str,
                        end_step: Optional[int] = None) -> Dict[str, Any]:
        """Close the open incarnation; returns its goodput section (the
        dict the trainer embeds in the incarnation metadata)."""
        with self._lock:
            section = self._close_incarnation_locked(outcome, end_step)
        return section if section is not None else {}

    def finish(self) -> Dict[str, Any]:
        """Stop the wallclock (idempotent) and return a final snapshot."""
        with self._lock:
            if self._open is not None:
                self._close_incarnation_locked("abandoned", None)
            if self._ended is None and self._started is not None:
                self._ended = self._clock()
            snap = self._snapshot_locked()
        self._set_gauge(snap)
        return snap

    # -- consumer API --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The decomposition right now: seconds per bucket, fractions that
        sum to exactly 1.0, and the honesty number (``reconstructionError``
        — the share of wallclock the named buckets fail to reconstruct)."""
        with self._lock:
            return self._snapshot_locked()

    # -- internals -----------------------------------------------------------
    def _note_locked(self, bucket: str, seconds: float) -> None:
        self._badput[bucket] += seconds
        if self._open is not None:
            self._open["badputSeconds"][bucket] += seconds

    def _drain_clock_locked(self) -> Tuple[float, float]:
        clock = self._step_clock
        if clock is None:
            return 0.0, 0.0
        compile_total = float(getattr(clock, "compile_s", 0.0))
        compile_d = max(0.0, compile_total - self._compile_seen)
        self._compile_seen = compile_total
        steps = getattr(clock, "steps", [])
        data_d = 0.0
        for rec in steps[self._clock_steps_seen:]:
            data_d += float(rec.get("data_wait", 0.0))
        self._clock_steps_seen = len(steps)
        return compile_d, data_d

    def _close_incarnation_locked(
            self, outcome: str, end_step: Optional[int]
    ) -> Optional[Dict[str, Any]]:
        section = self._open
        self._open = None
        if section is None:
            return None
        started_at = section.pop("startedAt")
        section["wallclockSeconds"] = max(0.0, self._clock() - started_at)
        section["outcome"] = outcome
        if end_step is not None:
            section["endStep"] = int(end_step)
        self._incarnations.append(section)
        return section

    def _snapshot_locked(self) -> Dict[str, Any]:
        if self._started is None:
            wall = 0.0
        else:
            wall = max(0.0, (self._ended or self._clock()) - self._started)
        measured = dict(self._badput)
        named = self._goodput + sum(measured.values())
        other = max(0.0, wall - named)
        parts = dict(measured)
        parts["other"] = other
        denom = self._goodput + sum(parts.values())
        if denom <= 0.0:
            fractions = {"goodput": 1.0}
            fractions.update({b: 0.0 for b in BADPUT_BUCKETS})
        else:
            fractions = {"goodput": _on_grid(self._goodput / denom)}
            for b in BADPUT_BUCKETS:
                if b != "other":
                    fractions[b] = _on_grid(parts[b] / denom)
            # the honesty contract is checked with ==, not ≈. Every fraction
            # is a multiple of 2⁻⁵² in [0, 1], so every partial sum of them,
            # in any order, is exact, and the residual bucket closes each
            # one to 1.0: the ~1e-16 slop of the divisions lands in
            # ``other`` beside the unmeasured wallclock it already holds.
            # (JAX closes the plain left-to-right sum only; Python's ``sum``
            # has been compensated since 3.12 and may then read 1 - 2⁻⁵³.)
            fractions["other"] = 1.0 - math.fsum(fractions.values())
        return {
            "workload": self.workload,
            "wallclockSeconds": wall,
            "goodputSeconds": self._goodput,
            "badputSeconds": parts,
            "measuredSeconds": named,
            "reconstructionError": (abs(wall - named) / wall) if wall > 0 else 0.0,
            "goodputFraction": fractions["goodput"],
            "fractions": fractions,
            "incarnations": list(self._incarnations),
        }

    def _refresh_gauge(self) -> None:
        with self._lock:
            started = self._started is not None
            snap = self._snapshot_locked() if started else None
        if snap is not None:
            self._set_gauge(snap)

    def _set_gauge(self, snap: Dict[str, Any]) -> None:
        self._registry.gauge(
            "training_goodput_fraction", workload=self.workload
        ).set(round(snap["goodputFraction"], 6))


# -- per-tenant chip metering --------------------------------------------------


class TenantChipMeter:
    """``tenant_chip_seconds_total{namespace}`` from bind/unbind lifecycle.

    JAX's scheduler ledger calls ``on_bind`` for every record it puts and
    ``on_unbind`` for every record it drops (the port has no scheduler: a
    caller that binds pods calls them); an interval stays open while the
    pod is bound. Replay-idempotent: the informer echo of a bind
    the scheduler already assumed carries an identical (namespace, chips)
    record and must NOT restart the interval. ``flush`` (registered as a
    metrics collector, so it runs at every scrape) settles open intervals
    incrementally — the counter tracks live binds within one scrape
    interval instead of only materializing at unbind.

    Counter increments happen after the internal lock is released, so the
    meter imposes no lock order against the metrics registry.
    """

    def __init__(self, *, registry: MetricsRegistry = METRICS,
                 clock: Callable[[], float] = time.monotonic,
                 collector_key: Optional[str] = "tenant-chip-meter") -> None:
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        #: key -> [namespace, chips, interval anchor (last settle)]
        self._open: Dict[Hashable, List[Any]] = {}
        if collector_key is not None:
            registry.register_collector(collector_key, self.flush)

    def on_bind(self, key: Hashable, namespace: Optional[str],
                chips: int) -> None:
        ns = namespace or "default"
        chips = int(chips)
        now = self._clock()
        settled: List[Tuple[str, float]] = []
        with self._lock:
            cur = self._open.get(key)
            if cur is not None:
                if cur[0] == ns and cur[1] == chips:
                    return  # informer echo of an assumed bind: same interval
                settled.append(self._settle_locked(cur, now))
            self._open[key] = [ns, chips, now]
        self._emit(settled)

    def on_unbind(self, key: Hashable) -> None:
        now = self._clock()
        settled: List[Tuple[str, float]] = []
        with self._lock:
            cur = self._open.pop(key, None)
            if cur is not None:
                settled.append(self._settle_locked(cur, now))
        self._emit(settled)

    def flush(self) -> None:
        """Settle every open interval up to now (scrape-time collector)."""
        now = self._clock()
        with self._lock:
            settled = [self._settle_locked(cur, now)
                       for cur in self._open.values()]
        self._emit(settled)

    def open_intervals(self) -> Dict[str, int]:
        """namespace -> currently-bound chips (for /debug/goodput)."""
        out: Dict[str, int] = {}
        with self._lock:
            for ns, chips, _anchor in self._open.values():
                out[ns] = out.get(ns, 0) + chips
        return out

    def _settle_locked(self, cur: List[Any], now: float) -> Tuple[str, float]:
        ns, chips, anchor = cur
        dt = max(0.0, now - anchor)
        cur[2] = now
        return ns, chips * dt

    def _emit(self, settled: Iterable[Tuple[str, float]]) -> None:
        for ns, chip_seconds in settled:
            if chip_seconds > 0.0:
                self._registry.counter(
                    "tenant_chip_seconds_total", namespace=ns
                ).inc(chip_seconds)


#: the process-wide meter (``/debug/goodput``'s ``tenants``)
TENANT_METER = TenantChipMeter()


# -- serving goodput view ------------------------------------------------------


def serving_goodput_view(registry: MetricsRegistry = METRICS) -> Dict[str, Any]:
    """Token-level goodput for the serving plane, from the waste counters
    the continuous batcher already maintains: delivered tokens vs tokens
    computed for nobody (``serving_discarded_tail_tokens_total``, of which
    ``serving_wasted_decode_tokens_total`` is the deadline/abandonment
    subset — the goodput-loss counter), plus the request-level
    shed/expiry context."""
    delivered = registry.total("serving_tokens_out_total")
    discarded = registry.total("serving_discarded_tail_tokens_total")
    wasted = registry.total("serving_wasted_decode_tokens_total")
    generated = delivered + discarded
    return {
        "deliveredTokens": delivered,
        "discardedTailTokens": discarded,
        "wastedDecodeTokens": wasted,
        "shedRequests": registry.total("serving_shed_total"),
        "deadlineExpired": registry.total("serving_deadline_expired_total"),
        "tokenGoodputFraction":
            (delivered / generated) if generated > 0 else None,
    }


# -- surfacing: the debug source ---------------------------------------------

_LEDGERS_LOCK = threading.Lock()
_LEDGERS: Dict[str, GoodputLedger] = {}


def _register_ledger(ledger: GoodputLedger) -> None:
    with _LEDGERS_LOCK:
        _LEDGERS[ledger.workload] = ledger


def get_ledger(workload: str = "training") -> GoodputLedger:
    """The process-wide ledger for ``workload`` (created on first use)."""
    with _LEDGERS_LOCK:
        existing = _LEDGERS.get(workload)
    return existing if existing is not None else GoodputLedger(workload)


def debug_goodput(_req: Any = None) -> Dict[str, Any]:
    """``GET /debug/goodput``: every workload ledger's decomposition, the
    serving token-goodput view, and the live per-tenant bound-chip set."""
    with _LEDGERS_LOCK:
        ledgers = list(_LEDGERS.values())
    return {
        "workloads": {led.workload: led.snapshot() for led in ledgers},
        "serving": serving_goodput_view(),
        "tenants": {"boundChips": TENANT_METER.open_intervals()},
    }


register_debug_source("goodput", debug_goodput)


def goodput_recording_rules() -> List[RecordingRule]:
    """Recording rules for the monitoring plane's RuleEngine.

    ``platform:training_goodput_fraction`` recomputes the measured goodput
    share TSDB-side from the scraped second counters — the federation-level
    cross-check of the in-process ``training_goodput_fraction`` gauge. (The
    counters carry only MEASURED seconds, so this is the measured share;
    the unmeasured ``other`` residual is visible in /debug/goodput and the
    gauge, which divide by true wallclock.)"""

    def _measured_fraction(tsdb: Any, _now: float):
        good = sum(v for _l, _t, v in
                   tsdb.latest("training_goodput_seconds_total"))
        bad = sum(v for _l, _t, v in
                  tsdb.latest("training_badput_seconds_total"))
        if good + bad > 0.0:
            yield {}, good / (good + bad)

    return [RecordingRule(record="platform:training_goodput_fraction",
                          fn=_measured_fraction)]
