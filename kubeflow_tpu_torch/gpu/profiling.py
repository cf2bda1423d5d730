"""Step telemetry and torch.profiler integration.

The port of ``kubeflow_tpu/tpu/profiling.py``: :class:`StepClock` is a
faithful copy (its metrics and tracer are the port's
``runtime.metrics``/``runtime.tracing``), :func:`step_trace`,
:func:`annotate` and :func:`profile_step` go through ``torch.profiler`` in
place of ``jax.profiler`` and write Chrome traces (``*.pt.trace.json``) that
Perfetto and chrome://tracing open. :func:`step_breakdown` is ``bench.py``'s
``_step_breakdown``: the per-step dict a training run reports.

Left out, queued in ROADMAP.md: ``register_profile_clock`` and the
``/debug/profile`` endpoint (they need the port's ``mount_observability``)
and ``start_profile_server`` (TensorBoard's capture over JAX's profiler
server).
"""

from __future__ import annotations

import collections
import glob
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, List, Optional

import torch


@contextmanager
def step_trace(logdir: str, name: str = "step"):
    """Capture a torch.profiler trace of the host and the card into
    ``logdir`` (a Chrome trace per capture). Use around a handful of steps,
    not whole runs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.{os.getpid()}.pt.trace.json"))


def annotate(name: str):
    """Named region inside a trace (shows as a range in the timeline)."""
    return torch.profiler.record_function(name)


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepClock:
    """Wall-clock step breakdown for training/bench loops.

    The profiler trace (above) answers "where did the time go" offline; the
    clock answers it live, per step, with host-side timers cheap enough to
    leave on: wrap each phase of the loop body and ``end_step()`` at the
    bottom. The canonical phases:

        with clock.compile(): _build.load_all()   # first-use work
        for batch in data:
            with clock.compute(): loss = train_step(model, opt, batch)
            with clock.fetch():   value = float(loss)   # D2H sync
            clock.end_step()

    Each record holds the measured phases plus ``total`` (wall since the
    previous ``end_step``) and ``other`` (total minus measured — dispatch
    overhead, Python, logging). Compile time accumulates separately and is
    never charged to a step, so first-use work (a kernel build, cuDNN's
    algorithm search) can't masquerade
    as slow data loading (the classic misread this exists to kill). With a
    ``metrics`` namespace (``METRICS.namespace("train")``) every phase also
    lands in ``<ns>_step_<phase>_seconds`` histograms for ``/metrics``.
    With a ``tracer`` (``runtime.tracing.TRACER``) every ``end_step()``
    additionally emits one ``span_name`` span covering the step, its phases
    attached as events — so a training run's timeline shows up in
    ``/debug/traces`` next to the serving requests.

    Phase events are always retained per step in a bounded ring
    (``keep_steps``, default 512) so the timeline survives without a
    tracer: ``to_chrome_trace()`` renders the recorded steps as a
    Chrome-trace-event document (the ``trace.json`` Perfetto and
    chrome://tracing load).

    In eager PyTorch ``compute`` around a step measures its host dispatch
    and ``fetch`` around the loss read waits for the device, so a step's
    device time lands in ``fetch`` once the host runs ahead.
    """

    def __init__(self, metrics: Optional[Any] = None,
                 tracer: Optional[Any] = None,
                 span_name: str = "train.step",
                 keep_steps: int = 512) -> None:
        self._metrics = metrics
        self._tracer = tracer
        self._span_name = span_name
        self.compile_s = 0.0
        self.steps: List[Dict[str, float]] = []
        self.notes: Dict[str, float] = {}
        self._current: Dict[str, float] = {}
        self._anchor = time.perf_counter()
        self._step_start_ns = time.time_ns()
        self._events: List[Dict[str, Any]] = []
        #: per-step phase-event history for to_chrome_trace(): bounded so a
        #: long training run can't grow host memory without limit
        self._step_records: Deque[Dict[str, Any]] = collections.deque(
            maxlen=keep_steps)

    def note(self, key: str, value: float) -> None:
        """Attach a derived scalar (analytic comm bytes, bubble fraction —
        things computed about the step rather than timed in it) so it rides
        along in ``summary()``/metrics next to the measured phases."""
        self.notes[key] = float(value)
        if self._metrics is not None:
            self._metrics.gauge(key).set(float(value))

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self._current[name] = self._current.get(name, 0.0) + dt
            if self._metrics is not None:
                self._metrics.histogram(f"step_{name}_seconds").observe(dt)
            # always recorded (span-event shape; start derives from end −
            # seconds): the chrome-trace timeline must not require a tracer
            self._events.append({"name": name,
                                 "timeUnixNano": time.time_ns(),
                                 "attributes": {"seconds": dt}})

    # The canonical phases as methods so call sites stay greppable.
    def data_wait(self):
        """Host blocked waiting on the input pipeline (H2D not yet hidden)."""
        return self.phase("data_wait")

    def compute(self):
        """Dispatch of the step's work (plus device execution wherever the
        host waits inside it)."""
        return self.phase("compute")

    def fetch(self):
        """D2H readback of step outputs (loss/metrics scalars)."""
        return self.phase("fetch")

    def collective(self):
        """Host blocked on cross-worker synchronization (barriers, collective
        dispatch waits) — the straggler plane's skew signal: one slow worker
        inflates every peer's collective_wait, not their compute."""
        return self.phase("collective_wait")

    @contextmanager
    def compile(self):
        """First-use work (the kernels' build) — accumulated separately,
        never charged to a step."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.compile_s += time.perf_counter() - start
            if self._metrics is not None:
                self._metrics.gauge("compile_seconds").set(self.compile_s)
            # Reset the anchors ONLY. Clearing self._events here silently
            # dropped phase events recorded earlier in the same step (a
            # data_wait timed before a mid-loop recompile vanished from the
            # step span); already-recorded events must survive.
            self._anchor = time.perf_counter()
            if not self._events:
                self._step_start_ns = time.time_ns()

    def mark(self) -> None:
        """Reset the wall anchor without recording — call after untimed
        work between steps (warmup executions, logging) so the next step's
        ``total``/``other`` doesn't absorb it. Phase events already recorded
        in the open step are preserved (see ``compile()``)."""
        self._anchor = time.perf_counter()
        if not self._events:
            self._step_start_ns = time.time_ns()

    def end_step(self) -> Dict[str, float]:
        now = time.perf_counter()
        now_ns = time.time_ns()
        rec = dict(self._current)
        rec["total"] = now - self._anchor
        rec["other"] = max(0.0, rec["total"] - sum(self._current.values()))
        self.steps.append(rec)
        if self._metrics is not None:
            for k, v in rec.items():
                self._metrics.gauge("step_phase_seconds", phase=k).set(v)
        self._step_records.append({
            "step": len(self.steps),
            "start_ns": self._step_start_ns,
            "end_ns": now_ns,
            "phases": list(self._events),
            "rec": rec,
        })
        if self._tracer is not None:
            self._tracer.emit_span(
                self._span_name, self._step_start_ns, now_ns,
                events=self._events,
                **{"step": len(self.steps),
                   **{f"phase.{k}": round(v, 6) for k, v in rec.items()}})
        self._step_start_ns = now_ns
        self._events = []
        self._current = {}
        self._anchor = now
        return rec

    def to_chrome_trace(self, steps: Optional[int] = None,
                        tid: int = 1) -> Dict[str, Any]:
        """The last ``steps`` recorded steps (all retained when None) as a
        Chrome-trace-event document: one complete ("ph": "X") event per
        step named ``span_name`` with its phase means in ``args``, plus one
        complete event per measured phase (start derived from the phase
        event's end − duration). ``json.dumps`` of the return value is a
        ``trace.json`` Perfetto and chrome://tracing open directly."""
        records = list(self._step_records)
        if steps is not None:
            records = records[-max(0, steps):]
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for r in records:
            events.append({
                "name": self._span_name,
                "cat": "step",
                "ph": "X",
                "ts": r["start_ns"] / 1e3,
                "dur": max(0.0, (r["end_ns"] - r["start_ns"]) / 1e3),
                "pid": pid,
                "tid": tid,
                "args": {"step": r["step"],
                         **{k: round(v, 6) for k, v in r["rec"].items()}},
            })
            for ev in r["phases"]:
                dur_us = float(ev["attributes"].get("seconds", 0.0)) * 1e6
                events.append({
                    "name": ev["name"],
                    "cat": "phase",
                    "ph": "X",
                    "ts": ev["timeUnixNano"] / 1e3 - dur_us,
                    "dur": dur_us,
                    "pid": pid,
                    "tid": tid,
                    "args": {"step": r["step"]},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def summary(self) -> Dict[str, float]:
        """Per-phase mean seconds across recorded steps, plus ``compile_s``
        and the step count — the dict bench.py emits as ``step_breakdown``."""
        out: Dict[str, float] = {}
        if self.steps:
            keys = sorted(set().union(*self.steps))
            n = len(self.steps)
            for k in keys:
                out[k] = sum(s.get(k, 0.0) for s in self.steps) / n
        out.update(self.notes)
        out["compile_s"] = self.compile_s
        out["steps"] = float(len(self.steps))
        return out



def profile_step(
    fn: Callable[..., Any], *args: Any, logdir: str, iters: int = 3, **kwargs: Any
) -> Dict[str, Any]:
    """Run ``fn`` under the profiler (after one untraced warm-up call, for
    the allocator, cuDNN's algorithm choice and the kernels' first-use
    build) and return {result, trace_files}. The capture covers ``iters``
    calls so steady-state behavior dominates over first-call noise, and
    ends in ``torch.cuda.synchronize`` so every launch lands in it."""
    result = fn(*args, **kwargs)  # warm-up outside the trace
    _synchronize()
    with step_trace(logdir):
        for _ in range(iters):
            result = fn(*args, **kwargs)
        _synchronize()
    traces = sorted(glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"), recursive=True))
    return {"result": result, "trace_files": traces}


def step_breakdown(clock: StepClock, timed_steps: int = 1) -> Dict[str, float]:
    """``clock.summary()`` as the per-step dict bench rows carry
    (``bench.py`` ``_step_breakdown``): one clock step is ``timed_steps``
    training steps; compile stays a one-time total."""
    s = clock.summary()
    return {
        "compile_s": round(s.get("compile_s", 0.0), 3),
        "data_wait_s_per_step": round(s.get("data_wait", 0.0) / timed_steps, 6),
        "device_compute_s_per_step": round(s.get("compute", 0.0) / timed_steps, 6),
        "fetch_s_per_step": round(s.get("fetch", 0.0) / timed_steps, 6),
        "host_other_s_per_step": round(s.get("other", 0.0) / timed_steps, 6),
    }
