"""Step telemetry and torch.profiler integration.

The port of ``kubeflow_tpu/tpu/profiling.py``: :class:`StepClock` is a
faithful copy (its metrics and tracer are the port's
``runtime.metrics``/``runtime.tracing``), :func:`step_trace`,
:func:`annotate` and :func:`profile_step` go through ``torch.profiler`` in
place of ``jax.profiler`` and write Chrome traces (``*.pt.trace.json``) that
Perfetto and chrome://tracing open. :func:`step_breakdown` is ``bench.py``'s
``_step_breakdown``: the per-step dict a training run reports.

:func:`register_profile_clock` publishes a loop's clock at ``GET
/debug/profile`` on every app that mounts the port's observability routes
(``runtime/obs.py``), as JAX's does. :func:`start_profile_server` keeps
JAX's contract (one server a process, idempotent on its port), but torch
has no profiler server for TensorBoard to capture from: the port's server
is the process's observability app, so ``<pod-dns>:9999`` answers
``/debug/profile``, ``/metrics`` and ``/debug/*``. Device traces come from
:func:`step_trace` and :func:`profile_step`.
"""

from __future__ import annotations

import collections
import glob
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

PROFILE_PORT = 9999

_server_lock = threading.Lock()
#: (port asked for, port bound) of the process's server; None before it starts
_server_ports: Optional[tuple] = None
_server: Optional[Any] = None


def start_profile_server(port: int = PROFILE_PORT, host: str = "0.0.0.0") -> int:
    """Start the process's profile server (idempotent) and return its port.
    It serves the observability routes (``/debug/profile`` among them, see
    :func:`register_profile_clock`) on ``port``; ``port=0`` binds a free
    port. A second call with the port asked for, or the one bound, returns
    it; any other port raises: one server a process, as JAX's."""
    global _server_ports, _server
    with _server_lock:
        if _server_ports is not None:
            if port not in _server_ports:
                raise RuntimeError(
                    f"profiler server already on port {_server_ports[1]}; "
                    f"cannot also serve {port} (one server per process)")
            return _server_ports[1]
        from ..runtime.obs import mount_observability  # lazy: HTTP only when asked
        from ..web.http import App

        _server = mount_observability(App("profile-server")).serve(port, host=host)
        _server_ports = (port, _server.port)
        return _server.port


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
            with clock.compute():
                loss = train_step(model, opt, batch)
                torch.cuda.synchronize()            # the device's work
            with clock.fetch():   value = float(loss)   # D2H read
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
    chrome://tracing load), and :func:`register_profile_clock` publishes
    it at ``GET /debug/profile``.

    In eager PyTorch the host runs ahead of the card, so a loop ends
    ``compute`` at a device synchronize (``bench.py``'s
    ``block_until_ready``): the step's device time is then ``compute``'s,
    and ``fetch`` is the host read alone (the port's training loops do).
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
        #: the ring is appended by the loop's thread and read by HTTP's
        self._records_lock = threading.Lock()

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
        """The step's work: its dispatch and, up to the synchronize that
        ends the phase, its device execution."""
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
        with self._records_lock:
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
        with self._records_lock:
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


# -- /debug/profile: on-demand step capture over HTTP -------------------------
#
# A training or bench loop registers its StepClock once; every server that
# mounts observability (the profile server, a ModelServer) then serves the
# loop's live timeline as Perfetto-loadable Chrome-trace JSON.

#: registered clocks by name; the last registration of a name wins
_PROFILE_CLOCKS: Dict[str, StepClock] = {}


def register_profile_clock(clock: StepClock, name: str = "train") -> StepClock:
    """Publish ``clock`` at ``GET /debug/profile`` (query: ``?steps=N`` the
    last N steps, default 16; ``?clock=<name>`` one clock; ``?timeout=S``
    wait up to S seconds for N *fresh* steps, the on-demand capture).
    Returns the clock, so call sites can register at construction."""
    from ..runtime import obs  # lazy: profiling must not drag HTTP in

    _PROFILE_CLOCKS[name] = clock
    obs.register_debug_source("profile", _profile_debug_source)
    return clock


def _profile_debug_source(req: Any) -> Dict[str, Any]:
    from ..web.http import HttpError

    try:
        steps = int(req.query1("steps", "16"))
        timeout = float(req.query1("timeout", "0"))
    except ValueError:
        raise HttpError(400, "steps/timeout must be numeric") from None
    name = req.query1("clock") or None
    if name is not None and name not in _PROFILE_CLOCKS:
        raise HttpError(
            404, f"unknown clock {name!r}; registered: {sorted(_PROFILE_CLOCKS)}")
    selected = {name: _PROFILE_CLOCKS[name]} if name else dict(_PROFILE_CLOCKS)
    if timeout > 0:
        # capture-on-demand: wait for `steps` steps recorded AFTER the
        # request, so the trace answers "what is the loop doing right now"
        deadline = time.monotonic() + timeout
        baselines = {n: len(c.steps) for n, c in selected.items()}
        while time.monotonic() < deadline:
            if all(len(c.steps) >= baselines[n] + steps
                   for n, c in selected.items()):
                break
            time.sleep(0.02)
    events: List[Dict[str, Any]] = []
    for tid, (_n, clock) in enumerate(sorted(selected.items()), start=1):
        events.extend(clock.to_chrome_trace(steps=steps, tid=tid)["traceEvents"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}
