"""The port's StepClock against kubeflow_tpu/tpu/profiling.py's.

Both clocks are driven through the same scripted phases under one fake
clock that replaces ``time.perf_counter`` and ``time.time_ns`` (both modules
call them through ``time``), with a metrics namespace and a tracer of their
own package each. Everything they record must be equal: ``summary()``,
``steps``, ``to_chrome_trace()`` apart from ``pid``, the emitted step spans
and the metric values. The script covers first-use work charged to
``compile`` (before the first step and inside one), ``mark``, ``note``,
the ``keep_steps`` ring and the tracer span. No tolerance: the same floats
go through the same arithmetic.
"""

import time

import pytest
import torch

from kubeflow_tpu.runtime.metrics import MetricsRegistry as JMetrics
from kubeflow_tpu.runtime.tracing import Tracer as JTracer
from kubeflow_tpu.tpu import profiling as jprof
from kubeflow_tpu_torch.gpu import profiling as tprof
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as TMetrics
from kubeflow_tpu_torch.runtime.tracing import Tracer as TTracer


class FakeTime:
    def __init__(self) -> None:
        self.t = 1000.0

    def advance(self, dt: float) -> None:
        self.t += dt

    def perf_counter(self) -> float:
        return self.t

    def time_ns(self) -> int:
        return int(round(self.t * 1e9)) + 1_700_000_000_000_000_000


def _drive(mod, registry, tracer, clock_time: FakeTime):
    clock = mod.StepClock(metrics=registry.namespace("train"), tracer=tracer,
                          keep_steps=3)
    with clock.compile():
        clock_time.advance(2.5)
    for i in range(5):
        with clock.data_wait():
            clock_time.advance(0.001 * (i + 1))
        with clock.compute():
            clock_time.advance(0.02 + 0.003 * i)
        if i == 2:
            with clock.compile():  # a rebuild inside a step
                clock_time.advance(0.7)
        with clock.fetch():
            clock_time.advance(0.005)
        clock_time.advance(0.0007)  # untimed host work: "other"
        clock.note("bubble_fraction", 0.1 * i)
        if i == 3:
            clock_time.advance(0.4)
            clock.mark()  # logging between steps, not charged
        clock.end_step()
    return clock


@pytest.fixture()
def both(monkeypatch):
    fake = FakeTime()
    monkeypatch.setattr(time, "perf_counter", fake.perf_counter)
    monkeypatch.setattr(time, "time_ns", fake.time_ns)
    regs, tracers = (JMetrics(), TMetrics()), (JTracer(service="s"), TTracer(service="s"))
    jclock = _drive(jprof, regs[0], tracers[0], fake)
    fake.t = 1000.0
    tclock = _drive(tprof, regs[1], tracers[1], fake)
    return (jclock, tclock), regs, tracers


def test_summary_and_steps_equal(both):
    (j, t), _, _ = both
    assert t.summary() == j.summary()
    assert t.steps == j.steps
    assert t.compile_s == j.compile_s == pytest.approx(3.2)
    assert len(t.steps) == 5 and t.notes == {"bubble_fraction": pytest.approx(0.4)}


def test_chrome_trace_equal_apart_from_pid(both):
    (j, t), _, _ = both
    for steps in (None, 2):
        jt, tt = j.to_chrome_trace(steps=steps), t.to_chrome_trace(steps=steps)
        strip = lambda doc: [{k: v for k, v in e.items() if k != "pid"}  # noqa: E731
                             for e in doc["traceEvents"]]
        assert strip(tt) == strip(jt)
        assert tt["displayTimeUnit"] == jt["displayTimeUnit"]
    # the ring keeps the last 3 of 5 steps
    assert {e["args"]["step"] for e in t.to_chrome_trace()["traceEvents"]} == {3, 4, 5}


def test_step_spans_equal(both):
    _, _, (jt, tt) = both
    js, ts = jt.finished_spans("train.step"), tt.finished_spans("train.step")
    assert len(ts) == len(js) == 5
    for a, b in zip(js, ts):
        assert (b.start_ns, b.end_ns, b.attributes, b.events) == (
            a.start_ns, a.end_ns, a.attributes, a.events)


def test_metric_values_equal(both):
    _, (jm, tm), _ = both
    for name, labels in [("train_compile_seconds", {}), ("train_bubble_fraction", {})] + [
            ("train_step_phase_seconds", {"phase": p})
            for p in ("data_wait", "compute", "fetch", "total", "other")]:
        assert tm.value(name, **labels) == jm.value(name, **labels), name
    for phase in ("data_wait", "compute", "fetch"):
        jh = jm.histogram(f"train_step_{phase}_seconds")
        th = tm.histogram(f"train_step_{phase}_seconds")
        assert (th.sum, th.total, th.counts) == (jh.sum, jh.total, jh.counts)


def test_step_breakdown_is_the_bench_shape(both):
    (_, t), _, _ = both
    out = tprof.step_breakdown(t, timed_steps=1)
    s = t.summary()
    assert out == {"compile_s": round(s["compile_s"], 3),
                   "data_wait_s_per_step": round(s["data_wait"], 6),
                   "device_compute_s_per_step": round(s["compute"], 6),
                   "fetch_s_per_step": round(s["fetch"], 6),
                   "host_other_s_per_step": round(s["other"], 6)}


def test_profile_step_writes_a_chrome_trace(tmp_path):
    x = torch.arange(16.0)
    out = tprof.profile_step(lambda t: (t * 2).sum(), x, logdir=str(tmp_path), iters=2)
    assert float(out["result"]) == 240.0
    assert out["trace_files"] and all(f.endswith(".pt.trace.json") for f in out["trace_files"])
    with tprof.step_trace(str(tmp_path / "again"), name="window"):
        with tprof.annotate("inner"):
            (x + 1).sum()
    assert list((tmp_path / "again").glob("window.*.pt.trace.json"))
