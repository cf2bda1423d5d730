"""The port's ``runtime/tracing.py`` open-span sweep against the JAX package's.

``Tracer``'s open-span map: ``start_span`` registers, ``end_span``
removes; ``sweep_abandoned`` force-closes spans past the TTL, and a start
past ``max_open_spans`` evicts the oldest, each recorded as ERROR with
JAX's message and counted by ``tracing_spans_abandoned_total``: the same
script gives the same statuses, messages and counts in both, at caps of
2, 3 and 5 open spans.
"""

from __future__ import annotations

import pytest

from kubeflow_tpu.runtime import tracing as jt
from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
from kubeflow_tpu_torch.runtime import tracing as tt
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


def _script(module, cap):
    tracer = module.Tracer(capacity=cap, open_span_ttl_s=600.0)
    a = tracer.start_span("a")
    b = tracer.start_span("b")
    tracer.end_span(b)
    open_after_end = sorted(s.name for s in tracer.open_spans())
    # `cap` more starts against a cap of `cap`: the oldest open one is evicted
    for i in range(cap):
        tracer.start_span(f"s{i}")
    evicted = [(s.name, s.status, s.status_message) for s in tracer.finished_spans()
               if s.status == "ERROR"]
    swept = tracer.sweep_abandoned(ttl_s=0.0)
    done = [(s.name, s.status, s.status_message) for s in tracer.finished_spans()]
    return {"open_after_end": open_after_end, "evicted": evicted, "swept": swept,
            "done": done, "open_after_sweep": tracer.open_spans(), "a_closed": a.end_ns > 0}


@pytest.mark.parametrize("cap", [2, 3, 5])
def test_abandoned_spans_swept_and_evicted_as_jax(cap):
    before = J_METRICS.total("tracing_spans_abandoned_total")
    want, got = _script(jt, cap), _script(tt, cap)
    assert got == want
    assert got["open_after_end"] == ["a"]
    assert got["evicted"] == [("a", "ERROR", f"evicted: >{cap} open spans")]
    assert got["swept"] == cap and got["open_after_sweep"] == [] and got["a_closed"]
    assert T_METRICS.total("tracing_spans_abandoned_total") == \
        J_METRICS.total("tracing_spans_abandoned_total") - before == cap + 1


def test_spans_ended_in_time_are_never_swept():
    tracer = tt.Tracer(open_span_ttl_s=600.0)
    with tracer.span("request"):
        inner = tracer.start_span("engine")
        tracer.end_span(inner)
    assert tracer.sweep_abandoned() == 0 and tracer.open_spans() == []
    assert [s.status for s in tracer.finished_spans()] == ["OK", "OK"]
    tracer.start_span("lost")
    tracer.reset()
    assert tracer.open_spans() == [] and tracer.finished_spans() == []
