"""kubeflow_tpu_torch/monitoring/stragglers.py against kubeflow_tpu/monitoring/stragglers.py.

One scripted ``latest`` source (JAX's duck type: ``latest(name)`` gives
``(labels, ts, value)`` rows) feeds JAX's and the port's
``StragglerDetector``, each with a registry of its own, tick for tick: the
hang verdicts (the stack dump's thread names aside: each detector captures
its own), the snapshots and the ``training_*`` series are equal — skew
k-of-n, transient skew, a single-worker gang never flagged, restart and
counter-reset awareness, hangs. Remediation runs against the JAX
package's in-process apiserver client; ``RegistrySource`` reads the
port's own registry, fed by real beacons. A hang verdict attaches to the
trace of the pod's bind-traceparent annotation as JAX's does, each
detector on its own package's store.
"""

from __future__ import annotations

import pytest

from kubeflow_tpu.api.meta import new_object
from kubeflow_tpu.controllers.builtin import make_tpu_node
from kubeflow_tpu.monitoring.stragglers import StragglerDetector as JDetector
from kubeflow_tpu.runtime.metrics import MetricsRegistry as JRegistry
from kubeflow_tpu_torch.monitoring.stragglers import RegistrySource, StragglerDetector
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as TRegistry
from kubeflow_tpu_torch.scheduler.gang import (DRAIN_DEADLINE_ANNOTATION, POD_GROUP_LABEL,
                                               POD_GROUP_SIZE_ANNOTATION as POD_GROUP_SIZE,
                                               QUARANTINE_ANNOTATION, annotations_of,
                                               is_quarantined)
from kubeflow_tpu_torch.training.heartbeat import WorkerBeacon, clear_beacons


class Source:
    """The newest sample per (name, worker), as a scrape would land it."""

    def __init__(self):
        self.rows = {}

    def latest(self, name):
        return [({"worker": w}, ts, v) for (n, w), (ts, v) in sorted(self.rows.items())
                if n == name]

    def feed(self, worker, ts, *, wall, step, incarnation=0):
        for name, value in (("training_worker_step_wall_seconds", wall),
                            ("training_worker_step_index", float(step)),
                            ("training_worker_incarnation", float(incarnation)),
                            ("training_worker_last_step_timestamp_seconds", ts)):
            self.rows[(name, worker)] = (ts, value)


def _skew_k_of_n(src, tick):
    for i in range(3):
        now = 10.0 + i
        src.feed("w0", now, wall=0.1, step=i)
        src.feed("w1", now, wall=0.1, step=i)
        src.feed("w2", now, wall=0.9, step=i)  # 9x the median
        tick(now)


def _transient(src, tick):
    for i in range(6):
        now = 10.0 + i
        src.feed("w0", now, wall=0.1, step=i)
        src.feed("w1", now, wall=0.1, step=i)
        src.feed("w2", now, wall=0.9 if i < 2 else 0.1, step=i)
        tick(now)


def _solo(src, tick):
    for i in range(10):
        src.feed("solo", 10.0 + i, wall=5.0, step=i)
        tick(10.0 + i)


def _counter_reset(src, tick):
    for i in range(2):  # two skewed windows, one short of k
        now = 10.0 + i
        src.feed("w0", now, wall=0.1, step=i)
        src.feed("w1", now, wall=0.9, step=i)
        src.feed("w2", now, wall=0.1, step=i)
        tick(now)
    src.feed("w0", 20.0, wall=0.1, step=5)
    src.feed("w1", 20.0, wall=0.9, step=0, incarnation=1)
    src.feed("w2", 20.0, wall=0.1, step=5)
    tick(20.0)
    src.feed("w1", 21.0, wall=0.9, step=1, incarnation=1)
    tick(21.0)


def _hang(src, tick):
    src.feed("w0", 10.0, wall=0.1, step=3)
    src.feed("w1", 10.0, wall=0.1, step=3)
    tick(10.0)
    src.feed("w1", 14.0, wall=0.1, step=4)
    tick(14.0)
    tick(16.0)  # w0: 6 s of silence past a 5 s deadline
    tick(30.0)  # w0 latched (no second verdict); w1 silent since 14 s


def _restart(src, tick):
    src.feed("w0", 10.0, wall=0.1, step=7)
    tick(10.0)
    src.feed("w0", 30.0, wall=0.1, step=0, incarnation=1)  # past the deadline
    tick(30.0)
    tick(33.0)
    tick(36.5)  # a fresh deadline elapsed after the restart


def _counter_reset_alone(src, tick):
    src.feed("w0", 10.0, wall=0.1, step=9)
    tick(10.0)
    src.feed("w0", 30.0, wall=0.1, step=0)  # incarnation still 0
    tick(30.0)


def _never_progressed(src, tick):
    src.feed("w0", 10.0, wall=0.0, step=-1)
    tick(10.0)
    tick(100.0)


SCENARIOS = {"skew_k_of_n": _skew_k_of_n, "transient": _transient, "solo": _solo,
             "counter_reset": _counter_reset, "hang": _hang, "restart": _restart,
             "counter_reset_alone": _counter_reset_alone,
             "never_progressed": _never_progressed}


def _strip(verdict):
    v = dict(verdict)
    assert v.pop("stackThreads"), "no stack dump in the verdict"
    return v


def _series(registry):
    return sorted(ln for ln in registry.render().splitlines() if ln.startswith("training_"))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verdicts_equal_jax(name):
    src = Source()
    jreg, treg = JRegistry(), TRegistry()
    jdet = JDetector(src, registry=jreg, skew_factor=2.0, k=3, n=5, hang_deadline_s=5.0)
    tdet = StragglerDetector(src, registry=treg, skew_factor=2.0, k=3, n=5,
                             hang_deadline_s=5.0)
    verdicts = []

    def tick(now):
        want, got = jdet.tick(now), tdet.tick(now)
        assert [_strip(v) for v in got] == [_strip(v) for v in want], now
        verdicts.extend(got)

    SCENARIOS[name](src, tick)
    snap, want = tdet.snapshot(), jdet.snapshot()
    if want["lastHangVerdict"] is not None:
        assert _strip(snap.pop("lastHangVerdict")) == _strip(want.pop("lastHangVerdict"))
    assert snap == want
    assert _series(treg) == _series(jreg)
    flagged = {w for w, s in snap["workers"].items() if s["flagged"]}
    expect = {"skew_k_of_n": ({"w2"}, 0), "hang": (set(), 2), "restart": (set(), 1)}
    assert (flagged, len(verdicts)) == expect.get(name, (set(), 0))


def _gang_pod(name, gang, node, size=2):
    return new_object("v1", "Pod", name, "default", labels={POD_GROUP_LABEL: gang},
                      annotations={"scheduling.kubeflow.org/pod-group-size": str(size)},
                      spec={"nodeName": node}, status={"phase": "Running"})


def test_hang_quarantines_node_and_drains_gang(client):
    """Against JAX's in-process apiserver: the hung worker's node is
    quarantined once (a second detector reads the annotation and never
    re-patches), the whole gang gets drain deadlines, and the events are
    JAX's."""
    client.create(make_tpu_node("node-a", "v5e", "2x2", 4))
    client.create(_gang_pod("w0", "g1", "node-a"))
    client.create(_gang_pod("w1", "g1", "node-a"))
    src = Source()
    src.feed("w0", 10.0, wall=0.1, step=3)
    det = StragglerDetector(src, client=client, registry=TRegistry(), hang_deadline_s=2.0)
    det.tick(10.0)
    verdicts = det.tick(17.0)
    assert verdicts and verdicts[0]["node"] == "node-a" and verdicts[0]["gang"] == "g1"
    node = client.get_opt("v1", "Node", "node-a", None)
    assert is_quarantined(node) and "w0" in annotations_of(node)[QUARANTINE_ANNOTATION]
    for name in ("w0", "w1"):
        assert DRAIN_DEADLINE_ANNOTATION in annotations_of(
            client.get_opt("v1", "Pod", name, "default"))
    stamped = annotations_of(node)[QUARANTINE_ANNOTATION]
    det2 = StragglerDetector(src, client=client, registry=TRegistry(), hang_deadline_s=2.0)
    det2.tick(10.0)
    assert det2.tick(17.0)
    assert annotations_of(client.get_opt("v1", "Node", "node-a", None))[
        QUARANTINE_ANNOTATION] == stamped
    assert det2.snapshot()["quarantined"] == ["node-a"]
    reasons = {e["reason"] for e in client.list("v1", "Event", "default")}
    assert {"WorkerHung", "NodeQuarantined"} <= reasons


def test_registry_source_reads_real_beacons():
    """The port's detector on its own registry: three beacons publish, one
    at 9x the others, and is flagged within k of n ticks."""
    clear_beacons()
    reg = TRegistry()
    det = StragglerDetector(RegistrySource(reg), registry=reg, skew_factor=2.0, k=3, n=5)
    beacons = {w: WorkerBeacon(w, registry=reg) for w in ("a", "b", "c")}
    for step in range(3):
        for w, b in beacons.items():
            b.publish({"total": 0.9 if w == "c" else 0.1}, step)
        det.tick()
    snap = det.snapshot()
    assert snap["workers"]["c"]["flagged"] and not snap["workers"]["a"]["flagged"]
    assert reg.value("training_stragglers_flagged_total", worker="c") == 1
    rows = RegistrySource(reg).latest("training_worker_step_index")
    assert sorted((labels["worker"], v) for labels, _ts, v in rows) == [
        ("a", 2.0), ("b", 2.0), ("c", 2.0)]
    clear_beacons()


class _Verdicts:
    """A trace collector's ``attach_verdict``, recorded."""

    def __init__(self):
        self.attached = []

    def attach_verdict(self, trace_id, verdict):
        self.attached.append((trace_id, _strip(verdict)))


TRACEPARENTS = {
    "bound": "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "malformed": "00-not-a-trace-01",
    "unstamped": None,
    "no_collector": "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
}


@pytest.mark.parametrize("case", sorted(TRACEPARENTS))
def test_attach_trace_verdict_equals_jax(case):
    """A hang verdict rides the trace named by the hung pod's
    bind-traceparent annotation, on JAX's detector over JAX's store and
    the port's over the port's: the same trace id and verdict, and nothing
    when the annotation is absent or malformed or no collector is given."""
    from kubeflow_tpu.apiserver.client import Client as JClient
    from kubeflow_tpu.apiserver.store import Store as JStore
    from kubeflow_tpu.runtime.tracing import BIND_TRACEPARENT_ANNOTATION as J_BIND
    from kubeflow_tpu_torch.api.meta import new_object as t_new_object
    from kubeflow_tpu_torch.apiserver.client import Client as TClient
    from kubeflow_tpu_torch.apiserver.store import Store as TStore
    from kubeflow_tpu_torch.runtime.tracing import BIND_TRACEPARENT_ANNOTATION

    assert J_BIND == BIND_TRACEPARENT_ANNOTATION
    runs = []
    for make_object, client, detector, registry in (
            (new_object, JClient(JStore()), JDetector, JRegistry()),
            (t_new_object, TClient(TStore()), StragglerDetector, TRegistry())):
        annotations = {POD_GROUP_SIZE: "1"}
        if TRACEPARENTS[case] is not None:
            annotations[BIND_TRACEPARENT_ANNOTATION] = TRACEPARENTS[case]
        client.create(make_object("v1", "Pod", "w0", "default", labels={POD_GROUP_LABEL: "g"},
                                  annotations=annotations, spec={"nodeName": "node-a"},
                                  status={"phase": "Running"}))
        traces = None if case == "no_collector" else _Verdicts()
        det = detector(Source(), client=client, registry=registry, hang_deadline_s=2.0,
                       traces=traces)
        det.tsdb.feed("w0", 10.0, wall=0.1, step=3)
        det.tick(10.0)
        verdicts = det.tick(17.0)
        assert len(verdicts) == 1 and verdicts[0]["gang"] == "g"
        runs.append(None if traces is None else traces.attached)
    assert runs[1] == runs[0]
    want = {"bound": 1, "malformed": 0, "unstamped": 0}
    if case == "no_collector":
        assert runs[1] is None
    else:
        assert len(runs[1]) == want[case]
        if runs[1]:
            assert runs[1][0][0] == "4bf92f3577b34da6a3ce929d0e0e4736"
            assert runs[1][0][1]["kind"] == "hang" and runs[1][0][1]["worker"] == "w0"
