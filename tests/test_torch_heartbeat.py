"""kubeflow_tpu_torch/training/heartbeat.py against kubeflow_tpu/training/heartbeat.py.

The same step records, published by JAX's and the port's ``WorkerBeacon``
into registries of their own, give the same ``training_worker_*`` series
(the timestamp gauge aside: it is the wall clock at publish). The port's
beacon paces ``throttle`` by ``step_delay_s * slow_factor``, parks a
wedged worker in ``_wedge_wait`` (named by a stack dump) until released,
and shows every worker at ``/debug/beacon``.
"""

from __future__ import annotations

import threading
import time

import pytest

from kubeflow_tpu.runtime.metrics import MetricsRegistry as JRegistry
from kubeflow_tpu.training import heartbeat as jh
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as TRegistry
from kubeflow_tpu_torch.runtime.obs import capture_stacks, mount_observability
from kubeflow_tpu_torch.training import heartbeat as th
from kubeflow_tpu_torch.web.http import App, Request

RECORDS = [
    ({"total": 0.5, "data_wait": 0.1, "compute": 0.3, "fetch": 0.05}, None),
    ({"total": 0.7, "compute": 0.4, "collective_wait": 0.2, "other": 0.1}, None),
    ({"total": 0.25}, 7),  # a restore path: the step is given
    ({"total": 0.3, "compute": 0.2}, None),
]


@pytest.fixture(autouse=True)
def _clean():
    th.clear_beacons()
    jh.clear_beacons()
    yield
    th.clear_beacons()
    jh.clear_beacons()


def _series(registry):
    return sorted(ln for ln in registry.render().splitlines()
                  if ln.startswith("training_worker_")
                  and "last_step_timestamp" not in ln and "_bucket" not in ln)


def _publish(module, registry, expected=None):
    b = module.WorkerBeacon("w-0", registry=registry, expected_collective_s=expected)
    b.begin_incarnation(2)
    for rec, step in RECORDS:
        b.publish(rec, step)
    return b


@pytest.mark.parametrize("expected", [None, lambda: 0.125])
def test_same_records_same_series(expected):
    jreg, treg = JRegistry(), TRegistry()
    jb = _publish(jh, jreg, expected)
    tb = _publish(th, treg, expected)
    assert _series(treg) == _series(jreg)
    assert any("step_index" in ln for ln in _series(treg))
    assert treg.value("training_worker_step_index", worker="w-0") == 8.0
    assert treg.value("training_worker_incarnation", worker="w-0") == 2.0
    snap, want = tb.snapshot(), jb.snapshot()
    assert abs(snap.pop("lastStepAt") - want.pop("lastStepAt")) < 5.0
    assert snap == want
    hist = treg.histogram("training_worker_step_seconds", worker="w-0")
    assert hist.total == len(RECORDS)
    assert hist.counts == jreg.histogram("training_worker_step_seconds", worker="w-0").counts


def test_throttle_paces_by_the_slow_factor():
    b = th.WorkerBeacon("pace", registry=TRegistry(), step_delay_s=0.02)
    assert b.throttle() >= 0.02
    b.slow_factor = 5.0
    t0 = time.perf_counter()
    waited = b.throttle()
    assert waited >= 0.1 and time.perf_counter() - t0 >= 0.1
    b.slow_factor = 0.5  # never faster than the base pacing
    assert b.throttle() >= 0.02


def test_wedge_parks_in_wedge_wait_until_release():
    b = th.WorkerBeacon("wedged", registry=TRegistry())
    b.wedge()
    assert b.wedged and b.snapshot()["wedged"]
    done = threading.Event()
    waited = []

    def worker():
        waited.append(b.throttle())
        done.set()

    t = threading.Thread(target=worker, name="worker-7", daemon=True)
    t.start()
    time.sleep(0.2)
    assert not done.is_set()
    dump = capture_stacks(reason="hang:wedged")
    frames = [f["function"] for th_ in dump["threads"] if th_["threadName"] == "worker-7"
              for f in th_["frames"]]
    assert "_wedge_wait" in frames and "throttle" in frames, frames
    b.release()
    assert done.wait(5.0)
    t.join(5.0)
    assert waited[0] >= 0.2 and not b.wedged


def test_debug_beacon_lists_every_worker():
    reg = TRegistry()
    a = th.WorkerBeacon("a", registry=reg)
    th.WorkerBeacon("b", registry=reg).publish({"total": 0.1}, 3)
    a.slow_factor = 3.0
    again = th.WorkerBeacon("a", registry=reg)  # the last registration of an id wins
    assert set(th.beacons()) == {"a", "b"} and th.beacons()["a"] is again
    app = mount_observability(App("beacon"))
    resp = app.dispatch(Request(method="GET", path="/debug/beacon", query={}, headers={},
                                body=b""))
    assert resp.status == 200, resp.body
    workers = resp.body["workers"]
    assert workers["b"]["stepIndex"] == 3 and workers["b"]["lastStep"] == {"total": 0.1}
    assert workers["a"]["slowFactor"] == 1.0
    th.clear_beacons()
    assert th.beacons() == {}
