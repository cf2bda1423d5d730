"""kubeflow_tpu_torch/runtime/chaos.py against kubeflow_tpu/runtime/chaos.py.

- ``ChaosSchedule.seeded`` gives JAX's faults for several seeds and specs
  over the serving kinds.
- ``Fault`` refuses every kind the port does not carry, each of which
  JAX's accepts.
- Each serving injector, fired by JAX's ``ChaosMonkey`` and the port's at
  the same stub fleet (``live_handles()`` of stub engines), leaves the same
  ``step_delay_s``, ``fail_next_step`` and cancel counts, the same
  ``fired`` list and the same ``chaos_faults_injected_total``; a fault
  that cannot be injected is skipped by both.
- ``stop()`` resets slowed engines, a ``duration`` lifts the fault by
  itself, and ``start()`` fires a seeded schedule as JAX's does.
"""

import dataclasses
import time

import pytest

from kubeflow_tpu.runtime import chaos as jchaos
from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu_torch.runtime import chaos
from kubeflow_tpu_torch.runtime.metrics import METRICS

SERVING = ("slow_replica", "crash_replica_mid_decode", "client_abandon")


class StubEngine:
    """The engine hooks the serving kinds set, with ``inflight`` requests
    to cancel."""

    def __init__(self, inflight: int) -> None:
        self.step_delay_s = 0.0
        self.fail_next_step = False
        self.inflight = inflight
        self.cancelled = 0

    def cancel_requests(self, n: int = 1) -> int:
        k = max(0, min(n, self.inflight))
        self.inflight -= k
        self.cancelled += k
        return k


@dataclasses.dataclass
class StubHandle:
    id: str
    gauge_id: str
    engine: StubEngine


class StubFleet:
    def __init__(self, inflight=(2, 0, 3)) -> None:
        self.handles = [StubHandle(str(i), f"f-{i}", StubEngine(n))
                        for i, n in enumerate(inflight)]

    def live_handles(self):
        return list(self.handles)


def _state(fleet):
    return [(h.engine.step_delay_s, h.engine.fail_next_step, h.engine.inflight,
             h.engine.cancelled) for h in fleet.handles]


def _fired(monkey):
    return [dataclasses.astuple(f) for f in monkey.fired]


def _counts(registry):
    return {k: registry.value("chaos_faults_injected_total", kind=k) for k in SERVING}


@pytest.mark.parametrize("seed,n,duration,targets,param", [
    (0, 5, 10.0, {"slow_replica": ["f-0", "f-1"]}, {"slow_replica": 0.5}),
    (7, 12, 3.0, {"slow_replica": ["a"], "client_abandon": [], "crash_replica_mid_decode":
                  ["a", "b", "c"]}, {"client_abandon": 2.0}),
    (42, 20, 60.0, {k: ["r-0", "r-1", "r-2"] for k in SERVING}, None),
    (123456, 1, 0.0, {"client_abandon": ["x"]}, {"client_abandon": 4.0}),
])
def test_seeded_schedule_equals_jax(seed, n, duration, targets, param):
    want = jchaos.ChaosSchedule.seeded(seed, n, duration, targets, param)
    got = chaos.ChaosSchedule.seeded(seed, n, duration, targets, param)
    assert [dataclasses.astuple(f) for f in got.faults] == \
        [dataclasses.astuple(f) for f in want.faults]
    assert [f.at for f in got.faults] == sorted(f.at for f in got.faults)


def test_fault_refuses_the_kinds_not_ported():
    assert set(chaos.KINDS) == set(SERVING) and set(SERVING) < set(jchaos.KINDS)
    for kind in set(jchaos.KINDS) - set(SERVING):
        jchaos.Fault(at=0.0, kind=kind)  # JAX's carries it
        with pytest.raises(ValueError, match="unknown fault kind"):
            chaos.Fault(at=0.0, kind=kind)
    with pytest.raises(ValueError):
        chaos.ChaosSchedule.seeded(0, 3, 1.0, {"kill_node": ["n-0"]})
    for mod in (jchaos, chaos):
        with pytest.raises(ValueError):
            mod.Fault(at=0.0, kind="no_such_kind")


#: (kind, target, param): fired in order; some cannot be injected
SCRIPT = [
    ("slow_replica", "f-1", 0.75),
    ("slow_replica", "1", -3.0),             # by replica id; the delay clamps at 0
    ("slow_replica", "f-9", 1.0),            # no such replica: skipped
    ("client_abandon", "f-2", 4.0),          # f-2's 3, then f-0's 1
    ("client_abandon", None, 0.0),           # param 0 means 1: f-0's last
    ("client_abandon", "f-1", 2.0),          # nothing left in flight: skipped
    ("crash_replica_mid_decode", None, 0.0),  # the first live replica
    ("crash_replica_mid_decode", "f-2", 0.0),
    ("slow_replica", None, 0.25),
]


def _run_script(mod, registry, make_monkey):
    registry.reset()
    fleet = StubFleet()
    monkey = make_monkey(mod, fleet)
    trace = []
    for kind, target, param in SCRIPT:
        monkey.inject(mod.Fault(at=0.0, kind=kind, target=target, param=param))
        trace.append(_state(fleet))
    out = {"trace": trace, "fired": _fired(monkey), "counts": _counts(registry)}
    monkey.stop()
    out["after_stop"] = _state(fleet)
    return out


def test_injectors_act_as_jax():
    want = _run_script(jchaos, JMETRICS,
                       lambda m, f: m.ChaosMonkey(None, m.ChaosSchedule([]), fleet=f))
    got = _run_script(chaos, METRICS,
                      lambda m, f: m.ChaosMonkey(m.ChaosSchedule([]), fleet=f))
    assert got == want
    assert got["counts"] == {"slow_replica": 3.0, "crash_replica_mid_decode": 2.0,
                             "client_abandon": 2.0}
    assert len(got["fired"]) == len(SCRIPT) - 2
    # stop() reset every slowed engine; a crash flag stays set for the engine
    assert [s[0] for s in got["after_stop"]] == [0.0, 0.0, 0.0]
    assert [s[1] for s in got["after_stop"]] == [True, False, True]


def test_serving_kinds_without_a_fleet_are_skipped():
    for mod, registry, monkey in (
            (jchaos, JMETRICS, jchaos.ChaosMonkey(None, jchaos.ChaosSchedule([]))),
            (chaos, METRICS, chaos.ChaosMonkey(chaos.ChaosSchedule([])))):
        registry.reset()
        for kind in SERVING:
            monkey.inject(mod.Fault(at=0.0, kind=kind))
        assert monkey.fired == [] and _counts(registry) == dict.fromkeys(SERVING, 0.0)
        monkey.stop()


def test_slow_replica_lifts_after_its_duration():
    fleet = StubFleet()
    monkey = chaos.ChaosMonkey(chaos.ChaosSchedule([]), fleet=fleet)
    try:
        monkey.inject(chaos.Fault(at=0.0, kind="slow_replica", target="f-0", param=0.5,
                                  duration=0.05))
        assert fleet.handles[0].engine.step_delay_s == 0.5
        deadline = time.monotonic() + 10
        while fleet.handles[0].engine.step_delay_s and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.handles[0].engine.step_delay_s == 0.0
    finally:
        monkey.stop()


def test_start_fires_a_seeded_schedule_as_jax():
    targets = {"slow_replica": ["f-0", "f-1", "f-2"], "client_abandon": ["f-0", "f-2"]}
    param = {"slow_replica": 0.1, "client_abandon": 1.0}
    runs = []
    for mod, registry, make in (
            (jchaos, JMETRICS, lambda s, f: jchaos.ChaosMonkey(None, s, fleet=f)),
            (chaos, METRICS, lambda s, f: chaos.ChaosMonkey(s, fleet=f))):
        registry.reset()
        fleet = StubFleet(inflight=(1, 1, 1))
        monkey = make(mod.ChaosSchedule.seeded(3, 6, 0.2, targets, param), fleet).start()
        monkey.join(timeout=30)
        runs.append((_fired(monkey), _state(fleet), _counts(registry)))
        monkey.stop()
        assert all(h.engine.step_delay_s == 0.0 for h in fleet.handles)
    assert runs[1] == runs[0]
    assert len(runs[1][0]) >= 4  # an abandon with nothing left is skipped
