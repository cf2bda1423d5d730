"""kubeflow_tpu_torch/runtime/chaos.py against kubeflow_tpu/runtime/chaos.py.

- ``ChaosSchedule.seeded`` gives JAX's faults for several seeds and specs
  over the serving and the control-plane kinds (the elastic driver's
  benign schedule among them).
- ``Fault`` refuses every kind the port does not carry, each of which
  JAX's accepts.
- Each control-plane injector (``kill_node``, ``preempt_gang`` with its
  ack-then-evict thread, ``drop_informer_watch``, ``delay_apiserver``),
  fired by JAX's ``ChaosMonkey`` on JAX's ``Store`` and the port's on the
  port's from the same objects, leaves the same Pods, Nodes, annotations
  and Events, fires the same faults and counts the same; a fault whose
  dependency is absent is skipped by both.
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
from types import SimpleNamespace

import pytest

import kubeflow_tpu.api.meta as j_meta
import kubeflow_tpu.apiserver.client as j_client
import kubeflow_tpu.apiserver.store as j_store
import kubeflow_tpu.runtime.informer as j_informer
import kubeflow_tpu.scheduler.gang as j_gang
import kubeflow_tpu_torch.api.meta as t_meta
import kubeflow_tpu_torch.apiserver.client as t_client
import kubeflow_tpu_torch.apiserver.store as t_store
import kubeflow_tpu_torch.runtime.informer as t_informer
import kubeflow_tpu_torch.scheduler.gang as t_gang
from kubeflow_tpu.runtime import chaos as jchaos
from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu_torch.runtime import chaos
from kubeflow_tpu_torch.runtime.metrics import METRICS

SERVING = ("slow_replica", "crash_replica_mid_decode", "client_abandon")
CONTROL = ("kill_node", "preempt_gang", "drop_informer_watch", "delay_apiserver")

PLANES = {
    "jax": SimpleNamespace(chaos=jchaos, metrics=JMETRICS, meta=j_meta, gang=j_gang,
                           store=j_store.Store, client=j_client.Client,
                           informer=j_informer.SharedInformer),
    "torch": SimpleNamespace(chaos=chaos, metrics=METRICS, meta=t_meta, gang=t_gang,
                             store=t_store.Store, client=t_client.Client,
                             informer=t_informer.SharedInformer),
}


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
    # the elastic driver's benign schedule
    (20260805, 4, 20.0, {"drop_informer_watch": ["Pod"], "delay_apiserver": [""]},
     {"delay_apiserver": 0.2}),
    (7, 6, 30.0, {"kill_node": ["n0", "n1"], "preempt_gang": ["default/g"]},
     {"preempt_gang": 2.0}),
    (99, 16, 5.0, {k: ["t-0", "t-1"] for k in CONTROL + SERVING}, {"delay_apiserver": 0.5}),
])
def test_seeded_schedule_equals_jax(seed, n, duration, targets, param):
    want = jchaos.ChaosSchedule.seeded(seed, n, duration, targets, param)
    got = chaos.ChaosSchedule.seeded(seed, n, duration, targets, param)
    assert [dataclasses.astuple(f) for f in got.faults] == \
        [dataclasses.astuple(f) for f in want.faults]
    assert [f.at for f in got.faults] == sorted(f.at for f in got.faults)


def test_fault_refuses_the_kinds_not_ported():
    ported = set(SERVING) | set(CONTROL)
    assert set(chaos.KINDS) == ported and ported < set(jchaos.KINDS)
    assert set(jchaos.KINDS) - ported == {"flood_apiserver", "kill9_apiserver",
                                          "kill9_scheduler", "slow_worker", "wedge_worker"}
    for kind in set(jchaos.KINDS) - ported:
        jchaos.Fault(at=0.0, kind=kind)  # JAX's carries it
        with pytest.raises(ValueError, match="unknown fault kind"):
            chaos.Fault(at=0.0, kind=kind)
    with pytest.raises(ValueError):
        chaos.ChaosSchedule.seeded(0, 3, 1.0, {"flood_apiserver": ["bulk:a"]})
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
                      lambda m, f: m.ChaosMonkey(None, m.ChaosSchedule([]), fleet=f))
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
            (chaos, METRICS, chaos.ChaosMonkey(None, chaos.ChaosSchedule([])))):
        registry.reset()
        for kind in SERVING:
            monkey.inject(mod.Fault(at=0.0, kind=kind))
        assert monkey.fired == [] and _counts(registry) == dict.fromkeys(SERVING, 0.0)
        monkey.stop()


def test_slow_replica_lifts_after_its_duration():
    fleet = StubFleet()
    monkey = chaos.ChaosMonkey(None, chaos.ChaosSchedule([]), fleet=fleet)
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
            (chaos, METRICS, lambda s, f: chaos.ChaosMonkey(None, s, fleet=f))):
        registry.reset()
        fleet = StubFleet(inflight=(1, 1, 1))
        monkey = make(mod.ChaosSchedule.seeded(3, 6, 0.2, targets, param), fleet).start()
        monkey.join(timeout=30)
        runs.append((_fired(monkey), _state(fleet), _counts(registry)))
        monkey.stop()
        assert all(h.engine.step_delay_s == 0.0 for h in fleet.handles)
    assert runs[1] == runs[0]
    assert len(runs[1][0]) >= 4  # an abandon with nothing left is skipped


# -- the control-plane kinds, on each package's own Store ----------------------


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _pod(p, name, node=None, gang=None):
    labels = {p.gang.POD_GROUP_LABEL: gang} if gang else {}
    annotations = {p.gang.POD_GROUP_SIZE_ANNOTATION: "2"} if gang else {}
    obj = p.meta.new_object("v1", "Pod", name, "default", labels=labels,
                            annotations=annotations, spec={"containers": [{"name": "c"}]})
    if node:
        obj["spec"]["nodeName"] = node
        obj["status"] = {"phase": "Running"}
    return obj


def _world(p, client):
    """Pods (node, phase, annotation keys), Nodes and Events of a store."""
    pods = {p.meta.name_of(o): ((o.get("spec") or {}).get("nodeName"),
                                (o.get("status") or {}).get("phase"),
                                sorted(p.meta.annotations_of(o)))
            for o in client.list("v1", "Pod")}
    nodes = sorted(p.meta.name_of(o) for o in client.list("v1", "Node"))
    events = sorted((e["involvedObject"]["name"], e["reason"], e["type"], e["count"],
                     (e.get("source") or {}).get("component"))
                    for e in client.list("v1", "Event", "default"))
    return {"pods": pods, "nodes": nodes, "events": events}


def _control_run(p, kind):
    """Fire ``kind`` (and a fault of its kind that cannot be injected) at a
    fresh store through each package's monkey; what the store and the
    counters hold at each stage."""
    p.metrics.reset()
    store = p.store()
    client = p.client(store)
    for n in ("n0", "n1"):
        client.create(p.meta.new_object("v1", "Node", n))
    for name, node, gang in (("g-0", "n0", "job"), ("g-1", "n1", "job"),
                             ("solo", "n0", None), ("idle", None, None)):
        client.create(_pod(p, name, node, gang))
    informers = []
    if kind == "drop_informer_watch":
        informers = [p.informer(client, "v1", "Pod").start()]
        assert informers[0].wait_synced(10)
    monkey = p.chaos.ChaosMonkey(client, p.chaos.ChaosSchedule([]), store=store,
                                 informers=informers)
    bare = p.chaos.ChaosMonkey(client, p.chaos.ChaosSchedule([]))
    out = {}
    try:
        if kind == "kill_node":
            monkey.inject(p.chaos.Fault(0.0, "kill_node", "n0"))
            bare.inject(p.chaos.Fault(0.0, "kill_node", "absent"))  # no such node: a no-op
        elif kind == "preempt_gang":
            monkey.inject(p.chaos.Fault(0.0, "preempt_gang", "default/job", param=10.0))
            out["stamped"] = _world(p, client)
            client.patch("v1", "Pod", "g-0", {"metadata": {"annotations": {
                p.gang.DRAIN_ACK_ANNOTATION: "3"}}}, "default")
            time.sleep(0.1)  # one pod acked: both stay
            out["one_ack"] = _world(p, client)
            client.patch("v1", "Pod", "g-1", {"metadata": {"annotations": {
                p.gang.DRAIN_ACK_ANNOTATION: "3"}}}, "default")
            assert _wait(lambda: client.get_opt("v1", "Pod", "g-1", "default") is None)
        elif kind == "drop_informer_watch":
            inf = informers[0]
            before = p.metrics.value("informer_watch_reconnects_total", kind="Pod")
            first = inf._watcher
            monkey.inject(p.chaos.Fault(0.0, "drop_informer_watch", "Pod"))
            monkey.inject(p.chaos.Fault(0.0, "drop_informer_watch", "Node"))  # none
            bare.inject(p.chaos.Fault(0.0, "drop_informer_watch", "Pod"))  # no informers
            assert _wait(lambda: inf._watcher is not first)
            client.create(_pod(p, "after", "n1"))
            assert _wait(lambda: inf.get("after", "default") is not None)
            out["reconnects"] = p.metrics.value("informer_watch_reconnects_total",
                                                kind="Pod") - before
            out["mirror"] = sorted(p.meta.name_of(o) for o in inf.list())
        elif kind == "delay_apiserver":
            monkey.inject(p.chaos.Fault(0.0, "delay_apiserver", param=0.4))
            bare.inject(p.chaos.Fault(0.0, "delay_apiserver", param=0.4))  # no store
            time.sleep(0.05)  # the holder thread takes the lock
            t0 = time.monotonic()
            client.create(_pod(p, "stalled", "n1"))
            out["stalled"] = time.monotonic() - t0 >= 0.25
        out["fired"] = [(f.kind, f.target, f.param) for f in monkey.fired + bare.fired]
        out["counts"] = {k: p.metrics.value("chaos_faults_injected_total", kind=k)
                         for k in CONTROL}
        out["world"] = _world(p, client)
    finally:
        monkey.stop()
        bare.stop()
        for inf in informers:
            inf.stop()
    return out


@pytest.mark.parametrize("kind", CONTROL)
def test_control_plane_kind_acts_as_jax(kind):
    want = _control_run(PLANES["jax"], kind)
    got = _control_run(PLANES["torch"], kind)
    assert got == want
    # a kill of an absent node deletes nothing and still fires, on both
    fired = 2 if kind == "kill_node" else 1
    assert got["counts"][kind] == fired and len(got["fired"]) == fired
    pods = got["world"]["pods"]
    if kind == "kill_node":
        assert got["world"]["nodes"] == ["n1"]
        assert pods["g-0"][1] == pods["solo"][1] == "Failed"
        assert pods["g-1"][1] == "Running" and pods["idle"][1] is None
    elif kind == "preempt_gang":
        stamped = got["stamped"]["pods"]
        deadline = t_gang.DRAIN_DEADLINE_ANNOTATION
        assert deadline in stamped["g-0"][2] and deadline in stamped["g-1"][2]
        assert deadline not in stamped["solo"][2]
        assert set(got["one_ack"]["pods"]) == {"g-0", "g-1", "solo", "idle"}
        assert sorted(pods) == ["idle", "solo"]
        assert [e[1:] for e in got["world"]["events"]] == [
            ("TrainingPreempted", "Warning", 1, chaos.COMPONENT)] * 2
    elif kind == "drop_informer_watch":
        assert got["reconnects"] >= 1 and "after" in got["mirror"]
    else:
        assert got["stalled"] is True and "stalled" in pods
