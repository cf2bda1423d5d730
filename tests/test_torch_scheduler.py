"""The port's gang scheduler against the JAX package's, on the same gangs
and nodes.

The differential cases script ``tests/test_scheduler.py``'s scenarios (gang
all-or-nothing across nodes, a partial gang holding its reservation, two
gangs contending for one pair of nodes, priority preemption, equal
priority, quota admission, backoff, drain-grace preemption, the elastic
driver's organic drain of a trial gang by a notebook gang) cycle by cycle
through each package's ``SchedulerReconciler.reconcile`` over its own
in-process Store: nodes from the same ``(name, cards)`` tuples in each
package's own form (JAX ``make_tpu_node``'s ``google.com/tpu``, the port's
``make_gpu_node``'s ``nvidia.com/gpu``), pods asking for the same counts.
After every cycle both give the same requeue delay, the same placements
node by node, the same flight-recorder decision (verdicts, quota
arithmetic, preemption record) and the same aggregated Events. The
accelerator's name in a message ("TPU"/"GPU") is the only text that
differs; the Events' component is ``gpu-scheduler``.

Then ``tests/test_scheduler.py``'s Manager-driven cases run on the port,
and the tenant meter opens and closes intervals on bind and unbind.
"""

import re
import time
from types import SimpleNamespace

import pytest

import kubeflow_tpu.api.meta as j_meta
import kubeflow_tpu.apiserver.backend as j_backend
import kubeflow_tpu.apiserver.client as j_client
import kubeflow_tpu.apiserver.store as j_store
import kubeflow_tpu.controllers.builtin as j_builtin
import kubeflow_tpu.runtime.manager as j_manager
import kubeflow_tpu.scheduler.core as j_core
import kubeflow_tpu.scheduler.gang as j_gang
import kubeflow_tpu.tpu.topology as j_topology
import kubeflow_tpu_torch.api.meta as t_meta
import kubeflow_tpu_torch.apiserver.client as t_client
import kubeflow_tpu_torch.apiserver.store as t_store
import kubeflow_tpu_torch.controllers.builtin as t_builtin
import kubeflow_tpu_torch.gpu.topology as t_topology
import kubeflow_tpu_torch.runtime.manager as t_manager
import kubeflow_tpu_torch.scheduler.core as t_core
import kubeflow_tpu_torch.scheduler.gang as t_gang
from kubeflow_tpu_torch.monitoring.goodput import TENANT_METER
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.scheduler.ledger import ChipLedger

PKGS = {
    "jax": SimpleNamespace(
        meta=j_meta, core=j_core, gang=j_gang, manager=j_manager, builtin=j_builtin,
        resource=j_topology.RESOURCE_TPU, quota_key=j_gang.TPU_QUOTA_KEY,
        node=lambda name, cards: j_builtin.make_tpu_node(name, "v5e", "2x4", cards),
        client=lambda: j_client.Client(j_store.Store(backend=j_backend.DictBackend())),
        request=j_manager.Request),
    "torch": SimpleNamespace(
        meta=t_meta, core=t_core, gang=t_gang, manager=t_manager, builtin=t_builtin,
        resource=t_topology.RESOURCE_GPU, quota_key=t_gang.GPU_QUOTA_KEY,
        node=lambda name, cards: t_builtin.make_gpu_node(name, "h100", cards),
        client=lambda: t_client.Client(t_store.Store()),
        request=t_manager.Request),
}


def mkpod(pkg, name, ns="default", chips=0, gang=None, size=1, priority_class=None,
          selector=None, grace=None):
    spec = {"containers": [{"name": "c"}]}
    if chips:
        spec["containers"][0]["resources"] = {"limits": {pkg.resource: str(chips)}}
    if priority_class:
        spec["priorityClassName"] = priority_class
    if selector:
        spec["nodeSelector"] = selector
    labels = {pkg.gang.POD_GROUP_LABEL: gang} if gang else {}
    annotations = {pkg.gang.POD_GROUP_SIZE_ANNOTATION: str(size)} if gang else {}
    if grace is not None:
        annotations[pkg.gang.DRAIN_GRACE_ANNOTATION] = str(grace)
    return pkg.meta.new_object("v1", "Pod", name, ns, labels=labels,
                               annotations=annotations, spec=spec)


def _text(s):
    """The accelerator's name aside, and a drain's wall-clock deadline."""
    if not isinstance(s, str):
        return s
    return re.sub(r"deadline [0-9.]+", "deadline <t>", s.replace("TPU", "GPU"))


def _decision(d):
    if d is None:
        return None
    out = d.to_dict()
    out.pop("wallTime")
    out["message"] = _text(out["message"])
    if out.get("preemption") and out["preemption"].get("graceDeadline") is not None:
        out["preemption"]["graceDeadline"] = "<deadline>"
    drain = (out.get("preemption") or {}).get("draining")
    if drain:
        drain["graceDeadline"] = "<deadline>"
    return out


def run_scenario(pkg, steps, ns="default"):
    """Apply ``steps``; return one record a reconcile cycle."""
    client = pkg.client()
    sched = pkg.core.SchedulerReconciler(assembly_timeout=30.0, reservation_ttl=30.0,
                                         backoff_base=0.02, backoff_cap=0.5)
    log = []
    for step in steps:
        kind, *args = step
        if kind == "node":
            client.create(pkg.node(*args))
        elif kind == "pod":
            name, kw = args
            client.create(mkpod(pkg, name, ns=ns, **kw))
        elif kind == "quota":
            client.create(pkg.meta.new_object(
                "v1", "ResourceQuota", pkg.gang.QUOTA_NAME, ns,
                spec={"hard": {pkg.quota_key: str(args[0])}}))
        elif kind == "finish":
            pod = client.get("v1", "Pod", args[0], ns)
            pod["status"] = {"phase": "Succeeded"}
            client.update_status(pod)
        elif kind == "ack":
            client.patch("v1", "Pod", args[0], {"metadata": {"annotations": {
                pkg.gang.DRAIN_ACK_ANNOTATION: "7"}}}, ns)
        elif kind == "reconcile":
            result = sched.reconcile(client, pkg.request(ns, args[0]))
            pods = {p["metadata"]["name"]: (p.get("spec") or {}).get("nodeName")
                    for p in client.list("v1", "Pod", ns)}
            gang = pkg.gang.gang_of(client.get_opt("v1", "Pod", args[0], ns)
                                    or mkpod(pkg, args[0], ns=ns))
            events = sorted(
                (e["involvedObject"]["name"], e["reason"], e["type"], e["count"],
                 _text(e["message"]))
                for e in client.list("v1", "Event", ns))
            delay = result.requeue_after
            log.append({
                "reconcile": args[0],
                "requeue_after": "<drain>" if delay and delay not in (
                    0.02, 0.04, 0.08, 0.16, 0.32, 0.5, 1.0) else delay,
                "placement": pods,
                "decision": _decision(sched.flight.last_for(f"{ns}/{gang.name}")),
                "events": events,
                "backoff": sched.backoff.failures(gang.key),
            })
        else:
            raise ValueError(kind)
    components = {(e.get("source") or {}).get("component")
                  for e in client.list("v1", "Event", ns)}
    return log, components, sched


def nodes(*cards):
    return [("node", f"node-{i}", c) for i, c in enumerate(cards)]


SCENARIOS = {
    "gang_all_or_nothing": nodes(4, 4) + [
        ("pod", "slice-0", dict(chips=4, gang="slice", size=2)),
        ("pod", "slice-1", dict(chips=4, gang="slice", size=2)),
        ("reconcile", "slice-0"), ("reconcile", "slice-1"),
    ],
    "partial_gang_reserves": nodes(4, 4) + [
        ("pod", "big-0", dict(chips=4, gang="big", size=2)),
        ("reconcile", "big-0"),
        ("pod", "interloper", dict(chips=4)),
        ("reconcile", "interloper"), ("reconcile", "interloper"),
        ("pod", "big-1", dict(chips=4, gang="big", size=2)),
        ("reconcile", "big-1"),
        ("finish", "big-0"), ("reconcile", "interloper"),
    ],
    "two_gangs_one_pair": nodes(4, 4) + [
        ("pod", "alpha-0", dict(chips=4, gang="alpha", size=2)),
        ("pod", "alpha-1", dict(chips=4, gang="alpha", size=2)),
        ("pod", "beta-0", dict(chips=4, gang="beta", size=2)),
        ("pod", "beta-1", dict(chips=4, gang="beta", size=2)),
        ("reconcile", "alpha-0"), ("reconcile", "beta-0"), ("reconcile", "beta-1"),
        ("reconcile", "beta-0"),
        ("finish", "alpha-0"), ("finish", "alpha-1"), ("reconcile", "beta-0"),
    ],
    "preemption": nodes(4, 4) + [
        ("pod", "trial-0", dict(chips=4, gang="hpo", size=2, priority_class="trial")),
        ("pod", "trial-1", dict(chips=4, gang="hpo", size=2, priority_class="trial")),
        ("reconcile", "trial-0"),
        ("pod", "nb-0", dict(chips=4, gang="nb", size=2, priority_class="notebook")),
        ("pod", "nb-1", dict(chips=4, gang="nb", size=2, priority_class="notebook")),
        ("reconcile", "nb-0"), ("reconcile", "nb-0"),
    ],
    "equal_priority": nodes(4, 4) + [
        ("pod", "a-0", dict(chips=4, gang="a", size=2)),
        ("pod", "a-1", dict(chips=4, gang="a", size=2)),
        ("reconcile", "a-0"),
        ("pod", "b-0", dict(chips=4, gang="b", size=2)),
        ("pod", "b-1", dict(chips=4, gang="b", size=2)),
        ("reconcile", "b-0"), ("reconcile", "b-0"), ("reconcile", "b-1"),
    ],
    "quota": nodes(8) + [
        ("quota", 4),
        ("pod", "first", dict(chips=4)), ("reconcile", "first"),
        ("pod", "second", dict(chips=4)), ("reconcile", "second"), ("reconcile", "second"),
        ("finish", "first"), ("reconcile", "second"),
    ],
    "backoff": nodes(4, 4) + [("pod", "huge", dict(chips=64))] + [("reconcile", "huge")] * 7,
    "selector_mismatch": nodes(4, 2, 8) + [
        ("pod", "pinned", dict(chips=2, selector={"kubernetes.io/hostname": "node-1"})),
        ("reconcile", "pinned"),
        ("pod", "nowhere", dict(chips=1, selector={"pool": "absent"})),
        ("reconcile", "nowhere"), ("reconcile", "nowhere"),
        ("pod", "best-fit", dict(chips=4)), ("reconcile", "best-fit"),
    ],
    "drain_grace": nodes(4, 4) + [
        ("pod", "train-0", dict(chips=4, gang="tr", size=2, priority_class="batch", grace=30)),
        ("pod", "train-1", dict(chips=4, gang="tr", size=2, priority_class="batch", grace=30)),
        ("reconcile", "train-0"),
        ("pod", "urgent-0", dict(chips=4, gang="urgent", size=2, priority_class="notebook")),
        ("pod", "urgent-1", dict(chips=4, gang="urgent", size=2, priority_class="notebook")),
        ("reconcile", "urgent-0"),
        ("ack", "train-0"), ("reconcile", "urgent-0"),
        ("ack", "train-1"), ("reconcile", "urgent-0"), ("reconcile", "urgent-0"),
    ],
    # the elastic driver's organic preemption: a drain-graced trial gang on
    # both hosts, a notebook gang that needs them, the acks one by one, the
    # eviction, and the trial's degraded re-request landing on the spare
    "organic_drain": nodes(4, 4, 4) + [
        ("pod", "trial-0", dict(chips=4, gang="tr", size=2, priority_class="trial", grace=20)),
        ("pod", "trial-1", dict(chips=4, gang="tr", size=2, priority_class="trial", grace=20)),
        ("reconcile", "trial-0"),
        ("pod", "spare", dict(chips=4, gang="sp", size=1, priority_class="trial")),
        ("reconcile", "spare"),
        ("pod", "nb-0", dict(chips=4, gang="nb", size=2, priority_class="notebook")),
        ("pod", "nb-1", dict(chips=4, gang="nb", size=2, priority_class="notebook")),
        ("reconcile", "nb-0"), ("reconcile", "nb-0"),
        ("ack", "trial-0"), ("reconcile", "nb-0"),
        ("ack", "trial-1"), ("reconcile", "nb-0"), ("reconcile", "nb-1"),
        ("finish", "spare"),
        ("pod", "trial2-0", dict(chips=4, gang="tr2", size=1, priority_class="trial",
                                 grace=20)),
        ("reconcile", "trial2-0"),
    ],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_decisions_match_jax(scenario):
    want, want_components, _ = run_scenario(PKGS["jax"], SCENARIOS[scenario])
    got, components, _ = run_scenario(PKGS["torch"], SCENARIOS[scenario])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (scenario, g["reconcile"])
    assert want_components <= {"tpu-scheduler", None}
    assert components <= {"gpu-scheduler", None}


def test_the_scenarios_cover_every_outcome():
    outcomes = set()
    for steps in SCENARIOS.values():
        log, _c, _s = run_scenario(PKGS["torch"], steps)
        outcomes |= {r["decision"]["outcome"] for r in log if r["decision"]}
    assert {"bound", "waiting_gang", "unschedulable", "preempted", "quota_denied",
            "awaiting_drain"} <= outcomes


def test_backoff_delays_double_to_the_cap():
    log, _c, _s = run_scenario(PKGS["torch"], SCENARIOS["backoff"])
    assert [r["requeue_after"] for r in log] == [0.02, 0.04, 0.08, 0.16, 0.32, 0.5, 0.5]
    (event,) = log[-1]["events"]
    assert event[1] == "FailedScheduling" and event[3] == 7  # ONE aggregated Event


def test_bind_and_unbind_drive_the_tenant_meter():
    ns = "meter-ns"
    steps = nodes(4) + [("pod", "m-0", dict(chips=3)), ("reconcile", "m-0")]
    log, _c, sched = run_scenario(PKGS["torch"], steps, ns=ns)
    assert log[-1]["placement"] == {"m-0": "node-0"}
    assert TENANT_METER.open_intervals().get(ns) == 3
    pod = mkpod(PKGS["torch"], "m-0", ns=ns, chips=3)
    pod["spec"]["nodeName"] = "node-0"
    sched.ledger.on_pod_event("DELETED", pod)
    assert TENANT_METER.open_intervals().get(ns, 0) == 0


# -- tests/test_scheduler.py's Manager-driven cases on the port ----------------


def wait_for(predicate, timeout=10.0, interval=0.02, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    assert predicate(), f"timed out waiting for {desc}"


TORCH = PKGS["torch"]


def node_of(client, name, ns="default"):
    return (client.get("v1", "Pod", name, ns).get("spec") or {}).get("nodeName")


def phase_of(client, name, ns="default"):
    return (client.get("v1", "Pod", name, ns).get("status") or {}).get("phase")


def finish_pod(client, name, ns="default"):
    pod = client.get("v1", "Pod", name, ns)
    pod["status"] = {"phase": "Succeeded"}
    client.update_status(pod)


@pytest.fixture()
def sched():
    return t_core.SchedulerReconciler(assembly_timeout=5.0, reservation_ttl=5.0,
                                      backoff_base=0.02, backoff_cap=0.5)


@pytest.fixture()
def cluster(sched):
    """Scheduler + podlet over two 4-card GPU nodes."""
    mgr = t_manager.Manager()
    mgr.add(sched).add(t_builtin.PodletReconciler())
    mgr.client.create(t_builtin.make_gpu_node("gpu-node-0", "h100", 4))
    mgr.client.create(t_builtin.make_gpu_node("gpu-node-1", "h100", 4))
    mgr.start()
    try:
        yield mgr
    finally:
        mgr.stop()


class TestManagerDriven:
    def test_gang_binds_all_or_nothing_across_nodes(self, cluster):
        for i in range(2):
            cluster.client.create(mkpod(TORCH, f"slice-{i}", chips=4, gang="slice", size=2))
        wait_for(lambda: all(phase_of(cluster.client, f"slice-{i}") == "Running"
                             for i in range(2)), desc="gang Running")
        assert {node_of(cluster.client, f"slice-{i}") for i in range(2)} == \
            {"gpu-node-0", "gpu-node-1"}
        assert METRICS.value("scheduler_attempts_total", result="bound") >= 1
        rendered = METRICS.render()
        assert "scheduler_time_to_bind_seconds_count" in rendered
        assert "scheduler_bind_latency_seconds_count" in rendered

    def test_two_gangs_no_partial_placement(self, cluster):
        for g in ("alpha", "beta"):
            for i in range(2):
                cluster.client.create(mkpod(TORCH, f"{g}-{i}", chips=4, gang=g, size=2))

        def gang_nodes(g):
            return [node_of(cluster.client, f"{g}-{i}") for i in range(2)]

        wait_for(lambda: any(all(gang_nodes(g)) for g in ("alpha", "beta")),
                 desc="one gang fully bound")
        winner = "alpha" if all(gang_nodes("alpha")) else "beta"
        loser = "beta" if winner == "alpha" else "alpha"
        assert gang_nodes(loser) == [None, None], "partial placement leaked"
        wait_for(lambda: any(
            c.get("reason") == "Unschedulable"
            for c in (cluster.client.get("v1", "Pod", f"{loser}-0", "default")
                      .get("status") or {}).get("conditions", [])),
            desc="loser Unschedulable condition")
        for i in range(2):
            finish_pod(cluster.client, f"{winner}-{i}")
        wait_for(lambda: all(phase_of(cluster.client, f"{loser}-{i}") == "Running"
                             for i in range(2)), desc="loser Running after winner finished")

    def test_notebook_gang_evicts_trial_gang(self, cluster):
        for i in range(2):
            cluster.client.create(mkpod(TORCH, f"trial-{i}", chips=4, gang="hpo", size=2,
                                        priority_class="trial"))
        wait_for(lambda: all(phase_of(cluster.client, f"trial-{i}") == "Running"
                             for i in range(2)), desc="trial gang Running")
        for i in range(2):
            cluster.client.create(mkpod(TORCH, f"nb-{i}", chips=4, gang="nb", size=2,
                                        priority_class="notebook"))
        wait_for(lambda: all(phase_of(cluster.client, f"nb-{i}") == "Running"
                             for i in range(2)), desc="notebook gang Running")
        assert cluster.client.get_opt("v1", "Pod", "trial-0", "default") is None
        assert cluster.client.get_opt("v1", "Pod", "trial-1", "default") is None

    def test_quota_rejects_at_bind_time(self, sched):
        mgr = t_manager.Manager()
        mgr.add(sched).add(t_builtin.PodletReconciler())
        mgr.client.create(t_builtin.make_gpu_node("gpu-node-0", "h100", 8))
        mgr.client.create(t_meta.new_object("v1", "ResourceQuota", t_gang.QUOTA_NAME, "default",
                                            spec={"hard": {t_gang.GPU_QUOTA_KEY: "4"}}))
        mgr.start()
        try:
            mgr.client.create(mkpod(TORCH, "first", chips=4))
            wait_for(lambda: phase_of(mgr.client, "first") == "Running", desc="first Running")
            mgr.client.create(mkpod(TORCH, "second", chips=4))
            wait_for(lambda: any(
                "quota" in (c.get("message") or "")
                for c in (mgr.client.get("v1", "Pod", "second", "default")
                          .get("status") or {}).get("conditions", [])),
                desc="quota denial condition")
            assert node_of(mgr.client, "second") is None
            finish_pod(mgr.client, "first")
            wait_for(lambda: phase_of(mgr.client, "second") == "Running",
                     desc="second Running after quota freed")
        finally:
            mgr.stop()

    def test_debug_scheduler_serves_the_flight_recorder(self, cluster, sched):
        from kubeflow_tpu_torch.runtime.obs import mount_observability
        from kubeflow_tpu_torch.web.http import App, Request

        cluster.client.create(mkpod(TORCH, "seen", chips=4))
        wait_for(lambda: phase_of(cluster.client, "seen") == "Running", desc="Running")
        app = App("ops")
        mount_observability(app)
        resp = app.dispatch(Request(method="GET", path="/debug/scheduler",
                                    query={"gang": ["default/pod:seen"]}, headers={},
                                    body=b""))
        doc = resp.body
        assert doc["scheduler"] == "kubeflow-tpu-torch" and doc["count"] >= 1
        assert doc["decisions"][-1]["outcome"] == "bound"
        assert doc["decisions"][-1]["placement"] in (["gpu-node-0"], ["gpu-node-1"])


def test_ledger_reservations_and_all_or_nothing():
    led = ChipLedger()
    led.on_node_event("ADDED", t_builtin.make_gpu_node("n0", "h100", 4))
    led.on_node_event("ADDED", t_builtin.make_gpu_node("n1", "h100", 4))
    need = [(4, {}), (4, {})]
    assert sorted(led.place_and_reserve(("ns", "a"), need, ttl=30.0)) == ["n0", "n1"]
    assert led.place_and_reserve(("ns", "b"), need, ttl=30.0) is None
    assert ("ns", "b") not in led.reservations()
    led = ChipLedger()
    led.on_node_event("ADDED", t_builtin.make_gpu_node("n0", "h100", 4))
    led.reserve(("ns", "c"), {"n0": 4}, ttl=30.0, now=100.0)
    assert led.free_chips(now=101.0)["n0"] == 0
    assert led.free_chips(exclude_gang=("ns", "c"), now=101.0)["n0"] == 4
    assert led.free_chips(now=131.0)["n0"] == 4  # every hold expired


def test_gpu_node_fixture_shape():
    node = t_builtin.make_gpu_node("gpu-node-0", "h100", 8, instance_type="a3-highgpu-8g")
    labels = node["metadata"]["labels"]
    assert node["status"]["capacity"][t_topology.RESOURCE_GPU] == "8"
    assert labels[t_topology.NODE_LABEL_PRODUCT] == "NVIDIA-H100-80GB-HBM3"
    assert labels[t_builtin.NODE_LABEL_INSTANCE_TYPE] == "a3-highgpu-8g"
    assert t_gang.GPU_QUOTA_KEY == "requests.nvidia.com/gpu"
    assert t_core.COMPONENT == "gpu-scheduler"


def test_gang_model_keeps_jax_values():
    pod = mkpod(TORCH, "p", gang="g", size=3, priority_class="trial")
    gang = t_gang.gang_of(pod)
    assert (gang.name, gang.size, gang.priority, gang.labeled) == ("g", 3, 10, True)
    assert t_gang.PRIORITY_CLASSES == j_gang.PRIORITY_CLASSES
    assert t_gang.requires_scheduling(mkpod(TORCH, "q", chips=1), have_nodes=False)
    assert not t_gang.requires_scheduling(mkpod(TORCH, "r"), have_nodes=False)
    for name in ("POD_GROUP_LABEL", "POD_GROUP_SIZE_ANNOTATION", "DRAIN_GRACE_ANNOTATION",
                 "DRAIN_DEADLINE_ANNOTATION", "DRAIN_ACK_ANNOTATION", "QUARANTINE_ANNOTATION",
                 "QUOTA_NAME", "TERMINAL_PHASES", "DEFAULT_PRIORITY"):
        assert getattr(t_gang, name) == getattr(j_gang, name), name
