"""kubeflow_tpu_torch/e2e/{elastic,goodput}_driver.py against e2e/{elastic,goodput}_driver.py.

Each driver runs once for the file in a world of 8 gloo ranks (~16 s
each) and asserts JAX's contract itself; the tests read its summary: >= 3
preemptions survived with a reshard 8 -> 4 ranks ((pp 4, V 1) -> (pp 2,
V 2)), zero steps lost, losses within JAX's ``LOSS_TOL`` 1e-3 of an
uninterrupted run, the kill -9 scenario; goodput fractions summing to
exactly 1.0, reconstruction within 5%, ``preemption_replay`` of exactly
the 2 steps past the surviving checkpoint. Both run on the drivers'
cluster (the port's store, gang scheduler and podlet, on rank 0): the
elastic driver's first drain is the scheduler's, the next two the chaos
harness's, with JAX's seeded benign chaos throughout; the goodput
driver's ``scheduling_wait`` agrees with the scheduler's bind latency,
its tenant gang's meter with cards × bound duration, and its goodput
fraction survives the scrape into a TSDB, the recording rule and the
platform view. ``elastic_cluster.cluster`` and the command line are checked on
their own.
"""

import json

import pytest
import torch

from kubeflow_tpu_torch.e2e import elastic_cluster as ec
from kubeflow_tpu_torch.e2e import elastic_driver, goodput_driver
from kubeflow_tpu_torch.scheduler.gang import (DRAIN_ACK_ANNOTATION, DRAIN_DEADLINE_ANNOTATION,
                                               DRAIN_GRACE_ANNOTATION, POD_GROUP_LABEL,
                                               POD_GROUP_SIZE_ANNOTATION, annotations_of)


@pytest.fixture(scope="module")
def elastic():
    return elastic_driver.run("cpu", 8, timeout=240)


@pytest.fixture(scope="module")
def goodput():
    return goodput_driver.run("cpu", 8, timeout=240)


def test_elastic_survives_three_preemptions_with_a_reshard(elastic):
    assert elastic["ok"] and elastic["ranks"] == 8
    assert elastic["preemptions_survived"] >= 3 and elastic["restarts"] >= 3
    shapes = [tuple(i["shape"]) for i in elastic["incarnations"]]
    chips = [i["chips"] for i in elastic["incarnations"]]
    assert shapes[:2] == [(4, 1), (2, 2)] and chips[:2] == [8, 4]
    assert shapes[-1] == (4, 1) and chips[-1] == 8


def test_elastic_loses_no_step_and_keeps_the_curve(elastic):
    incs = elastic["incarnations"]
    assert [i["outcome"] for i in incs] == ["preempted"] * (len(incs) - 1) + ["completed"]
    for prev, cur in zip(incs, incs[1:]):
        assert cur["startStep"] == prev["endStep"] + 1
    assert incs[-1]["endStep"] == elastic_driver.TOTAL_STEPS
    assert elastic["max_loss_delta"] <= elastic_driver.LOSS_TOL == 1e-3


def test_elastic_kill9_mid_save_skips_the_torn_checkpoint(elastic):
    assert elastic["kill9"] == {"resumed_step": 0, "skipped": [1], "torn_cleaned": True}


def test_goodput_honesty_contract(goodput):
    assert goodput["ok"]
    assert goodput["reconstruction_error"] <= goodput_driver.RECONSTRUCTION_TOL == 0.05
    bad = goodput["badput_seconds"]
    assert set(bad) == {"scheduling_wait", "compile", "checkpoint_save", "checkpoint_restore",
                        "preemption_replay", "reshard", "data_wait", "other"}
    assert all(bad[b] > 0.0 for b in ("preemption_replay", "checkpoint_restore",
                                      "checkpoint_save", "compile", "scheduling_wait"))
    assert 0.0 < goodput["goodput_fraction"] < 1.0
    assert abs(goodput["scraped_goodput_fraction"] - goodput["goodput_fraction"]) < 1e-3


def test_goodput_replays_exactly_the_steps_past_the_checkpoint(goodput):
    incs = goodput["incarnations"]
    assert [i["outcome"] for i in incs] == ["preempted", "preempted", "lost", "completed"]
    assert goodput["replayed_steps"] == 2
    assert incs[3]["startStep"] == incs[2]["endStep"] - 1
    assert [i["goodput"]["replaySteps"] for i in incs] == [0, 0, 0, 2]


def test_elastic_drains_come_from_the_scheduler_and_the_harness(elastic):
    """JAX's control-plane checks, read back: the first drain was the
    scheduler's own (requested and completed on the acks), the next two the
    chaos kind's, with the seeded benign chaos running beside them (its
    first fault is due 11.55 s in, so a short run may see none fire)."""
    assert elastic["drains_requested"] >= 1 and elastic["drains_acked"] >= 1
    assert elastic["chaos_preemptions"] >= 2
    assert set(elastic["benign_chaos"]) <= {"drop_informer_watch", "delay_apiserver"}


def test_goodput_scheduling_wait_and_tenant_meter(goodput):
    """``scheduling_wait`` within 1.5 s a gang of the scheduler's bind
    latency, and the tenant meter within its tolerance of cards × bound
    duration."""
    bind = goodput["bind_latency_seconds"]
    assert bind["count"] >= len(goodput["incarnations"])
    assert abs(goodput["badput_seconds"]["scheduling_wait"] - bind["sum"]) <= \
        goodput_driver.BIND_LATENCY_SLACK_PER_GANG * bind["count"]
    assert goodput["tenant_chip_seconds"] > 0.0
    assert abs(goodput["tenant_chip_seconds"] - goodput["tenant_expected_chip_seconds"]) <= \
        goodput_driver.TENANT_TOL_CHIP_SECONDS


def test_goodput_federates_through_the_tsdb(goodput):
    mon = goodput["monitoring"]
    assert abs(mon["scraped_goodput_fraction"] - goodput["goodput_fraction"]) < 1e-3
    assert 0.0 < mon["recorded_measured_fraction"] <= 1.0
    assert goodput_driver.TENANT_NS in mon["dashboard_tenants"]


def test_cluster_binds_a_gang_pod_and_drains_it_for_a_notebook():
    """The drivers' cluster: ``gang_pod`` is JAX's ``_gang_pod`` asking for
    ``nvidia.com/gpu``; the scheduler binds a drain-graced trial gang, and
    a notebook gang that needs its cards makes the scheduler stamp the
    drain deadline; once both pods ack it evicts them and binds the
    notebook. ``stop()`` leaves no thread of the cluster running."""
    import threading

    before = set(threading.enumerate())
    mgr, client, sched = ec.cluster([("gpu-node-0", 4), ("gpu-node-1", 4)])
    try:
        pod = ec.gang_pod("t-0", "t", 2, 4, "trial", grace=30.0)
        assert pod["metadata"]["labels"] == {POD_GROUP_LABEL: "t"}
        assert annotations_of(pod) == {POD_GROUP_SIZE_ANNOTATION: "2",
                                       DRAIN_GRACE_ANNOTATION: "30.0"}
        assert pod["spec"] == {"priorityClassName": "trial", "containers": [
            {"name": "trainer", "resources": {"limits": {"nvidia.com/gpu": "4"}}}]}
        for name in ("t-0", "t-1"):
            client.create(ec.gang_pod(name, "t", 2, 4, "trial", grace=30.0))
        ec.poll(lambda: ec.running(client, ["t-0", "t-1"]), timeout=15, desc="trial bound")
        for name in ("nb-0", "nb-1"):
            client.create(ec.gang_pod(name, "nb", 2, 4, "notebook"))
        ec.poll(lambda: all(DRAIN_DEADLINE_ANNOTATION in annotations_of(
            client.get("v1", "Pod", n, ec.NAMESPACE)) for n in ("t-0", "t-1")),
            timeout=15, desc="drain stamped")
        assert not ec.gone(client, ["t-0", "t-1"])  # nobody acked yet
        for name in ("t-0", "t-1"):
            client.patch("v1", "Pod", name, {"metadata": {"annotations": {
                DRAIN_ACK_ANNOTATION: "9"}}}, ec.NAMESPACE)
        ec.poll(lambda: ec.gone(client, ["t-0", "t-1"]), timeout=15, desc="evicted")
        ec.poll(lambda: ec.running(client, ["nb-0", "nb-1"]), timeout=15, desc="notebook bound")
        assert sched.flight.last_for(f"{ec.NAMESPACE}/nb").outcome == "bound"
    finally:
        mgr.stop()
    left = [t.name for t in threading.enumerate() if t not in before and t.is_alive()]
    assert left == [], left


def test_driver_main_reports_a_failure_as_json(capsys):
    def failing(device, ranks, timeout):
        assert ranks == 4 and device == "cpu", (device, ranks)
        raise AssertionError("loss curve diverged")

    assert ec.driver_main(["--device", "cpu", "--ranks", "4"], "doc", failing, 8) == 1
    assert json.loads(capsys.readouterr().out) == {"ok": False, "error": "loss curve diverged"}
    report = lambda d, r, t: {"ok": True, "device": d, "ranks": r}  # noqa: E731
    assert ec.driver_main(["--device", "cpu"], "doc", report, 8) == 0
    assert json.loads(capsys.readouterr().out) == {"ok": True, "device": "cpu", "ranks": 8}
    # the card unless the CPU is asked for: one rank a card
    assert ec.driver_main([], "doc", report, 8) == 0
    assert json.loads(capsys.readouterr().out) == {
        "ok": True, "device": "cuda", "ranks": torch.cuda.device_count()}
