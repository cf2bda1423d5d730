"""kubeflow_tpu_torch/e2e/{elastic,goodput}_driver.py against e2e/{elastic,goodput}_driver.py.

Each driver runs once for the file in a world of 8 gloo ranks (~16 s
each) and asserts JAX's contract itself; the tests read its summary: >= 3
preemptions survived with a reshard 8 -> 4 ranks ((pp 4, V 1) -> (pp 2,
V 2)), zero steps lost, losses within JAX's ``LOSS_TOL`` 1e-3 of an
uninterrupted run, the kill -9 scenario; goodput fractions summing to
exactly 1.0, reconstruction within 5%, ``preemption_replay`` of exactly
the 2 steps past the surviving checkpoint. The drivers' in-memory cluster
and command line are checked on their own.
"""

import json

import pytest
import torch

from kubeflow_tpu_torch.e2e import elastic_cluster as ec
from kubeflow_tpu_torch.e2e import elastic_driver, goodput_driver
from kubeflow_tpu_torch.scheduler.gang import (DRAIN_ACK_ANNOTATION, DRAIN_DEADLINE_ANNOTATION,
                                               QUARANTINE_ANNOTATION, annotations_of)


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


def test_pod_client_places_drains_and_evicts():
    client = ec.PodClient()
    ec.add_nodes(client, ["a", "b"], 4)
    pods = ec.place_gang(client, "g", 2, 4, grace=5)
    assert [client.get_opt("v1", "Pod", p, ec.NAMESPACE)["spec"]["nodeName"]
            for p in pods] == ["a", "b"]
    assert ec.place_gang(client, "h", 1, 1) is None  # full
    ec.preempt_gang(client, pods, 5.0)
    assert all(DRAIN_DEADLINE_ANNOTATION in annotations_of(
        client.get_opt("v1", "Pod", p, ec.NAMESPACE)) for p in pods)
    client.patch("v1", "Pod", pods[0], {"metadata": {"annotations": {DRAIN_ACK_ANNOTATION: "7"}}},
                 ec.NAMESPACE)
    assert ec.evict(client, pods) == ["7"]
    client.patch("v1", "Node", "a", {"metadata": {"annotations": {QUARANTINE_ANNOTATION: "{}"}}})
    again = ec.place_gang(client, "i", 1, 4)
    assert client.get_opt("v1", "Pod", again[0], ec.NAMESPACE)["spec"]["nodeName"] == "b"
    client.emit_event(client.get_opt("v1", "Node", "a"), "NodeQuarantined", "m", type_="Warning")
    assert [e["reason"] for e in client.list("v1", "Event", ec.NAMESPACE)] == ["NodeQuarantined"]


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
