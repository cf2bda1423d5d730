"""kubeflow_tpu_torch/e2e/straggler_driver.py against e2e/straggler_driver.py.

The driver runs once for the file in a world of 8 gloo ranks (~36 s) and
asserts JAX's contract itself: a ``slow_worker`` flagged within the k-of-n
window budget, a ``wedge_worker`` given a hang verdict whose stack dump
names ``_wedge_wait``, its node quarantined and the gang drained, the
trainer resharding around the node and finishing with loss parity. The
tests read its summary.
"""

import pytest

from kubeflow_tpu_torch.e2e import straggler_driver as driver


@pytest.fixture(scope="module")
def summary():
    return driver.run("cpu", 8, timeout=240)


def test_detection_within_the_window_budgets(summary):
    assert summary["ok"]
    assert 0.0 < summary["straggler_detect_seconds"] <= driver.STRAGGLER_BUDGET_S
    assert 0.0 < summary["hang_detect_seconds"] <= driver.HANG_BUDGET_S
    assert "_wedge_wait" in summary["stack_threads"]


def test_drained_around_the_quarantined_node_with_loss_parity(summary):
    incs = summary["incarnations"]
    assert [i["outcome"] for i in incs] == ["preempted", "completed"]
    assert incs[1]["startStep"] == incs[0]["endStep"] + 1
    assert summary["quarantined_node"].startswith("gpu-node-")
    assert abs(summary["final_loss"] - summary["reference_final_loss"]) <= driver.LOSS_PARITY_TOL
    assert summary["max_step_loss_delta"] <= driver.LOSS_PARITY_TOL
