"""kubeflow_tpu_torch/e2e/overload_driver.py against e2e/overload_driver.py,
on the CPU.

``run(device="cpu")`` drives the whole scenario over real HTTP with JAX's
constants (a 3-replica fleet of 2 slots, a flood at 40 / 18 = 2.22x the
batch capacity, the port's ``ChaosMonkey`` firing ``client_abandon``,
``slow_replica`` and ``crash_replica_mid_decode``), asserts everything
JAX's driver asserts, and reports JAX's keys: the top level and each
section's, read from the JAX driver's source.
"""

import ast
import json
from pathlib import Path

import torch

from e2e import overload_driver as jdriver
from kubeflow_tpu_torch.e2e import overload_driver as driver
from kubeflow_tpu_torch.runtime.metrics import METRICS

from test_torch_paged_kv_driver import jax_report_keys

# the replicas' worker threads share the cores
torch.set_num_threads(1)

JAX_SOURCE = Path(__file__).resolve().parents[1] / "e2e" / "overload_driver.py"


def report_keys(source: Path) -> dict:
    """``jax_report_keys`` plus the keys the report starts with
    (``report: dict = {...}``)."""
    out = jax_report_keys(source)
    for node in ast.walk(ast.parse(source.read_text())):
        if (isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
                and node.target.id == "report" and isinstance(node.value, ast.Dict)):
            out.update(dict.fromkeys(k.value for k in node.value.keys))
    return out


def test_constants_equal_jax():
    tree = ast.parse(JAX_SOURCE.read_text())
    names = {n.targets[0].id for n in tree.body
             if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}
    assert names == {"REPLICAS", "SLOTS", "BUDGET", "MAX_PENDING", "ENGINE_RESERVE",
                     "ROUTER_DEPTH", "ROUTER_RESERVE", "BATCH_CAPACITY", "FLOOD",
                     "INTERACTIVE_CLIENTS"}
    assert {k: getattr(driver, k) for k in names} == {k: getattr(jdriver, k) for k in names}
    assert driver.BATCH_CAPACITY == 18 and round(driver.FLOOD / driver.BATCH_CAPACITY, 2) == 2.22


def test_run_passes_and_reports_jax_keys():
    METRICS.reset()
    report = driver.run(device="cpu")
    want = report_keys(JAX_SOURCE)
    assert set(report) == set(want) == {
        "ok", "saturation_factor", "doa_504_s", "flood", "abandoned", "breaker", "crash",
        "deadline_expired_total"}
    for key, keys in want.items():
        if keys is not None:
            assert set(report[key]) == keys, key
    assert report["ok"] is True and report["saturation_factor"] == 2.22
    assert report["doa_504_s"] < 5.0
    flood = report["flood"]
    assert flood["batch_503"] > 0 and flood["interactive_200"] == 2 * driver.INTERACTIVE_CLIENTS
    assert flood["batch_200"] + flood["batch_503"] == driver.FLOOD
    assert report["abandoned"]["cancelled"] >= 1
    assert report["breaker"]["opened"] and report["breaker"]["reclosed"]
    assert report["crash"]["burst_200"] == 8
    assert report["deadline_expired_total"] >= 1
    # every fault fired through the port's monkey, none skipped
    assert METRICS.value("chaos_faults_injected_total", kind="slow_replica") == 4
    assert METRICS.value("chaos_faults_injected_total", kind="client_abandon") == 1
    assert METRICS.value("chaos_faults_injected_total", kind="crash_replica_mid_decode") == 1
    json.dumps(report)  # main() prints it as one JSON line
