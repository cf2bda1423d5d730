"""kubeflow_tpu_torch/e2e/{control_plane,controlplane_scale}_driver.py
against e2e/{control_plane,controlplane_scale}_driver.py.

Each port driver runs once over real HTTP on the port's apiserver, gang
scheduler and podlet and makes JAX's checks itself (the oversized gang's
flight-recorder verdicts, ONE aggregated FailedScheduling Event a member,
the scraped series; the seeded topology's two waves bound, the truncated
verdict list, the watch storm, churn and node kills, the SLIs queryable
from a TSDB); the tests read its report for every key of JAX's (read
from the JAX driver's source, which imports JAX-side modules only inside
``run``), at JAX's sizes for the first and, for the second, 40 nodes
at JAX's 6 gangs a wave.
Neither driver imports torch.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu_torch.e2e import control_plane_driver as cpd
from kubeflow_tpu_torch.e2e import controlplane_scale_driver as csd

ROOT = Path(__file__).resolve().parents[1]


def _jax_report_keys(module: str) -> set:
    """The keys of the dict JAX's ``run`` returns."""
    tree = ast.parse((ROOT / "e2e" / f"{module}.py").read_text())
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    keys = set()
    for node in ast.walk(run):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    return keys


@pytest.fixture(scope="module")
def control_plane():
    return cpd.run()


@pytest.fixture(scope="module")
def scale():
    return csd.run(nodes=40)


def test_control_plane_driver_keeps_jax_keys_and_checks(control_plane):
    want = _jax_report_keys("control_plane_driver")
    assert {"unschedulable_decisions", "verdicts", "event_counts", "decision_total"} <= want
    assert want <= set(control_plane), want - set(control_plane)
    assert control_plane["ok"] is True
    assert control_plane["unschedulable_decisions"] >= cpd.MIN_DECISIONS
    assert control_plane["verdicts"] == {f"gpu-node-{i}": "insufficient_chips"
                                         for i in range(cpd.NODES)}
    assert set(control_plane["event_counts"]) == set(cpd.MEMBERS)
    assert all(c > 1 for c in control_plane["event_counts"].values())
    assert control_plane["decision_total"] >= cpd.MIN_DECISIONS
    json.dumps(control_plane)


def test_control_plane_driver_main_prints_the_report(capsys):
    assert cpd.main() == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is True
    assert report["unschedulable_decisions"] >= cpd.MIN_DECISIONS


def test_scale_driver_keeps_jax_keys_and_checks(scale):
    want = _jax_report_keys("controlplane_scale_driver")
    assert {"nodes", "gangs_bound", "storm", "verdicts_exact", "bind_p99_s"} <= want
    assert want <= set(scale), want - set(scale)
    assert scale["ok"] is True and scale["nodes"] == 40
    assert scale["gangs_bound"] == 2 * csd.WAVE_GANGS
    assert scale["bind_count"] >= 2 * csd.WAVE_GANGS
    assert scale["verdicts_exact"] <= csd.VERDICT_TOP_K < scale["nodes"]
    assert scale["verdicts_exact"] + scale["verdicts_truncated"] >= scale["nodes"] - 1
    assert scale["killed"] == 1 and scale["churned"] >= 1
    assert scale["storm"]["lists"] >= 24 and scale["storm"]["watch_events"] > 0
    assert scale["cycles_per_sec"] > 0 and scale["bind_p99_s"] >= 0.0
    json.dumps(scale)


@pytest.mark.parametrize("module", ["control_plane_driver", "controlplane_scale_driver"])
def test_drivers_import_no_torch_or_jax(module):
    code = (f"import sys, kubeflow_tpu_torch.e2e.{module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'jax', 'jaxlib', 'flax', 'kubeflow_tpu', 'e2e'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
