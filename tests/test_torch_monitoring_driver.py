"""kubeflow_tpu_torch/e2e/monitoring_driver.py on the CPU at JAX's tiny
width: it passes with JAX's checks and reports every key of JAX's report
(read from ``e2e/monitoring_driver.py``'s source), its fast TTFTs under the
threshold and its slowed ones over it; its ops servers import nothing of
JAX.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubeflow_tpu_torch.e2e import monitoring_driver as md

ROOT = Path(__file__).resolve().parents[1]


def _jax_report_keys() -> set:
    tree = ast.parse((ROOT / "e2e" / "monitoring_driver.py").read_text())
    keys = {"ok"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "report" and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


@pytest.fixture()
def one_thread():
    """The replicas' workers share the cores: one intra-op thread each (as
    the port's other serving-driver tests run)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_driver_passes_with_the_jax_report_keys(one_thread):
    report = md.run(device="cpu", tiny=True)
    want = _jax_report_keys()
    assert {"federated_targets", "event_count", "autoscaled_to", "platform_ttft_p99"} <= want
    assert want <= set(report), want - set(report)
    assert report["ok"] is True
    assert len(report["federated_targets"]) == 3
    assert report["event_count"] >= 2
    assert report["autoscaled_to"] == 3 and report["autoscaler_source"] == "federated"
    assert report["resolved"] is True
    assert report["fire_tick"] < report["resolve_tick"]
    # the TTFTs the threshold sits between
    assert report["ttft_fast_p50_s"] < md.TTFT_THRESHOLD_S < report["ttft_slow_p50_s"]
    json.dumps(report)  # main prints it as one JSON line


def test_ops_server_imports_no_jax(tmp_path):
    """Run from outside the checkout: the port comes from PYTHONPATH."""
    script = md._OPS_SCRIPT.replace(
        "sys.stdin.read()",
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'kubeflow_tpu', 'e2e')], flush=True)")
    proc = subprocess.run([sys.executable, "-c", script], env=md._ops_env(), cwd=tmp_path,
                          capture_output=True, text=True, timeout=60, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr
    port, bad = proc.stdout.splitlines()
    assert int(port) > 0 and bad == "[]"


def test_ttft_table_rows(one_thread):
    """The fast row (the driver's run holds the slowed TTFTs past the
    threshold)."""
    (fast,) = md.ttft_table(device="cpu", tiny=True, chunks=(md.DECODE_CHUNK,),
                            delays=(0.0,), seconds=1.5)
    assert (fast["chunk"], fast["delay_s"]) == (4, 0.0)
    assert fast["n"] >= 2 and fast["p10_s"] <= fast["p50_s"] <= fast["p90_s"]
    assert fast["alone_s"] < md.TTFT_THRESHOLD_S and fast["p90_s"] < md.TTFT_THRESHOLD_S


def test_quantile_matches_numpy():
    import numpy as np

    for values in ([3.0], [1.0, 2.0], [0.5, 0.1, 0.9, 0.3, 0.7]):
        v = sorted(values)
        for q in (0.0, 0.1, 0.5, 0.9, 1.0):
            assert md._quantile(v, q) == pytest.approx(float(np.quantile(v, q)), abs=1e-12)
    assert md._quantile([], 0.5) is None
