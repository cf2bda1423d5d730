"""kubeflow_tpu_torch/e2e/distributed_driver.py against e2e/distributed_driver.py.

The driver boots 4 worker processes with the torchrun env the webhook
injects (a free localhost port in place of the headless-service DNS) and
runs the bootstrap, an all-gather, a data-parallel step and a ``data 2 x
model 2`` step on gloo; it asserts what JAX's driver asserts (falling
losses, parameters elementwise equal on every worker) and reports JAX's
keys, read from the JAX driver's source. One run for the file (~10 s).
"""

import ast
import json
from pathlib import Path

import pytest

from kubeflow_tpu_torch.e2e import distributed_driver as driver

JAX_SOURCE = Path(__file__).resolve().parents[1] / "e2e" / "distributed_driver.py"


def _jax_report_keys():
    tree = ast.parse(JAX_SOURCE.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_distributed_e2e")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


@pytest.fixture(scope="module")
def report():
    return driver.run(timeout=120)


def test_run_passes_and_reports_jax_keys(report):
    assert set(report) == _jax_report_keys()
    assert report["workers"] == 4
    assert report["rendezvous"] == report["dp_train"] == "ok"
    assert report["dp_tp_train"].startswith("ok (data2 x model2")
    # the master the webhook injects: pod 0 of the headless Service
    assert report["coordinator_env"] == ("dist-nb-0.dist-nb.kubeflow-user.svc."
                                         "cluster.local:29500")


def test_a_failing_worker_fails_the_run(monkeypatch):
    # an env the bootstrap refuses: every worker exits non-zero at once
    monkeypatch.setattr(driver, "POD_NAME", "dist-nb-7")
    with pytest.raises(AssertionError, match="ordinal 28 >= num_processes 4"):
        driver.run(timeout=60)


def test_main_prints_one_json_line_on_failure(monkeypatch, capsys):
    monkeypatch.setattr(driver, "POD_NAME", "dist-nb-7")
    assert driver.main([]) == 1
    out = json.loads(capsys.readouterr().out.strip())
    assert out["ok"] is False and "ordinal" in out["error"]
