"""The port's serving, observability and fleet drivers against
e2e/serving_driver.py, e2e/observability_driver.py and e2e/fleet_driver.py,
on the CPU.

Each driver runs its whole scenario over real HTTP with ``device="cpu"``,
asserts everything the JAX driver asserts and reports JAX's keys (read
from the JAX driver's source); the constants are JAX's; the serving
driver's ``main`` writes a JUnit file with one passing case, in the JAX
writer's format. The served
models are held against JAX's on the same weights elsewhere:
``tests/test_torch_bert.py::test_bert_served_model_matches_jax_servable``
(BERT-tiny's predictions) and
``tests/test_torch_fleet_serving.py::test_gpt_tiny_fleet_equals_the_jax_fleet``
(the fleet driver's GPT-tiny fleet and prompt).
"""

import ast
import json
import xml.etree.ElementTree as ET
from pathlib import Path

import torch

from e2e import fleet_driver as jfleet
from e2e import observability_driver as jobs
from e2e import serving_driver as jserving
from kubeflow_tpu_torch.e2e import fleet_driver, observability_driver, serving_driver
from kubeflow_tpu_torch.runtime.metrics import METRICS

from test_torch_paged_kv_driver import jax_report_keys

# the replicas' worker threads share the cores
torch.set_num_threads(1)

E2E = Path(__file__).resolve().parents[1] / "e2e"


def returned_keys(source: Path, func: str) -> set:
    """The keys of the dict literal that ``func`` returns in a JAX driver."""
    tree = ast.parse(source.read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def test_constants_equal_jax():
    assert serving_driver.TOLERANCE == jserving.TOLERANCE == 1e-3
    for name in ("CLIENT_TRACE_ID", "CLIENT_SPAN_ID", "TRACEPARENT", "SLO_HISTOGRAMS"):
        assert getattr(observability_driver, name) == getattr(jobs, name), name
    for name in ("REPLICAS", "MAX_REPLICAS", "SLOTS", "BURST", "BUDGET"):
        assert getattr(fleet_driver, name) == getattr(jfleet, name), name


def test_serving_driver_passes_and_reports_jax_keys():
    report = serving_driver.run_serving_e2e(device="cpu")
    assert set(report) == returned_keys(E2E / "serving_driver.py", "run_serving_e2e")
    assert report == {"predictions": 3, "model": "bert"}


def test_serving_driver_main_writes_junit(tmp_path, capsys):
    path = tmp_path / "junit.xml"
    assert serving_driver.main(["--junit", str(path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("PASS")
    suite = ET.parse(path).getroot()
    assert (suite.tag, suite.get("name"), suite.get("tests"), suite.get("failures")) == \
        ("testsuite", "e2e-serving", "1", "0")
    (case,) = list(suite)
    assert (case.get("classname"), case.get("name"), list(case)) == \
        ("ServingE2E", "bert-predict", [])


def test_junit_xml_equals_jax():
    from e2e.junit import TestSuite, junit_xml as jax_junit_xml
    from kubeflow_tpu_torch.e2e._http import junit_xml

    for failure in (None, ValueError("a <bad> & 'odd' answer")):
        suite = TestSuite("e2e-serving")

        def flow():
            if failure is not None:
                raise failure

        case = suite.run("ServingE2E", "bert-predict", flow)
        got = junit_xml("e2e-serving", "ServingE2E", "bert-predict", case.time_seconds,
                        case.failure)
        assert got == jax_junit_xml(suite)


def test_observability_driver_passes_and_reports_jax_keys():
    METRICS.reset()
    report = observability_driver.run(device="cpu")
    assert set(report) == returned_keys(E2E / "observability_driver.py", "run")
    assert report["ok"] is True and report["trace_id"] == jobs.CLIENT_TRACE_ID
    assert report["events"][:5] == ["enqueued", "admitted", "prefill_done", "first_token",
                                    "retired"]
    assert report["generated"] == 4 + 8
    json.dumps(report)


def test_fleet_driver_passes_and_reports_jax_keys():
    METRICS.reset()
    report = fleet_driver.run(device="cpu")
    assert set(report) == set(jax_report_keys(E2E / "fleet_driver.py"))
    assert report["ok"] is True and report["prefix_hits"] > 0
    assert "up" in report["autoscale_decisions"] and "down" in report["autoscale_decisions"]
    assert report["requeued"] > 0 and report["burst_ok"] == fleet_driver.BURST
    json.dumps(report)
