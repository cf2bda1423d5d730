"""kubeflow_tpu_torch/e2e/paged_kv_driver.py against e2e/paged_kv_driver.py,
on the CPU.

``run(device="cpu")`` drives the whole scenario over real HTTP (a
2-replica fleet, paged arena, chunked prefill, a speculating draft) with
JAX's constants, asserts everything JAX's driver asserts, and reports
JAX's keys: the top level and each section's, read from the JAX driver's
source. The port holds its chatty requests behind the long prompt's first
chunk, so their first tokens come before the long one's by order, not by a
sleep (``_FirstChunkGate``).
"""

import ast
import json
from pathlib import Path

from kubeflow_tpu_torch.e2e import paged_kv_driver as driver
from kubeflow_tpu_torch.runtime.metrics import METRICS

JAX_SOURCE = Path(__file__).resolve().parents[1] / "e2e" / "paged_kv_driver.py"


def jax_report_keys(source: Path) -> dict:
    """``report[key] = {...}`` assignments of a JAX driver: key -> the
    section's keys (None where the value is not a dict literal)."""
    tree = ast.parse(source.read_text())
    out = {"ok": None}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "report"):
            key = node.targets[0].slice.value
            out[key] = ({k.value for k in node.value.keys}
                        if isinstance(node.value, ast.Dict) else None)
    return out


def test_constants_equal_jax():
    tree = ast.parse(JAX_SOURCE.read_text())
    consts = {n.targets[0].id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)}
    assert consts == {k: getattr(driver, k) for k in consts}
    assert set(consts) == {"REPLICAS", "SLOTS", "BUDGET", "PREFILL_CHUNK", "SPEC_K",
                           "LONG_PROMPT", "CHATTY"}


def test_run_passes_and_reports_jax_keys(capsys):
    METRICS.reset()
    report = driver.run(device="cpu")
    want = jax_report_keys(JAX_SOURCE)
    assert set(report) == set(want)
    for key, keys in want.items():
        if keys is not None:
            assert set(report[key]) == keys, key
    assert report["ok"] is True
    assert report["long_prompt"]["chunks"] >= driver.LONG_PROMPT // driver.PREFILL_CHUNK
    assert report["ttft"]["chatty_max_s"] < report["ttft"]["long_s"]
    assert 0 < report["spec"]["accepted"] <= report["spec"]["drafted"]
    assert report["kv_blocks_free_after_drain"] > 0
    json.dumps(report)  # main() prints it as one JSON line
