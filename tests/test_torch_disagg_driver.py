"""kubeflow_tpu_torch/e2e/disagg_driver.py against e2e/disagg_driver.py, on the CPU.

``run(device="cpu")`` drives the whole scenario over real HTTP (two models
over prefill and decode pools, int8 KV over the wire, a long-prefill
burst, the int8 arena's bytes, a decode-replica drain) with JAX's
constants, asserts everything JAX's driver asserts, and reports JAX's
keys, read from the JAX driver's source.
"""

import ast
import json
from pathlib import Path

from kubeflow_tpu_torch.e2e import disagg_driver as driver
from kubeflow_tpu_torch.runtime.metrics import METRICS
from test_torch_paged_kv_driver import jax_report_keys

JAX_SOURCE = Path(__file__).resolve().parents[1] / "e2e" / "disagg_driver.py"


def test_constants_equal_jax():
    tree = ast.parse(JAX_SOURCE.read_text())
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value, (ast.Constant, ast.Dict))}
    assert consts == {k: getattr(driver, k) for k in consts}
    assert set(consts) == {"POOLS", "SLOTS", "BUDGET", "PREFILL_CHUNK", "LONG_PROMPT",
                           "LONG_BURST", "CHATTY"}


def test_run_passes_and_reports_jax_keys():
    # the handoff histograms are read whole: start from an empty registry
    METRICS.reset()
    report = driver.run(device="cpu")
    want = jax_report_keys(JAX_SOURCE)
    assert set(report) == set(want)
    for key, keys in want.items():
        if keys is not None:
            assert set(report[key]) == keys, key
    assert report["parity"] == {"requests": 8, "models": ["alpha", "beta"]}
    assert report["handoff"]["pool_replicas"] == {"prefill": 1, "decode": 2}
    assert report["int8_hbm"]["slots_per_byte_gain"] >= 1.8
    assert report["drain"]["requests"] == 6
    json.dumps(report)
