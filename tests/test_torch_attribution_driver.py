"""kubeflow_tpu_torch/e2e/attribution_driver.py against e2e/attribution_driver.py.

The port's driver runs its four checks (a Chrome trace at
``/debug/profile``, capture-on-demand of fresh steps, a nonzero
``training_step_peak_hbm_bytes`` on ``/metrics``, an attribution report
whose fractions sum to 1 and whose phases rebuild the step within 5%) on
the CPU, keeps JAX's ``STEPS``, ``PHASES``, report keys and exit codes, and
computes JAX's step on the same numbers; on the card the same run passes
(marked ``cuda``).
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.e2e import attribution_driver as drv
from kubeflow_tpu_torch.gpu import profiling as tprof

REPORT_KEYS = {"ok", "steps", "trace_events", "peak_hbm_bytes", "fractions", "step_seconds"}


@pytest.fixture(autouse=True)
def _drop_clock():
    yield
    tprof._PROFILE_CLOCKS.pop("train", None)


def test_constants_are_jax_s():
    import e2e.attribution_driver as jdrv

    assert drv.STEPS == jdrv.STEPS and drv.PHASES == jdrv.PHASES


def test_run_on_the_cpu():
    report = drv.run(device="cpu")
    assert set(report) == REPORT_KEYS
    assert report["ok"] is True and report["steps"] == drv.STEPS + 2
    # STEPS step events + 3 phase events a step
    assert report["trace_events"] == drv.STEPS * (1 + len(drv.PHASES))
    # the meta-run footprint of the step: w and x in, w out, temps between
    assert report["peak_hbm_bytes"] >= (64 * 64 + 32 * 64 + 64 * 64) * 4
    assert sum(report["fractions"].values()) == pytest.approx(1.0, abs=1e-3)
    assert set(report["fractions"]) == {"data_wait", "fused_compute", "unfused_compute",
                                        "other"}


def test_the_step_is_jax_s():
    """The driver's step computes what JAX's jitted step computes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    want = np.asarray(w - 0.01 * jnp.tanh(x @ w).T @ x / x.shape[0])
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    got = (tw - 0.01 * torch.tanh(tx @ tw).T @ tx / tx.shape[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_main_exit_codes(monkeypatch, capsys):
    monkeypatch.setattr(drv, "run", lambda: {"ok": True})
    assert drv.main() == 0
    assert json.loads(capsys.readouterr().out) == {"ok": True}

    def failing():
        raise AssertionError("phase compute: 0 events < 4 steps")

    monkeypatch.setattr(drv, "run", failing)
    assert drv.main() == 1
    assert json.loads(capsys.readouterr().out) == {
        "ok": False, "error": "phase compute: 0 events < 4 steps"}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drv.run()


@pytest.mark.cuda
def test_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the driver's default device is the card")
    report = drv.run(device="cuda")
    assert report["ok"] is True and report["peak_hbm_bytes"] > 0
