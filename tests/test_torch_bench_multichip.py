"""kubeflow_tpu_torch/bench.py's multichip row against the root bench.py's, on the CPU.

JAX's ``_bench_multichip`` runs over this process's 8 virtual devices at
``tests/test_multichip.py``'s shapes (d 32, ff 64, 8 layers, seq 32,
vocab 128, 8 microbatches of 8, 2 steps, 1 window); the port's through
``python -m kubeflow_tpu_torch.bench --model multichip --device cpu
--tiny``, the same shapes in an 8-rank gloo world. The factorization, the
schedule, the gather mode, the bubble fractions, the analytic comm bytes
and FLOPs are equal; the key set is JAX's; the loss is finite and the
weak-scaling efficiency positive.
"""

import contextlib
import io
import json
import math

import pytest

from kubeflow_tpu_torch import bench as tb

JAX_ENV = {"BENCH_MC_DMODEL": "32", "BENCH_MC_FF": "64", "BENCH_MC_LAYERS": "8",
           "BENCH_MC_SEQ": "32", "BENCH_MC_VOCAB": "128", "BENCH_MC_MICRO": "8",
           "BENCH_MC_MB": "8", "BENCH_MC_STEPS": "2", "BENCH_REPEATS": "1"}
OVERRIDES = ("BENCH_MC_PP", "BENCH_MC_TP", "BENCH_MC_FSDP")


def test_tiny_settings_are_the_jax_tests():
    d = dict(tb.MULTICHIP_DEFAULTS, **tb.TINY_MULTICHIP)
    assert (d["d_model"], d["d_ff"], d["n_layers"], d["seq"], d["vocab"], d["num_micro"],
            d["microbatch"], d["timed_steps"], d["repeats"]) == tuple(
        int(JAX_ENV[k]) for k in ("BENCH_MC_DMODEL", "BENCH_MC_FF", "BENCH_MC_LAYERS",
                                  "BENCH_MC_SEQ", "BENCH_MC_VOCAB", "BENCH_MC_MICRO",
                                  "BENCH_MC_MB", "BENCH_MC_STEPS", "BENCH_REPEATS"))


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_sizes_equal_jax(monkeypatch, n):
    import bench as jbench

    for name in OVERRIDES:
        monkeypatch.delenv(name, raising=False)
    assert tb._multichip_mesh_sizes(n) == jbench._multichip_mesh_sizes(n)
    monkeypatch.setenv("BENCH_MC_PP", "1")
    assert tb._multichip_mesh_sizes(n, pp=1) == jbench._multichip_mesh_sizes(n)


@pytest.fixture(scope="module")
def jax_multichip():
    import bench as jbench

    with pytest.MonkeyPatch.context() as mp:
        for name in OVERRIDES + ("BENCH_PP_VIRTUAL", "BENCH_GATHER_MODE", "BENCH_MC_1CHIP"):
            mp.delenv(name, raising=False)
        for k, v in JAX_ENV.items():
            mp.setenv(k, v)
        raw = jbench._bench_multichip()
        mp.setattr(jbench, "_bench_multichip", lambda: raw)
        return raw, jbench._run_multichip("cpu")


@pytest.fixture(scope="module")
def port_multichip():
    """``main`` at ``--model multichip``; a spy on ``multichip_row`` keeps
    the raw result."""
    seen = {}
    row_of = tb.multichip_row

    def spy(r, platform):
        seen["raw"] = r
        return row_of(r, platform)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(tb, "multichip_row", spy)
        rc = tb.main(["--model", "multichip", "--device", "cpu", "--tiny"])
    return rc, json.loads(out.getvalue().splitlines()[-1]), seen["raw"]


def test_main_runs_the_eight_rank_world(port_multichip):
    rc, row, raw = port_multichip
    assert rc == 0 and "error" not in row, row
    assert row["n_devices"] == 8 and raw["device"] == "cpu"
    assert row["platform"] == "cpu" and row["vs_baseline"] is None
    assert row["value"] > 0


def test_analytic_fields_equal_jax(port_multichip, jax_multichip):
    _, row, raw = port_multichip
    jraw, jrow = jax_multichip
    for key in ("metric", "mesh", "virtual_stages", "gather_mode", "bubble_fraction",
                "bubble_fraction_gpipe", "comm_bytes_per_step", "num_micro", "microbatch",
                "n_devices"):
        assert row[key] == jrow[key], key
    assert raw["flops_per_step"] == jraw["flops_per_step"]
    assert raw["microbatch_1chip"] == jraw["microbatch_1chip"]
    assert row["bubble_fraction"] < row["bubble_fraction_gpipe"]


def test_key_set_equals_jax(port_multichip, jax_multichip):
    _, row, _ = port_multichip
    _, jrow = jax_multichip
    assert set(row) == set(jrow)
    assert set(row["step_breakdown"]) == set(jrow["step_breakdown"])
    assert set(row["comm_bytes_per_step"]) == {"pipe", "fsdp", "model", "data", "total"}


def test_loss_and_scaling(port_multichip):
    _, row, raw = port_multichip
    assert math.isfinite(row["loss"]) and row["loss"] > 0
    assert row["scaling_efficiency"] > 0 and row["tokens_per_sec_1chip"] > 0
    assert row["step_breakdown"]["device_compute_s_per_step"] > 0
    fractions = row["attribution"]["fractions"]
    assert abs(sum(fractions.values()) - 1.0) < 1e-3 and fractions["fused_compute"] == 0.0


@pytest.mark.parametrize("virtual_stages", [1, 2])
def test_settings_reach_the_world(virtual_stages):
    """``run_multichip``'s settings reach every rank: a GPipe run and the
    interleaved default at 2 ranks, each with its own schedule."""
    row = tb.run_multichip(2, device="cpu", **dict(tb.TINY_MULTICHIP,
                                                   virtual_stages=virtual_stages))
    assert "error" not in row, row
    assert row["metric"] == "multichip_composite_tokens_per_sec_per_chip_2dev"
    assert row["mesh"] == {"pipe": 2, "model": 1, "fsdp": 1, "data": 1}
    assert row["virtual_stages"] == virtual_stages
    assert (row["bubble_fraction"] == row["bubble_fraction_gpipe"]) == (virtual_stages == 1)


def test_unknown_settings_give_the_error_row():
    bad = tb.run_multichip(2, device="cpu", layers=4)
    assert bad["value"] == 0.0 and "unknown multichip settings" in bad["error"]
