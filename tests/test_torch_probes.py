"""The port's device-evidence probes against the JAX probes in e2e/.

Each row function runs at toy shapes with ``device="cpu"`` (host-clock
times of the CPU: only the keys and the accounting are checked, never a
rate). FLOP and byte counts must equal the JAX probes' formulas for the
same shapes exactly; where a JAX row can run on the CPU (matmul, conv) its
own ``tflops * iter_s`` is the reference. The fused-probe chain body (the
block, then ``* bf16(0.97)``) is held against the JAX body on the same
inputs within 1e-2 of the output's largest magnitude: the port's plain block
rounds h1 and h2 to bf16 at the same places as JAX's composite and differs
only in f32 sum order, which can flip one bf16 rounding (one ULP).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.e2e import ceiling, fused_bottleneck_probe as fbp, gpt_profile
from kubeflow_tpu_torch.e2e import profile_step
from kubeflow_tpu_torch.models.gpt import GptConfig
from kubeflow_tpu_torch.ops import stream_copy as sc
from kubeflow_tpu_torch.training.gpt import bench_config

torch.set_num_threads(1)

jfb = importlib.import_module("kubeflow_tpu.ops.fused_bottleneck")


def _jax_e2e(name):
    """``e2e.<name>``; ``e2e.ceiling`` points JAX's persistent compilation
    cache at a directory when imported — the settings are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module(f"e2e.{name}")
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


jceil = _jax_e2e("ceiling")
jprobe = _jax_e2e("fused_bottleneck_probe")


def _flops(row):
    return row["tflops"] * 1e12 * row["iter_s"]


def test_ceiling_rows_keys_and_flops_match_jax():
    m = ceiling.matmul_sustained(32, iters=1, chain=2, device="cpu")
    c = ceiling.conv_sustained(2, 8, 16, 8, iters=1, chain=2, device="cpu")
    assert set(m) == set(c) == {"kernel", "tflops", "iter_s"}
    jm, jc = jceil.matmul_sustained(32, iters=1), jceil.conv_sustained(2, 8, 16, 8, iters=1)
    assert (m["kernel"], c["kernel"]) == (jm["kernel"], jc["kernel"])
    assert _flops(m) == pytest.approx(_flops(jm), rel=1e-9)
    assert _flops(c) == pytest.approx(_flops(jc), rel=1e-9)


def test_flash_row_keys_and_flops_match_jax():
    r = ceiling.flash_seq_sustained(1, 64, heads=2, head_dim=32, iters=1, chain=1, device="cpu")
    assert set(r) == {"kernel", "tflops", "iter_s"} and r["kernel"] == "flash_attn_fwd_bwd_b1_L64"
    want = 3.5 * 2.0 * jceil.b_h_l2_d(1, 2, 64, 32)
    assert ceiling.flash_flops(1, 64, 2, 32) == want
    assert _flops(r) == pytest.approx(want, rel=1e-9)
    assert [tuple(s) for s in ceiling.FLASH_SHAPES] == [(8, 1024), (4, 2048), (2, 4096),
                                                         (1, 8192)]


def test_triad_counts_the_bytes_of_its_own_launches():
    r = ceiling.hbm_triad(mib=1, iters=1, chain=3, device="cpu")
    assert set(r) == {"kernel", "gbs", "iter_s"} and r["kernel"] == "hbm_triad_f32_1MiB"
    n = 1024 * 1024 // 4
    assert r["gbs"] * 1e9 * r["iter_s"] == pytest.approx(5 * 3 * n * 4, rel=1e-9)
    assert ceiling.TRIAD_PASSES == 5  # abs: 2 passes, add: 3 (XLA's fused chain: 3 in all)


def test_probe_inputs_match_jax_bit_for_bit():
    """The port's ``inputs`` draw what the JAX probe's ``_inputs`` draws, at
    toy shapes (the same expressions as ``_inputs``, in JAX)."""
    n, hw, cin, cmid = 2, 8, 32, 16
    rng = np.random.RandomState(0)
    jx = jnp.asarray(rng.randn(n, hw, hw, cin), jnp.bfloat16) * 0.3
    jw = [jnp.asarray(rng.randn(cin, cmid) * 0.05, jnp.bfloat16),
          jnp.asarray(rng.randn(3, 3, cmid, cmid) * 0.05, jnp.bfloat16),
          jnp.asarray(rng.randn(cmid, cin) * 0.05, jnp.bfloat16)]
    x, w = fbp.inputs(n, hw, cin, cmid, device="cpu")
    for got, want in zip([x, w[0], w[3], w[6]], [jx] + jw):
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    norms = [jnp.ones(cmid), jnp.zeros(cmid) + 0.01, jnp.ones(cmid) * 1.1,
             jnp.zeros(cmid) - 0.01, jnp.ones(cin) * 0.9, jnp.zeros(cin)]
    for got, want in zip([w[1], w[2], w[4], w[5], w[7], w[8]], norms):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(want))


def test_chain_body_matches_jax():
    x, w = fbp.inputs(2, 8, 32, 16, device="cpu")
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jw = [jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                      else jnp.float32) for t in w]
    want = np.asarray((jfb.reference_bottleneck(jx, *jw) * jnp.bfloat16(0.97))
                      .astype(jnp.bfloat16), np.float32)
    from kubeflow_tpu_torch.ops.fused_bottleneck import fused_bottleneck, reference_bottleneck

    for fn in (reference_bottleneck, fused_bottleneck):
        got = fbp.chain_step(fn, x, w)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * np.abs(want).max(), err


def test_probe_rows_keys_and_accounting():
    x, w = fbp.inputs(2, 8, 32, 16, device="cpu")
    sc.reset_launches()
    rows = fbp.probe_rows(x, w, chain=1, iters=1, copy_block=(16, 32), bm=16)
    assert [r["probe"] for r in rows] == ["torch_composite", "fused_cuda", "torch_mul_2d",
                                          "stream_copy_2d", "stream_copy_4d", "stream_copy_dma"]
    assert all(set(r) == {"probe", "ms_per_pass", "tflops"} for r in rows[:2])
    assert all(set(r) == {"probe", "ms_per_pass", "gbps_rw"} for r in rows[2:])
    assert sc.LAUNCHES == {"stream_copy": 0, "stream_copy_dma": 0}  # the CPU: plain
    # the JAX probe's accounting at its own shapes
    assert fbp.block_flops() == 2.0 * jprobe.N * jprobe.HW * jprobe.HW * (
        jprobe.CIN * jprobe.CMID + 9 * jprobe.CMID * jprobe.CMID + jprobe.CMID * jprobe.CIN)
    assert (fbp.N, fbp.HW, fbp.CIN, fbp.CMID) == (jprobe.N, jprobe.HW, jprobe.CIN, jprobe.CMID)
    flat = torch.zeros(jprobe.N * jprobe.HW * jprobe.HW // 64, jprobe.CIN, dtype=torch.bfloat16)
    assert fbp.copy_bytes(flat) == 2 * (flat.numel() * 2)  # gbps_rw = 2 * nbytes / dt
    r = rows[2]
    assert r["gbps_rw"] * 1e9 * r["ms_per_pass"] / 1e3 == pytest.approx(fbp.copy_bytes(
        x.view(-1, 32)), rel=1e-9)


def test_profile_step_rows():
    out = profile_step.profile(2, 1, image=32, stage_sizes=(1, 1), num_filters=8,
                               num_classes=10, device="cpu")
    assert out["batch"] == 2
    assert list(out["seconds"]) == ["fwd_eval", "fwd_train", "fwd_bwd", "full_step"]
    assert all(v > 0 for v in out["seconds"].values())
    d = profile_step.deltas(out["seconds"])
    assert set(d) == {"bn_stats", "backward", "optimizer"}
    assert d["optimizer"] == out["seconds"]["full_step"] - out["seconds"]["fwd_bwd"]


def test_gpt_profile_rows_and_jax_formulas():
    cfg = GptConfig.tiny()
    rows = gpt_profile.profile(2, 32, 1, cfg=cfg, device="cpu")
    assert [r["phase"] for r in rows] == ["block (x1)", "embed+head+loss", "adamw update"]
    assert set(rows[0]) == {"phase", "ms", "tflops", "x24_ms"}
    assert set(rows[1]) == {"phase", "ms", "tflops"}
    assert set(rows[2]) == {"phase", "ms", "gb_moved"}
    # e2e/gpt_profile.py's formulas, at the bench shapes
    big, batch, seq = bench_config(1024), 8, 1024
    proj = 4 * 2.0 * batch * seq * big.d_model * big.d_model
    mlp = 2 * 2.0 * batch * seq * big.d_model * big.d_ff
    attn = 2 * 2.0 * batch * big.n_heads * seq * seq * big.head_dim / 2
    assert gpt_profile.block_flops(big, batch, seq) == 3.0 * (proj + mlp + attn)
    assert gpt_profile.head_flops(big, batch, seq) == 3.0 * (
        2.0 * batch * seq * big.d_model * big.vocab_size)
    assert gpt_profile.adamw_gb(334_858_240) == round(334_858_240 * 4 * 7 / 1e9, 2)


def test_kv_update_probe_imports_without_jax():
    """The KV-write probe is the port's own: importing it loads no JAX and
    nothing of the JAX package or its e2e probes."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "import kubeflow_tpu_torch.e2e.kv_update_probe\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax',"
            " 'kubeflow_tpu', 'e2e')]\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kv_update_probe_rows_at_toy_shapes():
    from kubeflow_tpu_torch.e2e import kv_update_probe as kvp

    iso = kvp.isolated(contig=(2, 16, 2, 8), paged=(2, 64, 2, 8, 16), iters=2, device="cpu")
    assert list(iso) == ["where_select_ms", "index_put_ms", "kv_row_update_ms",
                         "kv_row_update_x2_ms", "kv_row_update_pair_ms", "row_replaced_x2_ms",
                         "kv_block_update_x2_ms", "kv_block_update_pair_ms",
                         "block_replaced_x2_ms"]
    for name in ("row_replaced_x2_ms", "block_replaced_x2_ms"):
        assert iso.pop(name) is None  # the replaced kernels run only on the card
    assert all(ms > 0 for ms in iso.values())
    rows = kvp.in_model(cfg=GptConfig.tiny(), slots=2, chunks=1, start=4, device="cpu")
    names = ("shared_cursor", "per_slot_plain", "per_slot_kernel", "paged_plain",
             "paged_kernel")
    assert set(rows) == {f"{n}_ms_per_{u}" for n in names for u in ("chunk", "token")}
    assert all(rows[f"{n}_ms_per_token"] * kvp.CHUNK == pytest.approx(
        rows[f"{n}_ms_per_chunk"]) for n in names)
    assert kvp.medium_config().n_layers == 24 and kvp.medium_config().max_seq == 352
