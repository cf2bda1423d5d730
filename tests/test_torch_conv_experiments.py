"""kubeflow_tpu_torch/e2e/conv_experiments.py against e2e/conv_experiments.py,
on the CPU.

The probe names and their order are JAX's. Each probe's chain step, at
tiny shapes in f32, equals the JAX body's arithmetic (``lax.dot``,
``lax.conv_general_dilated`` with SAME padding, ``jax.grad`` of the same
losses) on the same inputs within 1e-5 of the result's largest magnitude
(f32 sums in another order). Each FLOP count equals JAX's own expression,
evaluated from its source at every probe's shapes, and a probe's row
reports it (``tflops * iter_s``).
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.e2e import conv_experiments as ce

torch.set_num_threads(1)

JAX_SOURCE = Path(__file__).resolve().parents[1] / "e2e" / "conv_experiments.py"
TOL = 1e-5


def _jax_e2e(name):
    """``e2e.<name>``, putting back the compilation-cache settings its
    import changes."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module(f"e2e.{name}")
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


jce = _jax_e2e("conv_experiments")


def _rng(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-30)


def _conv(x, k, stride=1):
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape, ("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(x, k, (stride, stride), "SAME", dimension_numbers=dn)


def test_probe_names_equal_jax():
    assert list(ce.PROBES) == list(jce.PROBES)
    assert (ce.B, ce.HW, ce.C, ce.M, ce.K) == (jce.B, jce.HW, jce.C, jce.M, jce.K)
    assert ce.ITERS == jce.ITERS and ce.CHAIN == jce.CHAIN


def test_gemm_and_tap_dot_steps():
    x, w, proj = _rng(12, 9, seed=1), _rng(9, 4, seed=2), _rng(4, 9, seed=3)
    want = jnp.abs(jax.lax.dot(jax.lax.dot(x, w), proj)) * 0.05
    _close(ce.gemm_step(*map(torch.tensor, (x, w, proj))), want)
    xt, w9 = _rng(4, 20, seed=4), _rng(9, 4, 4, seed=5)
    y = jnp.zeros((4, 20), jnp.float32)
    for t in range(9):
        y = y + jax.lax.dot(w9[t].T, xt, preferred_element_type=jnp.float32)
    _close(ce.tap_dots_step(torch.tensor(xt), torch.tensor(w9)), jnp.abs(y) * 0.05)


@pytest.mark.parametrize("hw, cin, cout, ksz, stride, fuse", [
    (8, 4, 4, 3, 1, False), (8, 4, 4, 3, 1, True), (16, 3, 8, 7, 2, False),
    (8, 12, 8, 4, 1, False), (9, 3, 4, 3, 2, False)],
    ids=["conv3x3", "conv3x3_bn_relu", "stem7x7_s2", "s2d4x4", "odd_s2"])
def test_conv_step(hw, cin, cout, ksz, stride, fuse):
    x, k = _rng(2, hw, hw, cin, seed=1), _rng(ksz, ksz, cin, cout, seed=2, scale=0.05)
    proj = _rng(1, 1, cout, cin, seed=3, scale=0.05)
    scale, bias = _rng(cout, seed=4, scale=0.1), _rng(cout, seed=5, scale=0.1)
    y = _conv(x, k, stride)
    if fuse:
        y = jnp.maximum(y * scale + bias, 0.0)
    z = _conv(y, proj) * (1.0 / hw)
    if stride != 1:
        z = jnp.repeat(jnp.repeat(z, stride, 1), stride, 2)
    got = ce.conv_step(*map(torch.tensor, (x, k, proj, scale, bias)), stride, hw, fuse)
    if stride != 1 and hw % stride:  # repeated back to more than hw: same on both sides
        assert got.shape[1] == z.shape[1] == -(-hw // stride) * stride
    _close(got, jnp.abs(z))


@pytest.mark.parametrize("which", ["x", "w", "both"])
def test_conv_grad_step(which):
    x, k = _rng(2, 6, 6, 4, seed=1), _rng(3, 3, 4, 4, seed=2, scale=0.05)

    def loss(x, k):
        return jnp.sum(jnp.abs(_conv(x, k).astype(jnp.float32)))

    tiny = jnp.float32(1e-30)
    if which == "x":
        want = jnp.abs(jax.grad(loss, argnums=0)(x, k)) * 0.01
    elif which == "w":
        want = x * (1.0 + jnp.sum(jnp.abs(jax.grad(loss, argnums=1)(x, k))) * tiny)
    else:
        dx, dw = jax.grad(loss, argnums=(0, 1))(x, k)
        want = jnp.abs(dx) * 0.01 + jnp.sum(jnp.abs(dw)) * tiny
    _close(ce.conv_grad_step(torch.tensor(x), torch.tensor(k), which), want)
    # the 1x1 probe's step is the same with a 1x1 kernel
    k1 = _rng(1, 1, 4, 3, seed=6, scale=0.05)
    if which == "both":
        x3 = _rng(2, 6, 6, 4, seed=7)
        dx, dw = jax.grad(loss, argnums=(0, 1))(x3, k1)
        _close(ce.conv_grad_step(torch.tensor(x3), torch.tensor(k1), "both"),
               jnp.abs(dx) * 0.01 + jnp.sum(jnp.abs(dw)) * tiny)


def test_block_step():
    x = _rng(1, 6, 6, 8, seed=1, scale=0.1)
    p = {"k1": _rng(1, 1, 8, 4, seed=2, scale=0.05), "k2": _rng(3, 3, 4, 4, seed=3, scale=0.05),
         "k3": _rng(1, 1, 4, 8, seed=4, scale=0.05),
         "s1": _rng(4, seed=5), "b1": _rng(4, seed=6), "s2": _rng(4, seed=7),
         "b2": _rng(4, seed=8), "s3": _rng(8, seed=9), "b3": _rng(8, seed=10)}

    def block(x, p):
        y = jnp.maximum(_conv(x, p["k1"]) * p["s1"] + p["b1"], 0)
        y = jnp.maximum(_conv(y, p["k2"]) * p["s2"] + p["b2"], 0)
        y = _conv(y, p["k3"]) * p["s3"] + p["b3"]
        return jnp.maximum(x + y, 0)

    def loss(x, p):
        return jnp.sum(jnp.abs(block(x, p).astype(jnp.float32)))

    dx, dp = jax.grad(loss, argnums=(0, 1))(x, p)
    dpsum = sum(jnp.sum(jnp.abs(g)) for g in jax.tree_util.tree_leaves(dp))
    want = jnp.abs(dx) * 0.05 + dpsum * jnp.float32(1e-30)
    got = ce.block_step(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()})
    _close(got, want)
    _close(ce.block(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()}), block(x, p))


def _jax_flops(func, **names):
    """JAX's FLOP statements of ``func`` (every assignment to ``conv_f`` or
    ``flops``, in order) evaluated with ``names`` and the module's
    constants."""
    tree = ast.parse(JAX_SOURCE.read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    stmts = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Name) and n.targets[0].id in ("conv_f", "flops")]
    ns = dict(B=jce.B, HW=jce.HW, C=jce.C, M=jce.M, K=jce.K, **names)
    exec(compile(ast.Module(stmts, []), func, "exec"), ns)
    return ns["flops"]


def test_flop_formulas_equal_jax():
    m, k, c = jce.M, jce.K, jce.C
    assert ce.gemm_flops(m, k, c) == _jax_flops("_gemm_probe", m=m, k=k, n=c)
    assert ce.gemm_flops(c, k, m) == _jax_flops("_gemm_probe", m=c, k=k, n=m)
    assert ce.tap_dots_flops() == _jax_flops("gemm_tap_dots")
    for args in ((256, 56, 64, 64, 3, 1), (256, 224, 3, 64, 7, 2), (256, 112, 12, 64, 4, 1)):
        b, hw, cin, cout, ksz, stride = args
        assert ce.conv_flops(*args) == _jax_flops(
            "_conv_probe", batch=b, hw=hw, cin=cin, cout=cout, ksz=ksz, stride=stride,
            ohw=hw // stride)
    for which, cin, hw in (("x", 64, 56), ("w", 64, 56), ("both", 64, 56), ("both", 128, 28)):
        assert ce.conv_grad_flops(which, cin, hw) == _jax_flops(
            "_conv_bwd_probe", which=which, cin=cin, hw=hw)
    for cin, cout in ((256, 64), (64, 256)):
        assert ce.conv1x1_flops(cin, cout) == _jax_flops(
            "_conv1x1_bwd_probe", cin=cin, cout=cout, hw=56)
    assert ce.block_flops() == _jax_flops("bottleneck_block_fwd_bwd")


def test_rows_report_their_flops():
    kw = dict(iters=1, chain=2, device="cpu")
    rows = [(ce._gemm_probe(12, 9, 4, "g", **kw), ce.gemm_flops(12, 9, 4)),
            (ce.gemm_tap_dots(c=4, m=20, **kw), ce.tap_dots_flops(4, 20)),
            (ce._conv_probe(2, 8, 4, 4, 3, 1, "c", fuse_bn_relu=True, **kw),
             ce.conv_flops(2, 8, 4, 4, 3, 1)),
            (ce._conv_probe(2, 16, 3, 8, 7, 2, "s", **kw), ce.conv_flops(2, 16, 3, 8, 7, 2)),
            (ce._conv_bwd_probe("both", 4, 6, batch=2, **kw),
             ce.conv_grad_flops("both", 4, 6, 2)),
            (ce._conv1x1_bwd_probe(8, 4, 6, batch=2, **kw), ce.conv1x1_flops(8, 4, 6, 2)),
            (ce.bottleneck_block_fwd_bwd(batch=1, hw=6, **kw), ce.block_flops(hw=6, batch=1))]
    for row, flops in rows:
        assert set(row) == {"kernel", "tflops", "iter_s"}
        assert row["tflops"] * 1e12 * row["iter_s"] == pytest.approx(flops, rel=1e-9)


def test_run_probes_records_a_failure_and_goes_on(monkeypatch, capsys):
    monkeypatch.setitem(ce.PROBES, "conv_xla", lambda **kw: 1 / 0)
    monkeypatch.setitem(ce.PROBES, "conv_stem", lambda **kw: {"kernel": "k", "tflops": 1.0,
                                                             "iter_s": 1.0})
    rows = ce.run_probes(["conv_xla", "conv_stem"])
    assert rows[0]["kernel"] == "conv_xla" and rows[0]["tflops"] == 0.0
    assert "division by zero" in rows[0]["error"] and rows[1]["kernel"] == "k"
    assert "ERROR" in capsys.readouterr().out
