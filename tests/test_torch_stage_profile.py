"""kubeflow_tpu_torch/e2e/stage_profile.py against e2e/stage_profile.py, on the CPU.

``StemTower`` (both stems) and ``StageTower`` (train, eval and frozen
norms; a stride-1 stage head as stage 1 has, a stride-2 one as stages 2-4
have) at tiny shapes on weights carried from the flax towers: the forward
in train mode, and the gradients of ``sum(out) * 1e-6`` with respect to
every parameter and the input, as JAX's ``time_tower`` takes them. Both
sides compute in bf16 with f32 parameters, so they differ by bf16
roundings in another order: the output within 2e-2 of its largest
magnitude, each gradient within 2e-2 of its own, a frozen norm's scale
and bias gradients (bf16 sums over every pixel on both sides) within
6e-2. Then ``time_tower``'s
counted FLOPs equal three times the convolutions' forward products (the
forward, the input gradient and the weight gradient), and ``profile``
keeps JAX's row keys and flags.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.e2e import stage_profile as sp
from kubeflow_tpu_torch.models.convert import resnet_params_from_flax
from kubeflow_tpu_torch.models.resnet import Conv

torch.set_num_threads(1)

#: the output's and each gradient's tolerance, of its largest magnitude; a
#: frozen norm's scale and bias gradients are bf16 sums over every pixel on
#: both sides (seen: up to 3.9e-2; the rest up to 1.1e-2)
OUT_TOL, GRAD_TOL, FROZEN_NORM_TOL = 2e-2, 2e-2, 6e-2


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


jsp = _jax_e2e("stage_profile")

#: (id, flax tower, port tower, input shape)
TOWERS = [
    ("stem_conv7x7", lambda: jsp.StemTower(stem="conv7x7"),
     lambda: sp.StemTower("conv7x7", device="cpu"), (2, 16, 16, 3)),
    ("stem_s2d", lambda: jsp.StemTower(stem="s2d"),
     lambda: sp.StemTower("s2d", device="cpu"), (2, 16, 16, 3)),
] + [
    (f"stage_{name}_{norm}", (lambda f=f, b=b, s=s, norm=norm: jsp.StageTower(f, b, s, norm)),
     (lambda c=c, f=f, b=b, s=s, norm=norm: sp.StageTower(c, f, b, s, norm, device="cpu")), shape)
    for name, c, f, b, s, shape, norm in (
        ("head_s1", 8, 8, 2, 1, (2, 8, 8, 8), "train"),
        ("head_s1", 8, 8, 1, 1, (2, 8, 8, 8), "frozen"),
        ("head_s2", 32, 8, 1, 2, (2, 8, 8, 32), "train"),
        ("head_s2", 32, 8, 1, 2, (2, 8, 8, 32), "eval"))
]


def _x(shape):
    return np.random.default_rng(1).standard_normal(shape).astype(np.float32)


def _carried(jtower, ttower, x):
    variables = jtower.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ttower.load_state_dict(resnet_params_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(variables)), ttower))
    return variables


def _jax_fwd_bwd(module, variables, x):
    """JAX ``time_tower``'s ``fwd_bwd``: train mode, batch statistics
    mutable, gradients with respect to the parameters and the input."""
    batch_stats = variables.get("batch_stats", {})

    def loss_fn(p, xx):
        out, _ = module.apply({"params": p, "batch_stats": batch_stats}, xx, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32)) * 1e-6, out

    (loss, out), grads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    return loss, out, grads


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max error {err} > {tol} x {scale}"


@pytest.mark.parametrize("name, jtower, ttower, shape", TOWERS, ids=[t[0] for t in TOWERS])
def test_tower_forward_and_gradients_match_flax(name, jtower, ttower, shape):
    jm, tm = jtower(), ttower()
    x = _x(shape)
    variables = _carried(jm, tm, x)
    loss, out, (gparams, gx) = _jax_fwd_bwd(jm, variables, x)
    with torch.no_grad():
        got_out = tm(torch.tensor(x), train=True)
    assert got_out.dtype == torch.bfloat16
    _close(got_out, jnp.asarray(out, jnp.float32), OUT_TOL, f"{name} out")
    got_loss, grads = sp.fwd_bwd(tm, torch.tensor(x))
    assert float(got_loss.detach()) == pytest.approx(float(loss), rel=2e-2, abs=1e-7)
    params = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert len(grads) == len(params) + 1
    want = resnet_params_from_flax({"params": jax.tree_util.tree_map(np.asarray, gparams)}, tm)
    for pname, g in zip(params, grads):
        frozen_norm = name.endswith("frozen") and ".bn" in pname
        _close(g, want[pname].numpy(), FROZEN_NORM_TOL if frozen_norm else GRAD_TOL,
               f"{name} d{pname}")
    _close(grads[-1], gx, GRAD_TOL, f"{name} dx")


def _conv_flops(module, x):
    """2 x the multiply-adds of every convolution's forward, from the
    output shapes a forward hook sees."""
    total = []

    def hook(m, inputs, out):
        kh, kw, cin, cout = m.kernel.shape
        n, ho, wo, _ = out.shape
        total.append(2 * n * ho * wo * kh * kw * cin * cout)

    handles = [m.register_forward_hook(hook) for m in module.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        module(x, train=True)
    for h in handles:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("name, jtower, ttower, shape", TOWERS[:3] + TOWERS[4:5],
                         ids=[t[0] for t in TOWERS[:3] + TOWERS[4:5]])
def test_counted_flops_are_the_convolutions_forward_and_backward(name, jtower, ttower, shape):
    tm = ttower()
    x = torch.tensor(_x(shape))
    row = sp.time_tower(tm, shape, steps=1, device="cpu")
    assert set(row) == {"ms", "tflops", "gflops"}
    assert row["gflops"] * 1e9 == pytest.approx(3 * _conv_flops(tm, x), rel=1e-12)


def test_profile_rows_and_flags(capsys):
    out = sp.profile(batch=1, steps=1, stages=["stage4"], device="cpu")
    assert [r["stage"] for r in out["rows"]] == ["stage4 (3x bottleneck 512, 7x7)"]
    assert set(out) == {"metric", "batch", "stem", "rows", "sum_ms"}
    assert out["metric"] == "resnet_stage_profile" and out["stem"] == "conv7x7"
    assert set(out["rows"][0]) == {"stage", "ms", "tflops", "gflops"}
    assert "sum of stages" in capsys.readouterr().out
    names = [n for n, _, _ in sp.towers(4)]
    assert names == ["stem", "stage1 (3x bottleneck 64, 56x56)",
                     "stage2 (4x bottleneck 128, 28x28)", "stage3 (6x bottleneck 256, 14x14)",
                     "stage4 (3x bottleneck 512, 7x7)"]
    assert [s for _, _, s in sp.towers(4)] == [(4, 224, 224, 3), (4, 56, 56, 64),
                                               (4, 56, 56, 256), (4, 28, 28, 512),
                                               (4, 14, 14, 1024)]
    with pytest.raises(SystemExit):
        sp.main(["--norm", "nope"])
