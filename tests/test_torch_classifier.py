"""The port's classifier training step against kubeflow_tpu/training/classifier.py.

The tiny flax ResNet (two stages of two bottlenecks, 8 filters, 32 x 32
images, 10 classes) is initialized by ``ClassifierTask.init``; its
variables are carried into the port, and both take 3 steps of
``sgd_momentum(lr=0.1, total_steps=10)`` on the same numpy batch (lr 0 at
step 0, so the loss first moves at step 3).

Tolerances. The f32 model (fused blocks still round their dots to bf16 on
both sides): losses 1e-5, every parameter and statistic 1e-5 (3e-7 and
1.2e-7 seen: f32 sums in another order). The bf16 model, the bench's
dtype: losses 5e-3 (1.6e-3 seen at step 3, unfused: bf16 activations and
their gradients round in other places in XLA's and PyTorch's CPU
convolutions), parameters not compared.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.resnet import BottleneckBlock as JBlock, ResNet as JResNet
from kubeflow_tpu.training.classifier import ClassifierTask as JTask
from kubeflow_tpu.training.classifier import cross_entropy_loss as j_ce
from kubeflow_tpu.training.classifier import sgd_momentum as j_sgd
from kubeflow_tpu_torch.models import resnet as tr
from kubeflow_tpu_torch.models.convert import resnet_params_from_flax
from kubeflow_tpu_torch.ops import fused_bottleneck as tfb
from kubeflow_tpu_torch.training import classifier as tc
from kubeflow_tpu_torch.training import resnet as trn

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 4).astype(np.int32))


@pytest.mark.parametrize("dtype,fused", [("f32", False), ("f32", True), ("bf16", True)])
def test_three_sgd_steps_match_classifier_task(dtype, fused):
    x, y = _batch()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jm = JResNet(stage_sizes=[2, 2], block_cls=JBlock, num_classes=10, num_filters=8,
                 stem="s2d", fused_blocks=fused, dtype=jdt)
    task = JTask(model=jm, optimizer=j_sgd(lr=0.1, total_steps=10))
    state = jax.jit(task.init)(jax.random.PRNGKey(0), jnp.asarray(x))  # one compile, not one per op
    model = tr.ResNet([2, 2], tr.BottleneckBlock, num_classes=10, num_filters=8, stem="s2d",
                      fused_blocks=fused, dtype=tdt, device="cpu")
    model.load_state_dict(resnet_params_from_flax(
        _np_tree({"params": state.params, "batch_stats": state.batch_stats}), model))
    step = task.make_train_step()
    ttask = tc.ClassifierTask(model, functools.partial(tc.sgd_momentum, lr=0.1, total_steps=10))
    tstate = ttask.init()
    want, got = [], []
    for _ in range(3):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = ttask.train_step(tstate, torch.tensor(x), torch.tensor(y))
        want.append((float(m["loss"]), float(m["accuracy"])))
        got.append((float(tm["loss"]), float(tm["accuracy"])))
    assert tstate.step == 3
    assert got[0][0] == got[1][0]  # lr 0 at step 0: the first update moves no weight
    tol = 1e-5 if dtype == "f32" else 5e-3
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], atol=tol, rtol=0)
    assert [g[1] for g in got] == [w[1] for w in want]
    if dtype == "f32":
        after = resnet_params_from_flax(
            _np_tree({"params": state.params, "batch_stats": state.batch_stats}), model)
        for name, value in model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), after[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
        assert set(tstate.buffers) == {n for n, _ in model.named_buffers()}
    logits = ttask.eval_step(tstate, torch.tensor(x))
    assert logits.shape == (4, 10) and torch.isfinite(logits).all()


def test_schedule_is_optax_warmup_cosine():
    for lr, warmup, total in ((0.1, 0, 1000), (0.1, 0, 10), (0.5, 3, 12)):
        want = optax.warmup_cosine_decay_schedule(0.0, lr, max(warmup, 1), total)
        _, got = tc.sgd_momentum([torch.nn.Parameter(torch.zeros(1))], lr=lr,
                                 warmup_steps=warmup, total_steps=total)
        for step in range(11):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9)
    assert got(0) == 0.0
    _, constant = tc.sgd_momentum([torch.nn.Parameter(torch.zeros(1))], lr=0.3)
    assert constant(0) == constant(7) == 0.3


def test_sgd_pins_optax_decay_momentum_and_nesterov():
    """Weight decay added to the gradient before the momentum, the buffer
    starting at the first gradient, Nesterov's extra momentum term: 4 steps
    of ``add_decayed_weights(1e-4)`` then ``sgd(0.05, 0.9, nesterov=True)``."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(4)]
    opt = optax.chain(optax.add_decayed_weights(1e-4),
                      optax.sgd(learning_rate=0.05, momentum=0.9, nesterov=True))
    params, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.tensor(p0))
    topt, _ = tc.sgd_momentum([param], lr=0.05)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(params), atol=1e-7,
                                   rtol=0)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((5, 7)) * 3).astype(np.float32)
    labels = rng.integers(0, 7, 5)
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tc.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    bf = float(tc.cross_entropy_loss(torch.tensor(logits).to(torch.bfloat16),
                                     torch.tensor(labels)))
    np.testing.assert_allclose(bf, float(j_ce(jnp.asarray(logits, jnp.bfloat16),
                                              jnp.asarray(labels))), atol=1e-6, rtol=0)


def test_train_cli_on_the_cpu(capsys):
    tfb.reset_launches()
    out = trn.train(trn.tiny_config(), steps=3, device="cpu")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["losses"][0] == out["losses"][1]  # lr 0 at step 0
    assert out["images_per_step"] == 4
    assert sum(tfb.LAUNCHES.values()) == 0  # the CPU runs the plain versions
    assert trn.main(["--tiny", "--device", "cpu", "--steps", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [json.loads(line) for line in lines[:3]]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert all({"loss", "accuracy", "step_ms", "images_per_s"} <= set(s) for s in steps)
    assert [s["loss"] for s in steps] == out["losses"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trn.train(trn.tiny_config(), steps=1)  # the default device is the card


def test_bench_config_and_flop_count():
    cfg = trn.bench_config()
    assert (tuple(cfg.stage_sizes), cfg.num_classes, cfg.num_filters, cfg.stem,
            cfg.fused_blocks, cfg.batch, cfg.image, cfg.lr, cfg.total_steps) == (
        (3, 4, 6, 3), 1000, 64, "s2d", True, 256, 224, 0.1, 1000)
    # bench.py's fallback: 3 x 8.2 GFLOP an image
    assert trn.flops_per_step(256) == 3.0 * 8.2e9 * 256


def test_entry_on_the_cpu():
    from kubeflow_tpu_torch.entry import entry

    forward, args = entry(device="cpu", image=32)
    assert args[0].shape == (8, 32, 32, 3)
    logits = forward(*args)
    assert logits.shape == (8, 1000) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
