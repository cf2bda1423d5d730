"""kubeflow_tpu_torch/models/mnist.py and kubeflow_tpu_torch/hpo/trials.py
against kubeflow_tpu/models/mnist.py and kubeflow_tpu/hpo/trials.py, on the
CPU.

``MnistCNN``'s forward in eval mode (f32) is within 1e-5 of flax's on the
same variables and images; in bf16 within 2e-2 (the activations are
rounded to bf16 at the same places; XLA's and PyTorch's sums run in
another order). The trial's training loop, fed JAX's images, labels and
initial variables with dropout 0, gives the JAX ``mnist_objective``'s loss
and accuracy at every step within 1e-4 (five Adam steps in f32).
Dropout draws from JAX's RNG in JAX and from a ``torch.Generator`` in the
port, so the two are compared with dropout off. ``quadratic_objective``
equals JAX's exactly, ``report_fn`` stops both at the same step, and the
port's ``mnist_objective`` completes a StudyJob under the JAX control
plane's ``InProcessTrialRunner``.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.api.meta import new_object
from kubeflow_tpu.controllers.studyjob import STUDY_API, InProcessTrialRunner
from kubeflow_tpu.hpo import trials as jtrials
from kubeflow_tpu.models.mnist import MnistCNN as JMnistCNN
from kubeflow_tpu.platform import build_platform
from kubeflow_tpu_torch.hpo import trials
from kubeflow_tpu_torch.models.convert import resnet_params_from_flax, resnet_params_to_flax
from kubeflow_tpu_torch.models.mnist import MnistCNN

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_images(batch, key=0):
    """``mnist_objective``'s images and labels, drawn as JAX draws them."""
    imgs = jax.random.normal(jax.random.PRNGKey(key), (batch, 28, 28, 1))
    labels = (jnp.abs(imgs).sum((1, 2, 3)) * 7).astype(jnp.int32) % 10
    return np.array(imgs), np.array(labels)


def _pair(width, dropout, jdtype, tdtype, batch=8):
    jm = JMnistCNN(width=width, dropout_rate=dropout, dtype=jdtype)
    images, _ = _jax_images(batch)
    init = jax.jit(lambda rng, x: jm.init(rng, x, train=True))
    variables = _np_tree(init(jax.random.PRNGKey(0), images))
    tm = MnistCNN(width=width, dropout_rate=dropout, dtype=tdtype, device="cpu")
    tm.load_state_dict(resnet_params_from_flax(variables, tm))
    return jm, variables, tm, images


@pytest.mark.parametrize("jdtype,tdtype,tol", [(jnp.float32, torch.float32, 1e-5),
                                               (jnp.bfloat16, torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_forward_matches_flax_in_eval_mode(jdtype, tdtype, tol):
    jm, variables, tm, images = _pair(8, 0.1, jdtype, tdtype)
    want = np.asarray(jm.apply(variables, images, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), train=False)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_tree_names_layouts_and_the_inverse():
    """The port keeps flax's tree, so the ResNet converters carry it both
    ways bit for bit (and a model has no batch_stats)."""
    _, variables, tm, _ = _pair(4, 0.0, jnp.float32, torch.float32)
    assert sorted(variables["params"]) == ["classifier", "conv1", "conv2", "dense"]
    assert tm.conv1.kernel.shape == (3, 3, 1, 4) and tm.dense.kernel.shape == (7 * 7 * 8, 128)
    back = resnet_params_to_flax(tm.state_dict(), tm)
    assert list(back) == ["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(got, want)


def test_init_is_seeded_lecun_normal_with_zero_biases():
    a = MnistCNN(width=16, seed=3, device="cpu")
    b = MnistCNN(width=16, seed=3, device="cpu")
    c = MnistCNN(width=16, seed=4, device="cpu")
    assert all(torch.equal(x, y)
               for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.dense.kernel, c.dense.kernel)
    assert all(float(p.detach().abs().max()) == 0
               for n, p in a.named_parameters() if n.endswith("bias"))
    k = a.dense.kernel.detach()  # truncated at two standard deviations of 1 / fan_in
    std = (1.0 / k.shape[0]) ** 0.5
    assert float(k.std()) == pytest.approx(std, rel=0.05)
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


def test_dropout_is_seeded_and_off_in_eval():
    x = torch.from_numpy(_jax_images(4)[0])
    a = MnistCNN(width=8, dropout_rate=0.5, dtype=torch.float32, seed=1, device="cpu")
    b = MnistCNN(width=8, dropout_rate=0.5, dtype=torch.float32, seed=1, device="cpu")
    with torch.no_grad():
        ta, tb = a(x, train=True), b(x, train=True)
        assert torch.equal(ta, tb)  # the same generator seed, the same masks
        assert not torch.equal(ta, a(x, train=False))
        assert torch.equal(a(x, train=False), b(x, train=False))
    z = MnistCNN(width=8, dropout_rate=0.0, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        assert torch.equal(z(x, train=True), z(x, train=False))


def test_training_matches_jax_mnist_objective():
    """JAX's ``mnist_objective`` (dropout 0, f32) against the port's loop on
    JAX's images, labels and initial variables: every step's loss and
    accuracy within 1e-4."""
    width, batch, steps, lr = 8, 16, 5, 1e-2
    seen = {"jax": [], "port": []}

    def collect(name):
        def report(step, m):
            seen[name].append((step, m["loss"], m["accuracy"]))
            return True
        return report

    jfinal = jtrials.mnist_objective({"lr": lr, "dropout": 0.0, "width": width}, steps=steps,
                                     batch=batch, report_fn=collect("jax"), report_every=1)
    _, _, tm, _ = _pair(width, 0.0, jnp.float32, torch.float32, batch=batch)
    images, labels = _jax_images(batch)
    final = trials._train_trial(tm, torch.from_numpy(images), torch.from_numpy(labels).long(),
                                lr=lr, steps=steps, report_fn=collect("port"), report_every=1)
    assert [s for s, *_ in seen["port"]] == [s for s, *_ in seen["jax"]] == [1, 2, 3, 4]
    for (_, lp, ap), (_, lj, aj) in zip(seen["port"], seen["jax"]):
        assert abs(lp - lj) <= 1e-4 and abs(ap - aj) <= 1e-4
    assert abs(final["loss"] - jfinal["loss"]) <= 1e-4
    assert abs(final["accuracy"] - jfinal["accuracy"]) <= 1e-4
    assert seen["port"][-1][1] < seen["port"][0][1]  # it learns


def test_report_fn_stops_where_jax_stops():
    def stopper(seen):
        def report(step, m):
            seen.append((step, m))
            return step < 10
        return report

    params = {"lr": 1e-2, "dropout": 0.1, "width": 4}
    jseen, tseen = [], []
    jgot = jtrials.mnist_objective(params, steps=30, batch=8, report_fn=stopper(jseen))
    got = trials.mnist_objective(params, steps=30, batch=8, report_fn=stopper(tseen),
                                 device="cpu")
    assert [s for s, _ in tseen] == [s for s, _ in jseen] == [5, 10]
    # the stopping report's metrics are the trial's result, in both
    assert got == tseen[-1][1] and jgot == jseen[-1][1]
    assert set(got) == {"accuracy", "loss"} and all(isinstance(v, float) for v in got.values())
    # no report at the last step: JAX reports only while steps remain
    last = []
    trials.mnist_objective(params, steps=10, batch=8, report_every=5,
                           report_fn=lambda s, m: last.append(s), device="cpu")
    assert last == [5]


def test_mnist_objective_learns_and_reads_params():
    a = trials.mnist_objective({"lr": 1e-2, "dropout": 0.1, "width": 8}, steps=20, batch=16,
                               device="cpu")
    b = trials.mnist_objective({"lr": 1e-2, "dropout": 0.1, "width": 8, "steps": 1}, steps=20,
                               batch=16, device="cpu")
    assert 0.0 <= a["accuracy"] <= 1.0 and np.isfinite(a["loss"])
    assert a["loss"] < b["loss"]  # 20 steps against params' 1
    images, labels = trials._trial_batch(16)
    assert images.shape == (16, 28, 28, 1) and images.dtype == np.float32
    want = (np.abs(images).sum((1, 2, 3)) * 7).astype(np.int32) % 10
    assert np.array_equal(labels, want)


def test_mnist_objective_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trials.mnist_objective({"lr": 1e-2})


@pytest.mark.parametrize("params", [{"lr": 0.1, "width": 32}, {"lr": 1e-3, "width": 8},
                                    {"lr": 0.0}, {}, {"lr": 2.5, "width": 64}])
def test_quadratic_objective_equals_jax(params):
    assert trials.quadratic_objective(params) == jtrials.quadratic_objective(params)


def test_studyjob_completes_with_the_ports_mnist_trials():
    objective = functools.partial(trials.mnist_objective, steps=6, batch=8, device="cpu")
    mgr = build_platform(trial_runner=InProcessTrialRunner(objective)).start()
    try:
        mgr.client.create(new_object(STUDY_API, "StudyJob", "mnist", "team-a", spec={
            "objective": {"type": "maximize", "objectiveMetricName": "accuracy"},
            "algorithm": {"algorithmName": "random"},
            "parallelTrialCount": 2, "maxTrialCount": 3,
            "parameters": [
                {"name": "lr", "parameterType": "double",
                 "feasibleSpace": {"min": "1e-3", "max": "1e-1", "logScale": True}},
                {"name": "width", "parameterType": "int",
                 "feasibleSpace": {"min": "4", "max": "8"}},
            ],
            "trialTemplate": {"image": "kubeflow-tpu/trial-torch:latest"},
        }))
        deadline = time.time() + 60
        status = {}
        while time.time() < deadline:
            status = mgr.client.get(STUDY_API, "StudyJob", "mnist", "team-a").get("status") or {}
            if status.get("phase") == "Completed":
                break
            time.sleep(0.1)
        assert status.get("phase") == "Completed", status
        assert status["trialsSucceeded"] == 3
        assert 0.0 <= status["currentOptimalTrial"]["observation"]["accuracy"] <= 1.0
        runs = mgr.client.list(STUDY_API, "Trial", "team-a")
        assert len(runs) == 3
        # each trial reported its step-5 accuracy through report_fn
        assert all(t["status"].get("observations") for t in runs)
    finally:
        mgr.stop()
