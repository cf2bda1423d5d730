"""``ClassifierTask(mesh, rules)`` of the port against kubeflow_tpu/training/classifier.py.

JAX's sharded task runs on the conftest's 8 virtual CPU devices; the port
runs one world of 8 gloo ranks for the file, each on its local batch.

- MnistCNN (f32, no dropout) at ``data 2 x fsdp 4`` under ``FSDP_RULES``
  with ``optax.adam(1e-3)`` against ``torch.optim.Adam(lr=1e-3)``, and
  again with ``eps=1e-6`` in both;
- ResNet-18 (f32, 8 filters, 32 x 32, 10 classes) at ``data 4 x fsdp 2``
  under ``FSDP_RULES`` with ``sgd_momentum(lr=0.1, total_steps=10)``: its
  BatchNorm statistics are the global batch's in both;
- ResNet-18 at ``data 8`` under ``REPLICATED_RULES`` against the port's own
  task without a mesh on the global batch (JAX's data-8 run is the same
  program as its fsdp one, which the second case holds).

Each takes 3 steps from JAX's initial weights (``models/convert.py``) on a
global batch of 16 drawn with numpy. Tolerances: losses 2e-4 relative;
parameters and BatchNorm statistics 1e-5 absolute (f32 sums over the batch
in another order). Adam at optax's default eps 1e-8 is held on its losses
only: its update ``m / (sqrt(v) + eps)`` divides a gradient near zero by
its own size, so the packages' f32 reduction orders move 2-3 of the
401,408 elements of ``dense.kernel`` by up to 1.4e-5 after 3 steps with
no mesh at all; at eps 1e-6 the same elements agree to 1.4e-6, with or
without the mesh, and the parameters are held to 1e-5 there.
"""

from __future__ import annotations

import functools
import pickle

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel.launch import run_world

torch.set_num_threads(1)

BATCH, STEPS = 16, 3
#: the cases JAX runs too (data 8 is held against the port's own
#: process on the global batch, from ResNet-18's initial weights)
JAX_CASES = ("mnist_fsdp", "mnist_fsdp_eps6", "resnet18_fsdp")
#: optax's default eps, and a larger one for the parameter comparison
ADAM_EPS = {"adam": 1e-8, "adam_eps6": 1e-6}
CASES = {
    # name: (model, mesh sizes, rules, optimizer)
    "mnist_fsdp": ("mnist", dict(data=2, fsdp=4), "fsdp", "adam"),
    "mnist_fsdp_eps6": ("mnist", dict(data=2, fsdp=4), "fsdp", "adam_eps6"),
    "resnet18_fsdp": ("resnet18", dict(data=4, fsdp=2), "fsdp", "sgd"),
    "resnet18_dp8": ("resnet18", dict(data=8), "replicated", "sgd"),
}


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "mnist": (rng.standard_normal((BATCH, 28, 28, 1)).astype(np.float32),
                  rng.integers(0, 10, BATCH).astype(np.int32)),
        "resnet18": (rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
                     rng.integers(0, 10, BATCH).astype(np.int32)),
    }


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from kubeflow_tpu.models.mnist import MnistCNN as JMnist
    from kubeflow_tpu.models.resnet import ResNet18 as JResNet18
    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel.sharding import FSDP_RULES as J_FSDP
    from kubeflow_tpu.parallel.sharding import REPLICATED_RULES as J_REP
    from kubeflow_tpu.training.classifier import ClassifierTask as JTask
    from kubeflow_tpu.training.classifier import sgd_momentum as j_sgd

    workdir = str(tmp_path_factory.mktemp("classifier_mesh"))
    data = _inputs()
    out = {"workdir": workdir, "data": data}
    init = {}
    for name, (model, sizes, rules, opt) in CASES.items():
        if name not in JAX_CASES:
            init[name] = init["resnet18_fsdp"]  # the same model and key
            continue
        jm = (JMnist(dtype=jnp.float32, dropout_rate=0.0) if model == "mnist"
              else JResNet18(num_classes=10, num_filters=8, dtype=jnp.float32))
        mesh = j_make_mesh(JMeshConfig(**sizes))
        task = JTask(model=jm, mesh=mesh, rules=J_FSDP if rules == "fsdp" else J_REP,
                     optimizer=optax.adam(1e-3, eps=ADAM_EPS[opt]) if opt in ADAM_EPS
                     else j_sgd(lr=0.1, total_steps=10))
        x, y = data[model]
        images = jax.device_put(jnp.asarray(x), task.batch_sharding(extra_dims=3))
        labels = jax.device_put(jnp.asarray(y), task.batch_sharding(extra_dims=0))
        state = jax.jit(task.init)(jax.random.PRNGKey(0), images)  # one compile, not one per op
        init[name] = _np_tree({"params": state.params, "batch_stats": state.batch_stats})
        step = task.make_train_step()
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, images, labels)
            metrics.append((float(m["loss"]), float(m["accuracy"])))
        out[name] = {"metrics": metrics,
                     "after": _np_tree({"params": state.params,
                                        "batch_stats": state.batch_stats})}
    with open(f"{workdir}/inputs.pkl", "wb") as f:
        pickle.dump({"data": data, "init": init}, f)
    return out


def _model(kind: str, variables):
    from kubeflow_tpu_torch.models.convert import resnet_params_from_flax
    from kubeflow_tpu_torch.models.mnist import MnistCNN
    from kubeflow_tpu_torch.models.resnet import ResNet18

    model = (MnistCNN(dtype=torch.float32, dropout_rate=0.0, device="cpu") if kind == "mnist"
             else ResNet18(num_classes=10, num_filters=8, dtype=torch.float32, device="cpu"))
    if not variables["batch_stats"]:
        variables = {"params": variables["params"]}
    model.load_state_dict(resnet_params_from_flax(variables, model))
    return model


def _optimizer(opt: str):
    from kubeflow_tpu_torch.training.classifier import sgd_momentum

    if opt in ADAM_EPS:
        return lambda params: (torch.optim.Adam(params, lr=1e-3, eps=ADAM_EPS[opt]),
                               lambda _: 1e-3)
    return functools.partial(sgd_momentum, lr=0.1, total_steps=10)


def _rank_main(rank, world, workdir):
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_tpu_torch.parallel.sharding import FSDP_RULES, REPLICATED_RULES
    from kubeflow_tpu_torch.training.classifier import ClassifierTask

    with open(f"{workdir}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for name, (kind, sizes, rules, opt) in CASES.items():
        mesh = make_mesh(MeshConfig(**sizes), device="cpu")
        task = ClassifierTask(_model(kind, inputs["init"][name]), _optimizer(opt), mesh=mesh,
                              rules=FSDP_RULES if rules == "fsdp" else REPLICATED_RULES)
        state = task.init()
        x, y = inputs["data"][kind]
        images, labels = task.local_batch(x), task.local_batch(y)
        metrics = []
        for _ in range(STEPS):
            state, m = task.train_step(state, images, labels)
            metrics.append((float(m["loss"]), float(m["accuracy"])))
        moments = {n: [tuple(v.shape) for v in state.optimizer.state[p].values()
                       if isinstance(v, torch.Tensor) and v.dim() > 0]
                   for n, p in state.shards.items()}
        try:
            task.model(images, train=False)
            stale = None
        except RuntimeError as e:  # the module's own parameters are meta
            stale = str(e)
        out[name] = {
            "released": [n for n, p in task.model.named_parameters() if not p.is_meta],
            "stale_read": stale,
            "shard_numel": sum(p.numel() for p in state.shards.values()),
            "metrics": metrics,
            "params": {n: v.numpy() for n, v in task.canonical_params(state).items()},
            "buffers": {n: v.numpy().copy() for n, v in state.buffers.items()},
            "shards": {n: tuple(p.shape) for n, p in state.shards.items()},
            "moments": moments,
            "eval": task.eval_step(state, images).numpy(),
        }
    mesh = make_mesh(MeshConfig(data=4, model=2), device="cpu")
    try:
        ClassifierTask(_model("mnist", inputs["init"]["mnist_fsdp"]), _optimizer("adam"),
                       mesh=mesh).init()
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def world(jax_side):
    return run_world(f"{__name__}:_rank_main", 8, jax_side["workdir"], timeout=240,
                     device="cpu")


def _flatten(tree, prefix=""):
    """A flax tree by the port's names (``a/b/kernel`` -> ``a.b.kernel``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_losses_match_jax(world, jax_side, name):
    """Losses to 2e-4 relative and accuracies exactly, on every rank."""
    want = jax_side[name]
    for res in world:
        got = res[name]
        np.testing.assert_allclose([m[0] for m in got["metrics"]],
                                   [m[0] for m in want["metrics"]], rtol=2e-4)
        assert [m[1] for m in got["metrics"]] == [m[1] for m in want["metrics"]]


@pytest.mark.parametrize("name", ["mnist_fsdp_eps6", "resnet18_fsdp"])
def test_sharded_steps_match_jax(world, jax_side, name):
    """Parameters and (ResNet-18) BatchNorm statistics to 1e-5 on every
    rank, and every rank's whole model the same."""
    want = jax_side[name]
    params, stats = _flatten(want["after"]["params"]), _flatten(want["after"]["batch_stats"])
    for res in world:
        got = res[name]
        assert set(got["params"]) == set(params)
        for n, v in params.items():
            np.testing.assert_allclose(got["params"][n], v, atol=1e-5, rtol=0, err_msg=n)
        assert set(got["buffers"]) == set(stats)
        for n, v in stats.items():
            np.testing.assert_allclose(got["buffers"][n], v, atol=1e-5, rtol=0, err_msg=n)
    # every rank holds the same whole model after the step
    for res in world[1:]:
        for n, v in world[0][name]["params"].items():
            np.testing.assert_array_equal(res[name]["params"][n], v)


@pytest.mark.parametrize("name", ["mnist_fsdp", "resnet18_fsdp"])
def test_moments_shard_with_the_parameters(world, name):
    """The ZeRO-3 point: each rank's optimizer moments have its parameter
    shards' shapes, and the fsdp-sharded leaves are really cut."""
    fsdp = CASES[name][1]["fsdp"]
    for res in world:
        got = res[name]
        cut = 0
        for n, shape in got["shards"].items():
            assert got["moments"][n], n
            assert all(m == shape for m in got["moments"][n]), (n, got["moments"][n])
            whole = got["params"][n].shape
            if tuple(whole) != shape:
                cut += 1
                assert int(np.prod(whole)) == fsdp * int(np.prod(shape)), (n, whole, shape)
        assert cut >= 2, got["shards"]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_task_holds_only_shards(world, name):
    """With a mesh the module's own parameters are meta tensors: each rank
    holds its shards (1/fsdp of the sharded leaves) and no stale whole
    copy, and running ``state.model`` directly fails instead of using the
    initial weights."""
    fsdp = CASES[name][1].get("fsdp", 1)
    for res in world:
        got = res[name]
        assert got["released"] == [], got["released"]
        assert got["stale_read"] and "meta" in got["stale_read"], got["stale_read"]
        whole = sum(int(np.prod(v.shape)) for v in got["params"].values())
        if fsdp == 1:
            assert got["shard_numel"] == whole
        else:
            assert got["shard_numel"] < whole * 0.6, (got["shard_numel"], whole)


def test_replicated_mesh_equals_one_process_on_the_global_batch(world, jax_side):
    """``REPLICATED_RULES`` at ``data 8``: the 8 local batches of 2 with
    global BatchNorm statistics give the step of one process on the batch
    of 16 (losses 2e-4 relative; parameters, statistics and eval logits
    1e-5)."""
    from kubeflow_tpu_torch.training.classifier import ClassifierTask

    with open(f"{jax_side['workdir']}/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    task = ClassifierTask(_model("resnet18", inputs["init"]["resnet18_dp8"]), _optimizer("sgd"))
    state = task.init()
    x, y = inputs["data"]["resnet18"]
    images, labels = torch.tensor(x), torch.tensor(y)
    metrics = []
    for _ in range(STEPS):
        state, m = task.train_step(state, images, labels)
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    logits = task.eval_step(state, images).numpy()
    whole = task.canonical_params(state)
    for rank, res in enumerate(world):
        got = res["resnet18_dp8"]
        np.testing.assert_allclose([m[0] for m in got["metrics"]], [m[0] for m in metrics],
                                   rtol=2e-4)
        assert [m[1] for m in got["metrics"]] == [m[1] for m in metrics]
        for n, v in whole.items():
            np.testing.assert_allclose(got["params"][n], v.numpy(), atol=1e-5, rtol=0)
        for n, v in state.buffers.items():
            np.testing.assert_allclose(got["buffers"][n], v.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["eval"], logits[rank * 2:(rank + 1) * 2], atol=1e-5,
                                   rtol=0)


def test_no_mesh_is_unchanged():
    """``mesh=None``: no shards, no BatchNorm group, and the step is the
    plain one (the same bits as a hand-written forward, loss, backward and
    optimizer step)."""
    from kubeflow_tpu_torch.models.resnet import BatchNorm, ResNet18
    from kubeflow_tpu_torch.training.classifier import (ClassifierTask, cross_entropy_loss,
                                                        sgd_momentum)

    x, y = _inputs()["resnet18"]
    images, labels = torch.tensor(x), torch.tensor(y)
    a = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32, device="cpu")
    b = ResNet18(num_classes=10, num_filters=8, dtype=torch.float32, device="cpu")
    task = ClassifierTask(a, functools.partial(sgd_momentum, lr=0.1))
    assert task.mesh is None and task.batch_sharding(3) is None
    state = task.init()
    assert state.shards is None and state.specs is None
    assert all(m.group is None for m in a.modules() if isinstance(m, BatchNorm))
    opt, _ = sgd_momentum(b.parameters(), lr=0.1)
    for _ in range(2):
        state, m = task.train_step(state, images, labels)
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(b(images, train=True), labels)
        loss.backward()
        opt.step()
        assert torch.equal(m["loss"], loss.detach())
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n



def test_mesh_with_a_model_axis_is_refused(world):
    """The batch splits over data x fsdp; a model (or any other) axis
    above 1 would hold one batch on several ranks: refused, not wrong."""
    msgs = [res["refused"] for res in world]
    assert all(m and "other axes must be 1" in m and "'model': 2" in m for m in msgs), msgs
