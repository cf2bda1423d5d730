"""The port's ResNet against kubeflow_tpu/models/resnet.py.

A tiny flax ResNet (two stages of two bottlenecks, 8 filters, 32 x 32
images) is initialized in JAX and its variables are carried into the port
with ``resnet_params_from_flax``; the same numpy images go through both.
The fused flax blocks run the Pallas kernels in interpret mode, the port's
the kernels' plain versions.

Tolerances (bf16, the models' default dtype). Logits: 5e-3. Activations
are rounded to bf16 at the same places on both sides, but XLA's and
PyTorch's f32 sums run in another order and can flip a bf16 rounding (a
relative 3.9e-3) of a few activations; the largest logit difference seen
is 5.6e-4 (train mode, unfused). BatchNorm statistics after a train-mode
forward: 1e-3 (2e-4 seen, same cause).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from kubeflow_tpu.models.resnet import BottleneckBlock as JBlock, ResNet as JResNet
from kubeflow_tpu_torch.models import resnet as tr
from kubeflow_tpu_torch.models.convert import resnet_params_from_flax
from kubeflow_tpu_torch.ops import fallback
from kubeflow_tpu_torch.ops import fused_bottleneck as tfb
from kubeflow_tpu_torch.runtime.metrics import METRICS

torch.set_num_threads(1)

TINY = dict(num_classes=10, num_filters=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n=4, hw=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax_variables(stem):
    """One init per stem: fused and unfused models declare the same tree."""
    jm = JResNet(stage_sizes=[2, 2], block_cls=JBlock, stem=stem, **TINY)
    return jm.init(jax.random.PRNGKey(0), jnp.asarray(_images()), train=True)


def _pair(stem, fused):
    jm = JResNet(stage_sizes=[2, 2], block_cls=JBlock, stem=stem, fused_blocks=fused, **TINY)
    variables = _flax_variables(stem)
    tm = tr.ResNet([2, 2], tr.BottleneckBlock, stem=stem, fused_blocks=fused, device="cpu",
                   **TINY)
    tm.load_state_dict(resnet_params_from_flax(_np_tree(variables), tm))
    return jm, variables, tm


@pytest.mark.parametrize("stem", ["s2d", "conv7x7"])
@pytest.mark.parametrize("fused", [False, True])
def test_forward_and_batch_stats_match_flax(stem, fused):
    jm, variables, tm = _pair(stem, fused)
    x = _images(seed=1)
    want_eval = jm.apply(variables, jnp.asarray(x), train=False)
    want_train, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    before = {k: v.clone() for k, v in tm.named_buffers()}
    tfb.reset_launches()
    with torch.no_grad():
        got_eval = tm(torch.tensor(x), train=False)
        assert all(torch.equal(v, before[k]) for k, v in tm.named_buffers())
        got_train = tm(torch.tensor(x), train=True)
    assert got_eval.dtype == torch.float32 and got_eval.shape == (4, 10)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=5e-3, rtol=0)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=5e-3, rtol=0)
    want_stats = resnet_params_from_flax(
        _np_tree({"params": variables["params"], "batch_stats": mutated["batch_stats"]}), tm)
    changed = set()
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), atol=1e-3, rtol=0,
                                   err_msg=name)
        if not torch.equal(buf, before[name]):
            changed.add(name.rsplit(".", 1)[0])
    # frozen norm: a fused model updates only the stem's statistics
    if fused:
        assert changed == {"bn_init"}
    else:
        assert changed == {n.rsplit(".", 1)[0] for n, _ in tm.named_buffers()}
    assert sum(tfb.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_converter_round_trip_and_its_errors():
    _, variables, tm = _pair("s2d", False)
    tree = _np_tree(variables)
    state = tm.state_dict()
    for collection in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree[collection])[0]:
            name = ".".join(k.key for k in path)
            assert np.array_equal(state[name].numpy(), np.asarray(leaf, np.float32)), name
    assert len(state) == len(jax.tree_util.tree_leaves(tree))
    # a gradient tree (params only) fills the parameters
    only = resnet_params_from_flax({"params": tree["params"]}, tm)
    assert set(only) == {n for n, _ in tm.named_parameters()}
    missing = {"params": dict(tree["params"]), "batch_stats": tree["batch_stats"]}
    del missing["params"]["classifier"]
    with pytest.raises(ValueError, match="missing"):
        resnet_params_from_flax(missing, tm)
    surplus = {"params": dict(tree["params"], extra={"kernel": np.zeros(3)}),
               "batch_stats": tree["batch_stats"]}
    with pytest.raises(ValueError, match="no counterpart"):
        resnet_params_from_flax(surplus, tm)
    bad = {"params": dict(tree["params"], classifier={"kernel": np.zeros((3, 3)),
                                                     "bias": np.zeros(10)})}
    with pytest.raises(ValueError, match="does not fit"):
        resnet_params_from_flax(bad, tm)
    with pytest.raises(ValueError, match="collection"):
        resnet_params_from_flax({"params": tree["params"], "cache": {}}, tm)


def test_non_square_input_falls_back_warns_and_counts():
    """A shape neither kernel takes runs ``folded_bottleneck``, warns once
    and ticks ``ops_fused_fallback_total``; the result is flax's."""
    conv = functools.partial(fnn.Conv, use_bias=False, dtype=jnp.bfloat16,
                             param_dtype=jnp.float32)
    norm = functools.partial(fnn.BatchNorm, momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16,
                             param_dtype=jnp.float32)
    jb = JBlock(filters=8, strides=(1, 1), conv=conv, norm=norm, act=fnn.relu, fused=True)
    x = np.abs(np.random.default_rng(2).standard_normal((1, 12, 16, 32))).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    variables = jb.init(jax.random.PRNGKey(0), jx)
    want = jb.apply(variables, jx)
    tb = tr.BottleneckBlock(32, 8, fused=True)
    tb.load_state_dict(resnet_params_from_flax(_np_tree(variables), tb))
    fallback.reset_fallback_warnings()
    METRICS.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            got = tb(torch.tensor(x).to(torch.bfloat16))
            tb(torch.tensor(x).to(torch.bfloat16))
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "not kernel-fusable" in msgs[0]
    assert 'ops_fused_fallback_total{kernel="fused_bottleneck"} 2' in METRICS.render()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


def test_resnet50_at_224_routes_12_identity_and_4_transition_blocks():
    """The routing decision from shapes alone, block by block, against the
    JAX model's own predicates on the same shapes."""
    model = tr.ResNet50(fused_blocks=True, device="meta")
    assert len(model.blocks) == 16
    shape, kinds = (1, 56, 56, 64), []
    for block in model.blocks:
        x = torch.empty(shape, device="meta")
        jblock = JBlock(filters=block.filters, strides=block.strides, conv=None, norm=None,
                        act=None, fused=True)
        jx = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        if block._fusable(x):
            kinds.append("identity")
        elif block._fusable_transition(x):
            kinds.append(f"transition_s{block.strides[0]}")
        else:
            kinds.append("fallback")
        assert (block._fusable(x), block._fusable_transition(x)) == (
            jblock._fusable(jx), jblock._fusable_transition(jx))
        hw = shape[1] // block.strides[0]
        shape = (1, hw, hw, block.filters * 4)
    assert kinds.count("identity") == 12 and kinds.count("fallback") == 0
    assert [k for k in kinds if k != "identity"] == ["transition_s1"] + ["transition_s2"] * 3
    assert shape == (1, 7, 7, 2048)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == 25_557_032  # torchvision's ResNet-50 count


def test_space_to_depth_matches_jax():
    from kubeflow_tpu.models.resnet import space_to_depth

    x = _images(2, 8)
    np.testing.assert_array_equal(tr.space_to_depth(torch.tensor(x)).numpy(),
                                  np.asarray(space_to_depth(jnp.asarray(x))))


def test_basic_block_resnet_matches_flax():
    from kubeflow_tpu.models.resnet import BasicBlock as JBasic

    jm = JResNet(stage_sizes=[1, 1], block_cls=JBasic, stem="s2d", **TINY)
    x = _images(seed=3)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = tr.ResNet([1, 1], tr.BasicBlock, stem="s2d", device="cpu", **TINY)
    tm.load_state_dict(resnet_params_from_flax(_np_tree(variables), tm))
    with torch.no_grad():
        got = tm(torch.tensor(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, jnp.asarray(x),
                                                                train=False)),
                               atol=5e-3, rtol=0)


def test_seeded_init_and_the_odd_s2d_input():
    a = tr.ResNet([1], tr.BottleneckBlock, stem="s2d", seed=3, device="cpu", **TINY)
    b = tr.ResNet([1], tr.BottleneckBlock, stem="s2d", seed=3, device="cpu", **TINY)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    k = a.stage1_block1.conv2.kernel
    # lecun normal: truncated at 2 sigma, variance 1 / fan_in
    assert float(k.detach().abs().max()) <= 2 / (9 * 8) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(a.stage1_block1.bn3.scale.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="even height"):
        a(torch.zeros(1, 31, 32, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tr.ResNet50()  # the default device is the card

