"""kubeflow_tpu_torch/training/checkpoint.py and the reverse converters of
kubeflow_tpu_torch/models/convert.py against the JAX package, on the CPU.

Each package restores what the other wrote: the same tree saved by both
gives manifests equal in every leaf's key, path tokens, file, shape, dtype
and crc32 (and the same bytes on disk). A bfloat16 leaf is written as JAX
writes it (a ``'<V2'`` ``.npy``, manifest dtype ``"bfloat16"``) and restores
in the port as a ``torch.bfloat16`` tensor with the same bits; the JAX
``Checkpointer`` cannot restore it (ROADMAP.md C.4). The crash-safety tests
mirror ``tests/test_checkpoint.py`` and
``tests/test_elastic.py::TestCrashSafeCheckpointer``, plus a real kill -9
in the middle of a save. The inverse converters are exact: flax → port →
flax gives the same arrays bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM, stack_block_params
from kubeflow_tpu.models.resnet import BottleneckBlock as JBlock, ResNet as JResNet
from kubeflow_tpu.training.checkpoint import Checkpointer as JCheckpointer
from kubeflow_tpu_torch.models import resnet as tr
from kubeflow_tpu_torch.models.convert import (params_from_flax, params_to_flax,
                                               resnet_params_from_flax, resnet_params_to_flax)
from kubeflow_tpu_torch.models.gpt import GptConfig, GptLM
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.training.checkpoint import SAVE_BUCKETS, Checkpointer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MANIFEST_FIELDS = ("key", "path", "file", "shape", "dtype", "bytes", "crc32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_tree():
    """Dict keys of both types, nested lists and tuples, scalars, a None."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "k": {1: rng.standard_normal(2), 0: np.arange(3, dtype=np.int32)},
            "l": [np.zeros(1), (np.int32(3), 5)], "t": (1.5,), "n": None,
            "b": np.array([True, False])}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _entries(manifest):
    return [{k: e[k] for k in MANIFEST_FIELDS} for e in manifest["leaves"]]


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_array_equal(g, np.asarray(want))
        assert g.dtype == np.asarray(want).dtype


# -- the two packages on one format -----------------------------------------------


def test_port_writes_what_jax_writes_and_jax_reads_it(tmp_path):
    tree = _numpy_tree()
    Checkpointer(str(tmp_path / "port")).save(4, _as_tensors(tree), meta={"step": 4})
    JCheckpointer(str(tmp_path / "jax")).save(4, tree, meta={"step": 4})
    port, jx = _manifest(tmp_path / "port", 4), _manifest(tmp_path / "jax", 4)
    assert _entries(port) == _entries(jx)
    assert port["format"] == jx["format"] == 1 and port["meta"] == jx["meta"]
    keys = [e["key"] for e in port["leaves"]]
    assert keys == ["['b']", "['k'][0]", "['k'][1]", "['l'][0]", "['l'][1][0]",
                    "['l'][1][1]", "['t'][0]", "['w']"]
    for e in port["leaves"]:  # the same bytes on disk
        assert ((tmp_path / "port" / "step_4" / e["file"]).read_bytes()
                == (tmp_path / "jax" / "step_4" / e["file"]).read_bytes())
    # the JAX Checkpointer reads the port's directory both ways
    jc = JCheckpointer(str(tmp_path / "port"))
    got, meta = jc.restore_numpy()
    assert meta == {"step": 4}
    _assert_tree_equal(got["w"], tree["w"])
    _assert_tree_equal(got["k"], tree["k"])
    _assert_tree_equal(got["l"][1], list(tree["l"][1]))
    restored = jc.restore(tree)
    _assert_tree_equal(restored["w"], tree["w"])
    assert restored["t"] == (1.5,) and restored["l"][1][1] == 5 and restored["n"] is None


def test_jax_writes_and_the_port_restores(tmp_path):
    state = {"params": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones(3, jnp.float32)},
             "step": jnp.int32(7), "opt": [jnp.zeros(2), jnp.arange(2, dtype=jnp.int32)]}
    JCheckpointer(str(tmp_path)).save(7, state, meta={"pp": 4})
    ckpt = Checkpointer(str(tmp_path))
    got, meta = ckpt.restore_numpy()
    assert meta == {"pp": 4} and ckpt.read_meta()["pp"] == 4 and ckpt.latest_step() == 7
    _assert_tree_equal(got, _np_tree(state))
    # a template of tensors: each leaf lands on the template leaf's dtype
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                           "b": torch.zeros(3)},
                "step": 0, "opt": [torch.zeros(2, dtype=torch.float64),
                                   torch.zeros(2, dtype=torch.int64)]}
    out = ckpt.restore(template)
    assert out["params"]["w"].dtype == torch.bfloat16 and out["step"] == 7
    assert isinstance(out["step"], int) and out["opt"][1].dtype == torch.int64
    assert torch.equal(out["params"]["w"].float(), torch.arange(6.0).reshape(2, 3))
    assert torch.equal(out["opt"][1], torch.arange(2))


def test_bf16_leaf_is_jaxs_file_and_restores_as_bf16(tmp_path):
    values = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(values).to(torch.bfloat16)
    Checkpointer(str(tmp_path / "port")).save(3, {"w": t})
    JCheckpointer(str(tmp_path / "jax")).save(3, {"w": jnp.asarray(values, jnp.bfloat16)})
    port, jx = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "jax", 3)
    assert _entries(port) == _entries(jx)
    assert port["leaves"][0]["dtype"] == "bfloat16"
    assert ((tmp_path / "port" / "step_3" / "leaf_00000.npy").read_bytes()
            == (tmp_path / "jax" / "step_3" / "leaf_00000.npy").read_bytes())
    # the port restores either directory as bf16 with the same bits
    for d in ("port", "jax"):
        got, _ = Checkpointer(str(tmp_path / d)).restore_numpy()
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))
        out = Checkpointer(str(tmp_path / d)).restore(
            {"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
        assert torch.equal(out["w"].view(torch.int16), t.view(torch.int16))
    # the reference: restore_numpy gives raw 2-byte words; restore cannot cast
    raw, _ = JCheckpointer(str(tmp_path / "port")).restore_numpy()
    assert raw["w"].dtype.kind == "V"
    assert raw["w"].tobytes() == t.view(torch.int16).numpy().tobytes()
    with pytest.raises(ValueError):
        JCheckpointer(str(tmp_path / "port")).restore({"w": jnp.zeros((3, 5), jnp.bfloat16)})


# -- crash safety (the mirrors of the JAX package's tests) ---------------------------


def test_roundtrip_and_retention(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step() is None
    state = {"w": torch.arange(8.0), "step": torch.tensor(0, dtype=torch.int32)}
    for step in (0, 1, 2, 3):
        ckpt.save(step, {**state, "step": torch.tensor(step, dtype=torch.int32)})
    assert ckpt.latest_step() == 3
    assert ckpt.all_steps() == [2, 3]  # retention pruned 0 and 1
    restored = ckpt.restore(state)
    assert int(restored["step"]) == 3 and restored["step"].dtype == torch.int32
    assert torch.equal(restored["w"], torch.arange(8.0))
    ckpt.close()


def test_maybe_save_cadence(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    state = {"x": torch.zeros(2)}
    assert not ckpt.maybe_save(1, state, every=5)
    assert not ckpt.maybe_save(5, state, every=0)
    assert ckpt.maybe_save(5, state, every=5, wait=True)
    assert ckpt.latest_step() == 5
    ckpt.close()


def test_restore_missing_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_numpy()
    with pytest.raises(FileNotFoundError):
        ckpt.read_meta()


def test_meta_and_restore_numpy_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    tree = {"params": {"w": np.arange(6.0).reshape(2, 3)},
            "opt": [np.float32(0.5), np.arange(3, dtype=np.int32)]}
    ckpt.save(7, tree, meta={"step": 7, "pp": 4, "virtualStages": 1})
    got, meta = ckpt.restore_numpy()
    assert meta == {"step": 7, "pp": 4, "virtualStages": 1}
    np.testing.assert_array_equal(got["params"]["w"], tree["params"]["w"])
    np.testing.assert_array_equal(got["opt"][1], tree["opt"][1])
    assert ckpt.read_meta()["pp"] == 4 and ckpt.read_meta(7)["step"] == 7


def test_corrupt_newest_checkpoint_is_skipped(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(0, {"x": torch.full((4,), 1.0)}, meta={"step": 0})
    ckpt.save(1, {"x": torch.full((4,), 2.0)}, meta={"step": 1})
    # bit-flip a leaf of the newest checkpoint (same size: the crc catches it)
    leaf = tmp_path / "step_1" / "leaf_00000.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    got, meta = ckpt.restore_numpy()
    assert meta["step"] == 0
    np.testing.assert_array_equal(got["x"], np.full(4, 1.0, np.float32))
    out = ckpt.restore({"x": torch.zeros(4)})  # the template walk skips it too
    assert torch.equal(out["x"], torch.full((4,), 1.0))
    with pytest.raises(FileNotFoundError):  # asked for by step: no walk
        ckpt.restore({"x": torch.zeros(4)}, step=1)


def test_truncated_manifest_and_short_leaf_are_skipped(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    for s in range(3):
        ckpt.save(s, {"x": torch.ones(2) * s}, meta={"step": s})
    mpath = tmp_path / "step_2" / "manifest.json"
    mpath.write_text(mpath.read_text()[:20])  # a torn write
    leaf = tmp_path / "step_1" / "leaf_00000.npy"
    leaf.write_bytes(leaf.read_bytes()[:-4])  # a short leaf
    assert ckpt.all_steps() == [0] and ckpt.latest_step() == 0
    assert ckpt.restore_numpy()[1]["step"] == 0


def test_structure_that_differs_from_the_template_is_skipped(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(0, {"a": torch.ones(2), "b": torch.zeros(1)})
    ckpt.save(1, {"a": torch.ones(2) * 2})  # "b" gone
    out = ckpt.restore({"a": torch.zeros(2), "b": torch.ones(1)})
    assert torch.equal(out["a"], torch.ones(2)) and torch.equal(out["b"], torch.zeros(1))
    assert torch.equal(ckpt.restore({"a": torch.zeros(2)})["a"], torch.full((2,), 2.0))


def test_orphan_temp_dir_is_reclaimed(tmp_path):
    tmp = tmp_path / "_tmp.3.deadbeef"
    tmp.mkdir()
    (tmp / "leaf_00000.npy").write_bytes(b"partial")
    ckpt = Checkpointer(str(tmp_path))  # reopen after the crash
    assert ckpt.latest_step() is None
    assert not tmp.exists(), "orphan temp dir not reclaimed"
    with pytest.raises(FileNotFoundError):
        ckpt.restore_numpy()


KILL_MID_SAVE = """
import os, signal, sys
sys.path.insert(0, {root!r})
import torch
from kubeflow_tpu_torch.training import checkpoint

ckpt = checkpoint.Checkpointer({directory!r})
ckpt.save(1, {{"x": torch.ones(1000)}}, meta={{"step": 1}})

def die(*a, **k):  # the leaves and manifest are written; the rename never happens
    os.kill(os.getpid(), signal.SIGKILL)

checkpoint.os.rename = die
ckpt.save(2, {{"x": torch.full((1000,), 2.0)}}, meta={{"step": 2}})
"""


def test_kill9_mid_save_leaves_the_previous_step(tmp_path):
    code = KILL_MID_SAVE.format(root=str(ROOT), directory=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120)
    assert proc.returncode == -9, proc.stderr.decode()
    leftovers = [p.name for p in tmp_path.iterdir() if p.name.startswith("_tmp.2.")]
    assert len(leftovers) == 1 and (tmp_path / leftovers[0] / "manifest.json").exists()
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.all_steps() == [1] and not (tmp_path / leftovers[0]).exists()
    got, meta = ckpt.restore_numpy()
    assert meta == {"step": 1} and np.array_equal(got["x"], np.ones(1000, np.float32))


def test_gc_keeps_newest_complete_never_corrupt_floor(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in range(4):
        ckpt.save(s, {"x": np.full(2, float(s))}, meta={"step": s})
    assert ckpt.all_steps() == [2, 3]
    # corrupt the newest; the previous complete one must survive both the
    # corruption and the next save's retention
    shutil.rmtree(tmp_path / "step_3")
    (tmp_path / "step_3").mkdir()  # empty = corrupt
    assert ckpt.all_steps() == [2]
    ckpt.save(4, {"x": np.full(2, 4.0)}, meta={"step": 4})
    assert ckpt.all_steps() == [2, 4]
    assert ckpt.restore_numpy()[1]["step"] == 4


def test_concurrent_saves_serialize_without_corruption(tmp_path):
    # an urgent save fires while a periodic one is still writing; the lock
    # serializes them and both land complete
    ckpt = Checkpointer(str(tmp_path), max_to_keep=4)
    big = {"x": torch.from_numpy(np.random.RandomState(0).rand(256, 256))}
    errs = []

    def periodic():
        try:
            ckpt.save(10, big, meta={"step": 10})
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=periodic)
    t.start()
    ckpt.save(11, big, meta={"step": 11})
    t.join(timeout=60)
    assert not t.is_alive() and not errs
    assert set(ckpt.all_steps()) == {10, 11}
    assert ckpt.restore_numpy()[1]["step"] == 11


def test_save_and_restore_seconds_observed(tmp_path):
    save = METRICS.histogram("checkpoint_save_seconds", buckets=SAVE_BUCKETS)
    restore = METRICS.histogram("checkpoint_restore_seconds", buckets=SAVE_BUCKETS)
    n_save, n_restore = save.total, restore.total
    ckpt = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):  # a failed walk is not a restore
        ckpt.restore_numpy()
    assert restore.total == n_restore
    ckpt.save(0, {"x": torch.ones(1)})
    ckpt.restore_numpy()
    assert save.total == n_save + 1 and restore.total == n_restore + 1
    assert save.buckets == SAVE_BUCKETS


# -- the reverse converters ----------------------------------------------------------

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=64, vocab_size=97)


@pytest.fixture(scope="module")
def gpt_tree():
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    init = jax.jit(JLM(jcfg).init)  # one compile, not one per op
    return jcfg, _np_tree(init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"])


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_blocks"])
def test_gpt_inverse_is_exact(gpt_tree, scan):
    jcfg, tree = gpt_tree
    if scan:
        tree = _np_tree(stack_block_params(tree, jcfg.n_layers))
    cfg = GptConfig(**SHAPE, dtype=torch.float32, scan_blocks=scan)
    params = params_from_flax(tree, cfg)
    back = params_to_flax(params, cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves(tree)):
        assert got.dtype == np.float32 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    # the JAX model runs on the carried-back tree
    ids = np.arange(8, dtype=np.int32)[None]
    jlm = JLM(JCfg(**SHAPE, dtype=jnp.float32, scan_blocks=scan))
    np.testing.assert_array_equal(np.asarray(jlm.apply({"params": back}, ids)),
                                  np.asarray(jlm.apply({"params": tree}, ids)))


def test_gpt_inverse_refuses_what_does_not_fit():
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    params = {k: torch.zeros(v.shape) for k, v in GptLM(cfg, device="meta").state_dict().items()}
    with pytest.raises(ValueError, match="no tensor for"):
        params_to_flax({k: v for k, v in params.items() if k != "ln_final.scale"}, cfg)
    with pytest.raises(ValueError, match="no counterpart"):
        params_to_flax({**params, "block_9.mlp.up_proj.weight": torch.zeros(64, 32)}, cfg)
    with pytest.raises(ValueError, match="does not fit"):
        params_to_flax({**params, "embedding.weight": torch.zeros(96, 32)}, cfg)


@pytest.fixture(scope="module")
def resnet_variables():
    jm = JResNet(stage_sizes=[1, 1], block_cls=JBlock, stem="s2d", num_classes=10,
                 num_filters=8)
    images = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    init = jax.jit(lambda rng, x: jm.init(rng, x, train=True))  # one compile, not one per op
    return _np_tree(init(jax.random.PRNGKey(0), images))


def _resnet():
    return tr.ResNet([1, 1], tr.BottleneckBlock, stem="s2d", num_classes=10, num_filters=8,
                     device="cpu")


def test_resnet_inverse_is_exact(resnet_variables):
    model = _resnet()
    model.load_state_dict(resnet_params_from_flax(resnet_variables, model))
    back = resnet_params_to_flax(model.state_dict(), model)
    assert sorted(back) == ["batch_stats", "params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(resnet_variables)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(resnet_variables)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # a fresh model filled from the carried-back tree holds the same tensors
    fresh = _resnet()
    fresh.load_state_dict(resnet_params_from_flax(back, fresh))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  fresh.state_dict().values()))


def test_resnet_inverse_refuses_what_does_not_fit():
    model = _resnet()
    state = model.state_dict()
    with pytest.raises(ValueError, match="no tensor for"):
        resnet_params_to_flax({k: v for k, v in state.items() if k != "bn_init.mean"}, model)
    with pytest.raises(ValueError, match="no counterpart"):
        resnet_params_to_flax({**state, "extra.kernel": torch.zeros(1)}, model)
    with pytest.raises(ValueError, match="does not fit"):
        resnet_params_to_flax({**state, "classifier.bias": torch.zeros(11)}, model)


def test_a_checkpointed_flax_tree_round_trips_between_packages(tmp_path, resnet_variables):
    """The port saves a ResNet's variables as a flax tree; the JAX
    Checkpointer restores them into the flax model's own variables, and
    the port restores them into a fresh model bit for bit."""
    model = _resnet()
    model.load_state_dict(resnet_params_from_flax(resnet_variables, model))
    Checkpointer(str(tmp_path)).save(5, resnet_params_to_flax(model.state_dict(), model))
    jtree = JCheckpointer(str(tmp_path)).restore(
        jax.tree_util.tree_map(jnp.zeros_like, resnet_variables))
    for got, want in zip(jax.tree_util.tree_leaves(jtree),
                         jax.tree_util.tree_leaves(resnet_variables)):
        np.testing.assert_array_equal(np.asarray(got), want)
    tree, _ = Checkpointer(str(tmp_path)).restore_numpy()
    fresh = _resnet()
    fresh.load_state_dict(resnet_params_from_flax(tree, fresh))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  fresh.state_dict().values()))
