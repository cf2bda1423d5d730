"""kubeflow_tpu_torch/parallel/composite.py against the JAX package.

JAX's composite GPT step (``CompositeConfig`` of JAX's tests: vocab 64,
d 32, 4 heads, ff 64, 4 layers, seq 16; 4 microbatches of 8) runs here on
the conftest's 8 virtual CPU devices at ``data 8`` and ``fsdp 2 x model 2
x pipe 2``, from one canonical draw; after two steps at the second it
writes ``canonical_params`` with JAX's ``Checkpointer``. The port runs one
world of 8 gloo ranks for the file: the same canonical weights and ids at
``data 8`` and at ``fsdp 2 x model 2 x pipe 2`` in every gather mode at
V = 1 and 2, three SGD steps each; then it restores JAX's checkpoint with
its own ``Checkpointer`` at ``data 2 x fsdp 2 x pipe 2``, V = 2 (another
factorization) and takes the third step.

Tolerances: losses to 2e-4 relative (JAX's own factorization test; ~1e-6
seen) and parameters after three steps to 1e-5; ``eager`` and ``overlap``
give the same bits, losses and parameters.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel.composite import (GATHER_MODES, CompositeConfig,
                                                   canonical_params, init_params, local_ids,
                                                   make_train_step, params_from_canonical)
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=4, seq=16)
MICRO, MB, STEPS = 4, 8, 3
DP8 = dict(data=8)
MIXED = dict(data=1, fsdp=2, model=2, pipe=2)
RESUME = dict(data=2, fsdp=2, model=1, pipe=2)
RUNS = [("dp8", "eager", 1)] + [("mixed", m, v) for v in (1, 2) for m in GATHER_MODES]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel.composite import CompositeConfig as JCfg
    from kubeflow_tpu.parallel.composite import batch_sharding
    from kubeflow_tpu.parallel.composite import canonical_params as j_canonical
    from kubeflow_tpu.parallel.composite import init_params as j_init
    from kubeflow_tpu.parallel.composite import make_train_step as j_step
    from kubeflow_tpu.training.checkpoint import Checkpointer as JCheckpointer

    workdir = str(tmp_path_factory.mktemp("composite_world"))
    cfg = JCfg(**CFG)
    ids = np.random.default_rng(1).integers(0, CFG["vocab_size"], (MICRO, MB, CFG["seq"]))
    ids = ids.astype(np.int32)
    out = {"ids": ids, "workdir": workdir}
    for name, sizes in (("dp8", DP8), ("mixed", MIXED)):
        mesh = j_make_mesh(JMeshConfig(**sizes))
        params = j_init(jax.random.PRNGKey(0), cfg, mesh)
        if name == "dp8":
            out["canon"] = j_canonical(params, mesh)
        step = j_step(cfg, mesh)
        jids = jax.device_put(jnp.asarray(ids), batch_sharding(mesh))
        losses = []
        for i in range(STEPS):
            params, loss = step(params, jids)
            losses.append(float(loss))
            if name == "mixed" and i == 1:
                ckpt = JCheckpointer(f"{workdir}/ckpt")
                ckpt.save(2, j_canonical(params, mesh))
                ckpt.close()
        out[name] = dict(losses=losses, canon=j_canonical(params, mesh))
    with open(f"{workdir}/inputs.pkl", "wb") as f:
        pickle.dump({"ids": ids, "canon": out["canon"]}, f)
    return out


def _train(cfg, mesh, mode, v, data, canon=None, steps=STEPS):
    params = params_from_canonical(canon if canon is not None else data["canon"], cfg, mesh,
                                   virtual_stages=v)
    step = make_train_step(cfg, mesh, virtual_stages=v, gather_mode=mode)
    ids = local_ids(data["ids"], mesh)
    losses = []
    for _ in range(steps):
        params, loss = step(params, ids)
        losses.append(float(loss))
    return losses, canonical_params(params, mesh, virtual_stages=v)


def _rank_main(rank, world, workdir):
    from kubeflow_tpu_torch.training.checkpoint import Checkpointer

    with open(f"{workdir}/inputs.pkl", "rb") as f:
        data = pickle.load(f)
    cfg = CompositeConfig(**CFG)
    meshes = {n: make_mesh(MeshConfig(**s), device="cpu")
              for n, s in (("dp8", DP8), ("mixed", MIXED), ("resume", RESUME))}
    out = {}
    for name, mode, v in RUNS:
        out[(name, mode, v)] = _train(cfg, meshes[name], mode, v, data)
    ckpt = Checkpointer(f"{workdir}/ckpt")
    canon, _ = ckpt.restore_numpy(2)
    ckpt.close()
    out["resumed"] = _train(cfg, meshes["resume"], "eager", 2, data, canon=canon, steps=1)
    # the port's own draw is one logical model on every factorization
    mixed, dp = meshes["mixed"], meshes["dp8"]
    out["own_draw"] = (canonical_params(init_params(cfg, mixed, seed=3, virtual_stages=2),
                                        mixed, virtual_stages=2),
                       canonical_params(init_params(cfg, dp, seed=3), dp))
    return out


@pytest.fixture(scope="module")
def world(jax_side):
    return run_world(f"{__name__}:_rank_main", 8, jax_side["workdir"], timeout=240,
                     device="cpu")


def _assert_params(got, want, atol, exact=False):
    check = np.testing.assert_array_equal if exact else (
        lambda a, b, err_msg: np.testing.assert_allclose(a, b, atol=atol, err_msg=err_msg))
    check(got["embed"], want["embed"], err_msg="embed")
    for k in want["stages"]:
        check(got["stages"][k], np.asarray(want["stages"][k]), err_msg=k)


@pytest.mark.parametrize("name,mode,v", RUNS)
def test_three_steps_match_jax(world, jax_side, name, mode, v):
    want = jax_side[name]
    for res in world:
        losses, canon = res[(name, mode, v)]
        np.testing.assert_allclose(losses, want["losses"], rtol=2e-4)
        _assert_params(canon, want["canon"], atol=1e-5)
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("v", [1, 2])
def test_overlap_is_bit_identical_to_eager(world, v):
    for res in world:
        eager, overlap = res[("mixed", "eager", v)], res[("mixed", "overlap", v)]
        assert eager[0] == overlap[0]
        _assert_params(overlap[1], eager[1], 0.0, exact=True)


def test_factorizations_are_equivalent(world):
    ref = world[0][("dp8", "eager", 1)][0]
    for res in world:
        for run in RUNS:
            np.testing.assert_allclose(res[run][0], ref, rtol=2e-4)


def test_jax_checkpoint_resumes_at_another_factorization(world, jax_side):
    want = jax_side["mixed"]["losses"][2]
    for res in world:
        (loss,), _ = res["resumed"]
        assert loss == pytest.approx(want, rel=2e-4)
        assert loss < jax_side["mixed"]["losses"][0]


def test_own_draw_is_one_model_on_every_factorization(world):
    mixed, dp8 = world[0]["own_draw"]
    _assert_params(mixed, dp8, 0.0, exact=True)
    assert mixed["stages"]["wqkv"].shape == (4, 32, 3, 32)


@pytest.mark.parametrize("bad", ["n_layers", "virtual_stages", "gather_mode"])
def test_refusals_carry_jax_messages(bad):
    import types

    mesh = types.SimpleNamespace(shape={"pipe": 2, "data": 1, "fsdp": 1, "model": 1},
                                 size=lambda axes: 1)
    if bad == "n_layers":
        with pytest.raises(ValueError, match="not divisible"):
            params_from_canonical({"embed": np.zeros((4, 2)), "stages": {}},
                                  CompositeConfig(n_layers=3), mesh)
    elif bad == "virtual_stages":
        with pytest.raises(ValueError, match="virtual_stages=3"):
            params_from_canonical({"embed": np.zeros((4, 2)), "stages": {}},
                                  CompositeConfig(**CFG), mesh, virtual_stages=3)
    else:
        with pytest.raises(ValueError, match="gather_mode"):
            make_train_step(CompositeConfig(**CFG), mesh, gather_mode="lazy")
