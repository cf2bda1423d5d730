"""kubeflow_tpu_torch/training/fsdp.py against kubeflow_tpu/training/fsdp.py.

JAX's plain ZeRO-3 GPT step (``FsdpConfig`` of JAX's tests: vocab 64, d 32,
4 heads, ff 64, 3 layers, seq 16; batch 8) runs here on a 4-device
``fsdp`` mesh of the conftest's virtual CPU devices, in both gather modes.
The port runs one world of 4 gloo ranks for the file from JAX's initial
weights and ids, three SGD steps in each mode.

Tolerances: losses to 2e-4 relative and parameters after three steps to
1e-5 (f32 sums in another order); ``eager`` and ``overlap`` give the same
bits, losses and parameters, in JAX's (asserted here too, as JAX's own
test does) and in the port's.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.collectives import gather_global
from kubeflow_tpu_torch.training.fsdp import (BLOCK_SPECS, EMBED_SPEC, FSDP_GATHER_MODES,
                                              FsdpConfig, fsdp_mesh, init_fsdp_params,
                                              local_batch, make_fsdp_train_step,
                                              params_from_canonical)

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=3, seq=16)
BATCH, STEPS = 8, 3


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.training.fsdp import FsdpConfig as JCfg
    from kubeflow_tpu.training.fsdp import fsdp_batch_sharding, fsdp_mesh as j_mesh
    from kubeflow_tpu.training.fsdp import init_fsdp_params as j_init
    from kubeflow_tpu.training.fsdp import make_fsdp_train_step as j_step

    mesh = j_mesh(jax.devices()[:4])
    cfg = JCfg(**CFG)
    ids = np.random.default_rng(42).integers(0, CFG["vocab_size"], (BATCH, CFG["seq"]))
    ids = ids.astype(np.int32)
    init = j_init(jax.random.PRNGKey(0), cfg, mesh)
    out = {"workdir": str(tmp_path_factory.mktemp("fsdp_world"))}
    for mode in ("eager", "overlap"):
        params, step = init, j_step(cfg, mesh, lr=0.1, gather_mode=mode)
        jids = jax.device_put(jnp.asarray(ids), fsdp_batch_sharding(mesh))
        losses = []
        for _ in range(STEPS):
            params, loss = step(params, jids)
            losses.append(float(loss))
        out[mode] = dict(losses=losses,
                         params=jax.tree_util.tree_map(np.asarray, params))
    canon = jax.tree_util.tree_map(np.asarray, init)
    with open(f"{out['workdir']}/inputs.pkl", "wb") as f:
        pickle.dump({"ids": ids, "canon": canon}, f)
    return out


def _whole(params, mesh):
    return {"embed": gather_global(params["embed"], mesh, EMBED_SPEC).numpy(),
            "blocks": {k: gather_global(v, mesh, BLOCK_SPECS[k]).numpy()
                       for k, v in params["blocks"].items()}}


def _rank_main(rank, world, workdir):
    with open(f"{workdir}/inputs.pkl", "rb") as f:
        data = pickle.load(f)
    cfg = FsdpConfig(**CFG)
    mesh = fsdp_mesh(device="cpu")
    ids = local_batch(data["ids"], mesh)
    out = {"local_wqkv": tuple(init_fsdp_params(cfg, mesh)["blocks"]["wqkv"].shape)}
    for mode in FSDP_GATHER_MODES:
        params = params_from_canonical(data["canon"], mesh)
        step = make_fsdp_train_step(cfg, mesh, lr=0.1, gather_mode=mode)
        losses = []
        for _ in range(STEPS):
            params, loss = step(params, ids)
            losses.append(float(loss))
        out[mode] = dict(losses=losses, params=_whole(params, mesh))
    from kubeflow_tpu_torch.training.autotune import autotune_gpt_quick

    out["autotune"] = autotune_gpt_quick(steps=1, device="cpu").to_dict()
    return out


@pytest.fixture(scope="module")
def world(jax_side):
    return run_world(f"{__name__}:_rank_main", 4, jax_side["workdir"], timeout=180,
                     device="cpu")


def _leaves(p):
    yield "embed", p["embed"]
    for k in sorted(p["blocks"]):
        yield k, p["blocks"][k]


@pytest.mark.parametrize("mode", ["eager", "overlap"])
def test_losses_and_params_match_jax(world, jax_side, mode):
    want = jax_side[mode]
    for res in world:
        np.testing.assert_allclose(res[mode]["losses"], want["losses"], rtol=2e-4)
        for (name, got), (_, ref) in zip(_leaves(res[mode]["params"]), _leaves(want["params"])):
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
    assert want["losses"][-1] < want["losses"][0]


def test_overlap_is_bit_identical_to_eager(world, jax_side):
    assert jax_side["eager"]["losses"] == jax_side["overlap"]["losses"]
    for res in world:
        assert res["eager"]["losses"] == res["overlap"]["losses"]
        for (name, a), (_, b) in zip(_leaves(res["eager"]["params"]),
                                     _leaves(res["overlap"]["params"])):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_params_are_sharded_over_the_fsdp_group(world):
    # each rank holds a quarter of the sharded dim, not a replica
    assert world[0]["local_wqkv"] == (CFG["n_layers"], CFG["d_model"] // 4, 3, CFG["d_model"])


def test_modes_registry_and_unknown_mode():
    assert FSDP_GATHER_MODES == ("eager", "overlap")
    with pytest.raises(ValueError, match="gather_mode"):
        make_fsdp_train_step(FsdpConfig(**CFG), None, gather_mode="telepathy")


def test_quick_gpt_sweep_measures_the_gather_mode_rows(world):
    from kubeflow_tpu.training.autotune import gpt_quick_candidates as j_candidates

    for res in world:
        rows = res["autotune"]["candidates"]
        assert [r["knobs"] for r in rows] == j_candidates(4)
        for r in rows:
            assert "gather_mode is measured, not priced" in r["error"]
            assert r["measured_seconds"] > 0 and not r["pruned"]
        assert res["autotune"]["chosen"]["gather_mode"] in FSDP_GATHER_MODES
