"""kubeflow_tpu_torch/parallel/{mesh,collectives,sharding,distributed,comm}.py
against the JAX package.

Pure parts run in this process: ``MeshConfig.sizes`` and its messages, the
rule tables, JAX's heuristic on flax paths, the bootstrap's identity and
``initialize`` (with ``init_process_group`` stubbed, as JAX's tests stub
``jax.distributed.initialize``), and the communication model (to 1e-12).
One world of 4 gloo ranks, spawned once for the file, checks what needs
process groups: the mesh's row-major coordinates and groups against
JAX's device mesh, each collective and its transpose against the plain
computation on one process, Megatron's f/g at tp=2 (gradients equal the
unsharded MLP's to 1e-5 relative (f32 sums in another order; gradients of
magnitude up to ~50), where a naive all-reduce would double them), and
the sharding of a MoE GPT's state dict against JAX's ``shard_pytree`` on
the same flax tree.
"""

from __future__ import annotations

import pickle
import types

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.gpu.env import env_list_to_dict, torchrun_worker_env
from kubeflow_tpu_torch.gpu.topology import parse_topology
from kubeflow_tpu_torch.parallel import collectives as C
from kubeflow_tpu_torch.parallel import distributed
from kubeflow_tpu_torch.parallel.comm import (collective_wait_seconds, composite_comm_bytes,
                                              composite_param_count, composite_step_flops,
                                              ring_allgather_bytes, ring_allreduce_bytes)
from kubeflow_tpu_torch.parallel.composite import CompositeConfig
from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, CANONICAL_AXES, MeshConfig,
                                              global_batch_divisor, local_shard, make_mesh)
from kubeflow_tpu_torch.parallel.sharding import (FSDP_RULES, REPLICATED_RULES,
                                                  TENSOR_PARALLEL_RULES, LogicalRules,
                                                  _infer_logical_axes, param_specs,
                                                  shard_pytree)

torch.set_num_threads(1)

MOE_GPT = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, d_ff=32, max_seq=32,
               num_experts=4)
ROUTER_TREE = {"router": (16, 8), "gate": (16, 8), "gating": (16, 8), "moe_router": (16, 8),
               "gate_proj": (16, 32), "experts_wi": (4, 16, 32)}
PATHS = [("embedding", "embedding"), ("block_0", "attention", "query", "kernel"),
         ("block_0", "attention", "out_proj", "kernel"), ("block_0", "mlp", "up_proj", "kernel"),
         ("block_0", "mlp", "down_proj", "kernel"), ("block_0", "moe", "router"),
         ("block_0", "moe", "experts_wi"), ("conv1", "kernel"), ("router", "kernel"),
         ("gate_proj", "kernel"), ("experts", "kernel"), ("ln", "scale"), ("dense", "kernel"),
         ("intermediate", "kernel"), ("qkv", "kernel"), ("x",)]


# -- pure parts -------------------------------------------------------------------

@pytest.mark.parametrize("cfg,n", [
    (dict(model=2), 8), (dict(data=2, seq=2, model=2), 8), (dict(), 4),
    (dict(data=1, fsdp=-1), 8), (dict(data=3, model=2), 8), (dict(data=-1, fsdp=-1), 8),
    (dict(model=3), 8), (dict(model=0), 8), (dict(pipe=2, expert=2), 8)])
def test_mesh_config_sizes_and_messages_match_jax(cfg, n):
    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig

    try:
        want = JMeshConfig(**cfg).sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            MeshConfig(**cfg).sizes(n)
        assert str(err.value) == str(e)
        return
    assert MeshConfig(**cfg).sizes(n) == want


def test_axis_vocabulary_and_rule_tables_match_jax():
    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu.parallel import sharding as jsh

    assert CANONICAL_AXES == jmesh.CANONICAL_AXES
    assert BATCH_AXES == jmesh.BATCH_AXES
    for ours, theirs in ((REPLICATED_RULES, jsh.REPLICATED_RULES), (FSDP_RULES, jsh.FSDP_RULES),
                         (TENSOR_PARALLEL_RULES, jsh.TENSOR_PARALLEL_RULES)):
        assert ours.rules == theirs.rules
    rules = LogicalRules.of(embed="fsdp", heads="model")
    assert rules.spec(["embed", None, "heads"]) == ("fsdp", None, "model")
    assert FSDP_RULES.spec(["nonexistent"]) == (None,)
    ext = TENSOR_PARALLEL_RULES.extended(mlp=None)
    assert ext.mesh_axes("mlp") is None and ext.mesh_axes("heads") == "model"
    assert ext.rules == jsh.TENSOR_PARALLEL_RULES.extended(mlp=None).rules


@pytest.mark.parametrize("path", PATHS, ids=["/".join(p) for p in PATHS])
@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_infer_logical_axes_matches_jax(path, rank):
    from kubeflow_tpu.parallel.sharding import _infer_logical_axes as j_infer

    keys = [types.SimpleNamespace(key=p) for p in path]
    want = j_infer(tuple(keys), np.zeros((2,) * rank))
    assert _infer_logical_axes(path, rank) == want


def test_identity_from_torchrun_env():
    env = env_list_to_dict(torchrun_worker_env(parse_topology("h100", "2x8"), "nb", "team-a"))
    ident = distributed.identity_from_env(dict(env, LOCAL_RANK="3"), hostname="nb-1")
    assert (ident.process_id, ident.num_processes, ident.local_rank) == (11, 16, 3)
    assert not ident.is_coordinator and ident.is_distributed
    assert ident.coordinator_address == "nb-0.nb.team-a.svc.cluster.local:29500"
    # RANK, where the launcher set it, wins over the hostname ordinal
    assert distributed.identity_from_env(dict(env, RANK="5"), hostname="nb-1").process_id == 5
    single = distributed.identity_from_env({}, hostname="tpu-vm-1")
    assert (single.process_id, single.num_processes, single.is_distributed) == (0, 1, False)


def test_ordinals_and_refusals_name_the_variable():
    assert distributed.ordinal_from_hostname("nb-train-3") == 3
    assert distributed.ordinal_from_hostname("nb-train-3.nb-train.ns.svc") == 3
    assert distributed.ordinal_from_hostname("plainhost") == 0
    with pytest.raises(ValueError, match="ordinal 5 >= num_processes 2"):
        distributed.identity_from_env({"WORLD_SIZE": "2"}, hostname="nb-5")
    with pytest.raises(ValueError, match="WORLD_SIZE='two'"):
        distributed.identity_from_env({"WORLD_SIZE": "two"}, hostname="nb-0")
    with pytest.raises(ValueError, match="RANK='one'"):
        distributed.identity_from_env({"WORLD_SIZE": "4", "RANK": "one"}, hostname="nb-1")
    with pytest.raises(ValueError, match="LOCAL_RANK='x'"):
        distributed.identity_from_env({"WORLD_SIZE": "4", "LOCAL_RANK": "x"})


def test_initialize_idempotent_until_reset(monkeypatch):
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    env = {"WORLD_SIZE": "2", "MASTER_ADDR": "nb-0.nb.ns.svc", "MASTER_PORT": "29500"}
    distributed.reset_initialized_for_testing()
    try:
        ident = distributed.initialize(env, hostname="nb-1", device="cpu")
        assert ident.process_id == 1 and len(calls) == 1
        assert calls[0]["init_method"] == "tcp://nb-0.nb.ns.svc:29500"
        assert (calls[0]["backend"], calls[0]["rank"], calls[0]["world_size"]) == ("gloo", 1, 2)
        distributed.initialize(env, hostname="nb-1", device="cpu")  # a no-op
        assert len(calls) == 1
        distributed.reset_initialized_for_testing()
        distributed.initialize(env, hostname="nb-1", device="cpu")
        assert len(calls) == 2
        with pytest.raises(RuntimeError, match="MASTER_ADDR"):
            distributed.reset_initialized_for_testing()
            distributed.initialize({"WORLD_SIZE": "2"}, hostname="nb-1", device="cpu")
    finally:
        distributed.reset_initialized_for_testing()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.initialize(env, hostname="nb-1")


def _shape(**sizes):
    full = {a: 1 for a in CANONICAL_AXES}
    full.update(sizes)
    return types.SimpleNamespace(shape=full)


COMM_MESHES = [dict(data=8), dict(fsdp=2, model=2, pipe=2), dict(data=2, fsdp=2, pipe=2),
               dict(data=2, model=4)]


@pytest.mark.parametrize("sizes", COMM_MESHES, ids=[str(m) for m in COMM_MESHES])
def test_comm_model_matches_jax(sizes):
    import jax

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel import comm as jcomm
    from kubeflow_tpu.parallel.composite import CompositeConfig as JCfg

    cfg = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=4, seq=16)
    jmesh = j_make_mesh(JMeshConfig(**{"data": 1, **sizes}), devices=jax.devices())
    mesh = _shape(**sizes)
    for v in (1, 2):
        for mode in ("eager", "overlap", "amortized"):
            for db in (2, 4):
                want = jcomm.composite_comm_bytes(JCfg(**cfg), jmesh, 8, 8, virtual_stages=v,
                                                  gather_mode=mode, dtype_bytes=db)
                got = composite_comm_bytes(CompositeConfig(**cfg), mesh, 8, 8,
                                           virtual_stages=v, gather_mode=mode, dtype_bytes=db)
                assert got.keys() == want.keys()
                for k in want:
                    assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12)
    assert composite_param_count(CompositeConfig(**cfg)) == jcomm.composite_param_count(JCfg(**cfg))
    assert composite_step_flops(CompositeConfig(**cfg), 4096) == pytest.approx(
        jcomm.composite_step_flops(JCfg(**cfg), 4096), rel=1e-12)
    for b, k in ((100.0, 1), (100.0, 4), (3e9, 8)):
        assert ring_allgather_bytes(b, k) == jcomm.ring_allgather_bytes(b, k)
        assert ring_allreduce_bytes(b, k) == jcomm.ring_allreduce_bytes(b, k)
        assert collective_wait_seconds(b * k) == jcomm.collective_wait_seconds(b * k)


# -- the world (4 gloo ranks) ---------------------------------------------------------

def _collectives(mesh, rank):
    """Each collective and its backward on rank-distinct values; returns
    (forward, grad) pairs the parent checks against the plain math."""
    out = {}
    g = mesh.group("model")                      # 2 ranks: model index 0, 1
    i = mesh.index("model")
    x = torch.arange(6.0).reshape(2, 3).add(10 * rank).requires_grad_(True)
    y = C.all_gather(x, g, axis=1)
    (y * torch.arange(12.0).reshape(2, 6)).sum().backward()
    out["all_gather"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.all_gather(x, g, axis=0, backward="slice")
    (y * torch.arange(12.0).reshape(4, 3)).sum().backward()
    out["all_gather_slice"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.all_gather_start(x, g, axis=0).wait()
    (y * 2).sum().backward()
    out["all_gather_start"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.psum(x, g)
    (y * (i + 1)).sum().backward()
    out["psum"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.reduce_from(x, g)
    (y * (i + 1)).sum().backward()
    out["reduce_from"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.copy_to(x, g)
    (y * (i + 1)).sum().backward()
    out["copy_to"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    w = torch.distributed.group.WORLD  # all 4 ranks, ring order
    y = C.ppermute(x, w, [(j, (j + 1) % 4) for j in range(4)])
    (y * (rank + 1)).sum().backward()
    out["ppermute"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    z = torch.arange(8.0).reshape(4, 2).add(100 * rank).requires_grad_(True)
    y = C.all_to_all(z, w)
    (y * torch.arange(8.0).reshape(4, 2)).sum().backward()
    out["all_to_all"] = (y.detach().numpy(), z.grad.numpy())
    return out


def _megatron(mesh):
    """A 2-layer MLP, W1 column- and W2 row-split over model (tp=2) behind
    f/g: loss and gradients, to be equal to the unsharded MLP's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=gen)
    w1, w2 = torch.randn(8, 16, generator=gen), torch.randn(16, 8, generator=gen)
    g = mesh.group("model")
    w1l = local_shard(w1, mesh, (None, "model")).clone().requires_grad_(True)
    w2l = local_shard(w2, mesh, ("model", None)).clone().requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    h = torch.tanh(C.copy_to(xs, g) @ w1l)
    y = C.reduce_from(h @ w2l, g)
    loss = (y ** 2).sum()
    loss.backward()
    return {"loss": float(loss), "gx": xs.grad.numpy(), "gw1": w1l.grad.numpy(),
            "gw2": w2l.grad.numpy(), "x": x.numpy(), "w1": w1.numpy(), "w2": w2.numpy()}


def _rank_main(rank, world, workdir):
    from kubeflow_tpu_torch.models.convert import gpt_flax_layout, params_from_flax
    from kubeflow_tpu_torch.models.gpt import GptConfig

    with open(f"{workdir}/inputs.pkl", "rb") as f:
        data = pickle.load(f)
    out = {}
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    out["coords"] = {a: mesh.coordinate(a) for a in CANONICAL_AXES}
    out["groups"] = {a: mesh.group_ranks(a) for a in CANONICAL_AXES}
    out["batch_group"] = mesh.group_ranks(BATCH_AXES)
    out["divisor"] = global_batch_divisor(mesh)
    out["collectives"] = _collectives(mesh, rank)
    out["megatron"] = _megatron(mesh)

    sh_mesh = make_mesh(MeshConfig(data=1, fsdp=2, model=2), device="cpu")
    cfg = GptConfig(**MOE_GPT, dtype=torch.float32)
    params = params_from_flax(data["gpt_tree"], cfg)
    layout = gpt_flax_layout(cfg)
    specs = param_specs(params, sh_mesh, TENSOR_PARALLEL_RULES, layout)
    out["gpt_specs"] = {n: (layout(n, tuple(params[n].shape)), s) for n, s in specs.items()}
    local = shard_pytree(params, sh_mesh, TENSOR_PARALLEL_RULES, layout)
    out["gpt_local_shapes"] = {n: tuple(t.shape) for n, t in local.items()}
    plain = {n: torch.zeros(s) for n, s in data["router_tree"].items()}
    out["router_specs"] = param_specs(
        {f"{n}.kernel" if n != "experts_wi" else f"moe_{n}.kernel": t
         for n, t in plain.items()}, sh_mesh, TENSOR_PARALLEL_RULES)
    return out


@pytest.fixture(scope="module")
def gpt_tree():
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM

    jcfg = JCfg(**MOE_GPT, dtype=jnp.float32)
    params = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def world(gpt_tree, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("parallel_world"))
    with open(f"{workdir}/inputs.pkl", "wb") as f:
        pickle.dump({"gpt_tree": gpt_tree, "router_tree": ROUTER_TREE}, f)
    return run_world(f"{__name__}:_rank_main", 4, workdir, timeout=180, device="cpu")


def test_mesh_coordinates_and_groups_follow_jax_device_order(world):
    import jax

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh

    jmesh = j_make_mesh(JMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)  # [data, fsdp, pipe, expert, seq, model]
    for rank, res in enumerate(world):
        coords = res["coords"]
        assert ids[tuple(coords[a] for a in CANONICAL_AXES)] == rank
        for axis in CANONICAL_AXES:
            pos = CANONICAL_AXES.index(axis)
            index = [coords[a] for a in CANONICAL_AXES]
            index[pos] = slice(None)
            assert res["groups"][axis] == ids[tuple(index)].tolist()
        assert res["divisor"] == 2
        assert res["batch_group"] == [r for r in range(4)
                                      if world[r]["coords"]["model"] == coords["model"]]


def _expected_collective(name, rank):
    """(forward, grad) of each collective on rank ``rank`` by the plain math
    (ranks 2m + i: data m, model i)."""
    def xval(r):
        return np.arange(6.0).reshape(2, 3) + 10 * r

    data, i = divmod(rank, 2)
    pair = [2 * data, 2 * data + 1]
    if name == "all_gather":
        fwd = np.concatenate([xval(r) for r in pair], axis=1)
        ct = np.arange(12.0).reshape(2, 6)
        return fwd, 2 * ct[:, 3 * i:3 * i + 3]           # both ranks' cotangents summed
    if name == "all_gather_slice":
        fwd = np.concatenate([xval(r) for r in pair], axis=0)
        return fwd, np.arange(12.0).reshape(4, 3)[2 * i:2 * i + 2]
    if name == "all_gather_start":
        return np.concatenate([xval(r) for r in pair], axis=0), np.full((2, 3), 4.0)
    total = xval(pair[0]) + xval(pair[1])
    if name == "psum":
        return total, np.full((2, 3), 3.0)                # 1 + 2 summed back
    if name == "reduce_from":
        return total, np.full((2, 3), i + 1.0)            # identity backward
    if name == "copy_to":
        return xval(rank), np.full((2, 3), 3.0)           # summed backward
    if name == "ppermute":
        return xval((rank - 1) % 4), np.full((2, 3), ((rank + 1) % 4) + 1.0)
    if name == "all_to_all":
        z = [np.arange(8.0).reshape(4, 2) + 100 * r for r in range(4)]
        fwd = np.stack([z[j][rank] for j in range(4)])
        return fwd, np.stack([np.arange(8.0).reshape(4, 2)[rank] for _ in range(4)])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["all_gather", "all_gather_slice", "all_gather_start", "psum",
                                  "reduce_from", "copy_to", "ppermute", "all_to_all"])
def test_collective_and_its_transpose(world, name):
    for rank, res in enumerate(world):
        fwd, grad = res["collectives"][name]
        want_fwd, want_grad = _expected_collective(name, rank)
        np.testing.assert_array_equal(fwd, want_fwd, err_msg=f"{name} rank {rank}")
        np.testing.assert_array_equal(grad, want_grad, err_msg=f"{name} grad rank {rank}")


def test_megatron_f_g_gradients_equal_the_unsharded_mlp(world):
    ref = world[0]["megatron"]
    x = torch.tensor(ref["x"], requires_grad=True)
    w1 = torch.tensor(ref["w1"], requires_grad=True)
    w2 = torch.tensor(ref["w2"], requires_grad=True)
    loss = ((torch.tanh(x @ w1) @ w2) ** 2).sum()
    loss.backward()
    for rank, res in enumerate(world):
        got = res["megatron"]
        i = rank % 2
        assert got["loss"] == pytest.approx(float(loss.detach()), rel=1e-6)
        np.testing.assert_allclose(got["gx"], x.grad.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["gw1"], w1.grad.numpy()[:, 8 * i:8 * i + 8], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(got["gw2"], w2.grad.numpy()[8 * i:8 * i + 8], rtol=1e-5,
                                   atol=1e-4)


def test_moe_gpt_state_dict_gets_jax_specs(world, gpt_tree):
    import jax

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel.sharding import TENSOR_PARALLEL_RULES as J_TP
    from kubeflow_tpu.parallel.sharding import shard_pytree as j_shard

    jmesh = j_make_mesh(JMeshConfig(data=1, fsdp=2, model=2), devices=jax.devices()[:4])
    jspecs = dict(jax.tree_util.tree_flatten_with_path(j_shard(gpt_tree, jmesh, J_TP))[0])
    by_path = {tuple(k.key for k in path): tuple(s.spec) for path, s in jspecs.items()}
    res = world[0]
    assert len(res["gpt_specs"]) == len(by_path)
    for name, ((path, flax_shape, groups), spec) in res["gpt_specs"].items():
        want = by_path[path]
        assert spec == tuple(want[g[0]] for g in groups), name
    # the port's layouts: q/k/v [H*D, d] over (model, fsdp); experts on no axis
    # (JAX's heuristic classifies them by their owning module "moe")
    assert res["gpt_specs"]["block_0.attention.query.weight"][1] == ("model", "fsdp")
    assert res["gpt_specs"]["block_0.moe.experts_wi"][1] == (None, None, None)
    assert res["gpt_specs"]["block_0.moe.router"][1] == ("fsdp", None)
    shapes = res["gpt_local_shapes"]
    assert shapes["block_0.attention.query.weight"] == (8, 8)
    assert shapes["embedding.weight"] == (32, 8)


def test_router_and_gate_kernels_replicate_as_in_jax(world):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel.sharding import TENSOR_PARALLEL_RULES as J_TP
    from kubeflow_tpu.parallel.sharding import shard_pytree as j_shard

    jmesh = j_make_mesh(JMeshConfig(data=1, fsdp=2, model=2), devices=jax.devices()[:4])
    tree = {n if n != "experts_wi" else f"moe_{n}": {"kernel": jnp.zeros(s)}
            for n, s in ROUTER_TREE.items()}
    jspecs = j_shard(tree, jmesh, J_TP)
    specs = world[0]["router_specs"]
    for name in tree:
        assert specs[f"{name}.kernel"] == tuple(jspecs[name]["kernel"].spec), name
    for name in ("router", "gate", "gating", "moe_router"):
        assert specs[f"{name}.kernel"] == (None, None), name
    assert specs["gate_proj.kernel"] == (None, "model")


def _rank_fails(rank, world, workdir):
    if rank == 1:
        raise ValueError("rank one refuses")
    torch.distributed.barrier()  # rank 0 would wait here for ever


def test_run_world_kills_the_world_when_a_rank_fails(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="exited(.|\n)*rank one refuses"):
        run_world(f"{__name__}:_rank_fails", 2, str(tmp_path), timeout=60, device="cpu",
                  pg_timeout=30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_world(f"{__name__}:_rank_fails", 2, str(tmp_path))
