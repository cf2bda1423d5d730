"""kubeflow_tpu_torch/parallel/ring_attention.py against JAX ``ring_attention``.

The JAX side runs ``ring_attention`` (jitted, with its gradients through a
fixed random cotangent) on 4-device meshes of the conftest's virtual CPU
devices: ``seq 4``, ``data 2 x seq 2`` and ``seq 2 x model 2`` (heads split
over ``model``). The port's side runs one world of 4 gloo ranks for the
file: each rank takes its blocks of q/k/v (``ring_spec``) and the
cotangent, and returns its output block and q/k/v gradient blocks, which
are held against the matching blocks of JAX's global arrays. On CPU tensors
the ring calls the flash kernels' plain versions.

Tolerances: f32 to 1e-5 (out) and 1e-4 (gradients), ~1e-6 seen. bf16 to
0.05 and 0.1: the port rounds each block's output to bf16 before its f32
merge and runs the backward from the bf16 global output, where JAX keeps
one f32 accumulator and differentiates through it (values of magnitude
~1, where one bf16 ULP is 2^-8).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, local_shard, make_mesh
from kubeflow_tpu_torch.parallel.ring_attention import full_attention, ring_attention, ring_spec

torch.set_num_threads(1)

B, L, H, D = 2, 32, 4, 8
MESHES = {"seq4": dict(data=1, seq=4), "data2_seq2": dict(data=2, seq=2),
          "seq2_model2": dict(data=1, seq=2, model=2)}
CASES = [(m, causal, dtype) for m in sorted(MESHES) for causal in (False, True)
         for dtype in ("f32", "bf16")]
TOL = {"f32": (1e-5, 1e-4), "bf16": (0.05, 0.1)}


def _inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((B, L, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "ct")}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_refs(inputs):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel.ring_attention import ring_attention as j_ring

    refs = {}
    for name, cfg in MESHES.items():
        mesh = j_make_mesh(JMeshConfig(**cfg), devices=jax.devices()[:4])
        for causal in (False, True):
            for dtype in ("f32", "bf16"):
                dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
                q, k, v = (jnp.asarray(inputs[n], dt) for n in "qkv")
                ct = jnp.asarray(inputs["ct"])

                def loss(q, k, v):
                    out = j_ring(q, k, v, mesh, causal=causal)
                    return jnp.sum(out.astype(jnp.float32) * ct), out

                (_, out), grads = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
                refs[(name, causal, dtype)] = [np.asarray(a, np.float32)
                                               for a in (out, *grads)]
    return refs


def _rank_main(rank, world, workdir):
    with open(f"{workdir}/inputs.pkl", "rb") as f:
        data = pickle.load(f)
    out = {}
    for name, cfg in MESHES.items():
        mesh = make_mesh(MeshConfig(**cfg), device="cpu")
        spec = ring_spec(mesh, H)
        for causal in (False, True):
            for dtype in ("f32", "bf16"):
                dt = torch.float32 if dtype == "f32" else torch.bfloat16
                q, k, v = (torch.tensor(local_shard(data[n], mesh, spec)).to(dt)
                           .requires_grad_(True) for n in "qkv")
                ct = torch.tensor(local_shard(data["ct"], mesh, spec))
                o = ring_attention(q, k, v, mesh, causal=causal)
                (o.float() * ct).sum().backward()
                out[(name, causal, dtype)] = [t.detach().float().numpy()
                                              for t in (o, q.grad, k.grad, v.grad)]
        out[(name, "spec")] = spec
        # which elements of the global arrays this rank holds
        out[(name, "index")] = local_shard(np.arange(B * L * H * D).reshape(B, L, H, D),
                                           mesh, spec)
    return out


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("ring_world"))
    with open(f"{workdir}/inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return run_world(f"{__name__}:_rank_main", 4, workdir, timeout=180, device="cpu")


@pytest.mark.parametrize("mesh_name,causal,dtype", CASES)
def test_ring_attention_out_and_grads_match_jax(world, jax_refs, mesh_name, causal, dtype):
    atol_out, atol_grad = TOL[dtype]
    ref = jax_refs[(mesh_name, causal, dtype)]
    for rank, res in enumerate(world):
        index = res[(mesh_name, "index")]
        for i, (got, want) in enumerate(zip(res[(mesh_name, causal, dtype)], ref)):
            tol = atol_out if i == 0 else atol_grad
            np.testing.assert_allclose(got, want.reshape(-1)[index], atol=tol,
                                       rtol=tol, err_msg=f"{'out dq dk dv'.split()[i]} "
                                                         f"rank {rank}")


def test_ring_spec_shards_heads_over_model_where_they_divide(world):
    assert world[0][("seq2_model2", "spec")] == (("data", "fsdp"), "seq", "model", None)
    assert world[0][("seq4", "spec")] == (("data", "fsdp"), "seq", None, None)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(inputs, causal):
    import jax.numpy as jnp

    from kubeflow_tpu.parallel.ring_attention import full_attention as j_full

    q, k, v = (inputs[n] for n in "qkv")
    want = np.asarray(j_full(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    got = full_attention(*(torch.tensor(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
