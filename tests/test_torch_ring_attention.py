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
4e-3 and 2e-2: like JAX's one f32 accumulator, the port merges each
block's f32 output in f32 and rounds the global output once, and its
backward takes ``delta`` from that unrounded output, as JAX's autodiff
through the accumulator does. ``out`` then differs from JAX's by at most
rounding of nearly equal f32 values; the gradients by about one bf16 ULP
at magnitude 2-3 (2^-7) on the ``seq4`` ring, where JAX sums dk/dv in bf16
through its transposed ``ppermute`` chain and the port in f32.

One case runs at head_dim 16, BERT-tiny's and GPT-tiny's width, which the
flash kernels take natively on the card.
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
TOL = {"f32": (1e-5, 1e-4), "bf16": (4e-3, 2e-2)}
# (mesh, causal, dtype) of the head_dim-16 cases
D16, D16_CASES = 16, [("seq4", True, "f32"), ("seq4", True, "bf16")]


def _inputs():
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal((B, L, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "ct")}
    data.update({(n, D16): rng.standard_normal((B, L, H, D16)).astype(np.float32)
                 for n in ("q", "k", "v", "ct")})
    return data


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_refs(inputs):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
    from kubeflow_tpu.parallel.ring_attention import ring_attention as j_ring

    def run(mesh, causal, dtype, d):
        dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        key = (lambda n: n) if d == D else (lambda n: (n, d))
        q, k, v = (jnp.asarray(inputs[key(n)], dt) for n in "qkv")
        ct = jnp.asarray(inputs[key("ct")])

        def loss(q, k, v):
            out = j_ring(q, k, v, mesh, causal=causal)
            return jnp.sum(out.astype(jnp.float32) * ct), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        return [np.asarray(a, np.float32) for a in (out, *grads)]

    refs = {}
    meshes = {name: j_make_mesh(JMeshConfig(**cfg), devices=jax.devices()[:4])
              for name, cfg in MESHES.items()}
    for name, causal, dtype in CASES:
        refs[(name, causal, dtype)] = run(meshes[name], causal, dtype, D)
    for name, causal, dtype in D16_CASES:
        refs[(name, causal, dtype, D16)] = run(meshes[name], causal, dtype, D16)
    return refs


def _rank_main(rank, world, workdir):
    with open(f"{workdir}/inputs.pkl", "rb") as f:
        data = pickle.load(f)
    def run(mesh, spec, causal, dtype, d):
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        key = (lambda n: n) if d == D else (lambda n: (n, d))
        q, k, v = (torch.tensor(local_shard(data[key(n)], mesh, spec)).to(dt)
                   .requires_grad_(True) for n in "qkv")
        ct = torch.tensor(local_shard(data[key("ct")], mesh, spec))
        o = ring_attention(q, k, v, mesh, causal=causal)
        assert o.dtype == dt
        (o.float() * ct).sum().backward()
        return [t.detach().float().numpy() for t in (o, q.grad, k.grad, v.grad)]

    out = {}
    for name, cfg in MESHES.items():
        mesh = make_mesh(MeshConfig(**cfg), device="cpu")
        spec = ring_spec(mesh, H)
        for causal in (False, True):
            for dtype in ("f32", "bf16"):
                out[(name, causal, dtype)] = run(mesh, spec, causal, dtype, D)
        for m, causal, dtype in D16_CASES:
            if m == name:
                out[(name, causal, dtype, D16)] = run(mesh, spec, causal, dtype, D16)
                out[(name, "index", D16)] = local_shard(
                    np.arange(B * L * H * D16).reshape(B, L, H, D16), mesh, spec)
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


def _check(world, ref, key, index_key, dtype):
    atol_out, atol_grad = TOL[dtype]
    for rank, res in enumerate(world):
        index = res[index_key]
        for i, (got, want) in enumerate(zip(res[key], ref)):
            tol = atol_out if i == 0 else atol_grad
            np.testing.assert_allclose(got, want.reshape(-1)[index], atol=tol,
                                       rtol=tol, err_msg=f"{'out dq dk dv'.split()[i]} "
                                                         f"rank {rank}")


@pytest.mark.parametrize("mesh_name,causal,dtype", CASES)
def test_ring_attention_out_and_grads_match_jax(world, jax_refs, mesh_name, causal, dtype):
    key = (mesh_name, causal, dtype)
    _check(world, jax_refs[key], key, (mesh_name, "index"), dtype)


@pytest.mark.parametrize("mesh_name,causal,dtype", D16_CASES)
def test_ring_attention_at_head_dim_16_matches_jax(world, jax_refs, mesh_name, causal, dtype):
    key = (mesh_name, causal, dtype, D16)
    _check(world, jax_refs[key], key, (mesh_name, "index", D16), dtype)


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
