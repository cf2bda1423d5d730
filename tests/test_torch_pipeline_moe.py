"""kubeflow_tpu_torch/parallel/{pipeline,moe}.py against the JAX package.

The JAX side runs in this process on the conftest's virtual CPU devices
(``pipeline_apply`` on a 4-device ``pipe`` mesh, ``MoEMlp`` unsharded);
the port's side runs in one world of 4 gloo ranks spawned once for the
file (``parallel.launch.run_world``), which reads JAX's inputs and weights
as numpy and returns its local results. Each case is its own test.

Tolerances: the pipeline's f32 forward to 1e-5 and its gradients to 1e-4
(JAX's own pipeline tests; ~1e-7 seen); ``mask_bubbles`` bit for bit,
forward and gradients; routing exactly for dispatch, 1e-6 for combine
and the aux loss; ``MoEMlp`` (f32) to 1e-5 forward and 1e-4 gradients,
sharded over ``expert`` or not.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel.launch import run_world
from kubeflow_tpu_torch.parallel.mesh import (BATCH_AXES, MeshConfig, local_batch,
                                              local_shard, make_mesh)
from kubeflow_tpu_torch.parallel.moe import MoEMlp, top_k_routing
from kubeflow_tpu_torch.parallel.pipeline import (deinterleave_stage_params,
                                                  interleave_stage_params, pipeline_apply,
                                                  schedule_stats, stack_stage_params,
                                                  stage_param_spec)

torch.set_num_threads(1)

S, D = 4, 8
#: (virtual_stages, microbatches): GPipe and V = 2, at M = S and M > S
PIPE_CASES = [(1, 4), (1, 8), (2, 4), (2, 8)]
MOE = dict(num_experts=4, d_ff=32, k=2)
ERROR_CASES = {
    "few_micro": dict(V=1, M=3, match="at least as many microbatches"),
    "few_micro_v2": dict(V=2, M=3, match="at least as many microbatches"),
    "leading_dim": dict(V=2, M=8, rows=S, match=r"n_stages\*virtual_stages"),
    "virtual_stages": dict(V=0, M=8, match="virtual_stages"),
}


def _stages(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(D) * 0.1).astype(np.float32)} for _ in range(n)]


def _inputs():
    rng = np.random.default_rng(7)
    pipe = {}
    for V, M in PIPE_CASES:
        pipe[(V, M)] = dict(stages=_stages(S * V, 10 * V + M),
                            x=rng.standard_normal((M, 2, D)).astype(np.float32))
    moe_x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    return {"pipe": pipe, "moe_x": moe_x}


# -- the JAX side (this process) -------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_refs(inputs):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import MeshConfig as JMeshConfig, MoEMlp as JMoE
    from kubeflow_tpu.parallel import interleave_stage_params as j_inter
    from kubeflow_tpu.parallel import make_mesh as j_make_mesh
    from kubeflow_tpu.parallel import pipeline_apply as j_pipe
    from kubeflow_tpu.parallel import stack_stage_params as j_stack

    mesh = j_make_mesh(JMeshConfig(data=1, pipe=S), devices=jax.devices()[:S])

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    refs = {}
    for (V, M), case in inputs["pipe"].items():
        natural = j_stack([jax.tree_util.tree_map(jnp.asarray, s) for s in case["stages"]])
        x = jnp.asarray(case["x"])

        def loss(s, x):
            out = j_pipe(stage_fn, j_inter(s, S, V), x, mesh, virtual_stages=V)
            return jnp.sum(out ** 2), out

        (_, out), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            natural, x)
        refs[("pipe", V, M)] = dict(out=np.asarray(out), gx=np.asarray(gx),
                                    g={k: np.asarray(v) for k, v in g.items()})
    for name, case in ERROR_CASES.items():
        n_rows = case.get("rows", S * max(case["V"], 1))
        natural = j_stack([jax.tree_util.tree_map(jnp.asarray, s)
                           for s in _stages(n_rows, 0)])
        with pytest.raises(ValueError) as err:
            j_pipe(stage_fn, natural, jnp.zeros((case["M"], 2, D)), mesh,
                   virtual_stages=case["V"])
        refs[("error", name)] = str(err.value)

    x = jnp.asarray(inputs["moe_x"])
    moe = JMoE(**MOE, dtype=jnp.float32)
    variables = jax.jit(moe.init)(jax.random.PRNGKey(1), x)

    def moe_loss(v, x):
        y, _ = moe.apply(v, x, mutable=["losses"])
        return jnp.sum(y ** 2), y

    (_, y), (g, gx) = jax.jit(jax.value_and_grad(moe_loss, argnums=(0, 1), has_aux=True))(
        variables, x)
    refs["moe"] = dict(params={k: np.asarray(v) for k, v in variables["params"].items()},
                       y=np.asarray(y), gx=np.asarray(gx),
                       g={k: np.asarray(v) for k, v in g["params"].items()})
    return refs


# -- the port's side (4 spawned ranks) -----------------------------------------------

def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipe_case(mesh, case, V, mask=True):
    natural = stack_stage_params([{k: torch.tensor(v) for k, v in s.items()}
                                  for s in case["stages"]])
    inter = interleave_stage_params(natural, S, V)
    local = {k: local_shard(v, mesh, stage_param_spec(v)).clone().requires_grad_(True)
             for k, v in inter.items()}
    x = torch.tensor(case["x"], requires_grad=True)
    out = pipeline_apply(_stage_fn, local, x, mesh, virtual_stages=V, mask_bubbles=mask)
    (out ** 2).sum().backward()
    return dict(out=out.detach().numpy(), gx=x.grad.numpy(),
                g={k: v.grad.numpy() for k, v in local.items()})


def _rank_main(rank, world, workdir):
    with open(f"{workdir}/inputs.pkl", "rb") as f:
        data = pickle.load(f)
    out = {}
    mesh = make_mesh(MeshConfig(data=1, pipe=S), device="cpu")
    for (V, M), case in data["pipe"].items():
        out[("pipe", V, M)] = _pipe_case(mesh, case, V)
        if M == 8:
            out[("unmasked", V, M)] = _pipe_case(mesh, case, V, mask=False)
    for name, case in ERROR_CASES.items():
        rows = case.get("rows", S * max(case["V"], 1)) // S
        local = {"w": torch.zeros(rows, D, D), "b": torch.zeros(rows, D)}
        try:
            pipeline_apply(_stage_fn, local, torch.zeros(case["M"], 2, D), mesh,
                           virtual_stages=case["V"])
            out[("error", name)] = None
        except ValueError as e:
            out[("error", name)] = str(e)

    # MoE over data 2 x expert 2: tokens split over the batch axes, experts
    # over `expert`; the loss is each batch slice's sum of squares
    moe_mesh = make_mesh(MeshConfig(data=2, expert=2), device="cpu")
    p = data["moe_params"]
    layer = MoEMlp(**MOE, mesh=moe_mesh, dtype=torch.float32, d_model=16, device="cpu")
    layer.load_state_dict({
        "router": torch.tensor(p["router"]),
        "experts_wi": local_shard(torch.tensor(p["experts_wi"]), moe_mesh, ("expert",)),
        "experts_wo": local_shard(torch.tensor(p["experts_wo"]), moe_mesh, ("expert",))})
    x = torch.tensor(local_batch(data["moe_x"], moe_mesh), requires_grad=True)
    y = layer(x)
    (y ** 2).sum().backward()
    grads = {}
    for name, param in layer.named_parameters():
        g = param.grad.contiguous()
        torch.distributed.all_reduce(g, group=moe_mesh.group(BATCH_AXES))
        grads[name] = g.numpy()
    out["moe"] = dict(y=y.detach().numpy(), gx=x.grad.numpy(), g=grads,
                      aux=float(layer.aux_loss))
    out["moe_mesh"] = (moe_mesh.index(BATCH_AXES), moe_mesh.coordinate("expert"))
    return out


@pytest.fixture(scope="module")
def world(inputs, jax_refs, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("pipeline_moe_world"))
    data = dict(inputs, moe_params=jax_refs["moe"]["params"])
    with open(f"{workdir}/inputs.pkl", "wb") as f:
        pickle.dump(data, f)
    return run_world(f"{__name__}:_rank_main", 4, workdir, timeout=180, device="cpu")


def _inter(tree, V):
    return interleave_stage_params({k: torch.tensor(v) for k, v in tree.items()}, S, V)


@pytest.mark.parametrize("V,M", PIPE_CASES)
def test_pipeline_forward_and_gradients_match_jax(world, jax_refs, V, M):
    ref = jax_refs[("pipe", V, M)]
    g_inter = _inter(ref["g"], V)
    for rank, res in enumerate(world):
        got = res[("pipe", V, M)]
        # every stage returns the whole output (replicated over pipe)
        np.testing.assert_allclose(got["out"], ref["out"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["gx"], ref["gx"], atol=1e-4, rtol=1e-4)
        for k, g in got["g"].items():
            want = g_inter[k][rank * V:(rank + 1) * V].numpy()
            np.testing.assert_allclose(g, want, atol=1e-4, rtol=1e-4, err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("V", [1, 2])
def test_mask_bubbles_is_bit_exact_forward_and_backward(world, V):
    for res in world:
        masked, unmasked = res[("pipe", V, 8)], res[("unmasked", V, 8)]
        np.testing.assert_array_equal(masked["out"], unmasked["out"])
        np.testing.assert_array_equal(masked["gx"], unmasked["gx"])
        for k in masked["g"]:
            np.testing.assert_array_equal(masked["g"][k], unmasked["g"][k])


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_pipeline_refusals_carry_jax_messages(world, jax_refs, name):
    want = jax_refs[("error", name)]
    got = world[0][("error", name)]
    assert got is not None, f"{name}: the port did not refuse"
    assert re.search(ERROR_CASES[name]["match"], want)
    assert re.search(ERROR_CASES[name]["match"], got)
    if name.startswith("few_micro") or name == "virtual_stages":
        assert got == want


def test_layout_helpers_and_schedule_match_jax():
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import deinterleave_stage_params as j_deinter
    from kubeflow_tpu.parallel import interleave_stage_params as j_inter
    from kubeflow_tpu.parallel import schedule_stats as j_stats

    stacked = {"w": np.arange(8 * 3, dtype=np.float32).reshape(8, 3)}
    got = interleave_stage_params({"w": torch.tensor(stacked["w"])}, 4, 2)["w"].numpy()
    want = np.asarray(j_inter({"w": jnp.asarray(stacked["w"])}, 4, 2)["w"])
    np.testing.assert_array_equal(got, want)
    back = deinterleave_stage_params({"w": torch.tensor(got)}, 4, 2)["w"].numpy()
    np.testing.assert_array_equal(back, stacked["w"])
    np.testing.assert_array_equal(
        back, np.asarray(j_deinter({"w": jnp.asarray(want)}, 4, 2)["w"]))
    for m, s, v in [(8, 4, 1), (8, 4, 2), (4, 4, 2), (16, 2, 4)]:
        assert schedule_stats(m, s, v) == pytest.approx(j_stats(m, s, v))
    assert stage_param_spec(torch.zeros(8, 3, 2)) == ("pipe", None, None)


def _routing_logits():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    logits[:8] = 0.0                         # exact ties: every expert equal
    logits[8:16, 2] = logits[8:16, 5] = 3.0  # a two-way tie at the top
    return logits


@pytest.mark.parametrize("capacity,k", [(4, 2), (64, 1), (16, 2), (1, 1)])
def test_top_k_routing_matches_jax(capacity, k):
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import top_k_routing as j_route

    logits = _routing_logits()
    jd, jc, ja = j_route(jnp.asarray(logits), 8, capacity=capacity, k=k)
    td, tc, ta = top_k_routing(torch.tensor(logits), 8, capacity, k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)


def test_moe_unsharded_matches_jax(jax_refs, inputs):
    ref = jax_refs["moe"]
    layer = MoEMlp(**MOE, dtype=torch.float32, d_model=16, device="cpu")
    layer.load_state_dict({k: torch.tensor(v) for k, v in ref["params"].items()})
    x = torch.tensor(inputs["moe_x"], requires_grad=True)
    y = layer(x)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), ref["gx"], atol=1e-4, rtol=1e-4)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref["g"][name], atol=1e-4, rtol=1e-4)
    assert layer.aux_loss is not None and np.isfinite(float(layer.aux_loss.detach()))
    assert float(layer.router.grad.abs().max()) > 0.0


@pytest.mark.parametrize("part", ["forward", "gradients"])
def test_moe_sharded_over_expert_matches_unsharded_jax(world, jax_refs, part):
    ref = jax_refs["moe"]
    rows = ref["y"].shape[0] // 2
    for res in world:
        got, (b, e) = res["moe"], res["moe_mesh"]
        sl = slice(b * rows, (b + 1) * rows)
        if part == "forward":
            np.testing.assert_allclose(got["y"], ref["y"][sl], atol=1e-5, rtol=1e-5)
            continue
        np.testing.assert_allclose(got["gx"], ref["gx"][sl], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["g"]["router"], ref["g"]["router"], atol=1e-4,
                                   rtol=1e-4)
        for name in ("experts_wi", "experts_wo"):
            want = ref["g"][name][e * 2:(e + 1) * 2]
            np.testing.assert_allclose(got["g"][name], want, atol=1e-4, rtol=1e-4)
