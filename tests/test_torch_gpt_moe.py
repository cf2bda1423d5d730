"""GptBlock with experts (``num_experts > 0``) against kubeflow_tpu/models/gpt.py.

A toy MoE GPT (4 experts, top-2, f32) with JAX's flax weights carried in
by ``params_from_flax`` (``block_i/moe/{router, experts_wi, experts_wo}``):
the training forward's logits and every gradient of the loss, the decode
prefill, and the greedy tokens of the serving engine in the paged and
contiguous layouts, each against the JAX package on the same weights and
prompts. The engines route every row of each call, padded slots
included, so their capacity drops match JAX's and so do the tokens
(requests go one at a time: which requests share a call is timing, and
it changes the drops in either package).

Tolerances: logits to 1e-4 and gradients to 2e-4 (f32 sums in another
order), tokens exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu_torch.models.convert import params_from_flax, params_to_flax
from kubeflow_tpu_torch.models.gpt import GptConfig, GptLM, init_params
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.training import gpt as tg

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101,
             num_experts=4, moe_k=2)
PROMPT_LENS = (7, 12, 30, 5)
BUDGETS = (10, 6, 9, 20)
LAYOUTS = {"paged": dict(paged=True), "contiguous": dict(paged=False)}


@pytest.fixture(scope="module")
def weights():
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    tcfg = GptConfig(**SHAPE, dtype=torch.float32)
    params = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = params["params"]
    return jcfg, params, tcfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)


def _ids():
    return np.random.default_rng(1).integers(0, SHAPE["vocab_size"], (2, 24)).astype(np.int32)


def test_moe_leaves_carry_both_ways(weights):
    _, jparams, tcfg, tparams = weights
    assert tparams["block_1.moe.experts_wi"].shape == (4, 32, 64)
    assert tparams["block_0.moe.router"].shape == (32, 4)
    assert not any(".mlp." in n for n in tparams)
    back = params_to_flax(tparams, tcfg)
    for leaf in ("router", "experts_wi", "experts_wo"):
        np.testing.assert_array_equal(back["block_0"]["moe"][leaf],
                                      np.asarray(jparams["block_0"]["moe"][leaf]))
    seeded = init_params(GptConfig(**SHAPE), seed=0, device="cpu")
    assert seeded.keys() == tparams.keys()
    # flax's lecun scale: std 1/sqrt(fan_in), the router's fan-in its rows
    assert float(seeded["block_0.moe.router"].std()) == pytest.approx(32 ** -0.5, rel=0.3)
    assert float(seeded["block_0.moe.experts_wo"].std()) == pytest.approx(64 ** -0.5, rel=0.1)


def test_training_forward_and_gradients_match_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    ids = _ids()

    def jloss(p, ids):
        return tg_jax_loss(jcfg, p, ids)

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(jparams, jnp.asarray(ids))
    logits_j = jax.jit(JLM(jcfg).apply)({"params": jparams}, jnp.asarray(ids))
    model = GptLM.trainable(tcfg, tparams)
    with torch.no_grad():
        logits = model(torch.tensor(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), atol=1e-4, rtol=0)
    loss = tg.loss_fn(model, torch.tensor(ids), fused_loss=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), atol=1e-5, rtol=0)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-4, rtol=0,
                                   err_msg=name)
    assert all(b.moe.aux_loss is not None for b in (model.block_0, model.block_1))


def tg_jax_loss(jcfg, p, ids):
    from kubeflow_tpu.models.gpt import causal_lm_loss as j_causal

    return j_causal(JLM(jcfg).apply({"params": p}, ids), ids)


def test_decode_prefill_matches_jax(weights):
    from kubeflow_tpu.models.gpt import _fresh_cache as j_fresh
    from kubeflow_tpu_torch.models.gpt import _fresh_cache

    jcfg, jparams, tcfg, tparams = weights
    ids = _ids()
    jmodel = JLM(jcfg, decode=True)
    want, _ = jax.jit(lambda p, c, i: jmodel.apply({"params": p, "cache": c}, i,
                                                   mutable=["cache"]))(
        jparams, j_fresh(jcfg, 2), jnp.asarray(ids))
    with torch.no_grad():
        got = GptLM.bind(tcfg, tparams, decode=True)(torch.tensor(ids),
                                                    _fresh_cache(tcfg, 2, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, SHAPE["vocab_size"], n).astype(np.int32) for n in PROMPT_LENS]


def _serve(engine):
    """One request at a time: a MoE block's capacity is shared by every row
    of a call, so which requests share a wave or a decode step changes the
    tokens; alone, each request's rows and the idle slot's padded row are
    the same in both packages."""
    try:
        return [engine.submit(p, n).result(timeout=300) for p, n in zip(_prompts(), BUDGETS)]
    finally:
        engine.close()


@pytest.mark.parametrize("layout,slots", [("paged", 1), ("contiguous", 1), ("contiguous", 2)])
def test_engine_greedy_tokens_match_jax_engine(weights, layout, slots):
    """slots=2: the idle slot's row and the prefill group's padding row
    take expert capacity too. The JAX paged engine at slots=2 is not
    repeatable from run to run with experts (its idle slot reads the trash
    block, whose contents follow the engine's history: ROADMAP.md C), so
    the paged layout is held at one slot."""
    jcfg, jparams, tcfg, tparams = weights
    want = _serve(JBatcher(jcfg, jparams, slots=slots, kv_kernel=True, **LAYOUTS[layout]))
    got = _serve(ContinuousBatcher(tcfg, tparams, slots=slots, kv_kernel=True, device="cpu",
                                   **LAYOUTS[layout]))
    assert got == want
    assert [len(t) for t in got] == list(BUDGETS)
