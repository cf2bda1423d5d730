"""kubeflow_tpu_torch/models against kubeflow_tpu/models/gpt.py.

The JAX package's flax parameters are carried into the port with
``params_from_flax``; the same numpy token ids go through both. The f32
config's logits agree to atol 1e-4 (same math, f32 sums in another order:
~1e-6 seen). The bf16 config rounds activations to bf16 at other places in
the two frameworks (XLA fuses and keeps f32 inside fusions); its logits, of
magnitude ~3 where one bf16 ULP is 0.016, agree to atol 0.05 (0.021 seen).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.models.gpt import _fresh_cache as j_fresh_cache
from kubeflow_tpu.models.gpt import generate as j_generate
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import (GptConfig, GptLM, _fresh_cache,
                                           generate, init_params, rope)

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)


def _pair(dtype: str):
    jcfg = JCfg(**SHAPE, dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tcfg = GptConfig(**SHAPE, dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def flax_params():
    jcfg, _ = _pair("f32")
    return JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_params_from_flax_round_trip(flax_params):
    _, tcfg = _pair("f32")
    tree = _np_tree(flax_params)
    sd = params_from_flax(tree, tcfg)
    H, D, d = tcfg.n_heads, tcfg.head_dim, tcfg.d_model
    att = tree["block_1"]["attention"]
    np.testing.assert_array_equal(
        sd["block_1.attention.query.weight"].numpy().T.reshape(d, H, D),
        att["query"]["kernel"])
    np.testing.assert_array_equal(
        sd["block_1.attention.out_proj.weight"].numpy().T.reshape(H, D, d),
        att["out_proj"]["kernel"])
    np.testing.assert_array_equal(sd["block_0.mlp.up_proj.weight"].numpy().T,
                                  tree["block_0"]["mlp"]["up_proj"]["kernel"])
    np.testing.assert_array_equal(sd["ln_final.scale"].numpy(), tree["ln_final"]["scale"])
    np.testing.assert_array_equal(sd["embedding.weight"].numpy(),
                                  tree["embedding"]["embedding"])
    # every port parameter is filled, and the module accepts the dict as is
    GptLM.bind(tcfg, sd, decode=True)


def test_params_from_flax_rejects_unused_and_missing_leaves(flax_params):
    _, tcfg = _pair("f32")
    tree = _np_tree(flax_params)
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        params_from_flax(extra, tcfg)
    missing = {k: v for k, v in tree.items() if k != "ln_final"}
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(missing, tcfg)


def test_rope_matches_jax_for_shared_and_per_row_positions():
    from kubeflow_tpu.models.gpt import rope as j_rope

    x = np.random.default_rng(0).normal(size=(2, 5, 3, 8)).astype(np.float32)
    for pos in (np.arange(5), np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])):
        want = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
        got = rope(torch.tensor(x), torch.tensor(pos), 10000.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 0.05)])
def test_prefill_logits_match_jax(flax_params, dtype, atol):
    jcfg, tcfg = _pair(dtype)
    ids = np.random.default_rng(1).integers(0, 101, (2, 12)).astype(np.int32)
    want, _ = JLM(jcfg, decode=True).apply(
        {"params": flax_params, "cache": j_fresh_cache(jcfg, 2)}, jnp.asarray(ids),
        mutable=["cache"])
    model = GptLM.bind(tcfg, params_from_flax(_np_tree(flax_params), tcfg), decode=True)
    cache = _fresh_cache(tcfg, 2, "cpu")
    with torch.no_grad():
        got = model(torch.tensor(ids), cache)
    assert got.dtype == torch.float32 and got.shape == (2, 12, 101)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    assert int(cache["block_0"]["attention"]["cursor"]) == 12


def test_greedy_generate_matches_jax(flax_params):
    jcfg, tcfg = _pair("f32")
    ids = np.random.default_rng(2).integers(0, 101, (3, 9)).astype(np.int32)
    want = np.asarray(j_generate(jcfg, flax_params, jnp.asarray(ids), 24))
    got = generate(tcfg, params_from_flax(_np_tree(flax_params), tcfg), ids, 24,
                   device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_seeded_and_in_vocab():
    cfg = GptConfig.tiny()
    params = init_params(cfg, seed=0, device="cpu")
    ids = np.zeros((2, 4), np.int32)
    runs = [generate(cfg, params, ids, 8, temperature=1.0, device="cpu",
                     generator=torch.Generator().manual_seed(s)) for s in (5, 5)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all()


def test_training_forward_and_cuda_without_a_card_raise(monkeypatch):
    """A MoE config builds (its blocks carry ``moe``, not ``mlp``); every
    module of the port, the public submodules included, takes the port's
    device policy: default "cuda", which raises on a host without it."""
    from kubeflow_tpu_torch.models.gpt import GptAttention, GptBlock, GptMlp, LayerNorm

    cfg = GptConfig.tiny()
    moe = GptLM(GptConfig(**SHAPE, num_experts=2), decode=True, device="cpu")
    assert hasattr(moe.block_0, "moe") and not hasattr(moe.block_0, "mlp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GptLM(GptConfig(**SHAPE, num_experts=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GptLM(cfg, decode=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GptLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    for build in (lambda: LayerNorm(cfg.d_model), lambda: GptMlp(cfg),
                  lambda: GptAttention(cfg), lambda: GptAttention(cfg, decode=True),
                  lambda: GptBlock(cfg), lambda: GptBlock(cfg, decode=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    # "meta" (shapes only) and an explicit "cpu" still build
    assert LayerNorm(8, device="meta").scale.device.type == "meta"
    assert GptBlock(cfg, device="cpu").mlp.up_proj.weight.device.type == "cpu"
