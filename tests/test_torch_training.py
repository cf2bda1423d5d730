"""The port's GPT training path against kubeflow_tpu/models/gpt.py and the
bench's optax step.

The JAX package's flax parameters (and ``jax.grad``'s gradient trees) are
carried into the port with ``params_from_flax``; the same numpy token ids go
through both. JAX's attention runs the Pallas flash kernels in interpret
mode, the port's runs their plain versions through the same
``autograd.Function`` the CUDA kernels use.

Tolerances. f32 logits: 1e-4 (the same math, f32 sums in another order;
tests/test_torch_gpt.py's bound). bf16 logits: 0.05 (activations rounded to
bf16 at other places; one bf16 ULP at magnitude ~3 is 0.016). Losses given
the same inputs: 1e-5. Gradients: atol 2e-4, rtol 2e-3, the bound
tests/test_gpt.py::TestScanBlocks holds two JAX layouts to. Three AdamW
steps: losses within 1e-4.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.models.gpt import blockwise_causal_lm_loss as j_blockwise
from kubeflow_tpu.models.gpt import causal_lm_loss as j_causal
from kubeflow_tpu.models.gpt import stack_block_params
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import (GptConfig, GptLM, blockwise_causal_lm_loss,
                                           causal_lm_loss, causal_plain_attention)
from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.training import gpt as tg

torch.set_num_threads(1)

SHAPE = dict(d_model=64, n_layers=2, n_heads=2, d_ff=128, max_seq=128, vocab_size=101)
L = 32


def _pair(dtype: str = "f32", **kw):
    jcfg = JCfg(**SHAPE, dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16, **kw)
    tcfg = GptConfig(**SHAPE, dtype=torch.float32 if dtype == "f32" else torch.bfloat16, **kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def flax_params():
    jcfg, _ = _pair()
    return JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(1).integers(0, SHAPE["vocab_size"], (2, L)).astype(np.int32)


def _model(tcfg, flax_params, **mode):
    return GptLM.trainable(tcfg, params_from_flax(_np_tree(flax_params), tcfg), **mode)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 0.05)])
def test_training_forward_logits_match_jax(flax_params, ids, dtype, atol):
    jcfg, tcfg = _pair(dtype)
    want = JLM(jcfg).apply({"params": flax_params}, jnp.asarray(ids))
    model = _model(tcfg, flax_params)
    with torch.no_grad():
        got = model(torch.tensor(ids))
        hidden = model(torch.tensor(ids), return_hidden=True)
    assert got.dtype == torch.float32 and got.shape == (2, L, SHAPE["vocab_size"])
    assert hidden.dtype == torch.float32 and hidden.shape == (2, L, SHAPE["d_model"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    want_hidden = JLM(jcfg).apply({"params": flax_params}, jnp.asarray(ids), return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), atol=atol, rtol=0)


def _loss_inputs(vocab=SHAPE["vocab_size"]):
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, L, 16)).astype(np.float32)
    emb = (rng.normal(size=(vocab, 16)) / 4).astype(np.float32)
    ids = rng.integers(0, vocab, (2, L)).astype(np.int32)
    return hidden, emb, ids


def test_causal_lm_loss_matches_jax():
    hidden, emb, ids = _loss_inputs()
    logits = hidden @ emb.T
    want = float(j_causal(jnp.asarray(logits), jnp.asarray(ids)))
    got = float(causal_lm_loss(torch.tensor(logits), torch.tensor(ids)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("block", [128, 100, 37])
def test_blockwise_loss_and_its_gradients_match_jax(block):
    """block 128 > vocab and 37 pad the last chunk (the -1e30 columns);
    100 leaves one real column in the second chunk."""
    hidden, emb, ids = _loss_inputs()
    jloss, jgrads = jax.value_and_grad(
        lambda h, e: j_blockwise(h, e, jnp.asarray(ids), block_size=block), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(emb))
    th = torch.tensor(hidden, requires_grad=True)
    te = torch.tensor(emb, requires_grad=True)
    loss = blockwise_causal_lm_loss(th, te, torch.tensor(ids), block_size=block)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    # and it is the unfused loss
    full = causal_lm_loss(torch.tensor(hidden) @ torch.tensor(emb).T, torch.tensor(ids))
    np.testing.assert_allclose(float(loss.detach()), float(full), atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[0]), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jgrads[1]), atol=2e-4, rtol=2e-3)


def _jax_loss(jcfg, fused):
    model = JLM(jcfg)

    def loss(p, ids):
        if fused:
            hidden = model.apply({"params": p}, ids, return_hidden=True)
            return j_blockwise(hidden, p["embedding"]["embedding"], ids)
        return j_causal(model.apply({"params": p}, ids), ids)
    return loss


@pytest.mark.parametrize("fused", [True, False])
def test_every_gradient_matches_jax_grad(flax_params, ids, fused):
    jcfg, tcfg = _pair()
    jloss, jgrads = jax.value_and_grad(_jax_loss(jcfg, fused))(flax_params, jnp.asarray(ids))
    want = params_from_flax(_np_tree(jgrads), tcfg)
    model = _model(tcfg, flax_params)
    loss = tg.loss_fn(model, torch.tensor(ids), fused_loss=fused)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=2e-4,
                                   rtol=2e-3, err_msg=name)


def test_three_adamw_steps_match_optax(flax_params, ids):
    jcfg, tcfg = _pair()
    loss_fn = _jax_loss(jcfg, fused=True)
    opt = optax.adamw(3e-4, weight_decay=0.01)
    params, state = flax_params, opt.init(flax_params)
    want = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(ids))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    model = _model(tcfg, flax_params)
    topt = tg.make_optimizer(model.parameters())
    got = [float(tg.train_step(model, topt, torch.tensor(ids))) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]
    after = params_from_flax(_np_tree(params), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_optimizer_decays_every_parameter():
    model = GptLM(GptConfig(**SHAPE), device="cpu")
    opt = tg.make_optimizer(model.parameters())
    assert len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert group["weight_decay"] == 0.01 and group["lr"] == 3e-4
    assert len(group["params"]) == len(list(model.parameters()))


def test_remat_gives_the_same_gradients(flax_params, ids):
    _, tcfg = _pair()
    grads = []
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=True)):
        model = _model(cfg, flax_params)
        tg.loss_fn(model, torch.tensor(ids)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        np.testing.assert_allclose(grads[1][name].numpy(), grads[0][name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_stacked_blocks_tree_converts_like_the_unrolled_tree(flax_params, ids):
    jcfg, tcfg = _pair()
    unrolled = params_from_flax(_np_tree(flax_params), tcfg)
    scfg = dataclasses.replace(tcfg, scan_blocks=True)
    stacked = params_from_flax(_np_tree(stack_block_params(flax_params, jcfg.n_layers)), scfg)
    assert sorted(stacked) == sorted(unrolled)
    assert all(torch.equal(stacked[k], unrolled[k]) for k in unrolled)
    # the port's scan_blocks model is the JAX scan model
    sjcfg = dataclasses.replace(jcfg, scan_blocks=True)
    want = JLM(sjcfg).apply({"params": stack_block_params(flax_params, jcfg.n_layers)},
                            jnp.asarray(ids))
    with torch.no_grad():
        got = GptLM.trainable(scfg, stacked)(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    both = dict(_np_tree(flax_params), blocks=_np_tree(
        stack_block_params(flax_params, jcfg.n_layers))["blocks"])
    with pytest.raises(ValueError, match="twice"):
        params_from_flax(both, tcfg)


def test_scan_blocks_with_decode_and_cache_misuse_raise():
    _, tcfg = _pair()
    with pytest.raises(ValueError, match="scan_blocks"):
        GptLM(dataclasses.replace(tcfg, scan_blocks=True), decode=True, device="cpu")
    model = GptLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="takes none"):
        model(torch.zeros((1, 4), dtype=torch.int64), {})


def test_attention_fn_is_injectable_and_plain_attention_is_the_same(flax_params, ids):
    _, tcfg = _pair()
    seen = []

    def spy(q, k, v):
        seen.append(q.shape)
        return causal_plain_attention(q, k, v)

    with torch.no_grad():
        a = _model(tcfg, flax_params)(torch.tensor(ids))
        b = _model(tcfg, flax_params, attention_fn=spy)(torch.tensor(ids))
    assert seen == [(2, L, tcfg.n_heads, tcfg.head_dim)] * tcfg.n_layers
    assert torch.equal(a, b)


def test_train_entry_point_on_the_cpu(capsys):
    tfa.reset_launches()
    out = tg.train(tg.tiny_config(32), batch=2, seq=32, steps=3, seed=0, device="cpu")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert out["tokens_per_step"] == 64 and out["n_params"] > 0
    assert sum(tfa.LAUNCHES.values()) == 0  # the CPU runs the plain versions
    assert tg.main(["--steps", "2", "--tiny", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [__import__("json").loads(line) for line in lines[:2]]
    assert [s["step"] for s in steps] == [1, 2]
    assert all({"loss", "step_ms", "tokens_per_s"} <= set(s) for s in steps)


def test_bench_config_and_flop_count():
    cfg = tg.bench_config()
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_ff, cfg.vocab_size,
            cfg.max_seq, cfg.scan_blocks) == (1024, 24, 16, 4096, 32000, 1024, True)
    n = sum(p.numel() for p in GptLM(cfg, device="meta").parameters())
    # bench.py: 6 N per token plus 3.5 x 2 causal dots (b h L^2 d each) per layer
    want = 6.0 * n * 8 * 1024 + 3.5 * 2 * (8 * 16 * 1024 * 1024 * 64) * 24
    assert tg.flops_per_step(cfg, n, 8, 1024) == want
