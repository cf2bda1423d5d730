"""kubeflow_tpu_torch/training/distill.py against kubeflow_tpu/training/distill.py,
on the CPU.

``draft_config`` and ``init_from_target`` build what JAX's build (the port's
copies, not views of the target). On the same corpus (the port's
``_decode_corpus`` of given prompts equals JAX's ``generate`` on them, f32),
the first step's KL and every gradient match ``jax.value_and_grad`` of JAX's
loss within f32 tolerance (rtol 1e-4, atol 1e-6), and the KL curve over 5
Adam steps matches JAX's (rtol 1e-4); the JAX reference loop is held to the
JAX package's own ``distill_draft`` first. On the JAX test's config
(``tests/test_distill.py``, bf16) the port's distilled draft reaches an
accept rate of at least 0.4, above the self-draft's. With
``checkpoint_dir`` the port saves the draft as JAX does: the JAX
``Checkpointer`` reads it back with JAX's ``spec_draft`` meta (the final KL
within rtol 1e-4 of JAX's own run on the same corpus, the other fields
equal), the JAX ``GptLM`` on the restored tree gives the port draft's
logits within f32 tolerance (rtol 1e-4, atol 1e-6), and a JAX-written
draft becomes the port's ``spec_draft`` through ``params_from_flax``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import kubeflow_tpu.training.distill as jdistill
from kubeflow_tpu.training.checkpoint import Checkpointer as JCheckpointer
from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM, generate as jgenerate
from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig, GptLM
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.training import distill
from kubeflow_tpu_torch.training.checkpoint import Checkpointer

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)
RTOL, ATOL = 1e-4, 1e-6


def _weights(dtype_j, dtype_t):
    jcfg = JCfg(**SHAPE, dtype=dtype_j)
    params = JLM(jcfg).init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]
    cfg = GptConfig(**SHAPE, dtype=dtype_t)
    return jcfg, params, cfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg)


@pytest.fixture(scope="module")
def bf16():
    """The JAX distill test's config (bf16)."""
    return _weights(jnp.bfloat16, torch.bfloat16)


@pytest.fixture(scope="module")
def f32():
    jcfg, jp, cfg, tp = _weights(jnp.float32, torch.float32)
    jdcfg = JCfg(**dict(SHAPE, n_layers=1), dtype=jnp.float32)
    dcfg = dataclasses.replace(distill.draft_config(cfg), dtype=torch.float32)
    prompts = np.random.default_rng(3).integers(0, 101, (16, 16)).astype(np.int32)
    corpus = distill._decode_corpus(cfg, tp, sequences=16, prompt_len=16, decode_len=48,
                                    seed=0, prompts=prompts, device="cpu")
    return jcfg, jp, jdcfg, cfg, tp, dcfg, prompts, corpus


def test_draft_config_and_init_from_target_match_jax(bf16):
    jcfg, jp, cfg, tp = bf16
    for n in (None, 2):
        want, got = jdistill.draft_config(jcfg, n), distill.draft_config(cfg, n)
        for f in ("d_model", "n_layers", "n_heads", "d_ff", "max_seq", "vocab_size",
                  "rope_theta"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    dcfg = distill.draft_config(cfg)
    assert dcfg.n_layers == 1
    dp = distill.init_from_target(dcfg, tp)
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jdistill.init_from_target(jdistill.draft_config(jcfg), jp)), dcfg)
    assert sorted(dp) == sorted(want) == sorted(GptLM(dcfg, device="meta").state_dict())
    assert all(torch.equal(dp[k], want[k]) for k in dp)
    # copies: training the draft must not touch the target
    assert all(dp[k].data_ptr() != tp[k].data_ptr() for k in dp)
    before = tp["block_0.attention.query.weight"].clone()
    dp["block_0.attention.query.weight"].add_(1.0)
    assert torch.equal(tp["block_0.attention.query.weight"], before)


def test_decode_corpus_continues_prompts_as_jax_generate(f32):
    jcfg, jp, _, _, _, _, prompts, corpus = f32
    want = np.asarray(jgenerate(jcfg, jp, jnp.asarray(prompts), max_new_tokens=48))
    assert corpus.shape == (16, 64)
    np.testing.assert_array_equal(corpus, want)


def _jax_reference(jcfg, jp, jdcfg, corpus, steps, lr=1e-3, batch=8, seed=0):
    """JAX's recipe step by step (``kubeflow_tpu/training/distill.py``
    ``step_fn``): the per-step KL, the first step's gradients and the final
    draft params."""
    target, draft = JLM(jcfg), JLM(jdcfg)
    dp = jdistill.init_from_target(jdcfg, jp)
    tx = optax.adam(lr)
    opt = tx.init(dp)

    @jax.jit
    def step(dp, opt, ids):
        tlogits = jax.lax.stop_gradient(target.apply({"params": jp}, ids))

        def loss_fn(p):
            t = jax.nn.log_softmax(tlogits.astype(jnp.float32), -1)
            s = jax.nn.log_softmax(draft.apply({"params": p}, ids).astype(jnp.float32), -1)
            return jnp.mean(jnp.sum(jnp.exp(t) * (t - s), axis=-1))

        loss, grads = jax.value_and_grad(loss_fn)(dp)
        updates, opt = tx.update(grads, opt, dp)
        return optax.apply_updates(dp, updates), opt, loss, grads

    rng = np.random.default_rng(seed + 1)
    losses, first_grads = [], None
    for _ in range(steps):
        ids = jnp.asarray(corpus[rng.integers(0, corpus.shape[0], size=batch)])
        dp, opt, loss, grads = step(dp, opt, ids)
        losses.append(float(loss))
        first_grads = grads if first_grads is None else first_grads
    return losses, first_grads, dp


def test_first_step_kl_gradients_and_kl_curve_match_jax(f32, monkeypatch):
    jcfg, jp, jdcfg, cfg, tp, dcfg, _, corpus = f32
    losses, grads, ref_dp = _jax_reference(jcfg, jp, jdcfg, corpus, steps=5)
    # the reference IS the JAX package's distill_draft on this corpus
    monkeypatch.setattr(jdistill, "_decode_corpus", lambda *a, **k: corpus)
    _, jax_dp = jdistill.distill_draft(jcfg, jp, jdcfg, steps=5)
    assert JMETRICS.gauge("distill_kl").value == pytest.approx(losses[-1], rel=RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(jax_dp), jax.tree_util.tree_leaves(ref_dp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=1e-5)

    # the port's first step: KL and every gradient
    rows = np.random.default_rng(1).integers(0, corpus.shape[0], size=8)
    ids = torch.from_numpy(corpus[rows])
    student = GptLM.trainable(dcfg, distill.init_from_target(dcfg, tp))
    with torch.no_grad():
        tlogits = GptLM.bind(cfg, tp)(ids)
    loss = distill.distill_loss(student(ids), tlogits)
    loss.backward()
    assert loss.item() == pytest.approx(losses[0], rel=RTOL)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads), dcfg)
    got = dict(student.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)

    # the port's KL curve over 5 steps, on the same corpus and rows
    monkeypatch.setattr(distill, "_decode_corpus", lambda *a, **k: corpus)
    curve = []
    steps0 = METRICS.value("distill_steps_total")
    distill.distill_draft(cfg, tp, dcfg, steps=5, device="cpu",
                          on_step=lambda i, kl: curve.append(kl))
    np.testing.assert_allclose(curve, losses, rtol=RTOL)
    assert curve[-1] < curve[0]
    assert METRICS.value("distill_steps_total") - steps0 == 5
    assert METRICS.gauge("distill_kl").value == curve[-1]


def test_distilled_draft_lifts_accept_rate_above_the_floor(bf16):
    """tests/test_distill.py's config and recipe (bf16, 200 steps, 24
    sequences of 16 + 48 tokens): the distilled draft's accept rate is at
    least 0.4 and above the self-draft's, measured by the port's spec
    engine."""
    _, _, cfg, params = bf16
    dcfg = distill.draft_config(cfg)
    self_accept = distill.measure_accept_rate(
        cfg, params, dcfg, distill.init_from_target(dcfg, params), device="cpu")
    _, dp = distill.distill_draft(cfg, params, steps=200, batch=8, sequences=24,
                                  prompt_len=16, decode_len=48, seed=0, device="cpu")
    accept = distill.measure_accept_rate(cfg, params, dcfg, dp, device="cpu")
    assert accept >= 0.4, f"distilled accept {accept:.3f} below the floor"
    assert accept > self_accept, f"the self-draft's is {self_accept:.3f}"
    assert METRICS.gauge("distill_kl").value >= 0.0


def test_mismatched_draft_and_checkpoint_dir_are_refused(tmp_path):
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    params = {k: torch.zeros(v.shape) for k, v in GptLM(cfg, device="meta").state_dict().items()}
    bad = GptConfig(**dict(SHAPE, n_layers=1, vocab_size=99))
    with pytest.raises(ValueError, match="vocab"):
        distill.distill_draft(cfg, params, bad, steps=1, device="cpu")
    # an unusable checkpoint_dir (a file) is refused before any step runs
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    steps0 = METRICS.value("distill_steps_total")
    with pytest.raises(OSError):
        distill.distill_draft(cfg, params, steps=1, checkpoint_dir=str(blocker), device="cpu")
    assert METRICS.value("distill_steps_total") == steps0


def test_checkpointed_draft_reads_back_in_both_packages(f32, monkeypatch, tmp_path):
    jcfg, jp, jdcfg, cfg, tp, dcfg, _, corpus = f32
    monkeypatch.setattr(distill, "_decode_corpus", lambda *a, **k: corpus)
    monkeypatch.setattr(jdistill, "_decode_corpus", lambda *a, **k: corpus)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _, dp = distill.distill_draft(cfg, tp, dcfg, steps=3, lr=2e-3, seed=0,
                                  checkpoint_dir=port_dir, device="cpu")
    jdistill.distill_draft(jcfg, jp, jdcfg, steps=3, lr=2e-3, seed=0, checkpoint_dir=jax_dir)
    assert JCheckpointer(port_dir).latest_step() == 3
    tree, meta = JCheckpointer(port_dir).restore_numpy()
    _, jmeta = JCheckpointer(jax_dir).restore_numpy()
    assert meta["kind"] == "spec_draft" and sorted(meta) == sorted(jmeta)
    assert {k: v for k, v in meta.items() if k != "final_kl"} == {
        k: v for k, v in jmeta.items() if k != "final_kl"}
    assert meta["final_kl"] == round(METRICS.gauge("distill_kl").value, 6)
    assert meta["final_kl"] == pytest.approx(jmeta["final_kl"], rel=RTOL)
    # the JAX model on the restored tree gives the port draft's logits
    ids = corpus[:2]
    want = np.asarray(JLM(jdcfg).apply({"params": tree}, jnp.asarray(ids)))
    with torch.no_grad():
        got = GptLM.bind(dcfg, dp)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the port reads its own draft back bit for bit, and JAX's as its spec_draft
    ptree, pmeta = Checkpointer(port_dir).restore_numpy()
    assert pmeta == meta
    back = params_from_flax(ptree, dcfg)
    assert sorted(back) == sorted(dp) and all(torch.equal(back[k], dp[k]) for k in dp)
    jtree, _ = Checkpointer(jax_dir).restore_numpy()
    jdp = params_from_flax(jtree, dcfg)
    with torch.no_grad():
        jgot = GptLM.bind(dcfg, jdp)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(jgot, np.asarray(
        JLM(jdcfg).apply({"params": jtree}, jnp.asarray(ids))), rtol=RTOL, atol=ATOL)
