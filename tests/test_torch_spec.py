"""Speculative decoding in kubeflow_tpu_torch/serving/continuous.py against the
JAX engine's, on the CPU.

The JAX test config (``tests/test_continuous_batching.py``'s ``CFG`` and
``MIXED_JOBS``) in f32, the self-draft (the target's bottom block and
embeddings, ``init_from_target``) on both sides. In every layout (paged
bf16, contiguous, paged int8, chunked prefill) and for ``spec_k`` 2-4 the
port's spec engine gives the JAX spec engine's greedy tokens and its
plain engine's, and the drafted/accepted counters equal JAX's on the same
jobs. Then sampled slots, a draft equal to the target (m = k every round)
and the ``max_seq`` edge. (The card's test of a spec round is in
``tests/test_torch_kv_cache.py``, which the card's machine can import.)
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.training.distill import init_from_target as j_init_from_target
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.training.distill import draft_config, init_from_target

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)
MIXED_JOBS = [(1, 3, 6), (2, 17, 9), (3, 7, 4), (4, 30, 11), (5, 12, 5),
              (6, 5, 8), (7, 21, 7)]  # (seed, prompt_len, budget)
#: layout -> (engine options, spec_k): spec_k 2-4 across the layouts
LAYOUTS = {"paged_bf16": (dict(paged=True), 2),
           "contiguous": (dict(paged=False), 3),
           "paged_int8": (dict(paged=True, kv_dtype="int8"), 4),
           "chunked": (dict(paged=True, prefill_chunk=16), 4)}
COUNTERS = ("serving_spec_tokens_drafted_total", "serving_spec_tokens_accepted_total")


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, params, draft cfg, draft params), (the port's, converted)."""
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    params = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jdcfg = JCfg(**dict(SHAPE, n_layers=1), dtype=jnp.float32)
    tcfg = GptConfig(**SHAPE, dtype=torch.float32)
    tparams = params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    tdcfg = dataclasses.replace(draft_config(tcfg), dtype=torch.float32)
    return ((jcfg, params, jdcfg, j_init_from_target(jdcfg, params)),
            (tcfg, tparams, tdcfg, init_from_target(tdcfg, tparams)))


def _jobs(jobs=MIXED_JOBS):
    return [(np.random.default_rng(s).integers(0, 101, n).astype(np.int32), b)
            for s, n, b in jobs]


def _run(engine, jobs, temperature=0.0):
    try:
        futs = [engine.submit(p, b, temperature=temperature) for p, b in jobs]
        return [f.result(timeout=300) for f in futs]
    finally:
        engine.close()


def _counted(metrics, run):
    before = [metrics.counter(c).value for c in COUNTERS]
    out = run()
    return out, [metrics.counter(c).value - b for c, b in zip(COUNTERS, before)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_tokens_and_counters_match_jax_and_plain(weights, layout):
    (jcfg, jp, jdcfg, jdp), (tcfg, tp, tdcfg, tdp) = weights
    opts, k = LAYOUTS[layout]
    jobs = _jobs()
    want, jcounts = _counted(JMETRICS, lambda: _run(JBatcher(
        jcfg, jp, slots=3, spec_draft=(jdcfg, jdp), spec_k=k, **opts), jobs))
    got, tcounts = _counted(METRICS, lambda: _run(ContinuousBatcher(
        tcfg, tp, slots=3, spec_draft=(tdcfg, tdp), spec_k=k, device="cpu", **opts), jobs))
    plain = _run(ContinuousBatcher(tcfg, tp, slots=3, device="cpu", **opts), jobs)
    assert got == want
    assert got == plain
    assert [len(t) for t in got] == [b for _, b in jobs]
    assert tcounts == jcounts and tcounts[0] > 0


def test_sampled_slots_keep_their_budgets(weights):
    _, (tcfg, tp, tdcfg, tdp) = weights
    jobs = _jobs([(9, 7, 6), (11, 12, 4), (12, 20, 9)])
    rounds0 = METRICS.value("serving_spec_rounds_total")
    out = _run(ContinuousBatcher(tcfg, tp, slots=2, spec_draft=(tdcfg, tdp), spec_k=3,
                                 seed=5, device="cpu"), jobs, temperature=0.8)
    assert [len(t) for t in out] == [6, 4, 9]
    assert all(0 <= t < 101 for toks in out for t in toks)
    assert METRICS.value("serving_spec_rounds_total") > rounds0


def test_a_draft_equal_to_the_target_accepts_every_draft(weights):
    _, (tcfg, tp, _, _) = weights
    jobs = _jobs()[:4]
    out, (drafted, accepted) = _counted(METRICS, lambda: _run(ContinuousBatcher(
        tcfg, tp, slots=2, spec_draft=(tcfg, tp), spec_k=4, device="cpu"), jobs))
    assert out == _run(ContinuousBatcher(tcfg, tp, slots=2, device="cpu"), jobs)
    assert drafted > 0 and accepted == drafted  # m = k in every counted round


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_max_seq_edge_pinned_to_jax(weights, paged):
    """prompt + budget == max_seq: the last rounds start within spec_k of
    max_seq. The contiguous verify write then clamps its start (JAX's
    ``dynamic_update_slice``) and overwrites rows below the cursor; the
    paged one sends positions past max_seq to the trash block. The port
    gives the JAX spec engine's tokens in both layouts, and on these
    prompts plain decode's as well (ROADMAP.md C.3)."""
    (jcfg, jp, jdcfg, jdp), (tcfg, tp, tdcfg, tdp) = weights
    jobs = [(np.random.default_rng(s).integers(0, 101, 100).astype(np.int32), 28)
            for s in (3, 4)]
    want = _run(JBatcher(jcfg, jp, slots=2, paged=paged, spec_draft=(jdcfg, jdp),
                         spec_k=4), jobs)
    got = _run(ContinuousBatcher(tcfg, tp, slots=2, paged=paged, device="cpu",
                                 spec_draft=(tdcfg, tdp), spec_k=4), jobs)
    assert got == want
    assert got == _run(ContinuousBatcher(tcfg, tp, slots=2, paged=paged, device="cpu"), jobs)

