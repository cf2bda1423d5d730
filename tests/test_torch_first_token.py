"""``_Request.first_token_at`` in kubeflow_tpu_torch/serving/continuous.py
against kubeflow_tpu/serving/continuous.py, on the CPU.

Each scenario runs on the JAX engine and on the port's, on the same f32
weights: a plain request, a chunked prefill (a 300-token prompt in chunks
of 64), a speculative engine, the decode side of a KV handoff, a queued
import that a draining decode engine hands back and another decode engine
re-imports (the fleet's re-import), a request with budget 1, and requests
that finish before their first token (a deadline already past at submit,
cancelled while queued, failed at admission). Wherever JAX sets
``first_token_at`` the port sets it, with ``submit_at <= first_token_at
<= last_token_at <= done_at``; wherever JAX's is None the port's is None.
"""

import dataclasses
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu.training.distill import init_from_target as j_init_from_target
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.training.distill import draft_config, init_from_target

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=512, vocab_size=101)
PROMPT = np.random.default_rng(3).integers(0, 101, 6).astype(np.int32)
LONG = np.random.default_rng(4).integers(0, 101, 300).astype(np.int32)


@pytest.fixture(scope="module")
def sides():
    """(engine class, cfg, params, draft, extra kwargs) of the JAX engine
    and the port's, on the same f32 weights."""
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jdcfg = JCfg(**dict(SHAPE, n_layers=1), dtype=jnp.float32)
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    tp = params_from_flax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    tdcfg = dataclasses.replace(draft_config(cfg), dtype=torch.float32)
    return [(JBatcher, jcfg, jp, (jdcfg, j_init_from_target(jdcfg, jp)), {}),
            (ContinuousBatcher, cfg, tp, (tdcfg, init_from_target(tdcfg, tp)),
             {"device": "cpu"})]


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert pred()


def _stamps(req):
    """Whether ``first_token_at`` is set, and (when it is) that the request's
    stamps are ordered."""
    if req.first_token_at is None:
        return None
    assert req.submit_at <= req.first_token_at <= req.last_token_at <= req.done_at
    return True


def _served(make, cfg, params, draft, kw):
    out = {}
    eng = make(cfg, params, slots=2, chunk=2, pipeline=1, prefill_chunk=64, **kw)
    try:
        plain = eng.submit(PROMPT, 4)
        long = eng.submit(LONG, 3)
        one = eng.submit(PROMPT, 1)
        for r in (plain, long, one):
            r.result(timeout=120)
        out.update(plain=_stamps(plain), chunked=_stamps(long), budget_one=_stamps(one),
                   budget_one_first_is_last=one.first_token_at == one.last_token_at)
        late = eng.submit(PROMPT, 4, deadline=time.monotonic() - 1.0)
        late.done.wait(timeout=60)
        out["expired_at_submit"] = _stamps(late)
    finally:
        eng.close()
    spec = make(cfg, params, slots=2, chunk=2, pipeline=1, spec_draft=draft, spec_k=3, **kw)
    try:
        s = spec.submit(PROMPT, 5)
        s.result(timeout=120)
        out["spec"] = _stamps(s)
    finally:
        spec.close()
    return out


def _unserved(make, cfg, params, draft, kw):
    eng = make(cfg, params, slots=1, chunk=2, pipeline=1, prefill_chunk=0, **kw)
    try:
        bad = eng.submit(LONG, 2)  # over the largest bucket, no chunking: fails at admission
        bad.done.wait(timeout=60)
        eng.step_delay_s = 0.02
        a = eng.submit(PROMPT, 30)
        _wait(lambda: len(a.tokens) > 0)
        b = eng.submit(PROMPT, 4)
        b.cancel()
        b.done.wait(timeout=60)
        a.cancel()
        a.done.wait(timeout=60)
        return {"failed_admission": _stamps(bad), "cancelled_decoding": _stamps(a),
                "cancelled_queued": _stamps(b)}
    finally:
        eng.close()


def _handoff_and_reimport(make, cfg, params, draft, kw):
    """A prefill engine hands off to a one-slot decode engine that steps
    slowly; the second import queues behind the first, the decode engine
    drains and hands it back, and a second decode engine re-imports its
    blob (what ``EngineFleet`` does with a drained replica's imports)."""
    d1 = make(cfg, params, engine_id="d1", role="decode", slots=1, chunk=2, pipeline=1, **kw)
    d2 = make(cfg, params, engine_id="d2", role="decode", slots=1, chunk=2, pipeline=1, **kw)
    delivered = []

    def sink(req, blob):
        d1.submit_handoff(req, blob)
        delivered.append(req)

    prefill = make(cfg, params, engine_id="p", role="prefill", slots=2, chunk=2, pipeline=1,
                   handoff_sink=sink, **kw)
    d1.step_delay_s = 0.05
    try:
        # a holds d1's one slot for >= 2 s (40 tokens, 2 steps a chunk, 50 ms a step)
        a = prefill.submit(PROMPT, 40)
        _wait(lambda: len(a.tokens) > 0)
        b = prefill.submit(PROMPT[:5], 4)
        _wait(lambda: len(delivered) == 2)  # b's import is queued on d1
        handed = d1.drain()
        out = {"handed_back": [r is b for r in handed],
               "before_reimport": _stamps(b)}
        d2.submit_handoff(b, b.kv_blob)
        a.result(timeout=120)
        b.result(timeout=120)
        out.update(handoff=_stamps(a), reimport=_stamps(b))
        return out
    finally:
        prefill.close()
        d1.close()
        d2.close()


@pytest.mark.parametrize("scenario", [_served, _unserved, _handoff_and_reimport],
                         ids=["served", "unserved", "handoff_and_reimport"])
def test_first_token_at_is_set_where_jax_sets_it(sides, scenario):
    want, got = (scenario(*side) for side in sides)
    assert got == want
    if scenario is _served:
        assert got == {"plain": True, "chunked": True, "budget_one": True,
                       "budget_one_first_is_last": True, "expired_at_submit": None,
                       "spec": True}
    elif scenario is _unserved:
        assert got == {"failed_admission": None, "cancelled_decoding": True,
                       "cancelled_queued": None}
    else:
        assert got == {"handed_back": [True], "before_reimport": None, "handoff": True,
                       "reimport": True}
