"""Prefill/decode roles and the KV wire in kubeflow_tpu_torch/serving/continuous.py,
on the CPU.

A prefill-role engine handing each request to a decode-role engine through
``submit_handoff`` (its sink) gives the greedy tokens of a unified engine
that never exported anything, on the JAX test config (bf16): bf16 and int8
arenas, plain and chunked prefill on the exporting side, with and without
a speculative draft; in f32, the same as JAX's prefill -> decode pair on
the same weights and prompts; the decode engine's arena holds the unified
engine's bytes. Then ``submit_handoff``'s refusals, a prefill replica without a
sink (or with a failing one) failing only the request, the role checks at
construction, and ``drain`` handing queued imports back.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.training.distill import draft_config, init_from_target

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)
#: 5-9 tokens as the JAX handoff test's, and 21 and 30 (over a 16-token chunk)
PROMPTS = [(50, 5), (51, 7), (52, 9), (53, 21), (54, 30)]


@pytest.fixture(scope="module")
def weights():
    jcfg = JCfg(**SHAPE)
    params = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GptConfig(**SHAPE)
    return jcfg, params, cfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg)


def _prompts(spec=PROMPTS):
    return [np.random.default_rng(s).integers(0, 101, n).astype(np.int32) for s, n in spec]


def _pair(cfg, params, **kw):
    decode = ContinuousBatcher(cfg, params, engine_id="d", role="decode", device="cpu", **kw)
    prefill = ContinuousBatcher(cfg, params, engine_id="p", role="prefill", device="cpu",
                                handoff_sink=decode.submit_handoff, **kw)
    return prefill, decode


def _arena(engine):
    """Every non-trash arena block of every layer (and int8 scales)."""
    return [t[:-1].clone() for layer in engine.cache.values()
            for name, t in sorted(layer["attention"].items()) if name != "cursors"]


CASES = {"bf16_plain": dict(kv_dtype="bf16"), "int8_plain": dict(kv_dtype="int8"),
         "bf16_chunked": dict(kv_dtype="bf16", prefill_chunk=16),
         "int8_chunked": dict(kv_dtype="int8", prefill_chunk=16)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_pair_equals_a_unified_engine(weights, case):
    _, _, cfg, params = weights
    kw = dict(slots=2, chunk=2, pipeline=1, **CASES[case])
    prompts = _prompts()
    unified = ContinuousBatcher(cfg, params, engine_id="u", device="cpu", **kw)
    prefill, decode = _pair(cfg, params, **kw)
    handoffs0 = METRICS.value("serving_kv_handoff_total")
    imports0 = METRICS.value("serving_kv_import_total")
    try:
        want = [unified.submit(p, 8).result(timeout=120) for p in prompts]
        futs = [prefill.submit(p, 8) for p in prompts]
        assert [f.result(timeout=120) for f in futs] == want
        assert all(f.kv_blob is not None and f.finish_reason == "ok" for f in futs)
    finally:
        prefill.close()
        decode.close()
        unified.close()
    assert METRICS.value("serving_kv_handoff_total") - handoffs0 == len(prompts)
    assert METRICS.value("serving_kv_import_total") - imports0 == len(prompts)
    assert METRICS.histogram("serving_kv_handoff_bytes").total >= len(prompts)
    assert prefill._alloc.used() == 0 and decode._alloc.used() == 0


@pytest.fixture(scope="module")
def weights_f32():
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    params = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    return jcfg, params, cfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), cfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_pair_equals_the_jax_pair(weights_f32, case):
    """The same prompts through JAX's prefill -> decode pair and the
    port's, on the same f32 weights: the greedy tokens are equal, for bf16
    and int8 arenas, plain and chunked prefill on the exporting side."""
    jcfg, jparams, cfg, params = weights_f32
    kw = dict(slots=2, chunk=2, pipeline=1, **CASES[case])
    prompts = _prompts()
    jdecode = JBatcher(jcfg, jparams, engine_id="jd", role="decode", **kw)
    jprefill = JBatcher(jcfg, jparams, engine_id="jp", role="prefill",
                        handoff_sink=jdecode.submit_handoff, **kw)
    prefill, decode = _pair(cfg, params, **kw)
    try:
        jfuts = [jprefill.submit(p, 8) for p in prompts]
        want = [[int(t) for t in f.result(timeout=300)] for f in jfuts]
        futs = [prefill.submit(p, 8) for p in prompts]
        assert [f.result(timeout=120) for f in futs] == want
    finally:
        for eng in (prefill, decode, jprefill, jdecode):
            eng.close()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_imported_arena_blocks_are_byte_identical_to_never_moved(weights, kv_dtype):
    """One request of 21 tokens (two blocks, the second part padding) on
    fresh engines: the decode engine grants the unified engine's blocks,
    and after the run every arena block holds the same bytes."""
    _, _, cfg, params = weights
    kw = dict(slots=2, chunk=2, pipeline=1, kv_dtype=kv_dtype)
    p = _prompts([(53, 21)])[0]
    unified = ContinuousBatcher(cfg, params, engine_id="u", device="cpu", **kw)
    prefill, decode = _pair(cfg, params, **kw)
    try:
        want = unified.submit(p, 8).result(timeout=120)
        assert prefill.submit(p, 8).result(timeout=120) == want
    finally:
        prefill.close()
        decode.close()
        unified.close()
    got, ref = _arena(decode), _arena(unified)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert any(a.abs().sum() > 0 for a in got)


def test_pair_with_speculative_decode_stays_greedy_exact(weights):
    """The decode engine re-prefills its draft locally after each import;
    its spec rounds commit exactly a unified spec engine's greedy tokens,
    chunked prompts included."""
    _, _, cfg, params = weights
    dcfg = draft_config(cfg)
    kw = dict(slots=2, chunk=2, pipeline=1, prefill_chunk=16, spec_k=3,
              spec_draft=(dcfg, init_from_target(dcfg, params)))
    prompts = _prompts()
    unified = ContinuousBatcher(cfg, params, engine_id="su", device="cpu", **kw)
    prefill, decode = _pair(cfg, params, **kw)
    try:
        want = [unified.submit(p, 10).result(timeout=120) for p in prompts]
        futs = [prefill.submit(p, 10) for p in prompts]
        assert [f.result(timeout=120) for f in futs] == want
    finally:
        prefill.close()
        decode.close()
        unified.close()


def _blob(cfg, params, prompt, **kw):
    """A prefill engine's export of ``prompt``, captured by its sink."""
    blobs = []
    eng = ContinuousBatcher(cfg, params, role="prefill", device="cpu",
                            handoff_sink=lambda req, blob: blobs.append((req, blob)), **kw)
    try:
        req = eng.submit(prompt, 4)
        for _ in range(600):
            if blobs or req.done.wait(0.1):
                break
    finally:
        eng.close()
    return blobs[0]


REFUSALS = {"kv_dtype": (dict(kv_dtype="int8"), "kv_dtype"),
            "block_t": (dict(kv_block_t=8), "block_t"),
            "model_id": (dict(model_id="other"), "model"),
            "prompt_len": (dict(), "prompt_len")}


@pytest.mark.parametrize("field", sorted(REFUSALS))
def test_submit_handoff_refuses_a_blob_that_does_not_fit(weights, field):
    _, _, cfg, params = weights
    p = _prompts()[3]
    req, blob = _blob(cfg, params, p, model_id="gpt")
    opts, match = REFUSALS[field]
    eng = ContinuousBatcher(cfg, params, role="decode", device="cpu",
                            **{"model_id": "gpt", **opts})
    try:
        if field == "prompt_len":
            req.prompt = p[:-1]
        with pytest.raises(ValueError, match=match):
            eng.submit_handoff(req, blob)
        with pytest.raises(ValueError, match="crc"):
            eng.submit_handoff(req, blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    finally:
        eng.close()


def test_prefill_replica_without_a_sink_fails_the_request_alone(weights):
    _, _, cfg, params = weights
    p = _prompts()
    eng = ContinuousBatcher(cfg, params, role="prefill", device="cpu", prefill_chunk=16)
    try:
        for prompt in (p[0], p[4]):  # a wave, and a chunked prompt
            with pytest.raises(RuntimeError, match="handoff_sink"):
                eng.submit(prompt, 4).result(timeout=60)
    finally:
        eng.close()

    def sink(req, blob):
        raise ConnectionError("decode pool gone")

    eng = ContinuousBatcher(cfg, params, role="prefill", handoff_sink=sink, device="cpu")
    try:
        for _ in range(2):  # the engine keeps serving after a failed ship
            with pytest.raises(ConnectionError):
                eng.submit(p[1], 4).result(timeout=60)
        with pytest.raises(ValueError, match="cannot import"):
            eng.submit_handoff(eng.submit(p[1], 4), b"")
    finally:
        eng.close()


def test_drain_hands_queued_imports_back_with_their_blob(weights):
    _, _, cfg, params = weights
    prompts = _prompts()[:3]
    blobs = [_blob(cfg, params, prompt) for prompt in prompts]
    eng = ContinuousBatcher(cfg, params, role="decode", slots=1, device="cpu")
    for req, blob in blobs:
        eng.submit_handoff(req, blob)
    handed = eng.drain(timeout=120)
    served = [req for req, _ in blobs if req not in handed]
    assert len(handed) >= 2 and all(r.kv_blob is not None for r in handed)
    assert all(not r.done.is_set() for r in handed)
    assert all(len(r.result(timeout=1)) == 4 for r in served)
    with pytest.raises(RuntimeError):
        eng.submit_handoff(*blobs[0])


def test_role_options_raise_the_jax_value_errors(weights):
    jcfg, jparams, cfg, params = weights
    for opts, match in ((dict(role="router"), "role"),
                        (dict(role="decode", paged=False), "paged=True")):
        with pytest.raises(ValueError, match=match):
            JBatcher(jcfg, jparams, **opts)
        with pytest.raises(ValueError, match=match):
            ContinuousBatcher(cfg, params, device="cpu", **opts)
    eng = ContinuousBatcher(cfg, params, device="cpu", paged=False)
    try:
        with pytest.raises(ValueError, match="paged"):
            eng.submit_handoff(eng.submit(_prompts()[0], 2), b"")
    finally:
        eng.close()
