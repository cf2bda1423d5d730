"""Chunked prefill, prewarm and cancel_requests of the port's engine, against
kubeflow_tpu/serving on the CPU.

Prompts longer than ``prefill_chunk`` prefill in chunks between decode
dispatches. On the f32 config the port's greedy tokens equal the JAX
engine's on the same jobs and converted weights, and the port's unchunked
engine's, in every cache layout (paged bf16, contiguous, paged int8). Then the chunked request's lifecycle (cancel, deadline, drain,
close), ``GenerativeModel``'s routing against the JAX server's case by
case, ``prewarm``, ``cancel_requests``, and an over-bucket prompt with
chunking off failing only its own future.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JBatcher
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig, generate
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.serving.continuous import (PREFILL_BUCKETS_S, ContinuousBatcher,
                                                   effective_prefill_chunk)
from kubeflow_tpu_torch.serving.errors import (DeadlineExceeded, EngineClosed,
                                               RequestCancelled)

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, vocab_size=101)
#: (seed, prompt_len, budget): 17, 21 and 30 tokens exceed the 16-token chunk
MIXED_JOBS = [(1, 3, 6), (2, 17, 9), (3, 7, 4), (4, 30, 11), (5, 12, 5),
              (6, 5, 8), (7, 21, 7)]
LAYOUTS = {"paged_bf16": dict(paged=True), "contiguous": dict(paged=False),
           "paged_int8": dict(paged=True, kv_dtype="int8")}


def _weights(max_seq):
    jcfg = JCfg(**SHAPE, max_seq=max_seq, dtype=jnp.float32)
    tcfg = GptConfig(**SHAPE, max_seq=max_seq, dtype=torch.float32)
    params = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, tcfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def weights():
    return _weights(128)


@pytest.fixture(scope="module")
def long_weights():
    """max_seq 512: room for prompts over the largest prefill bucket (256)."""
    return _weights(512)


def _prompt(seed, n, vocab=101):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _jobs():
    return [(_prompt(s, n), b) for s, n, b in MIXED_JOBS]


def _run(engine, jobs):
    try:
        futs = [engine.submit(p, b) for p, b in jobs]
        return [f.result(timeout=300) for f in futs]
    finally:
        engine.close()


def _chunks_total():
    return METRICS.counter("serving_prefill_chunks_total").value


class _Gate:
    """Wraps the engine's prefill module: the first ``after``-th call
    returns, then parks the worker until the test releases it, so a test
    acts at a known point of a chunked prefill."""

    def __init__(self, eng, after=1):
        self.real, self.after, self.calls = eng._prefill_model, after, 0
        self.reached, self.release = threading.Event(), threading.Event()
        eng._prefill_model = self

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, *args, **kw):
        out = self.real(*args, **kw)
        self.calls += 1
        if self.calls == self.after:
            self.reached.set()
            assert self.release.wait(timeout=60)
        return out


def test_effective_prefill_chunk_matches_jax():
    from kubeflow_tpu.serving.continuous import effective_prefill_chunk as jax_chunk

    for args in [(None, 2048), (None, 128), (0, 512), (-3, 512), (16, 128), (100, 512),
                 (300, 2048, 16), (24, 128, 16), (7, 100, 4), (None, 2048, 16)]:
        assert effective_prefill_chunk(*args) == jax_chunk(*args), args


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunked_tokens_match_jax_engine_and_unchunked(weights, layout):
    """prefill_chunk=16 against the JAX engine's chunked run and the port's
    unchunked engine (contiguous; for int8, the unchunked int8 arena, whose
    codes differ from a bf16 cache's): greedy tokens identical (f32). Each
    prompt over the chunk counts ceil(n / 16) chunks."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(slots=3, prefill_chunk=16, **LAYOUTS[layout])
    before = _chunks_total()
    got = _run(ContinuousBatcher(tcfg, tparams, device="cpu", **kw), _jobs())
    chunks = _chunks_total() - before
    want = _run(JBatcher(jcfg, jparams, **kw), _jobs())
    base_kw = LAYOUTS[layout] if layout == "paged_int8" else dict(paged=False)
    base = _run(ContinuousBatcher(tcfg, tparams, slots=3, device="cpu", **base_kw), _jobs())
    assert got == want
    assert got == base
    assert [len(t) for t in got] == [b for _, _, b in MIXED_JOBS]
    assert chunks == sum(-(-n // 16) for _, n, _ in MIXED_JOBS if n > 16)


def test_overbucket_prompt_serves_via_chunked_prefill(long_weights):
    """A 300-token prompt decodes through the engine (default chunk 256)
    equal to generate(), while a short request admitted behind it
    completes too."""
    _, _, cfg, params = long_weights
    long_p, short_p = _prompt(8, 300), _prompt(9, 7)
    eng = ContinuousBatcher(cfg, params, slots=2, device="cpu")
    assert eng.prefill_chunk == 256
    try:
        f_long, f_short = eng.submit(long_p, 5), eng.submit(short_p, 5)
        assert f_long.result(timeout=120) == \
            generate(cfg, params, long_p[None], 5, device="cpu")[0, 300:].tolist()
        assert f_short.result(timeout=120) == \
            generate(cfg, params, short_p[None], 5, device="cpu")[0, 7:].tolist()
    finally:
        eng.close()


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_mid_prefill_cancel_or_deadline_frees_slot_and_blocks(weights, how):
    _, _, cfg, params = weights
    eng = ContinuousBatcher(cfg, params, slots=1, prefill_chunk=16, device="cpu")
    gate = _Gate(eng)
    try:
        deadline = time.monotonic() + 1.0 if how == "deadline" else None
        fut = eng.submit(_prompt(3, 100), 8, deadline=deadline)
        assert gate.reached.wait(timeout=60)  # one chunk done, six to go
        assert eng._chunked is not None and eng._free == []
        if how == "cancel":
            assert fut.cancel()
        else:
            time.sleep(max(0.0, deadline - time.monotonic()) + 0.05)
        gate.release.set()
        with pytest.raises(RequestCancelled if how == "cancel" else DeadlineExceeded):
            fut.result(timeout=60)
        assert fut.finish_reason == ("cancelled" if how == "cancel" else "deadline")
        assert eng._chunked is None and eng._free == [0]
        assert eng._alloc.available() == eng._alloc.n_blocks
        assert METRICS.value("serving_kv_blocks_used", replica="0") == 0
        # the slot serves again
        assert len(eng.submit(_prompt(4, 7), 3).result(timeout=60)) == 3
    finally:
        gate.release.set()
        eng.close()


def test_drain_completes_a_chunked_prefill_in_flight(weights):
    _, _, cfg, params = weights
    p = _prompt(5, 70)
    want = generate(cfg, params, p[None], 6, device="cpu")[0, 70:].tolist()
    eng = ContinuousBatcher(cfg, params, slots=2, prefill_chunk=16, paged=False,
                            device="cpu")
    gate = _Gate(eng)
    fut = eng.submit(p, 6)
    assert gate.reached.wait(timeout=60)
    handoff = []
    drainer = threading.Thread(target=lambda: handoff.append(eng.drain(timeout=60)))
    drainer.start()
    gate.release.set()
    drainer.join(timeout=90)
    assert not drainer.is_alive()
    assert handoff == [[]]
    assert fut.result(timeout=1) == want  # in-flight work, run to its end
    assert not eng._worker.is_alive()


def test_close_fails_a_chunked_prefill_in_flight(weights):
    _, _, cfg, params = weights
    eng = ContinuousBatcher(cfg, params, slots=2, prefill_chunk=16, device="cpu")
    gate = _Gate(eng)
    fut = eng.submit(_prompt(6, 70), 6)
    assert gate.reached.wait(timeout=60)
    closer = threading.Thread(target=eng.close)
    closer.start()
    time.sleep(0.1)  # the shutdown sentinel is queued behind the parked chunk
    gate.release.set()
    closer.join(timeout=60)
    assert not closer.is_alive() and not eng._worker.is_alive()
    with pytest.raises(EngineClosed):
        fut.result(timeout=1)
    assert eng._chunked is None
    assert eng._alloc.available() == eng._alloc.n_blocks


@pytest.mark.parametrize("continuous,prefill_chunk",
                         [(True, None), (True, 0), (False, None), (False, 0)])
def test_generative_model_routes_as_jax(long_weights, continuous, prefill_chunk):
    """Each (continuous, prefill_chunk) case with a prompt at the largest
    bucket (256) and one over it (300): the engine or the static path, as
    the JAX GenerativeModel routes it, and the same tokens."""
    from kubeflow_tpu.serving.server import GenerativeModel as JModel
    from kubeflow_tpu_torch.serving.server import GenerativeModel

    jcfg, jparams, cfg, params = long_weights
    for n in (256, 300):
        prompt = _prompt(n, n)[None].tolist()
        kw = dict(name="g", apply_fn=None, cfg=cfg, max_new_tokens=3, slots=2,
                  continuous=continuous, prefill_chunk=prefill_chunk)
        model = GenerativeModel(params=params, device="cpu", **kw)
        jmodel = JModel(params=jparams, **dict(kw, cfg=jcfg))
        try:
            got, want = model.predict(prompt), jmodel.predict(prompt)
            assert got == want, (n, continuous, prefill_chunk)
            engine = continuous and (n <= 256 or prefill_chunk != 0)
            assert (model._engine is not None) == engine
            assert (jmodel._engine is not None) == engine
        finally:
            model.close()
            jmodel.close()


def test_generative_model_passes_its_arena_to_the_engine(long_weights):
    """``kv_blocks`` and ``kv_block_t`` size the engine's paged arena, as in
    the JAX GenerativeModel, and an over-bucket prompt prefills in chunks
    of the tile they give, with the JAX model's tokens."""
    from kubeflow_tpu.serving.server import GenerativeModel as JModel
    from kubeflow_tpu_torch.serving.server import GenerativeModel

    jcfg, jparams, cfg, params = long_weights
    prompt = _prompt(9, 300)[None].tolist()
    kw = dict(name="g", apply_fn=None, cfg=cfg, max_new_tokens=3, slots=2,
              kv_blocks=40, kv_block_t=8)
    model = GenerativeModel(params=params, device="cpu", **kw)
    jmodel = JModel(params=jparams, **dict(kw, cfg=jcfg))
    try:
        chunks = _chunks_total()
        assert model.predict(prompt) == jmodel.predict(prompt)
        eng, jeng = model._engine, jmodel._engine
        assert eng._alloc.n_blocks == jeng._alloc.n_blocks == 40
        assert eng.kv_block_t == jeng.kv_block_t == 8
        assert eng.prefill_chunk == jeng.prefill_chunk
        assert _chunks_total() - chunks == -(-300 // eng.prefill_chunk)
    finally:
        model.close()
        jmodel.close()


def test_prewarm_one_wave_per_group_size_and_its_deadline(weights):
    _, _, cfg, params = weights
    eng = ContinuousBatcher(cfg, params, slots=3, chunk=4, device="cpu")
    try:
        hist = METRICS.histogram("serving_prefill_seconds", buckets=PREFILL_BUCKETS_S)
        waves, served = hist.total, METRICS.value("serving_continuous_requests_total")
        eng.prewarm(16)
        assert hist.total - waves == 3  # group sizes 1, 2, 3: one prefill each
        assert METRICS.value("serving_continuous_requests_total") - served == 1 + 2 + 3
        with pytest.raises(DeadlineExceeded):
            eng.prewarm(16, timeout=0.0)
        assert len(eng.submit(_prompt(1, 9), 2).result(timeout=60)) == 2
    finally:
        eng.close()


def test_cancel_requests_reaps_queued_work(weights):
    _, _, cfg, params = weights
    eng = ContinuousBatcher(cfg, params, slots=1, chunk=2, pipeline=1, engine_id="ab",
                            device="cpu")
    step = eng.model

    def slow_step(*args, **kw):  # a slow decode step keeps the blocker in flight
        time.sleep(0.02)
        return step(*args, **kw)

    eng.model = slow_step
    try:
        blocker = eng.submit(_prompt(5, 5), 30)
        deadline = time.monotonic() + 30
        while not blocker.tokens and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = eng.submit(_prompt(6, 6), 4)
        while len(eng._pending) != 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(eng._pending) == 1
        assert eng.cancel_requests(2) == 2
        with pytest.raises(RequestCancelled):
            queued.result(timeout=10)
        assert queued.finish_reason == "cancelled"
        assert blocker.result(timeout=10) and blocker.finish_reason == "cancelled"
    finally:
        eng.close()


def test_failed_admission_does_not_leak_the_slot(long_weights):
    """With chunking off, a prompt over every prefill bucket passes submit
    and fails ONLY its own future at admission; the slot stays usable."""
    _, _, cfg, params = long_weights
    eng = ContinuousBatcher(cfg, params, slots=1, prefill_chunk=0, device="cpu")
    try:
        bad = eng.submit(_prompt(1, 300), 32)
        with pytest.raises(ValueError, match="exceeds the largest prefill bucket"):
            bad.result(timeout=60)
        assert len(eng.submit(_prompt(2, 7), 3).result(timeout=60)) == 3
    finally:
        eng.close()
