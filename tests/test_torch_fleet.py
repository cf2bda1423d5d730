"""kubeflow_tpu_torch/serving/fleet.py against kubeflow_tpu/serving/fleet.py,
on the CPU.

On the f32 test config, the port's ``EngineFleet`` and the JAX
``EngineFleet`` serve the same prompts with the same weights
(``convert.params_from_flax``); the greedy tokens must be equal (exactly)
with two unified replicas, two multiplexed models of different seeds, and
prefill/decode pools over bf16 and int8 arenas. Then the fleet's own
contracts on the port: a drain re-queues with zero drops, a drained decode
replica's queued imports are imported again (not prefilled again),
``scale_to`` grows and shrinks pools with their gauges, ``debug_snapshot``
has the JAX fleet's keys, a replica poisoned by ``fail_next_step`` opens
its breaker (as on the JAX fleet) and later requests land on the survivor,
a crash the port's ``ChaosMonkey`` fires at an idle replica closes it at
once and the others serve every request after it, and replicas share one
set of weight tensors.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu.serving.fleet import EngineFleet as JFleet, ReplicaBreaker as JBreaker
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig, generate
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.serving.fleet import EngineFleet, ReplicaBreaker

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)
#: (seed, length): short prompts of three buckets
PROMPTS = [(1, 5), (2, 9), (3, 17), (4, 30)]
BUDGET = 8
FLEET = dict(slots=2, chunk=2, pipeline=1, max_replicas=3, register_debug=False)


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    METRICS.reset()
    yield


def _jparams(jcfg, seed):
    return JLM(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def weights():
    """f32 weights of seeds 0 and 1, as flax trees and as the port's dicts."""
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    j = [_jparams(jcfg, s) for s in (0, 1)]
    t = [params_from_flax(jax.tree_util.tree_map(np.asarray, p), cfg) for p in j]
    return jcfg, j, cfg, t


def _prompts(spec=PROMPTS):
    return [np.random.default_rng(s).integers(0, 101, n).astype(np.int32) for s, n in spec]


def _want(cfg, params, p, n=BUDGET):
    return generate(cfg, params, p[None], n, device="cpu")[0, len(p):].tolist()


CASES = {
    "replicas_2": dict(replicas=2),
    "models_two_seeds": dict(models=True, model_slo={"b": "batch"}),
    "pools_bf16": dict(pools={"prefill": 1, "decode": 2}),
    "pools_int8": dict(pools={"prefill": 1, "decode": 2}, engine_kwargs={"kv_dtype": "int8"}),
}


def _serve(fleet, prompts, models):
    try:
        futs = [fleet.submit(p, BUDGET, model=m) for m in models for p in prompts]
        return [[int(t) for t in f.result(timeout=300)] for f in futs], futs
    finally:
        fleet.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_tokens_equal_the_jax_fleet(weights, case):
    jcfg, jp, cfg, tp = weights
    kw = dict(CASES[case])
    models = [""]
    if kw.pop("models", False):
        models = ["a", "b"]
        jargs = dict(models={"a": (jcfg, jp[0]), "b": (jcfg, jp[1])})
        targs = dict(models={"a": (cfg, tp[0]), "b": (cfg, tp[1])})
    else:
        jargs, targs = dict(cfg=jcfg, params=jp[0]), dict(cfg=cfg, params=tp[0])
    prompts = _prompts()
    want, _ = _serve(JFleet(name="j", **jargs, **FLEET, **kw), prompts, models)
    got, futs = _serve(EngineFleet(name="t", device="cpu", **targs, **FLEET, **kw),
                       prompts, models)
    assert got == want
    if len(models) == 2:
        # each model serves its own weights, at its model_slo class
        assert got[:4] == [_want(cfg, tp[0], p) for p in prompts]
        assert got[4:] == [_want(cfg, tp[1], p) for p in prompts] != got[:4]
        assert [f.priority for f in futs] == ["interactive"] * 4 + ["batch"] * 4
    if "pools" in kw:
        n = len(prompts)
        assert METRICS.value("serving_kv_handoff_total") == n
        assert METRICS.value("serving_kv_import_total") == n
    assert METRICS.value("tenant_tokens_total", namespace="default",
                         direction="out") == BUDGET * len(got)


def test_replicas_share_one_set_of_weights(weights):
    _, _, cfg, tp = weights
    fleet = EngineFleet(cfg, tp[0], replicas=3, name="w", device="cpu", **FLEET)
    try:
        engines = [h.engine for h in fleet.live_handles()]
        assert len(engines) == 3
        for k, v in tp[0].items():
            assert {e.params[k].data_ptr() for e in engines} == {v.data_ptr()}
    finally:
        fleet.close()


def _wait_for(pred, timeout=60.0, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    assert pred(), f"timed out waiting for {desc}"


def test_drain_requeues_with_zero_drops(weights):
    _, _, cfg, tp = weights
    fleet = EngineFleet(cfg, tp[0], replicas=2, name="ho", device="cpu",
                        **dict(FLEET, slots=1))
    try:
        p = _prompts([(5, 6)])[0]
        victim = fleet.live_handles()[0]
        victim.engine.step_delay_s = 0.02  # queue up behind a slow replica
        # prefix affinity keeps all five on the replica the first one took
        futs = [fleet.submit(p, BUDGET) for _ in range(5)]
        assert len(victim.engine._pending) + victim.engine._queue.qsize() >= 1
        requeued = fleet.drain_replica(victim.id, reason="test")
        assert requeued >= 1
        assert METRICS.value("fleet_requeued_total") == requeued
        want = _want(cfg, tp[0], p)
        assert [f.result(timeout=120) for f in futs] == [want] * 5
        assert all(f.error is None for f in futs)
        assert fleet.desired_replicas == 1
        assert METRICS.histogram_counts("fleet_drain_seconds")[2] == 1
        snap = fleet.debug_snapshot()
        assert snap["drains"][0]["requeued"] == requeued
        assert snap["drains"][0]["replica"] == victim.gauge_id
    finally:
        fleet.close()


def test_drained_decode_replica_imports_are_imported_again(weights):
    """A decode replica drained with KV imports still queued hands them
    back with their blobs; the fleet imports each on the surviving decode
    replica: every request is prefilled once and imported once more."""
    _, _, cfg, tp = weights
    fleet = EngineFleet(cfg, tp[0], pools={"prefill": 1, "decode": 1}, name="ddr",
                        device="cpu", **dict(FLEET, slots=1))
    try:
        prompts = _prompts([(6, 6), (7, 9), (8, 12), (9, 7)])
        victim = next(h for h in fleet.live_handles() if h.role == "decode")
        victim.engine.step_delay_s = 0.1
        futs = [fleet.submit(p, BUDGET) for p in prompts]
        _wait_for(lambda: METRICS.value("serving_kv_handoff_total") == len(prompts),
                  desc="every handoff")
        assert len(victim.engine._imports) + victim.engine._queue.qsize() >= 1
        fleet.scale_to(2, reason="test", pool="decode")
        requeued = fleet.drain_replica(victim.id, reason="test")
        assert requeued >= 1
        assert [f.result(timeout=120) for f in futs] == [_want(cfg, tp[0], p)
                                                         for p in prompts]
        # re-imported, not re-prefilled: one export a request, and each
        # request admitted by an import once (the handed-back ones on the
        # survivor)
        assert METRICS.value("serving_kv_handoff_total") == len(prompts)
        assert METRICS.value("serving_kv_import_total") == len(prompts)
        assert fleet.pool_size("decode") == 1
    finally:
        fleet.close()


def test_scale_to_grows_and_shrinks_with_its_gauges(weights):
    _, _, cfg, tp = weights
    fleet = EngineFleet(cfg, tp[0], replicas=1, name="sc", device="cpu", **FLEET)
    try:
        first = fleet.live_handles()[0].engine
        fleet.scale_to(3, reason="test")
        assert fleet.desired_replicas == 3 and METRICS.value("fleet_replicas") == 3.0
        fleet.scale_to(9, reason="test")  # clamped to max_replicas
        assert fleet.desired_replicas == 3
        newest = [h.engine for h in fleet.live_handles()][1:]
        fleet.scale_to(1, reason="test")
        assert fleet.desired_replicas == 1 and METRICS.value("fleet_replicas") == 1.0
        assert fleet.live_handles()[0].engine is first  # the newest drain first
        assert all(e._closed for e in newest)
        assert METRICS.histogram_counts("fleet_replica_cold_start_seconds")[2] == 3
        assert [e["to"] for e in fleet.debug_snapshot()["scale_log"]] == [1, 3, 3, 1]
    finally:
        fleet.close()
    pooled = EngineFleet(cfg, tp[0], pools={"prefill": 1, "decode": 1}, name="dsc",
                         device="cpu", **FLEET)
    try:
        assert pooled.pools == {"prefill": 1, "decode": 1}
        pooled.scale_to(2, reason="test", pool="prefill")
        assert (pooled.pool_size("prefill"), pooled.pool_size("decode")) == (2, 1)
        assert METRICS.value("fleet_pool_replicas", pool="prefill") == 2.0
        pooled.scale_to(0, reason="test", pool="decode")  # pools floor at 1
        pooled.scale_to(1, reason="test", pool="prefill")
        assert sorted(h.role for h in pooled.live_handles()) == ["decode", "prefill"]
        assert METRICS.value("fleet_pool_replicas", pool="prefill") == 1.0
    finally:
        pooled.close()


class _Fake:
    def __init__(self, engine_id):
        self.engine_id = engine_id

    def submit(self, prompt_ids, max_new_tokens, **kw):
        req = type("R", (), {})()
        req.tokens, req.error, req.finish_reason = [7] * max_new_tokens, None, "ok"
        req.done = threading.Event()
        req.done.set()
        kw["on_done"](req)
        return req

    def drain(self):
        return []

    def close(self):
        pass


def _strip_at(obj):
    if isinstance(obj, dict):
        return {k: _strip_at(v) for k, v in obj.items() if k != "at"}
    if isinstance(obj, list):
        return [_strip_at(v) for v in obj]
    return obj


def test_debug_snapshot_equals_the_jax_fleets():
    snaps = []
    for make, kw, registry in ((JFleet, {}, JMETRICS), (EngineFleet, {"device": "cpu"}, METRICS)):
        registry.reset()
        fleet = make(replicas=3, name="dbg", engine_factory=_Fake, register_debug=False, **kw)
        try:
            fleet.submit(_prompts()[0], 4)
            fleet.scale_to(2, reason="test")
            snaps.append(_strip_at(fleet.debug_snapshot()))
        finally:
            fleet.close()
    assert snaps[1] == snaps[0]
    assert {r["id"] for r in snaps[1]["replicas"]} == {"dbg-0", "dbg-1"}
    assert snaps[1]["drains"][0]["replica"] == "dbg-2"


def _poison_trace(make, cfg, params, registry, **kw):
    """A two-replica fleet whose first replica fails its next iteration:
    the request it took fails, its breaker (threshold 1) opens, and the
    next three requests are served by the other replica."""
    registry.reset()
    fleet = make(cfg, params, replicas=2, name="px",
                 breaker_factory=lambda: BREAKERS[make](failure_threshold=1),
                 **dict(FLEET, **kw))
    try:
        h0, h1 = fleet.live_handles()
        h0.engine.fail_next_step = True
        bad = fleet.submit(_prompts([(10, 6)])[0], BUDGET)
        bad.done.wait(timeout=120)
        # the port's message also names the exception's type
        trace = [type(bad.error).__name__,
                 "chaos: replica crashed mid-decode" in str(bad.error),
                 h0.breaker.state, h1.breaker.state,
                 registry.value("fleet_breaker_state", replica=h0.gauge_id)]
        later = [fleet.submit(p, BUDGET) for p in _prompts([(11, 6), (12, 9), (13, 17)])]
        trace.append([[int(t) for t in f.result(timeout=120)] for f in later])
        trace.append([len(h.prefixes) for h in (h0, h1)])
        trace.append(h0.engine._closed)
        return trace
    finally:
        fleet.close()


BREAKERS = {JFleet: JBreaker, EngineFleet: ReplicaBreaker}


def test_a_poisoned_replica_opens_its_breaker_as_on_the_jax_fleet(weights):
    jcfg, jp, cfg, tp = weights
    want = _poison_trace(JFleet, jcfg, jp[0], JMETRICS)
    got = _poison_trace(EngineFleet, cfg, tp[0], METRICS, device="cpu")
    assert got == want
    assert got[:2] == ["EngineClosed", True]
    assert got[2:5] == ["open", "closed", 1.0]
    assert got[5] == [_want(cfg, tp[0], p) for p in _prompts([(11, 6), (12, 9), (13, 17)])]
    assert got[6] == [1, 3] and got[7] is True


def test_a_crash_fired_at_an_idle_replica_closes_it_at_once(weights):
    """JAX's injector leaves an idle replica's poison for the next request
    routed there, which it fails (a 503 through the server); the port's
    pokes the engine, so the replica is closed before any request and the
    fleet routes every one around it."""
    from kubeflow_tpu_torch.runtime.chaos import ChaosMonkey, ChaosSchedule, Fault

    _, _, cfg, tp = weights
    fleet = EngineFleet(cfg, tp[0], replicas=2, name="cx", device="cpu", **FLEET)
    try:
        h0, h1 = fleet.live_handles()
        ChaosMonkey(ChaosSchedule([]), fleet=fleet).inject(
            Fault(at=0.0, kind="crash_replica_mid_decode", target=h0.gauge_id))
        _wait_for(lambda: h0.engine.closed, timeout=15, desc="the crashed replica to close")
        assert not h1.engine.closed
        futs = [fleet.submit(p, BUDGET) for p in _prompts()]
        assert [[int(t) for t in f.result(timeout=120)] for f in futs] == [
            _want(cfg, tp[0], p) for p in _prompts()]
        assert [h.gauge_id for h in fleet.live_handles()] == [h1.gauge_id]
    finally:
        fleet.close()


def test_close_releases_the_fleet_from_the_debug_registry():
    """``/debug/fleet``'s process-global registration held a closed fleet,
    and through its engine factory the weights (on the card: GPT-small's
    ~500 MB after the overload driver returned). ``close`` unregisters its
    own handler only: a later fleet's registration stays."""
    import gc
    import weakref

    from kubeflow_tpu_torch.runtime import obs

    first = EngineFleet(replicas=1, name="one", engine_factory=_Fake, device="cpu")
    second = EngineFleet(replicas=1, name="two", engine_factory=_Fake, device="cpu")
    try:
        assert obs._DEBUG_SOURCES["fleet"](None)["fleet"] == "two"
        first.close()
        assert obs._DEBUG_SOURCES["fleet"](None)["fleet"] == "two"
        gone = weakref.ref(first)
        del first
        gc.collect()
        assert gone() is None
    finally:
        second.close()
    assert "fleet" not in obs._DEBUG_SOURCES
    gone = weakref.ref(second)
    del second
    gc.collect()
    assert gone() is None
