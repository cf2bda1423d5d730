"""kubeflow_tpu_torch/serving/{router,fleet,autoscaler}.py's decision logic
against kubeflow_tpu/serving's, pure Python, on the CPU.

Each scenario runs twice, once on the JAX package's classes and registry
and once on the port's, and returns a trace of what it saw (keys, chosen
replicas, policies, errors and their Retry-After, breaker states, scale
decisions); the two traces must be equal, and each scenario also checks
the outcome the JAX tests expect (``tests/test_fleet.py``,
``tests/test_overload.py``). Floats in the traces are compared exactly:
both sides do the same float arithmetic on the same inputs.
"""

import threading
import time
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest

from kubeflow_tpu.runtime import metrics as jmetrics
from kubeflow_tpu.serving import autoscaler as jautoscaler
from kubeflow_tpu.serving import errors as jerrors
from kubeflow_tpu.serving import fleet as jfleet
from kubeflow_tpu.serving import router as jrouter
from kubeflow_tpu.serving.continuous import TTFT_BUCKETS
from kubeflow_tpu_torch.runtime import metrics as tmetrics
from kubeflow_tpu_torch.serving import autoscaler as tautoscaler
from kubeflow_tpu_torch.serving import errors as terrors
from kubeflow_tpu_torch.serving import fleet as tfleet
from kubeflow_tpu_torch.serving import router as trouter

JAX = SimpleNamespace(name="jax", router=jrouter, fleet=jfleet, autoscaler=jautoscaler,
                      errors=jerrors, METRICS=jmetrics.METRICS, kw={})
PORT = SimpleNamespace(name="port", router=trouter, fleet=tfleet, autoscaler=tautoscaler,
                       errors=terrors, METRICS=tmetrics.METRICS, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    tmetrics.METRICS.reset()
    yield


def both(scenario):
    """The scenario's trace on the JAX classes, and on the port's; each
    side starts from empty registries."""
    traces = []
    for side in (JAX, PORT):
        jmetrics.METRICS.reset()
        tmetrics.METRICS.reset()
        traces.append(scenario(side))
    return traces


def prompt(seed: int, n: int = 6) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 101, size=(n,)).astype(np.int32)


def handle(rid: str, model_id: str = ""):
    return SimpleNamespace(id=rid, gauge_id=rid, state="ready", model_id=model_id,
                           prefixes=OrderedDict())


# -- prefix_key and _Histogram.mean ---------------------------------------------

@pytest.mark.parametrize("model_id", ["", "a", "gpt-small", "ünï"])
@pytest.mark.parametrize("n", [1, 5, 16, 40])
def test_prefix_key_equals_jax(model_id, n):
    for seed in range(4):
        p = np.random.default_rng(seed).integers(0, 32000, n)
        for prefix_len in (4, 16):
            assert trouter.prefix_key(p, prefix_len, model_id) == \
                jrouter.prefix_key(p, prefix_len, model_id)
    head = list(range(16))
    assert trouter.prefix_key(head + [1, 2]) == trouter.prefix_key(head + [9])


def test_histogram_mean_equals_jax():
    values = [0.25, 2.0, 4.0, 0.001, 17.5]
    jh, th = jmetrics._Histogram(), tmetrics._Histogram()
    assert jh.mean == th.mean == 0.0
    for i, v in enumerate(values):
        jh.observe(v, count=i + 1)
        th.observe(v, count=i + 1)
        assert th.mean == jh.mean
    assert th.mean == pytest.approx(sum(v * (i + 1) for i, v in enumerate(values)) / 15)


# -- PrefixRouter ----------------------------------------------------------------

def _route_trace(P, router, handles, p, **kw):
    try:
        h, policy = router.route(handles, p, **kw)
        return (h.id, policy)
    except P.errors.FleetSaturated as e:
        return ("saturated", e.retry_after_s)


def sc_prefix_spill_least_loaded(P):
    """Prefix hit, then the owner saturates (spill), then least-loaded by
    occupancy among empty queues, then every queue full."""
    M = P.METRICS
    r = P.router.PrefixRouter(max_queue_depth=4)
    hs = [handle(f"r-{i}") for i in range(3)]
    trace = []
    M.gauge("serving_slot_occupancy", replica="r-0").set(0.5)
    M.gauge("serving_slot_occupancy", replica="r-2").set(0.125)
    for p in (prompt(0), prompt(0), prompt(1)):
        trace.append(_route_trace(P, r, hs, p))
    owner = trace[0][0]
    M.gauge("serving_queue_depth", replica=owner).set(4)
    trace.append(_route_trace(P, r, hs, prompt(0)))
    for h in hs:
        M.gauge("serving_queue_depth", replica=h.gauge_id).set(4 + int(h.id[-1]))
    M.histogram("serving_request_seconds").observe(0.75)
    trace.append(_route_trace(P, r, hs, prompt(2)))
    trace.append([len(h.prefixes) for h in hs])
    trace.append({p: M.value("fleet_routed_total", policy=p)
                  for p in ("prefix", "prefix_spill", "least_loaded")})
    trace.append((M.value("fleet_prefix_hits_total"), M.value("fleet_saturated_total")))
    return trace


def sc_batch_shed_at_reserve(P):
    M = P.METRICS
    r = P.router.PrefixRouter(max_queue_depth=8, interactive_reserve=0.25)
    h = handle("rp-0")
    trace = [r.depth_limit("interactive"), r.depth_limit("batch")]
    M.gauge("serving_queue_depth", replica="rp-0").set(6)
    trace.append(_route_trace(P, r, [h], prompt(0), priority="batch"))
    trace.append(_route_trace(P, r, [h], prompt(0), priority="interactive"))
    trace.append(M.value("serving_shed_total", priority="batch"))
    return trace


def sc_retry_after_hint(P):
    M = P.METRICS
    r = P.router.PrefixRouter(max_queue_depth=32)
    h = handle("rh-0")
    M.gauge("serving_queue_depth", replica="rh-0").set(4)
    trace = [r.retry_after_hint([h])]
    M.histogram("serving_request_seconds").observe(2.0)
    M.histogram("serving_request_seconds").observe(4.0)
    trace.append(r.retry_after_hint([h]))
    M.gauge("serving_queue_depth", replica="rh-0").set(1000)
    trace.append(r.retry_after_hint([h]))
    M.gauge("serving_queue_depth", replica="rh-0").set(0)
    trace.append(r.retry_after_hint([h]))
    trace.append(r.retry_after_hint([]))
    return trace


def sc_model_scoped(P):
    r = P.router.PrefixRouter()
    a0, a1, b0 = handle("m-0", "a"), handle("m-1", "a"), handle("m-2", "b")
    trace = [_route_trace(P, r, [a0, a1, b0], prompt(0), model_id="b"),
             _route_trace(P, r, [a0, a1, b0], prompt(0), model_id="a"),
             _route_trace(P, r, [a0, a1], prompt(0), model_id="c"),
             _route_trace(P, r, [a0, a1, b0], prompt(0), model_id="a", exclude="m-0")]
    trace.append([list(h.prefixes) for h in (a0, a1, b0)])
    r2 = P.router.PrefixRouter(prefix_cache_size=2)
    h = handle("lru")
    for s in (1, 2, 1, 3):
        r2.note_prefix(h, prompt(s), "a")
    trace.append(list(h.prefixes))
    return trace


ROUTER_SCENARIOS = {"prefix_spill_least_loaded": sc_prefix_spill_least_loaded,
                    "batch_shed_at_reserve": sc_batch_shed_at_reserve,
                    "retry_after_hint": sc_retry_after_hint,
                    "model_scoped": sc_model_scoped}


@pytest.mark.parametrize("name", sorted(ROUTER_SCENARIOS))
def test_router_decides_as_jax(name):
    want, got = both(ROUTER_SCENARIOS[name])
    assert got == want


def test_router_outcomes_are_the_jax_tests():
    """The scripted traces say what tests/test_fleet.py and
    tests/test_overload.py expect of the JAX router."""
    t = both(sc_prefix_spill_least_loaded)[1]
    owner = t[0][0]
    assert t[0][1] == "least_loaded" and t[1] == (owner, "prefix")
    assert t[2] == ("r-1", "least_loaded")  # empty queue and occupancy 0
    assert t[3][1] == "prefix_spill" and t[3][0] != owner
    assert t[4] == ("saturated", 3.0)  # depth 4 x mean 0.75 s
    assert t[6] == {"prefix": 1.0, "prefix_spill": 1.0, "least_loaded": 2.0}
    assert t[7] == (1.0, 1.0)
    t = both(sc_batch_shed_at_reserve)[1]
    assert t[:2] == [8, 6] and t[2] == ("saturated", 3.0) and t[3] == ("rp-0", "least_loaded")
    assert t[4] == 1.0
    assert both(sc_retry_after_hint)[1] == [2.0, 12.0, 60.0, 0.5, 60.0]
    t = both(sc_model_scoped)[1]
    assert t[0] == ("m-2", "least_loaded") and t[2] == ("saturated", None)
    assert t[3] == ("m-1", "least_loaded")


# -- ReplicaBreaker and RetryBudget ------------------------------------------------

def sc_breaker_cycle(P):
    clk = [0.0]
    b = P.fleet.ReplicaBreaker(failure_threshold=3, open_s=5.0, clock=lambda: clk[0])
    trace = []

    def note(op):
        trace.append((op, b.state, b.state_code))

    for op, arg in [("fail", 0), ("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0),
                    ("fail", 0), ("allow", 0), ("tick", 4.9), ("allow", 0), ("tick", 0.1),
                    ("allow", 0), ("allow", 0), ("fail", 0), ("allow", 0), ("tick", 5.0),
                    ("allow", 0), ("tick", 5.0), ("allow", 0), ("ok", 0), ("allow", 0)]:
        if op == "fail":
            b.record_failure()
        elif op == "ok":
            b.record_success()
        elif op == "tick":
            clk[0] += arg
        else:
            trace.append(b.allow())
        note(op)
    return trace


def sc_retry_budget(P):
    rb = P.fleet.RetryBudget(ratio=0.5, cap=2.0)
    trace = [rb.try_withdraw(), rb.try_withdraw(), rb.try_withdraw(), rb.tokens]
    for _ in range(10):
        rb.deposit()
    trace += [rb.tokens, rb.try_withdraw()]
    rb.deposit()
    trace += [rb.tokens, P.METRICS.value("fleet_retry_budget_exhausted_total")]
    return trace


def test_breaker_and_retry_budget_step_as_jax():
    want, got = both(sc_breaker_cycle)
    assert got == want
    states = [s[1] for s in got if isinstance(s, tuple)]
    assert states == ["closed"] * 5 + ["open"] * 5 + ["half_open"] * 2 + ["open"] * 3 \
        + ["half_open"] * 3 + ["closed"] * 2
    assert [a for a in got if isinstance(a, bool)] == [False, False, True, False, False,
                                                       True, True, True]
    want, got = both(sc_retry_budget)
    assert got == want == [True, True, False, 0.0, 2.0, True, 1.5, 1.0]


# -- EngineFleet's request path, with engines scripted in Python -------------------

class ScriptedEngine:
    """Duck-typed engine whose submissions finish at once: failed until
    ``healthy``; ``raising`` makes submit raise as a closed engine does."""

    def __init__(self, engine_id: str):
        self.engine_id = engine_id
        self.healthy = False
        self.raising = False
        self.submitted = []

    def submit(self, prompt_ids, max_new_tokens, eos_id=None, temperature=0.0,
               traceparent=None, deadline=None, priority="interactive", on_done=None):
        if self.raising:
            raise RuntimeError("engine wedged")
        req = SimpleNamespace(
            prompt=np.asarray(prompt_ids, np.int32), max_new_tokens=max_new_tokens,
            eos_id=eos_id, temperature=temperature, deadline=deadline, priority=priority,
            tokens=[7] * max_new_tokens if self.healthy else [],
            error=None if self.healthy else RuntimeError("replica sick"),
            finish_reason="ok" if self.healthy else "error",
            on_done=on_done, done=threading.Event())
        req.done.set()
        if on_done is not None:
            on_done(req)
        self.submitted.append(req)
        return req

    def drain(self):
        return []

    def close(self):
        pass


def sc_fleet_breakers(P):
    clk = [0.0]
    fleet = P.fleet.EngineFleet(
        replicas=2, min_replicas=1, max_replicas=4, name="brk",
        engine_factory=ScriptedEngine, register_debug=False,
        breaker_factory=lambda: P.fleet.ReplicaBreaker(
            failure_threshold=2, open_s=5.0, clock=lambda: clk[0]), **P.kw)
    M = P.METRICS
    trace = []
    try:
        p = prompt(0)
        for _ in range(4):
            fleet.submit(p, 4)
            trace.append([(h.gauge_id, h.breaker.state, len(h.engine.submitted))
                          for h in fleet.live_handles()])
        trace.append([M.value("fleet_breaker_state", replica=h.gauge_id)
                      for h in fleet.live_handles()])
        try:
            fleet.submit(p, 4)
        except P.errors.FleetSaturated as e:
            trace.append(("saturated", str(e), e.retry_after_s))
        clk[0] += 5.0
        for h in fleet.live_handles():
            h.engine.healthy = True
        req = fleet.submit(p, 4)
        trace.append((req.error, req.tokens))
        trace.append([(h.gauge_id, h.breaker.state) for h in fleet.live_handles()])
        trace.append(M.value("tenant_tokens_total", namespace="default", direction="in"))
        trace.append(M.value("tenant_tokens_total", namespace="default", direction="out"))
        trace.append(fleet.retry_budget.tokens)
    finally:
        fleet.close()
    return trace


def sc_fleet_raising_engines(P):
    fleet = P.fleet.EngineFleet(
        replicas=3, min_replicas=1, max_replicas=4, name="rb",
        engine_factory=ScriptedEngine, register_debug=False,
        retry_budget=P.fleet.RetryBudget(ratio=0.0, cap=1.0), **P.kw)
    trace = []
    try:
        for h in fleet.live_handles():
            h.engine.raising = True
        try:
            fleet.submit(prompt(1), 4)
        except P.errors.FleetSaturated as e:
            trace.append(str(e))
        trace.append([(h.gauge_id, h.state) for h in fleet._replicas.values()])
        trace.append(P.METRICS.value("fleet_retry_budget_exhausted_total"))
    finally:
        fleet.close()
    return trace


def test_fleet_breakers_route_as_jax():
    want, got = both(sc_fleet_breakers)
    assert got == want
    assert got[4] == [1.0, 1.0]  # both breakers open
    assert got[5][0] == "saturated" and "breakers open" in got[5][1]
    assert got[6] == (None, [7, 7, 7, 7])
    assert "closed" in {s for _, s in got[7]}
    assert (got[8], got[9]) == (30.0, 4.0)
    want, got = both(sc_fleet_raising_engines)
    assert got == want
    assert "retry budget exhausted" in got[0] and got[2] == 1.0


# -- SLOAutoscaler ----------------------------------------------------------------

class ScalableFleet:
    def __init__(self, n=2, lo=1, hi=4):
        self.n, self.min_replicas, self.max_replicas = n, lo, hi
        self.calls = []

    @property
    def desired_replicas(self):
        return self.n

    def scale_to(self, n, reason=""):
        self.calls.append((n, reason))
        self.n = n


class DisaggFleet:
    max_replicas = 4

    def __init__(self):
        self.sizes = {"prefill": 1, "decode": 1}
        self.calls = []

    @property
    def pools(self):
        return dict(self.sizes)

    def pool_size(self, pool=None):
        return self.sizes[pool or "decode"]

    def scale_to(self, n, reason="", pool=None):
        self.calls.append((pool, n, reason))
        self.sizes[pool] = n


def _asc(P, fleet, **kw):
    base = dict(ttft_slo=0.5, queue_wait_slo=0.25, quantile=0.99, scale_down_margin=0.5,
                breach_ticks=2, idle_ticks=3, cooldown_ticks=2)
    base.update(kw)
    return P.autoscaler.SLOAutoscaler(fleet, P.autoscaler.AutoscalerConfig(**base))


#: (ttft, queue wait) observations per tick, count 10 each; None: no traffic
UNIFIED_SCRIPT = [None, (3.0, 0.01), (3.0, 0.01), (3.0, 0.01), (3.0, 0.01), (0.35, 0.1),
                  (0.35, 0.1), None, None, None, None, (0.01, 1.0), (0.01, 1.0),
                  (30.0, 0.01), None, None, None, None, None, None, None]


def sc_unified_autoscaler(P):
    fleet = ScalableFleet(n=2)
    asc = _asc(P, fleet, cooldown_ticks=3)
    ttft = P.METRICS.histogram("serving_ttft_seconds", buckets=TTFT_BUCKETS)
    qwait = P.METRICS.histogram("serving_queue_wait_seconds")
    trace = []
    for obs in UNIFIED_SCRIPT:
        if obs is not None:
            ttft.observe(obs[0], count=10)
            qwait.observe(obs[1], count=10)
        trace.append((asc.tick(), fleet.n, dict(asc.last)))
    trace.append(fleet.calls)
    trace.append({(d, r): P.METRICS.value("fleet_autoscale_total", direction=d, reason=r,
                                          pool="unified")
                  for d, r in (("up", "slo_breach"), ("down", "idle"))})
    return trace


#: (ttft, inter-token) observations per tick, count 10 each
POOL_SCRIPT = [None, (3.0, 0.001), (3.0, 0.001), (3.0, 0.001), (0.01, 1.0), (0.01, 1.0),
               (3.0, 1.0), (3.0, 1.0), None, None, None, None, None, None]


def sc_pool_autoscaler(P):
    fleet = DisaggFleet()
    asc = _asc(P, fleet, cooldown_ticks=3)
    ttft = P.METRICS.histogram("serving_ttft_seconds", buckets=TTFT_BUCKETS)
    itl = P.METRICS.histogram("serving_inter_token_seconds", buckets=TTFT_BUCKETS)
    trace = []
    for obs in POOL_SCRIPT:
        if obs is not None:
            ttft.observe(obs[0], count=10)
            itl.observe(obs[1], count=10)
        trace.append((asc.tick(), dict(fleet.sizes), dict(asc.last)))
    trace.append(fleet.calls)
    return trace


def test_autoscaler_decides_as_jax_unified():
    want, got = both(sc_unified_autoscaler)
    assert got == want
    decisions = [d for d, _, _ in got[:-2]]
    assert decisions[:5] == [None, None, "up", None, None]  # then its cooldown
    assert decisions.count("up") >= 1 and "down" in decisions
    assert got[-2][0] == (3, "slo_breach")
    assert got[-1][("up", "slo_breach")] >= 1.0


def test_autoscaler_decides_as_jax_per_pool():
    want, got = both(sc_pool_autoscaler)
    assert got == want
    calls = got[-1]
    assert calls[0] == ("prefill", 2, "slo_breach")
    assert ("decode", 2, "slo_breach") in calls
    assert set(got[0][2]) >= {"prefill", "decode", "ttft_p", "inter_token_p", "decision"}


def test_autoscaler_start_and_stop_tick_on_a_timer():
    fleet = ScalableFleet(n=3, lo=1)
    asc = _asc(PORT, fleet, idle_ticks=1, cooldown_ticks=0)
    asc.start(interval=0.01)
    try:
        deadline = time.monotonic() + 10
        while fleet.n > 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        asc.stop()
    assert fleet.n == 1 and asc._thread is None
    assert asc.last["source"] == "registry"
