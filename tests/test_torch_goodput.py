"""kubeflow_tpu_torch/monitoring/goodput.py and the metrics it needs, against
the JAX package's.

The same scripted calls, on a fake clock, go into JAX's and the port's
``GoodputLedger``: the snapshots are equal (the same float arithmetic, so
``==``), as are the rendered ``training_*`` series, the returned
incarnation sections and ``serving_goodput_view``; the fractions alone may
differ, by at most 2⁻⁵¹ each: the port puts them on a grid of 2⁻⁵² so that
they sum to exactly 1.0 in any order, where JAX's close the left-to-right
sum only (ROADMAP C). ``MetricsRegistry.total``/``timer`` and
``_Gauge.dec`` behave as JAX's.
"""

from __future__ import annotations

import math
import random

import pytest

from kubeflow_tpu.monitoring import goodput as jg
from kubeflow_tpu.runtime.metrics import METRICS as J_METRICS
from kubeflow_tpu.runtime.metrics import MetricsRegistry as JRegistry
from kubeflow_tpu_torch.monitoring import goodput as tg
from kubeflow_tpu_torch.runtime.metrics import METRICS as T_METRICS
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as TRegistry
from kubeflow_tpu_torch.runtime.obs import mount_observability
from kubeflow_tpu_torch.web.http import App, Request


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    T_METRICS.reset()
    yield


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now

    def tick(self, dt: float) -> float:
        self.now += dt
        return self.now


class FakeStepClock:
    compile_s = 0.0
    steps: list = []


def _basic(led, clk, sc):
    led.start()
    led.begin_incarnation(0)
    clk.tick(2.0)
    led.note("scheduling_wait", 2.0)
    clk.tick(1.5)
    led.note("checkpoint_restore", 1.5)
    for i in range(4):
        clk.tick(1.0)
        led.step(i, 1.0)
    clk.tick(0.5)
    led.note("checkpoint_save", 0.5)
    return [led.end_incarnation("completed", 4)]


def _other(led, clk, sc):
    led.start()
    led.begin_incarnation(0)
    clk.tick(4.0)
    led.step(0, 1.0)  # 3 s of wallclock nobody measured
    return []


def _replay(led, clk, sc):
    led.start()
    led.begin_incarnation(0)
    out = []
    for i in range(5):  # steps 0..4, then the gang dies
        clk.tick(1.0)
        led.step(i, 1.0)
    out.append(led.end_incarnation("lost", 4))
    led.begin_incarnation(1)
    for i in range(3, 8):  # restored at step 3: 3 and 4 are replay
        clk.tick(0.7)
        led.step(i, 0.7)
    clk.tick(0.3)
    led.note("reshard", 0.3)
    out.append(led.end_incarnation("completed", 8))
    led.begin_incarnation(2)  # abandoned by finish()
    clk.tick(0.1)
    return out


def _clock_drain(led, clk, sc):
    led.start()
    led.attach_step_clock(sc)
    led.begin_incarnation(0)
    sc.compile_s = 2.0
    sc.steps = [{"data_wait": 0.5, "compute": 0.4, "total": 1.0}]
    clk.tick(3.0)
    led.step(0, 3.0)
    clk.tick(1.0)
    led.step(1, 1.0)
    sc.steps = sc.steps + [{"data_wait": 0.25, "total": 0.5}]
    clk.tick(0.1)
    led.step(2, 1 / 3)  # fractions that do not sum exactly by accident
    return []


def _seeded(seed):
    """Four steps and four badput intervals of random lengths."""

    def script(led, clk, sc):
        rnd = random.Random(seed)
        led.start()
        led.begin_incarnation(0)
        for i in range(4):
            dt = rnd.random()
            clk.tick(dt * 1.25)
            led.step(i, dt)
            bucket = rnd.choice(["compile", "checkpoint_save", "reshard", "data_wait",
                                 "scheduling_wait"])
            x = rnd.random() * 0.2
            clk.tick(x)
            led.note(bucket, x)
        return []

    return script


SCRIPTS = {"basic": _basic, "other": _other, "replay": _replay, "clock_drain": _clock_drain,
           "seeded_5": _seeded(5)}


def _split(snap):
    """(the snapshot without its fractions, the fractions)."""
    rest = {k: v for k, v in snap.items() if k not in ("fractions", "goodputFraction")}
    return rest, snap["fractions"]


def _sums_to_one(fractions):
    values = list(fractions.values())
    left = 0.0
    for v in values:
        left += v
    return left == sum(values) == sum(reversed(values)) == math.fsum(values) == 1.0


def _run(module, registry, name):
    clk = FakeClock()
    sc = FakeStepClock()
    sc.steps = []
    led = module.GoodputLedger(f"gp-{name}", registry=registry, clock=clk)
    sections = SCRIPTS[name](led, clk, sc)
    live = led.snapshot()
    final = led.finish()
    return led, live, final, sections


def _series(registry, workload):
    lines = [ln for ln in registry.render().splitlines()
             if ln.startswith(("training_badput", "training_goodput_seconds"))
             or (ln.startswith("training_goodput_fraction") and workload in ln)]
    return sorted(lines)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ledger_snapshots_equal_jax(name):
    jreg, treg = JRegistry(), TRegistry()
    _, jlive, jfinal, jsec = _run(jg, jreg, name)
    _, tlive, tfinal, tsec = _run(tg, treg, name)
    for got, want in ((tlive, jlive), (tfinal, jfinal)):
        rest, fractions = _split(got)
        want_rest, want_fractions = _split(want)
        assert rest == want_rest
        assert list(fractions) == list(want_fractions)
        for k, v in fractions.items():
            assert abs(v - want_fractions[k]) <= 2.0 ** -51, (k, v, want_fractions[k])
        assert got["goodputFraction"] == fractions["goodput"]
        assert _sums_to_one(fractions), fractions
    assert tsec == jsec
    assert set(tfinal["badputSeconds"]) == set(tg.BADPUT_BUCKETS) == set(jg.BADPUT_BUCKETS)
    assert _series(treg, f"gp-{name}") == _series(jreg, f"gp-{name}")
    assert _series(treg, f"gp-{name}"), "no training_* series rendered"


def test_fractions_sum_to_one_in_any_order_where_jax_reads_less():
    """Seed 5's decomposition: JAX closes the left-to-right sum of its
    fractions, but Python's ``sum`` (compensated since 3.12) reads them as
    1 - 2⁻⁵²; the port's, on a grid of 2⁻⁵², are 1.0 however summed."""
    _, _, jfinal, _ = _run(jg, JRegistry(), "seeded_5")
    _, _, tfinal, _ = _run(tg, TRegistry(), "seeded_5")
    left = 0.0
    for v in jfinal["fractions"].values():
        left += v
    assert left == 1.0 and sum(jfinal["fractions"].values()) == 1.0 - 2.0 ** -52
    assert _sums_to_one(tfinal["fractions"])


def test_unknown_bucket_and_residual_refused_as_in_jax():
    for module, reg in ((jg, JRegistry()), (tg, TRegistry())):
        led = module.GoodputLedger("refuse", registry=reg, clock=FakeClock())
        with pytest.raises(ValueError, match="unknown badput bucket"):
            led.note("coffee_break", 1.0)
        with pytest.raises(ValueError):
            led.note("other", 1.0)


def test_gauge_refreshes_at_render_time():
    for module, reg in ((jg, JRegistry()), (tg, TRegistry())):
        clk = FakeClock()
        led = module.GoodputLedger("live", registry=reg, clock=clk)
        led.start()
        led.begin_incarnation(0)
        clk.tick(2.0)
        led.step(0, 1.0)
        reg.render()  # no finish(): the collector surfaces the live fraction
        assert reg.value("training_goodput_fraction", workload="live") == 0.5


def _waste(registry):
    registry.counter("serving_tokens_out_total", tenant="a").inc(60)
    registry.counter("serving_tokens_out_total", tenant="b").inc(30)
    registry.counter("serving_discarded_tail_tokens_total").inc(10)
    registry.counter("serving_wasted_decode_tokens_total").inc(6)
    registry.counter("serving_shed_total", reason="queue").inc(2)
    registry.counter("serving_deadline_expired_total").inc(1)


def test_serving_goodput_view_equals_jax():
    jreg, treg = JRegistry(), TRegistry()
    assert tg.serving_goodput_view(treg) == jg.serving_goodput_view(jreg)
    assert tg.serving_goodput_view(treg)["tokenGoodputFraction"] is None
    _waste(jreg)
    _waste(treg)
    view = tg.serving_goodput_view(treg)
    assert view == jg.serving_goodput_view(jreg)
    assert view["tokenGoodputFraction"] == pytest.approx(0.9)


def test_debug_goodput_served_over_observability():
    clk = FakeClock()
    led = tg.GoodputLedger("dbg", clock=clk)
    led.start()
    led.begin_incarnation(0)
    clk.tick(1.0)
    led.step(0, 1.0)
    led.finish()
    assert tg.get_ledger("dbg") is led
    app = mount_observability(App("test"))
    resp = app.dispatch(Request(method="GET", path="/debug/goodput", query={}, headers={},
                                body=b""))
    assert resp.status == 200, resp.body
    doc = resp.body
    assert doc["workloads"]["dbg"]["goodputFraction"] == 1.0
    assert sum(doc["workloads"]["dbg"]["fractions"].values()) == 1.0
    assert "serving" in doc
    assert doc["tenants"] == {"boundChips": tg.TENANT_METER.open_intervals()}


def test_registry_total_timer_and_gauge_dec_as_jax():
    for reg in (J_METRICS, T_METRICS):
        reg.counter("x_total", k="a").inc(2.5)
        reg.counter("x_total", k="b").inc(1.5)
        reg.gauge("depth", q="1").set(3.0)
        reg.gauge("depth", q="1").dec()
        reg.gauge("depth", q="2").dec(0.5)
        with reg.timer("t_seconds", phase="p"):
            pass
        with pytest.raises(RuntimeError):
            with reg.timer("t_seconds", phase="p"):
                raise RuntimeError("observed all the same")
        ns = reg.namespace("svc")
        ns.counter("req_total", code="200").inc(4)
        with ns.timer("lat_seconds"):
            pass
    for name in ("x_total", "depth", "svc_req_total", "missing_total"):
        assert T_METRICS.total(name) == J_METRICS.total(name), name
    assert T_METRICS.namespace("svc").total("req_total") == 4.0
    assert T_METRICS.total("depth") == 1.5
    for reg in (J_METRICS, T_METRICS):
        assert reg.histogram("t_seconds", phase="p").total == 2
        assert reg.histogram("svc_lat_seconds").total == 1
