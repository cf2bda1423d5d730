"""The engine hooks a fleet hangs on, in kubeflow_tpu_torch/serving/continuous.py,
against kubeflow_tpu/serving/continuous.py, on the CPU.

``submit(..., on_done=cb)`` must fire ``cb`` exactly once, after ``done``
is set, on every way a request finishes: retired, cancelled while queued
or decoding, its deadline passed while queued or decoding, failed at
admission, failed by ``close``, by a poisoned iteration
(``fail_next_step``), handed off from a prefill engine and retired on the
decode engine; and never for a deadline already past at submit, nor for a
request ``drain`` hands back (it has not finished). The chaos hooks
``step_delay_s`` and ``fail_next_step`` act as JAX's. Each scenario runs
on the JAX engine and on the port's, and their traces (callback counts,
finish reasons, error types, whether tokens are partial) must be equal.
Last, the counters that several engine threads bump at once lose no
update.
"""

import collections
import sys
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
from kubeflow_tpu_torch.models.gpt import GptConfig
from kubeflow_tpu_torch.ops import kv_cache as kc
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

torch.set_num_threads(1)

#: max_seq 512 leaves room for a 300-token prompt over the largest bucket
SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=512, vocab_size=101)
ENGINE = dict(slots=1, chunk=2, pipeline=1, prefill_chunk=0)
PROMPT = np.random.default_rng(3).integers(0, 101, 6).astype(np.int32)
LONG = np.random.default_rng(4).integers(0, 101, 300).astype(np.int32)


@pytest.fixture(scope="module")
def sides():
    """(engine class, cfg, params, extra kwargs) of the JAX engine and the
    port's, on the same f32 weights."""
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    jp = JLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tp = params_from_flax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    return [(JBatcher, jcfg, jp, {}), (ContinuousBatcher, cfg, tp, {"device": "cpu"})]


class Calls:
    """on_done callbacks by path name; each records the request's outcome,
    and whether ``done`` was already set when it fired."""

    def __init__(self):
        self.seen = collections.defaultdict(list)

    def cb(self, name):
        def on_done(req):
            self.seen[name].append((req.done.is_set(), req.finish_reason,
                                    type(req.error).__name__ if req.error else None,
                                    0 < len(req.tokens) < req.max_new_tokens))
        return on_done

    def trace(self, names):
        return {n: self.seen.get(n, []) for n in names}


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert pred()


def _finishing_paths(make, cfg, params, kw):
    calls = Calls()
    eng = make(cfg, params, **ENGINE, **kw)
    try:
        eng.submit(PROMPT, 4, on_done=calls.cb("retired")).result(timeout=120)
        late = eng.submit(PROMPT, 4, deadline=time.monotonic() - 1.0,
                          on_done=calls.cb("expired_at_submit"))
        assert late.done.is_set()
        bad = eng.submit(LONG, 2, on_done=calls.cb("failed_admission"))
        bad.done.wait(timeout=120)
        eng.step_delay_s = 0.02  # a slow replica: deadlines expire, queues form
        a = eng.submit(PROMPT, 60, on_done=calls.cb("cancelled_decoding"))
        _wait(lambda: len(a.tokens) > 0)
        b = eng.submit(PROMPT, 4, on_done=calls.cb("cancelled_queued"))
        b.cancel()
        c = eng.submit(PROMPT, 4, deadline=time.monotonic() + 0.05,
                       on_done=calls.cb("deadline_queued"))
        for r in (b, c):
            r.done.wait(timeout=60)
        a.cancel()
        a.done.wait(timeout=60)
        d = eng.submit(PROMPT, 60, deadline=time.monotonic() + 0.3,
                       on_done=calls.cb("deadline_decoding"))
        d.done.wait(timeout=60)
        e = eng.submit(PROMPT, 60, on_done=calls.cb("closed"))
        _wait(lambda: len(e.tokens) > 0)
    finally:
        eng.close()
    e.done.wait(timeout=60)
    return calls.trace(["retired", "expired_at_submit", "failed_admission",
                        "cancelled_decoding", "cancelled_queued", "deadline_queued",
                        "deadline_decoding", "closed"])


def _drain_and_poison(make, cfg, params, kw):
    calls = Calls()
    eng = make(cfg, params, **ENGINE, **kw)
    eng.step_delay_s = 0.02
    a = eng.submit(PROMPT, 10, on_done=calls.cb("drained_in_flight"))
    _wait(lambda: len(a.tokens) > 0)
    b = eng.submit(PROMPT, 4, on_done=calls.cb("handed_back"))
    handed = eng.drain()
    trace = calls.trace(["drained_in_flight", "handed_back"])
    trace["handed"] = [r is b and not r.done.is_set() for r in handed]
    try:
        eng.submit(PROMPT, 4, on_done=calls.cb("submit_after_close"))
    except RuntimeError as err:
        trace["raised"] = type(err).__name__
    trace["submit_after_close"] = calls.seen["submit_after_close"]
    eng.close()
    poisoned = make(cfg, params, **ENGINE, **kw)
    try:
        poisoned.fail_next_step = True
        p = poisoned.submit(PROMPT, 4, on_done=calls.cb("poisoned"))
        p.done.wait(timeout=60)
        trace["poisoned"] = calls.seen["poisoned"]
        trace["poison_message"] = "chaos: replica crashed mid-decode" in str(p.error)
        trace["poison_is_one_shot"] = poisoned.fail_next_step
        try:
            poisoned.submit(PROMPT, 4)
        except RuntimeError as err:
            trace["after_poison"] = type(err).__name__
    finally:
        poisoned.close()
    return trace


def _handoff(make, cfg, params, kw):
    calls = Calls()
    pk = dict(slots=2, chunk=2, pipeline=1)
    decode = make(cfg, params, engine_id="d", role="decode", **pk, **kw)
    prefill = make(cfg, params, engine_id="p", role="prefill",
                   handoff_sink=decode.submit_handoff, **pk, **kw)
    try:
        r = prefill.submit(PROMPT, 6, on_done=calls.cb("handed_off"))
        toks = [int(t) for t in r.result(timeout=120)]
    finally:
        prefill.close()
        decode.close()
    return {"calls": calls.seen["handed_off"], "tokens": toks}


@pytest.mark.parametrize("scenario", [_finishing_paths, _drain_and_poison, _handoff],
                         ids=["finishing_paths", "drain_and_poison", "handoff"])
def test_on_done_and_chaos_hooks_act_as_jax(sides, scenario):
    want, got = (scenario(*side) for side in sides)
    assert got == want
    for name, seen in got.items():
        if isinstance(seen, list) and seen and isinstance(seen[0], tuple):
            assert all(s[0] for s in seen), f"{name}: on_done fired before done was set"
    if scenario is _finishing_paths:
        once = {n: len(s) for n, s in got.items()}
        assert once == {"retired": 1, "expired_at_submit": 0, "failed_admission": 1,
                        "cancelled_decoding": 1, "cancelled_queued": 1,
                        "deadline_queued": 1, "deadline_decoding": 1, "closed": 1}
        assert got["retired"][0][1:] == ("ok", None, False)
        assert got["failed_admission"][0][1:3] == ("error", "ValueError")
        assert got["cancelled_decoding"][0][1:] == ("cancelled", None, True)
        assert got["cancelled_queued"][0][1:3] == ("cancelled", "RequestCancelled")
        assert got["deadline_queued"][0][1:3] == ("deadline", "DeadlineExceeded")
        assert got["deadline_decoding"][0][1:] == ("deadline", None, True)
        assert got["closed"][0][1:3] == ("error", "EngineClosed")
    elif scenario is _drain_and_poison:
        assert len(got["drained_in_flight"]) == 1 and got["handed_back"] == []
        assert got["handed"] == [True] and got["raised"] == "EngineClosed"
        assert len(got["submit_after_close"]) == 1
        assert got["poisoned"] == [(True, "error", "EngineClosed", False)]
        assert got["poison_message"] and got["poison_is_one_shot"] is False
        assert got["after_poison"] == "EngineClosed"
    else:
        assert got["calls"] == [(True, "ok", None, False)]


def test_counters_lose_no_update_under_threads(monkeypatch):
    """Eight threads bump one counter, one histogram and one LAUNCHES entry
    (through the launch path, its kernel entry stubbed) with the
    interpreter switching threads every microsecond: every update lands."""
    reg = MetricsRegistry()
    monkeypatch.setattr(kc._build, "entry", lambda source, name: lambda *a: 0)
    monkeypatch.setattr(kc, "_raw_stream", lambda index: 0)
    kc.reset_launches()
    target = torch.zeros(1)
    n_threads, n = 8, 3000

    def work():
        c = reg.counter("c")
        h = reg.histogram("h")
        for _ in range(n):
            c.inc()
            h.observe(0.5)
            kc._launch("kv_block_update_pair", "stub", target)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert reg.value("c") == n_threads * n
    assert reg.histogram("h").total == n_threads * n
    assert reg.histogram("h").mean == 0.5
    assert kc.LAUNCHES["kv_block_update_pair"] == n_threads * n
    kc.reset_launches()
