"""The fleet behind kubeflow_tpu_torch/serving/server.py against
kubeflow_tpu/serving/server.py, on the CPU, over real HTTP.

``GenerativeModel(replicas=2)`` serves the JAX server's predictions
(greedy tokens, exactly, f32 test config); ``/debug/fleet`` names both
replicas. The body's ``"model"`` field: 400 when a multiplexing servable
gets none and when a plain one gets one, on both packages alike;
``model_slo`` overrides the request's priority. A saturated fleet answers
503 with the JAX server's ``Retry-After``. ``GenerativeModel`` builds a
fleet exactly when JAX's ``_wants_fleet`` does, and
``python -m kubeflow_tpu_torch.serving.server --replicas 2`` serves one.
At GPT-tiny (bf16) with JAX's weights converted, a 3-replica fleet serves
the JAX fleet's tokens for the fleet driver's prompt.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
from kubeflow_tpu.runtime.metrics import METRICS as JMETRICS
from kubeflow_tpu.serving.server import GenerativeModel as JModel, ModelServer as JServer
from kubeflow_tpu_torch.models.convert import params_from_flax
from kubeflow_tpu_torch.models.gpt import GptConfig
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.fleet import EngineFleet
from kubeflow_tpu_torch.serving.server import GenerativeModel, ModelServer

torch.set_num_threads(1)

SHAPE = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101)
NEW = 6


@pytest.fixture(autouse=True)
def _reset_port_metrics():
    METRICS.reset()
    yield


@pytest.fixture(scope="module")
def weights():
    jcfg = JCfg(**SHAPE, dtype=jnp.float32)
    cfg = GptConfig(**SHAPE, dtype=torch.float32)
    j = [JLM(jcfg).init(jax.random.PRNGKey(s), jnp.zeros((1, 8), jnp.int32))["params"]
         for s in (0, 1)]
    t = [params_from_flax(jax.tree_util.tree_map(np.asarray, p), cfg) for p in j]
    return jcfg, j, cfg, t


def _instances(n_rows=3, length=7, seed=5):
    return np.random.default_rng(seed).integers(0, 101, (n_rows, length)).tolist()


def _post(port, body, name="gen"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


class Served:
    """A GenerativeModel of either package behind its ModelServer on port 0."""

    def __init__(self, model, server_cls):
        self.model = model
        self.server = server_cls()
        self.server.add(model)
        self.httpd = self.server.serve(0)

    def post(self, body):
        return _post(self.httpd.port, body)

    def close(self):
        self.httpd.close()
        self.server.close()
        self.model.close()


def _pair(weights, **kw):
    """The JAX servable and the port's, same weights and fields."""
    jcfg, jp, cfg, tp = weights
    jkw, tkw = dict(kw), dict(kw)
    if "mux_models" in kw:
        jkw["mux_models"] = {"a": (jcfg, jp[0]), "b": (jcfg, jp[1])}
        tkw["mux_models"] = {"a": (cfg, tp[0]), "b": (cfg, tp[1])}
    jm = JModel(name="gen", apply_fn=None, params=jp[0], cfg=jcfg, max_new_tokens=NEW,
                slots=2, **jkw)
    tm = GenerativeModel(name="gen", apply_fn=None, params=tp[0], cfg=cfg,
                         max_new_tokens=NEW, slots=2, device="cpu", **tkw)
    return Served(jm, JServer), Served(tm, ModelServer)


def test_two_replicas_over_http_equal_the_jax_server(weights):
    jserved, served = _pair(weights, replicas=2)
    try:
        body = {"instances": _instances()}
        js, jbody, _ = jserved.post(body)
        status, out, _ = served.post(body)
        assert (status, js) == (200, 200)
        assert out["predictions"] == jbody["predictions"]
        assert isinstance(served.model.engine(), EngineFleet)
        # the same prompts again: prefix affinity sends each to its owner
        assert served.post(body)[1] == out
        assert METRICS.value("fleet_prefix_hits_total") == 3
        snap = _get(served.httpd.port, "/debug/fleet")
        assert {r["id"] for r in snap["replicas"]} == {"gen-0", "gen-1"}
        assert snap["max_replicas"] == 2
    finally:
        jserved.close()
        served.close()


def test_model_field_400s_and_model_slo_as_the_jax_server(weights):
    plain = _pair(weights)
    mux = _pair(weights, mux_models=True, model_slo={"b": "batch"})
    priorities = {}
    try:
        body = {"instances": _instances(1)}
        statuses = []
        for jserved, served in (plain, mux):
            for extra in ({}, {"model": "a"}):
                j = jserved.post(dict(body, **extra))[0]
                t = served.post(dict(body, **extra))[0]
                statuses.append((j, t))
        # plain: no model 200, a model 400; multiplexing: no model 400
        assert statuses == [(200, 200), (400, 400), (400, 400), (200, 200)]
        jserved, served = mux
        for side, key in ((jserved, "jax"), (served, "port")):
            fleet = side.model._continuous_engine() if key == "jax" else side.model.engine()
            submit = fleet.submit
            seen = priorities.setdefault(key, [])

            def spy(*a, _submit=submit, _seen=seen, **kw):
                _seen.append((kw["model"], kw["priority"]))
                return _submit(*a, **kw)

            fleet.submit = spy
        outs = {}
        for m in ("a", "b"):
            req = dict(body, model=m, priority="interactive")
            outs[m] = (jserved.post(req)[1], served.post(req)[1])
            assert outs[m][1] == outs[m][0]
        assert outs["a"][1] != outs["b"][1]  # each model its own weights
        assert priorities["port"] == priorities["jax"] == [("a", "interactive"),
                                                           ("b", "batch")]
        assert served.post(dict(body, model="zz"))[0] == jserved.post(
            dict(body, model="zz"))[0] == 400
    finally:
        for jserved, served in (plain, mux):
            jserved.close()
            served.close()


def _worker_idle(engine) -> bool:
    """The engine's worker blocks on its queue with nothing in flight, so
    its last queue-gauge write of the finished work has landed."""
    frame = sys._current_frames().get(engine._worker.ident)
    where = set()
    while frame is not None:
        where.add((os.path.basename(frame.f_code.co_filename), frame.f_code.co_name))
        frame = frame.f_back
    return ({("queue.py", "get"), ("threading.py", "wait")} <= where
            and not engine._pending and not engine._active)


def _wait_idle(*fleets, timeout=30.0) -> None:
    deadline = time.monotonic() + timeout
    engines = [h.engine for fleet in fleets for h in fleet.live_handles()]
    while not all(_worker_idle(e) for e in engines):
        assert time.monotonic() < deadline, "the fleets' engines never went idle"
        time.sleep(0.01)


def test_saturated_fleet_answers_503_with_the_jax_retry_after(weights):
    jserved, served = _pair(weights, replicas=2)
    try:
        body = {"instances": _instances(1)}
        assert jserved.post(body)[0] == served.post(body)[0] == 200
        # an engine that has not gone idle writes its queue gauge once more
        # after its request returns: that write must land before the reset
        # and the 32-deep gauges below, not after them
        _wait_idle(jserved.model._continuous_engine(), served.model.engine())
        answers = []
        for side, registry in ((jserved, JMETRICS), (served, METRICS)):
            # the hint is the shortest queue times the mean request seconds:
            # the same history on both sides
            registry.reset()
            registry.histogram("serving_request_seconds").observe(0.75)
            for rid in ("gen-0", "gen-1"):
                registry.gauge("serving_queue_depth", replica=rid).set(32)
            status, out, headers = side.post(body)
            answers.append((status, headers.get("Retry-After")))
        assert answers[1] == answers[0] == (503, "24")
    finally:
        jserved.close()
        served.close()


class _Saturated:
    def submit(self, *a, **kw):
        from kubeflow_tpu_torch.serving.errors import FleetSaturated

        raise FleetSaturated("every replica full", retry_after_s=7.2)

    def close(self):
        pass


def test_saturation_retry_after_rounds_up(weights):
    _, _, cfg, tp = weights
    model = GenerativeModel(name="gen", apply_fn=None, params=tp[0], cfg=cfg,
                            max_new_tokens=4, device="cpu")
    model._engine = _Saturated()
    served = Served(model, ModelServer)
    try:
        status, _, headers = served.post({"instances": [[1, 2, 3]]})
        assert status == 503 and headers["Retry-After"] == "8"
    finally:
        served.close()


@pytest.mark.parametrize("fields", [{}, {"replicas": 2}, {"max_replicas": 2},
                                    {"pools": {"prefill": 1, "decode": 1}},
                                    {"mux_models": True}])
def test_a_fleet_exactly_when_jax_wants_one(weights, fields):
    jcfg, jp, cfg, tp = weights
    fields = dict(fields)
    if fields.get("mux_models"):
        fields["mux_models"] = {"a": (cfg, tp[0])}
    jm = JModel(name="g", apply_fn=None, params=jp[0], cfg=jcfg,
                **{k: v for k, v in fields.items() if k != "mux_models"},
                **({"mux_models": {"a": (jcfg, jp[0])}} if "mux_models" in fields else {}))
    tm = GenerativeModel(name="g", apply_fn=None, params=tp[0], cfg=cfg, device="cpu",
                         **fields)
    try:
        assert tm._wants_fleet() == jm._wants_fleet()
        eng = tm.engine()
        assert isinstance(eng, EngineFleet if jm._wants_fleet() else ContinuousBatcher)
        if isinstance(eng, EngineFleet):
            assert eng.max_replicas == (fields.get("max_replicas") or
                                        max(fields.get("replicas", 1), 1))
            assert all(h.engine.device.type == "cpu" for h in eng.live_handles())
    finally:
        tm.close()
        jm.close()


def test_main_serves_a_fleet_of_two():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.server", "--replicas", "2",
         "--device", "cpu", "--tiny", "--port", "0", "--max-new-tokens", "3"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "fleet replicas=2" in line, line + proc.stderr.read()
        port = int(line.split(" on :")[1].split()[0])
        status, out, _ = _post(port, {"instances": [[1, 2, 3, 4]]}, name="gpt")
        assert status == 200 and len(out["predictions"][0]) == 7
        snap = _get(port, "/debug/fleet")
        assert len(snap["replicas"]) == 2 and snap["fleet"] == "gpt"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_gpt_tiny_fleet_equals_the_jax_fleet():
    """The fleet driver's servable (GPT-tiny, bf16, 3 replicas of 2 slots,
    24 new tokens) with JAX's seeded weights converted: the port's fleet
    serves the JAX fleet's tokens for the driver's prompt, exactly."""
    from kubeflow_tpu.serving.server import gpt_served_model as jax_gpt_served
    from kubeflow_tpu_torch.e2e import fleet_driver

    jm = jax_gpt_served(name="gen", tiny=True, max_new_tokens=fleet_driver.BUDGET,
                        replicas=fleet_driver.REPLICAS)
    jm.slots = fleet_driver.SLOTS
    cfg = GptConfig.tiny()
    tm = GenerativeModel(name="gen", apply_fn=None,
                         params=params_from_flax(jax.tree_util.tree_map(np.asarray, jm.params),
                                                 cfg),
                         cfg=cfg, max_new_tokens=fleet_driver.BUDGET,
                         replicas=fleet_driver.REPLICAS, slots=fleet_driver.SLOTS,
                         device="cpu")
    jserved, served = Served(jm, JServer), Served(tm, ModelServer)
    try:
        body = {"instances": [list(range(1, 9))]}
        js, jbody, _ = jserved.post(body)
        status, out, _ = served.post(body)
        assert (status, js) == (200, 200)
        assert out["predictions"] == jbody["predictions"]
        assert len(out["predictions"][0]) == 8 + fleet_driver.BUDGET
    finally:
        jserved.close()
        served.close()
