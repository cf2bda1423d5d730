"""``/debug/profile`` and the profile server of kubeflow_tpu_torch/gpu/profiling.py
against kubeflow_tpu/tpu/profiling.py, on the CPU.

The mirrors of ``tests/test_profiling.py``'s ``TestProfileServer`` (one
server a process, idempotent on its port, another port refused) and
``TestProfileDebugSource`` (the selected clock's last steps, 404 for an
unknown clock, 400 for a non-numeric ``steps``, an on-demand capture that
ignores a stale step and returns the fresh steps 2 and 3); the same
scripted steps give the same trace document through both packages'
``_profile_debug_source``; and HTTP round trips through
``start_profile_server(0)`` and a ``ModelServer``'s ``/debug/profile``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu.tpu import profiling as jprof
from kubeflow_tpu_torch.gpu import profiling as tprof
from kubeflow_tpu_torch.web import http as thttp


class _Req:
    def __init__(self, **query):
        self.query = query

    def query1(self, name, default=""):
        return self.query.get(name, default)


def _run_steps(clock, n):
    for _ in range(n):
        with clock.compute():
            pass
        with clock.fetch():
            pass
        clock.end_step()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _status(port, path):
    try:
        return _get(port, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


class TestProfileServer:
    @pytest.fixture(autouse=True)
    def _fresh_server_state(self, monkeypatch):
        # count the servers started, and stop the real one after the test
        self.started = []
        real = thttp.App.serve

        def serve(app, port=0, host="127.0.0.1"):
            server = real(app, port, host)
            self.started.append(server)
            return server

        monkeypatch.setattr(thttp.App, "serve", serve)
        monkeypatch.setattr(tprof, "_server_ports", None)
        monkeypatch.setattr(tprof, "_server", None)
        yield
        for server in self.started:
            server.close()

    def test_starts_once_and_is_idempotent(self):
        port = tprof.start_profile_server(0)
        assert port > 0
        assert tprof.start_profile_server(0) == port
        assert tprof.start_profile_server(port) == port
        assert len(self.started) == 1, "second call must not start a second server"
        assert self.started[0].port == port

    def test_conflicting_port_is_an_error(self):
        port = tprof.start_profile_server(0)
        with pytest.raises(RuntimeError, match=f"already on port {port}"):
            tprof.start_profile_server(port + 1)
        assert len(self.started) == 1

    def test_serves_the_profile_and_the_observability_routes(self):
        clock = tprof.register_profile_clock(tprof.StepClock(), name="srv")
        try:
            _run_steps(clock, 3)
            port = tprof.start_profile_server(0)
            status, doc = _get(port, "/debug/profile?clock=srv&steps=2")
            assert status == 200 and doc["displayTimeUnit"] == "ms"
            assert [e["args"]["step"] for e in doc["traceEvents"] if e["cat"] == "step"] \
                == [2, 3]
            assert _status(port, "/debug/profile?clock=nope") == 404
            assert _status(port, "/debug/profile?steps=many") == 400
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                assert r.read().decode().rstrip().endswith("# EOF")
        finally:
            tprof._PROFILE_CLOCKS.pop("srv", None)


class TestProfileDebugSource:
    @pytest.fixture(autouse=True)
    def _own_clock(self):
        self.clock = tprof.register_profile_clock(tprof.StepClock(), name="unit")
        yield
        tprof._PROFILE_CLOCKS.pop("unit", None)

    def test_snapshot_returns_selected_clock(self):
        _run_steps(self.clock, 3)
        doc = tprof._profile_debug_source(_Req(clock="unit", steps="2"))
        steps = [e for e in doc["traceEvents"] if e["cat"] == "step"]
        assert len(steps) == 2
        assert doc["displayTimeUnit"] == "ms"

    def test_unknown_clock_404s(self):
        with pytest.raises(thttp.HttpError) as err:
            tprof._profile_debug_source(_Req(clock="nope"))
        assert err.value.status == 404
        assert "'unit'" in str(err.value)

    def test_bad_steps_400s(self):
        for query in ({"steps": "many"}, {"timeout": "soon"}):
            with pytest.raises(thttp.HttpError) as err:
                tprof._profile_debug_source(_Req(**query))
            assert err.value.status == 400

    def test_on_demand_capture_waits_for_fresh_steps(self):
        _run_steps(self.clock, 1)  # stale step that must NOT satisfy the wait
        box = {}

        def capture():
            box["doc"] = tprof._profile_debug_source(
                _Req(clock="unit", steps="2", timeout="10"))

        t = threading.Thread(target=capture)
        t.start()
        time.sleep(0.1)
        assert t.is_alive(), "capture returned before fresh steps existed"
        _run_steps(self.clock, 2)
        t.join(timeout=30)
        assert not t.is_alive()
        steps = [e for e in box["doc"]["traceEvents"] if e["cat"] == "step"]
        assert [e["args"]["step"] for e in steps] == [2, 3]

    def test_last_registration_of_a_name_wins(self):
        newer = tprof.register_profile_clock(tprof.StepClock(), name="unit")
        _run_steps(self.clock, 2)
        _run_steps(newer, 1)
        doc = tprof._profile_debug_source(_Req(clock="unit"))
        assert len([e for e in doc["traceEvents"] if e["cat"] == "step"]) == 1


class FakeTime:
    def __init__(self) -> None:
        self.t = 500.0

    def perf_counter(self) -> float:
        return self.t

    def time_ns(self) -> int:
        return int(round(self.t * 1e9)) + 1_700_000_000_000_000_000


def _scripted(mod, fake, n, offset):
    clock = mod.StepClock()
    for i in range(n):
        with clock.data_wait():
            fake.t += 0.001 * (i + 1) + offset
        with clock.compute():
            fake.t += 0.02
        with clock.fetch():
            fake.t += 0.004
        fake.t += 0.0005
        clock.end_step()
    return clock


def test_trace_document_equals_jax(monkeypatch):
    """Two clocks a package ("train" and "eval"), the same scripted steps
    under one fake clock: every query gives JAX's document, tids in sorted
    name order."""
    fake = FakeTime()
    monkeypatch.setattr(time, "perf_counter", fake.perf_counter)
    monkeypatch.setattr(time, "time_ns", fake.time_ns)
    monkeypatch.setattr(jprof, "_PROFILE_CLOCKS", {})
    monkeypatch.setattr(tprof, "_PROFILE_CLOCKS", {})
    for mod in (jprof, tprof):
        fake.t = 500.0
        mod.register_profile_clock(_scripted(mod, fake, 5, 0.0), name="train")
        mod.register_profile_clock(_scripted(mod, fake, 3, 0.002), name="eval")
    for query in ({}, {"steps": "2"}, {"clock": "train", "steps": "4"}, {"clock": "eval"},
                  {"steps": "0"}):
        want = jprof._profile_debug_source(_Req(**query))
        got = tprof._profile_debug_source(_Req(**query))
        assert got == want, query
    doc = tprof._profile_debug_source(_Req())
    assert {e["tid"] for e in doc["traceEvents"] if e["cat"] == "step"} == {1, 2}
    assert [e["tid"] for e in doc["traceEvents"]][0] == 1  # "eval" sorts first


def test_model_server_serves_debug_profile():
    from kubeflow_tpu_torch.serving.server import ModelServer

    clock = tprof.register_profile_clock(tprof.StepClock(), name="ms")
    server = ModelServer()
    httpd = server.serve(0)
    try:
        _run_steps(clock, 4)
        status, doc = _get(httpd.port, "/debug/profile?clock=ms&steps=3")
        assert status == 200
        steps = [e for e in doc["traceEvents"] if e["cat"] == "step"]
        phases = [e["name"] for e in doc["traceEvents"] if e["cat"] == "phase"]
        assert [e["args"]["step"] for e in steps] == [2, 3, 4]
        assert phases == ["compute", "fetch"] * 3
    finally:
        httpd.close()
        server.close()
        tprof._PROFILE_CLOCKS.pop("ms", None)
