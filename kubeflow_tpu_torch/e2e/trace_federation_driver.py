"""Trace federation over real processes: the port of
``e2e/trace_federation_driver.py``.

One gang-bind journey traced across three processes. This process plays
the user edge (``TRACER.service = "loadgen"``): it mints a W3C
traceparent and submits a gang of GPU pods through
:class:`~kubeflow_tpu_torch.scale.loadgen.LoadGenerator` to an apiserver
started as ``python -m kubeflow_tpu_torch.apiserver``, with ``python -m
kubeflow_tpu_torch.scheduler.core`` reconciling from a third process. The
two control-plane processes import the port from this checkout
(``PYTHONPATH``) and no torch. Then, with JAX's five checks:

1. the minted trace id appears verbatim in every bound member's creation
   and bind traceparent annotations (two process hops kept the context);
2. a GPT served in this process (2 replicas, paged, ``max_new_tokens`` 4)
   answers one predict under the SAME traceparent, so its
   ``serving.request`` span, with its ``replica``, joins the gang's trace;
3. a :class:`TraceCollector` federates the three span buffers (apiserver
   and scheduler over HTTP, this process's ring directly) into a trace
   spanning >= 3 services with the journey's span names;
4. ``critical_path()`` splits the trace into queue, cycle and bind, which
   reconstruct the scheduler's recorded ``gang.bind_latency_s`` within
   ``max(10%, 0.05 s)``; the scheduler's ``/metrics`` carries the
   bind-latency histogram with the trace id as its exemplar;
5. a burst of twice the budget of one-span traces, beside known serving
   5xx traces, goes through a small tail-sampled collector: every error
   trace and the gang trace survive, and the span bound holds.

``run(device="cuda", tiny=True, params=None, model=None)`` returns JAX's
report keys plus ``seconds`` (the whole run) and ``setup_s`` (to both
processes up). ``tiny`` serves JAX's GPT-tiny, ``tiny=False`` GPT-small;
``params`` are weights the caller built (``init_params`` of that config);
``model`` is a GPT servable named ``gpt`` the caller built and warmed,
served as it is and left open. The predict's decode writes its KV rows
through ``kv_block_update_pair``. Both processes are stopped before
``run`` returns or raises. ``main`` prints the report as one JSON line
and exits 0, or prints ``{"ok": false, "error": ...}`` and exits 1. On the
card: ``python -m kubeflow_tpu_torch.e2e.trace_federation_driver``
(GPT-small; ``--tiny`` and ``--device cpu`` for a CPU check).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
from typing import Any, Dict, List, Optional

from ..device import DeviceLike, resolve_device
from ._http import get, metric_value, poll, post

SEED = 14
NODES = 8
ERROR_PREDICTS = 3
MAX_NEW_TOKENS = 4
REPLICAS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _role_env(**extra: str) -> Dict[str, str]:
    """The control-plane processes import the port from this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.setdefault("LOG_LEVEL", "WARNING")
    env.update(extra)
    return env


def _spans_since(since_ns: int) -> dict:
    """This process's spans that started at or after ``since_ns``, as one
    OTLP document: its ring may hold other gangs' binds, from a scheduler
    an earlier caller ran in this process."""
    from ..runtime.obs import otlp_traces
    from ..runtime.tracing import TRACER

    doc = otlp_traces(TRACER, limit=4096)
    for rs in doc["resourceSpans"]:
        for sc in rs["scopeSpans"]:
            sc["spans"] = [s for s in sc["spans"] if s["startTimeUnixNano"] >= since_ns]
    return doc


def _stop(procs: List[subprocess.Popen]) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def run(device: DeviceLike = "cuda", tiny: bool = True, params=None,
        model=None) -> Dict[str, Any]:
    from ..apiserver.remote import RemoteStore
    from ..monitoring.scrape import Target
    from ..monitoring.traces import TraceCollector, critical_path, traces_url
    from ..runtime.tracing import BIND_TRACEPARENT_ANNOTATION, TRACEPARENT_ANNOTATION, TRACER
    from ..scale.loadgen import LoadGenerator
    from ..scale.topology import synth_gangs, synthesize
    from ..serving.server import ModelServer, gpt_served_model

    t_run, run_ns = time.monotonic(), time.time_ns()
    owned = model is None
    if owned:
        resolve_device(device)  # raises without CUDA before any process starts
    TRACER.service = "loadgen"  # this process IS the client
    api_port, ops_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{api_port}"
    ops = f"http://127.0.0.1:{ops_port}"
    procs: List[subprocess.Popen] = []
    closers: list = []
    try:
        # -- three processes: this one, a real apiserver, a real scheduler --
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.apiserver"],
            env=_role_env(API_PORT=str(api_port))))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.scheduler.core"],
            env=_role_env(APISERVER_URL=base, METRICS_PORT=str(ops_port))))
        if owned:
            # built while the two processes start
            model = gpt_served_model(name="gpt", tiny=tiny, max_new_tokens=MAX_NEW_TOKENS,
                                     replicas=REPLICAS, device=device, params=params)
            closers.append(model.close)
        RemoteStore(base).wait_ready(timeout=60.0)

        def ops_up():
            try:
                return get(f"{ops}/healthz")
            except (urllib.error.URLError, OSError):
                return None

        poll(ops_up, timeout=60.0, interval=0.05, desc="scheduler ops endpoints")
        setup_s = time.monotonic() - t_run

        # -- the traced journey: one minted trace id at the user edge -------
        trace_id = f"{SEED:032x}"
        tp = f"00-{trace_id}-{'00ab' * 4}-01"
        topo = synthesize(NODES, seed=SEED)
        gen = LoadGenerator(base, topo, seed=SEED, traceparent=tp)
        registered = gen.register_nodes()
        assert registered == topo.total_nodes, (registered, topo.total_nodes)
        shape = synth_gangs(topo, 1, seed=SEED, prefix="fed", max_size=4)[0]
        gen.submit_gang(shape)
        gen.wait_gangs_bound([shape.name], timeout_s=90.0)

        # (1) the trace id verbatim in both pod annotations, on every member
        members = [p for p in gen._list_pods()
                   if p["metadata"]["name"].startswith(f"{shape.name}-")]
        assert len(members) == shape.size, [p["metadata"]["name"] for p in members]
        for pod in members:
            ann = pod["metadata"].get("annotations") or {}
            assert trace_id in ann.get(TRACEPARENT_ANNOTATION, ""), \
                f"creation annotation lost the trace: {ann}"
            assert trace_id in ann.get(BIND_TRACEPARENT_ANNOTATION, ""), \
                f"bind annotation lost the trace: {ann}"

        # (2) a predict under the SAME traceparent: the serving span joins
        # the gang's trace
        server = ModelServer()
        server.add(model)
        httpd = server.serve(0)
        # ModelServer.close closes its models: a caller's model stays open
        closers[:0] = [httpd.close, server.close] if owned else [httpd.close]
        predict = f"http://127.0.0.1:{httpd.port}/v1/models/{model.name}:predict"
        status, _h, out = post(predict, {"instances": [list(range(1, 9))]},
                               headers={"traceparent": tp})
        assert status == 200 and out and out.get("predictions"), (status, out)

        # (3) federation: pull the apiserver's and the scheduler's buffers
        # over HTTP, ingest this process's spans of this run, assemble by
        # trace id
        collector = TraceCollector(targets=[
            Target(job="apiserver", url=traces_url(f"{base}/metrics")),
            Target(job="scheduler", url=f"{ops}/debug/traces?limit=4096"),
        ])
        need = {"gang.submit", "apiserver.create", "gang.lifecycle",
                "schedule.bind", "serving.request"}

        def assembled():
            ok = collector.collect_once()
            assert all(ok.values()), f"trace pulls must succeed: {ok}"
            collector.ingest(_spans_since(run_ns), job="loadgen")
            t = collector.trace(trace_id)
            if not t or not need <= {s["name"] for s in t["spans"]}:
                return None
            # gang.lifecycle counts once the root closed with the
            # bind-latency observation attached
            roots = [s for s in t["spans"] if s["name"] == "gang.lifecycle"]
            if not any(isinstance(s.get("attributes", {}).get("gang.bind_latency_s"),
                                  (int, float)) for s in roots):
                return None
            return t

        trace = poll(assembled, timeout=30.0, interval=0.25,
                     desc=f"federated gang-bind trace {trace_id}")
        assert len(trace["services"]) >= 3, \
            f"a gang bind crosses >=3 processes: {trace['services']}"
        retire = [s for s in trace["spans"] if s["name"] == "serving.request"]
        assert retire and retire[0]["traceId"] == trace_id
        assert any("replica" in (s.get("attributes") or {}) for s in retire), \
            "fleet serving spans must carry their replica identity"

        # (4) the critical path reconstructs the bind-latency SLI
        path = critical_path(trace)
        assert path is not None, "gang trace must decompose"
        assert [s["name"] for s in path["segments"]] == ["queue", "cycle", "bind"], path
        measured = path["measuredBindLatencySeconds"]
        assert measured > 0, path
        # 10% relative, with an absolute floor for thread-wakeup jitter
        # between spans on a loaded host
        tolerance = max(0.1 * measured, 0.05)
        assert path["reconstructionError"] <= tolerance, \
            f"segments {path['totalSeconds']}s vs measured {measured}s " \
            f"(error {path['reconstructionError']}s > {tolerance}s)"
        sched_metrics = get(f"{ops}/metrics").decode()
        assert metric_value(sched_metrics, "scheduler_bind_latency_seconds_count") >= 1
        assert trace_id in sched_metrics, \
            "bind-latency histogram must expose the trace-id exemplar"
        binds = collector.slowest_binds(n=5)
        assert any(r["traceId"] == trace_id and r["bound"] for r in binds), binds

        # (5) tail sampling under a burst: twice-the-budget boring traces
        # beside known error traces, into a small-budget collector
        errors = 0
        for _ in range(ERROR_PREDICTS):
            # a zero budget expires on arrival: a deterministic 504, and the
            # serving dispatch span goes ERROR
            status, _h, _b = post(predict, {"instances": [list(range(1, 9))],
                                            "timeout_ms": 0})
            assert status >= 500, status
            errors += 1
        assert errors == ERROR_PREDICTS, "expired predicts must 5xx"

        # the budget is sized from what must survive: every error trace any
        # of the three processes saw, plus the gang trace; the burst then
        # doubles it with one-span traces
        api_target = Target(job="apiserver", url=traces_url(f"{base}/metrics"))
        sched_target = Target(job="scheduler", url=f"{ops}/debug/traces?limit=4096")
        docs = [(collector.fetch(api_target), "apiserver"),
                (collector.fetch(sched_target), "scheduler"),
                (_spans_since(run_ns), "loadgen")]
        by_trace: dict = {}
        for doc, _job in docs:
            for rs in doc["resourceSpans"]:
                for sc in rs["scopeSpans"]:
                    for s in sc["spans"]:
                        by_trace.setdefault(s["traceId"], {})[s["spanId"]] = s
        error_ids = {tid for tid, spans in by_trace.items()
                     if any((s.get("status") or {}).get("code") == "ERROR"
                            for s in spans.values())}
        assert error_ids, "expired predicts must produce error traces"
        protected = error_ids | {trace_id}
        budget = sum(len(by_trace.get(t, {})) for t in protected) + 16
        tail = TraceCollector(max_spans=budget)
        burst = 2 * budget
        for _ in range(burst):  # boring one-span traces
            get(f"{base}/healthz")
        for doc, job in docs:
            tail.ingest(doc, job=job)
        tail.add_target(api_target)
        tail.add_target(sched_target)
        tail.collect_once()  # pulls the burst, then enforces the bound
        kept = set(tail.trace_ids())
        assert error_ids <= kept, f"tail sampling dropped error traces: {error_ids - kept}"
        assert trace_id in kept, "slowest gang bind must survive sampling"
        kept_spans = sum(tail.trace(t)["spanCount"] for t in kept)
        assert kept_spans <= budget, (kept_spans, budget)
        assert len(kept) < len(by_trace) + burst, "sampling must drop traces"

        return {
            "ok": True,
            "traceId": trace_id,
            "services": trace["services"],
            "spanCount": trace["spanCount"],
            "criticalPath": path,
            "tail": {"kept_traces": len(kept), "kept_spans": kept_spans,
                     "error_traces": len(error_ids)},
            "setup_s": setup_s,
            "seconds": time.monotonic() - t_run,
        }
    finally:
        for close in closers:
            close()
        _stop(procs)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="GPT-tiny instead of GPT-small")
    args = ap.parse_args(argv)
    try:
        report = run(device=args.device, tiny=args.tiny)
    except AssertionError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
