"""The port's trace federation: the in-process propagation cases of
``tests/test_trace_federation.py``, and the port's
``e2e/trace_federation_driver`` on the CPU.

- The driver at GPT-tiny passes JAX's five checks over three processes and
  returns JAX's report keys plus ``seconds`` and ``setup_s``, also with
  slower gang binds of an earlier in-process scheduler in this process's
  tracer.
- With weights converted from JAX's GPT-tiny (``models/convert.py``, f32 on
  both sides), the driver's predict answers JAX's predictions for the same
  prompt, token for token.
- JAX's propagation cases pass on the port: the client → apiserver →
  object hop over real HTTP, the workqueue's last-enqueuer trace, the
  reconcile span parented to the creation annotation, the open-span
  hygiene, and the gang lifecycle trace through bind and pod start with
  its critical path (the detached relist is in ``test_torch_informer.py``).
- The apiserver and the scheduler import no torch.
"""

import ast
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.meta import annotations_of, new_object
from kubeflow_tpu_torch.apiserver.client import Client
from kubeflow_tpu_torch.apiserver.remote import RemoteStore
from kubeflow_tpu_torch.apiserver.server import make_apiserver_app
from kubeflow_tpu_torch.apiserver.store import Store
from kubeflow_tpu_torch.controllers.builtin import PodletReconciler, make_gpu_node
from kubeflow_tpu_torch.gpu.topology import RESOURCE_GPU
from kubeflow_tpu_torch.monitoring.traces import TraceCollector, critical_path
from kubeflow_tpu_torch.runtime.manager import Manager, Reconciler, Request, Result, _WorkQueue
from kubeflow_tpu_torch.runtime.metrics import METRICS
from kubeflow_tpu_torch.runtime.obs import otlp_traces
from kubeflow_tpu_torch.runtime.tracing import (BIND_TRACEPARENT_ANNOTATION,
                                                TRACEPARENT_ANNOTATION, TRACER, Tracer,
                                                parse_traceparent)
from kubeflow_tpu_torch.scheduler.core import SchedulerReconciler
from kubeflow_tpu_torch.scheduler.gang import POD_GROUP_LABEL, POD_GROUP_SIZE_ANNOTATION

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_tracer():
    TRACER.reset()
    yield
    TRACER.reset()


def wait_for(predicate, timeout=10.0, interval=0.02, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    assert predicate(), f"timed out waiting for {desc}"


def mkpod(name, ns="default", chips=0, gang=None, size=1, annotations=None):
    spec = {"containers": [{"name": "c"}]}
    if chips:
        spec["containers"][0]["resources"] = {"limits": {RESOURCE_GPU: str(chips)}}
    labels = {POD_GROUP_LABEL: gang} if gang else {}
    ann = dict(annotations or {})
    if gang:
        ann[POD_GROUP_SIZE_ANNOTATION] = str(size)
    return new_object("v1", "Pod", name, ns, labels=labels, annotations=ann, spec=spec)


# -- the driver ---------------------------------------------------------------


def _jax_report_keys():
    """The keys of the JAX driver's report, read from its source."""
    tree = ast.parse((ROOT / "e2e" / "trace_federation_driver.py").read_text())
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    ret = next(n for n in ast.walk(run) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def _f32_tiny():
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models.gpt import GptConfig as JCfg, GptLM as JLM
    from kubeflow_tpu_torch.models.convert import params_from_flax
    from kubeflow_tpu_torch.models.gpt import GptConfig

    jcfg = JCfg(**{**vars(JCfg.tiny()), "dtype": jnp.float32})
    tcfg = GptConfig(**{**vars(GptConfig.tiny()), "dtype": torch.float32})
    params = JLM(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, tcfg, params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)


def test_driver_passes_and_answers_jax_predictions():
    from kubeflow_tpu.serving.server import GenerativeModel as JModel
    from kubeflow_tpu_torch.e2e import trace_federation_driver as driver
    from kubeflow_tpu_torch.serving.server import GenerativeModel

    jcfg, jparams, tcfg, tparams = _f32_tiny()
    model = GenerativeModel(name="gpt", apply_fn=None, params=tparams, cfg=tcfg,
                            max_new_tokens=driver.MAX_NEW_TOKENS, replicas=driver.REPLICAS,
                            device="cpu")
    answers = []
    predict = model.predict

    def recording(instances, *a, **kw):
        out = predict(instances, *a, **kw)
        answers.append((instances, out))
        return out

    model.predict = recording
    # slower binds an earlier in-process scheduler left in this process's
    # tracer (chip_smoke.py runs 23a's and 24a's before 25a): the driver's
    # own gang must still lead the federated slowest binds and survive the
    # tail sampling
    for i in range(24):
        root = TRACER.start_span("gang.lifecycle", gang=f"default/earlier-{i}", size=1)
        root.set("gang.bind_latency_s", 5.0 + i)
        root.set("gang.bound", True)
        for step in ("schedule", "schedule.bind"):
            TRACER.end_span(TRACER.start_span(step, parent=root))
        TRACER.end_span(root)
    try:
        report = driver.run(device="cpu", model=model)
        (instances, got), = answers  # the traced predict (the expired ones never answer)
        assert predict(instances) == got  # the caller's model is left open
    finally:
        model.close()
    assert report["ok"] is True
    assert set(report) == _jax_report_keys() | {"seconds", "setup_s"}
    assert len(report["services"]) >= 3 and report["spanCount"] > 0
    path = report["criticalPath"]
    assert [s["name"] for s in path["segments"]] == ["queue", "cycle", "bind"]
    assert path["reconstructionError"] <= max(0.1 * path["measuredBindLatencySeconds"], 0.05)
    assert report["tail"]["error_traces"] >= driver.ERROR_PREDICTS
    assert 0 < report["setup_s"] < report["seconds"]
    jmodel = JModel(name="gpt", apply_fn=None, params=jparams, cfg=jcfg,
                    max_new_tokens=driver.MAX_NEW_TOKENS)
    try:
        assert got == jmodel.predict(instances)
    finally:
        jmodel.close()


def test_driver_main_and_device_check(capsys):
    from kubeflow_tpu_torch.e2e import trace_federation_driver as driver

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            driver.run(device="cuda")
    assert driver.main(["--device", "cpu", "--tiny"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"ok": true' in out and '"criticalPath"' in out


def test_control_plane_imports_no_torch():
    code = ("import sys; import kubeflow_tpu_torch.apiserver.server, "
            "kubeflow_tpu_torch.apiserver.__main__, kubeflow_tpu_torch.scheduler.core, "
            "kubeflow_tpu_torch.controllers.builtin, kubeflow_tpu_torch.scale; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'kubeflow_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


# -- propagation: the client → apiserver → object hop -------------------------


class TestPropagation:
    def test_remote_store_preserves_trace_id_over_real_http(self):
        store = Store()
        server = make_apiserver_app(store).serve(0)
        remote = RemoteStore(f"http://127.0.0.1:{server.port}")
        try:
            with TRACER.span("client-call") as client_span:
                remote.create(new_object("v1", "Pod", "traced", "default"))
            stored = Client(store).get("v1", "Pod", "traced", "default")
            header = annotations_of(stored).get(TRACEPARENT_ANNOTATION)
            assert header, "apiserver create must stamp the creation traceparent"
            trace_id, _ = parse_traceparent(header)
            assert trace_id == client_span.trace_id
            assert [s for s in TRACER.finished_spans(trace_id=trace_id)
                    if s.name == "apiserver.create"]
        finally:
            server.close()

    def test_create_without_active_span_stays_unannotated(self):
        client = Client(Store())
        client.create(new_object("v1", "Pod", "plain", "default"))
        assert TRACEPARENT_ANNOTATION not in annotations_of(
            client.get("v1", "Pod", "plain", "default"))

    def test_workqueue_carries_last_enqueuer_trace(self):
        q = _WorkQueue("test")
        req = Request("default", "x")
        tp1 = "00-" + "a" * 32 + "-" + "1" * 16 + "-01"
        tp2 = "00-" + "b" * 32 + "-" + "2" * 16 + "-01"
        q.add(req, traceparent=tp1)
        q.add(req, traceparent=tp2)  # dedup keeps one item; the last trace wins
        assert q.get(timeout=1.0) == req
        assert q.trace_of(req) == tp2
        assert q.trace_of(req) is None  # consumed exactly once
        q.task_done()

    def test_reconcile_span_parents_to_creation_annotation(self):
        seen = []

        class Spy(Reconciler):
            FOR = ("v1", "Pod")

            def reconcile(self, client, req):
                seen.append(req.name)
                return Result()

        tp = "00-" + "c" * 32 + "-" + "3" * 16 + "-01"
        mgr = Manager()
        mgr.add(Spy())
        mgr.start()
        try:
            mgr.client.create(mkpod("evt", annotations={TRACEPARENT_ANNOTATION: tp}))
            wait_for(lambda: "evt" in seen, desc="reconcile")
            wait_for(lambda: any(s.trace_id == "c" * 32
                                 for s in TRACER.finished_spans(name="reconcile")),
                     desc="reconcile span joins creation trace")
        finally:
            mgr.stop()


class TestOpenSpanHygiene:
    def test_ttl_sweep_abandons_and_counts(self):
        t = Tracer("t")
        before = METRICS.value("tracing_spans_abandoned_total")
        s = t.start_span("orphan")
        s.start_ns -= int(3600 * 1e9)  # pretend it started an hour ago
        assert t.sweep_abandoned(ttl_s=600.0) == 1
        assert t.open_spans() == []
        (rec,) = t.finished_spans(name="orphan")
        assert rec.status == "ERROR" and "abandoned" in rec.status_message
        assert METRICS.value("tracing_spans_abandoned_total") == before + 1

    def test_ended_spans_leave_the_open_map(self):
        t = Tracer("t")
        s = t.start_span("brief")
        assert [x.span_id for x in t.open_spans()] == [s.span_id]
        t.end_span(s)
        assert t.open_spans() == [] and t.sweep_abandoned(ttl_s=0.0) == 0

    def test_hard_cap_evicts_oldest_open_span(self):
        t = Tracer("t", capacity=4)
        spans = [t.start_span(f"s{i}") for i in range(6)]
        assert len(t.open_spans()) <= 4
        evicted = [s for s in t.finished_spans() if s.status == "ERROR"]
        assert evicted and all("evicted" in s.status_message for s in evicted)
        assert spans[0].span_id in {s.span_id for s in evicted}


# -- the gang lifecycle trace end to end (in-process) ---------------------------


@pytest.fixture()
def cluster():
    mgr = Manager()
    mgr.add(SchedulerReconciler(backoff_base=0.02, backoff_cap=0.5))
    mgr.add(PodletReconciler())
    mgr.client.create(make_gpu_node("gpu-node-0", "h100", 4))
    mgr.client.create(make_gpu_node("gpu-node-1", "h100", 4))
    mgr.start()
    try:
        yield mgr
    finally:
        mgr.stop()


def _phase(client, name):
    return (client.get("v1", "Pod", name, "default").get("status") or {}).get("phase")


class TestGangLifecycleTrace:
    def test_injected_traceparent_survives_to_bind_and_pod_start(self, cluster):
        trace_id = "f" * 32
        tp = f"00-{trace_id}-{'9' * 16}-01"
        for i in range(2):
            cluster.client.create(mkpod(f"fed-{i}", chips=4, gang="fed", size=2,
                                        annotations={TRACEPARENT_ANNOTATION: tp}))
        wait_for(lambda: all(_phase(cluster.client, f"fed-{i}") == "Running" for i in range(2)),
                 desc="gang Running")
        wait_for(lambda: TRACER.finished_spans(name="gang.lifecycle", trace_id=trace_id),
                 desc="lifecycle root recorded")
        (root,) = TRACER.finished_spans(name="gang.lifecycle", trace_id=trace_id)
        assert root.attributes["gang.bound"] is True
        assert root.attributes["gang"] == "default/fed"
        assert root.attributes["gang.bind_latency_s"] >= 0.0
        assert "gang.submitted_unix" in root.attributes
        for i in range(2):
            pod = cluster.client.get("v1", "Pod", f"fed-{i}", "default")
            bind_tp = annotations_of(pod).get(BIND_TRACEPARENT_ANNOTATION)
            assert bind_tp and parse_traceparent(bind_tp)[0] == trace_id
        names = {s.name for s in TRACER.finished_spans(trace_id=trace_id)}
        assert {"schedule", "schedule.bind", "pod.start"} <= names
        rendered = METRICS.render()
        assert "scheduler_bind_latency_seconds_bucket" in rendered
        assert f'trace_id="{trace_id}"' in rendered
        collector = TraceCollector()
        collector.ingest(otlp_traces(TRACER, limit=4096))
        assembled = collector.trace(trace_id)
        path = critical_path(assembled)
        measured = path["measuredBindLatencySeconds"]
        assert measured == root.attributes["gang.bind_latency_s"]
        assert {s["name"] for s in path["segments"]} == {"queue", "cycle", "bind"}
        assert path["reconstructionError"] <= max(0.1 * measured, 0.05)
        assert path["postBindPodStart"]["pods"] == 2
        assert collector.slowest_binds(1)[0]["traceId"] == trace_id

    def test_queue_duration_exemplar_present(self, cluster):
        tp = f"00-{'d' * 32}-{'4' * 16}-01"
        cluster.client.create(mkpod("exq", annotations={TRACEPARENT_ANNOTATION: tp}))
        wait_for(lambda: 'trace_id="' + "d" * 32 + '"' in METRICS.render(),
                 desc="queue-duration exemplar")
        assert "workqueue_queue_duration_seconds_bucket" in METRICS.render()
