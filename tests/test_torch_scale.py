"""The port's control-plane load: synthetic GPU topologies, the ledger,
verdict truncation and the load generator.

- ``synthesize`` and ``synth_gangs`` are deterministic in ``(n, seed)``;
  ``synthesize`` splits nodes across pools as JAX's does (the pools are A3
  High shapes of 4, 8, 2 and 1 H100s a node), and the trace-federation
  driver's gang has JAX's size and cards.
- On seeded random clusters and at synthesized scale the port's ledger
  (a full scan) places as JAX's does, by its free-chip index and by its
  scan alike (``tests/test_scale.py``'s parity suite).
- ``LoadGenerator`` binds a wave of synthesized gangs through the port's
  apiserver and scheduler: in-process over HTTP, and as the two processes
  ``python -m kubeflow_tpu_torch.apiserver`` and ``python -m
  kubeflow_tpu_torch.scheduler.core``, which import no torch and refuse
  the switches whose parts are not ported.
"""

import os
import random
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import kubeflow_tpu.scale.topology as j_topo
import kubeflow_tpu.scheduler.ledger as j_ledger
import kubeflow_tpu.controllers.builtin as j_builtin
from kubeflow_tpu_torch.api.meta import new_object
from kubeflow_tpu_torch.apiserver.__main__ import refuse_unported
from kubeflow_tpu_torch.apiserver.remote import RemoteStore
from kubeflow_tpu_torch.apiserver.server import make_apiserver_app
from kubeflow_tpu_torch.apiserver.store import Store
from kubeflow_tpu_torch.controllers.builtin import make_gpu_node
from kubeflow_tpu_torch.gpu.topology import RESOURCE_GPU
from kubeflow_tpu_torch.runtime.bootstrap import run_role
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.scale.loadgen import LoadGenerator
from kubeflow_tpu_torch.scale.topology import POOL_LABEL, synth_gangs, synthesize
from kubeflow_tpu_torch.scheduler.core import SchedulerReconciler
from kubeflow_tpu_torch.scheduler.flight import dominant_node_reason, truncate_node_verdicts
from kubeflow_tpu_torch.scheduler.gang import POD_GROUP_LABEL
from kubeflow_tpu_torch.scheduler.ledger import ChipLedger

ROOT = Path(__file__).resolve().parents[1]


class TestSyntheticTopology:
    @pytest.mark.parametrize("n,seed", [(8, 14), (40, 0), (700, 3), (997, 1)])
    def test_deterministic_and_split_as_jax(self, n, seed):
        a, b = synthesize(n, seed=seed), synthesize(n, seed=seed)
        assert a.pools == b.pools and a.node_names() == b.node_names()
        assert [list(x["metadata"]["labels"].items()) for x in a.nodes()] == \
            [list(x["metadata"]["labels"].items()) for x in b.nodes()]
        assert a.total_nodes == n and all(p.nodes >= 1 for p in a.pools)
        jax = j_topo.synthesize(n, seed=seed)
        assert [p.nodes for p in a.pools] == [p.nodes for p in jax.pools]
        assert synthesize(n, seed=seed + 1).pools != a.pools or n < 50

    def test_nodes_are_a3_high_gpu_nodes_with_the_pool_selector(self):
        topo = synthesize(200, seed=0)
        by_pool = {p.name: p for p in topo.pools}
        assert [p.machine_type for p in topo.pools] == \
            ["a3-highgpu-4g", "a3-highgpu-8g", "a3-highgpu-2g", "a3-highgpu-1g"]
        for node in topo.nodes():
            labels = node["metadata"]["labels"]
            pool = by_pool[labels[POOL_LABEL]]
            assert labels["node.kubernetes.io/instance-type"] == pool.machine_type
            assert labels["nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3"
            assert int(node["status"]["capacity"][RESOURCE_GPU]) == pool.chips_per_node
            assert all(labels.get(k) == v for k, v in pool.selector().items())

    def test_synth_gangs_deterministic_feasible_and_sized_as_jax(self):
        topo = synthesize(300, seed=5)
        gangs = synth_gangs(topo, 20, seed=7)
        assert gangs == synth_gangs(topo, 20, seed=7)
        # the trace-federation driver's gang is JAX's: 4 members of 2 cards
        (fed,) = synth_gangs(synthesize(8, seed=14), 1, seed=14, prefix="fed", max_size=4)
        (jax,) = j_topo.synth_gangs(j_topo.synthesize(8, seed=14), 1, seed=14, prefix="fed",
                                    max_size=4)
        assert (fed.name, fed.size, fed.chips_per_pod) == (jax.name, jax.size, jax.chips_per_pod)
        by_pool = {p.name: p for p in topo.pools}
        for g in gangs:
            pool = by_pool[g.selector[POOL_LABEL]]
            assert 2 <= g.size <= max(2, min(8, pool.nodes))
            assert 1 <= g.chips_per_pod <= pool.chips_per_node


# -- the ledger: the port against JAX, the index against the scan --------------


def _bound_pod(name, node, chips, resource, label):
    pod = new_object("v1", "Pod", name, "default", labels={label: f"g{name[-1]}"})
    pod["spec"] = {"nodeName": node, "containers": [
        {"name": "c", "resources": {"limits": {resource: str(chips)}}}]}
    pod["status"] = {"phase": "Running"}
    return pod


def _trial(rng):
    """One seeded random cluster fed to both ledgers; every query answered
    by the port's scan, JAX's index and JAX's scan."""
    from kubeflow_tpu.tpu.topology import RESOURCE_TPU

    mine, theirs = ChipLedger(), j_ledger.ChipLedger()
    pools = [{"pool": f"p{i}", "tier": rng.choice(["a", "b"])}
             for i in range(rng.randint(1, 4))]
    nodes = []
    for i in range(rng.randint(3, 20)):
        name, chips, labels = f"n{i}", rng.choice((1, 2, 4, 8)), rng.choice(pools)
        g = make_gpu_node(name, "h100", chips)
        g["metadata"]["labels"].update(labels)
        t = j_builtin.make_tpu_node(name, "v5e", "2x4", chips)
        t["metadata"]["labels"].update(labels)
        mine.on_node_event("ADDED", g)
        theirs.on_node_event("ADDED", t)
        nodes.append((name, chips))
    for i in range(rng.randint(0, 10)):
        name, chips = rng.choice(nodes)
        used = rng.randint(1, chips)
        mine.on_pod_event("ADDED", _bound_pod(f"pod-{i}", name, used, RESOURCE_GPU,
                                              POD_GROUP_LABEL))
        theirs.on_pod_event("ADDED", _bound_pod(f"pod-{i}", name, used, RESOURCE_TPU,
                                                POD_GROUP_LABEL))
    for g in range(rng.randint(0, 3)):
        held = {rng.choice(nodes)[0]: rng.randint(1, 4)}
        for led in (mine, theirs):
            led.reserve((None, f"hold{g}"), held, ttl=100.0, now=1.0)
    for q in range(8):
        reqs = []
        for _ in range(rng.randint(1, 5)):
            roll = rng.random()
            sel = (dict(rng.choice(pools)) if roll < 0.35 else
                   {"kubernetes.io/hostname": rng.choice(nodes)[0]} if roll < 0.5 else
                   {"pool": "no-such-pool"} if roll < 0.6 else {})
            reqs.append((rng.choice((0, 1, 2, 4, 8)), sel))
        kw = dict(ttl=None, now=1.0)
        got = mine.place_and_reserve((None, f"q{q}"), reqs, **kw)
        assert got == theirs.place_and_reserve((None, f"q{q}"), reqs, use_index=True, **kw)
        assert got == theirs.place_and_reserve((None, f"q{q}"), reqs, use_index=False, **kw)
        assert mine.explain((None, f"q{q}"), reqs, now=1.0) == \
            theirs.explain((None, f"q{q}"), reqs, now=1.0)


def test_ledger_places_as_jax():
    for trial in range(60):
        _trial(random.Random(f"parity:{trial}"))


def test_ledger_places_as_jax_at_synthesized_scale():
    """400 synthesized nodes, given to JAX's ledger as TPU nodes of the
    same names, labels and counts: the same placement for every gang."""
    topo = synthesize(400, seed=11)
    mine, theirs = ChipLedger(), j_ledger.ChipLedger()
    for node in topo.nodes():
        mine.on_node_event("ADDED", node)
        cards = int(node["status"]["capacity"][RESOURCE_GPU])
        t = j_builtin.make_tpu_node(node["metadata"]["name"], "v5e", "2x4", cards)
        t["metadata"]["labels"] = dict(node["metadata"]["labels"])
        theirs.on_node_event("ADDED", t)
    for shape in synth_gangs(topo, 16, seed=11):
        reqs = [(shape.chips_per_pod, dict(shape.selector))] * shape.size
        got = mine.place_and_reserve((None, shape.name), reqs, ttl=60.0, now=1.0)
        assert got is not None
        assert got == theirs.place_and_reserve((None, shape.name), reqs, ttl=60.0, now=1.0)


def test_verdict_truncation_keeps_the_dominant_reason():
    verdicts = [{"node": f"n{i}", "reason": "insufficient_chips"} for i in range(12)] + \
        [{"node": "m", "reason": "selector_mismatch"}]
    kept = truncate_node_verdicts(verdicts, top_k=3)
    assert [v["node"] for v in kept[:3]] == ["n0", "n1", "n2"]
    assert [v["truncated"] for v in kept[3:]] == [9, 1]
    assert dominant_node_reason(verdicts) == "insufficient_chips"
    assert truncate_node_verdicts(verdicts, top_k=-1) == verdicts


# -- the load generator against the apiserver and scheduler -------------------


def test_loadgen_binds_a_wave_in_process():
    store = Store()
    server = make_apiserver_app(store).serve(0)
    base = f"http://127.0.0.1:{server.port}"
    mgr = Manager(store=RemoteStore(base))
    mgr.add(SchedulerReconciler(backoff_base=0.02, backoff_cap=0.5))
    mgr.start()
    try:
        topo = synthesize(24, seed=2)
        gen = LoadGenerator(base, topo, seed=2)
        assert gen.register_nodes() == 24
        shapes = synth_gangs(topo, 4, seed=2, max_size=3)
        gen.gang_wave(shapes)
        gen.wait_gangs_bound([s.name for s in shapes], timeout_s=30.0)
        assert gen.bound_gangs() == {s.name: s.size for s in shapes}
        for pod in gen._list_pods():  # every member landed in its gang's pool
            node = store.get(store_res("Node"), pod["spec"]["nodeName"])
            gang = gen.submitted_gangs[pod["metadata"]["labels"][POD_GROUP_LABEL]]
            assert node["metadata"]["labels"][POOL_LABEL] == gang.selector[POOL_LABEL]
    finally:
        mgr.stop()
        server.close()


def test_loadgen_churn_kills_and_watch_storm():
    """The rest of the generator's steps against the apiserver alone: node
    kills and a watch storm draw from the seeded stream, and churn deletes
    a seeded fraction of bound pods (bound here by hand: no scheduler)."""
    store = Store()
    server = make_apiserver_app(store).serve(0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        topo = synthesize(10, seed=4)
        gens = [LoadGenerator(base, topo, seed=4) for _ in range(2)]
        gen = gens[0]
        gen.register_nodes()
        killed = gen.kill_nodes(3)
        assert killed == gens[1].kill_nodes(3)  # the same seeded draw (deletes 404 now)
        assert len(store.list(store_res("Node"))) == 10 - 3
        (shape,) = synth_gangs(topo, 1, seed=4, max_size=4)
        names = gen.submit_gang(shape)
        for name in names:
            pod = store.get(store_res("Pod"), name, "default")
            pod["spec"]["nodeName"] = topo.node_names()[0]
            store.update(pod)
        assert gen.churn_pods(0.5) == len(names) // 2
        assert len(gen._list_pods()) == len(names) - len(names) // 2
        # a write every 50 ms wakes the storm's readers once it stops them
        # (an idle stream's reader waits for the server's 15 s heartbeat)
        done = threading.Event()

        def writes():
            i = 0
            while not done.wait(0.05):
                store.create(new_object("v1", "ConfigMap", f"tick{i}", "default"))
                store.create(new_object("v1", "Pod", f"tick{i}", "default"))
                i += 1

        writer = threading.Thread(target=writes, daemon=True)
        writer.start()
        try:
            storm = gen.watch_storm(streams=2, relists=4, duration_s=0.2)
        finally:
            done.set()
            writer.join(timeout=5)
        assert storm["lists"] >= 4 and storm["streams"] == 2 and storm["watch_events"] >= 2
    finally:
        server.close()


def store_res(kind):
    from kubeflow_tpu_torch.api.meta import REGISTRY

    return REGISTRY.for_kind("v1", kind)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_apiserver_and_scheduler_processes_bind_a_wave():
    """The two roles as their own processes, without torch, over real HTTP."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), LOG_LEVEL="WARNING")
    api_port, ops_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{api_port}"
    probe = ("import runpy, sys; sys.argv = ['x']; "
             "import atexit; atexit.register(lambda: print('torch' in sys.modules, "
             "file=sys.stderr)); runpy.run_module('{}', run_name='__main__')")
    procs = [
        subprocess.Popen([sys.executable, "-c", probe.format("kubeflow_tpu_torch.apiserver")],
                         env=dict(env, API_PORT=str(api_port)), stderr=subprocess.PIPE,
                         text=True),
        subprocess.Popen([sys.executable, "-c",
                          probe.format("kubeflow_tpu_torch.scheduler.core")],
                         env=dict(env, APISERVER_URL=base, METRICS_PORT=str(ops_port)),
                         stderr=subprocess.PIPE, text=True),
    ]
    try:
        RemoteStore(base).wait_ready(timeout=30)
        topo = synthesize(8, seed=14)
        gen = LoadGenerator(base, topo, seed=14)
        gen.register_nodes()
        shapes = synth_gangs(topo, 2, seed=14, prefix="wave", max_size=4)
        gen.gang_wave(shapes)
        gen.wait_gangs_bound([s.name for s in shapes], timeout_s=60.0)
        assert sum(gen.bound_gangs().values()) == sum(s.size for s in shapes)
    finally:
        for p in procs:
            p.terminate()
        errs = [p.communicate(timeout=20)[1] for p in procs]
    # each role printed at exit whether torch was imported: it was not
    assert all(e.strip().splitlines()[-1] == "False" for e in errs), errs
    assert all("Traceback" not in e for e in errs), errs


@pytest.mark.parametrize("env", [
    {"APISERVER_WAL_DIR": "/tmp/wal"}, {"APISERVER_AUTH": "token"},
    {"APISERVER_FAIRNESS": "1"}, {"APISERVER_TLS_CERT_FILE": "c.pem"},
    {"WEBHOOK_URL": "http://webhook"}, {"KUBEFLOW_TPU_NATIVE": "1"},
])
def test_apiserver_refuses_unported_switches(env):
    with pytest.raises(SystemExit) as err:
        refuse_unported(env)
    assert next(iter(env)) in str(err.value)
    refuse_unported({"APISERVER_FAIRNESS": "0", "APISERVER_AUTH": "", "KUBEFLOW_TPU_NATIVE": "0"})


def test_leader_election_is_refused(monkeypatch):
    monkeypatch.setenv("ENABLE_LEADER_ELECTION", "true")
    with pytest.raises(SystemExit, match="leader"):
        run_role("scheduler", SchedulerReconciler(), url="http://127.0.0.1:9")
