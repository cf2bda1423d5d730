"""Distributed-bootstrap e2e: the injected torchrun env really forms a world.

The port of ``e2e/distributed_driver.py``, without its control plane (as
the port's other drivers): the workers' env is what the admission webhook
injects (``gpu/env.py`` ``torchrun_worker_env`` for a 4-card node:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``NNODES``,
``NPROC_PER_NODE``), with localhost TCP and a free port standing in for
the headless-service DNS. One OS process is booted per worker with that
env, its ``LOCAL_RANK`` (as torchrun sets it) and a pod-style hostname,
and runs the library bootstrap (``parallel.distributed.initialize``: the
rank from the hostname ordinal and ``LOCAL_RANK``, then
``init_process_group``), then:

1. an all-gather of ``rank + 1`` across the workers;
2. a data-parallel train step over the world (``MeshConfig()``: ``data``
   4): each worker's own batch, the gradient summed over ``data``, five
   SGD steps; the loss must fall and the parameters be elementwise equal
   on every worker;
3. dp x tp over the same processes, ``data 2 x model 2``: a Megatron-split
   2-layer MLP (W1 by columns, W2 by rows, ``parallel.collectives``'
   *f*/*g*), the gradient summed over ``data``; the loss must fall and
   each worker's gathered W1 and W2 be equal on every worker. JAX's driver
   runs this as 2 processes of 4 local devices; the port has one device a
   process, so it is 4 processes.

Everything runs on the CPU (gloo), on the card's machine too. ``run()``
returns the report (JAX's keys);
``python -m kubeflow_tpu_torch.e2e.distributed_driver`` prints it as one
JSON line and exits 0, or prints ``{"ok": false, "error": ...}`` and exits 1.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..gpu.env import (ENV_LOCAL_RANK, ENV_MASTER_ADDR, ENV_MASTER_PORT, env_list_to_dict,
                       torchrun_worker_env)
from ..gpu.topology import parse_topology

WORKLOAD, NAMESPACE, CARDS = "dist-nb", "kubeflow-user", 4
POD_NAME = f"{WORKLOAD}-0"  # one node of 4 cards: pod 0


def _summed(t: torch.Tensor, group=None) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _synced(t: torch.Tensor) -> bool:
    """Every worker holds exactly this tensor (an all-gather, compared
    elementwise: a checksum would let offsetting differences through)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return all(torch.equal(o, out[0]) for o in out)


def _dp_phase(rank: int, world: int) -> List[float]:
    from ..parallel.mesh import AXIS_DATA, MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(), device="cpu")
    x = torch.tensor(np.random.RandomState(rank).randn(2, 16), dtype=torch.float32)
    w = torch.zeros(16, 16)
    count = 2 * 16 * world
    losses = []
    for _ in range(5):
        w = w.detach().requires_grad_(True)
        local = ((torch.tanh(x @ w) - 1.0) ** 2).sum() / count
        local.backward()
        w = w.detach() - 0.5 * _summed(w.grad, mesh.group(AXIS_DATA))
        losses.append(float(_summed(local.detach(), mesh.group(AXIS_DATA))))
    assert losses[-1] < losses[0], losses
    assert _synced(w), "param replicas diverged"
    return losses


def _dp_tp_phase(rank: int) -> List[float]:
    from ..parallel.collectives import copy_to, gather_global, reduce_from
    from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, MeshConfig, local_shard, make_mesh

    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    d, h = 16, 16 * mesh.shape[AXIS_MODEL]
    tp = mesh.group(AXIS_MODEL)
    w1 = local_shard(torch.tensor(np.random.RandomState(0).randn(d, h) * 0.1,
                                  dtype=torch.float32), mesh, (None, AXIS_MODEL))
    w2 = local_shard(torch.tensor(np.random.RandomState(1).randn(h, d) * 0.1,
                                  dtype=torch.float32), mesh, (AXIS_MODEL, None))
    # the batch is split over data and the same on both model ranks
    x = torch.tensor(np.random.RandomState(100 + mesh.coordinate(AXIS_DATA)).randn(4, d),
                     dtype=torch.float32)
    count = x.numel() * mesh.shape[AXIS_DATA]
    losses = []
    for _ in range(5):
        w1, w2 = w1.detach().requires_grad_(True), w2.detach().requires_grad_(True)
        y = reduce_from(torch.tanh(copy_to(x, tp) @ w1) @ w2, tp)
        local = ((y - 1.0) ** 2).sum() / count
        local.backward()
        w1 = w1.detach() - 0.5 * _summed(w1.grad, mesh.group(AXIS_DATA))
        w2 = w2.detach() - 0.5 * _summed(w2.grad, mesh.group(AXIS_DATA))
        losses.append(float(_summed(local.detach(), mesh.group(AXIS_DATA))))
    assert losses[-1] < losses[0], losses
    for name, w, spec in (("w1", w1, (None, AXIS_MODEL)), ("w2", w2, (AXIS_MODEL, None))):
        assert _synced(gather_global(w, mesh, spec)), f"{name} replicas diverged"
    return losses


def worker() -> None:
    """One worker: the env is the webhook's plus LOCAL_RANK, the hostname
    the pod's (passed explicitly: this process is not in the pod)."""
    from ..parallel import distributed

    torch.set_num_threads(1)
    ident = distributed.initialize(hostname=os.environ["E2E_POD_NAME"], device="cpu")
    assert ident.is_distributed, ident
    rank, world = ident.process_id, ident.num_processes
    out = [torch.empty(1) for _ in range(world)]
    dist.all_gather(out, torch.tensor([rank + 1.0]))
    gathered = [float(o) for o in out]
    assert sum(gathered) == world * (world + 1) / 2, gathered
    print(f"worker {rank}/{world}: allgather={gathered} sum={sum(gathered)}", flush=True)
    losses = _dp_phase(rank, world)
    print(f"worker {rank}: dp_train losses={losses[0]:.4f}->{losses[-1]:.4f} "
          f"params_synced=True", flush=True)
    tp_losses = _dp_tp_phase(rank)
    print(f"worker {rank}: dp_tp_train mesh=data2xmodel2 losses={tp_losses[0]:.4f}->"
          f"{tp_losses[-1]:.4f} tp_params_synced=True", flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(timeout: float = 120.0) -> Dict[str, Any]:
    env = env_list_to_dict(torchrun_worker_env(parse_topology("h100", str(CARDS)), WORKLOAD,
                                               NAMESPACE))
    injected_master = f"{env[ENV_MASTER_ADDR]}:{env[ENV_MASTER_PORT]}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    procs = []
    try:
        for local_rank in range(int(env["NPROC_PER_NODE"])):
            penv = dict(os.environ, **env)
            penv.update({ENV_MASTER_ADDR: "127.0.0.1", ENV_MASTER_PORT: str(port),
                         ENV_LOCAL_RANK: str(local_rank), "E2E_POD_NAME": POD_NAME,
                         "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, "--worker"], env=penv,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        outputs = []
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outputs.append(out.decode())
            assert p.returncode == 0, outputs[-1][-2000:]
    finally:
        # a failed or hung worker must not outlive the run
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all("allgather=" in o for o in outputs)
    assert all("dp_train" in o and "params_synced=True" in o for o in outputs)
    assert all("dp_tp_train" in o and "tp_params_synced=True" in o for o in outputs), \
        "dp x tp phase missing"
    return {
        "namespace": NAMESPACE,
        "workers": len(procs),
        "coordinator_env": injected_master,
        "rendezvous": "ok",
        "dp_train": "ok",
        "dp_tp_train": f"ok (data2 x model2 over {len(procs)} processes, one device each)",
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["--worker"]:
        worker()
        return 0
    try:
        report = run()
    except (AssertionError, subprocess.TimeoutExpired) as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
