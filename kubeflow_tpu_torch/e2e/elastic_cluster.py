"""The drivers' cluster: the port's own in-memory control plane.

The elastic, goodput, straggler, monitoring and control-plane drivers
(and ``chip_smoke.py``'s phases that run them) build their cluster as
JAX's drivers do: :func:`cluster` starts a ``runtime.manager.Manager`` over a
fresh ``apiserver.store.Store``, with the gang scheduler at JAX's driver
settings (:data:`SCHEDULER_SETTINGS`) and the podlet that moves bound pods
to Running, on ``controllers.builtin.make_gpu_node`` nodes. A workload's
pods (:func:`gang_pod`: JAX's ``_gang_pod``, asking for ``nvidia.com/gpu``
cards) bind through the scheduler, which also runs the two-phase drain of
a lower-priority, drain-graced gang; ``runtime.chaos.ChaosMonkey`` on the
cluster's client issues the chaos kinds.

:func:`run_in_world` runs a driver's ranks (``parallel.launch.run_world``)
and :func:`driver_main` is their command line. In a world of ranks only
rank 0 builds the cluster: it decides for the gang and broadcasts offers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

from ..api.meta import new_object
from ..controllers.builtin import PodletReconciler, make_gpu_node
from ..gpu.topology import RESOURCE_GPU
from ..runtime.manager import Manager
from ..scheduler.core import SchedulerReconciler
from ..scheduler.gang import (DRAIN_GRACE_ANNOTATION, POD_GROUP_LABEL,
                              POD_GROUP_SIZE_ANNOTATION)

NAMESPACE = "default"
#: JAX's drivers' scheduler: gangs assemble within 5 s, holds last 5 s, and
#: a gang that does not fit retries after 0.05 s doubling to 0.4 s
SCHEDULER_SETTINGS = {"assembly_timeout": 5.0, "reservation_ttl": 5.0,
                      "backoff_base": 0.05, "backoff_cap": 0.4}


class Cluster(NamedTuple):
    manager: Manager
    client: Any
    scheduler: SchedulerReconciler


def cluster(nodes: Sequence[Tuple[str, int]] = ()) -> Cluster:
    """A started manager with the scheduler and the podlet, and an H100
    ``make_gpu_node`` node of ``cards`` cards for each ``(name, cards)``.
    The caller stops it (``manager.stop()``)."""
    mgr = Manager()
    sched = SchedulerReconciler(**SCHEDULER_SETTINGS)
    mgr.add(sched).add(PodletReconciler())
    for name, cards in nodes:
        mgr.client.create(make_gpu_node(name, "h100", cards))
    mgr.start()
    return Cluster(mgr, mgr.client, sched)


def gang_pod(name: str, gang: str, size: int, chips: int, priority_class: str,
             namespace: str = NAMESPACE, grace: Optional[float] = None) -> Dict[str, Any]:
    """A member of gang ``gang`` of ``size`` pods, asking ``chips`` cards at
    ``priority_class``; ``grace`` opts it into the scheduler's drain."""
    annotations = {POD_GROUP_SIZE_ANNOTATION: str(size)}
    if grace is not None:
        annotations[DRAIN_GRACE_ANNOTATION] = str(grace)
    return new_object(
        "v1", "Pod", name, namespace, labels={POD_GROUP_LABEL: gang}, annotations=annotations,
        spec={"priorityClassName": priority_class,
              "containers": [{"name": "trainer",
                              "resources": {"limits": {RESOURCE_GPU: str(chips)}}}]})


def running(client, names: Sequence[str], namespace: str = NAMESPACE) -> bool:
    """Whether every pod of ``names`` exists and is Running."""
    pods = [client.get_opt("v1", "Pod", n, namespace) for n in names]
    return all(p is not None and (p.get("status") or {}).get("phase") == "Running"
               for p in pods)


def gone(client, names: Sequence[str], namespace: str = NAMESPACE) -> bool:
    """Whether no pod of ``names`` is left."""
    return all(client.get_opt("v1", "Pod", n, namespace) is None for n in names)


def poll(fn: Callable[[], Any], timeout: float = 30.0, interval: float = 0.05,
         desc: str = "condition") -> Any:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {desc}")


def run_in_world(module: str, device: str, ranks: int, timeout: float,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run ``module``'s ``_rank_main`` in a fresh world of ``ranks``; rank
    0's summary."""
    from ..parallel.launch import run_world

    workdir = tempfile.mkdtemp(prefix=module.rsplit(".", 1)[-1] + "-")
    try:
        with open(os.path.join(workdir, "args.json"), "w") as f:
            json.dump(dict(extra or {}, device=device), f)
        return run_world(f"{module}:_rank_main", ranks, workdir, timeout=timeout,
                         device=device, pg_timeout=timeout)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def driver_main(argv, doc: str, run_fn: Callable[..., Dict[str, Any]], ranks: int) -> int:
    """A driver's command line: ``--device cuda|cpu`` (one rank a card on
    nccl, the default, or gloo ranks on the CPU), ``--ranks`` (the cards
    on CUDA, ``ranks`` on the CPU, unless given), ``--timeout``; prints
    the summary as one JSON line (0), or ``{"ok": false, "error": ...}``
    (1)."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--ranks", type=int, default=None)
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args(argv)
    if args.ranks is None:
        import torch

        args.ranks = torch.cuda.device_count() if args.device == "cuda" else ranks
    try:
        summary = run_fn(args.device, args.ranks, args.timeout)
    except (AssertionError, RuntimeError, ValueError) as e:
        print(json.dumps({"ok": False, "error": str(e)[-4000:]}))
        return 1
    print(json.dumps(summary))
    return 0
