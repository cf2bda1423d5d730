"""Run one function on every rank of a local ``torch.distributed`` world.

:func:`run_world` starts ``world_size`` Python processes (``python -m
kubeflow_tpu_torch.parallel.launch``), each of which joins a process group
that rendezvouses through a file under ``workdir`` (so concurrent worlds
never share a port), calls ``target(rank, world_size, workdir)`` and
pickles its return value. The parent waits with a deadline and kills
every rank as soon as one fails or the deadline passes, so a deadlock costs
``timeout`` seconds, not a test run. ``init_process_group`` gets its own
timeout too, so a rank stuck in a collective raises.

``target`` is ``"module:function"``, importable in a fresh process (the
parent's ``sys.path`` is passed down). With ``device="cuda"`` (the
default; raises without CUDA) rank r runs on card r over ``nccl``; with
``device="cpu"`` every rank runs on the CPU over ``gloo``. Each rank runs
one thread of intra-op parallelism.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from typing import Any, List

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import backend_for


def _child(target: str, rank: int, world_size: int, workdir: str, device: str,
           pg_timeout: float) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend_for(device), init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=pg_timeout))
    module, func = target.split(":")
    try:
        result = getattr(importlib.import_module(module), func)(rank, world_size, workdir)
        with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_world(target: str, world_size: int, workdir: str, *, timeout: float = 120.0,
              device: str = "cuda", pg_timeout: float = 60.0) -> List[Any]:
    """Each rank's return value of ``target``, in rank order; raises
    ``RuntimeError`` with the failed ranks' output when a rank fails, or
    the running ranks' when the world outlives ``timeout`` seconds."""
    device = resolve_device(device).type
    os.makedirs(workdir, exist_ok=True)
    penv = dict(os.environ)
    penv["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    procs = []
    logs = []
    try:
        for rank in range(world_size):
            log = open(os.path.join(workdir, f"rank_{rank}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, target, str(rank), str(world_size), workdir,
                 device, str(pg_timeout)], env=penv, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                if bad:
                    # a rank's failure fails its peers' collectives too, and
                    # a peer may exit first: give the others a moment to
                    # exit, then show every failed rank's log
                    grace = time.monotonic() + 5.0
                    while time.monotonic() < grace and None in [p.poll() for p in procs]:
                        time.sleep(0.05)
                    codes = [p.poll() for p in procs]
                    bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                shown = bad or [r for r, c in enumerate(codes) if c is None]
                why = (f"ranks {bad} exited {[codes[r] for r in bad]}" if bad else
                       f"world outlived {timeout} s (ranks still running: {shown})")
                logs_out = "".join(f"\n--- rank {r} ---\n{_tail(workdir, r)}" for r in shown)
                raise RuntimeError(f"{target}: {why}{logs_out}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for rank in range(world_size):
        with open(os.path.join(workdir, f"result_{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _tail(workdir: str, rank: int, n: int = 4000) -> str:
    try:
        with open(os.path.join(workdir, f"rank_{rank}.log"), "rb") as f:
            return f.read().decode(errors="replace")[-n:]
    except OSError:
        return ""


if __name__ == "__main__":
    _target, _rank, _world, _workdir, _device, _pg = sys.argv[1:7]
    _child(_target, int(_rank), int(_world), _workdir, _device, float(_pg))
