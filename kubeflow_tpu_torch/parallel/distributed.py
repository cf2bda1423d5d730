"""Multi-node bootstrap: from the injected torchrun env to a live process group.

The port of ``kubeflow_tpu/parallel/distributed.py``. The admission webhook
injects identical env on every pod of a job (``gpu/env.py``
``torchrun_worker_env``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``NNODES``, ``NPROC_PER_NODE``); a process's rank is ``RANK`` when its
launcher set it, else ``<StatefulSet ordinal> * NPROC_PER_NODE +
LOCAL_RANK``, the ordinal read from the pod hostname (``<name>-3`` is node
3) as JAX's worker id is. One process drives one device.

:func:`initialize` calls ``torch.distributed.init_process_group`` once:
``nccl`` with ``torch.cuda.set_device(LOCAL_RANK)`` on CUDA, ``gloo`` on the
CPU, the rendezvous at ``tcp://MASTER_ADDR:MASTER_PORT``. A single-process
world (``WORLD_SIZE`` unset or 1) is a no-op, as in JAX.
"""

from __future__ import annotations

import os
import re
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..gpu.env import (ENV_LOCAL_RANK, ENV_MASTER_ADDR, ENV_MASTER_PORT,
                       ENV_NPROC_PER_NODE, ENV_RANK, ENV_WORLD_SIZE)
from .mesh import backend_for

_ORDINAL_RE = re.compile(r"-(\d+)$")


@dataclass(frozen=True)
class WorkerIdentity:
    process_id: int
    num_processes: int
    coordinator_address: Optional[str]
    local_rank: int = 0

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def ordinal_from_hostname(hostname: Optional[str] = None) -> int:
    """StatefulSet ordinal from the pod hostname; 0 if not pod-shaped."""
    host = hostname if hostname is not None else socket.gethostname()
    m = _ORDINAL_RE.search(host.split(".")[0])
    return int(m.group(1)) if m else 0


def _int_env(var: str, raw: str) -> int:
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{var}={raw!r} is not an integer; fix the env injected on this "
            "pod (GPU PodDefault webhook output)") from None


def identity_from_env(environ: Optional[dict] = None,
                      hostname: Optional[str] = None) -> WorkerIdentity:
    env = os.environ if environ is None else environ
    num = _int_env(ENV_WORLD_SIZE, env.get(ENV_WORLD_SIZE, "1"))
    if num <= 1:
        # a single process: a hostname ordinal means nothing here
        return WorkerIdentity(process_id=0, num_processes=1, coordinator_address=None)
    local = _int_env(ENV_LOCAL_RANK, env.get(ENV_LOCAL_RANK, "0"))
    explicit = env.get(ENV_RANK)
    if explicit is not None:
        pid = _int_env(ENV_RANK, explicit)
    else:
        per_node = _int_env(ENV_NPROC_PER_NODE, env.get(ENV_NPROC_PER_NODE, "1"))
        pid = ordinal_from_hostname(hostname) * per_node + local
    addr, port = env.get(ENV_MASTER_ADDR), env.get(ENV_MASTER_PORT)
    coord = f"{addr}:{port}" if addr and port else None
    if pid >= num:
        raise ValueError(f"worker ordinal {pid} >= num_processes {num}")
    return WorkerIdentity(process_id=pid, num_processes=num, coordinator_address=coord,
                          local_rank=local)


_initialized = False


def reset_initialized_for_testing() -> None:
    """Forget that :func:`initialize` ran, so tests can drive the bootstrap
    more than once a process (with a stubbed ``init_process_group``). Never
    call this in production: a process group is not re-initialized."""
    global _initialized
    _initialized = False


def initialize(environ: Optional[dict] = None, hostname: Optional[str] = None, *,
               device: DeviceLike = "cuda",
               timeout: timedelta = timedelta(minutes=10)) -> WorkerIdentity:
    """Idempotently join the process group the injected env describes, on
    ``device`` (``"cuda"``: this process's card, ``LOCAL_RANK``; raises
    without CUDA unless ``"cpu"``). A single process is a no-op."""
    global _initialized
    ident = identity_from_env(environ, hostname)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(ident.local_rank)
    if ident.is_distributed and not _initialized:
        if not ident.coordinator_address:
            raise RuntimeError(
                f"{ENV_WORLD_SIZE}={ident.num_processes} but {ENV_MASTER_ADDR}/"
                f"{ENV_MASTER_PORT} unset; was this pod admitted through the GPU "
                "PodDefault webhook?")
        dist.init_process_group(
            backend=backend_for(dev), init_method=f"tcp://{ident.coordinator_address}",
            world_size=ident.num_processes, rank=ident.process_id, timeout=timeout)
        _initialized = True
    return ident
