"""torchrun / NCCL environment for multi-node GPU jobs.

The port of ``kubeflow_tpu/tpu/env.py``. The rendezvous is deterministic
and computable at admission time: the master is pod 0 of the workload's
headless Service (``<name>-0.<name>.<ns>.svc.<domain>``), so every pod
gets the same environment, and regenerating it is a no-op (the PodDefault
webhook rejects conflicting env). Each worker derives its ``RANK`` and
``LOCAL_RANK`` at runtime (torchrun sets them from ``--node_rank``, the
StatefulSet ordinal), as JAX's ``TPU_WORKER_ID`` is left to runtime.

``data/pipeline.py`` ``per_host_shard`` reads :data:`ENV_RANK` and
:data:`ENV_WORLD_SIZE` from a worker's environment.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .topology import NodeTopology

#: torch.distributed's conventional rendezvous port
MASTER_PORT = 29500
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_NNODES = "NNODES"
ENV_NPROC_PER_NODE = "NPROC_PER_NODE"
#: set per process at runtime, never by the admission-time env
ENV_RANK = "RANK"
ENV_LOCAL_RANK = "LOCAL_RANK"


def coordinator_address(workload_name: str, namespace: str,
                        cluster_domain: str = "cluster.local",
                        port: int = MASTER_PORT) -> str:
    """Pod 0 of the headless Service: ``<name>-0.<name>.<ns>.svc.<domain>:<port>``."""
    return f"{workload_name}-0.{workload_name}.{namespace}.svc.{cluster_domain}:{port}"


def worker_hostnames(workload_name: str, namespace: str, num_hosts: int,
                     cluster_domain: str = "cluster.local") -> str:
    return ",".join(
        f"{workload_name}-{i}.{workload_name}.{namespace}.svc.{cluster_domain}"
        for i in range(num_hosts))


def torchrun_worker_env(
    topology: NodeTopology,
    workload_name: str,
    namespace: str,
    cluster_domain: str = "cluster.local",
    extra: Optional[Dict[str, str]] = None,
) -> List[Dict[str, str]]:
    """Env var list (pod-spec shape, sorted by name) making a pod a node of
    a torchrun job: the master's address and port, ``WORLD_SIZE`` (every
    card of the job), ``NNODES`` and ``NPROC_PER_NODE``. Identical on
    every pod; ``RANK`` and ``LOCAL_RANK`` are left
    to runtime."""
    host, port = coordinator_address(workload_name, namespace, cluster_domain).rsplit(":", 1)
    env = {
        ENV_MASTER_ADDR: host,
        ENV_MASTER_PORT: port,
        ENV_WORLD_SIZE: str(topology.num_chips),
        ENV_NNODES: str(topology.num_hosts),
        ENV_NPROC_PER_NODE: str(topology.chips_per_pod),
    }
    if extra:
        env.update(extra)
    return [{"name": k, "value": v} for k, v in sorted(env.items())]


def env_list_to_dict(env: List[Dict[str, str]]) -> Dict[str, str]:
    return {e["name"]: e.get("value", "") for e in env}
