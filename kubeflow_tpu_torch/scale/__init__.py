"""Control-plane load for GPU clusters (ports of ``kubeflow_tpu/scale/``):
``topology`` builds deterministic clusters of A3 High GPU node pools,
selectors and gang shapes from a seed; ``loadgen`` drives gang waves, pod
churn, node kills and watch storms against the real apiserver and
scheduler over HTTP."""

from .topology import POOL_LABEL, GangShape, PoolSpec, SyntheticTopology, synth_gangs, synthesize
from .loadgen import LoadGenerator

__all__ = [
    "POOL_LABEL",
    "GangShape",
    "PoolSpec",
    "SyntheticTopology",
    "synth_gangs",
    "synthesize",
    "LoadGenerator",
]
