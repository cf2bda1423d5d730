"""Deterministic synthetic GPU cluster topologies for control-plane runs.

The port of ``kubeflow_tpu/scale/topology.py``. A :class:`SyntheticTopology`
is fully determined by ``(num_nodes, seed)``: the same inputs give the same
node objects, pool split and gang shapes on every run. Nodes are
``controllers/builtin.make_gpu_node`` fixtures with one extra pool label
that gang selectors pin to.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from ..controllers.builtin import make_gpu_node

POOL_LABEL = "scale.kubeflow.org/pool"

# (catalog generation, machine type, cards per node): the H100 node shapes
# users run, Google Cloud's A3 High machine types (a3-highgpu-1g/2g/4g/8g:
# 1, 2, 4 and 8 H100 80GB cards a VM; cloud.google.com/compute/docs/
# accelerator-optimized-machines#a3-high-vms). The 4-card shape comes
# first, as JAX's 4-chip v4 pool does, so small topologies read alike.
_POOL_KINDS = (
    ("h100", "a3-highgpu-4g", 4),
    ("h100", "a3-highgpu-8g", 8),
    ("h100", "a3-highgpu-2g", 2),
    ("h100", "a3-highgpu-1g", 1),
)


@dataclass(frozen=True)
class PoolSpec:
    name: str
    generation: str
    machine_type: str
    chips_per_node: int
    nodes: int

    def selector(self) -> Dict[str, str]:
        return {POOL_LABEL: self.name}


@dataclass(frozen=True)
class GangShape:
    name: str
    size: int
    chips_per_pod: int
    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class SyntheticTopology:
    seed: int
    pools: List[PoolSpec]

    @property
    def total_nodes(self) -> int:
        return sum(p.nodes for p in self.pools)

    @property
    def total_chips(self) -> int:
        return sum(p.nodes * p.chips_per_node for p in self.pools)

    def pool(self, name: str) -> PoolSpec:
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(name)

    def node_name(self, pool: PoolSpec, i: int) -> str:
        return f"{pool.name}-node-{i:05d}"

    def nodes(self) -> Iterator[Dict[str, Any]]:
        """Node objects in deterministic order (pool by pool)."""
        for pool in self.pools:
            for i in range(pool.nodes):
                node = make_gpu_node(
                    self.node_name(pool, i), pool.generation, pool.chips_per_node,
                    instance_type=pool.machine_type, pool=pool.name)
                node["metadata"]["labels"][POOL_LABEL] = pool.name
                yield node

    def node_names(self) -> List[str]:
        return [self.node_name(p, i) for p in self.pools for i in range(p.nodes)]


def synthesize(num_nodes: int, seed: int = 0,
               num_pools: Optional[int] = None) -> SyntheticTopology:
    """Split ``num_nodes`` across a few heterogeneous pools, seeded."""
    # string seeds stay deterministic across processes (tuple seeds hash)
    rng = random.Random(f"topology:{seed}:{num_nodes}")
    if num_pools is None:
        num_pools = max(1, min(len(_POOL_KINDS), num_nodes // 50 or 1))
    # seeded weights decide the split; every pool gets at least one node
    weights = [rng.uniform(0.5, 1.5) for _ in range(num_pools)]
    total_w = sum(weights)
    counts = [max(1, int(num_nodes * w / total_w)) for w in weights]
    counts[0] += num_nodes - sum(counts)  # absorb rounding in the first pool
    pools = []
    for i, count in enumerate(counts):
        generation, machine, chips = _POOL_KINDS[i % len(_POOL_KINDS)]
        pools.append(PoolSpec(
            name=f"pool-{i}-{machine}", generation=generation,
            machine_type=machine, chips_per_node=chips, nodes=count))
    return SyntheticTopology(seed=seed, pools=pools)


def synth_gangs(topology: SyntheticTopology, count: int, seed: int = 0,
                prefix: str = "gang", max_size: int = 8) -> List[GangShape]:
    """Seeded gang shapes sized to fit somewhere in ``topology``: each gang
    targets one pool via selector and asks for at most a node's worth of
    chips per pod, so a quiet cluster can always bind it."""
    rng = random.Random(f"gangs:{seed}:{count}")
    shapes = []
    for i in range(count):
        pool = rng.choice(topology.pools)
        size = rng.randint(2, min(max_size, max(2, pool.nodes)))
        chips = rng.choice([c for c in (1, 2, 4, pool.chips_per_node)
                            if c <= pool.chips_per_node])
        shapes.append(GangShape(
            name=f"{prefix}-{i:04d}", size=size, chips_per_pod=chips,
            selector=pool.selector()))
    return shapes
