"""GPU accelerator catalog and node-topology math.

The port of ``kubeflow_tpu/tpu/topology.py`` for the card the port runs
on. The catalog (``AcceleratorType``, ``ACCELERATORS``) holds the peaks
every MFU and roofline denominator reads: NVIDIA's data-sheet figures for
the H100 SXM part (dense bf16 tensor-core rate without sparsity, HBM3 size
and rate) at its full 700 W power limit. The H100 PCIe and H100 NVL parts
have other peaks and do not match this entry: a card whose name is not
listed has no entry, and :func:`lookup` raises rather than put one card's
peaks under another's name.

:class:`NodeTopology` is JAX ``SliceTopology``'s surface for GPU nodes: a
job of ``num_chips`` cards fills whole HGX nodes of ``gpus_per_host``
cards (8 on an HGX H100), one pod a node, each pod holding
``nvidia.com/gpu`` cards and scheduled by the ``nvidia.com/gpu.product``
label that GPU feature discovery sets. The launcher environment a pod
needs (torchrun's rendezvous) is in :mod:`kubeflow_tpu_torch.gpu.env`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

RESOURCE_GPU = "nvidia.com/gpu"
#: the node label GPU feature discovery sets to the card's product name
NODE_LABEL_PRODUCT = "nvidia.com/gpu.product"


@dataclass(frozen=True)
class AcceleratorType:
    """One GPU part, by the device names it reports."""

    generation: str                 # catalog key, "h100"
    device_names: Tuple[str, ...]   # torch.cuda.get_device_name values it matches
    bf16_tflops_per_chip: float     # peak dense bf16 TFLOP/s (MFU denominators)
    hbm_gib_per_chip: int
    hbm_gbps_per_chip: float        # peak HBM GB/s (roofline denominators)
    gpus_per_host: int = 8          # cards a node (an HGX board) exposes to one pod
    gfd_product: str = ""           # value of the nvidia.com/gpu.product node label
    max_chips: int = 1024           # largest job the catalog admits


ACCELERATORS: Dict[str, AcceleratorType] = {
    a.generation: a
    for a in [
        AcceleratorType("h100", ("NVIDIA H100 80GB HBM3",), 989.0, 80, 3350.0,
                        gpus_per_host=8, gfd_product="NVIDIA-H100-80GB-HBM3"),
    ]
}


def lookup(device_name: str) -> AcceleratorType:
    """The catalog entry whose device names include ``device_name``
    exactly; raises ``KeyError`` naming the card otherwise."""
    for acc in ACCELERATORS.values():
        if device_name in acc.device_names:
            return acc
    known = sorted(n for a in ACCELERATORS.values() for n in a.device_names)
    raise KeyError(f"no accelerator catalog entry for {device_name!r} (known: {known}); "
                   "its peaks would be another part's")


@dataclass(frozen=True)
class NodeTopology:
    """A job of ``num_chips`` cards of one generation: JAX
    ``SliceTopology``'s surface, with HGX nodes in place of TPU hosts."""

    generation: str
    num_chips: int

    @property
    def accelerator(self) -> AcceleratorType:
        return ACCELERATORS[self.generation]

    @property
    def label(self) -> str:
        """``<nodes>x<cards a node>``, e.g. ``2x8``; ``1x4`` for four cards
        of one node."""
        return f"{self.num_hosts}x{self.chips_per_pod}"

    @property
    def num_hosts(self) -> int:
        """Pods (= nodes) the job needs: one while the cards fit one node,
        else whole nodes of ``gpus_per_host`` cards."""
        gph = self.accelerator.gpus_per_host
        if self.num_chips <= gph:
            return 1
        if self.num_chips % gph:
            raise ValueError(f"{self.generation} {self.num_chips} GPUs: not divisible by "
                             f"{gph} GPUs a node")
        return self.num_chips // gph

    @property
    def chips_per_pod(self) -> int:
        return self.num_chips if self.num_hosts == 1 else self.accelerator.gpus_per_host

    @property
    def is_multi_host(self) -> bool:
        return self.num_hosts > 1

    def node_selector(self) -> Dict[str, str]:
        return {NODE_LABEL_PRODUCT: self.accelerator.gfd_product}

    def resource_limits(self) -> Dict[str, str]:
        return {RESOURCE_GPU: str(self.chips_per_pod)}

    def peak_bf16_tflops(self) -> float:
        return self.num_chips * self.accelerator.bf16_tflops_per_chip


def parse_topology(generation: str, label: str) -> NodeTopology:
    """Parse a GPU count (``"4"``) or ``<nodes>x<cards a node>``
    (``"2x8"``) with JAX's validation messages."""
    if generation not in ACCELERATORS:
        raise ValueError(f"unknown GPU generation {generation!r}; known: {sorted(ACCELERATORS)}")
    acc = ACCELERATORS[generation]
    try:
        dims = tuple(int(p) for p in label.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad topology {label!r}: expected N or NODESxGPUS") from None
    if any(d < 1 for d in dims):
        raise ValueError(f"bad topology {label!r}: dimensions must be >= 1")
    if len(dims) > 2:
        raise ValueError(f"{generation} topologies are N or NODESxGPUS; got {label!r}")
    if len(dims) == 2 and dims[1] > acc.gpus_per_host:
        raise ValueError(f"{generation} {label}: {dims[1]} GPUs a node exceeds "
                         f"{acc.gpus_per_host}")
    if len(dims) == 2 and dims[0] > 1 and dims[1] != acc.gpus_per_host:
        raise ValueError(f"{generation} {label}: a multi-node job takes whole nodes of "
                         f"{acc.gpus_per_host} GPUs")
    n = dims[0] * (dims[1] if len(dims) == 2 else 1)
    topo = NodeTopology(generation, n)
    if topo.num_chips > acc.max_chips:
        raise ValueError(f"{generation} {label}: {topo.num_chips} chips exceeds max "
                         f"{acc.max_chips}")
    topo.num_hosts  # validates divisibility
    return topo


def pod_gpu_chips(pod: Dict[str, Any]) -> int:
    """Cards a pod holds against node capacity and quota: the sum of its
    containers' ``nvidia.com/gpu`` limits, zero once the pod is terminal
    (kube-scheduler leaves Succeeded/Failed pods out of resource
    accounting). The analog of JAX ``pod_tpu_chips``."""
    if (pod.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
        return 0
    total = 0
    for c in (pod.get("spec") or {}).get("containers", []) or []:
        total += int(((c.get("resources") or {}).get("limits") or {}).get(RESOURCE_GPU, 0))
    return total
