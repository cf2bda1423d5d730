"""GPU accelerator catalog: the peaks every MFU and roofline denominator
reads.

The port of the catalog half of ``kubeflow_tpu/tpu/topology.py``
(``AcceleratorType``, ``ACCELERATORS``) for the card the port runs on. The
numbers are NVIDIA's data-sheet figures for the H100 SXM part (dense bf16
tensor-core rate without sparsity, HBM3 size and rate) at its full 700 W
power limit. The H100 PCIe and H100 NVL parts have other peaks and do not
match this entry: a card whose name is not listed has no entry, and
:func:`lookup` raises rather than put one card's peaks under another's name.

The slice-topology math, the resource names and the launcher environment
of ``kubeflow_tpu/tpu/`` wait for the accelerator-seam item of ROADMAP.md
queue A.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class AcceleratorType:
    """One GPU part, by the device names it reports."""

    generation: str                 # catalog key, "h100"
    device_names: Tuple[str, ...]   # torch.cuda.get_device_name values it matches
    bf16_tflops_per_chip: float     # peak dense bf16 TFLOP/s (MFU denominators)
    hbm_gib_per_chip: int
    hbm_gbps_per_chip: float        # peak HBM GB/s (roofline denominators)


ACCELERATORS: Dict[str, AcceleratorType] = {
    a.generation: a
    for a in [
        AcceleratorType("h100", ("NVIDIA H100 80GB HBM3",), 989.0, 80, 3350.0),
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
