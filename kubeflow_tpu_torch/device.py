"""Device policy shared by every entry point of the port.

An entry point takes ``device`` (default ``"cuda"``) and resolves it here.
A CUDA device on a host without CUDA raises instead of carrying on on the
CPU: a serving or measurement path that silently ran on the CPU would
report CPU numbers under a GPU's name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run the plain PyTorch paths")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
