"""Entry point of the port, the counterpart of ``__graft_entry__.entry()``.

``entry()`` returns ``(forward, example_args)`` for the flagship model's
eval forward: ``ResNet50(num_classes=1000)`` (the 7x7 stem, unfused
blocks, as in the JAX entry) from seeded weights, on a zero batch of 8
NHWC images. ``forward(images)`` gives the f32 logits [8, 1000].
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .device import DeviceLike, resolve_device
from .models.resnet import ResNet50


def entry(device: DeviceLike = "cuda", image: int = 224
          ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Tuple[torch.Tensor]]:
    """``image`` below 224 gives a quicker check on the CPU."""
    dev = resolve_device(device)
    model = ResNet50(num_classes=1000, seed=0, device=dev)
    images = torch.zeros((8, image, image, 3), dtype=torch.float32, device=dev)

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(images, train=False)

    return forward, (images,)
