"""Attention over a whole sequence on one device.

The port's counterpart of ``kubeflow_tpu/parallel/ring_attention.py``. Only
:func:`full_attention` is ported: the exact reference BERT uses by default
and ``ops.flash_attention.auto_attention`` takes on the CPU. Ring attention
itself (sequence-parallel, ``q_offset``/``k_offset`` into the flash
kernels) waits for the parallelism slice, ROADMAP.md queue A, A.7.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import NEG_BIG


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Single-device exact attention on [b, L, heads, head_dim], as JAX's:
    f32 scores from the inputs' products (bf16 inputs widen exactly), an
    f32 softmax, ``p @ v`` with v in f32, the output in q's dtype."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
