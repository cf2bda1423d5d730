"""Mixture-of-Experts with expert parallelism over the ``expert`` group.

The port of ``kubeflow_tpu/parallel/moe.py``. :func:`top_k_routing` is
JAX's position-based top-k assignment with static capacity, step for step:

- ties in the top-k break toward the lower expert index, as ``lax.top_k``
  (a stable descending sort; ``torch.topk`` promises no order);
- a token's place in its expert's queue comes from an f32 ``cumsum`` over
  (choice, token) in choice-major order, exact as JAX's;
- tokens past an expert's capacity, or with a zero gate, are dropped.

:class:`MoEMlp` is the FFN block with parameters ``router`` [d, E] (f32),
``experts_wi`` [E, d, ff] and ``experts_wo`` [E, ff, d], flax's names and
layouts; its capacity is ``max(1, int(capacity_factor * k * tokens / E))``
over every row of the call, padded rows included, and the Switch
load-balance loss of the last forward is ``aux_loss`` (JAX sows it under
``("losses", "moe_aux")``). The dense einsums stay ``torch.einsum`` in the
compute dtype, as JAX computes them outside any Pallas kernel.

With a ``mesh``, a rank holds its batch slice of the tokens (split over
the batch axes, the same on every rank of its ``expert`` group) and its
``E / n`` experts' slices of ``experts_wi``/``experts_wo``. Routing is
global: the router logits are gathered over the batch axes, so every rank
computes JAX's capacity and queue positions over all tokens. Dispatch: each
rank of the expert group fills the expert slots of its share of the
tokens ([E, C, d]), an ``all_to_all_single`` over the expert group sends
each expert's slots to the rank that holds it, where the shares (each slot
is one token's) are summed, then summed over the batch axes. The experts
run locally; their outputs are gathered over the expert group and combined
per token. The reshardings XLA places for JAX's sharding constraints
become these collectives.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .collectives import all_gather, all_to_all, copy_to, psum
from .mesh import AXIS_EXPERT, BATCH_AXES, Mesh


def top_k_routing(router_logits: torch.Tensor, num_experts: int, capacity: int, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits [tokens, E] -> (dispatch [tokens, E, C] one-hot,
    combine [tokens, E, C] gate-weighted, aux_loss), f32; earlier
    positions win a full expert, JAX's sequential priority."""
    tokens = router_logits.shape[0]
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]               # [tokens, k]
    expert_mask = F.one_hot(gate_idx, num_experts).float()               # [tokens, k, E]

    flat_mask = expert_mask.transpose(0, 1).reshape(k * tokens, num_experts)
    pos_in_expert = torch.cumsum(flat_mask, dim=0) - flat_mask
    pos = (pos_in_expert * flat_mask).sum(-1).reshape(k, tokens).T.to(torch.int64)
    keep = (pos < capacity) & (gate_vals > 0)

    first_choice = expert_mask[:, 0, :]
    density = first_choice.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = num_experts * torch.sum(density * density_proxy)

    # slot `capacity` is past the end: its one-hot row is all zeros
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    pos_oh = F.one_hot(slot, capacity + 1)[..., :capacity].float()       # [tokens, k, C]
    dispatch = torch.einsum("tke,tkc->tec", expert_mask, pos_oh)
    combine = torch.einsum("tke,tkc,tk->tec", expert_mask, pos_oh, gate_vals)
    return dispatch, combine, aux_loss


def _fan_in_normal(shape, fan_in: int, device) -> torch.Tensor:
    return torch.randn(shape, device=device) / math.sqrt(fan_in)


class MoEMlp(nn.Module):
    """Expert FFN block: route -> dispatch -> expert MLP -> combine.
    [..., d_model] -> [..., d_model]; see the module docstring for the
    sharded path. JAX's fields, plus ``d_model`` (flax infers it from the
    first input) and ``device`` (``"meta"`` builds shapes only); the
    seeded weights are normal with std 1/sqrt(fan_in), flax's scale."""

    def __init__(self, num_experts: int, d_ff: int, k: int = 2,
                 capacity_factor: float = 1.25, mesh: Optional[Mesh] = None,
                 dtype: torch.dtype = torch.bfloat16, *, d_model: int,
                 device: DeviceLike = "cuda"):
        super().__init__()
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        self.num_experts, self.d_ff, self.k = num_experts, d_ff, k
        self.capacity_factor, self.mesh, self.dtype = capacity_factor, mesh, dtype
        local = num_experts
        if mesh is not None:
            n = mesh.shape[AXIS_EXPERT]
            if num_experts % n:
                raise ValueError(f"num_experts {num_experts} does not split over "
                                 f"expert={n}")
            local = num_experts // n
        self.router = nn.Parameter(_fan_in_normal((d_model, num_experts), d_model, device))
        self.experts_wi = nn.Parameter(_fan_in_normal((local, d_model, d_ff), d_model, device))
        self.experts_wo = nn.Parameter(_fan_in_normal((local, d_ff, d_model), d_ff, device))
        self.aux_loss: Optional[torch.Tensor] = None

    def capacity(self, tokens: int) -> int:
        return max(1, int(self.capacity_factor * self.k * tokens / self.num_experts))

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.einsum("ecd,edf->ecf", expert_in, self.experts_wi.to(dt))
        h = F.gelu(h, approximate="tanh")
        return torch.einsum("ecf,efd->ecd", h, self.experts_wo.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_shape, dt = x.shape, self.dtype
        x2 = x.reshape(-1, x.shape[-1])
        mesh = self.mesh
        logits = x2.float() @ self.router
        if mesh is None:
            tokens = x2.shape[0]
        else:
            batch = mesh.group(BATCH_AXES)
            logits = all_gather(logits, batch, 0)
            tokens = logits.shape[0]
            rows = slice(mesh.index(BATCH_AXES) * x2.shape[0],
                         (mesh.index(BATCH_AXES) + 1) * x2.shape[0])
        dispatch, combine, aux = top_k_routing(logits, self.num_experts,
                                               self.capacity(tokens), self.k)
        self.aux_loss = aux
        if mesh is None:
            expert_in = torch.einsum("td,tec->ecd", x2.to(dt), dispatch.to(dt))
            out = self._experts(expert_in)
            y = torch.einsum("ecd,tec->td", out, combine.to(dt))
            return y.reshape(orig_shape).to(x.dtype)
        dispatch, combine = dispatch[rows], combine[rows]
        group = mesh.group(AXIS_EXPERT)
        n, j = mesh.shape[AXIS_EXPERT], mesh.coordinate(AXIS_EXPERT)
        # this rank's share of the tokens fills its slots of every expert
        share = torch.tensor_split(torch.arange(x2.shape[0], device=x2.device), n)[j]
        xs = copy_to(x2, group)[share]
        partial = torch.einsum("td,tec->ecd", xs.to(dt), dispatch[share].to(dt))
        local_in = all_to_all(partial, group)                   # n blocks of [E/n, C, d]
        local_in = local_in.reshape((n, -1) + tuple(local_in.shape[1:])).sum(0)
        local_in = psum(local_in, mesh.group(BATCH_AXES))
        out = all_gather(self._experts(local_in), group, 0, backward="slice")
        y = torch.einsum("ecd,tec->td", out, combine.to(dt))
        return y.reshape(orig_shape).to(x.dtype)
