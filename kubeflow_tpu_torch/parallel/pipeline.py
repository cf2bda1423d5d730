"""Pipeline parallelism: stage-partitioned layers, microbatch streaming.

The port of ``kubeflow_tpu/parallel/pipeline.py``: one loop of
``V*M + S - 1`` steps covers GPipe (``virtual_stages=1``) and the
interleaved schedule (V > 1, with the circular re-entry buffer on stage
0), with JAX's checks, messages and final sum over ``pipe``. The layout
helpers (:func:`stack_stage_params`, :func:`stage_param_spec`,
:func:`interleave_stage_params`, :func:`deinterleave_stage_params`) and
:func:`schedule_stats` are JAX's on dicts of tensors.

One process is one pipeline stage: ``local_params`` holds this rank's V
chunks (leading dim V, device-major round-robin as in JAX), and the stage
index is a Python int, so JAX's ``jnp.where`` on the stage and on
``valid`` become branches. The activation hop is :func:`ppermute` over the
``pipe`` group. Two things differ from differentiating JAX's scan:

- every hop stays in the graph and exchanges on every step, bubble or not:
  a hop whose output nobody used would otherwise have its backward skipped
  while its neighbour waits for it;
- consecutive hops share a token (a scalar threaded through each hop and
  added to the output as zero), so their backwards run in one total order
  on every rank; two ranks that ran them in different orders would swap
  same-shaped messages silently.

``mask_bubbles`` skips only ``stage_fn`` on a bubble step, as JAX's
``lax.cond``. The input stream is replicated over ``pipe`` (its cotangent
is summed there: only stage 0 reads it) and the output is the sum over
``pipe`` of the last stage's results (the replicated result's cotangent
passes through): the transposes JAX's shard_map gives an unsharded input
and output.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .collectives import axis_index, copy_to, ppermute, reduce_from
from .mesh import AXIS_PIPE, Mesh, Spec

Params = Dict[str, torch.Tensor]


def stack_stage_params(per_stage_params: List[Params]) -> Params:
    """Stack S (or S*V) per-stage dicts into one with a leading stage dim,
    in natural order (row g holds chunk g)."""
    return {k: torch.stack([p[k] for p in per_stage_params]) for k in per_stage_params[0]}


def stage_param_spec(leaf: torch.Tensor) -> Spec:
    """Spec for stacked stage params: stage dim over ``pipe``."""
    return (AXIS_PIPE,) + (None,) * (leaf.dim() - 1)


def _round_robin_perm(n_stages: int, virtual_stages: int) -> List[int]:
    """Row d*V+v of the interleaved layout holds natural chunk v*S+d."""
    return [v * n_stages + d for d in range(n_stages) for v in range(virtual_stages)]


def interleave_stage_params(stage_params: Params, n_stages: int,
                            virtual_stages: int) -> Params:
    """Natural chunk order [S*V, ...] -> device-major round-robin layout:
    sharding the leading dim over ``pipe`` then hands device d its V chunks
    {d, S+d, 2S+d, ...} as local rows [0..V)."""
    perm = _round_robin_perm(n_stages, virtual_stages)
    return {k: p[perm] for k, p in stage_params.items()}


def deinterleave_stage_params(stage_params: Params, n_stages: int,
                              virtual_stages: int) -> Params:
    """Inverse of :func:`interleave_stage_params` (back to natural order)."""
    perm = _round_robin_perm(n_stages, virtual_stages)
    inv = [0] * len(perm)
    for row, g in enumerate(perm):
        inv[g] = row
    return {k: p[inv] for k, p in stage_params.items()}


def schedule_stats(num_micro: int, n_stages: int,
                   virtual_stages: int = 1) -> Dict[str, float]:
    """Analytic schedule shape: step counts and bubble fraction
    (S-1)/(V*M+S-1), as JAX's."""
    total = virtual_stages * num_micro + n_stages - 1
    bubble = n_stages - 1
    return {
        "total_steps": total,
        "compute_steps": virtual_stages * num_micro,
        "bubble_steps": bubble,
        "bubble_fraction": bubble / total,
    }


class _Tie(torch.autograd.Function):
    """``token`` unchanged, with ``x`` tied into its graph (a zero
    cotangent), so that ``x``'s backward runs on every stage, readers of
    ``x`` or not."""

    @staticmethod
    def forward(ctx, token, x):
        ctx.like = (x.shape, x.dtype, x.device)
        return token.view_as(token)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _check(n_stages: int, virtual_stages: int, num_micro: int, local_params: Params) -> None:
    if virtual_stages < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {virtual_stages}")
    if n_stages > num_micro:
        raise ValueError(
            f"need at least as many microbatches as stages: "
            f"{num_micro} microbatches < {n_stages} stages")
    for name, leaf in local_params.items():
        if leaf.shape[:1] != (virtual_stages,):
            raise ValueError(
                f"stage_params leading dim must be n_stages*virtual_stages="
                f"{n_stages}*{virtual_stages}={n_stages * virtual_stages}; this stage's "
                f"leaf [{name!r}] has local shape {tuple(leaf.shape)} (want "
                f"{virtual_stages} rows)")


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   local_params: Params, x: torch.Tensor, mesh: Mesh, *,
                   axis_name: str = AXIS_PIPE, virtual_stages: int = 1,
                   mask_bubbles: bool = True,
                   stage_prepare: Optional[Callable[[Params], Params]] = None
                   ) -> torch.Tensor:
    """Run ``x`` through S*V pipelined stage chunks of ``stage_fn``.

    - ``stage_fn(chunk_params, h) -> h'`` — one chunk; output shape and
      dtype equal the input's (the GPipe contract); it sees local shards
      and runs its own collectives over other axes;
    - ``local_params`` — this stage's rows [V, ...] of the stacked,
      interleaved params (``local_shard(p, mesh, stage_param_spec(p))``);
    - ``x`` — [num_microbatches, microbatch, ...], replicated over
      ``axis_name`` (batch axes may split its microbatch dim);
    - ``stage_prepare(local_params)`` — run once per call before the loop
      (the amortized fsdp gathers).

    Returns [num_microbatches, microbatch, ...], replicated over the pipe
    axis. Differentiable end to end.
    """
    group = mesh.group(axis_name)
    n_stages = mesh.shape[axis_name]
    stage = axis_index(mesh, axis_name)
    V, num_micro = virtual_stages, x.shape[0]
    _check(n_stages, V, num_micro, local_params)
    is_first, is_last = stage == 0, stage == n_stages - 1
    if stage_prepare is not None:
        local_params = stage_prepare(local_params)
    x = copy_to(x, group)
    total_steps = V * num_micro + n_stages - 1
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    chunks = [{k: p[r] for k, p in local_params.items()} for r in range(V)]
    zeros = torch.zeros_like(x[0])
    token = _Tie.apply(torch.zeros((), device=x.device, requires_grad=True), x)
    recv = zeros
    circ: List[Any] = [zeros] * num_micro
    out: List[Any] = [zeros] * num_micro
    for t in range(total_steps):
        u = t - stage
        r, m = u // num_micro, u % num_micro
        valid = 0 <= u < V * num_micro
        if is_first:
            if V > 1:
                # bank what the last stage sent: microbatch (t - S) mod M
                # re-enters stage 0 here (store-then-read keeps M == S safe)
                circ[(t - n_stages) % num_micro] = recv
                inp = x[m] if r <= 0 else circ[m]
            else:
                inp = x[m]
        else:
            inp = recv
        if valid or not mask_bubbles:
            y = stage_fn(chunks[min(max(r, 0), V - 1)], inp)
        else:
            y = zeros
        if is_last and valid and r == V - 1:
            out[m] = y
        recv, token = ppermute(y, group, fwd_perm, token=token)
    result = torch.stack(out) if is_last else torch.zeros_like(x)
    # the token's value is 0: adding it ties every hop into the graph
    return reduce_from(result, group) + token
