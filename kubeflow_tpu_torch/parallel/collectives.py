"""The collectives the manual-SPMD bodies use, each with JAX's transpose.

The port's counterpart of the ``lax`` collectives that
``kubeflow_tpu/parallel/*`` calls inside ``shard_map`` (JAX's
``parallel/_compat.py`` is only a ``shard_map`` version shim). Each is a
small ``torch.autograd.Function`` over ``torch.distributed`` on a process
group of the mesh (``mesh.group(axis)``):

- :func:`all_gather` — ``lax.all_gather(tiled=True)``; backward a
  ``reduce_scatter`` (the sum over the group of each block's cotangent),
  or with ``backward="slice"`` this rank's block of a cotangent that every
  rank of the group holds whole (a replicated consumer);
- :func:`psum` — ``lax.psum`` of device-varying values; backward a psum;
- :func:`reduce_from` / :func:`copy_to` — Megatron's pair *g* and *f*: a
  sum forward and the identity backward after a row split; the identity
  forward and a sum backward where a replicated activation enters a
  column split (JAX's shard_map autodiff gives the same in
  ``composite._block``);
- :func:`ppermute` — ``lax.ppermute`` over ``(src, dst)`` pairs of group
  indices, on ``batch_isend_irecv``; backward the inverse permutation. An
  optional ``token`` threads consecutive hops so that their backwards run
  in one total order on every rank (``parallel/pipeline.py``);
- :func:`all_to_all` — block ``i`` of dim 0 to group index ``i``; its own
  transpose;
- :func:`axis_index` — ``lax.axis_index``.

Gloo refuses a send to oneself, so a pair whose source and destination are
this rank is a local copy. ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` exist in every torch this port supports; newer
releases warn that they are deprecated, which is silenced here.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axes, Mesh

warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch.distributed.(all_gather_into_tensor|reduce_scatter_tensor)` is deprecated")

Perm = Sequence[Tuple[int, int]]


def axis_index(mesh: Mesh, axes: Axes) -> int:
    """``lax.axis_index``: this rank's index over ``axes``."""
    return mesh.index(axes)


def _gather_raw(x: torch.Tensor, group, axis: int, async_op: bool = False):
    """all_gather of ``x`` along ``axis`` into a new tensor; with
    ``async_op`` (tensor, work) where the tensor is valid after ``wait``."""
    n = dist.get_world_size(group)
    xm = x.movedim(axis, 0).contiguous()
    buf = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    work = dist.all_gather_into_tensor(buf, xm, group=group, async_op=async_op)
    return buf.movedim(0, axis), work


def _scatter_raw(g: torch.Tensor, group, axis: int) -> torch.Tensor:
    """reduce_scatter (sum) of ``g`` along ``axis``: this rank's block."""
    n = dist.get_world_size(group)
    gm = g.movedim(axis, 0).contiguous()
    out = torch.empty((gm.shape[0] // n,) + tuple(gm.shape[1:]), dtype=g.dtype,
                      device=g.device)
    dist.reduce_scatter_tensor(out, gm, group=group)
    return out.movedim(0, axis)


def gather_global(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The whole array from every rank's shard under ``spec`` (no
    autograd; collective over each named group)."""
    out = x.detach()
    for dim, axes in enumerate(spec):
        if axes is not None:
            out, _ = _gather_raw(out, mesh.group(axes), dim)
    return out


def _own_block(g: torch.Tensor, group, axis: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return g.chunk(n, dim=axis)[i].contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Gathered(torch.autograd.Function):
    """The gathered ``buf`` (already collected) as a function of ``x``."""

    @staticmethod
    def forward(ctx, x, buf, group, axis: int, backward: str):
        ctx.group, ctx.axis, ctx.mode = group, axis, backward
        return buf

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "slice":
            dx = _own_block(g, ctx.group, ctx.axis)
        else:
            dx = _scatter_raw(g, ctx.group, ctx.axis)
        return dx, None, None, None, None


def _check_mode(backward: str) -> None:
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError(f"backward must be 'reduce_scatter' or 'slice', got {backward!r}")


def all_gather(x: torch.Tensor, group, axis: int = 0, tiled: bool = True,
               backward: str = "reduce_scatter") -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=axis, tiled=tiled)``: the group's
    blocks concatenated along ``axis`` in group order (stacked on a new
    ``axis`` when not ``tiled``). See the module docstring for ``backward``."""
    _check_mode(backward)
    if not tiled:
        return all_gather(x.unsqueeze(axis), group, axis, True, backward)
    buf, _ = _gather_raw(x.detach(), group, axis)
    return _Gathered.apply(x, buf, group, axis, backward)


class PendingGather:
    """An all_gather in flight (:func:`all_gather_start`); :meth:`wait`
    returns the gathered tensor, differentiable as :func:`all_gather`."""

    def __init__(self, x: torch.Tensor, group, axis: int, backward: str):
        self._x, self._group, self._axis, self._mode = x, group, axis, backward
        self._buf, self._work = _gather_raw(x.detach(), group, axis, async_op=True)

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return _Gathered.apply(self._x, self._buf, self._group, self._axis, self._mode)


def all_gather_start(x: torch.Tensor, group, axis: int = 0,
                     backward: str = "reduce_scatter") -> PendingGather:
    """Issue a tiled all_gather asynchronously (``async_op=True``): the
    overlap gather modes start layer i+1's gathers before layer i computes."""
    _check_mode(backward)
    return PendingGather(x, group, axis, backward)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum`` over the group; its transpose is a psum of the cotangents."""
    return _Psum.apply(x, group)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: sum the group's partial outputs of a row split; the
    result is replicated, so its cotangent passes through unchanged."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: a replicated activation entering a column split; the
    partial cotangents of the group's columns are summed in backward."""
    return _CopyTo.apply(x, group)


def exchange(x: torch.Tensor, group, perm: Perm) -> torch.Tensor:
    """Send ``x`` along each ``(src, dst)`` of ``perm`` (group indices);
    returns what this rank receives (zeros when no pair targets it)."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops: List[dist.P2POp] = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _inverse(perm: Perm) -> List[Tuple[int, int]]:
    return [(dst, src) for src, dst in perm]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token, group, perm):
        ctx.group, ctx.perm = group, perm
        return exchange(x, group, perm), token.view_as(token)

    @staticmethod
    def backward(ctx, g, g_token):
        return exchange(g, ctx.group, _inverse(ctx.perm)), g_token, None, None


def ppermute(x: torch.Tensor, group, perm: Perm, token: Optional[torch.Tensor] = None):
    """``lax.ppermute(x, axis_name, perm)``. With ``token`` (a scalar that
    requires grad) returns ``(y, token')``: the backward of this hop then
    runs after every later hop's on the same token chain, whatever the
    cotangent of ``y`` (a hop whose output no one used still exchanges
    zeros, so its neighbours never wait on it)."""
    perm = [(int(s), int(d)) for s, d in perm]
    if token is None:
        y, _ = _Ppermute.apply(x, x.new_zeros(()), group, perm)
        return y
    return _Ppermute.apply(x, token, group, perm)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of dim 0 (split into group-size equal blocks) goes to
    group index ``i``; block ``j`` of the result came from index ``j``."""
    return _AllToAll.apply(x, group)
