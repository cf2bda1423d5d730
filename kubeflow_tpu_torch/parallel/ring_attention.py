"""Ring attention over the ``seq`` group, and exact attention on one device.

The port of ``kubeflow_tpu/parallel/ring_attention.py``.

:func:`ring_attention` takes this rank's local blocks ``[b, L/N, h, d]``
(JAX takes the global arrays and shards them): queries stay put while the
key/value blocks travel the ring of the mesh's ``seq`` group. Each of the
N steps runs the port's flash forward (``ops.flash_attention``, the CUDA
kernel ``flash_fwd`` on CUDA tensors, its plain version on CPU tensors) on
the resident block with ``q_offset = idx * Lq`` and ``k_offset = src * Lk``
for the causal mask by global position. Each block's forward returns its
``out`` in f32 (``out_dtype=torch.float32``: the kernel's accumulator, not
rounded), the blocks are merged by their log-sum-exp in f32, and the
global output is rounded to the input dtype once, at the end, as JAX's one
f32 accumulator is. A fully masked causal block (zeros, ``lse = -1e30``)
merges to nothing.

The backward is one ``torch.autograd.Function`` that walks the ring again:
each step calls ``flash_attention_bwd`` (``flash_bwd_dq`` and
``flash_bwd_dkv``) on the resident block with the **global** ``lse`` and
the global ``out`` in f32, saved before its rounding, so ``delta =
rowsum(dout * out)`` is taken from the unrounded output, as JAX's autodiff
through its accumulator takes it. The dk/dv accumulators (f32) travel with
their blocks, home after N hops. The message order is fixed by this loop,
not by autograd. Heads may be split over ``model`` (the caller's local
blocks then hold ``h / model`` heads); attention needs no collective over
them.

:func:`full_attention` is the single-device exact attention BERT uses by
default and ``ops.flash_attention.auto_attention`` takes on the CPU.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.flash_attention import NEG_BIG, flash_attention_bwd, flash_attention_fwd
from .collectives import exchange
from .mesh import AXIS_MODEL, AXIS_SEQ, BATCH_AXES, Mesh, Spec


def ring_spec(mesh: Mesh, heads: int, axis_name: str = AXIS_SEQ) -> Spec:
    """JAX's layout of [b, L, h, d] for :func:`ring_attention`: batch over
    the batch axes, sequence over the ring, heads over ``model`` where
    they divide."""
    model = mesh.shape.get(AXIS_MODEL, 1)
    head_axes = AXIS_MODEL if model > 1 and heads % model == 0 else None
    return (BATCH_AXES, axis_name, head_axes, None)


def _merge(o: torch.Tensor, lse: torch.Tensor, out_i: torch.Tensor, lse_i: torch.Tensor):
    """Fold a block's (out [b, lq, h, d] f32, lse [b, h, lq]) into the
    f32 running pair; a block with ``lse = -1e30`` adds nothing."""
    new = torch.logaddexp(lse, lse_i)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    c = torch.exp(lse_i - new).transpose(1, 2)[..., None]
    return o * a + out_i * c, new


Blocks = Iterable[Tuple[torch.Tensor, torch.Tensor]]


def ring_forward(q: torch.Tensor, blocks: Blocks, idx: int, n: int, *, causal: bool,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query block ``idx`` of a ring of ``n`` against the k/v blocks that
    ``blocks`` yields at steps 0..n-1 (block ``(idx - i) mod n`` at step
    i): one flash forward a step with an f32 ``out``, merged by
    log-sum-exp in f32. Returns (out f32, not rounded, lse f32 [b, h, lq])."""
    b, lq, h, d = q.shape
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, lq), NEG_BIG, dtype=torch.float32, device=q.device)
    for i, (k_cur, v_cur) in enumerate(blocks):
        src = (idx - i) % n
        out_i, lse_i = flash_attention_fwd(q, k_cur, v_cur, causal=causal, scale=scale,
                                           q_offset=idx * lq, k_offset=src * k_cur.shape[1],
                                           out_dtype=torch.float32)
        o, lse = _merge(o, lse, out_i, lse_i)
    return o, lse


def ring_backward(q: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  blocks: Blocks, idx: int, n: int, *, causal: bool, scale: float,
                  on_block: Callable[[int, torch.Tensor, torch.Tensor], None]) -> torch.Tensor:
    """The backward of :func:`ring_forward` from the global ``out`` (f32,
    as it returns it) and ``lse``: one flash backward a step; ``on_block(src, dk_i, dv_i)`` takes
    each step's gradient of the resident block. Returns dq (f32)."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i, (k_cur, v_cur) in enumerate(blocks):
        src = (idx - i) % n
        dq_i, dk_i, dv_i = flash_attention_bwd(
            q, k_cur, v_cur, out, lse, dout, causal=causal, scale=scale,
            q_offset=idx * q.shape[1], k_offset=src * k_cur.shape[1])
        dq += dq_i.float()
        on_block(src, dk_i, dv_i)
    return dq


def _rotating(k: torch.Tensor, v: torch.Tensor, group, n: int) -> Blocks:
    """The resident k/v block at each step, handed one hop along the ring
    between steps."""
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for i in range(n):
        yield k_cur, v_cur
        if i < n - 1:
            k_cur, v_cur = exchange(k_cur, group, perm), exchange(v_cur, group, perm)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        out, lse = ring_forward(q, _rotating(k, v, group, n), idx, n, causal=causal,
                                scale=scale)
        # the f32 out is the backward's; the caller's is rounded once, here
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        perm = [(j, (j + 1) % n) for j in range(n)]
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]

        def travel(src, dk_i, dv_i):
            # the accumulators travel with their blocks: after n hops each
            # is home, holding every query block's contribution
            acc[0] = exchange(acc[0] + dk_i.float(), group, perm)
            acc[1] = exchange(acc[1] + dv_i.float(), group, perm)

        dq = ring_backward(q, out, lse, dout, _rotating(k, v, group, n), idx, n,
                           causal=ctx.causal, scale=ctx.scale, on_block=travel)
        return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                   causal: bool = False, scale: Optional[float] = None,
                   axis_name: str = AXIS_SEQ) -> torch.Tensor:
    """Sequence-parallel exact attention on this rank's blocks
    [b_local, L/N, h_local, d] (``local_shard(x, mesh, ring_spec(mesh,
    h))``); the output has q's local shape and dtype. Works with a ring of
    one (one local pass)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("expected local [batch, seq, heads, head_dim] blocks")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _RingAttention.apply(q, k, v, mesh.group(axis_name), bool(causal), float(scale))


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
