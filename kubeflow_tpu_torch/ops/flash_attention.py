"""Fused blockwise attention (FlashAttention-2 style), forward and backward.

The port of ``kubeflow_tpu/ops/flash_attention.py``. Three hand-written
CUDA kernels (``csrc/flash_attention.cu``) replace the Pallas ones:

- ``flash_fwd`` — online-softmax attention; returns ``out`` (input dtype)
  and the f32 log-sum-exp ``lse`` [b, h, lq];
- ``flash_bwd_dq`` — dq, q-major, recomputing ``p = exp(s - lse)``;
- ``flash_bwd_dkv`` — dk and dv, k-major; two passes and no atomics, so the
  gradients are the same bits on every run.

:func:`flash_attention` is differentiable through :class:`FlashAttention`
(the ``torch.autograd.Function`` in place of JAX's ``custom_vjp``), which
saves ``q, k, v, out, lse`` as ``_flash_fwd`` does. ``q_offset``/
``k_offset`` are the global positions of element 0 of q/k for causal
masking: a row that sees no key gives zeros and ``lse = -1e30``.

Precision as in JAX: by default every dot runs on f32 operands
(``bf16_dots=False``); ``bf16_dots=True`` rounds each operand, ``p`` and
``ds`` included, to bf16 first, with f32 sums. On bf16 inputs all three
kernels run their dots on the tensor cores (bf16 ``mma``, f32 sums): q, k,
v and dout products are exact, and with ``bf16_dots=False`` ``p`` and
``ds`` enter as two bf16 terms ``hi + lo`` (within 2^-16 of the f32 value,
relative); f32 inputs keep f32 SIMT products.

A wrapper takes the plain PyTorch versions (:func:`flash_attention_fwd_plain`,
:func:`flash_attention_bwd_plain`, which materialize the scores in f32) only
when the tensors lie on the CPU; on CUDA tensors it launches the kernels or
raises. :func:`flash_attention_plain` runs the plain versions on any device,
the comparator the kernels are held against. Each kernel launch adds one to
``LAUNCHES[<name>]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build

SOURCE = "flash_attention.cu"
NEG_BIG = -1e30
HEAD_DIMS = (32, 64, 128)

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _auto_block(length: int, cap: int = 1024) -> int:
    """The JAX package's tile choice: the largest 128-aligned divisor of
    ``length`` up to ``cap`` (the whole length when it is at most 128), else
    the largest 8-aligned divisor >= 64, else the whole length."""
    if length <= 128:
        return length
    best = max((d for d in range(128, min(cap, length) + 1, 128) if length % d == 0),
               default=0)
    if best:
        return best
    for d in range(min(cap, length) & ~7, 63, -8):
        if length % d == 0:
            return d
    return length


def _block_sizes(lq: int, lk: int, block_q: Optional[int],
                 block_k: Optional[int]) -> Tuple[int, int]:
    """Validation only: explicit blocks must divide the lengths, as in JAX.
    The CUDA kernels pick their own 64 x 64 tiles and mask a ragged edge."""
    bq = _auto_block(lq) if block_q is None else min(block_q, lq)
    bk = _auto_block(lk) if block_k is None else min(block_k, lk)
    if lq % bq or lk % bk:
        raise ValueError(
            f"block sizes ({bq}, {bk}) must divide sequence lengths ({lq}, {lk})")
    return bq, bk


# -- plain versions ------------------------------------------------------------

def _dot_operand(x: torch.Tensor, bf16_dots: bool) -> torch.Tensor:
    """f32 copy of a dot operand, rounded to bf16 first when ``bf16_dots``
    (JAX's ``astype(dot_dtype)``)."""
    return (x.to(torch.bfloat16) if bf16_dots else x).float()


def _visible(lq: int, lk: int, causal: bool, q_offset: int, k_offset: int,
             device: torch.device) -> Optional[torch.Tensor]:
    """[lq, lk] causal mask by global position, or None when not causal."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(lq, device=device)
    k_pos = k_offset + torch.arange(lk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, bf16_dots: bool):
    """f32 scores [b, h, lq, lk] of ``q`` [b, lq, h, d] and ``k`` [b, lk, h, d]."""
    return torch.einsum("bqhd,bkhd->bhqk", _dot_operand(q, bf16_dots),
                        _dot_operand(k, bf16_dots)) * scale


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool, scale: float, q_offset: int = 0,
                              k_offset: int = 0, bf16_dots: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out [b, lq, h, d] in q's dtype,
    lse [b, h, lq] f32). The row max and sum follow the kernel's formulas
    (masked entries -1e30 and p zeroed there, ``l == 0`` gives zeros and
    ``lse = -1e30``) over the whole row at once."""
    s = _scores(q, k, scale, bf16_dots)
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    ctx = torch.einsum("bhqk,bkhd->bhqd", _dot_operand(p, bf16_dots),
                       _dot_operand(v, bf16_dots)) / l_safe
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_BIG), m + torch.log(l_safe))
    return ctx.transpose(1, 2).to(q.dtype), lse[..., 0]


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [b, h, lq] (left to XLA in JAX)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool, scale: float, q_offset: int = 0,
                              k_offset: int = 0, bf16_dots: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels: (dq, dk, dv) in the
    inputs' dtypes, from ``p = exp(s - lse)`` and ``ds = p (dp - delta) scale``."""
    s = _scores(q, k, scale, bf16_dots)
    p = torch.exp(s - lse[..., None])
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    do_f = _dot_operand(dout, bf16_dots)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_f, _dot_operand(v, bf16_dots))
    ds = p * (dp - _delta(out, dout)[..., None]) * scale
    ds_d, p_d = _dot_operand(ds, bf16_dots), _dot_operand(p, bf16_dots)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_d, _dot_operand(k, bf16_dots))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_d, _dot_operand(q, bf16_dots))
    dv = torch.einsum("bhqk,bqhd->bkhd", p_d, do_f)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -----------------------------------------------------------------

def _check_cuda(q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError("flash_attention: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: kernels take bf16 or f32, got {q.dtype}")
    for t in others:
        if t.device != q.device:
            raise ValueError(f"flash_attention: all tensors must be on {q.device}, "
                             f"got one on {t.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    k, v = others[:2]
    if (k.dim() != 4 or v.shape != k.shape
            or (k.shape[0], *k.shape[2:]) != (q.shape[0], *q.shape[2:])):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "must be [b, lq, h, d] and [b, lk, h, d]")


def _check_aligned(*ts: torch.Tensor) -> None:
    """The bf16 kernels move rows in 16-byte vectors."""
    for t in ts:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("flash_attention: tensors must start on a 16-byte boundary")


def _launch(name: str, device: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _build.entry(SOURCE, name)(device.index, *args, stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _shape_args(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool,
                q_offset: int, k_offset: int, bf16_dots: bool):
    b, lq, h, d = q.shape
    return (int(q.dtype == torch.bfloat16), b, lq, k.shape[1], h, d, float(scale),
            int(causal), int(q_offset), int(k_offset), int(bf16_dots))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, scale: float, q_offset: int = 0, k_offset: int = 0,
                        bf16_dots: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) through ``flash_fwd``; the plain version for CPU tensors.
    Replaces the Pallas ``_fwd_kernel`` of ``kubeflow_tpu/ops/flash_attention.py``."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, k_offset=k_offset,
              bf16_dots=bf16_dots)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    _check_cuda(q, k, v)
    q, k, v = q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous()
    b, lq, h, _ = q.shape
    _check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *_shape_args(q, k, **kw))
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool, scale: float, q_offset: int = 0, k_offset: int = 0,
                        bf16_dots: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through ``flash_bwd_dq`` then ``flash_bwd_dkv``; the
    plain version for CPU tensors. Replaces the Pallas ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel``."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, k_offset=k_offset,
              bf16_dots=bf16_dots)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    _check_cuda(q, k, v, out, lse, dout)
    dt = q.dtype
    q, k, v = q.contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous()
    dout = dout.to(dt).contiguous()
    lse, delta = lse.float().contiguous(), _delta(out, dout)
    return (bwd_dq_kernel(q, k, v, dout, lse, delta, **kw),
            *bwd_dkv_kernel(q, k, v, dout, lse, delta, **kw))


def bwd_dq_kernel(q, k, v, dout, lse, delta, **kw) -> torch.Tensor:
    """Launch ``flash_bwd_dq`` on contiguous CUDA tensors of one dtype
    (lse, delta: [b, h, lq] f32); :func:`flash_attention_bwd` prepares them."""
    _check_aligned(q, k, v, dout)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_shape_args(q, k, **kw))
    return dq


def bwd_dkv_kernel(q, k, v, dout, lse, delta, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd_dkv``; inputs as :func:`bwd_dq_kernel`."""
    _check_aligned(q, k, v, dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_shape_args(q, k, **kw))
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of ``_flash`` in PyTorch: the forward saves
    ``q, k, v, out, lse``; the backward returns (dq, dk, dv). ``plain``
    takes the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q_offset: int, k_offset: int,
                bf16_dots: bool, plain: bool):
        kw = dict(causal=causal, scale=scale, q_offset=q_offset, k_offset=k_offset,
                  bf16_dots=bf16_dots)
        fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def _attention(q, k, v, causal, scale, q_offset, k_offset, block_q, block_k,
               bf16_dots, plain):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected [batch, seq, heads, head_dim] inputs")
    _block_sizes(q.shape[1], k.shape[1], block_q, block_k)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttention.apply(q, k, v, bool(causal), float(scale), int(q_offset),
                                int(k_offset), bool(bf16_dots), plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: int = 0, k_offset: int = 0, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, bf16_dots: bool = False) -> torch.Tensor:
    """Fused attention. q: [b, lq, h, d]; k/v: [b, lk, h, d] -> [b, lq, h, d].

    Differentiable; both passes are CUDA kernels on a CUDA device and the
    plain versions on the CPU. ``block_q``/``block_k`` are validated as in
    JAX (they must divide the lengths) and otherwise unused.
    """
    return _attention(q, k, v, causal, scale, q_offset, k_offset, block_q, block_k,
                      bf16_dots, plain=False)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = False, scale: Optional[float] = None,
                          q_offset: int = 0, k_offset: int = 0,
                          bf16_dots: bool = False) -> torch.Tensor:
    """:func:`flash_attention` through the plain versions on any device,
    the same ``autograd.Function``; launches nothing."""
    return _attention(q, k, v, causal, scale, q_offset, k_offset, None, None,
                      bf16_dots, plain=True)


def auto_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Drop-in ``attention_fn``: the flash kernels on a CUDA device, at any
    sequence length (they tile by 64 and mask a ragged edge, so the
    128-tiling that decides JAX's choice on the TPU does not bind them);
    exact attention (``parallel.ring_attention.full_attention``) on the CPU,
    the plain route."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    from ..parallel.ring_attention import full_attention

    return full_attention(q, k, v, causal=causal, scale=scale)
