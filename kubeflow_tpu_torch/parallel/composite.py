"""Composed 4D parallelism: one GPT train step over dp x fsdp x tp x pp.

The port of ``kubeflow_tpu/parallel/composite.py``, in the port's manual
SPMD (one process per device, ``parallel/mesh.py``):

- ``pipe``  — the transformer layers split into stage chunks
  (``parallel/pipeline.py``; GPipe, or with ``virtual_stages > 1`` the
  interleaved schedule);
- ``model`` — Megatron tensor parallelism inside each stage: column-split
  QKV/W1 behind :func:`copy_to` (*f*), row-split WO/W2 followed by
  :func:`reduce_from` (*g*), as JAX's shard_map autodiff places them in
  ``_block``;
- ``fsdp``  — ZeRO-3 weight shards, gathered in one of
  :data:`GATHER_MODES`: ``"eager"`` (each weight right before use, once per
  layer per microbatch), ``"overlap"`` (layer i+1's gathers issued
  ``async_op=True`` before layer i computes; the last layer prefetches a
  clamped duplicate that is discarded) or ``"amortized"`` (every chunk
  weight gathered once per step by the pipeline's ``stage_prepare``, so
  each gradient reduce-scatter runs once per step). Each gather's backward
  is a reduce-scatter;
- ``data``/``fsdp`` — the microbatch dim of the ids is split over both
  batch axes; after backward, a leaf's gradient is summed over the batch
  axes it is replicated on (the LN scales and the embedding over both, the
  fsdp-sharded weights over ``data``), so every copy stays identical.

JAX's embedding and loss head run under GSPMD with the vocab split over
``model``; here the embedding is gathered over ``model`` with autograd (its
cotangent is whole on every rank of the group, so backward keeps this
rank's block), and the loss is JAX's mean over the **global** batch: each
rank sums its tokens' negative log-likelihoods over the global count, and
the reported loss is the sum of that over the batch axes.

Parameters are this rank's local shards; :func:`init_params` cuts them
from a canonical draw ([n_layers, ...] per weight, JAX's shapes and
scales from a ``torch.Generator``), :func:`params_from_canonical` from any
canonical tree (JAX's included), and :func:`canonical_params` gathers them
back (collective), the factorization-independent format of JAX's elastic
checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import (all_gather, all_gather_start, copy_to, gather_global,
                          reduce_from)
from .mesh import (AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_PIPE, BATCH_AXES, Mesh, Spec,
                   local_shard)
from .pipeline import deinterleave_stage_params, interleave_stage_params, pipeline_apply

GATHER_MODES = ("eager", "overlap", "amortized")
Params = Dict[str, Any]


@dataclass(frozen=True)
class CompositeConfig:
    vocab_size: int = 256
    d_model: int = 32
    n_heads: int = 4
    d_ff: int = 64
    n_layers: int = 4  # must divide by mesh pipe size * virtual_stages
    seq: int = 16


#: stage-stacked weight specs, JAX's: stage dim on ``pipe``, Megatron
#: column/row splits on ``model``, the remaining large dim on ``fsdp``
PARAM_SPECS: Dict[str, Spec] = {
    "ln1_scale": (AXIS_PIPE, None, None),
    "ln2_scale": (AXIS_PIPE, None, None),
    # [S*V, L, d, 3, d]: the qkv role dim is explicit and unsharded
    "wqkv": (AXIS_PIPE, None, AXIS_FSDP, None, AXIS_MODEL),
    "wo": (AXIS_PIPE, None, AXIS_MODEL, AXIS_FSDP),    # [S*V, L, d/tp, d]
    "w1": (AXIS_PIPE, None, AXIS_FSDP, AXIS_MODEL),    # [S*V, L, d, ff/tp]
    "w2": (AXIS_PIPE, None, AXIS_MODEL, AXIS_FSDP),    # [S*V, L, ff/tp, d]
}
EMBED_SPEC: Spec = (AXIS_MODEL, None)
#: the batch axes each leaf is replicated on (its gradient is summed there)
_GRAD_SUM_AXES = {"ln1_scale": BATCH_AXES, "ln2_scale": BATCH_AXES, "wqkv": AXIS_DATA,
                  "wo": AXIS_DATA, "w1": AXIS_DATA, "w2": AXIS_DATA}
#: the ids' spec [M, mb, seq]: the microbatch dim over the batch axes
IDS_SPEC: Spec = (None, BATCH_AXES, None)


def _chunks(cfg: CompositeConfig, mesh: Mesh, virtual_stages: int) -> Tuple[int, int]:
    pp = mesh.shape[AXIS_PIPE]
    chunks = pp * virtual_stages
    if cfg.n_layers % chunks:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by "
            f"pipe={pp} * virtual_stages={virtual_stages}")
    return chunks, cfg.n_layers // chunks


def canonical_draw(cfg: CompositeConfig, seed: int = 0) -> Params:
    """Canonical per-layer weights with JAX's shapes and scales (normal
    draws times d^-1/2, w2 times ff^-1/2, LN scales 1), from one
    ``torch.Generator`` on the CPU."""
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    gen = torch.Generator().manual_seed(int(seed))
    scale = d ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    stages = {
        "ln1_scale": torch.ones(nl, d),
        "ln2_scale": torch.ones(nl, d),
        "wqkv": normal(nl, d, 3, d) * scale,
        "wo": normal(nl, d, d) * scale,
        "w1": normal(nl, d, ff) * scale,
        "w2": normal(nl, ff, d) * (ff ** -0.5),
    }
    return {"embed": normal(cfg.vocab_size, d) * scale, "stages": stages}


def params_from_canonical(canon: Params, cfg: CompositeConfig, mesh: Mesh, *,
                          virtual_stages: int = 1) -> Params:
    """Canonical per-layer arrays (tensors or numpy, JAX's
    ``canonical_params`` included) -> this rank's shards for THIS mesh:
    chunked [chunks, lpc, ...], interleaved for V > 1, cut by the specs."""
    chunks, lpc = _chunks(cfg, mesh, virtual_stages)
    stages = {}
    for k, v in canon["stages"].items():
        t = torch.as_tensor(np.asarray(v, dtype=np.float32))
        stages[k] = t.reshape((chunks, lpc) + tuple(t.shape[1:]))
    if virtual_stages > 1:
        stages = interleave_stage_params(stages, mesh.shape[AXIS_PIPE], virtual_stages)
    embed = torch.as_tensor(np.asarray(canon["embed"], dtype=np.float32))
    return {"embed": local_shard(embed, mesh, EMBED_SPEC).contiguous().to(mesh.device),
            "stages": {k: local_shard(v, mesh, PARAM_SPECS[k]).contiguous().to(mesh.device)
                       for k, v in stages.items()}}


def init_params(cfg: CompositeConfig, mesh: Mesh, *, seed: int = 0,
                virtual_stages: int = 1) -> Params:
    """This rank's shards of the canonical draw at ``seed``: the same
    logical model on every (pp, V) factorization."""
    return params_from_canonical(canonical_draw(cfg, seed), cfg, mesh,
                                 virtual_stages=virtual_stages)


def canonical_params(params: Params, mesh: Mesh, *, virtual_stages: int = 1) -> Params:
    """This rank's shards -> canonical per-layer numpy arrays (collective:
    every rank gathers, every rank returns them). Inverse of
    :func:`params_from_canonical`."""
    stages = {k: gather_global(v, mesh, PARAM_SPECS[k]).cpu() for k, v in
              params["stages"].items()}
    if virtual_stages > 1:
        stages = deinterleave_stage_params(stages, mesh.shape[AXIS_PIPE], virtual_stages)
    stages = {k: v.reshape((-1,) + tuple(v.shape[2:])).numpy() for k, v in stages.items()}
    embed = gather_global(params["embed"], mesh, EMBED_SPEC).cpu().numpy()
    return {"embed": embed, "stages": stages}


def local_ids(ids, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of global ids [M, mb, seq] (JAX's ``batch_sharding``)."""
    return torch.as_tensor(np.asarray(local_shard(np.asarray(ids), mesh, IDS_SPEC)),
                           dtype=torch.long, device=mesh.device)


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def _block(cfg: CompositeConfig, mesh: Mesh, h, ln1, ln2, wqkv, wo, w1, w2):
    """One transformer block, weights whole over fsdp (still tp-local):
    Megatron column/row splits, *f* before each and *g* after."""
    group = mesh.group(AXIS_MODEL)
    x = copy_to(_ln(h, ln1), group)
    qkv = torch.einsum("bsd,drh->bsrh", x, wqkv)       # [mb, s, 3, d/tp]
    dl = qkv.shape[-1]
    hd = cfg.d_model // cfg.n_heads
    nh = dl // hd
    mb, s = qkv.shape[:2]
    q, k, v = (qkv[:, :, i].reshape(mb, s, nh, hd).transpose(1, 2) for i in range(3))
    scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=h.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    attn = torch.softmax(scores, dim=-1) @ v            # [mb, nh, s, hd]
    attn = attn.transpose(1, 2).reshape(mb, s, dl)
    h = h + reduce_from(attn @ wo, group)
    x = copy_to(_ln(h, ln2), group)
    return h + reduce_from(F.gelu(x @ w1, approximate="tanh") @ w2, group)


#: per-layer weight -> its fsdp-sharded dim in a layer slice [..]
_LAYER_AXES = {"wqkv": 0, "wo": 1, "w1": 0, "w2": 1}
_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def _stage_fn(cfg: CompositeConfig, mesh: Mesh, p: Params, h: torch.Tensor, *,
              gather_mode: str = "eager") -> torch.Tensor:
    """One stage chunk: ``p`` leaves are local [lpc, ...]; ``h`` the local
    microbatch [mb_local, seq, d]. ``"pregathered"`` is the amortized path
    (weights already whole over fsdp)."""
    fsdp = mesh.group(AXIS_FSDP)
    lpc = p["ln1_scale"].shape[0]

    def start(i):
        return [all_gather_start(p[w][i], fsdp, _LAYER_AXES[w]) for w in _WEIGHTS]

    pending = start(0) if gather_mode == "overlap" else None
    for i in range(lpc):
        if gather_mode == "overlap":
            # issue layer i+1's gathers before layer i computes; the last
            # layer prefetches a clamped duplicate that is discarded
            current, pending = pending, start(min(i + 1, lpc - 1))
            ws = [g.wait() for g in current]
        elif gather_mode == "pregathered":
            ws = [p[w][i] for w in _WEIGHTS]
        else:
            ws = [all_gather(p[w][i], fsdp, _LAYER_AXES[w]) for w in _WEIGHTS]
        h = _block(cfg, mesh, h, p["ln1_scale"][i], p["ln2_scale"][i], *ws)
    if pending is not None:
        for g in pending:
            g.wait()
    return h


def _stage_prepare_fn(mesh: Mesh, p: Params) -> Params:
    """Amortized mode: gather every chunk weight once per step (local
    leaves [V, lpc, ...]: the fsdp dims sit one further right)."""
    fsdp = mesh.group(AXIS_FSDP)
    out = dict(p)
    for w in _WEIGHTS:
        out[w] = all_gather(p[w], fsdp, _LAYER_AXES[w] + 2)
    return out


def _sum_grad(g: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    g = g.contiguous()
    dist.all_reduce(g, group=mesh.group(axes))
    return g


def make_train_step(cfg: CompositeConfig, mesh: Mesh, lr: float = 0.1, *,
                    virtual_stages: int = 1, gather_mode: str = "eager",
                    mask_bubbles: bool = True):
    """``step(params, ids_local[M, mb_local, seq]) -> (params, loss)``: one
    SGD step of next-token CE under dp x fsdp x tp x pp. ``params`` are this
    rank's shards (:func:`init_params` with the same ``virtual_stages``);
    ``loss`` is the global mean (a 0-d tensor, equal on every rank)."""
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, got {gather_mode!r}")
    inner_mode = "pregathered" if gather_mode == "amortized" else gather_mode
    prepare = (lambda p: _stage_prepare_fn(mesh, p)) if gather_mode == "amortized" else None
    global_mb_factor = mesh.size(BATCH_AXES)

    def stage(p, hh):
        return _stage_fn(cfg, mesh, p, hh, gather_mode=inner_mode)

    def step(params: Params, ids: torch.Tensor):
        embed = params["embed"].detach().requires_grad_(True)
        stages = {k: v.detach().requires_grad_(True) for k, v in params["stages"].items()}
        embed_full = all_gather(embed, mesh.group(AXIS_MODEL), 0, backward="slice")
        h = embed_full[ids]                                     # [M, mb, s, d]
        h = pipeline_apply(stage, stages, h, mesh, virtual_stages=virtual_stages,
                           mask_bubbles=mask_bubbles, stage_prepare=prepare)
        logits = h @ embed_full.T                               # [M, mb, s, vocab]
        targets = torch.roll(ids, -1, dims=-1)
        logp = torch.log_softmax(logits.float(), dim=-1)
        count = ids.numel() * global_mb_factor
        local = -logp.gather(-1, targets[..., None]).sum() / count
        local.backward()
        new_stages = {k: v.detach() - lr * _sum_grad(v.grad, mesh, _GRAD_SUM_AXES[k])
                      for k, v in stages.items()}
        new_embed = embed.detach() - lr * _sum_grad(embed.grad, mesh, BATCH_AXES)
        loss = _sum_grad(local.detach().clone(), mesh, BATCH_AXES)
        return {"embed": new_embed, "stages": new_stages}, loss

    return step

