"""Plain FSDP (ZeRO-3) GPT train step with overlapped weight gathers.

The port of ``kubeflow_tpu/training/fsdp.py``: one ``fsdp`` mesh axis
shared by the batch and the weight shards, each layer's weights gathered
at use (``parallel.collectives.all_gather``, whose backward is the
gradient reduce-scatter: the ZeRO-3 contract). Modes
(:data:`FSDP_GATHER_MODES`):

- ``"eager"``   — gather each layer's weights right before use;
- ``"overlap"`` — layer i+1's gathers are issued ``async_op=True`` before
  layer i computes (one layer ahead); the last layer prefetches a clamped
  duplicate that is discarded.

Both give the same bits, losses and parameters alike: the same gathered
values feed the same arithmetic, and each layer's gradient is the same
reduce-scatter (``tests/test_torch_fsdp.py``, and on the card
``chip_smoke.py`` ``dist1``).

JAX's embedding and loss head run under GSPMD with the vocab split over
``fsdp``; here the embedding is gathered over ``fsdp`` with autograd (a
reduce-scatter back), the LN scales (replicated) have their gradients
summed over the group, and the loss is the mean over the global batch.
Parameters are this rank's shards of a canonical draw (JAX's shapes and
scales from a ``torch.Generator``), or of any canonical tree through
:func:`params_from_canonical` (JAX's ``init_fsdp_params`` gathered).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..parallel.collectives import all_gather, all_gather_start
from ..parallel.composite import _LAYER_AXES, _WEIGHTS, _ln, _sum_grad
from ..parallel.mesh import AXIS_FSDP, Mesh, MeshConfig, Spec, local_shard, make_mesh

FSDP_GATHER_MODES = ("eager", "overlap")
Params = Dict[str, Any]


@dataclass(frozen=True)
class FsdpConfig:
    vocab_size: int = 256
    d_model: int = 32
    n_heads: int = 4
    d_ff: int = 64
    n_layers: int = 4
    seq: int = 16


#: layer-stacked [L, ...] shards, JAX's: the largest non-layer dim over fsdp
BLOCK_SPECS: Dict[str, Spec] = {
    "ln1": (None, None),
    "ln2": (None, None),
    "wqkv": (None, AXIS_FSDP, None, None),   # [L, d, 3, d]
    "wo": (None, None, AXIS_FSDP),           # [L, d, d]
    "w1": (None, AXIS_FSDP, None),           # [L, d, ff]
    "w2": (None, None, AXIS_FSDP),           # [L, ff, d]
}
EMBED_SPEC: Spec = (AXIS_FSDP, None)
BATCH_SPEC: Spec = (AXIS_FSDP, None)


def fsdp_mesh(device: DeviceLike = "cuda") -> Mesh:
    """A single-axis ``fsdp`` mesh over the whole world (collective)."""
    return make_mesh(MeshConfig(data=1, fsdp=-1), device=device)


def canonical_draw(cfg: FsdpConfig, seed: int = 0) -> Params:
    """Whole weights with JAX's shapes and scales, from a ``torch.Generator``."""
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    gen = torch.Generator().manual_seed(int(seed))
    scale = d ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    blocks = {
        "ln1": torch.ones(nl, d),
        "ln2": torch.ones(nl, d),
        "wqkv": normal(nl, d, 3, d) * scale,
        "wo": normal(nl, d, d) * scale,
        "w1": normal(nl, d, ff) * scale,
        "w2": normal(nl, ff, d) * (ff ** -0.5),
    }
    return {"embed": normal(cfg.vocab_size, d) * scale, "blocks": blocks}


def params_from_canonical(canon: Params, mesh: Mesh) -> Params:
    """Whole arrays (tensors or numpy) -> this rank's shards on the mesh's device."""
    def cut(v, spec):
        t = torch.as_tensor(np.asarray(v, dtype=np.float32))
        return local_shard(t, mesh, spec).contiguous().to(mesh.device)

    return {"embed": cut(canon["embed"], EMBED_SPEC),
            "blocks": {k: cut(v, BLOCK_SPECS[k]) for k, v in canon["blocks"].items()}}


def init_fsdp_params(cfg: FsdpConfig, mesh: Mesh, seed: int = 0) -> Params:
    return params_from_canonical(canonical_draw(cfg, seed), mesh)


def local_batch(ids, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of global ids [B, seq] (JAX's ``fsdp_batch_sharding``)."""
    return torch.as_tensor(np.asarray(local_shard(np.asarray(ids), mesh, BATCH_SPEC)),
                           dtype=torch.long, device=mesh.device)


def _block(cfg: FsdpConfig, h, ln1, ln2, wqkv, wo, w1, w2):
    """One pre-LN transformer block, weights whole (no tp axis)."""
    x = _ln(h, ln1)
    qkv = torch.einsum("bsd,drh->bsrh", x, wqkv)           # [b, s, 3, d]
    hd = cfg.d_model // cfg.n_heads
    b, s = qkv.shape[:2]
    q, k, v = (qkv[:, :, i].reshape(b, s, cfg.n_heads, hd).transpose(1, 2) for i in range(3))
    scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=h.device))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    attn = torch.softmax(scores, dim=-1) @ v
    attn = attn.transpose(1, 2).reshape(b, s, cfg.d_model)
    h = h + attn @ wo
    x = _ln(h, ln2)
    return h + F.gelu(x @ w1, approximate="tanh") @ w2


def _stack(cfg: FsdpConfig, mesh: Mesh, p: Params, h: torch.Tensor, gather_mode: str):
    """The layer stack on local shards [L, ...] and the local batch."""
    group = mesh.group(AXIS_FSDP)
    nl = p["ln1"].shape[0]

    def start(i):
        return [all_gather_start(p[w][i], group, _LAYER_AXES[w]) for w in _WEIGHTS]

    pending = start(0) if gather_mode == "overlap" else None
    for i in range(nl):
        if gather_mode == "overlap":
            current, pending = pending, start(min(i + 1, nl - 1))
            ws = [g.wait() for g in current]
        else:
            ws = [all_gather(p[w][i], group, _LAYER_AXES[w]) for w in _WEIGHTS]
        h = _block(cfg, h, p["ln1"][i], p["ln2"][i], *ws)
    if pending is not None:
        for g in pending:  # the discarded clamped prefetch
            g.wait()
    return h


def make_fsdp_train_step(cfg: FsdpConfig, mesh: Mesh, lr: float = 0.1, *,
                         gather_mode: str = "overlap"):
    """``step(params, ids_local[B/n, seq]) -> (params, loss)``: one SGD step
    of next-token CE under plain ZeRO-3; ``loss`` is the global mean, the
    same on every rank."""
    if gather_mode not in FSDP_GATHER_MODES:
        raise ValueError(
            f"gather_mode must be one of {FSDP_GATHER_MODES}, got {gather_mode!r}")
    group = mesh.group(AXIS_FSDP)
    n = mesh.shape[AXIS_FSDP]

    def step(params: Params, ids: torch.Tensor):
        embed = params["embed"].detach().requires_grad_(True)
        blocks = {k: v.detach().requires_grad_(True) for k, v in params["blocks"].items()}
        embed_full = all_gather(embed, group, 0)
        h = _stack(cfg, mesh, blocks, embed_full[ids], gather_mode)
        logits = h @ embed_full.T
        targets = torch.roll(ids, -1, dims=-1)
        logp = torch.log_softmax(logits.float(), dim=-1)
        local = -logp.gather(-1, targets[..., None]).sum() / (ids.numel() * n)
        local.backward()
        new_blocks = {}
        for k, v in blocks.items():
            # a replicated leaf (the LN scales) sums its partial gradients
            g = v.grad if AXIS_FSDP in BLOCK_SPECS[k] else _sum_grad(v.grad, mesh, AXIS_FSDP)
            new_blocks[k] = v.detach() - lr * g
        new = {"embed": embed.detach() - lr * embed.grad, "blocks": new_blocks}
        return new, _sum_grad(local.detach().clone(), mesh, AXIS_FSDP)

    return step
