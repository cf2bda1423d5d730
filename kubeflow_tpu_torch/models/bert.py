"""BERT encoder with a masked-LM head: the serving path's encoder model.

The port of ``kubeflow_tpu/models/bert.py``. Parameter names mirror the
flax tree (``encoder.layer_<i>.attention.query``, ``mlp_wi``,
``attention_ln``, ``mlm_head``, ...), so
:func:`kubeflow_tpu_torch.models.convert.bert_params_from_flax` is a rename
plus transposes.

Numerics follow the flax modules: f32 parameters and ``cfg.dtype`` (bf16)
compute; embeddings, dense layers and their biases in ``cfg.dtype``;
LayerNorm with f32 statistics (flax's fast variance, epsilon 1e-12) and
its output in ``cfg.dtype``; tanh-approximated GELU; the MLM head in f32
over ``hidden.float()``. The attention primitive is injectable
(``attention_fn``, default ``full_attention``; ``ops.flash_attention.
auto_attention`` takes the flash kernels on the card) and sees no padding
mask, as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..parallel.ring_attention import full_attention
from .gpt import AttentionFn, LayerNorm, Params, _module_device


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position_embeddings=128)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense/DenseGeneral(dtype=dtype, param_dtype=f32): input, kernel
    and bias cast to ``dtype``; the product rounds to ``dtype`` before the
    bias is added."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class _Norm(LayerNorm):
    """flax ``nn.LayerNorm(dtype=cfg.dtype)``: f32 statistics, output cast."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype, device: DeviceLike):
        super().__init__(d, eps=eps, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).to(self.dtype)


class BertSelfAttention(nn.Module):
    """q/k/v DenseGeneral to [heads, head_dim], ``attention_fn``, and
    ``out_proj`` back to the hidden width."""

    def __init__(self, cfg: BertConfig, attention_fn: AttentionFn, device: DeviceLike):
        super().__init__()
        self.cfg = cfg
        self.attention_fn = attention_fn
        d = cfg.hidden_size
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, L = hidden.shape[:2]
        heads = (b, L, cfg.num_heads, cfg.head_dim)
        q, k, v = (_dense(hidden, p, cfg.dtype).view(heads)
                   for p in (self.query, self.key, self.value))
        ctx = self.attention_fn(q, k, v)  # [b, L, heads, head_dim]
        return _dense(ctx.reshape(b, L, -1), self.out_proj, cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, attention_fn: AttentionFn, device: DeviceLike):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, attention_fn, device)
        self.attention_ln = _Norm(cfg.hidden_size, eps, cfg.dtype, device)
        self.mlp_wi = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.mlp_wo = nn.Linear(cfg.intermediate_size, cfg.hidden_size, device=device)
        self.output_ln = _Norm(cfg.hidden_size, eps, cfg.dtype, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        dtype = self.cfg.dtype
        hidden = self.attention_ln(hidden + self.attention(hidden))
        mlp = F.gelu(_dense(hidden, self.mlp_wi, dtype), approximate="tanh")
        return self.output_ln(hidden + _dense(mlp, self.mlp_wo, dtype))


class BertEncoder(nn.Module):
    """Token ids [b, L] -> contextual embeddings [b, L, hidden]."""

    def __init__(self, cfg: BertConfig, attention_fn: AttentionFn, device: DeviceLike):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embedding = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, d, device=device)
        self.type_embedding = nn.Embedding(cfg.type_vocab_size, d, device=device)
        self.embedding_ln = _Norm(d, cfg.layer_norm_eps, cfg.dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, attention_fn, device))

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)[None, :]
        # flax Embed(dtype=bf16) casts the table before the lookup
        hidden = (self.word_embedding.weight.to(cfg.dtype)[input_ids]
                  + self.position_embedding.weight.to(cfg.dtype)[positions]
                  + self.type_embedding.weight.to(cfg.dtype)[token_type_ids])
        hidden = self.embedding_ln(hidden)
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden)
        return hidden


class BertForMaskedLM(nn.Module):
    """Token ids [b, L] -> MLM logits [b, L, vocab] in f32."""

    def __init__(self, cfg: BertConfig, *, attention_fn: AttentionFn = full_attention,
                 device: DeviceLike = "cuda"):
        super().__init__()
        device = _module_device(device)
        self.cfg = cfg
        d = cfg.hidden_size
        self.encoder = BertEncoder(cfg, attention_fn, device)
        self.mlm_transform = nn.Linear(d, d, device=device)
        self.mlm_ln = _Norm(d, cfg.layer_norm_eps, cfg.dtype, device)
        self.mlm_head = nn.Linear(d, cfg.vocab_size, device=device)

    @classmethod
    def bind(cls, cfg: BertConfig, params: Params, **kw: Any) -> "BertForMaskedLM":
        """A module whose parameters ARE ``params``'s tensors (no copy)."""
        model = cls(cfg, device="meta", **kw)
        model.load_state_dict(params, assign=True)
        return model.requires_grad_(False)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        hidden = self.encoder(input_ids, token_type_ids)
        hidden = F.gelu(_dense(hidden, self.mlm_transform, cfg.dtype), approximate="tanh")
        hidden = self.mlm_ln(hidden)
        # logits in f32 for a stable softmax-xent
        return _dense(hidden.float(), self.mlm_head, torch.float32)


def init_bert_params(cfg: BertConfig, seed: int = 0, device: DeviceLike = "cuda") -> Params:
    """Seeded random weights: normal with std 1/sqrt(fan_in) for every
    kernel and embedding table, biases 0, LayerNorm scale 1. Drawn on the
    CPU from one ``torch.Generator``, so a seed gives the same weights on
    every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    shapes = BertForMaskedLM(cfg, device="meta").state_dict()
    params: Params = {}
    for name in sorted(shapes):
        shape = shapes[name].shape
        if name.endswith(".scale"):
            t = torch.ones(shape)
        elif name.endswith(".bias"):
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[-1])
        params[name] = t.to(dev)
    return params
