"""GPT-style decoder-only causal LM: the training forward and the decode
(serving) paths.

The port of ``kubeflow_tpu/models/gpt.py``. Training runs
``GptLM(decode=False)``: rope on q/k at positions ``arange(L)``, attention
through an injectable ``attention_fn`` (default
:func:`causal_flash_attention`, the CUDA flash-attention kernels), optional
per-block ``remat`` (``torch.utils.checkpoint``), and the losses
:func:`causal_lm_loss` and :func:`blockwise_causal_lm_loss`. ``scan_blocks``
is accepted on that path: PyTorch has no ``nn.scan`` to trace, so the
Python loop over the blocks is the scan, and the stacked ``blocks/``
parameter layout is unstacked by
:func:`kubeflow_tpu_torch.models.convert.params_from_flax`.

Serving runs ``GptLM(decode=True)`` in three cache layouts —

- scalar-cursor prefill/decode (one shared cursor; ``generate`` and the
  engine's group prefill), cache ``{"k", "v": [b, max_seq, H, D],
  "cursor": []}``;
- per-slot contiguous (``per_slot=True``), cache ``{"k", "v",
  "cursors": [b]}``: each row sits at its own position;
- paged (``per_slot=True, paged=True``), cache ``{"k_arena", "v_arena":
  [N, block_t, H, D], "cursors": [b]}`` plus ``"k_scale"/"v_scale"
  [N, block_t, H, 1]`` when ``kv_dtype="int8"``, addressed through a
  ``[b, MB]`` block table passed to each call.

A cache is a dict ``{"block_<i>": {"attention": {...}}}`` in the JAX
package's naming (``_fresh_cache``); ``GptLM.forward`` updates it IN PLACE
(KV rows and cursors), where the flax module returned a new collection.

A config with ``num_experts > 0`` gives every block a
``parallel.moe.MoEMlp`` (``moe``) in place of its MLP, routed over every
row of each call, as JAX's ``GptBlock``.

Numerics follow the JAX module step by step: bf16 embedding output and
residual stream, LayerNorm in f32 (flax's epsilon 1e-6 and fast variance),
bf16 dense layers from f32 parameters, tanh-approximated GELU, rotate-half
rope with f32 angles, f32 attention scores and softmax with a -1e30 mask,
and the tied LM head in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import NEG_BIG, flash_attention, flash_attention_plain

Cache = Dict[str, Dict[str, Dict[str, torch.Tensor]]]
Params = Dict[str, torch.Tensor]
AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 32000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = False
    num_experts: int = 0
    moe_k: int = 2
    scan_blocks: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls) -> "GptConfig":
        return cls(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=128)

    @classmethod
    def small(cls) -> "GptConfig":
        return cls(d_model=768, n_layers=12, n_heads=12, d_ff=3072)  # ~GPT-2 124M

    @classmethod
    def base(cls) -> "GptConfig":
        return cls(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)  # ~GPT-2 medium


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half layout. x: [b, L, heads, head_dim];
    positions: [L] (shared across the batch) or [b, L] (per row)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.to(torch.float32)[..., None] * freqs  # [..., L, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if positions.dim() == 1:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # [b, L, half] -> broadcast over heads
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _module_device(device: DeviceLike) -> DeviceLike:
    """The port's device policy for a module's parameters: ``"meta"`` passes
    through (shapes only), anything else goes through ``resolve_device``."""
    return device if torch.device(device).type == "meta" else resolve_device(device)


def causal_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """The training forward's default ``attention_fn``: causal flash
    attention on [b, L, heads, head_dim]."""
    return flash_attention(q, k, v, causal=True)


def causal_plain_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """The same function through the plain PyTorch versions on any device:
    the comparator the kernels' training path is held against."""
    return flash_attention_plain(q, k, v, causal=True)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 statistics with the fast
    variance ``E[x^2] - E[x]^2`` and epsilon 1e-6; parameters ``scale`` and
    ``bias`` as flax names them."""

    def __init__(self, d: int, eps: float = 1e-6, device: DeviceLike = "cuda"):
        super().__init__()
        device = _module_device(device)
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dtype, param_dtype=f32): inputs and the f32 kernel
    both cast to ``dtype`` before the product."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class GptAttention(nn.Module):
    """Training attention (``decode=False``: ``attention_fn`` over the whole
    sequence) or decode attention against a KV cache; see the module
    docstring for the three cache layouts. ``kv_kernel`` (default on)
    routes single-token per-slot writes through the CUDA kernels, whose
    wrappers run their plain versions on CPU tensors; ``kv_kernel=False``
    takes the plain PyTorch writes on any device, the comparator the
    kernels are held against."""

    def __init__(self, cfg: GptConfig, *, attention_fn: AttentionFn = causal_flash_attention,
                 decode: bool = False, per_slot: bool = False, kv_kernel: bool = True,
                 paged: bool = False, kv_dtype: str = "bf16",
                 device: DeviceLike = "cuda"):
        super().__init__()
        device = _module_device(device)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: expected bf16|int8")
        if kv_dtype == "int8" and not paged:
            raise ValueError("int8 KV cache requires the paged arena layout")
        if paged and not per_slot:
            raise ValueError("paged KV decode requires per_slot=True")
        self.cfg = cfg
        self.attention_fn = attention_fn
        self.decode = decode
        self.per_slot = per_slot
        self.paged = paged
        self.quant = kv_dtype == "int8"
        self.use_kernel = bool(kv_kernel)
        d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
        self.query = nn.Linear(d, hd, bias=False, device=device)
        self.key = nn.Linear(d, hd, bias=False, device=device)
        self.value = nn.Linear(d, hd, bias=False, device=device)
        self.out_proj = nn.Linear(hd, d, bias=False, device=device)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        b, L = x.shape[:2]
        heads = (b, L, cfg.n_heads, cfg.head_dim)
        q = rope(_dense(x, self.query, cfg.dtype).view(heads), positions, cfg.rope_theta)
        k = rope(_dense(x, self.key, cfg.dtype).view(heads), positions, cfg.rope_theta)
        v = _dense(x, self.value, cfg.dtype).view(heads)
        return q, k, v

    def forward(self, x: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None,
                block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, L = x.shape[:2]
        if not self.decode:
            q, k, v = self._qkv(x, torch.arange(L, device=x.device))
            ctx = self.attention_fn(q, k, v)  # [b, L, heads, head_dim]
            return _dense(ctx.reshape(b, L, -1), self.out_proj, self.cfg.dtype)
        if self.paged:
            keys, values, mask, q = self._paged_write_and_read(x, cache, block_tables)
        else:
            keys, values, mask, q = self._contiguous_write(x, cache)
        scale = self.cfg.head_dim ** -0.5
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) * scale
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, values.float())
        return _dense(ctx.to(self.cfg.dtype).reshape(b, L, -1), self.out_proj,
                      self.cfg.dtype)

    def _contiguous_write(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
        """Write this segment's K/V into the [b, max_seq] cache at the
        cursor(s) and advance them; returns (keys, values, mask, q)."""
        from ..ops.kv_cache import kv_row_update_pair, kv_row_update_plain

        cfg = self.cfg
        b, L = x.shape[:2]
        T = cfg.max_seq
        keys, values = cache["k"], cache["v"]
        steps = torch.arange(L, device=x.device)
        if self.per_slot:
            start = cache["cursors"]                                 # [b]
            seg_positions = start.long()[:, None] + steps            # [b, L]
            q, k, v = self._qkv(x, seg_positions)
            if L == 1:
                # kernel: one launch touches one [H, D] K row and one V row
                # per slot; plain: the same write as one gather/where/scatter
                # per array (cursors past the end write back what they read —
                # the where-select's no-op)
                if self.use_kernel:
                    kv_row_update_pair(keys, values, k[:, 0], v[:, 0], start)
                else:
                    kv_row_update_plain(keys, k[:, 0], start)
                    kv_row_update_plain(values, v[:, 0], start)
            else:
                # dynamic_update_slice clamps the start so the slice fits
                pos = start.long().clamp(0, T - L)[:, None] + steps
                rows = torch.arange(b, device=x.device)[:, None]
                keys[rows, pos] = k.to(keys.dtype)
                values[rows, pos] = v.to(values.dtype)
            cache["cursors"] += L
            mask = (torch.arange(T, device=x.device)[None, None, None, :]
                    <= seg_positions[:, None, :, None])              # [b,1,L,T]
        else:
            start = cache["cursor"]                                  # []
            seg_positions = start.long() + steps                     # [L]
            q, k, v = self._qkv(x, seg_positions)
            pos = start.long().clamp(0, T - L) + steps
            keys[:, pos] = k.to(keys.dtype)
            values[:, pos] = v.to(values.dtype)
            cache["cursor"] += L
            mask = (torch.arange(T, device=x.device)[None, None, None, :]
                    <= seg_positions[None, None, :, None])
        return keys, values, mask, q

    def _paged_write_and_read(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                              block_tables: Optional[torch.Tensor]):
        """Per-slot decode against the shared block arena: the write goes
        through the block table (CUDA kernel, or the scatter reference),
        the read gathers ``arena[tables]`` back into a [b, MB*block_t]
        view. When block_t divides max_seq that view has exactly the
        contiguous cache's shape, so the attention that follows matches the
        contiguous path bit for bit. Rows whose entries point at the trash
        block read garbage there, only at positions the mask hides."""
        from ..ops.kv_cache import (kv_block_update_pair, kv_block_update_quant_pair,
                                    kv_block_update_ref, quantize_kv)

        if block_tables is None:
            raise ValueError("paged decode needs block_tables=[b, max_blocks]")
        cfg = self.cfg
        b, L = x.shape[:2]
        max_seq = cfg.max_seq
        start = cache["cursors"]
        seg_positions = start.long()[:, None] + torch.arange(L, device=x.device)
        q, k, v = self._qkv(x, seg_positions)
        k_arena, v_arena = cache["k_arena"], cache["v_arena"]
        single = L == 1 and self.use_kernel
        if self.quant:
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            if single:  # K and V in one launch
                kv_block_update_quant_pair(k_arena, k_scale, v_arena, v_scale, k[:, 0],
                                           v[:, 0], start, block_tables, max_seq=max_seq)
            else:
                for arena, scales, seg in ((k_arena, k_scale, k),
                                           (v_arena, v_scale, v)):
                    sq, ss = quantize_kv(seg)
                    kv_block_update_ref(arena, sq, start, block_tables, max_seq=max_seq)
                    kv_block_update_ref(scales, ss, start, block_tables, max_seq=max_seq)
        elif single:  # K and V in one launch
            kv_block_update_pair(k_arena, v_arena, k[:, 0], v[:, 0], start, block_tables,
                                 max_seq=max_seq)
        else:
            kv_block_update_ref(k_arena, k, start, block_tables, max_seq=max_seq)
            kv_block_update_ref(v_arena, v, start, block_tables, max_seq=max_seq)
        cache["cursors"] += L

        bt = k_arena.shape[1]
        mb = block_tables.shape[1]
        view = (b, mb * bt, cfg.n_heads, cfg.head_dim)
        if self.quant:
            # load-dequantized read: values and scales through the same table
            sview = (b, mb * bt, cfg.n_heads, 1)
            keys = k_arena[block_tables].reshape(view).float() * \
                cache["k_scale"][block_tables].reshape(sview)
            values = v_arena[block_tables].reshape(view).float() * \
                cache["v_scale"][block_tables].reshape(sview)
        else:
            keys = k_arena[block_tables].reshape(view)
            values = v_arena[block_tables].reshape(view)
        mask = (torch.arange(mb * bt, device=x.device)[None, None, None, :]
                <= seg_positions[:, None, :, None])                  # [b,1,L,MB*bt]
        return keys, values, mask, q


class GptMlp(nn.Module):
    def __init__(self, cfg: GptConfig, device: DeviceLike = "cuda"):
        super().__init__()
        device = _module_device(device)
        self.cfg = cfg
        self.up_proj = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.down_proj = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_dense(x, self.up_proj, self.cfg.dtype), approximate="tanh")
        return _dense(h, self.down_proj, self.cfg.dtype)


class GptBlock(nn.Module):
    def __init__(self, cfg: GptConfig, *, device: DeviceLike = "cuda", **attn: Any):
        super().__init__()
        device = _module_device(device)
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.d_model, device=device)
        self.attention = GptAttention(cfg, device=device, **attn)
        self.ln_mlp = LayerNorm(cfg.d_model, device=device)
        if cfg.num_experts > 0:
            from ..parallel.moe import MoEMlp

            # routes every row of the call, padded ones included: capacity
            # drops depend on them, as in JAX
            self.moe = MoEMlp(cfg.num_experts, cfg.d_ff, k=cfg.moe_k, dtype=cfg.dtype,
                              d_model=cfg.d_model, device=device)
        else:
            self.mlp = GptMlp(cfg, device=device)

    def forward(self, x: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None,
                block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.cfg.dtype
        x = x + self.attention(self.ln_attn(x).to(dtype), cache, block_tables)
        ffn = self.moe if self.cfg.num_experts > 0 else self.mlp
        return x + ffn(self.ln_mlp(x).to(dtype))


class GptLM(nn.Module):
    """Decoder-only LM. input_ids [b, L] -> logits [b, L, vocab] (f32). The
    decode modes update ``cache`` in place; the training forward
    (``decode=False``) takes none. The output projection ties to the input
    embedding. Parameter names mirror the flax tree (``block_<i>``,
    ``attention.query``, ``mlp.up_proj``, ``ln_attn.scale``, ...), so
    :func:`kubeflow_tpu_torch.models.convert.params_from_flax` is a rename
    plus transposes."""

    def __init__(self, cfg: GptConfig, *, attention_fn: AttentionFn = causal_flash_attention,
                 decode: bool = False, per_slot: bool = False, kv_kernel: bool = True,
                 paged: bool = False, kv_dtype: str = "bf16",
                 device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.scan_blocks and decode:
            raise ValueError(
                "scan_blocks is a training/forward layout; the decode path "
                "needs per-layer cache naming — decode with scan_blocks=False "
                "(params_from_flax unstacks a blocks/ tree)")
        device = _module_device(device)
        self.cfg = cfg
        self.decode = decode
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", GptBlock(
                cfg, device=device, attention_fn=attention_fn, decode=decode,
                per_slot=per_slot, kv_kernel=kv_kernel, paged=paged, kv_dtype=kv_dtype))
        self.ln_final = LayerNorm(cfg.d_model, device=device)

    @classmethod
    def bind(cls, cfg: GptConfig, params: Params, **mode: Any) -> "GptLM":
        """A module in the given mode whose parameters ARE ``params``'s
        tensors (no copy): several modes — the engine's per-slot step and
        its scalar-cursor prefill — share one set of weights."""
        model = cls(cfg, device="meta", **mode)
        model.load_state_dict(params, assign=True)
        return model.requires_grad_(False)

    @classmethod
    def trainable(cls, cfg: GptConfig, params: Params, **mode: Any) -> "GptLM":
        """A training module (``decode=False``) whose parameters are fresh
        copies of ``params`` that require gradients; ``params`` itself is
        left as it is."""
        model = cls(cfg, device="meta", **mode)
        model.load_state_dict({k: v.detach().clone() for k, v in params.items()},
                              assign=True)
        return model.requires_grad_(True)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Cache] = None, *,
                block_tables: Optional[torch.Tensor] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """Logits [b, L, vocab] in f32, or with ``return_hidden`` the final
        hidden states [b, L, d] in f32 for :func:`blockwise_causal_lm_loss`
        (the logits never materialize)."""
        cfg = self.cfg
        if self.decode != (cache is not None):
            raise ValueError("a decode module takes a cache; the training "
                             "forward (decode=False) takes none")
        x = self.embedding(input_ids).to(cfg.dtype)
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            if self.decode:
                x = block(x, cache[f"block_{i}"]["attention"], block_tables)
            elif cfg.remat and torch.is_grad_enabled():
                # activations of the block are recomputed in backward
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_final(x)
        if return_hidden:
            return x
        # tied LM head in f32 (the final softmax wants full precision)
        return x @ self.embedding.weight.float().T


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy; position t predicts token t+1."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    targets = input_ids[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def _lse_chunk(x: torch.Tensor, w: torch.Tensor, valid: torch.Tensor, m: torch.Tensor,
               s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One vocab chunk of the online logsumexp: running max ``m`` and
    rescaled sum ``s`` over the logits ``x @ w.T`` (padded columns -1e30)."""
    logits = (x @ w.T).masked_fill(~valid[None, :], NEG_BIG)  # [tokens, block]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    return m_new, s


def blockwise_causal_lm_loss(hidden: torch.Tensor, embedding: torch.Tensor,
                             input_ids: torch.Tensor, block_size: int = 4096) -> torch.Tensor:
    """Fused next-token cross entropy over the tied LM head that never
    materializes the [b, L, vocab] f32 logits: ``mean(logsumexp(x W^T) -
    x W[target])`` with the logsumexp accumulated online over vocab chunks
    of ``block_size``. Each chunk runs under ``torch.utils.checkpoint``, so
    backward recomputes its logits instead of saving them; peak residency is
    one [tokens, block_size] chunk.

    ``hidden``: [b, L, d] (``GptLM(...)(ids, return_hidden=True)``);
    ``embedding``: the [vocab, d] tied embedding — gradients flow to both.
    """
    b, seq_len, d = hidden.shape
    vocab = embedding.shape[0]
    x = hidden[:, :-1].reshape(b * (seq_len - 1), d).float()
    targets = input_ids[:, 1:].reshape(-1).long()
    n_blocks = -(-vocab // block_size)
    padded = n_blocks * block_size
    w = F.pad(embedding.float(), (0, 0, 0, padded - vocab))
    valid = torch.arange(padded, device=hidden.device) < vocab
    m = torch.full((x.shape[0],), NEG_BIG, dtype=torch.float32, device=hidden.device)
    s = torch.zeros_like(m)
    for i in range(n_blocks):
        chunk = slice(i * block_size, (i + 1) * block_size)
        m, s = checkpoint(_lse_chunk, x, w[chunk], valid[chunk], m, s, use_reentrant=False)
    lse = m + torch.log(s)
    # target logit via a [tokens, d] gather — never the full logits row
    target_logit = (x * embedding[targets].float()).sum(dim=-1)
    return (lse - target_logit).mean()


def _fan_in(name: str, shape: torch.Size) -> int:
    """A kernel's input width: ``Linear.weight`` [out, in] and the MoE
    experts [E, in, out] read it where their layouts keep it, the router
    [d, E] first."""
    if name.endswith("moe.router"):
        return shape[0]
    if ".moe.experts_" in name:
        return shape[1]
    return shape[-1]


def init_params(cfg: GptConfig, seed: int = 0, device: DeviceLike = "cuda") -> Params:
    """Seeded random weights with flax's default scales: normal with
    std 1/sqrt(fan_in) for every kernel and the embedding, LayerNorm scale
    1 and bias 0. Drawn on the CPU from one ``torch.Generator`` so the same
    seed gives the same weights on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    shapes = GptLM(cfg, device="meta").state_dict()
    params: Params = {}
    for name in sorted(shapes):
        shape = shapes[name].shape
        if name.endswith(".scale"):
            t = torch.ones(shape)
        elif name.endswith(".bias"):
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=gen) / math.sqrt(_fan_in(name, shape))
        params[name] = t.to(dev)
    return params


def _fresh_cache(cfg: GptConfig, batch: int, device: DeviceLike = "cuda") -> Cache:
    """Zeroed scalar-cursor KV cache in the structure ``GptLM(decode=True)``
    reads."""
    dev = resolve_device(device)
    kv_shape = (batch, cfg.max_seq, cfg.n_heads, cfg.head_dim)
    return {
        f"block_{i}": {"attention": {
            "k": torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
            "cursor": torch.zeros((), dtype=torch.int32, device=dev),
        }}
        for i in range(cfg.n_layers)
    }


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax at temperature 0, else a categorical draw by the
    Gumbel-max trick (``argmax(logits / t - log(E))``, E ~ Exp(1)) from
    ``generator``. int32 out."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    noise = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits / temperature - torch.log(noise), dim=-1).to(torch.int32)


@torch.no_grad()
def generate(cfg: GptConfig, params: Params, prompt_ids: Any, max_new_tokens: int,
             generator: Optional[torch.Generator] = None, temperature: float = 0.0,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Static autoregressive decoding with a KV cache: one prefill forward
    over the prompt, then single-token steps in a Python loop. The greedy
    (``temperature=0``) oracle the serving engine is held against.

    Returns [batch, prompt_len + max_new_tokens] token ids (int32).
    """
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    dev = resolve_device(device)
    ids = torch.as_tensor(prompt_ids, dtype=torch.int32).to(dev)
    total = ids.shape[1] + max_new_tokens
    if total > cfg.max_seq:
        raise ValueError(f"prompt+new = {total} exceeds max_seq {cfg.max_seq}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = GptLM.bind(cfg, {k: v.to(dev) for k, v in params.items()}, decode=True)
    cache = _fresh_cache(cfg, ids.shape[0], dev)
    tok = sample_tokens(model(ids, cache)[:, -1], temperature, generator)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        tok = sample_tokens(model(tok[:, None], cache)[:, -1], temperature, generator)
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
