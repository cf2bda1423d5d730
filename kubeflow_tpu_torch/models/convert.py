"""Carry the JAX package's GPT parameters into the port's ``GptLM``.

``params_from_flax`` takes the flax parameter tree as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's state dict (f32 CPU tensors; move them with ``.to(device)``):

- ``embedding/embedding [V, d]`` -> ``embedding.weight``;
- ``block_i/attention/{query,key,value}/kernel [d, H, D]`` ->
  ``block_i.attention.{query,key,value}.weight [H*D, d]``;
- ``block_i/attention/out_proj/kernel [H, D, d]`` ->
  ``block_i.attention.out_proj.weight [d, H*D]``;
- ``block_i/mlp/{up_proj,down_proj}/kernel [in, out]`` ->
  ``Linear.weight [out, in]``;
- ``{block_i/ln_attn, block_i/ln_mlp, ln_final}/{scale, bias}`` -> the
  LayerNorms' ``scale``/``bias``;
- the ``scan_blocks`` layout, ``blocks/...`` with a leading layer axis
  (``stack_block_params``), is unstacked into ``block_0 .. block_{n-1}``.

A flax gradient tree has the parameter tree's structure, so the same call
carries ``jax.grad``'s output into the port's names and layouts.

``resnet_params_from_flax`` does the same for a flax ResNet's variables
(parameters and BatchNorm statistics) and a port ``ResNet``.

``bert_params_from_flax`` carries a flax ``BertForMaskedLM`` tree into the
port's ``models/bert.py``: the same names with ``/`` as ``.``; Embed
``embedding`` -> ``weight``; Dense ``kernel [in, out]`` -> ``weight [out,
in]``; the attention's DenseGeneral kernels ``query/key/value [hidden,
heads, head_dim]`` and ``out_proj [heads, head_dim, hidden]`` flattened to
``[hidden, hidden]`` and transposed, their ``[heads, head_dim]`` biases
flattened.

Any flax leaf left unused, or any port parameter left unfilled, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .bert import BertConfig, BertForMaskedLM
from .gpt import GptConfig, GptLM, Params


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, np.asarray(tree)


def _unstacked(tree: Any) -> Iterator[Tuple[str, np.ndarray]]:
    """The leaves of ``tree`` with each ``blocks/<rest>`` leaf [n, ...]
    split into ``block_<i>/<rest>`` leaves."""
    for path, leaf in _leaves(tree):
        head, _, rest = path.partition("/")
        if head == "blocks" and rest:
            for i in range(leaf.shape[0]):
                yield f"block_{i}/{rest}", leaf[i]
        else:
            yield path, leaf


def _target(path: str, leaf: np.ndarray, cfg: GptConfig) -> Tuple[str, np.ndarray]:
    """(port parameter name, value in the port's layout) of one flax leaf."""
    parts = path.split("/")
    if parts == ["embedding", "embedding"]:
        return "embedding.weight", leaf
    if parts[-1] in ("scale", "bias") and parts[-2] in ("ln_attn", "ln_mlp", "ln_final"):
        return ".".join(parts), leaf
    if parts[-1] == "kernel" and len(parts) == 4:
        block, group, proj = parts[:3]
        hd = cfg.n_heads * cfg.head_dim
        if group == "attention" and proj in ("query", "key", "value"):
            return f"{block}.{group}.{proj}.weight", leaf.reshape(cfg.d_model, hd).T
        if group == "attention" and proj == "out_proj":
            return f"{block}.{group}.{proj}.weight", leaf.reshape(hd, cfg.d_model).T
        if group == "mlp" and proj in ("up_proj", "down_proj"):
            return f"{block}.{group}.{proj}.weight", leaf.T
    raise ValueError(f"flax leaf {path!r} {leaf.shape} has no counterpart in the port")


def _fill(model: torch.nn.Module, cfg: Any,
          targets: Iterator[Tuple[str, str, np.ndarray]]) -> Params:
    """``model``'s state dict (f32 CPU tensors) from (flax path, port name,
    value) triples; a name ``model`` lacks, a shape that does not fit, a
    name filled twice or one left unfilled raises."""
    expected = {k: v.shape for k, v in model.state_dict().items()}
    out: Params = {}
    for path, name, value in targets:
        if name in out:
            raise ValueError(f"flax leaf {path!r} fills {name!r} twice")
        if name not in expected:
            raise ValueError(f"flax leaf {path!r} maps to {name!r}, which "
                             f"{cfg} does not have")
        if tuple(value.shape) != tuple(expected[name]):
            raise ValueError(f"flax leaf {path!r}: shape {value.shape} does not "
                             f"fit {name!r} {tuple(expected[name])}")
        out[name] = torch.tensor(np.asarray(value, dtype=np.float32))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"flax tree is missing parameters for {missing}")
    return out


def params_from_flax(tree: Dict[str, Any], cfg: GptConfig) -> Params:
    return _fill(GptLM(cfg, device="meta"), cfg,
                 ((path, *_target(path, leaf, cfg)) for path, leaf in _unstacked(tree)))


def resnet_params_from_flax(variables: Dict[str, Any], model: torch.nn.Module) -> Params:
    """Carry a flax ResNet's ``{"params", "batch_stats"}`` tree (nested
    dicts of numpy arrays) into ``model``'s state dict: the port keeps
    flax's names and layouts, so ``a/b/kernel`` becomes ``a.b.kernel``
    (HWIO kernels, ``[in, out]`` dense kernels) and ``batch_stats``'
    ``a/b/mean``, ``a/b/var`` fill the buffers ``a.b.mean``, ``a.b.var``.

    A tree without ``batch_stats`` (a flax gradient tree wrapped as
    ``{"params": grads}``) fills the parameters only. Returns f32 CPU
    tensors; any leaf left unused or tensor left unfilled raises."""
    unknown = sorted(set(variables) - {"params", "batch_stats"})
    if unknown or "params" not in variables:
        raise ValueError(f"expected a 'params' and optionally a 'batch_stats' "
                         f"collection, got {sorted(variables)}")
    expected = {n: p.shape for n, p in model.named_parameters()}
    if "batch_stats" in variables:
        expected.update((n, b.shape) for n, b in model.named_buffers())
    out: Params = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            name = path.replace("/", ".")
            if name not in expected:
                raise ValueError(f"flax leaf {collection}/{path} {leaf.shape} has no "
                                 "counterpart in the port's model")
            if tuple(leaf.shape) != tuple(expected[name]):
                raise ValueError(f"flax leaf {collection}/{path}: shape {leaf.shape} does "
                                 f"not fit {name!r} {tuple(expected[name])}")
            out[name] = torch.tensor(np.asarray(leaf, dtype=np.float32))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"flax tree is missing tensors for {missing}")
    return out


def _bert_target(path: str, leaf: np.ndarray, cfg: BertConfig) -> Tuple[str, np.ndarray]:
    """(port parameter name, value in the port's layout) of one flax BERT
    leaf; the shapes are checked by the caller."""
    parts = path.split("/")
    d = cfg.hidden_size
    if parts[-1] == "embedding":
        return ".".join(parts[:-1] + ["weight"]), leaf
    if parts[-1] in ("scale", "bias") and parts[-2].endswith("_ln"):
        return ".".join(parts), leaf
    if parts[-1] in ("kernel", "bias") and len(parts) >= 2:
        name = ".".join(parts[:-1] + ["weight" if parts[-1] == "kernel" else "bias"])
        if parts[-1] == "bias":
            return name, leaf.reshape(-1)
        if len(parts) >= 3 and parts[-3] == "attention" and leaf.ndim == 3:
            return name, leaf.reshape(d, d).T
        return name, leaf.T
    raise ValueError(f"flax leaf {path!r} {leaf.shape} has no counterpart in the port")


def bert_params_from_flax(tree: Dict[str, Any], cfg: BertConfig) -> Params:
    """A flax ``BertForMaskedLM`` parameter tree (nested dicts of numpy
    arrays) as the port's state dict (f32 CPU tensors), refusing as
    :func:`params_from_flax` does."""
    return _fill(BertForMaskedLM(cfg, device="meta"), cfg,
                 ((path, *_bert_target(path, leaf, cfg)) for path, leaf in _leaves(tree)))
