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

Any flax leaf left unused, or any port parameter left unfilled, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

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


def params_from_flax(tree: Dict[str, Any], cfg: GptConfig) -> Params:
    expected = {k: v.shape for k, v in GptLM(cfg, device="meta").state_dict().items()}
    out: Params = {}
    for path, leaf in _unstacked(tree):
        name, value = _target(path, leaf, cfg)
        if name in out:
            raise ValueError(f"flax leaf {path!r} fills {name!r} twice (both "
                             "block_i/ and blocks/ layouts given?)")
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
