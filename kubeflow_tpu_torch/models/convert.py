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
  LayerNorms' ``scale``/``bias``.

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
    expected = {k: v.shape for k, v in
                GptLM(cfg, decode=True, device="meta").state_dict().items()}
    out: Params = {}
    for path, leaf in _leaves(tree):
        name, value = _target(path, leaf, cfg)
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
