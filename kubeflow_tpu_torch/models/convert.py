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
- a MoE block's ``block_i/moe/{router [d, E], experts_wi [E, d, ff],
  experts_wo [E, ff, d]}`` -> ``block_i.moe.<leaf>``, the same layouts;
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

The inverses carry the port's tensors back into flax trees of f32 numpy
arrays, which the JAX package loads and the port's ``Checkpointer`` saves
under flax's names: ``params_to_flax`` undoes ``params_from_flax`` (and
re-stacks ``block_i`` into ``blocks`` for a ``scan_blocks`` config, JAX's
``stack_block_params``), ``resnet_params_to_flax`` undoes
``resnet_params_from_flax`` for a ``ResNet`` or an ``MnistCNN``. They
refuse as the forward converters do: a tensor the model lacks, one left
unfilled, or a shape that does not fit. BERT's inverse waits for a caller
that saves BERT weights.
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


#: the MoE block's leaves (``block_i/moe/<leaf>``): flax's names and layouts
_MOE_LEAVES = ("router", "experts_wi", "experts_wo")


def _target(path: str, leaf: np.ndarray, cfg: GptConfig) -> Tuple[str, np.ndarray]:
    """(port parameter name, value in the port's layout) of one flax leaf."""
    parts = path.split("/")
    if parts == ["embedding", "embedding"]:
        return "embedding.weight", leaf
    if parts[-1] in ("scale", "bias") and parts[-2] in ("ln_attn", "ln_mlp", "ln_final"):
        return ".".join(parts), leaf
    if len(parts) == 3 and parts[1] == "moe" and parts[2] in _MOE_LEAVES:
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


def _checked(params: Params, expected: Dict[str, Tuple[int, ...]], what: str
             ) -> Iterator[Tuple[str, np.ndarray]]:
    """``params``' (name, f32 numpy value) pairs; a name ``expected`` lacks,
    a shape that does not fit or a name left unfilled raises."""
    missing = sorted(set(expected) - set(params))
    if missing:
        raise ValueError(f"{what}: no tensor for {missing}")
    for name, value in params.items():
        if name not in expected:
            raise ValueError(f"{what}: {name!r} has no counterpart in the flax tree")
        if tuple(value.shape) != tuple(expected[name]):
            raise ValueError(f"{what}: {name!r} shape {tuple(value.shape)} does not fit "
                             f"{tuple(expected[name])}")
        yield name, value.detach().to("cpu", torch.float32).numpy()


def _nest(flat: Iterator[Tuple[str, np.ndarray]]) -> Dict[str, Any]:
    """``a/b/c`` paths as nested dicts."""
    tree: Dict[str, Any] = {}
    for path, value in flat:
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return tree


def _source(name: str, value: np.ndarray, cfg: GptConfig) -> Tuple[str, np.ndarray]:
    """(flax path, value in flax's layout) of one port GPT tensor: the
    inverse of :func:`_target`."""
    parts = name.split(".")
    if name == "embedding.weight":
        return "embedding/embedding", value
    if parts[-1] in ("scale", "bias") and parts[-2] in ("ln_attn", "ln_mlp", "ln_final"):
        return "/".join(parts), value
    if len(parts) == 3 and parts[1] == "moe" and parts[2] in _MOE_LEAVES:
        return "/".join(parts), value
    if parts[-1] == "weight" and len(parts) == 4:
        block, group, proj = parts[:3]
        h, d = cfg.n_heads, cfg.head_dim
        if group == "attention" and proj in ("query", "key", "value"):
            return f"{block}/{group}/{proj}/kernel", value.T.reshape(cfg.d_model, h, d)
        if group == "attention" and proj == "out_proj":
            return f"{block}/{group}/{proj}/kernel", value.T.reshape(h, d, cfg.d_model)
        if group == "mlp" and proj in ("up_proj", "down_proj"):
            return f"{block}/{group}/{proj}/kernel", value.T
    raise ValueError(f"port tensor {name!r} {value.shape} has no counterpart in flax")


def params_to_flax(params: Params, cfg: GptConfig) -> Dict[str, Any]:
    """The port's GPT state dict as the flax parameter tree (nested dicts
    of f32 numpy arrays) that :func:`params_from_flax` reads: per-layer
    ``block_i`` trees, or for ``cfg.scan_blocks`` one ``blocks`` tree with
    a leading layer axis."""
    expected = {k: tuple(v.shape) for k, v in GptLM(cfg, device="meta").state_dict().items()}
    tree = _nest(_source(name, value, cfg)
                 for name, value in _checked(params, expected, "params_to_flax"))
    if not cfg.scan_blocks:
        return tree
    layers = [tree.pop(f"block_{i}") for i in range(cfg.n_layers)]

    def stack(*xs: Any) -> Any:
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    tree["blocks"] = stack(*layers)
    return tree


def resnet_params_to_flax(state: Params, model: torch.nn.Module) -> Dict[str, Any]:
    """``state`` (a state dict of ``model``'s names, e.g.
    ``model.state_dict()``) as the flax variables that
    :func:`resnet_params_from_flax` reads: ``{"params": ...}`` from the
    model's parameters and, when it has buffers (a ResNet's BatchNorm
    statistics), ``"batch_stats"`` from them; nested dicts of f32 numpy
    arrays."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    shapes.update((n, tuple(b.shape)) for n, b in model.named_buffers())
    buffers = {n for n, _ in model.named_buffers()}
    flat = list(_checked(state, shapes, "resnet_params_to_flax"))
    out = {"params": _nest((n.replace(".", "/"), v) for n, v in flat if n not in buffers)}
    if buffers:
        out["batch_stats"] = _nest((n.replace(".", "/"), v) for n, v in flat if n in buffers)
    return out


def gpt_flax_layout(cfg: GptConfig):
    """The ``layout`` that ``parallel.sharding`` needs for a GPT state
    dict: port name -> (flax path, flax shape, per port dim the flax dims
    it is made of), the inverse of :func:`_target`'s reshapes."""
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model

    def layout(name: str, shape: Tuple[int, ...]):
        parts = name.split(".")
        ident = tuple((i,) for i in range(len(shape)))
        if name == "embedding.weight":
            return ("embedding", "embedding"), tuple(shape), ident
        if parts[-1] == "weight" and len(parts) == 4:
            block, group, proj = parts[:3]
            path = (block, group, proj, "kernel")
            if group == "attention" and proj in ("query", "key", "value"):
                return path, (d, h, hd), ((1, 2), (0,))
            if group == "attention" and proj == "out_proj":
                return path, (h, hd, d), ((2,), (0, 1))
            if group == "mlp":
                return path, (shape[1], shape[0]), ((1,), (0,))
        return tuple(parts), tuple(shape), ident

    return layout
