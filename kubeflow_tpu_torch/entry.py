"""Entry points of the port, the counterparts of ``__graft_entry__``.

``entry()`` returns ``(forward, example_args)`` for the flagship model's
eval forward: ``ResNet50(num_classes=1000)`` (the 7x7 stem, unfused
blocks, as in the JAX entry) from seeded weights, on a zero batch of 8
NHWC images. ``forward(images)`` gives the f32 logits [8, 1000].

``dryrun_multichip(n)`` runs one sharded train step of each parallel path
in a world of ``n`` ranks (``parallel.launch.run_world``; one rank a card,
or gloo ranks on the CPU with ``device="cpu"``), as JAX's does over ``n``
devices, at tiny shapes:

1. ResNet-18 (8 filters, 32²) under data x fsdp through
   ``ClassifierTask(mesh, FSDP_RULES)``;
2. BERT-tiny MLM (``BertConfig.tiny()``: 4 heads of 16, in f32) under
   data x seq x model: ``ring_attention`` over ``seq`` as the attention, heads
   and MLP split over ``model`` behind
   ``copy_to``/``reduce_from`` and the word embedding over ``model`` by
   vocab rows, each weight placed by ``TENSOR_PARALLEL_RULES``; its loss
   held to one process's ``BertForMaskedLM`` on the whole batch;
3. a GPipe train step (``pipeline_apply``), held to the stages run in turn;
4. an expert-parallel MoE step with its aux loss, held to the mesh-less
   layer;
5. the composed dp x fsdp x tp x pp step, its canonical checkpoint
   restored through the port's ``Checkpointer`` at another factorization
   (tp folded into dp), whose step must not lose the progress;
6. gpipe / interleaved / overlapped-gather parity of that step, and the
   interleaved schedule's smaller bubble;

then, as JAX's dry run ends, the timed multichip row
(``bench.run_multichip`` over ``n`` ranks in a world of its own) at the
dry run's tiny shapes (:data:`DRYRUN_MULTICHIP`): no ``error``, and
``value``, ``bubble_fraction``, ``comm_bytes_per_step`` and
``scaling_efficiency`` present. Rank 0's summary, with the row under
``"multichip"``, is returned and printed as one line; the row as another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .device import DeviceLike, resolve_device
from .models.resnet import ResNet50


def entry(device: DeviceLike = "cuda", image: int = 224
          ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Tuple[torch.Tensor]]:
    """``image`` below 224 gives a quicker check on the CPU."""
    dev = resolve_device(device)
    model = ResNet50(num_classes=1000, seed=0, device=dev)
    images = torch.zeros((8, image, image, 3), dtype=torch.float32, device=dev)

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(images, train=False)

    return forward, (images,)


def _summed(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """``x`` summed over each named axis of more than one rank."""
    x = x.detach().clone()
    for axis in axes:
        if mesh.shape[axis] > 1:
            dist.all_reduce(x, group=mesh.group(axis))
    return x


def _resnet_phase(n: int, dev: torch.device) -> Dict[str, Any]:
    from .models.resnet import ResNet18
    from .parallel.mesh import MeshConfig, make_mesh
    from .parallel.sharding import FSDP_RULES
    from .training.classifier import ClassifierTask, sgd_momentum

    dp, fsdp = (n // 2, 2) if n % 2 == 0 else (n, 1)
    mesh = make_mesh(MeshConfig(data=dp, fsdp=fsdp), device=dev)
    task = ClassifierTask(ResNet18(num_classes=10, num_filters=8, seed=0, device=dev),
                          lambda p: sgd_momentum(p, lr=0.1, total_steps=10), mesh=mesh,
                          rules=FSDP_RULES)
    batch = dp * fsdp * 2
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    labels = np.arange(batch) % 10
    state = task.init()
    state, metrics = task.train_step(state, task.local_batch(images), task.local_batch(labels))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), "resnet dp/fsdp step produced non-finite loss"
    return {"dp": dp, "fsdp": fsdp, "loss": loss}


#: BERT's weights by logical axes (the port's [out, in] layouts, Megatron's
#: column and row splits); TENSOR_PARALLEL_RULES maps them onto the mesh
_BERT_AXES = {
    "word_embedding.weight": ("vocab", "embed"),
    "attention.query.weight": ("heads", "embed"), "attention.query.bias": ("heads",),
    "attention.key.weight": ("heads", "embed"), "attention.key.bias": ("heads",),
    "attention.value.weight": ("heads", "embed"), "attention.value.bias": ("heads",),
    "attention.out_proj.weight": (None, "heads"),
    "mlp_wi.weight": ("mlp", None), "mlp_wi.bias": ("mlp",),
    "mlp_wo.weight": (None, "mlp"),
}


def _bert_specs(params, mesh) -> Dict[str, Any]:
    from .parallel.sharding import TENSOR_PARALLEL_RULES, _divisible_spec

    specs = {}
    for name, p in params.items():
        key = next((k for k in _BERT_AXES if name.endswith(k)), None)
        axes = _BERT_AXES[key] if key else (None,) * p.dim()
        specs[name] = _divisible_spec(TENSOR_PARALLEL_RULES.spec(axes), tuple(p.shape), mesh)
    return specs


def _tp_bert_logits(cfg, p: Dict[str, torch.Tensor], ids: torch.Tensor, mesh) -> torch.Tensor:
    """The MLM logits of this rank's ids [b, L/seq] from its local weights:
    the vocab-parallel embedding lookup, Megatron's f/g around each split,
    ``ring_attention`` over ``seq``."""
    from .parallel.collectives import copy_to, reduce_from
    from .parallel.mesh import AXIS_MODEL, AXIS_SEQ
    from .parallel.ring_attention import ring_attention

    model = mesh.group(AXIS_MODEL)
    dt, eps = cfg.dtype, cfg.layer_norm_eps
    table = p["encoder.word_embedding.weight"]
    lo = mesh.coordinate(AXIS_MODEL) * table.shape[0]
    mine = (ids >= lo) & (ids < lo + table.shape[0])
    rows = table[torch.where(mine, ids - lo, torch.zeros_like(ids))] * mine[..., None]
    b, length = ids.shape
    positions = mesh.coordinate(AXIS_SEQ) * length + torch.arange(length, device=ids.device)
    hidden = (reduce_from(rows, model) + p["encoder.position_embedding.weight"][positions]
              + p["encoder.type_embedding.weight"][torch.zeros_like(ids)])

    def norm(x, name):
        return F.layer_norm(x.float(), x.shape[-1:], p[f"{name}.scale"], p[f"{name}.bias"],
                            eps).to(dt)

    def dense(x, name):
        return F.linear(x.to(dt), p[f"{name}.weight"].to(dt),
                        None if f"{name}.bias" not in p else p[f"{name}.bias"].to(dt))

    hidden = norm(hidden, "encoder.embedding_ln")
    for i in range(cfg.num_layers):
        pre = f"encoder.layer_{i}"
        x = copy_to(hidden, model)
        q, k, v = (dense(x, f"{pre}.attention.{w}").view(b, length, -1, cfg.head_dim)
                   for w in ("query", "key", "value"))
        ctx = ring_attention(q, k, v, mesh, causal=False)
        attn = reduce_from(F.linear(ctx.reshape(b, length, -1),
                                    p[f"{pre}.attention.out_proj.weight"].to(dt)), model)
        hidden = norm(hidden + attn + p[f"{pre}.attention.out_proj.bias"].to(dt),
                      f"{pre}.attention_ln")
        mlp = F.gelu(dense(copy_to(hidden, model), f"{pre}.mlp_wi"), approximate="tanh")
        mlp = reduce_from(F.linear(mlp, p[f"{pre}.mlp_wo.weight"].to(dt)), model)
        hidden = norm(hidden + mlp + p[f"{pre}.mlp_wo.bias"].to(dt), f"{pre}.output_ln")
    hidden = F.gelu(dense(hidden, "mlm_transform"), approximate="tanh")
    hidden = norm(hidden, "mlm_ln")
    return F.linear(hidden.float(), p["mlm_head.weight"], p["mlm_head.bias"])


def _bert_phase(n: int, dev: torch.device) -> Dict[str, Any]:
    from .models.bert import BertConfig, BertForMaskedLM, init_bert_params
    from .parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, MeshConfig, make_mesh, local_shard

    seq = 2 if n % 2 == 0 else 1
    tp = 2 if n % (2 * seq) == 0 and n // seq % 2 == 0 else 1
    dp = n // (seq * tp)
    mesh = make_mesh(MeshConfig(data=dp, seq=seq, model=tp), device=dev)
    # BERT-tiny as JAX's (4 heads of 16), in f32 so that the loss holds to
    # one process's within 1e-4
    cfg = dataclasses.replace(BertConfig.tiny(), dtype=torch.float32)
    whole = init_bert_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (dp * 2, 32))
    targets = np.roll(ids, 1, axis=-1)  # JAX's synthetic objective, on the whole sequence
    id_spec = ((AXIS_DATA,), AXIS_SEQ)
    specs = _bert_specs(whole, mesh)
    params = {k: torch.nn.Parameter(local_shard(v, mesh, specs[k]).to(dev, copy=True))
              for k, v in whole.items()}
    local_ids = torch.as_tensor(local_shard(ids, mesh, id_spec), device=dev)
    local_targets = torch.as_tensor(local_shard(targets, mesh, id_spec), device=dev)
    opt = torch.optim.Adam(params.values(), lr=1e-3)
    logits = _tp_bert_logits(cfg, params, local_ids, mesh)
    nll = -torch.log_softmax(logits, -1).gather(-1, local_targets[..., None]).sum()
    (nll / ids.size).backward()
    for name, w in params.items():
        # a weight is replicated over data and seq (each holds other tokens);
        # over model only the split ones differ, and their f/g pairs close
        g = w.grad.contiguous()
        for axis in (AXIS_DATA, AXIS_SEQ):
            if mesh.shape[axis] > 1:
                dist.all_reduce(g, group=mesh.group(axis))
        w.grad = g
    opt.step()
    loss = float(_summed(nll / ids.size, mesh, AXIS_DATA, AXIS_SEQ))
    assert np.isfinite(loss), "bert dp/tp/sp step produced non-finite loss"
    # one process's BERT on the whole batch and the same weights
    ref = BertForMaskedLM(cfg, device="cpu")
    ref.load_state_dict(whole)
    with torch.no_grad():
        ref_logits = ref(torch.as_tensor(ids))
    want = float(-torch.log_softmax(ref_logits, -1).gather(
        -1, torch.as_tensor(targets)[..., None]).mean())
    assert abs(loss - want) <= 1e-4 * abs(want), (
        f"bert dp/tp/sp loss {loss} vs one process's {want}")
    return {"dp": dp, "seq": seq, "model": tp, "heads": cfg.num_heads,
            "head_dim": cfg.head_dim, "loss": loss, "one_process_loss": want,
            "model_split": {k: str(v) for k, v in specs.items() if AXIS_MODEL in str(v)}}


def _pipeline_phase(n: int, dev: torch.device) -> Dict[str, Any]:
    from .parallel.mesh import MeshConfig, local_shard, make_mesh
    from .parallel.pipeline import pipeline_apply, stack_stage_params, stage_param_spec

    pp, d = (2 if n % 2 == 0 else 1), 16
    mesh = make_mesh(MeshConfig(data=n // pp, pipe=pp), device=dev)
    gen = torch.Generator().manual_seed(0)
    stages = stack_stage_params([{"w": torch.randn(d, d, generator=gen) * 0.3,
                                  "b": torch.zeros(d)} for _ in range(pp)])
    xs = torch.randn(2 * pp, 2, d, generator=gen)
    local = {k: local_shard(v, mesh, stage_param_spec(v)).to(dev, copy=True)
             .requires_grad_(True) for k, v in stages.items()}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, local, xs.to(dev), mesh)
    loss = ((out - 1.0) ** 2).mean()
    loss.backward()
    loss = float(loss.detach())
    with torch.no_grad():
        for v in local.values():
            v -= 0.1 * v.grad
    h = xs
    for s in range(pp):
        h = stage_fn({k: v[s] for k, v in stages.items()}, h)
    want = float(((h - 1.0) ** 2).mean())
    assert np.isfinite(loss), "pipeline-parallel step produced non-finite loss"
    assert abs(loss - want) <= 1e-5, f"pipeline loss {loss} vs in turn {want}"
    return {"pp": pp, "loss": loss}


def _moe_phase(n: int, dev: torch.device) -> Dict[str, Any]:
    from .parallel.mesh import AXIS_EXPERT, BATCH_AXES, MeshConfig, local_batch, local_shard, \
        make_mesh
    from .parallel.moe import MoEMlp

    ep, d = (2 if n % 2 == 0 else 1), 16
    mesh = make_mesh(MeshConfig(data=n // ep, expert=ep), device=dev)
    torch.manual_seed(0)
    whole = MoEMlp(num_experts=2 * ep, d_ff=32, k=2, dtype=torch.float32, d_model=d,
                   device="cpu")
    layer = MoEMlp(num_experts=2 * ep, d_ff=32, k=2, mesh=mesh, dtype=torch.float32,
                   d_model=d, device=dev)
    state = whole.state_dict()
    layer.load_state_dict({"router": state["router"],
                           "experts_wi": local_shard(state["experts_wi"], mesh, (AXIS_EXPERT,)),
                           "experts_wo": local_shard(state["experts_wo"], mesh, (AXIS_EXPERT,))})
    x = torch.randn(n // ep * 2, 4, d, generator=torch.Generator().manual_seed(1))
    y = layer(local_batch(x, mesh).to(dev))
    count = x.numel()
    loss = (y.float() ** 2).sum() / count + 0.01 * layer.aux_loss / mesh.size(BATCH_AXES)
    loss.backward()
    with torch.no_grad():
        for w in layer.parameters():
            g = w.grad.contiguous()
            dist.all_reduce(g, group=mesh.group(BATCH_AXES))
            w -= 0.1 * g
    total = float(_summed(loss, mesh, "data"))
    with torch.no_grad():
        want_y = whole(x)
        want = float((want_y ** 2).mean() + 0.01 * whole.aux_loss)
    assert np.isfinite(total), "expert-parallel step produced non-finite loss"
    assert abs(total - want) <= 1e-5 * max(1.0, abs(want)), f"moe loss {total} vs {want}"
    return {"ep": ep, "loss": total}


def _factorization(n: int, tp_wanted: int):
    from .parallel.mesh import MeshConfig

    pp = 2 if n % 2 == 0 else 1
    tp = tp_wanted if n % (pp * tp_wanted) == 0 else 1
    fsdp = 2 if n % (pp * tp * 2) == 0 else 1
    return MeshConfig(data=n // (pp * tp * fsdp), fsdp=fsdp, model=tp, pipe=pp)


def _composite_phases(n: int, dev: torch.device, workdir: str) -> Dict[str, Any]:
    from .parallel import composite as comp
    from .parallel.mesh import make_mesh
    from .parallel.pipeline import schedule_stats
    from .training.checkpoint import Checkpointer

    cfg = comp.CompositeConfig(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=4,
                               seq=16)
    cfg_a, cfg_b = _factorization(n, 2), _factorization(n, 1)
    mesh_a, mesh_b = make_mesh(cfg_a, device=dev), make_mesh(cfg_b, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, n, cfg.seq))
    params, l5a = comp.make_train_step(cfg, mesh_a)(comp.init_params(cfg, mesh_a, seed=0),
                                                    comp.local_ids(ids, mesh_a))
    canon = comp.canonical_params(params, mesh_a)
    ckpt_dir = os.path.join(workdir, "dryrun_ckpt")
    if dist.get_rank() == 0:
        Checkpointer(ckpt_dir).save(0, canon)
    dist.barrier()
    restored, _ = Checkpointer(ckpt_dir).restore_numpy()
    params_b = comp.params_from_canonical(restored, cfg, mesh_b)
    _, l5b = comp.make_train_step(cfg, mesh_b)(params_b, comp.local_ids(ids, mesh_b))
    l5a, l5b = float(l5a), float(l5b)
    assert np.isfinite(l5a) and np.isfinite(l5b), "composed 4D step produced non-finite loss"
    assert l5b < l5a + 1e-3, f"restore lost training progress: step-2 loss {l5b} vs {l5a}"
    # phase 6: schedule and gather parity on factorization a
    losses = {}
    for name, (v, mode) in {"gpipe_eager": (1, "eager"), "interleaved_eager": (2, "eager"),
                            "gpipe_overlap": (1, "overlap")}.items():
        if cfg.n_layers % (cfg_a.pipe * v):
            continue
        p6 = comp.init_params(cfg, mesh_a, seed=0, virtual_stages=v)
        step = comp.make_train_step(cfg, mesh_a, virtual_stages=v, gather_mode=mode)
        for _ in range(2):
            p6, loss = step(p6, comp.local_ids(ids, mesh_a))
        losses[name] = float(loss)
    base = losses["gpipe_eager"]
    for name, loss in losses.items():
        assert abs(loss - base) <= 1e-5 * max(1.0, abs(base)), (
            f"phase-6 parity: {name} loss {loss} != gpipe_eager {base}")
    if "interleaved_eager" in losses:
        assert (schedule_stats(4, cfg_a.pipe, 2)["bubble_fraction"]
                < schedule_stats(4, cfg_a.pipe, 1)["bubble_fraction"]), (
            "interleaved schedule did not reduce the bubble fraction")
    return {"a": dataclasses.asdict(cfg_a), "b": dataclasses.asdict(cfg_b), "loss_a": l5a,
            "loss_b": l5b, "parity": losses,
            "max_dloss": max(abs(v - base) for v in losses.values())}


def _dryrun_rank(rank: int, world: int, workdir: str) -> Dict[str, Any]:
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
        else torch.device("cpu")
    out = {"n": world, "device": dev.type, "resnet": _resnet_phase(world, dev),
           "bert": _bert_phase(world, dev), "pipeline": _pipeline_phase(world, dev),
           "moe": _moe_phase(world, dev)}
    out["composite"] = _composite_phases(world, dev, workdir)
    return out


#: the timed row's shapes in the dry run (JAX's ``BENCH_MC_*`` defaults there)
DRYRUN_MULTICHIP = {"d_model": 32, "d_ff": 64, "n_layers": 8, "seq": 32, "vocab": 128,
                    "timed_steps": 3, "repeats": 2}


def check_timed_row(row: Dict[str, Any]) -> Dict[str, Any]:
    """JAX's dry run's assertions on its timed multichip row, raised as
    ``AssertionError`` without ``assert`` so that ``python -O`` keeps them."""
    if row.get("error"):
        raise AssertionError(f"multichip bench failed: {row['error']}")
    for name in ("value", "bubble_fraction", "comm_bytes_per_step", "scaling_efficiency"):
        if row.get(name) is None:
            raise AssertionError(f"multichip row missing {name}")
    return row


def dryrun_multichip_row(n_devices: int, device: DeviceLike = "cuda",
                         timeout: float = 300.0) -> Dict[str, Any]:
    """The dry run's timed multichip row over ``n_devices`` ranks, held by
    :func:`check_timed_row`."""
    from .bench import run_multichip

    return check_timed_row(run_multichip(n_devices, timeout=timeout, device=device,
                                         **DRYRUN_MULTICHIP))


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     timeout: float = 300.0) -> Dict[str, Any]:
    """One sharded train step of each parallel path over ``n_devices``
    ranks (see the module docstring); rank 0's summary, also printed."""
    from .parallel.launch import run_world

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    workdir = tempfile.mkdtemp(prefix="dryrun-")
    try:
        summary = run_world(f"{__package__}.entry:_dryrun_rank", n_devices, workdir,
                            timeout=timeout, device=dev.type)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    summary["multichip"] = dryrun_multichip_row(n_devices, dev, timeout)
    c = summary["composite"]
    print(f"dryrun_multichip OK: {n_devices} ranks ({summary['device']}) | "
          f"resnet dp={summary['resnet']['dp']} fsdp={summary['resnet']['fsdp']} "
          f"loss={summary['resnet']['loss']:.4f} | bert dp={summary['bert']['dp']} "
          f"seq={summary['bert']['seq']} model={summary['bert']['model']} "
          f"loss={summary['bert']['loss']:.4f} | pipeline pp={summary['pipeline']['pp']} "
          f"loss={summary['pipeline']['loss']:.4f} | moe ep={summary['moe']['ep']} "
          f"loss={summary['moe']['loss']:.4f} | composed4d {c['a']} loss={c['loss_a']:.4f} "
          f"-> resharded {c['b']} loss={c['loss_b']:.4f} | schedule/gather parity "
          f"{sorted(c['parity'])} max_dloss={c['max_dloss']:.2e}", flush=True)
    print(json.dumps(summary["multichip"]), flush=True)
    return summary


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
