"""Image-classification training task (ResNet): the port of
``kubeflow_tpu/training/classifier.py``.

One step is the forward in train mode (which updates the BatchNorm
running statistics in place, as flax's mutable ``batch_stats`` does), the
cross-entropy loss in f32, the backward and the optimizer step. The port
updates the model and the optimizer in place where JAX returns a new
state.

With a ``mesh`` (``parallel.mesh``, one process a device) the task is JAX's
sharded one in the port's manual SPMD:

- the batch is split over :data:`BATCH_AXES`: each rank steps on its local
  batch (:meth:`ClassifierTask.local_batch`, by ``batch_sharding``'s spec),
  and every ``BatchNorm`` reduces its statistics over the batch group, so
  they are the global batch's, as XLA computes them in JAX;
- parameters are this rank's shards by ``parallel.sharding.param_specs``
  under ``rules`` (the flax paths are the port's names); each step gathers
  every sharded leaf with ``collectives.all_gather`` (backward: a
  reduce-scatter) and runs the model through ``torch.func.functional_call``;
  a leaf's gradient is then summed over the batch axes it is replicated
  on, as ``parallel/composite.py`` does (the mesh's other axes must be 1);
- the optimizer is built on the local shards, so its moments shard
  wherever the parameters do (JAX's ZeRO-3 point), and the module's own
  parameters become meta tensors: a rank holds only its shards and each
  step's gathered copies, and a read of ``state.model``'s weights fails
  loudly instead of giving the initial ones;
- the loss is the global batch's mean and ``accuracy`` the global share,
  equal on every rank; :meth:`ClassifierTask.canonical_params` gathers
  whole parameters back (collective), for checkpoints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..models.resnet import set_batch_group
from ..parallel.collectives import all_gather, gather_global
from ..parallel.mesh import BATCH_AXES, Mesh, Spec, batch_spec, local_shard
from ..parallel.sharding import REPLICATED_RULES, LogicalRules, param_specs

Schedule = Callable[[int], float]
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]],
                            Tuple[torch.optim.Optimizer, Schedule]]


@dataclass
class TrainState:
    """The step count (optimizer updates done so far), the model (its
    parameters and, as buffers, its BatchNorm statistics), the optimizer
    (the momentum buffers) and the learning-rate schedule."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    #: with a mesh: this rank's shard of each parameter (what the optimizer
    #: updates) and its spec; None without one
    shards: Optional[Dict[str, torch.nn.Parameter]] = None
    specs: Optional[Dict[str, Spec]] = None

    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics (flax's ``batch_stats``)."""
        return dict(self.model.named_buffers())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       count: Optional[int] = None) -> torch.Tensor:
    """The mean cross-entropy in f32; with ``count``, the sum over
    ``count`` (a local batch's share of the global batch's mean)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])
    return nll.mean() if count is None else nll.sum() / count


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` (``end_value`` 0): linear
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine to 0 over the remaining ``decay_steps - warmup_steps``."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init_value + (peak_value - init_value) * step / warmup_steps
        count = min(step - warmup_steps, cosine_steps)
        return peak_value * 0.5 * (1 + math.cos(math.pi * count / cosine_steps))

    return schedule


def sgd_momentum(params: Iterable[torch.nn.Parameter], lr: float = 0.1,
                 momentum: float = 0.9, weight_decay: float = 1e-4, warmup_steps: int = 0,
                 total_steps: Optional[int] = None) -> Tuple[torch.optim.SGD, Schedule]:
    """The standard ResNet recipe, as ``optax.chain(add_decayed_weights(wd),
    sgd(schedule, momentum, nesterov=True))``: ``torch.optim.SGD`` adds the
    decay to the gradient before the momentum, its first step sets the
    buffer to that gradient (optax's trace from zeros), and Nesterov adds
    ``momentum * buffer``. The schedule is optax's warmup-cosine when
    ``total_steps`` is given, else the constant ``lr``; set each step's lr
    from it before the step (:meth:`ClassifierTask.train_step` does)."""
    if total_steps:
        schedule = warmup_cosine_decay_schedule(0.0, lr, max(warmup_steps, 1), total_steps)
    else:
        schedule = lambda _: lr  # noqa: E731
    opt = torch.optim.SGD(params, lr=schedule(0), momentum=momentum, dampening=0.0,
                          weight_decay=weight_decay, nesterov=True)
    return opt, schedule


def _release_parameters(model: torch.nn.Module) -> None:
    """Each parameter of ``model`` replaced by a meta tensor of its shape
    (``functional_call`` supplies the real ones)."""
    for module in model.modules():
        for name, p in module._parameters.items():
            if p is not None:
                module._parameters[name] = torch.nn.Parameter(
                    p.detach().to("meta"), requires_grad=p.requires_grad)


@dataclass
class ClassifierTask:
    """A ResNet-shaped model (``model(images, train=...)`` gives logits)
    with its optimizer: ``optimizer(params)`` returns ``(optimizer,
    schedule)``, e.g. ``functools.partial(sgd_momentum, lr=0.1,
    total_steps=1000)``. ``mesh`` and ``rules`` place the batch and the
    parameters as JAX's do (see the module docstring); ``mesh=None`` is one
    process on the whole batch."""

    model: torch.nn.Module
    optimizer: OptimizerFactory
    mesh: Optional[Mesh] = None
    rules: LogicalRules = REPLICATED_RULES

    def init(self) -> TrainState:
        """The state at step 0 from the model's parameters (drawn from its
        seed, or loaded). With a mesh, the optimizer gets this rank's shards
        of them, the module's own become meta tensors, and every BatchNorm
        gets the batch group."""
        if self.mesh is None:
            opt, schedule = self.optimizer(self.model.parameters())
            return TrainState(step=0, model=self.model, optimizer=opt, schedule=schedule)
        mesh = self.mesh
        others = {a: n for a, n in mesh.shape.items() if a not in BATCH_AXES and n > 1}
        if others:
            raise ValueError(f"ClassifierTask splits the batch over {BATCH_AXES}; the mesh's "
                             f"other axes must be 1, got {others}")
        whole = {n: p.detach() for n, p in self.model.named_parameters()}
        specs = param_specs(whole, mesh, self.rules)
        shards = {n: torch.nn.Parameter(local_shard(p, mesh, specs[n]).to(
            mesh.device, copy=True, memory_format=torch.contiguous_format))
            for n, p in whole.items()}
        del whole
        _release_parameters(self.model)
        set_batch_group(self.model,
                        mesh.group(BATCH_AXES) if mesh.size(BATCH_AXES) > 1 else None)
        opt, schedule = self.optimizer(list(shards.values()))
        return TrainState(step=0, model=self.model, optimizer=opt, schedule=schedule,
                          shards=shards, specs=specs)

    def batch_sharding(self, extra_dims: int) -> Optional[Spec]:
        """The batch's spec (dim 0 over :data:`BATCH_AXES`), None without a mesh."""
        return None if self.mesh is None else batch_spec(extra_dims)

    def local_batch(self, x) -> torch.Tensor:
        """This rank's slice of a global batch (numpy or tensor), on the
        mesh's device; the whole batch without a mesh."""
        if self.mesh is None:
            return torch.as_tensor(x)
        x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
        local = local_shard(x, self.mesh, self.batch_sharding(x.ndim - 1))
        return torch.as_tensor(local).to(self.mesh.device)

    def _gathered(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Whole parameters from this rank's shards (differentiable)."""
        out = {}
        for name, shard in state.shards.items():
            full = shard
            for dim, axes in enumerate(state.specs[name]):
                if axes is not None:
                    full = all_gather(full, self.mesh.group(axes), dim)
            out[name] = full
        return out

    def _grad_group(self, spec: Spec):
        """The group a leaf's gradient is summed over: the batch axes of
        more than one rank that its spec does not shard it on (None when
        there are none)."""
        used = {a for axes in spec if axes is not None
                for a in ((axes,) if isinstance(axes, str) else axes)}
        free = tuple(a for a in BATCH_AXES if a not in used and self.mesh.shape[a] > 1)
        if not free:
            return None
        return self.mesh.group(free if len(free) > 1 else free[0])

    def train_step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a batch (this rank's local batch with a mesh);
        updates ``state`` in place and returns it with the step's loss and
        accuracy over the global batch (before the update), detached."""
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            logits = state.model(images, train=True)
            loss = cross_entropy_loss(logits, labels)
            loss.backward()
            state.optimizer.step()
            state.step += 1
            accuracy = (logits.detach().argmax(-1) == labels).float().mean()
            return state, {"loss": loss.detach(), "accuracy": accuracy}
        mesh = self.mesh
        count = images.shape[0] * mesh.size(BATCH_AXES)
        logits = functional_call(state.model, self._gathered(state), (images,),
                                 {"train": True})
        local = cross_entropy_loss(logits, labels, count)
        local.backward()
        for name, shard in state.shards.items():
            group = self._grad_group(state.specs[name])
            if group is not None:
                shard.grad = shard.grad.contiguous()
                dist.all_reduce(shard.grad, group=group)
        state.optimizer.step()
        state.step += 1
        stats = torch.stack([local.detach(),
                             (logits.detach().argmax(-1) == labels).sum().float() / count])
        if mesh.size(BATCH_AXES) > 1:
            dist.all_reduce(stats, group=mesh.group(BATCH_AXES))
        return state, {"loss": stats[0], "accuracy": stats[1]}

    def eval_step(self, state: TrainState, images: torch.Tensor) -> torch.Tensor:
        """Logits in eval mode (running statistics, nothing updated); with
        a mesh, of this rank's local images, the parameters gathered once."""
        with torch.no_grad():
            if self.mesh is None:
                return state.model(images, train=False)
            return functional_call(state.model, self.canonical_params(state), (images,),
                                   {"train": False})

    def canonical_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Whole parameters by name, for checkpoints (collective with a
        mesh: every rank gathers, every rank returns them)."""
        if self.mesh is None:
            return {n: p.detach() for n, p in state.model.named_parameters()}
        return {n: gather_global(p, self.mesh, state.specs[n])
                for n, p in state.shards.items()}
