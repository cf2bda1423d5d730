"""Image-classification training task (ResNet): the port of
``kubeflow_tpu/training/classifier.py``.

One step is the forward in train mode (which updates the BatchNorm
running statistics in place, as flax's mutable ``batch_stats`` does), the
cross-entropy loss in f32, the backward and the optimizer step. The port
updates the model and the optimizer in place where JAX returns a new
state. The JAX task's ``mesh`` and ``rules`` arguments (batch and
parameter sharding) are left out; they wait for the second part of the
parallelism slice (ROADMAP A.7b), on ``parallel.sharding.shard_pytree``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

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

    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics (flax's ``batch_stats``)."""
        return dict(self.model.named_buffers())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


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


@dataclass
class ClassifierTask:
    """A ResNet-shaped model (``model(images, train=...)`` gives logits)
    with its optimizer: ``optimizer(params)`` returns ``(optimizer,
    schedule)``, e.g. ``functools.partial(sgd_momentum, lr=0.1,
    total_steps=1000)``."""

    model: torch.nn.Module
    optimizer: OptimizerFactory

    def init(self) -> TrainState:
        """The state at step 0; the model's parameters are its own (drawn
        from its seed, or loaded)."""
        opt, schedule = self.optimizer(self.model.parameters())
        return TrainState(step=0, model=self.model, optimizer=opt, schedule=schedule)

    def train_step(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step on a batch; updates ``state`` in place and returns it
        with the step's loss and accuracy (before the update), detached."""
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(images, train=True)
        loss = cross_entropy_loss(logits, labels)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        accuracy = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    def eval_step(self, state: TrainState, images: torch.Tensor) -> torch.Tensor:
        """Logits in eval mode (running statistics, nothing updated)."""
        with torch.no_grad():
            return state.model(images, train=False)
