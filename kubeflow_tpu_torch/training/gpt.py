"""The GPT training step of the JAX package's bench, in PyTorch.

The port of ``bench.py``'s ``_bench_gpt`` train step: a GPT-2-medium-class
causal LM (d 1024, 24 layers, 16 heads x 64, d_ff 4096, vocab 32000), batch
8, sequence 1024, bf16 compute with f32 parameters, the blockwise fused
loss, and ``optax.adamw(3e-4, weight_decay=0.01)`` — which decays EVERY
parameter (its ``mask`` defaults to None), LayerNorms and the embedding
included, so :func:`make_optimizer` has one parameter group. Attention runs
the flash-attention CUDA kernels (24 forward, 24 dq and 24 dk/dv launches a
step without remat). Token ids are drawn once from numpy with the seed and
the same batch repeats every step, as in the bench.

Run on the card (the default device)::

    python -m kubeflow_tpu_torch.training.gpt --steps 8

or at a tiny size on the CPU, through the kernels' plain versions::

    python -m kubeflow_tpu_torch.training.gpt --steps 3 --tiny --device cpu

Each step prints one JSON line: loss, step ms, tokens/s; the last line
holds the FLOP counts, mfu (on the card), the step breakdown and the peak
device memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..gpu.profiling import StepClock, step_breakdown
from ..models.gpt import (AttentionFn, GptConfig, GptLM, Params, blockwise_causal_lm_loss,
                          causal_flash_attention, causal_lm_loss, init_params)
from ..ops import _build
from ..runtime.tracing import TRACER
from . import flops


#: the bench's batch and sequence length (``bench.py`` ``_run_gpt`` defaults)
BENCH_BATCH, BENCH_SEQ = 8, 1024
#: the ``--tiny`` CPU run's batch and sequence length
TINY_BATCH, TINY_SEQ = 2, 64


def bench_config(seq: int = BENCH_SEQ) -> GptConfig:
    """The bench's GPT config (``bench.py`` ``make_cfg``, scan_blocks on)."""
    return GptConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096, max_seq=seq,
                     vocab_size=32000, scan_blocks=True)


def tiny_config(seq: int = TINY_SEQ) -> GptConfig:
    return GptConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=2, d_ff=128,
                     max_seq=seq)


def make_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """``optax.adamw(3e-4, weight_decay=0.01)``: the same update (decoupled
    decay ``p -= lr * (adam + wd * p)``), on every parameter."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def loss_fn(model: GptLM, ids: torch.Tensor, fused_loss: bool = True) -> torch.Tensor:
    if fused_loss:
        hidden = model(ids, return_hidden=True)
        return blockwise_causal_lm_loss(hidden, model.embedding.weight, ids)
    return causal_lm_loss(model(ids), ids)


def train_step(model: GptLM, opt: torch.optim.Optimizer, ids: torch.Tensor,
               fused_loss: bool = True) -> torch.Tensor:
    """One AdamW step on ``ids``; returns the step's loss (before the
    update), detached and on the model's device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, ids, fused_loss)
    loss.backward()
    opt.step()
    return loss.detach()


def causal_attention_flops(cfg: GptConfig, batch: int, seq: int) -> float:
    """The causal attention dots the flash kernels run — 2 in the forward
    and 5 in the backward, 3.5 x 2 causal dots per layer (``bench.py``
    ``_bench_gpt``)."""
    causal_dot = 2.0 * batch * cfg.n_heads * seq * seq * cfg.head_dim / 2
    return 3.5 * (2 * causal_dot) * cfg.n_layers


def flops_per_step(cfg: GptConfig, n_params: int, batch: int, seq: int) -> float:
    """The bench's analytic FLOP count of one step: 6 N per token, plus
    :func:`causal_attention_flops`."""
    return 6.0 * n_params * batch * seq + causal_attention_flops(cfg, batch, seq)


def counted_flops_per_step(cfg: GptConfig, params: Params, ids: torch.Tensor,
                           attention_fn: AttentionFn = causal_flash_attention) -> float:
    """The step's FLOPs as ``bench.py`` counts them: the reference step
    (the unfused ``causal_lm_loss``, no remat) counted by
    :func:`flops.counted_flops`, forward and backward, on a throwaway copy
    of ``params``, with attention left out of the count — on the card the
    flash kernels are invisible to the counter, and :func:`flops.uncounted`
    hides the CPU's plain attention the same way — then
    :func:`causal_attention_flops` added. AdamW's update adds no products."""
    model = GptLM.trainable(dataclasses.replace(cfg, remat=False), params,
                            attention_fn=flops.uncounted(attention_fn))

    def step():
        causal_lm_loss(model(ids), ids).backward()

    counted = flops.counted_flops(step)
    return counted + causal_attention_flops(cfg, ids.shape[0], ids.shape[1])


def train(cfg: GptConfig, *, batch: int, seq: int, steps: int, seed: int = 0,
          device: DeviceLike = "cuda", attention_fn: AttentionFn = causal_flash_attention,
          on_step: Optional[Callable[[Dict[str, Any]], None]] = None) -> Dict[str, Any]:
    """``steps`` AdamW steps from seeded weights on one seeded batch.

    Each step runs under a :class:`StepClock`: ``compute`` around the step's
    dispatch, ``fetch`` around the read of its loss (which waits for the
    device); the kernels' first-use build is charged to ``compile``. Returns
    the per-step losses and step times, the parameter count, the step's
    counted FLOPs (:func:`counted_flops_per_step`) beside the bench's
    analytic count, ``mfu`` of the median step after the first (on the
    card; None on the CPU, which has no catalog peak), the
    ``step_breakdown`` and ``peak_hbm_bytes`` of the training loop (None on
    the CPU). ``on_step`` gets each step's record."""
    if seq > cfg.max_seq:
        raise ValueError(f"seq {seq} exceeds max_seq {cfg.max_seq}")
    dev = resolve_device(device)
    ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    ids = torch.as_tensor(ids_np, dtype=torch.int64, device=dev)
    params = init_params(cfg, seed=seed, device=dev)
    clock = StepClock(tracer=TRACER)
    if dev.type == "cuda":
        with clock.compile():
            _build.load("flash_attention.cu")
    counted = counted_flops_per_step(cfg, params, ids, attention_fn)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = GptLM.trainable(cfg, params, attention_fn=attention_fn)
    del params
    opt = make_optimizer(model.parameters())
    losses: List[float] = []
    step_ms: List[float] = []
    clock.mark()
    for step in range(steps):
        with clock.compute():
            loss_t = train_step(model, opt, ids)
        with clock.fetch():
            loss = float(loss_t)
        ms = clock.end_step()["total"] * 1e3
        losses.append(loss)
        step_ms.append(ms)
        if on_step is not None:
            on_step({"step": step + 1, "loss": loss, "step_ms": ms,
                     "tokens_per_s": batch * seq / ms * 1e3})
    n_params = sum(p.numel() for p in model.parameters())
    steady_s = float(np.median(step_ms[1:] or step_ms)) / 1e3
    mem = flops.memory_stats(dev)
    return {"losses": losses, "step_ms": step_ms, "n_params": n_params,
            "tokens_per_step": batch * seq, "flops_per_step": counted,
            "analytic_flops_per_step": flops_per_step(cfg, n_params, batch, seq),
            "mfu": (flops.mfu(counted, steady_s, generation=flops.detect_generation(dev))
                    if dev.type == "cuda" else None),
            "step_breakdown": step_breakdown(clock),
            "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help=f"a 2-layer d64 model, batch {TINY_BATCH}, sequence {TINY_SEQ} "
                         "(for --device cpu)")
    args = ap.parse_args(argv)
    if args.tiny:
        cfg, batch, seq = tiny_config(TINY_SEQ), TINY_BATCH, TINY_SEQ
    else:
        cfg, batch, seq = bench_config(BENCH_SEQ), BENCH_BATCH, BENCH_SEQ
    result = train(cfg, batch=batch, seq=seq, steps=args.steps, device=args.device,
                   on_step=lambda r: print(json.dumps(r), flush=True))
    keys = ("n_params", "flops_per_step", "analytic_flops_per_step", "mfu",
            "step_breakdown", "peak_hbm_bytes")
    print(json.dumps({k: result[k] for k in keys}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
