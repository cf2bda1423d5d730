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

Each step prints one JSON line: loss, step ms, tokens/s.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.gpt import (AttentionFn, GptConfig, GptLM, blockwise_causal_lm_loss,
                          causal_flash_attention, causal_lm_loss, init_params)


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


def flops_per_step(cfg: GptConfig, n_params: int, batch: int, seq: int) -> float:
    """The bench's FLOP count of one step: 6 N per token, plus the causal
    attention dots the flash kernels run — 2 in the forward and 5 in the
    backward, 3.5 x 2 causal dots per layer (``bench.py`` ``_bench_gpt``)."""
    causal_dot = 2.0 * batch * cfg.n_heads * seq * seq * cfg.head_dim / 2
    return 6.0 * n_params * batch * seq + 3.5 * (2 * causal_dot) * cfg.n_layers


def train(cfg: GptConfig, *, batch: int, seq: int, steps: int, seed: int = 0,
          device: DeviceLike = "cuda", attention_fn: AttentionFn = causal_flash_attention,
          on_step: Optional[Callable[[Dict[str, Any]], None]] = None) -> Dict[str, Any]:
    """``steps`` AdamW steps from seeded weights on one seeded batch.

    Returns the per-step losses and host step times (each step ends in a
    read of its loss, which waits for the device), the parameter count and
    the bench's FLOPs per step. ``on_step`` gets each step's record."""
    if seq > cfg.max_seq:
        raise ValueError(f"seq {seq} exceeds max_seq {cfg.max_seq}")
    dev = resolve_device(device)
    ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    ids = torch.as_tensor(ids_np, dtype=torch.int64, device=dev)
    model = GptLM.trainable(cfg, init_params(cfg, seed=seed, device=dev),
                            attention_fn=attention_fn)
    opt = make_optimizer(model.parameters())
    losses: List[float] = []
    step_ms: List[float] = []
    for step in range(steps):
        t0 = time.perf_counter()
        loss = float(train_step(model, opt, ids))
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        step_ms.append(ms)
        if on_step is not None:
            on_step({"step": step + 1, "loss": loss, "step_ms": ms,
                     "tokens_per_s": batch * seq / ms * 1e3})
    n_params = sum(p.numel() for p in model.parameters())
    return {"losses": losses, "step_ms": step_ms, "n_params": n_params,
            "tokens_per_step": batch * seq,
            "flops_per_step": flops_per_step(cfg, n_params, batch, seq)}


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
    print(json.dumps({"n_params": result["n_params"],
                      "flops_per_step": result["flops_per_step"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
