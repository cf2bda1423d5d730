"""GPT train-step decomposition (the transformer flagship's counterpart of
``profile_step``).

The port of ``e2e/gpt_profile.py``. Times each phase of the bench's b8 x
L1024 GPT-2-medium-class step as trained (bf16 compute, f32 parameters,
AdamW, the flash-attention CUDA kernels), each in its own tower:

  block       one transformer block forward + backward (x24 = the body)
  embed_head  embedding + final LayerNorm + tied f32 LM head + the
              unfused cross entropy, forward + backward
  optimizer   the AdamW update alone over the full parameter set

The towers are bounds, not addends: the full step schedules its pieces
together. FLOPs are the JAX probe's formulas (a causal attention dot counts
its lower triangle). Each tower is
:func:`~kubeflow_tpu_torch.e2e.ceiling.timed` over back-to-back calls
(CUDA events after a warm-up call); eager PyTorch needs no anti-hoist
carry.

Run on the card: ``python -m kubeflow_tpu_torch.e2e.gpt_profile [--batch 8]
[--seq 1024] [--steps 20]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.gpt import GptConfig, GptLM, LayerNorm, causal_lm_loss, init_params
from ..training.gpt import bench_config, make_optimizer
from .ceiling import timed


def block_flops(cfg: GptConfig, batch: int, seq: int) -> float:
    """Forward + backward of one block: 3 x (4 attention projections, 2 MLP
    matmuls, the two causal attention dots)."""
    proj = 4 * 2.0 * batch * seq * cfg.d_model * cfg.d_model
    mlp = 2 * 2.0 * batch * seq * cfg.d_model * cfg.d_ff
    attn = 2 * 2.0 * batch * cfg.n_heads * seq * seq * cfg.head_dim / 2  # causal
    return 3.0 * (proj + mlp + attn)


def head_flops(cfg: GptConfig, batch: int, seq: int) -> float:
    """Forward + backward of the tied LM head: 3 x one [b L, d] x [d, V]."""
    return 3.0 * 2.0 * batch * seq * cfg.d_model * cfg.vocab_size


def adamw_gb(n_params: int) -> float:
    """GB an AdamW update moves: parameter, gradient and both moments read,
    and parameter and both moments written, f32 (7 passes)."""
    return round(n_params * 4 * 7 / 1e9, 2)


class EmbedHead(nn.Module):
    """Embedding -> final LayerNorm -> tied f32 LM head (the body left out)."""

    def __init__(self, cfg: GptConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(0)
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        with torch.no_grad():
            self.embedding.weight.copy_(
                torch.randn(cfg.vocab_size, cfg.d_model, generator=g) / cfg.d_model ** 0.5)
        self.ln = LayerNorm(cfg.d_model, device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.ln(self.embedding(ids).to(self.cfg.dtype))  # stand-in body output
        return x @ self.embedding.weight.float().T


def profile(batch: int = 8, seq: int = 1024, steps: int = 20, cfg: Optional[GptConfig] = None,
            device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    dev = resolve_device(device)
    cfg = cfg or bench_config(seq)
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=dev)
    rows: List[Dict[str, Any]] = []

    # -- one transformer block forward + backward ------------------------------
    one = dataclasses.replace(cfg, n_layers=1)
    block = GptLM.trainable(one, init_params(one, seed=0, device=dev)).block_0
    bparams = list(block.parameters())
    x0 = torch.randn(batch, seq, cfg.d_model, generator=g, device=dev).to(cfg.dtype) * 0.1

    def run_block():
        loss = block(x0).float().abs().sum() * 1e-6
        return torch.autograd.grad(loss, bparams)

    dt = timed(run_block, steps, device=dev)
    rows.append({"phase": "block (x1)", "ms": dt * 1e3,
                 "tflops": block_flops(cfg, batch, seq) / dt / 1e12,
                 "x24_ms": dt * cfg.n_layers * 1e3})
    del block, bparams, x0

    # -- embedding + LM head + loss forward + backward ------------------------------
    eh = EmbedHead(cfg, dev)
    ehp = list(eh.parameters())

    def run_eh():
        return torch.autograd.grad(causal_lm_loss(eh(ids), ids), ehp)

    dt = timed(run_eh, steps, device=dev)
    rows.append({"phase": "embed+head+loss", "ms": dt * 1e3,
                 "tflops": head_flops(cfg, batch, seq) / dt / 1e12})
    del eh, ehp

    # -- the optimizer alone ------------------------------------------------------
    model = GptLM.trainable(cfg, init_params(cfg, seed=0, device=dev))
    opt = make_optimizer(model.parameters())
    with torch.no_grad():
        for p in model.parameters():
            p.grad = p * 1e-3
    dt = timed(opt.step, steps, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    rows.append({"phase": "adamw update", "ms": dt * 1e3, "gb_moved": adamw_gb(n_params)})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    rows = profile(args.batch, args.seq, args.steps)
    total = 0.0
    for r in rows:
        extra = f"  (x24 = {r['x24_ms']:.1f} ms)" if "x24_ms" in r else ""
        rate = (f"{r['tflops']:6.1f} TF/s" if "tflops" in r
                else f"{r['gb_moved']} GB/step")
        print(f"{r['phase']:18s} {r['ms']:8.2f} ms  {rate}{extra}", flush=True)
        total += r.get("x24_ms", r["ms"])
    print(f"{'sum (24 blocks + head + opt)':18s} {total:8.2f} ms")
    print(json.dumps({"metric": "gpt_step_profile", "device": torch.cuda.get_device_name(),
                      "batch": args.batch, "seq": args.seq, "rows": rows,
                      "sum_ms": total}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
