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

Like the bench, the command line first sweeps ``remat`` (priced on meta
tensors, the cheaper measured) and trains with the choice;
``--no-autotune`` pins the config's. Each step prints one JSON
line: loss, step ms, tokens/s; the last line holds the FLOP counts, mfu
(on the card), the step breakdown, the peak device memory, the
``autotune`` row and the ``attribution`` row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize
from ..gpu.profiling import StepClock, step_breakdown
from ..models.gpt import (AttentionFn, GptConfig, GptLM, Params, blockwise_causal_lm_loss,
                          causal_flash_attention, causal_lm_loss, causal_plain_attention,
                          init_params)
from ..ops import _build
from ..runtime.tracing import TRACER
from . import flops
from .attribution import (attribute_gpt, attribution_row, loop_generation, price_callable,
                          record_step_peak_hbm)
from .autotune import sweep


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


Observer = Callable[[str, Dict[str, Any]], None]


def sweep_candidates() -> List[Dict[str, Any]]:
    """``bench.py`` ``_bench_gpt``'s grid with its ``scan_blocks`` axis
    collapsed: ``remat`` off and on. In the port the Python loop over the
    blocks is the scan either way (``models/gpt.py``), so the scan
    candidates would time one program twice; the config's ``scan_blocks``
    stays."""
    return [{"remat": False}, {"remat": True}]


def price_step(cfg: GptConfig, batch: int, seq: int, generation: str = "h100") -> float:
    """Roofline seconds of one train step of ``cfg`` (forward, backward and
    AdamW), run once on meta tensors by ``attribution.price_callable``
    (``train_factor=1``) with the plain causal attention, whose dots the
    counter sees; remat's recomputed forward shows in its FLOPs."""
    model = GptLM(cfg, device="meta", attention_fn=causal_plain_attention)
    opt = make_optimizer(model.parameters())
    ids = torch.empty(batch, seq, dtype=torch.int64, device="meta")
    return price_callable(lambda: train_step(model, opt, ids), name="gpt_bench",
                          kind="model", generation=generation,
                          train_factor=1.0).est_seconds


def sweep_knobs(cfg: GptConfig, params: Params, ids: torch.Tensor, *, calib_steps: int,
                attention_fn: AttentionFn = causal_flash_attention,
                generation: str = "h100", observe: Optional[Observer] = None):
    """``bench.py``'s GPT autotune: every candidate of
    :func:`sweep_candidates` priced by :func:`price_step`, all but the
    dearest measured (bench.py keeps 2 of its 3; here 1 of 2), each on a
    fresh copy of ``params``: one warm-up step, then ``calib_steps`` timed
    steps ended by a read of the last loss. Strict: a measured candidate
    that fails to run raises.
    ``observe("candidate", {"knobs", "steps", "seconds"})`` follows each
    measured candidate. Returns the :class:`AutotuneResult`."""
    batch, seq = ids.shape

    def price(knobs: Dict[str, Any]) -> float:
        return price_step(dataclasses.replace(cfg, **knobs), batch, seq, generation)

    def measure(knobs: Dict[str, Any]) -> float:
        model = GptLM.trainable(dataclasses.replace(cfg, **knobs), params,
                                attention_fn=attention_fn)
        opt = make_optimizer(model.parameters())
        float(train_step(model, opt, ids))  # warm-up
        t0 = time.perf_counter()
        for _ in range(calib_steps):
            loss = train_step(model, opt, ids)
        float(loss)
        seconds = (time.perf_counter() - t0) / calib_steps
        if observe is not None:
            observe("candidate", {"knobs": dict(knobs), "steps": calib_steps + 1,
                                  "seconds": seconds})
        return seconds

    cands = sweep_candidates()
    return sweep("gpt", cands, measure=measure, price=price, keep=len(cands) - 1,
                 strict=True)


def train(cfg: GptConfig, *, batch: int, seq: int, steps: int, seed: int = 0,
          device: DeviceLike = "cuda", attention_fn: AttentionFn = causal_flash_attention,
          autotune: bool = False,
          on_step: Optional[Callable[[Dict[str, Any]], None]] = None,
          observe: Optional[Observer] = None,
          clock: Optional[StepClock] = None) -> Dict[str, Any]:
    """``steps`` AdamW steps from seeded weights on one seeded batch.

    ``autotune=True`` first runs :func:`sweep_knobs` at ``calib_steps =
    max(2, min(4, steps))`` and trains with the chosen ``remat``, as
    ``bench.py`` does; otherwise the config's are pinned (the ``autotune``
    row says so).

    Each step runs under a :class:`StepClock`: ``compute`` around the step
    and a device synchronize (``bench.py``'s ``block_until_ready``),
    ``fetch`` around the host read of its loss; the kernels' first-use
    build is charged to ``compile``. Returns the per-step losses and step
    times, the parameter count, the step's counted FLOPs
    (:func:`counted_flops_per_step`) beside the bench's analytic count,
    ``mfu`` of the median step after the first (on the card; None on the
    CPU, which has no catalog peak), the ``step_breakdown``,
    ``peak_hbm_bytes`` of the training loop (None on the CPU; also
    published as ``training_step_peak_hbm_bytes``), the ``autotune`` row
    and the ``attribution`` row (``attribute_gpt`` over the clock; the
    price and the row use :func:`attribution.loop_generation`).
    ``on_step`` gets each step's record; ``observe`` each swept
    candidate's and then ``("sweep", {"result": AutotuneResult})``.
    ``clock``, if given, is the loop's clock (to register at
    ``/debug/profile`` or read after)."""
    if seq > cfg.max_seq:
        raise ValueError(f"seq {seq} exceeds max_seq {cfg.max_seq}")
    dev = resolve_device(device)
    gen = loop_generation(dev)
    ids_np = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))
    ids = torch.as_tensor(ids_np, dtype=torch.int64, device=dev)
    params = init_params(cfg, seed=seed, device=dev)
    clock = clock if clock is not None else StepClock(tracer=TRACER)
    if dev.type == "cuda":
        with clock.compile():
            _build.load("flash_attention.cu")
    if autotune:
        result = sweep_knobs(cfg, params, ids, calib_steps=max(2, min(4, steps)),
                             attention_fn=attention_fn, generation=gen,
                             observe=observe)
        cfg = dataclasses.replace(cfg, **result.chosen)
        autotune_row = result.to_row()
        if observe is not None:
            observe("sweep", {"result": result})
    else:
        autotune_row = {"family": "gpt",
                        "chosen": {"remat": cfg.remat},
                        "pinned": "config"}
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
            synchronize(dev)
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
    record_step_peak_hbm(mem)
    out = {"losses": losses, "step_ms": step_ms, "n_params": n_params,
           "tokens_per_step": batch * seq, "flops_per_step": counted,
           "analytic_flops_per_step": flops_per_step(cfg, n_params, batch, seq),
           "mfu": flops.mfu(counted, steady_s, generation=gen) if dev.type == "cuda" else None,
           "step_breakdown": step_breakdown(clock),
           "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
           "scan_blocks": cfg.scan_blocks, "remat": cfg.remat, "autotune": autotune_row}
    out["attribution"] = attribution_row(
        lambda: attribute_gpt(cfg, batch=batch, seq=seq, fused_loss=True,
                              generation=gen, device=dev),
        clock, generation=gen, device=dev)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help=f"a 2-layer d64 model, batch {TINY_BATCH}, sequence {TINY_SEQ} "
                         "(for --device cpu)")
    ap.add_argument("--no-autotune", dest="autotune", action="store_false",
                    help="pin the config's remat (default: sweep it first, as "
                         "bench.py does)")
    args = ap.parse_args(argv)
    if args.tiny:
        cfg, batch, seq = tiny_config(TINY_SEQ), TINY_BATCH, TINY_SEQ
    else:
        cfg, batch, seq = bench_config(BENCH_SEQ), BENCH_BATCH, BENCH_SEQ
    result = train(cfg, batch=batch, seq=seq, steps=args.steps, device=args.device,
                   autotune=args.autotune,
                   on_step=lambda r: print(json.dumps(r), flush=True))
    keys = ("n_params", "flops_per_step", "analytic_flops_per_step", "mfu",
            "step_breakdown", "peak_hbm_bytes", "scan_blocks", "remat", "autotune",
            "attribution")
    print(json.dumps({k: result[k] for k in keys}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
