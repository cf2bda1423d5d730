"""Bench-in-the-loop autotuner: the attribution plane closing its own loop.

The port of ``kubeflow_tpu/training/autotune.py``. A two-stage sweep over
knob dicts:

1. **prune**: every candidate is priced with ``price_callable`` (one run of
   its train step on meta tensors: counted FLOPs and bytes, no allocation);
   only the ``keep`` best roofline estimates survive;
2. **measure**: survivors run a handful of real steps; the measured step
   time picks the winner. Rooflines rank, clocks decide.

The ResNet bench sweeps the fused kernel set (``training/resnet.py``
``fused_blocks="auto"``), the GPT bench ``remat`` (``training/gpt.py``
``autotune=True``); both sweep strictly (a candidate that fails to run
raises) and each records
``AutotuneResult.to_row()`` in its result's ``autotune`` field, so a run
documents the configuration that produced it.

``python -m kubeflow_tpu_torch.training.autotune --quick --device cpu`` runs
both sweeps at toy shapes on the CPU (the kernels' plain versions); on the
card (``--device cuda``, the default) the ResNet toy's fused candidate
launches the fused-block kernels.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device, synchronize

#: knob dict -> roofline seconds (may raise; errors are recorded, not fatal)
PriceFn = Callable[[Dict[str, Any]], float]
#: knob dict -> measured seconds per step (may raise)
MeasureFn = Callable[[Dict[str, Any]], float]


@dataclass
class TunedCandidate:
    """One swept config: knobs + what the two stages said about it."""

    knobs: Dict[str, Any]
    est_seconds: Optional[float] = None       # stage-1 roofline price
    measured_seconds: Optional[float] = None  # stage-2 StepClock pick
    pruned: bool = False                      # dropped after pricing
    error: Optional[str] = None               # a stage raised; excluded

    def to_dict(self) -> Dict[str, Any]:
        return {
            "knobs": self.knobs,
            "est_seconds": self.est_seconds,
            "measured_seconds": self.measured_seconds,
            "pruned": self.pruned,
            "error": self.error,
        }


@dataclass
class AutotuneResult:
    """The sweep's verdict + full audit table."""

    family: str                       # "resnet" | "gpt" | ...
    chosen: Dict[str, Any]
    candidates: List[TunedCandidate] = field(default_factory=list)
    quick: bool = False

    def to_row(self) -> Dict[str, Any]:
        """Compact form for a bench result's ``autotune`` field."""
        measured = [c for c in self.candidates if c.measured_seconds is not None]
        return {
            "family": self.family,
            "chosen": self.chosen,
            "swept": len(self.candidates),
            "pruned": sum(1 for c in self.candidates if c.pruned),
            "measured": len(measured),
            "errors": sum(1 for c in self.candidates if c.error),
            "quick": self.quick,
        }

    def to_dict(self) -> Dict[str, Any]:
        d = self.to_row()
        d["candidates"] = [c.to_dict() for c in self.candidates]
        return d

    def render(self) -> str:
        lines = [f"# autotune[{self.family}] chosen: {self.chosen}"]
        for c in self.candidates:
            est = f"{c.est_seconds * 1e3:.3f}ms" if c.est_seconds is not None else "-"
            meas = (f"{c.measured_seconds * 1e3:.3f}ms"
                    if c.measured_seconds is not None else "-")
            tag = "PRUNED" if c.pruned else ("ERROR " + c.error if c.error else "")
            lines.append(f"  {c.knobs}  est={est}  measured={meas}  {tag}")
        return "\n".join(lines)


def sweep(
    family: str,
    candidates: List[Dict[str, Any]],
    *,
    measure: MeasureFn,
    price: Optional[PriceFn] = None,
    keep: int = 2,
    quick: bool = False,
    log: Optional[Callable[[str], None]] = None,
    strict: bool = False,
) -> AutotuneResult:
    """Run the two-stage sweep. With a ``price`` fn, only the ``keep``
    cheapest roofline estimates are measured; without one, every candidate
    is. The winner is the smallest measured step; if every measurement
    fails, the best (un-errored) estimate; if even pricing failed
    everywhere, the first candidate (the caller's default ordering).

    ``strict=True`` (the port's own sweeps) raises a measure error instead
    of recording it: a candidate that does not run is a fault of the
    program, not a slow configuration, and must not leave the sweep to
    the candidates that did. Price errors stay advisory."""
    if not candidates:
        raise ValueError("sweep needs at least one candidate")
    say = log or (lambda s: None)
    table = [TunedCandidate(knobs=dict(k)) for k in candidates]

    if price is not None:
        for c in table:
            try:
                c.est_seconds = float(price(c.knobs))
            except Exception as exc:
                # pricing is advisory, never fatal: an unpriceable candidate
                # is still MEASURED, just never pruned by price and never
                # eligible for the price fallback
                c.error = f"price: {exc}"
        priced = sorted((c for c in table if c.est_seconds is not None),
                        key=lambda c: c.est_seconds)
        for c in priced[max(1, keep):]:
            c.pruned = True
        say(f"autotune[{family}]: priced {len(priced)}/{len(table)}, "
            f"measuring {sum(1 for c in table if not c.pruned)}")

    for c in table:
        if c.pruned:
            continue
        try:
            start = time.perf_counter()
            c.measured_seconds = float(measure(c.knobs))
            say(f"autotune[{family}]: {c.knobs} -> "
                f"{c.measured_seconds * 1e3:.3f} ms/step "
                f"(swept in {time.perf_counter() - start:.1f}s)")
        except Exception as exc:
            if strict:
                raise RuntimeError(f"autotune[{family}]: {c.knobs} failed to run: "
                                   f"{exc}") from exc
            c.error = (f"{c.error}; measure: {exc}" if c.error
                       else f"measure: {exc}")
            say(f"autotune[{family}]: {c.knobs} failed: {exc}")

    measured = [c for c in table if c.measured_seconds is not None]
    if measured:
        chosen = min(measured, key=lambda c: c.measured_seconds).knobs
    else:
        # no measurement survived: the best roofline estimate decides; with
        # no estimates either, the first candidate (the caller's ordering)
        priced_ok = [c for c in table if c.est_seconds is not None]
        chosen = (min(priced_ok, key=lambda c: c.est_seconds).knobs
                  if priced_ok else table[0].knobs)
    return AutotuneResult(family=family, chosen=chosen, candidates=table,
                          quick=quick)


def measure_steps(compiled: Callable[[], Any], steps: int = 3) -> float:
    """Median wall-clock of ``steps`` calls to a zero-arg thunk that runs
    one step and ends in a device synchronize or a read of its result
    (StepClock's compute phase, without the full loop scaffolding)."""
    from ..gpu.profiling import StepClock

    clock = StepClock()
    for _ in range(steps):
        with clock.phase("compute"):
            compiled()
        clock.end_step()
    times = sorted(s.get("compute", 0.0) for s in clock.steps)
    return times[len(times) // 2]


# -- quick mode: toy shapes ---------------------------------------------------


def resnet_quick_candidates() -> List[Dict[str, Any]]:
    return [{"fused_blocks": False}, {"fused_blocks": True}]


def autotune_resnet_quick(steps: int = 2, device: DeviceLike = "cuda") -> AutotuneResult:
    """The ResNet sweep at toy shape (two stages of one bottleneck, 8
    filters, batch 4 of 32 x 32): fused kernel set on/off, priced via the
    unfused model on meta tensors (the counter sees nothing a kernel does,
    the rule of ``flops.counted_flops``), measured with real gradient steps
    on ``device``; on the card the fused candidate launches the fused-block
    kernels."""
    from ..models.resnet import BottleneckBlock, ResNet
    from .attribution import price_callable

    dev = resolve_device(device)
    batch, image = 4, 32
    x = torch.zeros(batch, image, image, 3, device=dev)

    def build(fused: bool, where: DeviceLike) -> ResNet:
        return ResNet([1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                      fused_blocks=fused, seed=0, device=where)

    with torch.device("meta"):
        ref = build(False, "meta").requires_grad_(False)

    def price(knobs: Dict[str, Any]) -> float:
        cost = price_callable(lambda m, a: m(a, train=False), ref, x,
                              name="resnet_quick", kind="model")
        # the fused path saves the inter-op HBM round trips; credit the
        # roofline with the traffic the kernel keeps on chip
        return cost.est_seconds * (0.7 if knobs["fused_blocks"] else 1.0)

    def measure(knobs: Dict[str, Any]) -> float:
        model = build(knobs["fused_blocks"], dev)

        def grad_step() -> None:
            model.zero_grad(set_to_none=True)
            (model(x, train=False) ** 2).mean().backward()
            synchronize(dev)

        grad_step()  # warm-up: first-use builds, cuDNN's choice
        return measure_steps(grad_step, steps=steps)

    return sweep("resnet", resnet_quick_candidates(), measure=measure,
                 price=price, keep=2, quick=True, strict=True)


def gpt_quick_candidates(n_devices: int = 1) -> List[Dict[str, Any]]:
    grid = [
        {"remat": False, "scan_blocks": True},
        {"remat": True, "scan_blocks": True},
        {"remat": False, "scan_blocks": False},
    ]
    if n_devices > 1:
        grid = [dict(g, gather_mode=m) for g in grid
                for m in ("overlap", "eager")]
    return grid


def autotune_gpt_quick(steps: int = 2, device: DeviceLike = "cuda") -> AutotuneResult:
    """The GPT sweep at toy shape (d 32, 2 layers, 2 heads, batch 2 x 32,
    SGD): remat x scan_blocks, priced by the candidate's own train step on
    meta tensors (remat's recompute shows in its FLOPs), measured with real
    steps on ``device``. The measured build is ``GptLM``'s default, the
    causal flash attention (the kernels at head_dim 16 on the card, their
    plain versions on the CPU), as JAX's; the priced build on meta tensors
    takes the plain causal attention, since the kernels do not run there.

    In an initialized ``torch.distributed`` world of more than one rank
    (every rank calls this), the grid is :func:`gpt_quick_candidates` of
    the world size: each row builds the FSDP step
    (``training/fsdp.py``, the same toy widths) in its ``gather_mode`` and
    measures it. As in JAX those rows are not priced (collectives are not
    in a single program's cost): each is recorded as a price error."""
    import torch.distributed as dist

    from ..models.gpt import GptConfig, GptLM, causal_plain_attention, init_params

    dev = resolve_device(device)
    batch, seq = 2, 32
    n_dev = dist.get_world_size() if dist.is_initialized() else 1

    def build(knobs: Dict[str, Any], where: DeviceLike):
        cfg = GptConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64,
                        max_seq=seq, vocab_size=64,
                        remat=bool(knobs.get("remat")),
                        scan_blocks=bool(knobs.get("scan_blocks")))
        if torch.device(where).type == "meta":
            model = GptLM(cfg, device="meta", attention_fn=causal_plain_attention)
        else:
            model = GptLM.trainable(cfg, init_params(cfg, seed=0, device=where))
        ids = torch.zeros(batch, seq, dtype=torch.int64, device=where)
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)

        def step():
            opt.zero_grad(set_to_none=True)
            logp = torch.log_softmax(model(ids).float(), dim=-1)
            tgt = torch.roll(ids, -1, dims=-1)
            loss = -logp.gather(-1, tgt[..., None]).mean()
            loss.backward()
            opt.step()
            return loss.detach()

        return step

    meshes: Dict[str, Any] = {}

    def build_fsdp(knobs: Dict[str, Any]):
        from .fsdp import (FsdpConfig, fsdp_mesh, init_fsdp_params, local_batch,
                           make_fsdp_train_step)

        cfg = FsdpConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, seq=seq, vocab_size=64)
        if "fsdp" not in meshes:  # new_group is collective: once, on every rank
            meshes["fsdp"] = fsdp_mesh(device=dev)
        mesh = meshes["fsdp"]
        params = init_fsdp_params(cfg, mesh)
        ids = local_batch(torch.zeros(max(batch, n_dev), seq, dtype=torch.int64), mesh)
        step = make_fsdp_train_step(cfg, mesh, gather_mode=knobs["gather_mode"])
        return lambda: step(params, ids)

    def price(knobs: Dict[str, Any]) -> float:
        from .attribution import price_callable

        if "gather_mode" in knobs:
            raise ValueError("gather_mode is measured, not priced")
        return price_callable(build(knobs, "meta"), name="gpt_quick", kind="model",
                              train_factor=1.0).est_seconds

    def measure(knobs: Dict[str, Any]) -> float:
        step = build_fsdp(knobs) if "gather_mode" in knobs else build(knobs, dev)
        step()
        synchronize(dev)

        def timed() -> None:
            step()
            synchronize(dev)

        return measure_steps(timed, steps=steps)

    return sweep("gpt", gpt_quick_candidates(n_dev), measure=measure, price=price, keep=2,
                 quick=True, strict=True)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="toy shapes; the autotune smoke path")
    parser.add_argument("--family", choices=("resnet", "gpt", "all"),
                        default="all")
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.quick:
        parser.error("only --quick is wired for standalone runs; the full "
                     "sweeps run inside training/resnet.py (fused_blocks=\"auto\") "
                     "and training/gpt.py (autotune=True)")
    out: Dict[str, Any] = {}
    if args.family in ("resnet", "all"):
        out["resnet"] = autotune_resnet_quick(steps=args.steps, device=args.device).to_dict()
    if args.family in ("gpt", "all"):
        out["gpt"] = autotune_gpt_quick(steps=args.steps, device=args.device).to_dict()
    print(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
