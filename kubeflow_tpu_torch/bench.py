"""The benchmark rows of the JAX package's ``bench.py``, on the port.

Five rows, each with ``bench.py``'s keys and metric names (the
generation is the card's: ``resnet50_train_mfu_h100_1chip``):

- :func:`run_resnet` (``_bench`` / ``_run_resnet``): ResNet-50, batch 256
  of 224 x 224, the s2d stem, SGD-momentum; ``fused_blocks="auto"``
  measures the fused kernel set against the unfused model
  (``training/resnet.py`` ``sweep_fused``) and keeps the faster. The
  batch ladder [256, 512, 128, 64, 32] steps down on
  ``torch.OutOfMemoryError`` only.
- :func:`run_gpt` (``_bench_gpt`` / ``_run_gpt``): d 1024, 24 layers,
  batch 8 x 1024, AdamW, bf16 and the flash kernels; ``autotune=True``
  sweeps ``remat`` (``training/gpt.py`` ``sweep_knobs``).
- :func:`run_serving` (``_run_serving``): ``e2e/serving_bench.py``'s four
  passes at their defaults (JAX's), condensed by :func:`serving_row`.
- :func:`run_hpo` (``_run_hpo``): a 16-trial MNIST study, 4 trials at
  once, median stopping on (``hpo/study.py``).
- :func:`run_multichip` (``_bench_multichip`` / ``_run_multichip``): the
  composed dp x fsdp x tp x pp GPT step over one process a device
  (``parallel/launch.py`` ``run_world``), its weak scaling against rank 0
  alone, the schedule's bubble and the analytic comm bytes.

A training row times ``repeats`` windows of ``timed_steps`` steps and
reports the median. A window runs its steps with no synchronize between
them and ends with one device synchronize under ``StepClock.compute`` and
one host read, under ``fetch``, of the last loss and a parameter
checksum. Every window starts from the same initial model and optimizer
state, as JAX's functional ``run_steps(state, ...)`` does: it is restored
from a snapshot outside the clock. One untimed warm-up window comes first.

Where ``bench.py`` reads ``BENCH_*`` environment variables the functions
take keyword arguments with JAX's defaults, and ``python -m
kubeflow_tpu_torch.bench`` takes flags for them. ``vs_baseline`` is None
in every row: ``bench.py``'s 0.60 MFU target is a TPU's and binds nothing
on this card. A row that fails is JAX's error row (``value`` 0.0 and
``error``); it never reruns on the CPU or on a plain kernel.

Run on the card (the default device)::

    python -m kubeflow_tpu_torch.bench [--model resnet|gpt|serving|hpo|multichip|all]

or at tiny sizes on the CPU::

    python -m kubeflow_tpu_torch.bench --device cpu --tiny

Each row prints as one JSON line; ``all`` ends with ``bench.py``'s summary
line and exits 1 when a row carries ``error``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device, synchronize
from .gpu.profiling import StepClock, step_breakdown
from .models.gpt import GptConfig
from .runtime.metrics import METRICS
from .runtime.tracing import TRACER
from .training import flops, gpt, resnet
from .training.attribution import attribution_row, loop_generation, record_step_peak_hbm

Observer = Callable[[str, Dict[str, Any]], None]
Row = Dict[str, Any]

#: ``bench.py``'s batch ladder: 256 first, then down after 512
BATCH_LADDER = (256, 512, 128, 64, 32)


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def _batch_candidates(batch: Optional[int] = None) -> List[int]:
    """``batch`` alone when given (``BENCH_BATCH``), else the ladder."""
    return [int(batch)] if batch else list(BATCH_LADDER)


def _timed_windows(fn, repeats: int):
    """Run ``fn()`` (one fetched-checksum window) ``repeats`` times; return
    (median_seconds, [per-window seconds]). ``fn.check()`` follows each
    window, outside its time: every window's fetched results must be
    finite, since the median may come from any of them."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        fn.check()
    return statistics.median(times), times


class _Snapshot:
    """A model's and its optimizer's state (parameters, buffers, moments),
    to restore every window to."""

    def __init__(self, model: torch.nn.Module, opt: torch.optim.Optimizer) -> None:
        self.model = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.opt = copy.deepcopy(opt.state_dict())

    def restore(self, model: torch.nn.Module, opt: torch.optim.Optimizer) -> None:
        model.load_state_dict(self.model)
        opt.load_state_dict(copy.deepcopy(self.opt))


def _checksum(params) -> torch.Tensor:
    """``sum(p.astype(f32).sum())`` over the parameters, on their device."""
    return torch.stack([p.detach().float().sum() for p in params]).sum()


def _windows(run_window: Callable[[], Any], restore: Callable[[], None], clock: StepClock,
             repeats: int, dev: torch.device, label: str):
    """The untimed warm-up window, then ``repeats`` timed windows of
    ``run_window()`` (which queues a window's steps and returns its last
    loss and the parameter checksum, on the device). The state is restored
    after every window, outside the window's time and the clock. Returns
    (median seconds, per-window seconds, each window's last loss)."""
    def settle() -> None:
        restore()
        synchronize(dev)
        clock.mark()

    loss, checksum = run_window()
    torch.stack([loss.float(), checksum]).tolist()
    settle()
    results: Dict[str, float] = {}
    losses: List[float] = []

    def window() -> None:
        with clock.compute():
            loss, checksum = run_window()
            synchronize(dev)
        with clock.fetch():
            results["loss"], results["checksum"] = torch.stack(
                [loss.float(), checksum]).tolist()
        clock.end_step()

    def check() -> None:
        if not all(math.isfinite(v) for v in results.values()):
            raise RuntimeError(f"non-finite {label} bench result: {results}")
        losses.append(results["loss"])
        settle()

    window.check = check
    total, times = _timed_windows(window, repeats)
    return total, times, losses


# -- ResNet-50 ----------------------------------------------------------------

def _bench_resnet(cfg: resnet.ResNetBenchConfig, *, timed_steps: int = 50, repeats: int = 3,
                  fused_blocks: Union[bool, str] = "auto", autotune: bool = True,
                  attribution: bool = True, seed: int = 0, clock: Optional[StepClock] = None,
                  observe: Optional[Observer] = None, device: DeviceLike = "cuda"
                  ) -> Dict[str, Any]:
    """``bench.py`` ``_bench`` at ``cfg`` (its batch): ``training/resnet.py``
    ``prepare`` (the sweep or the pinned choice, the step's counted FLOPs,
    the model), then the warm-up and the timed windows, then its
    ``finish``. ``fused_blocks="auto"`` with ``autotune`` off takes the
    card's default, the fused blocks, with no ``autotune`` row
    (``BENCH_AUTOTUNE=0``). Returns ``_bench``'s fields, plus
    ``window_losses`` and ``flops_per_step``."""
    dev = resolve_device(device)
    clock = clock if clock is not None else StepClock(tracer=TRACER)
    default = fused_blocks == "auto" and not autotune
    p = resnet.prepare(cfg, steps=timed_steps, clock=clock, seed=seed, device=dev,
                       fused_blocks=(dev.type == "cuda") if default else fused_blocks,
                       observe=observe)
    task, state = p.task, p.state
    snapshot = _Snapshot(p.model, state.optimizer)

    def run_window():
        for _ in range(timed_steps):
            _, metrics = task.train_step(state, p.images, p.labels)
        return metrics["loss"], _checksum(p.model.parameters())

    def restore():
        snapshot.restore(p.model, state.optimizer)
        state.step = 0

    total, window_times, losses = _windows(run_window, restore, clock, repeats, dev, "resnet")
    dt = total / timed_steps
    mem, attr = resnet.finish(p, clock, timed_steps, attribution)
    return {
        "images_per_sec_per_chip": cfg.batch / dt,
        "step_seconds": dt,
        "mfu": flops.mfu(p.flops_per_step, dt, generation=p.generation),
        "window_mfus": [round(flops.mfu(p.flops_per_step, t / timed_steps, 1, p.generation)
                              * 100, 2) for t in window_times],
        "window_losses": losses,
        "generation": p.generation,
        "batch": cfg.batch,
        "flops_per_step": p.flops_per_step,
        "fused_blocks": p.fused,
        "fused_calibration": p.calibration,
        "autotune": None if default else p.autotune,
        "step_breakdown": step_breakdown(clock, timed_steps),
        "peak_hbm_bytes": (mem or {}).get("peak_hbm_bytes"),
        "attribution": attr,
    }


def resnet_row(r: Dict[str, Any], platform: str) -> Row:
    """``bench.py`` ``_run_resnet``'s row from :func:`_bench_resnet`'s result."""
    return {
        "metric": f"resnet50_train_mfu_{r['generation']}_1chip",
        "value": round(r["mfu"] * 100, 2),
        "unit": "percent_mfu",
        "vs_baseline": None,
        "images_per_sec_per_chip": round(r["images_per_sec_per_chip"], 1),
        "batch": r["batch"],
        "window_mfus": r.get("window_mfus"),
        "fused_blocks": r.get("fused_blocks"),
        "fused_calibration": r.get("fused_calibration"),
        "autotune": r.get("autotune"),
        "step_breakdown": r.get("step_breakdown"),
        "peak_hbm_bytes": r.get("peak_hbm_bytes"),
        "attribution": r.get("attribution"),
        "platform": platform,
    }


def run_resnet(*, cfg: Optional[resnet.ResNetBenchConfig] = None, batch: Optional[int] = None,
               timed_steps: int = 50, repeats: int = 3, fused_blocks: Union[bool, str] = "auto",
               autotune: bool = True, attribution: bool = True, seed: int = 0,
               clock: Optional[StepClock] = None, observe: Optional[Observer] = None,
               device: DeviceLike = "cuda") -> Row:
    """The ResNet-50 row. Without ``cfg`` the bench's config runs down the
    batch ladder (or at ``batch``); a ``cfg`` runs at its own batch (or
    ``batch``). Only ``torch.OutOfMemoryError`` steps down the ladder; any
    other error, or the ladder's end, gives the error row. ``observe`` sees
    the sweep's stages, then ``("run", {"result": ...})`` with
    :func:`_bench_resnet`'s result."""
    dev = resolve_device(device)
    if cfg is None:
        cfg, batches = resnet.bench_config(), _batch_candidates(batch)
    else:
        batches = [batch or cfg.batch]
    err = ""
    try:
        for b in batches:
            try:
                r = _bench_resnet(dataclasses.replace(cfg, batch=b), timed_steps=timed_steps,
                                  repeats=repeats, fused_blocks=fused_blocks,
                                  autotune=autotune, attribution=attribution, seed=seed,
                                  clock=clock, observe=observe, device=dev)
            except torch.OutOfMemoryError as e:  # this batch does not fit: try the next
                err = str(e)  # not the exception: its frames would hold the batch's memory
            else:
                if observe is not None:
                    observe("run", {"result": r})
                return resnet_row(r, _platform(dev))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    except Exception as e:
        err = str(e)
    return {"metric": "resnet50_train_mfu", "value": 0.0, "unit": "percent_mfu",
            "vs_baseline": None, "error": err[:200]}


# -- GPT ----------------------------------------------------------------------

def _bench_gpt(cfg: GptConfig, batch: int, seq: int, *, timed_steps: int = 50,
               repeats: int = 3, autotune: bool = True, remat: Optional[bool] = None,
               fused_loss: bool = True, attribution: bool = True, seed: int = 0,
               clock: Optional[StepClock] = None, observe: Optional[Observer] = None,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """``bench.py`` ``_bench_gpt``: ``training/gpt.py`` ``prepare`` (the
    remat sweep unless ``remat`` pins it or ``autotune`` is off, the
    counted FLOPs, the model and AdamW), then the warm-up and the timed
    windows, then its ``finish``. Returns ``_bench_gpt``'s fields, plus
    ``window_losses`` and ``flops_per_step``."""
    dev = resolve_device(device)
    clock = clock if clock is not None else StepClock(tracer=TRACER)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=bool(remat))
    p = gpt.prepare(cfg, batch=batch, seq=seq, steps=timed_steps, clock=clock, seed=seed,
                    device=dev, autotune=autotune and remat is None,
                    pinned="config" if remat is None else f"remat={bool(remat)}",
                    observe=observe)
    model, opt = p.model, p.opt
    snapshot = _Snapshot(model, opt)

    def run_window():
        for _ in range(timed_steps):
            loss = gpt.train_step(model, opt, p.ids, fused_loss)
        return loss, _checksum(model.parameters())

    total, window_times, losses = _windows(run_window, lambda: snapshot.restore(model, opt),
                                           clock, repeats, dev, "gpt")
    dt = total / timed_steps
    mem, attr = gpt.finish(p, clock, timed_steps, fused_loss, attribution)
    return {
        "tokens_per_sec_per_chip": batch * seq / dt,
        "step_seconds": dt,
        "mfu": flops.mfu(p.flops_per_step, dt, generation=p.generation),
        "window_mfus": [round(flops.mfu(p.flops_per_step, t / timed_steps, 1, p.generation)
                              * 100, 2) for t in window_times],
        "window_losses": losses,
        "generation": p.generation,
        "batch": batch,
        "seq": seq,
        "flops_per_step": p.flops_per_step,
        "scan_blocks": p.cfg.scan_blocks,
        "remat": p.cfg.remat,
        "fused_loss": fused_loss,
        "autotune": p.autotune,
        "step_breakdown": step_breakdown(clock, timed_steps),
        "peak_hbm_bytes": (mem or {}).get("peak_hbm_bytes"),
        "attribution": attr,
    }


def gpt_row(r: Dict[str, Any], platform: str) -> Row:
    """``bench.py`` ``_run_gpt``'s row from :func:`_bench_gpt`'s result."""
    return {
        "metric": f"gpt2_medium_train_mfu_{r['generation']}_1chip",
        "value": round(r["mfu"] * 100, 2),
        "unit": "percent_mfu",
        "vs_baseline": None,
        "tokens_per_sec_per_chip": round(r["tokens_per_sec_per_chip"], 1),
        "batch": r["batch"], "seq": r["seq"],
        "window_mfus": r.get("window_mfus"),
        "scan_blocks": r.get("scan_blocks"),
        "remat": r.get("remat"),
        "fused_loss": r.get("fused_loss"),
        "autotune": r.get("autotune"),
        "step_breakdown": r.get("step_breakdown"),
        "peak_hbm_bytes": r.get("peak_hbm_bytes"),
        "attribution": r.get("attribution"),
        "platform": platform,
    }


def run_gpt(*, cfg: Optional[GptConfig] = None, batch: int = gpt.BENCH_BATCH,
            seq: int = gpt.BENCH_SEQ, timed_steps: int = 50, repeats: int = 3,
            autotune: bool = True, remat: Optional[bool] = None, fused_loss: bool = True,
            attribution: bool = True, seed: int = 0, clock: Optional[StepClock] = None,
            observe: Optional[Observer] = None, device: DeviceLike = "cuda") -> Row:
    """The GPT row (``cfg`` defaults to ``training/gpt.py``
    ``bench_config(seq)``); any error gives the error row. ``observe`` as
    :func:`run_resnet`'s."""
    dev = resolve_device(device)
    try:
        r = _bench_gpt(cfg or gpt.bench_config(seq), batch, seq, timed_steps=timed_steps,
                       repeats=repeats, autotune=autotune, remat=remat, fused_loss=fused_loss,
                       attribution=attribution, seed=seed, clock=clock, observe=observe,
                       device=dev)
    except Exception as e:
        return {"metric": "gpt2_medium_train_mfu", "value": 0.0, "unit": "percent_mfu",
                "vs_baseline": None, "error": str(e)[:200]}
    if observe is not None:
        observe("run", {"result": r})
    return gpt_row(r, _platform(dev))


# -- serving ------------------------------------------------------------------

def serving_row(bert: List[Dict[str, Any]], decode: List[Dict[str, Any]],
                cont: Optional[Dict[str, Any]], disagg: Optional[Dict[str, Any]],
                platform: str) -> Row:
    """``bench.py`` ``_run_serving``'s row from the serving probe's four
    passes (``cont`` and ``disagg`` None when skipped): decode tokens/s
    and BERT p50 at batch 8 (the last row without one), the continuous
    pass's TTFT and queue-wait quantiles and accept rate, and the
    disaggregated pass's two headline fields."""
    b8 = next((r for r in bert if r["batch"] == 8), bert[-1])
    d8 = next((r for r in decode if r["batch"] == 8), decode[-1])
    return {
        "metric": "serving_gpt_kv_decode_tokens_per_sec_b8",
        "value": d8["decode_tokens_per_sec"],
        "unit": "tokens_per_sec",
        "vs_baseline": None,
        "bert_http_p50_ms_b8": b8["p50_ms"],
        "bert_http_rows": bert,
        "decode_rows": decode,
        "continuous_batching": cont,
        "ttft_p50": cont.get("ttft_p50") if cont else None,
        "ttft_p99": cont.get("ttft_p99") if cont else None,
        "queue_wait_p99": cont.get("queue_wait_p99") if cont else None,
        "spec_accept_rate": cont.get("spec_accept_rate") if cont else None,
        "disagg": disagg,
        "decode_tok_s_heterogeneous": (
            disagg.get("decode_tok_s_heterogeneous") if disagg else None),
        "kv_handoff_p99_s": disagg.get("kv_handoff_p99_s") if disagg else None,
        "platform": platform,
    }


def run_serving(*, continuous: bool = True, disagg: bool = True,
                depths: Optional[Dict[str, Dict[str, Any]]] = None,
                device: DeviceLike = "cuda") -> Row:
    """The serving row: ``e2e/serving_bench.py``'s ``bench_bert_http``,
    ``bench_gpt_decode``, ``bench_continuous`` and ``bench_disagg`` at
    their defaults (JAX's), then :func:`serving_row`. ``continuous`` /
    ``disagg`` False skip a pass (``BENCH_CONTINUOUS`` / ``BENCH_DISAGG``);
    ``depths`` maps ``"bert"``, ``"decode"``, ``"continuous"`` or
    ``"disagg"`` to keyword arguments of that pass (smaller sizes, a tiny
    config on the CPU)."""
    dev = resolve_device(device)
    kw = depths or {}
    try:
        from .e2e import serving_bench as sb

        bert = sb.bench_bert_http(device=dev, **kw.get("bert", {}))
        decode = sb.bench_gpt_decode(device=dev, **kw.get("decode", {}))
        cont = sb.bench_continuous(device=dev, **kw.get("continuous", {})) if continuous \
            else None
        dis = sb.bench_disagg(device=dev, **kw.get("disagg", {})) if disagg else None
        return serving_row(bert, decode, cont, dis, _platform(dev))
    except Exception as e:
        return {"metric": "serving_gpt_kv_decode_tokens_per_sec_b8", "value": 0.0,
                "unit": "tokens_per_sec", "vs_baseline": None, "error": str(e)[:200]}


# -- HPO ----------------------------------------------------------------------

def run_hpo(*, trials: int = 16, parallel: int = 4, early_stopping: bool = True,
            steps: Optional[int] = None, timeout: float = 900.0,
            device: DeviceLike = "cuda") -> Row:
    """The HPO row: a study of ``trials`` ``mnist_objective`` trials
    (``steps`` a trial: its default 30 when None), ``parallel`` at once,
    with median stopping (``hpo/study.py`` ``run_study``)."""
    dev = resolve_device(device)
    try:
        from .hpo.study import run_study
        from .hpo.trials import mnist_objective

        objective = mnist_objective if steps is None else \
            _with_steps(mnist_objective, steps)
        status = run_study(objective, max_trials=trials, parallel=parallel,
                           early_stopping=early_stopping, timeout=timeout, device=dev)
        return {
            "metric": "hpo_mnist_trials_per_hour",
            "value": status["trialsPerHour"],
            "unit": "trials_per_hour",
            "vs_baseline": None,
            "trials": trials,
            "trials_succeeded": status.get("trialsSucceeded"),
            "trials_pruned": status.get("trialsPruned", 0),
            "elapsed_seconds": status["elapsedSeconds"],
            "best_accuracy": (status.get("currentOptimalTrial") or {})
            .get("observation", {}).get("accuracy"),
            "platform": _platform(dev),
        }
    except Exception as e:
        return {"metric": "hpo_mnist_trials_per_hour", "value": 0.0,
                "unit": "trials_per_hour", "vs_baseline": None, "error": str(e)[:200]}


def _with_steps(objective, steps: int):
    def trial(params, report_fn=None, device="cuda"):
        return objective(params, steps=steps, report_fn=report_fn, device=device)
    return trial


# -- multichip ----------------------------------------------------------------

def _multichip_mesh_sizes(n_devices: int, pp: Optional[int] = None, tp: Optional[int] = None,
                          fsdp: Optional[int] = None) -> Dict[str, int]:
    """Default dp x fsdp x tp x pp factorization for ``n_devices``: peel
    off pipe, model, fsdp as factors of 2 (innermost axes smallest), data
    absorbs the rest. ``pp``, ``tp``, ``fsdp`` override an axis
    (``BENCH_MC_{PP,TP,FSDP}``)."""
    rest = n_devices
    pp = pp or (2 if rest % 2 == 0 else 1)
    rest //= pp
    tp = tp or (2 if rest % 2 == 0 else 1)
    rest //= tp
    fs = fsdp or (2 if rest % 2 == 0 else 1)
    return {"pipe": pp, "model": tp, "fsdp": fs, "data": n_devices // (pp * tp * fs)}


#: ``bench.py`` ``_bench_multichip``'s defaults (its ``BENCH_MC_*``,
#: ``BENCH_PP_VIRTUAL``, ``BENCH_GATHER_MODE``, ``BENCH_REPEATS``); ``d_ff``
#: None is 4 x ``d_model``
MULTICHIP_DEFAULTS: Dict[str, Any] = {
    "d_model": 128, "n_heads": 4, "d_ff": None, "n_layers": 8, "seq": 128, "vocab": 512,
    "num_micro": 8, "microbatch": 8, "virtual_stages": 2, "gather_mode": "overlap",
    "timed_steps": 5, "repeats": 3, "reference": True, "pp": None, "tp": None, "fsdp": None,
}
_MULTICHIP_SETTINGS = "bench_multichip.json"


def _timed_composite(cfg, mesh, virtual_stages: int, gather_mode: str, ids: torch.Tensor,
                     label: str, clock: StepClock, timed_steps: int, repeats: int,
                     dev: torch.device):
    """The first step (its communicators, allocations) under the compile
    clock, then ``repeats`` windows of ``timed_steps`` chained steps, each
    from the same initial shards (the step is functional). Returns (median
    seconds a step, the last loss, the peak memory)."""
    from .parallel import composite

    params0 = composite.init_params(cfg, mesh, seed=0, virtual_stages=virtual_stages)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with clock.compile():
        step = composite.make_train_step(cfg, mesh, virtual_stages=virtual_stages,
                                         gather_mode=gather_mode)
        _, loss = step(params0, ids)
        synchronize(dev)
    mem = flops.memory_stats(dev)
    clock.mark()
    results: Dict[str, float] = {}

    def window() -> None:
        with clock.compute():
            p, loss = params0, None
            for _ in range(timed_steps):
                p, loss = step(p, ids)
            synchronize(dev)
        with clock.fetch():
            results["loss"] = float(loss)
        clock.end_step()

    def check() -> None:
        if not math.isfinite(results.get("loss", float("nan"))):
            raise RuntimeError(f"non-finite {label} bench loss: {results}")

    window.check = check
    total, _ = _timed_windows(window, repeats)
    return total / timed_steps, results["loss"], mem


def _multichip_rank(rank: int, world: int, workdir: str) -> Optional[Dict[str, Any]]:
    """One rank of :func:`_bench_multichip`'s world: the timed composite
    step at the settings file's settings and its weak-scaling reference;
    rank 0 returns ``_bench_multichip``'s fields."""
    from .parallel import composite
    from .parallel.comm import composite_comm_bytes, composite_step_flops
    from .parallel.mesh import MeshConfig, make_mesh
    from .parallel.pipeline import schedule_stats

    with open(os.path.join(workdir, _MULTICHIP_SETTINGS)) as f:
        s = json.load(f)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    sizes = _multichip_mesh_sizes(world, s["pp"], s["tp"], s["fsdp"])
    d_model = s["d_model"]
    cfg = composite.CompositeConfig(vocab_size=s["vocab"], d_model=d_model,
                                    n_heads=s["n_heads"], d_ff=s["d_ff"] or 4 * d_model,
                                    n_layers=s["n_layers"], seq=s["seq"])
    num_micro, mb = s["num_micro"], s["microbatch"]
    virtual_stages, gather_mode = s["virtual_stages"], s["gather_mode"]
    timed_steps, repeats = s["timed_steps"], s["repeats"]
    if cfg.n_layers % (sizes["pipe"] * virtual_stages):
        virtual_stages = 1  # odd factorization: fall back to GPipe
    mesh = make_mesh(MeshConfig(**sizes), device=dev)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (num_micro, mb, cfg.seq))
    clock = StepClock(metrics=METRICS.namespace("multichip"), tracer=TRACER)
    dt, loss, mem = _timed_composite(cfg, mesh, virtual_stages, gather_mode,
                                     composite.local_ids(ids, mesh), "multichip", clock,
                                     timed_steps, repeats, dev)
    tokens_per_step = num_micro * mb * cfg.seq
    tok_per_chip = tokens_per_step / dt / world

    # weak-scaling reference: rank 0 alone, the same per-chip token load
    # (mb / world), the whole model, no pipeline
    scaling_efficiency = tok_1chip = None
    mb1 = max(1, mb // world)
    if s["reference"]:
        mesh1 = make_mesh(MeshConfig(), devices=[0], device=dev)  # collective
        if mesh1 is not None:
            ids1 = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                     (num_micro, mb1, cfg.seq))
            clock_ref = StepClock(metrics=METRICS.namespace("multichip_ref"), tracer=TRACER,
                                  span_name="bench.1chip_ref")
            dt1, _, _ = _timed_composite(cfg, mesh1, 1, "eager",
                                         composite.local_ids(ids1, mesh1), "1chip",
                                         clock_ref, timed_steps, repeats, dev)
            tok_1chip = num_micro * mb1 * cfg.seq / dt1
            scaling_efficiency = tok_per_chip / tok_1chip
        dist.barrier()
    if rank != 0:
        return None

    stats = schedule_stats(num_micro, sizes["pipe"], virtual_stages)
    stats_gpipe = schedule_stats(num_micro, sizes["pipe"], 1)
    comm = composite_comm_bytes(cfg, mesh, num_micro, mb, virtual_stages=virtual_stages,
                                gather_mode=gather_mode)
    clock.note("tokens_per_sec_per_chip", tok_per_chip)
    clock.note("bubble_fraction", stats["bubble_fraction"])
    if scaling_efficiency is not None:
        clock.note("scaling_efficiency", scaling_efficiency)
    for axis, b in comm.items():
        clock.note(f"comm_bytes_{axis}", b)
    gen = loop_generation(dev)
    record_step_peak_hbm(mem, metrics=METRICS.namespace("multichip"))
    # fractions only: the composite's stages are no modules to walk, but
    # the step's decomposition rides along
    attr = attribution_row(lambda: [], clock, timed_steps, generation=gen, device=dev)
    return {
        "tokens_per_sec_per_chip": tok_per_chip,
        "tokens_per_sec_1chip": tok_1chip,
        "scaling_efficiency": scaling_efficiency,
        "n_devices": world,
        "mesh": sizes,
        "virtual_stages": virtual_stages,
        "gather_mode": gather_mode,
        "num_micro": num_micro,
        "microbatch": mb,
        "microbatch_1chip": mb1,
        "seq": cfg.seq,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "bubble_fraction": stats["bubble_fraction"],
        "bubble_fraction_gpipe": stats_gpipe["bubble_fraction"],
        "comm_bytes_per_step": {k: round(v) for k, v in comm.items()},
        "flops_per_step": composite_step_flops(cfg, tokens_per_step),
        "step_seconds": dt,
        "loss": loss,
        "step_breakdown": step_breakdown(clock, timed_steps),
        "peak_hbm_bytes": (mem or {}).get("peak_hbm_bytes"),
        "attribution": attr,
        "device": dev.type,
    }


def _bench_multichip(n_devices: Optional[int], settings: Dict[str, Any], *,
                     timeout: float = 600.0, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """``bench.py`` ``_bench_multichip`` at ``settings`` (over
    :data:`MULTICHIP_DEFAULTS`) in a world of ``n_devices`` ranks (default:
    every card; 8 gloo ranks on the CPU), one process a device through
    ``run_world``. Returns rank 0's result."""
    from .parallel.launch import run_world

    unknown = set(settings) - set(MULTICHIP_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown multichip settings {sorted(unknown)}")
    dev = resolve_device(device)
    n = n_devices or (torch.cuda.device_count() if dev.type == "cuda" else 8)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"need {n} cards, have {torch.cuda.device_count()}")
    workdir = tempfile.mkdtemp(prefix="bench-multichip-")
    try:
        with open(os.path.join(workdir, _MULTICHIP_SETTINGS), "w") as f:
            json.dump({**MULTICHIP_DEFAULTS, **settings}, f)
        return run_world(f"{__package__}.bench:_multichip_rank", n, workdir, timeout=timeout,
                         device=dev.type, pg_timeout=timeout)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def multichip_row(r: Dict[str, Any], platform: str) -> Row:
    """``bench.py`` ``_run_multichip``'s row from :func:`_bench_multichip`'s
    result."""
    return {
        "metric": f"multichip_composite_tokens_per_sec_per_chip_{r['n_devices']}dev",
        "value": round(r["tokens_per_sec_per_chip"], 1),
        "unit": "tokens_per_sec_per_chip",
        "vs_baseline": None,
        "scaling_efficiency": (round(r["scaling_efficiency"], 4)
                               if r["scaling_efficiency"] is not None else None),
        "tokens_per_sec_1chip": (round(r["tokens_per_sec_1chip"], 1)
                                 if r["tokens_per_sec_1chip"] is not None else None),
        "n_devices": r["n_devices"],
        "mesh": r["mesh"],
        "virtual_stages": r["virtual_stages"],
        "gather_mode": r["gather_mode"],
        "num_micro": r["num_micro"],
        "microbatch": r["microbatch"],
        "bubble_fraction": round(r["bubble_fraction"], 4),
        "bubble_fraction_gpipe": round(r["bubble_fraction_gpipe"], 4),
        "comm_bytes_per_step": r["comm_bytes_per_step"],
        "loss": round(r["loss"], 4),
        "step_breakdown": r["step_breakdown"],
        "peak_hbm_bytes": r.get("peak_hbm_bytes"),
        "attribution": r.get("attribution"),
        "platform": platform,
    }


def run_multichip(n_devices: Optional[int] = None, *, timeout: float = 600.0,
                  device: DeviceLike = "cuda", **settings: Any) -> Row:
    """The multichip row (:func:`_bench_multichip` at ``settings``); any
    error gives the error row."""
    dev = resolve_device(device)
    try:
        return multichip_row(_bench_multichip(n_devices, settings, timeout=timeout, device=dev),
                             _platform(dev))
    except Exception as e:
        return {"metric": "multichip_composite_tokens_per_sec_per_chip", "value": 0.0,
                "unit": "tokens_per_sec_per_chip", "vs_baseline": None, "error": str(e)[:200]}


# -- the command line ---------------------------------------------------------

MODELS = ("resnet", "gpt", "serving", "hpo", "multichip")


def summary_row(rows: Dict[str, Row], platform: str) -> Row:
    """``bench.py`` ``main``'s summary line over the rows that ran."""
    resnet_r, gpt_r = rows.get("resnet", {}), rows.get("gpt", {})
    serving = rows.get("serving", {})
    return {
        "metric": resnet_r.get("metric", "resnet50_train_mfu"),
        "value": resnet_r.get("value", 0.0),
        "unit": "percent_mfu",
        "vs_baseline": resnet_r.get("vs_baseline"),
        "images_per_sec_per_chip": resnet_r.get("images_per_sec_per_chip"),
        "gpt2_medium_mfu_pct": gpt_r.get("value"),
        "gpt2_medium_tokens_per_sec": gpt_r.get("tokens_per_sec_per_chip"),
        "serving_decode_tokens_per_sec_b8": serving.get("value"),
        "serving_bert_p50_ms_b8": serving.get("bert_http_p50_ms_b8"),
        "serving_ttft_p99_s": serving.get("ttft_p99"),
        "spec_accept_rate": serving.get("spec_accept_rate"),
        "decode_tok_s_heterogeneous": serving.get("decode_tok_s_heterogeneous"),
        "kv_handoff_p99_s": serving.get("kv_handoff_p99_s"),
        "hpo_trials_per_hour": rows.get("hpo", {}).get("value"),
        "multichip_tokens_per_sec_per_chip": rows.get("multichip", {}).get("value"),
        "multichip_scaling_efficiency": rows.get("multichip", {}).get("scaling_efficiency"),
        "platform": platform,
        "errors": {k: v["error"] for k, v in rows.items() if v.get("error")} or None,
    }


#: ``--tiny``: each row at a size the CPU runs in seconds
TINY_SERVING = {
    "bert": {"batches": (1, 8), "requests_per_batch": 2},
    "decode": {"batches": (1, 8), "prompt_len": 8, "new_tokens": 3},
    "continuous": {"slots": 2, "n_requests": 2, "prompt_len": 8, "chunk": 2,
                   "budgets": (4, 10), "distill_steps": 2},
    "disagg": {"slots": 2, "n_requests": 3, "prompt_short": 8, "prompt_long": 24,
               "budget": 3},
}
TINY_MULTICHIP = {"d_model": 32, "d_ff": 64, "n_layers": 8, "seq": 32, "vocab": 128,
                  "timed_steps": 2, "repeats": 1}


def _tiny_serving() -> Dict[str, Dict[str, Any]]:
    from .models.bert import BertConfig

    cfg = GptConfig(vocab_size=101, d_model=32, n_layers=4, n_heads=2, d_ff=64)
    out = {k: dict(v) for k, v in TINY_SERVING.items()}
    out["bert"]["cfg"] = BertConfig.tiny()
    for k in ("decode", "continuous", "disagg"):
        out[k]["cfg"] = cfg
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=MODELS + ("all",), default="all",
                    help="one row, or all of them and the summary line (BENCH_MODEL); the "
                         "multichip row joins 'all' when more than one card is visible")
    ap.add_argument("--skip", default="", help="comma-separated rows 'all' leaves out "
                                               "(BENCH_SKIP)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny configs and counts (for --device cpu)")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps a window (BENCH_STEPS; 50, the multichip row 5)")
    ap.add_argument("--repeats", type=int, default=3, help="timed windows (BENCH_REPEATS)")
    ap.add_argument("--batch", type=int, default=None,
                    help="ResNet batch; default the ladder 256/512/128/64/32 (BENCH_BATCH)")
    ap.add_argument("--fused", choices=("auto", "true", "false"), default="auto",
                    help="ResNet fused blocks (BENCH_FUSED)")
    ap.add_argument("--gpt-batch", type=int, default=gpt.BENCH_BATCH)
    ap.add_argument("--seq", type=int, default=gpt.BENCH_SEQ)
    ap.add_argument("--remat", choices=("true", "false"), default=None,
                    help="pin GPT's remat (BENCH_REMAT; default: swept)")
    ap.add_argument("--no-autotune", dest="autotune", action="store_false",
                    help="no sweeps (BENCH_AUTOTUNE=0)")
    ap.add_argument("--no-attribution", dest="attribution", action="store_false",
                    help="no attribution rows (BENCH_ATTRIBUTION=0)")
    ap.add_argument("--no-continuous", dest="continuous", action="store_false",
                    help="skip the serving row's engine pass (BENCH_CONTINUOUS=0)")
    ap.add_argument("--no-disagg", dest="disagg", action="store_false",
                    help="skip the serving row's fleet pass (BENCH_DISAGG=0)")
    ap.add_argument("--hpo-trials", type=int, default=16, help="BENCH_HPO_TRIALS")
    ap.add_argument("--no-hpo-early-stop", dest="hpo_early_stop", action="store_false",
                    help="BENCH_HPO_EARLYSTOP=0")
    ap.add_argument("--devices", type=int, default=None,
                    help="multichip ranks (default: every card; 8 on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    platform = _platform(dev)
    steps = args.steps if args.steps is not None else (2 if args.tiny else 50)
    repeats = 1 if args.tiny and args.repeats == 3 else args.repeats
    common = dict(timed_steps=steps, repeats=repeats, autotune=args.autotune,
                  attribution=args.attribution, device=dev)
    tiny_gpt = gpt.tiny_config(gpt.TINY_SEQ)
    mc = dict(TINY_MULTICHIP) if args.tiny else {}
    if args.steps is not None:
        mc.update(timed_steps=args.steps)
    if args.repeats != 3:
        mc.update(repeats=args.repeats)
    runs = {
        "resnet": lambda: run_resnet(
            cfg=resnet.tiny_config() if args.tiny else None, batch=args.batch,
            fused_blocks={"auto": "auto", "true": True, "false": False}[args.fused], **common),
        "gpt": lambda: run_gpt(
            cfg=tiny_gpt if args.tiny else None,
            batch=gpt.TINY_BATCH if args.tiny else args.gpt_batch,
            seq=gpt.TINY_SEQ if args.tiny else args.seq,
            remat=None if args.remat is None else args.remat == "true", **common),
        "serving": lambda: run_serving(continuous=args.continuous, disagg=args.disagg,
                                       depths=_tiny_serving() if args.tiny else None,
                                       device=dev),
        "hpo": lambda: run_hpo(trials=args.hpo_trials, early_stopping=args.hpo_early_stop,
                               steps=10 if args.tiny else None, device=dev),
        "multichip": lambda: run_multichip(args.devices, device=dev, **mc),
    }
    if args.model != "all":
        row = runs[args.model]()
        print(json.dumps(row), flush=True)
        return 1 if row.get("error") else 0
    skip = set(filter(None, args.skip.split(",")))
    names = ["resnet", "gpt", "serving", "hpo"]
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        names.append("multichip")
    rows: Dict[str, Row] = {}
    for name in names:
        if name in skip:
            continue
        rows[name] = runs[name]()
        print(json.dumps(rows[name]), flush=True)
    summary = summary_row(rows, platform)
    print(json.dumps(summary), flush=True)
    return 1 if summary["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
