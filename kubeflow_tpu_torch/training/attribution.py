"""Per-module training cost attribution: which modules spend the step's
time, whether each is compute- or HBM-bound, and how much of the measured
step the fused kernels cover.

The port of ``kubeflow_tpu/training/attribution.py``. :func:`price_callable`
runs ``fn`` once on ``meta``-device tensors (shapes and dtypes only: nothing
is allocated and nothing runs on a card) and prices it in place of XLA's
cost analysis and ``memory_analysis``:

- FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (the counter of
  ``training/flops.py``): the products of matrix products and convolutions,
  2 FLOPs a multiply-add; elementwise work is not counted;
- bytes as the sum of every op's input and output bytes (views move none):
  the eager traffic the port's unfused modules move, where XLA reports the
  bytes of its fused HLO;
- the footprint: ``argument_bytes`` (inputs, parameters, buffers),
  ``output_bytes`` and ``temp_bytes`` (the most intermediate bytes alive at
  once, storages followed until their last tensor dies);
  ``peak_hbm_bytes`` is their sum.

Each module is classified against the card's roofline (peak bf16 FLOP/s
against peak HBM bytes/s from the catalog, ``gpu/topology.py``), and
:func:`attribution_report` decomposes a ``StepClock``-measured step into
data-wait / fused-compute / un-fused-compute / other fractions with a
top-N time-sink table, by JAX's arithmetic.

Pricing ground rules (those of the JAX module):

- every module is priced in its UNFUSED form: the counter sees nothing a
  CUDA kernel does, as XLA credits nothing inside a Pallas call; fused
  eligibility is classified separately by the block's own predicates,
- forward cost is scaled by ``TRAIN_STEP_FACTOR`` (3x: forward + ~2x
  backward) so module shares line up with the measured train step,
- attention is priced through the plain causal attention, whose dots the
  counter sees (the flash wrapper launches or raises on a non-CPU tensor).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from ..device import DeviceLike
from ..runtime.metrics import METRICS
from .flops import detect_generation, peak_flops_per_chip, peak_hbm_bandwidth

#: train step ≈ forward + backward ≈ 3x forward FLOPs (the convention of
#: bench.py's analytic fallback; the optimizer update is O(params), noise)
TRAIN_STEP_FACTOR = 3.0

META = torch.device("meta")


@dataclass
class ModuleCost:
    """One priced module: counted cost + roofline verdict."""

    name: str
    kind: str                 # "stem" | "bottleneck" | "gpt_block" | "loss_head" | ...
    detail: str = ""          # "strided+projection", "projection", "identity", ...
    fused: bool = False       # routed through a fused CUDA kernel at runtime
    count: int = 1            # identical applications priced once (the block stack)
    flops: float = 0.0        # train-step FLOPs, all applications
    hbm_bytes: float = 0.0    # train-step bytes moved, all applications
    peak_hbm_bytes: int = 0   # resident bytes of ONE application (the footprint)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    intensity: float = 0.0    # flops / hbm_bytes (arithmetic intensity)
    verdict: str = "unknown"  # "compute-bound" | "hbm-bound"
    est_seconds: float = 0.0  # roofline time: max(flops/peak, bytes/bandwidth)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "kind": self.kind, "detail": self.detail,
            "fused": self.fused, "count": self.count,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "intensity": round(self.intensity, 2), "verdict": self.verdict,
            "est_seconds": self.est_seconds,
        }


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> Tuple[int, int]:
    """(key, bytes) of ``t``'s storage."""
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


def _moved(t: torch.Tensor) -> int:
    """Bytes an op reads or writes of ``t``: its elements, at most its
    storage (a broadcast view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class _Traffic(TorchDispatchMode):
    """Sums every op's input and output bytes (view ops move none) and
    records when each storage made during the run is allocated and freed.
    An allocation is numbered: a freed storage's address may come back."""

    def __init__(self, known: set) -> None:
        super().__init__()
        self.bytes = 0
        self.events: List[Tuple[int, int, int]] = []   # (+1 | -1, allocation, bytes)
        self._known = known                            # argument storages
        self._live: Dict[int, List[int]] = {}          # key -> [tensors alive, bytes, allocation]
        self.open = True

    def allocation(self, t: torch.Tensor) -> Optional[int]:
        """The number of the live allocation ``t``'s storage is, if the run
        made it."""
        entry = self._live.get(_storage(t)[0])
        return None if entry is None else entry[2]

    def _free(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None or not self.open:
            return
        entry[0] -= 1
        if entry[0] == 0:
            del self._live[key]
            self.events.append((-1, entry[2], entry[1]))

    def _follow(self, t: torch.Tensor, allocated: bool) -> None:
        key, nbytes = _storage(t)
        if key in self._known:
            return
        entry = self._live.get(key)
        if entry is None:
            if not allocated:
                return  # a view of a storage the run did not make
            entry = self._live[key] = [0, nbytes, len(self.events)]
            self.events.append((1, entry[2], nbytes))
        entry[0] += 1
        weakref.finalize(t, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(_moved(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._follow(t, allocated=not func.is_view)
        return out


def _to_meta(arg: Any) -> Any:
    """Tensors become meta tensors of the same shape and dtype; a module
    must have been built on the meta device."""
    if isinstance(arg, torch.nn.Module):
        devices = {t.device.type for t in list(arg.parameters()) + list(arg.buffers())}
        if devices - {"meta"}:
            raise ValueError(f"price_callable: module {type(arg).__name__} has tensors on "
                             f"{sorted(devices)}; build it under torch.device('meta')")
        return arg
    if isinstance(arg, torch.Tensor) and arg.device.type != "meta":
        return arg.detach().to(META).requires_grad_(arg.requires_grad)
    return arg


def _argument_tensors(args: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for leaf in tree_flatten(args)[0]:
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
            out.extend(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _unique_bytes(tensors: List[torch.Tensor], skip: set = frozenset()) -> Tuple[set, int]:
    keys: Dict[int, int] = {}
    for t in tensors:
        key, nbytes = _storage(t)
        if key not in skip:
            keys[key] = nbytes
    return set(keys), sum(keys.values())


def footprint(fn: Any, *args: Any) -> Dict[str, Any]:
    """Run ``fn(*args)`` once on meta tensors (tensor leaves of ``args`` are
    turned into meta tensors; ``nn.Module`` leaves must be meta already)
    and return its counted ``flops``, the ``bytes`` its ops move, and the
    footprint: ``argument_bytes``, ``output_bytes``, ``temp_bytes`` and
    their sum ``peak_hbm_bytes``."""
    from torch.utils.flop_counter import FlopCounterMode

    args = tree_map(_to_meta, args, is_leaf=lambda x: isinstance(x, torch.nn.Module))
    arg_keys, arg_bytes = _unique_bytes(_argument_tensors(args))
    traffic = _Traffic(arg_keys)
    with FlopCounterMode(display=False) as counter, traffic:
        result = fn(*args)
    outputs = _tensors(result)
    _, out_bytes = _unique_bytes(outputs, skip=arg_keys)
    out_allocations = {traffic.allocation(t) for t in outputs}
    traffic.open = False
    live = peak = 0
    for sign, allocation, nbytes in traffic.events:
        if allocation not in out_allocations:
            live += sign * nbytes
            peak = max(peak, live)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes, "temp_bytes": peak}
    mem["peak_hbm_bytes"] = sum(mem.values())
    return {"flops": float(counter.get_total_flops()), "bytes": float(traffic.bytes), **mem}


def price_callable(
    fn: Any,
    *args: Any,
    name: str,
    kind: str = "module",
    detail: str = "",
    fused: bool = False,
    count: int = 1,
    generation: str = "h100",
    train_factor: float = TRAIN_STEP_FACTOR,
) -> ModuleCost:
    """Run ``fn(*args)`` on meta tensors (:func:`footprint`; nothing is
    allocated or executed on a device) and price it: counted FLOPs and
    bytes moved, scaled by ``count`` applications and ``train_factor``,
    the footprint of one application, and the roofline verdict against
    ``generation``'s peaks."""
    cost = footprint(fn, *args)
    flops1, bytes1 = cost["flops"], cost["bytes"]
    if bytes1 <= 0.0:  # no op moved a byte: floor at the footprint
        bytes1 = float(cost["argument_bytes"] + cost["output_bytes"] + cost["temp_bytes"])
    flops = flops1 * count * train_factor
    hbm = bytes1 * count * train_factor
    peak_f = peak_flops_per_chip(generation)
    peak_b = peak_hbm_bandwidth(generation)
    intensity = flops / hbm if hbm > 0 else float("inf")
    balance = peak_f / peak_b if peak_b > 0 else float("inf")
    verdict = "compute-bound" if intensity >= balance else "hbm-bound"
    est = max(flops / peak_f if peak_f > 0 else 0.0,
              hbm / peak_b if peak_b > 0 else 0.0)
    return ModuleCost(
        name=name, kind=kind, detail=detail, fused=fused, count=count,
        flops=flops, hbm_bytes=hbm,
        peak_hbm_bytes=int(cost["peak_hbm_bytes"]),
        argument_bytes=int(cost["argument_bytes"]),
        output_bytes=int(cost["output_bytes"]),
        temp_bytes=int(cost["temp_bytes"]),
        intensity=intensity, verdict=verdict, est_seconds=est,
    )


def _generation(generation: Optional[str], device: DeviceLike) -> str:
    return generation or detect_generation(device)


def loop_generation(device: DeviceLike) -> str:
    """The catalog generation a training loop prices against: the card's
    (:func:`detect_generation`) on a CUDA device, else ``"h100"``, the
    catalog's one entry (a CPU run prices for the card it stands in for)."""
    dev = torch.device(device)
    return detect_generation(dev) if dev.type == "cuda" else "h100"


# -- ResNet walk --------------------------------------------------------------

def attribute_resnet(
    batch: int = 256,
    image: int = 224,
    num_classes: int = 1000,
    stem: str = "conv7x7",
    fused_blocks: bool = True,
    generation: Optional[str] = None,
    stage_sizes: tuple = (3, 4, 6, 3),
    num_filters: int = 64,
    device: DeviceLike = "cuda",
) -> List[ModuleCost]:
    """Price every module of a ``ResNet(stage_sizes, BottleneckBlock)``:
    the stem (with the max-pool), each bottleneck (classified fused or not
    by the block's own ``_fusable`` / ``_fusable_transition``), and the
    pooled f32 classifier head. Blocks are built on the meta device with
    ``fused=False`` and priced in eval mode. ``generation=None`` reads the
    catalog generation of the CUDA card ``device``."""
    import torch.nn.functional as F

    from ..models.resnet import BottleneckBlock, space_to_depth
    from ..ops.fused_bottleneck import conv_nhwc

    gen = _generation(generation, device)
    bf16 = torch.bfloat16
    costs: List[ModuleCost] = []

    # the stem and the pool, one module: f32 image in, bf16 out
    s2d = stem == "s2d" and image % 2 == 0
    if s2d:
        kernel = torch.empty(4, 4, 12, num_filters, dtype=bf16, device=META)
    else:
        kernel = torch.empty(7, 7, 3, num_filters, dtype=bf16, device=META)

    def stem_fn(x, k):
        x = x.to(bf16)
        if s2d:
            x = conv_nhwc(space_to_depth(x, 2), k, 1, ((2, 1), (2, 1)))
        else:
            x = conv_nhwc(x, k, 2, ((3, 3), (3, 3)))
        x = torch.relu(x)
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)

    img = torch.empty(batch, image, image, 3, device=META)
    costs.append(price_callable(stem_fn, img, kernel, name="stem", kind="stem",
                                detail=stem, generation=gen))

    size, cin = image // 4, num_filters
    for i, blocks in enumerate(stage_sizes):
        filters = num_filters * 2 ** i
        for j in range(blocks):
            strides = (2, 2) if i > 0 and j == 0 else (1, 1)
            x = torch.empty(batch, size, size, cin, dtype=bf16, device=META)
            with torch.device(META):
                block = BottleneckBlock(cin, filters, strides, fused=False)
            block.requires_grad_(False)
            fused_here = bool(fused_blocks) and (
                block._fusable(x) or block._fusable_transition(x))
            if strides != (1, 1) and cin != filters * 4:
                detail = "strided+projection"
            elif cin != filters * 4:
                detail = "projection"
            elif strides != (1, 1):
                detail = "strided"
            else:
                detail = "identity"
            if fused_here and not block._fusable(x):
                detail += "/transition"
            costs.append(price_callable(
                lambda b, a: b(a, train=False), block, x,
                name=f"stage{i + 1}_block{j + 1}", kind="bottleneck",
                detail=detail, fused=fused_here, generation=gen))
            if strides == (2, 2):
                size //= 2
            cin = filters * 4

    def head_fn(w, x):
        pooled = x.float().mean(dim=(1, 2))
        return pooled @ w

    feat = torch.empty(batch, size, size, cin, dtype=bf16, device=META)
    w = torch.empty(cin, num_classes, device=META)
    costs.append(price_callable(head_fn, w, feat, name="classifier_head",
                                kind="head", generation=gen))
    return costs


# -- GPT walk -----------------------------------------------------------------

def attribute_gpt(
    cfg: Any,
    batch: int = 8,
    seq: Optional[int] = None,
    fused_loss: bool = True,
    generation: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> List[ModuleCost]:
    """Price a ``GptConfig`` stack: one transformer block (priced once,
    counted ``n_layers`` times: every layer runs the same program) with
    its attention through the plain causal attention, plus the logits/loss
    head in its materialized f32 form (the work the blockwise fused loss
    restructures); ``fused_loss`` only flips its fused classification."""
    from ..models.gpt import GptBlock, causal_lm_loss, causal_plain_attention

    gen = _generation(generation, device)
    L = seq or cfg.max_seq
    x = torch.empty(batch, L, cfg.d_model, dtype=torch.bfloat16, device=META)
    block = GptBlock(cfg, device=META, attention_fn=causal_plain_attention)
    block.requires_grad_(False)
    costs = [price_callable(
        lambda b, a: b(a), block, x,
        name="gpt_block", kind="gpt_block", count=cfg.n_layers,
        detail=f"x{cfg.n_layers}", generation=gen)]

    def loss_head(h, emb, ids):
        logits = h.float() @ emb.T.float()
        return causal_lm_loss(logits, ids)

    emb = torch.empty(cfg.vocab_size, cfg.d_model, device=META)
    ids = torch.empty(batch, L, dtype=torch.int64, device=META)
    costs.append(price_callable(
        loss_head, x, emb, ids, name="loss_head", kind="loss_head",
        fused=fused_loss, detail="blockwise" if fused_loss else "materialized",
        generation=gen))
    return costs


# -- step decomposition + report ----------------------------------------------

@dataclass
class AttributionReport:
    """Module table + the measured step decomposed into fractions."""

    generation: str
    modules: List[ModuleCost]
    step_seconds: float                      # measured per-step wall clock
    measured: Dict[str, float] = field(default_factory=dict)   # per-step phases
    fractions: Dict[str, float] = field(default_factory=dict)  # of step_seconds

    def top_sinks(self, n: int = 5, fused: Optional[bool] = None) -> List[ModuleCost]:
        mods = [m for m in self.modules if fused is None or m.fused == fused]
        return sorted(mods, key=lambda m: m.est_seconds, reverse=True)[:n]

    def coverage(self, kind: str = "bottleneck") -> Dict[str, int]:
        """Fused-kernel coverage over modules of ``kind`` (16/16
        bottlenecks of ResNet-50 at 224 x 224)."""
        of_kind = [m for m in self.modules if m.kind == kind]
        return {"fused": sum(1 for m in of_kind if m.fused),
                "total": len(of_kind)}

    def to_dict(self, top_n: int = 5) -> Dict[str, Any]:
        return {
            "generation": self.generation,
            "step_seconds": self.step_seconds,
            "fractions": {k: round(v, 4) for k, v in self.fractions.items()},
            "modules": len(self.modules),
            "fused_modules": sum(1 for m in self.modules if m.fused),
            "coverage": self.coverage(),
            "top_unfused_sinks": [m.to_dict() for m in
                                  self.top_sinks(top_n, fused=False)],
            "top_fused_sinks": [m.to_dict() for m in
                                self.top_sinks(top_n, fused=True)],
        }

    def render(self, top_n: int = 10) -> str:
        lines = [
            f"# Attribution report ({self.generation}: "
            f"{peak_flops_per_chip(self.generation) / 1e12:.0f} TF/s peak, "
            f"{peak_hbm_bandwidth(self.generation) / 1e9:.0f} GB/s HBM)",
            f"measured step: {self.step_seconds * 1e3:.3f} ms  "
            + "  ".join(f"{k}={v * 1e3:.3f}ms" for k, v in self.measured.items()),
            "fractions: " + "  ".join(f"{k}={v:.1%}"
                                      for k, v in self.fractions.items()),
            "fused coverage: {fused}/{total} bottlenecks".format(
                **self.coverage()),
            "",
            f"{'module':<22}{'kind':<12}{'detail':<31}{'fused':<7}"
            f"{'GFLOPs':>9}{'HBM MiB':>10}{'int.':>8}  {'verdict':<14}{'est ms':>8}",
        ]
        for m in sorted(self.modules, key=lambda m: m.est_seconds, reverse=True)[:top_n]:
            lines.append(
                f"{m.name:<22}{m.kind:<12}{m.detail:<31}"
                f"{'yes' if m.fused else 'NO':<7}"
                f"{m.flops / 1e9:>9.2f}{m.hbm_bytes / 2**20:>10.1f}"
                f"{m.intensity:>8.1f}  {m.verdict:<14}{m.est_seconds * 1e3:>8.3f}")
        return "\n".join(lines)


def attribution_report(
    modules: List[ModuleCost],
    clock: Optional[Any] = None,
    steps_per_record: int = 1,
    step_seconds: Optional[float] = None,
    generation: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> AttributionReport:
    """Decompose the measured step into data-wait / fused-compute /
    un-fused-compute / other. Phases come from ``clock.summary()`` (one
    clock record = ``steps_per_record`` real steps); the measured
    ``compute`` phase (which ends at a device synchronize in the port's
    loops) is split between fused and un-fused module groups in proportion
    to their roofline estimates, and ``other`` absorbs the remainder
    (fetch + host), so the fractions sum to the measured step exactly."""
    gen = _generation(generation, device)
    if clock is not None:
        s = clock.summary()
        spr = max(1, steps_per_record)
        measured = {k: s.get(k, 0.0) / spr
                    for k in ("data_wait", "compute", "fetch", "other")}
        total = s.get("total", 0.0) / spr
    else:
        total = float(step_seconds or 0.0)
        measured = {"data_wait": 0.0, "compute": total, "fetch": 0.0,
                    "other": 0.0}
    est_fused = sum(m.est_seconds for m in modules if m.fused)
    est_unfused = sum(m.est_seconds for m in modules if not m.fused)
    compute = measured.get("compute", 0.0)
    if est_fused + est_unfused > 0:
        fused_c = compute * est_fused / (est_fused + est_unfused)
    else:
        fused_c = 0.0
    unfused_c = compute - fused_c
    data_wait = measured.get("data_wait", 0.0)
    other = max(0.0, total - data_wait - compute)
    fractions = {}
    if total > 0:
        fractions = {
            "data_wait": data_wait / total,
            "fused_compute": fused_c / total,
            "unfused_compute": unfused_c / total,
            "other": other / total,
        }
    return AttributionReport(generation=gen, modules=modules,
                             step_seconds=total, measured=measured,
                             fractions=fractions)


def record_step_peak_hbm(mem: Optional[Dict[str, int]],
                         metrics: Optional[Any] = None) -> Optional[int]:
    """Publish a train step's footprint as gauges:
    ``training_step_peak_hbm_bytes`` plus per-component
    ``training_step_hbm_bytes{component=...}``. Takes a dict with
    ``peak_hbm_bytes`` (``training.flops.memory_stats`` on the card, or
    :func:`footprint`); None-safe (the CPU has no device counter).
    Returns the peak bytes recorded."""
    if not mem:
        return None
    reg = metrics if metrics is not None else METRICS.namespace("training")
    peak = int(mem.get("peak_hbm_bytes", 0))
    reg.gauge("step_peak_hbm_bytes").set(peak)
    for key in ("argument_bytes", "output_bytes", "temp_bytes"):
        if key in mem:
            reg.gauge("step_hbm_bytes",
                      component=key.replace("_bytes", "")).set(mem[key])
    return peak


def attribution_row(make_costs: Any, clock: Any, timed_steps: int = 1,
                    generation: Optional[str] = None,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A bench result's ``attribution`` field (``bench.py``
    ``_attribution_row``): ``make_costs()`` prices the model walk on meta
    tensors and the report decomposes ``clock``'s measured step (one clock
    record = ``timed_steps`` steps). Guarded: a failing attribution gives
    ``{"error": ...}`` and never fails the run."""
    try:
        report = attribution_report(make_costs(), clock=clock,
                                    steps_per_record=timed_steps,
                                    generation=generation, device=device)
        return report.to_dict(top_n=5)
    except Exception as e:
        return {"error": str(e)[:160]}
