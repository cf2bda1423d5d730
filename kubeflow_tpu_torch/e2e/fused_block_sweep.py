"""Band sweep of the bf16 fused-block kernels on the card.

At each ResNet-50 block shape of a kernel (batch 256, bf16 x >= 0, weights
at a lecun scale, folded norms near (1, 0), from a seed) and every band
whose shared memory fits, the kernel is held against its plain version
(within 1e-2 of the output's largest magnitude) and timed by CUDA events
over back-to-back calls, beside the plan's modelled ns
(``ops/fused_bottleneck.py`` ``mma_band_ns``) and the band the plan picks.
The plan's weights ``_NS_PER_BYTE``, ``_NS_PER_MMA`` and ``_NS_PER_CHUNK``
are set so that its pick is the fastest band measured here.

One JSON line a (shape, band), then one with the card's name and power
limit. On the card::

    python -m kubeflow_tpu_torch.e2e.fused_block_sweep [--kernel fused_transition]
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops import fused_bottleneck as fb
from .ceiling import timed

BATCH = 256
#: ResNet-50's block shapes at 224 x 224: (hw, stride, cin, cmid, cout)
SHAPES: Dict[str, List[Tuple[int, int, int, int, int]]] = {
    "fused_bottleneck": [(56, 1, 256, 64, 256), (28, 1, 512, 128, 512),
                         (14, 1, 1024, 256, 1024), (7, 1, 2048, 512, 2048)],
    "fused_transition": [(56, 1, 64, 64, 256), (56, 2, 256, 128, 512),
                         (28, 2, 512, 256, 1024), (14, 2, 1024, 512, 2048)],
}


def block_inputs(n: int, hw: int, cin: int, cmid: int, cout: int, proj: bool, seed: int,
                 device: torch.device) -> List[torch.Tensor]:
    """A block's inputs: bf16 x >= 0 (a relu's output), f32 weights at a
    lecun scale, folded norms near (1, 0)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    args = [torch.relu(r(n, hw, hw, cin)).to(torch.bfloat16),
            r(cin, cmid) / cin ** 0.5, 1 + 0.1 * r(cmid), 0.1 * r(cmid),
            r(3, 3, cmid, cmid) / (9 * cmid) ** 0.5, 1 + 0.1 * r(cmid), 0.1 * r(cmid),
            r(cmid, cout) / cmid ** 0.5, 1 + 0.1 * r(cout), 0.1 * r(cout)]
    if proj:
        args += [r(cin, cout) / cin ** 0.5, 1 + 0.1 * r(cout), 0.1 * r(cout)]
    return args


def sweep(kernel: str, shapes: Sequence[Tuple[int, int, int, int, int]], iters: int = 10,
          device: str = "cuda") -> List[dict]:
    """Rows of (shape, band): ms a call, max abs error against the plain
    version, the modelled ns of an image and whether the plan picks it."""
    dev = resolve_device(device)
    proj = kernel == "fused_transition"
    rows = []
    for seed, (hw, stride, cin, cmid, cout) in enumerate(shapes):
        args = block_inputs(BATCH, hw, cin, cmid, cout, proj, seed, dev)
        main, extra = args[:10], (args[10:] if proj else None)
        want = (fb.fused_transition_plain(*args, stride=stride) if proj
                else fb.fused_bottleneck_plain(*args)).float()
        top = float(want.abs().max())
        pick = fb.plan_band_mma(hw, cin, cmid, cout, stride, proj)
        for band in fb.mma_bands(hw, cmid, cout, stride, proj, cin):
            call = lambda: fb._launch(kernel, args[0], main[1:], extra, stride, band)  # noqa: E731
            err = float((call().float() - want).abs().max())
            if not err <= 1e-2 * top:
                raise AssertionError(f"{kernel} {hw} band {band}: kernel vs plain {err} "
                                     f"(max {top})")
            lay = fb.mma_layout(hw, cmid, cout, band, stride, proj, cin=cin)
            rows.append(dict(kernel=kernel, hw=hw, stride=stride, cin=cin, cmid=cmid,
                             cout=cout, band=band, kc_rows=lay["kc_rows"], fit1=lay["fit1"],
                             wn=[lay["wn1"], lay["wn2"], lay["wn3"]],
                             kc=[lay["kc1"], lay["kc2"], lay["kc3"]],
                             smem=fb.smem_bytes_mma(hw, cmid, cout, band, stride, proj, cin=cin),
                             ms=timed(call, iters, warmup=2, device=dev) * 1e3,
                             max_abs_err=err, max_abs=top, picked=band == pick,
                             model_ns=fb.mma_band_ns(hw, cin, cmid, cout, band, stride, proj)))
            print(json.dumps(rows[-1]), flush=True)
        del args, main, extra, want
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SHAPES), action="append")
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args(argv)
    for kernel in a.kernel or sorted(SHAPES):
        sweep(kernel, SHAPES[kernel], a.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"device": torch.cuda.get_device_name(), "card": card.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
