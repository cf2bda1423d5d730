"""How often a torch.profiler window loses device records, per mode.

A window is the recorded cycle of ``profile(schedule=schedule(wait=0,
warmup=1, active=1, repeat=1))`` around 10 bf16 matmuls (4096², one kernel
each) that end in a device synchronize, as ``chip_smoke.py`` takes its
device times. A record is lost where the trace holds a kernel-launch call
and no device record with its correlation id. The modes are taken in turn
for the whole run: CUDA activity alone, the same with a 50 ms pause
before the window stops, and CPU with CUDA activity. Every fifth round
adds a window of 5000 small launches (CPU and CUDA activity).

Per mode: windows, windows that lost a record, windows that lost all,
records lost, and the longest run of consecutive windows that lost one.
One JSON line, then one with the card's name and power limit. On the
card::

    python -m kubeflow_tpu_torch.e2e.profiler_records [--seconds 90]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device


def lost_records(prof) -> Tuple[int, int]:
    """(kernel-launch calls, those with no device record) of a window."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    recorded = {e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA}
    launches = [e.correlation_id() for e in events
                if e.device_type() == DeviceType.CPU and "aunch" in e.name()]
    return len(launches), sum(c not in recorded for c in launches)


def tally(seconds: float, device: DeviceLike = "cuda") -> Dict[str, Dict[str, int]]:
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = resolve_device(device)
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    small = torch.randn(1024, device=dev)
    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    modes = {"cuda": ([cuda], 0.0), "cuda_pause_50ms": ([cuda], 0.05),
             "cpu_cuda": ([cpu, cuda], 0.0)}

    def matmuls():
        for _ in range(10):
            torch.mm(a, a)
        torch.cuda.synchronize(dev)

    def window(activities, pause):
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            matmuls()
            prof.step()
            matmuls()
            time.sleep(pause)
            prof.step()
        return lost_records(prof)

    def small_launches():
        with profile(activities=[cpu, cuda]) as prof:
            for _ in range(5000):
                small.add_(1.0)
            torch.cuda.synchronize(dev)
        return lost_records(prof)

    counts = {m: Counter() for m in [*modes, "small_launches_5000"]}
    run = Counter()

    def count(mode, launches, lost):
        c = counts[mode]
        c["windows"] += 1
        c["lossy"] += lost > 0
        c["all_lost"] += lost == launches > 0
        c["records_lost"] += lost
        run[mode] = run[mode] + 1 if lost else 0
        c["longest_lossy_run"] = max(c["longest_lossy_run"], run[mode])

    t0, rounds = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for mode, (activities, pause) in modes.items():
            count(mode, *window(activities, pause))
        if rounds % 5 == 0:
            count("small_launches_5000", *small_launches())
        rounds += 1
    return {m: dict(c) for m, c in counts.items()}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=90.0)
    a = ap.parse_args(argv)
    print(json.dumps({"seconds": a.seconds, "modes": tally(a.seconds)}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"device": torch.cuda.get_device_name(), "card": card.strip()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
