"""The profiler-record probe's count of lost device records.

``lost_records`` pairs each kernel-launch call in a torch.profiler trace
with the device record of the same correlation id; ``chip_smoke.py`` takes
a window again when one is missing. The traces here are built by hand: the
CPU has no device records to lose.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from kubeflow_tpu_torch.e2e.profiler_records import lost_records, tally


def event(name, device_type, correlation_id):
    return SimpleNamespace(name=lambda: name, device_type=lambda: device_type,
                           correlation_id=lambda: correlation_id)


def trace(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("recorded, want", [
    ((1, 2, 3), (3, 0)),  # every launch has its kernel
    ((1, 3), (3, 1)),  # one record dropped
    ((), (3, 3)),  # a window that lost every record
])
def test_lost_records_counts_launches_without_a_device_record(recorded, want):
    launches = [event(n, DeviceType.CPU, c) for n, c in
                (("cudaLaunchKernel", 1), ("cuLaunchKernelEx", 2), ("cudaLaunchKernelExC", 3))]
    others = [event("aten::mm", DeviceType.CPU, 0), event("cudaMemsetAsync", DeviceType.CPU, 9),
              event("Memset (Device)", DeviceType.CUDA, 9)]
    kernels = [event(f"k{c}", DeviceType.CUDA, c) for c in recorded]
    assert lost_records(trace(launches + others + kernels)) == want


def test_lost_records_of_a_cpu_trace_is_empty():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert lost_records(prof) == (0, 0)


def test_tally_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the probe would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tally(0.0)
