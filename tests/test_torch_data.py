"""kubeflow_tpu_torch/data/pipeline.py against kubeflow_tpu/data/pipeline.py.

The mirrors of ``tests/test_data.py`` with ``device="cpu"``: order, the
named device, overlap of host and consumer, an abandoned iterator releasing
its producer, a source error raised on the consumer's side, per-host
slicing, a pipeline feeding a train step, and the consumer's wait charged
to ``StepClock.data_wait``. ``synthetic_classifier_source`` yields the
JAX package's arrays byte for byte. The CUDA path (pinned buffers, a side
stream) runs only on the card (``-m cuda``).
"""

import time

import numpy as np
import pytest
import torch

from kubeflow_tpu.data import DataPipeline as JDataPipeline
from kubeflow_tpu.data import synthetic_classifier_source as jsynthetic
from kubeflow_tpu_torch.data import (DataPipeline, device_prefetch, per_host_shard,
                                     synthetic_classifier_source)
from kubeflow_tpu_torch.gpu.profiling import StepClock

torch.set_num_threads(1)


def test_prefetch_preserves_order_and_places_on_device():
    src = ({"x": np.full((2,), i, np.float32)} for i in range(5))
    out = list(device_prefetch(src, device="cpu"))
    assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3, 4]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in out)


def test_prefetch_copies_each_leaf_and_keeps_the_tree():
    images, labels = np.ones((4, 3), np.float32), np.arange(4, dtype=np.int32)
    item = {"images": images, "labels": labels, "extra": [np.zeros(2), (np.int64(7),)]}
    (got,) = list(device_prefetch(iter([item]), device="cpu"))
    assert got["images"].dtype == torch.float32 and got["labels"].dtype == torch.int32
    assert isinstance(got["extra"], list) and isinstance(got["extra"][1], tuple)
    assert int(got["extra"][1][0]) == 7
    images[:] = 5.0  # the source may reuse its buffers: the batch is a copy
    assert torch.equal(got["images"], torch.ones(4, 3))


def test_a_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_prefetch(iter([np.zeros(1)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataPipeline(synthetic_classifier_source(2, (4,), steps=1))


def test_prefetch_overlaps_host_and_consumer():
    """With buffering, the consumer's wall ≈ max(host, consume), not their
    sum."""
    host_delay = 0.04
    n = 6

    def slow_source():
        for _ in range(n):
            time.sleep(host_delay)
            yield {"x": np.zeros((1,), np.float32)}

    t0 = time.perf_counter()
    for _ in device_prefetch(slow_source(), device="cpu", buffer_size=2):
        time.sleep(host_delay)  # consumer work of equal cost
    overlapped = time.perf_counter() - t0
    # serial would be ~2 n host_delay (480 ms), ideal overlap ~(n + 1)
    # host_delay (280 ms); 1.8x leaves ~150 ms for scheduler noise
    assert overlapped < 1.8 * n * host_delay, overlapped


def test_abandoned_iterator_releases_producer():
    """Closing an epoch early must unblock the prefetch thread, which would
    otherwise hold its batches on the full queue forever."""
    produced = []

    def src():
        for i in range(1000):
            produced.append(i)
            yield {"x": np.zeros((1,), np.float32)}

    it = device_prefetch(src(), device="cpu", buffer_size=2)
    next(it)
    it.close()  # what `break` in a for loop triggers via GeneratorExit
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n, "producer kept running after iterator close"
    assert n < 1000  # it stopped early, not after draining the source


def test_prefetch_propagates_source_error():
    def bad():
        yield {"x": np.zeros((1,), np.float32)}
        raise RuntimeError("decode failed")

    it = device_prefetch(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_per_host_shard_slicing(monkeypatch):
    assert per_host_shard(32, process_index=0, process_count=4) == (0, 8)
    assert per_host_shard(32, process_index=3, process_count=4) == (24, 8)
    with pytest.raises(ValueError, match="not divisible"):
        per_host_shard(10, process_index=0, process_count=4)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert per_host_shard(32) == (0, 32)
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert per_host_shard(32) == (16, 8)
    with pytest.raises(ValueError, match="not divisible"):
        per_host_shard(30)


def test_pipeline_feeds_a_train_step():
    """Synthetic source → transform → batches on the device → a real step
    consumes them; epochs reshuffle deterministically."""
    pipe = DataPipeline(
        synthetic_classifier_source(batch=16, image_shape=(8,), num_classes=10, steps=4),
        device="cpu", transform=lambda b: {**b, "images": b["images"] * 2.0})
    w = torch.zeros(8, 10, requires_grad=True)
    losses = []
    for b in pipe.epoch(0):
        loss = torch.nn.functional.cross_entropy(b["images"] @ w, b["labels"].long())
        loss.backward()
        losses.append(float(loss.detach()))
    assert len(losses) == 4 and all(np.isfinite(losses)) and w.grad is not None
    a = next(iter(pipe.epoch(0)))["images"]
    b = next(iter(pipe.epoch(0)))["images"]
    c = next(iter(pipe.epoch(1)))["images"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(next(iter(pipe))["images"], a)  # iter() is epoch 0


def test_prefetch_charges_consumer_wait_to_step_clock():
    """A slow source shows up as StepClock data_wait; a fast source with a
    slow consumer does not."""

    def slow_source():
        for i in range(3):
            time.sleep(0.05)
            yield np.full((2,), i, np.float32)

    clock = StepClock()
    out = list(device_prefetch(slow_source(), device="cpu", buffer_size=1, clock=clock))
    assert len(out) == 3 and [int(t[0]) for t in out] == [0, 1, 2]
    assert clock._current["data_wait"] >= 0.05, clock._current

    clock2 = StepClock()
    for _ in device_prefetch((np.zeros(2) for _ in range(3)), device="cpu", buffer_size=2,
                             clock=clock2):
        time.sleep(0.02)
    # the first get can include the producer's start; later waits are tiny
    assert clock2._current["data_wait"] < 0.5


@pytest.mark.parametrize("shape,classes,seed", [((8,), 10, 0), ((6, 6, 3), 1000, 3)])
def test_synthetic_source_yields_jaxs_arrays(shape, classes, seed):
    port = synthetic_classifier_source(4, shape, classes, steps=3, seed=seed)
    jx = jsynthetic(4, shape, classes, steps=3, seed=seed)
    for epoch in (0, 1):
        got, want = list(port(epoch)), list(jx(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in ("images", "labels"):
                assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()


def test_pipelines_give_the_same_batches():
    """The port's and JAX's pipelines over their sources, with a transform:
    the same values, batch for batch."""
    transform = lambda b: {**b, "images": b["images"] * 0.5}  # noqa: E731
    port = DataPipeline(synthetic_classifier_source(4, (5,), steps=3), device="cpu",
                        transform=transform)
    jx = JDataPipeline(jsynthetic(4, (5,), steps=3), transform=transform)
    for g, w in zip(port.epoch(1), jx.epoch(1), strict=True):
        assert g["images"].numpy().tobytes() == np.asarray(w["images"]).tobytes()
        assert np.array_equal(g["labels"].numpy(), np.asarray(w["labels"]))


@pytest.mark.cuda
def test_cuda_prefetch_gives_the_source_in_order_on_the_card():
    """Pinned staging and a side stream: every batch equal to its source on
    the consumer's stream, while the consumer keeps the device busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned, side-stream copy path runs on CUDA only")
    src = synthetic_classifier_source(8, (64, 64, 3), steps=6, seed=1)
    want = list(src(0))
    clock = StepClock()
    busy = torch.randn(2048, 2048, device="cuda")
    for i, got in enumerate(DataPipeline(src, device="cuda", clock=clock)):
        busy = busy @ busy.T / 2048.0  # work on the consumer's stream
        assert got["images"].is_cuda and got["labels"].dtype == torch.int32
        assert torch.equal(got["images"].cpu(), torch.from_numpy(want[i]["images"]))
        assert torch.equal(got["labels"].cpu(), torch.from_numpy(want[i]["labels"]))
    assert i == 5 and torch.isfinite(busy).all()
