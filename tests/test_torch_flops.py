"""The port's GPU catalog, FLOP counting and MFU against kubeflow_tpu/training/flops.py and bench.py.

Tolerances. ``counted_flops`` and XLA's ``compiled_flops`` agree exactly
where both count only products: an f32 matmul chain and one unpadded 3x3
convolution. (On the CPU XLA runs a bf16 dot as f32 and counts the converts
around it, one FLOP an element, and a SAME convolution's cost leaves out the
padded taps, which FlopCounterMode counts.) ResNet-50's counted step is
within 3% of bench.py's analytic 3 x 8.2 GFLOP an image: FlopCounterMode
counts no elementwise work, the s2d stem differs from the 7x7 stem of the
8.2 GFLOP figure, and the stem's input gradient is not computed. The tiny
GPT's count is within 1% of 6 N per token plus the causal term: N also
holds the LayerNorm parameters, which do no products.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.training import flops as jflops
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.models.gpt import causal_plain_attention, init_params
from kubeflow_tpu_torch.training import flops, gpt, resnet

torch.set_num_threads(1)


def test_catalog_holds_the_h100_sxm_data_sheet():
    acc = topology.ACCELERATORS["h100"]
    assert (acc.generation, acc.bf16_tflops_per_chip, acc.hbm_gib_per_chip,
            acc.hbm_gbps_per_chip) == ("h100", 989.0, 80, 3350.0)
    assert flops.peak_flops_per_chip("h100") == 989e12
    assert flops.peak_hbm_bandwidth("h100") == 3350e9


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "h100"),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_detect_generation_maps_only_the_listed_card(monkeypatch, name, want):
    monkeypatch.setattr(flops, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    if want is None:
        with pytest.raises(KeyError, match=name):
            flops.detect_generation()
    else:
        assert flops.detect_generation() == want


def test_detect_generation_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="not a CUDA device"):
        flops.detect_generation("cpu")
    assert flops.memory_stats("cpu") is None


def test_mfu_is_the_jax_formula():
    args = (6.3e12, 0.4281, 2)
    want = jflops.mfu(*args, generation="v5e") * jflops.peak_flops_per_chip("v5e")
    got = flops.mfu(*args, generation="h100") * flops.peak_flops_per_chip("h100")
    assert got == pytest.approx(want, rel=1e-12)
    assert flops.mfu(989e12, 1.0) == 1.0


def test_counted_flops_equals_xla_on_a_matmul_chain():
    rng = np.random.RandomState(0)
    y, a, b = (rng.randn(*s).astype(np.float32) for s in ((32, 48), (48, 64), (64, 16)))
    want = jflops.compiled_flops(jax.jit(lambda y, a, b: (y @ a) @ b), y, a, b)
    got = flops.counted_flops(lambda: (torch.tensor(y) @ torch.tensor(a)) @ torch.tensor(b))
    assert got == want == 2 * 32 * 48 * 64 + 2 * 32 * 64 * 16


def test_counted_flops_equals_xla_on_a_3x3_convolution():
    rng = np.random.RandomState(1)
    x, k = rng.randn(2, 10, 10, 8).astype(np.float32), rng.randn(3, 3, 8, 16).astype(np.float32)
    conv = jax.jit(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    want = jflops.compiled_flops(conv, x, k)
    got = flops.counted_flops(lambda: F.conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                                               torch.tensor(k).permute(3, 2, 0, 1)))
    assert got == want == 2 * 2 * 8 * 8 * 9 * 8 * 16


def test_resnet50_counted_step_is_near_the_bench_count():
    cfg = dataclasses.replace(resnet.bench_config(), batch=1)
    images, labels = resnet.make_batch(cfg, 0, "cpu")
    counted = resnet.counted_flops_per_step(cfg, images, labels)
    analytic = resnet.flops_per_step(1)
    assert analytic == 3 * 8.2e9
    assert abs(counted / analytic - 1) <= 0.03, counted


def test_gpt_counted_step_is_near_the_bench_count():
    cfg, batch, seq = gpt.tiny_config(32), 2, 32
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq)))
    params = init_params(cfg, seed=0, device="cpu")
    n = sum(p.numel() for p in params.values())
    counted = gpt.counted_flops_per_step(cfg, params, ids, causal_plain_attention)
    causal = gpt.causal_attention_flops(cfg, batch, seq)
    assert causal == 3.5 * 2 * (batch * cfg.n_heads * seq * seq * cfg.head_dim) * cfg.n_layers
    assert abs(counted / (6.0 * n * batch * seq + causal) - 1) <= 0.01, counted
    assert counted <= gpt.flops_per_step(cfg, n, batch, seq)


def test_uncounted_hides_products_and_keeps_gradients():
    """``uncounted(fn)`` counts 0 and gives ``fn``'s value and gradients."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.tensor(rng.randn(2, 16, 2, 8).astype(np.float32), requires_grad=True)
               for _ in range(3))
    hidden = flops.uncounted(causal_plain_attention)
    assert flops.counted_flops(lambda: hidden(q, k, v).sum().backward()) == 0
    assert flops.counted_flops(lambda: causal_plain_attention(q, k, v)) > 0
    grads = []
    for fn in (causal_plain_attention, hidden):
        for t in (q, k, v):
            t.grad = None
        out = fn(q, k, v)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["gpt", "resnet"])
def test_train_reports_counted_flops_and_step_breakdown(which):
    """``train()`` runs each step under a StepClock and reports the counted
    FLOPs beside the bench's analytic count; on the CPU there is no catalog
    peak and no device memory counter, so mfu and peak_hbm_bytes are None."""
    if which == "gpt":
        out = gpt.train(gpt.tiny_config(32), batch=2, seq=32, steps=2, device="cpu")
        tol = 0.01
    else:
        out = resnet.train(resnet.tiny_config(), steps=2, device="cpu")
        tol = None  # the tiny ResNet is far from ResNet-50's analytic count
    assert out["mfu"] is None and out["peak_hbm_bytes"] is None
    assert set(out["step_breakdown"]) == {"compile_s", "data_wait_s_per_step",
                                          "device_compute_s_per_step", "fetch_s_per_step",
                                          "host_other_s_per_step"}
    assert out["step_breakdown"]["compile_s"] == 0.0  # the CPU builds nothing
    assert len(out["step_ms"]) == 2 and all(ms > 0 for ms in out["step_ms"])
    assert out["flops_per_step"] > 0
    if tol is not None:
        assert abs(out["flops_per_step"] / out["analytic_flops_per_step"] - 1) <= tol
