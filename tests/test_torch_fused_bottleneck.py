"""The port's fused bottleneck blocks against kubeflow_tpu/ops/fused_bottleneck.py.

The same numpy inputs go through the Pallas kernels in interpret mode (as
tests/test_fused_coverage.py runs them) and through the port's wrappers,
which run the kernels' plain versions for CPU tensors.

Tolerances. Forward: 1e-2 of the output's largest magnitude, about one bf16
ULP of the output: h1 and h2 are rounded to bf16 at the same places on both
sides and only the f32 sum order differs, which can flip one rounding.
Gradients: both sides differentiate the all-f32 composite, so atol and rtol
1e-5 (f32 sums in another order); they are taken at an f32 x, since a bf16
x's cotangent is rounded to bf16 and one flipped rounding is 4e-3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import fused_bottleneck as tfb

jfb = importlib.import_module("kubeflow_tpu.ops.fused_bottleneck")

torch.set_num_threads(1)


def _inputs(hw, cin, cmid, cout, proj, n=2, seed=0):
    rng = np.random.RandomState(seed)
    a = [rng.randn(n, hw, hw, cin) * 0.5, rng.randn(cin, cmid) * 0.15,
         1.0 + 0.1 * rng.randn(cmid), 0.05 * rng.randn(cmid),
         rng.randn(3, 3, cmid, cmid) * 0.1, 1.0 + 0.1 * rng.randn(cmid), 0.05 * rng.randn(cmid),
         rng.randn(cmid, cout) * 0.2, 0.8 + 0.1 * rng.randn(cout), 0.05 * rng.randn(cout)]
    if proj:
        a += [rng.randn(cin, cout) * 0.15, 1.0 + 0.1 * rng.randn(cout), 0.05 * rng.randn(cout)]
    return [v.astype(np.float32) for v in a]


def _jax(args, x_dtype):
    return [jnp.asarray(args[0], x_dtype)] + [jnp.asarray(v) for v in args[1:]]


def _torch(args, x_dtype):
    return [torch.tensor(args[0]).to(x_dtype)] + [torch.tensor(v) for v in args[1:]]


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-2 * np.abs(want).max(), f"max abs err {err} of {np.abs(want).max()}"


@pytest.mark.parametrize("hw", [7, 8, 14])
def test_identity_plain_matches_pallas(hw):
    args = _inputs(hw, 64, 16, 64, proj=False)
    want = jfb.fused_bottleneck(*_jax(args, jnp.bfloat16), interpret=True)
    tfb.reset_launches()
    got = tfb.fused_bottleneck(*_torch(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want)
    assert tfb.LAUNCHES == {"fused_bottleneck": 0, "fused_transition": 0}


@pytest.mark.parametrize("hw,stride", [(8, 2), (14, 2), (14, 1)])
def test_transition_plain_matches_pallas(hw, stride):
    args = _inputs(hw, 32, 16, 64, proj=True)
    want = jfb.fused_transition(*_jax(args, jnp.bfloat16), stride=stride, interpret=True)
    got = tfb.fused_transition(*_torch(args, torch.bfloat16), stride=stride)
    assert got.shape == (2, hw // stride, hw // stride, 64)
    _close(got, want)


def test_f32_x_keeps_its_dtype_and_matches_pallas():
    args = _inputs(8, 32, 16, 32, proj=False, seed=4)
    want = jfb.fused_bottleneck(*_jax(args, jnp.float32), interpret=True)
    got = tfb.fused_bottleneck(*_torch(args, torch.float32))
    assert got.dtype == torch.float32
    _close(got, want)


def test_odd_hw_at_stride_2_raises():
    args = _torch(_inputs(7, 32, 16, 64, proj=True), torch.bfloat16)
    with pytest.raises(ValueError, match="even hw"):
        tfb.fused_transition(*args, stride=2)
    with pytest.raises(ValueError, match="stride must be 1 or 2"):
        tfb.fused_transition(*args, stride=3)


def test_bad_shapes_raise():
    args = _torch(_inputs(8, 64, 16, 64, proj=False), torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[n, hw, hw, cin\]"):
        tfb.fused_bottleneck(args[0][:, :, :6], *args[1:])
    with pytest.raises(ValueError, match="weight shapes"):
        tfb.fused_bottleneck(args[0], args[1][:32], *args[2:])


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """Only a CPU x runs the plain version; any other device goes to the
    kernel launcher, which raises for a device that is not CUDA."""
    args = [t.to("meta") for t in _torch(_inputs(8, 64, 16, 64, proj=False), torch.bfloat16)]
    with pytest.raises(ValueError, match="CUDA device"):
        tfb.fused_bottleneck(*args)
    with pytest.raises(ValueError, match="CUDA device"):
        tfb.fused_transition(*args, torch.zeros(64, 64, device="meta"),
                             torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
                             stride=2)


@pytest.mark.parametrize("hw", [7, 8])
def test_identity_block_gradients_match_jax_grad(hw):
    args = _inputs(hw, 32, 16, 32, proj=False, seed=2)
    c = np.random.RandomState(7).randn(2, hw, hw, 32).astype(np.float32)

    def loss(*a):
        return jnp.sum(jfb.fused_bottleneck_block(*a).astype(jnp.float32) * c)

    want = jax.grad(loss, argnums=tuple(range(10)))(*_jax(args, jnp.float32))
    targs = [t.requires_grad_(True) for t in _torch(args, torch.float32)]
    (tfb.fused_bottleneck_block(*targs).float() * torch.tensor(c)).sum().backward()
    for i, (t, w) in enumerate(zip(targs, want)):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=f"argument {i}")


@pytest.mark.parametrize("stride", [1, 2])
def test_transition_block_gradients_match_jax_grad(stride):
    args = _inputs(8, 32, 16, 64, proj=True, seed=3)
    ho = 8 // stride
    c = np.random.RandomState(11).randn(2, ho, ho, 64).astype(np.float32)

    def loss(*a):
        out = jfb.fused_transition_block(*a, stride=stride)
        return jnp.sum(out.astype(jnp.float32) * c)

    want = jax.grad(loss, argnums=tuple(range(13)))(*_jax(args, jnp.float32))
    targs = [t.requires_grad_(True) for t in _torch(args, torch.float32)]
    out = tfb.fused_transition_block(*targs, stride=stride)
    (out.float() * torch.tensor(c)).sum().backward()
    for i, (t, w) in enumerate(zip(targs, want)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=f"argument {i}")


def test_bf16_x_gets_a_bf16_cotangent():
    """``_fused_block_bwd`` casts each cotangent to its primal's dtype."""
    args = _inputs(8, 32, 16, 32, proj=False, seed=5)
    targs = _torch(args, torch.bfloat16)
    targs = [t.requires_grad_(True) for t in targs]
    c = torch.tensor(np.random.RandomState(1).randn(2, 8, 8, 32).astype(np.float32))
    (tfb.fused_bottleneck_block(*targs).float() * c).sum().backward()
    assert targs[0].grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in targs[1:])
    # the f32 composite's cotangent at the same x, rounded once to bf16
    x32 = targs[0].detach().float().requires_grad_(True)
    (tfb._composite_f32(x32, *[torch.tensor(a) for a in args[1:]]) * c).sum().backward()
    np.testing.assert_allclose(targs[0].grad.float().numpy(),
                               x32.grad.to(torch.bfloat16).float().numpy(),
                               atol=1e-2 * float(x32.grad.abs().max()), rtol=0)


def test_plain_flag_and_block_forward_agree_with_the_wrapper():
    args = _torch(_inputs(8, 32, 16, 64, proj=True), torch.bfloat16)
    a = tfb.fused_transition_block(*args, stride=2)
    b = tfb.fused_transition_block(*args, stride=2, plain=True)
    assert torch.equal(a, b) and torch.equal(a, tfb.fused_transition(*args, stride=2))


def test_folded_bottleneck_matches_jax():
    args = _inputs(10, 32, 16, 64, proj=True, seed=6)
    ja = _jax(args, jnp.bfloat16)
    want = jfb.folded_bottleneck(*ja[:10], strides=(2, 2), proj=tuple(ja[10:]))
    ta = _torch(args, torch.bfloat16)
    got = tfb.folded_bottleneck(*ta[:10], strides=(2, 2), proj=tuple(ta[10:]))
    _close(got, want)
    args = _inputs(9, 64, 16, 64, proj=False, seed=8)
    _close(tfb.folded_bottleneck(*_torch(args, torch.bfloat16)),
           jfb.folded_bottleneck(*_jax(args, jnp.bfloat16)))


@pytest.mark.parametrize("size,kernel,stride,want", [
    (8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (8, 3, 1, (1, 1)), (8, 1, 2, (0, 0)),
    (7, 1, 2, (0, 0)), (112, 4, 1, (1, 2))])
def test_same_pads_are_xla_s(size, kernel, stride, want):
    assert tfb.same_pads(size, kernel, stride) == want


def test_band_plan_at_resnet50_shapes():
    """The rows per kernel block at each ResNet-50 shape fit the output
    height (the last band may be shorter) and the card's shared memory."""
    shapes = [(56, 1, 256, 64, 256, False), (28, 1, 512, 128, 512, False),
              (14, 1, 1024, 256, 1024, False), (7, 1, 2048, 512, 2048, False),
              (56, 1, 64, 64, 256, True), (56, 2, 256, 128, 512, True),
              (28, 2, 512, 256, 1024, True), (14, 2, 1024, 512, 2048, True)]
    bands = [tfb.plan_band(hw, s, ci, cm, co, p) for hw, s, ci, cm, co, p in shapes]
    assert bands == [6, 6, 6, 4, 6, 2, 2, 2]
    for (hw, s, _, cm, _, _), band in zip(shapes, bands):
        assert band <= hw // s and tfb.smem_bytes(hw, s, cm, band) <= tfb.SMEM_TWO_PER_SM
    assert tfb.smem_bytes(56, 1, 64, 4) == (6 * 58 + 4 * 56) * 72 * 2


def test_f32_convolutions_restores_the_flags():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with tfb.f32_convolutions():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.enabled
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Each kernel against its plain version on the card at ResNet-50's
    shapes (batch 4), bf16 and f32 x, channel counts the wrapper pads, and
    twice for the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    cases = [(56, 1, 256, 64, 256, False), (7, 1, 2048, 512, 2048, False),
             (56, 1, 64, 64, 256, True), (14, 2, 1024, 512, 2048, True),
             (8, 2, 8, 8, 32, True), (6, 1, 24, 8, 24, False)]
    for hw, s, cin, cmid, cout, proj in cases:
        for dtype in (torch.bfloat16, torch.float32):
            a = [t.cuda() for t in _torch(_inputs(hw, cin, cmid, cout, proj, n=4), dtype)]
            tfb.reset_launches()
            if proj:
                y1, y2 = (tfb.fused_transition(*a, stride=s) for _ in range(2))
                want = tfb.fused_transition_plain(*a, stride=s)
            else:
                y1, y2 = (tfb.fused_bottleneck(*a) for _ in range(2))
                want = tfb.fused_bottleneck_plain(*a)
            torch.cuda.synchronize()
            assert sum(tfb.LAUNCHES.values()) == 2
            assert torch.equal(y1, y2) and y1.dtype == dtype
            err = float((y1.float() - want.float()).abs().max())
            assert err <= 1e-2 * float(want.float().abs().max()), (hw, s, cin, dtype, err)
