"""The port's streaming copies against e2e/fused_bottleneck_probe.py's Pallas kernels.

The same numpy inputs (``RandomState(0)`` normals rounded to bf16) go
through the probe's ``_pallas_copy`` and ``_manual_dma_copy`` and through
the port's wrappers, which run the plain version for CPU tensors. The Pallas
kernels run in interpret mode: the probe module's ``pl`` is replaced, for
the test, by a namespace whose ``pallas_call`` forces ``interpret=True``
(the probe builds its kernels with ``interpret=False``); no JAX file
changes. Tolerance: none — ``x * bf16(0.97)`` is one bf16 rounding of an
exact f32 product on both sides, so the bits must be equal.
"""

import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kubeflow_tpu_torch.ops import stream_copy as sc

torch.set_num_threads(1)


def _probe_module():
    """``e2e.fused_bottleneck_probe``; importing it imports ``e2e.ceiling``,
    which points JAX's persistent compilation cache at a directory — the
    settings are put back, so no other test writes there."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module("e2e.fused_bottleneck_probe")
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


probe = _probe_module()


@pytest.fixture()
def interpret_pl(monkeypatch):
    """The probe's ``pl`` with ``pallas_call(..., interpret=True)``."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})

    @functools.wraps(pl.pallas_call)
    def pallas_call(*args, **kwargs):
        kwargs["interpret"] = True
        return pl.pallas_call(*args, **kwargs)

    ns.pallas_call = pallas_call
    monkeypatch.setattr(probe, "pl", ns)


def _inputs(shape, seed=0):
    a = np.random.RandomState(seed).randn(*shape)
    return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("shape,block", [((64, 128), (16, 128)),
                                         ((4, 8, 8, 128), (1, 8, 8, 128))])
def test_plain_matches_pallas_copy_bit_for_bit(interpret_pl, shape, block):
    jx, tx = _inputs(shape)
    want = probe._pallas_copy(shape, block)(jx)
    got = sc.stream_copy(tx, block)
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))


def test_plain_matches_manual_dma_copy_bit_for_bit(interpret_pl):
    jx, tx = _inputs((64, 128), seed=1)
    want = probe._manual_dma_copy(64, 128, bm=16)(jx)
    got = sc.stream_copy_dma(tx, 16)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(sc.stream_copy_plain(tx)), _bits(want))


def test_scale_is_bf16_and_a_float_scale_differs():
    assert sc.SCALE.dtype == torch.bfloat16 and float(sc.SCALE) == 0.96875
    jx, tx = _inputs((256, 128), seed=2)
    want = _bits(jx * jnp.bfloat16(0.97))
    assert np.array_equal(_bits(sc.stream_copy_plain(tx)), want)
    # a Python float multiplies by 0.97 in f32: other bits for many elements
    assert not np.array_equal(_bits(tx * 0.97), want)


_X4 = torch.zeros(4, 8, 8, 128, dtype=torch.bfloat16)
_FLAT = _X4.view(-1, 128)


@pytest.mark.parametrize("label,call", [
    ("dim 0 not a multiple of block[0]", lambda: sc.stream_copy(_FLAT, (48, 128))),
    ("block narrower than dim 1", lambda: sc.stream_copy(_FLAT, (16, 64))),
    ("4-D block not whole", lambda: sc.stream_copy(_X4, (1, 8, 4, 128))),
    ("block of another rank", lambda: sc.stream_copy(_FLAT, (16,))),
    ("f32", lambda: sc.stream_copy(_FLAT.float(), (16, 128))),
    ("not contiguous", lambda: sc.stream_copy(_FLAT.t(), (128, 256))),
    ("not 16-byte aligned", lambda: sc.stream_copy(_FLAT.view(-1)[1:1025], (1024,))),
    ("size not a multiple of 8", lambda: sc.stream_copy(_FLAT[:3, :3].contiguous(), (3, 3))),
    ("dma: m not a multiple of bm", lambda: sc.stream_copy_dma(_FLAT[:40], 16)),
    ("dma: a single tile", lambda: sc.stream_copy_dma(_FLAT[:16], 16)),
    ("dma: not 2-D", lambda: sc.stream_copy_dma(_X4, 16)),
    ("dma: f32", lambda: sc.stream_copy_dma(_FLAT.float(), 16)),
])
def test_refused_shapes_raise(label, call):
    with pytest.raises(ValueError):
        call()


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    sc.reset_launches()
    _, tx = _inputs((4, 8, 8, 128), seed=3)
    flat = tx.view(-1, 128)
    want = sc.stream_copy_plain(flat)
    assert torch.equal(sc.stream_copy(flat, (32, 128)), want)
    assert torch.equal(sc.stream_copy(tx, (1, 8, 8, 128)).view(-1, 128), want)
    assert torch.equal(sc.stream_copy_dma(flat, 64), want)
    assert sc.LAUNCHES == {"stream_copy": 0, "stream_copy_dma": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Both kernels against the plain version on the card, bit for bit and
    twice, at sizes with a partial last tile of the DMA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, c in ((3 * 4096, 256), (802816 // 64, 256), (2 * 48, 24)):
        x = torch.randn(m, c, generator=g, device="cuda").to(torch.bfloat16)
        want = sc.stream_copy_plain(x)
        sc.reset_launches()
        for call in (lambda: sc.stream_copy(x, (m // 2, c)),
                     lambda: sc.stream_copy_dma(x, m // 2)):
            a, b = call(), call()
            torch.cuda.synchronize()
            assert torch.equal(a, want) and torch.equal(b, want), (m, c)
        assert sc.LAUNCHES == {"stream_copy": 2, "stream_copy_dma": 2}
