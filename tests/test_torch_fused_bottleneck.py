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


@pytest.mark.parametrize("hw,cin,cmid", [(56, 256, 64), (28, 512, 128), (14, 1024, 256),
                                         (7, 2048, 512)])
def test_mma_plan_at_resnet50_shapes(hw, cin, cmid):
    """The bf16 identity kernel's plan at each ResNet-50 shape: its shared
    memory fits the card's 227 KB, its bands cover every output row once,
    and in every phase the warps' m16 tiles cover every pixel once."""
    band = tfb.plan_band_mma(hw, cin, cmid, cin)
    assert band == {56: 7, 28: 7, 14: 8, 7: 7}[hw]
    lay = tfb.mma_layout(hw, cmid, cin, band)
    assert (lay["kc1"], lay["kc2"], lay["kc3"]) == {56: (32, 64, 64), 28: (64, 64, 32),
                                                    14: (64, 64, 32), 7: (32, 32, 32)}[hw]
    assert tfb.smem_bytes_mma(hw, cmid, cin, band) <= tfb.SMEM_MAX
    starts = list(range(0, hw, band))
    assert sum(min(band, hw - i0) for i0 in starts) == hw
    for i0 in starts:
        rows = min(band, hw - i0)
        m1 = (min(i0 + rows + 1, hw) - max(i0 - 1, 0)) * hw
        for m, n in ((m1, cmid), (rows * hw, cmid), (rows * hw, cin)):
            covered = [t0 + i for sweep in tfb.mma_sweeps(m, n) for t0, mt in sweep
                       for i in range(mt)]
            assert sorted(covered) == list(range(-(-m // 16)))
            assert all(mt <= tfb.MMA_WARP_TILES for sweep in tfb.mma_sweeps(m, n)
                       for _, mt in sweep)


def test_mma_plan_layout():
    """The shared-memory sum of the source's MmaLayout at one small shape,
    the warps along N for each channel count and the chunk depths."""
    assert [tfb._warps_n(n) for n in (16, 48, 64, 128, 192, 256, 512, 2048)] == \
        [1, 1, 1, 2, 2, 4, 8, 8]
    assert [tfb._chunk_depth(tfb._chunk_rows(n)) for n in (16, 256, 512, 2048)] == \
        [64, 64, 32, 32]
    # hw 6, cmid 16, cout 32, band 6: h1 8 x 8 x 24 x 2 = 3072 < the f32
    # staging 8 x 16 x 68 x 4; h2 36 x 24 x 2 = 1728 < x chunks 2 x 48 x 72 x 2;
    # weights 2 x 32 x 72 x 2
    assert tfb.smem_bytes_mma(6, 16, 32, 6) == 34816 + 13824 + 9216


#: ResNet-50's stage heads at 224 x 224: (hw, stride, cin, cmid, cout)
TRANSITION_SHAPES = [(56, 1, 64, 64, 256), (56, 2, 256, 128, 512), (28, 2, 512, 256, 1024),
                     (14, 2, 1024, 512, 2048)]


@pytest.mark.parametrize("hw,stride,cin,cmid,cout", TRANSITION_SHAPES)
def test_transition_mma_plan_at_resnet50_shapes(hw, stride, cin, cmid, cout):
    """The bf16 transition kernel's plan at each ResNet-50 stage head: its
    shared memory fits the card's 227 KB, its bands cover every output row
    once, and in every phase the warps' m16 tiles cover every pixel once
    (phase 3 at 32 channels a warp)."""
    band = tfb.plan_band_mma(hw, cin, cmid, cout, stride, True)
    assert band == {(56, 1): 7, (56, 2): 4, (28, 2): 4, (14, 2): 3}[hw, stride]
    assert tfb.smem_bytes_mma(hw, cmid, cout, band, stride, True, cin=cin) <= tfb.SMEM_MAX
    assert band in tfb.mma_bands(hw, cmid, cout, stride, True, cin)
    lay, ho = tfb.mma_layout(hw, cmid, cout, band, stride, True, cin=cin), hw // stride
    starts = list(range(0, ho, band))
    assert sum(min(band, ho - i0) for i0 in starts) == ho
    for i0 in starts:
        rows = min(band, ho - i0)
        row0, held = (i0 - 1, rows + 2) if stride == 1 else (2 * i0, 2 * rows + 1)
        m1 = (min(row0 + held, hw) - max(row0, 0)) * hw
        for m, n, width, wn in ((m1, cmid, 64, lay["wn1"]), (rows * ho, cmid, 64, lay["wn2"]),
                                (rows * ho, cout, 32, lay["wn3"])):
            sweeps = tfb.mma_sweeps(m, n, width, wn)
            covered = [t0 + i for sweep in sweeps for t0, mt in sweep for i in range(mt)]
            assert sorted(covered) == list(range(-(-m // 16)))
            assert all(mt <= tfb.MMA_WARP_TILES for sweep in sweeps for _, mt in sweep)


def test_transition_mma_layout():
    """The shared-memory sum of the source's MmaLayout for the transition at
    one small shape, and the shallower chunks it takes where a band does not
    fit otherwise."""
    # hw 8, stride 2, cmid 16, cout 32, band 2: h1 5 x 9 x 24 x 2 = 2160 <
    # the f32 staging 8 x 16 x 68 x 4 + the projection's x chunks 2 x 16 x
    # 72 x 2; h2 8 x 24 x 2 < phase 1's x chunks 2 x 48 x 72 x 2; weights
    # 2 x 32 x 72 x 2
    assert tfb.smem_bytes_mma(8, 16, 32, 2, 2, True) == 39424 + 13824 + 9216
    # stage 2's band 4 fits only with 32-deep chunks of 256 rows
    lay = tfb.mma_layout(56, 128, 512, 4, 2, True, cin=256)
    assert lay["kc_rows"] == 128 and (lay["kc1"], lay["kc2"], lay["kc3"]) == (32, 64, 64)
    assert tfb.smem_bytes_mma(56, 128, 512, 4, 2, True, (256, False), cin=256) > tfb.SMEM_MAX
    # warps fitted to the band's pixels where the weights are large: stage
    # 2's phase 3 (384 K values) covers its 112 pixels in one sweep of 2 x
    # 64 (4 warps along N), not two of 64; stage 4's phase 1 (512 K) its 98
    # pixels likewise
    assert lay["wn3"] == 4
    lay = tfb.mma_layout(14, 512, 2048, 3, 2, True, cin=1024)
    assert (lay["kc_rows"], lay["fit1"], lay["wn1"]) == (256, True, 4)
    # stage 1's phase 3 (32 K values) keeps 8 warps along N
    assert tfb.mma_layout(56, 64, 256, 7, 1, True, cin=64)["wn3"] == 8
    # the identity block keeps 64-deep chunks up to 256 rows at every band
    assert tfb.mma_choices(56, 64, 256, 7) == (256, False)


def _bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _tile_geometry(hw, stride):
    """The bf16 kernels' h1 tile (csrc/fused_bottleneck.cu ``block_mma``):
    pixels a tile row, the tile column of image column j, tile pixels
    between output rows, and the tile-column offsets of taps dj = 0, 1, 2.
    Stride 1: a zero border all round. Stride 2: even image columns, then
    the zero column past the edge, then the odd columns."""
    ho = hw // stride
    if stride == 1:
        return hw + 2, (lambda j: j + 1), hw + 2, (0, 1, 2)
    return hw + 1, (lambda j: j // 2 + (j % 2) * (ho + 1)), 2 * (hw + 1), (0, ho + 1, 1)


def _im2col_through_tile(h1, stride, band):
    """[n, ho * ho, 9 cmid]: each band's h1 tile laid out as the kernel's
    phase 1 stores it (pixel rows padded by 8 values, zeros elsewhere) and
    read at the per-lane ldmatrix row addresses of phase 2, tap by tap."""
    n, hw, _, cmid = h1.shape
    ho, lda = hw // stride, cmid + 8
    wc, col, opitch, tapc = _tile_geometry(hw, stride)
    out = np.full((n, ho * ho, 9 * cmid), np.nan, np.float32)
    for img in range(n):
        for i0 in range(0, ho, band):
            rows = min(band, ho - i0)
            hr, row0 = (rows + 2, i0 - 1) if stride == 1 else (2 * rows + 1, 2 * i0)
            tile = np.zeros(hr * wc * lda, np.float32)
            for r in range(max(row0, 0), min(row0 + hr, hw)):
                for j in range(hw):
                    at = ((r - row0) * wc + col(j)) * lda
                    assert tile[at:at + lda].sum() == 0  # each tile pixel written once
                    tile[at:at + cmid] = h1[img, r, j]
            for q in range(rows * ho):
                arow = ((q // ho) * opitch + q % ho) * lda
                for tap in range(9):
                    at = arow + ((tap // 3) * wc + tapc[tap % 3]) * lda
                    assert at + lda <= tile.size
                    out[img, i0 * ho + q, tap * cmid:(tap + 1) * cmid] = tile[at:at + cmid]
    return out


@pytest.mark.parametrize("hw,stride,band", [(8, 2, 4), (10, 2, 2), (12, 2, 5), (9, 1, 4),
                                            (8, 1, 8)])
def test_tap_addresses_are_xla_same_im2col(hw, stride, band):
    """The kernel's h1 tile and tap addresses, gathered from a random h1,
    give exactly the im2col of XLA's SAME taps: (1, 1) at stride 1, (0, 1)
    at stride 2 (the last band ragged where the band does not divide ho)."""
    h1 = np.random.RandomState(hw + band).randn(2, hw, hw, 16).astype(np.float32)
    (pt, pb), (pl, pr) = [tfb.same_pads(hw, 3, stride)] * 2
    padded = np.pad(h1, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    ho = hw // stride
    want = np.stack([padded[:, oi * stride + di, oj * stride + dj]
                     for oi in range(ho) for oj in range(ho)
                     for di in range(3) for dj in range(3)], 1).reshape(2, ho * ho, 9 * 16)
    np.testing.assert_array_equal(_im2col_through_tile(h1, stride, band), want)


@pytest.mark.parametrize("stride,band", [(2, 3), (1, 3)])
def test_tile_path_matches_reference_transition(stride, band):
    """The whole block computed through the tile's im2col (phase 2 as the
    kernel gathers it) against the JAX package's ``reference_transition``
    on the CPU, within 1e-2 of the output's largest magnitude."""
    args = _inputs(10, 32, 16, 64, proj=True, seed=12)
    x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wp, sp, bp = args
    want = jfb.reference_transition(*_jax(args, jnp.bfloat16), stride=stride)
    xb = _bf16(x)
    h1 = _bf16(np.maximum(xb @ _bf16(w1) * s1 + b1, 0))
    cols = _im2col_through_tile(h1, stride, band)
    h2 = _bf16(np.maximum(cols @ _bf16(w2).reshape(9 * 16, 16) * s2 + b2, 0))
    ho = 10 // stride
    y = h2 @ _bf16(w3) * s3 + b3
    p = xb[:, ::stride, ::stride].reshape(2, ho * ho, 32) @ _bf16(wp) * sp + bp
    _close(torch.tensor(np.maximum(p + y, 0).reshape(2, ho, ho, 64)), want)


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
    shapes (batch 4), bf16 and f32 x, twice for the same bits: the four
    identity shapes and the four stage heads; pixel counts per band that
    are not a multiple of the bf16 kernels' 16-pixel tiles (hw 6, 9); cmid
    16 and 48 (not multiples of 64), at stride 1 and 2; a stride-2 head
    whose last band is shorter (ho 5); channel counts the wrapper pads
    (cin 24, cmid 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    cases = [(56, 1, 256, 64, 256, False), (28, 1, 512, 128, 512, False),
             (14, 1, 1024, 256, 1024, False), (7, 1, 2048, 512, 2048, False),
             (9, 1, 64, 48, 64, False), (6, 1, 32, 16, 32, False),
             *[(*shape, True) for shape in TRANSITION_SHAPES],
             (10, 2, 64, 512, 512, True), (16, 2, 32, 48, 64, True),
             (8, 2, 8, 8, 32, True), (6, 1, 24, 8, 24, False)]
    assert 5 % tfb.plan_band_mma(10, 64, 512, 512, 2, True) != 0  # a ragged last band
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
