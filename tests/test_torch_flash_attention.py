"""kubeflow_tpu_torch/ops/flash_attention.py against
kubeflow_tpu/ops/flash_attention.py.

On the CPU the port runs its plain versions through the same
``autograd.Function`` the kernels use; the JAX side runs its Pallas kernels
in interpret mode, as tests/test_ops.py does (``_fwd``/``_bwd`` for the
log-sum-exp and the raw gradients, ``jax.grad`` of ``flash_attention`` for
the wired-up VJP). Inputs are made with numpy from a seed and handed to
both; JAX's answer for each of ``CASES`` is computed once and shared.

Tolerances. f32: the same math with sums in another order, so ``out`` and
``lse`` within 2e-5 (test_ops.py's bound against exact attention) and
gradients within 1e-4. bf16 inputs: ``out`` and the gradients are rounded
to bf16 (one ULP at magnitude ~2 is 0.0156), so 2e-2 as test_bf16_inputs
uses. ``bf16_dots=True``: every dot operand is rounded to bf16 in both;
with a single JAX tile (L <= 128) the formulas are the same, so only f32
sum order differs, which can move a bf16 rounding of p by one ULP: 1e-3.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kubeflow_tpu_torch.ops import flash_attention as tfa

# the module, not the function that kubeflow_tpu.ops re-exports under its name
jfa = importlib.import_module("kubeflow_tpu.ops.flash_attention")

torch.set_num_threads(1)


def _qkv(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, lq, h, d)).astype(np.float32),
            rng.normal(size=(b, lk, h, d)).astype(np.float32),
            rng.normal(size=(b, lk, h, d)).astype(np.float32))


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _t(*xs, dtype=torch.float32, grad=False):
    return [torch.tensor(x).to(dtype).requires_grad_(grad) for x in xs]


# (b, lq, lk, h, d, causal, q_offset, k_offset, jax block)
CASES = {
    "causal": (1, 128, 128, 2, 32, True, 0, 0, 64),
    "non_causal": (2, 128, 128, 1, 64, False, 0, 0, 64),
    "lq_ne_lk": (2, 64, 128, 1, 32, False, 0, 0, 64),
    "causal_lq_ne_lk": (1, 64, 128, 2, 32, True, 0, 0, 64),
    "q_offset_all_visible": (1, 64, 64, 2, 32, True, 64, 0, 32),
    "k_offset_partly_masked": (1, 128, 128, 1, 32, True, 0, 64, 64),
    "k_offset_fully_masked": (1, 64, 64, 1, 32, True, 0, 640, 64),
}


def _bf16_values(*xs):
    """f32 arrays rounded to bf16 values, so that every product is exact."""
    return [torch.tensor(x).to(torch.bfloat16).float().numpy() for x in xs]


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """Inputs for ``CASES[case]`` and JAX's interpret-mode ``_fwd`` then
    ``_bwd`` on them with the case's blocks, under one jit: ((q, k, v, do),
    (out, lse, (dq, dk, dv))). The inputs are made from a seed and rounded
    to bf16 values, so that the tensor-core model below sees exact products.
    Computed once a case and shared by the tests that hold the f32 path and
    the model against JAX."""
    b, lq, lk, h, d, causal, qo, ko, blk = CASES[case]
    q, k, v = _bf16_values(*_qkv(0, b, lq, lk, h, d))
    (do,) = _bf16_values(np.random.default_rng(3).normal(size=(b, lq, h, d)).astype(np.float32))
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko)

    def run(q, k, v, do):
        out, lse = jfa._fwd(q, k, v, block_q=blk, block_k=blk, interpret=True, **kw)
        return out, lse, jfa._bwd(q, k, v, out, lse, do, block_q=blk, block_k=blk,
                                  interpret=True, **kw)
    return (q, k, v, do), jax.tree.map(np.asarray, jax.jit(run)(*_j(q, k, v, do)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_out_and_lse_match_jax(case):
    b, lq, lk, h, d, causal, qo, ko, blk = CASES[case]
    (q, k, v, _), (want_out, want_lse, _) = _jax_reference(case)
    scale = d ** -0.5
    out, lse = tfa.flash_attention_fwd(*_t(q, k, v), causal=causal, scale=scale,
                                       q_offset=qo, k_offset=ko)
    assert out.shape == (b, lq, h, d) and lse.shape == (b, h, lq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse[..., 0], atol=2e-5, rtol=0)


def test_fully_masked_rows_give_zeros_and_neg_big_lse():
    q, k, v = _qkv(1, 1, 64, 64, 2, 32)
    out, lse = tfa.flash_attention_fwd(*_t(q, k, v), causal=True, scale=0.2, k_offset=640)
    assert torch.equal(out, torch.zeros_like(out))
    assert (lse == tfa.NEG_BIG).all()
    # partly masked: the first 32 query rows see no key
    out, lse = tfa.flash_attention_fwd(*_t(q, k, v), causal=True, scale=0.2, k_offset=32)
    assert torch.equal(out[:, :32], torch.zeros_like(out[:, :32]))
    assert (lse[:, :, :32] == tfa.NEG_BIG).all() and (lse[:, :, 32:] > -1e3).all()


@pytest.mark.parametrize("case", ["causal", "lq_ne_lk", "k_offset_partly_masked"])
def test_raw_backward_matches_jax_bwd(case):
    b, lq, lk, h, d, causal, qo, ko, blk = CASES[case]
    (q, k, v, do), (_, _, want) = _jax_reference(case)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, **kw)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0, err_msg=name)


def _jax_grads(q, k, v, dtype, **kw):
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw).astype(jnp.float32) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v, dtype=dtype))


def _torch_grads(q, k, v, dtype, **kw):
    tq, tk, tv = _t(q, k, v, dtype=dtype, grad=True)
    out = tfa.flash_attention(tq, tk, tv, **kw)
    (out.float() ** 2).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("case", ["causal", "lq_ne_lk", "k_offset_partly_masked",
                                  "q_offset_all_visible"])
def test_gradients_through_the_function_match_jax_grad(case):
    b, lq, lk, h, d, causal, qo, ko, blk = CASES[case]
    q, k, v = _qkv(4, b, lq, lk, h, d)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko, block_q=blk, block_k=blk)
    want = _jax_grads(q, k, v, jnp.float32, **kw)
    _, got = _torch_grads(q, k, v, torch.float32, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_bf16_inputs_forward_and_gradients():
    q, k, v = _qkv(5, 1, 128, 128, 2, 64)
    want_out = jfa.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), causal=True)
    want = _jax_grads(q, k, v, jnp.bfloat16, causal=True)
    out, got = _torch_grads(q, k, v, torch.bfloat16, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want_out, np.float32), atol=2e-2, rtol=0)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=2e-2, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_dots_match_jax(causal):
    q, k, v = _qkv(6, 1, 96, 96, 2, 32)
    kw = dict(causal=causal, bf16_dots=True)
    want_out = jfa.flash_attention(*_j(q, k, v), **kw)
    want = _jax_grads(q, k, v, jnp.float32, **kw)
    out, got = _torch_grads(q, k, v, torch.float32, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-3, rtol=0)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0, err_msg=name)
    # and the rounding is real: f32 dots give another answer
    f32 = tfa.flash_attention(*_t(q, k, v), causal=causal)
    assert (f32 - out.detach()).abs().max() > 1e-4


def test_indivisible_block_raises():
    q, k, v = _t(*_qkv(7, 1, 96, 96, 1, 32))
    with pytest.raises(ValueError, match="must divide"):
        tfa.flash_attention(q, k, v, block_q=64, block_k=64)
    # an explicit block that divides is accepted and changes nothing
    np.testing.assert_array_equal(tfa.flash_attention(q, k, v, block_q=32, block_k=48).numpy(),
                                  tfa.flash_attention(q, k, v).numpy())


@pytest.mark.parametrize("length", [1, 64, 96, 128, 192, 200, 384, 1000, 1024, 3072, 4104])
def test_auto_block_matches_jax(length):
    assert tfa._auto_block(length, 1024) == jfa._auto_block(length, 1024)


def test_cpu_path_counts_no_launch_and_other_devices_are_refused():
    tfa.reset_launches()
    q, k, v = _t(*_qkv(8, 1, 32, 32, 1, 32), grad=True)
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    meta = torch.empty((1, 32, 1, 32), device="meta")
    with pytest.raises(ValueError, match="CPU .* or on a CUDA device"):
        tfa.flash_attention_fwd(meta, meta, meta, causal=True, scale=1.0)


def test_plain_function_matches_the_wrapper_on_the_cpu():
    q, k, v = _t(*_qkv(9, 2, 48, 80, 2, 32))
    for causal in (True, False):
        np.testing.assert_array_equal(
            tfa.flash_attention_plain(q, k, v, causal=causal, q_offset=40).numpy(),
            tfa.flash_attention(q, k, v, causal=causal, q_offset=40).numpy())


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Each CUDA kernel against its plain version on the card, with ragged
    lengths (not multiples of the 64-row tile), offsets and both dtypes;
    the kernels run twice and give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for (b, lq, lk, h, d, causal, qo, ko) in [(2, 100, 100, 2, 64, True, 0, 0),
                                                  (1, 64, 200, 3, 32, False, 0, 0),
                                                  (1, 130, 70, 1, 128, True, 60, 0),
                                                  (1, 64, 64, 2, 64, True, 0, 640)]:
            q, k, v = (x.cuda().to(dtype) for x in _t(*_qkv(10, b, lq, lk, h, d)))
            do = torch.randn(b, lq, h, d, device="cuda").to(dtype)
            kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko)
            tfa.reset_launches()
            out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
            grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            out2, lse2 = tfa.flash_attention_fwd(q, k, v, **kw)
            grads2 = tfa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            assert tfa.LAUNCHES == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
            assert torch.equal(out, out2) and torch.equal(lse, lse2)
            assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
            p_out, p_lse = tfa.flash_attention_fwd_plain(q, k, v, **kw)
            p_grads = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
            assert (out.float() - p_out.float()).abs().max() <= atol
            assert (lse - p_lse).abs().max() <= 1e-3
            for g, p in zip(grads, p_grads):
                assert (g.float() - p.float()).abs().max() <= atol


# -- the tensor-core kernels' arithmetic ---------------------------------------
#
# On bf16 inputs the forward, dq and dk/dv kernels run every dot on bf16 mma
# with f32 sums. q, k, v and dout are bf16, so their products are exact; p
# and ds are f32 and enter their dots as hi = bf16(x) and lo = bf16(x - hi), two
# mma summed in f32 (hi alone under bf16_dots). The model below is the plain
# forward and backward with that one change; with bf16-representable inputs
# it must meet JAX's f32 kernels at the f32 tolerances above.


def _split(x):
    """x as two bf16 terms in f32: hi = bf16_rn(x), lo = bf16_rn(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_dot(eq, x, y, bf16_dots):
    """einsum(eq, x, y) with x entering as its two bf16 terms (hi alone
    under ``bf16_dots``), each product summed in f32 and then added."""
    hi, lo = _split(x)
    out = torch.einsum(eq, hi, y)
    return out if bf16_dots else out + torch.einsum(eq, lo, y)


def _mma_model(q, k, v, do, *, causal, scale, q_offset, k_offset, bf16_dots=False):
    """(out, lse, dq, dk, dv) as the tensor-core kernels compute them, on f32
    tensors that hold bf16 values: p enters P V and dP^T dO, and ds enters
    dS K and dS^T Q, as hi + lo (hi alone under ``bf16_dots``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = tfa._visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, tfa.NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (_split_dot("bhqk,bkhd->bhqd", p, v, bf16_dots) / l_safe).transpose(1, 2)
    lse = torch.where(l == 0.0, torch.full_like(l, tfa.NEG_BIG), m + torch.log(l_safe))
    p = torch.exp(s - lse)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - tfa._delta(out, do)[..., None]) * scale
    dq = _split_dot("bhqk,bkhd->bqhd", ds, k, bf16_dots)
    dk = _split_dot("bhqk,bqhd->bkhd", ds, q, bf16_dots)
    dv = _split_dot("bhqk,bqhd->bkhd", p, do, bf16_dots)
    return out, lse[..., 0], dq, dk, dv


def _jax_one_tile(q, k, v, do, **kw):
    """JAX's interpret-mode ``_fwd`` then ``_bwd`` with one tile per (batch,
    head), under one jit: (out, lse, (dq, dk, dv))."""
    lq, lk = q.shape[1], k.shape[1]

    def run(q, k, v, do):
        out, lse = jfa._fwd(q, k, v, block_q=lq, block_k=lk, interpret=True, **kw)
        return out, lse, jfa._bwd(q, k, v, out, lse, do, block_q=lq, block_k=lk,
                                  interpret=True, **kw)
    return jax.jit(run)(*_j(q, k, v, do))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_core_arithmetic_matches_jax_f32(case):
    """The hi + lo split keeps the kernels' bf16 path at JAX's f32 answer:
    out and lse within 2e-5, gradients within 1e-4."""
    b, lq, lk, h, d, causal, qo, ko, _ = CASES[case]
    (q, k, v, do), (jout, jlse, want) = _jax_reference(case)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko)
    out, lse, *got = _mma_model(*_t(q, k, v, do), **kw)
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse[..., 0], atol=2e-5, rtol=0)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["causal", "k_offset_partly_masked"])
def test_tensor_core_arithmetic_with_bf16_dots_matches_jax(case):
    """Under ``bf16_dots`` the kernels take hi alone, which is JAX's
    ``p.astype(bfloat16)``: the tolerance of test_bf16_dots_match_jax."""
    b, lq, lk, h, d, causal, qo, ko, _ = CASES[case]
    q, k, v = _bf16_values(*_qkv(13, b, lq, lk, h, d))
    (do,) = _bf16_values(np.random.default_rng(14).normal(size=(b, lq, h, d)).astype(np.float32))
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko, bf16_dots=True)
    jout, jlse, want = _jax_one_tile(q, k, v, do, **kw)
    out, lse, *got = _mma_model(*_t(q, k, v, do), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-3, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-3, rtol=0)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0, err_msg=name)


def test_hi_lo_split_is_within_two_to_the_minus_16():
    p = torch.tensor(1.0 - np.random.default_rng(15).random(100_000), dtype=torch.float32)
    assert p.min() > 0 and p.max() <= 1
    hi, lo = _split(p)
    assert ((p - (hi + lo)).abs() / p).max() <= 2.0 ** -16
    # hi alone is bf16's own rounding, far coarser
    assert ((p - hi).abs() / p).max() > 2.0 ** -10


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_dots", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tensor_core_kernels_match_plain_on_the_card(d, bf16_dots):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv on bf16 (the mma kernels)
    against their plain versions at toy shapes with ragged lengths and
    offsets: out, dq, dk and dv within 2e-2 (bf16 outputs), lse within 1e-3;
    twice for the same bits; a row that sees no key gives zeros, lse -1e30
    and dq 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    for (b, lq, lk, h, causal, qo, ko) in [(2, 100, 100, 2, True, 0, 0),
                                           (1, 64, 200, 3, False, 0, 0),
                                           (1, 130, 70, 1, True, 60, 0),
                                           (1, 96, 160, 2, True, 0, 32),
                                           (1, 64, 64, 2, True, 0, 640)]:
        q, k, v = (x.cuda().to(torch.bfloat16) for x in _t(*_qkv(16, b, lq, lk, h, d)))
        do = torch.randn(b, lq, h, d, device="cuda").to(torch.bfloat16)
        kw = dict(causal=causal, scale=d ** -0.5, q_offset=qo, k_offset=ko,
                  bf16_dots=bf16_dots)
        tfa.reset_launches()
        runs = []
        for _ in range(2):
            out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
            delta = tfa._delta(out, do)
            runs.append((out, lse, tfa.bwd_dq_kernel(q, k, v, do, lse, delta, **kw),
                         *tfa.bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)))
        torch.cuda.synchronize()
        assert tfa.LAUNCHES == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        out, lse, dq, dk, dv = runs[0]
        p_out, p_lse = tfa.flash_attention_fwd_plain(q, k, v, **kw)
        p_dq, p_dk, p_dv = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        assert (out.float() - p_out.float()).abs().max() <= 2e-2
        assert (lse - p_lse).abs().max() <= 1e-3
        for g, p in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
            assert (g.float() - p.float()).abs().max() <= 2e-2
        if ko >= qo + lq:
            assert torch.equal(out, torch.zeros_like(out)) and (lse == tfa.NEG_BIG).all()
            assert torch.equal(dq, torch.zeros_like(dq))


def _off_16_bytes(x):
    """A copy of ``x`` whose storage starts one element past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    skip = (-flat.data_ptr() % 16) // x.element_size() + 1
    return flat[skip:skip + x.numel()].view(x.shape).copy_(x)


@pytest.mark.parametrize("wrapper", ["bwd_dq_kernel", "bwd_dkv_kernel"])
def test_backward_wrappers_refuse_bf16_off_a_16_byte_boundary(wrapper):
    """The tensor-core kernels move rows by 16-byte cp.async: both backward
    wrappers raise before they launch when a bf16 tensor does not start on
    a 16-byte boundary (checked on the host, so the CPU can hold it)."""
    q, k, v, do = (x.to(torch.bfloat16) for x in _t(*_qkv(21, 1, 64, 64, 1, 32),
                                                    np.zeros((1, 64, 1, 32))))
    lse = delta = torch.zeros(1, 1, 64)
    bad = _off_16_bytes(k)
    assert bad.data_ptr() % 16 and torch.equal(bad, k)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="16-byte boundary"):
        getattr(tfa, wrapper)(q, bad, v, do, lse, delta, causal=True, scale=0.2)
    assert not any(tfa.LAUNCHES.values())


@pytest.mark.cuda
def test_bwd_dq_kernel_refuses_bf16_off_a_16_byte_boundary_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    q, k, v, do = (x.cuda().to(torch.bfloat16) for x in _t(*_qkv(22, 1, 64, 64, 2, 64),
                                                           np.ones((1, 64, 2, 64))))
    lse = delta = torch.zeros(1, 2, 64, device="cuda")
    for i in range(4):
        args = [q, k, v, do]
        args[i] = _off_16_bytes(args[i])
        assert args[i].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte boundary"):
            tfa.bwd_dq_kernel(*args, lse, delta, causal=True, scale=0.125)



def _share_off_bf16(x, ref):
    """Share of elements of bf16 ``x`` that differ from f32 ``ref`` rounded to bf16."""
    return float((x.to(torch.bfloat16) != ref.to(torch.bfloat16)).float().mean())


def test_split_rounds_to_the_f32_answer_where_hi_alone_does_not():
    """The bound that chip_smoke.py holds the kernels to: with p and ds as
    hi + lo, out, dq, dk and dv are the f32 answer rounded to bf16 in all but
    at most 2% of elements; hi alone moves far more past a rounding edge."""
    q, k, v, do = _t(*_bf16_values(*_qkv(17, 1, 256, 256, 2, 32),
                                   np.random.default_rng(18).normal(size=(1, 256, 2, 32))))
    kw = dict(causal=True, scale=32 ** -0.5, q_offset=0, k_offset=0)
    ref_out, _ = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    for bf16_dots, check in ((False, lambda s: s <= 0.02), (True, lambda s: s > 0.02)):
        out, lse, dq, dk, dv = _mma_model(q, k, v, do, bf16_dots=bf16_dots, **kw)
        ref_dq, ref_dk, ref_dv = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        for name, x, ref in (("out", out, ref_out), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                             ("dv", dv, ref_dv)):
            assert check(_share_off_bf16(x, ref)), (name, bf16_dots)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_split_rounds_to_the_f32_answer_on_the_card(d):
    """The kernels themselves (out, dq, dk, dv) under the same bound:
    bf16_dots off (hi + lo) within 2% of elements off the f32 answer rounded
    to bf16, bf16_dots on (hi alone) beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = (x.cuda().to(torch.bfloat16) for x in _t(
        *_qkv(19, 2, 512, 512, 2, d), np.random.default_rng(20).normal(size=(2, 512, 2, d))))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    kw = dict(causal=True, scale=d ** -0.5, q_offset=0, k_offset=0)
    ref_out, _ = tfa.flash_attention_fwd_plain(qf, kf, vf, **kw)
    for bf16_dots, check in ((False, lambda s: s <= 0.02), (True, lambda s: s > 0.02)):
        out, lse = tfa.flash_attention_fwd(q, k, v, bf16_dots=bf16_dots, **kw)
        delta = tfa._delta(out, do)
        dq = tfa.bwd_dq_kernel(q, k, v, do, lse, delta, bf16_dots=bf16_dots, **kw)
        dk, dv = tfa.bwd_dkv_kernel(q, k, v, do, lse, delta, bf16_dots=bf16_dots, **kw)
        ref_dq, ref_dk, ref_dv = tfa.flash_attention_bwd_plain(qf, kf, vf, out.float(), lse,
                                                               dof, **kw)
        for name, x, ref in (("out", out, ref_out), ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                             ("dv", dv, ref_dv)):
            assert check(_share_off_bf16(x, ref)), (name, bf16_dots)
