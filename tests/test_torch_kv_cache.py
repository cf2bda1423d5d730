"""kubeflow_tpu_torch/ops/kv_cache.py against kubeflow_tpu/ops/kv_cache.py.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_kv_cache.py
does. Inputs are made with numpy from a seed and handed to both.

Tolerances: bf16/f32 row writes are copies, so exact. int8 against JAX's
eager ``quantize_kv``: exact (both divide by 127 in IEEE f32 and round half
to even). int8 against the interpret-mode kernel: XLA may rewrite the
division into a reciprocal multiply under jit, which moves a scale by up to
1 ULP and can flip a code at a rounding boundary, so codes within ±1 and
scales within 1 ULP (rtol 1.2e-7).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kubeflow_tpu.ops import kv_cache as jkv
from kubeflow_tpu_torch.ops import kv_cache as tkv

torch.set_num_threads(1)

F32_ULP = 1.2e-7  # 2**-23, one f32 ULP relative


def _paged_inputs(seed, S=5, MB=4, bt=8, H=2, D=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_blocks = S * MB
    arena = rng.normal(size=(n_blocks + 1, bt, H, D)).astype(dtype)
    new = rng.normal(size=(S, H, D)).astype(np.float32)
    cursors = rng.integers(0, MB * bt, S).astype(np.int32)
    tables = rng.permutation(n_blocks).reshape(S, MB).astype(np.int32)
    return arena, new, cursors, tables, MB * bt


@pytest.mark.parametrize("shape,tdtype,jdtype", [
    ((8, 352, 16, 64), torch.float32, jnp.float32),
    ((4, 36, 4, 8), torch.bfloat16, jnp.bfloat16),
    ((1, 8, 2, 128), torch.float32, jnp.float32),
])
def test_row_update_matches_jax_kernel(shape, tdtype, jdtype):
    S, T, H, D = shape
    rng = np.random.default_rng(0)
    cache = rng.normal(size=shape).astype(np.float32)
    new = rng.normal(size=(S, H, D)).astype(np.float32)
    cursors = rng.integers(0, T, S).astype(np.int32)
    want = jkv.kv_row_update(jnp.asarray(cache, jdtype), jnp.asarray(new, jdtype),
                             jnp.asarray(cursors))
    got = tkv.kv_row_update(torch.tensor(cache).to(tdtype), torch.tensor(new).to(tdtype),
                            torch.tensor(cursors))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_row_update_out_of_range_cursor_is_a_noop():
    S, T, H, D = 4, 16, 2, 8
    cursors = np.asarray([0, T, T + 5, 3], np.int32)
    want = jkv.kv_row_update(jnp.zeros((S, T, H, D)), jnp.ones((S, H, D)),
                             jnp.asarray(cursors))
    got = tkv.kv_row_update(torch.zeros(S, T, H, D), torch.ones(S, H, D),
                            torch.tensor(cursors))
    assert got[1].sum() == 0 and got[2].sum() == 0
    assert got[0, 0].all() and got[3, 3].all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_update_writes_in_place_and_counts_no_launch_on_cpu():
    tkv.reset_launches()
    cache = torch.zeros(2, 4, 1, 2)
    out = tkv.kv_row_update(cache, torch.ones(2, 1, 1, 2), torch.tensor([1, 2]))
    assert out is cache and cache[0, 1].sum() == 2 and cache[1, 2].sum() == 2
    assert tkv.LAUNCHES == {"kv_row_update": 0, "kv_block_update": 0,
                            "kv_block_update_quant": 0}


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    meta = torch.empty(2, 4, 1, 2, device="meta")
    with pytest.raises(ValueError, match="CPU"):
        tkv.kv_row_update(meta, meta[:, 0], torch.empty(2, device="meta"))


@pytest.mark.parametrize("seed", [7, 8])
def test_block_update_matches_jax_kernel_and_ref(seed):
    arena, new, cursors, tables, max_seq = _paged_inputs(seed)
    want = jkv.kv_block_update(jnp.asarray(arena), jnp.asarray(new), jnp.asarray(cursors),
                               jnp.asarray(tables), max_seq=max_seq, interpret=True)
    got = tkv.kv_block_update(torch.tensor(arena), torch.tensor(new),
                              torch.tensor(cursors), torch.tensor(tables), max_seq=max_seq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_update_out_of_range_and_trash_contracts():
    """A cursor at/past max_seq writes nothing; a trash table entry writes
    into the trash row (N-1) and nowhere else."""
    arena, new, _, tables, max_seq = _paged_inputs(1)
    trash = arena.shape[0] - 1
    tables[2, :] = trash
    cursors = np.asarray([max_seq, max_seq + 3, 9, 0, 5], np.int32)
    want = jkv.kv_block_update(jnp.asarray(arena), jnp.asarray(new), jnp.asarray(cursors),
                               jnp.asarray(tables), max_seq=max_seq, interpret=True)
    got = tkv.kv_block_update(torch.tensor(arena), torch.tensor(new),
                              torch.tensor(cursors), torch.tensor(tables),
                              max_seq=max_seq).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[trash, 9 % 8], new[2])
    changed = np.nonzero((got != arena).any(axis=(1, 2, 3)))[0]
    assert set(changed) == {trash, tables[3, 0], tables[4, 0]}


def test_block_update_ref_multi_token_matches_jax():
    arena, _, _, tables, max_seq = _paged_inputs(3)
    seg = np.random.default_rng(4).normal(size=(5, 3, 2, 4)).astype(np.float32)
    cursors = np.asarray([0, 6, max_seq - 2, max_seq, 13], np.int32)
    want = jkv.kv_block_update_ref(jnp.asarray(arena), jnp.asarray(seg),
                                   jnp.asarray(cursors), jnp.asarray(tables),
                                   max_seq=max_seq)
    got = tkv.kv_block_update_ref(torch.tensor(arena), torch.tensor(seg),
                                  torch.tensor(cursors), torch.tensor(tables),
                                  max_seq=max_seq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_matches_jax_eager_exactly(dtype):
    x = np.random.default_rng(5).normal(size=(3, 7, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0, codes 0
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, js = jkv.quantize_kv(jx)
    tq, ts = tkv.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.shape == (3, 7, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == 0 and (tq[0, 0, 0] == 0).all()
    np.testing.assert_array_equal(tkv.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jkv.dequantize_kv(jq, js)))


def test_block_update_quant_matches_jax():
    S, MB, bt, H, D = 3, 4, 4, 2, 8
    N, max_seq = S * MB + 1, MB * bt
    rng = np.random.default_rng(5)
    arena = rng.integers(-127, 128, (N, bt, H, D)).astype(np.int8)
    scales = rng.random((N, bt, H, 1)).astype(np.float32)
    new = rng.normal(size=(S, H, D)).astype(np.float32)
    cursors = np.asarray([0, 5, max_seq], np.int32)  # last row out of range
    tables = np.arange(S * MB).reshape(S, MB).astype(np.int32)
    got_q, got_s = tkv.kv_block_update_quant(
        torch.tensor(arena), torch.tensor(scales), torch.tensor(new),
        torch.tensor(cursors), torch.tensor(tables), max_seq=max_seq)
    # against JAX's eager quantize_kv + scatter: exact
    q, s = jkv.quantize_kv(jnp.asarray(new))
    want_q, want_s = arena.copy(), scales.copy()
    for row in range(2):
        blk, off = tables[row, cursors[row] // bt], cursors[row] % bt
        want_q[blk, off], want_s[blk, off] = np.asarray(q[row]), np.asarray(s[row])
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # against the interpret-mode Pallas kernel: codes ±1, scales 1 ULP
    kq, ks = jkv.kv_block_update_quant(
        jnp.asarray(arena), jnp.asarray(scales), jnp.asarray(new), jnp.asarray(cursors),
        jnp.asarray(tables), max_seq=max_seq, interpret=True)
    assert np.abs(got_q.numpy().astype(int) - np.asarray(kq).astype(int)).max() <= 1
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ks), rtol=F32_ULP, atol=0)


@pytest.mark.cuda
def test_kernels_bit_equal_to_plain_on_the_card():
    """Each CUDA kernel against its plain version, at small shapes with
    out-of-range cursors and one trash-table slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    arena, new, cursors, tables, max_seq = _paged_inputs(2)
    cursors[0], tables[1, :] = max_seq, arena.shape[0] - 1
    dev = "cuda"
    a, n = torch.tensor(arena, device=dev).bfloat16(), torch.tensor(new, device=dev)
    c, t = torch.tensor(cursors, device=dev), torch.tensor(tables, device=dev)
    tkv.reset_launches()
    assert torch.equal(tkv.kv_block_update(a.clone(), n, c, t, max_seq=max_seq),
                       tkv.kv_block_update_plain(a.clone(), n, c, t, max_seq=max_seq))
    cache = torch.randn(5, max_seq, 2, 4, device=dev)
    assert torch.equal(tkv.kv_row_update(cache.clone(), n, c),
                       tkv.kv_row_update_plain(cache.clone(), n, c))
    q = torch.zeros(arena.shape, dtype=torch.int8, device=dev)
    s = torch.zeros(arena.shape[:3] + (1,), device=dev)
    got = tkv.kv_block_update_quant(q.clone(), s.clone(), n, c, t, max_seq=max_seq)
    want = tkv.kv_block_update_quant_plain(q.clone(), s.clone(), n, c, t, max_seq=max_seq)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tkv.LAUNCHES == {"kv_row_update": 1, "kv_block_update": 1,
                            "kv_block_update_quant": 1}
