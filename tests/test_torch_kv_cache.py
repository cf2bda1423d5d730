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
    assert tkv.LAUNCHES == {"kv_row_update": 0, "kv_row_update_pair": 0,
                            "kv_block_update": 0, "kv_block_update_quant": 0,
                            "kv_block_update_pair": 0, "kv_block_update_quant_pair": 0}


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    meta = torch.empty(2, 4, 1, 2, device="meta")
    with pytest.raises(ValueError, match="CPU"):
        tkv.kv_row_update(meta, meta[:, 0], torch.empty(2, device="meta"))


def _row_pair_inputs(seed, S=6, T=24, H=2, D=8):
    """K and V caches, rows and cursors: cursors T and T + 5 (no-ops) among
    in-range ones, 0 and T - 1 included."""
    rng = np.random.default_rng(seed)
    caches = [rng.normal(size=(S, T, H, D)).astype(np.float32) for _ in range(2)]
    news = [rng.normal(size=(S, H, D)).astype(np.float32) for _ in range(2)]
    cursors = rng.integers(0, T, S).astype(np.int32)
    cursors[:4] = [T, 0, T + 5, T - 1]
    return caches, news, rng.permutation(cursors).astype(np.int32)


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32),
                                           (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_row_pair_equals_two_jax_kernel_calls(seed, tdtype, jdtype):
    """kv_row_update_pair on CPU tensors against the interpret-mode JAX
    kernel run once for K and once for V: exact (row copies); the slots at
    T and T + 5 keep their rows."""
    caches, news, cursors = _row_pair_inputs(seed)
    want = [jkv.kv_row_update(jnp.asarray(c, jdtype), jnp.asarray(n, jdtype),
                              jnp.asarray(cursors), interpret=True)
            for c, n in zip(caches, news)]
    k_cache, v_cache = (torch.tensor(c).to(tdtype) for c in caches)
    before = [k_cache.clone(), v_cache.clone()]
    tkv.reset_launches()
    got = tkv.kv_row_update_pair(k_cache, v_cache, *(torch.tensor(n).to(tdtype) for n in news),
                                 torch.tensor(cursors))
    assert got[0] is k_cache and got[1] is v_cache  # in place
    assert not any(tkv.LAUNCHES.values())  # CPU tensors: plain versions
    T = caches[0].shape[1]
    for g, w, b in zip(got, want, before):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
        assert torch.equal(g[cursors >= T], b[cursors >= T])


def _row_refusals():
    """(label, reason, caches, rows) the contiguous pair must refuse."""
    c = torch.zeros(2, 8, 2, 4)
    big = torch.zeros(3, 8, 2, 4)
    rows = (torch.ones(2, 2, 4), torch.ones(2, 2, 4))
    return [
        ("the same tensor twice", "overlap", (c, c), rows),
        ("overlapping views", "overlap", (big[:2], big[1:]), rows),
        ("shapes differ", "differ", (c, torch.zeros(2, 9, 2, 4)), rows),
        ("dtypes differ", "differ", (c, c.clone().bfloat16()), rows),
        ("not contiguous", "contiguous", (c, torch.zeros(2, 8, 2, 5)[..., :4]), rows),
        ("a transposed cache", "contiguous", (c, torch.zeros(2, 8, 4, 2).transpose(2, 3)),
         rows),
        ("rows of two dtypes", "rows differ", (c, c.clone()),
         (rows[0], rows[1].double())),
        ("rows of the wrong shape", "needs new", (c, c.clone()),
         (torch.ones(3, 2, 4), torch.ones(3, 2, 4))),
        ("a cache on another device", "all tensors", (c, torch.zeros(2, 8, 2, 4, device="meta")),
         rows),
        ("rows on another device", "all tensors", (c, c.clone()),
         (rows[0], torch.ones(2, 2, 4, device="meta"))),
    ]


@pytest.mark.parametrize("label,reason,caches,rows", _row_refusals(),
                         ids=[r[0] for r in _row_refusals()])
def test_row_pair_refuses_unsafe_caches(label, reason, caches, rows):
    """Caches the contiguous pair kernel cannot write safely are refused on
    the CPU too (the same checks run on CUDA tensors before the launch),
    and nothing is written."""
    before = [c.clone() for c in caches if c.device.type == "cpu"]
    with pytest.raises(ValueError, match=reason):
        tkv.kv_row_update_pair(*caches, *rows, torch.tensor([0, 3], dtype=torch.int32))
    after = [c for c in caches if c.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_row_cfg_needs_cuda():
    c = torch.zeros(2, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tkv.kv_row_update_cfg(1, c, c.clone(), torch.ones(2, 2, 4), torch.ones(2, 2, 4),
                              torch.tensor([0, 3]))


@pytest.mark.parametrize("kv_kernel", [True, False])
def test_contiguous_decode_writes_each_layer_with_one_pair_call(monkeypatch, kv_kernel):
    """A single-token per-slot decode step on the contiguous cache calls
    kv_row_update_pair once a layer (K and V together) when kv_kernel is
    on, and never when it is off; both give the same cache bit for bit."""
    from kubeflow_tpu_torch.models.gpt import GptConfig, GptLM, init_params

    cfg = GptConfig(d_model=32, n_layers=3, n_heads=2, d_ff=64, max_seq=16,
                    vocab_size=61, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    calls = []
    pair = tkv.kv_row_update_pair

    def spy(*args):
        calls.append(args[0].shape)
        return pair(*args)

    monkeypatch.setattr(tkv, "kv_row_update_pair", spy)

    def step(kernel):
        cache = {f"block_{i}": {"attention": {
            "k": torch.zeros(3, 16, 2, 16), "v": torch.zeros(3, 16, 2, 16),
            "cursors": torch.tensor([0, 7, 16], dtype=torch.int32)}}
            for i in range(cfg.n_layers)}
        model = GptLM.bind(cfg, params, decode=True, per_slot=True, paged=False,
                           kv_kernel=kernel)
        with torch.no_grad():
            logits = model(torch.tensor([[5], [9], [2]]), cache)
        return logits, cache

    logits, cache = step(kv_kernel)
    assert len(calls) == (cfg.n_layers if kv_kernel else 0)
    calls.clear()
    want_logits, want = step(not kv_kernel)
    assert torch.equal(logits, want_logits)
    for i in range(cfg.n_layers):
        for key in ("k", "v", "cursors"):
            got_t, want_t = cache[f"block_{i}"]["attention"][key], \
                want[f"block_{i}"]["attention"][key]
            assert torch.equal(got_t, want_t)
    assert cache["block_0"]["attention"]["k"][1, 7].abs().sum() > 0  # written
    assert cache["block_0"]["attention"]["k"][2].abs().sum() == 0  # cursor 16: no-op


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


def _pair_inputs(seed, quant=False, dtype=np.float32):
    """K and V arenas (int8 with f32 scales when ``quant``), rows, cursors
    and tables over one arena geometry."""
    arena, new, cursors, tables, max_seq = _paged_inputs(seed, dtype=dtype)
    rng = np.random.default_rng(seed + 100)
    v_new = rng.normal(size=new.shape).astype(np.float32)
    if not quant:
        v_arena = rng.normal(size=arena.shape).astype(dtype)
        return (arena, v_arena), (new, v_new), cursors, tables, max_seq
    shape = arena.shape
    q = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    sc = [rng.random(shape[:3] + (1,)).astype(np.float32) for _ in range(2)]
    return (q[0], sc[0], q[1], sc[1]), (new, v_new), cursors, tables, max_seq


@pytest.mark.parametrize("seed,tdtype,jdtype", [(11, torch.float32, jnp.float32),
                                                (12, torch.bfloat16, jnp.bfloat16)])
def test_pair_equals_two_jax_kernel_calls(seed, tdtype, jdtype):
    """kv_block_update_pair on CPU tensors against the interpret-mode JAX
    kernel run once for K and once for V: exact (row copies)."""
    (ka, va), (kn, vn), cursors, tables, max_seq = _pair_inputs(seed)
    want = [jkv.kv_block_update(jnp.asarray(a, jdtype), jnp.asarray(n, jdtype),
                                jnp.asarray(cursors), jnp.asarray(tables),
                                max_seq=max_seq, interpret=True)
            for a, n in ((ka, kn), (va, vn))]
    k_arena, v_arena = torch.tensor(ka).to(tdtype), torch.tensor(va).to(tdtype)
    got = tkv.kv_block_update_pair(k_arena, v_arena, torch.tensor(kn).to(tdtype),
                                   torch.tensor(vn).to(tdtype), torch.tensor(cursors),
                                   torch.tensor(tables), max_seq=max_seq)
    assert got[0] is k_arena and got[1] is v_arena  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("seed", [13, 14])
def test_quant_pair_equals_two_jax_kernel_calls(seed):
    """kv_block_update_quant_pair on CPU tensors: exact against JAX's eager
    quantize_kv scattered through the tables, and within the C.3 tolerance
    (codes ±1, scales 1 ULP) of the interpret-mode kernel run for K and V."""
    arenas, news, cursors, tables, max_seq = _pair_inputs(seed, quant=True)
    bt = arenas[0].shape[1]
    t = [torch.tensor(a) for a in arenas]
    got = tkv.kv_block_update_quant_pair(*t, *(torch.tensor(n) for n in news),
                                         torch.tensor(cursors), torch.tensor(tables),
                                         max_seq=max_seq)
    assert all(g is x for g, x in zip(got, t))
    for i, new in enumerate(news):
        q0, s0 = arenas[2 * i], arenas[2 * i + 1]
        q, s = jkv.quantize_kv(jnp.asarray(new))
        want_q, want_s = q0.copy(), s0.copy()
        for row, cur in enumerate(cursors):
            blk, off = tables[row, cur // bt], cur % bt
            want_q[blk, off], want_s[blk, off] = np.asarray(q[row]), np.asarray(s[row])
        np.testing.assert_array_equal(got[2 * i].numpy(), want_q)
        np.testing.assert_array_equal(got[2 * i + 1].numpy(), want_s)
        kq, ks = jkv.kv_block_update_quant(
            jnp.asarray(q0), jnp.asarray(s0), jnp.asarray(new), jnp.asarray(cursors),
            jnp.asarray(tables), max_seq=max_seq, interpret=True)
        assert np.abs(got[2 * i].numpy().astype(int) - np.asarray(kq).astype(int)).max() <= 1
        np.testing.assert_allclose(got[2 * i + 1].numpy(), np.asarray(ks), rtol=F32_ULP,
                                   atol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_pair_out_of_range_and_trash_contracts(quant):
    """In both arenas: cursors outside [0, max_seq) and a table entry >= N
    write nothing; a trash table row writes the trash row; every other slot
    writes its own row (and scale)."""
    arenas, news, cursors, tables, max_seq = _pair_inputs(21, quant=quant)
    N, bt = arenas[0].shape[:2]
    trash = N - 1
    cursors = np.asarray([max_seq, -1, 9, 0, 5], np.int32)
    tables[2, :] = trash
    tables[3, 0] = N + 4
    t = [torch.tensor(a) for a in arenas]
    args = (torch.tensor(news[0]), torch.tensor(news[1]), torch.tensor(cursors),
            torch.tensor(tables))
    tkv.reset_launches()
    if quant:
        got = [g.numpy() for g in tkv.kv_block_update_quant_pair(*t, *args, max_seq=max_seq)]
    else:
        got = [g.numpy() for g in tkv.kv_block_update_pair(*t, *args, max_seq=max_seq)]
    assert not any(tkv.LAUNCHES.values())  # CPU tensors: plain versions
    per = 2 if quant else 1
    for i, new in enumerate(news):
        arena, out = arenas[per * i], got[per * i]
        changed = set(np.nonzero((out != arena).any(axis=(1, 2, 3)))[0])
        assert changed == {trash, tables[4, 0]}
        rows = {(trash, 9 % bt): 2, (tables[4, 0], 5): 4}
        for (blk, off), slot in rows.items():
            if quant:
                q, s = tkv.quantize_kv(torch.tensor(new[slot]))
                np.testing.assert_array_equal(out[blk, off], q.numpy())
                np.testing.assert_array_equal(got[per * i + 1][blk, off], s.numpy())
            else:
                np.testing.assert_array_equal(out[blk, off], new[slot])


def _refusals():
    """(label, reason, quant, arenas) the pair wrappers must refuse."""
    a = torch.zeros(9, 4, 2, 8)
    big = torch.zeros(17, 4, 2, 8)
    q = torch.zeros(9, 4, 2, 8, dtype=torch.int8)
    s = torch.zeros(9, 4, 2, 1)
    qbuf = torch.zeros(2 * 576, dtype=torch.int8)
    return [
        ("the same tensor twice", "overlap", False, (a, a)),
        ("overlapping views", "overlap", False, (big[:9], big[8:])),
        ("shapes differ", "differ", False, (a, torch.zeros(10, 4, 2, 8))),
        ("dtypes differ", "differ", False, (a, a.clone().bfloat16())),
        ("not contiguous", "contiguous", False, (a, torch.zeros(9, 4, 2, 9)[..., :8])),
        ("a transposed arena", "contiguous", False, (a, torch.zeros(9, 4, 8, 2).transpose(2, 3))),
        ("K and V scales the same", "overlap", True, (q, s, q.clone(), s)),
        ("overlapping int8 arenas", "overlap", True,
         (qbuf[:576].view(9, 4, 2, 8), s, qbuf[288:864].view(9, 4, 2, 8), s.clone())),
        ("int8 arenas of different shapes", "differ", True,
         (q, s, torch.zeros(9, 4, 2, 4, dtype=torch.int8), torch.zeros(9, 4, 2, 1))),
    ]


@pytest.mark.parametrize("label,reason,quant,arenas", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_pair_wrappers_refuse_unsafe_arenas(label, reason, quant, arenas):
    """Arenas the pair kernel cannot write safely are refused (the same
    checks run on CUDA tensors before the launch), and nothing is written."""
    S, H, D = 2, 2, 8
    rows = (torch.ones(S, H, D), torch.ones(S, H, D))
    cursors, tables = torch.tensor([0, 5], dtype=torch.int32), torch.tensor([[0, 1], [2, 3]])
    before = [a.clone() for a in arenas]
    fn = tkv.kv_block_update_quant_pair if quant else tkv.kv_block_update_pair
    with pytest.raises(ValueError, match=reason):
        fn(*arenas, *rows, cursors, tables, max_seq=8)
    assert all(torch.equal(a, b) for a, b in zip(arenas, before))


def test_pair_refuses_mismatched_rows_and_cfg_needs_cuda():
    a, b = torch.zeros(9, 4, 2, 8), torch.zeros(9, 4, 2, 8)
    cursors, tables = torch.tensor([0, 5], dtype=torch.int32), torch.tensor([[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="rows differ"):
        tkv.kv_block_update_pair(a, b, torch.ones(2, 2, 8), torch.ones(2, 2, 8).double(),
                                 cursors, tables, max_seq=8)
    with pytest.raises(ValueError, match="need new"):
        tkv.kv_block_update_pair(a, b, torch.ones(3, 2, 8), torch.ones(3, 2, 8),
                                 cursors, tables, max_seq=8)
    with pytest.raises(ValueError, match="CUDA"):
        tkv.kv_block_update_cfg(0, a, b, torch.ones(2, 2, 8), torch.ones(2, 2, 8),
                                cursors, tables, max_seq=8)


@pytest.mark.cuda
def test_kernels_bit_equal_to_plain_on_the_card():
    """Each CUDA kernel against its plain version, at small shapes with
    out-of-range cursors and one trash-table slot: the one-array wrappers,
    the three pair wrappers (the contiguous one on 16-byte and on odd rows),
    and every design of the contiguous and the paged writes."""
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
    v_cache, vn = torch.randn_like(cache), torch.randn_like(n)
    row_want = tkv.kv_row_update_pair_plain(cache.clone(), v_cache.clone(), n, vn, c)
    got = tkv.kv_row_update_pair(cache.clone(), v_cache.clone(), n, vn, c)
    assert all(torch.equal(x, y) for x, y in zip(got, row_want))
    odd = torch.randn(5, max_seq, 3, 3, device=dev)  # 36-byte rows: the byte-wise path
    on = torch.randn(5, 3, 3, device=dev)
    got = tkv.kv_row_update_pair(odd.clone(), odd.clone() + 1, on, on * 2, c)
    want = tkv.kv_row_update_pair_plain(odd.clone(), odd.clone() + 1, on, on * 2, c)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    for design in (0, 1):
        got = (cache.clone(), v_cache.clone())
        tkv.kv_row_update_cfg(design, *got, n, vn, c)
        assert all(torch.equal(x, y) for x, y in zip(got, row_want)), design
    q = torch.zeros(arena.shape, dtype=torch.int8, device=dev)
    s = torch.zeros(arena.shape[:3] + (1,), device=dev)
    got = tkv.kv_block_update_quant(q.clone(), s.clone(), n, c, t, max_seq=max_seq)
    want = tkv.kv_block_update_quant_plain(q.clone(), s.clone(), n, c, t, max_seq=max_seq)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    v, b = torch.randn_like(n), torch.randn_like(a)
    got = tkv.kv_block_update_pair(a.clone(), b.clone(), n, v, c, t, max_seq=max_seq)
    want = tkv.kv_block_update_pair_plain(a.clone(), b.clone(), n.bfloat16(), v.bfloat16(),
                                          c, t, max_seq=max_seq)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    for nn in (n, n.bfloat16()):
        vv = v.to(nn.dtype)
        got = tkv.kv_block_update_quant_pair(q.clone(), s.clone(), q.clone(), s.clone(),
                                             nn, vv, c, t, max_seq=max_seq)
        want = tkv.kv_block_update_quant_pair_plain(q.clone(), s.clone(), q.clone(),
                                                    s.clone(), nn, vv, c, t,
                                                    max_seq=max_seq)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tkv.LAUNCHES == {"kv_row_update": 1, "kv_row_update_pair": 2,
                            "kv_block_update": 1, "kv_block_update_quant": 1,
                            "kv_block_update_pair": 1, "kv_block_update_quant_pair": 2}
    want = tkv.kv_block_update_pair_plain(a.clone(), b.clone(), n.bfloat16(), v.bfloat16(),
                                          c, t, max_seq=max_seq)
    wantq = tkv.kv_block_update_quant_pair_plain(q.clone(), s.clone(), q.clone(), s.clone(),
                                                 n, v, c, t, max_seq=max_seq)
    for design in (0, 1):
        got = (a.clone(), b.clone())
        tkv.kv_block_update_cfg(design, *got, n, v, c, t, max_seq=max_seq)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), design
        got = (q.clone(), s.clone(), q.clone(), s.clone())
        tkv.kv_block_update_cfg(design, got[0], got[2], n, v, c, t, max_seq=max_seq,
                                k_scales=got[1], v_scales=got[3])
        assert all(torch.equal(x, y) for x, y in zip(got, wantq)), design
    torch.cuda.synchronize()
    # cfg launches count nothing
    assert tkv.LAUNCHES["kv_block_update_pair"] == 1 and tkv.LAUNCHES["kv_row_update_pair"] == 2


@pytest.mark.cuda
def test_spec_round_tokens_equal_the_plain_engine_on_the_card():
    """A speculative engine on the card (f32 tiny config, spec_k 4), with
    the 1-layer self-draft and with the target as its own draft: its greedy
    tokens are the plain engine's, and the draft's one-row writes launched
    ``kv_row_update_pair`` once per draft layer and draft step, the
    target's verify no KV kernel. The target as draft accepts every draft
    (m = k each round), so rounds that commit several tokens and roll
    back nothing are held to the plain engine too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    import dataclasses

    from kubeflow_tpu_torch.models.gpt import GptConfig, init_params
    from kubeflow_tpu_torch.runtime.metrics import METRICS
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.training.distill import draft_config, init_from_target

    cfg = GptConfig(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=128, vocab_size=101,
                    dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cuda")
    dcfg = dataclasses.replace(draft_config(cfg), dtype=torch.float32)
    jobs = [(np.random.default_rng(s).integers(0, 101, n).astype(np.int32), b)
            for s, n, b in ((1, 3, 6), (2, 17, 9), (3, 7, 4), (4, 30, 11), (5, 12, 5))]

    def run(**kw):
        eng = ContinuousBatcher(cfg, params, slots=3, device="cuda", **kw)
        try:
            futs = [eng.submit(p, b) for p, b in jobs]
            return [f.result(timeout=300) for f in futs]
        finally:
            eng.close()

    plain = run()
    names = ("serving_spec_rounds_total", "serving_spec_tokens_drafted_total",
             "serving_spec_tokens_accepted_total")
    for draft in ((dcfg, init_from_target(dcfg, params)), (cfg, params)):
        tkv.reset_launches()
        before = [METRICS.value(n) for n in names]
        got = run(spec_k=4, spec_draft=draft)
        rounds, drafted, accepted = (METRICS.value(n) - b for n, b in zip(names, before))
        assert got == plain
        assert rounds > 0
        assert tkv.LAUNCHES["kv_row_update_pair"] == draft[0].n_layers * 4 * rounds
        assert tkv.LAUNCHES["kv_block_update_pair"] == 0
    assert drafted > 0 and accepted == drafted
