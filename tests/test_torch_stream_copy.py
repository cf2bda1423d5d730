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
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kubeflow_tpu_torch.e2e import stream_copy_sweep as sweep
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


@pytest.fixture()
def probe(monkeypatch):
    """The probe module (imported at first use: the kernels' test on the card
    needs none of it), its ``pl`` replaced by one whose
    ``pallas_call(..., interpret=True)``."""
    module = _probe_module()
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})

    @functools.wraps(pl.pallas_call)
    def pallas_call(*args, **kwargs):
        kwargs["interpret"] = True
        return pl.pallas_call(*args, **kwargs)

    ns.pallas_call = pallas_call
    monkeypatch.setattr(module, "pl", ns)
    return module


def _inputs(shape, seed=0):
    a = np.random.RandomState(seed).randn(*shape)
    return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("shape,block", [((64, 128), (16, 128)),
                                         ((4, 8, 8, 128), (1, 8, 8, 128))])
def test_plain_matches_pallas_copy_bit_for_bit(probe, shape, block):
    jx, tx = _inputs(shape)
    want = probe._pallas_copy(shape, block)(jx)
    got = sc.stream_copy(tx, block)
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))


def test_plain_matches_manual_dma_copy_bit_for_bit(probe):
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


def test_sweep_launch_takes_cuda_tensors_only():
    """The sweep's ``launch`` has no plain version: a CPU tensor raises
    before any library is loaded."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    for kernel in ("stream_copy", "stream_copy_dma"):
        with pytest.raises(ValueError):
            sweep.launch(kernel, sweep.CHOSEN[kernel], x, torch.empty_like(x))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    sc.reset_launches()
    _, tx = _inputs((4, 8, 8, 128), seed=3)
    flat = tx.view(-1, 128)
    want = sc.stream_copy_plain(flat)
    assert torch.equal(sc.stream_copy(flat, (32, 128)), want)
    assert torch.equal(sc.stream_copy(tx, (1, 8, 8, 128)).view(-1, 128), want)
    assert torch.equal(sc.stream_copy_dma(flat, 64), want)
    assert sc.LAUNCHES == {"stream_copy": 0, "stream_copy_dma": 0}


# -- the ring schedule of stream_copy_dma, mirrored in Python -------------------


class _Barrier:
    """An mbarrier: ``count`` arrivals and a transaction count per phase;
    ``phase`` is the number of phases completed."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._step()

    def complete_tx(self, n):
        self.tx -= n
        self._step()

    def _step(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passes(self, parity):
        """``mbarrier.try_wait.parity``: true once the phase of this parity
        has completed, i.e. the current phase has the other parity."""
        return (self.phase & 1) != parity


def _ring_grid(n_tiles, sms, blocks_per_sm, tiles_per_block):
    """The grid of ``launch_ring``: a block every ``tiles_per_block`` tiles,
    or for 0 the persistent grid of ``grid_size``."""
    if tiles_per_block:
        return -(-n_tiles // tiles_per_block)
    return min(n_tiles, sms * blocks_per_sm)


def _block_tiles(block, grid, n_tiles, tiles_per_block):
    """The tiles a ring block takes: ``first + i * step`` for i <
    ``n_local``, as in ``stream_copy_dma_kernel``."""
    if tiles_per_block:
        first = block * tiles_per_block
        return list(range(first, min(first + tiles_per_block, n_tiles)))
    n_local = (n_tiles - 1 - block) // grid + 1 if block < n_tiles else 0
    return [block + i * grid for i in range(n_local)]


def _run_ring_block(block, grid, n_bytes, tile, tiles_per_block, stages, consumers, lag, rng,
                    out, loads):
    """One block of ``stream_copy_dma_kernel`` (its producer lane and its
    consumer warps' schedule, line for line) under a random interleaving,
    with the bulk loads landing and the bulk stores reading their stage at
    random later steps. Each 16-byte vector of shared memory holds a tag:
    2 t for tile t as loaded, 2 t + 1 once scaled. Counts each tile's loads
    in ``loads`` and each output vector's stores in ``out``."""
    n_tiles = -(-n_bytes // tile)
    tiles = _block_tiles(block, grid, n_tiles, tiles_per_block)
    tile_v = tile // 16
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(consumers) for _ in range(stages)]
    smem = np.full((stages, tile_v), -1)
    reading = [0] * stages  # bulk stores still reading each stage
    copies = []  # in flight: ("load", st, t, nv) or ("store", group)
    moves = [0]  # steps that changed the state, to tell a stall

    def wait(bar, parity, phase):
        # the wait's parity must name the phase the schedule means, and the
        # barrier must not have run a whole phase past it
        while not bar.passes(parity):
            yield
        assert parity == phase & 1 and bar.phase == phase + 1, (bar.phase, phase)

    def nbytes(t):
        return min(tile, n_bytes - t * tile)

    def producer():
        for i, t in enumerate(tiles):
            st, rnd = i % stages, i // stages
            if rnd > 0:
                yield from wait(empty[st], (rnd - 1) & 1, rnd - 1)
                # no stage is reloaded before its last tile was scaled and
                # every store of it has read it
                last = tiles[i - stages]
                assert np.all(smem[st, :nbytes(last) // 16] == 2 * last + 1)
            assert reading[st] == 0, "a stage reloaded while a store reads it"
            full[st].arrive(tx=nbytes(t))  # mbarrier.arrive.expect_tx
            copies.append(("load", st, t, nbytes(t) // 16))
            loads[t] += 1
            moves[0] += 1

    def consumer(w):
        groups = []
        for i, t in enumerate(tiles):
            st = i % stages
            nv = nbytes(t) // 16
            lo, hi = nv * w // consumers, nv * (w + 1) // consumers
            yield from wait(full[st], (i // stages) & 1, i // stages)
            assert np.all(smem[st, lo:hi] == 2 * t), "scaled a slice that is not tile t"
            smem[st, lo:hi] = 2 * t + 1
            group = dict(st=st, t=t, lo=lo, hi=hi, read=hi == lo)
            if hi > lo:
                reading[st] += 1
                copies.append(("store", group))
            groups.append(group)
            moves[0] += 1
            if i >= lag:  # wait_group.read lag, then free tile i - lag's stage
                while not all(g["read"] for g in groups[:len(groups) - lag]):
                    yield
                empty[(i - lag) % stages].arrive()
                moves[0] += 1
        while not all(g["read"] for g in groups):  # wait_group 0
            yield

    actors = [producer()] + [consumer(w) for w in range(consumers)]
    idle = set()  # actors that made no move since the last move of any
    while actors or copies:
        k = rng.randint(len(actors) + len(copies))
        if k < len(actors):
            before = moves[0]
            try:
                next(actors[k])
            except StopIteration:
                actors.pop(k)
                idle.clear()
                continue
            if moves[0] == before:
                idle.add(id(actors[k]))
                assert copies or len(idle) < len(actors), "the ring stalls"
            else:
                idle.clear()
            continue
        idle.clear()
        copy = copies.pop(k - len(actors))
        if copy[0] == "load":
            _, st, t, nv = copy
            assert reading[st] == 0
            smem[st, :nv] = 2 * t
            full[st].complete_tx(nv * 16)
        else:
            g = copy[1]
            assert np.all(smem[g["st"], g["lo"]:g["hi"]] == 2 * g["t"] + 1)
            out[g["t"] * tile_v + g["lo"]:g["t"] * tile_v + g["hi"]] += 1
            reading[g["st"]] -= 1
            g["read"] = True


@pytest.mark.parametrize("n_bytes,tile,sms,blocks_per_sm,tiles_per_block", [
    (3 * 64, 64, 4, 2, 0),          # fewer tiles than blocks
    (8 * 64, 64, 4, 2, 0),          # one tile a block
    (20 * 64 + 16, 64, 2, 2, 0),    # a partial last tile of one vector: empty slices
    (50 * 64, 64, 2, 2, 0),         # many tiles a block, more than the stages
    (37 * 96 + 48, 96, 3, 1, 0),    # a partial last tile, an odd grid
    (37 * 96 + 48, 96, 0, 0, 5),    # runs of 5 tiles, the last run short and partial
    (2 * 64, 64, 0, 0, 8),          # fewer tiles than one run
])
@pytest.mark.parametrize("stages,lag", [(2, 0), (2, 1), (3, 1), (4, 2), (8, 1), (8, 3)])
@pytest.mark.parametrize("consumers", [1, 3])
def test_ring_schedule_loads_and_stores_every_tile_once(n_bytes, tile, sms, blocks_per_sm,
                                                        tiles_per_block, stages, lag,
                                                        consumers):
    """A Python mirror of ``stream_copy_dma_kernel``'s ring: each block's
    tiles, stage ``i % S`` and waits of parity ``(i / S) & 1`` on ``full``
    and ``(i / S - 1) & 1`` on ``empty``, a consumer freeing tile i - lag's
    stage after tile i's store, under random interleavings of the warps and
    of the copies' completions. Every tile is loaded once, every
    output vector stored once, no stage is reloaded while a store still
    reads it, and every wait meets its barrier in the phase it names."""
    n_tiles = -(-n_bytes // tile)
    grid = _ring_grid(n_tiles, sms, blocks_per_sm, tiles_per_block)
    taken = [t for b in range(grid) for t in _block_tiles(b, grid, n_tiles, tiles_per_block)]
    assert sorted(taken) == list(range(n_tiles))
    for seed in range(4):
        rng = np.random.RandomState(seed)
        out = np.zeros(n_tiles * tile // 16, np.int64)
        loads = np.zeros(n_tiles, np.int64)
        for b in range(grid):
            _run_ring_block(b, grid, n_bytes, tile, tiles_per_block, stages, consumers, lag,
                            rng, out, loads)
        assert np.all(loads == 1)
        assert np.all(out[:n_bytes // 16] == 1) and np.all(out[n_bytes // 16:] == 0)


def _source_constants():
    src = (Path(sc.__file__).parent / "csrc" / sc.SOURCE).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_the_sweep_names_the_configurations_the_source_launches():
    """``stream_copy_sweep.CHOSEN`` is what the wrappers' entries launch:
    the COPY_* and DMA_* constants of the source; every ring variant of the
    sweep fits in shared memory, and the chosen ones are among them."""
    c = _source_constants()
    copy, dma = sweep.CHOSEN["stream_copy"], sweep.CHOSEN["stream_copy_dma"]
    assert (c["COPY_THREADS"], c["COPY_UNROLL"], c["COPY_LOAD"], c["COPY_STORE"],
            c["COPY_BLOCKS_PER_SM"]) == (copy["threads"], copy["unroll"],
                                         sweep.LOADS[copy["load"]],
                                         sweep.STORES[copy["store"]], copy["blocks_per_sm"])
    assert (c["DMA_STAGES"], c["DMA_TILE"], c["DMA_BLOCKS_PER_SM"], c["DMA_TILES_PER_BLOCK"],
            c["DMA_CONSUMER_WARPS"], c["DMA_STORE_LAG"], c["DMA_EVICT_FIRST"]) == (
                dma["stages"], dma["tile"], dma["blocks_per_sm"], dma["tiles_per_block"],
                dma["consumer_warps"], dma["store_lag"], dma["evict_first"])
    assert c["SMEM_PER_BLOCK"] == sweep.SMEM_PER_BLOCK
    for kernel in ("stream_copy", "stream_copy_dma"):
        vs = sweep.variants(kernel)
        assert vs[0] == sweep.PARENT[kernel] and sweep.CHOSEN[kernel] in vs
        assert len({sweep.label(v) for v in vs}) == len(vs)
    rings = [v for v in sweep.variants("stream_copy_dma") if v["design"] == "ring"]
    assert all(sweep.ring_fits(v["stages"], v["tile"], max(v["blocks_per_sm"], 1))
               and (v["blocks_per_sm"] > 0) != (v["tiles_per_block"] > 0) for v in rings)
    assert all(2 <= v["stages"] <= c["RING_MAX_STAGES"]
               and v["consumer_warps"] <= c["RING_MAX_CONSUMERS"]
               and v["store_lag"] <= min(c["RING_MAX_STORE_LAG"], v["stages"] - 1)
               for v in rings)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """Both kernels against the plain version on the card, bit for bit and
    twice: through the wrappers at sizes with a partial last tile of the DMA
    kernel, and every variant the sweep launches at sizes with fewer tiles
    than blocks, than ring stages x blocks, and a partial last chunk or
    tile, each into an output filled with other bits first."""
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # elements: one vector; one partial 16 KB tile; 6 tiles of 16 KB, the
    # last partial; 3 tiles of 16 KB a block at two blocks an SM, plus 48 bytes
    for n in (8, 4104, 5 * 8192 + 8, 3 * 2 * sms * 8192 + 24):
        x = torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)
        want = sc.stream_copy_plain(x)
        out = torch.empty_like(x)
        for kernel in ("stream_copy", "stream_copy_dma"):
            for v in sweep.variants(kernel):
                for _ in range(2):
                    out.fill_(7.0)
                    sweep.launch(kernel, v, x, out)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (kernel, sweep.label(v), n)
