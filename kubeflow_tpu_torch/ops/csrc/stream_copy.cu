// Streaming-copy kernels of the device-evidence probe (sm_90a).
//
// Both compute o = bf16(float(x) * s) over a contiguous bf16 array, rounded
// to nearest even (__floats2bfloat162_rn). With s = bf16(0.97) = 0.96875 the
// f32 product of two bf16 values is exact, so this is the TPU's bf16
// multiply bit for bit and equals the plain PyTorch `x * SCALE`:
//
//   stream_copy      replaces e2e/fused_bottleneck_probe.py `_pallas_copy`
//                    (Pallas `kern`, :95): the copy block-pipelined by the
//                    Pallas grid's automatic double-buffering.
//   stream_copy_dma  replaces `_manual_dma_copy` (Pallas `kern`, :107): the
//                    same product, hand double-buffered — DMA in, scale,
//                    DMA out, two VMEM slots each way.
//
// Bound. The probe's array is bf16 [256 * 56 * 56, 256]: 411,041,792 bytes
// read and as many written, 822 MB. One multiply per element is nothing
// beside that: both kernels are bound by bytes, and their design is about
// the shape of the stream they put to device memory. The sweep
// (kubeflow_tpu_torch/e2e/stream_copy_sweep.py) times every configuration
// below on the card; what it taught shaped both designs: short blocks, each
// on one contiguous span of 16 KB, many of them resident an SM, with some
// 48-112 KB in flight an SM, stream faster than persistent blocks or long
// ones, whose spans drift apart over the array; cache hints change nothing.
//
// stream_copy: the threads move the bytes. The array is cut into chunks of
// blockDim * U 16-byte vectors, and a block owns a chunk: thread t loads
// vectors t, t + blockDim, ..., t + (U - 1) * blockDim of it (each warp
// access one coalesced 512-byte run), all U before any store, then scales
// and stores them. The grid holds one block a chunk, as PyTorch launches its
// own elementwise kernels, so blocks start in chunk order; with
// blocks_per_sm > 0 a persistent grid walks the chunks instead (block b
// takes chunks b, b + grid, ...). The load can carry the evict-first hint
// (ld.global.cs), or bypass L1 with an L2 256-byte prefetch
// (ld.global.nc.L1::no_allocate.L2::256B), or neither; the store the
// evict-first hint (st.global.cs) or none. The wrapper's entry
// `stream_copy` launches the COPY_* constants below: 1024 threads, one
// vector each, no hint.
//
// stream_copy_dma keeps what makes `_manual_dma_copy` a different kernel:
// the copy engine moves the bytes (TMA's 1-D bulk copies, cp.async.bulk)
// and the threads only scale. A block walks its tiles of T bytes through a
// ring of S stages in dynamic shared memory, warp-specialised:
//   - the last warp is the producer: one lane issues the bulk load of each
//     tile into the next stage as soon as that stage is empty, so loads run
//     up to S - 1 - lag tiles ahead of the tile being scaled (the JAX
//     schedule's one-ahead prefetch, fused_bottleneck_probe.py:119-141,
//     made deeper);
//   - every other warp is a consumer and owns a fixed slice of each tile:
//     it waits on the stage's `full` mbarrier (expect_tx by the producer,
//     complete_tx by the copy), scales its slice in place, makes its writes
//     visible to the copy engine (fence.proxy.async.shared::cta), and its
//     lane 0 issues the bulk store of the slice as one bulk async-group;
//   - after tile i's store a consumer lane waits
//     (cp.async.bulk.wait_group.read) until its stores up to tile i - lag
//     have read their stages, then arrives on tile i - lag's `empty`
//     mbarrier (one arrival per consumer warp): up to lag + 1 stores of a
//     warp drain behind the scale.
// Scaling in place halves the shared memory of an in/out pair, so the ring
// is twice as deep for the same bytes. The i-th tile of a block uses stage
// i % S, waits on its `full` barrier for phase parity (i / S) & 1, and the
// producer waits on its `empty` barrier for parity (i / S - 1) & 1 before
// reusing it (tests/test_torch_stream_copy.py holds a Python mirror of
// this schedule). A block takes a run of consecutive tiles; with
// blocks_per_sm > 0 a persistent grid takes every gridDim-th tile instead.
// Both bulk copies can carry an L2 evict-first cache policy
// (createpolicy.fractional.L2::evict_first). The wrapper's entry
// `stream_copy_dma` launches the DMA_* constants below: blocks of two 8 KB
// tiles, both loads in flight at once in a ring of two stages.
//
// The two designs these replace stay as variants of the sweep's entries
// (`stream_copy_cfg` and `stream_copy_dma_cfg`, design 0), so that the
// sweep and chip_smoke.py can time them on the same call:
// stream_copy_grid_stride_kernel (a grid-stride loop of 8 blocks of 256
// threads an SM, four vectors a thread, gridDim * 256 vectors apart, with
// __ldcs/__stcs) and stream_copy_dma_two_slot_kernel (two in and two out
// slots of 24 KB a block, two blocks an SM, one load in flight a block).
//
// Contract (checked by the wrapper, ops/stream_copy.py): 16-byte aligned
// pointers and a size that is a multiple of 8 elements (16 bytes).
//
// Each entry point first makes `device` (the CUDA ordinal of the tensors)
// current: this library links its own copy of the CUDA runtime, whose
// current device is not the one the caller's framework set. It then
// launches on the caller's stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a configuration it does not take; it allocates
// and synchronises nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- the chosen configurations (the sweep's picks) --------------------------------

constexpr int COPY_THREADS = 1024;
constexpr int COPY_UNROLL = 1;
constexpr int COPY_LOAD = 2;           // LOAD_PLAIN
constexpr int COPY_STORE = 0;          // STORE_PLAIN
constexpr int COPY_BLOCKS_PER_SM = 0;  // 0: one block a chunk

constexpr int DMA_STAGES = 2;
constexpr int DMA_TILE = 8192;  // bytes
constexpr int DMA_BLOCKS_PER_SM = 0;  // 0: not persistent
constexpr int DMA_TILES_PER_BLOCK = 2;
constexpr int DMA_CONSUMER_WARPS = 8;
constexpr int DMA_STORE_LAG = 1;
constexpr int DMA_EVICT_FIRST = 0;

// -- limits of the configurable kernels ---------------------------------------------

enum { LOAD_CS = 0, LOAD_NC_256B = 1, LOAD_PLAIN = 2 };
enum { STORE_PLAIN = 0, STORE_CS = 1 };
constexpr int COPY_MAX_THREADS = 1024;
constexpr int RING_MAX_STAGES = 8;
constexpr int RING_MAX_CONSUMERS = 8;
constexpr int RING_MAX_STORE_LAG = 3;
constexpr int SMEM_PER_BLOCK = 232448;  // 227 KB, the most a block may use

// the earlier designs, kept as design 0 of the sweep's entries
constexpr int GRID_STRIDE_THREADS = 256;
constexpr int GRID_STRIDE_UNROLL = 4;
constexpr int GRID_STRIDE_BLOCKS_PER_SM = 8;
constexpr int TWO_SLOT_THREADS = 256;
constexpr int TWO_SLOT_TILE = 24576;  // bytes: 48 rows of 256 bf16
constexpr int TWO_SLOT_SMEM = 4 * TWO_SLOT_TILE;
constexpr int TWO_SLOT_BLOCKS_PER_SM = 2;

// 8 bf16 in a 16-byte vector, each times s, rounded to nearest even.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w[k]);
    const float2 f = __bfloat1622float2(h);
    h = __floats2bfloat162_rn(f.x * s, f.y * s);
    w[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// -- stream_copy ------------------------------------------------------------------

template <int LOAD>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if constexpr (LOAD == LOAD_CS) {
    return __ldcs(p);
  } else if constexpr (LOAD == LOAD_NC_256B) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  } else {
    uint4 v;
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  }
}

template <int STORE>
__device__ __forceinline__ void store16(uint4* p, uint4 v) {
  if constexpr (STORE == STORE_CS) {
    __stcs(p, v);
  } else {
    asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

// Chunks of blockDim * U vectors; block b takes chunks b, b + gridDim, ...
// (one each when the grid holds a block a chunk).
template <int U, int LOAD, int STORE>
__global__ void __launch_bounds__(COPY_MAX_THREADS)
stream_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, long long n_vec,
                   float s) {
  const long long chunk = (long long)blockDim.x * U;
  for (long long start = blockIdx.x * chunk; start < n_vec; start += gridDim.x * chunk) {
    const long long i0 = start + threadIdx.x;
    uint4 v[U];
    if (start + chunk <= n_vec) {
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = load16<LOAD>(x + i0 + u * blockDim.x);
#pragma unroll
      for (int u = 0; u < U; ++u) store16<STORE>(o + i0 + u * blockDim.x, scale8(v[u], s));
    } else {  // the array's last, partial chunk
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = i0 + u * blockDim.x;
        if (i < n_vec) v[u] = load16<LOAD>(x + i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = i0 + u * blockDim.x;
        if (i < n_vec) store16<STORE>(o + i, scale8(v[u], s));
      }
    }
  }
}

// The earlier design: a grid-stride loop, four vectors a thread gridDim * 256
// vectors apart, evict-first loads and stores.
__global__ void __launch_bounds__(GRID_STRIDE_THREADS)
stream_copy_grid_stride_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
                               long long n_vec, float s) {
  const long long stride = (long long)gridDim.x * GRID_STRIDE_THREADS;
  long long i = (long long)blockIdx.x * GRID_STRIDE_THREADS + threadIdx.x;
  for (; i + (GRID_STRIDE_UNROLL - 1) * stride < n_vec; i += GRID_STRIDE_UNROLL * stride) {
    uint4 v[GRID_STRIDE_UNROLL];
#pragma unroll
    for (int u = 0; u < GRID_STRIDE_UNROLL; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < GRID_STRIDE_UNROLL; ++u) __stcs(o + i + u * stride, scale8(v[u], s));
  }
  for (; i < n_vec; i += stride) __stcs(o + i, scale8(__ldcs(x + i), s));
}

// -- TMA bulk copies and mbarriers (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// global -> shared, completion reported to `bar` as `bytes` transactions
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// as bulk_load, under the L2 cache policy `policy`
__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// shared -> global, then close the calling thread's bulk async-group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// as bulk_store, under the L2 cache policy `policy`
__device__ __forceinline__ void bulk_store_hint(void* dst, const void* src, uint32_t bytes,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most `pending` (0-3) of the thread's newest bulk
// async-groups have not yet read their source
__device__ __forceinline__ void wait_group_read(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 3;" ::: "memory"); break;
  }
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the threads' shared-memory writes, made visible to the copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- stream_copy_dma ----------------------------------------------------------------

// The ring (header): blockDim = 32 * (consumers + 1), the last warp the
// producer; `stages` * `tile` bytes of dynamic shared memory.
__global__ void __launch_bounds__(32 * (RING_MAX_CONSUMERS + 1))
stream_copy_dma_kernel(const char* __restrict__ x, char* __restrict__ o, long long n_bytes,
                       float s, int stages, int tile, int tiles_per_block, int store_lag,
                       int evict_first) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[RING_MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[RING_MAX_STAGES];
  const int consumers = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_tiles = (n_bytes + tile - 1) / tile;
  // this block's tiles: first + i * step for i < n_local
  long long first, step, n_local;
  if (tiles_per_block > 0) {  // a run of consecutive tiles
    first = (long long)blockIdx.x * tiles_per_block;
    step = 1;
    n_local = n_tiles - first < tiles_per_block ? n_tiles - first : tiles_per_block;
  } else {  // persistent: every gridDim-th tile
    first = blockIdx.x;
    step = gridDim.x;
    n_local = first < n_tiles ? (n_tiles - 1 - first) / gridDim.x + 1 : 0;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], consumers);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
  uint64_t policy = 0;
  if (evict_first && lane == 0)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));

  if (warp == consumers) {  // the producer
    if (lane != 0) return;
    for (long long i = 0; i < n_local; ++i) {
      const int st = (int)(i % stages);
      const long long round = i / stages;
      if (round > 0) mbar_wait(&empty[st], (uint32_t)((round - 1) & 1));
      const long long t = first + i * step;
      const long long left = n_bytes - t * tile;
      const uint32_t nb = (uint32_t)(left < tile ? left : tile);
      mbar_expect_tx(&full[st], nb);
      unsigned char* dst = smem + (size_t)st * tile;
      if (evict_first)
        bulk_load_hint(dst, x + t * tile, nb, &full[st], policy);
      else
        bulk_load(dst, x + t * tile, nb, &full[st]);
    }
    return;
  }

  for (long long i = 0; i < n_local; ++i) {
    const int st = (int)(i % stages);
    const long long t = first + i * step;
    const long long left = n_bytes - t * tile;
    const uint32_t nv = (uint32_t)(left < tile ? left : tile) / 16;
    const uint32_t lo = (uint32_t)((uint64_t)nv * warp / consumers);
    const uint32_t hi = (uint32_t)((uint64_t)nv * (warp + 1) / consumers);
    uint4* buf = reinterpret_cast<uint4*>(smem + (size_t)st * tile);
    mbar_wait(&full[st], (uint32_t)((i / stages) & 1));
    for (uint32_t v = lo + lane; v < hi; v += 32) buf[v] = scale8(buf[v], s);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      char* dst = o + t * tile + (long long)lo * 16;
      if (hi == lo)  // a slice of the last tile can be empty: an empty group
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      else if (evict_first)
        bulk_store_hint(dst, buf + lo, (hi - lo) * 16, policy);
      else
        bulk_store(dst, buf + lo, (hi - lo) * 16);
      if (i >= store_lag) {
        // every group but the newest store_lag has read its stage: free the
        // stage of tile i - store_lag
        wait_group_read(store_lag);
        mbar_arrive(&empty[(i - store_lag) % stages]);
      }
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The earlier design: two in and two out slots a block, the next tile's load
// issued before the current tile's wait, one thread issuing both copies.
__global__ void __launch_bounds__(TWO_SLOT_THREADS)
stream_copy_dma_two_slot_kernel(const char* __restrict__ x, char* __restrict__ o,
                                long long n_bytes, float s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  unsigned char* const in_buf[2] = {smem, smem + TWO_SLOT_TILE};
  unsigned char* const out_buf[2] = {smem + 2 * TWO_SLOT_TILE, smem + 3 * TWO_SLOT_TILE};
  const long long n_tiles = (n_bytes + TWO_SLOT_TILE - 1) / TWO_SLOT_TILE;
  const long long first = blockIdx.x;
  const long long n_local = first < n_tiles ? (n_tiles - 1 - first) / gridDim.x + 1 : 0;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  auto tile = [&](long long i) { return first + i * gridDim.x; };
  auto tile_bytes = [&](long long t) {
    const long long left = n_bytes - t * TWO_SLOT_TILE;
    return (uint32_t)(left < TWO_SLOT_TILE ? left : TWO_SLOT_TILE);
  };
  auto get = [&](long long i, int slot) {  // leader only
    const long long t = tile(i);
    const uint32_t nb = tile_bytes(t);
    mbar_expect_tx(&bar[slot], nb);
    bulk_load(in_buf[slot], x + t * TWO_SLOT_TILE, nb, &bar[slot]);
  };

  if (leader && n_local > 0) get(0, 0);
  for (long long i = 0; i < n_local; ++i) {
    const int slot = (int)(i & 1);
    // in[slot ^ 1] was last read by tile i-1's scale, before the barrier
    // that ended it
    if (leader && i + 1 < n_local) get(i + 1, slot ^ 1);
    mbar_wait(&bar[slot], (uint32_t)((i >> 1) & 1));
    if (leader && i >= 2) {
      // pending stores: tiles <= i-1; all but the newest have read their slot
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    }
    __syncthreads();  // out[slot] is free for every thread
    const long long t = tile(i);
    const uint32_t nb = tile_bytes(t);
    const uint4* src = reinterpret_cast<const uint4*>(in_buf[slot]);
    uint4* dst = reinterpret_cast<uint4*>(out_buf[slot]);
    for (uint32_t v = threadIdx.x; v < nb / 16; v += TWO_SLOT_THREADS) dst[v] = scale8(src[v], s);
    fence_proxy_async();
    __syncthreads();
    if (leader) bulk_store(o + t * TWO_SLOT_TILE, out_buf[slot], nb);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int sm_count(int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// blocks of a grid over `units` work units, capped at blocks_per_sm an SM
// when that is > 0
int grid_size(int device, long long units, int blocks_per_sm) {
  if (blocks_per_sm > 0) {
    const long long most = (long long)sm_count(device) * blocks_per_sm;
    if (units > most) units = most;
  }
  return (int)units;
}

using CopyKernel = void (*)(const uint4*, uint4*, long long, float);

template <int U>
CopyKernel copy_kernel_u(int load, int store) {
  switch (load * 2 + store) {
    case LOAD_CS * 2 + STORE_PLAIN: return stream_copy_kernel<U, LOAD_CS, STORE_PLAIN>;
    case LOAD_CS * 2 + STORE_CS: return stream_copy_kernel<U, LOAD_CS, STORE_CS>;
    case LOAD_NC_256B * 2 + STORE_PLAIN: return stream_copy_kernel<U, LOAD_NC_256B, STORE_PLAIN>;
    case LOAD_NC_256B * 2 + STORE_CS: return stream_copy_kernel<U, LOAD_NC_256B, STORE_CS>;
    case LOAD_PLAIN * 2 + STORE_PLAIN: return stream_copy_kernel<U, LOAD_PLAIN, STORE_PLAIN>;
    case LOAD_PLAIN * 2 + STORE_CS: return stream_copy_kernel<U, LOAD_PLAIN, STORE_CS>;
    default: return nullptr;
  }
}

CopyKernel copy_kernel(int unroll, int load, int store) {
  if (store != STORE_PLAIN && store != STORE_CS) return nullptr;
  switch (unroll) {
    case 1: return copy_kernel_u<1>(load, store);
    case 2: return copy_kernel_u<2>(load, store);
    case 4: return copy_kernel_u<4>(load, store);
    case 8: return copy_kernel_u<8>(load, store);
    default: return nullptr;
  }
}

cudaError_t launch_copy(int device, const void* x, void* out, long long n_vec, float scale,
                        int threads, int unroll, int load, int store, int blocks_per_sm,
                        cudaStream_t stream) {
  const CopyKernel kernel = copy_kernel(unroll, load, store);
  if (kernel == nullptr || threads < 32 || threads > COPY_MAX_THREADS || threads % 32 ||
      blocks_per_sm < 0)
    return cudaErrorInvalidValue;
  if (n_vec > 0) {
    const long long chunk = (long long)threads * unroll;
    const int blocks = grid_size(device, (n_vec + chunk - 1) / chunk, blocks_per_sm);
    kernel<<<blocks, threads, 0, stream>>>(static_cast<const uint4*>(x),
                                           static_cast<uint4*>(out), n_vec, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_grid_stride(int device, const void* x, void* out, long long n_vec,
                               float scale, cudaStream_t stream) {
  if (n_vec > 0) {
    const int blocks = grid_size(device, (n_vec + GRID_STRIDE_THREADS - 1) / GRID_STRIDE_THREADS,
                                 GRID_STRIDE_BLOCKS_PER_SM);
    stream_copy_grid_stride_kernel<<<blocks, GRID_STRIDE_THREADS, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), n_vec, scale);
  }
  return cudaGetLastError();
}

cudaError_t launch_ring(int device, const void* x, void* out, long long n_bytes, float scale,
                        int stages, int tile, int blocks_per_sm, int tiles_per_block,
                        int consumer_warps, int store_lag, int evict_first,
                        cudaStream_t stream) {
  const long long smem = (long long)stages * tile;
  if (stages < 2 || stages > RING_MAX_STAGES || tile < 16 || tile % 16 ||
      smem > SMEM_PER_BLOCK - 2 * RING_MAX_STAGES * 8 ||
      (blocks_per_sm < 1) == (tiles_per_block < 1) || blocks_per_sm < 0 || tiles_per_block < 0 ||
      consumer_warps < 1 || consumer_warps > RING_MAX_CONSUMERS || store_lag < 0 ||
      store_lag > RING_MAX_STORE_LAG || store_lag >= stages)
    return cudaErrorInvalidValue;
  if (n_bytes > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_copy_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(stream_copy_dma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const long long n_tiles = (n_bytes + tile - 1) / tile;
    const int blocks =
        tiles_per_block > 0 ? (int)((n_tiles + tiles_per_block - 1) / tiles_per_block)
                            : grid_size(device, n_tiles, blocks_per_sm);
    stream_copy_dma_kernel<<<blocks, 32 * (consumer_warps + 1), (size_t)smem, stream>>>(
        static_cast<const char*>(x), static_cast<char*>(out), n_bytes, scale, stages, tile,
        tiles_per_block, store_lag, evict_first);
  }
  return cudaGetLastError();
}

cudaError_t launch_two_slot(int device, const void* x, void* out, long long n_bytes,
                            float scale, cudaStream_t stream) {
  if (n_bytes > 0) {
    cudaError_t err = cudaFuncSetAttribute(stream_copy_dma_two_slot_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           TWO_SLOT_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(stream_copy_dma_two_slot_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const int blocks = grid_size(device, (n_bytes + TWO_SLOT_TILE - 1) / TWO_SLOT_TILE,
                                 TWO_SLOT_BLOCKS_PER_SM);
    stream_copy_dma_two_slot_kernel<<<blocks, TWO_SLOT_THREADS, TWO_SLOT_SMEM, stream>>>(
        static_cast<const char*>(x), static_cast<char*>(out), n_bytes, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int stream_copy(int device, const void* x, void* out, long long n_elems, float scale,
                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return (int)launch_copy(device, x, out, n_elems / 8, scale, COPY_THREADS, COPY_UNROLL,
                          COPY_LOAD, COPY_STORE, COPY_BLOCKS_PER_SM, (cudaStream_t)stream);
}

int stream_copy_dma(int device, const void* x, void* out, long long n_elems, float scale,
                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return (int)launch_ring(device, x, out, n_elems * 2, scale, DMA_STAGES, DMA_TILE,
                          DMA_BLOCKS_PER_SM, DMA_TILES_PER_BLOCK, DMA_CONSUMER_WARPS,
                          DMA_STORE_LAG, DMA_EVICT_FIRST, (cudaStream_t)stream);
}

// Any variant of stream_copy: design 0 is the earlier grid-stride kernel (the
// other arguments unread), design 1 the chunked kernel with `threads`,
// `unroll` in {1, 2, 4, 8}, `load` and `store` as the enums above, and
// `blocks_per_sm` (0: one block a chunk).
int stream_copy_cfg(int device, const void* x, void* out, long long n_elems, float scale,
                    int design, int threads, int unroll, int load, int store,
                    int blocks_per_sm, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (design == 0)
    return (int)launch_grid_stride(device, x, out, n_elems / 8, scale, (cudaStream_t)stream);
  if (design != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_copy(device, x, out, n_elems / 8, scale, threads, unroll, load, store,
                          blocks_per_sm, (cudaStream_t)stream);
}

// Any variant of stream_copy_dma: design 0 is the earlier two-slot kernel
// (the other arguments unread), design 1 the ring with `stages` of `tile`
// bytes; either a persistent grid of `blocks_per_sm` blocks an SM or, with
// blocks_per_sm 0, a block for every `tiles_per_block` consecutive tiles;
// `consumer_warps`, `store_lag` (0-3, below `stages`) and the evict-first
// policy.
int stream_copy_dma_cfg(int device, const void* x, void* out, long long n_elems, float scale,
                        int design, int stages, int tile, int blocks_per_sm,
                        int tiles_per_block, int consumer_warps, int store_lag,
                        int evict_first, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (design == 0)
    return (int)launch_two_slot(device, x, out, n_elems * 2, scale, (cudaStream_t)stream);
  if (design != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_ring(device, x, out, n_elems * 2, scale, stages, tile, blocks_per_sm,
                          tiles_per_block, consumer_warps, store_lag, evict_first,
                          (cudaStream_t)stream);
}

}  // extern "C"
