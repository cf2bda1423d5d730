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
// read and as many written, 822 MB, 0.2454 ms at the H100's 3.35 TB/s. One
// multiply per element is nothing beside that: both kernels are bound by
// bytes, and their design is about keeping enough bytes in flight.
//
// stream_copy ports the function, not the block structure: the Pallas grid
// runs one block at a time on one core, while here every SM streams at once.
// A grid-stride loop over 16-byte vectors (8 bf16 a thread, neighbouring
// threads on neighbouring addresses), four independent vector loads in
// flight per thread before their stores, eight 256-thread blocks per SM.
// Loads and stores carry the evict-first hint (__ldcs/__stcs): nothing is
// read twice.
//
// stream_copy_dma keeps what makes `_manual_dma_copy` a different kernel:
// the copies are made by the copy engine (TMA's 1-D bulk copies,
// cp.async.bulk), not by the threads, and overlap with the scale. Persistent
// blocks, two per SM, each walk their share of 24 KB tiles (tile t goes to
// block t mod grid). A block has two shared-memory slots in and two out and
// follows the JAX schedule (fused_bottleneck_probe.py:119-141): start the
// load of tile i+1 before waiting on tile i; drain the store of tile i-2
// before its out slot is reused; scale in[i % 2] -> out[i % 2] with every
// thread; start the store of tile i. The JAX tile (4096 x 256 bf16, 2 MiB)
// does not fit in 227 KB of shared memory, so the device tile is the
// kernel's own (4 x 24 KB = 96 KB a block, dynamic shared memory set with
// cudaFuncSetAttribute). Loads complete on an mbarrier per in slot
// (expect_tx, then complete_tx from the copy); a slot's barrier is reused
// every second tile, so the n-th wait on it waits for phase parity n & 1.
// Stores are bulk async-groups of the one issuing thread:
// cp.async.bulk.wait_group.read 1 before reusing an out slot, wait_group 0
// before the block exits. The threads' shared-memory writes reach the copy
// engine through fence.proxy.async.shared::cta before the store is issued.
//
// Contract (checked by the wrapper, ops/stream_copy.py): 16-byte aligned
// pointers and a size that is a multiple of 8 elements (16 bytes).
//
// Each entry point first makes `device` (the CUDA ordinal of the tensors)
// current: this library links its own copy of the CUDA runtime, whose
// current device is not the one the caller's framework set. It then
// launches on the caller's stream and returns cudaGetLastError(); it
// allocates and synchronises nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int COPY_UNROLL = 4;
constexpr int COPY_BLOCKS_PER_SM = 8;

constexpr int DMA_THREADS = 256;
constexpr int DMA_TILE = 24576;  // bytes: 48 rows of 256 bf16
constexpr int DMA_SMEM = 4 * DMA_TILE;
constexpr int DMA_BLOCKS_PER_SM = 2;

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

__global__ void __launch_bounds__(COPY_THREADS)
stream_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, long long n_vec,
                   float s) {
  const long long stride = (long long)gridDim.x * COPY_THREADS;
  long long i = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  for (; i + (COPY_UNROLL - 1) * stride < n_vec; i += COPY_UNROLL * stride) {
    uint4 v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) __stcs(o + i + u * stride, scale8(v[u], s));
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

// shared -> global, as one bulk async-group of the calling thread
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(DMA_THREADS)
stream_copy_dma_kernel(const char* __restrict__ x, char* __restrict__ o, long long n_bytes,
                       float s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  unsigned char* const in_buf[2] = {smem, smem + DMA_TILE};
  unsigned char* const out_buf[2] = {smem + 2 * DMA_TILE, smem + 3 * DMA_TILE};
  const long long n_tiles = (n_bytes + DMA_TILE - 1) / DMA_TILE;
  const long long first = blockIdx.x;
  const long long n_local = first < n_tiles ? (n_tiles - 1 - first) / gridDim.x + 1 : 0;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto tile = [&](long long i) { return first + i * gridDim.x; };
  auto tile_bytes = [&](long long t) {
    const long long left = n_bytes - t * DMA_TILE;
    return (uint32_t)(left < DMA_TILE ? left : DMA_TILE);
  };
  auto get = [&](long long i, int slot) {  // leader only
    const long long t = tile(i);
    const uint32_t nb = tile_bytes(t);
    mbar_expect_tx(&bar[slot], nb);
    bulk_load(in_buf[slot], x + t * DMA_TILE, nb, &bar[slot]);
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
    for (uint32_t v = threadIdx.x; v < nb / 16; v += DMA_THREADS) dst[v] = scale8(src[v], s);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (leader) bulk_store(o + t * DMA_TILE, out_buf[slot], nb);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int sm_count(int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" {

int stream_copy(int device, const void* x, void* out, long long n_elems, float scale,
                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n_vec = n_elems / 8;
  if (n_vec > 0) {
    long long blocks = (n_vec + COPY_THREADS - 1) / COPY_THREADS;
    const long long most = (long long)sm_count(device) * COPY_BLOCKS_PER_SM;
    if (blocks > most) blocks = most;
    stream_copy_kernel<<<(int)blocks, COPY_THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), n_vec, scale);
  }
  return (int)cudaGetLastError();
}

int stream_copy_dma(int device, const void* x, void* out, long long n_elems, float scale,
                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n_bytes = n_elems * 2;
  if (n_bytes > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        stream_copy_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(stream_copy_dma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    long long blocks = (n_bytes + DMA_TILE - 1) / DMA_TILE;
    const long long most = (long long)sm_count(device) * DMA_BLOCKS_PER_SM;
    if (blocks > most) blocks = most;
    stream_copy_dma_kernel<<<(int)blocks, DMA_THREADS, DMA_SMEM, (cudaStream_t)stream>>>(
        static_cast<const char*>(x), static_cast<char*>(out), n_bytes, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
