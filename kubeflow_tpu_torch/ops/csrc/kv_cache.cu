// KV-cache write kernels for the continuous-batching decode step (sm_90a).
//
// Each decode step writes ONE [H, D] key row and ONE value row per slot,
// per layer. These three kernels are that write, in place:
//
//   kv_row_update          replaces kubeflow_tpu/ops/kv_cache.py `_kernel`
//                          (wrapper kv_row_update): contiguous per-slot
//                          cache [S, T, H, D], row cache[s, cursors[s]].
//   kv_block_update        replaces `_paged_kernel` (wrapper
//                          kv_block_update): shared block arena
//                          [N, block_t, H, D] addressed through a per-slot
//                          block table [S, MB]; arena row N-1 is trash.
//   kv_block_update_quant  replaces `_paged_quant_kernel` (wrapper
//                          kv_block_update_quant): the same write into an
//                          int8 arena, quantized here per (row, head) with
//                          an f32 scale [N, block_t, H, 1] written beside it.
//
// Design. The Pallas kernels copy a whole [block_t, H, D] tile through VMEM
// because the TPU aliases whole blocks; here nothing but the one row moves.
// Grid: one block per slot; the block loads its own cursor and table entry
// (no scalar prefetch). The bf16/f32 rows are plain byte copies with 16-byte
// vector loads and stores when the row and both pointers allow it. The int8
// kernel gives one warp to a head: a warp reduction finds the abs-max, then
// each lane quantizes its elements with IEEE division and round-half-even
// (`__fdiv_rn`, `rintf`; the build uses no --use_fast_math), so the codes and
// scales equal the plain PyTorch quantizer bit for bit.
//
// Contracts (kubeflow_tpu/ops/kv_cache.py:50-54, :123-126): a cursor outside
// [0, T) (resp. [0, max_seq)) writes nothing; a table entry pointing at the
// trash row writes there. A table entry outside [0, N) writes nothing.
//
// Bound. Per call: S rows read from `new` and S rows written, plus the S
// cursors and S table entries. GPT-small serving (S=8, H=12, D=64, bf16):
// 8 * 2 * 1536 B + 64 B = 24.6 KB, 7.3 ns at 3.35 TB/s — far below the
// ~2-3 us a launch costs, so the kernel is launch-latency-bound. Launches per
// decode token: 2 per layer (K and V), 24 for GPT-small's 12 layers. Fusing
// K and V, or all layers, into one launch is the lever, for a later change.
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

// Copy `nbytes` from src to dst with every thread of the block.
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         int nbytes) {
  const bool vec = (nbytes % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0);
  if (vec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void kv_row_update_kernel(char* __restrict__ cache,
                                     const char* __restrict__ new_rows,
                                     const int* __restrict__ cursors,
                                     int T, int row_bytes) {
  const int s = blockIdx.x;
  const int cur = cursors[s];
  if (cur < 0 || cur >= T) return;  // retired/idle row: no-op
  copy_row(cache + ((int64_t)s * T + cur) * row_bytes,
           new_rows + (int64_t)s * row_bytes, row_bytes);
}

// Arena row that slot `s` writes at its cursor, or -1 for no write.
__device__ __forceinline__ int64_t arena_row(const int* __restrict__ cursors,
                                             const int* __restrict__ tables,
                                             int s, int mb, int block_t,
                                             int max_seq, int n_blocks) {
  const int cur = cursors[s];
  if (cur < 0 || cur >= max_seq) return -1;
  const int bi = min(cur / block_t, mb - 1);
  const int blk = tables[(int64_t)s * mb + bi];
  if (blk < 0 || blk >= n_blocks) return -1;
  return (int64_t)blk * block_t + cur % block_t;
}

__global__ void kv_block_update_kernel(char* __restrict__ arena,
                                       const char* __restrict__ new_rows,
                                       const int* __restrict__ cursors,
                                       const int* __restrict__ tables,
                                       int mb, int block_t, int max_seq,
                                       int n_blocks, int row_bytes) {
  const int s = blockIdx.x;
  const int64_t row = arena_row(cursors, tables, s, mb, block_t, max_seq, n_blocks);
  if (row < 0) return;
  copy_row(arena + row * row_bytes, new_rows + (int64_t)s * row_bytes, row_bytes);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__global__ void kv_block_update_quant_kernel(int8_t* __restrict__ arena,
                                             float* __restrict__ scales,
                                             const T* __restrict__ new_rows,
                                             const int* __restrict__ cursors,
                                             const int* __restrict__ tables,
                                             int mb, int block_t, int max_seq,
                                             int n_blocks, int H, int D) {
  const int s = blockIdx.x;
  const int64_t row = arena_row(cursors, tables, s, mb, block_t, max_seq, n_blocks);
  if (row < 0) return;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int h = threadIdx.x / 32; h < H; h += nwarps) {
    const T* x = new_rows + ((int64_t)s * H + h) * D;
    float amax = 0.0f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f32(x[d])));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fdiv_rn(amax, 127.0f);
    const float div = scale > 0.0f ? scale : 1.0f;
    int8_t* q = arena + (row * H + h) * D;
    for (int d = lane; d < D; d += 32) {
      const float v = rintf(__fdiv_rn(to_f32(x[d]), div));
      q[d] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
    }
    if (lane == 0) scales[row * H + h] = scale;
  }
}

int copy_threads(int row_bytes) {
  const int units = (row_bytes % 16 == 0) ? row_bytes / 16 : row_bytes;
  const int warps = (units + 31) / 32;
  return 32 * (warps < 1 ? 1 : (warps > 8 ? 8 : warps));
}

}  // namespace

extern "C" {

int kv_row_update(int device, void* cache, const void* new_rows, const int* cursors,
                  int S, int T, int row_bytes, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (S > 0) {
    kv_row_update_kernel<<<S, copy_threads(row_bytes), 0, (cudaStream_t)stream>>>(
        static_cast<char*>(cache), static_cast<const char*>(new_rows), cursors,
        T, row_bytes);
  }
  return (int)cudaGetLastError();
}

int kv_block_update(int device, void* arena, const void* new_rows,
                    const int* cursors, const int* tables, int S, int mb,
                    int block_t, int max_seq, int n_blocks, int row_bytes,
                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (S > 0) {
    kv_block_update_kernel<<<S, copy_threads(row_bytes), 0, (cudaStream_t)stream>>>(
        static_cast<char*>(arena), static_cast<const char*>(new_rows), cursors,
        tables, mb, block_t, max_seq, n_blocks, row_bytes);
  }
  return (int)cudaGetLastError();
}

int kv_block_update_quant(int device, void* arena, void* scales,
                          const void* new_rows, int new_is_bf16,
                          const int* cursors, const int* tables, int S, int mb,
                          int block_t, int max_seq, int n_blocks, int H, int D,
                          void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (S > 0) {
    const int threads = 32 * (H < 1 ? 1 : (H > 16 ? 16 : H));
    cudaStream_t st = (cudaStream_t)stream;
    if (new_is_bf16) {
      kv_block_update_quant_kernel<__nv_bfloat16><<<S, threads, 0, st>>>(
          static_cast<int8_t*>(arena), static_cast<float*>(scales),
          static_cast<const __nv_bfloat16*>(new_rows), cursors, tables, mb,
          block_t, max_seq, n_blocks, H, D);
    } else {
      kv_block_update_quant_kernel<float><<<S, threads, 0, st>>>(
          static_cast<int8_t*>(arena), static_cast<float*>(scales),
          static_cast<const float*>(new_rows), cursors, tables, mb, block_t,
          max_seq, n_blocks, H, D);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
