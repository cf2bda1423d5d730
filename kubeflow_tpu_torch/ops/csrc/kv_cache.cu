// KV-cache write kernels for the continuous-batching decode step (sm_90a).
//
// Each decode step writes ONE [H, D] key row and ONE value row per slot,
// per layer. These kernels are that write, in place:
//
//   kv_row_update_pair_*        replaces kubeflow_tpu/ops/kv_cache.py
//                               `_kernel` (wrappers kv_row_update_pair,
//                               kv_row_update): contiguous per-slot caches
//                               [S, T, H, D], row cache[s, cursors[s]].
//   kv_block_update_pair_*      replaces `_paged_kernel` (wrappers
//                               kv_block_update_pair, kv_block_update):
//                               shared block arena [N, block_t, H, D]
//                               addressed through a per-slot block table
//                               [S, MB]; arena row N-1 is trash.
//   kv_block_update_quant_pair_*  replaces `_paged_quant_kernel` (wrappers
//                               kv_block_update_quant_pair,
//                               kv_block_update_quant): the same write into
//                               an int8 arena, quantized here per (row,
//                               head) with an f32 scale [N, block_t, H, 1]
//                               written beside it.
//
// Design. The Pallas kernels copy a whole [block_t, H, D] tile through VMEM
// because the TPU aliases whole blocks; here nothing but the one row moves.
// A block loads its own cursor and table entry (no scalar prefetch). The
// bf16/f32 rows are plain byte copies with 16-byte vector loads and stores
// when the row and every pointer allow it. The int8 kernels give one warp
// to a head: a warp reduction finds the abs-max, then each lane quantizes
// its elements with IEEE division and round-half-even (`__fdiv_rn`,
// `rintf`; the build uses no --use_fast_math), so the codes and scales equal
// the plain PyTorch quantizer bit for bit.
//
// Contracts (kubeflow_tpu/ops/kv_cache.py:50-54, :123-126): a cursor outside
// [0, T) (resp. [0, max_seq)) writes nothing; a table entry pointing at the
// trash row writes there. A table entry outside [0, N) writes nothing.
//
// Bound. Per array and call: S rows read from `new` and S rows written,
// plus the S cursors (and S table entries). GPT-small serving (S=8, H=12,
// D=64, bf16): 8 * 2 * 1536 B + 64 B = 24.6 KB, 7.3 ns at 3.35 TB/s — far
// below the ~2 us a launch costs, so these writes are bound by the launch
// and the host's call, not by bytes. Every write therefore takes a layer's
// K and V in ONE launch (`n_arrays` 2; the one-array wrappers pass 1): 12
// launches per decode token for GPT-small's 12 layers, not 24, a block per
// (slot, array). On the device a block's time beyond an empty kernel's is
// its chain of dependent loads, so the contiguous pair issues its row's
// loads beside the cursor's and tests the cursor only before the stores
// (the row does not depend on it): one load round trip before the store.
// The designs are reachable through kv_row_update_cfg and
// kv_block_update_cfg:
//   design 1 (the pair): a block per (slot, array), grid S x n_arrays;
//   design 0: the one-array kernel the pair replaced, launched once per
//             array, kept for the timing beside it.
//
// Each entry point first makes `device` (the CUDA ordinal of the tensors)
// current when it is not: this library links its own copy of the CUDA
// runtime, whose current device is not the one the caller's framework set.
// It then launches on the caller's stream and returns cudaGetLastError();
// it allocates and synchronises nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Copy `nbytes` from src to dst with every thread of the block.
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         int nbytes) {
  if (nbytes % 16 == 0 && aligned16(dst) && aligned16(src)) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = src[i];
  }
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

// The one or two (arena or contiguous cache, rows) pairs of a call: K
// first, then V.
struct Arrays {
  char* arena[2];
  const char* rows[2];
  float* scales[2];  // int8 arenas only
};

// p[k] by a select: an index into a kernel parameter's array would copy the
// array to local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&p)[2], int k) { return k ? p[1] : p[0]; }

// -- design 0: the replaced kernels, one array a launch ----------------------

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

// One warp quantizes one head row of D values into q and its scale.
template <typename T>
__device__ __forceinline__ void quantize_head(int8_t* __restrict__ q,
                                              float* __restrict__ scale_out,
                                              const T* __restrict__ x, int D,
                                              int lane) {
  float amax = 0.0f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f32(x[d])));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(amax, 127.0f);
  const float div = scale > 0.0f ? scale : 1.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = rintf(__fdiv_rn(to_f32(x[d]), div));
    q[d] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (lane == 0) *scale_out = scale;
}

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
  for (int h = threadIdx.x / 32; h < H; h += nwarps)
    quantize_head(arena + (row * H + h) * D, scales + row * H + h,
                  new_rows + ((int64_t)s * H + h) * D, D, lane);
}

// -- design 1: every array of a layer in one launch, a block per (slot, array)
// (on the card it beat a block per slot copying both rows: PERF.md) ----------

// 16-byte vectors of a row that a thread holds in registers between its
// loads and its stores: rows up to ROW_VECTORS * blockDim.x vectors (16 KB
// at 256 threads) are loaded whole before the cursor is tested.
constexpr int ROW_VECTORS = 4;

__device__ __forceinline__ void load_vectors(int4 (&r)[ROW_VECTORS],
                                             const int4* __restrict__ src,
                                             int first, int n) {
#pragma unroll
  for (int j = 0; j < ROW_VECTORS; ++j) {
    const int i = first + threadIdx.x + j * blockDim.x;
    if (i < n) r[j] = __ldg(src + i);
  }
}

__device__ __forceinline__ void store_vectors(int4* __restrict__ dst,
                                              const int4 (&r)[ROW_VECTORS],
                                              int first, int n) {
#pragma unroll
  for (int j = 0; j < ROW_VECTORS; ++j) {
    const int i = first + threadIdx.x + j * blockDim.x;
    if (i < n) dst[i] = r[j];
  }
}

// The row's loads are issued (read-only path) beside the cursor's, before
// the cursor is tested: a slot out of range has read its row and stores
// nothing. Rows not 16-byte sized or aligned take the byte-wise copy.
__global__ void kv_row_update_pair_kernel(Arrays a, const int* __restrict__ cursors,
                                          int T, int row_bytes) {
  const int s = blockIdx.x, k = blockIdx.y;
  const char* src = pick(a.rows, k) + (int64_t)s * row_bytes;
  char* cache = pick(a.arena, k) + (int64_t)s * T * row_bytes;
  const int cur = __ldg(cursors + s);
  if (row_bytes % 16 != 0 || !aligned16(src) || !aligned16(cache)) {
    if (cur < 0 || cur >= T) return;
    copy_row(cache + (int64_t)cur * row_bytes, src, row_bytes);
    return;
  }
  const int n = row_bytes / 16, step = ROW_VECTORS * blockDim.x;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4 r[ROW_VECTORS];
  load_vectors(r, s4, 0, n);
  if (cur < 0 || cur >= T) return;  // retired/idle row: no-op
  int4* d4 = reinterpret_cast<int4*>(cache + (int64_t)cur * row_bytes);
  for (int first = 0;;) {
    store_vectors(d4, r, first, n);
    first += step;
    if (first >= n) break;
    load_vectors(r, s4, first, n);
  }
}

__global__ void kv_block_update_pair_kernel(Arrays a,
                                                  const int* __restrict__ cursors,
                                                  const int* __restrict__ tables,
                                                  int mb, int block_t, int max_seq,
                                                  int n_blocks, int row_bytes) {
  const int s = blockIdx.x, k = blockIdx.y;
  const int64_t row = arena_row(cursors, tables, s, mb, block_t, max_seq, n_blocks);
  if (row < 0) return;
  copy_row(pick(a.arena, k) + row * row_bytes, pick(a.rows, k) + (int64_t)s * row_bytes,
           row_bytes);
}

template <typename T>
__global__ void kv_block_update_quant_pair_kernel(Arrays a,
                                                        const int* __restrict__ cursors,
                                                        const int* __restrict__ tables,
                                                        int mb, int block_t, int max_seq,
                                                        int n_blocks, int H, int D) {
  const int s = blockIdx.x, k = blockIdx.y;
  const int64_t row = arena_row(cursors, tables, s, mb, block_t, max_seq, n_blocks);
  if (row < 0) return;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  int8_t* arena = reinterpret_cast<int8_t*>(pick(a.arena, k));
  const T* x = reinterpret_cast<const T*>(pick(a.rows, k));
  for (int h = threadIdx.x / 32; h < H; h += nwarps)
    quantize_head(arena + (row * H + h) * D, pick(a.scales, k) + row * H + h,
                  x + ((int64_t)s * H + h) * D, D, lane);
}

__global__ void kv_launch_floor_kernel() {}

int copy_threads(int bytes) {
  const int units = (bytes % 16 == 0) ? bytes / 16 : bytes;
  const int warps = (units + 31) / 32;
  return 32 * (warps < 1 ? 1 : (warps > 8 ? 8 : warps));
}

// a warp a head, at most 16 warps
int warp_threads(int heads) {
  return 32 * (heads < 1 ? 1 : (heads > 16 ? 16 : heads));
}

cudaError_t use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

Arrays arrays(void* k_arena, void* v_arena, const void* k_rows, const void* v_rows,
              void* k_scales, void* v_scales) {
  Arrays a;
  a.arena[0] = static_cast<char*>(k_arena);
  a.arena[1] = static_cast<char*>(v_arena);
  a.rows[0] = static_cast<const char*>(k_rows);
  a.rows[1] = static_cast<const char*>(v_rows);
  a.scales[0] = static_cast<float*>(k_scales);
  a.scales[1] = static_cast<float*>(v_scales);
  return a;
}

template <typename T>
void launch_quant(int design, const Arrays& a, int n_arrays, const int* cursors,
                  const int* tables, int S, int mb, int block_t, int max_seq,
                  int n_blocks, int H, int D, cudaStream_t st) {
  if (design == 0) {
    for (int k = 0; k < n_arrays; ++k)
      kv_block_update_quant_kernel<T><<<S, warp_threads(H), 0, st>>>(
          reinterpret_cast<int8_t*>(a.arena[k]), a.scales[k],
          reinterpret_cast<const T*>(a.rows[k]), cursors, tables, mb, block_t,
          max_seq, n_blocks, H, D);
  } else {
    kv_block_update_quant_pair_kernel<T><<<dim3(S, n_arrays), warp_threads(H),
                                                 0, st>>>(
        a, cursors, tables, mb, block_t, max_seq, n_blocks, H, D);
  }
}

}  // namespace

extern "C" {

// Every contiguous write, by design (0 or 1; see the header). `n_arrays` 1
// writes K only (V pointers unused), 2 writes K and V.
int kv_row_update_cfg(int device, int design, void* k_cache, void* v_cache,
                      const void* k_new, const void* v_new, int n_arrays,
                      const int* cursors, int S, int T, int row_bytes, void* stream) {
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  if (design < 0 || design > 1 || n_arrays < 1 || n_arrays > 2) return (int)cudaErrorInvalidValue;
  if (S <= 0) return (int)cudaGetLastError();
  const Arrays a = arrays(k_cache, v_cache, k_new, v_new, nullptr, nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = copy_threads(row_bytes);
  if (design == 0) {
    for (int k = 0; k < n_arrays; ++k)
      kv_row_update_kernel<<<S, threads, 0, st>>>(a.arena[k], a.rows[k], cursors, T,
                                                  row_bytes);
  } else {
    kv_row_update_pair_kernel<<<dim3(S, n_arrays), threads, 0, st>>>(a, cursors, T,
                                                                     row_bytes);
  }
  return (int)cudaGetLastError();
}

int kv_row_update_pair(int device, void* k_cache, void* v_cache, const void* k_new,
                       const void* v_new, int n_arrays, const int* cursors, int S, int T,
                       int row_bytes, void* stream) {
  return kv_row_update_cfg(device, 1, k_cache, v_cache, k_new, v_new, n_arrays, cursors,
                           S, T, row_bytes, stream);
}

// Every paged write, by design (0 or 1; see the header). `quant` 0: copy
// rows of `row_bytes` into arenas of the rows' type (scales unused); 1:
// quantize rows of H x D values (bf16 if `new_is_bf16`, else f32) into int8
// arenas and f32 scale arenas. `n_arrays` 1 writes K only (V pointers
// unused), 2 writes K and V.
int kv_block_update_cfg(int device, int design, int quant, void* k_arena, void* v_arena,
                        void* k_scales, void* v_scales, const void* k_new,
                        const void* v_new, int new_is_bf16, int n_arrays,
                        const int* cursors, const int* tables, int S, int mb,
                        int block_t, int max_seq, int n_blocks, int H, int D,
                        int row_bytes, void* stream) {
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  if (design < 0 || design > 1 || n_arrays < 1 || n_arrays > 2) return (int)cudaErrorInvalidValue;
  if (S <= 0) return (int)cudaGetLastError();
  const Arrays a = arrays(k_arena, v_arena, k_new, v_new, k_scales, v_scales);
  cudaStream_t st = (cudaStream_t)stream;
  if (quant) {
    if (new_is_bf16)
      launch_quant<__nv_bfloat16>(design, a, n_arrays, cursors, tables, S, mb, block_t,
                                  max_seq, n_blocks, H, D, st);
    else
      launch_quant<float>(design, a, n_arrays, cursors, tables, S, mb, block_t,
                          max_seq, n_blocks, H, D, st);
  } else if (design == 0) {
    for (int k = 0; k < n_arrays; ++k)
      kv_block_update_kernel<<<S, copy_threads(row_bytes), 0, st>>>(
          a.arena[k], a.rows[k], cursors, tables, mb, block_t, max_seq, n_blocks,
          row_bytes);
  } else {
    kv_block_update_pair_kernel<<<dim3(S, n_arrays), copy_threads(row_bytes), 0, st>>>(
        a, cursors, tables, mb, block_t, max_seq, n_blocks, row_bytes);
  }
  return (int)cudaGetLastError();
}

int kv_block_update_pair(int device, void* k_arena, void* v_arena, const void* k_new,
                         const void* v_new, int n_arrays, const int* cursors,
                         const int* tables, int S, int mb, int block_t, int max_seq,
                         int n_blocks, int row_bytes, void* stream) {
  return kv_block_update_cfg(device, 1, 0, k_arena, v_arena, nullptr, nullptr,
                             k_new, v_new, 0, n_arrays, cursors, tables, S, mb, block_t,
                             max_seq, n_blocks, 0, 0, row_bytes, stream);
}

int kv_block_update_quant_pair(int device, void* k_arena, void* v_arena, void* k_scales,
                               void* v_scales, const void* k_new, const void* v_new,
                               int new_is_bf16, int n_arrays, const int* cursors,
                               const int* tables, int S, int mb, int block_t,
                               int max_seq, int n_blocks, int H, int D, void* stream) {
  return kv_block_update_cfg(device, 1, 1, k_arena, v_arena, k_scales, v_scales,
                             k_new, v_new, new_is_bf16, n_arrays, cursors, tables, S, mb,
                             block_t, max_seq, n_blocks, H, D, 0, stream);
}

// The least launch: the one-array paged write's grid and block, an empty
// kernel.
int kv_launch_floor(int device, int S, int row_bytes, void* stream) {
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return (int)set;
  if (S > 0) {
    kv_launch_floor_kernel<<<S, copy_threads(row_bytes), 0, (cudaStream_t)stream>>>();
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
