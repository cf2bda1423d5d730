// Flash attention, forward and backward, for the GPT training step (sm_90a).
//
//   flash_fwd      replaces kubeflow_tpu/ops/flash_attention.py `_fwd_kernel`
//                  (:111, pallas_call :195): out and the f32 log-sum-exp.
//   flash_bwd_dq   replaces `_bwd_dq_kernel` (:229, pallas_call :358): dq.
//   flash_bwd_dkv  replaces `_bwd_dkv_kernel` (:278, pallas_call :376): dk, dv.
//
// Layout. q, out, dout: [b, lq, h, d]; k, v: [b, lk, h, d], contiguous, read
// in place through their row stride h*d (no transposes). lse and delta:
// [b, h, lq] f32. Element type bf16 or f32; head_dim 32, 64 or 128.
//
// Design. On the TPU the minor grid dimension runs in order and carries the
// accumulators in VMEM scratch from step to step. Here blocks run in
// parallel and in no order, so each block owns one output tile and loops
// over the other axis itself:
//   forward: one block per (q-tile, head, batch) walks the k-tiles, keeping
//            the running max m, the sum l and the [64, d] accumulator in
//            registers (online softmax);
//   dq:      one block per (q-tile, head, batch) walks the k-tiles;
//   dk/dv:   one block per (k-tile, head, batch) walks the q-tiles.
// Each output element is written by exactly one block: no atomics, and the
// same inputs give the same bits on every run. delta = rowsum(dout * out)
// is computed outside, in PyTorch (the JAX package leaves it to XLA).
//
// Tiles are 64 x 64, 256 threads as a 16 x 16 grid. For a score tile, thread
// (ty, tx) owns rows ty*4..ty*4+3 and columns tx, tx+16, tx+32, tx+48; the
// 16 threads of a row sit in one half-warp, so row max and row sum are
// shuffles. For an output tile it owns the same rows and columns tx+16*c.
// Every shared tile row is padded to d+1 (or 65) floats, so the column reads
// of one half-warp fall in distinct banks. Shared memory is dynamic
// (66-166 KB, above the 48 KB static limit) and set per launch with
// cudaFuncSetAttribute; a refused launch comes back as the return value.
//
// Numerics follow the Pallas kernels. With bf16_dots = 0 (the default) every
// product is an f32 product of f32 operands (JAX's dot_dtype f32): bf16
// inputs are widened exactly, and p and ds stay f32, so this is a SIMT f32
// kernel (no TF32, no bf16 rounding of p or ds). With bf16_dots = 1 every
// dot operand (q, k, v, dout, p, ds) is rounded to bf16 first, as
// `astype(dot_dtype)` does; sums stay f32. Masked entries (causal, or past
// the ragged edge of lq/lk) get s = -1e30 and p = 0, so a row that sees no
// key gives out = 0 and lse = -1e30 (:142-146, :166-171). Causal tiles
// entirely above the diagonal, by global position (q_offset, k_offset),
// are skipped.
//
// Bound (b 8, h 16, L 1024, d 64, causal, bf16; H100 SXM: 989 TF/s bf16,
// 3.35 TB/s): forward 2 causal dots 17.2 GFLOP (17.4 us) vs 67.6 MB
// (20.2 us): bytes; dq 3 dots 25.8 GFLOP (26.1 us) vs 85 MB (25.4 us):
// operations; dk/dv 4 dots 34.4 GFLOP (34.7 us) vs 102 MB (30.3 us):
// operations. This first version runs its dots on the f32 SIMT units
// (67 TF/s peak) out of shared memory, far from that bound: the tensor-core
// path (mma for q.k^T and dout.v^T, whose bf16 products are exact) is the
// lever for a later change.
//
// Each entry point first makes `device` current (this library links its own
// CUDA runtime), launches on the caller's stream and returns
// cudaGetLastError(); it allocates and synchronises nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;  // padded row of a [64, 64] score tile
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float dot_operand(float x, bool bf16_dots) {
  return bf16_dots ? __bfloat162float(__float2bfloat16(x)) : x;
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a [64, D + 1] f32
// tile; rows at or past `len` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int row0, int len,
                                          bool bf16_dots) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const float x = row0 + r < len ? to_f32(src[(int64_t)(row0 + r) * row_stride + c]) : 0.0f;
    dst[r * (D + 1) + c] = dot_operand(x, bf16_dots);
  }
}

// Sum or max over the 16 lanes of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  int lq, lk, h;
  float scale;
  int causal, q_offset, k_offset, bf16_dots;
};

__device__ __forceinline__ bool visible(const Args& a, int qr, int kc) {
  return qr < a.lq && kc < a.lk && (!a.causal || a.q_offset + qr >= a.k_offset + kc);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Args a) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ks = Qs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Ps = Vs + BK * LD;    // [BQ][LDP]

  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q_lo = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool rb = a.bf16_dots != 0;
  const int64_t rs = (int64_t)a.h * D;
  const T* kb = k + ((int64_t)ib * a.lk * a.h + ih) * D;
  const T* vb = v + ((int64_t)ib * a.lk * a.h + ih) * D;
  load_tile<T, D>(Qs, q + ((int64_t)ib * a.lq * a.h + ih) * D, rs, q_lo, a.lq, rb);

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = a.q_offset + min(q_lo + BQ, a.lq) - 1;
  const int nk = (a.lk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_lo = ik * BK;
    if (a.causal && q_last < a.k_offset + k_lo) break;  // this and later tiles: above the diagonal
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    load_tile<T, D>(Ks, kb, rs, k_lo, a.lk, rb);
    load_tile<T, D>(Vs, vb, rs, k_lo, a.lk, rb);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q_lo + ty * 4 + i;
      bool ok[4];
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(a, qr, k_lo + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * a.scale : NEG_BIG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = dot_operand(p, rb);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q_lo + ty * 4 + i;
    if (qr >= a.lq) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];  // a row that saw no key: zeros
    T* o = out + (((int64_t)ib * a.lq + qr) * a.h + ih) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (tx == 0)
      lse[((int64_t)ib * a.h + ih) * a.lq + qr] = l[i] == 0.0f ? NEG_BIG : m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (q-major)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Args a) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* dOs = Qs + BQ * LD;    // [BQ][LD]
  float* Ks = dOs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* dSs = Vs + BK * LD;    // [BQ][LDP]

  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q_lo = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool rb = a.bf16_dots != 0;
  const int64_t rs = (int64_t)a.h * D;
  const int64_t qbase = ((int64_t)ib * a.lq * a.h + ih) * D;
  const T* kb = k + ((int64_t)ib * a.lk * a.h + ih) * D;
  const T* vb = v + ((int64_t)ib * a.lk * a.h + ih) * D;
  load_tile<T, D>(Qs, q + qbase, rs, q_lo, a.lq, rb);
  load_tile<T, D>(dOs, dout + qbase, rs, q_lo, a.lq, rb);

  const float* lse_bh = lse + ((int64_t)ib * a.h + ih) * a.lq;
  const float* delta_bh = delta + ((int64_t)ib * a.h + ih) * a.lq;
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q_lo + ty * 4 + i;
    lse_r[i] = qr < a.lq ? lse_bh[qr] : 0.0f;
    delta_r[i] = qr < a.lq ? delta_bh[qr] : 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = a.q_offset + min(q_lo + BQ, a.lq) - 1;
  const int nk = (a.lk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_lo = ik * BK;
    if (a.causal && q_last < a.k_offset + k_lo) break;
    __syncthreads();
    load_tile<T, D>(Ks, kb, rs, k_lo, a.lk, rb);
    load_tile<T, D>(Vs, vb, rs, k_lo, a.lk, rb);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * LD + d];
        ov[i] = dOs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q_lo + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(a, qr, k_lo + tx + 16 * j) ? expf(s[i][j] * a.scale - lse_r[i]) : 0.0f;
        const float ds = p * (dp[i][j] - delta_r[i]) * a.scale;
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] = dot_operand(ds, rb);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q_lo + ty * 4 + i;
    if (qr >= a.lq) continue;
    T* o = dq + (((int64_t)ib * a.lq + qr) * a.h + ih) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (k-major)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Qs = Vs + BK * LD;     // [BQ][LD]
  float* dOs = Qs + BQ * LD;    // [BQ][LD]
  float* Ps = dOs + BQ * LD;    // [BK][LDP]: p transposed, k rows by q columns
  float* dSs = Ps + BK * LDP;   // [BK][LDP]
  float* lse_s = dSs + BK * LDP;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int ih = blockIdx.y, ib = blockIdx.z;
  const int k_lo = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool rb = a.bf16_dots != 0;
  const int64_t rs = (int64_t)a.h * D;
  const int64_t qbase = ((int64_t)ib * a.lq * a.h + ih) * D;
  const int64_t kbase = ((int64_t)ib * a.lk * a.h + ih) * D;
  load_tile<T, D>(Ks, k + kbase, rs, k_lo, a.lk, rb);
  load_tile<T, D>(Vs, v + kbase, rs, k_lo, a.lk, rb);
  const float* lse_bh = lse + ((int64_t)ib * a.h + ih) * a.lq;
  const float* delta_bh = delta + ((int64_t)ib * a.h + ih) * a.lq;

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  const int nq = (a.lq + BQ - 1) / BQ;
  for (int iq = 0; iq < nq; ++iq) {
    const int q_lo = iq * BQ;
    // a q-tile whose last row lies before this k-tile's first key sees none of it
    if (a.causal && a.q_offset + min(q_lo + BQ, a.lq) - 1 < a.k_offset + k_lo) continue;
    __syncthreads();
    load_tile<T, D>(Qs, q + qbase, rs, q_lo, a.lq, rb);
    load_tile<T, D>(dOs, dout + qbase, rs, q_lo, a.lq, rb);
    if (threadIdx.x < BQ) {
      const int qr = q_lo + threadIdx.x;
      lse_s[threadIdx.x] = qr < a.lq ? lse_bh[qr] : 0.0f;
      delta_s[threadIdx.x] = qr < a.lq ? delta_bh[qr] : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};  // rows: keys ty*4+i; columns: queries tx+16*j
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * LD + d];
        vv[i] = Vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + d];
        ov[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k_lo + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = visible(a, q_lo + col, kc) ? expf(s[i][j] * a.scale - lse_s[col]) : 0.0f;
        const float ds = p * (dp[i][j] - delta_s[col]) * a.scale;
        Ps[(ty * 4 + i) * LDP + col] = dot_operand(p, rb);
        dSs[(ty * 4 + i) * LDP + col] = dot_operand(ds, rb);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * LDP + j];
        dsv[i] = dSs[(ty * 4 + i) * LDP + j];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float o = dOs[j * LD + tx + 16 * c];
        const float qq = Qs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pv[i], o, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qq, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k_lo + ty * 4 + i;
    if (kc >= a.lk) continue;
    const int64_t row = (((int64_t)ib * a.lk + kc) * a.h + ih) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[row + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[row + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() { return sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP); }
template <int D> constexpr size_t dq_smem() { return sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP); }
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * LDP + 2 * BQ);
}

template <typename Kernel, typename... Ptrs>
cudaError_t launch(Kernel kernel, size_t smem, int tiles, int h, int b, cudaStream_t st,
                   const Args& a, Ptrs... ptrs) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles, h, b), THREADS, smem, st>>>(ptrs..., a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                int b, const Args& a, cudaStream_t st) {
  return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), (a.lq + BQ - 1) / BQ, a.h, b, st, a,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out), lse);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int b, const Args& a,
                   cudaStream_t st) {
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), (a.lq + BQ - 1) / BQ, a.h, b, st,
                a, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                static_cast<T*>(dq));
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int b,
                    const Args& a, cudaStream_t st) {
  return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>(), (a.lk + BK - 1) / BK, a.h, b,
                st, a, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                static_cast<T*>(dk), static_cast<T*>(dv));
}

// Returns FN<T, D>(...) for the element type and head_dim given at run
// time; anything else is cudaErrorInvalidValue (the wrapper raises first).
#define FLASH_DISPATCH(FN, ...)                                      \
  {                                                                  \
    if (is_bf16) {                                                   \
      if (d == 32) return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);   \
      if (d == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);   \
      if (d == 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__); \
    } else {                                                         \
      if (d == 32) return (int)FN<float, 32>(__VA_ARGS__);           \
      if (d == 64) return (int)FN<float, 64>(__VA_ARGS__);           \
      if (d == 128) return (int)FN<float, 128>(__VA_ARGS__);         \
    }                                                                \
    return (int)cudaErrorInvalidValue;                               \
  }

}  // namespace

extern "C" {

int flash_fwd(int device, const void* q, const void* k, const void* v, void* out,
              float* lse, int is_bf16, int b, int lq, int lk, int h, int d, float scale,
              int causal, int q_offset, int k_offset, int bf16_dots, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (b == 0 || lq == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{lq, lk, h, scale, causal, q_offset, k_offset, bf16_dots};
  FLASH_DISPATCH(fwd, q, k, v, out, lse, b, a, (cudaStream_t)stream)
}

int flash_bwd_dq(int device, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta, void* dq,
                 int is_bf16, int b, int lq, int lk, int h, int d, float scale, int causal,
                 int q_offset, int k_offset, int bf16_dots, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (b == 0 || lq == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{lq, lk, h, scale, causal, q_offset, k_offset, bf16_dots};
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, b, a, (cudaStream_t)stream)
}

int flash_bwd_dkv(int device, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta, void* dk,
                  void* dv, int is_bf16, int b, int lq, int lk, int h, int d, float scale,
                  int causal, int q_offset, int k_offset, int bf16_dots, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (b == 0 || lk == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{lq, lk, h, scale, causal, q_offset, k_offset, bf16_dots};
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, b, a, (cudaStream_t)stream)
}

}  // extern "C"
