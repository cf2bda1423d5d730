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
// Grid. On the TPU the minor grid dimension runs in order and carries the
// accumulators in VMEM scratch from step to step. Here blocks run in
// parallel and in no order, so each block owns one output tile and loops
// over the other axis itself:
//   forward: one block per (q-tile, head, batch) walks the k-tiles, keeping
//            the running max m, the sum l and the output accumulator in
//            registers (online softmax);
//   dq:      one block per (q-tile, head, batch) walks the k-tiles;
//   dk/dv:   one block per (k-tile, head, batch) walks the q-tiles.
// Each output element is written by exactly one block: no atomics, and the
// same inputs give the same bits on every run. delta = rowsum(dout * out)
// is computed outside, in PyTorch (the JAX package leaves it to XLA).
// Masked entries (causal by global position q_offset + i >= k_offset + j,
// or past the ragged edge of lk) get s = -1e30 and p = 0, so a row that
// sees no key gives out = 0 and lse = -1e30 (:142-146, :166-171). Causal
// tiles entirely above the diagonal are skipped.
//
// Two designs.
//
// bf16 forward, dq and dk/dv (`flash_fwd_kernel_mma`, `flash_bwd_dq_kernel_mma`,
// `flash_bwd_dkv_kernel_mma`) run every dot on the tensor cores:
// mma.sync.m16n8k16 bf16 x bf16 -> f32. Each warp owns 16 rows of the output
// tile (query rows in the forward and dq, key rows in dk/dv). Tiles arrive in
// bf16 shared memory by 16-byte cp.async, double buffered: the copy of tile
// i+1 is issued before tile i is computed. Rows are padded to d + 8 elements
// (16 bytes), so the 8 row addresses of an ldmatrix fall in 8 distinct
// 16-byte bank groups. The ragged edge of lq and lk is the zero-fill form of
// cp.async (src-size 0).
//   forward: Q's A fragments come once from shared memory by ldmatrix;
//     S = Q K^T takes K's rows as B columns (plain ldmatrix); the online
//     softmax runs on the C fragments in registers (row max and sum over the
//     4 lanes of a quad, exp2 with scale * log2 e folded in); O += P V
//     reuses P's C fragments as A fragments in registers and takes V by
//     ldmatrix.trans. The out tile goes back through the warp's own rows of
//     the Q tile as 16-byte stores. Tile: 64 query rows (4 warps) x 64 keys.
//   dq: the forward with a second score product and no online softmax. Q and
//     dO are A fragments, held in registers for the block's lifetime at
//     d <= 64 (at d 128, which would spill, they stay in shared memory and
//     are reloaded by ldmatrix for each k-tile). S = Q K^T and dP = dO V^T
//     take K and V rows as B columns from the double-buffered k-tiles; P =
//     exp(S scale - lse) and dS = P (dP - delta) scale are formed on the C
//     fragments in registers (lse and delta: 2 rows a thread); dQ += dS K
//     reuses dS's C fragments as A fragments and takes K, from the same
//     shared tile, by ldmatrix.trans. Tile: 64 query rows (4 warps) x 64 keys.
//   dk/dv: K and V are A fragments, held in registers for the block's
//     lifetime at d <= 64 (at d 128 they stay in shared memory, as dq's Q
//     and dO). S^T = K Q^T and dP^T = V dO^T take Q and dO as B operands
//     from the double-buffered tiles, with lse and delta staged beside them; P^T = exp(S^T scale -
//     lse) and dS^T = P^T (dP^T - delta) scale are formed in registers,
//     already in A-fragment layout; dV += P^T dO and dK += dS^T Q take dO and
//     Q by ldmatrix.trans. Tile: 64 keys (4 warps) x 64 queries (32 at d 128).
//   Tiles: 4 warps, 64 x 64 for every kernel (dk/dv 64 x 32 at d 128).
//     At b 8, h 16, L 1024, d 64 on the H100 these beat 8-warp blocks and
//     wider k- or q-tiles (128 x 64, 64 x 128, 128 x 128 forward; 128 x 64,
//     128 x 32 dk/dv), and 64 x 32 dk/dv was no faster (PERF.md).
//     ptxas -v: dq and dk/dv spill nothing at any head_dim (the forward at
//     d 32 under bf16_dots spills 4 bytes); dq's registers a thread
//     (bf16_dots 0 / 1) are 127 / 127 at d 32, 211 / 211 at d 64 and
//     233 / 234 at d 128, with Q and dO in shared memory there.
//   Masking: the element mask runs only on tiles that cross the diagonal or
//     the ragged edge of lk, and overwrites p with 0 there: a row that sees
//     no key has lse = -1e30, so its exp is inf, and the mask must win (such
//     a row's dq is 0, its dk/dv terms are 0).
//
// Numerics. q, k, v and dout are bf16, and a bf16 x bf16 product is exact in
// f32, so S and dP are the f32 SIMT kernel's products with only the order of
// the f32 sum changed. p and ds are f32. With bf16_dots = 0 (JAX's f32
// dot_dtype) each enters its dot as two bf16 terms, hi = bf16_rn(x) and
// lo = bf16_rn(x - hi), so two mma give the f32 dot within 2^-16 of |x|
// relative (hi and lo each round to within 2^-8 relative, so
// |x - hi - lo| <= 2^-8 |x - hi| <= 2^-16 |x|),
// below the half-ULP 2^-9 at which out, dq, dk and dv are rounded to bf16.
// With bf16_dots = 1 every operand is rounded to bf16 and sums stay f32: hi
// alone, one mma, as JAX's ds.astype(bfloat16). No product on this path runs
// on the f32 SIMT units.
//
// f32 inputs (every kernel) keep the SIMT design: 64 x 64 tiles, 256 threads
// as a 16 x 16 grid, f32 tiles in shared memory padded to d + 1, every
// product an f32 FMA (bf16_dots rounds each operand to bf16 first). f32
// inputs have no exact bf16 product, so the tensor cores would change their
// answer. `chip_smoke.py` holds this path in phase `train_ref` (a tiny f32
// GPT, gradients within 1e-4) and in the f32 cases of phase `flash`.
//
// Bound (b 8, h 16, L 1024, d 64, causal, bf16; H100 SXM: 989 TF/s bf16,
// 3.35 TB/s; the function's work, not the kernels'): forward 2 causal dots
// 17.2 GFLOP (17.4 us) vs 67.6 MB (20.2 us): bytes; dq 3 dots 25.8 GFLOP
// (26.1 us) vs 85 MB (25.4 us): operations; dk/dv 4 dots 34.4 GFLOP
// (34.8 us) vs 102 MB (30.4 us): operations. The hi/lo split runs the p and
// ds dots twice, so the tensor cores execute 1.5x those operations (dq
// 1.33x: only dS K is split), and the diagonal tiles compute their masked
// half. exp2 on the special-function unit (16 a clock per SM) costs about
// as much as the mma of a d-64 score.
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
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
// bf16 tensor-core kernels: forward, dk/dv
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16x2 hi = bf16_rn(x) and lo = bf16_rn(x - hi); x - hi is
// exact in f32. The lower half holds x0, the lower column of the pair.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// The A fragments (hi, lo) of the 16-column chunk kk of a warp's 16-row
// tile held as C fragments c[n-tile][4] (columns 8 n .. 8 n + 7).
template <int NT>
__device__ __forceinline__ void c_to_a(const float (&c)[NT][4], int kk, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);          // row g,     cols 2t, 2t+1
  split2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);          // row g + 8
  split2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);  // row g,     cols 8 + 2t
  split2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);  // row g + 8
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice, D bf16 each, into a
// [ROWS, D + 8] shared tile by 16-byte cp.async; rows at or past `len` are
// zero-filled (the source address is then row 0's and is not read).
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int64_t row_stride, int row0, int len) {
  constexpr int CPR = D / 8, N = ROWS * CPR;  // 16-byte chunks per row, per tile
#pragma unroll
  for (int j = 0; j < (N + NTHREADS - 1) / NTHREADS; ++j) {
    const int i = threadIdx.x + j * NTHREADS, r = i / CPR, c = (i % CPR) * 8;
    if (N % NTHREADS != 0 && i >= N) break;
    const bool ok = row0 + r < len;
    cp_async16(smem_addr(dst + r * (D + 8) + c),
               src + (ok ? (int64_t)(row0 + r) * row_stride : 0) + c, ok ? 16 : 0);
  }
}

// A warp's 16 x D f32 accumulator (C fragments acc[D / 8][4]) rounded to bf16
// and written to rows [row0, row0 + 16) (those below `len`) of `dst`, through
// the warp's own [16, D + 8] shared rows `stage` for 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const float (&mul)[2],
                                           bf16* stage, bf16* __restrict__ dst,
                                           int64_t row_stride, int row0, int len) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * (D + 8) + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] * mul[0], acc[n][1] * mul[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * (D + 8) + n * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] * mul[1], acc[n][3] * mul[1]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (row0 + r < len)
      *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * (D + 8) + c);
  }
}

// Tiles of the tensor-core kernels, 16 rows a warp (the forward's query
// rows, dk/dv's key rows): 4 warps, 64 x 64 (see the header).
constexpr int FWD_THREADS = 128;
constexpr int FWD_BQ = 64;  // query rows of a forward block
constexpr int FWD_BK = 64;  // keys of a forward k-tile
constexpr int DKV_THREADS = 128;
constexpr int DKV_BK = 64;  // key rows of a dk/dv block
constexpr int DQ_THREADS = 128;
constexpr int DQ_BQ = 64;  // query rows of a dq block
constexpr int DQ_BK = 64;  // keys of a dq k-tile
// queries of a dk/dv q-tile; 32 at d 128, where 64 would spill registers
template <int D> __host__ __device__ constexpr int dkv_bq() { return D == 128 ? 32 : 64; }

// forward. LO: p enters P V as hi + lo (bf16_dots = 0), else as hi alone.
template <int D, bool LO>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, Args a) {
  constexpr int LDS = D + 8, KC = D / 16, NT = FWD_BK / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [FWD_BQ][LDS]
  bf16* Ks = Qs + FWD_BQ * LDS;                   // [2][FWD_BK][LDS]
  bf16* Vs = Ks + 2 * FWD_BK * LDS;               // [2][FWD_BK][LDS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q_lo = blockIdx.x * FWD_BQ;
  const int64_t rs = (int64_t)a.h * D;
  const bf16* qb = q + ((int64_t)ib * a.lq * a.h + ih) * D;
  const bf16* kb = k + ((int64_t)ib * a.lk * a.h + ih) * D;
  const bf16* vb = v + ((int64_t)ib * a.lk * a.h + ih) * D;
  const float sl2 = a.scale * LOG2E;  // scores in log2 units: p = exp2(s sl2 - m)

  // k-tiles to visit: causal tiles past the block's last query are skipped
  int nk = (a.lk + FWD_BK - 1) / FWD_BK;
  if (a.causal) {
    const int last = a.q_offset + min(q_lo + FWD_BQ, a.lq) - 1 - a.k_offset;  // last visible key
    nk = last < 0 ? 0 : min(nk, last / FWD_BK + 1);
  }

  float o[DT][4], m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  uint32_t qf[KC][4];
  if (nk > 0) {
    load_tile_async<FWD_BQ, D, FWD_THREADS>(Qs, qb, rs, q_lo, a.lq);
    load_tile_async<FWD_BK, D, FWD_THREADS>(Ks, kb, rs, 0, a.lk);
    load_tile_async<FWD_BK, D, FWD_THREADS>(Vs, vb, rs, 0, a.lk);
  }
  cp_async_commit();

  const int qr0 = q_lo + warp * 16 + g;  // this thread's rows: qr0, qr0 + 8
  for (int ik = 0; ik < nk; ++ik) {
    const int st = ik & 1, k_lo = ik * FWD_BK;
    if (ik + 1 < nk) {  // tile ik + 1 into the other stage, read by no warp since the last barrier
      load_tile_async<FWD_BK, D, FWD_THREADS>(Ks + (st ^ 1) * FWD_BK * LDS, kb, rs,
                                              k_lo + FWD_BK, a.lk);
      load_tile_async<FWD_BK, D, FWD_THREADS>(Vs + (st ^ 1) * FWD_BK * LDS, vb, rs,
                                              k_lo + FWD_BK, a.lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile ik (and Q) has landed for this thread ...
    __syncthreads();     // ... and for every thread
    const bf16* Kt = Ks + st * FWD_BK * LDS;
    const bf16* Vt = Vs + st * FWD_BK * LDS;
    if (ik == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], smem_addr(Qs + (warp * 16 + lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
    }

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];  // keys 16 np + [0, 8) and + [8, 16), d 16 kc + [0, 16)
        ldmatrix_x4(b, smem_addr(Kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LDS + kc * 16 +
                                 ((lane / 8) % 2) * 8));
        mma(s[2 * np], qf[kc], b[0], b[1]);
        mma(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }

    // online softmax on the C fragments: rows qr0 (e 0, 1) and qr0 + 8 (e 2, 3)
    const bool edge = k_lo + FWD_BK > a.lk ||
                      (a.causal && a.q_offset + q_lo < a.k_offset + k_lo + FWD_BK - 1);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int kc = k_lo + n * 8 + 2 * t + (e & 1);
          if (kc >= a.lk || (a.causal && a.q_offset + qr0 + 8 * (e / 2) < a.k_offset + kc))
            x = NEG_BIG;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this thread's share of the row sum; the quad adds up at the end
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked entry is 0, also in a row that has seen no key yet (m = -1e30)
        const float p = s[n][e] > 0.5f * NEG_BIG ? exp2f(s[n][e] - m[e / 2]) : 0.0f;
        s[n][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's C fragments are the A fragments, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < FWD_BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      c_to_a(s, kk, ph, pl);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];  // keys 16 kk + [0, 16), d 16 dp + [0, 8) and + [8, 16)
        ldmatrix_x4_trans(b, smem_addr(Vt + (kk * 16 + lane % 16) * LDS + dp * 16 + (lane / 16) * 8));
        mma(o[2 * dp], ph, b[0], b[1]);
        mma(o[2 * dp + 1], ph, b[2], b[3]);
        if (LO) {
          mma(o[2 * dp], pl, b[0], b[1]);
          mma(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.0f ? 1.0f : 1.0f / l[r];  // a row that saw no key: zeros
    const int qr = qr0 + 8 * r;
    if (t == 0 && qr < a.lq)
      lse[((int64_t)ib * a.h + ih) * a.lq + qr] = l[r] == 0.0f ? NEG_BIG : m[r] * LN2 + logf(l[r]);
  }
  // only this warp reads its 16 rows of Qs (its ldmatrix of ik 0)
  store_rows<D>(o, inv, Qs + warp * 16 * LDS, out + ((int64_t)ib * a.lq * a.h + ih) * D, rs,
                q_lo + warp * 16, a.lq);
}

// dk, dv. LO: p and ds enter their dots as hi + lo (bf16_dots = 0).
template <int D, bool LO>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Args a) {
  constexpr int BQM = dkv_bq<D>(), LDS = D + 8, KC = D / 16, NT = BQM / 8, DT = D / 8;
  constexpr bool KV_REGS = D <= 64;  // K and V fragments in registers for the block's life
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [DKV_BK][LDS]
  bf16* Vs = Ks + DKV_BK * LDS;                   // [DKV_BK][LDS]
  bf16* Qs = Vs + DKV_BK * LDS;                   // [2][BQM][LDS]
  bf16* dOs = Qs + 2 * BQM * LDS;                 // [2][BQM][LDS]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQM * LDS);  // [2][BQM], log2 units
  float* delta_s = lse_s + 2 * BQM;                               // [2][BQM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int k_lo = blockIdx.x * DKV_BK;
  const int64_t rs = (int64_t)a.h * D;
  const int64_t qbase = ((int64_t)ib * a.lq * a.h + ih) * D;
  const int64_t kbase = ((int64_t)ib * a.lk * a.h + ih) * D;
  const float* lse_bh = lse + ((int64_t)ib * a.h + ih) * a.lq;
  const float* delta_bh = delta + ((int64_t)ib * a.h + ih) * a.lq;
  const float sl2 = a.scale * LOG2E;

  // q-tiles to visit: from the first whose last query sees this k-tile's first key
  const int nq = (a.lq + BQM - 1) / BQM;
  int iq0 = 0;
  if (a.causal)
    while (iq0 < nq && a.q_offset + min((iq0 + 1) * BQM, a.lq) - 1 < a.k_offset + k_lo) ++iq0;

  auto stage_q = [&](int iq, int st) {  // Q, dO by cp.async; lse, delta by plain loads
    const int q_lo = iq * BQM;
    load_tile_async<BQM, D, DKV_THREADS>(Qs + st * BQM * LDS, q + qbase, rs, q_lo, a.lq);
    load_tile_async<BQM, D, DKV_THREADS>(dOs + st * BQM * LDS, dout + qbase, rs, q_lo, a.lq);
    for (int i = threadIdx.x; i < BQM; i += DKV_THREADS) {
      const bool ok = q_lo + i < a.lq;
      lse_s[st * BQM + i] = ok ? lse_bh[q_lo + i] * LOG2E : 0.0f;
      delta_s[st * BQM + i] = ok ? delta_bh[q_lo + i] : 0.0f;
    }
  };

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  uint32_t kf[KV_REGS ? KC : 1][4], vf[KV_REGS ? KC : 1][4];
  if (iq0 < nq) {
    load_tile_async<DKV_BK, D, DKV_THREADS>(Ks, k + kbase, rs, k_lo, a.lk);
    load_tile_async<DKV_BK, D, DKV_THREADS>(Vs, v + kbase, rs, k_lo, a.lk);
    stage_q(iq0, 0);
  }
  cp_async_commit();

  const int kr0 = k_lo + warp * 16 + g;  // this thread's keys: kr0 (e 0, 1), kr0 + 8 (e 2, 3)
  const bf16* Kw = Ks + warp * 16 * LDS;  // this warp's 16 key rows
  const bf16* Vw = Vs + warp * 16 * LDS;
  for (int iq = iq0; iq < nq; ++iq) {
    const int st = (iq - iq0) & 1, q_lo = iq * BQM;
    if (iq + 1 < nq) stage_q(iq + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * BQM * LDS;
    const bf16* dOt = dOs + st * BQM * LDS;
    const float* lse_t = lse_s + st * BQM;
    const float* delta_t = delta_s + st * BQM;
    if (KV_REGS && iq == iq0) {
#pragma unroll
      for (int kc = 0; kc < (KV_REGS ? KC : 1); ++kc) {
        ldmatrix_x4(kf[kc], smem_addr(Kw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
        ldmatrix_x4(vf[kc], smem_addr(Vw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
      }
    }

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQM queries a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      if (KV_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[KV_REGS ? kc : 0][e];
          va[e] = vf[KV_REGS ? kc : 0][e];
        }
      } else {
        ldmatrix_x4(ka, smem_addr(Kw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
        ldmatrix_x4(va, smem_addr(Vw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + lane % 8 + (lane / 16) * 8) * LDS + kc * 16 + ((lane / 8) % 2) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(Qt + off));
        mma(s[2 * np], ka, b[0], b[1]);
        mma(s[2 * np + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, smem_addr(dOt + off));
        mma(dp[2 * np], va, b[0], b[1]);
        mma(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T in registers, in place of S^T and dP^T
    const bool edge = k_lo + DKV_BK > a.lk || q_lo + BQM > a.lq ||
                      (a.causal && a.q_offset + q_lo < a.k_offset + k_lo + DKV_BK - 1);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);  // query column in the tile
        float p = exp2f(s[n][e] * sl2 - lse_t[c]);
        if (edge) {
          const int kc = kr0 + 8 * (e / 2), qr = q_lo + c;
          if (qr >= a.lq || kc >= a.lk || (a.causal && a.q_offset + qr < a.k_offset + kc))
            p = 0.0f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_t[c]) * a.scale;
      }

    // dV += P^T dO, dK += dS^T Q: A from the C fragments, dO and Q by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQM / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      c_to_a(s, kk, ph, pl);
      c_to_a(dp, kk, dh, dl);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const int off = (kk * 16 + lane % 16) * LDS + dd * 16 + (lane / 16) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(dOt + off));
        mma(dva[2 * dd], ph, b[0], b[1]);
        mma(dva[2 * dd + 1], ph, b[2], b[3]);
        if (LO) {
          mma(dva[2 * dd], pl, b[0], b[1]);
          mma(dva[2 * dd + 1], pl, b[2], b[3]);
        }
        ldmatrix_x4_trans(b, smem_addr(Qt + off));
        mma(dka[2 * dd], dh, b[0], b[1]);
        mma(dka[2 * dd + 1], dh, b[2], b[3]);
        if (LO) {
          mma(dka[2 * dd], dl, b[0], b[1]);
          mma(dka[2 * dd + 1], dl, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // only this warp reads its 16 rows of Ks and Vs
  const float one[2] = {1.0f, 1.0f};
  const int row0 = k_lo + warp * 16;
  store_rows<D>(dka, one, Ks + warp * 16 * LDS, dk + kbase, rs, row0, a.lk);
  store_rows<D>(dva, one, Vs + warp * 16 * LDS, dv + kbase, rs, row0, a.lk);
}

// dq. LO: ds enters dS K as hi + lo (bf16_dots = 0), else as hi alone.
template <int D, bool LO>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, Args a) {
  constexpr int LDS = D + 8, KC = D / 16, NT = DQ_BK / 8, DT = D / 8;
  constexpr bool QO_REGS = D <= 64;  // Q and dO fragments in registers for the block's life
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [DQ_BQ][LDS]
  bf16* dOs = Qs + DQ_BQ * LDS;                   // [DQ_BQ][LDS]
  bf16* Ks = dOs + DQ_BQ * LDS;                   // [2][DQ_BK][LDS]
  bf16* Vs = Ks + 2 * DQ_BK * LDS;                // [2][DQ_BK][LDS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q_lo = blockIdx.x * DQ_BQ;
  const int64_t rs = (int64_t)a.h * D;
  const int64_t qbase = ((int64_t)ib * a.lq * a.h + ih) * D;
  const bf16* kb = k + ((int64_t)ib * a.lk * a.h + ih) * D;
  const bf16* vb = v + ((int64_t)ib * a.lk * a.h + ih) * D;
  const float sl2 = a.scale * LOG2E;

  int nk = (a.lk + DQ_BK - 1) / DQ_BK;  // k-tiles to visit, as in the forward
  if (a.causal) {
    const int last = a.q_offset + min(q_lo + DQ_BQ, a.lq) - 1 - a.k_offset;
    nk = last < 0 ? 0 : min(nk, last / DQ_BK + 1);
  }

  // this thread's rows qr0 (e 0, 1) and qr0 + 8 (e 2, 3): lse in log2 units, delta
  const int qr0 = q_lo + warp * 16 + g;
  const float* lse_bh = lse + ((int64_t)ib * a.h + ih) * a.lq;
  const float* delta_bh = delta + ((int64_t)ib * a.h + ih) * a.lq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qr0 + 8 * r < a.lq;
    lse2[r] = ok ? lse_bh[qr0 + 8 * r] * LOG2E : 0.0f;
    dlt[r] = ok ? delta_bh[qr0 + 8 * r] : 0.0f;
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  uint32_t qf[QO_REGS ? KC : 1][4], of[QO_REGS ? KC : 1][4];
  if (nk > 0) {
    load_tile_async<DQ_BQ, D, DQ_THREADS>(Qs, q + qbase, rs, q_lo, a.lq);
    load_tile_async<DQ_BQ, D, DQ_THREADS>(dOs, dout + qbase, rs, q_lo, a.lq);
    load_tile_async<DQ_BK, D, DQ_THREADS>(Ks, kb, rs, 0, a.lk);
    load_tile_async<DQ_BK, D, DQ_THREADS>(Vs, vb, rs, 0, a.lk);
  }
  cp_async_commit();

  const bf16* Qw = Qs + warp * 16 * LDS;  // this warp's 16 query rows
  const bf16* dOw = dOs + warp * 16 * LDS;
  for (int ik = 0; ik < nk; ++ik) {
    const int st = ik & 1, k_lo = ik * DQ_BK;
    if (ik + 1 < nk) {  // tile ik + 1 into the other stage, read by no warp since the last barrier
      load_tile_async<DQ_BK, D, DQ_THREADS>(Ks + (st ^ 1) * DQ_BK * LDS, kb, rs, k_lo + DQ_BK,
                                            a.lk);
      load_tile_async<DQ_BK, D, DQ_THREADS>(Vs + (st ^ 1) * DQ_BK * LDS, vb, rs, k_lo + DQ_BK,
                                            a.lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * DQ_BK * LDS;
    const bf16* Vt = Vs + st * DQ_BK * LDS;
    if (QO_REGS && ik == 0) {
#pragma unroll
      for (int kc = 0; kc < (QO_REGS ? KC : 1); ++kc) {
        ldmatrix_x4(qf[kc], smem_addr(Qw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
        ldmatrix_x4(of[kc], smem_addr(dOw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
      }
    }

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp, K and V rows as B columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], oa[4];
      if (QO_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[QO_REGS ? kc : 0][e];
          oa[e] = of[QO_REGS ? kc : 0][e];
        }
      } else {
        ldmatrix_x4(qa, smem_addr(Qw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
        ldmatrix_x4(oa, smem_addr(dOw + (lane % 16) * LDS + kc * 16 + (lane / 16) * 8));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + lane % 8 + (lane / 16) * 8) * LDS + kc * 16 + ((lane / 8) % 2) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(Kt + off));
        mma(s[2 * np], qa, b[0], b[1]);
        mma(s[2 * np + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, smem_addr(Vt + off));
        mma(dp[2 * np], oa, b[0], b[1]);
        mma(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // dS = P (dP - delta) scale in registers, in place of dP; a masked p is 0,
    // also in a row that sees no key (lse -1e30 makes its exp inf)
    const bool edge = k_lo + DQ_BK > a.lk ||
                      (a.causal && a.q_offset + q_lo < a.k_offset + k_lo + DQ_BK - 1);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float p = exp2f(s[n][e] * sl2 - lse2[r]);
        if (edge) {
          const int kc = k_lo + n * 8 + 2 * t + (e & 1);
          if (kc >= a.lk || (a.causal && a.q_offset + qr0 + 8 * r < a.k_offset + kc)) p = 0.0f;
        }
        dp[n][e] = p * (dp[n][e] - dlt[r]) * a.scale;
      }

    // dQ += dS K: dS's C fragments are the A fragments, K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      uint32_t dh[4], dl[4];
      c_to_a(dp, kk, dh, dl);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];  // keys 16 kk + [0, 16), d 16 dd + [0, 8) and + [8, 16)
        ldmatrix_x4_trans(b, smem_addr(Kt + (kk * 16 + lane % 16) * LDS + dd * 16 + (lane / 16) * 8));
        mma(acc[2 * dd], dh, b[0], b[1]);
        mma(acc[2 * dd + 1], dh, b[2], b[3]);
        if (LO) {
          mma(acc[2 * dd], dl, b[0], b[1]);
          mma(acc[2 * dd + 1], dl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  // only this warp reads its 16 rows of Qs
  const float one[2] = {1.0f, 1.0f};
  store_rows<D>(acc, one, Qs + warp * 16 * LDS, dq + qbase, rs, q_lo + warp * 16, a.lq);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() { return sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP); }
template <int D> constexpr size_t dq_smem() { return sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP); }
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * LDP + 2 * BQ);
}
template <int D> constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (FWD_BQ + 4 * FWD_BK) * (D + 8);
}
template <int D> constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (2 * DKV_BK + 4 * dkv_bq<D>()) * (D + 8) + sizeof(float) * 4 * dkv_bq<D>();
}
template <int D> constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (2 * DQ_BQ + 4 * DQ_BK) * (D + 8);
}

template <typename Kernel, typename... Ptrs>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int tiles, int h, int b,
                   cudaStream_t st, const Args& a, Ptrs... ptrs) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles, h, b), threads, smem, st>>>(ptrs..., a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                int b, const Args& a, cudaStream_t st) {
  return launch(flash_fwd_kernel<T, D>, THREADS, fwd_smem<D>(), (a.lq + BQ - 1) / BQ, a.h, b,
                st, a, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out), lse);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int b, const Args& a,
                   cudaStream_t st) {
  return launch(flash_bwd_dq_kernel<T, D>, THREADS, dq_smem<D>(), (a.lq + BQ - 1) / BQ, a.h,
                b, st, a, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                static_cast<T*>(dq));
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int b,
                    const Args& a, cudaStream_t st) {
  return launch(flash_bwd_dkv_kernel<T, D>, THREADS, dkv_smem<D>(), (a.lk + BK - 1) / BK,
                a.h, b, st, a, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                static_cast<T*>(dk), static_cast<T*>(dv));
}

template <int D>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                    int b, const Args& a, cudaStream_t st) {
  auto kernel = a.bf16_dots ? flash_fwd_kernel_mma<D, false> : flash_fwd_kernel_mma<D, true>;
  return launch(kernel, FWD_THREADS, fwd_mma_smem<D>(), (a.lq + FWD_BQ - 1) / FWD_BQ, a.h, b,
                st, a, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(out), lse);
}

template <int D>
cudaError_t bwd_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int b,
                        const Args& a, cudaStream_t st) {
  auto kernel =
      a.bf16_dots ? flash_bwd_dkv_kernel_mma<D, false> : flash_bwd_dkv_kernel_mma<D, true>;
  return launch(kernel, DKV_THREADS, dkv_mma_smem<D>(), (a.lk + DKV_BK - 1) / DKV_BK, a.h, b,
                st, a, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                static_cast<bf16*>(dk), static_cast<bf16*>(dv));
}

template <int D>
cudaError_t bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int b, const Args& a,
                       cudaStream_t st) {
  auto kernel = a.bf16_dots ? flash_bwd_dq_kernel_mma<D, false> : flash_bwd_dq_kernel_mma<D, true>;
  return launch(kernel, DQ_THREADS, dq_mma_smem<D>(), (a.lq + DQ_BQ - 1) / DQ_BQ, a.h, b, st, a,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                static_cast<bf16*>(dq));
}

// Returns FN<float, D>(...) for the head_dim given at run time (the f32
// SIMT kernels: every entry point sends bf16 to the tensor-core kernels
// first); anything else is cudaErrorInvalidValue (the wrapper raises first).
#define FLASH_DISPATCH(FN, ...)                             \
  {                                                         \
    if (d == 32) return (int)FN<float, 32>(__VA_ARGS__);    \
    if (d == 64) return (int)FN<float, 64>(__VA_ARGS__);    \
    if (d == 128) return (int)FN<float, 128>(__VA_ARGS__);  \
    return (int)cudaErrorInvalidValue;                      \
  }

// Returns FN<D>(...) for the head_dim given at run time (the bf16
// tensor-core kernels); anything else is cudaErrorInvalidValue.
#define HEAD_DIM_DISPATCH(FN, ...)                  \
  {                                                 \
    if (d == 32) return (int)FN<32>(__VA_ARGS__);   \
    if (d == 64) return (int)FN<64>(__VA_ARGS__);   \
    if (d == 128) return (int)FN<128>(__VA_ARGS__); \
    return (int)cudaErrorInvalidValue;              \
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) HEAD_DIM_DISPATCH(fwd_mma, q, k, v, out, lse, b, a, st)
  FLASH_DISPATCH(fwd, q, k, v, out, lse, b, a, st)
}

int flash_bwd_dq(int device, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta, void* dq,
                 int is_bf16, int b, int lq, int lk, int h, int d, float scale, int causal,
                 int q_offset, int k_offset, int bf16_dots, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (b == 0 || lq == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{lq, lk, h, scale, causal, q_offset, k_offset, bf16_dots};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) HEAD_DIM_DISPATCH(bwd_dq_mma, q, k, v, dout, lse, delta, dq, b, a, st)
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, b, a, st)
}

int flash_bwd_dkv(int device, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta, void* dk,
                  void* dv, int is_bf16, int b, int lq, int lk, int h, int d, float scale,
                  int causal, int q_offset, int k_offset, int bf16_dots, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (b == 0 || lk == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{lq, lk, h, scale, causal, q_offset, k_offset, bf16_dots};
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) HEAD_DIM_DISPATCH(bwd_dkv_mma, q, k, v, dout, lse, delta, dk, dv, b, a, st)
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, b, a, st)
}

}  // extern "C"
