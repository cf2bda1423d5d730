// Fused ResNet bottleneck blocks for the ResNet-50 training step (sm_90a).
//
//   fused_bottleneck  replaces kubeflow_tpu/ops/fused_bottleneck.py `_kernel`
//                     (:76, pallas_call :144): the identity-shortcut block,
//                     y = relu(x + (relu(conv3x3(relu(x W1 s1 + b1)) s2 + b2)) W3 s3 + b3).
//   fused_transition  replaces `_transition_kernel` (:237, pallas_call :325):
//                     the stage head, a stride-1 or stride-2 3x3 and the
//                     projection shortcut x[::s, ::s] Wp sp + bp in place of x.
//
// Layout. x: [n, hw, hw, cin] NHWC, bf16 or f32; out: [n, ho, ho, cout] in
// x's dtype. The weights come rounded to bf16 and transposed to [out, in]
// (w2 as [cmid, 9 cmid], k = (3 di + dj) cmid + ci), the folded norms as f32
// scale and bias. Channel counts are multiples of 16 (the wrapper pads any
// other to that).
//
// Numerics follow the Pallas kernels. Every dot takes bf16 operands with f32
// sums: x is rounded to bf16 as it is loaded, h1 and h2 are rounded to bf16
// (round to nearest even) as they are stored; the affine, relu, residual and
// projection run in f32. That is exactly what the tensor cores compute, so
// the dots run as mma.sync m16n8k16 bf16 -> f32. The 3x3 uses XLA's SAME
// padding: (1, 1) at stride 1; (0, 1) at stride 2 on an even hw, so output
// (i, j) taps input rows 2i..2i+2 and columns 2j..2j+2, the one past the
// edge zero.
//
// Two designs share one source.
//
// bf16 x: `fused_bottleneck_kernel_mma` (identity) and
// `fused_transition_kernel_mma<S>` (stage head), one body (`block_mma`).
// The Pallas kernels keep one whole image in VMEM per grid step; at stage 1
// that is 1.6 MB of x, far beyond the 227 KB of shared memory a block has
// here. So each block owns one (image, band of output rows; an image's last
// band may be shorter) and runs three phases, each a block-wide GEMM
// (`block_gemm`):
//   1. h1 = relu(x W1 s1 + b1) for the image rows the band's 3x3 taps read,
//      into a zeroed bf16 tile that holds the SAME padding: at stride 1 the
//      band and a halo row each side, with a one-pixel border; at stride 2
//      rows 2 i0 .. 2 i0 + 2 band, stored as the image's even columns, then
//      the zero column past the edge, then the odd columns;
//   2. h2 = relu(conv3x3_s(h1) s2 + b2) for the band, an implicit GEMM of K
//      = 9 cmid: each A fragment comes from the h1 tile by ldmatrix, whose 8
//      per-lane row addresses are the 8 output pixels' positions at the
//      tap's offset, so no im2col copy is made. At stride 2 output column
//      oj reads image columns 2 oj, 2 oj + 1, 2 oj + 2: stored columns oj,
//      ho + 1 + oj and oj + 1, so at either stride an ldmatrix's 8 rows are
//      consecutive stored pixels, 16 bytes of bank offset apart;
//   3. identity: y = relu(x + h2 W3 s3 + b3); transition: out = relu(p + y),
//      y = h2 W3 s3 + b3 and p = x[::s, ::s] Wp sp + bp, two GEMMs through
//      one weight ring into two sets of sums, each warp 64 pixels x 32
//      channels of each (128 f32 sums a lane in all, as one 64 x 64 tile),
//      the projection's strided x pixels staged by cp.async with per-row
//      source addresses.
// What goes through shared memory: the weights always, and the x rows of
// phase 1 and of the projection, in k-chunks staged by 16-byte cp.async in
// a ring of two buffers (chunk i + 1 in flight while chunk i is computed),
// shared by all 8 warps; h1 and h2 stay there as bf16. Every fragment comes
// by ldmatrix and every dot runs as mma.sync m16n8k16 bf16 -> f32. Tile:
// each warp holds 64 pixels (4 m16 tiles) x 64 channels of f32 sums (32 and
// 32 in the transition's phase 3), so each B fragment feeds 4 mma; the 8
// warps stand 8 / wn along M and wn along N, wn the largest power of two up
// to 8 whose slices N fills (`warps_n`). A block's pixels go in sweeps of
// up to 8 / wn * 64 pixels and its channels in chunks of wn warps' slices,
// and each (sweep, chunk) pass streams its weights once; so in the
// transition, a phase whose weights reach FIT_WEIGHTS halves wn while that
// saves a sweep (`phase_warps_n`). A chunk of at most kc_rows weight rows
// is 64 deep (a whole 128-byte line of each row), else 32 (`chunk_depth`).
// Weight copies carry an L2 evict_last hint; the residual read and the
// output store are streaming (evict first). Rows in shared memory are
// padded by 8 bf16 values, so the 8 rows of an ldmatrix fall in 8 bank
// groups. Phase 3's epilogue goes through a per-warp f32 staging tile (in
// h1's region, free by then), so that the output (and the residual x) move
// as 16-byte vectors.
//   Band (ops/fused_bottleneck.py `plan_band_mma`, the fastest of a model
//   of staged bytes, mma and k-chunks among the bands that fit, its
//   weights fitted to a band sweep on the H100): identity 7 output rows at
//   hw 56, 28 and 7, 8 at 14; transition 7 at stage 1, then 4, 4, 3;
//   217-231 KB of dynamic shared memory, one block (8 warps) an SM. Wider
//   bands read the weights for more pixels and recompute fewer halo rows.
//   Where a transition band fits only so, its chunks are 64 deep up to 128
//   rows, or its phase 1 keeps its warps unfitted (`mma_choices`).
//   ptxas -v: 242 registers a thread (transition), 246 (identity), no spill.
//
// f32 x keeps the register-load design (`block_body`): one block per
// (image, band), h1 and h2 in shared memory, but the weights and phase 1's
// x loaded straight from global memory into registers, two 4-byte loads a
// lane per k-step, 32 pixels x 64 channels a warp item; at stride 2 the h1
// tile holds rows 2 i0 .. 2 i0 + 2 band in image order and the projection
// reads x[::2, ::2]. The wrapper picks its band (`plan_band`: 6 rows at
// stride 1 except 4 at 7 x 7, 2 at stride 2; 83-113 KB, two blocks an SM).
// Each output element is written by one thread after a fixed-order sum in
// both designs: the same inputs give the same bits on every run.
//
// Bound (batch 256, bf16; H100 SXM: 989 TF/s bf16, 3.35 TB/s), the larger
// of the dots' time and x read once + y written once + the weights:
//   fused_bottleneck (hw, cin, cmid): (56, 256, 64) 111.8 GFLOP 0.113 ms vs
//   822 MB 0.245 ms: bytes; (28, 512, 128) 0.113 vs 0.123 ms: bytes;
//   (14, 1024, 256) 0.113 vs 0.062 ms and (7, 2048, 512) 0.113 vs 0.033 ms:
//   operations.
//   fused_transition (hw, s, cin, cmid, cout): (56, 1, 64, 64, 256)
//   118.4 GFLOP 0.120 ms vs 514 MB 0.153 ms: bytes; (56, 2, 256, 128, 512)
//   0.193 vs 0.184 ms, (28, 2, 512, 256, 1024) 0.193 vs 0.093 ms and
//   (14, 2, 1024, 512, 2048) 0.193 vs 0.050 ms: operations.
// What the designs do about it: x and y cross device memory once each and
// h1/h2 never do (the bytes bound at stage 1); the dots run on the tensor
// cores (the operations bound at stages 3-4). What bounds the mma kernels
// instead: the weights, re-read by every block (8.9 MB per 49-pixel block
// at 7 x 7, 11.7 MB per 21-pixel stage-4 transition block), streamed at
// about 2.5 TB/s in all, and the halo rows of h1, recomputed by both
// neighbouring bands. The register-load kernels' mma units wait on their
// loads.
//
// Each entry point first makes `device` current (this library links its own
// CUDA runtime), launches on the caller's stream and returns
// cudaGetLastError(); it allocates and synchronises nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PAD = 8;  // bf16 values of padding after each shared pixel row
constexpr int MT = 2;   // m16 tiles per warp item: 32 pixels

struct Params {
  const void* x;
  const bf16 *w1t, *w2t, *w3t, *wpt;
  const float *s1, *b1, *s2, *b2, *s3, *b3, *sp, *bp;
  void* out;
  int hw, ho, cin, cmid, cout, band;
  // the bf16 kernels' layout choices (set by launch_mma): the most rows of
  // a 64-deep chunk, and whether phase 1's warps are fitted to its pixels
  int kc_rows, fit1;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring values of a row as one bf16x2 operand register.
struct LoadGlobal {
  __device__ __forceinline__ uint32_t operator()(const bf16* p) const {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ uint32_t operator()(const float* p) const {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return pack_bf16(v.x, v.y);
  }
};
struct LoadShared {
  __device__ __forceinline__ uint32_t operator()(const bf16* p) const {
    return *reinterpret_cast<const uint32_t*>(p);
  }
};

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni] += A(m-tile mi) * B(n-tile ni) over k in [0, K), for the
// warp-uniform counts mi < mt and ni < nt. Lane (g, t) = (lane / 4,
// lane % 4) holds PTX's m16n8k16 fragments: A rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9; B column g, rows 2t, 2t + 1 and
// 2t + 8, 2t + 9; C rows g and g + 8, columns 2t, 2t + 1. rows[mi][h]
// points at k = 0 of the lane's A row g + 8h of m-tile mi, or is null past
// the edge (zeros). B is stored [N][ldb]: `bt` points at (n0, k = 0).
template <int NT, typename P, typename Load>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const P (&rows)[MT][2],
                                          Load load, int K, int mt, int nt,
                                          const bf16* __restrict__ bt, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* bcol = bt + (int64_t)g * ldb + 2 * t;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const P r0 = rows[mi][0], r1 = rows[mi][1];
      const int k = k0 + 2 * t;
      a[mi][0] = (mi < mt && r0) ? load(r0 + k) : 0u;
      a[mi][1] = (mi < mt && r1) ? load(r1 + k) : 0u;
      a[mi][2] = (mi < mt && r0) ? load(r0 + k + 8) : 0u;
      a[mi][3] = (mi < mt && r1) ? load(r1 + k + 8) : 0u;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      if (ni < nt) {
        const bf16* b = bcol + (int64_t)(ni * 8) * ldb + k0;
        const uint32_t b0 = LoadGlobal()(b), b1 = LoadGlobal()(b + 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          if (mi < mt) mma(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }
}

template <int M_, int N_>
__device__ __forceinline__ void zero(float (&acc)[M_][N_][4]) {
#pragma unroll
  for (int mi = 0; mi < M_; ++mi)
#pragma unroll
    for (int ni = 0; ni < N_; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
}

// One block: image blockIdx.y, output rows [i0, i0 + rows), i0 = blockIdx.x *
// band; the last band of an image may be shorter (rows < band).
template <typename T, int S, bool PROJ>
__device__ __forceinline__ void block_body(const Params& p, unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int img = blockIdx.y, i0 = blockIdx.x * p.band;
  const int hw = p.hw, ho = p.ho, cin = p.cin, cmid = p.cmid, cout = p.cout;
  const int rows = min(p.band, ho - i0);
  const int ld = cmid + PAD;
  // h1 tile: rows [row0, row0 + hr) of the image, columns shifted by pad_l,
  // zero outside the image
  const int hr = S == 1 ? rows + 2 : 2 * rows + 1;
  const int wc = S == 1 ? hw + 2 : hw + 1;
  const int pad_l = S == 1 ? 1 : 0;
  const int row0 = S == 1 ? i0 - 1 : 2 * i0;
  bf16* h1s = reinterpret_cast<bf16*>(smem);
  bf16* h2s = h1s + (size_t)hr * wc * ld;
  const T* x = static_cast<const T*>(p.x) + (int64_t)img * hw * hw * cin;
  T* out = static_cast<T*>(p.out) + (int64_t)img * ho * ho * cout;

  {
    uint4* z = reinterpret_cast<uint4*>(h1s);
    const int n16 = hr * wc * ld / 8;
    for (int i = threadIdx.x; i < n16; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // 1. h1 = relu(x W1 s1 + b1) on the image rows [lo, hi) the taps read.
  const int lo = max(row0, 0), hi = min(row0 + hr, hw);
  const int m1 = (hi - lo) * hw;
  {
    const int chunks = (cmid + 63) / 64, items = (m1 + 31) / 32 * chunks;
    for (int it = warp; it < items; it += NWARPS) {
      const int mb = it / chunks * 32, n0 = it % chunks * 64;
      const int mt = min(MT, (m1 - mb + 15) / 16), nt = min(8, (cmid - n0) / 8);
      const T* rows[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mb + mi * 16 + g + 8 * h;
          rows[mi][h] = r < m1 ? x + ((int64_t)(lo + r / hw) * hw + r % hw) * cin : nullptr;
        }
      float acc[MT][8][4];
      zero(acc);
      warp_gemm<8>(acc, rows, LoadGlobal(), cin, mt, nt, p.w1t + (int64_t)n0 * cin, cin);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mb + mi * 16 + g + 8 * h, c = n0 + ni * 8 + 2 * t;
            if (mi >= mt || ni >= nt || r >= m1) continue;
            const float v0 = fmaxf(acc[mi][ni][2 * h] * __ldg(p.s1 + c) + __ldg(p.b1 + c), 0.0f);
            const float v1 =
                fmaxf(acc[mi][ni][2 * h + 1] * __ldg(p.s1 + c + 1) + __ldg(p.b1 + c + 1), 0.0f);
            store2(h1s + ((size_t)(lo + r / hw - row0) * wc + r % hw + pad_l) * ld + c, v0, v1);
          }
    }
  }
  __syncthreads();

  // 2. h2 = relu(conv3x3_s(h1) s2 + b2) for the band: 9 tap dots. Output
  // pixel (oi, oj) of the band reads h1 tile row oi*S + di, column oj*S + dj.
  const int np = rows * ho;
  {
    const int chunks = (cmid + 63) / 64, items = (np + 31) / 32 * chunks;
    for (int it = warp; it < items; it += NWARPS) {
      const int mb = it / chunks * 32, n0 = it % chunks * 64;
      const int mt = min(MT, (np - mb + 15) / 16), nt = min(8, (cmid - n0) / 8);
      int base[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mb + mi * 16 + g + 8 * h;
          base[mi][h] = q < np ? ((q / ho) * S * wc + (q % ho) * S) * ld : -1;
        }
      float acc[MT][8][4];
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * wc + tap % 3) * ld;
        const bf16* rows[MT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) rows[mi][h] = base[mi][h] < 0 ? nullptr : h1s + base[mi][h] + off;
        warp_gemm<8>(acc, rows, LoadShared(), cmid, mt, nt,
                     p.w2t + (int64_t)n0 * 9 * cmid + tap * cmid, 9 * cmid);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = mb + mi * 16 + g + 8 * h, c = n0 + ni * 8 + 2 * t;
            if (mi >= mt || ni >= nt || q >= np) continue;
            const float v0 = fmaxf(acc[mi][ni][2 * h] * __ldg(p.s2 + c) + __ldg(p.b2 + c), 0.0f);
            const float v1 =
                fmaxf(acc[mi][ni][2 * h + 1] * __ldg(p.s2 + c + 1) + __ldg(p.b2 + c + 1), 0.0f);
            store2(h2s + (size_t)q * ld + c, v0, v1);
          }
    }
  }
  __syncthreads();

  // 3. y = h2 W3 s3 + b3, plus x (identity) or x[::S, ::S] Wp sp + bp
  // (projection), relu, written in x's dtype.
  constexpr int NT = PROJ ? 4 : 8;
  const int chunks = (cout + NT * 8 - 1) / (NT * 8), items = (np + 31) / 32 * chunks;
  for (int it = warp; it < items; it += NWARPS) {
    const int mb = it / chunks * 32, n0 = it % chunks * (NT * 8);
    const int mt = min(MT, (np - mb + 15) / 16), nt = min(NT, (cout - n0) / 8);
    const bf16* hrows[MT][2];
    const T* xrows[MT][2];  // the shortcut's pixel of x
    int orow[MT][2];        // the output pixel, within the image
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mb + mi * 16 + g + 8 * h;
        const bool ok = q < np;
        const int oi = i0 + q / ho, oj = q % ho;
        hrows[mi][h] = ok ? h2s + (size_t)q * ld : nullptr;
        xrows[mi][h] = ok ? x + ((int64_t)oi * S * hw + oj * S) * cin : nullptr;
        orow[mi][h] = ok ? oi * ho + oj : -1;
      }
    float acc[MT][NT][4];
    zero(acc);
    warp_gemm<NT>(acc, hrows, LoadShared(), cmid, mt, nt, p.w3t + (int64_t)n0 * cmid, cmid);
    float accp[MT][PROJ ? NT : 1][4];
    if constexpr (PROJ) {
      zero(accp);
      warp_gemm<NT>(accp, xrows, LoadGlobal(), cin, mt, nt, p.wpt + (int64_t)n0 * cin, cin);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + ni * 8 + 2 * t;
          if (mi >= mt || ni >= nt || orow[mi][h] < 0) continue;
          float y0 = acc[mi][ni][2 * h] * __ldg(p.s3 + c) + __ldg(p.b3 + c);
          float y1 = acc[mi][ni][2 * h + 1] * __ldg(p.s3 + c + 1) + __ldg(p.b3 + c + 1);
          float r0, r1;
          if constexpr (PROJ) {
            r0 = accp[mi][ni][2 * h] * __ldg(p.sp + c) + __ldg(p.bp + c);
            r1 = accp[mi][ni][2 * h + 1] * __ldg(p.sp + c + 1) + __ldg(p.bp + c + 1);
          } else {
            load2(xrows[mi][h] + c, r0, r1);
          }
          store2(out + (int64_t)orow[mi][h] * cout + c, fmaxf(r0 + y0, 0.0f),
                 fmaxf(r1 + y1, 0.0f));
        }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_bottleneck_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_body<T, 1, false>(p, smem);
}

template <typename T, int S>
__global__ void __launch_bounds__(THREADS) fused_transition_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_body<T, S, true>(p, smem);
}

size_t smem_bytes(const Params& p, int stride) {
  const size_t rows = stride == 1 ? p.band + 2 : 2 * p.band + 1;
  const size_t cols = stride == 1 ? p.hw + 2 : p.hw + 1;
  return (rows * cols + (size_t)p.band * p.ho) * (p.cmid + PAD) * sizeof(bf16);
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int stride, int n, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, stride);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.ho + p.band - 1) / p.band, n), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool valid(const Params& p, int n, int stride) {
  return n > 0 && n <= 65535 && p.hw > 0 && p.band > 0 && p.ho > 0 && p.band <= p.ho &&
         (stride == 1 || (stride == 2 && p.hw % 2 == 0)) && p.cin > 0 && p.cin % 16 == 0 &&
         p.cmid > 0 && p.cmid % 16 == 0 && p.cout > 0 && p.cout % 16 == 0;
}

// ---------------------------------------------------------------------------
// bf16 x: operands staged in shared memory (fused_bottleneck_kernel_mma,
// fused_transition_kernel_mma)
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;        // k-chunks in the ring: one in flight while one is used
constexpr int KC_ROWS = 256;     // a chunk of at most this many rows is 64 deep, else 32
constexpr int WT_M = 4;          // m16 tiles a warp holds: 64 pixels
constexpr int EST_LD = 64 + 4;   // f32 row of a warp's epilogue staging
constexpr int EST_BYTES = NWARPS * 16 * EST_LD * 4;
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may take (227 KB)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// The same for a weight row, marked to stay in L2 ahead of the activations
// that stream past it (`policy` from createpolicy ... evict_last).
__device__ __forceinline__ void cp_async16_keep(uint32_t dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, 16, %2;\n" ::"r"(dst),
               "l"(src), "l"(policy));
}
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the newest STAGES - 2 groups have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Warps along N for a phase of n output channels, `width` channels a warp
// (64; 32 in the transition's phase 3): the largest power of two up to 8
// whose slices n fills; the other warps go along M. ops/fused_bottleneck.py
// `_warps_n` is the same rule.
__host__ __device__ __forceinline__ int warps_n(int n, int width = 64) {
  int w = 1;
  while (w * 2 <= NWARPS && w * 2 * width <= n) w *= 2;
  return w;
}
// The same for a phase of m pixels in the transition (fit_m): then halved
// while that saves a sweep over the pixels, since every sweep re-reads the
// phase's weights. ops/fused_bottleneck.py `_phase_warps_n`.
constexpr int FIT_WEIGHTS = 128 * 1024;  // weights of a phase worth fitting its warps to
__host__ __device__ __forceinline__ int sweeps(int m, int wn) {
  const int per = NWARPS / wn * WT_M * 16;  // pixels a sweep
  return (m + per - 1) / per;
}
__host__ __device__ __forceinline__ int phase_warps_n(int m, int n, int width, bool fit_m) {
  int wn = warps_n(n, width);
  while (fit_m && wn > 1 && sweeps(m, wn / 2) < sweeps(m, wn)) wn /= 2;
  return wn;
}
// The depth of a staged chunk of weight rows: 64 (a whole 128-byte line of
// each weight row) for up to kc_rows rows, else 32.
__host__ __device__ __forceinline__ int chunk_depth(int rows, int kc_rows) {
  return rows <= kc_rows ? 64 : 32;
}

// Shared memory of one block, in three regions (ops/fused_bottleneck.py
// `mma_layout` is the same sum): [h1 tile | phase 3: the f32 epilogue
// staging and the projection's ring of x chunks] [h2 | phase 1's ring of x
// chunks] [the ring of weight chunks]. A chunk's rows are padded by 8
// values (16 bytes), so the 8 rows of an ldmatrix fall in 8 bank groups.
// kc1..kc3: the phases' chunk depths; xstride, xstride3, bstride: the
// elements of one stage of each ring. The h1 tile holds hr image rows of wc
// pixels: at stride 1 the band's rows and a halo row each side, with a zero
// border all round; at stride 2 rows 2 i0 .. 2 i0 + 2 band, the image's even
// columns then its odd ones, with the zero column past the edge among the
// even ones.
struct MmaLayout {
  int lda, wc, wn1, wn2, wn3, kc1, kc2, kc3, xstride, xstride3, bstride;
  size_t region1, region2, region3;
  __host__ __device__ MmaLayout(int hw, int s, int cin, int cmid, int cout, int band, bool proj,
                                int kc_rows, bool fit1) {
    const int ho = hw / s, hr = s == 1 ? band + 2 : 2 * band + 1, w3 = proj ? 32 : 64;
    lda = cmid + PAD;
    wc = s == 1 ? hw + 2 : hw + 1;
    const int m1 = imin(hr, hw) * hw, m2 = band * ho;
    // each phase's weights: cin cmid, 9 cmid cmid, and (cmid + cin) cout
    wn1 = phase_warps_n(m1, cmid, 64, proj && fit1 && cin * cmid >= FIT_WEIGHTS);
    wn2 = phase_warps_n(m2, cmid, 64, proj && 9 * cmid * cmid >= FIT_WEIGHTS);
    wn3 = phase_warps_n(m2, cout, w3, proj && (cmid + cin) * cout >= FIT_WEIGHTS);
    const int xrows = imin(NWARPS / wn1 * WT_M, (m1 + 15) / 16) * 16;
    const int xrows3 = proj ? imin(NWARPS / wn3 * WT_M, (m2 + 15) / 16) * 16 : 0;
    const int r1 = imin(cmid, wn1 * 64), r2 = imin(cmid, wn2 * 64), r3 = imin(cout, wn3 * w3);
    kc1 = chunk_depth(imax(r1, xrows), kc_rows);
    kc2 = chunk_depth(r2, kc_rows);
    kc3 = chunk_depth(imax(r3, xrows3), kc_rows);
    xstride = xrows * (kc1 + 8);
    xstride3 = xrows3 * (kc3 + 8);
    bstride = imax(r1 * (kc1 + 8), imax(r2 * (kc2 + 8), r3 * (kc3 + 8)));
    const size_t h1 = (size_t)hr * wc * lda * 2, h2 = (size_t)band * ho * lda * 2;
    const size_t r1b = (size_t)EST_BYTES + (size_t)STAGES * xstride3 * 2;
    region1 = h1 > r1b ? h1 : r1b;
    const size_t xs = (size_t)STAGES * xstride * 2;
    region2 = h2 > xs ? h2 : xs;
    region3 = (size_t)STAGES * bstride * 2;
  }
  __host__ __device__ size_t bytes() const { return region1 + region2 + region3; }
};

// The layout choices of a launch (ops/fused_bottleneck.py `mma_choices`):
// the identity block takes 64-deep chunks up to KC_ROWS rows and phase 1's
// warps unfitted; the transition the first of these that fits: chunks 64
// deep up to KC_ROWS rows, then up to KC_ROWS / 2 (leaving room for a
// deeper band), each with phase 1's warps fitted to its pixels (which
// widens phase 1's ring of x chunks), then not.
void mma_choices(Params& p, int s, bool proj) {
  p.kc_rows = KC_ROWS;
  p.fit1 = 0;
  if (!proj) return;
  for (int kc_rows = KC_ROWS; kc_rows >= KC_ROWS / 2; kc_rows /= 2)
    for (int fit1 = 1; fit1 >= 0; --fit1)
      if (MmaLayout(p.hw, s, p.cin, p.cmid, p.cout, p.band, true, kc_rows, fit1).bytes() <=
          SMEM_MAX) {
        p.kc_rows = kc_rows;
        p.fit1 = fit1;
        return;
      }
}

// Where a GEMM's A rows come from: x staged through a ring from global
// memory (A_X: a run of whole image rows; A_XS: the projection's pixels
// x[::s, ::s]), the h1 tile at a 3x3 tap (A_H1), or h2 (A_H2). A_NONE: the
// phase has no second GEMM.
enum ASource { A_NONE = 0, A_X, A_XS, A_H1, A_H2 };

// One GEMM of a phase: C[m, n] = sum over taps and k of A[m, tap, k]
// w[n, tap K + k], w stored [N][taps K].
struct Gemm {
  const bf16* w;
  int K, taps;
  const bf16* x;       // A_X, A_XS: pixel 0 of x at k = 0
  bf16* stage;         // A_X, A_XS: the ring of staged rows, xstride elements a stage
  int xstride;
  const bf16* tile;    // A_H1, A_H2: the tile, ld elements a pixel
  int ld;
  // A_XS: row m is pixel (m / ow) opitch + (m % ow) ostep of x.
  // A_H1: output pixel (oi, oj) reads tile pixel oi opitch + oj + di wc +
  // col[dj] at tap (di, dj), col = {0, col1, col2}.
  int ow, opitch, ostep, wc, col1, col2;
};

__device__ __forceinline__ Gemm x_rows(const bf16* w, int K, const bf16* x, bf16* stage,
                                       int xstride) {
  Gemm g{};
  g.w = w, g.K = K, g.taps = 1, g.x = x, g.stage = stage, g.xstride = xstride;
  return g;
}
__device__ __forceinline__ Gemm tile_rows(const bf16* w, int K, int taps, const bf16* tile,
                                          int ld) {
  Gemm g{};
  g.w = w, g.K = K, g.taps = taps, g.tile = tile, g.ld = ld;
  return g;
}

// The lane's A row for pixel q of the phase (`local`: its row in the sweep's
// staged x): in staged rows (A_X, A_XS), or in elements of the tile.
template <int SRC>
__device__ __forceinline__ int a_row(const Gemm& g, int q, int local) {
  return SRC == A_X || SRC == A_XS ? local
         : SRC == A_H1             ? ((q / g.ow) * g.opitch + q % g.ow) * g.ld
                                   : q * g.ld;
}

// Stage chunk `cl` of GEMM g into ring buffer `buf`: its weight rows n0 ..
// n0 + nrows and, for A_X and A_XS, the sweep's x rows m0 .. m0 + mrows
// (zeros past M). Thread i copies 16 bytes (column (i % pieces) * 8 of the
// chunk) of rows i / pieces, i / pieces + THREADS / pieces, ...; columns
// past a short last chunk are skipped.
template <int SRC>
__device__ __forceinline__ void issue_chunk(const Gemm& g, int cl, int kpt, int kc, int buf,
                                            int n0, int nrows, int M, int m0, int mrows,
                                            bf16* bstage, int bstride, uint64_t keep) {
  const int shift = kc == 64 ? 3 : 2, ldk = kc + 8;  // 16-byte pieces a row: 1 << shift
  const int cr = threadIdx.x >> shift, cc = (threadIdx.x & ((1 << shift) - 1)) * 8;
  const int tap = cl / kpt, k0 = (cl % kpt) * kc;
  if (cc >= g.K - k0) return;
  const int ldw = g.taps * g.K;
  bf16* bs = bstage + buf * bstride + cc;
  const bf16* src = g.w + (int64_t)n0 * ldw + tap * g.K + k0 + cc;
  for (int r = cr; r < nrows; r += THREADS >> shift)
    cp_async16_keep(smem_addr(bs + r * ldk), src + (int64_t)r * ldw, keep);
  if constexpr (SRC == A_X || SRC == A_XS) {
    bf16* xs = g.stage + buf * g.xstride + cc;
    const bf16* xsrc = g.x + k0 + cc;
    for (int r = cr; r < mrows; r += THREADS >> shift) {
      const int m = m0 + r;
      int64_t pix = 0;
      if (m < M) pix = SRC == A_X ? m : (int64_t)(m / g.ow) * g.opitch + (m % g.ow) * g.ostep;
      cp_async16(smem_addr(xs + r * ldk), xsrc + pix * g.K, m < M ? 16 : 0);
    }
  }
}

// acc += the products of staged chunk `cl` of GEMM g (ring buffer `buf`,
// weights at bs) for the lane's mt m tiles and nt n8 tiles.
template <int SRC, int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[WT_M][NT][4], const Gemm& g, int cl,
                                          int kpt, int kc, int buf, const int (&arow)[WT_M],
                                          const bf16* bs, int mt, int nt, int wj) {
  constexpr bool STAGED = SRC == A_X || SRC == A_XS;
  const int lane = threadIdx.x & 31, ldk = kc + 8;
  const int tap = cl / kpt, k0 = (cl % kpt) * kc, kl = min(kc, g.K - k0);
  const bf16* as = STAGED ? g.stage + buf * g.xstride : g.tile;
  int acol = STAGED ? 0 : k0;
  if (SRC == A_H1) {
    const int dj = tap % 3;
    acol += ((tap / 3) * g.wc + (dj == 0 ? 0 : dj == 1 ? g.col1 : g.col2)) * g.ld;
  }
  const int ald = STAGED ? ldk : 1;  // arow is in elements for the tiles
  for (int ks = 0; ks < (mt > 0 ? kl : 0); ks += 16) {
    uint32_t a[WT_M][4];
#pragma unroll
    for (int mi = 0; mi < WT_M; ++mi)
      if (mi < mt)
        ldmatrix_x4(a[mi], smem_addr(as + arow[mi] * ald + acol + ks + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < nt) {
        uint32_t b[4];  // channels 16 np + [0, 8) and + [8, 16), depth ks + [0, 16)
        ldmatrix_x4(b, smem_addr(bs + (wj * NT * 8 + np * 16 + (lane & 7) + (lane >> 4) * 8) * ldk +
                                 ks + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mi = 0; mi < WT_M; ++mi) {
          if (mi < mt) {
            mma(acc[mi][2 * np], a[mi], b[0], b[1]);
            mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
}

// C[M, N] for the whole block: GEMM g1 (source SRC) and, when SRC2 is not
// A_NONE, a second GEMM g2 (one tap) into its own sums, both over the same
// pixels and channels. The M rows (pixels) go in sweeps of up to wm * 4 m16
// tiles, spread evenly over the wm warps along M; N goes in chunks of wn *
// NT * 8 channels, NT n8 tiles a warp. For each pass (sweep, channel
// chunk) the weights (and, for staged A, the sweep's x rows) pass through
// shared memory in k-chunks of kc by cp.async, g1's chunks then g2's, in a
// ring of STAGES buffers: chunk i + 1 is in flight while chunk i is
// computed, and one barrier a chunk both publishes chunk i and frees the
// buffer of chunk i - 1. Fragments come by ldmatrix; the sums stay in
// registers and, at the end of a pass, go to `epi(acc, [acc2,] first m
// tile, m tiles, first channel, n tiles)`.
template <int SRC, int SRC2, int NT, typename Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int wn, int kc, const Gemm& g1,
                                           const Gemm& g2, bf16* bstage, int bstride, Epi epi) {
  constexpr bool DUAL = SRC2 != A_NONE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = NWARPS / wn;
  const int wi = warp / wn, wj = warp % wn;
  const int tiles = (M + 15) / 16, per = wm * WT_M, nchunk = wn * NT * 8;
  const int kpt1 = (g1.K + kc - 1) / kc, nk1 = g1.taps * kpt1;
  const int kpt2 = DUAL ? (g2.K + kc - 1) / kc : 0, nk = nk1 + kpt2;
  const uint64_t keep = evict_last_policy();
  for (int t0 = 0; t0 < tiles; t0 += per) {
    const int ts = min(per, tiles - t0), tpw = (ts + wm - 1) / wm;
    const int mt0 = t0 + wi * tpw, mt = max(0, min(tpw, t0 + ts - mt0));
    int arow[WT_M], arow2[WT_M];  // g1's and g2's A row of the lane in each m tile
#pragma unroll
    for (int mi = 0; mi < WT_M; ++mi) {
      const int q = min((mt0 + mi) * 16 + (lane & 15), M - 1);
      const int local = (mt0 - t0 + mi) * 16 + (lane & 15);
      arow[mi] = a_row<SRC>(g1, q, local);
      if constexpr (DUAL) arow2[mi] = a_row<SRC2>(g2, q, local);
    }
    for (int n0 = 0; n0 < N; n0 += nchunk) {
      const int nrows = min(nchunk, N - n0), nw0 = n0 + wj * NT * 8;
      const int nt = max(0, min(NT, (N - nw0) / 8));
      float acc[WT_M][NT][4], acc2[WT_M][DUAL ? NT : 1][4];
      zero(acc);
      if constexpr (DUAL) zero(acc2);
      auto issue = [&](int c) {
        if (c >= nk) return;
        if constexpr (DUAL) {
          if (c >= nk1) {
            issue_chunk<SRC2>(g2, c - nk1, kpt2, kc, c % STAGES, n0, nrows, M, t0 * 16, ts * 16,
                              bstage, bstride, keep);
            return;
          }
        }
        issue_chunk<SRC>(g1, c, kpt1, kc, c % STAGES, n0, nrows, M, t0 * 16, ts * 16, bstage,
                         bstride, keep);
      };
#pragma unroll
      for (int c = 0; c < STAGES - 1; ++c) {
        issue(c);
        cp_async_commit();  // a group a chunk, empty past the end: the wait count stays fixed
      }
      for (int c = 0; c < nk; ++c) {
        cp_async_wait_ring();
        __syncthreads();  // chunk c has landed for every thread; chunk c - 1 is computed
        issue(c + STAGES - 1);
        cp_async_commit();
        const bf16* bs = bstage + (c % STAGES) * bstride;
        if constexpr (DUAL) {
          if (c >= nk1) {
            chunk_mma<SRC2, NT>(acc2, g2, c - nk1, kpt2, kc, c % STAGES, arow2, bs, mt, nt, wj);
            continue;
          }
        }
        chunk_mma<SRC, NT>(acc, g1, c, kpt1, kc, c % STAGES, arow, bs, mt, nt, wj);
      }
      __syncthreads();  // the ring is free for the next pass
      if constexpr (DUAL)
        epi(acc, acc2, mt0, mt, nw0, nt);
      else
        epi(acc, mt0, mt, nw0, nt);
    }
  }
}

// Phase 3's store of one warp's m tile, whose f32 y (16 pixel rows of up to
// NT * 8 channels) the warp has put in `est`: out = relu(y + x) with the
// identity's residual x (RES), else relu(y), as 16-byte vectors of 8
// channels a lane, streaming (first out of L2): x's last use, and y.
template <int NT, bool RES>
__device__ __forceinline__ void store_tile(const float* est, const bf16* xres, bf16* out,
                                           int ld, int q0, int np, int n0, int nt) {
  const int lane = threadIdx.x & 31, cc = lane % NT;
#pragma unroll
  for (int pass = 0; pass < NT / 2; ++pass) {
    const int row = pass * (32 / NT) + lane / NT, q = q0 + row;
    if (q >= np || cc >= nt) continue;
    const float4 y0 = *reinterpret_cast<const float4*>(est + row * EST_LD + cc * 8);
    const float4 y1 = *reinterpret_cast<const float4*>(est + row * EST_LD + cc * 8 + 4);
    float v[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
    const int64_t off = (int64_t)q * ld + n0 + cc * 8;
    if constexpr (RES) {
      const uint4 xv = __ldcs(reinterpret_cast<const uint4*>(xres + off));
      const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __low2float(xb[j]) + v[2 * j];
        v[2 * j + 1] = __high2float(xb[j]) + v[2 * j + 1];
      }
    }
    uint4 ov;
    uint32_t* o = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = pack_bf16(fmaxf(v[2 * j], 0.0f), fmaxf(v[2 * j + 1], 0.0f));
    __stcs(reinterpret_cast<uint4*>(out + off), ov);
  }
}

// One block of the bf16 kernels: image blockIdx.y, output rows [i0, i0 +
// rows), i0 = blockIdx.x * band (an image's last band may be shorter).
// S: the 3x3's stride; PROJ: the projection shortcut (the transition) in
// place of the identity's x.
template <int S, bool PROJ>
__device__ __forceinline__ void block_mma(const Params& p, unsigned char* smem) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const int hw = p.hw, ho = p.ho, cin = p.cin, cmid = p.cmid, cout = p.cout;
  const int img = blockIdx.y, i0 = blockIdx.x * p.band, rows = min(p.band, ho - i0);
  const int hr = S == 1 ? rows + 2 : 2 * rows + 1, row0 = S == 1 ? i0 - 1 : 2 * i0;
  const MmaLayout L(hw, S, cin, cmid, cout, p.band, PROJ, p.kc_rows, p.fit1);
  const int lda = L.lda, wc = L.wc;
  bf16* h1s = reinterpret_cast<bf16*>(smem);
  float* est = reinterpret_cast<float*>(smem) + warp * 16 * EST_LD;
  bf16* h2s = reinterpret_cast<bf16*>(smem + L.region1);
  bf16* bstage = reinterpret_cast<bf16*>(smem + L.region1 + L.region2);
  const bf16* x = static_cast<const bf16*>(p.x) + (int64_t)img * hw * hw * cin;
  bf16* out = static_cast<bf16*>(p.out) + ((int64_t)img * ho + i0) * ho * cout;

  {
    uint4* z = reinterpret_cast<uint4*>(h1s);
    const int n16 = hr * wc * lda / 8;
    for (int i = threadIdx.x; i < n16; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // 1. h1 = relu(x W1 s1 + b1) on the image rows [lo, hi) the taps read;
  // image column j goes to tile column j + 1 (S = 1), or j / 2 for an even
  // j and ho + 1 + j / 2 for an odd one (S = 2).
  const int lo = max(row0, 0), hi = min(row0 + hr, hw), m1 = (hi - lo) * hw;
  const Gemm g1 = x_rows(p.w1t, cin, x + (int64_t)lo * hw * cin, h2s, L.xstride);
  block_gemm<A_X, A_NONE, 8>(
      m1, cmid, L.wn1, L.kc1, g1, g1, bstage, L.bstride,
      [&](float (&acc)[WT_M][8][4], int mt0, int mt, int n0, int nt) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          if (ni >= nt) continue;
          const int c = n0 + ni * 8 + 2 * t;
          const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s1 + c));
          const float2 bi = __ldg(reinterpret_cast<const float2*>(p.b1 + c));
#pragma unroll
          for (int mi = 0; mi < WT_M; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = (mt0 + mi) * 16 + g + 8 * h;
              if (mi >= mt || r >= m1) continue;
              const int j = r % hw, col = S == 1 ? j + 1 : (j >> 1) + (j & 1) * (ho + 1);
              store2(h1s + ((size_t)(lo - row0 + r / hw) * wc + col) * lda + c,
                     fmaxf(acc[mi][ni][2 * h] * sc.x + bi.x, 0.0f),
                     fmaxf(acc[mi][ni][2 * h + 1] * sc.y + bi.y, 0.0f));
            }
        }
      });
  __syncthreads();

  // 2. h2 = relu(conv3x3_s(h1) s2 + b2) for the band: K = 9 cmid over the
  // h1 tile. Output pixel (oi, oj) reads image row oi S + di, column
  // oj S + dj: tile pixel oi S wc + oj at tap (0, 0), then + di wc +
  // {0, 1, 2}[dj] (S = 1) or {0, ho + 1, 1}[dj] (S = 2), so that at either
  // stride the 8 rows of an ldmatrix are consecutive tile pixels.
  const int np = rows * ho;
  Gemm g2 = tile_rows(p.w2t, cmid, 9, h1s, lda);
  g2.ow = ho, g2.opitch = S * wc, g2.wc = wc;
  g2.col1 = S == 1 ? 1 : ho + 1, g2.col2 = S == 1 ? 2 : 1;
  block_gemm<A_H1, A_NONE, 8>(
      np, cmid, L.wn2, L.kc2, g2, g2, bstage, L.bstride,
      [&](float (&acc)[WT_M][8][4], int mt0, int mt, int n0, int nt) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          if (ni >= nt) continue;
          const int c = n0 + ni * 8 + 2 * t;
          const float2 sc = __ldg(reinterpret_cast<const float2*>(p.s2 + c));
          const float2 bi = __ldg(reinterpret_cast<const float2*>(p.b2 + c));
#pragma unroll
          for (int mi = 0; mi < WT_M; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = (mt0 + mi) * 16 + g + 8 * h;
              if (mi >= mt || q >= np) continue;
              store2(h2s + (size_t)q * lda + c, fmaxf(acc[mi][ni][2 * h] * sc.x + bi.x, 0.0f),
                     fmaxf(acc[mi][ni][2 * h + 1] * sc.y + bi.y, 0.0f));
            }
        }
      });
  __syncthreads();

  // 3. y = h2 W3 s3 + b3, then out = relu(x + y) (identity) or relu(p + y)
  // with p = x[::S, ::S] Wp sp + bp (projection; its x pixels are staged
  // in region 1, after the f32 epilogue staging). Each m tile goes through
  // the warp's f32 staging (region 1, free now), so that the output (and
  // the residual x) move as 16-byte vectors.
  const Gemm g3 = tile_rows(p.w3t, cmid, 1, h2s, lda);
  if constexpr (PROJ) {
    // two sets of f32 sums: 64 pixels x 32 channels a warp for each
    Gemm gp = x_rows(p.wpt, cin, x + (int64_t)i0 * S * hw * cin,
                     reinterpret_cast<bf16*>(smem + EST_BYTES), L.xstride3);
    gp.ow = ho, gp.opitch = S * hw, gp.ostep = S;
    block_gemm<A_H2, A_XS, 4>(
        np, cout, L.wn3, L.kc3, g3, gp, bstage, L.bstride,
        [&](float (&acc)[WT_M][4][4], float (&accp)[WT_M][4][4], int mt0, int mt, int n0,
            int nt) {
          if (mt == 0 || nt == 0) return;
          float2 sc[4], bi[4], scp[4], bip[4];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = n0 + imin(ni, nt - 1) * 8 + 2 * t;
            sc[ni] = __ldg(reinterpret_cast<const float2*>(p.s3 + c));
            bi[ni] = __ldg(reinterpret_cast<const float2*>(p.b3 + c));
            scp[ni] = __ldg(reinterpret_cast<const float2*>(p.sp + c));
            bip[ni] = __ldg(reinterpret_cast<const float2*>(p.bp + c));
          }
#pragma unroll
          for (int mi = 0; mi < WT_M; ++mi) {
            if (mi >= mt) continue;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (ni >= nt) continue;
                const float y0 = acc[mi][ni][2 * h] * sc[ni].x + bi[ni].x;
                const float y1 = acc[mi][ni][2 * h + 1] * sc[ni].y + bi[ni].y;
                const float p0 = accp[mi][ni][2 * h] * scp[ni].x + bip[ni].x;
                const float p1 = accp[mi][ni][2 * h + 1] * scp[ni].y + bip[ni].y;
                *reinterpret_cast<float2*>(est + (g + 8 * h) * EST_LD + ni * 8 + 2 * t) =
                    make_float2(p0 + y0, p1 + y1);
              }
            __syncwarp();
            store_tile<4, false>(est, nullptr, out, cout, (mt0 + mi) * 16, np, n0, nt);
            __syncwarp();
          }
        });
  } else {
    const bf16* xres = x + (int64_t)i0 * hw * cin;
    block_gemm<A_H2, A_NONE, 8>(
        np, cout, L.wn3, L.kc3, g3, g3, bstage, L.bstride,
        [&](float (&acc)[WT_M][8][4], int mt0, int mt, int n0, int nt) {
          if (mt == 0 || nt == 0) return;
          float2 sc[8], bi[8];
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int c = n0 + imin(ni, nt - 1) * 8 + 2 * t;
            sc[ni] = __ldg(reinterpret_cast<const float2*>(p.s3 + c));
            bi[ni] = __ldg(reinterpret_cast<const float2*>(p.b3 + c));
          }
#pragma unroll
          for (int mi = 0; mi < WT_M; ++mi) {
            if (mi >= mt) continue;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (ni >= nt) continue;
                *reinterpret_cast<float2*>(est + (g + 8 * h) * EST_LD + ni * 8 + 2 * t) =
                    make_float2(acc[mi][ni][2 * h] * sc[ni].x + bi[ni].x,
                                acc[mi][ni][2 * h + 1] * sc[ni].y + bi[ni].y);
              }
            __syncwarp();
            store_tile<8, true>(est, xres, out, cout, (mt0 + mi) * 16, np, n0, nt);
            __syncwarp();
          }
        });
  }
}

__global__ void __launch_bounds__(THREADS, 1) fused_bottleneck_kernel_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_mma<1, false>(p, smem);
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) fused_transition_kernel_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_mma<S, true>(p, smem);
}

int launch_mma(Params p, int stride, bool proj, int n, cudaStream_t stream) {
  mma_choices(p, stride, proj);
  const size_t smem =
      MmaLayout(p.hw, stride, p.cin, p.cmid, p.cout, p.band, proj, p.kc_rows, p.fit1).bytes();
  void (*kernel)(Params) = !proj ? fused_bottleneck_kernel_mma
                           : stride == 1 ? fused_transition_kernel_mma<1>
                                         : fused_transition_kernel_mma<2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.ho + p.band - 1) / p.band, n), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device, x, w1t, s1, b1, w2t, s2, b2, w3t, s3, b3, out, is_bf16, n, hw, cin,
// cmid, band, stream
int fused_bottleneck(int device, const void* x, const void* w1t, const float* s1,
                     const float* b1, const void* w2t, const float* s2, const float* b2,
                     const void* w3t, const float* s3, const float* b3, void* out, int is_bf16,
                     int n, int hw, int cin, int cmid, int band, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p{x, static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t),
           static_cast<const bf16*>(w3t), nullptr, s1, b1, s2, b2, s3, b3, nullptr,
           nullptr, out, hw, hw, cin, cmid, cin, band};
  if (!valid(p, n, 1)) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_mma(p, 1, false, n, stream)
                 : launch(fused_bottleneck_kernel<float>, p, 1, n, stream);
}

// as fused_bottleneck, with wpt, sp, bp after b3 and cout, stride before band
int fused_transition(int device, const void* x, const void* w1t, const float* s1,
                     const float* b1, const void* w2t, const float* s2, const float* b2,
                     const void* w3t, const float* s3, const float* b3, const void* wpt,
                     const float* sp, const float* bp, void* out, int is_bf16, int n, int hw,
                     int cin, int cmid, int cout, int stride, int band, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p{x, static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t),
           static_cast<const bf16*>(w3t), static_cast<const bf16*>(wpt), s1, b1, s2, b2, s3,
           b3, sp, bp, out, hw, stride == 2 ? hw / 2 : hw, cin, cmid, cout, band};
  if (!valid(p, n, stride)) return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch_mma(p, stride, true, n, stream);
  return stride == 1 ? launch(fused_transition_kernel<float, 1>, p, 1, n, stream)
                     : launch(fused_transition_kernel<float, 2>, p, 2, n, stream);
}

}  // extern "C"
