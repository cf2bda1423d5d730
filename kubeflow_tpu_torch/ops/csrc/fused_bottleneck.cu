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
// bf16 identity block: `fused_bottleneck_kernel_mma`. The Pallas
// kernel keeps one whole image in VMEM per grid step; at stage 1 that is
// 1.6 MB of x, far beyond the 227 KB of shared memory a block has here. So
// each block owns one (image, band of output rows; an image's last band may
// be shorter) and runs three phases, each a block-wide GEMM (`block_gemm`):
//   1. h1 = relu(x W1 s1 + b1) for the rows the band's 3x3 taps read (the
//      band and a halo row on each side), into a zeroed bf16 tile with a
//      one-pixel border: SAME (1, 1) padding stays in the tile;
//   2. h2 = relu(conv3x3(h1) s2 + b2) for the band, an implicit GEMM of K =
//      9 cmid: each A fragment comes from the h1 tile by ldmatrix, whose 8
//      per-lane row addresses are the 8 pixels' positions at the tap's
//      offset, so no im2col copy is made;
//   3. y = relu(x + h2 W3 s3 + b3) for the band.
// What goes through shared memory: the weights always, and phase 1's x
// rows, in k-chunks staged by 16-byte cp.async in a ring of two buffers
// (chunk i + 1 in flight while chunk i is computed), shared by all 8 warps;
// h1 and h2 stay there as bf16. Every fragment comes by ldmatrix and every
// dot runs as mma.sync m16n8k16 bf16 -> f32. Tile: each warp holds 64
// pixels (4 m16 tiles) x 64 channels of f32 sums, so each B fragment feeds
// 4 mma and each A fragment 8; the 8 warps stand 8 / wn along M and wn
// along N, wn the largest power of two up to 8 whose 64-channel slices N
// fills (`warps_n`). A block's pixels go in sweeps of up to 8 / wn * 64
// pixels and its channels in chunks of wn * 64, and each (sweep, chunk)
// pass streams its weights once. A chunk of at most 256 weight rows is 64
// deep (a whole 128-byte line of each row), else 32 (`chunk_depth`), so a
// ring stage stays near 40 KB. Weight copies carry an L2 evict_last hint;
// the residual read and the output store are streaming (evict first). Rows
// in shared memory are padded by 8 bf16 values, so the 8 rows of an
// ldmatrix fall in 8 bank groups.
//   Band (ops/fused_bottleneck.py `plan_band_mma`, the fastest of a model
//   of staged bytes and mma per chunk among the bands that fit): 7 output
//   rows at hw 56, 28 and 7, 8 at 14; 217-231 KB of dynamic shared memory,
//   one block (8 warps) an SM. Wider bands read the weights for more
//   pixels and recompute fewer halo rows: on the H100 each band step down
//   cost more than the tile or pipeline changes tried gained (PERF.md).
//   ptxas -v: 255 registers a thread, no spill.
//   The epilogue of phase 3 goes through a per-warp f32 staging tile (in
//   h1's region, free by then), so that the residual x is read and y
//   written as 16-byte vectors, 8 channels a lane.
//
// f32 x (the identity block) and fused_transition (bf16 and f32) keep the
// register-load design (`block_body`): one block per (image, band), h1 and
// h2 in shared memory as above, but the weights and phase 1's x are loaded
// straight from global memory into registers, two 4-byte loads a lane per
// k-step, 32 pixels x 64 channels a warp item; at stride 2 the h1 tile
// holds rows 2 i0 .. 2 i0 + 2 band and the projection reads x[::2, ::2].
// The wrapper picks its band (`plan_band`: 6 rows at stride 1 except 4 at
// 7 x 7, 2 at stride 2; 83-113 KB, two blocks an SM).
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
// cores (the operations bound at stages 3-4). What bounds the mma kernel
// instead: the weights, re-read from L2 by every block (8.9 MB per 49-pixel
// block at 7 x 7), and the halo rows of h1, recomputed by both neighbouring
// bands. The register-load kernels' mma units wait on their loads.
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

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
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
// bf16 identity block: operands staged in shared memory (fused_bottleneck_kernel_mma)
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;        // k-chunks in the ring: one in flight while one is used
constexpr int KC_ROWS = 256;     // a chunk of at most this many rows is 64 deep, else 32
constexpr int WT_M = 4;          // m16 tiles a warp holds: 64 pixels
constexpr int WT_N = 8;          // n8 tiles a warp holds: 64 channels
constexpr int EST_LD = 64 + 4;   // f32 row of a warp's epilogue staging
constexpr int EST_BYTES = NWARPS * 16 * EST_LD * 4;

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

// Warps along N for a phase of N output channels: the largest power of two
// up to 8 whose 64-channel slices N fills; the other warps go along M.
// ops/fused_bottleneck.py `_warps_n` is the same rule.
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ int warps_n(int n) {
  int w = 1;
  while (w * 2 <= NWARPS && w * 2 * 64 <= n) w *= 2;
  return w;
}
// Weight rows of a phase's staged chunk, and the chunk's depth: 64 (a whole
// 128-byte line of each weight row) for up to KC_ROWS rows, else 32, so that
// a stage stays near 40 KB.
__host__ __device__ __forceinline__ int chunk_rows(int n) { return imin(n, warps_n(n) * 64); }
__host__ __device__ __forceinline__ int chunk_depth(int rows) { return rows <= KC_ROWS ? 64 : 32; }

// Shared memory of one block, in three regions (ops/fused_bottleneck.py
// `smem_bytes_mma` is the same sum): [h1 tile | f32 epilogue staging]
// [h2 | phase 1's ring of x chunks] [the ring of weight chunks]. A chunk's
// rows are padded by 8 values (16 bytes), so the 8 rows of an ldmatrix fall
// in 8 bank groups. kc1..kc3: the phases' chunk depths; xstride, bstride:
// the elements of one stage of each ring.
struct MmaLayout {
  int lda, wc, xrows, kc1, kc2, kc3, xstride, bstride;
  size_t region1, region2, region3;
  __host__ __device__ MmaLayout(int hw, int cmid, int cout, int band) {
    lda = cmid + PAD;
    wc = hw + 2;
    const int tiles1 = (imin(band + 2, hw) * hw + 15) / 16;
    xrows = imin(NWARPS / warps_n(cmid) * WT_M, tiles1) * 16;
    const int r1 = chunk_rows(cmid), r3 = chunk_rows(cout);
    kc1 = chunk_depth(imax(r1, xrows));
    kc2 = chunk_depth(r1);
    kc3 = chunk_depth(r3);
    xstride = xrows * (kc1 + 8);
    bstride = imax(r1 * (kc1 + 8), imax(r1 * (kc2 + 8), r3 * (kc3 + 8)));
    const size_t h1 = (size_t)(band + 2) * wc * lda * 2, h2 = (size_t)band * hw * lda * 2;
    region1 = h1 > (size_t)EST_BYTES ? h1 : (size_t)EST_BYTES;
    const size_t xs = (size_t)STAGES * xstride * 2;
    region2 = h2 > xs ? h2 : xs;
    region3 = (size_t)STAGES * bstride * 2;
  }
  __host__ __device__ size_t bytes() const { return region1 + region2 + region3; }
};

// A operand sources of the three phases.
enum ASource { A_X = 0, A_H1 = 1, A_H2 = 2 };

// C[M, N] = sum over taps and k of A[m, tap, k] W[n, tap * K + k], for the
// whole block. The M rows (pixels) go in sweeps of up to wm * 4 m16 tiles,
// spread evenly over the wm warps along M; N goes in chunks of wn * 64
// channels, 64 a warp. For each pass (sweep, channel chunk) the weights
// (and, for A_X, the sweep's x rows) pass through shared memory in k-chunks
// of kc by cp.async, in a ring of STAGES buffers: chunk i + 1 is in flight
// while chunk i is computed, and one barrier a chunk both publishes chunk i
// and frees the buffer of chunk i - 1. Fragments come by ldmatrix; the sums
// stay in registers and, at the end of a pass, go to `epi(acc, first m
// tile, m tiles, first channel, n tiles)`.
template <int SRC, typename Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K, int taps, int kc,
                                           const bf16* __restrict__ w, const bf16* a_glob,
                                           const bf16* a_smem, bf16* xstage, bf16* bstage,
                                           int a_ld, int hw, int wc, int xstride, int bstride,
                                           Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warps_n(N), wm = NWARPS / wn;
  const int wi = warp / wn, wj = warp % wn;
  const int tiles = (M + 15) / 16, per = wm * WT_M, nchunk = wn * 64;
  const int kpt = (K + kc - 1) / kc, nk = taps * kpt, ldw = taps * K;
  const int ldk = kc + 8, shift = kc == 64 ? 3 : 2;  // 16-byte pieces a row: 1 << shift
  // thread i copies 16 bytes (column (i % pieces) * 8 of the chunk) of rows
  // i / pieces, i / pieces + THREADS / pieces, ...; columns past a short
  // last chunk are skipped
  const int cr = threadIdx.x >> shift, cc = (threadIdx.x & ((1 << shift) - 1)) * 8;
  const uint64_t keep = evict_last_policy();
  for (int t0 = 0; t0 < tiles; t0 += per) {
    const int ts = min(per, tiles - t0), tpw = (ts + wm - 1) / wm;
    const int mt0 = t0 + wi * tpw, mt = max(0, min(tpw, t0 + ts - mt0));
    // the lane's A row of each m tile: a staged row (A_X), or the h1 tile
    // position of its pixel at tap (0, 0) (A_H1), or its h2 row (A_H2)
    int arow[WT_M];
#pragma unroll
    for (int mi = 0; mi < WT_M; ++mi) {
      const int q = min((mt0 + mi) * 16 + (lane & 15), M - 1);
      arow[mi] = SRC == A_X    ? (mt0 - t0 + mi) * 16 + (lane & 15)
                 : SRC == A_H1 ? ((q / hw) * wc + q % hw) * a_ld
                               : q * a_ld;
    }
    for (int n0 = 0; n0 < N; n0 += nchunk) {
      const int nrows = min(nchunk, N - n0), nw0 = n0 + wj * 64;
      const int nt = max(0, min(WT_N, (N - nw0) / 8));
      float acc[WT_M][WT_N][4];
#pragma unroll
      for (int mi = 0; mi < WT_M; ++mi)
#pragma unroll
        for (int ni = 0; ni < WT_N; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
      auto issue = [&](int c) {
        if (c >= nk) return;
        const int tap = c / kpt, k0 = (c % kpt) * kc, buf = c % STAGES;
        if (cc >= K - k0) return;
        bf16* bs = bstage + buf * bstride + cc;
        const bf16* src = w + (int64_t)n0 * ldw + tap * K + k0 + cc;
        for (int r = cr; r < nrows; r += THREADS >> shift)
          cp_async16_keep(smem_addr(bs + r * ldk), src + (int64_t)r * ldw, keep);
        if constexpr (SRC == A_X) {
          bf16* xs = xstage + buf * xstride + cc;
          const bf16* xsrc = a_glob + k0 + cc;
          for (int r = cr; r < ts * 16; r += THREADS >> shift) {
            const int m = t0 * 16 + r;
            cp_async16(smem_addr(xs + r * ldk), xsrc + (int64_t)(m < M ? m : 0) * K,
                       m < M ? 16 : 0);
          }
        }
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
        const int tap = c / kpt, k0 = (c % kpt) * kc, kl = min(kc, K - k0);
        const bf16* bs = bstage + (c % STAGES) * bstride;
        const bf16* as = SRC == A_X ? xstage + (c % STAGES) * xstride : a_smem;
        const int acol = SRC == A_X    ? 0
                         : SRC == A_H1 ? ((tap / 3) * wc + tap % 3) * a_ld + k0
                                       : k0;
        const int ald = SRC == A_X ? ldk : 1;  // arow is in elements for h1/h2
        for (int ks = 0; ks < (mt > 0 ? kl : 0); ks += 16) {
          uint32_t a[WT_M][4];
#pragma unroll
          for (int mi = 0; mi < WT_M; ++mi)
            if (mi < mt)
              ldmatrix_x4(a[mi], smem_addr(as + arow[mi] * ald + acol + ks + (lane >> 4) * 8));
#pragma unroll
          for (int np = 0; np < WT_N / 2; ++np) {
            if (2 * np < nt) {
              uint32_t b[4];  // channels 16 np + [0, 8) and + [8, 16), depth ks + [0, 16)
              ldmatrix_x4(b, smem_addr(bs + (wj * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8) * ldk +
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
      __syncthreads();  // the ring is free for the next pass
      epi(acc, mt0, mt, nw0, nt);
    }
  }
}

// One block: image blockIdx.y, output rows [i0, i0 + rows), i0 = blockIdx.x * band.
__global__ void __launch_bounds__(THREADS, 1) fused_bottleneck_kernel_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const int hw = p.hw, cin = p.cin, cmid = p.cmid, img = blockIdx.y, i0 = blockIdx.x * p.band;
  const int rows = min(p.band, hw - i0), hr = rows + 2, row0 = i0 - 1;
  const MmaLayout L(hw, cmid, p.cout, p.band);
  const int lda = L.lda, wc = L.wc;
  bf16* h1s = reinterpret_cast<bf16*>(smem);
  float* est = reinterpret_cast<float*>(smem) + warp * 16 * EST_LD;
  bf16* h2s = reinterpret_cast<bf16*>(smem + L.region1);
  bf16* xstage = h2s;
  bf16* bstage = reinterpret_cast<bf16*>(smem + L.region1 + L.region2);
  const bf16* x = static_cast<const bf16*>(p.x) + (int64_t)img * hw * hw * cin;
  bf16* out = static_cast<bf16*>(p.out) + ((int64_t)img * hw + i0) * hw * cin;

  {
    uint4* z = reinterpret_cast<uint4*>(h1s);
    const int n16 = hr * wc * lda / 8;
    for (int i = threadIdx.x; i < n16; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // 1. h1 = relu(x W1 s1 + b1) on the image rows [lo, hi) the taps read.
  const int lo = max(row0, 0), hi = min(row0 + hr, hw), m1 = (hi - lo) * hw;
  block_gemm<A_X>(m1, cmid, cin, 1, L.kc1, p.w1t, x + (int64_t)lo * hw * cin, nullptr, xstage,
                  bstage, 0, hw, wc, L.xstride, L.bstride,
                  [&](float (&acc)[WT_M][WT_N][4], int mt0, int mt, int n0, int nt) {
#pragma unroll
                    for (int ni = 0; ni < WT_N; ++ni) {
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
                          store2(h1s + ((size_t)(lo - row0 + r / hw) * wc + r % hw + 1) * lda + c,
                                 fmaxf(acc[mi][ni][2 * h] * sc.x + bi.x, 0.0f),
                                 fmaxf(acc[mi][ni][2 * h + 1] * sc.y + bi.y, 0.0f));
                        }
                    }
                  });
  __syncthreads();

  // 2. h2 = relu(conv3x3(h1) s2 + b2) for the band: K = 9 cmid over the h1 tile.
  const int np = rows * hw;
  block_gemm<A_H1>(np, cmid, cmid, 9, L.kc2, p.w2t, nullptr, h1s, nullptr, bstage, lda, hw, wc,
                   L.xstride, L.bstride,
                   [&](float (&acc)[WT_M][WT_N][4], int mt0, int mt, int n0, int nt) {
#pragma unroll
                     for (int ni = 0; ni < WT_N; ++ni) {
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

  // 3. y = relu(x + h2 W3 s3 + b3). Each m tile's y goes through the warp's
  // f32 staging (the h1 region, free now), so that x is read and y written
  // in 16-byte vectors: 8 channels a lane, 4 rows a pass.
  const bf16* xres = x + (int64_t)i0 * hw * cin;
  block_gemm<A_H2>(np, p.cout, cmid, 1, L.kc3, p.w3t, nullptr, h2s, nullptr, bstage, lda, hw,
                   wc, L.xstride, L.bstride,
                   [&](float (&acc)[WT_M][WT_N][4], int mt0, int mt, int n0, int nt) {
                     if (mt == 0 || nt == 0) return;
                     float2 sc[WT_N], bi[WT_N];
#pragma unroll
                     for (int ni = 0; ni < WT_N; ++ni) {
                       const int c = n0 + imin(ni, imax(nt - 1, 0)) * 8 + 2 * t;
                       sc[ni] = __ldg(reinterpret_cast<const float2*>(p.s3 + c));
                       bi[ni] = __ldg(reinterpret_cast<const float2*>(p.b3 + c));
                     }
#pragma unroll
                     for (int mi = 0; mi < WT_M; ++mi) {
                       if (mi >= mt) continue;
#pragma unroll
                       for (int ni = 0; ni < WT_N; ++ni)
#pragma unroll
                         for (int h = 0; h < 2; ++h) {
                           if (ni >= nt) continue;
                           *reinterpret_cast<float2*>(est + (g + 8 * h) * EST_LD + ni * 8 + 2 * t) =
                               make_float2(acc[mi][ni][2 * h] * sc[ni].x + bi[ni].x,
                                           acc[mi][ni][2 * h + 1] * sc[ni].y + bi[ni].y);
                         }
                       __syncwarp();
                       const int cc = lane & 7;
#pragma unroll
                       for (int pass = 0; pass < 4; ++pass) {
                         const int row = pass * 4 + (lane >> 3), q = (mt0 + mi) * 16 + row;
                         if (q >= np || cc >= nt) continue;
                         const float4 y0 = *reinterpret_cast<const float4*>(est + row * EST_LD + cc * 8);
                         const float4 y1 = *reinterpret_cast<const float4*>(est + row * EST_LD + cc * 8 + 4);
                         const int64_t off = (int64_t)q * cin + n0 + cc * 8;
                         // x's last use and y: streaming, first out of L2
                         const uint4 xv = __ldcs(reinterpret_cast<const uint4*>(xres + off));
                         const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&xv);
                         const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
                         uint4 ov;
                         uint32_t* o = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
                         for (int j = 0; j < 4; ++j)
                           o[j] = pack_bf16(fmaxf(__low2float(xb[j]) + yv[2 * j], 0.0f),
                                            fmaxf(__high2float(xb[j]) + yv[2 * j + 1], 0.0f));
                         __stcs(reinterpret_cast<uint4*>(out + off), ov);
                       }
                       __syncwarp();
                     }
                   });
}

int launch_mma(const Params& p, int n, cudaStream_t stream) {
  const size_t smem = MmaLayout(p.hw, p.cmid, p.cout, p.band).bytes();
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel_mma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_bottleneck_kernel_mma<<<dim3((p.ho + p.band - 1) / p.band, n), THREADS, smem, stream>>>(p);
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
  return is_bf16 ? launch_mma(p, n, stream) : launch(fused_bottleneck_kernel<float>, p, 1, n, stream);
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
  if (stride == 1)
    return is_bf16 ? launch(fused_transition_kernel<bf16, 1>, p, 1, n, stream)
                   : launch(fused_transition_kernel<float, 1>, p, 1, n, stream);
  return is_bf16 ? launch(fused_transition_kernel<bf16, 2>, p, 2, n, stream)
                 : launch(fused_transition_kernel<float, 2>, p, 2, n, stream);
}

}  // extern "C"
