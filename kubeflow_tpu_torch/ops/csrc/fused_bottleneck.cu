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
// Design. The Pallas kernel keeps one whole image in VMEM per grid step; at
// stage 1 that is 1.6 MB of x and 400 KB of h1, far beyond the 227 KB of
// shared memory a block has here. So each block owns one (image, band of
// output rows; an image's last band may be shorter) and:
//   1. zeroes h1's tile and computes h1 for the rows the band's 3x3 taps
//      read (the band and a halo row on each side at stride 1, rows
//      2 i0 .. 2 i0 + 2 band at stride 2), x read from global memory;
//   2. computes h2 for the band as 9 tap dots over the h1 tile (implicit
//      GEMM, K = 9 cmid);
//   3. computes the expand (and the projection from x) and the f32
//      epilogue, and writes y.
// h1 and h2 live in shared memory as bf16, each pixel row padded by 8 values
// so that the 8 rows of an mma fragment fall in distinct banks. Weights are
// read from global memory through L1/L2 (stage 4's w2 alone is 4.7 MB).
// Each warp owns 32 pixels x 64 output channels (32 for the transition's
// expand, which keeps two accumulators) of a phase at a time, with f32
// accumulators in registers (128 a thread, so two 256-thread blocks share
// an SM). The wrapper picks the band per shape (ops/fused_bottleneck.py
// `plan_band`: 6 rows at stride 1 except 4 at 7 x 7, 2 at stride 2); the
// shared memory (83-113 KB at ResNet-50's shapes) is dynamic and set per
// launch with cudaFuncSetAttribute, and a refused launch comes back as the
// return value.
// Each output element is written by one thread after a fixed-order sum: the
// same inputs give the same bits on every run.
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
// What the design does about it: x and y cross device memory once each and
// h1/h2 never do (the bytes bound at stage 1), and the dots run on the
// tensor cores (the operations bound at stages 3-4). What it does not do
// yet: the operands are loaded straight into registers, without a
// cp.async/TMA pipeline or a shared-memory stage for the weights, so the
// mma units wait on loads (unrolling the k loop to overlap them took
// 159-234 registers, one block per SM, and ran 1.4-1.8x slower on the
// card); and the halo rows of h1 are recomputed by both neighbouring bands.
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

__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
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
  return is_bf16 ? launch(fused_bottleneck_kernel<bf16>, p, 1, n, stream)
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
  if (stride == 1)
    return is_bf16 ? launch(fused_transition_kernel<bf16, 1>, p, 1, n, stream)
                   : launch(fused_transition_kernel<float, 1>, p, 1, n, stream);
  return is_bf16 ? launch(fused_transition_kernel<bf16, 2>, p, 2, n, stream)
                 : launch(fused_transition_kernel<float, 2>, p, 2, n, stream);
}

}  // extern "C"
