// K3: one NaiveV2Diff denoiser layer (conv-only conformer, no norm).
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_conformer.py
// (fused_conformer_layer -> _fused_layer_impl -> _layer_kernel), f32 mode:
//   h   = x + step_vec + cond . Wc^T + bc
//   u   = GLU(h . W1^T + b1)                (a * sigmoid(g), halves of 2I)
//   v   = depthwise_k(u) + bd               (zero rows outside [0, T))
//   out = x + silu(v) . W2^T + b2
// with weights in the torch layout (1x1 convs squeezed to (out, in), the
// depthwise weight (I, k)).
//
// Bound on the H100: operations. At the 10 s request (T = 862, C = 512,
// Hc = 128, I = 1024, k = 31) a layer does 2.9 GFLOP on ~11 MB (weights
// dominate), ~260 flop/byte, above the ridge. At f32 accuracy the GEMMs run
// on the tensor cores in split TF32 (mma_tf32x3.cuh: three MMAs per
// product, a ceiling of 494.7 / 3 TFLOP/s), which puts the layer's bound
// near 0.017 ms; the depthwise conv's 0.05 GFLOP stays on the FMA pipe.
//
// Design: one tensor-core GEMM kernel, launched three times with a fused
// epilogue each -- the first adds x, the step vector and the bias; the
// second owns output column j and column j + I of W1 together and applies
// the GLU; the third adds the bias and the residual -- and between the
// second and third a depthwise k-tap conv with bias and SiLU. What holds a
// GEMM of M = 862 rows back is filling 132 SMs, not its arithmetic: a block
// of four warps owns 64 rows x 32 output columns (a warp 32 x 16, and the
// matching 16 gate columns in the GLU), so the three GEMMs launch 224, 448
// and 224 blocks. A and W tiles of 32-deep k-steps go through a two-stage
// cp.async ring (zero fill past M, N and K) into rows padded to 36 floats,
// from which one ldmatrix.x4 loads an A fragment, or the W fragments of a
// warp's two n8 tiles, free of bank conflicts; the fragments are split into
// hi/lo TF32 in registers. The depthwise conv stages 64 rows and their
// halo of 64 channels in shared memory and keeps each channel's taps in
// registers. No library GEMM is called. wgmma and TMA are later work.
// Backward (training) stays the stock f32 chain, for B3 as for K3.
//
// B3 (ddsp_conformer_layer_bf16) is the same kernel pipeline in JAX's
// mxu_bf16 class (pallas_conformer.py:125-150, the casts at :73-98 and
// :196-202): the three GEMMs' operands rounded to bf16, f32 sums, every
// other value f32. At one bf16 MMA per product its tensor-core ceiling is
// the dense bf16 rate (989.4 TFLOP/s), six times split TF32's ceiling.
#include <cuda_bf16.h>

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int kStride = BK + 4;  // 144-byte rows: 16-byte copies, no conflicts
constexpr int kThreads = 128;
constexpr int MT = 2;  // m16 fragments per warp (32 rows)
constexpr int NT = 2;  // n8 fragments per warp (16 columns): one ldmatrix

enum Mode { kCond = 0, kGlu = 1, kResidual = 2 };

// The three fused epilogues, shared by the split-TF32 and the bf16 GEMM:
// writes the warp's MT x NT fragments (rows from m_base, columns from
// n_base) of acc[h][mt][nt] in the m16n8 C layout. kCond adds x, the step
// vector and the bias; kGlu takes acc[1] as the gate half; kResidual adds
// the bias and x.
template <int MODE, int H>
__device__ __forceinline__ void store_tile(
    const float (&acc)[H][MT][NT][4], const float* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ step,
    float* __restrict__ out, int m_base, int n_base, int g, int q, int m_rows,
    int n_out, int rows_per_batch) {
  constexpr int kHalves = H;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_base + mt * 16 + g + 8 * half;
      if (m >= m_rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n_base + nt * 8 + 2 * q;
        if (n >= n_out) continue;
        const size_t o = (size_t)m * n_out + n;
        const float c0 = acc[0][mt][nt][2 * half];
        const float c1 = acc[0][mt][nt][2 * half + 1];
        float2 y;
        if constexpr (MODE == kCond) {
          const float2 xv = *reinterpret_cast<const float2*>(x + o);
          const float* sv = step + (size_t)(m / rows_per_batch) * n_out + n;
          y = make_float2(xv.x + sv[0] + c0 + bias[n],
                          xv.y + sv[1] + c1 + bias[n + 1]);
        } else if constexpr (MODE == kGlu) {
          const float g0 = acc[kHalves - 1][mt][nt][2 * half] + bias[n + n_out];
          const float g1 =
              acc[kHalves - 1][mt][nt][2 * half + 1] + bias[n + 1 + n_out];
          y = make_float2((c0 + bias[n]) * ddsp_sigmoid(g0),
                          (c1 + bias[n + 1]) * ddsp_sigmoid(g1));
        } else {
          const float2 xv = *reinterpret_cast<const float2*>(x + o);
          y = make_float2(xv.x + c0 + bias[n], xv.y + c1 + bias[n + 1]);
        }
        *reinterpret_cast<float2*>(out + o) = y;
      }
    }
  }
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T); for kGlu, W has 2N rows and the
// tile also accumulates W rows n + N (the gate half). K is a multiple of 4.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_tc_kernel(const float* __restrict__ a, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ x,
               const float* __restrict__ step, float* __restrict__ out,
               int m_rows, int n_out, int k_dim, int rows_per_batch) {
  constexpr int kHalves = MODE == kGlu ? 2 : 1;
  constexpr int WR = kHalves * BN;  // staged W rows
  __shared__ __align__(16) float a_s[2][BM * kStride];
  __shared__ __align__(16) float w_s[2][WR * kStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // this thread's copies: rows tid / 8 + 16 j of each tile, words
  // 4 * (tid % 8) of each k-step; the sources are set up once and step by BK
  constexpr int kVec = BK / 4;
  constexpr int kRowStep = kThreads / kVec;
  const int r0 = tid / kVec;
  const int c4 = 4 * (tid % kVec);
  const float* a_src[BM / kRowStep];
  bool a_ok[BM / kRowStep];
#pragma unroll
  for (int j = 0; j < BM / kRowStep; ++j) {
    const int m = m0 + r0 + kRowStep * j;
    a_ok[j] = m < m_rows;
    a_src[j] = a + (size_t)(a_ok[j] ? m : 0) * k_dim + c4;
  }
  const float* w_src[WR / kRowStep];
  bool w_ok[WR / kRowStep];
#pragma unroll
  for (int j = 0; j < WR / kRowStep; ++j) {
    const int r = r0 + kRowStep * j;  // value rows, then gate rows
    const int n = n0 + r % BN;
    w_ok[j] = n < n_out;
    w_src[j] = w + ((size_t)(w_ok[j] ? n : 0) + (r / BN) * (size_t)n_out) *
                       k_dim + c4;
  }
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const bool k_ok = k0 + c4 < k_dim;
#pragma unroll
    for (int j = 0; j < BM / kRowStep; ++j)
      cp_async16(&a_s[buf][(r0 + kRowStep * j) * kStride + c4],
                 a_ok[j] && k_ok ? a_src[j] + k0 : a, a_ok[j] && k_ok);
#pragma unroll
    for (int j = 0; j < WR / kRowStep; ++j)
      cp_async16(&w_s[buf][(r0 + kRowStep * j) * kStride + c4],
                 w_ok[j] && k_ok ? w_src[j] + k0 : w, w_ok[j] && k_ok);
  };

  float acc[kHalves][MT][NT][4];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][mt][nt][i] = 0.0f;

  // ldmatrix row addresses: A quarter j = lane / 8 is rows + 8 * (j & 1),
  // words 4 * (j >> 1); W (n-major) matrix j is rows + 8 * (j >> 1), words
  // 4 * (j & 1), which covers the warp's NT = 2 n8 tiles
  const int a_row = warp_m * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  const int b_row = warp_n * NT * 8 + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 4;

  const int n_k = (k_dim + BK - 1) / BK;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      stage(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t r[4];
        ldmatrix_x4(r, &a_s[kt & 1][(a_row + mt * 16) * kStride + ks + a_col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(r[i], a_hi[mt][i], a_lo[mt][i]);
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        uint32_t r[4], b_hi[NT][2], b_lo[NT][2];
        ldmatrix_x4(r, &w_s[kt & 1][(h * BN + b_row) * kStride + ks + b_col]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(r[i], b_hi[i >> 1][i & 1], b_lo[i >> 1][i & 1]);
        mma_tf32x3_grid(acc[h], a_hi, a_lo, b_hi, b_lo);
      }
    }
    __syncthreads();
  }

  store_tile<MODE>(acc, bias, x, step, out, m0 + warp_m * MT * 16,
                   n0 + warp_n * NT * 8, g, q, m_rows, n_out, rows_per_batch);
}

// B3, K3's bf16 class: the same GEMM with its operands rounded to bf16
// (round to nearest even, as astype(bfloat16)) and f32 accumulation, one
// mma.sync m16n8k16 bf16 per product where the kernel above takes three
// split-TF32 MMAs. W arrives rounded to bf16 once per model ((N, K) rows, K
// a multiple of 8); A (cond, h or s, f32 in device memory) is staged in f32
// as above and rounded to bf16 pairs as its fragments are loaded. The
// epilogues are the f32 ones.
constexpr int kWStride = BK + 8;  // bf16: 80-byte rows, conflict-free words

__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// m16n8k16, bf16 inputs, f32 accumulators. A (16 x 16): a0 (g, 2q..2q+1),
// a1 (g + 8, 2q..), a2 (g, 2q + 8..), a3 (g + 8, 2q + 8..); B (16 x 8,
// n-major): b0 (k = 2q..2q+1, n = g), b1 (k = 2q + 8.., n = g); C as m16n8k8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const float* __restrict__ a,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ x,
                 const float* __restrict__ step, float* __restrict__ out,
                 int m_rows, int n_out, int k_dim, int rows_per_batch) {
  constexpr int kHalves = MODE == kGlu ? 2 : 1;
  constexpr int WR = kHalves * BN;  // staged W rows
  __shared__ __align__(16) float a_s[2][BM * kStride];
  __shared__ __align__(16) __nv_bfloat16 w_s[2][WR * kWStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A copies as the f32 kernel's: rows tid / 8 + 16 j, words 4 * (tid % 8);
  // W copies: 16-byte runs of 8 bf16, rows tid / 4 + 32 j, 8 * (tid % 4)
  constexpr int kVec = BK / 4;
  constexpr int kRowStep = kThreads / kVec;
  const int r0 = tid / kVec;
  const int c4 = 4 * (tid % kVec);
  const float* a_src[BM / kRowStep];
  bool a_ok[BM / kRowStep];
#pragma unroll
  for (int j = 0; j < BM / kRowStep; ++j) {
    const int m = m0 + r0 + kRowStep * j;
    a_ok[j] = m < m_rows;
    a_src[j] = a + (size_t)(a_ok[j] ? m : 0) * k_dim + c4;
  }
  constexpr int kWVec = BK / 8;
  constexpr int kWRowStep = kThreads / kWVec;
  const int wr0 = tid / kWVec;
  const int c8 = 8 * (tid % kWVec);
  const __nv_bfloat16* w_src[WR / kWRowStep];
  bool w_ok[WR / kWRowStep];
#pragma unroll
  for (int j = 0; j < WR / kWRowStep; ++j) {
    const int r = wr0 + kWRowStep * j;  // value rows, then gate rows
    const int n = n0 + r % BN;
    w_ok[j] = n < n_out;
    w_src[j] = w + ((size_t)(w_ok[j] ? n : 0) + (r / BN) * (size_t)n_out) *
                       k_dim + c8;
  }
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const bool ka = k0 + c4 < k_dim;
    const bool kw = k0 + c8 < k_dim;
#pragma unroll
    for (int j = 0; j < BM / kRowStep; ++j)
      cp_async16(&a_s[buf][(r0 + kRowStep * j) * kStride + c4],
                 a_ok[j] && ka ? a_src[j] + k0 : a, a_ok[j] && ka);
#pragma unroll
    for (int j = 0; j < WR / kWRowStep; ++j)
      cp_async16(&w_s[buf][(wr0 + kWRowStep * j) * kWStride + c8],
                 w_ok[j] && kw ? w_src[j] + k0 : w, w_ok[j] && kw);
  };

  float acc[kHalves][MT][NT][4];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][mt][nt][i] = 0.0f;

  const int n_k = (k_dim + BK - 1) / BK;
  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      stage(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = a_s[kt & 1];
    const __nv_bfloat16* ws = w_s[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = as + (warp_m * MT * 16 + mt * 16 + g) * kStride + ks + 2 * q;
        const float2 v0 = *reinterpret_cast<const float2*>(p);
        const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kStride);
        const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * kStride + 8);
        af[mt][0] = bf16x2_rn(v0.x, v0.y);
        af[mt][1] = bf16x2_rn(v1.x, v1.y);
        af[mt][2] = bf16x2_rn(v2.x, v2.y);
        af[mt][3] = bf16x2_rn(v3.x, v3.y);
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* p =
              ws + (h * BN + warp_n * NT * 8 + nt * 8 + g) * kWStride + ks + 2 * q;
          const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(p),
                                  *reinterpret_cast<const uint32_t*>(p + 8)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[h][mt][nt], af[mt], bf);
        }
      }
    }
    __syncthreads();
  }

  store_tile<MODE>(acc, bias, x, step, out, m0 + warp_m * MT * 16,
                   n0 + warp_n * NT * 8, g, q, m_rows, n_out, rows_per_batch);
}

// s = silu(depthwise_k(u) + bd) along time within each utterance; u rows
// outside [0, t_len) are zero ('same' padding on the whole utterance). A
// block owns kDwRows time rows x kDwCh channels of one utterance: it stages
// those rows and their (k-1)/2-row halo in shared memory, and each thread
// keeps its channel's k taps in registers and slides down its rows.
constexpr int kDwRows = 64;
constexpr int kDwCh = 64;
constexpr int kDwThreads = 256;
constexpr int kDwMaxK = 31;

__global__ void __launch_bounds__(kDwThreads)
depthwise_silu_kernel(const float* __restrict__ u, const float* __restrict__ wd,
                      const float* __restrict__ bd, float* __restrict__ s,
                      int t_len, int inner, int k) {
  extern __shared__ float4 dw_smem4[];
  float* tile = reinterpret_cast<float*>(dw_smem4);  // [rows + k - 1][kDwCh]
  const int pad = (k - 1) / 2;
  const int t0 = blockIdx.x * kDwRows;
  const int c0 = blockIdx.y * kDwCh;
  const int b = blockIdx.z;
  const float* ub = u + (size_t)b * t_len * inner;
  const int rows = kDwRows + k - 1;
  for (int i = threadIdx.x; i < rows * kDwCh; i += kDwThreads) {
    const int r = i / kDwCh;
    const int c = i - r * kDwCh;
    const int t = t0 - pad + r;
    tile[i] = (t >= 0 && t < t_len && c0 + c < inner)
                  ? ub[(size_t)t * inner + c0 + c] : 0.0f;
  }
  __syncthreads();
  const int c = threadIdx.x % kDwCh;
  if (c0 + c >= inner) return;
  constexpr int kGroups = kDwThreads / kDwCh;
  const int rows_per = kDwRows / kGroups;
  const int r0 = (threadIdx.x / kDwCh) * rows_per;
  float w[kDwMaxK];
#pragma unroll
  for (int tau = 0; tau < kDwMaxK; ++tau)
    w[tau] = tau < k ? wd[(size_t)(c0 + c) * k + tau] : 0.0f;
  const float bias = bd[c0 + c];
  for (int r = r0; r < r0 + rows_per; ++r) {
    const int t = t0 + r;
    if (t >= t_len) break;
    float acc = 0.0f;
#pragma unroll
    for (int tau = 0; tau < kDwMaxK; ++tau)
      if (tau < k) acc = fmaf(tile[(r + tau) * kDwCh + c], w[tau], acc);
    const float v = acc + bias;
    s[((size_t)b * t_len + t) * inner + c0 + c] = v * ddsp_sigmoid(v);
  }
}

}  // namespace

// x, out: (batch, t_len, c); cond: (batch, t_len, hc); step: (batch, c);
// wc (c, hc), w1 (2*inner, c), wd (inner, k), w2 (c, inner); h (batch*t_len,
// c), u and s (batch*t_len, inner) are scratch. c, hc and inner are
// multiples of 4 and the matrices 16-byte aligned.
DDSP_API int ddsp_conformer_layer(const float* x, const float* cond,
                                  const float* step, const float* wc,
                                  const float* bc, const float* w1,
                                  const float* b1, const float* wd,
                                  const float* bd, const float* w2,
                                  const float* b2, float* out, float* h,
                                  float* u, float* s, int batch, int t_len,
                                  int c, int hc, int inner, int k,
                                  void* stream) {
  const int m = batch * t_len;
  if (m == 0) return 0;
  if (c % 4 != 0 || hc % 4 != 0 || inner % 4 != 0 || k > kDwMaxK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kThreads);
  const dim3 grid_c((c + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 grid_u((inner + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_tc_kernel<kCond><<<grid_c, block, 0, st>>>(cond, wc, bc, x, step, h, m,
                                                  c, hc, t_len);
  DDSP_CHECK_LAUNCH();
  gemm_tc_kernel<kGlu><<<grid_u, block, 0, st>>>(h, w1, b1, nullptr, nullptr,
                                                 u, m, inner, c, t_len);
  DDSP_CHECK_LAUNCH();
  const dim3 grid_d((t_len + kDwRows - 1) / kDwRows,
                    (inner + kDwCh - 1) / kDwCh, batch);
  const size_t smem_d = (size_t)(kDwRows + k - 1) * kDwCh * sizeof(float);
  depthwise_silu_kernel<<<grid_d, kDwThreads, smem_d, st>>>(u, wd, bd, s,
                                                           t_len, inner, k);
  DDSP_CHECK_LAUNCH();
  gemm_tc_kernel<kResidual><<<grid_c, block, 0, st>>>(s, w2, b2, x, nullptr,
                                                      out, m, c, inner, t_len);
  DDSP_CHECK_LAUNCH();
  return 0;
}

// B3: the same layer with the three GEMMs in bf16 (gemm_bf16_kernel): wc, w1
// and w2 are bf16 (rounded once per model), everything else as above. c, hc
// and inner are multiples of 8.
DDSP_API int ddsp_conformer_layer_bf16(
    const float* x, const float* cond, const float* step,
    const __nv_bfloat16* wc, const float* bc, const __nv_bfloat16* w1,
    const float* b1, const float* wd, const float* bd,
    const __nv_bfloat16* w2, const float* b2, float* out, float* h, float* u,
    float* s, int batch, int t_len, int c, int hc, int inner, int k,
    void* stream) {
  const int m = batch * t_len;
  if (m == 0) return 0;
  if (c % 8 != 0 || hc % 8 != 0 || inner % 8 != 0 || k > kDwMaxK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kThreads);
  const dim3 grid_c((c + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 grid_u((inner + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_bf16_kernel<kCond><<<grid_c, block, 0, st>>>(cond, wc, bc, x, step, h,
                                                    m, c, hc, t_len);
  DDSP_CHECK_LAUNCH();
  gemm_bf16_kernel<kGlu><<<grid_u, block, 0, st>>>(h, w1, b1, nullptr, nullptr,
                                                   u, m, inner, c, t_len);
  DDSP_CHECK_LAUNCH();
  const dim3 grid_d((t_len + kDwRows - 1) / kDwRows,
                    (inner + kDwCh - 1) / kDwCh, batch);
  const size_t smem_d = (size_t)(kDwRows + k - 1) * kDwCh * sizeof(float);
  depthwise_silu_kernel<<<grid_d, kDwThreads, smem_d, st>>>(u, wd, bd, s,
                                                           t_len, inner, k);
  DDSP_CHECK_LAUNCH();
  gemm_bf16_kernel<kResidual><<<grid_c, block, 0, st>>>(s, w2, b2, x, nullptr,
                                                        out, m, c, inner,
                                                        t_len);
  DDSP_CHECK_LAUNCH();
  return 0;
}
