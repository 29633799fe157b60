// K3: one NaiveV2Diff denoiser layer (conv-only conformer, no norm).
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_conformer.py
// (fused_conformer_layer -> _fused_layer_impl -> _layer_kernel):
//   h   = x + step_vec + cond . Wc^T + bc
//   u   = GLU(h . W1^T + b1)                (a * sigmoid(g), halves of 2I)
//   v   = depthwise_k(u) + bd               (zero rows outside [0, T))
//   out = x + silu(v) . W2^T + b2
// with weights in the torch layout (1x1 convs squeezed to (out, in), the
// depthwise weight (I, k)).
//
// Bound on the H100: operations. At the 10 s request (T = 862, C = 512,
// Hc = 128, I = 1024, k = 31) a layer does 2.9 GFLOP on ~11 MB (weights
// dominate), ~260 flop/byte, above the f32 ridge of 20 flop/byte. Design
// (simple and right first, f32 only): a shared-memory-tiled f32 GEMM
// (64 x 64 output tile, k-steps of 16, 4 x 4 outputs per thread) launched
// three times with a fused epilogue each -- the first adds x, the step
// vector and the bias; the second owns output column j and column j + I of
// W1 together and applies the GLU; the third adds the bias and the
// residual -- and between the second and third a depthwise k-tap conv with
// bias and SiLU. No library GEMM is called. The bf16 precision class,
// wgmma and TMA are later work. Backward (training) stays the stock chain.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;

enum Mode { kCond = 0, kGlu = 1, kResidual = 2 };

// out[M, N] = epilogue(A[M, K] . W[N, K]^T); for kGlu, W has 2N rows and the
// tile also accumulates W rows n + N (the gate half).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ x,
            const float* __restrict__ step, float* __restrict__ out,
            int m_rows, int n_out, int k_dim, int rows_per_batch) {
  __shared__ __align__(16) float a_s[BK][BM + 4];
  __shared__ __align__(16) float w_s[BK][BN + 4];
  __shared__ __align__(16) float g_s[MODE == kGlu ? BK : 1][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int lr = tid / 4;        // tile row this thread loads
  const int lk = (tid % 4) * 4;  // first of its four k columns

  float acc[4][4];
  float accg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.0f;
      accg[i][j] = 0.0f;
    }

  for (int k0 = 0; k0 < k_dim; k0 += BK) {
    const int m = m0 + lr;
    const int n = n0 + lr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k0 + lk + q;
      const bool k_ok = kk < k_dim;
      a_s[lk + q][lr] =
          (m < m_rows && k_ok) ? a[(size_t)m * k_dim + kk] : 0.0f;
      w_s[lk + q][lr] =
          (n < n_out && k_ok) ? w[(size_t)n * k_dim + kk] : 0.0f;
      if constexpr (MODE == kGlu)
        g_s[lk + q][lr] =
            (n < n_out && k_ok) ? w[(size_t)(n + n_out) * k_dim + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
      if constexpr (MODE == kGlu) {
        const float4 gv = *reinterpret_cast<const float4*>(&g_s[kk][tx * 4]);
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            accg[i][j] = fmaf(ar[i], gr[j], accg[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= n_out) continue;
      const size_t o = (size_t)m * n_out + n;
      if constexpr (MODE == kCond) {
        const int bi = m / rows_per_batch;
        out[o] = x[o] + step[(size_t)bi * n_out + n] + acc[i][j] + bias[n];
      } else if constexpr (MODE == kGlu) {
        const float ga = acc[i][j] + bias[n];
        const float gg = accg[i][j] + bias[n + n_out];
        out[o] = ga * ddsp_sigmoid(gg);
      } else {
        out[o] = x[o] + acc[i][j] + bias[n];
      }
    }
  }
}

// s = silu(depthwise_k(u) + bd) along time within each utterance; u rows
// outside [0, t_len) are zero ('same' padding on the whole utterance).
__global__ void __launch_bounds__(256)
depthwise_silu_kernel(const float* __restrict__ u, const float* __restrict__ wd,
                      const float* __restrict__ bd, float* __restrict__ s,
                      int t_len, int inner, int k, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % inner);
  const long long m = idx / inner;
  const int t = (int)(m % t_len);
  const long long base = m - t;
  const int pad = (k - 1) / 2;
  float acc = 0.0f;
  for (int tau = 0; tau < k; ++tau) {
    const int tt = t + tau - pad;
    if (tt >= 0 && tt < t_len)
      acc = fmaf(u[(base + tt) * inner + c], wd[(size_t)c * k + tau], acc);
  }
  const float v = acc + bd[c];
  s[idx] = v * ddsp_sigmoid(v);
}

}  // namespace

// x, out: (batch, t_len, c); cond: (batch, t_len, hc); step: (batch, c);
// wc (c, hc), w1 (2*inner, c), wd (inner, k), w2 (c, inner); h (batch*t_len,
// c), u and s (batch*t_len, inner) are scratch.
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
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kThreads);
  const dim3 grid_c((c + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 grid_u((inner + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<kCond><<<grid_c, block, 0, st>>>(cond, wc, bc, x, step, h, m, c,
                                               hc, t_len);
  DDSP_CHECK_LAUNCH();
  gemm_kernel<kGlu><<<grid_u, block, 0, st>>>(h, w1, b1, nullptr, nullptr, u,
                                              m, inner, c, t_len);
  DDSP_CHECK_LAUNCH();
  const long long total = (long long)m * inner;
  depthwise_silu_kernel<<<(unsigned int)((total + 255) / 256), 256, 0, st>>>(
      u, wd, bd, s, t_len, inner, k, total);
  DDSP_CHECK_LAUNCH();
  gemm_kernel<kResidual><<<grid_c, block, 0, st>>>(s, w2, b2, x, nullptr, out,
                                                   m, c, inner, t_len);
  DDSP_CHECK_LAUNCH();
  return 0;
}
