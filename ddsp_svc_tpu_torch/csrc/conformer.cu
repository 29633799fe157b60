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
// B3 (ddsp_conformer_layer_bf16, JAX's mxu_bf16 class) has its own
// kernel on TMA and wgmma, at the end of this file.
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


// ---------------------------------------------------------------------------
// B3, K3's bf16 class: the layer in JAX's mxu_bf16 class
// (pallas_conformer.py:125 fused_conformer_layer with mxu_bf16=True at
// :134; the casts at :73-98 and :196-202): cond, h, s and Wc, W1, W2 are
// rounded to bf16 (nearest even) and their products summed in f32; every
// other value is f32. h feeds only GEMM 2 and s only GEMM 3, each through
// that one rounding, so they are stored as bf16 from the same f32 value.
//
// Bound on the H100: operations, the GEMMs' 2 M (Hc C + 3 I C) flops at the
// dense bf16 rate of 989.4 TFLOP/s plus the depthwise conv's 2 M I k at
// 67 TFLOP/s: 0.0037 ms at the 10 s request (M = 862, C = 512, Hc = 128,
// I = 1024, k = 31), 0.0352 ms at the training shape (B 48 x T 172).
//
// What this replaces: three mma.sync GEMMs (64 x 32 tiles, a two-stage
// cp.async ring of A staged in f32 and rounded per fragment) and a
// depthwise kernel between them, four launches a layer at 42-64 TFLOP/s.
//
// Design: one kernel template, launched three times. A block is two
// consumer warpgroups (BM = 128 MT rows, MT m64 tiles each) and a producer
// warp whose one lane keeps a ring of 64-deep K slices full by TMA (2-D
// tensor maps encoded on the host, 128-byte swizzle, zeros past every
// edge); the consumers run wgmma m64nBNk16 with both operands read from
// shared memory by descriptor and free a slice as soon as its products
// are read.
//   1. h = x + step + cond . Wc^T + bc, stored bf16. cond arrives f32: the
//      consumers round it into the swizzled A tiles themselves (K = Hc).
//   2. u = GLU(h . W1^T + b1) over the block's rows and a 15-row halo on
//      each side (the B tiles are W1's value rows and its gate rows), kept
//      f32 in shared memory; then s = silu(depthwise_k(u) + bd) for the
//      block's own rows (taps outside the row's utterance read zero),
//      stored bf16. u never reaches device memory.
//   3. out = x + s . W2^T + b2.
// Three launches a layer where K3 takes four. At M = 862 the tiles are
// 128 x 32, 256 x 32 (226 own rows) and 128 x 32, so the three launch 112,
// 128 and 112 blocks on 132 SMs; from M = 4096 on, 256 x 64 and 256 x 128
// for launches 1 and 3, and launch 2 persistent (below).
// Measured (tools/kernel_ab.py, parent and this kernel in turns on one
// NVIDIA H100 80GB HBM3 at 700 W, device time by CUDA graph replay):
// 0.032 ms a layer at M = 862 against 0.061 before, 0.236 ms at B 48 x
// T 172 against 0.421. At M = 862 each launch is a few microseconds of
// latency (TMA round trips, one wave); at B 48 x T 172 the GLU launch
// takes ~70 % of the layer, its h and W1 slices re-read from L2 by every
// block of its row or column.
//
// B5, the same layer on bf16 activations (fused_conformer_layer with a
// bf16 x, pallas_conformer.py:63 and :102, as a bf16 DiffusionFast or
// RectifiedFlow trunk in training runs it): x is read as bf16 and widened
// to f32, step arrives rounded to bf16 by the wrapper, and out is rounded
// once to bf16. cond is f32 (the DDSP mel, which the kernel rounds, as
// B3) or bf16 (already the GEMM operand). The same template with IN16 set:
// launches 1 and 3 read x as bf16 pairs and launch 3 stores bf16; with
// C16 launch 1 loads cond's A tiles by TMA like the other launches, with
// no rounding pass. Launch 2 is B3's own. The bound is B3's (operations);
// the bytes drop by x's and out's halves.
//
// Launch 2 at M >= 4096 (the training shapes; for B3 and B5 alike). Measured first (tools/kernel_ab.py, torch.profiler device time
// per launch, NVIDIA H100 80GB HBM3 at 700 W): at B 48 x T 172 B5's
// launches took 0.021 / 0.166 / 0.031 ms, launch 2 74 % of the layer; at
// 10 s 0.0055 / 0.0187 / 0.0075 ms (latency; that path is unchanged). What
// held launch 2 back: 592 blocks of one per SM in 4.5 waves, each running
// its mainloop, its GLU and its depthwise conv in turn, the conv's time
// mostly in per-element window masks and in sigmoids whose division
// branches to a slow path and serialises the chains; the 15-row halo
// recomputed (13 %), h read by 16 column blocks, W1 by 37 row blocks.
// Design (conformer_bf16_kernel_glu_dw): a persistent grid of one block
// per SM (8 column blocks of 128 value columns x 16 runs of ~546 rows);
// a block walks its run as 64-row tiles:
//  - a producer warp keeps a 3-slot TMA ring (h's 64 x 64 slice, W1's 128
//    value rows and 128 gate rows, one after the other) full across tiles;
//  - two consumer warpgroups take the tiles in turn (ping-pong): one runs
//    its mainloop (wgmma m64n256k16, value and gate columns in one
//    product) while the other runs the GLU and conv of the tile before;
//    named barriers order the mainloops (a ring slot's barrier is never
//    read two phases behind) and the convs (a tile's conv reads the halo
//    the tile before copied into its slot);
//  - the GLU goes from the accumulators into the tile's slot of u, f32;
//    the slot begins with the last 30 rows of the tile before, so the conv
//    of the rows whose window the tile completes (15 rows behind it) reads
//    one contiguous window and nothing is recomputed but 30 rows a run
//    (5.5 %); a thread takes a channel and 16 rows of one utterance at a
//    time, its taps and the 46-row window in registers, masks only at an
//    utterance's edge, and the 16 sigmoids of a step branch-free
//    (rcp_fast, proven equal to the division by ddsp_rcp_fast_mismatches);
//  - h is read by 8 column blocks (16 before), W1's slice once per tile.
// The output is the old launch's bit for bit (the same sums in the same
// order). Measured in turns with the old launch on one card
// (tools/kernel_ab.py, device time by CUDA graph replay): 0.151 ms against
// 0.224 at B 48 x T 172, launch 2 0.094 against 0.166 (PERF.md section 6),
// B3 0.164 against 0.237. Ablations of
// this kernel (variants timed by launch, the same card) put its mainloop
// alone at ~4.5 us a tile and the conv at ~half of the launch: the
// epilogue of a tile runs on one warpgroup, one warp per scheduler, and
// its instruction rate, not the tensor cores or the bytes, bounds the launch.

#include <atomic>
#include <mutex>

#include "hopper_bf16.cuh"

namespace {

enum B3Mode { kB3Cond = 0, kB3GluDw = 1, kB3Out = 2 };
constexpr int kB3Consumers = 256;
constexpr int kB3Threads = kB3Consumers + 32;
constexpr int kB3Halo = 15;      // the depthwise conv's largest pad (k <= 31)
constexpr int kB3MaxCondK = 256;  // Hc

struct B3Args {
  const void* x;          // (M, C) f32, or bf16 with IN16
  const float* cond;      // (M, Hc) f32        [1] (bf16 with IN16: by TMA)
  const float* step;      // (B, C) f32         [1]
  const float* bias;      // bc, b1 (2I) or b2
  const float* wd;        // (I, k) f32         [2]
  const float* bd;        // (I,) f32           [2]
  __nv_bfloat16* out_bf16;  // h (M, C) [1], s (M, I) [2]
  void* out;                // out (M, C) f32, or bf16 with IN16 [3]
  int m_rows, n_out, k_dim, t_len, k_dw;
};

template <int MODE, int BN, int MT, int STAGES, bool IN16, bool C16>
struct B3Cfg {
  static constexpr int BM = 128 * MT;
  static constexpr int OWN = MODE == kB3GluDw ? BM - 2 * kB3Halo : BM;  // rows a block writes
  static constexpr int NB = MODE == kB3GluDw ? 2 : 1;  // B tiles per slice
  // cond's f32 rows are rounded by the consumers into their own tiles; a
  // bf16 cond comes through the ring like the other launches' A
  static constexpr bool A_RING = MODE != kB3Cond || C16;
  static constexpr int A_BYTES = A_RING ? BM * 128 : 0;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + NB * B_BYTES;
  static constexpr int S = STAGES;
  static constexpr int US = BN + 8;  // u's row stride in floats
};

template <int MODE, int BN, int MT, int STAGES, bool IN16, bool C16>
size_t b3_smem_bytes(int k_dim) {
  using G = B3Cfg<MODE, BN, MT, STAGES, IN16, C16>;
  size_t n = (size_t)G::S * G::STAGE;
  if (!G::A_RING) n += (size_t)((k_dim + 63) / 64) * G::BM * 128;
  if (MODE == kB3GluDw) n += (size_t)G::BM * G::US * 4;
  return n + 2 * G::S * 8 + 1024;  // the barriers, and room to align the base
}

template <int MODE, int BN, int MT, int STAGES, bool IN16, bool C16>
__global__ void __launch_bounds__(kB3Threads, MT == 1 ? 2 : 1)
conformer_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const B3Args p) {
  using G = B3Cfg<MODE, BN, MT, STAGES, IN16, C16>;
  constexpr int S = G::S;
  extern __shared__ uint8_t b3_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(b3_smem_raw) + 1023) & ~(uintptr_t)1023);
  const int n_k = (p.k_dim + 63) / 64;
  uint8_t* extra = smem + S * G::STAGE;  // cond's A tiles [1] or u [2]
  size_t extra_bytes = 0;
  if (!G::A_RING) extra_bytes = (size_t)n_k * G::BM * 128;
  if (MODE == kB3GluDw) extra_bytes = (size_t)G::BM * G::US * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(extra + extra_bytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * G::OWN - (MODE == kB3GluDw ? kB3Halo : 0);
  const int n0 = blockIdx.x * BN;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kB3Consumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kB3Consumers) {
    if (tid == kB3Consumers) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        uint8_t* st = smem + s * G::STAGE;
        mbar_expect_tx(&full[s], G::STAGE);
        if (G::A_RING) tma_load_2d(st, &map_a, kt * 64, m0, &full[s]);
        tma_load_2d(st + G::A_BYTES, &map_b, kt * 64, n0, &full[s]);
        if (MODE == kB3GluDw)  // the gate half: W1's rows I + n
          tma_load_2d(st + G::A_BYTES + G::B_BYTES, &map_b, kt * 64,
                      n0 + p.n_out, &full[s]);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  if (!G::A_RING) {
    // cond's rows rounded to bf16 into swizzled A tiles, zeros past M and
    // Hc; four items' reads are issued before any is used
    const int chunks = n_k * 8;  // 16-byte chunks per row
    const int n_items = G::BM * chunks;
    constexpr int kBatch = 4;
    for (int i0 = tid; i0 < n_items; i0 += kBatch * kB3Consumers) {
      float4 v[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kB3Consumers;
        const int r = i / chunks;
        const int k0 = (i - r * chunks) * 8;
        const int m = m0 + r;
        if (i < n_items && m < p.m_rows && k0 < p.k_dim) {
          const float* src = p.cond + (size_t)m * p.k_dim + k0;
          v[u][0] = *reinterpret_cast<const float4*>(src);
          v[u][1] = *reinterpret_cast<const float4*>(src + 4);
        } else {
          v[u][0] = v[u][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kB3Consumers;
        if (i >= n_items) break;
        const int r = i / chunks;
        const int kc = i - r * chunks;
        __nv_bfloat162 h[4] = {__floats2bfloat162_rn(v[u][0].x, v[u][0].y),
                               __floats2bfloat162_rn(v[u][0].z, v[u][0].w),
                               __floats2bfloat162_rn(v[u][1].x, v[u][1].y),
                               __floats2bfloat162_rn(v[u][1].z, v[u][1].w)};
        *reinterpret_cast<uint4*>(extra + (size_t)(kc >> 3) * G::BM * 128 +
                                  sw128_offset(r, (kc & 7) * 8)) =
            *reinterpret_cast<const uint4*>(h);
      }
    }
    fence_proxy_async();
    consumer_sync(kB3Consumers);
  }

  float acc[MT][BN / 2];
  float acc_g[MODE == kB3GluDw ? MT : 1][BN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.0f;
    wgmma_fence_operand(acc[i]);
  }
#pragma unroll
  for (int i = 0; i < (MODE == kB3GluDw ? MT : 1); ++i) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc_g[i][e] = 0.0f;
    wgmma_fence_operand(acc_g[i]);
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    wgmma_fence();
    const uint8_t* st = smem + s * G::STAGE;
    const uint8_t* a_t = G::A_RING ? st : extra + (size_t)kt * G::BM * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bdesc = desc_sw128(st + G::A_BYTES + 32 * kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint64_t adesc = desc_sw128(a_t + (wg * MT + i) * 64 * 128 + 32 * kk);
        wgmma_ss<BN>(acc[i], adesc, bdesc);
        if constexpr (MODE == kB3GluDw)
          wgmma_ss<BN>(acc_g[i], adesc,
                       desc_sw128(st + G::A_BYTES + G::B_BYTES + 32 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) wgmma_fence_operand(acc[i]);
#pragma unroll
  for (int i = 0; i < (MODE == kB3GluDw ? MT : 1); ++i) wgmma_fence_operand(acc_g[i]);

  float* u_s = reinterpret_cast<float*>(extra);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * MT + i) * 64 + 16 * warp + g + 8 * h;
      const int m = m0 + r;
      if (MODE != kB3GluDw && m >= p.m_rows) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * q;
        const int n = n0 + cl;
        const float c0 = acc[i][4 * j + 2 * h];
        const float c1 = acc[i][4 * j + 2 * h + 1];
        if constexpr (MODE == kB3GluDw) {
          // every row of the frame, the halo's too; u past I is never read
          if (n >= p.n_out) continue;
          const float g0 = acc_g[i][4 * j + 2 * h] + p.bias[n + p.n_out];
          const float g1 = acc_g[i][4 * j + 2 * h + 1] + p.bias[n + 1 + p.n_out];
          *reinterpret_cast<float2*>(u_s + r * G::US + cl) =
              make_float2((c0 + p.bias[n]) * ddsp_sigmoid(g0),
                          (c1 + p.bias[n + 1]) * ddsp_sigmoid(g1));
        } else {
          if (n >= p.n_out) continue;
          const size_t o = (size_t)m * p.n_out + n;
          float2 xv;
          if constexpr (IN16)
            xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(p.x) + o));
          else
            xv = *reinterpret_cast<const float2*>(static_cast<const float*>(p.x) + o);
          if constexpr (MODE == kB3Cond) {
            const float* sv = p.step + (size_t)(m / p.t_len) * p.n_out + n;
            *reinterpret_cast<__nv_bfloat162*>(p.out_bf16 + o) = __floats2bfloat162_rn(
                xv.x + sv[0] + c0 + p.bias[n], xv.y + sv[1] + c1 + p.bias[n + 1]);
          } else if constexpr (IN16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) =
                __floats2bfloat162_rn(xv.x + c0 + p.bias[n], xv.y + c1 + p.bias[n + 1]);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
                make_float2(xv.x + c0 + p.bias[n], xv.y + c1 + p.bias[n + 1]);
          }
        }
      }
    }
  }

  if constexpr (MODE == kB3GluDw) {
    consumer_sync(kB3Consumers);
    // s = silu(depthwise(u) + bd) for the block's own rows. A thread takes
    // one channel (its taps in registers; 256 is a multiple of BN, so a
    // thread keeps its channel) and kDwR rows at a time: the rows' window
    // of u, zeros outside their utterance, slides through registers. Rows
    // that straddle two utterances (B > 1) take each row's own range.
    constexpr int kDwR = 8;
    constexpr int kWin = kDwR + 2 * kB3Halo;
    const int cl = tid % BN;
    const int n = n0 + cl;
    if (n >= p.n_out) return;
    const int k = p.k_dw;
    const int pad = (k - 1) / 2;
    float w[2 * kB3Halo + 1];
#pragma unroll
    for (int tau = 0; tau <= 2 * kB3Halo; ++tau)
      w[tau] = tau < k ? p.wd[(size_t)n * k + tau] : 0.0f;
    const float bias = p.bd[n];
    for (int item = tid; item < (G::OWN + kDwR - 1) / kDwR * BN; item += kB3Consumers) {
      const int r0 = (item / BN) * kDwR;
      const int m0r = blockIdx.y * G::OWN + r0;
      const int t0r = m0r % p.t_len;
      // u rows r0 + kB3Halo - pad + jj hold times t0r - pad + jj
      const float* u_col = u_s + (r0 + kB3Halo - pad) * G::US + cl;
      if (t0r + kDwR <= p.t_len) {
        float win[kWin];
#pragma unroll
        for (int jj = 0; jj < kWin; ++jj) {
          const int tt = t0r - pad + jj;
          const bool inside = jj < kDwR + k - 1 && r0 + kB3Halo - pad + jj < G::BM;
          win[jj] = (inside && tt >= 0 && tt < p.t_len) ? u_col[jj * G::US] : 0.0f;
        }
#pragma unroll
        for (int rr = 0; rr < kDwR; ++rr) {
          const int m = m0r + rr;
          if (r0 + rr >= G::OWN || m >= p.m_rows) break;
          float a = 0.0f;
#pragma unroll
          for (int tau = 0; tau <= 2 * kB3Halo; ++tau) a = fmaf(win[rr + tau], w[tau], a);
          const float v = a + bias;
          p.out_bf16[(size_t)m * p.n_out + n] = __float2bfloat16_rn(v * ddsp_sigmoid(v));
        }
      } else {
        for (int rr = 0; rr < kDwR; ++rr) {
          const int m = m0r + rr;
          if (r0 + rr >= G::OWN || m >= p.m_rows) break;
          const int t = m % p.t_len;
          float a = 0.0f;
#pragma unroll
          for (int tau = 0; tau <= 2 * kB3Halo; ++tau) {  // w in registers
            const int tt = t + tau - pad;
            if (tau < k && tt >= 0 && tt < p.t_len)
              a = fmaf(u_col[(rr + tau) * G::US], w[tau], a);
          }
          const float v = a + bias;
          p.out_bf16[(size_t)m * p.n_out + n] = __float2bfloat16_rn(v * ddsp_sigmoid(v));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 2 at M >= 4096 rows (B3's and B5's training shapes): the GLU GEMM
// and the depthwise conv on a persistent grid in ping-pong (see the note
// above, "Launch 2 at M >= 4096").
constexpr int kPpRows = 64;                // a tile's rows: one m64 per warpgroup
constexpr int kPpCols = 128;               // its value columns (and as many gate)
constexpr int kPpStages = 3;
constexpr int kPpA = kPpRows * 128;        // h's 64-deep slice of a tile
constexpr int kPpB = kPpCols * 128;        // one half of W1's slice
constexpr int kPpStage = kPpA + 2 * kPpB;  // 40 KB
// u of a tile in a slot of its own, behind the last 30 rows of the tile
// before (the conv's halo), so that a window never wraps; two slots
constexpr int kPpHalo = 2 * kB3Halo;
constexpr int kPpSlotRows = kPpHalo + kPpRows;
constexpr int kPpUS = kPpCols + 8;         // u's row stride in floats
constexpr int kPpDwR = 16;                 // output rows a thread takes at once

constexpr size_t pp_smem_bytes() {
  return (size_t)kPpStages * kPpStage + (size_t)2 * kPpSlotRows * kPpUS * 4 +
         2 * kPpCols * 4 + 2 * kPpStages * 8 + 1024;
}

// 1 / y rounded to nearest for y in [1, 2^126): the approximate reciprocal
// refined by two FMA corrections, free of the division's branch to its
// slow path (which checks for extreme exponents and, in every sigmoid it
// guards, ends a block of the schedule). ddsp_rcp_fast_mismatches holds it
// to 1.0f / y at every such y on the card.
__device__ __forceinline__ float rcp_fast(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  r = fmaf(r, fmaf(-y, r, 1.0f), r);
  return fmaf(r, fmaf(-y, r, 1.0f), r);
}

// ddsp_sigmoid of N values, bit for bit: the N reciprocals branch-free, and
// all N again by division if any denominator left [1, 2^126) (x below
// about -87, or NaN), so that the N chains interleave
template <int N>
__device__ __forceinline__ void sigmoid_n(const float (&x)[N], float (&out)[N]) {
  float y[N];
  bool slow = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    y[i] = 1.0f + expf(-x[i]);
    out[i] = rcp_fast(y[i]);
    slow |= !(y[i] < 0x1p126f);
  }
  if (slow) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = 1.0f / y[i];
  }
}

struct PpArgs {
  const float* b1;          // (2I,)
  const float* wd;          // (I, k)
  const float* bd;          // (I,)
  __nv_bfloat16* s;         // (M, I)
  int m_rows, n_out, k_dim, t_len, k_dw;
  int run_rows, tiles;      // own rows and tiles of a block
};

__global__ void __launch_bounds__(kB3Threads, 1)
conformer_bf16_kernel_glu_dw(const __grid_constant__ CUtensorMap map_h,
                             const __grid_constant__ CUtensorMap map_w1,
                             const PpArgs p) {
  constexpr int S = kPpStages;
  extern __shared__ uint8_t pp_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(pp_smem_raw) + 1023) & ~(uintptr_t)1023);
  float* u_s = reinterpret_cast<float*>(smem + S * kPpStage);  // [2][94][136]
  float* bias_s = u_s + 2 * kPpSlotRows * kPpUS;  // b1's value, then gate slice
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + 2 * kPpCols);
  uint64_t* empty = full + S;

  const int n_cb = (p.n_out + kPpCols - 1) / kPpCols;
  const int n0 = (blockIdx.x % n_cb) * kPpCols;
  const int r_lo = (blockIdx.x / n_cb) * p.run_rows;  // own rows [r_lo, r_hi)
  if (r_lo >= p.m_rows) return;
  const int r_hi = min(p.m_rows, r_lo + p.run_rows);
  const int row0 = r_lo - kB3Halo;  // tile j computes u for rows row0 + 64 j + [0, 64)
  const int n_k = (p.k_dim + 63) / 64;
  const int tiles = p.tiles;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // the owning warpgroup's four warps
    }
    mbar_fence_init();
  }
  if (tid < kPpCols) {
    const int n = n0 + tid;
    bias_s[tid] = n < p.n_out ? p.b1[n] : 0.0f;
    bias_s[kPpCols + tid] = n < p.n_out ? p.b1[n + p.n_out] : 0.0f;
  }
  __syncthreads();

  if (tid >= kB3Consumers) {
    // the producer: every tile's K slices in order, through one ring
    if (tid == kB3Consumers) {
      int g = 0;
      for (int j = 0; j < tiles; ++j) {
        for (int kt = 0; kt < n_k; ++kt, ++g) {
          const int st = g % S;
          if (g >= S) mbar_wait(&empty[st], ((g / S) - 1) & 1);
          uint8_t* dst = smem + st * kPpStage;
          mbar_expect_tx(&full[st], kPpStage);
          tma_load_2d(dst, &map_h, kt * 64, row0 + kPpRows * j, &full[st]);
          tma_load_2d(dst + kPpA, &map_w1, kt * 64, n0, &full[st]);
          tma_load_2d(dst + kPpA + kPpB, &map_w1, kt * 64, n0 + p.n_out, &full[st]);
        }
      }
    }
  } else {
    const int wg = tid >> 7;
    const int tw = tid & 127;
    const int warp = tw >> 5;
    const int lane = tid & 31;
    const int g8 = lane >> 2;
    const int q = lane & 3;
    // named barriers: 2 + w releases warpgroup w's mainloop, 4 + w its conv,
    // 6 + w is its own
    const int ml_mine = 2 + wg, ml_other = 3 - wg;
    const int ep_mine = 4 + wg, ep_other = 5 - wg;

    for (int j = wg; j < tiles; j += 2) {
      // the mainloop of tile j starts once tile j-1's slices have all landed,
      // so that a ring slot's barrier is never read two phases behind
      if (j > 0) named_sync(ml_mine, kB3Consumers);
      // one m64n256 product a k16 step: W1's value rows and gate rows sit one
      // after the other in the slot, so acc[0, 64) holds the value columns and
      // acc[64, 128) the gate columns, in wgmma's layout
      float acc[kPpCols];
  #pragma unroll
      for (int e = 0; e < kPpCols; ++e) acc[e] = 0.0f;
      wgmma_fence_operand(acc);
      for (int kt = 0; kt < n_k; ++kt) {
        const int g = j * n_k + kt;
        const int st = g % S;
        mbar_wait(&full[st], (g / S) & 1);
        if (kt == n_k - 1 && j + 1 < tiles) named_arrive(ml_other, kB3Consumers);
        wgmma_fence();
        const uint8_t* slot = smem + st * kPpStage;
  #pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<2 * kPpCols>(acc, desc_sw128(slot + 32 * kk),
                                desc_sw128(slot + kPpA + 32 * kk));
        wgmma_commit();
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % S]);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(j * n_k + n_k - 1) % S]);
      wgmma_fence_operand(acc);

      // u = GLU(h . W1^T + b1), f32, from the accumulators into the main rows
      // of slot j % 2 (the tile's row r at slot row 30 + r). The slot's main
      // rows were last read by tile j-2's conv, this warpgroup's own; the
      // other warpgroup may meanwhile run tile j-1's conv (the other slot)
      // and copy its tail into this slot's halo rows.
      float* slot_u = u_s + (j & 1) * kPpSlotRows * kPpUS;
  #pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* urow = slot_u + (kPpHalo + 16 * warp + g8 + 8 * hh) * kPpUS;
  #pragma unroll
        for (int jb = 0; jb < kPpCols / 32; ++jb) {
          float gate[8], sig[8];
  #pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int jj = 4 * jb + t;
            const float2 bg = *reinterpret_cast<const float2*>(bias_s + kPpCols + 8 * jj + 2 * q);
            gate[2 * t] = acc[kPpCols / 2 + 4 * jj + 2 * hh] + bg.x;
            gate[2 * t + 1] = acc[kPpCols / 2 + 4 * jj + 2 * hh + 1] + bg.y;
          }
          sigmoid_n(gate, sig);
  #pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int jj = 4 * jb + t;
            const int cl = 8 * jj + 2 * q;
            const float2 bv = *reinterpret_cast<const float2*>(bias_s + cl);
            *reinterpret_cast<float2*>(urow + cl) =
                make_float2((acc[4 * jj + 2 * hh] + bv.x) * sig[2 * t],
                            (acc[4 * jj + 2 * hh + 1] + bv.y) * sig[2 * t + 1]);
          }
        }
      }
      named_sync(6 + wg, 128);
      // the convs run in tile order: tile j-1's copied its tail into this
      // slot's halo, and read the halo rows of the slot this tile's tail goes to
      if (j > 0) named_sync(ep_mine, kB3Consumers);

      // s = silu(depthwise_k(u) + bd) for the own rows whose window tile j
      // completes, [row0 + 64 j - 15, row0 + 64 j + 49) within [r_lo, r_hi).
      // A thread takes one channel (its taps in registers) and up to kPpDwR
      // rows of one utterance at a time: the rows' window of u, read where a
      // warp's 32 channels are 32 consecutive words (no bank conflict), sits
      // in registers; zeros outside the utterance, and only there is a load
      // predicated.
      const int n = n0 + tw;
      const float* u_col = slot_u + tw;
      if (n < p.n_out) {
        const int k = p.k_dw;
        const int pad = (k - 1) / 2;
        float w[2 * kB3Halo + 1];
  #pragma unroll
        for (int tau = 0; tau <= 2 * kB3Halo; ++tau)
          w[tau] = tau < k ? __ldg(p.wd + (size_t)n * k + tau) : 0.0f;
        const float bias = __ldg(p.bd + n);
        const int s_j = row0 + kPpRows * j;  // the tile's first row
        const int lo = max(r_lo, s_j - kB3Halo);
        const int hi = min(r_hi, s_j + kPpRows - kB3Halo);
        constexpr int kWin = kPpDwR + 2 * kB3Halo;
        for (int m0r = lo; m0r < hi;) {
          const int t0r = m0r % p.t_len;
          const int rows = min(min(hi - m0r, kPpDwR), p.t_len - t0r);
          // window element jj is slot row base + jj, time t0r - pad + jj; the
          // rows' outputs need jj in [j_lo, j_hi)
          const float* win_u = u_col + (kPpHalo + m0r - pad - s_j) * kPpUS;
          const int j_lo = max(0, pad - t0r);
          const int j_hi = min(rows + 2 * pad, p.t_len - t0r + pad);
          float win[kWin];
          if (j_lo == 0 && j_hi == kWin) {
  #pragma unroll
            for (int jj = 0; jj < kWin; ++jj) win[jj] = win_u[jj * kPpUS];
          } else {
  #pragma unroll
            for (int jj = 0; jj < kWin; ++jj)
              win[jj] = (jj >= j_lo && jj < j_hi) ? win_u[jj * kPpUS] : 0.0f;
          }
          // each row's sum in tap order, the rows' chains interleaved
          float a[kPpDwR], sig[kPpDwR];
  #pragma unroll
          for (int rr = 0; rr < kPpDwR; ++rr) a[rr] = 0.0f;
  #pragma unroll
          for (int tau = 0; tau <= 2 * kB3Halo; ++tau)
  #pragma unroll
            for (int rr = 0; rr < kPpDwR; ++rr) a[rr] = fmaf(win[rr + tau], w[tau], a[rr]);
  #pragma unroll
          for (int rr = 0; rr < kPpDwR; ++rr) a[rr] += bias;
          sigmoid_n(a, sig);
          __nv_bfloat16* out = p.s + (size_t)m0r * p.n_out + n;
  #pragma unroll
          for (int rr = 0; rr < kPpDwR; ++rr)
            if (rr < rows) out[(size_t)rr * p.n_out] = __float2bfloat16_rn(a[rr] * sig[rr]);
          m0r += rows;
        }
      }
      // the tile's last 30 rows of u become the next tile's halo (the other
      // slot's first rows, which tile j-1's conv has read)
      if (j + 1 < tiles) {
        float* next_u = u_s + ((j + 1) & 1) * kPpSlotRows * kPpUS + tw;
  #pragma unroll
        for (int r = 0; r < kPpHalo; ++r)
          next_u[r * kPpUS] = u_col[(kPpRows + r) * kPpUS];
        named_arrive(ep_other, kB3Consumers);
      }
    }
  }
  // the producer warp waits here for the consumers rather than exiting
  // while their named barriers are in use
  __syncthreads();
}

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (rows, cols) bf16 matrix as boxes of 64 columns x box_rows rows in the
// 128-byte swizzle, zeros outside
int bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// bf16_map, remembered per (pointer, shape, box): at 10 s the host's work
// per layer call is longer than the layer on the card, and five encodes a
// call were most of what this file adds to it. A map holds only the
// layout, so an entry is right for whatever lives at its pointer with its
// shape: the weights (made once per model) and h and s (the caching
// allocator hands them back at the same places). Serving threads share it.
int cached_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  struct Entry {
    const void* base;
    int rows, cols, box_rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  static std::mutex lock;
  static Entry cache[kEntries];
  static int next = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache)
    if (e.base == base && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  const int err = bf16_map(map, base, rows, cols, box_rows);
  if (err == 0) cache[next++ % kEntries] = Entry{base, rows, cols, box_rows, *map};
  return err;
}

// A kernel's dynamic shared-memory limit is an attribute of the current
// card's context, so a launcher raises it once per card: on a second card
// a limit raised on the first alone refuses the launch. The wrappers make
// the tensor's card current before they call in (ops/kernels.launch).
constexpr int kMaxCards = 64;

struct DeviceFlags {
  std::atomic<bool> done[kMaxCards];
};

template <typename Kernel>
cudaError_t raise_smem_limit(DeviceFlags& raised, Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxCards;
  if (known && raised.done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && known) raised.done[dev].store(true, std::memory_order_release);
  return e;
}

// the card's SM count, asked once per card
int sm_count() {
  static std::atomic<int> sms[kMaxCards];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const bool known = dev >= 0 && dev < kMaxCards;
  int n = known ? sms[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    if (known) sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <int MODE, int BN, int MT, int STAGES, bool IN16 = false, bool C16 = false>
int launch_b3(const void* a, int a_cols, const void* b, int b_rows, const B3Args& p,
              cudaStream_t stream) {
  using G = B3Cfg<MODE, BN, MT, STAGES, IN16, C16>;
  CUtensorMap map_a, map_b;
  int err = cached_map(&map_b, b, b_rows, p.k_dim, BN);
  if (err) return err;
  if (!G::A_RING) {
    map_a = map_b;  // unused: the consumers make cond's tiles
  } else {
    err = cached_map(&map_a, a, p.m_rows, a_cols, G::BM);
    if (err) return err;
  }
  const size_t smem = b3_smem_bytes<MODE, BN, MT, STAGES, IN16, C16>(p.k_dim);
  // raised once per instantiation and card (to the most any Hc <= 256 needs)
  static DeviceFlags raised;
  const cudaError_t attr = raise_smem_limit(
      raised, conformer_bf16_kernel<MODE, BN, MT, STAGES, IN16, C16>,
      (int)b3_smem_bytes<MODE, BN, MT, STAGES, IN16, C16>(kB3MaxCondK));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.n_out + BN - 1) / BN, (p.m_rows + G::OWN - 1) / G::OWN);
  conformer_bf16_kernel<MODE, BN, MT, STAGES, IN16, C16>
      <<<grid, kB3Threads, smem, stream>>>(map_a, map_b, p);
  DDSP_CHECK_LAUNCH();
  return 0;
}

// launch 2 at M >= 4096: one block per SM walks a run of row tiles of one
// 128-column block; the runs split M evenly over the SMs a column block gets
int launch_glu_dw(const __nv_bfloat16* h, int c, const __nv_bfloat16* w1, int inner,
                  const float* b1, const float* wd, const float* bd, __nv_bfloat16* s,
                  int m, int t_len, int k, cudaStream_t stream) {
  CUtensorMap map_h, map_w1;
  int err = cached_map(&map_h, h, m, c, kPpRows);
  if (err) return err;
  err = cached_map(&map_w1, w1, 2 * inner, c, kPpCols);
  if (err) return err;
  static DeviceFlags raised;
  const cudaError_t attr =
      raise_smem_limit(raised, conformer_bf16_kernel_glu_dw, (int)pp_smem_bytes());
  if (attr != cudaSuccess) return (int)attr;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int n_cb = (inner + kPpCols - 1) / kPpCols;
  const int runs_max = sms > n_cb ? sms / n_cb : 1;
  const int per_run = (m + runs_max - 1) / runs_max;
  const int tiles = (per_run + 2 * kB3Halo + kPpRows - 1) / kPpRows;
  const int run_rows = tiles * kPpRows - 2 * kB3Halo;
  const int runs = (m + run_rows - 1) / run_rows;
  const PpArgs p{b1, wd, bd, s, m, inner, c, t_len, k, run_rows, tiles};
  conformer_bf16_kernel_glu_dw<<<n_cb * runs, kB3Threads, pp_smem_bytes(), stream>>>(
      map_h, map_w1, p);
  DDSP_CHECK_LAUNCH();
  return 0;
}

template <int MODE, int BN, int MT, int STAGES, bool IN16>
int launch_cond(bool c16, const void* cond, int hc, const void* b, int b_rows,
                const B3Args& p, cudaStream_t stream) {
  // a bf16 cond is launch 1's A itself, by TMA; an f32 one the consumers round
  return c16 ? launch_b3<MODE, BN, MT, STAGES, IN16, true>(cond, hc, b, b_rows, p, stream)
             : launch_b3<MODE, BN, MT, STAGES, IN16, false>(nullptr, 0, b, b_rows, p, stream);
}

template <bool IN16>
int conformer_layer_bf16(const void* x, const void* cond, bool c16, const float* step,
                         const __nv_bfloat16* wc, const float* bc,
                         const __nv_bfloat16* w1, const float* b1, const float* wd,
                         const float* bd, const __nv_bfloat16* w2, const float* b2,
                         void* out, __nv_bfloat16* h, __nv_bfloat16* s, int batch,
                         int t_len, int c, int hc, int inner, int k, void* stream) {
  const int m = batch * t_len;
  if (m == 0) return 0;
  if (c % 8 != 0 || hc % 8 != 0 || inner % 8 != 0 || hc > kB3MaxCondK ||
      k > 2 * kB3Halo + 1 || k % 2 == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool large = m >= 4096;
  const float* cond_f32 = c16 ? nullptr : static_cast<const float*>(cond);
  B3Args p1{x, cond_f32, step, bc, nullptr, nullptr, h, nullptr, m, c, hc, t_len, k};
  B3Args p2{x, nullptr, nullptr, b1, wd, bd, s, nullptr, m, inner, c, t_len, k};
  B3Args p3{x, nullptr, nullptr, b2, nullptr, nullptr, nullptr, out, m, c, inner, t_len, k};
  int err = large ? launch_cond<kB3Cond, 64, 2, 4, IN16>(c16, cond, hc, wc, c, p1, st)
                  : launch_cond<kB3Cond, 32, 1, 4, IN16>(c16, cond, hc, wc, c, p1, st);
  if (err) return err;
  err = large ? launch_glu_dw(h, c, w1, inner, b1, wd, bd, s, m, t_len, k, st)
              : launch_b3<kB3GluDw, 32, 2, 3>(h, c, w1, 2 * inner, p2, st);
  if (err) return err;
  return large ? launch_b3<kB3Out, 128, 2, 4, IN16>(s, inner, w2, c, p3, st)
               : launch_b3<kB3Out, 32, 1, 4, IN16>(s, inner, w2, c, p3, st);
}

}  // namespace

// B3: x, out: (batch, t_len, c) f32; cond (batch, t_len, hc) f32; step
// (batch, c); wc (c, hc), w1 (2 inner, c), w2 (c, inner) bf16 (rounded once
// per model); bc, b1, wd (inner, k), bd, b2 f32; h (batch t_len, c) and s
// (batch t_len, inner) bf16 scratch. c, hc and inner multiples of 8, hc at
// most 256, k odd and at most 31, every matrix 16-byte aligned.
DDSP_API int ddsp_conformer_layer_bf16(
    const float* x, const float* cond, const float* step,
    const __nv_bfloat16* wc, const float* bc, const __nv_bfloat16* w1,
    const float* b1, const float* wd, const float* bd,
    const __nv_bfloat16* w2, const float* b2, float* out, __nv_bfloat16* h,
    __nv_bfloat16* s, int batch, int t_len, int c, int hc, int inner, int k,
    void* stream) {
  return conformer_layer_bf16<false>(x, cond, false, step, wc, bc, w1, b1, wd, bd, w2,
                                     b2, out, h, s, batch, t_len, c, hc, inner, k, stream);
}

// B5: as B3 with x and out bf16 (batch, t_len, c); cond (batch, t_len, hc)
// bf16 when cond_bf16 is 1, f32 otherwise; step f32, already rounded to
// bf16 by the caller, as JAX casts it to x's type.
DDSP_API int ddsp_conformer_layer_bf16_io(
    const __nv_bfloat16* x, const void* cond, int cond_bf16, const float* step,
    const __nv_bfloat16* wc, const float* bc, const __nv_bfloat16* w1,
    const float* b1, const float* wd, const float* bd,
    const __nv_bfloat16* w2, const float* b2, __nv_bfloat16* out,
    __nv_bfloat16* h, __nv_bfloat16* s, int batch, int t_len, int c, int hc,
    int inner, int k, void* stream) {
  return conformer_layer_bf16<true>(x, cond, cond_bf16 != 0, step, wc, bc, w1, b1, wd,
                                    bd, w2, b2, out, h, s, batch, t_len, c, hc, inner,
                                    k, stream);
}

namespace {

__global__ void rcp_fast_check_kernel(unsigned long long* mismatches) {
  unsigned long long bad = 0;
  const uint32_t lo = 0x3F800000u, hi = 0x7E800000u;  // [1, 2^126)
  for (uint32_t b = lo + blockIdx.x * blockDim.x + threadIdx.x; b < hi;
       b += gridDim.x * blockDim.x) {
    const float y = __uint_as_float(b);
    bad += __float_as_uint(rcp_fast(y)) != __float_as_uint(1.0f / y);
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// The number of y in [1, 2^126) at which B3's and B5's branch-free
// reciprocal differs from 1.0f / y, added to *mismatches (one u64 on the
// card, zeroed by the caller): must be 0.
DDSP_API int ddsp_rcp_fast_mismatches(unsigned long long* mismatches, void* stream) {
  rcp_fast_check_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(mismatches);
  DDSP_CHECK_LAUNCH();
  return 0;
}
