// K2: one NSF-HiFiGAN generator stage's mean over its ResBlock1 chains.
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_resblock.py
// (fused_resblock_group -> _run_group -> _rb_group_kernel). For each of the
// stage's resblocks j (kernel size k_j, dilations d_j0..d_j2):
//   z = x
//   for d in d_j: t = conv_d(leaky(z)) + b1; z = conv_1(leaky(t)) + b2 + z
//   out = mean_j z
// with leaky = leaky_relu(0.1) and every conv 'same'-padded with zeros on
// the whole utterance (rows outside [0, length) read as zero).
//
// Bound on the H100: operations. A stage does 2*L*C^2*126 flops (126 = the
// sum of the 18 convs' taps) on 8*L*C bytes of activation in and out, so at
// C >= 16 it is far above the ridge. At f32 accuracy the tensor cores run
// split TF32 (mma_tf32x3.cuh: three MMAs per product), whose ceiling is
// 494.7 / 3 TFLOP/s; the f32 FMA pipe's is 67.
//
// Design: each conv is an implicit GEMM on the tensor cores, M = a tile of
// output time rows, N = output channels, K = input channels x taps, where
// tap tau reads the input rows shifted by tau * dilation. A block is two
// warpgroups that own BM = 256 rows (128 at the C = 256 stage, which has
// too few rows to fill the card otherwise) x BN channels and walk the
// input channels eight at a time through a two-stage cp.async ring: each
// stage holds BM + (k-1)*d input rows of eight channels (the halo comes in
// the same copy; cp.async's zero fill gives the rows outside the
// utterance) and the eight channels' k B tiles in a TF32 hi and a lo
// plane, which the wrapper split and packed once per model as wgmma's
// K-major core matrices, so a tile is one contiguous copy. Once a stage has
// landed, the block applies leaky_relu to the staged input and splits it
// into a hi and a lo plane, once per element: each input value then serves
// all k taps. Per tap, one ldmatrix.x4 per plane loads each warp's A
// fragment into registers, and wgmma m64nBNk8 takes lo*hi, hi*lo, then
// hi*hi with B read from shared memory by descriptor. What the design
// fights: issue slots (the mma.sync version spent ~55 instructions per 48
// HMMA on splits and fragment loads; a wgmma does 64 x BN x 8 products for
// one issue) and the weights' L2 traffic (every block reads all of its BN
// columns' weights, so rows per block set how often they are read;
// splitting them in shared memory instead, which halves that traffic,
// measured slower for the exposed split pass). The epilogue adds the bias
// and, optionally, the residual; the last conv of each chain adds the
// previous chains' sum and the last chain applies the 1/n_rb of the mean,
// so no sum is finished outside the kernels. The running sum alternates
// between two buffers: read and written in place by one launch it cost
// ~0.18 ms more per launch at C = 128 (tools/kernel_ab.py on an H100). A
// stage is 18 launches.
//
// Why not one launch per chain at C <= 64 (a time tile plus the chain's
// 60-row halo kept on the SM): the two activation tiles of 248 rows x 64
// channels take 127 KB and the conv's weights (11 x 64 x 64 floats, 180 KB)
// do not fit beside them, so they would stream from L2 six times per tile
// anyway; what fusion saves is the activation round trips, which at these
// sizes mostly hit the 50 MB L2. The per-conv kernel serves all five stages
// with one code path; the fused chain is left for a later PR and its
// measured share (PERF.md) says whether it pays.
// Backward (training) is not here: it stays the stock conv chain.
#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int KC = 8;       // input channels per ring stage: one k8 step
constexpr int kStride = 8;  // words per staged input row of 8 channels
constexpr float kSlope = 0.1f;

// word offset of 16-byte half h of staged input row r: the halves of rows
// whose bit 2 is set trade places, so any 8 consecutive rows' same half
// fall in 8 distinct 16-byte bank groups (ldmatrix without conflicts)
__device__ __forceinline__ int swz(int r, int h) {
  return r * kStride + 4 * (h ^ ((r >> 2) & 1));
}

// BN output channels x BM rows per block; each warpgroup owns MT m64 tiles
template <int BN, int MT>
struct ConvTile {
  static constexpr int BM = kWarpgroups * MT * 64;
  static constexpr int NACC = BN / 2;      // accumulators per thread per tile
  static constexpr int B_WORDS = BN * KC;  // one tap's B tile
};

// one ring stage: the k B tiles, hi plane and lo plane, [k][BN / 8][2][8][4]
// each (the layout the wgmma descriptor names), then the input's hi plane
// (the raw input lands here) and lo plane, [rows_in][kStride] each
__host__ __device__ constexpr int stage_words(int rows_in, int k, int bn) {
  return 2 * k * bn * KC + 2 * rows_in * kStride;
}

// leaky_relu and the hi/lo split of four staged input values: hi in place,
// lo at the same offset of the lo plane
__device__ __forceinline__ void leaky_split4(float* hi_p, float* lo_p) {
  float4 v = *reinterpret_cast<const float4*>(hi_p);
  v = make_float4(fmaxf(v.x, kSlope * v.x), fmaxf(v.y, kSlope * v.y),
                  fmaxf(v.z, kSlope * v.z), fmaxf(v.w, kSlope * v.w));
  uint32_t hi[4], lo[4];
  split_tf32(v.x, hi[0], lo[0]);
  split_tf32(v.y, hi[1], lo[1]);
  split_tf32(v.z, hi[2], lo[2]);
  split_tf32(v.w, hi[3], lo[3]);
  *reinterpret_cast<float4*>(hi_p) =
      make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                  __uint_as_float(hi[2]), __uint_as_float(hi[3]));
  *reinterpret_cast<float4*>(lo_p) =
      make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                  __uint_as_float(lo[2]), __uint_as_float(lo[3]));
}

template <int BN, int MT>
__global__ void __launch_bounds__(kThreads)
resblock_conv_tc_kernel(const float* __restrict__ x,
                        const float* __restrict__ wp,
                        const float* __restrict__ bias, const float* res,
                        float* out, int length, int channels, int k,
                        int dilation, float scale, const float* acc_in) {
  using T = ConvTile<BN, MT>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* smem = reinterpret_cast<float*>(smem4);
  const int halo = (k - 1) * dilation;
  const int pad = halo / 2;
  const int rows_in = T::BM + halo;
  const int stage_floats = stage_words(rows_in, k, BN);
  const int b_words = k * T::B_WORDS;  // one plane of a stage's B tiles
  const int n_chunks = channels / KC;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;  // within its warpgroup
  const int row0 = (tid >> 7) * MT * 64 + 16 * warp;  // this warp's first row
  const int g = lane >> 2;
  const int q = lane & 3;
  const int t0 = blockIdx.x * T::BM;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * length * channels;

  // input rows t0 - pad .. t0 + BM + pad of channels ci0 .. ci0 + 7 (zeros
  // outside the utterance) into the input's hi plane, and the 2k B tiles:
  // wp is [2][k][C / 8][C / 8][2][8][4], so a tile is contiguous
  auto stage = [&](int chunk, int buf) {
    float* w_s = smem + buf * stage_floats;
    float* x_s = w_s + 2 * b_words;
    const int ci0 = chunk * KC;
    for (int i = tid; i < rows_in * 2; i += kThreads) {
      const int r = i >> 1;
      const int half = i & 1;
      const int t = t0 - pad + r;
      const bool ok = t >= 0 && t < length;
      const float* src = ok ? xb + (size_t)t * channels + ci0 + 4 * half : xb;
      cp_async16(x_s + swz(r, half), src, ok);
    }
    constexpr int kVec = T::B_WORDS / 4;
    for (int i = tid; i < 2 * k * kVec; i += kThreads) {
      const int tile = i / kVec;  // plane * k + tau
      const int v = i - tile * kVec;
      const size_t src =
          (((size_t)tile * n_chunks + chunk) * channels + co0) * KC + 4 * v;
      cp_async16(w_s + tile * T::B_WORDS + 4 * v, wp + src, true);
    }
  };

  float acc[MT][T::NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[mt][i] = 0.0f;

  // ldmatrix row addresses of the A fragment (warp w of a warpgroup: rows
  // 16w..16w+15 of each m64 tile): quarter j = lane / 8 is rows
  // + 8 * (j & 1), half j >> 1
  const int a_row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;

  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage(ch + 1, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* bh_s = smem + (ch & 1) * stage_floats;
    float* bl_s = bh_s + b_words;
    float* xh_s = bl_s + b_words;
    float* xl_s = xh_s + rows_in * kStride;
    // leaky_relu and the hi/lo split once per staged input element (each
    // serves all k taps and every m64 tile)
    for (int i = tid; i < rows_in * 2; i += kThreads)
      leaky_split4(xh_s + 4 * i, xl_s + 4 * i);
    fence_proxy_async();  // the B planes are read by wgmma
    __syncthreads();
    for (int tau = 0; tau < k; ++tau) {
      // output row i of the tile reads staged input row i + tau * dilation
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off = swz(a_row + tau * dilation + 64 * mt, a_half);
        ldmatrix_x4(a_hi[mt], xh_s + off);
        ldmatrix_x4(a_lo[mt], xl_s + off);
      }
      // core matrices of 8 n-rows x 4 k-words: 128 bytes apart along K,
      // 256 bytes apart along N
      const uint64_t b_hi = wgmma_desc(bh_s + tau * T::B_WORDS, 128, 256);
      const uint64_t b_lo = wgmma_desc(bl_s + tau * T::B_WORDS, 128, 256);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_fence_operand(acc[mt]);
      wgmma_fence();
      // the small cross terms first, then hi * hi
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_tf32<BN>(acc[mt], a_lo[mt], b_hi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_tf32<BN>(acc[mt], a_hi[mt], b_lo);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_tf32<BN>(acc[mt], a_hi[mt], b_hi);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_fence_operand(acc[mt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + row0 + 64 * mt + g + 8 * half;
      if (t >= length) continue;
      const size_t row = ((size_t)b * length + t) * channels;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * q;
        float2 y = make_float2(acc[mt][4 * j + 2 * half] + bias[co],
                               acc[mt][4 * j + 2 * half + 1] + bias[co + 1]);
        if (res != nullptr) {
          const float2 r = *reinterpret_cast<const float2*>(res + row + co);
          y.x += r.x;
          y.y += r.y;
        }
        if (acc_in != nullptr) {
          const float2 o = *reinterpret_cast<const float2*>(acc_in + row + co);
          y.x += o.x;
          y.y += o.y;
        }
        y.x *= scale;
        y.y *= scale;
        *reinterpret_cast<float2*>(out + row + co) = y;
      }
    }
  }
}

template <int BN, int MT>
int launch_conv(const float* x, const float* wp, const float* bias,
                const float* res, float* out, int batch, int length,
                int channels, int k, int dilation, float scale,
                const float* acc_in, cudaStream_t stream) {
  using T = ConvTile<BN, MT>;
  const int rows_in = T::BM + (k - 1) * dilation;
  const size_t smem = 2 * (size_t)stage_words(rows_in, k, BN) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resblock_conv_tc_kernel<BN, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((length + T::BM - 1) / T::BM, channels / BN, batch);
  resblock_conv_tc_kernel<BN, MT><<<grid, kThreads, smem, stream>>>(
      x, wp, bias, res, out, length, channels, k, dilation, scale, acc_in);
  DDSP_CHECK_LAUNCH();
  return 0;
}

// Blocks of 256 rows, which halve the weights each block reads per row
// against 128, unless that leaves fewer than two blocks per SM (the
// C = 256 stage: 6,896 rows).
template <int BN>
int launch_conv_rows(const float* x, const float* wp, const float* bias,
                     const float* res, float* out, int batch, int length,
                     int channels, int k, int dilation, float scale,
                     const float* acc_in, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long blocks256 =
      (long long)((length + 255) / 256) * (channels / BN) * batch;
  if (blocks256 >= 2LL * sms)
    return launch_conv<BN, 2>(x, wp, bias, res, out, batch, length, channels,
                              k, dilation, scale, acc_in, stream);
  return launch_conv<BN, 1>(x, wp, bias, res, out, batch, length, channels, k,
                            dilation, scale, acc_in, stream);
}

int launch_conv_any(const float* x, const float* wp, const float* bias,
                    const float* res, float* out, int batch, int length,
                    int channels, int k, int dilation, float scale,
                    const float* acc_in, cudaStream_t stream) {
  if (channels % 64 == 0)
    return launch_conv_rows<64>(x, wp, bias, res, out, batch, length,
                                channels, k, dilation, scale, acc_in, stream);
  if (channels % 32 == 0)
    return launch_conv_rows<32>(x, wp, bias, res, out, batch, length,
                                channels, k, dilation, scale, acc_in, stream);
  return launch_conv_rows<16>(x, wp, bias, res, out, batch, length, channels,
                              k, dilation, scale, acc_in, stream);
}

}  // namespace

// x, out: (batch, length, channels), channels a multiple of 16; weights:
// host array of n_rb * n_dil * 2 device pointers in chain order (convs1_0,
// convs2_0, convs1_1, ...) per resblock, each packed as (k, C_out, C_in);
// biases likewise; kernel_sizes[n_rb]; dilations[n_rb * n_dil]. t_buf and
// z_buf and s_buf are scratch activations of x's size.
DDSP_API int ddsp_resblock_group(const float* x, const float* const* weights,
                                 const float* const* biases,
                                 const int* kernel_sizes, const int* dilations,
                                 int n_rb, int n_dil, float* out, float* t_buf,
                                 float* z_buf, float* s_buf, int batch,
                                 int length, int channels, void* stream) {
  if ((long long)batch * length * channels == 0) return 0;
  if (channels % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int wi = 0;
  for (int rb = 0; rb < n_rb; ++rb) {
    const int k = kernel_sizes[rb];
    const float* z = x;
    for (int di = 0; di < n_dil; ++di) {
      const int d = dilations[rb * n_dil + di];
      int err = launch_conv_any(z, weights[wi], biases[wi], nullptr, t_buf,
                                batch, length, channels, k, d, 1.0f, nullptr,
                                st);
      if (err) return err;
      ++wi;
      const bool last = di == n_dil - 1;
      // the chains' running sum alternates between out and s_buf, ending
      // in out: summing in place measured slower (see the note above)
      float* sums[2] = {out, s_buf};
      float* dst = last ? sums[(n_rb - 1 - rb) % 2] : z_buf;
      const float scale = (last && rb == n_rb - 1) ? 1.0f / n_rb : 1.0f;
      const float* acc_in = (last && rb > 0) ? sums[(n_rb - rb) % 2] : nullptr;
      err = launch_conv_any(t_buf, weights[wi], biases[wi], z, dst, batch,
                            length, channels, k, 1, scale, acc_in, st);
      if (err) return err;
      ++wi;
      z = z_buf;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K2's bf16 class (B4): the same stage when the generator runs in bf16.
//
// Replaces the same Pallas kernel with x.dtype == bf16
// (pallas_resblock.py:356 _fused_group_impl: weight_dtype = x.dtype at
// :376, and _rb_group_kernel with w_ref.dtype == bf16): x is read as bf16
// and widened to f32; each conv's input gets leaky_relu(0.1) in f32
// (max(t, 0.1 t)) and the utterance's zero padding, is rounded to bf16
// once, and is multiplied by the bf16-rounded weights with f32
// accumulation, plus the f32 bias; the residuals, the sum over chains and
// the 1/n_rb of the mean stay f32, and the output is rounded to bf16 once.
//
// Bound on the H100: operations, 2 L C^2 126 flops per stage at the dense
// bf16 rate of 989.4 TFLOP/s: 0.230 / 0.115 / 0.058 / 0.029 ms at C = 128
// / 64 / 32 / 16 for a 10 s request (L C = 7,061,504 at every stage). The
// stage's own bytes (x and out in bf16, 28 MB) take 0.008 ms at 3.35 TB/s.
//
// What this replaces: a per-conv kernel (18 launches a stage) that kept t,
// z and the chains' running sums in f32 in device memory. Every stage
// moves the same L C elements, so each conv pair moved ~140 MB and a stage
// ~1.3 GB, whatever its width; that kernel took 0.61 / 0.71 / 0.91 / 1.30
// ms at C = 16 / 32 / 64 / 128 (tools/kernel_ab.py, NVIDIA H100 80GB HBM3,
// 700 W).
//
// Design, as the JAX kernel keeps a time tile in VMEM: a block owns bm
// output rows of one utterance and keeps the activation of bm rows plus
// the run's halo on the SM through a run of convs. A run is a stretch of
// one chain: the whole chain (one launch does the whole stage at C <= 64,
// chain after chain) or a conv pair; its halo is the sum of
// (k - 1) d over its convs (120 rows for a k = 11 chain). z lives in
// shared memory in f32 (the residual), and each conv's input as a bf16 A
// plane of leaky'd values, one 16-byte row per (8 channels, time row), so
// that a tap's shift by tau d - pad rows is only a descriptor's start
// address: wgmma m64nCk16 reads both operands from shared memory. Conv j
// computes the rows the later convs need (the frame shrinks by its pad at
// each end) in m64 tiles dealt to two consumer warpgroups; its epilogue
// adds the bias (and the residual), writes rows outside [0, L) as zeros
// (the 'same' padding on the whole utterance, before every conv, at both
// ends and between the rows of a batch), and writes the next conv's A
// plane in place, after both warpgroups have finished reading it. The
// weights, packed once per model as bf16 K-major core matrices
// (pack_conv_weight_bf16: a tap's C x C tile is 2 C^2 contiguous bytes),
// stream from L2 through a ring of per-tap slots, filled by one producer
// warp with bulk copies (the TMA unit) that complete on mbarriers; the
// consumers keep up to D taps' products in flight and free a slot when
// its products have been read. The sum over chains is an f32 buffer in
// device memory, read and written by the same thread at the same place
// for every chain (each chain's last conv deals the bm output rows to its
// threads in the same way); the last chain adds it, divides by n_rb and
// writes the bf16 output, so t and z never leave the SM. The host spreads
// the rows over whole waves of the card's SMs (ops/cuda_resblock.py
// fused_rows). C = 128 does not fit a chain's halo beside a useful tile (z
// alone takes 544 bytes a row), so it runs one conv pair per launch by
// design: 9 launches, z through device memory in f32 between them, the
// residual read there at the block's own rows (no z window), which leaves
// room for 240-row tiles and a 4-slot ring. One conv per launch (the
// per-conv design on this operand path, since removed) measured 1.37 ms
// against the pair's 0.92 ms at C = 128.
//
// Measured (tools/kernel_ab.py, parent and this kernel in turns on one
// NVIDIA H100 80GB HBM3 at 700 W): 0.47 / 0.50 / 0.67 / 0.92 ms at C = 16
// / 32 / 64 / 128, 2.56-2.58 ms for the four stages against 3.53-3.55 ms
// before; 6-24 % of the bound. What holds it there: small-N wgmma (N = C)
// at C <= 32, the epilogue and the barriers between convs, which the
// tensor cores wait through, and at C = 128 the weights' L2 traffic (each
// block streams all of its launch's taps: ~1 GB a stage).

#include "hopper_bf16.cuh"

namespace {

constexpr int kMaxConvs = 48;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kFusedThreads = kConsumers + 32;  // and the producer warp

// The stage's convs in chain order (per chain: conv_d0, conv_10, conv_d1,
// ...): bf16 packed weights, f32 biases, kernel sizes and dilations.
struct StageBf16 {
  const void* w[kMaxConvs];
  const float* b[kMaxConvs];
  int k[kMaxConvs];
  int d[kMaxConvs];
  int per_chain;  // convs per chain: 2 n_dil
  int n_rb;
};

struct FusedArgs {
  const __nv_bfloat16* x;  // (B, L, C)
  __nv_bfloat16* out;      // (B, L, C)
  float* acc;              // the chains' running sum, f32 (B, L, C)
  float* z_buf;            // z between launches inside a chain, f32, two
                           // halves: pair p reads half (p - 1) % 2 (its
                           // neighbours' halo rows too) and writes half p % 2
  int length;
  int c_begin, c_end;  // this launch's convs
  int bm;              // output rows per block
  int a_rows;          // rows of the A plane
  int z_rows;          // rows of the z window
  int z_global;        // runs of one pair: the residual rows are the
                       // block's own, read from device memory (no window)
};

template <int C>
struct FusedCfg;
// ring depth (per-tap slots of 2 C^2 bytes), taps in flight on the tensor
// cores before a slot is freed, m64 tiles per warpgroup, blocks per SM
template <> struct FusedCfg<16> { static constexpr int S = 16, D = 4, MT = 5, MIN_BLOCKS = 2; };
template <> struct FusedCfg<32> { static constexpr int S = 8, D = 3, MT = 3, MIN_BLOCKS = 2; };
template <> struct FusedCfg<64> { static constexpr int S = 8, D = 2, MT = 3, MIN_BLOCKS = 1; };
template <> struct FusedCfg<128> { static constexpr int S = 4, D = 1, MT = 2, MIN_BLOCKS = 1; };

// z's row stride in floats: float2 rows 32 bytes apart
template <int C>
__host__ __device__ constexpr int z_stride() { return C + 8; }

// leaky_relu in f32 and one rounding to bf16, two values packed with the
// lower channel in the low half
__device__ __forceinline__ uint32_t leaky_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, kSlope * a),
                                                 fmaxf(b, kSlope * b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void load8(const void* base, bool is_bf16,
                                      size_t idx, float (&v)[8]) {
  if (is_bf16) {
    const uint4 p = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + idx);
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float* f = reinterpret_cast<const float*>(base) + idx;
    const float4 p0 = *reinterpret_cast<const float4*>(f);
    const float4 p1 = *reinterpret_cast<const float4*>(f + 4);
    v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
    v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
  }
}

__host__ __device__ inline int conv_pad(const StageBf16& st, int c) {
  return (st.k[c] - 1) * st.d[c] / 2;
}

template <int C>
__host__ __device__ inline size_t fused_smem_bytes(int a_rows, int z_rows) {
  using F = FusedCfg<C>;
  return (size_t)F::S * 2 * C * C + 2 * F::S * 8 + (size_t)(C / 8) * a_rows * 16 +
         (size_t)z_rows * z_stride<C>() * 4;
}

template <int C>
__global__ void __launch_bounds__(kFusedThreads, FusedCfg<C>::MIN_BLOCKS)
resblock_fused_bf16_kernel(const StageBf16 st, const FusedArgs a) {
  using F = FusedCfg<C>;
  constexpr int S = F::S;
  constexpr int MT = F::MT;
  constexpr int kSlot = 2 * C * C;  // bytes of one tap's weights
  constexpr int ZS = z_stride<C>();
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kSlot);
  uint64_t* empty = full + S;
  uint8_t* a_pl = reinterpret_cast<uint8_t*>(empty + S);
  float* z_s = reinterpret_cast<float*>(a_pl + (size_t)(C / 8) * a.a_rows * 16);

  const int tid = threadIdx.x;
  const int L = a.length;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.bm;
  const size_t row0 = (size_t)b * L;  // this utterance's first row
  const size_t n_elems = (size_t)gridDim.y * L * C;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one lane streams every tap of the launch's convs
    if (tid == kConsumers) {
      int it = 0;
      for (int c = a.c_begin; c < a.c_end; ++c)
        for (int tau = 0; tau < st.k[c]; ++tau, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
          mbar_expect_tx(&full[s], kSlot);
          bulk_g2s(ring + s * kSlot,
                   reinterpret_cast<const uint8_t*>(st.w[c]) + (size_t)tau * kSlot,
                   kSlot, &full[s]);
        }
    }
    return;
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  int it = 0;  // ring position, as the producer counts it

  for (int c = a.c_begin; c < a.c_end;) {
    const int chain = c / st.per_chain;
    const int chain_end = (chain + 1) * st.per_chain;
    const int run_end = min(a.c_end, chain_end);
    int half = 0;
    for (int cc = c; cc < run_end; ++cc) half += conv_pad(st, cc);
    const int rows = a.bm + 2 * half;  // the run's frame
    const int lo = t0 - half;          // its first row in the utterance
    const int local = c - chain * st.per_chain;  // even: runs start at a pair
    // rows of z kept for residuals: those of the run's first conv_1 output
    const int zo = conv_pad(st, c) + conv_pad(st, c + 1);
    const void* z_src = (local < 2) ? (const void*)a.x
                                    : (const void*)(a.z_buf + ((local / 2 - 1) & 1) * n_elems);
    const bool z_bf16 = local < 2;

    // load the run's input: z rows [lo, lo + rows), zeros outside
    // the utterance, into the A plane (leaky, bf16) and z's window (f32);
    // a batch of items' reads is issued before any is used
    constexpr int kBatch = F::MIN_BLOCKS == 1 ? 8 : 4;  // registers allowing
    const int n_items = rows * (C / 8);
    for (int i0 = tid; i0 < n_items; i0 += kBatch * kConsumers) {
      float v[kBatch][8];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kConsumers;
        const int r = i / (C / 8);
        const int gr = lo + r;
        if (i < n_items && gr >= 0 && gr < L) {
          load8(z_src, z_bf16, (row0 + gr) * C + 8 * (i - r * (C / 8)), v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kConsumers;
        if (i >= n_items) break;
        const int r = i / (C / 8);
        const int j = i - r * (C / 8);
        *reinterpret_cast<uint4*>(a_pl + ((size_t)j * a.a_rows + r) * 16) =
            make_uint4(leaky_bf16x2(v[u][0], v[u][1]), leaky_bf16x2(v[u][2], v[u][3]),
                       leaky_bf16x2(v[u][4], v[u][5]), leaky_bf16x2(v[u][6], v[u][7]));
        if (!a.z_global && r >= zo && r < rows - zo) {
          float* zp = z_s + (size_t)(r - zo) * ZS + 8 * j;
          *reinterpret_cast<float4*>(zp) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
          *reinterpret_cast<float4*>(zp + 4) = make_float4(v[u][4], v[u][5], v[u][6], v[u][7]);
        }
      }
    }
    fence_proxy_async();  // the A plane is read by wgmma
    consumer_sync(kConsumers);

    int cum = 0;
    for (int cc = c; cc < run_end; ++cc) {
      const int kk = st.k[cc];
      const int dd = st.d[cc];
      const int pad = conv_pad(st, cc);
      const bool second = (cc - chain * st.per_chain) & 1;
      cum += pad;
      const int n_tiles = (rows - 2 * cum + 63) / 64;
      // this thread's bias columns, read while the products run (at
      // C = 128 the registers go to the accumulators: read in the epilogue)
      constexpr bool kBiasEarly = C <= 64;
      float2 bias[kBiasEarly ? C / 8 : 1];
      if constexpr (kBiasEarly)
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
          bias[j] = *reinterpret_cast<const float2*>(st.b[cc] + 8 * j + 2 * q);

      float acc[MT][C / 2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < C / 2; ++e) acc[i][e] = 0.0f;
        wgmma_fence_operand(acc[i]);
      }
      for (int tau = 0; tau < kk; ++tau, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        wgmma_fence();
        const uint8_t* wt = ring + s * kSlot;
#pragma unroll
        for (int ch = 0; ch < C / 16; ++ch) {
          // a k16 step's B tile: C / 8 groups of 8 output channels, two
          // 128-byte core matrices each (pack_conv_weight_bf16)
          const uint64_t bdesc = desc_plain(wt + ch * 32 * C, 128, 256);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int tile = wg + 2 * i;
            if (tile < n_tiles) {
              // output row r reads input row r - pad + tau d
              const int r0 = cum + 64 * tile - pad + tau * dd;
              const uint64_t adesc = desc_plain(
                  a_pl + ((size_t)(2 * ch) * a.a_rows + r0) * 16, a.a_rows * 16, 128);
              wgmma_ss<C>(acc[i], adesc, bdesc);
            }
          }
        }
        wgmma_commit();
        // up to D taps stay in flight; the slot of the tap D back is free
        wgmma_wait<F::D>();
        if (tau >= F::D && lane == 0) mbar_arrive(&empty[(it - F::D) % S]);
      }
      wgmma_wait<0>();
      if (lane == 0)
        for (int back = kk < F::D ? kk : F::D; back > 0; --back)
          mbar_arrive(&empty[(it - back) % S]);
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma_fence_operand(acc[i]);
      consumer_sync(kConsumers);  // both warpgroups are done with the plane

      const bool last = cc == run_end - 1;
      const bool at_chain_end = cc == chain_end - 1;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int tile = wg + 2 * i;
        if (tile >= n_tiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = cum + 64 * tile + 16 * warp + g + 8 * h;
          if (r >= rows - cum) continue;  // past the rows the run needs
          const int gr = lo + r;
          const bool in = gr >= 0 && gr < L;
          const size_t grow = (row0 + (in ? gr : 0)) * C;
          float2 y[C / 8];
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            const float2 bj = kBiasEarly ? bias[kBiasEarly ? j : 0]
                                         : *reinterpret_cast<const float2*>(
                                               st.b[cc] + 8 * j + 2 * q);
            y[j] = make_float2(acc[i][4 * j + 2 * h] + bj.x,
                               acc[i][4 * j + 2 * h + 1] + bj.y);
          }
          if (!second) {  // t: the next conv's A plane
#pragma unroll
            for (int j = 0; j < C / 8; ++j)
              *reinterpret_cast<uint32_t*>(a_pl + ((size_t)j * a.a_rows + r) * 16 + 4 * q) =
                  in ? leaky_bf16x2(y[j].x, y[j].y) : 0u;
            continue;
          }
          // the residual: from the z window, or (runs of a pair) from z
          // in device memory at the block's own rows, which are the only
          // rows such a run's conv_1 writes
          float* zp = a.z_global ? nullptr : z_s + (size_t)(r - zo) * ZS + 2 * q;
          if (a.z_global && !in) continue;
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            float2 z;
            if (!a.z_global)
              z = *reinterpret_cast<const float2*>(zp + 8 * j);
            else if (z_bf16)
              z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  reinterpret_cast<const __nv_bfloat16*>(z_src) + grow + 8 * j + 2 * q));
            else
              z = *reinterpret_cast<const float2*>(
                  reinterpret_cast<const float*>(z_src) + grow + 8 * j + 2 * q);
            y[j].x += z.x;
            y[j].y += z.y;
          }
          if (at_chain_end) {
            if (!in) continue;
            float* accp = a.acc + grow + 2 * q;
            if (chain > 0) {
              float2 prev[C / 8];  // every read issued before any is used
#pragma unroll
              for (int j = 0; j < C / 8; ++j)
                prev[j] = *reinterpret_cast<const float2*>(accp + 8 * j);
#pragma unroll
              for (int j = 0; j < C / 8; ++j) {
                y[j].x += prev[j].x;
                y[j].y += prev[j].y;
              }
            }
            if (chain == st.n_rb - 1) {
              const float n = (float)st.n_rb;
#pragma unroll
              for (int j = 0; j < C / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(a.out + grow + 8 * j + 2 * q) =
                    __floats2bfloat162_rn(y[j].x / n, y[j].y / n);
            } else {
#pragma unroll
              for (int j = 0; j < C / 8; ++j)
                *reinterpret_cast<float2*>(accp + 8 * j) = y[j];
            }
          } else if (last) {  // z to the next launch
            float* zb = a.z_buf + (((cc - chain * st.per_chain) / 2) & 1) * n_elems;
            if (in)
#pragma unroll
              for (int j = 0; j < C / 8; ++j)
                *reinterpret_cast<float2*>(zb + grow + 8 * j + 2 * q) = y[j];
          } else {
#pragma unroll
            for (int j = 0; j < C / 8; ++j) {
              *reinterpret_cast<float2*>(zp + 8 * j) = y[j];
              *reinterpret_cast<uint32_t*>(a_pl + ((size_t)j * a.a_rows + r) * 16 + 4 * q) =
                  in ? leaky_bf16x2(y[j].x, y[j].y) : 0u;
            }
          }
        }
      }
      fence_proxy_async();
      consumer_sync(kConsumers);
    }
    c = run_end;
  }
}

template <int C>
int launch_fused(const StageBf16& st, FusedArgs a, int batch, int per_launch,
                 cudaStream_t stream) {
  using F = FusedCfg<C>;
  const int n_convs = st.n_rb * st.per_chain;
  for (int c0 = 0; c0 < n_convs; c0 += per_launch) {
    a.c_begin = c0;
    a.c_end = c0 + per_launch;
    // the largest run's frame sizes the A plane, the z window and the tiles
    int max_read = 0, max_z = 0, max_tiles = 0;
    for (int c = a.c_begin; c < a.c_end;) {
      const int chain_end = (c / st.per_chain + 1) * st.per_chain;
      const int run_end = a.c_end < chain_end ? a.c_end : chain_end;
      int half = 0;
      for (int cc = c; cc < run_end; ++cc) half += conv_pad(st, cc);
      const int rows = a.bm + 2 * half;
      const int zo = conv_pad(st, c) + conv_pad(st, c + 1);
      max_z = max_z > rows - 2 * zo ? max_z : rows - 2 * zo;
      // the A plane's rows: the load, and every tile's reads (a conv's last
      // tile runs past its rows: the rows it reads are read, not used)
      max_read = max_read > rows ? max_read : rows;
      int cum = 0;
      for (int cc = c; cc < run_end; ++cc) {
        cum += conv_pad(st, cc);
        const int tiles = (rows - 2 * cum + 63) / 64;
        const int read = cum + conv_pad(st, cc) + 64 * tiles;
        max_read = max_read > read ? max_read : read;
        max_tiles = max_tiles > tiles ? max_tiles : tiles;
      }
      c = run_end;
    }
    a.a_rows = max_read | 1;  // odd: a warp's 16-byte rows spread over the banks
    a.z_global = per_launch == 2;
    a.z_rows = a.z_global ? 0 : max_z;
    if (max_tiles > 2 * F::MT) return (int)cudaErrorInvalidValue;
    const size_t smem = fused_smem_bytes<C>(a.a_rows, a.z_rows);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(resblock_fused_bf16_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a.length + a.bm - 1) / a.bm, batch);
    resblock_fused_bf16_kernel<C><<<grid, kFusedThreads, smem, stream>>>(st, a);
    DDSP_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

// x, out: (batch, length, channels) bf16, channels 16, 32, 64 or 128;
// weights: n_rb * n_dil * 2 device pointers in chain order, each packed as
// (k, C_in / 16, C_out / 8, 2, 8, 8) bf16; biases: f32 (C,); acc: f32
// scratch of x's element count, z_buf of twice it (unused when a launch
// holds whole chains). per_launch: convs per launch (2, 2 n_dil or the
// stage's n_rb 2 n_dil); bm: output rows per block.
DDSP_API int ddsp_resblock_group_bf16(const void* x, const void* const* weights,
                                      const float* const* biases,
                                      const int* kernel_sizes,
                                      const int* dilations, int n_rb, int n_dil,
                                      void* out, float* acc, float* z_buf,
                                      int batch, int length, int channels,
                                      int per_launch, int bm, void* stream) {
  if ((long long)batch * length * channels == 0) return 0;
  const int per_chain = 2 * n_dil;
  const int n_convs = n_rb * per_chain;
  if (n_convs > kMaxConvs || per_launch < 2 || per_launch % 2 != 0 ||
      n_convs % per_launch != 0 ||
      (per_launch > per_chain ? per_launch != n_convs : per_chain % per_launch != 0) ||
      bm < 16 || bm % 8 != 0)
    return (int)cudaErrorInvalidValue;
  StageBf16 st{};
  st.per_chain = per_chain;
  st.n_rb = n_rb;
  for (int c = 0; c < n_convs; ++c) {
    const int rb = c / per_chain, local = c % per_chain;
    st.w[c] = weights[c];
    st.b[c] = biases[c];
    st.k[c] = kernel_sizes[rb];
    st.d[c] = (local & 1) ? 1 : dilations[rb * n_dil + local / 2];
  }
  FusedArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
              acc, z_buf, length, 0, 0, bm, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 16: return launch_fused<16>(st, a, batch, per_launch, s);
    case 32: return launch_fused<32>(st, a, batch, per_launch, s);
    case 64: return launch_fused<64>(st, a, batch, per_launch, s);
    case 128: return launch_fused<128>(st, a, batch, per_launch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
