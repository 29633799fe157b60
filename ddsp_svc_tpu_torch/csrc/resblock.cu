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
// (pallas_resblock.py _fused_group_impl: weight_dtype = x.dtype, and
// _rb_group_kernel with w_ref.dtype == bf16): x is read as bf16 and widened
// to f32; each conv's input gets leaky_relu(0.1) in f32 (max(t, 0.1 t)) and
// the utterance's zero padding, is rounded to bf16 once, and is multiplied
// by the bf16-rounded weights with f32 accumulation, plus the f32 bias; the
// residuals, the sum over chains and the 1/n_rb of the mean stay f32, and
// the output is rounded to bf16 once. The intermediates (t, z and the
// chains' running sums) stay f32 in device memory: rounding them to bf16
// there would be another function.
//
// Bound on the H100: operations, 2*L*C^2*126 flops per stage at the dense
// bf16 rate of 989.4 TFLOP/s (the activations are 6 to 18 bytes per
// element against C*126*2 flops).
//
// Design: the f32 kernel's structure with bf16 operands. A ring stage holds
// 16 input channels (one k16 step) of BM + (k-1)*d rows as they are stored
// (f32 or bf16) and the k B tiles, packed once per model as bf16 K-major
// core matrices (8 output channels x 8 input channels, 16 bytes a row:
// pack_conv_weight_bf16), so a tile is one contiguous copy. Once a stage
// has landed, one pass applies leaky_relu in f32 and rounds to bf16 into an
// A plane with the same 32-byte rows and swizzle as the f32 kernel's, so
// one ldmatrix.x4 loads a warp's m16k16 A fragment and one wgmma
// m64nBNk16 (bf16 in, f32 accumulators) takes each tap, where split TF32
// takes three. Four launches per resblock chain pair as in the f32 path;
// the stage's 18 launches are counted as one.

#include <cuda_bf16.h>

namespace {

constexpr int KC16 = 16;  // input channels per ring stage: one k16 step

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1)
      : "memory");
}

// leaky_relu in f32 and one rounding to bf16, two values packed as wgmma's
// A operand takes them (the lower channel in the low half)
__device__ __forceinline__ uint32_t leaky_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, kSlope * a),
                                                 fmaxf(b, kSlope * b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// words of one ring stage: the k B tiles ([k][BN / 8][2][8][8] bf16), the
// bf16 A plane ([rows_in][8] words, swizzled as swz), then the staged input
// as it is stored ([rows_in][16] elements of 4 or 2 bytes)
__host__ __device__ constexpr int stage_words_bf16(int rows_in, int k, int bn,
                                                   bool in_bf16) {
  return k * bn * 8 + rows_in * 8 + rows_in * (in_bf16 ? 8 : 16);
}

// One conv of the chain: out = scale * (conv(leaky(in)) + bias + res +
// acc_in), the product in bf16 with f32 accumulation. in: f32, or bf16
// with kInBf16; res (optional) f32 or bf16 (res_bf16); acc_in (optional)
// f32; out f32 or bf16 (out_bf16).
template <int BN, int MT, bool kInBf16>
__global__ void __launch_bounds__(kThreads)
resblock_conv_bf16_kernel(const void* __restrict__ x,
                          const uint32_t* __restrict__ wp,
                          const float* __restrict__ bias, const void* res,
                          int res_bf16, void* out, int out_bf16, int length,
                          int channels, int k, int dilation, float scale,
                          const float* acc_in) {
  using T = ConvTile<BN, MT>;
  extern __shared__ float4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int halo = (k - 1) * dilation;
  const int pad = halo / 2;
  const int rows_in = T::BM + halo;
  const int stage_w = stage_words_bf16(rows_in, k, BN, kInBf16);
  const int b_words = k * BN * 8;  // a stage's B tiles
  constexpr int kTileWords = BN * 8;  // one tap's B tile
  const int n_chunks = channels / KC16;
  constexpr int kElem = kInBf16 ? 2 : 4;
  constexpr int kRowVec = KC16 * kElem / 16;  // 16-byte copies per row

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int row0 = (tid >> 7) * MT * 64 + 16 * warp;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int t0 = blockIdx.x * T::BM;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const char* xb = reinterpret_cast<const char*>(x) +
                   (size_t)b * length * channels * kElem;

  auto stage = [&](int chunk, int buf) {
    uint32_t* w_s = smem + buf * stage_w;
    uint32_t* raw = w_s + b_words + rows_in * 8;
    const int ci0 = chunk * KC16;
    for (int i = tid; i < rows_in * kRowVec; i += kThreads) {
      const int r = i / kRowVec;
      const int v = i - r * kRowVec;
      const int t = t0 - pad + r;
      const bool ok = t >= 0 && t < length;
      const char* src =
          ok ? xb + ((size_t)t * channels + ci0) * kElem + 16 * v : xb;
      cp_async16(raw + r * (KC16 * kElem / 4) + 4 * v, src, ok);
    }
    constexpr int kVec = kTileWords / 4;
    for (int i = tid; i < k * kVec; i += kThreads) {
      const int tau = i / kVec;
      const int v = i - tau * kVec;
      const size_t src =
          (((size_t)tau * n_chunks + chunk) * channels + co0) * 8 + 4 * v;
      cp_async16(w_s + tau * kTileWords + 4 * v, wp + src, true);
    }
  };

  float acc[MT][T::NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[mt][i] = 0.0f;

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
    uint32_t* b_s = smem + (ch & 1) * stage_w;
    uint32_t* a_s = b_s + b_words;
    const uint32_t* raw = a_s + rows_in * 8;
    // leaky_relu in f32 and the bf16 rounding, once per staged element:
    // eight channels (16 bytes of the A plane) per item
    for (int i = tid; i < rows_in * 2; i += kThreads) {
      const int r = i >> 1;
      const int h = i & 1;
      float v[8];
      if constexpr (kInBf16) {
        const uint4 p = *reinterpret_cast<const uint4*>(raw + r * 8 + 4 * h);
        const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j] = __uint_as_float(w[j] << 16);
          v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      } else {
        const float4 p0 =
            *reinterpret_cast<const float4*>(raw + r * 16 + 8 * h);
        const float4 p1 =
            *reinterpret_cast<const float4*>(raw + r * 16 + 8 * h + 4);
        v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
        v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
      }
      *reinterpret_cast<uint4*>(a_s + swz(r, h)) =
          make_uint4(leaky_bf16x2(v[0], v[1]), leaky_bf16x2(v[2], v[3]),
                     leaky_bf16x2(v[4], v[5]), leaky_bf16x2(v[6], v[7]));
    }
    fence_proxy_async();  // the B tiles are read by wgmma
    __syncthreads();
    for (int tau = 0; tau < k; ++tau) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], reinterpret_cast<const float*>(
                               a_s + swz(a_row + tau * dilation + 64 * mt,
                                         a_half)));
      // core matrices of 8 n-rows x 16 bytes: 128 bytes apart along K,
      // 256 bytes apart along N
      const uint64_t b_desc = wgmma_desc(b_s + tau * kTileWords, 128, 256);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_fence_operand(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_bf16<BN>(acc[mt], a[mt], b_desc);
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
          float2 r;
          if (res_bf16)
            r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                reinterpret_cast<const __nv_bfloat16*>(res) + row + co));
          else
            r = *reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(res) + row + co);
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
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              reinterpret_cast<__nv_bfloat16*>(out) + row + co) =
              __floats2bfloat162_rn(y.x, y.y);
        else
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + row +
                                     co) = y;
      }
    }
  }
}

struct ConvBf16Args {
  const void* in;
  bool in_bf16;
  const uint32_t* wp;
  const float* bias;
  const void* res;
  bool res_bf16;
  void* out;
  bool out_bf16;
  int k, dilation;
  float scale;
  const float* acc_in;
};

template <int BN, int MT, bool kInBf16>
int launch_conv_bf16(const ConvBf16Args& a, int batch, int length,
                     int channels, cudaStream_t stream) {
  using T = ConvTile<BN, MT>;
  const int rows_in = T::BM + (a.k - 1) * a.dilation;
  const size_t smem =
      2 * (size_t)stage_words_bf16(rows_in, a.k, BN, kInBf16) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resblock_conv_bf16_kernel<BN, MT, kInBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((length + T::BM - 1) / T::BM, channels / BN, batch);
  resblock_conv_bf16_kernel<BN, MT, kInBf16><<<grid, kThreads, smem, stream>>>(
      a.in, a.wp, a.bias, a.res, a.res_bf16 ? 1 : 0, a.out,
      a.out_bf16 ? 1 : 0, length, channels, a.k, a.dilation, a.scale,
      a.acc_in);
  DDSP_CHECK_LAUNCH();
  return 0;
}

template <int BN>
int launch_conv_bf16_rows(const ConvBf16Args& a, int batch, int length,
                          int channels, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long blocks256 =
      (long long)((length + 255) / 256) * (channels / BN) * batch;
  const bool big = blocks256 >= 2LL * sms;
  if (a.in_bf16)
    return big ? launch_conv_bf16<BN, 2, true>(a, batch, length, channels, stream)
               : launch_conv_bf16<BN, 1, true>(a, batch, length, channels, stream);
  return big ? launch_conv_bf16<BN, 2, false>(a, batch, length, channels, stream)
             : launch_conv_bf16<BN, 1, false>(a, batch, length, channels, stream);
}

int launch_conv_bf16_any(const ConvBf16Args& a, int batch, int length,
                         int channels, cudaStream_t stream) {
  if (channels % 64 == 0)
    return launch_conv_bf16_rows<64>(a, batch, length, channels, stream);
  if (channels % 32 == 0)
    return launch_conv_bf16_rows<32>(a, batch, length, channels, stream);
  return launch_conv_bf16_rows<16>(a, batch, length, channels, stream);
}

}  // namespace

// x, out: (batch, length, channels) bf16, channels a multiple of 16;
// weights: n_rb * n_dil * 2 device pointers in chain order, each packed as
// (k, C_in / 16, C_out / 8, 2, 8, 8) bf16; biases: f32 (C,); t_buf and
// z_buf f32 scratch of x's element count, s_buf f32 scratch of twice it
// (the chains' running sums).
DDSP_API int ddsp_resblock_group_bf16(const void* x,
                                      const void* const* weights,
                                      const float* const* biases,
                                      const int* kernel_sizes,
                                      const int* dilations, int n_rb,
                                      int n_dil, void* out, float* t_buf,
                                      float* z_buf, float* s_buf, int batch,
                                      int length, int channels, void* stream) {
  const long long n = (long long)batch * length * channels;
  if (n == 0) return 0;
  if (channels % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sums[2] = {s_buf, s_buf + n};
  int wi = 0;
  for (int rb = 0; rb < n_rb; ++rb) {
    const int k = kernel_sizes[rb];
    for (int di = 0; di < n_dil; ++di) {
      const int d = dilations[rb * n_dil + di];
      const bool first = di == 0;  // z is x itself (bf16)
      ConvBf16Args c1{first ? x : (const void*)z_buf, first,
                      (const uint32_t*)weights[wi], biases[wi], nullptr, false,
                      t_buf, false, k, d, 1.0f, nullptr};
      int err = launch_conv_bf16_any(c1, batch, length, channels, st);
      if (err) return err;
      ++wi;
      const bool last = di == n_dil - 1;
      const bool final_chain = rb == n_rb - 1;
      void* dst = !last ? (void*)z_buf
                        : (final_chain ? out : (void*)sums[rb % 2]);
      ConvBf16Args c2{t_buf, false, (const uint32_t*)weights[wi], biases[wi],
                      first ? x : (const void*)z_buf, first, dst,
                      last && final_chain, k, 1,
                      (last && final_chain) ? 1.0f / n_rb : 1.0f,
                      (last && rb > 0) ? sums[(rb - 1) % 2] : nullptr};
      err = launch_conv_bf16_any(c2, batch, length, channels, st);
      if (err) return err;
      ++wi;
    }
  }
  return 0;
}
