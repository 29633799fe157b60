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
// sum of the 18 convs' taps) on 8*L*C bytes of activation in and out; at
// C >= 16 that is >= 250 flop/byte, above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte). Design (simple and right first): one direct
// dilated conv kernel, launched 18 times per stage. A block computes a tile
// of TT output rows x TCO output channels (4x4 per thread, 256 threads) and
// walks the input channels in chunks of 16: each chunk stages TT + halo
// input rows (leaky_relu applied as they load, zeros outside the
// utterance) and the chunk's k x 16 x TCO weights in shared memory, so
// C = 256, k = 11, d = 5 needs 53 KB. The epilogue adds the bias and,
// optionally, the residual; the last conv of each chain accumulates into
// the stage output and the last chain applies the 1/n_rb of the mean, so
// no sum is finished outside the kernels. The TPU kernel's band-matrix
// lane packing is a TPU layout device and is not carried over, and unlike
// the TPU path (C <= 128 only) this kernel runs on all five stages.
// Backward (training) is not here: it stays the stock conv chain.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCC = 16;             // input channels per shared-memory chunk
constexpr int kInStride = kCC + 1;  // padded rows: no bank conflicts on reads
constexpr float kSlope = 0.1f;

template <int TCO>
struct Tile {
  static constexpr int TT = 4096 / TCO;  // output rows per block
  static constexpr int TX = TCO / 4;     // threads across output channels
};

template <int TCO>
__global__ void __launch_bounds__(kThreads)
resblock_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* res,
                     float* out, int length, int channels, int k,
                     int dilation, float scale, int accumulate) {
  constexpr int TT = Tile<TCO>::TT;
  constexpr int TX = Tile<TCO>::TX;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned base
  float* smem = reinterpret_cast<float*>(smem4);
  const int halo = (k - 1) * dilation;
  const int pad = halo / 2;
  const int rows_in = TT + halo;
  float* w_s = smem;                   // [k][kCC][TCO]
  float* in_s = smem + k * kCC * TCO;  // [rows_in][kInStride]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * length * channels;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int wtile = kCC * k;
  for (int ci0 = 0; ci0 < channels; ci0 += kCC) {
    for (int idx = tid; idx < rows_in * kCC; idx += kThreads) {
      int r = idx / kCC;
      int c = idx - r * kCC;
      int t = t0 - pad + r;
      int ci = ci0 + c;
      float v = 0.0f;
      if (t >= 0 && t < length && ci < channels) {
        v = xb[(size_t)t * channels + ci];
        v = v >= 0.0f ? v : kSlope * v;
      }
      in_s[r * kInStride + c] = v;
    }
    // weights from the torch Conv1d layout (Cout, Cin, k)
    for (int idx = tid; idx < TCO * wtile; idx += kThreads) {
      int co = idx / wtile;
      int rem = idx - co * wtile;
      int c = rem / k;
      int tau = rem - c * k;
      float v = 0.0f;
      if (co0 + co < channels && ci0 + c < channels)
        v = w[((size_t)(co0 + co) * channels + ci0 + c) * k + tau];
      w_s[(tau * kCC + c) * TCO + co] = v;
    }
    __syncthreads();
    for (int tau = 0; tau < k; ++tau) {
      const float* in_row = in_s + (ty * 4 + tau * dilation) * kInStride;
      const float* w_row = w_s + tau * kCC * TCO + tx * 4;
#pragma unroll
      for (int c = 0; c < kCC; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(w_row + c * TCO);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = in_row[i * kInStride + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wr[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= length) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co >= channels) continue;
      const size_t o = ((size_t)b * length + t) * channels + co;
      float y = acc[i][j] + bias[co];
      if (res != nullptr) y += res[o];
      if (accumulate) y += out[o];
      out[o] = y * scale;
    }
  }
}

template <int TCO>
int launch_conv(const float* x, const float* w, const float* bias,
                const float* res, float* out, int batch, int length,
                int channels, int k, int dilation, float scale, int accumulate,
                cudaStream_t stream) {
  constexpr int TT = Tile<TCO>::TT;
  const int halo = (k - 1) * dilation;
  const size_t smem =
      (size_t)(k * kCC * TCO + (TT + halo) * kInStride) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resblock_conv_kernel<TCO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((length + TT - 1) / TT, (channels + TCO - 1) / TCO, batch);
  resblock_conv_kernel<TCO><<<grid, kThreads, smem, stream>>>(
      x, w, bias, res, out, length, channels, k, dilation, scale, accumulate);
  DDSP_CHECK_LAUNCH();
  return 0;
}

int launch_conv_any(const float* x, const float* w, const float* bias,
                    const float* res, float* out, int batch, int length,
                    int channels, int k, int dilation, float scale,
                    int accumulate, cudaStream_t stream) {
  if (channels >= 64)
    return launch_conv<64>(x, w, bias, res, out, batch, length, channels, k,
                           dilation, scale, accumulate, stream);
  if (channels >= 32)
    return launch_conv<32>(x, w, bias, res, out, batch, length, channels, k,
                           dilation, scale, accumulate, stream);
  return launch_conv<16>(x, w, bias, res, out, batch, length, channels, k,
                         dilation, scale, accumulate, stream);
}

}  // namespace

// x, out: (batch, length, channels); weights/biases: host arrays of
// n_rb * n_dil * 2 device pointers in chain order (convs1_0, convs2_0,
// convs1_1, ...) per resblock; kernel_sizes[n_rb]; dilations[n_rb * n_dil].
// t_buf and z_buf are scratch activations of x's size.
DDSP_API int ddsp_resblock_group(const float* x, const float* const* weights,
                                 const float* const* biases,
                                 const int* kernel_sizes, const int* dilations,
                                 int n_rb, int n_dil, float* out, float* t_buf,
                                 float* z_buf, int batch, int length,
                                 int channels, void* stream) {
  if ((long long)batch * length * channels == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int wi = 0;
  for (int rb = 0; rb < n_rb; ++rb) {
    const int k = kernel_sizes[rb];
    const float* z = x;
    for (int di = 0; di < n_dil; ++di) {
      const int d = dilations[rb * n_dil + di];
      int err = launch_conv_any(z, weights[wi], biases[wi], nullptr, t_buf,
                                batch, length, channels, k, d, 1.0f, 0, st);
      if (err) return err;
      ++wi;
      const bool last = di == n_dil - 1;
      float* dst = last ? out : z_buf;
      const float scale = (last && rb == n_rb - 1) ? 1.0f / n_rb : 1.0f;
      const int accumulate = (last && rb > 0) ? 1 : 0;
      err = launch_conv_any(t_buf, weights[wi], biases[wi], z, dst, batch,
                            length, channels, k, 1, scale, accumulate, st);
      if (err) return err;
      ++wi;
      z = z_buf;
    }
  }
  return 0;
}
