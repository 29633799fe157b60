// K4: the Sins harmonic bank.
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_oscillator.py
// (harmonic_bank_pallas -> _bank_kernel). For batch row b, frame t and
// sample n in [0, block), with x the wrapped phase in cycles and
// w = n / block:
//   out[b, t*block + n] = sum_k sin(2*pi*(k+1) * x) * (a[t][k] (1 - w) + a[t+1][k] w)
// where a[t+1] repeats the last frame of the same batch row (the linear
// upsample's edge), never the first frame of the next row.
//
// Bound on the H100: operations. A 10 s request is 56.5 M (sample,
// harmonic) pairs of a lerp, a product, a sinf and a multiply-add (the
// sinf alone is about twenty f32 instructions: a Cody-Waite reduction and
// a degree-4 polynomial), on 4 MB of input and output. The TPU tiling
// (8 frames per VMEM tile) is not carried over. Design: one block per
// (frame, batch row); its 128 threads stage the frame's two amplitude rows
// and the harmonic multipliers in shared memory as one float4 per
// harmonic, then each thread owns four samples of the frame and walks the
// harmonics, so one broadcast shared load feeds four independent sinf
// chains. x is read and out written once, coalesced. sinf, never __sinf:
// the argument reaches 2*pi*128*0.5 ~ 402 rad, where the fast intrinsic's
// error grows with the argument. The argument is one f32 product in the
// plain version's order, kept out of any contraction by __fmul_rn.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSamplesPerThread = 4;

__global__ void __launch_bounds__(kThreads)
harmonic_bank_kernel(const float* __restrict__ x, const float* __restrict__ amps,
                     float* __restrict__ out, int n_frames, int block,
                     int n_harm) {
  extern __shared__ float4 coef[];  // [n_harm]: (a_t, a_t+1, 2 pi (k+1), 0)
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_next = min(t + 1, n_frames - 1);  // edge repeat within row b
  const float* a0 = amps + ((long long)b * n_frames + t) * n_harm;
  const float* a1 = amps + ((long long)b * n_frames + t_next) * n_harm;
  for (int k = threadIdx.x; k < n_harm; k += blockDim.x) {
    // the multiplier rounded once from double, as the plain version's
    const float mult = (float)(6.283185307179586 * (double)(k + 1));
    coef[k] = make_float4(a0[k], a1[k], mult, 0.0f);
  }
  __syncthreads();

  const long long row = ((long long)b * n_frames + t) * block;
  const float fblock = (float)block;
  for (int base = 0; base < block; base += kSamplesPerThread * kThreads) {
    float xv[kSamplesPerThread], w[kSamplesPerThread];
    float omw[kSamplesPerThread], acc[kSamplesPerThread];
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      const int n = min(base + (int)threadIdx.x + j * kThreads, block - 1);
      xv[j] = x[row + n];
      w[j] = (float)n / fblock;
      omw[j] = 1.0f - w[j];
      acc[j] = 0.0f;
    }
    for (int k = 0; k < n_harm; ++k) {
      const float4 c = coef[k];
#pragma unroll
      for (int j = 0; j < kSamplesPerThread; ++j) {
        const float amp = c.x * omw[j] + c.y * w[j];
        acc[j] += sinf(__fmul_rn(c.z, xv[j])) * amp;
      }
    }
#pragma unroll
    for (int j = 0; j < kSamplesPerThread; ++j) {
      const int n = base + (int)threadIdx.x + j * kThreads;
      if (n < block) out[row + n] = acc[j];
    }
  }
}

}  // namespace

DDSP_API int ddsp_harmonic_bank(const float* x, const float* amps, float* out,
                                int batch, int n_frames, int block, int n_harm,
                                void* stream) {
  if (batch == 0 || n_frames == 0 || block == 0) return 0;
  const size_t smem = (size_t)n_harm * sizeof(float4);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // n_harm <= 3072
  dim3 grid((unsigned int)n_frames, (unsigned int)batch);
  harmonic_bank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, amps, out, n_frames, block, n_harm);
  DDSP_CHECK_LAUNCH();
  return 0;
}
