// K4: the Sins harmonic bank.
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_oscillator.py
// (harmonic_bank_pallas -> _bank_kernel). For batch row b, frame t and
// sample n in [0, block), with x the wrapped phase in cycles and
// w = n / block:
//   out[b, t*block + n] = sum_k sin(fl(2*pi*(k+1)) * x) * (a[t][k] (1 - w) + a[t+1][k] w)
// where a[t+1] repeats the last frame of the same batch row (the linear
// upsample's edge), never the first frame of the next row.
//
// Bound on the H100: operations, counted from the work and not from any
// kernel's instructions. The leanest form of the function spends three
// FMAs (6 flops) per (sample, harmonic) pair: one step of the three-term
// recurrence sin((k+2)th) = 2 cos(th) sin((k+1)th) - sin(k th), and one
// accumulation per bounding amplitude frame (the lerp factors out of the
// sum over k and is applied once per sample). A 10 s request is 56.49 M
// pairs: 0.00506 ms at 67 TFLOP/s, against 0.00119 ms for its 4.0 MB of
// input and output at 3.35 TB/s. All harmonics count, also those that
// remove_above_fmax zeroed: the kernel does not skip them.
//
// Design. Per sample, the harmonics follow the recurrence from the base
// angle th = fl(2 pi) * x (one sincosf per sample), restarted every
// kRestart = 16 harmonics from an exact sincosf of the plain version's own
// rounded argument __fmul_rn(fl(2 pi (k+1)), x): at a restart the kernel's
// sine is the plain version's, and between restarts the drift is
// O(kRestart * eps). The first step after a restart is a rotation,
// sin(a + th) = sin(a) cos(th) + cos(a) sin(th), the rest are single FMAs.
// Two accumulators, sum_k s_k a[t][k] and sum_k s_k a[t+1][k], are lerped
// once per sample. A block is one (frame, batch row): its 128 threads
// stage the two amplitude rows in shared memory as one float2 per
// harmonic, read as a broadcast, and each thread owns 4 samples of the
// frame, so four independent recurrences hide the FMA latency. The first
// restart is the base angle's own sincosf. Per pair that is 3 FMAs, a
// sixteenth of a sincosf (~2 instructions) and a quarter of a shared
// load. 4 samples x 128 threads measured faster than 8 x 64 and
// 2 x 256 (0.0156 against 0.0177 and 0.0160 ms, tools/kernel_ab.py on an
// NVIDIA H100 80GB HBM3 at 700 W). sincosf, never __sincosf: the restart
// argument reaches 2*pi*128*0.5 ~ 402 rad.
//
// Accuracy (tests/test_torch_osc_precision.py emulates this order in
// numpy f32; tolerance 3e-5 absolute against harmonic_bank_plain, the JAX
// oscillator test's bound): at the 10 s shape the emulation sits at 2.6e-6
// with chip_smoke.py's amplitudes (max|out| 0.78), 4.7e-6 with U(0, 0.02)
// amplitudes and 8.5e-6 with all 128 harmonics at 0.02 (max|out| 1.86).
// Restarts every 8 harmonics give the same 2.6e-6: that floor is the plain
// version's own argument rounding (half an ulp of up to 402 rad, ~1.5e-5
// rad per harmonic), which the recurrence does not follow between restarts.
// Every 32 harmonics reach 1.8e-5 in the all-0.02 case, every 128 1.8e-4.
// On the card (chip_smoke.py) it sits at 2.8e-6 at max|out| 0.77.
//
// bf16-amplitude mode (ddsp_harmonic_bank_bf16amp, a kernel of its own):
// the JAX Sins model in bf16 upsamples its bf16 amplitudes in bf16
// (ddsp_svc_tpu/ops/interp.py upsample on a bf16 array) before the f32
// sines multiply them, so the lerp does not factor out of the sum: per
// (sample, harmonic) the amplitude is bf16(bf16(a[t][k] (1 - w)) +
// bf16(a[t+1][k] w)) with w = bf16(bf16(n) / bf16(block)) (JAX rounds the
// weakly typed block to bf16 as well) and 1 - w rounded to bf16 too, each
// op computed in f32 and rounded as XLA's bf16 ops are; it is widened and
// accumulated against the sine in f32 in K4's order. The bound keeps K4's
// 6-flop count.
//
// What held the mode back: computed as written, each pair paid two f32
// multiplies, an f32 add and three separate roundings and widenings on
// top of the 3 FMAs, ~11 instructions against ~3 (0.0516 against 0.0155
// ms on an NVIDIA H100 80GB HBM3 at 700 W). The product of two bf16
// values is exact in f32 (16 significant bits, and no operand here is
// small enough to leave f32's subnormal grid of 2^-149), and so is the
// sum of two bf16 values whose exponents are at most 16 apart; further
// apart, the smaller is far below half a bf16 ulp of the larger and both
// roundings return the larger. So one rounding of the exact result, which
// the packed bf16x2 multiply and add of sm_90 give, is bit for bit the
// f32-op-then-round sequence (tests/test_torch_osc_precision.py proves it
// for every w and 1 - w of a 512-sample block against every positive
// bf16 amplitude, and for sums).
// Design: the block stages the two frames' amplitudes in shared memory as
// bf16 pairs of harmonics (a uint2 per pair: frame t's pair, frame t+1's
// pair; half of the f32 mode's staging), each sample broadcasts its w and
// 1 - w into both lanes of a bf16x2, and two harmonics' amplitudes take
// mul.rn.bf16x2, mul.rn.bf16x2, add.rn.bf16x2 (explicit rounding, so never
// contracted into an fma, which would round once where JAX rounds twice)
// and two widenings: ~4.5 instructions a pair. The sines and the f32
// accumulation are the f32 mode's, in the same fmaf order, so the output
// is that of the f32-op version bit for bit. Measured against that
// version in turns on one card (tools/kernel_ab.py): 0.0188 ms against
// 0.0520 at the 10 s shape, the same output digest.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSamples = 4;    // per thread
constexpr int kRestart = 16;   // harmonics per exact sincosf

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One (sample, harmonic) pair's accumulation of the sine s into both
// frames' sums (lerped once per sample at the end).
__device__ __forceinline__ void accumulate(float s, float2 a, float& acc0,
                                           float& acc1) {
  acc0 = fmaf(s, a.x, acc0);
  acc1 = fmaf(s, a.y, acc1);
}

// Harmonics 2 .. count-1 of a segment (i counts from the restart): the
// three-term recurrence and the accumulations.
template <int kFixed>
__device__ __forceinline__ void recur(const float2* __restrict__ coef, int count,
                                      const float (&two_c)[kSamples],
                                      float (&s)[kSamples], float (&sp)[kSamples],
                                      float (&acc0)[kSamples],
                                      float (&acc1)[kSamples]) {
#pragma unroll
  for (int i = 2; i < (kFixed > 0 ? kFixed : count); ++i) {
    const float2 a = coef[i];
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const float next = fmaf(two_c[j], s[j], -sp[j]);
      sp[j] = s[j];
      s[j] = next;
      accumulate(next, a, acc0[j], acc1[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
harmonic_bank_kernel(const float* __restrict__ x, const float* __restrict__ amps,
                     float* __restrict__ out, int n_frames, int block,
                     int n_harm) {
  extern __shared__ float2 coef[];  // [n_harm]: (a_t[k], a_t+1[k])
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_next = min(t + 1, n_frames - 1);  // edge repeat within row b
  const float* a0 = amps + ((long long)b * n_frames + t) * n_harm;
  const float* a1 = amps + ((long long)b * n_frames + t_next) * n_harm;
  for (int k = threadIdx.x; k < n_harm; k += kThreads)
    coef[k] = make_float2(a0[k], a1[k]);
  __syncthreads();

  const long long row = ((long long)b * n_frames + t) * block;
  const float fblock = (float)block;
  // the multipliers rounded once from double, as the plain version's
  const float m0 = (float)6.283185307179586;
  for (int base = 0; base < block; base += kSamples * kThreads) {
    float xv[kSamples], s1[kSamples], c1[kSamples], two_c[kSamples];
    float s[kSamples], sp[kSamples], co[kSamples];
    float acc0[kSamples], acc1[kSamples];
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const int n = min(base + (int)threadIdx.x + j * kThreads, block - 1);
      xv[j] = x[row + n];
      sincosf(__fmul_rn(m0, xv[j]), &s1[j], &c1[j]);
      two_c[j] = 2.0f * c1[j];
      acc0[j] = 0.0f;
      acc1[j] = 0.0f;
    }
    for (int k0 = 0; k0 < n_harm; k0 += kRestart) {
      const float m = (float)(6.283185307179586 * (double)(k0 + 1));
      const int count = min(kRestart, n_harm - k0);
      const float2 a = coef[k0];
#pragma unroll
      for (int j = 0; j < kSamples; ++j) {
        if (k0 == 0) {  // the first restart's argument is the base angle
          s[j] = s1[j];
          co[j] = c1[j];
        } else {
          sincosf(__fmul_rn(m, xv[j]), &s[j], &co[j]);
        }
        accumulate(s[j], a, acc0[j], acc1[j]);
      }
      if (count > 1) {
        const float2 a_1 = coef[k0 + 1];
#pragma unroll
        for (int j = 0; j < kSamples; ++j) {
          sp[j] = s[j];
          s[j] = fmaf(s[j], c1[j], __fmul_rn(co[j], s1[j]));
          accumulate(s[j], a_1, acc0[j], acc1[j]);
        }
      }
      if (count == kRestart)
        recur<kRestart>(coef + k0, count, two_c, s, sp, acc0, acc1);
      else
        recur<0>(coef + k0, count, two_c, s, sp, acc0, acc1);
    }
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const int n = base + (int)threadIdx.x + j * kThreads;
      if (n >= block) continue;
      const float wl = (float)n / fblock;
      out[row + n] = fmaf(acc0[j], 1.0f - wl, __fmul_rn(acc1[j], wl));
    }
  }
}

// ---------------------------------------------------------------- bf16 mode

// packed bf16x2 arithmetic, one round to nearest even per op (sm_90)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The upsampled amplitudes of one pair of harmonics at one sample,
// bf16(bf16(a_t (1 - w)) + bf16(a_t+1 w)) in each lane, widened: c.x holds
// frame t's pair, c.y frame t+1's (the lower harmonic in the low half).
__device__ __forceinline__ float2 amp_pair(uint2 c, uint32_t w2, uint32_t omw2) {
  const uint32_t v = bf16x2_add(bf16x2_mul(c.x, omw2), bf16x2_mul(c.y, w2));
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Harmonics 2 .. count-1 of a segment in the bf16 mode: the recurrence of
// the f32 mode, the amplitudes of each even harmonic and its successor
// made together.
template <int kFixed>
__device__ __forceinline__ void recur_bf16(const uint2* __restrict__ coef, int count,
                                           const float (&two_c)[kSamples],
                                           const uint32_t (&w2)[kSamples],
                                           const uint32_t (&omw2)[kSamples],
                                           float (&s)[kSamples], float (&sp)[kSamples],
                                           float (&acc)[kSamples]) {
  float2 amp[kSamples];
#pragma unroll
  for (int i = 2; i < (kFixed > 0 ? kFixed : count); ++i) {
    if ((i & 1) == 0) {
      const uint2 c = coef[i >> 1];
#pragma unroll
      for (int j = 0; j < kSamples; ++j) amp[j] = amp_pair(c, w2[j], omw2[j]);
    }
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const float next = fmaf(two_c[j], s[j], -sp[j]);
      sp[j] = s[j];
      s[j] = next;
      acc[j] = fmaf(next, (i & 1) ? amp[j].y : amp[j].x, acc[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
harmonic_bank_kernel_bf16amp(const float* __restrict__ x,
                             const unsigned short* __restrict__ amps,
                             float* __restrict__ out, int n_frames, int block,
                             int n_harm) {
  // [ceil(n_harm / 2)]: (frame t's pair, frame t+1's pair) of harmonics
  // 2p, 2p + 1 as bf16x2; a missing last harmonic is zero
  extern __shared__ uint2 coef2[];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_next = min(t + 1, n_frames - 1);  // edge repeat within row b
  const unsigned short* a0 = amps + ((long long)b * n_frames + t) * n_harm;
  const unsigned short* a1 = amps + ((long long)b * n_frames + t_next) * n_harm;
  for (int p = threadIdx.x; 2 * p < n_harm; p += kThreads) {
    const int k = 2 * p;
    const bool two = k + 1 < n_harm;
    coef2[p] = make_uint2((uint32_t)a0[k] | (two ? (uint32_t)a0[k + 1] << 16 : 0u),
                          (uint32_t)a1[k] | (two ? (uint32_t)a1[k + 1] << 16 : 0u));
  }
  __syncthreads();

  const long long row = ((long long)b * n_frames + t) * block;
  const float fblock = bf16_round((float)block);
  const float m0 = (float)6.283185307179586;
  for (int base = 0; base < block; base += kSamples * kThreads) {
    float xv[kSamples], s1[kSamples], c1[kSamples], two_c[kSamples];
    float s[kSamples], sp[kSamples], co[kSamples], acc[kSamples];
    uint32_t w2[kSamples], omw2[kSamples];
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const int n = min(base + (int)threadIdx.x + j * kThreads, block - 1);
      // the bf16 upsample's weights of sample n, in both lanes
      const float w = bf16_round(__fdiv_rn(bf16_round((float)n), fblock));
      const float omw = bf16_round(1.0f - w);
      w2[j] = (__float_as_uint(w) >> 16) * 0x10001u;
      omw2[j] = (__float_as_uint(omw) >> 16) * 0x10001u;
      xv[j] = x[row + n];
      sincosf(__fmul_rn(m0, xv[j]), &s1[j], &c1[j]);
      two_c[j] = 2.0f * c1[j];
      acc[j] = 0.0f;
    }
    for (int k0 = 0; k0 < n_harm; k0 += kRestart) {
      const float m = (float)(6.283185307179586 * (double)(k0 + 1));
      const int count = min(kRestart, n_harm - k0);
      const uint2 c = coef2[k0 >> 1];  // kRestart is even: k0 starts a pair
#pragma unroll
      for (int j = 0; j < kSamples; ++j) {
        if (k0 == 0) {  // the first restart's argument is the base angle
          s[j] = s1[j];
          co[j] = c1[j];
        } else {
          sincosf(__fmul_rn(m, xv[j]), &s[j], &co[j]);
        }
        const float2 amp = amp_pair(c, w2[j], omw2[j]);
        acc[j] = fmaf(s[j], amp.x, acc[j]);
        if (count > 1) {
          sp[j] = s[j];
          s[j] = fmaf(s[j], c1[j], __fmul_rn(co[j], s1[j]));
          acc[j] = fmaf(s[j], amp.y, acc[j]);
        }
      }
      if (count == kRestart)
        recur_bf16<kRestart>(coef2 + (k0 >> 1), count, two_c, w2, omw2, s, sp, acc);
      else
        recur_bf16<0>(coef2 + (k0 >> 1), count, two_c, w2, omw2, s, sp, acc);
    }
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
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
  const size_t smem = (size_t)n_harm * sizeof(float2);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // n_harm <= 6144
  dim3 grid((unsigned int)n_frames, (unsigned int)batch);
  harmonic_bank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, amps, out, n_frames, block, n_harm);
  DDSP_CHECK_LAUNCH();
  return 0;
}

// amps: bf16 (B, T, n_harm), upsampled as JAX's bf16 upsample (see above)
DDSP_API int ddsp_harmonic_bank_bf16amp(const float* x, const void* amps,
                                        float* out, int batch, int n_frames,
                                        int block, int n_harm, void* stream) {
  if (batch == 0 || n_frames == 0 || block == 0) return 0;
  const size_t smem = (size_t)((n_harm + 1) / 2) * sizeof(uint2);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // n_harm <= 12288
  dim3 grid((unsigned int)n_frames, (unsigned int)batch);
  harmonic_bank_kernel_bf16amp<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, static_cast<const unsigned short*>(amps), out, n_frames, block, n_harm);
  DDSP_CHECK_LAUNCH();
  return 0;
}
