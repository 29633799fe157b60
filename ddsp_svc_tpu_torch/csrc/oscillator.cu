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
// bf16-amplitude mode (ddsp_harmonic_bank_bf16amp): the JAX Sins model in
// bf16 upsamples its bf16 amplitudes in bf16 (ddsp_svc_tpu/ops/interp.py
// upsample on a bf16 array) before the f32 sines multiply them, so the
// lerp does not factor out of the sum: per (sample, harmonic) the
// amplitude is bf16(bf16(a[t][k] (1 - w)) + bf16(a[t+1][k] w)) with
// w = bf16(bf16(n) / bf16(block)) (JAX rounds the weakly typed block to
// bf16 as well) and 1 - w rounded to bf16 too, each op
// computed in f32 and rounded as XLA's bf16 ops are; it is widened and
// accumulated against the sine in f32. The amplitudes are read as bf16.
// Per pair that adds two multiplies, an add and three roundings to the
// 3 FMAs; the bound keeps the 6-flop count.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSamples = 4;    // per thread
constexpr int kRestart = 16;   // harmonics per exact sincosf

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One (sample, harmonic) pair's accumulation of the sine s. f32 mode: into
// both frames' sums (lerped once per sample at the end). bf16 mode: the
// bf16 upsampled amplitude (w and 1 - w of this sample) into acc0 alone.
template <bool kBf16>
__device__ __forceinline__ void accumulate(float s, float2 a, float w, float omw,
                                           float& acc0, float& acc1) {
  if (kBf16) {
    const float amp = bf16_round(bf16_round(a.x * omw) + bf16_round(a.y * w));
    acc0 = fmaf(s, amp, acc0);
  } else {
    acc0 = fmaf(s, a.x, acc0);
    acc1 = fmaf(s, a.y, acc1);
  }
}

// Harmonics 2 .. count-1 of a segment (i counts from the restart): the
// three-term recurrence and the accumulations.
template <int kFixed, bool kBf16>
__device__ __forceinline__ void recur(const float2* __restrict__ coef, int count,
                                      const float (&two_c)[kSamples],
                                      const float (&w)[kSamples],
                                      const float (&omw)[kSamples],
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
      accumulate<kBf16>(next, a, w[j], omw[j], acc0[j], acc1[j]);
    }
  }
}

template <typename Amp>
__global__ void __launch_bounds__(kThreads)
harmonic_bank_kernel(const float* __restrict__ x, const Amp* __restrict__ amps,
                     float* __restrict__ out, int n_frames, int block,
                     int n_harm) {
  constexpr bool kBf16 = sizeof(Amp) == 2;
  extern __shared__ float2 coef[];  // [n_harm]: (a_t[k], a_t+1[k])
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int t_next = min(t + 1, n_frames - 1);  // edge repeat within row b
  const Amp* a0 = amps + ((long long)b * n_frames + t) * n_harm;
  const Amp* a1 = amps + ((long long)b * n_frames + t_next) * n_harm;
  for (int k = threadIdx.x; k < n_harm; k += kThreads)
    coef[k] = make_float2(widen(a0[k]), widen(a1[k]));
  __syncthreads();

  const long long row = ((long long)b * n_frames + t) * block;
  const float fblock = (float)block;
  // the multipliers rounded once from double, as the plain version's
  const float m0 = (float)6.283185307179586;
  for (int base = 0; base < block; base += kSamples * kThreads) {
    float xv[kSamples], s1[kSamples], c1[kSamples], two_c[kSamples];
    float s[kSamples], sp[kSamples], co[kSamples];
    float acc0[kSamples], acc1[kSamples], w[kSamples], omw[kSamples];
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const int n = min(base + (int)threadIdx.x + j * kThreads, block - 1);
      if (kBf16) {  // the bf16 upsample's weights of sample n
        w[j] = bf16_round(__fdiv_rn(bf16_round((float)n), bf16_round(fblock)));
        omw[j] = bf16_round(1.0f - w[j]);
      } else {
        w[j] = 0.0f;
        omw[j] = 0.0f;
      }
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
        accumulate<kBf16>(s[j], a, w[j], omw[j], acc0[j], acc1[j]);
      }
      if (count > 1) {
        const float2 a_1 = coef[k0 + 1];
#pragma unroll
        for (int j = 0; j < kSamples; ++j) {
          sp[j] = s[j];
          s[j] = fmaf(s[j], c1[j], __fmul_rn(co[j], s1[j]));
          accumulate<kBf16>(s[j], a_1, w[j], omw[j], acc0[j], acc1[j]);
        }
      }
      if (count == kRestart)
        recur<kRestart, kBf16>(coef + k0, count, two_c, w, omw, s, sp, acc0, acc1);
      else
        recur<0, kBf16>(coef + k0, count, two_c, w, omw, s, sp, acc0, acc1);
    }
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const int n = base + (int)threadIdx.x + j * kThreads;
      if (n >= block) continue;
      if (kBf16) {
        out[row + n] = acc0[j];
      } else {
        const float wl = (float)n / fblock;
        out[row + n] = fmaf(acc0[j], 1.0f - wl, __fmul_rn(acc1[j], wl));
      }
    }
  }
}

}  // namespace

template <typename Amp>
static int launch_bank(const float* x, const Amp* amps, float* out, int batch,
                       int n_frames, int block, int n_harm, void* stream) {
  if (batch == 0 || n_frames == 0 || block == 0) return 0;
  const size_t smem = (size_t)n_harm * sizeof(float2);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // n_harm <= 6144
  dim3 grid((unsigned int)n_frames, (unsigned int)batch);
  harmonic_bank_kernel<Amp><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, amps, out, n_frames, block, n_harm);
  DDSP_CHECK_LAUNCH();
  return 0;
}

DDSP_API int ddsp_harmonic_bank(const float* x, const float* amps, float* out,
                                int batch, int n_frames, int block, int n_harm,
                                void* stream) {
  return launch_bank(x, amps, out, batch, n_frames, block, n_harm, stream);
}

// amps: bf16 (B, T, n_harm), upsampled as JAX's bf16 upsample (see above)
DDSP_API int ddsp_harmonic_bank_bf16amp(const float* x, const void* amps,
                                        float* out, int batch, int n_frames,
                                        int block, int n_harm, void* stream) {
  return launch_bank(x, static_cast<const __nv_bfloat16*>(amps), out, batch,
                     n_frames, block, n_harm, stream);
}
