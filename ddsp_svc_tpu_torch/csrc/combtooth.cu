// K1: combtooth exciter.
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_source.py
// (combtooth_pallas -> _comb_kernel). Per frame row r (s0 = f0/sr, ds0 = the
// next-frame delta, carry = the dequantised integer phase carry) and sample
// n in [0, block):
//   rad = s0*(n+1) + 0.5*ds0*n*(n+1)/block + carry;  rad -= rint(rad)
//   out = sinc(rad / (s0 + ds0*n/block + 1e-5))
// The int32 carry prefix and phase_frames stay outside, in the wrapper
// (ops/cuda_source.py), as in JAX.
//
// Bound on the H100: memory. One f32 store per output sample, fed by three
// scalars per frame (read once per sample from L1/L2, 1/512 of the bytes),
// and ~25 flops plus one sinpif per sample: far below the f32 peak. Design:
// one thread per output sample, consecutive threads on consecutive samples,
// so the stores are fully coalesced; rounding by rintf (half to even, as
// jnp.round and torch.round), sinc as sinpif(x) / (pi x) with sinc(0) = 1.
// The phase ramp is rounded step by step without FMA contraction: x =
// rad / s_eff divides by s0 ~ 0.005 at 220 Hz, so one ulp of rad moves x by
// ~5e-5, and a contracted ramp alone broke the 5e-5 tolerance on the card.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
combtooth_kernel(const float* __restrict__ s0, const float* __restrict__ ds0,
                 const float* __restrict__ carry, float* __restrict__ out,
                 long long total, int block) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  long long row = idx / block;
  const float n = (float)(idx - row * block);
  const float np1 = n + 1.0f;
  const float a = s0[row];
  const float d = ds0[row];
  const float bs = (float)block;
  // every product and sum rounded on its own (no FMA contraction), in the
  // order of the plain version, so the phase ramp matches it to the bit
  float rad = __fadd_rn(__fmul_rn(a, np1),
                        __fdiv_rn(__fmul_rn(__fmul_rn(0.5f * d, n), np1), bs));
  rad = __fadd_rn(rad, carry[row]);
  rad = rad - rintf(rad);  // exact: |rad - rint(rad)| <= 0.5 on rad's grid
  const float s_eff = __fadd_rn(a, __fdiv_rn(__fmul_rn(d, n), bs));
  const float x = __fdiv_rn(rad, __fadd_rn(s_eff, 1e-5f));
  out[idx] = (x == 0.0f) ? 1.0f : sinpif(x) / (3.14159265358979f * x);
}

}  // namespace

DDSP_API int ddsp_combtooth(const float* s0, const float* ds0,
                            const float* carry, float* out, long long n_rows,
                            int block, void* stream) {
  long long total = n_rows * (long long)block;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  combtooth_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      s0, ds0, carry, out, total, block);
  DDSP_CHECK_LAUNCH();
  return 0;
}
