// K1: combtooth exciter, the whole combtooth_pallas function in one launch.
//
// Replaces the Pallas kernel ddsp_svc_tpu/ops/pallas_source.py
// (combtooth_pallas -> _comb_kernel) together with the frame arithmetic its
// wrapper runs outside the pallas_call. From f0 (B, T) in Hz, per frame t
// of batch row b:
//   s0 = f0 / sr, ds0 = s0[t+1] - s0[t] (0 for the row's last frame),
//   q = rint(2^22 * wrap(s0*block + ((0.5*ds0)*(block-1))*block / block))
//   carry = ((offset[b] + sum_{u<t} q_u) mod 2^22) / 2^22
// with wrap(r) = fmod(r + 0.5, 1) - 0.5 (ops/source.py
// frame_phase_increments_q and carry_from_increments_q), and per sample
// n in [0, block):
//   rad = s0*(n+1) + 0.5*ds0*n*(n+1)/block + carry;  rad -= rint(rad)
//   out = sinc(rad / (s0 + ds0*n/block + 1e-5))
//   phase_frames[b, t] = fl(2 pi) * rad at n = 0
// The TPU wrapper kept the int32 carry prefix outside its kernel only
// because the TPU's tiling asked for it; here it is a scan inside.
//
// Bound on the H100: memory. One f32 store per output sample and per
// frame's phase, one f32 load per frame: (T + T*block + T) * 4 bytes, 0.53
// us at 3.35 TB/s for a 10 s request, far below any operation bound (~25
// flops and one sinpif per sample).
//
// Design: a block of 256 threads owns F frames of one batch row, F = 4
// until the grid would pass about one resident wave (1024 blocks), then
// as many as keep it there, up to 64: F = 4 and 216 blocks at T = 862,
// F = 51 and 1014 blocks at T = 51,680 (ten minutes). F of its threads
// derive s0, ds0 and q of their frame from f0. The carry into the block
// is a single-pass decoupled look-back scan over the row's blocks: each
// block publishes its frames' q sum as an aggregate, then one warp reads
// the 32 preceding blocks' words, sums aggregates back to the nearest
// inclusive prefix (a further window of 32 if there is none), and
// publishes its own inclusive prefix. Flag and 22-bit value share one
// 32-bit word, so a word is published by one store and read whole.
// Integer sums keep the same low 22 bits in any order and width, so the
// int32 wrap of the sums gives the plain version's int64 prefix masked to
// 22 bits, bit for bit. Blocks take their tile from an atomic ticket, so
// every block a look-back waits on has started and publishes its
// aggregate without waiting. The ticket and flags sit in a scratch of
// 1 + B * ceil(T / F) words that the host function zeroes with one
// cudaMemsetAsync: a call is two device operations, the memset and the
// kernel, and no host-to-device copy. Division by a power-of-two block is
// a product by its exact reciprocal (the same real number, so the same
// rounding), which left three divisions per sample.
//
// What holds it back (tools/kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W):
// ~6.8 us at T = 862 against 0.53 us of bytes. Its blocks all start at
// once, so only the first is inclusive at first, and a block k looks back
// through ceil(k / 32) windows, an L2 round trip each: the scan's latency,
// not the samples (~1.7 us of them at the ten-minute rate), sets the time.
// Reading 256 words a round (eight a lane) measured slower, 9.9 us, and so
// did 512-thread blocks at T = 51,680 (their prologue idles more threads).
// At T = 51,680 it takes ~0.100 ms against 0.032 ms of bytes: the three
// correctly rounded divisions and the sinpif per sample.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: no FMA contraction) in the plain version's f32
// order, rintf rounds half to even (as jnp.round and torch.round), sinc is
// sinpif(x) / (pi x) with sinc(0) = 1. x = rad / s_eff divides by s0 ~
// 0.005 at 220 Hz, so one ulp of rad moves x by ~5e-5, and a contracted
// ramp alone broke the 5e-5 tolerance on the card; an increment one
// quantum off would move x by as much.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinFrames = 4;    // frames per block, at least
constexpr int kMaxFrames = 64;   // and at most
constexpr int kWaveBlocks = 1024;  // about one resident wave on an H100
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 1u << 31;
constexpr unsigned kMask = (1u << 22) - 1;  // PHASE_Q_BITS = 22

// Frames per block: kMinFrames until the grid would pass about one wave,
// then as many as keep it there (up to kMaxFrames), so that each block's
// scan prologue is spread over more samples.
__host__ __device__ inline int frames_per_block(int batch, int n_frames) {
  const long long rows = (long long)batch * n_frames;
  const long long f = (rows + kWaveBlocks - 1) / kWaveBlocks;
  return (int)(f < kMinFrames ? kMinFrames : f > kMaxFrames ? kMaxFrames : f);
}

// v / block, correctly rounded: for a power-of-two block a product by the
// exact reciprocal, which is the same real number and so rounds the same
struct OverBlock {
  float block, inv;
  bool pow2;
  __device__ __forceinline__ float operator()(float v) const {
    return pow2 ? __fmul_rn(v, inv) : __fdiv_rn(v, block);
  }
};

// frame_phase_increments_q of one frame, rounded step by step
__device__ __forceinline__ int increment_q(float s0, float ds0,
                                           const OverBlock& over) {
  const float fblock = over.block;
  const float ramp =
      over(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, ds0), fblock - 1.0f), fblock));
  const float rad = __fadd_rn(__fmul_rn(s0, fblock), ramp);
  const float wrapped = __fsub_rn(fmodf(__fadd_rn(rad, 0.5f), 1.0f), 0.5f);
  return (int)rintf(__fmul_rn(wrapped, 4194304.0f));
}

// The scan's words: relaxed loads and stores at device scope
__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// The exclusive prefix (mod 2^22) of the tiles before ``tile``, by warp 0:
// lane i reads tile - 1 - i of the current window of 32, waiting while a
// word is still zero, and the warp sums aggregates down to the nearest
// inclusive prefix.
__device__ unsigned look_back(const unsigned* flags, int tile) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int end = tile;; end -= 32) {
    const int idx = end - 1 - lane;
    unsigned v = 0;
    if (idx >= 0) {
      do {
        v = load_word(flags + idx);
      } while (v == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (v & kInclusive) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;  // nearest inclusive lane
    excl += __reduce_add_sync(0xffffffffu, lane <= stop ? (v & kMask) : 0u);
    if (incl) return excl & kMask;
  }
}

__global__ void __launch_bounds__(kThreads)
combtooth_kernel(const float* __restrict__ f0, const void* __restrict__ offset,
                 int offset_is_64, float* __restrict__ out,
                 float* __restrict__ phase_frames, unsigned* __restrict__ scratch,
                 int n_frames, int block, float sr, int frames, int tiles_per_row) {
  __shared__ unsigned s_ticket, s_prefix;
  __shared__ float s_s0[kMaxFrames], s_ds0[kMaxFrames], s_carry[kMaxFrames];
  __shared__ int s_q[kMaxFrames];
  if (threadIdx.x == 0) s_ticket = atomicAdd(scratch, 1u);
  __syncthreads();
  const int b = (int)(s_ticket / (unsigned)tiles_per_row);
  const int tile = (int)(s_ticket % (unsigned)tiles_per_row);
  const int t0 = tile * frames;
  const int nf = min(frames, n_frames - t0);
  const float* f0_row = f0 + (long long)b * n_frames;
  unsigned* flags = scratch + 1 + (long long)b * tiles_per_row;
  const OverBlock over{(float)block, 1.0f / (float)block, (block & (block - 1)) == 0};

  if ((int)threadIdx.x < frames) {
    const int i = threadIdx.x;
    const int t = t0 + i;
    int q = 0;
    if (i < nf) {
      const float s0 = __fdiv_rn(f0_row[t], sr);
      const float ds0 =
          t + 1 < n_frames ? __fsub_rn(__fdiv_rn(f0_row[t + 1], sr), s0) : 0.0f;
      s_s0[i] = s0;
      s_ds0[i] = ds0;
      q = increment_q(s0, ds0, over);
    }
    s_q[i] = q;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned agg = 0;
    for (int i = threadIdx.x; i < frames; i += 32) agg += (unsigned)s_q[i];
    agg = __reduce_add_sync(0xffffffffu, agg);
    unsigned excl;
    if (tile == 0) {
      excl = offset == nullptr ? 0u
             : offset_is_64   ? (unsigned)((const long long*)offset)[b]
                              : (unsigned)((const int*)offset)[b];
    } else {
      if (threadIdx.x == 0) store_word(flags + tile, kAggregate | (agg & kMask));
      excl = look_back(flags, tile);
    }
    if (threadIdx.x == 0) {
      store_word(flags + tile, kInclusive | ((excl + agg) & kMask));
      s_prefix = excl;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < nf) {
    const int i = threadIdx.x;
    unsigned carry_q = s_prefix;
    for (int j = 0; j < i; ++j) carry_q += (unsigned)s_q[j];
    // exact: a value below 2^22 over a power of two
    const float carry = (float)(carry_q & kMask) * (1.0f / 4194304.0f);
    s_carry[i] = carry;
    float rad = __fadd_rn(s_s0[i], carry);
    rad = rad - rintf(rad);
    phase_frames[(long long)b * n_frames + t0 + i] =
        __fmul_rn(6.28318548202514648f, rad);
  }
  __syncthreads();

  for (int i = 0; i < nf; ++i) {
    const float a = s_s0[i];
    const float d = s_ds0[i];
    const float carry = s_carry[i];
    float* row = out + ((long long)b * n_frames + t0 + i) * block;
    for (int idx = threadIdx.x; idx < block; idx += kThreads) {
      const float n = (float)idx;
      const float np1 = n + 1.0f;
      // every product and sum rounded on its own, in the plain version's
      // order, so the phase ramp matches it to the bit
      float rad = __fadd_rn(__fmul_rn(a, np1),
                            over(__fmul_rn(__fmul_rn(0.5f * d, n), np1)));
      rad = __fadd_rn(rad, carry);
      rad = rad - rintf(rad);  // exact: |rad - rint(rad)| <= 0.5 on rad's grid
      const float s_eff = __fadd_rn(a, over(__fmul_rn(d, n)));
      const float x = __fdiv_rn(rad, __fadd_rn(s_eff, 1e-5f));
      row[idx] = (x == 0.0f) ? 1.0f : sinpif(x) / (3.14159265358979f * x);
    }
  }
}

}  // namespace

DDSP_API long long ddsp_combtooth_scratch_words(int batch, int n_frames) {
  const int frames = frames_per_block(batch, n_frames);
  return 1 + (long long)batch * ((n_frames + frames - 1) / frames);
}

DDSP_API int ddsp_combtooth(const float* f0, const void* offset,
                            int offset_is_64, float* out, float* phase_frames,
                            unsigned* scratch, int batch, int n_frames,
                            int block, float sampling_rate, void* stream) {
  if (batch == 0 || n_frames == 0 || block == 0) return 0;
  const int frames = frames_per_block(batch, n_frames);
  const int tiles = (n_frames + frames - 1) / frames;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)ddsp_combtooth_scratch_words(batch, n_frames) * 4,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  combtooth_kernel<<<(unsigned int)((long long)batch * tiles), kThreads, 0,
                     (cudaStream_t)stream>>>(f0, offset, offset_is_64, out,
                                             phase_frames, scratch, n_frames,
                                             block, sampling_rate, frames, tiles);
  DDSP_CHECK_LAUNCH();
  return 0;
}
