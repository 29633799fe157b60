// Split-TF32 ("3xTF32") tensor-core products at f32 accuracy, and the
// ldmatrix / cp.async helpers that feed them. Shared by K2 (resblock.cu)
// and K3 (conformer.cu).
//
// An f32 operand x is split as hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds
// (the plain emulation is ops/cuda_resblock.tf32_split). The product of two
// operands is taken as lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 with f32
// accumulation: the two small cross terms go into the accumulator first,
// then hi*hi. The dropped lo*lo term and the rounding of lo are ~2^-22 of
// the product, so a sum over K terms keeps f32's accuracy, where one TF32
// pass (10-bit mantissa) would sit near 1e-3 of the result. Three MMAs per
// product put the ceiling at a third of the card's dense TF32 rate (494.7 /
// 3 TFLOP/s on an H100 SXM).
//
// Fragment layout of mma.m16n8k8 (.row.col, tf32), lane = 4 * g + q:
//   A (16 x 8):  a0 (g, q)  a1 (g + 8, q)  a2 (g, q + 4)  a3 (g + 8, q + 4)
//   B (8 x 8):   b0 (k = q, n = g)  b1 (k = q + 4, n = g)
//   C (16 x 8):  c0 (g, 2q)  c1 (g, 2q + 1)  c2 (g + 8, 2q)  c3 (g + 8, 2q + 1)
// Each 8 x 4 quarter of A, and each half of B stored n-major ([n][k]), is
// one 8 x 8 b16 matrix of ldmatrix: lane l receives word l % 4 of row l / 4,
// which is the fragment element above. So one ldmatrix.x4 loads a whole A
// fragment, or the B fragments of two n8 tiles, from rows of 16-byte
// aligned words; rows whose stride is an odd multiple of 4 words load
// without bank conflicts.
#pragma once

#include <cstdint>

// cvt.rna.tf32.f32's rounding (nearest, ties away from zero) in two integer
// instructions: add half a TF32 ulp to the magnitude bits and clear the 13
// dropped ones. The same bits as the cvt for every finite input; ptxas
// expands the cvt with a NaN guard (an FSETP and a SEL more per value).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(bits);
  lo = tf32_rna(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  split_tf32(__float_as_uint(x), hi, lo);
}

// four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// not volatile: the kernels issue many independent products back to back,
// and the scheduler may interleave them
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a[m] * b[n] at f32 accuracy for an MT x NT grid of m16n8k8
// fragments: the small cross terms first, then hi * hi, each pass over the
// whole grid, so that the three products into one accumulator are MT * NT
// independent MMAs apart rather than back to back.
template <int MT, int NT>
__device__ __forceinline__ void mma_tf32x3_grid(float (&acc)[MT][NT][4],
                                                const uint32_t (&a_hi)[MT][4],
                                                const uint32_t (&a_lo)[MT][4],
                                                const uint32_t (&b_hi)[NT][2],
                                                const uint32_t (&b_lo)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], a_lo[m], b_hi[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], a_hi[m], b_lo[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], a_hi[m], b_hi[n]);
}

// Warpgroup MMA (sm_90a): D (64 x N, f32, in registers) += A (64 x 8 tf32,
// in registers: warp w of the group holds rows 16w..16w+15 as the m16n8k8
// A fragment above) x B (8 x N tf32, in shared memory, K-major, described
// by b_desc). Asynchronous: wgmma_fence() before the first product after
// the operand registers were written, wgmma_commit() after a batch, and
// wgmma_wait<N>() before the accumulators or the A registers are touched.
// D's registers: d[4j + 0/1] = (row 16w + g, columns 8j + 2q, +1),
// d[4j + 2/3] = (row 16w + g + 8, the same columns).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major B tile without swizzling, built from 8-row x
// 16-byte core matrices (128 contiguous bytes each): lbo is the byte step
// between the two core matrices of a k8 step (along K), sbo the step
// between groups of 8 rows (along N).
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// 16-byte global -> shared copy; with valid == false it writes 16 zero
// bytes and reads nothing (src-size 0), which is how the kernels pad.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's earlier shared-memory writes (cp.async included)
// before later reads by the async proxy (wgmma's B operand)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
