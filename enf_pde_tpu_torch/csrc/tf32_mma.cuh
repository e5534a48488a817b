// 3xTF32 products on Hopper's tensor cores at f32 accuracy, shared by the fused decode
// kernels K1 (fused_decode_fwd.cu) and K2 (fused_decode_bwd.cu), and the tanh-gelu both
// compute. Included once by each source; cuda_lib.build hashes it with them.
//
// x = big + small + e with big = tf32(x), small = tf32(x - big): |x - big| <= 2^-11 |x| and
// |e| <= 2^-11 |x - big| <= 2^-22 |x|. A product a b = ab bb + ab bs + as bb + as bs + O(2^-22
// |a b|); dropping as bs (<= 2^-22 |a b|) leaves each product within about 2^-21 of the f32
// product. The tensor core aligns the addends of its accumulation to the largest and
// truncates, so a sum kept in the mma accumulator drifts toward zero by up to an ulp per
// mma: callers give it a fresh accumulator every few k steps and add that into f32
// registers (round to nearest). The chain each kernel allows, and the error it measured,
// are in that kernel's header.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ float2 split_tf32(float x) {
  const uint32_t big = to_tf32(x);
  return make_float2(__uint_as_float(big), __uint_as_float(to_tf32(x - __uint_as_float(big))));
}

// The same split by integer rounding (add half of the 13 dropped bits' unit, clear them):
// bit for bit the cvt.rna result for finite x, in fewer instructions (the conversion compiles
// to several on sm_90). K1 uses this one.
__device__ __forceinline__ float2 split_tf32_int(float x) {
  const uint32_t big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float small = x - __uint_as_float(big);
  return make_float2(__uint_as_float(big), __uint_as_float((__float_as_uint(small) + 0x1000u) & 0xffffe000u));
}

// d += a b on one m16n8k8 tile. Fragments (lane = 4 g + t): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (t + 4, g); d0, d1 (g, 2t, 2t + 1),
// d2, d3 (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at f32 accuracy: the two cross terms first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_big, const uint32_t* a_small,
                                           const uint32_t* b_big, const uint32_t* b_small) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// d[mi][j] += a[mi] b[j] at f32 accuracy for every pair of MI A tiles and NJ B tiles, in
// mma_3xtf32's order per tile, one term across all tiles before the next: MI x NJ
// independent products are in flight at once instead of one chain of three.
template <int MI, int NJ>
__device__ __forceinline__ void mma_3xtf32_tiles(float (&d)[MI][NJ][4], const uint32_t (&a_big)[MI][4],
                                                 const uint32_t (&a_small)[MI][4], const uint32_t (&b_big)[NJ][2],
                                                 const uint32_t (&b_small)[NJ][2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) mma_tf32(d[mi][j], a_small[mi], b_big[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) mma_tf32(d[mi][j], a_big[mi], b_small[j]);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) mma_tf32(d[mi][j], a_big[mi], b_big[j]);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
