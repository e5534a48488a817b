// bf16 products on Hopper's tensor cores, f32 accumulation, and the polynomial sin/cos of the
// bf16 decode: shared by the bf16 programs of the fused decode kernels, K1
// (fused_decode_fwd_bf16.cu) and K2 (fused_decode_bwd_bf16.cu). They compute the function the
// JAX kernel computes with compute_dtype=bfloat16 (enf_pde_tpu/ops/pallas_decode.py, `_mm`):
// every product operand rounded to bf16 (to nearest, ties to even, as a cast rounds), the
// products exact and their sums in f32. A product whose operand JAX keeps in f32 (a cotangent
// times a bf16 weight) takes that operand as three bf16 terms, hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid): their sum is x to f32 rounding. (Two terms, 2^-17 of x, left K2 at
// 0.34-0.42 of the bf16 function's own distance from f32 on the card: each later rounding to
// bf16 flips where the operand's error crosses a rounding boundary, and the flips cascade.)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Two values rounded to bf16 in one register: lo in the low half (the lower k of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The three bf16 terms of a pair: t[0] = bf16(x), t[1] = bf16(x - t[0]), t[2] = bf16(x - t[0] -
// t[1]), each packed as pack_bf16 (the subtractions are exact in f32).
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t* t) {
  const float h0 = bf16_round(x0), h1 = bf16_round(x1);
  const float r0 = x0 - h0, r1 = x1 - h1;
  const float m0 = bf16_round(r0), m1 = bf16_round(r1);
  t[0] = pack_bf16(h0, h1);
  t[1] = pack_bf16(m0, m1);
  t[2] = pack_bf16(r0 - m0, r1 - m1);
}

// D (64 x N, f32, this thread's N / 2 values) = A (64 x 16 bf16, registers: this warp's 16 rows
// in the m16n8k16 A-fragment order) x B (16 x N bf16, K-major in shared memory, `desc`) +
// (accumulate ? D : 0), one asynchronous warpgroup product, N = 8, 16, 32 or 64. D's fragment as
// the tf32 product's: n8 tile j at d[4 j .. 4 j + 3].
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 8) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
}

// D (64 x 64, f32, this thread's 32 values as wgmma_bf16<64>'s) = A (64 x 16 bf16, K-major in shared
// memory, `adesc`) x B (16 x 64 bf16, K-major in shared memory, `bdesc`) + (accumulate ? D : 0): both
// operands read by the tensor cores where they lie, nothing of them in registers.
__device__ __forceinline__ void wgmma_bf16_ss64(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// wgmma_bf16_ss64 at N = 16, 32 or 64 columns (this thread's N / 2 values of D as wgmma_bf16<N>'s): K1's
// narrow classes, each product as wide as the class.
template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(adesc), "l"(bdesc), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(adesc), "l"(bdesc), "r"(accumulate));
  } else {
    wgmma_bf16_ss64(d, adesc, bdesc, accumulate);
  }
}

// The polynomial sin and cos of 2 pi p of the bf16 decode (`_fast_sincos` in
// pallas_decode.py): t = pi (p - round(p)) in [-pi/2, pi/2], s and c its sin and cos by
// odd / even polynomials, sin(2 pi p) = 2 s c, cos(2 pi p) = 1 - 2 s^2. Each operation rounds
// on its own (no contraction into fma), as the plain version's elementwise operations do. With
// `d`, also the derivatives of both outputs in p, as autodiff takes them through the polynomial.
constexpr float SC_PI = 3.14159265358979f;
constexpr float SC_S1 = 0.9999999995f, SC_S3 = -0.1666666279f, SC_S5 = 8.333288177e-3f, SC_S7 = -1.980741872e-4f,
                SC_S9 = 2.601885479e-6f;
constexpr float SC_C2 = -0.4999999963f, SC_C4 = 4.166657362e-2f, SC_C6 = -1.388544180e-3f, SC_C8 = 2.423340843e-5f;

__device__ __forceinline__ void fast_sincos(float p, float* sn, float* cs, float* dsn = nullptr, float* dcs = nullptr) {
  const float y = __fsub_rn(p, rintf(p));
  const float t = __fmul_rn(SC_PI, y);
  const float u = __fmul_rn(t, t);
  const float ps = __fadd_rn(SC_S1, __fmul_rn(u, __fadd_rn(SC_S3, __fmul_rn(u, __fadd_rn(SC_S5, __fmul_rn(u,
                   __fadd_rn(SC_S7, __fmul_rn(u, SC_S9))))))));
  const float s = __fmul_rn(t, ps);
  const float pc = __fadd_rn(SC_C2, __fmul_rn(u, __fadd_rn(SC_C4, __fmul_rn(u, __fadd_rn(SC_C6, __fmul_rn(u, SC_C8))))));
  const float c = __fadd_rn(1.0f, __fmul_rn(u, pc));
  const float s2 = __fmul_rn(2.0f, s);
  *sn = __fmul_rn(s2, c);
  *cs = __fsub_rn(1.0f, __fmul_rn(s2, s));
  if (dsn) {
    // s = t P(u), c = 1 + u Q(u), u = t^2: s' = P + 2 u P'(u), c' = 2 t (Q + u Q'(u)).
    const float dps = SC_S3 + u * (2.0f * SC_S5 + u * (3.0f * SC_S7 + u * (4.0f * SC_S9)));
    const float dpc = SC_C4 + u * (2.0f * SC_C6 + u * (3.0f * SC_C8));
    const float ds = ps + 2.0f * u * dps, dc = 2.0f * t * (pc + u * dpc);
    *dsn = 2.0f * SC_PI * (ds * c + s * dc);
    *dcs = -4.0f * SC_PI * s * ds;
  }
}

}  // namespace
