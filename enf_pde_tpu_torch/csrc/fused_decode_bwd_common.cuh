// Fused ENF decode, backward (kernel K2): the parts that its two programs share, the f32 program
// fused_decode_bwd.cu (3xTF32, the `pallas_interpret` backend's) and the bf16 program
// fused_decode_bwd_bf16.cu (bf16 operands, f32 sums: the YAMLs' `pallas` on the card). Each
// source includes this header first, then defines its sizes (Dims, `shape`), its products
// (`gemm`, the staging's Cls), the hooks below, the row passes whose math differs (the RFF VJP,
// the LayerNorm VJPs, the softmax), its kernels, and ends with fused_decode_bwd_host.cuh, the
// launcher's C interface. fused_decode_bwd.cu's header states the passes, the blocks, the
// workspace and the partials; here are the constants, the wgmma and cp.async helpers, the
// products' epilogues and the row passes both programs take alike, each product operand as the
// program takes it (`operand`: op(x) below is x in f32, bf16(x) in bf16). cuda_lib.build hashes
// it with each source.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // gelu_tanh, aligned16 (shared with K1)

namespace {

constexpr int TILE = 64;      // coordinates per work item: one m64 tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int WARPS = 8;
constexpr int KC = 16;        // k per staged chunk: two wgmma k steps
// Blocks an SM that __launch_bounds__ asks the compiler to leave registers for, per width
// class; the grid is what the SMs hold at once (occupancy).
constexpr int MINB64 = 1;
constexpr int MINB32 = 2;
constexpr int MINB16 = 2;
constexpr int MINB8 = 2;
// A block takes at least this many items: its partials (every weight gradient's, a batch row's)
// are stored once for all of them (a launch of few items otherwise holds one a tile). The rule
// holds with and without weight gradients, so the partition, and with it the order of every sum,
// does not depend on whether they are asked for: dinv ... dc come out the same bits either way.
constexpr int MIN_IPB = 2;
constexpr int MAX_I = 8;      // invariant dims (the RFF VJP's sums are kept in registers)
constexpr int MAX_SEG = 256;  // widest LayerNorm segment (32 lanes of 8 values)
constexpr int SMEM_CAP = 232448;  // bytes of shared memory a block may have on an H100
// These constants and each program's `shape` have one mirror, k2_smem_bytes / k2_scratch_bytes
// in ops/fused_decode.py, which reads the `constexpr int` lines of a source and of the headers
// it includes.
constexpr float LN_EPS = 1e-6f;  // flax LayerNorm default
constexpr int kNumPtrs = 34;
constexpr int kNumDims = 11;

__host__ __device__ constexpr int minb_of(int wn) { return wn == 64 ? MINB64 : wn == 32 ? MINB32 : wn == 16 ? MINB16 : MINB8; }
// Row strides of 4 mod 32 words: the A-fragment loads of a warp hit 32 distinct banks.
__host__ __device__ inline int row_stride(int width) { return (width + 31) / 32 * 32 + 4; }

// The width class: each warpgroup's slab of a product's columns. Every N (hid, H hidm, H D,
// hidm, D) is a multiple of it, and the narrowest of hid, hidm and D holds two of them.
inline int width_class(int hid, int hidm, int D) {
  const int w = hid < hidm ? (hid < D ? hid : D) : (hidm < D ? hidm : D);
  return w >= 128 ? 64 : w >= 64 ? 32 : w >= 32 ? 16 : 8;
}

// Each program defines these two: a product operand as the program takes it (the f32 value, or
// rounded to bf16), and sin and cos of 2 pi proj for the RFF features (sincosf, or the bf16
// mode's polynomial).
__device__ __forceinline__ float operand(float x);
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c);

// Shared-memory descriptor of a K-major B tile without swizzle (the staged layout, tf32 or bf16):
// core matrices of 8 rows (n) x 16 bytes stored whole; LBO is the step between the two core
// matrices of a k step (8 tf32, 16 bf16), SBO the step between groups of 8 rows (n).
constexpr int WG_LBO = 128, WG_SBO = 256;
__device__ __forceinline__ uint64_t wg_desc(const float* smem) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(WG_LBO >> 4) << 16) | ((uint64_t)(WG_SBO >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Orders the generic-proxy writes of shared memory (the staging stores) before wgmma's reads.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// Keeps the compiler from moving reads of an accumulator across wgmma's asynchronous writes.
template <int N>
__device__ __forceinline__ void wg_fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Where `gemm` reads B (element (k, n) of the K x N operand): a row-major [K][ldb] source in
// global memory (G, a workspace activation), its transpose [N][ldb] in global memory (G as the
// B of dpre G^T; a float4 a thread), a row-major source in shared memory (the tile's gradient,
// for a row contraction), each split (f32) or rounded (bf16) and staged by the threads; or a
// shared weight laid out once a launch in the staged layout (`weights_kernel`; B_SPLIT: one block
// per 16-deep chunk and WN slab, copied whole by cp.async).
enum { B_KN = 0, B_NK = 1, B_KN_SMEM = 2, B_SPLIT = 3 };
// The laid-out shared weights (Dims::split_off): each of q_w1, v_w1, fw, m_w2, o_w, p_w1, p_w2, h_w1,
// h_w2 as the B of X W, then (SPLIT_T + its index) as the B of dY W^T.
enum { SPLIT_Q = 0, SPLIT_V, SPLIT_F, SPLIT_M, SPLIT_O, SPLIT_P1, SPLIT_P2, SPLIT_H1, SPLIT_H2, SPLIT_T = 9 };
// A block-private partial that a product adds into, stored by its first contribution:
// element (m, n) at dst[m * ld + n], or at dst[n * ld + m] with trans.
struct ToPart {
  float* dst;
  int ld;
  bool first, trans;
};

// The end of a product's unit: its sums (column n = ns WN + 8 j + 2 tq (+1) of rows m0 and m1,
// when ok0 / ok1) handed to epi in pairs of columns.
template <int WN, class Epi>
__device__ __forceinline__ void finish(const Epi& epi, const float* sum, int ns, int tq, int m0, int m1, bool ok0,
                                       bool ok1) {
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int n = ns * WN + 8 * j + 2 * tq;
    if (ok0) epi(m0, n, sum[4 * j], sum[4 * j + 1]);
    if (ok1) epi(m1, n, sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// ... added into a partial: every old value is read before any is written (a load and a store
// through one pointer would otherwise run one round trip to memory at a time).
template <int WN>
__device__ __forceinline__ void finish(const ToPart& p, float* sum, int ns, int tq, int m0, int m1, bool ok0,
                                       bool ok1) {
  auto at = [&](int m, int n) { return p.trans ? p.dst + (size_t)n * p.ld + m : p.dst + (size_t)m * p.ld + n; };
  if (!p.first) {
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = ns * WN + 8 * j + 2 * tq + e;
        if (ok0) sum[4 * j + e] += *at(m0, n);
        if (ok1) sum[4 * j + 2 + e] += *at(m1, n);
      }
  }
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = ns * WN + 8 * j + 2 * tq + e;
      if (ok0) *at(m0, n) = sum[4 * j + e];
      if (ok1) *at(m1, n) = sum[4 * j + 2 + e];
    }
}

// ---- Row passes on the CUDA cores that both programs take alike ------------------------------

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// s_inv[t * I + i] = inv[(c0 + t) * I + i] of a latent's tile, zero past the last coordinate.
__device__ __noinline__ void load_inv(float* s_inv, const float* src, int rows, int I) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * I; idx += THREADS) s_inv[idx] = idx / I < rows ? src[idx] : 0.0f;
}

// F[t, :half] = sin(2 pi inv[t] @ coeff), F[t, half:] = cos(...) (rff_sincos); coeff is [I, half].
__device__ __noinline__ void rff(const float* s_inv, int I, const float* __restrict__ coeff, int half, float* F,
                                 int ldf) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * half; idx += THREADS) {
    const int t = idx / half, j = idx - t * half;
    float proj = 0.0f;
    for (int i = 0; i < I; ++i) proj = fmaf(s_inv[t * I + i], __ldg(coeff + i * half + j), proj);
    float s, co;
    rff_sincos(proj, &s, &co);
    F[t * ldf + j] = s;
    F[t * ldf + half + j] = co;
  }
}

// gelu(x) and gelu'(x) from one tanh.
__device__ __forceinline__ float2 gelu_and_grad(float x) {
  const float k = 0.7978845608028654f;
  const float th = tanhf(k * (x + 0.044715f * x * x * x));
  return make_float2(0.5f * x * (1.0f + th),
                     0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * k * (1.0f + 3.0f * 0.044715f * x * x));
}

// The LayerNorm passes take L lanes a segment of `width` columns: the largest power of two up to
// width / 8 (at most 32), so a lane holds 8 (at most 16) of its values in registers and a warp
// takes 32 / L segments at once (128 columns: 16 lanes, two segments a warp; 16 columns: 2 lanes).
__device__ __forceinline__ int seg_lanes(int width) {
  int L = 1;
  while (L < 32 && 2 * L <= width / 8) L *= 2;
  return L;
}

// Y = normalize(gelu(X)) in each of `segs` segments of `width` of the 64 rows (in place when
// Y == X); var = E[x^2] - E[x]^2 as in the JAX kernel.
template <int NV>
__device__ __noinline__ void ln_gelu_nv(const float* X, int ldx, float* Y, int ldy, int segs, int width, int L) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane % L, spw = 32 / L;
  for (int base = warp * spw; base < TILE * segs; base += WARPS * spw) {  // warp-uniform: every lane shuffles
    const int r = base + lane / L;
    const bool ok = r < TILE * segs;
    const int t = ok ? r / segs : 0, o = ok ? (r % segs) * width : 0;
    float v[NV];
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      v[i] = ok && n < width ? gelu_tanh(X[t * ldx + o + n]) : 0.0f;
      s += v[i];
      ss = fmaf(v[i], v[i], ss);
    }
    for (int sh = L / 2; sh > 0; sh >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, sh);
      ss += __shfl_xor_sync(0xffffffffu, ss, sh);
    }
    const float mean = s / width;
    const float rs = 1.0f / sqrtf(ss / width - mean * mean + LN_EPS);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      if (ok && n < width) Y[t * ldy + o + n] = (v[i] - mean) * rs;
    }
  }
}

__device__ void ln_gelu(const float* X, int ldx, float* Y, int ldy, int segs, int width) {
  const int L = seg_lanes(width);
  if (width <= 8 * L)
    ln_gelu_nv<8>(X, ldx, Y, ldy, segs, width, L);
  else
    ln_gelu_nv<16>(X, ldx, Y, ldy, segs, width, L);
}

// Y = gelu(X) over [64][width] (in place when Y == X).
__device__ __noinline__ void gelu_rows(const float* X, int ldx, float* Y, int ldy, int width) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    Y[t * ldy + n] = gelu_tanh(X[t * ldx + n]);
  }
}

// dX *= gelu'(Q) (Q in the block's workspace, [64][width] dense: written by this block, so read
// at L2 and not through the read-only cache, which may still hold an earlier item's values).
__device__ __noinline__ void mul_gelu_grad(float* dX, int ldd, const float* Q, int width) {
  __syncthreads();
#pragma unroll 4
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    dX[t * ldd + n] *= gelu_and_grad(__ldcg(Q + idx)).y;
  }
}

// dX = 0 where the ReLU's output H is not positive.
__device__ __noinline__ void relu_mask(float* dX, int ldd, const float* Hh, int ldh, int width) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    if (!(Hh[t * ldh + n] > 0.0f)) dX[t * ldd + n] = 0.0f;
  }
}

// dst[t * width + n] = X[t * ld + n] (a tile into the workspace, row stride width).
__device__ __noinline__ void copy_out(float* dst, const float* X, int ld, int width) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    dst[idx] = X[t * ld + n];
  }
}

// dst[n] (+)= sum_t sum_h dY[t, h * fold + n] for n < fold, h < width / fold (a bias gradient;
// fold < width sums the heads of the mixer's output).
__device__ __noinline__ void col_sums(const float* dY, int ld, int width, int fold, float* dst, bool first) {
  __syncthreads();
  for (int n = threadIdx.x; n < fold; n += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < TILE; ++t)
      for (int h = n; h < width; h += fold) s += dY[t * ld + h];
    dst[n] = first ? s : dst[n] + s;
  }
}

// nbar[t, h * hidm + j] (+)= op(prob[t, h]) op(nn[t, h * hidm + j]) (exact in f32).
__device__ __noinline__ void accum_nbar(float* nbar, const float* nn, int ld, const float* prob, int H, int hidm,
                                        bool first) {
  __syncthreads();
  const int HH = H * hidm;
  for (int idx = threadIdx.x; idx < TILE * HH; idx += THREADS) {
    const int t = idx / HH, n = idx - t * HH;
    const float v = operand(prob[t * H + n / hidm]) * operand(nn[t * ld + n]);
    nbar[t * ld + n] = first ? v : nbar[t * ld + n] + v;
  }
}

// logit[t, h] = op(hq[t]) . op(A[:, h]) + ab[h] + wb[t] (wb zero past the last coordinate).
__device__ __noinline__ void logits(const float* hq, int ldh, int hid, const float* __restrict__ Az,
                                    const float* __restrict__ abz, const float* __restrict__ wbz, int rows, int H,
                                    float* out) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * H; idx += THREADS) {
    const int t = idx / H, h = idx - t * H;
    float s = 0.0f;
    for (int k = 0; k < hid; ++k) s = fmaf(operand(hq[t * ldh + k]), operand(__ldg(Az + k * H + h)), s);
    out[idx] = s + __ldg(abz + h) + (t < rows ? __ldg(wbz + t) : 0.0f);
  }
}

// dlogit_z = p_z (dp_z - sum_z' p_z' dp_z'), in place over dp.
__device__ __noinline__ void softmax_vjp(const float* s_prob, float* s_dp, int Z, int H) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * H; idx += THREADS) {
    float s = 0.0f;
    for (int z = 0; z < Z; ++z) s = fmaf(s_prob[z * TILE * H + idx], s_dp[z * TILE * H + idx], s);
    for (int z = 0; z < Z; ++z) {
      const int k = z * TILE * H + idx;
      s_dp[k] = s_prob[k] * (s_dp[k] - s);
    }
  }
}

// The logit chain's VJP of one latent: dA[k, h] (+)= sum_t op(hq[t, k]) dlog[t, h], dab[h] (+)=
// sum_t dlog[t, h] (first: store), dwb[t] = sum_h dlog[t, h] (t < rows), and dhq[t, k] =
// (hq > 0) op(sum_h dlog[t, h] op(A[k, h])).
__device__ __noinline__ void logit_vjp(const float* hq, int ldh, int hid, const float* dlog, int H,
                                       const float* __restrict__ Az, float* dA, float* dab, float* dwb, int rows,
                                       bool first, float* dhq, int ldq) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < hid * H; idx += THREADS) {
    const int k = idx / H, h = idx - k * H;
    float s = 0.0f;
    for (int t = 0; t < TILE; ++t) s = fmaf(operand(hq[t * ldh + k]), dlog[t * H + h], s);
    dA[idx] = first ? s : dA[idx] + s;
  }
  for (int h = threadIdx.x; h < H; h += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < TILE; ++t) s += dlog[t * H + h];
    dab[h] = first ? s : dab[h] + s;
  }
  for (int t = threadIdx.x; t < rows; t += THREADS) {
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += dlog[t * H + h];
    dwb[t] = s;
  }
  for (int idx = threadIdx.x; idx < TILE * hid; idx += THREADS) {
    const int t = idx / hid, k = idx - t * hid;
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s = fmaf(dlog[t * H + h], operand(__ldg(Az + k * H + h)), s);
    dhq[t * ldq + k] = hq[t * ldh + k] > 0.0f ? operand(s) : 0.0f;
  }
}

// The head's last layer (N = out, on the CUDA cores): dh2[t, k] = op(sum_o g[t, o] op(h_w3[k, o]))
// (g zero past the last coordinate); with weight gradients dh_w3[k, o] (+)= sum_t op(h2[t, k])
// g[t, o] and dh_b3[o] (+)= sum_t g[t, o].
__device__ __noinline__ void head_vjp(const float* gsrc, int rows, int out, const float* __restrict__ h_w3, int hid,
                                      float* dh2, int ldd, const float* h2, int ld2, float* dw, float* db,
                                      bool first) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * hid; idx += THREADS) {
    const int t = idx / hid, k = idx - t * hid;
    float s = 0.0f;
    if (t < rows)
      for (int o = 0; o < out; ++o) s = fmaf(gsrc[t * out + o], operand(__ldg(h_w3 + k * out + o)), s);
    dh2[t * ldd + k] = operand(s);
  }
  if (!dw) return;
  for (int idx = threadIdx.x; idx < hid * out; idx += THREADS) {
    const int k = idx / out, o = idx - k * out;
    float s = 0.0f;
    for (int t = 0; t < rows; ++t) s = fmaf(operand(h2[t * ld2 + k]), gsrc[t * out + o], s);
    dw[idx] = first ? s : dw[idx] + s;
  }
  for (int o = threadIdx.x; o < out; o += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < rows; ++t) s += gsrc[t * out + o];
    db[o] = first ? s : db[o] + s;
  }
}

// Y[t, n] = g[t, n] for t < rows, else 0 (without the tail the cotangent is dy).
__device__ __noinline__ void load_g(float* Y, int ld, const float* __restrict__ gsrc, int rows, int width) {
  __syncthreads();
#pragma unroll 4
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    Y[t * ld + n] = t < rows ? __ldg(gsrc + idx) : 0.0f;
  }
}

}  // namespace
