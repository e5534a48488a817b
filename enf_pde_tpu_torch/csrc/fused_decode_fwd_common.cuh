// Fused ENF decode, forward (kernel K1): the parts that its two programs share, the f32 program
// fused_decode_fwd.cu (3xTF32, the `pallas_interpret` backend's) and the bf16 program
// fused_decode_fwd_bf16.cu (bf16 operands, f32 sums: the YAMLs' `pallas` on the card). Each
// source includes this header first, then defines its products (the f32 program's 32-row `dense32`
// / `dense32_direct` and group rows' `gemm_wg`; the bf16 program's designs of its own), its Width
// class traits, the two hooks below, its kernel `fused_decode_fwd_kernel<WN, WITH_TAIL>` and its
// `layout`, and ends with
// fused_decode_fwd_host.cuh, the launcher's C interface. fused_decode_fwd.cu's header states
// the math, the blocks, the width classes and the staging; here are the constants, the launch
// parameters, the cp.async and wgmma staging helpers, the row passes (the RFF features, the
// LayerNorms, the CUDA-core dot products) and the mixer. cuda_lib.build hashes it with each source.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // gelu_tanh, aligned16

namespace {

constexpr int TILE = 32;              // coordinates per block
constexpr int THREADS = 256;          // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int ZG = 4;                 // latents per batched product (ZG * TILE = 128 rows)
constexpr int KC = 16;                // k rows per staged chunk
constexpr int STAGES = 3;             // ring depth (2 measured the same in the f32 program, PERF.md §6)
constexpr int STAGE_FLOATS = KC * 264;  // one stage: 16 x (256 + 8) f32, or a wgmma block
constexpr int WG_N = 128;             // columns of one wgmma product and of one staged slab
constexpr int SMEM_CAP = 232448;      // bytes of shared memory a block may have on an H100
// The narrow width classes WN = 16, 32, 64 (hid, hidm and D at most WN; wider shapes take the
// class WG_N): the most latents a group takes (ZG16 * TILE rows), whether the four shared
// weights stay resident in shared memory (RES, 1) or pass through a ring of STAGES narrow blocks
// (0), and the blocks an SM that __launch_bounds__ asks the compiler to make room for.
constexpr int ZG16 = 8;
constexpr int ZG32 = 4;
constexpr int ZG64 = 4;
constexpr int RES16 = 1;
constexpr int RES32 = 1;
constexpr int RES64 = 0;
constexpr int MINB16 = 2;
constexpr int MINB32 = 2;
constexpr int MINB64 = 2;
// These constants, each program's and its `layout` have one mirror, k1_smem_bytes in
// ops/fused_decode.py, which reads the `constexpr int` lines of a source and of the headers it
// includes.
constexpr float LN_EPS = 1e-6f;       // flax LayerNorm default
constexpr int kNumPtrs = 33;          // the launcher's pointers (one more: the bf16 program's logits workspace)
constexpr int kNumDims = 10;

__host__ __device__ constexpr int zg_of(int wn) { return wn == 16 ? ZG16 : wn == 32 ? ZG32 : wn == 64 ? ZG64 : ZG; }
__host__ __device__ constexpr bool res_of(int wn) { return wn == 16 ? RES16 : wn == 32 ? RES32 : wn == 64 ? RES64 : 0; }

struct Params {
  const float *inv, *wb, *A, *ab, *G, *c;
  const float *q_coeff, *q_b1, *v_coeff, *v_b1, *fb, *m_b2;
  const float *q_w1s, *v_w1s, *fws, *m_w2s;  // blocked for wgmma (split_weights' tf32 parts, or bf16_weights)
  const float *o_w, *o_b, *p_w1, *p_b1, *p_w2, *p_b2, *h_w1, *h_b1, *h_w2, *h_b2, *h_w3, *h_b3;
  float* out;
  int B, Z, C, I, hid, H, D, hidm, out_dim;
  int ldX, ldP, ldW;  // row strides (words, 4 mod 8): X / Y as [ZG TILE][ldX], pre [64][ldP], acc [32][ldW]
  int nY;             // floats of Y
  int nW;             // narrow classes: floats of the resident shared weights, or of their ring
  int lg_global;      // the bf16 program: every latent's logits in `lg`, not in shared memory (`layout`)
  float* lg;          // then [B][ceil(C / TILE)][Z][TILE][H], a block's tile at its own offset (the bf16
                      // class 128: [grid][Z][64][H], a block's slot); else null
  int tile;           // coordinates a work item takes (the launcher's `item_tile`)
};

// Row strides of 4 mod 32 words: the A-fragment loads of a warp hit 32 distinct banks.
__host__ __device__ inline int row_stride(int width) { return (width + 31) / 32 * 32 + 4; }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == ACT_RELU) return fmaxf(x, 0.0f);
  if (ACT == ACT_GELU) return gelu_tanh(x);
  return x;
}


// Each program defines these two: a product operand as the program takes it (the f32 value,
// or rounded to bf16), and sin and cos of 2 pi proj for the RFF features (sincosf, or the bf16
// mode's polynomial). gemm_wg, the group rows' product, is the f32 program's (dense_group, mixer).
__device__ __forceinline__ float operand(float x);
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c);
template <int WN, int MT, bool RES, class XRow, class Active, class Epi>
__device__ __forceinline__ void gemm_wg(XRow xrow, Active active, int K, const float* __restrict__ W, int N,
                                        float* ring, Epi epi);
// And the launch's plan: whether a class's blocks are persistent over the work items (batch row, tile)
// and the coordinates an item takes (`item_tile`, from the blocks the grid holds at once).
bool persistent_class(int wn);
int item_tile(int wn, int B, int C, long long slots);

// Shared-memory descriptor of a K-major B tile without swizzle (split_weights' tf32 block, or
// bf16_weights'): core matrices of 8 rows (n) x 16 bytes stored whole; LBO is the step between
// the two core matrices of a k step (8 tf32, 16 bf16), SBO the step between groups of 8 rows
// (n). The same at every width and in both programs.
constexpr int WG_LBO = 128, WG_SBO = 256;
__device__ __forceinline__ uint64_t wg_desc(const float* smem) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(WG_LBO >> 4) << 16) | ((uint64_t)(WG_SBO >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Orders the generic-proxy writes of shared memory (cp.async, stores) before wgmma's reads.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// Keeps the compiler from moving reads of an accumulator across wgmma's asynchronous writes.
template <int N>
__device__ __forceinline__ void wg_fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Y = act(X W + bias) over the rows of a latent group (R of them valid), row strides ldx, ldy;
// W blocked (split_weights' or bf16_weights'; or resident). Inlined, as is mixer: ptxas serializes every wgmma of
// a kernel whose wgmma pipeline crosses a function call.
template <int WN, int MT, bool RES, int ACT>  // ACT_NONE or ACT_RELU (the gelu after fw is applied in its normalize pass)
__device__ __forceinline__ void dense_group(const float* X, int ldx, int R, int K, const float* __restrict__ W, int N,
                                            const float* __restrict__ bias, float* Y, int ldy, float* ring) {
  gemm_wg<WN, MT, RES>(
      [&](int wg, int mt, int w, int r) { return X + (64 * (wg + 2 * mt) + 16 * w + r) * ldx; },
      [&](int wg, int mt) { return 64 * (wg + 2 * mt) < R; }, K, W, N, ring,
      [&](int wg, int mt, int w, int r, int n, float v0, float v1) {
        const float bn = __ldg(bias + n);
        float* y = Y + (64 * (wg + 2 * mt) + 16 * w + r) * ldy + n;
        y[0] = activate<ACT>(v0 + bn);
        y[8 * ldy] = activate<ACT>(v1 + bn);
      });
}

// F[r, :half] = sin(2 pi inv[r] @ coeff), F[r, half:] = cos(...) for the R rows of a latent
// group (rff_sincos: the f32 program's sincosf, the bf16 program's polynomial); s_inv is [R][I]
// in shared memory, coeff [I, half]. The projection is f32 in both, as in `_rff_hidden`.
__device__ void rff_features(const float* s_inv, int R, int I, const float* __restrict__ coeff, int half,
                             float* F, int ldf) {
  for (int idx = threadIdx.x; idx < R * half; idx += THREADS) {
    const int r = idx / half, j = idx - r * half;
    float proj = 0.0f;
    for (int i = 0; i < I; ++i) proj = fmaf(s_inv[r * I + i], __ldg(coeff + i * half + j), proj);
    float s, co;
    rff_sincos(proj, &s, &co);
    F[r * ldf + j] = s;
    F[r * ldf + half + j] = co;
  }
}

// Normalize-only LayerNorm of each of the `segs` segments of width `width` (a multiple of 4,
// at most NW) in every one of `rows` rows of X, of gelu(X) with GELU (the activation of the
// product that wrote X, applied here rather than in its epilogue); var = E[x^2] - E[x]^2 as
// in the JAX kernel. L lanes per segment (8, or NW / 4 below 32 columns), 32 / L segments per
// warp at once, the values held in registers between the two passes. Below MAXW columns gelu
// takes only the columns the segment has; at MAXW (the width class 128) the zeros past them
// too, as that class always has (8x the tanh at 32 columns: half of K1's time at ihc).
constexpr int MAXW = 256;
template <bool GELU, int NW = MAXW>
__device__ void normalize(float* X, int ldx, int rows, int segs, int width) {
  constexpr int L = NW >= 32 ? 8 : NW / 4, SPW = 32 / L, NV = (NW + 4 * L - 1) / (4 * L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane % L;
  const int n_seg = rows * segs;
  for (int base = SPW * warp; base < n_seg; base += SPW * WARPS) {  // warp-uniform: the shuffles see every lane
    const int r = base + lane / L;
    const bool ok = r < n_seg;
    float* row = X + (ok ? (r / segs) * ldx + (r % segs) * width : 0);
    float4 v[NV];
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = 4 * sub + 4 * L * i;
      const bool in = ok && n < width;
      v[i] = in ? *reinterpret_cast<const float4*>(row + n) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (GELU && (in || NW == MAXW))
        v[i] = make_float4(gelu_tanh(v[i].x), gelu_tanh(v[i].y), gelu_tanh(v[i].z), gelu_tanh(v[i].w));
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
      ss = fmaf(v[i].x, v[i].x, fmaf(v[i].y, v[i].y, fmaf(v[i].z, v[i].z, fmaf(v[i].w, v[i].w, ss))));
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mean = s / width;
    const float rstd = 1.0f / sqrtf(ss / width - mean * mean + LN_EPS);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = 4 * sub + 4 * L * i;
      if (ok && n < width)
        *reinterpret_cast<float4*>(row + n) = make_float4((v[i].x - mean) * rstd, (v[i].y - mean) * rstd,
                                                          (v[i].z - mean) * rstd, (v[i].w - mean) * rstd);
    }
  }
}

// normalize<true> of the 32 rows of X, each one segment of `width` (the narrow classes' tail,
// up to MAXW columns): a warp per row, lanes along it, gelu stored back in a first pass and
// normalized in a second, nothing held in registers between them.
__device__ __noinline__ void normalize_rows(float* X, int ldx, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += WARPS) {
    float* row = X + r * ldx;
    float s = 0.0f, ss = 0.0f;
    for (int n = lane; n < width; n += 32) {
      const float v = gelu_tanh(row[n]);
      row[n] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mean = s / width;
    const float rstd = 1.0f / sqrtf(ss / width - mean * mean + LN_EPS);
    for (int n = lane; n < width; n += 32) row[n] = (row[n] - mean) * rstd;
  }
}

// The narrow products on the CUDA cores: for each output o of `count` (one warp per output),
// lane t computes sum_k X(o)[t, k] W(o)[k * ldw] for row t of 32, each operand as the program
// takes it (`operand`; in bf16 the products are exact, the sum f32); store(o, t, value). Lane t
// starts its sum at k = t, so the 32 rows (row stride 4 mod 32 words) hit distinct banks.
// W_SHARED: W(o) lies in shared memory (else global, read through the read-only cache).
template <bool W_SHARED = false, class XOf, class WOf, class Store>
__device__ void lane_dots(int count, int K, int ldw, XOf x_of, WOf w_of, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = warp; o < count; o += WARPS) {
    const float* x = x_of(o, lane);
    const float* w = w_of(o);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = lane % K;
    for (int i = 0; i < K; ++i) {
      s[i & 3] = fmaf(operand(x[k]), operand(W_SHARED ? w[k * ldw] : __ldg(w + k * ldw)), s[i & 3]);
      if (++k == K) k = 0;
    }
    store(o, lane, (s[0] + s[1]) + (s[2] + s[3]));
  }
}

// acc[t, h*D + n] += sum over the np (1 or 2) latents of a pair of prob[z, t, h] *
// (normalize(pre_z,h)[t] @ m_w2 + m_b2)[n]: one product over 2 MT heads and the latents of the
// pair. The tile (wg, mt) holds head h0 + wg + 2 mt; warp w of it coordinates 8 w .. 8 w + 7,
// its rows r and r + 8 the same coordinate in latents 0 and 1 of the pair, so one thread owns
// both latents' sums of an output element.
template <int WN, int MT, bool RES>
__device__ __forceinline__ void mixer(const float* Y, int ldP, int np, int H, int hidm, int D,
                                      const float* __restrict__ m_w2, const float* __restrict__ m_b2,
                                      const float* prob, float* acc, int ldW, float* ring) {
  for (int h0 = 0; h0 < H; h0 += 2 * MT) {
    gemm_wg<WN, MT, RES>(
        [&](int wg, int mt, int w, int r) {
          const int h = min(h0 + wg + 2 * mt, H - 1), t = 8 * w + (r & 7);
          return Y + ((r >= 8 && np > 1 ? TILE : 0) + t) * ldP + h * hidm;
        },
        [&](int wg, int mt) { return h0 + wg + 2 * mt < H; }, hidm, m_w2, D, ring,
        [&](int wg, int mt, int w, int r, int n, float v0, float v1) {
          const int h = h0 + wg + 2 * mt, t = 8 * w + r;
          const float bn = __ldg(m_b2 + n);
          float s = prob[t * H + h] * (v0 + bn);
          if (np > 1) s = fmaf(prob[TILE * H + t * H + h], v1 + bn, s);
          acc[t * ldW + h * D + n] += s;
        });
  }
}

// The width class of a shape: the narrowest of 16, 32, 64 that holds hid, hidm and D, else WG_N.
int width_class(int hid, int hidm, int D) {
  const int w = hid > hidm ? (hid > D ? hid : D) : (hidm > D ? hidm : D);
  return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : WG_N;
}

}  // namespace
