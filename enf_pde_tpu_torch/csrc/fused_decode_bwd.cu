// Fused ENF decode, backward: CUDA C++ for Hopper (sm_90a), its products on the tensor
// cores at f32 accuracy (3xTF32 mma.sync).
//
// Replaces the TPU kernel `_bwd_kernel` launched by `_bwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py), which recomputes one coordinate tile's forward
// decode and applies its VJP. The plain PyTorch version of the same function is
// `fused_decode_bwd_plain` in enf_pde_tpu_torch/ops/fused_decode.py (autograd over
// `fused_decode_plain`); the forward it differentiates is kernel K1
// (fused_decode_fwd.cu), whose header states the math.
//
// Outputs, for cotangent g [B, C, out]:
//   dinv [B, Z, C, I], dwb [B, Z, C]            one value per coordinate: written once
//   dA, dab, dG, dc    [B, Z, ...]               summed over a batch row's coordinates
//   weight gradients (optional, flag)            summed over every coordinate of the grid
// The RFF coefficients get no gradient (stop_gradient in JAX, fixed buffers here).
//
// The Pallas grid runs in order and carries the sums from one grid step to the next;
// the CUDA grid does not. Deterministic two-pass reduction instead of atomics:
//   pass 1 (`fused_decode_bwd_kernel`): block (b, j) owns batch row b and a contiguous
//     run of 32-coordinate tiles (one at the ode shape: about five rounds of blocks fill
//     the card better than two rounds of longer runs). It keeps t and dpre of its tiles
//     in its workspace and at its end stores dG = t^T dpre and dc = sum dpre, contracted
//     once over all its rows, into its slice of a partial-sum buffer. Tile by tile it adds
//     dA/dab into zeroed sections and the weight gradients into sections that its first
//     contribution stored. No two blocks write the same address.
//   pass 2 (`fused_decode_bwd_reduce`): one thread per output element sums the
//     partials of the row's blocks (per-row gradients) or of all blocks (weights), in
//     a fixed order.
// Per tile, the order the softmax over latents forces:
//   1. logits of every latent (query chain), softmax over Z (narrow [Z, T, H]);
//   2. each latent's value chain, its activations kept, y = sum_z p_z v_z;
//   3. the tail forward (activations kept) and its VJP, giving dy;
//   4. dp_z = <dy, v_z> per head, dlogit_z = p_z (dp_z - sum_z' p_z' dp_z');
//   5. per latent, the VJP of the value chain (cotangent p_z dy) and of the logit chain
//      (cotangent dlogit_z), accumulating dinv over both.
// Hand-written VJPs: sin/cos features (d proj = 2 pi (cos dS - sin dC)), ReLU, tanh-gelu,
// and the scale-free LayerNorm (dx = r (dn - mean(dn) - n mean(dn n))).
//
// Products. Three shapes, all on m16n8k8 TF32 mma.sync through the 3xTF32 helper of
// tf32_mma.cuh (shared with K1): forward layers Y = X W and
// input gradients dX = dY W^T (`dense_tc`: the 32-row tile is two m16 tiles, the 8 warps
// split N, 2 or 4 n8 tiles each), and row contractions out += X^T dY over a tile's or a
// block's rows (`tn_tc`: weight gradients and dG; 64 x 128 output blocks, warps 2 x 4).
// Operands go through shared memory in 16-deep chunks with row strides that make every
// fragment load conflict free; the next chunk's global loads are issued before this
// chunk's products. 3xTF32: each f32 operand x = big + small, both tf32, and
// a b = ab bb + ab bs + as bb with as bs dropped, about 2^-21 relative per product. The
// tensor core aligns its addends to the largest and truncates, so a long sum kept in its
// accumulator drifts toward zero (1.8e-3 rel-L2 on the weight gradients, measured); each
// k step of 8 goes into a fresh accumulator that is added into an f32 register sum, and
// every gradient stays within 2e-6 rel-L2 of autograd in f32.
//
// Memory. One latent's activations at T = 32 (hq, features, hidden, t, pre, mixer,
// v_mix) are about 100 KB and all four with the tail's do not fit in 227 KB of shared
// memory beside the staging. They are not recomputed either: each block keeps them in
// its own slice of a global workspace (about 1.2 MB a block at Navier-Stokes width),
// which it writes once and reads back in step 5 while they are mostly in the 50 MB L2.
// Shared memory (96 KB at that width, two blocks per SM) holds the operand staging, the
// two gradient buffers that every transposed product reads, the logits and softmax
// weights and the tile's invariants.
//
// What bounds it. About 3.1 MFLOP of matmul per point without weight gradients and 4.2
// with them (`decode_bwd_flops_per_point`): bound by operations, 1.9 ms at the ode shape
// on the f32 CUDA cores and 0.8 ms for the three TF32 products of each product on the
// tensor cores. Measured (PERF.md) at several times that: the mma itself is about a third
// of the time, the chunk staging with its barriers and the elementwise passes the rest.
// wgmma with TMA-fed staging is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"  // gelu_tanh, split_tf32, mma_3xtf32 (shared with K1)

namespace {

constexpr int TILE = 32;              // coordinates per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Tensor-core products (3xTF32 mma.sync.m16n8k8): a 32-row tile is two m16 tiles; the 8
// warps split the N columns, NT n8 tiles each.
constexpr int TC_KC = 16;             // k per staging step
constexpr int XS_LD = TC_KC + 4;      // split-X row stride in float2: fragment loads hit 16 distinct 8-byte banks
constexpr int WT_LD = TC_KC + 4;      // transposed W staging Ws[n][k] row stride: 20 g + t covers 32 banks
constexpr int TC_SLAB = 256;          // widest slab (NT = 4)
constexpr int TC_W = (TC_KC * (TC_SLAB + 8) > TC_SLAB * WT_LD) ? TC_KC * (TC_SLAB + 8) : TC_SLAB * WT_LD;
constexpr int STAGE = TC_W + 2 * TILE * XS_LD;  // floats of the staging area
constexpr float LN_EPS = 1e-6f;       // flax LayerNorm default
constexpr float TWO_PI = 6.283185307179586f;
constexpr int kNumPtrs = 34;
constexpr int kNumDims = 11;
constexpr int kTargetBlocks = 1320;   // about five rounds of 2 blocks on each of 132 SMs: a short last round

enum { ACT_NONE = 0, ACT_RELU = 1 };

// Sizes and offsets shared by the host launcher and the kernels.
struct Dims {
  int B, Z, C, I, hid, H, D, hidm, out, tail, wgrad;
  int HD, HH, W;      // H*D, H*hidm, widest gradient row (padded)
  int ntiles, tpb, bpr;  // tiles per row, tiles per block, blocks per row
  // Per-block workspace offsets (floats), each a [TILE][width] buffer (or Z of them; t and
  // dpre: Z x tpb of them, every tile of the block).
  long long o_fq, o_hq, o_fv, o_hv, o_u, o_t, o_dpre, o_pre, o_nn, o_vm, o_rt, o_rm;
  long long o_y, o_dy, o_y1, o_q1, o_t1, o_q2, o_y2, o_q3, o_h1, o_q4, o_h2, o_rt1;
  long long work;     // floats per block
  // Partial / output layout: per-row sections then the weights.
  long long l_A, l_ab, l_G, l_c, l_row;           // per row
  long long w_off[20], w_len[20];                  // weights: 8 attention + 12 tail
  int n_w;
  long long l_w, part;                             // weight floats, partial floats per block
};

__host__ __device__ inline void weight_shapes(const Dims& d, int* rows, int* cols) {
  // q_w1, q_b1, v_w1, v_b1, fw, fb, m_w2, m_b2, o_w, o_b, p_w1, p_b1, p_w2, p_b2,
  // h_w1, h_b1, h_w2, h_b2, h_w3, h_b3 (cols == 0 marks a bias of `rows` entries).
  const int r[20] = {d.hid, d.hid, d.hid, d.hid, d.hid, d.hid, d.hidm, d.D,
                     d.HD, d.HD, d.HD, d.HD, d.HD, d.HD, d.HD, d.hid, d.hid, d.hid, d.hid, d.out};
  const int c[20] = {d.hid, 0, d.hid, 0, d.hid, 0, d.D, 0,
                     d.HD, 0, d.HD, 0, d.HD, 0, d.hid, 0, d.hid, 0, d.out, 0};
  for (int i = 0; i < 20; ++i) { rows[i] = r[i]; cols[i] = c[i]; }
}

inline bool make_dims(const int* v, Dims& d) {
  d.B = v[0]; d.Z = v[1]; d.C = v[2]; d.I = v[3]; d.hid = v[4]; d.H = v[5]; d.D = v[6];
  d.hidm = v[7]; d.out = v[8]; d.tail = v[9] != 0; d.wgrad = v[10] != 0;
  if (d.B <= 0 || d.Z <= 0 || d.C <= 0 || d.I <= 0 || d.H <= 0 || d.out <= 0) return false;
  if (d.hid % 4 || d.hidm % 4 || d.D % 4 || d.hid % 2) return false;
  d.HD = d.H * d.D; d.HH = d.H * d.hidm;
  if (!d.tail && d.out != d.HD) return false;
  int w = d.HD > d.HH ? d.HD : d.HH;
  w = w > d.hid ? w : d.hid;
  w = w > d.out ? w : d.out;
  d.W = (w + 31) / 32 * 32 + 16;  // row stride 16 mod 32: a quarter warp's float4 reads of two rows hit distinct banks
  d.ntiles = (d.C + TILE - 1) / TILE;
  int bpr = (kTargetBlocks + d.B - 1) / d.B;
  bpr = bpr < 1 ? 1 : (bpr > d.ntiles ? d.ntiles : bpr);
  d.tpb = (d.ntiles + bpr - 1) / bpr;
  d.bpr = (d.ntiles + d.tpb - 1) / d.tpb;
  if ((long long)d.B * d.bpr > 2147483647LL) return false;

  const long long T = TILE, Z = d.Z;
  long long o = 0;
  auto take = [&](long long n) { long long r = o; o += (n + 3) / 4 * 4; return r; };
  d.o_fq = take(Z * T * d.hid); d.o_hq = take(Z * T * d.hid);
  d.o_fv = take(Z * T * d.hid); d.o_hv = take(Z * T * d.hid);
  d.o_u = take(Z * T * d.hid);
  // t and dpre of every tile of the block: dG and dc contract over all its rows at its end.
  d.o_t = take(Z * d.tpb * T * d.hid); d.o_dpre = take(Z * d.tpb * T * d.HH);
  d.o_pre = take(Z * T * d.HH); d.o_nn = take(Z * T * d.HH);
  d.o_vm = take(Z * T * d.HD);
  d.o_rt = take(Z * T); d.o_rm = take(Z * T * d.H);
  d.o_y = take(T * d.W); d.o_dy = take(T * d.W);
  d.o_y1 = take(T * d.HD); d.o_q1 = take(T * d.HD); d.o_t1 = take(T * d.HD);
  d.o_q2 = take(T * d.HD); d.o_y2 = take(T * d.HD);
  d.o_q3 = take(T * d.hid); d.o_h1 = take(T * d.hid); d.o_q4 = take(T * d.hid);
  d.o_h2 = take(T * d.hid); d.o_rt1 = take(T);
  d.work = o;

  d.l_A = Z * d.hid * d.H; d.l_ab = Z * d.H; d.l_G = Z * d.hid * d.HH; d.l_c = Z * d.HH;
  d.l_row = d.l_A + d.l_ab + d.l_G + d.l_c;
  int rows[20], cols[20];
  weight_shapes(d, rows, cols);
  d.n_w = d.wgrad ? (d.tail ? 20 : 8) : 0;
  d.l_w = 0;
  for (int i = 0; i < 20; ++i) d.w_off[i] = d.w_len[i] = 0;
  for (int i = 0; i < d.n_w; ++i) {
    d.w_off[i] = d.l_w;
    d.w_len[i] = (long long)rows[i] * (cols[i] ? cols[i] : 1);
    d.l_w += d.w_len[i];
  }
  d.part = d.l_row + d.l_w;
  return true;
}

struct Params {
  const float *inv, *wb, *A, *ab, *G, *c;
  const float *q_coeff, *q_w1, *q_b1, *v_coeff, *v_w1, *v_b1, *fw, *fb, *m_w2, *m_b2;
  const float *o_w, *o_b, *p_w1, *p_b1, *p_w2, *p_b2, *h_w1, *h_b1, *h_w2, *h_b2, *h_w3, *h_b3;
  const float* g;
  float *dinv, *dwb, *out, *work, *part;
  Dims d;
};

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.7978845608028654f;
  const float th = tanhf(k * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * k * (1.0f + 3.0f * 0.044715f * x * x);
}

// One staged k chunk of a dense layer on a warp's 2 x NT tiles: A fragments from the split
// X chunk, B fragments from the W chunk, split here; each k step of 8 into a fresh
// accumulator added into acc.
template <bool TRANS, int NT, int WS_LD>
__device__ __forceinline__ void dense_chunk(float (&acc)[2][NT][4], const float2* Xs, const float* Ws,
                                            int wn0, int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < TC_KC; ks += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float2* xr = Xs + (mi * 16 + g) * XS_LD + ks + tq;
      const float2 v[4] = {xr[0], xr[8 * XS_LD], xr[4], xr[8 * XS_LD + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ab[mi][e] = __float_as_uint(v[e].x);
        as[mi][e] = __float_as_uint(v[e].y);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn0 + 8 * j + g;
      const float w0 = TRANS ? Ws[n * WT_LD + ks + tq] : Ws[(ks + tq) * WS_LD + n];
      const float w1 = TRANS ? Ws[n * WT_LD + ks + tq + 4] : Ws[(ks + tq + 4) * WS_LD + n];
      const float2 s0 = split_tf32(w0), s1 = split_tf32(w1);
      const uint32_t bb[2] = {__float_as_uint(s0.x), __float_as_uint(s1.x)};
      const uint32_t bs[2] = {__float_as_uint(s0.y), __float_as_uint(s1.y)};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(part, ab[mi], as[mi], bb, bs);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[e];
      }
    }
  }
}

__device__ __forceinline__ void store_split4(float2* dst, float4 v) {
  const float2 a = split_tf32(v.x), b = split_tf32(v.y), c = split_tf32(v.z), e = split_tf32(v.w);
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(a.x, a.y, b.x, b.y);
  d4[1] = make_float4(c.x, c.y, e.x, e.y);
}

// Y[t, n] = act(sum_k X[t, k] * W(k, n) + bias[n]) for the TILE rows on the tensor cores,
// W(k, n) = W[k * N + n] or, with TRANS, W[n * K + k]. Per step of TC_KC: the block splits
// the X chunk once into (big, small) pairs (Xs [TILE][XS_LD] float2) and stages the W chunk
// (Ws[k][n], row stride SLAB + 8, or transposed Ws[n][k], row stride WT_LD: either way a
// B-fragment load hits 32 banks); each warp then runs its 2 x NT tiles. When the shapes
// allow 16-byte loads, the next chunk's global loads are issued before this chunk's
// products, so their latency hides behind the tensor cores; ragged K and N take a plain
// path that zero-pads the staging. Every thread of the block calls it; it starts with a
// barrier.
template <int ACT, bool TRANS, int NT>
__device__ __noinline__ void dense_tc(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                      const float* __restrict__ bias, float* Y, int ldy, float* S) {
  constexpr int WN = 8 * NT, SLAB = WARPS * WN, WS_LD = SLAB + 8;
  constexpr int WV = SLAB * TC_KC / 4 / THREADS;  // float4s of W a thread stages per chunk
  static_assert(SLAB <= TC_SLAB && WV * 4 * THREADS == SLAB * TC_KC, "staging shape");
  float* Ws = S;
  float2* Xs = reinterpret_cast<float2*>(S + TC_W);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wn0 = warp * WN;
  const bool fast = K % TC_KC == 0 && ldx % 4 == 0 && aligned16(X) && aligned16(W) &&
                    (TRANS ? true : N % SLAB == 0);
  for (int n_base = 0; n_base < N; n_base += SLAB) {
    const int ncols = min(SLAB, N - n_base);
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
    if (fast) {
      // Thread tid stages X float4 (r, q) = (tid / QK, tid % QK) and W float4s idx = tid +
      // i * THREADS: TRANS (n, q) = (idx / QK, idx % QK), else (kk, q) = (idx / (SLAB / 4), ...).
      constexpr int QK = TC_KC / 4;
      const int xr = tid / QK, xq = tid % QK;
      const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 xv = zero4, wv[WV];
      auto load = [&](int k0) {
        if (tid < TILE * TC_KC / 4) xv = *reinterpret_cast<const float4*>(X + xr * ldx + k0 + 4 * xq);
#pragma unroll
        for (int i = 0; i < WV; ++i) {
          const int idx = tid + i * THREADS;
          if (TRANS) {
            const int n = idx / QK, q = idx % QK;
            wv[i] = n < ncols ? __ldg(reinterpret_cast<const float4*>(W + (size_t)(n_base + n) * K + k0) + q) : zero4;
          } else {
            const int kk = idx / (SLAB / 4), q = idx % (SLAB / 4);
            wv[i] = __ldg(reinterpret_cast<const float4*>(W + (size_t)(k0 + kk) * N + n_base) + q);
          }
        }
      };
      load(0);
      for (int k0 = 0; k0 < K; k0 += TC_KC) {
        __syncthreads();  // earlier readers of Ws / Xs (and writers of X) are done
        if (tid < TILE * TC_KC / 4) store_split4(Xs + xr * XS_LD + 4 * xq, xv);
#pragma unroll
        for (int i = 0; i < WV; ++i) {
          const int idx = tid + i * THREADS;
          float* dst = TRANS ? Ws + (idx / QK) * WT_LD + 4 * (idx % QK)
                             : Ws + (idx / (SLAB / 4)) * WS_LD + 4 * (idx % (SLAB / 4));
          *reinterpret_cast<float4*>(dst) = wv[i];
        }
        __syncthreads();
        if (k0 + TC_KC < K) load(k0 + TC_KC);
        if (wn0 < ncols) dense_chunk<TRANS, NT, WS_LD>(acc, Xs, Ws, wn0, g, tq);
      }
    } else {
      for (int k0 = 0; k0 < K; k0 += TC_KC) {
        const int kc = min(TC_KC, K - k0);
        __syncthreads();
        for (int idx = tid; idx < TILE * TC_KC; idx += THREADS) {
          const int r = idx / TC_KC, kk = idx - r * TC_KC;
          Xs[r * XS_LD + kk] = split_tf32(kk < kc ? X[r * ldx + k0 + kk] : 0.0f);
        }
        for (int idx = tid; idx < SLAB * TC_KC; idx += THREADS) {
          const int a = idx / TC_KC, b = idx - a * TC_KC;  // TRANS: (n, kk); else (kk, n) below
          if (TRANS) {
            Ws[a * WT_LD + b] = a < ncols && b < kc ? __ldg(W + (size_t)(n_base + a) * K + k0 + b) : 0.0f;
          } else {
            const int kk = idx / SLAB, n = idx - kk * SLAB;
            Ws[kk * WS_LD + n] = n < ncols && kk < kc ? __ldg(W + (size_t)(k0 + kk) * N + n_base + n) : 0.0f;
          }
        }
        __syncthreads();
        if (wn0 < ncols) dense_chunk<TRANS, NT, WS_LD>(acc, Xs, Ws, wn0, g, tq);
      }
    }
    if (wn0 < ncols) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn0 + 8 * j + 2 * tq + e;
          if (n >= ncols) continue;
          const float bn = bias ? __ldg(bias + n_base + n) : 0.0f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = acc[mi][j][2 * h + e] + bn;
              Y[(mi * 16 + g + 8 * h) * ldy + n_base + n] = ACT == ACT_RELU ? fmaxf(v, 0.0f) : v;
            }
        }
    }
  }
  __syncthreads();
}

// Every dense layer and input gradient of K2: four n8 tiles a warp when N fills them.
template <int ACT, bool TRANS>
__device__ __forceinline__ void dense(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                      const float* __restrict__ bias, float* Y, int ldy, float* S) {
  if (N > 8 * WARPS * 2)
    dense_tc<ACT, TRANS, 4>(X, ldx, K, W, N, bias, Y, ldy, S);
  else
    dense_tc<ACT, TRANS, 2>(X, ldx, K, W, N, bias, Y, ldy, S);
}

// Staging of the row-contracting product: RC rows of an X block [RC][TN_M] split into
// (big, small) pairs (row stride TN_M + 4 float2: A fragments read (r, m) with lanes
// 68 t + g, 16 distinct 8-byte banks) and of a dY block [RC][TN_N] (row stride TN_N + 8:
// B fragments hit 32 banks).
constexpr int TN_RC = 16, TN_M = 64, TN_N = 128;
constexpr int TN_XLD = TN_M + 4, TN_YLD = TN_N + 8;
static_assert(2 * TN_RC * TN_XLD + TN_RC * TN_YLD <= STAGE, "row-product staging must fit");

// out[m, n] (+)= sum_{r < R} X[r, m] * dY[r, n] for m < M, n < N on the tensor cores at f32
// accuracy (ACC adds into out, else stores); out is block private, row stride ldo. Output
// blocks of TN_M x TN_N; the 8 warps as 2 (m) x 4 (n), each 32 x 32 (2 x 4 tiles). Rows go
// in chunks of TN_RC, the next chunk's global loads issued before this chunk's products
// when the shapes allow 16-byte loads. Every thread of the block calls it.
template <bool ACC>
__device__ __noinline__ void tn_tc(const float* X, int ldx, const float* dY, int ldy, int R, int M, int N,
                                   float* out, int ldo, float* S) {
  float2* Xs = reinterpret_cast<float2*>(S);   // [TN_RC][TN_XLD]
  float* Ys = S + 2 * TN_RC * TN_XLD;          // [TN_RC][TN_YLD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const bool fast = M % 4 == 0 && N % 4 == 0 && ldx % 4 == 0 && ldy % 4 == 0 && aligned16(X) && aligned16(dY);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // Thread tid stages X float4 (r, q) = (tid / 16, tid % 16) and dY float4s idx = tid, tid + 256:
  // (r, q) = (idx / 32, idx % 32).
  const int xr = tid >> 4, xq = tid & 15;
  for (int m0 = 0; m0 < M; m0 += TN_M) {
    for (int n0 = 0; n0 < N; n0 += TN_N) {
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
      float4 xv = zero4, yv[2] = {zero4, zero4};
      auto load = [&](int r0) {
        const int r = r0 + xr, m = m0 + 4 * xq;
        xv = r < R && m < M ? *reinterpret_cast<const float4*>(X + (size_t)r * ldx + m) : zero4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = tid + i * THREADS, rr = r0 + (idx >> 5), n = n0 + 4 * (idx & 31);
          yv[i] = rr < R && n < N ? *reinterpret_cast<const float4*>(dY + (size_t)rr * ldy + n) : zero4;
        }
      };
      if (fast) load(0);
      for (int r0 = 0; r0 < R; r0 += TN_RC) {
        __syncthreads();  // earlier readers of the staging (and writers of X, dY) are done
        if (fast) {
          store_split4(Xs + xr * TN_XLD + 4 * xq, xv);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = tid + i * THREADS;
            *reinterpret_cast<float4*>(Ys + (idx >> 5) * TN_YLD + 4 * (idx & 31)) = yv[i];
          }
        } else {
          for (int idx = tid; idx < TN_RC * TN_M; idx += THREADS) {
            const int r = idx / TN_M, m = idx - r * TN_M;
            Xs[r * TN_XLD + m] = split_tf32(r0 + r < R && m0 + m < M ? X[(size_t)(r0 + r) * ldx + m0 + m] : 0.0f);
          }
          for (int idx = tid; idx < TN_RC * TN_N; idx += THREADS) {
            const int r = idx / TN_N, n = idx - r * TN_N;
            Ys[r * TN_YLD + n] = r0 + r < R && n0 + n < N ? dY[(size_t)(r0 + r) * ldy + n0 + n] : 0.0f;
          }
        }
        __syncthreads();
        if (fast && r0 + TN_RC < R) load(r0 + TN_RC);
#pragma unroll
        for (int ks = 0; ks < TN_RC; ks += 8) {
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float2* xr2 = Xs + (ks + tq) * TN_XLD + wm + 16 * mi + g;
            const float2 v[4] = {xr2[0], xr2[8], xr2[4 * TN_XLD], xr2[4 * TN_XLD + 8]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ab[mi][e] = __float_as_uint(v[e].x);
              as[mi][e] = __float_as_uint(v[e].y);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* yr = Ys + (ks + tq) * TN_YLD + wn + 8 * j + g;
            const float2 s0 = split_tf32(yr[0]), s1 = split_tf32(yr[4 * TN_YLD]);
            const uint32_t bb[2] = {__float_as_uint(s0.x), __float_as_uint(s1.x)};
            const uint32_t bs[2] = {__float_as_uint(s0.y), __float_as_uint(s1.y)};
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_3xtf32(part, ab[mi], as[mi], bb, bs);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[e];
            }
          }
        }
      }
      // With ACC, every old value is read before any is written: a load and a store
      // through one pointer would otherwise run one round trip at a time.
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * mi + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + wn + 8 * j + 2 * tq + e;
              if (ACC && m < M && n < N) acc[mi][j][2 * h + e] += out[(size_t)m * ldo + n];
            }
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * mi + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + wn + 8 * j + 2 * tq + e;
              if (m < M && n < N) out[(size_t)m * ldo + n] = acc[mi][j][2 * h + e];
            }
        }
    }
  }
  __syncthreads();
}

// A weight gradient over the tile: dW[k, n] (+)= sum_t X[t, k] * dY[t, n] (dW [K, N], block
// private) and db[n] (+)= sum_t dY[t, n] when db is not null; the block's first
// contribution stores (add false), the later ones add.
__device__ void wgrad(const float* X, int ldx, int K, const float* dY, int ldy, int N,
                      float* dW, float* db, float* S, bool add) {
  if (add)
    tn_tc<true>(X, ldx, dY, ldy, TILE, K, N, dW, N, S);
  else
    tn_tc<false>(X, ldx, dY, ldy, TILE, K, N, dW, N, S);
  if (db) {
    for (int n = threadIdx.x; n < N; n += THREADS) {
      float s = 0.0f;
      for (int t = 0; t < TILE; ++t) s += dY[t * ldy + n];
      db[n] = add ? db[n] + s : s;
    }
    __syncthreads();
  }
}

// F[t, :half] = sin(2 pi inv[t] @ coeff), F[t, half:] = cos(...); coeff is [I, half].
__device__ void rff_features(const float* s_inv, int I, const float* __restrict__ coeff,
                             int half, float* F, int ldf) {
  for (int idx = threadIdx.x; idx < TILE * half; idx += THREADS) {
    const int t = idx / half, j = idx - t * half;
    float proj = 0.0f;
    for (int i = 0; i < I; ++i) proj = fmaf(s_inv[t * I + i], __ldg(coeff + i * half + j), proj);
    float s, co;
    sincosf(TWO_PI * proj, &s, &co);
    F[t * ldf + j] = s;
    F[t * ldf + half + j] = co;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// s_dinv[t, i] += sum_j 2 pi (cos_j dF[t, j] - sin_j dF[t, half + j]) coeff[i, j], with
// sin / cos read back from the features F. A warp per row, lanes along j.
__device__ void rff_features_vjp(const float* F, int ldf, const float* dF, int ldd,
                                 const float* __restrict__ coeff, int half, int I, float* s_dinv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TILE; t += WARPS) {
    const float* f = F + t * ldf;
    const float* df = dF + t * ldd;
    for (int i = 0; i < I; ++i) {
      float s = 0.0f;
      for (int j = lane; j < half; j += 32) {
        const float dproj = TWO_PI * (f[half + j] * df[j] - f[j] * df[half + j]);
        s = fmaf(dproj, __ldg(coeff + i * half + j), s);
      }
      s = warp_sum(s);
      if (lane == 0) s_dinv[t * I + i] += s;
    }
  }
  __syncthreads();
}

// Row passes: one warp per row segment, two rows at a time. At the widths of the model
// (a multiple of 128 floats) a lane keeps its 16-byte pieces of both rows in registers, so
// each row costs one round trip to the workspace; other widths take a plain loop.
template <int V>  // float4s a lane holds per row: width = 128 V
__device__ __forceinline__ void load_row(float4 (&v)[V], const float* x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = *reinterpret_cast<const float4*>(x + 128 * k + 4 * lane);
}
template <int V>
__device__ __forceinline__ void store_row(float* y, const float4 (&v)[V]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < V; ++k) *reinterpret_cast<float4*>(y + 128 * k + 4 * lane) = v[k];
}
#define K2_F4(OP) OP(x) OP(y) OP(z) OP(w)

// Y[t, :] = normalize(gelu(X[t, :])) over `segs` segments of `width`; var = E[x^2] - E[x]^2
// as in the JAX kernel; rstd[t * segs + s] kept.
template <int V>
__device__ __noinline__ void gelu_normalize_v(const float* X, float* Y, int ld, int segs, float* rstd) {
  constexpr int width = 128 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < TILE * segs; r0 += 2 * WARPS) {  // TILE * segs is a multiple of 2 WARPS
    float4 v[2][V];
    float s[2], ss[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i * WARPS;
      load_row<V>(v[i], X + (r / segs) * ld + (r % segs) * width);
      s[i] = ss[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
#define K2_GELU(c) v[i][k].c = gelu_tanh(v[i][k].c); s[i] += v[i][k].c; ss[i] = fmaf(v[i][k].c, v[i][k].c, ss[i]);
        K2_F4(K2_GELU)
#undef K2_GELU
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i * WARPS;
      const float mean = warp_sum(s[i]) / width;
      const float r_ = 1.0f / sqrtf(warp_sum(ss[i]) / width - mean * mean + LN_EPS);
#pragma unroll
      for (int k = 0; k < V; ++k) {
#define K2_NORM(c) v[i][k].c = (v[i][k].c - mean) * r_;
        K2_F4(K2_NORM)
#undef K2_NORM
      }
      store_row<V>(Y + (r / segs) * ld + (r % segs) * width, v[i]);
      if (lane == 0) rstd[r] = r_;
    }
  }
  __syncthreads();
}

__device__ void gelu_normalize(const float* X, float* Y, int ld, int segs, int width, float* rstd) {
  if (width == 128 && ld % 4 == 0 && aligned16(X) && aligned16(Y)) return gelu_normalize_v<1>(X, Y, ld, segs, rstd);
  if (width == 256 && ld % 4 == 0 && aligned16(X) && aligned16(Y)) return gelu_normalize_v<2>(X, Y, ld, segs, rstd);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE * segs; r += WARPS) {
    const float* x = X + (r / segs) * ld + (r % segs) * width;
    float* y = Y + (r / segs) * ld + (r % segs) * width;
    float s = 0.0f, ss = 0.0f;
    for (int n = lane; n < width; n += 32) {
      const float v = gelu_tanh(x[n]);
      y[n] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
    const float mean = warp_sum(s) / width;
    const float r_ = 1.0f / sqrtf(warp_sum(ss) / width - mean * mean + LN_EPS);
    for (int n = lane; n < width; n += 32) y[n] = (y[n] - mean) * r_;
    if (lane == 0) rstd[r] = r_;
  }
  __syncthreads();
}

// In place: dX[t, :] = gelu'(P[t, :]) * r (dN - mean(dN) - N mean(dN N)) per segment,
// the VJP of N = normalize(gelu(P)) with N and r kept from the forward; also written to
// `copy` (row stride ld) when given.
template <int V>
__device__ __noinline__ void gelu_normalize_vjp_v(float* dX, int ldd, const float* P, const float* Nn, int ld,
                                                  int segs, const float* rstd, float* copy) {
  constexpr int width = 128 * V;
  const int warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < TILE * segs; r0 += 2 * WARPS) {
    float4 dx[2][V], nn[2][V], p[2][V];
    float s[2], sn[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i * WARPS, t = r / segs, o = (r % segs) * width;
      load_row<V>(dx[i], dX + t * ldd + o);
      load_row<V>(nn[i], Nn + t * ld + o);
      load_row<V>(p[i], P + t * ld + o);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] = sn[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
#define K2_SUMS(c) s[i] += dx[i][k].c; sn[i] = fmaf(dx[i][k].c, nn[i][k].c, sn[i]);
        K2_F4(K2_SUMS)
#undef K2_SUMS
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i * WARPS, t = r / segs, o = (r % segs) * width;
      const float ms = warp_sum(s[i]) / width, msn = warp_sum(sn[i]) / width, r_ = rstd[r];
#pragma unroll
      for (int k = 0; k < V; ++k) {
#define K2_VJP(c) dx[i][k].c = r_ * (dx[i][k].c - ms - nn[i][k].c * msn) * gelu_tanh_grad(p[i][k].c);
        K2_F4(K2_VJP)
#undef K2_VJP
      }
      store_row<V>(dX + t * ldd + o, dx[i]);
      if (copy) store_row<V>(copy + t * ld + o, dx[i]);
    }
  }
  __syncthreads();
}

__device__ void gelu_normalize_vjp(float* dX, int ldd, const float* P, const float* Nn, int ld,
                                   int segs, int width, const float* rstd, float* copy = nullptr) {
  const bool vec = ld % 4 == 0 && ldd % 4 == 0 && aligned16(dX) && aligned16(P) && aligned16(Nn) &&
                   aligned16(copy);
  if (width == 128 && vec) return gelu_normalize_vjp_v<1>(dX, ldd, P, Nn, ld, segs, rstd, copy);
  if (width == 256 && vec) return gelu_normalize_vjp_v<2>(dX, ldd, P, Nn, ld, segs, rstd, copy);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE * segs; r += WARPS) {
    float* dx = dX + (r / segs) * ldd + (r % segs) * width;
    const float* p = P + (r / segs) * ld + (r % segs) * width;
    const float* nn = Nn + (r / segs) * ld + (r % segs) * width;
    float s = 0.0f, sn = 0.0f;
    for (int n = lane; n < width; n += 32) {
      s += dx[n];
      sn = fmaf(dx[n], nn[n], sn);
    }
    const float ms = warp_sum(s) / width, msn = warp_sum(sn) / width, r_ = rstd[r];
    float* cp = copy ? copy + (r / segs) * ld + (r % segs) * width : nullptr;
    for (int n = lane; n < width; n += 32) {
      dx[n] = r_ * (dx[n] - ms - nn[n] * msn) * gelu_tanh_grad(p[n]);
      if (cp) cp[n] = dx[n];
    }
  }
  __syncthreads();
}

// Elementwise passes over [TILE][width]: a warp per row, lanes along it.
__device__ void gelu_rows(const float* X, float* Y, int ld, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TILE; t += WARPS)
#pragma unroll 4
    for (int n = lane; n < width; n += 32) Y[t * ld + n] = gelu_tanh(X[t * ld + n]);
  __syncthreads();
}

// dX *= gelu'(P).
__device__ void mul_gelu_grad(float* dX, int ldd, const float* P, int ld, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TILE; t += WARPS)
#pragma unroll 4
    for (int n = lane; n < width; n += 32) dX[t * ldd + n] *= gelu_tanh_grad(P[t * ld + n]);
  __syncthreads();
}

// dX *= (H > 0): the ReLU's VJP from its output.
__device__ void mul_relu_grad(float* dX, int ldd, const float* Hh, int ld, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TILE; t += WARPS)
#pragma unroll 4
    for (int n = lane; n < width; n += 32)
      if (!(Hh[t * ld + n] > 0.0f)) dX[t * ldd + n] = 0.0f;
  __syncthreads();
}

template <bool WITH_TAIL, bool WGRAD>
__global__ void __launch_bounds__(THREADS, 2) fused_decode_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int Z = d.Z, H = d.H, I = d.I, hid = d.hid, D = d.D, hidm = d.hidm;
  const int HD = d.HD, HH = d.HH, Wd = d.W, half = hid / 2;
  float* Ws = smem;                          // [STAGE] staging, also wgrad's operands
  float* GA = Ws + STAGE;                    // [TILE][W] gradient ping-pong buffers: the X
  float* GB = GA + TILE * Wd;                // of every dX = dY W^T, the dY of every wgrad
  float* s_prob = GB + TILE * Wd;            // [Z][TILE][H] softmax weights
  float* s_dlog = s_prob + Z * TILE * H;     // [Z][TILE][H] logit gradients
  float* s_inv = s_dlog + Z * TILE * H;      // [TILE][I]
  float* s_dinv = s_inv + TILE * I;          // [TILE][I]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / d.bpr, j = blockIdx.x % d.bpr;
  float* work = P.work + (size_t)blockIdx.x * d.work;
  float* part = P.part + (size_t)blockIdx.x * d.part;
  float* pA = part;
  float* pab = pA + d.l_A;
  float* pG = pab + d.l_ab;
  float* pc = pG + d.l_G;
  float* pw = part + d.l_row;
  // Zero dA and dab, which every tile adds into. The weight sections are stored by the
  // block's first contribution and added into after; dG and dc are stored whole at its end.
  for (long long idx = tid; idx < d.l_A + d.l_ab; idx += THREADS) part[idx] = 0.0f;

  const size_t zT = (size_t)TILE;
  float *FQ = work + d.o_fq, *HQ = work + d.o_hq, *FV = work + d.o_fv, *HV = work + d.o_hv;
  float *U = work + d.o_u, *TT = work + d.o_t, *DPRE = work + d.o_dpre, *PRE = work + d.o_pre;
  float *NN = work + d.o_nn;
  float *VM = work + d.o_vm, *RTs = work + d.o_rt, *RM = work + d.o_rm;
  float *Y = work + d.o_y, *DY = work + d.o_dy;
  float *Y1 = work + d.o_y1, *Q1 = work + d.o_q1, *T1 = work + d.o_t1, *Q2 = work + d.o_q2;
  float *Y2 = work + d.o_y2, *Q3 = work + d.o_q3, *H1 = work + d.o_h1, *Q4 = work + d.o_q4;
  float *H2 = work + d.o_h2, *RT1 = work + d.o_rt1;
  // Weight partials (only read when WGRAD).
  float* wq_w1 = pw + d.w_off[0];
  float* wq_b1 = pw + d.w_off[1];
  float* wv_w1 = pw + d.w_off[2];
  float* wv_b1 = pw + d.w_off[3];
  float* wfw = pw + d.w_off[4];
  float* wfb = pw + d.w_off[5];
  float* wm_w2 = pw + d.w_off[6];
  float* wm_b2 = pw + d.w_off[7];

  const int tile0 = j * d.tpb, tile1 = min(d.ntiles, (j + 1) * d.tpb);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int c0 = tile * TILE;
    const size_t tl = tile - tile0;  // the tile's place in the block's kept t and dpre rows
    const int rows = min(TILE, d.C - c0);
    __syncthreads();

    // 1. Logits of every latent, then the softmax over latents.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      const float* src = P.inv + (bz * d.C + c0) * I;
      for (int idx = tid; idx < TILE * I; idx += THREADS) s_inv[idx] = idx / I < rows ? src[idx] : 0.0f;
      __syncthreads();
      float* fq = FQ + z * zT * hid;
      float* hq = HQ + z * zT * hid;
      rff_features(s_inv, I, P.q_coeff, half, fq, hid);
      dense<ACT_RELU, false>(fq, hid, hid, P.q_w1, hid, P.q_b1, hq, hid, Ws);
      float* logit = s_prob + z * TILE * H;
      dense<ACT_NONE, false>(hq, hid, hid, P.A + bz * hid * H, H, P.ab + bz * H, logit, H, Ws);
      for (int idx = tid; idx < TILE * H; idx += THREADS) {
        const int t = idx / H;
        if (t < rows) logit[idx] += P.wb[bz * d.C + c0 + t];
      }
      __syncthreads();
    }
    for (int idx = tid; idx < TILE * H; idx += THREADS) {
      float m = -INFINITY;
      for (int z = 0; z < Z; ++z) m = fmaxf(m, s_prob[z * TILE * H + idx]);
      float sum = 0.0f;
      for (int z = 0; z < Z; ++z) {
        const float e = expf(s_prob[z * TILE * H + idx] - m);
        s_prob[z * TILE * H + idx] = e;
        sum += e;
      }
      for (int z = 0; z < Z; ++z) s_prob[z * TILE * H + idx] /= sum;
    }
    for (int idx = tid; idx < TILE * Wd; idx += THREADS) Y[idx] = 0.0f;
    __syncthreads();

    // 2. Value chains, activations kept; y = sum_z p_z v_z.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      const float* src = P.inv + (bz * d.C + c0) * I;
      for (int idx = tid; idx < TILE * I; idx += THREADS) s_inv[idx] = idx / I < rows ? src[idx] : 0.0f;
      __syncthreads();
      float *fv = FV + z * zT * hid, *hv = HV + z * zT * hid, *u = U + z * zT * hid;
      float *tt = TT + (z * d.tpb + tl) * zT * hid;
      float *pre = PRE + z * zT * HH, *nn = NN + z * zT * HH, *vm = VM + z * zT * HD;
      rff_features(s_inv, I, P.v_coeff, half, fv, hid);
      dense<ACT_RELU, false>(fv, hid, hid, P.v_w1, hid, P.v_b1, hv, hid, Ws);
      dense<ACT_NONE, false>(hv, hid, hid, P.fw, hid, P.fb, u, hid, Ws);
      gelu_normalize(u, tt, hid, 1, hid, RTs + z * TILE);
      dense<ACT_NONE, false>(tt, hid, hid, P.G + bz * hid * HH, HH, P.c + bz * HH, pre, HH, Ws);
      gelu_normalize(pre, nn, HH, H, hidm, RM + z * TILE * H);
      for (int h = 0; h < H; ++h)
        dense<ACT_NONE, false>(nn + h * hidm, HH, hidm, P.m_w2, D, P.m_b2, vm + h * D, HD, Ws);
      const float* prob = s_prob + z * TILE * H;
      for (int idx = tid; idx < TILE * HD; idx += THREADS) {
        const int t = idx / HD, n = idx - t * HD;
        Y[t * Wd + n] = fmaf(prob[t * H + n / D], vm[idx], Y[t * Wd + n]);
      }
      __syncthreads();
    }

    // 3. The tail forward and its VJP: dy.
    {
      const float* gsrc = P.g + ((size_t)b * d.C + c0) * d.out;
      for (int idx = tid; idx < TILE * d.out; idx += THREADS) {
        const int t = idx / d.out, n = idx - t * d.out;
        (WITH_TAIL ? GA : DY)[t * Wd + n] = t < rows ? gsrc[idx] : 0.0f;
      }
      __syncthreads();
    }
    if (WITH_TAIL) {
      const int out = d.out;
      dense<ACT_NONE, false>(Y, Wd, HD, P.o_w, HD, P.o_b, Y1, HD, Ws);
      dense<ACT_NONE, false>(Y1, HD, HD, P.p_w1, HD, P.p_b1, Q1, HD, Ws);
      gelu_normalize(Q1, T1, HD, 1, HD, RT1);
      dense<ACT_NONE, false>(T1, HD, HD, P.p_w2, HD, P.p_b2, Q2, HD, Ws);
      gelu_rows(Q2, Y2, HD, HD);
      dense<ACT_NONE, false>(Y2, HD, HD, P.h_w1, hid, P.h_b1, Q3, hid, Ws);
      gelu_rows(Q3, H1, hid, hid);
      dense<ACT_NONE, false>(H1, hid, hid, P.h_w2, hid, P.h_b2, Q4, hid, Ws);
      gelu_rows(Q4, H2, hid, hid);
      // GA = g. Head layer 3, 2, 1, block FFN dense 2 and 1, out-projection.
      if (WGRAD) wgrad(H2, hid, hid, GA, Wd, out, pw + d.w_off[18], pw + d.w_off[19], Ws, tile > tile0);
      dense<ACT_NONE, true>(GA, Wd, out, P.h_w3, hid, nullptr, GB, Wd, Ws);
      mul_gelu_grad(GB, Wd, Q4, hid, hid);
      if (WGRAD) wgrad(H1, hid, hid, GB, Wd, hid, pw + d.w_off[16], pw + d.w_off[17], Ws, tile > tile0);
      dense<ACT_NONE, true>(GB, Wd, hid, P.h_w2, hid, nullptr, GA, Wd, Ws);
      mul_gelu_grad(GA, Wd, Q3, hid, hid);
      if (WGRAD) wgrad(Y2, HD, HD, GA, Wd, hid, pw + d.w_off[14], pw + d.w_off[15], Ws, tile > tile0);
      dense<ACT_NONE, true>(GA, Wd, hid, P.h_w1, HD, nullptr, GB, Wd, Ws);
      mul_gelu_grad(GB, Wd, Q2, HD, HD);
      if (WGRAD) wgrad(T1, HD, HD, GB, Wd, HD, pw + d.w_off[12], pw + d.w_off[13], Ws, tile > tile0);
      dense<ACT_NONE, true>(GB, Wd, HD, P.p_w2, HD, nullptr, GA, Wd, Ws);
      gelu_normalize_vjp(GA, Wd, Q1, T1, HD, 1, HD, RT1);
      if (WGRAD) wgrad(Y1, HD, HD, GA, Wd, HD, pw + d.w_off[10], pw + d.w_off[11], Ws, tile > tile0);
      dense<ACT_NONE, true>(GA, Wd, HD, P.p_w1, HD, nullptr, GB, Wd, Ws);
      if (WGRAD) wgrad(Y, Wd, HD, GB, Wd, HD, pw + d.w_off[8], pw + d.w_off[9], Ws, tile > tile0);
      dense<ACT_NONE, true>(GB, Wd, HD, P.o_w, HD, nullptr, DY, Wd, Ws);
    }

    // 4. Softmax VJP: dp_z = <dy, v_z> per head, dlogit_z = p_z (dp_z - sum_z' p_z' dp_z').
    // A warp per (z, t, h), lanes along the head, four at a time.
    for (int i0 = (tid >> 5) * 4; i0 < Z * TILE * H; i0 += WARPS * 4) {
      float s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = min(i0 + u, Z * TILE * H - 1);
        const int z = idx / (TILE * H), r = idx - z * TILE * H, t = r / H, h = r - t * H;
        const float* vm = VM + z * zT * HD + t * HD + h * D;
        const float* dy = DY + t * Wd + h * D;
        s[u] = 0.0f;
        for (int n = tid & 31; n < D; n += 32) s[u] = fmaf(dy[n], vm[n], s[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[u] = warp_sum(s[u]);
        if ((tid & 31) == 0 && i0 + u < Z * TILE * H) s_dlog[i0 + u] = s[u];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < TILE * H; idx += THREADS) {
      float s = 0.0f;
      for (int z = 0; z < Z; ++z) s = fmaf(s_prob[z * TILE * H + idx], s_dlog[z * TILE * H + idx], s);
      for (int z = 0; z < Z; ++z) {
        const int k = z * TILE * H + idx;
        s_dlog[k] = s_prob[k] * (s_dlog[k] - s);
      }
    }
    __syncthreads();

    // 5. Per latent: the value chain's and the logit chain's VJPs.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      float *fq = FQ + z * zT * hid, *hq = HQ + z * zT * hid;
      float *fv = FV + z * zT * hid, *hv = HV + z * zT * hid, *u = U + z * zT * hid;
      float *tt = TT + (z * d.tpb + tl) * zT * hid;
      float *pre = PRE + z * zT * HH, *nn = NN + z * zT * HH;
      const float* prob = s_prob + z * TILE * H;
      const float* dlog = s_dlog + z * TILE * H;
      for (int idx = tid; idx < TILE * I; idx += THREADS) s_dinv[idx] = 0.0f;
      // dv_mix = p_z dy, per head.
      for (int idx = tid; idx < TILE * HD; idx += THREADS) {
        const int t = idx / HD, n = idx - t * HD;
        GA[t * Wd + n] = prob[t * H + n / D] * DY[t * Wd + n];
      }
      __syncthreads();
      for (int h = 0; h < H; ++h) {
        if (WGRAD)
          wgrad(nn + h * hidm, HH, hidm, GA + h * D, Wd, D, wm_w2, wm_b2, Ws, tile > tile0 || z > 0 || h > 0);
        dense<ACT_NONE, true>(GA + h * D, Wd, D, P.m_w2, hidm, nullptr, GB + h * hidm, Wd, Ws);
      }
      gelu_normalize_vjp(GB, Wd, pre, nn, HH, H, hidm, RM + z * TILE * H,  // GB = dpre, kept
                         DPRE + (z * d.tpb + tl) * zT * HH);
      dense<ACT_NONE, true>(GB, Wd, HH, P.G + bz * hid * HH, hid, nullptr, GA, Wd, Ws);  // dt
      gelu_normalize_vjp(GA, Wd, u, tt, hid, 1, hid, RTs + z * TILE);                     // du
      if (WGRAD) wgrad(hv, hid, hid, GA, Wd, hid, wfw, wfb, Ws, tile > tile0 || z > 0);
      dense<ACT_NONE, true>(GA, Wd, hid, P.fw, hid, nullptr, GB, Wd, Ws);
      mul_relu_grad(GB, Wd, hv, hid, hid);
      if (WGRAD) wgrad(fv, hid, hid, GB, Wd, hid, wv_w1, wv_b1, Ws, tile > tile0 || z > 0);
      dense<ACT_NONE, true>(GB, Wd, hid, P.v_w1, hid, nullptr, GA, Wd, Ws);  // dF (value)
      rff_features_vjp(fv, hid, GA, Wd, P.v_coeff, half, I, s_dinv);
      // Logit chain: dA, dab, dwb, then back through the query RFF net. GA and GB
      // take row stride Wd; the narrow [TILE][H] products are plain loops.
      const float* Az = P.A + bz * hid * H;
      float* pAz = pA + (size_t)z * hid * H;
      for (int idx = tid; idx < hid * H; idx += THREADS) {
        const int k = idx / H, h = idx - k * H;
        float s = 0.0f;
        for (int t = 0; t < TILE; ++t) s = fmaf(hq[t * hid + k], dlog[t * H + h], s);
        pAz[idx] += s;
      }
      for (int h = tid; h < H; h += THREADS) {
        float s = 0.0f;
        for (int t = 0; t < TILE; ++t) s += dlog[t * H + h];
        pab[z * H + h] += s;
      }
      for (int t = tid; t < rows; t += THREADS) {
        float s = 0.0f;
        for (int h = 0; h < H; ++h) s += dlog[t * H + h];
        P.dwb[bz * d.C + c0 + t] = s;
      }
      for (int idx = tid; idx < TILE * hid; idx += THREADS) {
        const int t = idx / hid, k = idx - t * hid;
        float s = 0.0f;
        for (int h = 0; h < H; ++h) s = fmaf(dlog[t * H + h], __ldg(Az + k * H + h), s);
        GB[t * Wd + k] = hq[t * hid + k] > 0.0f ? s : 0.0f;
      }
      __syncthreads();
      if (WGRAD) wgrad(fq, hid, hid, GB, Wd, hid, wq_w1, wq_b1, Ws, tile > tile0 || z > 0);
      dense<ACT_NONE, true>(GB, Wd, hid, P.q_w1, hid, nullptr, GA, Wd, Ws);  // dF (query)
      rff_features_vjp(fq, hid, GA, Wd, P.q_coeff, half, I, s_dinv);
      float* dst = P.dinv + (bz * d.C + c0) * I;
      for (int idx = tid; idx < rows * I; idx += THREADS) dst[idx] = s_dinv[idx];
      __syncthreads();
    }
  }

  // dG = t^T dpre and dc = sum dpre over every row of the block's tiles, once per latent.
  // Padded rows (past C) have dpre = 0: their cotangent is 0.
  const int R = (tile1 - tile0) * TILE;
  for (int z = 0; z < Z; ++z) {
    const float* tt = TT + (size_t)z * d.tpb * TILE * hid;
    const float* dpre = DPRE + (size_t)z * d.tpb * TILE * HH;
    tn_tc<false>(tt, hid, dpre, HH, R, hid, HH, pG + (size_t)z * hid * HH, HH, Ws);
    for (int n = tid; n < HH; n += THREADS) {
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s += dpre[(size_t)r * HH + n];
      pc[(size_t)z * HH + n] = s;
    }
  }
}

// Pass 2: out = [dA | dab | dG | dc] over all rows (each [B, Z, ...]), then the weight
// gradients; each element sums its blocks' partials in block order.
__global__ void fused_decode_bwd_reduce(const float* __restrict__ part, float* __restrict__ out,
                                        const Dims d) {
  const long long n_row = (long long)d.B * d.l_row;
  const long long total = n_row + d.l_w;
  const long long sec_len[4] = {d.l_A, d.l_ab, d.l_G, d.l_c};
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (o < n_row) {
      long long rem = o, sec_off = 0;
      int sec = 0;
      while (rem >= (long long)d.B * sec_len[sec]) {
        rem -= (long long)d.B * sec_len[sec];
        sec_off += sec_len[sec];
        ++sec;
      }
      const long long b = rem / sec_len[sec], e = rem - b * sec_len[sec];
      for (int j = 0; j < d.bpr; ++j) s += part[(b * d.bpr + j) * d.part + sec_off + e];
    } else {
      const long long e = d.l_row + (o - n_row);
      const long long nblk = (long long)d.B * d.bpr;
      for (long long k = 0; k < nblk; ++k) s += part[k * d.part + e];
    }
    out[o] = s;
  }
}

size_t smem_bytes(const Dims& d) {
  return sizeof(float) * ((size_t)STAGE + 2 * (size_t)TILE * d.W + 2 * (size_t)d.Z * TILE * d.H +
                          2 * (size_t)TILE * d.I);
}

template <bool T, bool W>
cudaError_t launch_main(const Params& P, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(fused_decode_bwd_kernel<T, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_decode_bwd_kernel<T, W><<<P.d.B * P.d.bpr, THREADS, smem, s>>>(P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: B, Z, C, I, hid, H, D, hidm, out_dim, with_tail, weight_grads.
// sizes <- floats of the reduced output, of the workspace and of the partials.
int fused_decode_bwd_sizes(const int* dims, int n_dims, long long* sizes) {
  Dims d;
  if (n_dims != kNumDims || !make_dims(dims, d)) return (int)cudaErrorInvalidValue;
  sizes[0] = (long long)d.B * d.l_row + d.l_w;
  sizes[1] = (long long)d.B * d.bpr * d.work;
  sizes[2] = (long long)d.B * d.bpr * d.part;
  return 0;
}

// ptrs: inv, wb, A, ab, G, c, the 10 folded weights, the 12 tail weights (null
// without the tail), g, dinv, dwb, out (reduced gradients), workspace, partials;
// sized by `fused_decode_bwd_sizes`. Launches both passes on `stream` and returns the
// cudaError_t of the launches.
int fused_decode_bwd_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                            void* stream) {
  Params P;
  if (n_ptrs != kNumPtrs || n_dims != kNumDims || !make_dims(dims, P.d)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  P.inv = f[0]; P.wb = f[1]; P.A = f[2]; P.ab = f[3]; P.G = f[4]; P.c = f[5];
  P.q_coeff = f[6]; P.q_w1 = f[7]; P.q_b1 = f[8];
  P.v_coeff = f[9]; P.v_w1 = f[10]; P.v_b1 = f[11];
  P.fw = f[12]; P.fb = f[13]; P.m_w2 = f[14]; P.m_b2 = f[15];
  P.o_w = f[16]; P.o_b = f[17]; P.p_w1 = f[18]; P.p_b1 = f[19]; P.p_w2 = f[20]; P.p_b2 = f[21];
  P.h_w1 = f[22]; P.h_b1 = f[23]; P.h_w2 = f[24]; P.h_b2 = f[25]; P.h_w3 = f[26]; P.h_b3 = f[27];
  P.g = f[28];
  P.dinv = const_cast<float*>(f[29]); P.dwb = const_cast<float*>(f[30]);
  P.out = const_cast<float*>(f[31]); P.work = const_cast<float*>(f[32]);
  P.part = const_cast<float*>(f[33]);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(P.d);
  cudaError_t err;
  if (P.d.tail)
    err = P.d.wgrad ? launch_main<true, true>(P, smem, s) : launch_main<true, false>(P, smem, s);
  else
    err = P.d.wgrad ? launch_main<false, true>(P, smem, s) : launch_main<false, false>(P, smem, s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)P.d.B * P.d.l_row + P.d.l_w;
  long long blocks = (total + THREADS - 1) / THREADS;
  blocks = blocks > 4096 ? 4096 : (blocks < 1 ? 1 : blocks);
  fused_decode_bwd_reduce<<<(int)blocks, THREADS, 0, s>>>(P.part, P.out, P.d);
  return (int)cudaGetLastError();
}

const char* fused_decode_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
