// Fused ENF decode, backward: CUDA C++ for Hopper (sm_90a), f32 on the CUDA cores.
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
//     run of 32-coordinate tiles; it zeroes its own slice of a partial-sum buffer and
//     adds every tile's dA/dab/dG/dc (and weight) gradients into it. No two blocks
//     write the same address.
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
// Memory. One latent's activations at T = 32 (hq, features, hidden, t, pre, mixer,
// v_mix) are about 100 KB and all four with the tail's do not fit in 227 KB of shared
// memory beside the weight staging. They are not recomputed either: each block keeps
// them in its own slice of a global workspace (about 1.1 MB a block at Navier-Stokes
// width), which it writes once and reads back in step 5 while they are mostly in the
// 50 MB L2. Shared memory (85 KB at that width, two blocks per SM) holds the weight
// staging buffer (also the wgrad operand tiles), the two gradient buffers that every
// transposed product reads, the logits and softmax weights and the tile's invariants.
//
// What bounds it. About 3.1 MFLOP of matmul per point without weight gradients and
// 4.2 with them (`decode_bwd_flops_per_point`): bound by operations, like K1. Every
// product is f32 FMAs: dense layers and input gradients (dX = dY W^T) stream W
// through the shared staging buffer as K1 does; weight gradients (dW += X^T dY) run
// 64 x 64 output blocks over the tile's 32 rows with a 4 x 4 register tile per
// thread and add into the block's partial. The global workspace costs about 2 MB of
// L2/HBM traffic per tile, under 1 ms at the ode shape. Measured at half K1's rate
// per FLOP (PERF.md); right and simple first: the tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;              // coordinates per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = TILE / WARPS;      // rows per warp in a dense layer
constexpr int CT = 4;                 // columns per lane: lane + 32 * j
constexpr int SLAB = 32 * CT;         // columns of W per pass
constexpr int KC = 32;                // rows of W per staging step
// Row stride of the staging buffer: the transposed staging (dX = dY W^T) writes a
// column, and 129 puts its 32 lanes in 32 banks (128 would put them all in one).
constexpr int WS_LD = SLAB + 1;
constexpr int WB = 64;                // wgrad output block edge
constexpr float LN_EPS = 1e-6f;       // flax LayerNorm default
constexpr float TWO_PI = 6.283185307179586f;
constexpr int kNumPtrs = 34;
constexpr int kNumDims = 11;
constexpr int kTargetBlocks = 528;    // about two rounds of 2 blocks on each of 132 SMs

enum { ACT_NONE = 0, ACT_RELU = 1 };

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// Sizes and offsets shared by the host launcher and the kernels.
struct Dims {
  int B, Z, C, I, hid, H, D, hidm, out, tail, wgrad;
  int HD, HH, W;      // H*D, H*hidm, widest gradient row (padded)
  int ntiles, tpb, bpr;  // tiles per row, tiles per block, blocks per row
  // Per-block workspace offsets (floats), each a [TILE][width] buffer (or Z of them).
  long long o_fq, o_hq, o_fv, o_hv, o_u, o_t, o_pre, o_nn, o_vm, o_rt, o_rm;
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
  d.W = pad4(w);
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
  d.o_u = take(Z * T * d.hid);  d.o_t = take(Z * T * d.hid);
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.7978845608028654f;
  const float th = tanhf(k * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * k * (1.0f + 3.0f * 0.044715f * x * x);
}

// Y[t, n] = act(sum_k X[t, k] * W(k, n) + bias[n]) for the TILE rows, where W(k, n) is
// W[k * N + n] (a forward layer, W [K, N]) or, with TRANS, W[n * K + k] (an input
// gradient dX = dY W^T of a forward layer W [N, K]). bias may be null. X and Y are
// block-private rows (shared or global workspace) with row strides ldx / ldy, X != Y;
// W streams through the staging buffer Ws. Any K (float4 reads of X when K % 4 == 0
// and ldx % 4 == 0). Every thread of the block calls it; it starts with a barrier.
template <int ACT, bool TRANS>
__device__ __noinline__ void dense(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                      const float* __restrict__ bias, float* Y, int ldy, float* Ws) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 5) * RT;
  const bool vec = (K % 4 == 0) && (ldx % 4 == 0);
  for (int n_base = 0; n_base < N; n_base += SLAB) {
    const int ncols = min(SLAB, N - n_base);
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      __syncthreads();  // earlier readers of Ws (and writers of X) are done
      if (TRANS) {
        for (int idx = tid; idx < kc * SLAB; idx += THREADS) {
          const int n = idx / kc, kk = idx - n * kc;  // consecutive threads: consecutive k
          Ws[kk * WS_LD + n] = n < ncols ? __ldg(W + (size_t)(n_base + n) * K + k0 + kk) : 0.0f;
        }
      } else {
        for (int idx = tid; idx < kc * SLAB; idx += THREADS) {
          const int kk = idx / SLAB, n = idx - kk * SLAB;
          Ws[kk * WS_LD + n] = n < ncols ? __ldg(W + (size_t)(k0 + kk) * N + n_base + n) : 0.0f;
        }
      }
      __syncthreads();
      if (vec) {
        for (int kk = 0; kk < kc; kk += 4) {
          float4 xv[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            xv[i] = *reinterpret_cast<const float4*>(X + (r0 + i) * ldx + k0 + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float w[CT];
#pragma unroll
            for (int j = 0; j < CT; ++j) w[j] = Ws[(kk + q) * WS_LD + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float x = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
              for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
            }
          }
        }
      } else {
        for (int kk = 0; kk < kc; ++kk) {
          float w[CT];
#pragma unroll
          for (int j = 0; j < CT; ++j) w[j] = Ws[kk * WS_LD + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float x = X[(r0 + i) * ldx + k0 + kk];
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int n = lane + 32 * j;
      if (n < ncols) {
        const float bn = bias ? __ldg(bias + n_base + n) : 0.0f;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float v = acc[i][j] + bn;
          Y[(r0 + i) * ldy + n_base + n] = ACT == ACT_RELU ? fmaxf(v, 0.0f) : v;
        }
      }
    }
  }
  __syncthreads();
}

// dW[k, n] += sum_t X[t, k] * dY[t, n] over the TILE rows (dW [K, N] row-major, block
// private), and db[n] += sum_t dY[t, n] when db is not null. Operand tiles of
// TILE x 64 go through the staging buffer S (2 * TILE * WB floats).
__device__ __noinline__ void wgrad(const float* X, int ldx, int K, const float* dY, int ldy, int N,
                      float* dW, float* db, float* S) {
  const int tid = threadIdx.x;
  float* Xs = S;              // [TILE][WB]
  float* Ys = S + TILE * WB;  // [TILE][WB]
  const int kg = (tid / 16) * 4, ng = (tid % 16) * 4;
  for (int kb = 0; kb < K; kb += WB) {
    for (int nb = 0; nb < N; nb += WB) {
      __syncthreads();
      for (int idx = tid; idx < TILE * WB; idx += THREADS) {
        const int t = idx / WB, j = idx - t * WB;
        Xs[idx] = kb + j < K ? X[t * ldx + kb + j] : 0.0f;
        Ys[idx] = nb + j < N ? dY[t * ldy + nb + j] : 0.0f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int t = 0; t < TILE; ++t) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + t * WB + kg);
        const float4 yv = *reinterpret_cast<const float4*>(Ys + t * WB + ng);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kb + kg + i;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nb + ng + j;
          if (n < N) dW[(size_t)k * N + n] += acc[i][j];
        }
      }
    }
  }
  if (db) {
    __syncthreads();
    for (int n = tid; n < N; n += THREADS) {
      float s = 0.0f;
      for (int t = 0; t < TILE; ++t) s += dY[t * ldy + n];
      db[n] += s;
    }
  }
  __syncthreads();
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

// s_dinv[t, i] += sum_j 2 pi (cos_j dF[t, j] - sin_j dF[t, half + j]) coeff[i, j], with
// sin / cos read back from the features F.
__device__ void rff_features_vjp(const float* F, int ldf, const float* dF, int ldd,
                                 const float* __restrict__ coeff, int half, int I, float* s_dinv) {
  for (int idx = threadIdx.x; idx < TILE * I; idx += THREADS) {
    const int t = idx / I, i = idx - t * I;
    const float* f = F + t * ldf;
    const float* df = dF + t * ldd;
    float s = 0.0f;
    for (int j = 0; j < half; ++j) {
      const float dproj = TWO_PI * (f[half + j] * df[j] - f[j] * df[half + j]);
      s = fmaf(dproj, __ldg(coeff + i * half + j), s);
    }
    s_dinv[idx] += s;
  }
  __syncthreads();
}

// Y[t, :] = normalize(gelu(X[t, :])) over `segs` segments of `width`, one warp per
// segment; var = E[x^2] - E[x]^2 as in the JAX kernel; rstd[t * segs + s] kept.
__device__ void gelu_normalize(const float* X, float* Y, int ld, int segs, int width, float* rstd) {
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
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mean = s / width;
    const float r_ = 1.0f / sqrtf(ss / width - mean * mean + LN_EPS);
    for (int n = lane; n < width; n += 32) y[n] = (y[n] - mean) * r_;
    if (lane == 0) rstd[r] = r_;
  }
  __syncthreads();
}

// In place: dX[t, :] = gelu'(P[t, :]) * r (dN - mean(dN) - N mean(dN N)) per segment,
// the VJP of N = normalize(gelu(P)) with N and r kept from the forward.
__device__ void gelu_normalize_vjp(float* dX, int ldd, const float* P, const float* Nn, int ld,
                                   int segs, int width, const float* rstd) {
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
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sn += __shfl_xor_sync(0xffffffffu, sn, o);
    }
    const float ms = s / width, msn = sn / width, r_ = rstd[r];
    for (int n = lane; n < width; n += 32)
      dx[n] = r_ * (dx[n] - ms - nn[n] * msn) * gelu_tanh_grad(p[n]);
  }
  __syncthreads();
}

__device__ void gelu_rows(const float* X, float* Y, int ld, int width) {
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    Y[t * ld + n] = gelu_tanh(X[t * ld + n]);
  }
  __syncthreads();
}

// dX *= gelu'(P), elementwise over [TILE][width].
__device__ void mul_gelu_grad(float* dX, int ldd, const float* P, int ld, int width) {
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    dX[t * ldd + n] *= gelu_tanh_grad(P[t * ld + n]);
  }
  __syncthreads();
}

// dX *= (H > 0), elementwise: the ReLU's VJP from its output.
__device__ void mul_relu_grad(float* dX, int ldd, const float* Hh, int ld, int width) {
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int t = idx / width, n = idx - t * width;
    if (!(Hh[t * ld + n] > 0.0f)) dX[t * ldd + n] = 0.0f;
  }
  __syncthreads();
}

template <bool WITH_TAIL, bool WGRAD>
__global__ void __launch_bounds__(THREADS, 2) fused_decode_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int Z = d.Z, H = d.H, I = d.I, hid = d.hid, D = d.D, hidm = d.hidm;
  const int HD = d.HD, HH = d.HH, Wd = d.W, half = hid / 2;
  float* Ws = smem;                          // [KC][WS_LD] staging, also wgrad's operands
  float* GA = Ws + KC * WS_LD;               // [TILE][W] gradient ping-pong buffers: the X
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
  for (long long idx = tid; idx < d.part; idx += THREADS) part[idx] = 0.0f;

  const size_t zT = (size_t)TILE;
  float *FQ = work + d.o_fq, *HQ = work + d.o_hq, *FV = work + d.o_fv, *HV = work + d.o_hv;
  float *U = work + d.o_u, *TT = work + d.o_t, *PRE = work + d.o_pre, *NN = work + d.o_nn;
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

  for (int tile = j * d.tpb; tile < min(d.ntiles, (j + 1) * d.tpb); ++tile) {
    const int c0 = tile * TILE;
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
      float *fv = FV + z * zT * hid, *hv = HV + z * zT * hid, *u = U + z * zT * hid, *tt = TT + z * zT * hid;
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
      if (WGRAD) wgrad(H2, hid, hid, GA, Wd, out, pw + d.w_off[18], pw + d.w_off[19], Ws);
      dense<ACT_NONE, true>(GA, Wd, out, P.h_w3, hid, nullptr, GB, Wd, Ws);
      mul_gelu_grad(GB, Wd, Q4, hid, hid);
      if (WGRAD) wgrad(H1, hid, hid, GB, Wd, hid, pw + d.w_off[16], pw + d.w_off[17], Ws);
      dense<ACT_NONE, true>(GB, Wd, hid, P.h_w2, hid, nullptr, GA, Wd, Ws);
      mul_gelu_grad(GA, Wd, Q3, hid, hid);
      if (WGRAD) wgrad(Y2, HD, HD, GA, Wd, hid, pw + d.w_off[14], pw + d.w_off[15], Ws);
      dense<ACT_NONE, true>(GA, Wd, hid, P.h_w1, HD, nullptr, GB, Wd, Ws);
      mul_gelu_grad(GB, Wd, Q2, HD, HD);
      if (WGRAD) wgrad(T1, HD, HD, GB, Wd, HD, pw + d.w_off[12], pw + d.w_off[13], Ws);
      dense<ACT_NONE, true>(GB, Wd, HD, P.p_w2, HD, nullptr, GA, Wd, Ws);
      gelu_normalize_vjp(GA, Wd, Q1, T1, HD, 1, HD, RT1);
      if (WGRAD) wgrad(Y1, HD, HD, GA, Wd, HD, pw + d.w_off[10], pw + d.w_off[11], Ws);
      dense<ACT_NONE, true>(GA, Wd, HD, P.p_w1, HD, nullptr, GB, Wd, Ws);
      if (WGRAD) wgrad(Y, Wd, HD, GB, Wd, HD, pw + d.w_off[8], pw + d.w_off[9], Ws);
      dense<ACT_NONE, true>(GB, Wd, HD, P.o_w, HD, nullptr, DY, Wd, Ws);
    }

    // 4. Softmax VJP: dp_z = <dy, v_z> per head, dlogit_z = p_z (dp_z - sum_z' p_z' dp_z').
    for (int idx = tid; idx < Z * TILE * H; idx += THREADS) {
      const int z = idx / (TILE * H), r = idx - z * TILE * H, t = r / H, h = r - t * H;
      const float* vm = VM + z * zT * HD + t * HD + h * D;
      const float* dy = DY + t * Wd + h * D;
      float s = 0.0f;
      for (int n = 0; n < D; ++n) s = fmaf(dy[n], vm[n], s);
      s_dlog[idx] = s;
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
      float *fv = FV + z * zT * hid, *hv = HV + z * zT * hid, *u = U + z * zT * hid, *tt = TT + z * zT * hid;
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
        if (WGRAD) wgrad(nn + h * hidm, HH, hidm, GA + h * D, Wd, D, wm_w2, wm_b2, Ws);
        dense<ACT_NONE, true>(GA + h * D, Wd, D, P.m_w2, hidm, nullptr, GB + h * hidm, Wd, Ws);
      }
      gelu_normalize_vjp(GB, Wd, pre, nn, HH, H, hidm, RM + z * TILE * H);  // GB = dpre
      wgrad(tt, hid, hid, GB, Wd, HH, pG + (size_t)z * hid * HH, pc + (size_t)z * HH, Ws);
      dense<ACT_NONE, true>(GB, Wd, HH, P.G + bz * hid * HH, hid, nullptr, GA, Wd, Ws);  // dt
      gelu_normalize_vjp(GA, Wd, u, tt, hid, 1, hid, RTs + z * TILE);                     // du
      if (WGRAD) wgrad(hv, hid, hid, GA, Wd, hid, wfw, wfb, Ws);
      dense<ACT_NONE, true>(GA, Wd, hid, P.fw, hid, nullptr, GB, Wd, Ws);
      mul_relu_grad(GB, Wd, hv, hid, hid);
      if (WGRAD) wgrad(fv, hid, hid, GB, Wd, hid, wv_w1, wv_b1, Ws);
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
      if (WGRAD) wgrad(fq, hid, hid, GB, Wd, hid, wq_w1, wq_b1, Ws);
      dense<ACT_NONE, true>(GB, Wd, hid, P.q_w1, hid, nullptr, GA, Wd, Ws);  // dF (query)
      rff_features_vjp(fq, hid, GA, Wd, P.q_coeff, half, I, s_dinv);
      float* dst = P.dinv + (bz * d.C + c0) * I;
      for (int idx = tid; idx < rows * I; idx += THREADS) dst[idx] = s_dinv[idx];
      __syncthreads();
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
  static_assert(2 * TILE * WB <= KC * WS_LD, "wgrad's operand tiles must fit in the staging buffer");
  return sizeof(float) * ((size_t)KC * WS_LD + 2 * (size_t)TILE * d.W + 2 * (size_t)d.Z * TILE * d.H +
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
