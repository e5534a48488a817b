// Fused ENF decode, forward: CUDA C++ for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_fwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py), whose body is `_tile_decode`. The plain
// PyTorch version of the same function is `fused_decode_plain` in
// enf_pde_tpu_torch/ops/fused_decode.py; the folded inputs (A, ab, G, c and the
// folded weights) come from `fold_decode_weights` there.
//
// What it computes, for each batch row b and coordinate c:
//   per latent z:  hq = relu(sincos(2 pi inv @ q_coeff) @ q_w1 + q_b1)
//                  logit[z, h] = hq @ A[b, z] + ab[b, z] + wb[b, z, c]
//                  t  = normalize(gelu(relu(sincos(2 pi inv @ v_coeff) @ v_w1 + v_b1) @ fw + fb))
//                  pre = gelu(t @ G[b, z] + c[b, z])                   (H heads of width hidm)
//                  vmix[z, h] = normalize(pre_h) @ m_w2 + m_b2          (width D)
//   y[h] = sum_z softmax_z(logit)[z, h] * vmix[z, h]                   (width H*D)
//   with the tail: out = 3-layer gelu head(gelu(normalize(gelu(out_proj(y) @ p_w1 + p_b1))
//                                               @ p_w2 + p_b2))
// `normalize` is a LayerNorm without scale and bias (those are folded into the next
// matmul). The tail is the compile-time flag WITH_TAIL.
//
// Design. One block of 256 threads decodes TILE = 32 coordinates of one batch row;
// the grid is (ceil(C / TILE), B), so neighbouring blocks share a row's A/G/c in L2.
// Activations stay in shared memory: bufA (TILE x hid), bufB and acc (TILE x the
// widest layer, 256 at Navier-Stokes width). Weights cannot all sit on chip (one
// G[b, z] alone is 128 KB), so every dense layer streams its W through a shared
// staging buffer of KC x 128 floats that all 8 warps read: each weight crosses L2
// once per block instead of once per warp. About 98 KB of shared memory a block,
// two blocks per SM. Two passes over the latents: the first computes every logit and
// the softmax over Z, the second the value chains, whose last dense layer adds its
// softmax-weighted output straight into acc (no running rescale, no value buffer).
//
// What bounds it. About 1.42 MFLOP of matmul per decoded point at Navier-Stokes
// width and a few bytes of input per point, so it is bound by operations: every
// dense layer is a [32 x K] @ [K x N] product in f32 FMAs, each warp owning 4 rows
// x 4 strided columns per lane (16 accumulators), reading X as float4 broadcasts and
// W from the staging buffer. This is the simple first version: bf16 operands on the
// tensor cores (wgmma, TMA-staged weights) are the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;              // coordinates per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = TILE / WARPS;      // rows per warp in a dense layer
constexpr int CT = 4;                 // columns per lane: lane + 32 * j
constexpr int SLAB = 32 * CT;         // columns of W per pass
constexpr int KC = 32;                // rows of W per staging step
constexpr float LN_EPS = 1e-6f;       // flax LayerNorm default
constexpr float TWO_PI = 6.283185307179586f;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };
enum { STORE = 0, ACCUM = 1 };

struct Params {
  const float *inv, *wb, *A, *ab, *G, *c;
  const float *q_coeff, *q_w1, *q_b1, *v_coeff, *v_w1, *v_b1, *fw, *fb, *m_w2, *m_b2;
  const float *o_w, *o_b, *p_w1, *p_b1, *p_w2, *p_b2, *h_w1, *h_b1, *h_w2, *h_b2, *h_w3, *h_b3;
  float* out;
  int B, Z, C, I, hid, H, D, hidm, out_dim;
  int ldA, ldB;  // row strides of the shared activation buffers (multiples of 4)
};

constexpr int kNumPtrs = 29;
constexpr int kNumDims = 10;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == ACT_RELU) return fmaxf(x, 0.0f);
  if (ACT == ACT_GELU) return gelu_tanh(x);
  return x;
}

// Y[t, n] = act(sum_k X[t, k] * W[k, n] + bias[n]) for the TILE rows of the block, or
// with MODE == ACCUM: Y[t, n] += scale[t * scale_stride] * (sum_k ... + bias[n]).
// X and Y are in shared memory with row strides ldx / ldy (X != Y); W is [K, N]
// row-major in global memory, staged KC rows x SLAB columns at a time through Ws.
// Needs K % 4 == 0 and ldx % 4 == 0 (float4 reads of X). Every thread of the block
// must call it (it synchronises); it starts with a barrier, so X may have been
// written just before the call.
template <int ACT, int MODE>
__device__ void dense(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                      const float* __restrict__ bias, float* Y, int ldy, float* Ws,
                      const float* scale = nullptr, int scale_stride = 0) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 5) * RT;
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
      for (int idx = tid; idx < kc * SLAB; idx += THREADS) {
        const int kk = idx / SLAB, n = idx - kk * SLAB;
        Ws[idx] = n < ncols ? __ldg(W + (size_t)(k0 + kk) * N + n_base + n) : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 4) {
        float4 xv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          xv[i] = *reinterpret_cast<const float4*>(X + (r0 + i) * ldx + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w[CT];
#pragma unroll
          for (int j = 0; j < CT; ++j) w[j] = Ws[(kk + q) * SLAB + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float x = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
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
        const float bn = __ldg(bias + n_base + n);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float* y = Y + (r0 + i) * ldy + n_base + n;
          if (MODE == ACCUM)
            *y = fmaf(scale[(r0 + i) * scale_stride], acc[i][j] + bn, *y);
          else
            *y = activate<ACT>(acc[i][j] + bn);
        }
      }
    }
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
}

// Normalize-only LayerNorm of each of the `segs` segments of width `width` in every
// row of X, one warp per segment; var = E[x^2] - E[x]^2 as in the JAX kernel.
__device__ void normalize(float* X, int ldx, int segs, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE * segs; r += WARPS) {
    float* row = X + (r / segs) * ldx + (r % segs) * width;
    float s = 0.0f, ss = 0.0f;
    for (int n = lane; n < width; n += 32) {
      const float v = row[n];
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

template <bool WITH_TAIL>
__global__ void __launch_bounds__(THREADS) fused_decode_fwd_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  const int ldA = P.ldA, ldB = P.ldB, Z = P.Z, H = P.H, I = P.I, hid = P.hid, D = P.D;
  const int hidm = P.hidm, HD = H * D, HH = H * hidm;
  float* bufA = smem;                    // [TILE][ldA]
  float* bufB = bufA + TILE * ldA;       // [TILE][ldB]
  float* acc = bufB + TILE * ldB;        // [TILE][ldB]
  float* Ws = acc + TILE * ldB;          // [KC][SLAB] weight staging
  float* s_prob = Ws + KC * SLAB;        // [Z][TILE][H] logits, then softmax weights
  float* s_inv = s_prob + Z * TILE * H;  // [TILE][I]
  const int b = blockIdx.y, c0 = blockIdx.x * TILE, tid = threadIdx.x;
  const int rows = min(TILE, P.C - c0);  // valid coordinates in this tile

  auto load_inv = [&](int z) {
    const float* src = P.inv + ((size_t)(b * Z + z) * P.C + c0) * I;
    for (int idx = tid; idx < TILE * I; idx += THREADS) s_inv[idx] = idx / I < rows ? src[idx] : 0.0f;
  };

  // Pass 1: per-latent logits from the query chain, then the softmax over latents.
  for (int z = 0; z < Z; ++z) {
    const size_t bz = (size_t)b * Z + z;
    load_inv(z);
    __syncthreads();
    rff_features(s_inv, I, P.q_coeff, hid / 2, bufA, ldA);
    dense<ACT_RELU, STORE>(bufA, ldA, hid, P.q_w1, hid, P.q_b1, bufB, ldB, Ws);
    float* logit = s_prob + z * TILE * H;
    dense<ACT_NONE, STORE>(bufB, ldB, hid, P.A + bz * hid * H, H, P.ab + bz * H, logit, H, Ws);
    __syncthreads();
    for (int idx = tid; idx < TILE * H; idx += THREADS) {
      const int t = idx / H;
      if (t < rows) logit[idx] += P.wb[bz * P.C + c0 + t];
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
  for (int idx = tid; idx < TILE * HD; idx += THREADS) acc[(idx / HD) * ldB + idx % HD] = 0.0f;

  // Pass 2: the FiLM-conditioned value chain per latent, weighted into acc.
  for (int z = 0; z < Z; ++z) {
    const size_t bz = (size_t)b * Z + z;
    __syncthreads();
    load_inv(z);
    __syncthreads();
    rff_features(s_inv, I, P.v_coeff, hid / 2, bufA, ldA);
    dense<ACT_RELU, STORE>(bufA, ldA, hid, P.v_w1, hid, P.v_b1, bufB, ldB, Ws);
    dense<ACT_GELU, STORE>(bufB, ldB, hid, P.fw, hid, P.fb, bufA, ldA, Ws);
    __syncthreads();
    normalize(bufA, ldA, 1, hid);
    dense<ACT_GELU, STORE>(bufA, ldA, hid, P.G + bz * hid * HH, HH, P.c + bz * HH, bufB, ldB, Ws);
    __syncthreads();
    normalize(bufB, ldB, H, hidm);
    const float* prob = s_prob + z * TILE * H;
    for (int h = 0; h < H; ++h)  // heads read and write disjoint columns
      dense<ACT_NONE, ACCUM>(bufB + h * hidm, ldB, hidm, P.m_w2, D, P.m_b2, acc + h * D, ldB, Ws,
                             prob + h, H);
  }

  const float* result = acc;
  int width = HD;
  if (WITH_TAIL) {
    dense<ACT_NONE, STORE>(acc, ldB, HD, P.o_w, HD, P.o_b, bufB, ldB, Ws);
    dense<ACT_GELU, STORE>(bufB, ldB, HD, P.p_w1, HD, P.p_b1, acc, ldB, Ws);
    __syncthreads();
    normalize(acc, ldB, 1, HD);
    dense<ACT_GELU, STORE>(acc, ldB, HD, P.p_w2, HD, P.p_b2, bufB, ldB, Ws);
    dense<ACT_GELU, STORE>(bufB, ldB, HD, P.h_w1, hid, P.h_b1, acc, ldB, Ws);
    dense<ACT_GELU, STORE>(acc, ldB, hid, P.h_w2, hid, P.h_b2, bufB, ldB, Ws);
    dense<ACT_NONE, STORE>(bufB, ldB, hid, P.h_w3, P.out_dim, P.h_b3, acc, ldB, Ws);
    width = P.out_dim;
  }
  __syncthreads();
  float* dst = P.out + ((size_t)b * P.C + c0) * width;
  for (int idx = tid; idx < rows * width; idx += THREADS) dst[idx] = result[(idx / width) * ldB + idx % width];
}

}  // namespace

extern "C" {

// Shared memory of one block, in bytes.
size_t fused_decode_fwd_smem_bytes(int Z, int I, int H, int ldA, int ldB) {
  return sizeof(float) * ((size_t)TILE * (ldA + 2 * ldB) + (size_t)KC * SLAB +
                          (size_t)Z * TILE * H + (size_t)TILE * I);
}

// ptrs: inv, wb, A, ab, G, c, the 10 folded weights, the 12 tail weights (null
// without the tail), out. dims: B, Z, C, I, hid, H, D, hidm, out_dim, with_tail.
// Launches on `stream` and returns the cudaError_t of the launch.
int fused_decode_fwd_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                            void* stream) {
  if (n_ptrs != kNumPtrs || n_dims != kNumDims) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  Params P;
  P.inv = f[0]; P.wb = f[1]; P.A = f[2]; P.ab = f[3]; P.G = f[4]; P.c = f[5];
  P.q_coeff = f[6]; P.q_w1 = f[7]; P.q_b1 = f[8];
  P.v_coeff = f[9]; P.v_w1 = f[10]; P.v_b1 = f[11];
  P.fw = f[12]; P.fb = f[13]; P.m_w2 = f[14]; P.m_b2 = f[15];
  P.o_w = f[16]; P.o_b = f[17]; P.p_w1 = f[18]; P.p_b1 = f[19]; P.p_w2 = f[20]; P.p_b2 = f[21];
  P.h_w1 = f[22]; P.h_b1 = f[23]; P.h_w2 = f[24]; P.h_b2 = f[25]; P.h_w3 = f[26]; P.h_b3 = f[27];
  P.out = const_cast<float*>(f[28]);
  P.B = dims[0]; P.Z = dims[1]; P.C = dims[2]; P.I = dims[3]; P.hid = dims[4];
  P.H = dims[5]; P.D = dims[6]; P.hidm = dims[7]; P.out_dim = dims[8];
  const bool with_tail = dims[9] != 0;
  int ld = P.hid > P.H * P.hidm ? P.hid : P.H * P.hidm;
  ld = ld > P.H * P.D ? ld : P.H * P.D;
  P.ldA = P.hid;
  P.ldB = (ld + 3) / 4 * 4;
  if (P.hid % 4 || P.hidm % 4 || P.D % 4 || (with_tail && P.out_dim > P.ldB) || P.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (P.B == 0 || P.C == 0) return (int)cudaSuccess;

  const size_t smem = fused_decode_fwd_smem_bytes(P.Z, P.I, P.H, P.ldA, P.ldB);
  const dim3 grid((P.C + TILE - 1) / TILE, P.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_tail) {
    err = cudaFuncSetAttribute(fused_decode_fwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_decode_fwd_kernel<true><<<grid, THREADS, smem, s>>>(P);
  } else {
    err = cudaFuncSetAttribute(fused_decode_fwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_decode_fwd_kernel<false><<<grid, THREADS, smem, s>>>(P);
  }
  return (int)cudaGetLastError();
}

const char* fused_decode_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
