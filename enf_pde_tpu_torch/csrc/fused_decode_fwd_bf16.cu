// Fused ENF decode, forward, the bf16 program: CUDA C++ for Hopper (sm_90a), its products on
// the tensor cores with bf16 operands and f32 accumulation, as the JAX kernel runs on its chip
// (`fused_enf_decode(compute_dtype=jnp.bfloat16)`, the default; the decoder's `pallas` backend).
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_fwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py) in its bf16 mode, whose body is `_tile_decode` with
// `_Spec.compute_dtype` bf16. The plain PyTorch version of the same function is
// `fused_decode_plain(..., compute_dtype=torch.bfloat16)` in enf_pde_tpu_torch/ops/fused_decode.py.
// The f32 program (3xTF32, the `pallas_interpret` backend's) is fused_decode_fwd.cu, whose header
// states the math; fused_decode_fwd_common.cuh and fused_decode_fwd_host.cuh hold what the two
// programs share (constants, Params, cp.async and wgmma helpers, the launcher). What the bf16 mode
// changes, and this source with it:
//   - every product operand is rounded to bf16 (bf16_mma.cuh): the RFF features, the hidden
//     layers, the normalized activations, the folded A and G, the tail's activations and every
//     weight; the products are exact and their sums f32. The RFF projection, the biases, gelu,
//     the LayerNorm statistics and the softmax stay f32;
//   - sin and cos of the RFF features by the polynomial of `_fast_sincos` (fast_sincos);
//   - the softmax weights rounded to bf16 before they weight the values. That rounding needs
//     each weight whole, so the softmax is not taken online: a first pass over the latents takes
//     every latent's logits (the query chain) into shared memory ([Z][64][H]), the softmax over Z
//     follows, and a second pass takes the value chains. Where the logits do not fit beside the
//     rest, they go to a workspace in global memory that the wrapper allocates (a slot of
//     [Z][64][H] for each block of the persistent grid), read back by the block that wrote them:
//     the layout does not depend on Z, and every Z that the f32 program takes, this one takes.
// Both designs below walk work items of 64 coordinates of a batch row (32 where items of 64 would
// leave half of the grid's slots idle) on persistent blocks of two warpgroups; every product is a
// bf16 wgmma with A and B in shared memory (no mma.sync, nothing rounded in registers): A an
// activation stored in bf16 by the epilogue before it (`a16_index`), B a weight in bf16 blocks as
// wgmma reads them (`bf16_weights`, and G and the tail's weights laid out by `k1_operands` in
// fused_decode.py, once a decode or once a launch). gelu, the LayerNorm statistics, the logits and
// the mixer's weighted sum come from the accumulator registers in the epilogues: no row pass over
// shared memory but the RFF features and the softmax.
//   - The width class 128 (NS, SW, nonmaml, abs_pos; `decode128`): each product's columns split
//     between the warpgroups (an n64 half each, m64n64k16), a LayerNorm's row sums exchanged between
//     them, m_w2 resident, the rest streamed by each warpgroup through its own ring. hidm or D past
//     128 (up to 256) launch an instantiation of its own (WIDE128): a head of G and m_w2 in two
//     128-column slabs, each warpgroup's columns in two n64 parts, m_w2 streamed.
//   - The narrow classes 16, 32, 64 (diff_sphere, ihc, the planar configs; `decode_narrow`): a
//     latent a warpgroup, each product one m64nWNk16 as wide as the class (a row whole in a quad of
//     threads: a LayerNorm's statistics are two shuffles), the shared weights resident, a latent's G
//     copied by cp.async a latent ahead, the tail's layers a weight at a time, their WN-wide column
//     slabs split between the warpgroups.
// Shared memory (k1_smem_bytes mirrors it, with compute_dtype=torch.bfloat16), and every latent's
// logits where they fit:
//   class 128 (SMEM128: two bf16 operand buffers of 64 x 256, the attention output [64][264] f32,
//     m_w2's 32 KB, two rings of STAGES128 4 KB chunks, the row sums' exchange): NS (I 4, hid 128,
//     H 2, z 4) 202,752 B; shallow water (z 8) 204,800 B; one block an SM; past z = 62 at NS width
//     the logits go to global memory (200,704 B);
//   narrow (`narrow_layout`): ihc (hid 32, H 3, z 25) 111,360 B, two blocks an SM (BLOCKS32); diff_sphere
//     (hid 16, H 2, z 18) 44,032 B, three (BLOCKS16); cahn_hilliard (hid 64, H 2, z 9) 174,592 B and
//     diffusion_plane (z 4) 172,032 B, one (BLOCKS64). The logits take the room of BLOCKS blocks an SM or
//     go to global memory.
// Accuracy: against the plain bf16 version on the card the gates are relative to the bf16
// function's own distance from f32 (two right bf16 programs differ by chaotic roundings):
// chip_smoke.py's phase 35.
// What bounds it: the products at the bf16 rate, 0.1172 ms at NS 160 x 512 (NVIDIA H100 80GB HBM3,
// 700 W); at the narrow classes the CUDA-core work (the features' sin and cos, gelu, the LayerNorms,
// the softmax) comes nearer (PERF.md §6). Measured (PERF.md §6, NVIDIA H100 80GB HBM3 at
// 700.00 W): the class 128 1.7590 ms at NS 160 x 512 (15.0x the bound; 3.26-3.35 ms in its earlier design);
// the narrow classes PERF.md's table.

#include "fused_decode_fwd_common.cuh"  // constants, Params, staging, row passes, mixer (shared with the f32 program)
#include "bf16_mma.cuh"                  // bf16_round, wgmma_bf16_ss64, wgmma_bf16_ss, fast_sincos

namespace {

// The narrow classes' blocks an SM (`narrow_slots`), and the room an SM's shared memory gives a block:
// SM_SHARED bytes, SM_KEPT of them kept back for each block.
constexpr int BLOCKS16 = 3;
constexpr int BLOCKS32 = 2;
constexpr int BLOCKS64 = 1;
constexpr int SM_SHARED = 233472;
constexpr int SM_KEPT = 1024;

// A class's blocks an SM: what __launch_bounds__ makes room for, and what `narrow_slots` plans (one at the class 128).
__host__ __device__ constexpr int narrow_blocks(int wn) {
  return wn == 16 ? BLOCKS16 : wn == 32 ? BLOCKS32 : wn == 64 ? BLOCKS64 : 1;
}

// The hooks of fused_decode_fwd_common.cuh: operands rounded to bf16, sin and cos by the bf16
// mode's polynomial (`_fast_sincos`).
__device__ __forceinline__ float operand(float x) { return bf16_round(x); }
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c) { fast_sincos(proj, s, c); }


// ---- The width class 128 (NS, SW, nonmaml, abs_pos): 64-row tiles, bf16 in shared memory ------------
// A work item is 64 coordinates of a batch row (32 where items of 64 would leave half the grid's slots
// idle: `item_tile`), decoded a latent at a time as m64 tiles. Every product is a bf16 wgmma m64n64k16
// with both operands in shared memory: A (the activations) in the layout a16_index gives, B (a weight)
// as bf16_weights blocks it. Each product's columns are split between the two warpgroups, an n64 half
// each (a 128-column slab each for the tail's layers of N = 256, in two parts), and each warpgroup
// streams its own half of B (cp.async into its ring, its own named barrier). The activations whose
// next use is a product operand are stored in bf16 (the number JAX's cast gives). gelu, the LayerNorm
// statistics and the logits come from the accumulator registers in the product's epilogue: a row of
// an m64 tile lies in one quad of threads of each warpgroup (two shuffles, then one exchange between
// the warpgroups through shared memory, `row_sums`). m_w2 stays resident; the rest streams from L2.
constexpr int TILE128 = 64;     // rows of a work item's tiles
constexpr int WIDE128 = 2 * WG_N;  // the class 128's instantiation for hidm or D past 128 (K1_WIDE_CLASS)
constexpr int STAGES128 = 4;    // chunks of a warpgroup's ring (4 KB each); copies run STAGES128 - 2 ahead
constexpr int FRESH_ACC = 0;    // 1: each 16-deep k step's product in a fresh accumulator, summed in f32 registers
constexpr int LDA128 = 264;     // floats a row of the attention output (8 mod 32: its float2 updates conflict free)
constexpr int A16_BYTES = TILE128 * 2 * WG_N * 2;  // one bf16 operand buffer: 64 rows x 256 columns
constexpr int CHUNK16 = 16 * WG_N * 2;             // bytes of a 16 x 128 bf16 chunk
constexpr int SMEM128 = 2 * A16_BYTES + 4 * TILE128 * LDA128 + 8 * CHUNK16 + 2 * STAGES128 * CHUNK16 + 4 * 8 * TILE128;
static_assert(STAGES128 >= 3, "ring128");

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// Element (r, k) of a 64-row bf16 operand in shared memory, as wgmma reads A without swizzle: core
// matrices of 8 rows x 8 k (128 bytes), the row groups of a k group 128 bytes apart (SBO), the k groups
// 1,024 bytes apart (LBO); a 16-deep k step starts 2,048 bytes after the last.
__device__ __forceinline__ int a16_index(int r, int k) { return ((((k >> 3) << 3) + (r >> 3)) << 6) + ((r & 7) << 3) + (k & 7); }
constexpr int A16_LBO = 1024, A16_SBO = 128, A16_KSTEP = 1024;  // bytes, bytes, bf16 elements
__device__ __forceinline__ uint64_t a16_desc(const bf16* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(A16_LBO >> 4) << 16) | ((uint64_t)(A16_SBO >> 4) << 32);
}
__device__ __forceinline__ void wg_bar(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
__device__ __forceinline__ void store2(bf16* buf, int r, int n, float v0, float v1) {
  *reinterpret_cast<bf162*>(buf + a16_index(r, n)) = __floats2bfloat162_rn(v0, v1);
}
// Two neighbouring f32 values (an even column of a bias, of c or of A's rows) in one load.
__device__ __forceinline__ float2 ldg2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }


// A warpgroup's stream of B operand chunks into its ring of STAGES128 stages of 4 KB: a chunk is two k
// steps of an n64 column half (16 x 64 bf16, 2 KB each), step ks read from `src` + ks * `kstride`; the
// copies run STAGES128 - 2 chunks ahead of the products.
struct Stream {
  float* ring;
  const float* src;
  int kstride, nks, nc, issued, bar, lt;
};
__device__ __forceinline__ void issue(Stream& s) {
  if (s.issued < s.nc) {
    float* st = s.ring + (s.issued % STAGES128) * (CHUNK16 / 4);
    for (int p = 0; p < 2; ++p) {
      const int ks = 2 * s.issued + p;
      if (ks < s.nks) {
        const float* src = s.src + (size_t)ks * s.kstride;
        cp_async16(st + p * (CHUNK16 / 8) + 4 * s.lt, src + 4 * s.lt, true);  // 128 threads x 16 bytes
      }
    }
  }
  ++s.issued;
  cp_async_commit();  // an empty group past the end keeps the wait count uniform
}
// A product's first STAGES128 - 2 chunks in flight, before the work that precedes it: B's columns
// [64 h, 64 h + 64) of a 128-column slab whose 16-row blocks lie `kstride` floats apart, K = 16 nks.
__device__ __forceinline__ void prime(Stream& s, const float* slab, int kstride, int h, int nks) {
  s.src = slab + h * (CHUNK16 / 8);
  s.kstride = kstride;
  s.nks = nks;
  s.nc = (nks + 1) / 2;
  s.issued = 0;
  for (int c = 0; c < STAGES128 - 2; ++c) issue(s);
}

// The wgmma of k steps ks0 .. ks0 + n - 1: acc (this thread's 32 values of a 64 x 64 tile) = or += A
// (a16 at `a`) x B (step p's 16 x 64 block at `b` + p `bstep` floats), issued back to back behind one
// fence and committed as one group: a slab's whole sum in the wgmma accumulator. FRESH_ACC (the rule
// K2 takes; ROADMAP Queue 2, item 8; k1_compare's variant `fresh`): each step's product in a fresh
// accumulator (the tensor cores sum its 16 products exactly, truncating as they align them), added
// to acc in f32 after it completes, step by step, two steps a group.
__device__ __forceinline__ void steps_product(float (&acc)[32], const bf16* a, const float* b, int bstep, int ks0, int n) {
  if constexpr (FRESH_ACC) {
    for (int p0 = 0; p0 < n; p0 += 2) {
      float part[2][32];
      const bool two = p0 + 1 < n;
      wg_fence_operands<32>(part[0]);
      wg_fence_operands<32>(part[1]);
      wg_fence();
      wgmma_bf16_ss64(part[0], a16_desc(a + (ks0 + p0) * A16_KSTEP), wg_desc(b + p0 * bstep), 0);
      if (two) wgmma_bf16_ss64(part[1], a16_desc(a + (ks0 + p0 + 1) * A16_KSTEP), wg_desc(b + (p0 + 1) * bstep), 0);
      wg_commit();
      wg_wait0();
      wg_fence_operands<32>(part[0]);
      wg_fence_operands<32>(part[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float s = ks0 + p0 == 0 ? part[0][i] : acc[i] + part[0][i];
        acc[i] = two ? s + part[1][i] : s;
      }
    }
  } else {
    wg_fence_operands<32>(acc);
    wg_fence();
    for (int p = 0; p < n; ++p)
      wgmma_bf16_ss64(acc, a16_desc(a + (ks0 + p) * A16_KSTEP), wg_desc(b + p * bstep), ks0 + p > 0);
    wg_commit();
  }
}

// acc = A x B for this warpgroup over the stream's chunks (primed): A 64 x 16 nks bf16 at `a`. One
// wgmma group in flight behind the copies; ends with every product complete and the ring free (the
// warpgroup's barrier), so that the next stream may be primed.
__device__ __forceinline__ void product(Stream& s, const bf16* a, float (&acc)[32]) {
  for (int c = 0; c < s.nc; ++c) {
    cp_async_wait<STAGES128 - 3>();  // this thread's copies of chunk c have landed
    fence_async_smem();              // they (and its stores of A) are visible to wgmma
    wg_bar(s.bar);                   // everyone's; chunk c - 2's products are complete
    issue(s);                        // chunk c + STAGES128 - 2, into chunk c - 2's stage
    steps_product(acc, a, s.ring + (c % STAGES128) * (CHUNK16 / 4), CHUNK16 / 8, c * 2, min(2, s.nks - 2 * c));
    if constexpr (!FRESH_ACC) {
      wg_wait1();
      wg_fence_operands<32>(acc);
    }
  }
  wg_wait0();
  wg_fence_operands<32>(acc);
  cp_async_wait<0>();
  wg_bar(s.bar);
}

// acc = A x B, this warpgroup's n64 half h of B resident in shared memory (m_w2: nks blocks of 4 KB at
// `b`). A's writers have fenced and met at a barrier.
__device__ __forceinline__ void product_resident(const float* b, int h, const bf16* a, int nks, float (&acc)[32]) {
  steps_product(acc, a, b + h * (CHUNK16 / 8), CHUNK16 / 4, 0, nks);
  wg_wait0();
  wg_fence_operands<32>(acc);
}

// This thread's part of a 64 x WN product (NJ = WN / 8 n8 tiles): the accumulator element i, its row
// r = r0 + 8 hr of the tile (r0 = 16 warp + g) and its column col = 8 j + 2 tq + e; NACC_PAIRS visits the pairs
// (col, col + 1) at i, i + 1. Loops unrolled into constant register indices. ACC_LOOP / ACC_PAIRS: a 64 x 64 one.
#define NACC_LOOP(NJ, ...)                                                                  \
  _Pragma("unroll") for (int j_ = 0; j_ < (NJ); ++j_)                                        \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr)                                         \
      _Pragma("unroll") for (int e_ = 0; e_ < 2; ++e_) {                                     \
        const int i = 4 * j_ + 2 * hr + e_, col = 8 * j_ + 2 * tq + e_, r = r0 + 8 * hr;       \
        __VA_ARGS__                                                                          \
      }
#define NACC_PAIRS(NJ, ...)                                                                 \
  _Pragma("unroll") for (int j_ = 0; j_ < (NJ); ++j_)                                        \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr) {                                       \
      const int i = 4 * j_ + 2 * hr, col = 8 * j_ + 2 * tq, r = r0 + 8 * hr;                  \
      __VA_ARGS__                                                                            \
    }

#define ACC_LOOP(...) NACC_LOOP(8, __VA_ARGS__)
#define ACC_PAIRS(...) NACC_PAIRS(8, __VA_ARGS__)
#define ACC_FRAG const int tq = threadIdx.x & 3, r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2)

// Sums over a row of the tile whose columns the two warpgroups split: each thread's two rows' values,
// summed over its quad by two shuffles, then with the other warpgroup's through `xs` (a block barrier).
// `xs` alternates between two halves of its buffer (`par`), so that a warpgroup ahead writes the next
// sums into the half nobody still reads.
template <int NV>
__device__ __forceinline__ void row_sums(float (&v)[2][NV], float* xs, int& par) {
  ACC_FRAG;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 1);
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 2);
    }
  const int wg = threadIdx.x >> 7;
  float* buf = xs + par * 4 * TILE128;  // a half: [2 warpgroups][64 rows][NV <= 2]
  par ^= 1;
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < NV; ++k) buf[(wg * TILE128 + r0 + 8 * h) * NV + k] = v[h][k];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < NV; ++k) v[h][k] += buf[((1 - wg) * TILE128 + r0 + 8 * h) * NV + k];
}

// mean and 1 / sqrt(var + eps) of each of this thread's two rows from their sums v[h] = (sum, sum of
// squares) over `width` columns (var = E[x^2] - E[x]^2, as JAX's kernel takes it).
__device__ __forceinline__ void row_moments(const float (&v)[2][2], int width, float (&mean)[2], float (&rstd)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = v[h][0] / width;
    rstd[h] = 1.0f / sqrtf(v[h][1] / width - mean[h] * mean[h] + LN_EPS);
  }
}

// The normalize-only LayerNorm of this thread's two rows over the columns n0 + col < width of the
// warpgroup's part, the rest of each row in the other warpgroup (row_sums).
__device__ __forceinline__ void layer_norm(float (&acc)[32], int n0, int width, float* xs, int& par) {
  ACC_FRAG;
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  ACC_LOOP(if (n0 + col < width) {
    v[hr][0] += acc[i];
    v[hr][1] = fmaf(acc[i], acc[i], v[hr][1]);
  })
  row_sums<2>(v, xs, par);
  float mean[2], rstd[2];
  row_moments(v, width, mean, rstd);
  ACC_LOOP(acc[i] = (acc[i] - mean[hr]) * rstd[hr];)
}

// bf16(acc) of the columns n0 + col < width into the 64-row operand `out`.
__device__ __forceinline__ void store_acc(const float (&acc)[32], bf16* out, int n0, int width) {
  ACC_FRAG;
  ACC_PAIRS(if (n0 + col < width) store2(out, r, n0 + col, acc[i], acc[i + 1]);)
}

// The RFF features of the 64 coordinates of an item (inv: the latent's [rows][I] invariants) into X16
// (a 64-row operand): sin and cos of the f32 projection by the bf16 mode's polynomial, rounded to bf16.
// A warp writes whole core matrices (8 rows x 4 column pairs); threads u0, u0 + du, ... take the units (the
// block's, or a warpgroup's). Not inlined (no wgmma in it): one copy of its code serves every pass.
__device__ __noinline__ void features64(const float* __restrict__ inv, int I, int rows, const float* __restrict__ coeff,
                                        int hid, bf16* X16, int u0, int du) {
  const int half = hid >> 1, units = TILE128 * (half >> 1);
#pragma unroll 2
  for (int u = u0; u < units; u += du) {
    const int q = u & 3, rr = (u >> 2) & 7, rest = u >> 5, rg = rest & 7, jg = rest >> 3;
    const int t = 8 * rg + rr, j = 8 * jg + 2 * q;
    float p0 = 0.0f, p1 = 0.0f;
    if (t < rows) {
      const float* x = inv + (size_t)t * I;
      for (int k = 0; k < I; ++k) {
        const float xi = __ldg(x + k);
        const float2 cf = ldg2(coeff + k * half + j);
        p0 = fmaf(xi, cf.x, p0);
        p1 = fmaf(xi, cf.y, p1);
      }
    }
    float s0, k0, s1, k1;
    fast_sincos(p0, &s0, &k0);
    fast_sincos(p1, &s1, &k1);
    store2(X16, t, j, s0, s1);
    store2(X16, t, half + j, k0, k1);
  }
  fence_async_smem();
}

// The head's last layer on the CUDA cores (h_w3, one column an output): a warp an (output, 32 rows), lane t
// a row, from the 64-row bf16 operand Y16 (K = hid).
__device__ __forceinline__ void head_out(const Params& P, const bf16* Y16, float* dst, int rows) {
  const int hid = P.hid, od = P.out_dim, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o2 = warp; o2 < 2 * od; o2 += WARPS) {
    const int o = o2 >> 1, t = 32 * (o2 & 1) + lane;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = lane % hid;
    for (int n = 0; n < hid; ++n) {
      s[n & 3] = fmaf(__bfloat162float(Y16[a16_index(t, k)]), bf16_round(__ldg(P.h_w3 + k * od + o)), s[n & 3]);
      if (++k == hid) k = 0;
    }
    if (t < rows) dst[t * od + o] = (s[0] + s[1]) + (s[2] + s[3]) + __ldg(P.h_b3 + o);
  }
}

// The tail's layers split their N columns between the warpgroups: a 128-column slab each (N > 128)
// taken as two n64 parts, or an n64 half of the one slab. The stream of part `part` of W [K, N].
__device__ __forceinline__ void prime_part(Stream& st, const float* W, int N, int K, int part) {
  const int wg = threadIdx.x >> 7, two = N > WG_N;
  prime(st, W + (two ? wg * (CHUNK16 / 4) : 0), (1 + two) * (CHUNK16 / 4), two ? part : wg, K / 16);
}
// out = act(in W + bias) in bf16 (the stream primed with W's first part), normalized (gelu first)
// over its N columns with `ln` (the values of a slab's first part wait in `stage`, f32, until the
// row's sums are whole); the next stream primed as soon as a part's products are done.
__device__ __forceinline__ void tail_layer(Stream& st, const bf16* in, bf16* out, const float* W, int N, int K,
                                           const float* __restrict__ bias, bool gelu, bool ln, float* stage, float* xs,
                                           int& par, const float* next_w, int next_n, int next_k) {
  ACC_FRAG;
  const int wg = threadIdx.x >> 7, parts = N > WG_N ? 2 : 1;
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int part = 0; part < parts; ++part) {
    const int n0 = parts == 2 ? wg * WG_N + 64 * part : wg * 64;
    float acc[32];
    product(st, in, acc);
    if (part + 1 < parts)
      prime_part(st, W, N, K, part + 1);
    else if (next_w)
      prime_part(st, next_w, next_n, next_k, 0);
    ACC_PAIRS(if (n0 + col < N) {
      const float2 bb = ldg2(bias + n0 + col);
      float x0 = acc[i] + bb.x, x1 = acc[i + 1] + bb.y;
      if (gelu) {
        x0 = gelu_tanh(x0);
        x1 = gelu_tanh(x1);
      }
      acc[i] = x0;
      acc[i + 1] = x1;
      if (ln) {
        v[hr][0] += x0 + x1;
        v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
      }
    })
    if (ln) {
      ACC_PAIRS(if (n0 + col < N) *reinterpret_cast<float2*>(stage + r * LDA128 + n0 + col) = make_float2(acc[i], acc[i + 1]);)
    } else {
      store_acc(acc, out, n0, N);
    }
  }
  if (ln) {  // the LayerNorm of the staged values, this thread's own
    row_sums<2>(v, xs, par);
    float mean[2], rstd[2];
    row_moments(v, N, mean, rstd);
    for (int part = 0; part < parts; ++part) {
      const int n0 = parts == 2 ? wg * WG_N + 64 * part : wg * 64;
      ACC_PAIRS(if (n0 + col < N) {
        const float2 x = *reinterpret_cast<const float2*>(stage + r * LDA128 + n0 + col);
        store2(out, r, n0 + col, (x.x - mean[hr]) * rstd[hr], (x.y - mean[hr]) * rstd[hr]);
      })
    }
  }
  fence_async_smem();
  __syncthreads();  // the layer's columns, from both warpgroups
}
// The tail on the bf16 attention output in X16: out-projection, block FFN (gelu, LayerNorm over H D),
// two gelu layers of the head; their output in Y16. `stage`: f32 room of [64][LDA128] (accs, read).
__device__ __forceinline__ void tail128(const Params& P, Stream& st, bf16* X16, bf16* Y16, float* stage, float* xs,
                                        int& par) {
  const int HD = P.H * P.D, hid = P.hid;
  tail_layer(st, X16, Y16, P.o_w, HD, HD, P.o_b, false, false, stage, xs, par, P.p_w1, HD, HD);
  tail_layer(st, Y16, X16, P.p_w1, HD, HD, P.p_b1, true, true, stage, xs, par, P.p_w2, HD, HD);
  tail_layer(st, X16, Y16, P.p_w2, HD, HD, P.p_b2, true, false, stage, xs, par, P.h_w1, hid, HD);
  tail_layer(st, Y16, X16, P.h_w1, hid, HD, P.h_b1, true, false, stage, xs, par, P.h_w2, hid, hid);
  tail_layer(st, X16, Y16, P.h_w2, hid, hid, P.h_b2, true, false, stage, xs, par, nullptr, 0, 0);
}

// The LayerNorm of this thread's two rows over the columns of two n64 parts (n0[p] + col < width; the
// wide instantiation's G products), the rest of each row in the other warpgroup (row_sums).
__device__ __forceinline__ void layer_norm2(float (&acc)[2][32], const int (&n0)[2], int width, float* xs, int& par) {
  ACC_FRAG;
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    ACC_LOOP(if (n0[p] + col < width) {
      v[hr][0] += acc[p][i];
      v[hr][1] = fmaf(acc[p][i], acc[p][i], v[hr][1]);
    })
  }
  row_sums<2>(v, xs, par);
  float mean[2], rstd[2];
  row_moments(v, width, mean, rstd);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    ACC_LOOP(acc[p][i] = (acc[p][i] - mean[hr]) * rstd[hr];)
  }
}

// The decode of the class 128: a persistent block walks the work items (batch row, tile of P.tile
// coordinates) from blockIdx.x by gridDim.x; a latent at a time, every product's columns split
// between the two warpgroups (an n64 half each), each warpgroup streaming its own half of B. WIDE (an
// instantiation of its own, for hidm or D past 128, up to 256): a head of G and m_w2 in two 128-column
// slabs where they are wider than 128, each warpgroup taking its slab as two n64 parts; m_w2 streamed, not
// resident; each head's mixer after its G products (no stream primed across them).
template <bool WITH_TAIL, bool WIDE>
__device__ __forceinline__ void decode128(const Params& P, float* smem) {
  const int Z = P.Z, H = P.H, hid = P.hid, D = P.D, hidm = P.hidm, C = P.C, HD = H * D;
  bf16* X16 = reinterpret_cast<bf16*>(smem);  // a latent's features, then t; the tail's even layers' input
  bf16* Y16 = X16 + A16_BYTES / 2;            // a latent's hv, then a head's vm; the tail's odd layers' input
  float* accs = reinterpret_cast<float*>(Y16 + A16_BYTES / 2);  // [64][LDA128] the attention output
  float* mw2 = accs + TILE128 * LDA128;                         // m_w2's blocks, resident
  float* rings = mw2 + 8 * CHUNK16 / 4;                         // [2][STAGES128][1,024]
  float* xs = rings + 2 * STAGES128 * CHUNK16 / 4;              // [2][2][64][2] the row sums' exchange
  float* prob = P.lg_global ? P.lg + (size_t)blockIdx.x * Z * TILE128 * H : xs + 8 * TILE128;  // [Z][64][H]
  const int tid = threadIdx.x, wg = tid >> 7, nb = hid / 16, n0 = 64 * wg;
  ACC_FRAG;
  int par = 0;
  Stream st;
  st.ring = rings + wg * STAGES128 * (CHUNK16 / 4);
  st.bar = 1 + wg;
  st.lt = tid & 127;

  // m_w2, once a block: hidm / 16 blocks of one 128-column slab (D <= 128).
  if constexpr (!WIDE) {
    for (int k = 4 * tid; k < hidm / 16 * (CHUNK16 / 4); k += 4 * THREADS) cp_async16(mw2 + k, P.m_w2s + k, true);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
  }
  // WIDE: the 128-column slabs of a head of G (gs) and of m_w2 (ms), and the parts (n64 each) a warpgroup
  // takes of each product: its slab's two halves where there are two slabs, else its half of the one.
  const int gs = (hidm + WG_N - 1) / WG_N, ms = (D + WG_N - 1) / WG_N;
  auto part_n0 = [&](int slabs, int p) { return slabs == 2 ? wg * WG_N + 64 * p : 64 * wg; };
  auto prime_slabs = [&](const float* w, int slabs, int p, int nks) {
    prime(st, w + (slabs == 2 ? wg * (CHUNK16 / 4) : 0), slabs * (CHUNK16 / 4), slabs == 2 ? p : wg, nks);
  };

  const int ntiles = (C + P.tile - 1) / P.tile, items = ntiles * P.B;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / ntiles, c0 = item % ntiles * P.tile, rows = min(P.tile, C - c0);
    __syncthreads();  // the last item's readers of accs, X16 and Y16 are done
    for (int idx = tid; idx < TILE128 * HD; idx += THREADS) accs[(idx / HD) * LDA128 + idx % HD] = 0.0f;

    // Pass 1: every latent's logits, hq . A[b, z] + ab + wb, in q_w1's epilogue (each warpgroup's
    // half of the dot, summed through xs).
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      prime(st, P.q_w1s, CHUNK16 / 4, wg, nb);
      __syncthreads();  // the last readers of X16 are done
      features64(P.inv + (bz * C + c0) * P.I, P.I, rows, P.q_coeff, hid, X16, tid, THREADS);
      __syncthreads();
      float acc[32];
      product(st, X16, acc);
      ACC_PAIRS(if (n0 + col < hid) {
        const float2 bq = ldg2(P.q_b1 + n0 + col);
        acc[i] = bf16_round(fmaxf(acc[i] + bq.x, 0.0f));
        acc[i + 1] = bf16_round(fmaxf(acc[i + 1] + bq.y, 0.0f));
      } else {
        acc[i] = acc[i + 1] = 0.0f;
      })
      for (int h0 = 0; h0 < H; h0 += 2) {  // two heads a time
        const int h1 = min(h0 + 1, H - 1);
        float lg[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        ACC_LOOP(if (n0 + col < hid) {
          const float* a = P.A + (bz * hid + n0 + col) * H;
          const float2 ah = H % 2 == 0 ? ldg2(a + h0) : make_float2(__ldg(a + h0), __ldg(a + h1));
          lg[hr][0] = fmaf(acc[i], bf16_round(ah.x), lg[hr][0]);
          lg[hr][1] = fmaf(acc[i], bf16_round(ah.y), lg[hr][1]);
        })
        row_sums<2>(lg, xs, par);
        if (tq == 0 && wg == 0)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int t = r0 + 8 * k;
            const float w = t < rows ? __ldg(P.wb + bz * C + c0 + t) : 0.0f;
            prob[(z * TILE128 + t) * H + h0] = lg[k][0] + __ldg(P.ab + bz * H + h0) + w;
            if (h0 + 1 < H) prob[(z * TILE128 + t) * H + h1] = lg[k][1] + __ldg(P.ab + bz * H + h1) + w;
          }
      }
    }
    // The softmax over the latents, each weight rounded to bf16 (`pr.astype(dt)` in _tile_decode).
    __syncthreads();
    for (int idx = tid; idx < TILE128 * H; idx += THREADS) {
      float m = -INFINITY;
      for (int z = 0; z < Z; ++z) m = fmaxf(m, prob[z * TILE128 * H + idx]);
      const float ms = m == -INFINITY ? 0.0f : m;  // every logit -inf: exp gives 0, not NaN
      float l = 0.0f;
      for (int z = 0; z < Z; ++z) {
        const float e = expf(prob[z * TILE128 * H + idx] - ms);
        prob[z * TILE128 * H + idx] = e;
        l += e;
      }
      for (int z = 0; z < Z; ++z) prob[z * TILE128 * H + idx] = bf16_round(prob[z * TILE128 * H + idx] / l);
    }

    // Pass 2: each latent's value chain, hv = relu(. v_w1 + v_b1), t = normalize(gelu(hv fw + fb)),
    // then a head at a time vm = normalize(gelu(t G[b, z, h] + c)) and accs[:, h D + n] += p[z, :, h]
    // (vm m_w2 + m_b2)[:, n].
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      prime(st, P.v_w1s, CHUNK16 / 4, wg, nb);
      __syncthreads();  // the last readers of X16 and Y16 are done; the softmax's weights are stored
      features64(P.inv + (bz * C + c0) * P.I, P.I, rows, P.v_coeff, hid, X16, tid, THREADS);
      __syncthreads();
      float acc[32];
      product(st, X16, acc);
      prime(st, P.fws, CHUNK16 / 4, wg, nb);
      ACC_PAIRS(if (n0 + col < hid) {
        const float2 bv = ldg2(P.v_b1 + n0 + col);
        acc[i] = fmaxf(acc[i] + bv.x, 0.0f);
        acc[i + 1] = fmaxf(acc[i + 1] + bv.y, 0.0f);
      })
      store_acc(acc, Y16, n0, hid);
      fence_async_smem();
      __syncthreads();  // hv, both halves
      product(st, Y16, acc);
      if constexpr (WIDE)
        prime_slabs(P.G + bz * H * nb * gs * (CHUNK16 / 4), gs, 0, nb);
      else
        prime(st, P.G + bz * H * nb * (CHUNK16 / 4), CHUNK16 / 4, wg, nb);
      ACC_PAIRS(if (n0 + col < hid) {
        const float2 bf = ldg2(P.fb + n0 + col);
        acc[i] = gelu_tanh(acc[i] + bf.x);
        acc[i + 1] = gelu_tanh(acc[i + 1] + bf.y);
      } else {
        acc[i] = acc[i + 1] = 0.0f;
      })
      layer_norm(acc, n0, hid, xs, par);  // its barrier: both warpgroups are done reading X16
      store_acc(acc, X16, n0, hid);
      fence_async_smem();
      __syncthreads();  // t, both halves
      if constexpr (WIDE) {
        for (int h = 0; h < H; ++h) {
          const float* gh = P.G + (bz * H + h) * nb * gs * (CHUNK16 / 4);
          float ag[2][32];
          int gn[2];
          for (int p = 0; p < gs; ++p) {
            if (p > 0 || h > 0) prime_slabs(gh, gs, p, nb);
            product(st, X16, ag[p]);
            gn[p] = part_n0(gs, p);
            const float* cz = P.c + (bz * H + h) * hidm + gn[p];
            ACC_PAIRS(if (gn[p] + col < hidm) {
              const float2 cc = ldg2(cz + col);
              ag[p][i] = gelu_tanh(ag[p][i] + cc.x);
              ag[p][i + 1] = gelu_tanh(ag[p][i + 1] + cc.y);
            } else {
              ag[p][i] = ag[p][i + 1] = 0.0f;
            })
          }
          if (gs == 2) {
            layer_norm2(ag, gn, hidm, xs, par);  // its barrier: both warpgroups' last mixer read Y16
          } else {
            layer_norm(ag[0], gn[0], hidm, xs, par);
          }
          for (int p = 0; p < gs; ++p) store_acc(ag[p], Y16, gn[p], hidm);
          fence_async_smem();
          __syncthreads();  // vm, both halves
          for (int p = 0; p < ms; ++p) {
            prime_slabs(P.m_w2s, ms, p, hidm / 16);
            product(st, Y16, acc);
            const int m0 = part_n0(ms, p);
            const float p0 = prob[(z * TILE128 + r0) * H + h], p1 = prob[(z * TILE128 + r0 + 8) * H + h];
            ACC_PAIRS(if (m0 + col < D) {
              float2* a = reinterpret_cast<float2*>(accs + r * LDA128 + h * D + m0 + col);
              const float p = hr ? p1 : p0;
              const float2 bm = ldg2(P.m_b2 + m0 + col);
              float2 v = *a;
              v.x = fmaf(p, acc[i] + bm.x, v.x);
              v.y = fmaf(p, acc[i + 1] + bm.y, v.y);
              *a = v;
            })
          }
        }
      } else {
        for (int h = 0; h < H; ++h) {
          product(st, X16, acc);
          if (h + 1 < H) prime(st, P.G + (bz * H + h + 1) * nb * (CHUNK16 / 4), CHUNK16 / 4, wg, nb);
          const float* cz = P.c + (bz * H + h) * hidm + n0;
          ACC_PAIRS(if (n0 + col < hidm) {
            const float2 cc = ldg2(cz + col);
            acc[i] = gelu_tanh(acc[i] + cc.x);
            acc[i + 1] = gelu_tanh(acc[i + 1] + cc.y);
          } else {
            acc[i] = acc[i + 1] = 0.0f;
          })
          layer_norm(acc, n0, hidm, xs, par);  // its barrier: both warpgroups' last mixer read Y16
          store_acc(acc, Y16, n0, hidm);
          fence_async_smem();
          __syncthreads();  // vm, both halves
          product_resident(mw2, wg, Y16, hidm / 16, acc);
          const float p0 = prob[(z * TILE128 + r0) * H + h], p1 = prob[(z * TILE128 + r0 + 8) * H + h];
          ACC_PAIRS(if (n0 + col < D) {
            float2* a = reinterpret_cast<float2*>(accs + r * LDA128 + h * D + n0 + col);
            const float p = hr ? p1 : p0;
            const float2 bm = ldg2(P.m_b2 + n0 + col);
            float2 v = *a;
            v.x = fmaf(p, acc[i] + bm.x, v.x);
            v.y = fmaf(p, acc[i + 1] + bm.y, v.y);
            *a = v;
          })
        }
      }
    }
    __syncthreads();  // every head's sums are in accs

    float* dst = P.out + ((size_t)b * C + c0) * (WITH_TAIL ? P.out_dim : HD);
    if constexpr (WITH_TAIL) {
      // The tail: out-projection, block FFN (gelu, LayerNorm over H D), head MLP.
      prime_part(st, P.o_w, HD, HD, 0);
      for (int idx = tid; idx < TILE128 * HD / 2; idx += THREADS) {
        const int r = idx / (HD / 2), n = 2 * (idx % (HD / 2));
        store2(X16, r, n, accs[r * LDA128 + n], accs[r * LDA128 + n + 1]);
      }
      fence_async_smem();
      __syncthreads();
      tail128(P, st, X16, Y16, accs, xs, par);
      head_out(P, Y16, dst, rows);
    } else {
      for (int idx = tid; idx < rows * HD; idx += THREADS) dst[idx] = accs[(idx / HD) * LDA128 + idx % HD];
    }
  }
}
// ---- The narrow classes (16, 32, 64: diff_sphere, ihc, the planar configs): a latent a warpgroup ----------
// A work item is 64 coordinates of a batch row (32 where items of 64 would leave half the grid's slots idle,
// `item_tile`), as at the class 128. At these widths a warpgroup's m64 x WN accumulator holds whole rows,
// so each warpgroup decodes latents of its own (z = wg, wg + 2, ...; for an odd Z the second one repeats the
// last latent and drops its results, so that both run the same products) with its own bf16 operand buffers,
// its own G and its own share of the attention output, and meets the other only at the item's block barriers
// (the softmax, the shares' sum, the tail). Every product is a bf16 wgmma m64nWNk16 with both operands in
// shared memory: A an activation (a16 layout, K = hid or hidm) stored in bf16 by the epilogue before it, B the
// shared weights (resident, bf16_weights' blocks at the class width), the latent's G (bf16_g_blocks at the class
// width: a head's hidm columns padded to WN), copied by cp.async a latent ahead, A[b, z] (the logits' product,
// m64n16k16), or a tail layer's blocks. gelu, the LayerNorms (a row's statistics: a quad's two shuffles), the
// logits and the mixer's weighted sum come from the accumulator registers. A warp's wait covers its own part of
// a product only: a warpgroup barrier precedes every write of a buffer another warp's product may still read.
// The tail splits each layer's WN-wide column slabs between the warpgroups (p_w1's LayerNorm sums exchanged
// through xs, `row_sums`); h_w3 on the CUDA cores.

// The narrow classes' shared memory, byte offsets: the shared weights (q_w1, v_w1 and fw: hid x WN bf16
// each; m_w2 hidm x WN), then `xs` (the tail's row sums), then r1 (each warpgroup's X, Y and G, pw bytes
// apart; the tail's two operands), r2 (each warpgroup's share of the attention output, [64][ld] f32; the
// tail's LayerNorm stage and, at `tw`, a layer's weight blocks) and `prob`, every latent's logits where
// they fit (`layout`).
constexpr int XS_BYTES = 4 * 8 * TILE128;  // the tail's row sums' exchange, as at the class 128
struct NarrowLayout {
  int xs, r1, pw, r2, ld, tw, prob;
};
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline NarrowLayout narrow_layout(int wn, int hid, int hidm, int H, int D) {
  NarrowLayout L;
  const int HD = H * D, kt = imax(HD, hid), hdp = (HD + wn - 1) / wn * wn;
  L.ld = (HD + 23) / 32 * 32 + 8;  // 8 mod 32 words: a warp's float2 updates of its 8 rows conflict free
  L.xs = (3 * hid + hidm) * wn * 2;
  L.r1 = L.xs + XS_BYTES;
  L.pw = TILE128 * 2 * (hid + imax(hid, hidm)) + hid * H * wn * 2;
  L.r2 = L.r1 + imax(2 * L.pw, 2 * TILE128 * 2 * kt);
  L.tw = TILE128 * 4 * L.ld;
  L.prob = L.r2 + imax(2 * TILE128 * 4 * L.ld, L.tw + 2 * imax(HD * hdp, hid * wn));
  return L;
}

// acc = A x B, one wgmma group, waited for: A 64 x 16 nks bf16 (a16 at `a`), B's k step ks the 16 x N block at
// b + ks * bstep. Every warpgroup of the block issues the same products (ptxas serializes a wgmma it finds on a
// path that differs between warps), one group at a time: the other warpgroups fill the waits.
template <int N>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], const bf16* a, const bf16* b, int bstep, int nks) {
  wg_fence_operands<N / 2>(acc);
  wg_fence();
  for (int ks = 0; ks < nks; ++ks)
    wgmma_bf16_ss<N>(acc, a16_desc(a + ks * A16_KSTEP), wg_desc(reinterpret_cast<const float*>(b + ks * bstep)), ks > 0);
  wg_commit();
  wg_wait0();
  wg_fence_operands<N / 2>(acc);
}

// gelu_tanh as x sigmoid(2 u), u = sqrt(2 / pi) (x + 0.044715 x^3): the same function, by __expf and __fdividef
// (within a few ulp of tanhf's form, far below the bf16 rounding of the product operand it feeds; x -> -inf: the
// quotient's denominator overflows and it gives -0, as 0.5 x (1 + tanh u) does).
__device__ __forceinline__ float gelu_sig(float x) {
  return __fdividef(x, 1.0f + __expf(-1.5957691216057308f * (x + 0.044715f * x * x * x)));
}

// The normalize-only LayerNorm of this thread's two rows over their columns col < width, the whole row
// in the thread's quad (two shuffles); mean and 1 / sqrt(var + eps) by a reciprocal and rsqrtf (within an ulp
// or two of row_moments' division and sqrt: far below the bf16 rounding that follows).
template <int NJ>
__device__ __forceinline__ void quad_norm(float (&acc)[4 * NJ], int width) {
  ACC_FRAG;
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  NACC_LOOP(NJ, if (col < width) {
    v[hr][0] += acc[i];
    v[hr][1] = fmaf(acc[i], acc[i], v[hr][1]);
  })
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 1);
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 2);
    }
  const float inv = 1.0f / width;
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = v[h][0] * inv;
    rstd[h] = rsqrtf(v[h][1] * inv - mean[h] * mean[h] + LN_EPS);
  }
  NACC_LOOP(NJ, acc[i] = (acc[i] - mean[hr]) * rstd[hr];)
}

// bf16(acc) of the columns col < width into the 64-row operand `out`.
template <int NJ>
__device__ __forceinline__ void store_rows(const float (&acc)[4 * NJ], bf16* out, int width) {
  ACC_FRAG;
  NACC_PAIRS(NJ, if (col < width) store2(out, r, col, acc[i], acc[i + 1]);)
}

// A tail layer on the item's 64 rows: out = act(in W + bias) in bf16 (normalized over its N columns with
// `ln`, gelu first, the values waiting in `stage` until the row's sums are whole). W's blocks (K x N, each
// 16-row chunk's WN-wide slabs side by side) are copied whole into TW first; warpgroup wg takes the slabs
// wg, wg + 2, .... Every thread calls it; it ends with a block barrier.
template <int WN>
__device__ __forceinline__ void tail_layer_n(const bf16* in, bf16* out, const float* W, int K, int N,
                                             const float* __restrict__ bias, bool gelu, bool ln, bf16* TW, float* stage,
                                             int ld, float* xs, int& par) {
  constexpr int NJ = WN / 8;
  ACC_FRAG;
  const int wg = threadIdx.x >> 7, nslab = (N + WN - 1) / WN;
  float* tw = reinterpret_cast<float*>(TW);
  for (int k = 4 * threadIdx.x; k < K * nslab * WN / 2; k += 4 * THREADS) cp_async16(tw + k, W + k, true);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();  // the blocks, and the last layer's output
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int si = 0; si < (nslab + 1) / 2; ++si) {  // the same products in both warpgroups: no wgmma on a divergent path
    const int s = min(2 * si + wg, nslab - 1), n0 = s * WN;
    float acc[WN / 2];
    product_ss<WN>(acc, in, TW + s * 16 * WN, nslab * 16 * WN, K / 16);
    if (2 * si + wg < nslab) NACC_PAIRS(NJ, if (n0 + col < N) {
      const float2 bb = ldg2(bias + n0 + col);
      float x0 = acc[i] + bb.x, x1 = acc[i + 1] + bb.y;
      if (gelu) {
        x0 = gelu_sig(x0);
        x1 = gelu_sig(x1);
      }
      if (ln) {
        v[hr][0] += x0 + x1;
        v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
        *reinterpret_cast<float2*>(stage + r * ld + n0 + col) = make_float2(x0, x1);
      } else {
        store2(out, r, n0 + col, x0, x1);
      }
    })
  }
  if (ln) {  // the LayerNorm of the staged values, this thread's own
    row_sums<2>(v, xs, par);
    float mean[2], rstd[2];
    row_moments(v, N, mean, rstd);
    for (int s = wg; s < nslab; s += 2) {
      const int n0 = s * WN;
      NACC_PAIRS(NJ, if (n0 + col < N) {
        const float2 x = *reinterpret_cast<const float2*>(stage + r * ld + n0 + col);
        store2(out, r, n0 + col, (x.x - mean[hr]) * rstd[hr], (x.y - mean[hr]) * rstd[hr]);
      })
    }
  }
  fence_async_smem();
  __syncthreads();  // the layer's columns, from both warpgroups; TW free
}

// The decode of a narrow class WN: a persistent block walks the work items (batch row, tile of P.tile
// coordinates) from blockIdx.x by gridDim.x; in each, warpgroup wg takes the latents wg, wg + 2, ....
template <int WN, bool WITH_TAIL>
__device__ __forceinline__ void decode_narrow(const Params& P, float* smem) {
  constexpr int NJ = WN / 8, NA = WN / 2, NL = 16;  // NL: the logits product's columns, the heads (H <= 16)
  const int Z = P.Z, H = P.H, hid = P.hid, D = P.D, hidm = P.hidm, C = P.C, HD = H * D;
  const NarrowLayout L = narrow_layout(WN, hid, hidm, H, D);
  char* base = reinterpret_cast<char*>(smem);
  bf16* W = reinterpret_cast<bf16*>(base);  // q_w1, v_w1, fw, m_w2: resident
  const bf16 *Wq = W, *Wv = W + hid * WN, *Wf = W + 2 * hid * WN, *Wm = W + 3 * hid * WN;
  float* xs = reinterpret_cast<float*>(base + L.xs);
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127, nk = hid / 16, bar = 1 + wg;
  ACC_FRAG;
  bf16* XA = reinterpret_cast<bf16*>(base + L.r1 + wg * L.pw);  // a latent's features, then its t
  bf16* YA = XA + TILE128 * hid;                                // its hv, then a head's vm
  bf16* GB = YA + TILE128 * imax(hid, hidm);                    // its G: a head's hid / 16 blocks after another
  float* AC = reinterpret_cast<float*>(base + L.r2) + wg * TILE128 * L.ld;  // this warpgroup's share of the output
  bf16* TX = reinterpret_cast<bf16*>(base + L.r1);              // the tail's operands
  bf16* TY = TX + TILE128 * imax(HD, hid);
  float* stage = reinterpret_cast<float*>(base + L.r2);
  bf16* TW = reinterpret_cast<bf16*>(base + L.r2 + L.tw);
  float* prob = P.lg_global ? P.lg + (size_t)blockIdx.x * Z * TILE128 * H : reinterpret_cast<float*>(base + L.prob);
  const int gfl = hid * H * WN / 2;  // floats of a latent's G blocks
  const int zn = (Z + 1) / 2;        // latents a warpgroup takes
  int par = 0;

  // The shared weights, once a block.
  {
    const float* src[4] = {P.q_w1s, P.v_w1s, P.fws, P.m_w2s};
    const int n[4] = {hid * WN / 2, hid * WN / 2, hid * WN / 2, hidm * WN / 2};
    float* dst = reinterpret_cast<float*>(W);
    for (int w = 0; w < 4; ++w) {
      for (int k = 4 * tid; k < n[w]; k += 4 * THREADS) cp_async16(dst + k, src[w] + k, true);
      dst += n[w];
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();  // visible to wgmma after the barrier that starts each item
  }
  const int ntiles = (C + P.tile - 1) / P.tile, items = ntiles * P.B;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / ntiles, c0 = item % ntiles * P.tile, rows = min(P.tile, C - c0);
    // Latent z's G blocks into this warpgroup's GB (its last G product is complete).
    auto copy_g = [&](int z) {
      const float* src = P.G + ((size_t)b * Z + z) * gfl;
      for (int k = 4 * lt; k < gfl; k += 4 * 128) cp_async16(reinterpret_cast<float*>(GB) + k, src + k, true);
      cp_async_commit();
    };
    __syncthreads();  // the last item's readers of every buffer are done
    for (int idx = lt; idx < TILE128 * HD; idx += 128) AC[(idx / HD) * L.ld + idx % HD] = 0.0f;

    // Pass 1: every latent's logits, hq . A[b, z] + ab + wb: hq (bf16) times A[b, z] (its heads padded to NL
    // columns, as a bf16 B operand in GB, idle in this pass) in one more product, + ab + wb in its epilogue.
    for (int zi = 0; zi < zn; ++zi) {
      const int z = min(2 * zi + wg, Z - 1);  // an odd Z: the second warpgroup's last latent repeats one it drops
      const bool own = 2 * zi + wg < Z;
      const size_t bz = (size_t)b * Z + z;
      wg_bar(bar);  // every warp's last products from XA, YA and GB are complete (a warp waits for its own part)
      const float* Az = P.A + bz * hid * H;
      for (int e = lt; e < hid * NL; e += 128) {
        const int k = e / NL, n = e % NL;
        GB[(k >> 4) * 16 * NL + (n >> 3) * 128 + ((k >> 3) & 1) * 64 + (n & 7) * 8 + (k & 7)] =
            __float2bfloat16_rn(n < H ? __ldg(Az + k * H + n) : 0.0f);
      }
      features64(P.inv + (bz * C + c0) * P.I, P.I, rows, P.q_coeff, hid, XA, lt, 128);
      wg_bar(bar);
      float acc[NA];
      product_ss<WN>(acc, XA, Wq, 16 * WN, nk);
      NACC_PAIRS(NJ, if (col < hid) {
        const float2 bq = ldg2(P.q_b1 + col);
        acc[i] = fmaxf(acc[i] + bq.x, 0.0f);
        acc[i + 1] = fmaxf(acc[i + 1] + bq.y, 0.0f);
      })
      store_rows<NJ>(acc, YA, hid);  // hq, rounded to bf16
      fence_async_smem();
      wg_bar(bar);
      float lg[NL / 2];
      product_ss<NL>(lg, YA, GB, 16 * NL, nk);
      if (own) {
        const float w0 = r0 < rows ? __ldg(P.wb + bz * C + c0 + r0) : 0.0f;
        const float w1 = r0 + 8 < rows ? __ldg(P.wb + bz * C + c0 + r0 + 8) : 0.0f;
        NACC_LOOP(NL / 8, if (col < H) prob[(z * TILE128 + r) * H + col] = lg[i] + __ldg(P.ab + bz * H + col) + (hr ? w1 : w0);)
      }
    }
    wg_bar(bar);  // every warp's logits product from GB is complete
    copy_g(min(wg, Z - 1));
    // The softmax over the latents, each weight rounded to bf16 (`pr.astype(dt)` in _tile_decode).
    __syncthreads();
    for (int idx = tid; idx < TILE128 * H; idx += THREADS) {
      float m = -INFINITY;
      for (int z = 0; z < Z; ++z) m = fmaxf(m, prob[z * TILE128 * H + idx]);
      const float ms = m == -INFINITY ? 0.0f : m;  // every logit -inf: exp gives 0, not NaN
      float l = 0.0f;
      for (int z = 0; z < Z; ++z) {
        const float e = expf(prob[z * TILE128 * H + idx] - ms);
        prob[z * TILE128 * H + idx] = e;
        l += e;
      }
      for (int z = 0; z < Z; ++z) prob[z * TILE128 * H + idx] = bf16_round(prob[z * TILE128 * H + idx] / l);
    }
    __syncthreads();

    // Pass 2: each latent's value chain, hv = relu(. v_w1 + v_b1), t = normalize(gelu(hv fw + fb)), then a
    // head at a time vm = normalize(gelu(t G[b, z, h] + c)) and AC[:, h D + n] += p[z, :, h] (vm m_w2 + m_b2)[:, n].
    for (int zi = 0; zi < zn; ++zi) {
      const int z = min(2 * zi + wg, Z - 1);
      const bool own = 2 * zi + wg < Z;
      const size_t bz = (size_t)b * Z + z;
      wg_bar(bar);  // every warp's last products from XA and YA are complete
      features64(P.inv + (bz * C + c0) * P.I, P.I, rows, P.v_coeff, hid, XA, lt, 128);
      wg_bar(bar);
      float acc[NA];
      product_ss<WN>(acc, XA, Wv, 16 * WN, nk);
      NACC_PAIRS(NJ, if (col < hid) {
        const float2 bv = ldg2(P.v_b1 + col);
        acc[i] = fmaxf(acc[i] + bv.x, 0.0f);
        acc[i + 1] = fmaxf(acc[i + 1] + bv.y, 0.0f);
      })
      store_rows<NJ>(acc, YA, hid);
      fence_async_smem();
      wg_bar(bar);  // hv
      product_ss<WN>(acc, YA, Wf, 16 * WN, nk);
      NACC_PAIRS(NJ, if (col < hid) {
        const float2 bf = ldg2(P.fb + col);
        acc[i] = gelu_sig(acc[i] + bf.x);
        acc[i + 1] = gelu_sig(acc[i + 1] + bf.y);
      } else {
        acc[i] = acc[i + 1] = 0.0f;
      })
      quad_norm<NJ>(acc, hid);
      store_rows<NJ>(acc, XA, hid);
      cp_async_wait<0>();  // this thread's copies of G
      fence_async_smem();
      wg_bar(bar);  // t, and G
      for (int h = 0; h < H; ++h) {
        float ag[NA];
        product_ss<WN>(ag, XA, GB + h * hid * WN, 16 * WN, nk);
        const float* cz = P.c + (bz * H + h) * hidm;
        NACC_PAIRS(NJ, if (col < hidm) {
          const float2 cc = ldg2(cz + col);
          ag[i] = gelu_sig(ag[i] + cc.x);
          ag[i + 1] = gelu_sig(ag[i + 1] + cc.y);
        } else {
          ag[i] = ag[i + 1] = 0.0f;
        })
        quad_norm<NJ>(ag, hidm);
        if (h > 0) wg_bar(bar);  // every warp's m_w2 product of the last head is complete
        store_rows<NJ>(ag, YA, hidm);
        fence_async_smem();
        wg_bar(bar);  // vm
        float am[NA];
        product_ss<WN>(am, YA, Wm, 16 * WN, hidm / 16);
        if (own) {
          const float q0 = prob[(z * TILE128 + r0) * H + h], q1 = prob[(z * TILE128 + r0 + 8) * H + h];
          NACC_PAIRS(NJ, if (col < D) {
            float2* a = reinterpret_cast<float2*>(AC + r * L.ld + h * D + col);
            const float q = hr ? q1 : q0;
            const float2 bm = ldg2(P.m_b2 + col);
            float2 v = *a;
            v.x = fmaf(q, am[i] + bm.x, v.x);
            v.y = fmaf(q, am[i + 1] + bm.y, v.y);
            *a = v;
          })
        }
      }
      if (zi + 1 < zn) {
        wg_bar(bar);  // every warp's G products are complete
        copy_g(min(2 * zi + 2 + wg, Z - 1));
      }
    }
    __syncthreads();  // both warpgroups' shares

    const float* AC0 = reinterpret_cast<const float*>(base + L.r2);
    const float* AC1 = AC0 + TILE128 * L.ld;
    float* dst = P.out + ((size_t)b * C + c0) * (WITH_TAIL ? P.out_dim : HD);
    if constexpr (WITH_TAIL) {
      // The tail: out-projection, block FFN (gelu, LayerNorm over H D), head MLP, on bf16(the shares' sum).
      for (int idx = tid; idx < TILE128 * HD / 2; idx += THREADS) {
        const int r = idx / (HD / 2), n = 2 * (idx % (HD / 2));
        const float2 x = *reinterpret_cast<const float2*>(AC0 + r * L.ld + n);
        const float2 y = *reinterpret_cast<const float2*>(AC1 + r * L.ld + n);
        store2(TX, r, n, x.x + y.x, x.y + y.y);
      }
      fence_async_smem();
      __syncthreads();  // the shares are read: stage and TW may take their place
      tail_layer_n<WN>(TX, TY, P.o_w, HD, HD, P.o_b, false, false, TW, stage, L.ld, xs, par);
      tail_layer_n<WN>(TY, TX, P.p_w1, HD, HD, P.p_b1, true, true, TW, stage, L.ld, xs, par);
      tail_layer_n<WN>(TX, TY, P.p_w2, HD, HD, P.p_b2, true, false, TW, stage, L.ld, xs, par);
      tail_layer_n<WN>(TY, TX, P.h_w1, HD, hid, P.h_b1, true, false, TW, stage, L.ld, xs, par);
      tail_layer_n<WN>(TX, TY, P.h_w2, hid, hid, P.h_b2, true, false, TW, stage, L.ld, xs, par);
      head_out(P, TY, dst, rows);
    } else {
      for (int idx = tid; idx < rows * HD; idx += THREADS) {
        const int r = idx / HD, n = idx % HD;
        dst[idx] = AC0[r * L.ld + n] + AC1[r * L.ld + n];
      }
    }
  }
}

template <int WN, bool WITH_TAIL>
__global__ void __launch_bounds__(THREADS, narrow_blocks(WN)) fused_decode_fwd_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (WN == WG_N) {
    decode128<WITH_TAIL, false>(P, smem);
  } else if constexpr (WN == WIDE128) {
    decode128<WITH_TAIL, true>(P, smem);
  } else {
    decode_narrow<WN, WITH_TAIL>(P, smem);
  }
}

// Adds every latent's logits ([Z][rows][H]) to *smem where they fit beside the rest within `cap` bytes; else
// they go to the launch's workspace in global memory (P.lg_global): a slot of [Z][64][H] for each block of the
// persistent grid. False if the rest does not fit.
bool place_logits(Params& P, size_t* smem, int rows, size_t cap = SMEM_CAP) {
  const size_t lg = sizeof(float) * (size_t)P.Z * rows * P.H;
  P.lg_global = *smem + lg > cap;
  if (!P.lg_global) *smem += lg;
  return *smem <= SMEM_CAP;
}

// A narrow class's blocks an SM: BLOCKS<wn> where its shared memory leaves room for them (`layout` sends the
// logits to global memory rather than take that room), else one.
size_t narrow_room(int wn) { return (size_t)SM_SHARED / narrow_blocks(wn) - SM_KEPT; }
int narrow_slots(int wn, size_t smem) { return smem <= narrow_room(wn) ? narrow_blocks(wn) : 1; }

// Fills P's strides; false for shapes the kernel does not take. *cls: the width class.
bool layout(Params& P, bool with_tail, size_t* smem, int* cls) {
  if (P.B < 0 || P.B > 65535 || P.Z <= 0 || P.C < 0 || P.I <= 0 || P.H <= 0 || P.out_dim <= 0) return false;
  if (P.hid % KC || P.hidm % KC || P.D % KC || P.hid > 128) return false;  // X holds [128][hid]
  if (P.hidm > MAXW || P.H * P.D > MAXW) return false;                        // normalize's registers
  if (!with_tail && P.out_dim != P.H * P.D) return false;
  if (P.I > P.hid + 4) return false;  // a group's invariants are staged in Y
  *cls = width_class(P.hid, P.hidm, P.D);
  P.ldX = P.ldP = P.nY = P.nW = 0;
  if (*cls == WG_N) {
    // One 128-column slab a head of G and of the mixer (two past 128: the instantiation WIDE128); the
    // operand buffers, the attention output, m_w2, the two rings and the tail's LayerNorm sums are fixed;
    // every latent's logits where they fit.
    P.ldW = LDA128;
    *smem = SMEM128;
    return place_logits(P, smem, TILE128);
  }
  // Narrow: `narrow_layout`, and every latent's logits where they fit in the room of BLOCKS<class> blocks an SM.
  const NarrowLayout L = narrow_layout(*cls, P.hid, P.hidm, P.H, P.D);
  P.ldW = L.ld;
  *smem = L.prob;
  const size_t room = narrow_room(*cls);
  return place_logits(P, smem, TILE128, *smem <= room ? room : SMEM_CAP);
}

// Every class's blocks are persistent over the work items (batch row, tile of item_tile coordinates): 64
// coordinates an item, or 32 where items of 64 would leave half of the grid's slots (the blocks the SMs hold
// at once) idle, as at the nef step's fits (8 x 512 on 132 SMs).
bool persistent_class(int) { return true; }
int item_tile(int, int B, int C, long long slots) {
  const long long items = (long long)B * ((C + TILE128 - 1) / TILE128);
  return 2 * items <= slots ? TILE : TILE128;
}
}  // namespace

#define K1_WIDE_CLASS WIDE128          // the launcher takes hidm or D past 128 at the class 128 in WIDE128
#define K1_NARROW_SLOTS narrow_slots   // and caps a narrow class's blocks an SM
#include "fused_decode_fwd_host.cuh"  // the launcher's C interface (shared with the f32 program)
