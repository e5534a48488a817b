// Fused ENF decode, forward, the bf16 program: CUDA C++ for Hopper (sm_90a), its products on
// the tensor cores with bf16 operands and f32 accumulation, as the JAX kernel runs on its chip
// (`fused_enf_decode(compute_dtype=jnp.bfloat16)`, the default; the decoder's `pallas` backend).
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_fwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py) in its bf16 mode, whose body is `_tile_decode` with
// `_Spec.compute_dtype` bf16. The plain PyTorch version of the same function is
// `fused_decode_plain(..., compute_dtype=torch.bfloat16)` in enf_pde_tpu_torch/ops/fused_decode.py.
// The f32 program (3xTF32, the `pallas_interpret` backend's) is fused_decode_fwd.cu; this source
// is that design with the products and the softmax changed, and its header states the math, the
// blocks, the width classes and the staging; fused_decode_fwd_common.cuh and
// fused_decode_fwd_host.cuh hold what the two programs share. What the bf16 mode changes, and this source with it:
//   - every product operand is rounded to bf16 (bf16_mma.cuh): the RFF features, the hidden
//     layers, the normalized activations, the folded A and G, the tail's activations and every
//     weight; the products are exact and their sums f32. The RFF projection, the biases, gelu,
//     the LayerNorm statistics and the softmax stay f32;
//   - sin and cos of the RFF features by the polynomial of `_fast_sincos` (fast_sincos);
//   - the softmax weights rounded to bf16 before they weight the values. That rounding needs
//     each weight whole, so the softmax is not taken online: a first pass over the latent groups
//     takes every latent's logits (the query chain) into shared memory ([Z][rows][H]), the
//     softmax over Z follows, and a second pass takes the value chains. Where the logits do not
//     fit beside the rest, they go to a workspace in global memory that the wrapper allocates
//     (narrow: [B][tiles][Z][TILE][H], a block's tile at its own offset; class 128: a slot of
//     [Z][64][H] for each block), read back by the block that wrote them: the layout no longer
//     depends on Z, and every Z that the f32 program takes, this one takes.
// The width class 128 (NS, SW, nonmaml, abs_pos; hid at most 128) has a design of its own,
// below (`decode128`): persistent blocks over work items of 64 coordinates (32 where 64 would leave
// half of the SMs idle), every product a bf16 wgmma m64n64k16 with A and B in shared memory (no
// mma.sync), its columns split between the two warpgroups, G and the tail's weights handed over in
// bf16 blocks as wgmma reads them (`k1_operands` in fused_decode.py: G once a decode, or once a
// launch), the activations stored in bf16 where their next use is a product operand, gelu, the
// LayerNorm statistics and the logits taken from the accumulator registers in the epilogues (no row
// pass over shared memory but the RFF features and the softmax), m_w2 resident, the rest streamed by
// each warpgroup on its own. hidm or D past 128 (up to 256, as the f32 program takes them) launch an
// instantiation of its own (WIDE128): a head of G and m_w2 in two 128-column slabs, each warpgroup's
// columns in two n64 parts, m_w2 streamed; the NS-width instantiation's code is the one above.
// The narrow classes (16, 32, 64) keep their design (persistent blocks) with bf16 products:
//   wgmma m64nNk16 bf16 over a latent group's rows (A from registers, rounded per fragment; B K-major
//     in shared memory, the shared weights handed over by `bf16_weights`: one block of 16 x WN bf16 per
//     chunk and slab, element (16 kc + 8 kg + i, WN s + 8 ng + r) at [ng][kg][r][i]);
//   mma.sync m16n8k16 bf16 for the 32-row ones (G and the tail, read raw in f32 from L2, rounded as
//     their fragments are loaded);
//   the shared weights resident at 16 and 32 (2 / 8 KB), through a ring of three 2 KB blocks at 64.
// Shared memory (k1_smem_bytes mirrors it, with compute_dtype=torch.bfloat16): at the class 128
// SMEM128 (two bf16 operand buffers of 64 x 256, the attention output [64][264] f32, m_w2's 32 KB, two
// rings of STAGES128 4 KB chunks, the row sums' exchange) and every latent's logits, [Z][64][H]:
//   NS (I 4, hid 128, H 2, z 4): 202,752 B; shallow water (z 8) 204,800 B; one block an SM;
//   past z = 62 at NS width the logits go to global memory (200,704 B), a slot for each block.
// Narrow: the f32 program's X, Y and acc, the bf16 weights, every latent's logits and the group's A.
// Accuracy: against the plain bf16 version on the card the gates are relative to the bf16
// function's own distance from f32 (two right bf16 programs differ by chaotic roundings):
// chip_smoke.py's phase 35.
// What bounds it: the products at the bf16 rate, 0.1172 ms at NS 160 x 512 (NVIDIA H100 80GB HBM3,
// 700 W). Measured (PERF.md §6, NVIDIA H100 80GB HBM3 at 700.00 W): the earlier design (at 2697ec8),
// 32-row tiles and row passes over f32 shared memory, 3.26-3.35 ms there, its tail alone 1.17 ms; this design 1.7590 ms
// (15.0x the bound; chip_smoke.py's phase 35) and 1.75-2.00 ms in tools/k1_compare.py (two builds of
// the same program), SW 160 x 2048 11.42 ms (20.88), nonmaml 160 x 2048 6.71 ms (13.01). What holds it
// now is latency: every phase costs about its share of the code (k1_compare --skip), the epilogues'
// CUDA-core work, the features, the barriers a chunk and a latent, with two warpgroups an SM.

#include "fused_decode_fwd_common.cuh"  // constants, Params, staging, row passes, mixer (shared with the f32 program)
#include "bf16_mma.cuh"                  // bf16_round, pack_bf16, mma_bf16, wgmma_bf16, fast_sincos

namespace {


// What a width class fixes at compile time.
template <int WN>
struct Width {
  static constexpr bool NARROW = WN < WG_N;
  static constexpr int ZGN = zg_of(WN);                 // the most latents a group
  static constexpr int MT = (ZGN * TILE / 64 + 1) / 2;  // m64 row tiles a warpgroup takes: tiles wg, wg + 2
  static constexpr bool RES = res_of(WN);
  static constexpr int MINB = WN == 16 ? MINB16 : WN == 32 ? MINB32 : WN == 64 ? MINB64 : 1;
  static constexpr int BLOCK = 8 * WN;                  // floats of one bf16 block (16 k x WN columns)
  static_assert(MT >= 1 && MT <= 2, "class");
};

// The hooks of fused_decode_fwd_common.cuh: operands rounded to bf16, sin and cos by the bf16
// mode's polynomial (`_fast_sincos`).
__device__ __forceinline__ float operand(float x) { return bf16_round(x); }
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c) { fast_sincos(proj, s, c); }

// The narrow classes' 32-row products, with no ring and no barrier past the first: warp w owns
// columns 8 NJ w .. 8 NJ w + 8 NJ - 1 of each slab of 64 NJ, loads its B fragments straight from
// global memory (L2: G and the tail are read by every block of a batch row) into registers one
// k step of 16 ahead of the products (the first before the barrier), and its A fragments from X
// in shared memory, both rounded per fragment. Not inlined: its registers are its own; no wgmma
// crosses the call. `sync`: the barrier (X may have been written just before). Warps w0 ..
// w0 + nw - 1 take the product (a latent pair's two G products run side by side, four warps
// each); the others must not call it.
template <int NJ, int ACT>
__device__ __noinline__ void dense32_direct(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                            const float* __restrict__ bias, float* Y, int ldy, bool sync, int w0,
                                            int nw) {
  constexpr int WN = 8 * NJ;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0, SW = nw * WN;
  const int g = lane >> 2, tq = lane & 3;
  const int nks = K / 16;
  // B fragment values of k step ks: k = 16 ks + 2 tq, + 1, + 8, + 9 of column n0 + 8 j + g.
  auto load = [&](float (&dst)[NJ][4], int n0, int ks) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + g;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dst[j][r] = n < N ? __ldg(W + (size_t)(16 * ks + 2 * tq + (r & 1) + 8 * (r >> 1)) * N + n) : 0.0f;
    }
  };
  float cur[NJ][4], nxt[NJ][4] = {};
  int n0 = warp * WN;
  if (n0 < N) load(cur, n0, 0);
  if (sync) __syncthreads();
  for (; n0 < N; n0 += SW) {  // warp-uniform
    float acc[2][NJ][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
    for (int ks = 0; ks < nks; ++ks) {
      if (ks + 1 < nks)
        load(nxt, n0, ks + 1);
      else if (n0 + SW < N)
        load(nxt, n0 + SW, 0);  // the next slab's first k step
      uint32_t a[2][4], bf[NJ][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* x = X + (mi * 16 + g) * ldx + 16 * ks + 2 * tq;
        a[mi][0] = pack_bf16(x[0], x[1]);
        a[mi][1] = pack_bf16(x[8 * ldx], x[8 * ldx + 1]);
        a[mi][2] = pack_bf16(x[8], x[9]);
        a[mi][3] = pack_bf16(x[8 * ldx + 8], x[8 * ldx + 9]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bf[j][0] = pack_bf16(cur[j][0], cur[j][1]);
        bf[j][1] = pack_bf16(cur[j][2], cur[j][3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[j][r] = nxt[j][r];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[mi][j], a[mi], bf[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * tq + e;
        if (n >= N) continue;
        const float bn = __ldg(bias + n);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) Y[(mi * 16 + g + 8 * h) * ldy + n] = activate<ACT>(acc[mi][j][2 * h + e] + bn);
      }
  }
}

// As many n8 tiles a warp (up to 3) as N needs over the nw warps in one slab.
template <int ACT>
__device__ __forceinline__ void dense32_direct(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                               const float* __restrict__ bias, float* Y, int ldy, bool sync = true,
                                               int w0 = 0, int nw = WARPS) {
  const int cols = (N + nw - 1) / nw;  // columns a warp
  if (cols > 16)
    dense32_direct<3, ACT>(X, ldx, K, W, N, bias, Y, ldy, sync, w0, nw);
  else if (cols > 8)
    dense32_direct<2, ACT>(X, ldx, K, W, N, bias, Y, ldy, sync, w0, nw);
  else
    dense32_direct<1, ACT>(X, ldx, K, W, N, bias, Y, ldy, sync, w0, nw);
}

// ---- Products over the rows of a latent group: bf16 wgmma ------------------------------------// out = X W for the rows of a latent group on the tensor cores, bf16 operands. Warpgroup wg
// (warps 4 wg .. 4 wg + 3) multiplies the 64-row tiles wg + 2 mt (mt < MT) by each WN-wide slab
// of N: at WN = 128 as two m64n64k16 products, below it as one m64nWNk16 product; warp w supplies
// A rows 16 w .. 16 w + 15 of a tile from shared memory (xrow(wg, mt, w, r) points at row r of
// them), rounded into registers. W is bf16_weights' blocked layout: each block (16 k, WN columns)
// is either staged whole into the ring by cp.async, two chunks ahead (RES false), or read where it
// lies, the block's resident copy of the weight (RES: no ring, no barrier past the first). A
// slab's whole sum stays in the accumulator, one commit and wait a chunk. active(wg, mt) says
// whether the tile has rows (a warpgroup's tiles fill in order: none is active unless its first
// is); epi(wg, mt, w, r, n, v0, v1) gets column n of rows r (0..7) and r + 8 of warp w's 16.
// Every thread of the block calls it; it starts with a barrier and does not end with one.
template <int WN, int MT, bool RES, class XRow, class Active, class Epi>
__device__ __forceinline__ void gemm_wg(XRow xrow, Active active, int K, const float* __restrict__ W, int N,
                                        float* ring, Epi epi) {
  constexpr int NB = WN < 64 ? WN : 64;       // columns of one wgmma
  constexpr int NH = WN / NB;                 // wgmma a slab, chunk and tile
  constexpr int NACC = WN / 2;                // accumulator registers a tile
  constexpr int BLOCK = 8 * WN;               // floats of a bf16 chunk: 16 k x WN
  constexpr int RS = WN == WG_N ? STAGE_FLOATS : BLOCK;  // floats of a ring stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, wg = warp >> 2, w = warp & 3;
  bool act[MT];
  const float* xr0[MT];
  const float* xr1[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    act[mt] = active(wg, mt);
    xr0[mt] = xrow(wg, mt, w, g);
    xr1[mt] = xrow(wg, mt, w, g + 8);
  }
  const int nk = K / KC, nslab = (N + WN - 1) / WN, total = nk * nslab;
  int is = 0, ik = 0, ist = 0;  // slab, k chunk and ring stage of the next chunk to issue
  auto issue = [&](int c) {
    if (c < total) {
      const float* src = W + (ik * nslab + is) * BLOCK;
      float* st = ring + ist * RS;
      for (int i = tid; i < BLOCK / 4; i += THREADS) cp_async16(st + 4 * i, src + 4 * i, true);
      if (++ik == nk) { ik = 0; ++is; }
      if (++ist == STAGES) ist = 0;
    }
    cp_async_commit();
  };

  __syncthreads();  // earlier readers of the ring (and writers of X) are done
  if constexpr (!RES) {
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) issue(c);
  }
  float acc[MT][NACC];
  int s = 0, kc = 0, cst = 0;  // slab, k chunk and ring stage of chunk c
  for (int c = 0; c < total; ++c) {
    if constexpr (!RES) {
      cp_async_wait<STAGES - 2>();
      fence_async_smem();  // this thread's copies of chunk c are visible to wgmma
      __syncthreads();     // and everyone's; all are done with chunk c - 1
      issue(c + STAGES - 1);
    }
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.0f;
    }
    if (act[0]) {
      // Every tile of the warpgroup is multiplied, its rows valid or not (the epilogue skips
      // an inactive one): a wgmma on a path that differs within the warpgroup's program would
      // have ptxas serialize them all.
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int k = kc * KC + 2 * tq;
        a[mt][0] = pack_bf16(xr0[mt][k], xr0[mt][k + 1]);
        a[mt][1] = pack_bf16(xr1[mt][k], xr1[mt][k + 1]);
        a[mt][2] = pack_bf16(xr0[mt][k + 8], xr0[mt][k + 9]);
        a[mt][3] = pack_bf16(xr1[mt][k + 8], xr1[mt][k + 9]);
      }
      const float* st = RES ? W + (kc * nslab + s) * BLOCK : ring + cst * RS;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wg_fence_operands<NACC>(acc[mt]);
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < NH; ++half)  // NH products of NB columns: NB / 2 accumulator registers each
          wgmma_bf16<NB>(acc[mt] + NB / 2 * half, a[mt], wg_desc(st + half * 8 * NB), 1);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wg_fence_operands<NACC>(acc[mt]);
      if (kc == nk - 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt > 0 && !act[mt]) continue;
#pragma unroll
          for (int j = 0; j < WN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = s * WN + 8 * j + 2 * tq + e;
              if (n < N) epi(wg, mt, w, g, n, acc[mt][4 * j + e], acc[mt][4 * j + 2 + e]);
            }
        }
      }
    }
    if (++kc == nk) { kc = 0; ++s; }
    cst = cst + 1 == STAGES ? 0 : cst + 1;
  }
  if constexpr (!RES) cp_async_wait<0>();
}
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

// This thread's part of a 64 x 64 product: the accumulator element i, its row r = r0 + 8 hr of the
// tile (r0 = 16 warp + g) and its column col = 8 j + 2 tq + e; ACC_PAIRS visits the pairs (col, col + 1)
// at i, i + 1. Loops unrolled into constant register indices.
#define ACC_LOOP(...)                                                                       \
  _Pragma("unroll") for (int j_ = 0; j_ < 8; ++j_)                                           \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr)                                         \
      _Pragma("unroll") for (int e_ = 0; e_ < 2; ++e_) {                                     \
        const int i = 4 * j_ + 2 * hr + e_, col = 8 * j_ + 2 * tq + e_, r = r0 + 8 * hr;       \
        __VA_ARGS__                                                                          \
      }
#define ACC_PAIRS(...)                                                                      \
  _Pragma("unroll") for (int j_ = 0; j_ < 8; ++j_)                                           \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr) {                                       \
      const int i = 4 * j_ + 2 * hr, col = 8 * j_ + 2 * tq, r = r0 + 8 * hr;                  \
      __VA_ARGS__                                                                            \
    }
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
// A warp writes whole core matrices (8 rows x 4 column pairs). Not inlined (no wgmma in it): one copy
// of its code serves both passes.
__device__ __noinline__ void features128(const float* __restrict__ inv, int I, int rows, const float* __restrict__ coeff,
                                         int hid, bf16* X16) {
  const int half = hid >> 1, units = TILE128 * (half >> 1);
#pragma unroll 2
  for (int u = threadIdx.x; u < units; u += THREADS) {
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
      features128(P.inv + (bz * C + c0) * P.I, P.I, rows, P.q_coeff, hid, X16);
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
      features128(P.inv + (bz * C + c0) * P.I, P.I, rows, P.v_coeff, hid, X16);
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
      // The head's last layer on the CUDA cores: a warp an (output, 32 rows), lane t a row.
      const int od = P.out_dim, warp = tid >> 5, lane = tid & 31;
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
    } else {
      for (int idx = tid; idx < rows * HD; idx += THREADS) dst[idx] = accs[(idx / HD) * LDA128 + idx % HD];
    }
  }
}

template <int WN, bool WITH_TAIL>
__global__ void __launch_bounds__(THREADS, Width<WN>::MINB) fused_decode_fwd_kernel(const Params P) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (WN == WG_N) {
    decode128<WITH_TAIL, false>(P, smem);
  } else if constexpr (WN == WIDE128) {
    decode128<WITH_TAIL, true>(P, smem);
  } else {
  // The narrow classes.
  using Cls = Width<WN>;
  constexpr bool NARROW = Cls::NARROW, RES = Cls::RES;
  constexpr int ZGN = Cls::ZGN, MT = Cls::MT;
  const int Z = P.Z, H = P.H, I = P.I, hid = P.hid, D = P.D, hidm = P.hidm, C = P.C;
  const int HD = H * D, HH = H * hidm, ldX = P.ldX, ldP = P.ldP, ldW = P.ldW;
  float* X = smem;                        // [ZGN * TILE][ldX]
  float* Y = X + ZGN * TILE * ldX;        // nY floats
  float* acc = Y + P.nY;                  // [TILE][ldW]
  float* ring = acc + TILE * ldW;         // [STAGES][STAGE_FLOATS]; narrow: the shared weights or their ring
  float* s_lg = ring + P.nW;            // [Z][TILE][H] every latent's logits, unless in P.lg
  float* s_A = s_lg + (P.lg_global ? 0 : Z * TILE * H);  // narrow: [ZGN][hid][H] the group's A
  const int tid = threadIdx.x;
  // The four shared weights: resident in the ring's place (narrow, RES), else in global memory (bf16 blocks).
  const int wq_floats = hid / KC * Cls::BLOCK;
  const float* Wq = RES ? ring : P.q_w1s;
  const float* Wv = RES ? ring + wq_floats : P.v_w1s;
  const float* Wf = RES ? ring + 2 * wq_floats : P.fws;
  const float* Wm = RES ? ring + 3 * wq_floats : P.m_w2s;

  // Decodes the TILE coordinates from c0 of batch row b into out.
  auto decode_tile = [&](const int b, const int c0) {
    const int rows = min(TILE, C - c0);  // valid coordinates in this tile
    // Every latent's logits, then its weights: in shared memory, or this tile's slot of P.lg.
    float* s_prob = P.lg_global ? P.lg + ((size_t)b * ((C + TILE - 1) / TILE) + c0 / TILE) * Z * TILE * H : s_lg;

    // The RFF features of a group's latents into X, their invariants staged in Y, which is
    // idle between the last pair's mixer and the first product of either chain (narrow: the
    // query chain stages the group's A beside them).
    float* s_inv = Y;  // [ZGN][TILE][I]
    auto features = [&](int z0, int nz, const float* coeff, bool query) {
      __syncthreads();  // earlier readers of X and Y are done
      for (int idx = tid; idx < nz * TILE * I; idx += THREADS) {
        const int zz = idx / (TILE * I), rem = idx - zz * TILE * I, t = rem / I;
        s_inv[idx] = t < rows ? P.inv[((size_t)(b * Z + z0 + zz) * C + c0) * I + rem] : 0.0f;
      }
      if (NARROW && query)  // A[b, z0 .. z0 + nz) is contiguous
        for (int idx = tid; idx < nz * hid * H; idx += THREADS) s_A[idx] = __ldg(P.A + ((size_t)b * Z + z0) * hid * H + idx);
      __syncthreads();
      rff_features(s_inv, nz * TILE, I, coeff, hid / 2, X, ldX);
    };

    for (int idx = tid; idx < TILE * HD; idx += THREADS) acc[(idx / HD) * ldW + idx % HD] = 0.0f;
    // Groups of at most ZGN latents; the narrow classes spread Z evenly over them, so a last
    // group is never left with a latent or two (z = 25 at ZG32 = 4: four groups of 4, three of 3).
    const int ngroups = (Z + ZGN - 1) / ZGN;
    auto group = [&](int gi, int& z0, int& nz) {
      z0 = NARROW ? gi * Z / ngroups : gi * ZG;
      nz = NARROW ? (gi + 1) * Z / ngroups - z0 : min(ZG, Z - z0);
    };
    // Pass 1: every group's logits from the query chain, its latents' rows in one product.
    for (int gi = 0; gi < ngroups; ++gi) {
      int z0, nz;
      group(gi, z0, nz);
      features(z0, nz, P.q_coeff, true);
      dense_group<WN, MT, RES, ACT_RELU>(X, ldX, nz * TILE, hid, Wq, hid, P.q_b1, Y, ldX, ring);
      __syncthreads();
      // logit[z, t, h] = hq[z, t] . A[b, z][:, h] + ab + wb: one warp per (latent, head).
      lane_dots<NARROW>(
          nz * H, hid, H, [&](int o, int t) { return Y + ((o / H) * TILE + t) * ldX; },
          [&](int o) {
            return NARROW ? s_A + (o / H) * hid * H + o % H : P.A + ((size_t)b * Z + z0 + o / H) * hid * H + o % H;
          },
          [&](int o, int t, float s) {
            const int z = z0 + o / H, h = o % H;
            const size_t bz = (size_t)b * Z + z;
            s_prob[(z * TILE + t) * H + h] =
                s + __ldg(P.ab + bz * H + h) + (t < rows ? __ldg(P.wb + bz * C + c0 + t) : 0.0f);
          });
    }
    // The softmax over the latents, each weight rounded to bf16 (`pr.astype(dt)` in _tile_decode).
    __syncthreads();
    for (int idx = tid; idx < TILE * H; idx += THREADS) {
      float m = -INFINITY;
      for (int z = 0; z < Z; ++z) m = fmaxf(m, s_prob[z * TILE * H + idx]);
      const float ms = m == -INFINITY ? 0.0f : m;  // every logit -inf: exp gives 0, not NaN
      float l = 0.0f;
      for (int z = 0; z < Z; ++z) {
        const float e = expf(s_prob[z * TILE * H + idx] - ms);
        s_prob[z * TILE * H + idx] = e;
        l += e;
      }
      for (int z = 0; z < Z; ++z) s_prob[z * TILE * H + idx] = bf16_round(s_prob[z * TILE * H + idx] / l);
    }
    // Pass 2: every group's FiLM-conditioned value chains, weighted into acc.
    for (int gi = 0; gi < ngroups; ++gi) {
      int z0, nz;
      group(gi, z0, nz);
      features(z0, nz, P.v_coeff, false);
      dense_group<WN, MT, RES, ACT_RELU>(X, ldX, nz * TILE, hid, Wv, hid, P.v_b1, Y, ldX, ring);
      dense_group<WN, MT, RES, ACT_NONE>(Y, ldX, nz * TILE, hid, Wf, hid, P.fb, X, ldX, ring);
      __syncthreads();
      normalize<true, WN>(X, ldX, nz * TILE, 1, hid);  // t of every latent of the group
      for (int zp = 0; zp < nz; zp += 2) {  // pairs of latents
        const int np = min(2, nz - zp);
        if (np == 2) {  // the pair's products side by side: warps 0-3 the first, 4-7 the second
          __syncthreads();
          const int zz = (tid >> 5) >= WARPS / 2;
          const size_t bz = (size_t)b * Z + z0 + zp + zz;
          dense32_direct<ACT_NONE>(X + (zp + zz) * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH, P.c + bz * HH,
                                   Y + zz * TILE * ldP, ldP, false, zz * WARPS / 2, WARPS / 2);
        } else {
          const size_t bz = (size_t)b * Z + z0 + zp;
          dense32_direct<ACT_NONE>(X + zp * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH, P.c + bz * HH, Y, ldP);
        }
        __syncthreads();
        normalize<true, WN>(Y, ldP, np * TILE, H, hidm);  // gelu, then each head
        mixer<WN, MT, RES>(Y, P.ldP, np, H, hidm, D, Wm, P.m_b2, s_prob + (z0 + zp) * TILE * H, acc, ldW, ring);
      }
    }

    float* dst = P.out + ((size_t)b * C + c0) * (WITH_TAIL ? P.out_dim : HD);
    if (WITH_TAIL) {
      dense32_direct<ACT_NONE>(acc, ldW, HD, P.o_w, HD, P.o_b, Y, ldW);
      dense32_direct<ACT_NONE>(Y, ldW, HD, P.p_w1, HD, P.p_b1, acc, ldW);
      __syncthreads();
      normalize_rows(acc, ldW, HD);
      dense32_direct<ACT_GELU>(acc, ldW, HD, P.p_w2, HD, P.p_b2, Y, ldW);
      dense32_direct<ACT_GELU>(Y, ldW, HD, P.h_w1, hid, P.h_b1, acc, ldW);
      dense32_direct<ACT_GELU>(acc, ldW, hid, P.h_w2, hid, P.h_b2, Y, ldW);
      __syncthreads();
      const int od = P.out_dim;
      lane_dots(
          od, hid, od, [&](int, int t) { return Y + t * ldW; }, [&](int o) { return P.h_w3 + o; },
          [&](int o, int t, float s) {
            if (t < rows) dst[t * od + o] = s + __ldg(P.h_b3 + o);
          });
    } else {
      __syncthreads();
      for (int idx = tid; idx < rows * HD; idx += THREADS) dst[idx] = acc[(idx / HD) * ldW + idx % HD];
    }
  };

  {
    // A persistent block: the shared weights come in once (RES), then it walks the work items
    // (batch row, tile) from blockIdx.x by gridDim.x, neighbours sharing a row's A, G and c in L2.
    if constexpr (RES) {
      const float* src[4] = {P.q_w1s, P.v_w1s, P.fws, P.m_w2s};
      const int n[4] = {wq_floats, wq_floats, wq_floats, hidm / KC * Cls::BLOCK};
      float* dst = ring;
      for (int i = 0; i < 4; ++i) {
        for (int j = 4 * tid; j < n[i]; j += 4 * THREADS) cp_async16(dst + j, src[i] + j, true);
        dst += n[i];
      }
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();  // visible to wgmma after the barrier that starts each item
    }
    const int ntiles = (C + TILE - 1) / TILE, items = ntiles * P.B;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      __syncthreads();  // the last item's readers of acc and Y are done
      decode_tile(item / ntiles, item % ntiles * TILE);
    }
  }
  }
}
// Adds every latent's logits ([Z][rows][H]) to *smem where they fit beside the rest; else they go to
// the launch's workspace in global memory (P.lg_global). False if the rest does not fit.
bool place_logits(Params& P, size_t* smem, int rows) {
  const size_t lg = sizeof(float) * (size_t)P.Z * rows * P.H;
  P.lg_global = *smem + lg > SMEM_CAP;
  if (!P.lg_global) *smem += lg;
  return *smem <= SMEM_CAP;
}

// Fills P's strides; false for shapes the kernel does not take. *cls: the width class.
bool layout(Params& P, bool with_tail, size_t* smem, int* cls) {
  if (P.B < 0 || P.B > 65535 || P.Z <= 0 || P.C < 0 || P.I <= 0 || P.H <= 0 || P.out_dim <= 0) return false;
  if (P.hid % KC || P.hidm % KC || P.D % KC || P.hid > 128) return false;  // X holds [128][hid]
  if (P.hidm > MAXW || P.H * P.D > MAXW) return false;                        // normalize's registers
  if (!with_tail && P.out_dim != P.H * P.D) return false;
  if (P.I > P.hid + 4) return false;  // a group's invariants are staged in Y
  const int HD = P.H * P.D, HH = P.H * P.hidm;
  *cls = width_class(P.hid, P.hidm, P.D);
  P.ldP = row_stride(HH);
  P.ldW = row_stride(HD > P.hid ? HD : P.hid);
  if (*cls == WG_N) {
    // One 128-column slab a head of G and of the mixer (two past 128: the instantiation WIDE128); the
    // operand buffers, the attention output, m_w2, the two rings and the tail's LayerNorm sums are fixed;
    // every latent's logits where they fit.
    P.ldX = P.nY = P.nW = 0;
    P.ldW = LDA128;
    *smem = SMEM128;
    return place_logits(P, smem, TILE128);
  }
  // Narrow: X and Y take a group's ZG rows at a stride of WN + 4 words (4 mod 8: the
  // A-fragment loads hit distinct banks), the shared weights (or their ring) replace the ring,
  // and the group's A is staged beside every latent's logits (where they fit).
  const int wn = *cls, zg = zg_of(wn), rows = zg * TILE;
  P.ldX = wn + 4;
  size_t nY = (size_t)rows * P.ldX;
  if ((size_t)2 * TILE * P.ldP > nY) nY = (size_t)2 * TILE * P.ldP;
  if ((size_t)TILE * P.ldW > nY) nY = (size_t)TILE * P.ldW;
  P.nY = (int)nY;
  P.nW = res_of(wn) ? (3 * P.hid + P.hidm) / KC * 8 * wn : STAGES * 8 * wn;
  *smem = sizeof(float) * ((size_t)rows * P.ldX + nY + (size_t)TILE * P.ldW + (size_t)P.nW +
                           (size_t)zg * P.hid * P.H);
  return place_logits(P, smem, TILE);
}

// Every class's blocks are persistent over the work items (batch row, tile of item_tile coordinates):
// the class 128 takes 64 coordinates an item, or 32 where items of 64 would leave half of the grid's
// slots (the blocks the SMs hold at once) idle, as at the nef step's fits (8 x 512 on 132 SMs).
bool persistent_class(int) { return true; }
int item_tile(int wn, int B, int C, long long slots) {
  if (wn < WG_N) return TILE;
  const long long items = (long long)B * ((C + TILE128 - 1) / TILE128);
  return 2 * items <= slots ? TILE : TILE128;
}
}  // namespace

#define K1_WIDE_CLASS WIDE128       // the launcher takes hidm or D past 128 at the class 128 in WIDE128
#include "fused_decode_fwd_host.cuh"  // the launcher's C interface (shared with the f32 program)
