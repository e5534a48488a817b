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
//     takes every latent's logits (the query chain) into shared memory ([Z][TILE][H]), the
//     softmax over Z follows, and a second pass takes the value chains. Where the logits do not
//     fit beside the rest (Z > 52 at NS width), they go to a workspace in global memory that the
//     wrapper allocates ([B][tiles][Z][TILE][H], a block's tile at its own offset, read back by
//     the block that wrote it): the layout no longer depends on Z, and every Z that the f32
//     program takes, this one takes.
// Products:
//   128 rows: wgmma m64nNk16 bf16 (A from registers, rounded per fragment; B K-major in shared
//     memory): one wgmma per 16-deep chunk where 3xTF32 takes six. The wrapper hands the four
//     shared weights over in bf16, blocked as wgmma reads them (`bf16_weights` in
//     fused_decode.py): one block of 16 x WN bf16 per chunk and slab, element (16 kc + 8 kg + i,
//     WN s + 8 ng + r) at [ng][kg][r][i], 4 KB at WN = 128 (a quarter of the split f32 block).
//   32 rows: mma.sync m16n8k16 bf16, A and B fragments rounded as they are loaded (G and the tail
//     come raw, in f32).
// The narrow classes 16 and 32 keep the shared weights resident (2 / 8 KB); 64 streams them
// through a ring of three 2 KB blocks.
// Shared memory (k1_smem_bytes mirrors it, with compute_dtype=torch.bfloat16): the f32
// program's X, Y and acc, the ring without the split A chunks (class 128) or the bf16 weights
// (narrow), every latent's logits [Z][TILE][H] where they fit and, narrow, the group's A:
//   NS (I 4, hid 128, H 2, z 4): 220,160 B; shallow water (z 8) 221,184 B; one block an SM;
//   NS past z = 52: 219,136 B with the logits in global memory.
// Accuracy: against the plain bf16 version on the card the gates are relative to the bf16
// function's own distance from f32 (two right bf16 programs differ by chaotic roundings):
// chip_smoke.py's phase 35, where every launch shape lies within 0.21 of that distance.
// What bounds it: the products at the bf16 rate, 0.117 ms at NS 160 x 512. Measured (PERF.md §6,
// an H100): 3.34 ms there against 4.63 for the f32 program; 0.81-0.86x the f32 program at
// the narrow classes. The products were not the bulk: the row passes and the staging remain.

#include "fused_decode_fwd_common.cuh"  // constants, Params, staging, row passes, mixer (shared with the f32 program)
#include "bf16_mma.cuh"                  // bf16_round, pack_bf16, mma_bf16, wgmma_bf16, fast_sincos

namespace {

constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;  // the B ring
static_assert(STAGES >= 2 && 8 * WG_N <= STAGE_FLOATS, "ring");

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

// ---- 32-row products: bf16 mma.sync --------------------------------------------------------
// Y = act(X W + bias) for the TILE rows of X (shared memory, row stride ldx) and W [K x N] in
// global memory, f32, on the tensor cores with bf16 operands. The 8 warps split N: warp w owns
// the two m16 tiles of rows and NJ n8 tiles of each slab of 8 x 8 NJ columns. Per chunk of KC
// k rows: W is staged raw by cp.async into the ring, two chunks ahead, and rounded per fragment
// (each element is read by one warp); A's fragments are read from X and rounded. K must be a
// multiple of KC and N of 4. Every thread of the block calls it; it starts with a barrier (X
// may have been written just before) and does not end with one.
template <int NJ, int ACT>
__device__ __noinline__ void dense32(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                     const float* __restrict__ bias, float* Y, int ldy, float* ring) {
  constexpr int WN = 8 * NJ, SW = WARPS * WN;
  constexpr int LD = SW + 8;                   // floats per staged k row: B loads conflict free
  constexpr int CPT = KC * SW / 4 / THREADS;   // 16-byte copies a thread issues per chunk
  static_assert(KC * LD <= STAGE_FLOATS && CPT * 4 * THREADS == KC * SW, "staging");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nk = K / KC, total = nk * ((N + SW - 1) / SW);

  // What this thread copies does not change from chunk to chunk: its offsets are computed once.
  int c_dst[CPT], c_src[CPT], c_col[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int idx = tid + i * THREADS, kk = idx / (SW / 4), q = idx % (SW / 4);
    c_col[i] = 4 * q;
    c_dst[i] = kk * LD + 4 * q;
    c_src[i] = kk * N + 4 * q;
  }
  int is = 0, ik = 0, ist = 0;  // slab, k chunk and ring stage of the next chunk to issue
  auto issue = [&](int c) {
    if (c < total) {
      const float* src = W + ik * KC * N + is * SW;
      float* st = ring + ist * STAGE_FLOATS;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const bool ok = is * SW + c_col[i] < N;
        cp_async16(st + c_dst[i], ok ? src + c_src[i] : W, ok);
      }
      if (++ik == nk) { ik = 0; ++is; }
      if (++ist == STAGES) ist = 0;
    }
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  };

  __syncthreads();  // earlier readers of the ring (and writers of X) are done
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  float acc[2][NJ][4];
  int s = 0, kc = 0, cst = 0;  // slab, k chunk and ring stage of chunk c
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's have; all are done with chunk c - 1
    issue(c + STAGES - 1);        // into the stage chunk c - 1 used
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
    }
    const int ncols = N - s * SW;
    if (warp * WN < ncols) {
      const float* st = ring + cst * STAGE_FLOATS;
      uint32_t a[2][4], bf[NJ][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* x = X + (mi * 16 + g) * ldx + kc * KC + 2 * tq;
        a[mi][0] = pack_bf16(x[0], x[1]);
        a[mi][1] = pack_bf16(x[8 * ldx], x[8 * ldx + 1]);
        a[mi][2] = pack_bf16(x[8], x[9]);
        a[mi][3] = pack_bf16(x[8 * ldx + 8], x[8 * ldx + 9]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* b = st + 2 * tq * LD + warp * WN + 8 * j + g;
        bf[j][0] = pack_bf16(b[0], b[LD]);
        bf[j][1] = pack_bf16(b[8 * LD], b[9 * LD]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[mi][j], a[mi], bf[j]);
      if (kc == nk - 1) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = warp * WN + 8 * j + 2 * tq + e;
            if (n >= ncols) continue;
            const float bn = __ldg(bias + s * SW + n);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                Y[(mi * 16 + g + 8 * h) * ldy + s * SW + n] = activate<ACT>(acc[mi][j][2 * h + e] + bn);
          }
      }
    }
    if (++kc == nk) { kc = 0; ++s; }
    cst = cst + 1 == STAGES ? 0 : cst + 1;
  }
  cp_async_wait<0>();
}

// The 32-row layers (one latent's G, the tail): four n8 tiles a warp when N is wide.
template <int ACT>
__device__ __forceinline__ void dense32(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                        const float* __restrict__ bias, float* Y, int ldy, float* ring) {
  if (N > 128)
    dense32<4, ACT>(X, ldx, K, W, N, bias, Y, ldy, ring);
  else
    dense32<2, ACT>(X, ldx, K, W, N, bias, Y, ldy, ring);
}

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
template <int WN, bool WITH_TAIL>
__global__ void __launch_bounds__(THREADS, Width<WN>::MINB) fused_decode_fwd_kernel(const Params P) {
  using Cls = Width<WN>;
  constexpr bool NARROW = Cls::NARROW, RES = Cls::RES;
  constexpr int ZGN = Cls::ZGN, MT = Cls::MT;
  extern __shared__ __align__(16) float smem[];
  const int Z = P.Z, H = P.H, I = P.I, hid = P.hid, D = P.D, hidm = P.hidm, C = P.C;
  const int HD = H * D, HH = H * hidm, ldX = P.ldX, ldP = P.ldP, ldW = P.ldW;
  float* X = smem;                        // [ZGN * TILE][ldX]
  float* Y = X + ZGN * TILE * ldX;        // nY floats
  float* acc = Y + P.nY;                  // [TILE][ldW]
  float* ring = acc + TILE * ldW;         // [STAGES][STAGE_FLOATS]; narrow: the shared weights or their ring
  float* s_lg = ring + (NARROW ? P.nW : RING_FLOATS);  // [Z][TILE][H] every latent's logits, unless in P.lg
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
      if constexpr (NARROW)
        normalize<true, WN>(X, ldX, nz * TILE, 1, hid);  // t of every latent of the group
      else
        normalize<true>(X, ldX, nz * TILE, 1, hid);
      for (int zp = 0; zp < nz; zp += 2) {  // pairs of latents
        const int np = min(2, nz - zp);
        if constexpr (NARROW) {
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
        } else {
          for (int zz = 0; zz < np; ++zz) {
            const size_t bz = (size_t)b * Z + z0 + zp + zz;
            dense32<ACT_NONE>(X + (zp + zz) * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH, P.c + bz * HH,
                              Y + zz * TILE * ldP, ldP, ring);
          }
        }
        __syncthreads();
        if constexpr (NARROW)
          normalize<true, WN>(Y, ldP, np * TILE, H, hidm);  // gelu, then each head
        else
          normalize<true>(Y, ldP, np * TILE, H, hidm);
        mixer<WN, MT, RES>(Y, P.ldP, np, H, hidm, D, Wm, P.m_b2, s_prob + (z0 + zp) * TILE * H, acc, ldW, ring);
      }
    }

    float* dst = P.out + ((size_t)b * C + c0) * (WITH_TAIL ? P.out_dim : HD);
    if (WITH_TAIL) {
      if constexpr (NARROW) {
        dense32_direct<ACT_NONE>(acc, ldW, HD, P.o_w, HD, P.o_b, Y, ldW);
        dense32_direct<ACT_NONE>(Y, ldW, HD, P.p_w1, HD, P.p_b1, acc, ldW);
        __syncthreads();
        normalize_rows(acc, ldW, HD);
        dense32_direct<ACT_GELU>(acc, ldW, HD, P.p_w2, HD, P.p_b2, Y, ldW);
        dense32_direct<ACT_GELU>(Y, ldW, HD, P.h_w1, hid, P.h_b1, acc, ldW);
        dense32_direct<ACT_GELU>(acc, ldW, hid, P.h_w2, hid, P.h_b2, Y, ldW);
      } else {
        dense32<ACT_NONE>(acc, ldW, HD, P.o_w, HD, P.o_b, Y, ldW, ring);
        dense32<ACT_NONE>(Y, ldW, HD, P.p_w1, HD, P.p_b1, acc, ldW, ring);
        __syncthreads();
        normalize<true>(acc, ldW, TILE, 1, HD);
        dense32<ACT_GELU>(acc, ldW, HD, P.p_w2, HD, P.p_b2, Y, ldW, ring);
        dense32<ACT_GELU>(Y, ldW, HD, P.h_w1, hid, P.h_b1, acc, ldW, ring);
        dense32<ACT_GELU>(acc, ldW, hid, P.h_w2, hid, P.h_b2, Y, ldW, ring);
      }
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

  if constexpr (NARROW) {
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
  } else {
    decode_tile(blockIdx.y, blockIdx.x * TILE);
  }
}
// Adds every latent's logits ([Z][TILE][H]) to *smem where they fit beside the rest; else they
// go to the launch's workspace in global memory (P.lg_global). False if the rest does not fit.
bool place_logits(Params& P, size_t* smem) {
  const size_t lg = sizeof(float) * (size_t)P.Z * TILE * P.H;
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
    P.ldX = row_stride(P.hid);
    size_t nY = (size_t)ZG * TILE * P.ldX;
    if ((size_t)2 * TILE * P.ldP > nY) nY = (size_t)2 * TILE * P.ldP;
    if ((size_t)TILE * P.ldW > nY) nY = (size_t)TILE * P.ldW;
    P.nY = (int)nY;
    P.nW = 0;
    // X, Y, acc, the ring, every latent's logits where they fit.
    *smem = sizeof(float) * ((size_t)ZG * TILE * P.ldX + nY + (size_t)TILE * P.ldW + (size_t)RING_FLOATS);
    return place_logits(P, smem);
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
  return place_logits(P, smem);
}
}  // namespace

#include "fused_decode_fwd_host.cuh"  // the launcher's C interface (shared with the f32 program)
