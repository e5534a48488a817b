// Fused ENF decode, forward: CUDA C++ for Hopper (sm_90a), its products on the tensor
// cores at f32 accuracy (3xTF32), the latents batched into the rows of the layers that
// share weights (products over a latent group's rows on wgmma), in four instantiations by
// width class: 128 (Navier-Stokes, shallow water) stages every weight by cp.async in a ring;
// the narrow classes 16, 32 and 64 are laid out below ("Width classes").
//
// Replaces the TPU kernel `_fwd_kernel` launched by `_fwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py), whose body is `_tile_decode`. The plain
// PyTorch version of the same function is `fused_decode_plain` in
// enf_pde_tpu_torch/ops/fused_decode.py; the folded inputs (A, ab, G, c and the
// folded weights) come from `fold_decode_weights` there. What this program shares with the bf16
// one (fused_decode_fwd_bf16.cu) lives in fused_decode_fwd_common.cuh (constants, launch
// parameters, staging, the row passes, the mixer) and fused_decode_fwd_host.cuh (the launcher).
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
// Design. One block of 256 threads (two warpgroups) decodes TILE = 32 coordinates of one
// batch row; the grid is (ceil(C / TILE), B), so neighbouring blocks share a row's A/G/c in
// L2. One pass over the latents in groups of ZG, with the softmax over Z taken online, as a
// fused attention takes it over a long key axis: a group's logits from the query chain, then
// per (coordinate, head) the running max m and sum l of exp(logit - m) are updated, the
// accumulator's columns of that head are rescaled by exp(m_old - m_new), and the group's
// value chains add exp(logit - m_new) * vmix. The last group divides by the complete l, in
// its weights and in the accumulator's factor, so no pass follows. The update and the
// rescale share the barriers of the value chain's RFF staging: none is added. Shared
// memory does not depend on Z. As the Pallas kernel does (`inv3.reshape(Z*T, I)`), the
// latents go into the rows of the layers whose weights they share, ZG = 4 latents (128
// rows) at a time:
//   q_w1, v_w1, fw  one [4 T x hid] @ [hid x hid] product each (`dense128`);
//   m_w2            one [128 x hidm] @ [hidm x D] product per pair of latents and pair of
//                   heads (`mixer`): a thread's two fragment rows are one coordinate in the
//                   two latents, so it weights both by their softmax probabilities and adds
//                   the sum into the accumulator; no two threads write one element.
// What differs per latent stays per latent: G[b, z] as a [T x hid] @ [hid x H*hidm] product
// (`dense32`), A[b, z] (N = H) as dot products on the CUDA cores (`lane_dots`), as is the
// head's last layer (N = out_dim). The tail's products have T = 32 rows (`dense32`).
//
// Products. 3xTF32: each operand x = big + small, both tf32 (tf32_mma.cuh); small x small is
// dropped, about 2^-21 relative per product.
//   128 rows: wgmma m64n64k8 (A from registers, B K-major from shared memory, no swizzle),
//     one warpgroup per 64 rows, two n64 halves per 128-column slab, three wgmma (small x
//     big, big x small, big x big) per k step of 8. The wrapper hands the four weights over
//     pre-split and blocked (`split_weights` in fused_decode.py): one 16 KB block per
//     16-deep k chunk and 128 columns, which the ring takes whole. The warps split their A
//     fragments themselves. ptxas serializes every wgmma of a kernel whose wgmma crosses a
//     function call or a path that differs between warpgroups, so these products are
//     inlined and branch on nothing per warpgroup but whether it has rows.
//   32 rows: mma.sync m16n8k8 through mma_3xtf32_tiles, which issues each term across all
//     of a warp's 2 x NJ tiles before the next; the 8 warps split N (32 columns each). G
//     and the tail weights come raw and are split per fragment (each element is read by one
//     warp); the block splits each A chunk once into a float2 buffer, one chunk ahead.
// Staging: 16-deep k chunks by 16-byte cp.async into a ring of 3 stages (16,896 bytes each),
// two chunks ahead of the products, one barrier per chunk; no register round trip.
// Activations stay in shared memory with row strides of 4 mod 32 words and the staged raw
// weights with 8 mod 32, so every fragment load is conflict free.
//
// Accuracy: the length of the chain an accumulator carries before it is added into f32
// registers (the tensor core truncates when it aligns addends; K2 drifted to 1.8e-3 with
// its whole sums in the accumulator). Measured on an H100 against the plain version,
// rel-L2 at b = 160, c = 512 with the tail, one call of tools/k1_compare.py that built each
// chain length as a variant of this source (PERF.md §6):
//   used: mma.sync fresh per two k steps of 8 (a staged chunk, 6 mma), wgmma the whole slab
//     in the accumulator (16 k steps, 48 wgmma): 1.37e-6;
//   mma.sync fresh per k step: 1.36e-6; its whole sum (up to 32 steps, 96 mma): 5.58e-6;
//     wgmma fresh per two k steps: 1.04e-6.
// An earlier build measured mma.sync chains of 4 and 8 k steps at 1.18e-6 and 1.87e-6.
// Every shape chip_smoke.py checks stays within 2.4e-6 of the plain version (gate 1e-5;
// 1.5e-6 at Navier-Stokes width with z = 4).
//
// Shared memory at Navier-Stokes width (I = 4, hid = 128, H = 2, hidm = D = 128), any Z:
//   X      [128 x 132] f32       67,584 B   RFF features, then u / t of the group's latents
//   Y      [128 x 132] f32       67,584 B   hq / hv; a latent pair's pre [64 x 260]; the tail's
//   acc    [32 x 260] f32        33,280 B   the weighted sum y, then the tail's activations
//   ring   3 x 16 x 264 f32      50,688 B   B chunks (a 16 KB wgmma block or 16 x 256 raw f32)
//   A      2 x 32 x 20 float2    10,240 B   the split A chunks of the 32-row products
//   the group's logits, then weights [ZG][32][H] 1,024 B; running max, sum, factor [3][32][H] 768 B
//   231,168 B of the 232,448 B a block may have (SMEM_CAP): one block (two warpgroups) per SM.
// A group's invariants, [4][32][I], are staged in Y while it is idle (I <= hid + 4).
// L2 weight bytes per block of 32 points: q_w1, v_w1, fw 3 x 128 KB (pre-split, once for all
// four latents); m_w2 2 x 128 KB (once per pair); G 4 x 128 KB; A 4 KB; the tail's o_w, p_w1,
// p_w2 3 x 256 KB, h_w1 128 KB, h_w2 64 KB: 2,116 KB, 67.7 kB per decoded point (86 KB in
// the PR 7 build, which streamed every shared weight once per latent and head, in f32).
//
// Width classes. `layout` picks the instantiation from hid, hidm and D: the narrowest of
// 16, 32, 64 that holds all three, else 128 (the design above, unchanged). The narrow classes
// differ where the parent design lost its time at those widths (tools/k1_compare.py --skip on
// it, PERF.md §6: at ihc the LayerNorm pass 41 %, the wgmma chunk loops 28 %, the mma.sync
// chunk loops 15 %; 255 registers with spills, one block an SM):
//   wgmma at the layer's own width: m64nWNk8 for q_w1, v_w1, fw (N = hid) and m_w2 (N = D),
//     WN / 2 accumulator registers, no zero columns (128-wide slabs were 3/4 zeros at hid 32);
//     split_weights lays the weights out in WN-wide blocks of 32 WN floats a 16-deep chunk.
//   the shared weights resident (16, 32: RES, 8 / 32 KB, loaded once by cp.async per block)
//     or in a ring of three narrow blocks (64: resident would take 128 KB and one block an SM;
//     the ring leaves two: 10.46 against 11.81 ms at cahn_hilliard's 160 x 2048, one call of
//     tools/k1_compare.py). Persistent blocks: a grid of the blocks the SMs hold at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each walking the work items (batch
//     row, tile) from blockIdx.x by gridDim.x.
//   latents spread evenly over ceil(Z / ZG) groups of at most ZG16 = 8, ZG32 = 4, ZG64 = 4
//     (z = 25: four groups of 4 and three of 3, never a group of one); at 16 a warpgroup
//     multiplies tiles wg and wg + 2 (MT = 2) and the mixer four heads a call. At 32, groups
//     of 6 (five of 5 at z = 25) took 15.99 against 14.98 ms (the fourth tile is multiplied
//     whether it has rows or not, and more registers spill); at 16, groups of 4 took 4.74
//     against 4.63 (one call of tools/k1_compare.py each).
//   G and the tail with no ring (`dense32_direct`, not inlined): B fragments from L2 into
//     registers a k step ahead, the first before the barrier; a latent pair's two G products
//     side by side on four warps each (15.43 -> 14.21 ms at ihc, 4.99 -> 4.27 at
//     diff_sphere); the group's A staged in shared memory for the logits.
//   gelu only on the columns a LayerNorm segment has (the class 128 takes it of all 256
//     register columns), a low-register two-pass LayerNorm for the tail.
//   several blocks an SM: __launch_bounds__(256, 2), 128 registers a thread. ptxas spills
//     200-500 bytes a thread, cheaper than one block an SM (19.82 against 16.07 ms at ihc)
//     or 80 registers and three (24.99 against 16.60).
// Shared memory, any Z (k1_smem_bytes mirrors it; the library's layout agrees on the card):
//   16 (diff_sphere: I 1, H 2): X, Y [256 x 20], acc [32 x 36], weights 8 KB      57,600 B
//   32 (ihc: I 5, H 3):         X, Y [128 x 36], acc [32 x 100], weights 32 KB    93,824 B
//   64 (planar: I 2, H 2):      X, Y [128 x 68], acc [32 x 132], ring 24 KB      114,944 B
//   with the group's logits, the softmax's running max, sum and factor, and the group's A:
//   two blocks an SM at each (233,472 B an SM, 1 KB of it kept back per block; registers
//   allow two at each).
// What bounds them: the products, three TF32 products each on the tensor cores: 1.067 ms at
// ihc's 160 x 2048, 0.147 ms at diff_sphere's, 1.278 ms at cahn_hilliard's, 0.352 ms at
// diffusion_plane's 160 x 1024. Measured, one call of tools/k1_compare.py against the
// earlier build on an H100 (PERF.md §6): 14.21 ms (parent 36.15), 4.27 (16.53), 10.87
// (16.68), 2.83 (4.26): 13x, 29x, 8.5x and 8.0x the bound. What is left: the 32-row
// products' waits on L2 (dense32_direct: 31 % at ihc), the group products (about a quarter)
// and the LayerNorm passes; every step of a group is a barrier apart.
//
// What bounds it: 1.415 MFLOP of products per point, three TF32 products each on the tensor
// cores: 0.70 ms at b = 160, c = 512 (1.73 ms in f32 on the CUDA cores); a few bytes of input
// per point. Measured 4.67 ms (PERF.md): the 32-row mma.sync products take about half, the
// 128-row wgmma ones a fifth, the row passes (LayerNorm with gelu, RFF, logits) most of the
// rest.
// The online softmax against the earlier two-pass build, one call of tools/k1_compare.py
// (PERF.md §6): -2.2 % at Navier-Stokes width (z = 4, 160 x 512), +2.0 % at z = 9 (hid 64,
// 160 x 2048), +5.9 % at z = 18 (hid 16, 160 x 2048). The invariants are staged rather than
// read from global memory in the RFF pass, whose dependent loads then wait on L2 (+9.9 % at
// z = 9); the update runs on all lanes and shares barriers rather than taking its own
// (64 threads and two barriers of their own: +3.6 %).

#include "fused_decode_fwd_common.cuh"  // constants, Params, staging, row passes, mixer (shared with the bf16 program)
#include "tf32_mma.cuh"                  // split_tf32_int, mma_3xtf32_tiles (the header K2 shares)

namespace {

constexpr int WG_BLOCK = 2 * 2 * 8 * WG_N;  // floats of a pre-split chunk: part x k step x 8 x 128
constexpr int LDA = KC + 4;  // float2 per row of a block-split A chunk: fragment loads conflict free
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS + 2 * 2 * 32 * LDA;  // the B ring, then two A chunks
constexpr float TWO_PI = 6.283185307179586f;
static_assert(STAGES >= 2 && WG_BLOCK <= STAGE_FLOATS, "ring");

// What a width class fixes at compile time.
template <int WN>
struct Width {
  static constexpr bool NARROW = WN < WG_N;
  static constexpr int ZGN = zg_of(WN);                 // the most latents a group
  static constexpr int MT = (ZGN * TILE / 64 + 1) / 2;  // m64 row tiles a warpgroup takes: tiles wg, wg + 2
  static constexpr int ZL = ZGN <= 4 ? 4 : 8;           // lanes of a (coordinate, head) in the online softmax
  static constexpr bool RES = res_of(WN);
  static constexpr int MINB = WN == 16 ? MINB16 : WN == 32 ? MINB32 : WN == 64 ? MINB64 : 1;
  static constexpr int BLOCK = 2 * 2 * 8 * WN;          // floats of one pre-split chunk (16 k x WN columns)
  static_assert(ZGN <= ZL && MT >= 1 && MT <= 2, "class");
};

// The hooks of fused_decode_fwd_common.cuh: f32 operands (the products split them into tf32
// parts themselves), sin and cos by sincosf.
__device__ __forceinline__ float operand(float x) { return x; }
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c) { sincosf(TWO_PI * proj, s, c); }

// ---- 32-row products: 3xTF32 mma.sync ------------------------------------------------------
// Y = act(X W + bias) for the TILE rows of X (shared memory, row stride ldx) and W [K x N] in
// global memory, f32, on the tensor cores at f32 accuracy. The 8 warps split N: warp w owns
// the two m16 tiles of rows and NJ n8 tiles of each slab of 8 x 8 NJ columns. Per chunk of
// KC k rows: W is staged by cp.async into the ring, two chunks ahead, and split per fragment
// (each element is read by one warp); the block splits the X chunk once into one of two
// [32][LDA] float2 buffers after the ring, one chunk ahead (all warps read all of it). K must
// be a multiple of KC and N of 4. Every thread of the block calls it; it starts with a barrier
// (X may have been written just before) and does not end with one.
template <int NJ, int ACT>
__device__ __noinline__ void dense32(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                     const float* __restrict__ bias, float* Y, int ldy, float* ring) {
  constexpr int WN = 8 * NJ, SW = WARPS * WN;
  constexpr int LD = SW + 8;                   // floats per staged k row: B loads conflict free
  constexpr int CPT = KC * SW / 4 / THREADS;   // 16-byte copies a thread issues per chunk
  constexpr int APT = 32 * KC / THREADS;       // X elements a thread splits per chunk
  static_assert(KC * LD <= STAGE_FLOATS && CPT * 4 * THREADS == KC * SW && APT * THREADS == 32 * KC, "staging");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nk = K / KC, total = nk * ((N + SW - 1) / SW);
  float2* astage = reinterpret_cast<float2*>(ring + STAGES * STAGE_FLOATS);

  // What this thread copies and splits does not change from chunk to chunk: its offsets are
  // computed once (no divisions in the loop).
  int c_dst[CPT], c_src[CPT], c_col[CPT], a_src[APT], a_dst[APT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int idx = tid + i * THREADS, kk = idx / (SW / 4), q = idx % (SW / 4);
    c_col[i] = 4 * q;
    c_dst[i] = kk * LD + 4 * q;
    c_src[i] = kk * N + 4 * q;
  }
#pragma unroll
  for (int i = 0; i < APT; ++i) {
    const int idx = tid + i * THREADS, r = idx / KC, kk = idx % KC;
    a_src[i] = r * ldx + kk;
    a_dst[i] = r * LDA + kk;
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
  auto split_x = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < APT; ++i) astage[buf * 32 * LDA + a_dst[i]] = split_tf32_int(X[a_src[i] + k0]);
  };

  __syncthreads();  // earlier readers of the ring and astage (and writers of X) are done
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  split_x(0, 0);
  float acc[2][NJ][4];
  int s = 0, kc = 0, cst = 0;  // slab, k chunk and ring stage of chunk c
  for (int c = 0; c < total; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's have, and X chunk c is split; all are done with chunk c - 1
    issue(c + STAGES - 1);        // into the stage chunk c - 1 used
    if (c + 1 < total) split_x(kc + 1 == nk ? 0 : (kc + 1) * KC, (c + 1) & 1);
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
      const float2* xs = astage + (c & 1) * 32 * LDA;
      uint32_t ab[2][2][4], as[2][2][4];  // [k step][m16 tile][fragment register]
      uint32_t bb[2][NJ][2], bs[2][NJ][2];  // [k step][n8 tile][fragment register]
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float2* a = xs + (mi * 16 + g) * LDA + 8 * q + tq;
          const float2 v[4] = {a[0], a[8 * LDA], a[4], a[8 * LDA + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[q][mi][e] = __float_as_uint(v[e].x);
            as[q][mi][e] = __float_as_uint(v[e].y);
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 w = split_tf32_int(st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g]);
            bb[q][j][r] = __float_as_uint(w.x);
            bs[q][j][r] = __float_as_uint(w.y);
          }
      }
      // A fresh accumulator per chunk (two k steps, 6 mma a tile), added into f32 registers.
      float p[2][NJ][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mi][j][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < 2; ++q) mma_3xtf32_tiles(p, ab[q], as[q], bb[q], bs[q]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] += p[mi][j][e];
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
// k step ahead of the products (the first before the barrier), and its A fragments from X in
// shared memory, both split per fragment. Same products and chains as dense32 (a fresh
// accumulator per two k steps, added into f32 registers). Not inlined: its registers are its
// own, not added to the kernel's; no wgmma crosses the call. Measured at ihc's 160 x 2048 (one
// call of tools/k1_compare.py each, PERF.md §6): inlined 16.60 ms, not inlined 16.07; with
// its B fragments four k steps ahead 22.31 ms inlined (3.8 KB of spills a thread) and 19.81
// not inlined. `sync`: the barrier (X may have been written just before). Warps w0 ..
// w0 + nw - 1 take the product (a latent pair's two G products run side by side, four warps
// each); the others must not call it.
template <int NJ, int ACT>
__device__ __noinline__ void dense32_direct(const float* X, int ldx, int K, const float* __restrict__ W, int N,
                                            const float* __restrict__ bias, float* Y, int ldy, bool sync, int w0,
                                            int nw) {
  constexpr int WN = 8 * NJ;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0, SW = nw * WN;
  const int g = lane >> 2, tq = lane & 3;
  const int nks = K / 8;
  auto load = [&](float (&dst)[NJ][2], int n0, int ks) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + 8 * j + g;
        dst[j][r] = n < N ? __ldg(W + (size_t)(8 * ks + tq + 4 * r) * N + n) : 0.0f;
      }
  };
  float cur[NJ][2], nxt[NJ][2] = {};
  int n0 = warp * WN;
  if (n0 < N) load(cur, n0, 0);
  if (sync) __syncthreads();
  for (; n0 < N; n0 += SW) {  // warp-uniform
    float acc[2][NJ][4], p[2][NJ][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = p[mi][j][e] = 0.0f;
    for (int ks = 0; ks < nks; ++ks) {
      if (ks + 1 < nks)
        load(nxt, n0, ks + 1);
      else if (n0 + SW < N)
        load(nxt, n0 + SW, 0);  // the next slab's first k step
      uint32_t ab[2][4], as[2][4], bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = X + (mi * 16 + g) * ldx + 8 * ks + tq;
        const float v[4] = {a[0], a[8 * ldx], a[4], a[8 * ldx + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 sp = split_tf32_int(v[e]);
          ab[mi][e] = __float_as_uint(sp.x);
          as[mi][e] = __float_as_uint(sp.y);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 w = split_tf32_int(cur[j][r]);
          bb[j][r] = __float_as_uint(w.x);
          bs[j][r] = __float_as_uint(w.y);
          cur[j][r] = nxt[j][r];
        }
      mma_3xtf32_tiles(p, ab, as, bb, bs);
      if (ks & 1) {  // a chunk of two k steps (K is a multiple of 16): into f32 registers
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mi][j][e] += p[mi][j][e];
              p[mi][j][e] = 0.0f;
            }
      }
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

// ---- Products over the rows of a latent group: 3xTF32 wgmma ------------------------------------
// D (64 x N, f32, this thread's N / 2 values) = A (64 x 8 tf32, registers: this warp's 16
// rows in the m16n8k8 A-fragment order) x B (8 x N tf32, K-major in shared memory, `desc`)
// + (accumulate ? D : 0), one asynchronous warpgroup product, N = 16, 32 or 64. D's fragment:
// n8 tile j at d[4 j .. 4 j + 3] = (row g, col 8 j + 2 t), (g, 8 j + 2 t + 1), (g + 8, 8 j + 2 t),
// (g + 8, 8 j + 2 t + 1) of the warp's 16 rows.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
}
// out = X W for the rows of a latent group on the tensor cores at f32 accuracy. Warpgroup wg
// (warps 4 wg .. 4 wg + 3) multiplies the 64-row tiles wg + 2 mt (mt < MT) by each WN-wide slab
// of N: at WN = 128 as two m64n64k8 products, below it as one m64nWNk8 product; warp w supplies
// A rows 16 w .. 16 w + 15 of a tile from shared memory (xrow(wg, mt, w, r) points at row r of
// them), split per fragment into registers. W is split_weights' blocked layout: each block (big
// and small, two k steps, WN columns) is either staged whole into the ring by cp.async, two
// chunks ahead (RES false), or read where it lies, the block's resident copy of the weight
// (RES: no ring, no barrier past the first). 3xTF32 is three wgmma per k step (small x big, big
// x small, big x big) and a slab's whole sum in the accumulator (the header's accuracy note), one
// commit and wait a chunk. active(wg, mt) says whether the tile has rows (a warpgroup's tiles
// fill in order: none is active unless its first is); epi(wg, mt, w, r, n, v0, v1) gets column n
// of rows r (0..7) and r + 8 of warp w's 16. Every thread of the block calls it; it starts with
// a barrier and does not end with one.
template <int WN, int MT, bool RES, class XRow, class Active, class Epi>
__device__ __forceinline__ void gemm_wg(XRow xrow, Active active, int K, const float* __restrict__ W, int N,
                                        float* ring, Epi epi) {
  constexpr int NB = WN < 64 ? WN : 64;       // columns of one wgmma
  constexpr int NH = WN / NB;                 // wgmma a slab, k step and tile
  constexpr int NACC = WN / 2;                // accumulator registers a tile
  constexpr int BLOCK = 2 * 2 * 8 * WN;       // floats of a pre-split chunk: part x k step x 8 x WN
  constexpr int RS = WN == WG_N ? STAGE_FLOATS : BLOCK;  // floats of a ring stage
  constexpr int CPT = BLOCK / 4 / THREADS;    // 16-byte copies a thread issues per chunk
  static_assert(RES || CPT * 4 * THREADS == BLOCK, "ring copies");
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
#pragma unroll
      for (int i = 0; i < CPT; ++i) cp_async16(st + 4 * (tid + i * THREADS), src + 4 * (tid + i * THREADS), true);
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
      uint32_t ab[MT][2][4], as[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = kc * KC + 8 * q + tq;
          const float v[4] = {xr0[mt][k], xr1[mt][k], xr0[mt][k + 4], xr1[mt][k + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 sp = split_tf32_int(v[e]);
            ab[mt][q][e] = __float_as_uint(sp.x);
            as[mt][q][e] = __float_as_uint(sp.y);
          }
        }
      }
      const float* st = RES ? W + (kc * nslab + s) * BLOCK : ring + cst * RS;
      // The whole slab's sum stays in the accumulator: one commit and wait a chunk.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wg_fence_operands<NACC>(acc[mt]);
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < NH; ++half)  // NH products of NB columns: NB / 2 accumulator registers each
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* b = st + q * 8 * WN + half * 8 * NB;  // k step q, n groups NB / 8 half ..
            const uint64_t big = wg_desc(b), small = wg_desc(b + 2 * 8 * WN);
            wgmma_tf32<NB>(acc[mt] + NB / 2 * half, as[mt][q], big, 1);
            wgmma_tf32<NB>(acc[mt] + NB / 2 * half, ab[mt][q], small, 1);
            wgmma_tf32<NB>(acc[mt] + NB / 2 * half, ab[mt][q], big, 1);
          }
      }
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
  constexpr int ZGN = Cls::ZGN, MT = Cls::MT, ZL = Cls::ZL;
  extern __shared__ __align__(16) float smem[];
  const int Z = P.Z, H = P.H, I = P.I, hid = P.hid, D = P.D, hidm = P.hidm, C = P.C;
  const int HD = H * D, HH = H * hidm, ldX = P.ldX, ldP = P.ldP, ldW = P.ldW;
  float* X = smem;                        // [ZGN * TILE][ldX]
  float* Y = X + ZGN * TILE * ldX;        // nY floats
  float* acc = Y + P.nY;                  // [TILE][ldW]
  float* ring = acc + TILE * ldW;         // [STAGES][STAGE_FLOATS] and two A chunks; narrow: the shared weights or their ring
  float* s_prob = ring + (NARROW ? P.nW : RING_FLOATS);  // [ZGN][TILE][H] the group's logits, then its weights
  float* s_max = s_prob + ZGN * TILE * H;  // [TILE][H] running max of the logits
  float* s_sum = s_max + TILE * H;       // [TILE][H] running sum of exp(logit - max)
  float* s_scale = s_sum + TILE * H;     // [TILE][H] the factor acc's columns of head h take
  float* s_A = s_scale + TILE * H;       // narrow: [ZGN][hid][H] the group's A
  const int tid = threadIdx.x;
  // The four shared weights: resident in the ring's place (narrow, RES), else pre-split in global memory.
  const int wq_floats = hid / KC * Cls::BLOCK;
  const float* Wq = RES ? ring : P.q_w1s;
  const float* Wv = RES ? ring + wq_floats : P.v_w1s;
  const float* Wf = RES ? ring + 2 * wq_floats : P.fws;
  const float* Wm = RES ? ring + 3 * wq_floats : P.m_w2s;

  // Decodes the TILE coordinates from c0 of batch row b into out.
  auto decode_tile = [&](const int b, const int c0) {
    const int rows = min(TILE, C - c0);  // valid coordinates in this tile

    // Online softmax over the latent groups, after the group's logits are in s_prob: the
    // running max m and sum l of each (coordinate, head) take the group in, its logits become
    // exp(logit - m_new), and s_scale holds exp(m_old - m_new), the factor the accumulator's
    // columns of that head take before the group's value chains add into it. After the last
    // group l is complete, and both are divided by it. One lane per (coordinate, head, latent
    // of the group), the ZL lanes of a pair adjacent: shuffles reduce over the group.
    static_assert(ZL <= 32 && (ZL & (ZL - 1)) == 0, "a group's lanes lie in one warp");
    auto online_softmax = [&](int z0, int nz) {
      const bool first = z0 == 0, last = z0 + nz >= Z;
      for (int base = tid; base < TILE * H * ZL; base += THREADS) {  // TILE H ZL: whole warps
        const int zz = base % ZL, pair = base / ZL;  // pair = t H + h
        const bool valid = zz < nz;
        const float x = valid ? s_prob[zz * TILE * H + pair] : -INFINITY;
        const float m_old = first ? -INFINITY : s_max[pair];
        const float l_old = first ? 0.0f : s_sum[pair];
        float m = fmaxf(m_old, x);
#pragma unroll
        for (int o = 1; o < ZL; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float ms = m == -INFINITY ? 0.0f : m;  // every logit so far -inf: exp gives 0, not NaN
        float e = valid ? expf(x - ms) : 0.0f, sum = e;
#pragma unroll
        for (int o = 1; o < ZL; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        float scale = expf(m_old - ms);  // 0 for the first group
        const float l = l_old * scale + sum;
        if (last) {
          const float inv_l = 1.0f / l;
          e *= inv_l;
          scale *= inv_l;
        }
        __syncwarp();  // every lane of the pair has read m_old and l_old
        if (valid) s_prob[zz * TILE * H + pair] = e;
        if (zz == 0) {
          s_max[pair] = m;
          s_sum[pair] = l;
          s_scale[pair] = scale;
        }
      }
    };

    // The RFF features of a group's latents into X, their invariants staged in Y, which is
    // idle between the last pair's mixer and the first product of either chain (narrow: the
    // query chain stages the group's A beside them). Before the value chain's, the online
    // softmax takes the group's logits in beside the staging, and the accumulator takes its
    // factor beside the features: no barrier of their own.
    float* s_inv = Y;  // [ZGN][TILE][I]
    auto features = [&](int z0, int nz, const float* coeff, bool softmax) {
      __syncthreads();  // earlier readers of X and Y are done, the group's logits written
      if (softmax) online_softmax(z0, nz);
      for (int idx = tid; idx < nz * TILE * I; idx += THREADS) {
        const int zz = idx / (TILE * I), rem = idx - zz * TILE * I, t = rem / I;
        s_inv[idx] = t < rows ? P.inv[((size_t)(b * Z + z0 + zz) * C + c0) * I + rem] : 0.0f;
      }
      if (NARROW && !softmax)  // A[b, z0 .. z0 + nz) is contiguous
        for (int idx = tid; idx < nz * hid * H; idx += THREADS) s_A[idx] = __ldg(P.A + ((size_t)b * Z + z0) * hid * H + idx);
      __syncthreads();
      if (softmax && z0 > 0)  // acc holds the earlier groups' sum: a warp per row, lanes along n
        for (int t = tid >> 5; t < TILE; t += WARPS)
          for (int h = 0; h < H; ++h) {
            const float f = s_scale[t * H + h];
            for (int n = tid & 31; n < D; n += 32) acc[t * ldW + h * D + n] *= f;
          }
      rff_features(s_inv, nz * TILE, I, coeff, hid / 2, X, ldX);
    };

    for (int idx = tid; idx < TILE * HD; idx += THREADS) acc[(idx / HD) * ldW + idx % HD] = 0.0f;
    // Groups of at most ZGN latents; the narrow classes spread Z evenly over them, so a last
    // group is never left with a latent or two (z = 25 at ZG32 = 4: four groups of 4, three of 3).
    const int ngroups = (Z + ZGN - 1) / ZGN;
    for (int gi = 0; gi < ngroups; ++gi) {
      const int z0 = NARROW ? gi * Z / ngroups : gi * ZG;
      const int nz = NARROW ? (gi + 1) * Z / ngroups - z0 : min(ZG, Z - z0);
      // The group's logits from the query chain, its latents' rows in one product.
      features(z0, nz, P.q_coeff, false);
      dense_group<WN, MT, RES, ACT_RELU>(X, ldX, nz * TILE, hid, Wq, hid, P.q_b1, Y, ldX, ring);
      __syncthreads();
      // logit[z, t, h] = hq[z, t] . A[b, z][:, h] + ab + wb: one warp per (latent, head).
      lane_dots<NARROW>(
          nz * H, hid, H, [&](int o, int t) { return Y + ((o / H) * TILE + t) * ldX; },
          [&](int o) {
            return NARROW ? s_A + (o / H) * hid * H + o % H : P.A + ((size_t)b * Z + z0 + o / H) * hid * H + o % H;
          },
          [&](int o, int t, float s) {
            const int zz = o / H, h = o % H;
            const size_t bz = (size_t)b * Z + z0 + zz;
            s_prob[(zz * TILE + t) * H + h] =
                s + __ldg(P.ab + bz * H + h) + (t < rows ? __ldg(P.wb + bz * C + c0 + t) : 0.0f);
          });

      // The group's FiLM-conditioned value chains, weighted into acc.
      features(z0, nz, P.v_coeff, true);
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
        mixer<WN, MT, RES>(Y, P.ldP, np, H, hidm, D, Wm, P.m_b2, s_prob + zp * TILE * H, acc, ldW, ring);
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
    // X, Y, acc, the ring and two A chunks, the group's logits, running max, sum and factor.
    *smem = sizeof(float) * ((size_t)ZG * TILE * P.ldX + nY + (size_t)TILE * P.ldW + (size_t)RING_FLOATS +
                             (size_t)(ZG + 3) * TILE * P.H);
    return *smem <= SMEM_CAP;
  }
  // Narrow: X and Y take a group's ZG rows at a stride of WN + 4 words (4 mod 8: the
  // A-fragment loads hit distinct banks), the shared weights (or their ring) replace the ring,
  // and the group's A is staged beside the softmax's state.
  const int wn = *cls, zg = zg_of(wn), rows = zg * TILE;
  P.ldX = wn + 4;
  size_t nY = (size_t)rows * P.ldX;
  if ((size_t)2 * TILE * P.ldP > nY) nY = (size_t)2 * TILE * P.ldP;
  if ((size_t)TILE * P.ldW > nY) nY = (size_t)TILE * P.ldW;
  P.nY = (int)nY;
  P.nW = res_of(wn) ? (3 * P.hid + P.hidm) / KC * 32 * wn : STAGES * 32 * wn;
  *smem = sizeof(float) * ((size_t)rows * P.ldX + nY + (size_t)TILE * P.ldW + (size_t)P.nW +
                           (size_t)(zg + 3) * TILE * P.H + (size_t)zg * P.hid * P.H);
  return *smem <= SMEM_CAP;
}
// The narrow classes' blocks are persistent; the class 128 takes one block a tile. An item is a tile.
bool persistent_class(int wn) { return wn < WG_N; }
int item_tile(int, int, int, long long) { return TILE; }
}  // namespace

#include "fused_decode_fwd_host.cuh"  // the launcher's C interface (shared with the bf16 program)
