// Fused ENF decode, backward, the bf16 program: CUDA C++ for Hopper (sm_90a), the VJP of the
// bf16 forward (fused_decode_fwd_bf16.cu) with its products on bf16 wgmma, f32 accumulation.
//
// Replaces the TPU kernel `_bwd_kernel` launched by `_bwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py) in its bf16 mode (`_Spec.compute_dtype` bf16): the VJP of
// `_tile_decode` at bf16, as JAX's autodiff takes it through the casts. The plain PyTorch version
// of the same function is `fused_decode_bwd_plain(..., compute_dtype=torch.bfloat16)` in
// enf_pde_tpu_torch/ops/fused_decode.py (autograd over the plain bf16 forward). What the bf16
// function changes against the f32 one, in every design of this source:
//   - every forward product takes its operands rounded to bf16 (bf16_mma.cuh). An input gradient
//     dX = dY W^T is JAX's dot of the f32 cotangent dY with the bf16 W, rounded to bf16 after the
//     product (the cotangent of a bf16 operand): dY goes in as three bf16 terms (exact to f32
//     rounding) and the epilogue rounds. nbar (the softmax-weighted sum of the mixer's normalized
//     hidden, which JAX never rounds) takes three terms too; with both operands in three terms, the
//     six products of terms i + j <= 2;
//   - the gradients of the bf16 operands JAX casts (A, G and every weight matrix) are rounded to
//     bf16 once their sums are whole, in pass 2; m_w2's a head (JAX casts it in each head's
//     product), so its partials are kept a head;
//   - the softmax weights weight the values rounded to bf16 and do not sum to 1: y = nbar m_w2 +
//     (sum_z p16) m_b2, dm_b2 takes the same sums, and the softmax's cotangent is
//     dp = bf16(<e, n16> + <dy, m_b2>) (the bias term no longer cancels);
//   - the polynomial sin / cos of `_fast_sincos` and its derivative in the RFF VJP.
// Partials stay f32 and are reduced in a fixed order: two launches give the same bits.
// Three designs:
//   - the W128 design (`fused_decode_bwd_w128`, below its own header): every launch at hid = hidm = D = 128
//     with two heads (Navier-Stokes width: NS, shallow water, abs_pos, the rollout; `Dims::w128`):
//     bf16 operands written once in wgmma's shared-memory layouts, every product from shared memory
//     by descriptor, its columns split between the two warpgroups, its whole K in the accumulator,
//     the LayerNorm VJPs in the epilogues. Shared memory (k2_smem_bytes mirrors it) W128_SMEM and
//     1,024 B a latent: 211,968 B at NS (z = 4), 216,064 B at shallow water (z = 8); one block an SM;
//   - the narrow design (`narrow_logits` ... `narrow_query_vjp`, below their own header): every launch below the
//     width class 64 (hid = hidm = D = 16, 32, 64: diff_sphere, ihc, the planar configs; `Dims::narrow`): the
//     latents spread over the grid, a (batch row, latent, tile) item a block, kernels on the stream around the
//     softmax over latents, bf16 operands in wgmma's shared-memory layouts, the LayerNorm VJPs in the epilogues;
//   - the class design (the class 64's other shapes: one head at NS width, hid 192, past 24 latents at NS width):
//     the f32 program's (fused_decode_bwd.cu, whose header states its passes, blocks, workspace and partials) with
//     bf16 products: one bf16 wgmma m64n64k16 a 16-deep chunk into a fresh accumulator, A's fragments loaded from
//     f32 shared memory and rounded or split each chunk, B staged through registers, row passes over f32 shared
//     memory; its shared memory the f32 program's with the staging at three quarters of its floats and two [64][H]
//     rows.
// What bounds it: the products at the bf16 rate, 0.1282 / 0.1757 ms at NS 80 x 512 without / with
// weight gradients (NVIDIA H100 80GB HBM3, 700 W). Measured (PERF.md §6, NVIDIA H100 80GB HBM3 at
// 700.00 W; tools/k2_compare.py in one call): the class design at NS 6.28 / 9.05 ms, where its chunk loops
// took 2.04 / 2.33 ms, the LayerNorm passes 1.43 / 1.66, the partials 0.43 / 2.13; the W128 design 4.89 /
// 6.28 ms (38 / 36x the bound), SW 10 x 2048 4.79 / 5.98 (class design 6.20 / 8.83), 400 x 512 24.44 /
// 31.19 (30.89 / 45.18). What holds the W128 design now: its product loops wait on the tensor cores a chunk
// at a time (1.28 ms of the loops, 0.89 of wgmma), the tail (0.99 / 1.67), and with weight gradients
// the partials' traffic (1.45) and the row contractions (1.47).

#include "fused_decode_bwd_common.cuh"  // constants, wgmma / cp.async helpers, shared row passes
#include "bf16_mma.cuh"                  // bf16_round, pack_bf16, split3_bf16, wgmma_bf16, fast_sincos

namespace {

// The W128 design's sizes (fused_decode_bwd_w128, below).
constexpr int W128_HID = 128;    // hid = hidm = D
constexpr int W128_W = 256;      // H hidm = H D, two heads
constexpr int W128_STAGES = 4;   // 4 KB chunks of a warpgroup's ring; the copies run W128_STAGES - 2 ahead
constexpr int W128_RING = 2 * W128_STAGES * 4096;  // bytes of the two rings
constexpr int W128_U = 163840;   // bytes of the operand planes (the phases' union, below)
constexpr int W128_SMALL = 4 * (4 * TILE + TILE * MAX_I + 2048);  // psum, dyb, invariants, the sums' exchange, the column sums
constexpr int W128_SMEM = W128_RING + W128_U + W128_SMALL;  // and every latent's softmax weights and dp: 2 Z TILE 2 floats
constexpr int W128_GBLK = W128_HID * W128_W;  // floats of one (b, z)'s G in bf16 blocks, both ways

// Floats of the B staging: a ring of `stages` chunk buffers of two slabs of 24 wn (three bf16
// parts of 16 k x wn n).
__host__ __device__ constexpr int stage_floats(int wn, int stages) { return stages * 2 * 24 * wn; }

// Sizes and offsets shared by the host launcher and the kernels.
struct Dims {
  int B, Z, C, I, hid, H, D, hidm, out, tail, wgrad;
  int HD, HH, wn;       // H*D, H*hidm, the width class
  int ldh, ldw, n_w2;   // shared row strides of hid-wide and wide buffers; floats of W2
  int stages;           // chunk buffers of the B staging ring: 3 at the width class 64 where they fit, else 2
  long long smem;       // bytes of dynamic shared memory
  int nt;               // tiles a batch row
  long long items;      // work items (batch row, tile)
  int per_sm, ipb, grid, slots;  // blocks an SM holds, items a block, blocks, batch-row slots a block
  // The shared weights in bf16 for the products (`weights_kernel`) at the workspace's
  // start: entry j (SPLIT_* order) at split_off[j] floats (2 bf16 a float), its B K x N (split_K,
  // split_N); split_n of the 18 are laid out (the tail's only with the tail).
  long long split_off[18], split_total;
  int split_K[18], split_N[18], split_n;
  // Workspace floats per block after them, and the offsets of its pieces ([64][width] each).
  long long w_e, w_n, w_y, w_y1, w_q1, w_q2, w_q3, w_q4, work;
  // Partials: per-row sections, the weights (8 attention + 12 tail; m_w2 a head), floats per
  // block; the reduced weight gradients at o_off (m_w2 summed over its heads).
  long long l_A, l_ab, l_G, l_c, l_row;
  long long w_off[20], w_len[20], o_off[20], o_len[20];
  int n_w;
  long long l_w, l_wo, part;
  // The W128 design (fused_decode_bwd_w128): taken, G's bf16 blocks at g_off of the workspace (after the
  // shared weights, inside split_total), and the block's workspace pieces.
  int w128;
  long long g_off, x_e, x_u, x_q1, x_gq2, x_gq3, x_nbar, x_img;
  // The narrow design (narrow_shape, narrow_plan): taken, its width hid = hidm = D, the coordinates padded to
  // whole tiles; the per-latent kernels' items, plan and partials (smem and per_sm above are theirs), the tail's;
  // the workspace: the weight images, G's, every latent's logits (then dp), softmax weights and nn, e and <dy,
  // m_b2>, a tail block's pieces.
  int narrow, nw, smem_t, per_sm_t, n_img;
  long long cp, items_l, items_t;
  int grid_l, ipb_l, grid_t, ipb_t;
  long long lr_A, lr_ab, lr_G, lr_c, lr_row, lw_off[6], part_l, tw_off[20], part_t;
  long long x_w[9], x_g, x_lg, x_p, x_dp, x_nn, x_ee, x_dyb, x_t, ws_total;
  long long t_q1, t_g2, t_g3, t_img, t_nb, t_ws;
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

inline bool narrow_shape(Dims& d);
// The class design's and the W128 design's layout (the class 64); false for what they do not take.
inline bool class_shape(Dims& d) {
  if (d.hid % d.wn || d.hidm % d.wn || d.D % d.wn) return false;
  int wide = d.HH > d.HD ? d.HH : d.HD;
  wide = wide > d.hid ? wide : d.hid;
  d.ldh = row_stride(d.hid);
  d.ldw = row_stride(wide);
  d.n_w2 = TILE * (d.ldw > 2 * d.ldh ? d.ldw : 2 * d.ldh);
  // A third buffer copies the bf16 weights two chunks ahead where it fits (one block an SM).
  for (d.stages = 3; d.stages >= 2; --d.stages) {
    d.smem = 4LL * (stage_floats(d.wn, d.stages) + (long long)TILE * d.ldw + (long long)TILE * d.ldh + d.n_w2 +
                    2LL * d.Z * TILE * d.H + 2LL * TILE * d.H + (long long)TILE * d.I);
    if (d.smem <= SMEM_CAP) break;
  }
  // The class 64 at hid = hidm = D = 128, two heads, takes the W128 design (fused_decode_bwd_w128), where
  // its layout fits.
  const long long w128_smem = W128_SMEM + 4LL * 2 * d.Z * TILE * 2;
  d.w128 = d.wn == 64 && d.hid == W128_HID && d.hidm == W128_HID && d.D == W128_HID && d.H == 2 && w128_smem <= SMEM_CAP;
  if (d.w128) d.smem = w128_smem;
  if (d.smem > SMEM_CAP) return false;
  d.nt = (d.C + TILE - 1) / TILE;
  d.items = (long long)d.B * d.nt;
  if (d.items > 2147483647LL) return false;

  // The shared weights each product reads as its B, in bf16: as X W (K x N = the weight's
  // shape), then as dY W^T (its transpose); the tail's only with the tail.
  const int ks[9] = {d.hid, d.hid, d.hid, d.hidm, d.HD, d.HD, d.HD, d.HD, d.hid};
  const int ns[9] = {d.hid, d.hid, d.hid, d.D, d.HD, d.HD, d.HD, d.hid, d.hid};
  const int per = d.tail ? 9 : 4;
  d.split_n = 2 * per;
  d.split_total = 0;
  for (int tr = 0; tr < 2; ++tr)
    for (int i = 0; i < 9; ++i) {
      const int j = tr * 9 + i;
      d.split_K[j] = tr ? ns[i] : ks[i];
      d.split_N[j] = tr ? ks[i] : ns[i];
      d.split_off[j] = d.split_total;
      if (i < per) d.split_total += (long long)d.split_K[j] * d.split_N[j] / 2;
    }

  const long long T = TILE;
  long long o = 0;
  auto take = [&](bool need, long long n) { long long r = o; if (need) o += n; return need ? r : -1; };
  d.w_e = take(true, T * d.HH);
  d.w_n = take(d.wgrad, T * d.HH);
  d.w_q1 = take(d.tail, T * d.HD); d.w_q2 = take(d.tail, T * d.HD);
  d.w_q3 = take(d.tail, T * d.hid); d.w_q4 = take(d.tail, T * d.hid);
  const bool tw = d.tail && d.wgrad;
  d.w_y = take(tw, T * d.HD); d.w_y1 = take(tw, T * d.HD);
  d.work = o;
  if (d.w128) {  // the tail's q1, gelu'(q2), gelu'(q3); e, u; with weight gradients nbar and the tail's four planes
    o = 0;
    d.x_q1 = take(d.tail, T * W128_W); d.x_gq2 = take(d.tail, T * W128_W); d.x_gq3 = take(d.tail, T * W128_HID);
    if (d.tail) {  // e and u are written after the tail's VJP has read q1 and gelu'(q2): their room
      d.x_e = d.x_q1;
      d.x_u = d.x_gq2;
    } else {
      d.x_e = take(true, T * W128_W);
      d.x_u = take(true, T * W128_HID);
    }
    d.x_nbar = take(d.wgrad, T * W128_W); d.x_img = take(tw, 4 * T * W128_W / 2);
    d.work = o;
    d.g_off = d.split_total;
    d.split_total += (long long)d.B * d.Z * W128_GBLK;
  }

  return true;
}

// Everything but the grid; false for shapes the kernel does not take.
inline bool shape(const int* v, Dims& d) {
  d.B = v[0]; d.Z = v[1]; d.C = v[2]; d.I = v[3]; d.hid = v[4]; d.H = v[5]; d.D = v[6];
  d.hidm = v[7]; d.out = v[8]; d.tail = v[9] != 0; d.wgrad = v[10] != 0;
  if (d.B <= 0 || d.Z <= 0 || d.C <= 0 || d.I <= 0 || d.I > MAX_I || d.H <= 0 || d.out <= 0) return false;
  if (d.hid < 16 || d.hid % 16 || d.hidm < 16 || d.hidm % 16 || d.D < 16 || d.D % 16) return false;
  d.HD = d.H * d.D; d.HH = d.H * d.hidm;
  if (!d.tail && d.out != d.HD) return false;
  if (d.hidm > MAX_SEG || d.HD > MAX_SEG || d.hid > MAX_SEG) return false;  // LayerNorm segments
  d.wn = width_class(d.hid, d.hidm, d.D);
  d.narrow = d.wn < 64;  // the narrow classes take the narrow design (narrow_shape)
  d.w128 = 0;
  if (d.narrow ? !narrow_shape(d) : !class_shape(d)) return false;
  const long long Z = d.Z;
  d.l_A = Z * d.hid * d.H; d.l_ab = Z * d.H; d.l_G = Z * d.hid * d.HH; d.l_c = Z * d.HH;
  d.l_row = d.l_A + d.l_ab + d.l_G + d.l_c;
  int rows[20], cols[20];
  weight_shapes(d, rows, cols);
  d.n_w = d.wgrad ? (d.tail ? 20 : 8) : 0;
  d.l_w = d.l_wo = 0;
  for (int i = 0; i < 20; ++i) d.w_off[i] = d.w_len[i] = d.o_off[i] = d.o_len[i] = 0;
  for (int i = 0; i < d.n_w; ++i) {
    d.o_off[i] = d.l_wo;
    d.o_len[i] = (long long)rows[i] * (cols[i] ? cols[i] : 1);
    d.l_wo += d.o_len[i];
    d.w_off[i] = d.l_w;
    d.w_len[i] = d.o_len[i] * (i == 6 ? d.H : 1);  // m_w2: a head's sum each
    d.l_w += d.w_len[i];
  }
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

// The hooks of fused_decode_bwd_common.cuh: operands rounded to bf16, sin and cos by the bf16
// mode's polynomial (`_fast_sincos`).
__device__ __forceinline__ float operand(float x) { return bf16_round(x); }
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c) { fast_sincos(proj, s, c); }

// ---- wgmma (bf16_mma.cuh's wgmma_bf16) ------------------------------------------------------
template <int WN>
struct Cls {
  static constexpr int PART = 8 * WN;        // floats of one bf16 part of a staged slab: 16 k x WN n
  static constexpr int SLOT = 3 * PART;      // a staged slab: three parts, each [n group][k group][8 n][8 k]
  static constexpr int BUF = 2 * SLOT;       // a chunk of two slabs
  static constexpr int GROUPS = 8 * WN;      // float4 groups (4 k of one n) of a chunk of two slabs
  static constexpr int GPT = (GROUPS + THREADS - 1) / THREADS;
  static constexpr int NACC = WN / 2;        // accumulator registers a thread
};

// out(m, n) = sum_k A(m, k) B(k, n) on the tensor cores with bf16 operands and f32 sums;
// epi(m, n, v0, v1) gets columns n and n + 1 of row m. A_T false: A(m, k) = A[m * lda + k],
// M = 64 (the tile's rows); true: A(m, k) = A[k * lda + m] for m < M, zero beyond (a row
// contraction, K = 64). B per BMODE with row stride ldb. K is a multiple of KC, N of WN. AP / BP:
// the bf16 terms of A / B, 1 (the operand rounded to bf16, as JAX rounds it) or 3 (an f32 operand
// JAX does not round, split3_bf16); a chunk takes the products of terms i + j <= 2 (the rest are
// below f32 rounding of the product), the smallest first. Units (an m64 tile, a WN slab) go in rounds of two, one
// a warpgroup; the two units of a round share each staged chunk (one slab when they differ in m,
// two when in n). The staging is a ring of nst (2 or 3) chunk buffers: a bf16 weight's chunks are
// copied by cp.async nst - 1 chunks ahead of the products; any other B is loaded into registers
// two chunks ahead and rounded and stored one ahead, while the products run. Per chunk: A's
// fragments from shared memory, rounded; the wgmma into a fresh accumulator (its first does not
// accumulate), added into f32 sums. Every thread of the block calls it; it starts with a barrier
// and does not end with one.
template <int WN, bool A_T, int BMODE, int AP, int BP, class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, int M, int K, const float* B, int ldb, int N,
                                     float* stage, int nst, Epi epi) {
  using Cl = Cls<WN>;
  constexpr int NACC = Cl::NACC, GPT = Cl::GPT;
  static_assert((AP == 1 || AP == 3) && (BP == 1 || BP == 3) && !(BMODE == B_SPLIT && BP == 3), "terms");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, wg = warp >> 2, w = warp & 3;
  const int mtiles = A_T ? (M + TILE - 1) / TILE : 1;
  const int units = mtiles * (N / WN), nk = K / KC;
  __nv_bfloat16* const stage16 = reinterpret_cast<__nv_bfloat16*>(stage);
  for (int u0 = 0; u0 < units; u0 += 2) {
    const int u1 = u0 + 1 < units ? u0 + 1 : u0;  // a lone last unit: the second warpgroup repeats it
    const int u = wg ? u1 : u0;
    const bool valid = u0 + wg < units;
    const int mt = u % mtiles, ns = u / mtiles, ns0 = u0 / mtiles, ns1 = u1 / mtiles;
    const int nslots = ns1 == ns0 ? 1 : 2;
    const float* st0 = stage + (ns == ns0 ? 0 : Cl::SLOT);
    const int m0 = mt * TILE + 16 * w + g, m1 = m0 + 8;
    // This thread's groups of a chunk: a source offset (without the chunk's k) and a staging
    // offset in bf16 elements (the first part's; part p is p PART floats further).
    int src_off[GPT], dst_off[GPT];
    bool has[GPT];
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int gi = tid + i * THREADS;
      has[i] = gi < nslots * 4 * WN;
      const int s = gi / (4 * WN), rem = gi % (4 * WN);
      const int nb = (s ? ns1 : ns0) * WN;
      int kq, n;
      if (BMODE == B_NK) {  // lanes: 8 n of one k quad, then the k quads, then n groups
        kq = (rem % 32) / 8;
        n = (rem / 32) * 8 + rem % 8;
        src_off[i] = (nb + n) * ldb + 4 * kq;
      } else {  // lanes along n
        kq = rem / WN;
        n = rem % WN;
        src_off[i] = 4 * kq * ldb + nb + n;
      }
      dst_off[i] = 2 * s * Cl::SLOT + (n >> 3) * 128 + (kq >> 1) * 64 + (n & 7) * 8 + (kq & 1) * 4;
    }
    // B_SPLIT: chunk c's slabs copied whole into ring buffer buf (the hi part), one cp.async group
    // a chunk (an empty one past the last, so that the waits count uniformly).
    auto copy = [&](int c, int buf) {
      if (c < nk) {
        const int nsl = N / WN;
        float* dst = stage + buf * Cl::BUF;
        for (int i = tid; i < nslots * Cl::PART / 4; i += THREADS) {
          const int sl = i / (Cl::PART / 4), off = 4 * (i % (Cl::PART / 4));
          cp_async16(dst + sl * Cl::SLOT + off, B + ((size_t)c * nsl + (sl ? ns1 : ns0)) * Cl::PART + off);
        }
      }
      cp_async_commit();
    };
    // Chunk c's copies have landed (nst - 1 chunks are copied ahead: the later ones may not have).
    auto copied = [&]() {
      if (nst == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      fence_async_smem();  // this thread's copies are visible to wgmma
    };
    float4 raw[GPT];
    auto load = [&](int c) {
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        if (!has[i]) continue;
        if (BMODE == B_NK) {
          raw[i] = __ldg(reinterpret_cast<const float4*>(B + src_off[i] + c * KC));
        } else {
          const float* p = B + src_off[i] + (size_t)c * KC * ldb;
          if (BMODE == B_KN)  // G, or an activation this block kept in the workspace: not through the
                              // read-only cache, which does not see the block's own later writes
            raw[i] = make_float4(__ldcg(p), __ldcg(p + ldb), __ldcg(p + 2 * ldb), __ldcg(p + 3 * ldb));
          else
            raw[i] = make_float4(p[0], p[ldb], p[2 * ldb], p[3 * ldb]);
        }
      }
    };
    auto store = [&](int buf) {  // the loaded chunk's values, in BP bf16 terms, into ring buffer buf
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        if (!has[i]) continue;
        const float4 v = raw[i];
        __nv_bfloat16* dst = stage16 + 2 * buf * Cl::BUF + dst_off[i];
        if (BP == 3) {
          uint32_t lo[3], hi[3];
          split3_bf16(v.x, v.y, lo);
          split3_bf16(v.z, v.w, hi);
#pragma unroll
          for (int t = 0; t < 3; ++t) *reinterpret_cast<uint2*>(dst + 2 * t * Cl::PART) = make_uint2(lo[t], hi[t]);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        }
      }
    };

    if (BMODE == B_SPLIT) {
      __syncthreads();  // A was written; earlier readers of the staging are done
      for (int c = 0; c + 1 < nst; ++c) copy(c, c);
      copied();
    } else {
      // A B in device memory is loaded before the barrier (its latency under the wait); one in
      // shared memory was written just before it.
      if (BMODE != B_KN_SMEM) load(0);
      __syncthreads();
      if (BMODE == B_KN_SMEM) load(0);
      store(0);
      if (nk > 1) load(1);
      fence_async_smem();
    }
    __syncthreads();
    float sum[NACC], f0[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = f0[i] = 0.0f;
    int cur = 0, nxt = 1, prv = nst - 1;  // ring buffers of chunks c, c + 1 and c - 1 (c + nst - 1)
    for (int c = 0; c < nk; ++c) {
      if (BMODE == B_SPLIT) copy(c + nst - 1, prv);  // into the buffer chunk c - 1 used: under this chunk's products
      // A's fragment values: rows m0, m1; k = 16 c + 2 tq (+ 1) and + 8 (+ 9).
      float v[8];
      const int k = c * KC + 2 * tq;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = k + 8 * q + e;
          if (A_T) {
            v[4 * q + e] = m0 < M ? A[kk * lda + m0] : 0.0f;
            v[4 * q + 2 + e] = m1 < M ? A[kk * lda + m1] : 0.0f;
          } else {
            v[4 * q + e] = A[m0 * lda + kk];
            v[4 * q + 2 + e] = A[m1 * lda + kk];
          }
        }
      uint32_t a[AP][4];  // A's terms: a[t][r] the fragment register r of term t
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (AP == 3) {
          uint32_t t3[3];
          split3_bf16(v[2 * r], v[2 * r + 1], t3);
#pragma unroll
          for (int t = 0; t < 3; ++t) a[t][r] = t3[t];
        } else {
          a[0][r] = pack_bf16(v[2 * r], v[2 * r + 1]);
        }
      }
      const float* st = st0 + cur * Cl::BUF;
      wg_fence_operands<NACC>(f0);
      wg_fence();
      // The products of terms i + j <= 2 into a fresh accumulator, the smallest first (the first
      // does not accumulate). B's term j sits at st + PART j.
      if constexpr (AP == 3 && BP == 3) {
        wgmma_bf16<WN>(f0, a[2], wg_desc(st), 0);
        wgmma_bf16<WN>(f0, a[1], wg_desc(st + Cl::PART), 1);
        wgmma_bf16<WN>(f0, a[0], wg_desc(st + 2 * Cl::PART), 1);
        wgmma_bf16<WN>(f0, a[1], wg_desc(st), 1);
        wgmma_bf16<WN>(f0, a[0], wg_desc(st + Cl::PART), 1);
      } else if constexpr (AP == 3) {
        wgmma_bf16<WN>(f0, a[2], wg_desc(st), 0);
        wgmma_bf16<WN>(f0, a[1], wg_desc(st), 1);
      } else if constexpr (BP == 3) {
        wgmma_bf16<WN>(f0, a[0], wg_desc(st + 2 * Cl::PART), 0);
        wgmma_bf16<WN>(f0, a[0], wg_desc(st + Cl::PART), 1);
      }
      wgmma_bf16<WN>(f0, a[0], wg_desc(st), AP == 3 || BP == 3);
      wg_commit();
      if (BMODE != B_SPLIT && c + 1 < nk) {
        store(nxt);
        if (c + 2 < nk) load(c + 2);
        fence_async_smem();
      }
      wg_wait0();
      wg_fence_operands<NACC>(f0);
#pragma unroll
      for (int i = 0; i < NACC; ++i) sum[i] += f0[i];
      if (BMODE == B_SPLIT) copied();  // chunk c + 1
      __syncthreads();  // the next chunk is staged; everyone is done with this one
      prv = cur;
      cur = nxt;
      nxt = nxt + 1 == nst ? 0 : nxt + 1;
    }
    if (valid) finish<WN>(epi, sum, ns, tq, m0, m1, !A_T || m0 < M, !A_T || m1 < M);
  }
}

// ---- Row passes on the CUDA cores whose math is the program's --------------------------------

// dinv[t, i] (+)= sum_j (sin'_j dF[t, j] + cos'_j dF[t, half + j]) coeff[i, j] for t < rows, the
// derivatives of fast_sincos's polynomials in the projection, recomputed from the invariants. A
// warp per row, lanes along j.
__device__ __noinline__ void rff_vjp(const float* s_inv, int I, const float* __restrict__ coeff, int half,
                                     const float* dF, int ldd, float* dinv, int rows, bool add) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TILE; t += WARPS) {
    float acc[MAX_I];
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) acc[i] = 0.0f;
    for (int j = lane; j < half; j += 32) {
      float proj = 0.0f;
      for (int i = 0; i < I; ++i) proj = fmaf(s_inv[t * I + i], __ldg(coeff + i * half + j), proj);
      float s, co, ds, dc;
      fast_sincos(proj, &s, &co, &ds, &dc);
      const float dproj = ds * dF[t * ldd + j] + dc * dF[t * ldd + half + j];
#pragma unroll
      for (int i = 0; i < MAX_I; ++i)
        if (i < I) acc[i] = fmaf(dproj, __ldg(coeff + i * half + j), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < MAX_I; ++i) {
      if (i >= I) break;
      const float s = warp_sum(acc[i]);
      if (lane == 0 && t < rows) dinv[t * I + i] = add ? dinv[t * I + i] + s : s;
    }
  }
}

// In place, per segment: dX = gelu'(P) r (dn - mean(dn) - n mean(dn n)), the VJP of
// n = normalize(gelu(P)), with gelu(P), gelu'(P) (one tanh), its mean and r recomputed from the
// pre-activation P (shared or device memory). With E (device memory, row stride lde): dn =
// bf16(bf16(prob[t, seg]) E) (the mixer's input gradient of one latent, the cotangent of the
// rounded n; dX's old value unread), and dp[t, seg] = bf16(<E, bf16(n)> + dyb[t, seg]) (the
// cotangent of the rounded softmax weight: <dy, v_mix> with its bias term).
template <int NV>
__device__ __noinline__ void ln_gelu_vjp_nv(float* dX, int ldd, const float* P, int ldp, int segs, int width, int L,
                                            const float* E, int lde, const float* prob, float* dp, const float* dyb) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane % L, spw = 32 / L;
  for (int base = warp * spw; base < TILE * segs; base += WARPS * spw) {
    const int r = base + lane / L;
    const bool ok = r < TILE * segs;
    const int t = ok ? r / segs : 0, o = ok ? (r % segs) * width : 0;
    float gv[NV], gd[NV], dn[NV];
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      const bool in = ok && n < width;
      const float2 gg = gelu_and_grad(in ? P[t * ldp + o + n] : 0.0f);
      gv[i] = in ? gg.x : 0.0f;
      gd[i] = gg.y;
      dn[i] = in ? (E ? E[t * lde + o + n] : dX[t * ldd + o + n]) : 0.0f;
      s += gv[i];
      ss = fmaf(gv[i], gv[i], ss);
    }
    for (int sh = L / 2; sh > 0; sh >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, sh);
      ss += __shfl_xor_sync(0xffffffffu, ss, sh);
    }
    const float mean = s / width;
    const float rs = 1.0f / sqrtf(ss / width - mean * mean + LN_EPS);
    const float pr = E && ok ? bf16_round(prob[r]) : 0.0f;
    float sd = 0.0f, sdn = 0.0f, se = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      if (ok && n < width) {
        gv[i] = (gv[i] - mean) * rs;  // n
        se = fmaf(dn[i], bf16_round(gv[i]), se);  // <E, bf16(n)> before the scale
        if (E) dn[i] = bf16_round(dn[i] * pr);
        sd += dn[i];
        sdn = fmaf(dn[i], gv[i], sdn);
      }
    }
    for (int sh = L / 2; sh > 0; sh >>= 1) {
      sd += __shfl_xor_sync(0xffffffffu, sd, sh);
      sdn += __shfl_xor_sync(0xffffffffu, sdn, sh);
      if (E) se += __shfl_xor_sync(0xffffffffu, se, sh);
    }
    const float md = sd / width, mdn = sdn / width;
    if (E && ok && sub == 0) dp[r] = bf16_round(se + dyb[r]);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      if (ok && n < width) dX[t * ldd + o + n] = rs * (dn[i] - md - gv[i] * mdn) * gd[i];
    }
  }
}

__device__ void ln_gelu_vjp(float* dX, int ldd, const float* P, int ldp, int segs, int width,
                            const float* E = nullptr, int lde = 0, const float* prob = nullptr, float* dp = nullptr,
                            const float* dyb = nullptr) {
  const int L = seg_lanes(width);
  if (width <= 8 * L)
    ln_gelu_vjp_nv<8>(dX, ldd, P, ldp, segs, width, L, E, lde, prob, dp, dyb);
  else
    ln_gelu_vjp_nv<16>(dX, ldd, P, ldp, segs, width, L, E, lde, prob, dp, dyb);
}

// dst[n] (+)= sum_t sum_h psum[t, h] dY[t, h * D + n] for n < D: dm_b2, the bias taking each
// latent's rounded softmax weight (their sum psum is not 1).
__device__ __noinline__ void col_sums_psum(const float* dY, int ld, int H, int D, const float* psum, float* dst,
                                           bool first) {
  __syncthreads();
  for (int n = threadIdx.x; n < D; n += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < TILE; ++t)
      for (int h = 0; h < H; ++h) s = fmaf(psum[t * H + h], dY[t * ld + h * D + n], s);
    dst[n] = first ? s : dst[n] + s;
  }
}

// dyb[t, h] = <dY[t, h * D ..], m_b2>: the bias term of the softmax weights' cotangent.
__device__ __noinline__ void dy_bias(const float* dY, int ld, int H, int D, const float* __restrict__ m_b2,
                                     float* dyb) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * H; idx += THREADS) {
    const int t = idx / H, h = idx - t * H;
    float s = 0.0f;
    for (int n = 0; n < D; ++n) s = fmaf(dY[t * ld + h * D + n], __ldg(m_b2 + n), s);
    dyb[idx] = s;
  }
}

// The softmax over latents of s_prob [Z][64][H], in place (f32: its VJP takes these), and
// psum[t, h] = sum_z bf16(p_z), the sum of the weights the values take.
__device__ __noinline__ void softmax_z(float* s_prob, int Z, int H, float* psum) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * H; idx += THREADS) {
    float m = -INFINITY;
    for (int z = 0; z < Z; ++z) m = fmaxf(m, s_prob[z * TILE * H + idx]);
    float sum = 0.0f;
    for (int z = 0; z < Z; ++z) {
      const float e = expf(s_prob[z * TILE * H + idx] - m);
      s_prob[z * TILE * H + idx] = e;
      sum += e;
    }
    float ps = 0.0f;
    for (int z = 0; z < Z; ++z) {
      const float p = s_prob[z * TILE * H + idx] / sum;
      s_prob[z * TILE * H + idx] = p;
      ps += bf16_round(p);
    }
    psum[idx] = ps;
  }
}

// ---- The kernels -------------------------------------------------------------------------------
// Pass 0: the shared weights in bf16 into the staged layout `gemm` copies whole (B_SPLIT), once a
// launch: entry j's B (K x N) as blocks of 16 WN bf16, one per 16-deep chunk kc and WN slab s (kc
// major), each holding n group, k group, 8 rows, 8 k, i.e. element (16 kc + 8 kg + i, WN s + 8 ng
// + r) of B, rounded to nearest (ties to even).
template <int WN>
__global__ void weights_kernel(const Params P) {
  const Dims& d = P.d;
  const float* src[9] = {P.q_w1, P.v_w1, P.fw, P.m_w2, P.o_w, P.p_w1, P.p_w2, P.h_w1, P.h_w2};
  const int per = d.split_n / 2;
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(P.work);
  const long long n = d.w128 ? d.g_off : d.split_total;  // the W128 design's G blocks follow (w128_g_kernel)
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < 2 * n;
       idx += (long long)gridDim.x * blockDim.x) {
    int j = 0;  // the laid-out entry holding idx: the last whose offset is at most idx
    for (int jj = 1; jj < 18; ++jj)
      if (jj % 9 < per && 2 * d.split_off[jj] <= idx) j = jj;
    const long long e = idx - 2 * d.split_off[j];
    const int K = d.split_K[j], N = d.split_N[j];
    const long long blk = e / (16 * WN);
    const int w = (int)(e % (16 * WN));
    const int kc = (int)(blk / (N / WN)), sl = (int)(blk % (N / WN));
    const int ng = w / 128, kg = w % 128 / 64, r = w % 64 / 8, i = w % 8;
    const int k = 16 * kc + 8 * kg + i, n = WN * sl + 8 * ng + r;
    const float x = j < 9 ? src[j][(size_t)k * N + n] : src[j - 9][(size_t)n * K + k];  // B of X W, or of dY W^T
    out[idx] = __float2bfloat16_rn(x);
  }
}

// Pass 1. The products name their bf16 terms: <AP, BP> (1: the operand rounded, as JAX rounds
// it; 3: an f32 operand JAX keeps, in three terms). Input gradients (dY W^T) store bf16(result): the
// cotangent of a bf16 operand.
template <int WN>
__global__ void __launch_bounds__(THREADS, minb_of(WN)) fused_decode_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int Z = d.Z, H = d.H, I = d.I, hid = d.hid, D = d.D, hidm = d.hidm, C = d.C;
  const int HD = d.HD, HH = d.HH, ldh = d.ldh, ldw = d.ldw, half = hid / 2;
  float* stage = smem;                           // the B staging
  const int nst = d.stages;
  float* Pb = stage + stage_floats(WN, nst);     // [64][ldw]
  float* X1 = Pb + TILE * ldw;                   // [64][ldh]
  float* W2 = X1 + TILE * ldh;                   // [64][ldw] wide, or X2 and X3 [64][ldh]
  float* X2 = W2;
  float* X3 = W2 + TILE * ldh;
  float* s_prob = W2 + d.n_w2;                   // [Z][64][H] softmax weights (f32)
  float* s_dlog = s_prob + Z * TILE * H;         // [Z][64][H] dp, then dlogit
  float* s_psum = s_dlog + Z * TILE * H;         // [64][H] sum_z bf16(p_z)
  float* s_dyb = s_psum + TILE * H;              // [64][H] <dy_h, m_b2>
  float* s_inv = s_dyb + TILE * H;               // [64][I]

  float* ws = P.work + d.split_total + (size_t)blockIdx.x * d.work;
  auto wsplit = [&](int j) { return P.work + d.split_off[j]; };  // a bf16 shared weight
  float* pb = P.part + (size_t)blockIdx.x * d.part;
  float* pw = pb + (size_t)d.slots * d.l_row;    // the weight gradients, over the whole run
  const bool wgr = d.wgrad, tail = d.tail;
  const long long lo = (long long)blockIdx.x * d.ipb;
  const long long hi = lo + d.ipb < d.items ? lo + d.ipb : d.items;
  const int b_first = (int)(lo / d.nt);

  // Epilogues: a shared-memory store (with a bias and a ReLU), the same rounded to bf16 (an input
  // gradient), an add into a block-private partial (stored by its first contribution), and that
  // add transposed.
  auto to_smem = [](float* Y, int ld, const float* bias, bool relu) {
    return [=](int m, int n, float v0, float v1) {
      if (bias) { v0 += __ldg(bias + n); v1 += __ldg(bias + n + 1); }
      if (relu) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
      Y[m * ld + n] = v0;
      Y[m * ld + n + 1] = v1;
    };
  };
  auto to_smem16 = [](float* Y, int ld) {
    return [=](int m, int n, float v0, float v1) {
      Y[m * ld + n] = bf16_round(v0);
      Y[m * ld + n + 1] = bf16_round(v1);
    };
  };
  auto to_part = [](float* dst, int ld, bool first) { return ToPart{dst, ld, first, false}; };
  auto to_part_t = [](float* dst, int ld, bool first) { return ToPart{dst, ld, first, true}; };  // dst[n][m]

  for (long long item = lo; item < hi; ++item) {
    const int b = (int)(item / d.nt), tile = (int)(item % d.nt);
    const int c0 = tile * TILE, rows = min(TILE, C - c0);
    const bool first_row = item == lo || tile == 0, first_w = item == lo;
    float* pr = pb + (size_t)(b - b_first) * d.l_row;
    float* pA = pr;
    float* pab = pA + d.l_A;
    float* pG = pab + d.l_ab;
    float* pc = pG + d.l_G;

    // 1. Logits of every latent (the query chain), then the softmax over latents.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      load_inv(s_inv, P.inv + (bz * C + c0) * I, rows, I);
      rff(s_inv, I, P.q_coeff, half, X1, ldh);
      gemm<WN, false, B_SPLIT, 1, 1>(X1, ldh, TILE, hid, wsplit(SPLIT_Q), 0, hid, stage, nst, to_smem(X2, ldh, P.q_b1, true));
      logits(X2, ldh, hid, P.A + bz * hid * H, P.ab + bz * H, P.wb + bz * C + c0, rows, H, s_prob + z * TILE * H);
    }
    softmax_z(s_prob, Z, H, s_psum);

    // 2. Value chains, weighted into nbar (W2, row stride ldw) by the rounded softmax weights.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      load_inv(s_inv, P.inv + (bz * C + c0) * I, rows, I);
      rff(s_inv, I, P.v_coeff, half, X1, ldh);
      gemm<WN, false, B_SPLIT, 1, 1>(X1, ldh, TILE, hid, wsplit(SPLIT_V), 0, hid, stage, nst, to_smem(Pb, ldh, P.v_b1, true));  // hv
      gemm<WN, false, B_SPLIT, 1, 1>(Pb, ldh, TILE, hid, wsplit(SPLIT_F), 0, hid, stage, nst, to_smem(X1, ldh, P.fb, false));     // u
      ln_gelu(X1, ldh, X1, ldh, 1, hid);                                                                   // t
      gemm<WN, false, B_KN, 1, 1>(X1, ldh, TILE, hid, P.G + bz * hid * HH, HH, HH, stage, nst,
                                  to_smem(Pb, ldw, P.c + bz * HH, false));                                // pre
      ln_gelu(Pb, ldw, Pb, ldw, H, hidm);                                                                  // nn
      accum_nbar(W2, Pb, ldw, s_prob + z * TILE * H, H, hidm, z == 0);
    }
    if (wgr) copy_out(ws + d.w_n, W2, ldw, HH);

    // 3. The tail forward (its activations into the workspace) and its VJP: dy in W2.
    const float* gsrc = P.g + ((size_t)b * C + c0) * d.out;
    if (tail) {
      for (int h = 0; h < H; ++h) {  // y = nbar m_w2 + psum m_b2, a head at a time (nbar unrounded: three terms)
        float* yh = Pb + h * D;
        const float* ps = s_psum + h;
        const float* mb = P.m_b2;
        gemm<WN, false, B_SPLIT, 3, 1>(W2 + h * hidm, ldw, TILE, hidm, wsplit(SPLIT_M), 0, D, stage, nst,
                                       [=](int m, int n, float v0, float v1) {
                                         const float q = ps[m * H];
                                         yh[m * ldw + n] = fmaf(q, __ldg(mb + n), v0);
                                         yh[m * ldw + n + 1] = fmaf(q, __ldg(mb + n + 1), v1);
                                       });
      }
      if (wgr) copy_out(ws + d.w_y, Pb, ldw, HD);
      gemm<WN, false, B_SPLIT, 1, 1>(Pb, ldw, TILE, HD, wsplit(SPLIT_O), 0, HD, stage, nst, to_smem(W2, ldw, P.o_b, false));  // y1
      if (wgr) copy_out(ws + d.w_y1, W2, ldw, HD);
      gemm<WN, false, B_SPLIT, 1, 1>(W2, ldw, TILE, HD, wsplit(SPLIT_P1), 0, HD, stage, nst, to_smem(Pb, ldw, P.p_b1, false));  // q1
      copy_out(ws + d.w_q1, Pb, ldw, HD);
      ln_gelu(Pb, ldw, Pb, ldw, 1, HD);                                                                    // t1
      gemm<WN, false, B_SPLIT, 1, 1>(Pb, ldw, TILE, HD, wsplit(SPLIT_P2), 0, HD, stage, nst, to_smem(W2, ldw, P.p_b2, false));  // q2
      copy_out(ws + d.w_q2, W2, ldw, HD);
      gelu_rows(W2, ldw, W2, ldw, HD);                                                                     // y2
      gemm<WN, false, B_SPLIT, 1, 1>(W2, ldw, TILE, HD, wsplit(SPLIT_H1), 0, hid, stage, nst, to_smem(X1, ldh, P.h_b1, false));  // q3
      copy_out(ws + d.w_q3, X1, ldh, hid);
      gelu_rows(X1, ldh, X1, ldh, hid);                                                                    // h1
      gemm<WN, false, B_SPLIT, 1, 1>(X1, ldh, TILE, hid, wsplit(SPLIT_H2), 0, hid, stage, nst, to_smem(Pb, ldh, P.h_b2, false));  // q4
      copy_out(ws + d.w_q4, Pb, ldh, hid);
      gelu_rows(Pb, ldh, Pb, ldh, hid);                                                                    // h2
      // Head layer 3 on the CUDA cores: dh2 into X2; then dq4 = dh2 gelu'(q4).
      head_vjp(gsrc, rows, d.out, P.h_w3, hid, X2, ldh, Pb, ldh, wgr ? pw + d.w_off[18] : nullptr,
               pw + d.w_off[19], first_w);
      mul_gelu_grad(X2, ldh, ws + d.w_q4, hid);
      if (wgr) {  // dh_w2 = h1^T dq4 (h1 in X1)
        gemm<WN, true, B_KN_SMEM, 1, 3>(X1, ldh, hid, TILE, X2, ldh, hid, stage, nst, to_part(pw + d.w_off[16], hid, first_w));
        col_sums(X2, ldh, hid, hid, pw + d.w_off[17], first_w);
      }
      gemm<WN, false, B_SPLIT, 3, 1>(X2, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_H2), 0, hid, stage, nst, to_smem16(X3, ldh));  // dh1
      mul_gelu_grad(X3, ldh, ws + d.w_q3, hid);                                                              // dq3
      if (wgr) {  // dh_w1 = y2^T dq3: dq3^T y2 transposed, y2 = gelu(q2) recomputed into P
        gelu_rows(ws + d.w_q2, HD, Pb, ldw, HD);
        gemm<WN, true, B_KN_SMEM, 3, 1>(X3, ldh, hid, TILE, Pb, ldw, HD, stage, nst, to_part_t(pw + d.w_off[14], hid, first_w));
        col_sums(X3, ldh, hid, hid, pw + d.w_off[15], first_w);
      }
      gemm<WN, false, B_SPLIT, 3, 1>(X3, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_H1), 0, HD, stage, nst, to_smem16(Pb, ldw));  // dy2
      mul_gelu_grad(Pb, ldw, ws + d.w_q2, HD);                                                               // dq2
      if (wgr) {  // dp_w2 = t1^T dq2, t1 recomputed from q1 into W2
        ln_gelu(ws + d.w_q1, HD, W2, ldw, 1, HD);
        gemm<WN, true, B_KN_SMEM, 3, 1>(Pb, ldw, HD, TILE, W2, ldw, HD, stage, nst, to_part_t(pw + d.w_off[12], HD, first_w));
        col_sums(Pb, ldw, HD, HD, pw + d.w_off[13], first_w);
      }
      gemm<WN, false, B_SPLIT, 3, 1>(Pb, ldw, TILE, HD, wsplit(SPLIT_T + SPLIT_P2), 0, HD, stage, nst, to_smem16(W2, ldw));  // dt1
      ln_gelu_vjp(W2, ldw, ws + d.w_q1, HD, 1, HD);                                                        // dq1
      if (wgr) {  // dp_w1 = y1^T dq1
        gemm<WN, true, B_KN, 3, 1>(W2, ldw, HD, TILE, ws + d.w_y1, HD, HD, stage, nst, to_part_t(pw + d.w_off[10], HD, first_w));
        col_sums(W2, ldw, HD, HD, pw + d.w_off[11], first_w);
      }
      gemm<WN, false, B_SPLIT, 3, 1>(W2, ldw, TILE, HD, wsplit(SPLIT_T + SPLIT_P1), 0, HD, stage, nst, to_smem16(Pb, ldw));  // dy1
      if (wgr) {  // do_w = y^T dy1 (dy1 is bf16: one term)
        gemm<WN, true, B_KN, 1, 1>(Pb, ldw, HD, TILE, ws + d.w_y, HD, HD, stage, nst, to_part_t(pw + d.w_off[8], HD, first_w));
        col_sums(Pb, ldw, HD, HD, pw + d.w_off[9], first_w);
      }
      gemm<WN, false, B_SPLIT, 1, 1>(Pb, ldw, TILE, HD, wsplit(SPLIT_T + SPLIT_O), 0, HD, stage, nst, to_smem16(W2, ldw));  // dy
    } else {
      load_g(W2, ldw, gsrc, rows, HD);
    }

    // The mixer's VJP: dm_w2 = nbar_h^T dy_h a head (dy_h^T nbar_h transposed, both f32: three
    // terms each; each head's own partial), dm_b2 = sum psum dy, <dy_h, m_b2>, and e_h = dy_h m_w2^T
    // into the workspace (not rounded: the cotangent of the rounded n is bf16(p16 e)).
    if (wgr) {
      for (int h = 0; h < H; ++h)
        gemm<WN, true, B_KN, 3, 3>(W2 + h * D, ldw, D, TILE, ws + d.w_n + h * hidm, HH, hidm, stage, nst,
                                   to_part_t(pw + d.w_off[6] + (size_t)h * hidm * D, D, first_w));
      col_sums_psum(W2, ldw, H, D, s_psum, pw + d.w_off[7], first_w);
    }
    dy_bias(W2, ldw, H, D, P.m_b2, s_dyb);
    for (int h = 0; h < H; ++h) {
      float* e = ws + d.w_e + h * hidm;
      gemm<WN, false, B_SPLIT, 3, 1>(W2 + h * D, ldw, TILE, D, wsplit(SPLIT_T + SPLIT_M), 0, hidm, stage, nst,
                                     [=](int m, int n, float v0, float v1) {
                                       e[m * HH + n] = v0;
                                       e[m * HH + n + 1] = v1;
                                     });
    }

    // 4. Per latent: the value chain again, then its VJP.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      const float* Gz = P.G + bz * hid * HH;
      load_inv(s_inv, P.inv + (bz * C + c0) * I, rows, I);
      rff(s_inv, I, P.v_coeff, half, X1, ldh);
      gemm<WN, false, B_SPLIT, 1, 1>(X1, ldh, TILE, hid, wsplit(SPLIT_V), 0, hid, stage, nst, to_smem(X2, ldh, P.v_b1, true));  // hv
      gemm<WN, false, B_SPLIT, 1, 1>(X2, ldh, TILE, hid, wsplit(SPLIT_F), 0, hid, stage, nst, to_smem(X1, ldh, P.fb, false));     // u
      ln_gelu(X1, ldh, X3, ldh, 1, hid);                                                                   // t
      gemm<WN, false, B_KN, 1, 1>(X3, ldh, TILE, hid, Gz, HH, HH, stage, nst, to_smem(Pb, ldw, P.c + bz * HH, false));  // pre
      // dpre from dn = bf16(p16 e), and dp = bf16(<e, n16> + <dy, m_b2>), per head.
      ln_gelu_vjp(Pb, ldw, Pb, ldw, H, hidm, ws + d.w_e, HH, s_prob + z * TILE * H, s_dlog + z * TILE * H, s_dyb);
      gemm<WN, true, B_KN_SMEM, 1, 3>(X3, ldh, hid, TILE, Pb, ldw, HH, stage, nst, to_part(pG + (size_t)z * hid * HH, HH, first_row));
      col_sums(Pb, ldw, HH, HH, pc + (size_t)z * HH, first_row);
      gemm<WN, false, B_NK, 3, 1>(Pb, ldw, TILE, HH, Gz, HH, hid, stage, nst, to_smem16(X3, ldh));  // dt
      ln_gelu_vjp(X3, ldh, X1, ldh, 1, hid);                                                            // du
      if (wgr) {  // dfw = hv^T du
        gemm<WN, true, B_KN_SMEM, 1, 3>(X2, ldh, hid, TILE, X3, ldh, hid, stage, nst, to_part(pw + d.w_off[4], hid, first_w && z == 0));
        col_sums(X3, ldh, hid, hid, pw + d.w_off[5], first_w && z == 0);
      }
      gemm<WN, false, B_SPLIT, 3, 1>(X3, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_F), 0, hid, stage, nst, to_smem16(X1, ldh));  // dhv
      relu_mask(X1, ldh, X2, ldh, hid);
      if (wgr) {  // dv_w1 = F^T dhv, the features recomputed into X2 (dhv is bf16: one term)
        rff(s_inv, I, P.v_coeff, half, X2, ldh);
        gemm<WN, true, B_KN_SMEM, 1, 1>(X2, ldh, hid, TILE, X1, ldh, hid, stage, nst, to_part(pw + d.w_off[2], hid, first_w && z == 0));
        col_sums(X1, ldh, hid, hid, pw + d.w_off[3], first_w && z == 0);
      }
      gemm<WN, false, B_SPLIT, 1, 1>(X1, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_V), 0, hid, stage, nst, to_smem16(X3, ldh));  // dF
      rff_vjp(s_inv, I, P.v_coeff, half, X3, ldh, P.dinv + (bz * C + c0) * I, rows, false);
    }
    softmax_vjp(s_prob, s_dlog, Z, H);

    // 5. Per latent: the query chain again, then its VJP.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      load_inv(s_inv, P.inv + (bz * C + c0) * I, rows, I);
      rff(s_inv, I, P.q_coeff, half, X1, ldh);
      gemm<WN, false, B_SPLIT, 1, 1>(X1, ldh, TILE, hid, wsplit(SPLIT_Q), 0, hid, stage, nst, to_smem(X2, ldh, P.q_b1, true));  // hq
      logit_vjp(X2, ldh, hid, s_dlog + z * TILE * H, H, P.A + bz * hid * H, pA + (size_t)z * hid * H,
                pab + (size_t)z * H, P.dwb + bz * C + c0, rows, first_row, X3, ldh);                       // dhq (bf16)
      if (wgr) {  // dq_w1 = F^T dhq
        gemm<WN, true, B_KN_SMEM, 1, 1>(X1, ldh, hid, TILE, X3, ldh, hid, stage, nst, to_part(pw + d.w_off[0], hid, first_w && z == 0));
        col_sums(X3, ldh, hid, hid, pw + d.w_off[1], first_w && z == 0);
      }
      gemm<WN, false, B_SPLIT, 1, 1>(X3, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_Q), 0, hid, stage, nst, to_smem16(X2, ldh));  // dF
      rff_vjp(s_inv, I, P.q_coeff, half, X2, ldh, P.dinv + (bz * C + c0) * I, rows, true);
    }
  }
}

// ---- The W128 design: the width class 64 at hid = hidm = D = 128, two heads --------------------------
// Every K2 launch of the YAMLs' Navier-Stokes-width decoders (NS, SW, abs_pos, the rollout, a rank's and the
// nef step's: hid = hidm = D = 128, two heads, so H hidm = H D = 256) takes it (`Dims::w128`); other shapes
// of the class 64 take the design above. What it changes, by the class design's split (PERF.md §6):
//   - operands in bf16, written once in the layouts wgmma reads: the epilogue that makes an activation
//     stores it rounded to bf16 in shared memory as a 64-row A operand (`a16_index`); an f32 operand JAX
//     does not round (the cotangents of every input gradient, nbar, dy without the tail) goes in as
//     three bf16 planes (hi, mid, lo: their sum is the value to f32 rounding), split once in the
//     epilogue that makes it; the products of terms i + j <= 2, the smallest first. Every product reads
//     A and B from shared memory by descriptor: a row contraction (the weight gradients, dG) reads both
//     of its operands, stored as 64-row A operands, transposed (MN-major);
//   - each product's columns split between the two warpgroups (64 or 128 a warpgroup, one or two n64
//     parts), its whole K summed in the wgmma accumulator, the B operand (the shared weights, and G laid
//     out in bf16 blocks once a launch, both ways) streamed by each warpgroup through its own ring of
//     W128_STAGES 4 KB chunks with its own barrier; a block barrier a product;
//   - the LayerNorm-gelu passes and their VJPs in the epilogues (the row statistics exchanged between the
//     warpgroups through shared memory; a head's columns are one warpgroup's), the softmax-weighted dn and
//     dp of each head in G's epilogue, the logits and their VJP (dhq, dA) in q_w1's, the column sums (dc
//     and the bias gradients) in the epilogue of the cotangent they sum (shuffles, then the warps in a
//     fixed order); the RFF VJP stays a row pass (in dF's epilogue it cost 1.58 ms at NS, PERF.md §6);
//   - f32 values the VJP needs (u, the tail's q1, gelu' of q2 and q3, e) in the block's workspace,
//     each read back by the thread that wrote it (e by any, after a barrier); with weight gradients the
//     tail's bf16 activations too, copied back before their row contraction; a row contraction loads the
//     partial's old values before it issues its products.
// The partials and pass 2 are the design's above, every sum in a fixed order: two launches give the same
// bits, and dinv ... dc are the same with and without weight gradients.
// The planes (bytes into U). Steps 1, 2, 4, 5, a latent at a time: the features F, hv, t, then (step 2)
// nbar in f32 [64][256], (step 4) dpre's three planes of 64 x 256, after it du's three of 64 x 128, dhv
// and dF in f32 [64][128]. The tail and the mixer: C (three planes of 64 x 256: nbar's, then the
// cotangents), S (an activation, or one copied back from the workspace), E (h2, dy1), and each head's
// nbar planes in S and E for dm_w2.
constexpr int U_F = 0, U_HV = 16384, U_T = 32768, U_D = 49152, U_NBAR = 98304;
constexpr int U_C = 0, U_S = 98304, U_E = 131072;
constexpr int PL128 = TILE * 128, PL256 = TILE * 256;  // bf16 elements of a 64 x 128 and a 64 x 256 plane

typedef __nv_bfloat16 bf16;

// Element (r, k) of a 64-row bf16 operand in shared memory, as wgmma reads A without swizzle (K1's
// layout): core matrices of 8 rows x 8 k (128 bytes), the row groups of a k group 128 bytes apart, the k
// groups 1,024 bytes apart. A view from column c0 (a multiple of 8) starts 64 c0 elements further.
__device__ __forceinline__ int a16_index(int r, int k) { return ((((k >> 3) << 3) + (r >> 3)) << 6) + ((r & 7) << 3) + (k & 7); }
constexpr int A16_KSTEP = 1024;  // elements from one 16-deep k step to the next
// K-major (a product's A): LBO the k groups' step, SBO the row groups'. Read transposed (MN-major, a
// row contraction's operands, the 64 rows its K): core matrices of 8 columns (16 bytes) x 8 rows, the
// column groups SBO apart, the row groups LBO apart.
constexpr int A16_LBO = 1024, A16_SBO = 128, MN_LBO = 128, MN_SBO = 1024;
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_bar(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(bf16* buf, int r, int n, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(buf + a16_index(r, n)) = __floats2bfloat162_rn(v0, v1);
}
// A pair of f32 values as three bf16 planes `pstride` elements apart (split3_bf16).
__device__ __forceinline__ void store3(bf16* buf, int pstride, int r, int n, float v0, float v1) {
  uint32_t t[3];
  split3_bf16(v0, v1, t);
  const int i = a16_index(r, n);
#pragma unroll
  for (int p = 0; p < 3; ++p) *reinterpret_cast<uint32_t*>(buf + i + p * pstride) = t[p];
}
__device__ __forceinline__ float2 ldg2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 ldcg2(const float* p) { return __ldcg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ void stcg2(float* p, float a, float b) { __stcg(reinterpret_cast<float2*>(p), make_float2(a, b)); }

// D (64 x 64 f32, in the fragment of the register-A product) = A (64 x 16) x B (16 x 64) + (accumulate ? D : 0), both
// operands bf16 in shared memory; TA / TB: read MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TA), "n"(TB));
}

// A warpgroup's stream of B chunks into its ring: B's bf16 blocks (16 k x 64 n, 2 KB; block (ks, s) at
// src + (ks nsl + s) 512 floats: `weights_kernel`'s layout), this warpgroup's slabs s0 .. s0 + NP - 1. A
// chunk is two blocks: two k steps of the one slab (NP 1), or one k step of both (NP 2).
struct Ring {
  float* buf;
  const float* src;
  int nsl, nks, np, s0, nc, issued, bar, lt;
};
__device__ __forceinline__ void ring_issue(Ring& g) {
  if (g.issued < g.nc) {
    float* st = g.buf + (g.issued % W128_STAGES) * 1024;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ks = g.np == 1 ? 2 * g.issued + q : g.issued, s = g.np == 1 ? g.s0 : g.s0 + q;
      cp_async16(st + q * 512 + 4 * g.lt, g.src + ((size_t)ks * g.nsl + s) * 512 + 4 * g.lt);
    }
  }
  ++g.issued;
  cp_async_commit();  // an empty group past the end keeps the wait count uniform
}
// The first W128_STAGES - 2 chunks of a product's B (K = 16 nks, N = 64 nsl; this warpgroup's NP slabs) in
// flight, before the work that precedes the product. The ring is free (`w128_run` ends so).
__device__ __forceinline__ void w128_prime(Ring& g, const float* src, int nsl, int nks, int np) {
  g.src = src;
  g.nsl = nsl;
  g.nks = nks;
  g.np = np;
  g.s0 = (threadIdx.x >> 7) * np;
  g.nc = np == 1 ? nks / 2 : nks;
  g.issued = 0;
  for (int c = 0; c < W128_STAGES - 2; ++c) ring_issue(g);
}
// acc[p] (n64 part p of this warpgroup's columns) = A x B: A 64 x 16 nks in AP bf16 planes (`pstride`
// elements apart; K-major at `a`), B the primed stream; per k step the products of A's terms, the
// smallest first, into the accumulator (the first product of the whole K does not accumulate). Starts
// with a block barrier (A is written), ends with every product complete and the ring free.
template <int NP, int AP>
__device__ __forceinline__ void w128_run(Ring& g, const bf16* a, int pstride, float (&acc)[NP][32]) {
  // The accumulator's old values are dead (the first product does not accumulate): cleared, so that no
  // value of an earlier product is live across the calls between two products (ptxas would serialize
  // the wgmma of a pipeline that crosses a call, C7510).
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  __syncthreads();
  for (int c = 0; c < g.nc; ++c) {
    cp_async_wait<W128_STAGES - 3>();  // this thread's copies of chunk c have landed
    fence_async_smem();              // they are visible to wgmma
    wg_bar(g.bar);                   // everyone's; chunk c - 2's products are complete
    ring_issue(g);                   // chunk c + W128_STAGES - 2, into chunk c - 2's stage
    const float* st = g.buf + (c % W128_STAGES) * 1024;
#pragma unroll
    for (int p = 0; p < NP; ++p) wg_fence_operands<32>(acc[p]);
    wg_fence();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ks = NP == 1 ? 2 * c + q : c, p = NP == 1 ? 0 : q;
#pragma unroll
      for (int t = AP - 1; t >= 0; --t)
        wgmma_ss<0, 0>(acc[p], smem_desc(a + t * pstride + ks * A16_KSTEP, A16_LBO, A16_SBO), wg_desc(st + q * 512),
                       ks > 0 || t < AP - 1 || (NP == 2 && c > 0));
    }
    wg_commit();
    wg_wait1();
#pragma unroll
    for (int p = 0; p < NP; ++p) wg_fence_operands<32>(acc[p]);
  }
  wg_wait0();
#pragma unroll
  for (int p = 0; p < NP; ++p) wg_fence_operands<32>(acc[p]);
  cp_async_wait<0>();
  wg_bar(g.bar);
}

// This thread's part of a warpgroup's 64 x 64 accumulator: element i, its row r = r0 + 8 hr (r0 = 16 warp
// + g) and its column col = 8 j + 2 tq + e. Loops unrolled into constant register indices.
#define W128_LOOP(...)                                                                        \
  _Pragma("unroll") for (int j_ = 0; j_ < 8; ++j_)                                           \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr)                                         \
      _Pragma("unroll") for (int e_ = 0; e_ < 2; ++e_) {                                     \
        const int i = 4 * j_ + 2 * hr + e_, col = 8 * j_ + 2 * tq + e_, r = r0 + 8 * hr;       \
        __VA_ARGS__                                                                          \
      }
#define W128_PAIRS(...)                                                                       \
  _Pragma("unroll") for (int j_ = 0; j_ < 8; ++j_)                                           \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr) {                                       \
      const int i = 4 * j_ + 2 * hr, col = 8 * j_ + 2 * tq, r = r0 + 8 * hr;                  \
      __VA_ARGS__                                                                            \
    }
#define W128_FRAG \
  const int tq = threadIdx.x & 3, r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2), wg = threadIdx.x >> 7

// out(m, n) = sum over the 64 rows of X[r][m] Y[r][n] for X's columns m < M and Y's n < N, X in XP and Y
// in YP bf16 planes (64-row operands, `xs` / `ys` elements apart), both read transposed: units of 64 x 64
// over the warpgroups in turn, the products of terms i + j <= 2 a k step, the smallest first, summed in
// the accumulator, into a block-private partial dst[m ld + n] (stored by its first contribution). The
// partial's old values of a unit are loaded before its products are issued (their latency under the
// products), two columns a load. Starts with a block barrier.
template <int XP, int YP>
__device__ __forceinline__ void w128_rows_part(const bf16* X, int xs, int M, const bf16* Y, int ys, int N, float* dst,
                                             int ld, bool first) {
  W128_FRAG;
  __syncthreads();
  const int mts = M / 64, units = mts * (N / 64);
  for (int u = wg; u < units; u += 2) {
    const int mt = u % mts, nt = u / mts;
    float2* row[2] = {reinterpret_cast<float2*>(dst + (size_t)(64 * mt + r0) * ld + 64 * nt + 2 * tq),
                      reinterpret_cast<float2*>(dst + (size_t)(64 * mt + r0 + 8) * ld + 64 * nt + 2 * tq)};
    float2 old[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) old[h][j] = first ? make_float2(0.0f, 0.0f) : row[h][4 * j];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    wg_fence_operands<32>(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int s = 2; s >= 0; --s)
#pragma unroll
        for (int i = 0; i < XP; ++i) {
          const int j = s - i;
          if (j < 0 || j >= YP) continue;
          const bool first_p = ks == 0 && s == (XP - 1 + YP - 1 < 2 ? XP - 1 + YP - 1 : 2) && i == (s - YP + 1 > 0 ? s - YP + 1 : 0);
          wgmma_ss<1, 1>(acc, smem_desc(X + i * xs + a16_index(16 * ks, 64 * mt), MN_LBO, MN_SBO),
                         smem_desc(Y + j * ys + a16_index(16 * ks, 64 * nt), MN_LBO, MN_SBO), !first_p);
        }
    wg_commit();
    wg_wait0();
    wg_fence_operands<32>(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        row[h][4 * j] = first ? make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1])
                              : make_float2(old[h][j].x + acc[4 * j + 2 * h], old[h][j].y + acc[4 * j + 2 * h + 1]);
  }
}

// Sums over a row of NV values of this thread's two rows: over its quad (two shuffles) and, with
// `cross` (the row's columns split between the warpgroups), with the other warpgroup's through `xs` (a
// block barrier; its two halves alternate, `par`, so that a warpgroup ahead writes the next sums into
// the half nobody still reads).
template <int NV>
__device__ __forceinline__ void w128_row_sums(float (&v)[2][NV], float* xs, int& par, bool cross) {
  W128_FRAG;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 1);
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 2);
    }
  if (!cross) return;
  float* buf = xs + par * 2 * TILE * 4;  // a half: [2 warpgroups][64 rows][4]
  par ^= 1;
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < NV; ++k) buf[(wg * TILE + r0 + 8 * h) * 4 + k] = v[h][k];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < NV; ++k) v[h][k] += buf[((1 - wg) * TILE + r0 + 8 * h) * 4 + k];
}

// The RFF features of the tile's 64 coordinates (s_inv [64][I], zero past the last) into the plane F:
// sin and cos of the f32 projection by the bf16 mode's polynomial, rounded to bf16. Not inlined: one
// copy serves every chain. Starts with a barrier (s_inv written, F's last readers done).
__device__ __noinline__ void w128_features(const float* s_inv, int I, const float* __restrict__ coeff, bf16* F) {
  __syncthreads();
  constexpr int half = W128_HID / 2, units = TILE * (half / 2);
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int q = u & 3, rr = (u >> 2) & 7, rest = u >> 5, rg = rest & 7, jg = rest >> 3;
    const int t = 8 * rg + rr, j = 8 * jg + 2 * q;
    float p0 = 0.0f, p1 = 0.0f;
    for (int k = 0; k < I; ++k) {
      const float xi = s_inv[t * I + k];
      const float2 cf = ldg2(coeff + k * half + j);
      p0 = fmaf(xi, cf.x, p0);
      p1 = fmaf(xi, cf.y, p1);
    }
    float s0, k0, s1, k1;
    fast_sincos(p0, &s0, &k0);
    fast_sincos(p1, &s1, &k1);
    store2(F, t, j, s0, s1);
    store2(F, t, half + j, k0, k1);
  }
  fence_async_smem();
}

// dm_b2[n] (+)= sum_t sum_h psum[t, h] dy[t, h 128 + n] (the bias taking each latent's rounded softmax
// weight; psum [64][2]), dy in npl bf16 planes (`ps` elements apart; their sum is the value), in the order of
// col_sums_psum. Starts with a barrier.
__device__ __noinline__ void w128_dm_b2(const bf16* Y, int ps, int npl, float* dst, bool first, const float* psum) {
  __syncthreads();
  for (int n = threadIdx.x; n < W128_HID; n += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < TILE; ++t)
      for (int h = 0; h < 2; ++h) {
        const int i = a16_index(t, h * W128_HID + n);
        float v = b2f(Y[i]);
        for (int p = 1; p < npl; ++p) v += b2f(Y[i + p * ps]);
        s = fmaf(psum[t * 2 + h], v, s);
      }
    dst[n] = first ? s : dst[n] + s;
  }
}

// The head's last layer's weight gradients (on the CUDA cores): dh_w3[k, o] (+)= sum_t bf16(h2[t, k])
// g[t, o] and dh_b3[o] (+)= sum_t g[t, o] over the rows t < rows; h2 in the plane H2.
__device__ __noinline__ void w128_head_wgrad(const bf16* H2, const float* __restrict__ gsrc, int rows, int out, float* dw,
                                           float* db, bool first) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < W128_HID * out; idx += THREADS) {
    const int k = idx / out, o = idx - k * out;
    float s = 0.0f;
    for (int t = 0; t < rows; ++t) s = fmaf(b2f(H2[a16_index(t, k)]), __ldg(gsrc + t * out + o), s);
    dw[idx] = first ? s : dw[idx] + s;
  }
  for (int o = threadIdx.x; o < out; o += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < rows; ++t) s += __ldg(gsrc + t * out + o);
    db[o] = first ? s : db[o] + s;
  }
}

// The column sums over the tile's 64 rows of the values an epilogue makes: cv[p][2 j + e] holds this thread's
// two rows' sum in column 8 j + 2 tq + e of its part p (columns 128 wg + 64 p of two parts, or 64 wg of one);
// summed over the warp's rows by shuffles, then over the warpgroup's four warps in order through cs
// ([4][256]); dst[n] (+)= the sum, n < 128 NP (first: store). Every thread calls it (two block barriers).
template <int NP>
__device__ __forceinline__ void w128_col_out(float (&cv)[NP][16], float* cs, float* dst, bool first) {
  W128_FRAG;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float v = cv[p][k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cv[p][k] = v;
    }
  __syncthreads();  // the last readers of cs are done
  if (lane < 4)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < 16; ++k)
        cs[warp * W128_W + (NP == 2 ? 128 * wg + 64 * p : 64 * wg) + 8 * (k >> 1) + 2 * lane + (k & 1)] = cv[p][k];
  __syncthreads();
  for (int n = threadIdx.x; n < 128 * NP; n += THREADS) {
    const float v = ((cs[n] + cs[W128_W + n]) + cs[2 * W128_W + n]) + cs[3 * W128_W + n];
    dst[n] = first ? v : dst[n] + v;
  }
  (void)r0;
}
// Adds an epilogue's pair of values (columns col, col + 1 of part p, one of this thread's rows) to cv.
#define W128_COL_ADD(cv, p, v0, v1)       \
  {                                     \
    (cv)[p][2 * j_] += (v0);            \
    (cv)[p][2 * j_ + 1] += (v1);        \
  }

// A plane's image in the workspace back into shared memory (16 bytes a copy), visible to wgmma after the
// next block barrier.
__device__ __forceinline__ void w128_reload(bf16* dst, const float* img, int elems) {
  float* d = reinterpret_cast<float*>(dst);
  for (int i = 4 * threadIdx.x; i < elems / 2; i += 4 * THREADS) cp_async16(d + i, img + i);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
}

// Pass 0 of the W128 design, beside `weights_kernel`: G [b, z] in bf16 blocks (`weights_kernel`'s layout, 16
// k x 64 n a block) both ways, at g_off of the workspace, W128_GBLK floats a (b, z): as the B of t G (K =
// hid, N = H hidm), then as the B of dpre G^T (K = H hidm, N = hid).
__global__ void w128_g_kernel(const Params P) {
  const Dims& d = P.d;
  bf16* out = reinterpret_cast<bf16*>(P.work + d.g_off);
  const long long total = 2LL * d.B * d.Z * W128_GBLK;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long bz = idx / (2 * W128_GBLK);
    const int e = (int)(idx % (2 * W128_GBLK)), tr = e >= W128_GBLK, w = e % W128_GBLK;
    const int K = tr ? W128_W : W128_HID, N = tr ? W128_HID : W128_W;
    const int blk = w / 1024, within = w % 1024, kc = blk / (N / 64), sl = blk % (N / 64);
    const int ng = within / 128, kg = within % 128 / 64, r = within % 64 / 8, i = within % 8;
    const int k = 16 * kc + 8 * kg + i, n = 64 * sl + 8 * ng + r;
    const float* G = P.G + bz * W128_HID * W128_W;
    out[idx] = __float2bfloat16_rn(tr ? G[(size_t)n * W128_W + k] : G[(size_t)k * W128_W + n]);
    (void)K;
  }
}

// What every phase of the W128 design reads: the planes and rows of shared memory, the block's workspace.
struct W128Ctx {
  const Params* P;
  char* U;                                        // the operand planes (bytes, W128_U)
  float *s_psum, *s_dyb, *s_inv, *xs, *cs, *s_prob, *s_dlog;
  float *x_e, *x_u, *x_q1, *x_g2, *x_g3, *x_nb, *x_img;
  const float* Gblk;                              // G's bf16 blocks, W128_GBLK floats a (b, z)
};
template <class T>
__device__ __forceinline__ T* at(const W128Ctx& c, int off) { return reinterpret_cast<T*>(c.U + off); }
__device__ __forceinline__ const float* wsplit(const Params& P, int j) { return P.work + P.d.split_off[j]; }

// The phases below are inlined into the kernel (W128_PHASE): a wgmma in a function the kernel calls is
// serialized by ptxas (C7510), which cost 10 % (tools/k2_compare.py's variant `noinline`). Each primes
// its own first product's stream; a phase starts and ends with the ring free.
#define W128_PHASE __forceinline__

// 1. A latent's logits, hq . A[b, z] + ab + wb, in q_w1's epilogue (each warpgroup's half of the dot,
// summed through xs), into s_prob.
__device__ W128_PHASE void w128_logits(const W128Ctx& c, Ring& rg, int& par, size_t bz, int c0, int rows, int z) {
  const Params& P = *c.P;
  W128_FRAG;
  bf16* F = at<bf16>(c, U_F);
  w128_prime(rg, wsplit(P, SPLIT_Q), 2, 8, 1);
  load_inv(c.s_inv, P.inv + (bz * P.d.C + c0) * P.d.I, rows, P.d.I);
  w128_features(c.s_inv, P.d.I, P.q_coeff, F);
  float acc[1][32];
  w128_run<1, 1>(rg, F, 0, acc);
  const int n0 = 64 * wg;
  float lg[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  W128_LOOP({
    const float hq = bf16_round(fmaxf(acc[0][i] + __ldg(P.q_b1 + n0 + col), 0.0f));
    const float2 a = ldg2(P.A + (bz * W128_HID + n0 + col) * 2);
    lg[hr][0] = fmaf(hq, bf16_round(a.x), lg[hr][0]);
    lg[hr][1] = fmaf(hq, bf16_round(a.y), lg[hr][1]);
  })
  w128_row_sums<2>(lg, c.xs, par, true);
  if (tq == 0 && wg == 0)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = r0 + 8 * k;
      const float w = t < rows ? __ldg(P.wb + bz * P.d.C + c0 + t) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) c.s_prob[(z * TILE + t) * 2 + h] = lg[k][h] + __ldg(P.ab + bz * 2 + h) + w;
    }
}

// hv = relu(F v_w1 + v_b1) into HV, then (u = hv fw + fb) t = normalize(gelu(u)) into T, u into the
// workspace where `keep_u`: the value chain of a latent up to G's product (steps 2 and 4).
__device__ __forceinline__ void w128_value_chain(const W128Ctx& c, Ring& rg, int& par, size_t bz, int c0, int rows, bool keep_u) {
  const Params& P = *c.P;
  W128_FRAG;
  bf16 *F = at<bf16>(c, U_F), *HV = at<bf16>(c, U_HV), *T = at<bf16>(c, U_T);
  w128_prime(rg, wsplit(P, SPLIT_V), 2, 8, 1);
  load_inv(c.s_inv, P.inv + (bz * P.d.C + c0) * P.d.I, rows, P.d.I);
  w128_features(c.s_inv, P.d.I, P.v_coeff, F);
  float acc[1][32];
  w128_run<1, 1>(rg, F, 0, acc);
  w128_prime(rg, wsplit(P, SPLIT_F), 2, 8, 1);
  const int n0 = 64 * wg;
  W128_PAIRS({
    const float2 bv = ldg2(P.v_b1 + n0 + col);
    store2(HV, r, n0 + col, fmaxf(acc[0][i] + bv.x, 0.0f), fmaxf(acc[0][i + 1] + bv.y, 0.0f));
  })
  fence_async_smem();
  w128_run<1, 1>(rg, HV, 0, acc);
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  W128_PAIRS({
    const float2 bf = ldg2(P.fb + n0 + col);
    const float u0 = acc[0][i] + bf.x, u1 = acc[0][i + 1] + bf.y;
    if (keep_u) stcg2(c.x_u + r * W128_HID + n0 + col, u0, u1);
    const float x0 = gelu_tanh(u0), x1 = gelu_tanh(u1);
    acc[0][i] = x0;
    acc[0][i + 1] = x1;
    v[hr][0] += x0 + x1;
    v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
  })
  w128_row_sums<2>(v, c.xs, par, true);
  float mean[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = v[h][0] / W128_HID;
    rs[h] = 1.0f / sqrtf(v[h][1] / W128_HID - mean[h] * mean[h] + LN_EPS);
  }
  W128_PAIRS(store2(T, r, n0 + col, (acc[0][i] - mean[hr]) * rs[hr], (acc[0][i + 1] - mean[hr]) * rs[hr]);)
  fence_async_smem();
}

// 2. A latent's value chain, weighted into nbar (f32, NB) by the rounded softmax weights in G's epilogue:
// nn = normalize(gelu(t G + c)) per head (a warpgroup's columns), nbar (+)= bf16(p) bf16(nn).
__device__ W128_PHASE void w128_value(const W128Ctx& c, Ring& rg, int& par, size_t bz, int c0, int rows, int z) {
  const Params& P = *c.P;
  W128_FRAG;
  float* NB = at<float>(c, U_NBAR);
  w128_value_chain(c, rg, par, bz, c0, rows, false);
  w128_prime(rg, c.Gblk + bz * W128_GBLK, 4, 8, 2);
  float ag[2][32];
  w128_run<2, 1>(rg, at<bf16>(c, U_T), 0, ag);
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n0p = 128 * wg + 64 * p;
    W128_LOOP({
      const float x = gelu_tanh(ag[p][i] + __ldg(P.c + bz * W128_W + n0p + col));
      ag[p][i] = x;
      v[hr][0] += x;
      v[hr][1] = fmaf(x, x, v[hr][1]);
    })
  }
  w128_row_sums<2>(v, c.xs, par, false);
  float mean[2], rs[2], pz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = v[h][0] / W128_HID;
    rs[h] = 1.0f / sqrtf(v[h][1] / W128_HID - mean[h] * mean[h] + LN_EPS);
    pz[h] = bf16_round(c.s_prob[(z * TILE + r0 + 8 * h) * 2 + wg]);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n0p = 128 * wg + 64 * p;
    W128_PAIRS({
      float2* nb = reinterpret_cast<float2*>(NB + r * W128_W + n0p + col);
      const float a0 = pz[hr] * bf16_round((ag[p][i] - mean[hr]) * rs[hr]);
      const float a1 = pz[hr] * bf16_round((ag[p][i + 1] - mean[hr]) * rs[hr]);
      if (z == 0) {
        *nb = make_float2(a0, a1);
      } else {
        const float2 o = *nb;
        *nb = make_float2(o.x + a0, o.y + a1);
      }
    })
  }
}

// 3a. The tail forward: y = nbar m_w2 + psum m_b2 a head (nbar in three planes), y1, t1 = normalize(gelu(q1)),
// y2 = gelu(q2), h1 = gelu(q3), and in q4's epilogue h2 and dq4 = dh2 gelu'(q4) (dh2 = bf16(g h_w3^T) on the
// CUDA cores), dq4's three planes in C. q1, gelu'(q2), gelu'(q3) into the workspace; with weight gradients
// the planes of y, y1, t1, y2 too, and h2 in E.
__device__ W128_PHASE void w128_tail_fwd(const W128Ctx& c, Ring& rg, int& par, const float* gsrc, int rows, bool wgr,
                                     bool first_w, float* pw) {
  const Params& P = *c.P;
  W128_FRAG;
  const float* NB = at<float>(c, U_NBAR);
  bf16 *CC = at<bf16>(c, U_C), *SS = at<bf16>(c, U_S), *EE = at<bf16>(c, U_E);
  auto img = [&](int k) { return reinterpret_cast<bf16*>(c.x_img + (size_t)k * PL256 / 2); };
  w128_prime(rg, wsplit(P, SPLIT_M), 2, 8, 1);
  for (int idx = threadIdx.x; idx < TILE * W128_W / 2; idx += THREADS) {  // nbar's three planes
    const int r = idx / (W128_W / 2), n = 2 * (idx % (W128_W / 2));
    store3(CC, PL256, r, n, NB[r * W128_W + n], NB[r * W128_W + n + 1]);
  }
  fence_async_smem();
  const int n0 = 64 * wg;
  for (int h = 0; h < 2; ++h) {  // y = nbar m_w2 + psum m_b2, a head at a time
    float acc[1][32];
    w128_run<1, 3>(rg, CC + 64 * W128_HID * h, PL256, acc);
    if (h == 0)
      w128_prime(rg, wsplit(P, SPLIT_M), 2, 8, 1);
    else
      w128_prime(rg, wsplit(P, SPLIT_O), 4, 16, 2);
    const float q0 = c.s_psum[r0 * 2 + h], q1 = c.s_psum[(r0 + 8) * 2 + h];
    W128_PAIRS({
      const float2 mb = ldg2(P.m_b2 + n0 + col);
      const float q = hr ? q1 : q0;
      const float y0 = fmaf(q, mb.x, acc[0][i]), y1 = fmaf(q, mb.y, acc[0][i + 1]);
      store2(SS, r, W128_HID * h + n0 + col, y0, y1);
      if (wgr) store2(img(0), r, W128_HID * h + n0 + col, y0, y1);
    })
    fence_async_smem();
  }
  float ag[2][32];
  w128_run<2, 1>(rg, SS, 0, ag);  // y1 = y o_w + o_b
  w128_prime(rg, wsplit(P, SPLIT_P1), 4, 16, 2);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n0p = 128 * wg + 64 * p;
    W128_PAIRS({
      const float2 bb = ldg2(P.o_b + n0p + col);
      store2(CC, r, n0p + col, ag[p][i] + bb.x, ag[p][i + 1] + bb.y);
      if (wgr) store2(img(1), r, n0p + col, ag[p][i] + bb.x, ag[p][i + 1] + bb.y);
    })
  }
  fence_async_smem();
  w128_run<2, 1>(rg, CC, 0, ag);  // q1 = y1 p_w1 + p_b1; t1 = normalize(gelu(q1)) over H D
  w128_prime(rg, wsplit(P, SPLIT_P2), 4, 16, 2);
  {
    float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float2 bb = ldg2(P.p_b1 + n0p + col);
        const float qa = ag[p][i] + bb.x, qb = ag[p][i + 1] + bb.y;
        stcg2(c.x_q1 + r * W128_W + n0p + col, qa, qb);
        const float x0 = gelu_tanh(qa), x1 = gelu_tanh(qb);
        ag[p][i] = x0;
        ag[p][i + 1] = x1;
        v[hr][0] += x0 + x1;
        v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
      })
    }
    w128_row_sums<2>(v, c.xs, par, true);
    float mean[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = v[h][0] / W128_W;
      rs[h] = 1.0f / sqrtf(v[h][1] / W128_W - mean[h] * mean[h] + LN_EPS);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float x0 = (ag[p][i] - mean[hr]) * rs[hr], x1 = (ag[p][i + 1] - mean[hr]) * rs[hr];
        store2(SS, r, n0p + col, x0, x1);
        if (wgr) store2(img(2), r, n0p + col, x0, x1);
      })
    }
    fence_async_smem();
  }
  w128_run<2, 1>(rg, SS, 0, ag);  // q2 = t1 p_w2 + p_b2; y2 = gelu(q2)
  w128_prime(rg, wsplit(P, SPLIT_H1), 2, 16, 1);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n0p = 128 * wg + 64 * p;
    W128_PAIRS({
      const float2 bb = ldg2(P.p_b2 + n0p + col);
      const float2 g0 = gelu_and_grad(ag[p][i] + bb.x), g1 = gelu_and_grad(ag[p][i + 1] + bb.y);
      store2(CC, r, n0p + col, g0.x, g1.x);
      if (wgr) store2(img(3), r, n0p + col, g0.x, g1.x);
      stcg2(c.x_g2 + r * W128_W + n0p + col, g0.y, g1.y);
    })
  }
  fence_async_smem();
  float acc[1][32];
  w128_run<1, 1>(rg, CC, 0, acc);  // q3 = y2 h_w1 + h_b1; h1 = gelu(q3)
  w128_prime(rg, wsplit(P, SPLIT_H2), 2, 8, 1);
  W128_PAIRS({
    const float2 bb = ldg2(P.h_b1 + n0 + col);
    const float2 g0 = gelu_and_grad(acc[0][i] + bb.x), g1 = gelu_and_grad(acc[0][i + 1] + bb.y);
    store2(SS, r, n0 + col, g0.x, g1.x);
    stcg2(c.x_g3 + r * W128_HID + n0 + col, g0.y, g1.y);
  })
  fence_async_smem();
  w128_run<1, 1>(rg, SS, 0, acc);  // q4 = h1 h_w2 + h_b2; h2 = gelu(q4); dq4 = dh2 gelu'(q4)
  const int od = P.d.out;
  float cv[1][16] = {};
  W128_PAIRS({
    const float2 bb = ldg2(P.h_b2 + n0 + col);
    const float2 g0 = gelu_and_grad(acc[0][i] + bb.x), g1 = gelu_and_grad(acc[0][i + 1] + bb.y);
    float s0 = 0.0f, s1 = 0.0f;
    if (r < rows)
      for (int o = 0; o < od; ++o) {
        const float gg = __ldg(gsrc + r * od + o);
        s0 = fmaf(gg, bf16_round(__ldg(P.h_w3 + (n0 + col) * od + o)), s0);
        s1 = fmaf(gg, bf16_round(__ldg(P.h_w3 + (n0 + col + 1) * od + o)), s1);
      }
    const float q0 = bf16_round(s0) * g0.y, q1 = bf16_round(s1) * g1.y;
    store3(CC, PL128, r, n0 + col, q0, q1);
    W128_COL_ADD(cv, 0, q0, q1);
    if (wgr) store2(EE, r, n0 + col, g0.x, g1.x);
  })
  fence_async_smem();
  if (wgr) w128_col_out<1>(cv, c.cs, pw + P.d.w_off[17], first_w);  // dh_b2
}

// 3b. The tail's VJP from dq4 (three planes in C, h1 in S): each input gradient dX = bf16(dY W^T) and the
// product's epilogue (gelu' from the workspace, the LayerNorm-gelu VJP of t1 with the statistics of both
// warpgroups in one exchange), each cotangent in three planes in C; with weight gradients each row
// contraction X^T dY after its cotangent (X copied back from the workspace into S), the bias sums in the
// cotangents' epilogues.
// Ends with dy = bf16(dy1 o_w^T), one plane in C.
__device__ W128_PHASE void w128_tail_vjp(const W128Ctx& c, Ring& rg, int& par, const float* gsrc, int rows, bool wgr,
                                         bool first_w, float* pw) {
  const Params& P = *c.P;
  const Dims& d = P.d;
  W128_FRAG;
  bf16 *CC = at<bf16>(c, U_C), *SS = at<bf16>(c, U_S), *EE = at<bf16>(c, U_E);
  auto img = [&](int k) { return c.x_img + (size_t)k * PL256 / 2; };
  const int n0 = 64 * wg;
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_H2), 2, 8, 1);
  if (wgr) {
    w128_rows_part<1, 3>(SS, 0, W128_HID, CC, PL128, W128_HID, pw + d.w_off[16], W128_HID, first_w);  // dh_w2 = h1^T dq4
    w128_head_wgrad(EE, gsrc, rows, d.out, pw + d.w_off[18], pw + d.w_off[19], first_w);
  }
  bf16* DQ3 = CC + 3 * PL128;
  float acc[1][32];
  w128_run<1, 3>(rg, CC, PL128, acc);  // dh1 = bf16(dq4 h_w2^T); dq3 = dh1 gelu'(q3)
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_H1), 4, 8, 2);
  {
    float cv[1][16] = {};
    W128_PAIRS({
      const float2 gd = ldcg2(c.x_g3 + r * W128_HID + n0 + col);
      const float q0 = bf16_round(acc[0][i]) * gd.x, q1 = bf16_round(acc[0][i + 1]) * gd.y;
      store3(DQ3, PL128, r, n0 + col, q0, q1);
      W128_COL_ADD(cv, 0, q0, q1);
    })
    fence_async_smem();
    if (wgr) w128_col_out<1>(cv, c.cs, pw + d.w_off[15], first_w);  // dh_b1
  }
  if (wgr) {  // dh_w1 = y2^T dq3
    w128_reload(SS, img(3), PL256);
    w128_rows_part<1, 3>(SS, 0, W128_W, DQ3, PL128, W128_HID, pw + d.w_off[14], W128_HID, first_w);
  }
  float ag[2][32];
  w128_run<2, 3>(rg, DQ3, PL128, ag);  // dy2 = bf16(dq3 h_w1^T); dq2 = dy2 gelu'(q2), in C's place
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_P2), 4, 16, 2);
  __syncthreads();  // both warpgroups are done reading dq3
  {
    float cv[2][16] = {};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float2 gd = ldcg2(c.x_g2 + r * W128_W + n0p + col);
        const float q0 = bf16_round(ag[p][i]) * gd.x, q1 = bf16_round(ag[p][i + 1]) * gd.y;
        store3(CC, PL256, r, n0p + col, q0, q1);
        W128_COL_ADD(cv, p, q0, q1);
      })
    }
    fence_async_smem();
    if (wgr) w128_col_out<2>(cv, c.cs, pw + d.w_off[13], first_w);  // dp_b2
  }
  if (wgr) {  // dp_w2 = t1^T dq2
    w128_reload(SS, img(2), PL256);
    w128_rows_part<1, 3>(SS, 0, W128_W, CC, PL256, W128_W, pw + d.w_off[12], W128_W, first_w);
  }
  w128_run<2, 3>(rg, CC, PL256, ag);  // dt1 = bf16(dq2 p_w2^T); dq1 by the LayerNorm-gelu VJP, in C's place
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_P1), 4, 16, 2);
  {
    float v[2][4] = {};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float2 q = ldcg2(c.x_q1 + r * W128_W + n0p + col);
        const float x0 = gelu_tanh(q.x), x1 = gelu_tanh(q.y);
        const float d0 = bf16_round(ag[p][i]), d1 = bf16_round(ag[p][i + 1]);
        ag[p][i] = d0;
        ag[p][i + 1] = d1;
        v[hr][0] += x0 + x1;
        v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
        v[hr][2] += d0 + d1;
        v[hr][3] = fmaf(d0, x0, fmaf(d1, x1, v[hr][3]));
      })
    }
    w128_row_sums<4>(v, c.xs, par, true);  // its barrier: both warpgroups are done reading dq2
    float mean[2], rs[2], md[2], mdn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = v[h][0] / W128_W;
      rs[h] = 1.0f / sqrtf(v[h][1] / W128_W - mean[h] * mean[h] + LN_EPS);
      md[h] = v[h][2] / W128_W;
      mdn[h] = rs[h] * (v[h][3] - mean[h] * v[h][2]) / W128_W;
    }
    float cv[2][16] = {};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float2 q = ldcg2(c.x_q1 + r * W128_W + n0p + col);
        const float2 g0 = gelu_and_grad(q.x), g1 = gelu_and_grad(q.y);
        const float m0 = (g0.x - mean[hr]) * rs[hr], m1 = (g1.x - mean[hr]) * rs[hr];
        const float q0 = rs[hr] * (ag[p][i] - md[hr] - m0 * mdn[hr]) * g0.y;
        const float q1 = rs[hr] * (ag[p][i + 1] - md[hr] - m1 * mdn[hr]) * g1.y;
        store3(CC, PL256, r, n0p + col, q0, q1);
        W128_COL_ADD(cv, p, q0, q1);
      })
    }
    fence_async_smem();
    if (wgr) w128_col_out<2>(cv, c.cs, pw + d.w_off[11], first_w);  // dp_b1
  }
  if (wgr) {  // dp_w1 = y1^T dq1
    w128_reload(SS, img(1), PL256);
    w128_rows_part<1, 3>(SS, 0, W128_W, CC, PL256, W128_W, pw + d.w_off[10], W128_W, first_w);
  }
  w128_run<2, 3>(rg, CC, PL256, ag);  // dy1 = bf16(dq1 p_w1^T), into E
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_O), 4, 16, 2);
  {
    float cv[2][16] = {};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float q0 = bf16_round(ag[p][i]), q1 = bf16_round(ag[p][i + 1]);
        store2(EE, r, n0p + col, q0, q1);
        W128_COL_ADD(cv, p, q0, q1);
      })
    }
    fence_async_smem();
    if (wgr) w128_col_out<2>(cv, c.cs, pw + d.w_off[9], first_w);  // do_b
  }
  if (wgr) {  // do_w = y^T dy1 (dy1 is bf16: one term)
    w128_reload(SS, img(0), PL256);
    w128_rows_part<1, 1>(SS, 0, W128_W, EE, 0, W128_W, pw + d.w_off[8], W128_W, first_w);
  }
  w128_run<2, 1>(rg, EE, 0, ag);  // dy = bf16(dy1 o_w^T), into C
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int n0p = 128 * wg + 64 * p;
    W128_PAIRS(store2(CC, r, n0p + col, ag[p][i], ag[p][i + 1]);)
  }
  fence_async_smem();
}

// The mixer's VJP from dy (dyp planes in C): <dy_h, m_b2>; with weight gradients dm_b2 = sum psum dy and
// dm_w2 = nbar_h^T dy_h a head (nbar_h's three planes from the workspace into S and E; each head's own
// partial); e_h = dy_h m_w2^T into the workspace (not rounded: the cotangent of the rounded n is bf16(p16 e)).
template <int DYP>
__device__ W128_PHASE void w128_mixer_vjp(const W128Ctx& c, Ring& rg, bool wgr, bool first_w, float* pw) {
  const Params& P = *c.P;
  const Dims& d = P.d;
  W128_FRAG;
  bf16 *CC = at<bf16>(c, U_C), *SS = at<bf16>(c, U_S);
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_M), 2, 8, 1);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * 2; idx += THREADS) {
    const int t = idx >> 1, h = idx & 1;
    float s = 0.0f;
    for (int n = 0; n < W128_HID; ++n) {
      const int i = a16_index(t, h * W128_HID + n);
      float v = b2f(CC[i]);
      for (int p = 1; p < DYP; ++p) v += b2f(CC[i + p * PL256]);
      s = fmaf(v, __ldg(P.m_b2 + n), s);
    }
    c.s_dyb[idx] = s;
  }
  if (wgr) {
    w128_dm_b2(CC, PL256, DYP, pw + d.w_off[7], first_w, c.s_psum);
    for (int h = 0; h < 2; ++h) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < TILE * W128_HID / 2; idx += THREADS) {
        const int r = idx / (W128_HID / 2), n = 2 * (idx % (W128_HID / 2));
        const float2 v = ldcg2(c.x_nb + r * W128_W + h * W128_HID + n);
        store3(SS, PL128, r, n, v.x, v.y);
      }
      fence_async_smem();
      w128_rows_part<3, DYP>(SS, PL128, W128_HID, CC + 64 * W128_HID * h, PL256, W128_HID,
                           pw + d.w_off[6] + (size_t)h * W128_HID * W128_HID, W128_HID, first_w);
    }
  }
  for (int h = 0; h < 2; ++h) {
    float acc[1][32];
    w128_run<1, DYP>(rg, CC + 64 * W128_HID * h, PL256, acc);
    if (h == 0) w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_M), 2, 8, 1);
    const int n0 = W128_HID * h + 64 * wg;
    W128_PAIRS(stcg2(c.x_e + r * W128_W + n0 + col, acc[0][i], acc[0][i + 1]);)
  }
}

// 4. A latent's value chain again, then its VJP: in G's epilogue dn = bf16(bf16(p) e) and dp = bf16(<e, bf16(n)>
// + <dy, m_b2>) per head (a warpgroup's columns) and dpre, three planes; dc, dG = t^T dpre; dt = bf16(dpre
// G^T) and du by the LayerNorm-gelu VJP in its epilogue (one exchange); dfw; dhv = bf16(du fw^T) where hv >
// 0; dv_w1; dF = bf16(dhv v_w1^T) and the RFF VJP into dinv.
__device__ W128_PHASE void w128_value_vjp(const W128Ctx& c, Ring& rg, int& par, size_t bz, int c0, int rows, int z,
                                          float* pG, float* pc, bool first_row, bool wgr, bool first_w, float* pw) {
  const Params& P = *c.P;
  const Dims& d = P.d;
  W128_FRAG;
  bf16 *F = at<bf16>(c, U_F), *HV = at<bf16>(c, U_HV), *T = at<bf16>(c, U_T), *DP = at<bf16>(c, U_D);
  w128_value_chain(c, rg, par, bz, c0, rows, true);
  w128_prime(rg, c.Gblk + bz * W128_GBLK, 4, 8, 2);
  float ag[2][32];
  w128_run<2, 1>(rg, T, 0, ag);  // pre = t G + c
  w128_prime(rg, c.Gblk + bz * W128_GBLK + W128_GBLK / 2, 2, 16, 1);
  {
    float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_LOOP({
        const float x = ag[p][i] + __ldg(P.c + bz * W128_W + n0p + col);
        ag[p][i] = x;
        const float g = gelu_tanh(x);
        v[hr][0] += g;
        v[hr][1] = fmaf(g, g, v[hr][1]);
      })
    }
    w128_row_sums<2>(v, c.xs, par, false);
    float mean[2], rs[2], pz[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = v[h][0] / W128_HID;
      rs[h] = 1.0f / sqrtf(v[h][1] / W128_HID - mean[h] * mean[h] + LN_EPS);
      pz[h] = bf16_round(c.s_prob[(z * TILE + r0 + 8 * h) * 2 + wg]);
    }
    float w[2][3] = {};  // sums of e bf16(n), dn and dn n
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float2 e = ldcg2(c.x_e + r * W128_W + n0p + col);
        const float m0 = (gelu_tanh(ag[p][i]) - mean[hr]) * rs[hr], m1 = (gelu_tanh(ag[p][i + 1]) - mean[hr]) * rs[hr];
        const float d0 = bf16_round(e.x * pz[hr]), d1 = bf16_round(e.y * pz[hr]);
        w[hr][0] = fmaf(e.x, bf16_round(m0), fmaf(e.y, bf16_round(m1), w[hr][0]));
        w[hr][1] += d0 + d1;
        w[hr][2] = fmaf(d0, m0, fmaf(d1, m1, w[hr][2]));
      })
    }
    w128_row_sums<3>(w, c.xs, par, false);
    if (tq == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r0 + 8 * h;
        c.s_dlog[(z * TILE + t) * 2 + wg] = bf16_round(w[h][0] + c.s_dyb[t * 2 + wg]);
      }
    float cv[2][16] = {};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0p = 128 * wg + 64 * p;
      W128_PAIRS({
        const float2 e = ldcg2(c.x_e + r * W128_W + n0p + col);
        const float2 g0 = gelu_and_grad(ag[p][i]), g1 = gelu_and_grad(ag[p][i + 1]);
        const float m0 = (g0.x - mean[hr]) * rs[hr], m1 = (g1.x - mean[hr]) * rs[hr];
        const float d0 = bf16_round(e.x * pz[hr]), d1 = bf16_round(e.y * pz[hr]);
        const float md = w[hr][1] / W128_HID, mdn = w[hr][2] / W128_HID;
        const float q0 = rs[hr] * (d0 - md - m0 * mdn) * g0.y, q1 = rs[hr] * (d1 - md - m1 * mdn) * g1.y;
        store3(DP, PL256, r, n0p + col, q0, q1);
        W128_COL_ADD(cv, p, q0, q1);
      })
    }
    fence_async_smem();
    w128_col_out<2>(cv, c.cs, pc + (size_t)z * W128_W, first_row);  // dc
  }
  w128_rows_part<1, 3>(T, 0, W128_HID, DP, PL256, W128_W, pG + (size_t)z * W128_HID * W128_W, W128_W, first_row);  // dG = t^T dpre
  float acc[1][32];
  w128_run<1, 3>(rg, DP, PL256, acc);  // dt = bf16(dpre G^T); du by the LayerNorm-gelu VJP, in dpre's place
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_F), 2, 8, 1);
  const int n0 = 64 * wg;
  {
    float v[2][4] = {};
    W128_PAIRS({
      const float2 u = ldcg2(c.x_u + r * W128_HID + n0 + col);
      const float x0 = gelu_tanh(u.x), x1 = gelu_tanh(u.y);
      const float d0 = bf16_round(acc[0][i]), d1 = bf16_round(acc[0][i + 1]);
      acc[0][i] = d0;
      acc[0][i + 1] = d1;
      v[hr][0] += x0 + x1;
      v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
      v[hr][2] += d0 + d1;
      v[hr][3] = fmaf(d0, x0, fmaf(d1, x1, v[hr][3]));
    })
    w128_row_sums<4>(v, c.xs, par, true);  // its barrier: both warpgroups are done reading dpre
    float mean[2], rs[2], md[2], mdn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = v[h][0] / W128_HID;
      rs[h] = 1.0f / sqrtf(v[h][1] / W128_HID - mean[h] * mean[h] + LN_EPS);
      md[h] = v[h][2] / W128_HID;
      mdn[h] = rs[h] * (v[h][3] - mean[h] * v[h][2]) / W128_HID;
    }
    float cv[1][16] = {};
    W128_PAIRS({
      const float2 u = ldcg2(c.x_u + r * W128_HID + n0 + col);
      const float2 g0 = gelu_and_grad(u.x), g1 = gelu_and_grad(u.y);
      const float m0 = (g0.x - mean[hr]) * rs[hr], m1 = (g1.x - mean[hr]) * rs[hr];
      const float q0 = rs[hr] * (acc[0][i] - md[hr] - m0 * mdn[hr]) * g0.y;
      const float q1 = rs[hr] * (acc[0][i + 1] - md[hr] - m1 * mdn[hr]) * g1.y;
      store3(DP, PL128, r, n0 + col, q0, q1);
      W128_COL_ADD(cv, 0, q0, q1);
    })
    fence_async_smem();
    if (wgr) w128_col_out<1>(cv, c.cs, pw + d.w_off[5], first_w && z == 0);  // dfb
  }
  bf16* DHV = DP + 3 * PL128;
  if (wgr)  // dfw = hv^T du
    w128_rows_part<1, 3>(HV, 0, W128_HID, DP, PL128, W128_HID, pw + d.w_off[4], W128_HID, first_w && z == 0);
  w128_run<1, 3>(rg, DP, PL128, acc);  // dhv = bf16(du fw^T), 0 where hv is not positive
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_V), 2, 8, 1);
  {
    float cv[1][16] = {};
    W128_PAIRS({
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(HV + a16_index(r, n0 + col));
      const float q0 = b2f(h2.x) > 0.0f ? bf16_round(acc[0][i]) : 0.0f, q1 = b2f(h2.y) > 0.0f ? bf16_round(acc[0][i + 1]) : 0.0f;
      store2(DHV, r, n0 + col, q0, q1);
      W128_COL_ADD(cv, 0, q0, q1);
    })
    fence_async_smem();
    if (wgr) w128_col_out<1>(cv, c.cs, pw + d.w_off[3], first_w && z == 0);  // dv_b1
  }
  if (wgr)  // dv_w1 = F^T dhv (dhv is bf16: one term)
    w128_rows_part<1, 1>(F, 0, W128_HID, DHV, 0, W128_HID, pw + d.w_off[2], W128_HID, first_w && z == 0);
  w128_run<1, 1>(rg, DHV, 0, acc);  // dF = bf16(dhv v_w1^T), then the RFF VJP into dinv (a row pass)
  float* DF = at<float>(c, U_D + 65536);
  W128_PAIRS(*reinterpret_cast<float2*>(DF + r * W128_HID + n0 + col) = make_float2(bf16_round(acc[0][i]), bf16_round(acc[0][i + 1]));)
  rff_vjp(c.s_inv, d.I, P.v_coeff, W128_HID / 2, DF, W128_HID, P.dinv + (bz * d.C + c0) * d.I, rows, false);
}

// 5. A latent's query chain again, then its VJP: in q_w1's epilogue dhq = (hq > 0) bf16(dlog A^T) and dA's
// column sums (over the quads' rows by shuffles, then the warps' in order); dab, dwb; dq_w1; dF =
// bf16(dhq q_w1^T) and the RFF VJP added into dinv.
__device__ W128_PHASE void w128_query_vjp(const W128Ctx& c, Ring& rg, size_t bz, int c0, int rows, int z, float* pA,
                                          float* pab, bool first_row, bool wgr, bool first_w, float* pw) {
  const Params& P = *c.P;
  const Dims& d = P.d;
  W128_FRAG;
  bf16 *F = at<bf16>(c, U_F), *DH = at<bf16>(c, U_HV);
  w128_prime(rg, wsplit(P, SPLIT_Q), 2, 8, 1);
  load_inv(c.s_inv, P.inv + (bz * d.C + c0) * d.I, rows, d.I);
  w128_features(c.s_inv, d.I, P.q_coeff, F);
  float acc[1][32];
  w128_run<1, 1>(rg, F, 0, acc);
  w128_prime(rg, wsplit(P, SPLIT_T + SPLIT_Q), 2, 8, 1);
  const int n0 = 64 * wg, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* dlog = c.s_dlog + z * TILE * 2;
  float dl[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 2; ++k) dl[h][k] = dlog[(r0 + 8 * h) * 2 + k];
  float da[8][2][2];  // this thread's columns' sums over its two rows of bf16(hq) dlog
  float cv[1][16] = {};
  W128_PAIRS({
    const float2 bq = ldg2(P.q_b1 + n0 + col);
    const float hq[2] = {fmaxf(acc[0][i] + bq.x, 0.0f), fmaxf(acc[0][i + 1] + bq.y, 0.0f)};
    float dh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 a = ldg2(P.A + (bz * W128_HID + n0 + col + e) * 2);
      const float s = fmaf(dl[hr][1], bf16_round(a.y), dl[hr][0] * bf16_round(a.x));
      dh[e] = hq[e] > 0.0f ? bf16_round(s) : 0.0f;
      const float hb = bf16_round(hq[e]);
#pragma unroll
      for (int k = 0; k < 2; ++k) da[j_][e][k] = hr ? fmaf(hb, dl[hr][k], da[j_][e][k]) : hb * dl[hr][k];
    }
    store2(DH, r, n0 + col, dh[0], dh[1]);
    W128_COL_ADD(cv, 0, dh[0], dh[1]);
  })
  fence_async_smem();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float s = da[j][e][k];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        da[j][e][k] = s;
      }
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 2; ++k) c.cs[((warp & 3) * W128_HID + n0 + 8 * j + 2 * lane + e) * 2 + k] = da[j][e][k];
  __syncthreads();
  float* dA = pA + (size_t)z * W128_HID * 2;
  for (int idx = threadIdx.x; idx < W128_HID * 2; idx += THREADS) {
    const float s = ((c.cs[idx] + c.cs[W128_HID * 2 + idx]) + c.cs[2 * W128_HID * 2 + idx]) + c.cs[3 * W128_HID * 2 + idx];
    dA[idx] = first_row ? s : dA[idx] + s;
  }
  if (threadIdx.x < 2) {
    float s = 0.0f;
    for (int t = 0; t < TILE; ++t) s += dlog[t * 2 + threadIdx.x];
    pab[z * 2 + threadIdx.x] = first_row ? s : pab[z * 2 + threadIdx.x] + s;
  }
  for (int t = threadIdx.x; t < rows; t += THREADS) P.dwb[bz * d.C + c0 + t] = dlog[t * 2] + dlog[t * 2 + 1];
  if (wgr) {  // dq_b1, dq_w1 = F^T dhq
    w128_col_out<1>(cv, c.cs, pw + d.w_off[1], first_w && z == 0);
    w128_rows_part<1, 1>(F, 0, W128_HID, DH, 0, W128_HID, pw + d.w_off[0], W128_HID, first_w && z == 0);
  }
  w128_run<1, 1>(rg, DH, 0, acc);  // dF = bf16(dhq q_w1^T), then the RFF VJP added into dinv (a row pass)
  float* DF = at<float>(c, U_D + 65536);
  W128_PAIRS(*reinterpret_cast<float2*>(DF + r * W128_HID + n0 + col) = make_float2(bf16_round(acc[0][i]), bf16_round(acc[0][i + 1]));)
  rff_vjp(c.s_inv, d.I, P.q_coeff, W128_HID / 2, DF, W128_HID, P.dinv + (bz * d.C + c0) * d.I, rows, true);
}

__global__ void __launch_bounds__(THREADS, 1) fused_decode_bwd_w128(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int Z = d.Z, tid = threadIdx.x;
  W128Ctx c;
  c.P = &P;
  c.U = reinterpret_cast<char*>(smem) + W128_RING;
  c.s_psum = reinterpret_cast<float*>(c.U + W128_U);  // [64][2] sum_z bf16(p_z)
  c.s_dyb = c.s_psum + 2 * TILE;                      // [64][2] <dy_h, m_b2>
  c.s_inv = c.s_dyb + 2 * TILE;                       // [64][I]
  c.xs = c.s_inv + TILE * MAX_I;                      // the row sums' exchange: [2][2][64][4]
  c.cs = c.xs + 1024;                                 // the column sums of the warps: [4][128][2]
  c.s_prob = c.cs + 1024;                             // [Z][64][2] softmax weights (f32)
  c.s_dlog = c.s_prob + Z * TILE * 2;                 // [Z][64][2] dp, then dlogit
  float* ws = P.work + d.split_total + (size_t)blockIdx.x * d.work;
  c.x_e = ws + d.x_e;        // [64][256] e = dy m_w2^T (f32)
  c.x_u = ws + d.x_u;        // [64][128] u
  c.x_q1 = ws + d.x_q1;      // [64][256] the tail's q1
  c.x_g2 = ws + d.x_gq2;     // [64][256] gelu'(q2)
  c.x_g3 = ws + d.x_gq3;     // [64][128] gelu'(q3)
  c.x_nb = ws + d.x_nbar;    // [64][256] nbar (with weight gradients)
  c.x_img = ws + d.x_img;    // y, y1, t1, y2 as bf16 planes (with weight gradients and the tail)
  c.Gblk = P.work + d.g_off;
  Ring rg;
  rg.buf = smem + (tid >> 7) * W128_STAGES * 1024;
  rg.bar = 1 + (tid >> 7);
  rg.lt = tid & 127;
  int par = 0;
  float* pb = P.part + (size_t)blockIdx.x * d.part;
  float* pw = pb + (size_t)d.slots * d.l_row;
  const bool wgr = d.wgrad;
  const long long lo = (long long)blockIdx.x * d.ipb;
  const long long hi = lo + d.ipb < d.items ? lo + d.ipb : d.items;
  const int b_first = (int)(lo / d.nt);

  for (long long item = lo; item < hi; ++item) {
    const int b = (int)(item / d.nt), tile = (int)(item % d.nt);
    const int c0 = tile * TILE, rows = min(TILE, d.C - c0);
    const bool first_row = item == lo || tile == 0, first_w = item == lo;
    float* pA = pb + (size_t)(b - b_first) * d.l_row;
    float* pab = pA + d.l_A;
    float* pG = pab + d.l_ab;
    float* pc = pG + d.l_G;
    const float* gsrc = P.g + ((size_t)b * d.C + c0) * d.out;

    for (int z = 0; z < Z; ++z) w128_logits(c, rg, par, (size_t)b * Z + z, c0, rows, z);
    softmax_z(c.s_prob, Z, 2, c.s_psum);
    for (int z = 0; z < Z; ++z) w128_value(c, rg, par, (size_t)b * Z + z, c0, rows, z);
    __syncthreads();  // nbar, every latent's
    if (wgr) {
      const float* NB = at<float>(c, U_NBAR);
      for (int idx = 4 * tid; idx < TILE * W128_W; idx += 4 * THREADS)
        __stcg(reinterpret_cast<float4*>(c.x_nb + idx), *reinterpret_cast<const float4*>(NB + idx));
    }
    if (d.tail) {
      w128_tail_fwd(c, rg, par, gsrc, rows, wgr, first_w, pw);
      w128_tail_vjp(c, rg, par, gsrc, rows, wgr, first_w, pw);
      w128_mixer_vjp<1>(c, rg, wgr, first_w, pw);
    } else {
      bf16* CC = at<bf16>(c, U_C);
      for (int idx = tid; idx < TILE * W128_W / 2; idx += THREADS) {  // dy = g, three planes
        const int r = idx / (W128_W / 2), n = 2 * (idx % (W128_W / 2));
        const float2 v = r < rows ? ldg2(gsrc + r * W128_W + n) : make_float2(0.0f, 0.0f);
        store3(CC, PL256, r, n, v.x, v.y);
      }
      fence_async_smem();
      w128_mixer_vjp<3>(c, rg, wgr, first_w, pw);
    }
    for (int z = 0; z < Z; ++z)
      w128_value_vjp(c, rg, par, (size_t)b * Z + z, c0, rows, z, pG, pc, first_row, wgr, first_w, pw);
    softmax_vjp(c.s_prob, c.s_dlog, Z, 2);
    for (int z = 0; z < Z; ++z) w128_query_vjp(c, rg, (size_t)b * Z + z, c0, rows, z, pA, pab, first_row, wgr, first_w, pw);
  }
}

// ---- The narrow design: the width classes 8, 16, 32 (hid = hidm = D = 16, 32, 64) ------------------------------
// Every bf16 launch below the width class 64 (diff_sphere, ihc, diffusion_plane, cahn_hilliard: the nef step's and
// the fit's on `nef.backend: pallas`) takes it (`Dims::narrow`; `fd.k2_narrow_design`). The class design walked each
// work item (batch row, tile) through every latent four times, one small product after another, on a grid of a few
// dozen blocks at these shapes. Here the softmax over latents, the one coupling between them, splits the launch into
// kernels on the stream, and the rest runs a (batch row, latent, 64-coordinate tile) item at a time:
//   1. `narrow_logits`: a latent's query chain and its logits, into global memory;
//   2. `narrow_values`: the softmax over latents (each item takes its own latent's weights from every latent's
//      logits, in latent order) and a latent's value chain, nn = normalize(gelu(t G + c)) in bf16;
//   3. `narrow_tail`, a (batch row, tile) an item: nbar = sum_z bf16(p_z) nn_z in latent order, the tail forward and
//      its VJP, the mixer's VJP: e = dy m_w2^T and <dy, m_b2> into global memory;
//   4. `narrow_value_vjp`: a latent's value chain again and its VJP: dp, dG, dc, dfw ... dv_b1, dinv;
//   5. `narrow_query_vjp`: the softmax's VJP (every latent's p and dp, in latent order) and a latent's query chain
//      again and its VJP: dA, dab, dwb, dq_w1, dq_b1, dinv added;
//   then `narrow_reduce`: the partials summed in block order.
// Every product is a bf16 wgmma with both operands in shared memory, read by descriptor: an activation stored in bf16
// by the epilogue that makes it (64 rows, `a16_index`), an f32 cotangent in three bf16 planes (`store3`; the
// products of terms i + j <= 2, the smallest first, in the accumulator), the shared weights and G in bf16 images
// written once a launch (`narrow_prep`: K x N in `op_index`'s layout with K rows), read MN-major as the B of X W and
// K-major as the B of dY W^T; a row contraction (dG and the weight gradients) reads both of its operands MN-major.
// From W = 32 a block has two warpgroups, each half of every product's columns (m64n(W/2)k16; at W = 16 one
// warpgroup, m64n16k16): both run the same products, so no wgmma sits on a path that differs between them. A row
// of a product lies in one quad of each warpgroup: the LayerNorm-gelu passes and their VJPs, the logits and dp are
// epilogues (two shuffles, then the two warpgroups' sums added through shared memory, `xsum`); the column sums (dc
// and the bias gradients) are shuffles, then each warpgroup's four warps in order (`ncol_out`). The weights a
// latent's chain reads stay resident for the block's life; a latent's G is copied in by cp.async at the item's
// start; the tail's weights are streamed, two buffers, each copied while the product before it runs. Each product
// waits for its group and ends with a block barrier, so no write of a buffer races a warp's product still reading
// it (a warp's wait covers only its own part).
// The per-latent kernels share one plan: persistent blocks, each a contiguous run of items ordered (b, z, tile), so
// that a (b, z) row's partials (dA, dab, dG, dc) and the weight gradients are summed per block in item order and
// across blocks in block order (`narrow_reduce`); the plan does not depend on whether weight gradients are asked
// for, so dinv ... dc are the same bits either way. What passes between the kernels goes through the workspace
// (`narrow_plan`): every latent's logits (later dp) and softmax weights, nn in bf16, e and <dy, m_b2>. Shared
// memory (nl_layout, nt_layout; k2_smem_bytes / k2_narrow_layout mirror them), the per-latent kernels' and the
// tail's: diffusion_plane and cahn_hilliard (W 64, H 2) 115,200 B and 219,648 B; ihc (W 32, H 3) 67,840 B and
// 162,048 B; diff_sphere (W 16, H 2) 27,648 B and 54,272 B.
constexpr int NWIDE = 32;      // from this width a block has two warpgroups, each half of every product's columns
constexpr int NHD_MAX = 128;   // widest H D
constexpr int NH_MAX = 8;      // most heads

// A block's warpgroups at width W (the other widths: one, every product's columns), its threads, a warpgroup's
// columns of a product W wide, and the blocks an SM __launch_bounds__ leaves registers for (at most 128 a thread;
// 170 with one warpgroup).
__host__ __device__ constexpr int nwg(int W) { return W >= NWIDE ? 2 : 1; }
__host__ __device__ constexpr int nthreads(int W) { return 128 * nwg(W); }
__host__ __device__ constexpr int ncols(int W) { return W / nwg(W); }
__host__ __device__ constexpr int nminb(int W) { return nwg(W) == 2 ? 2 : 3; }
constexpr int SM_BYTES = 233472;  // shared memory of an SM; 1,024 B of it kept back a block (the tail's plan)
constexpr int NXS = 2 * 2 * TILE * 4 * 4;  // bytes of the row sums' exchange between the warpgroups: [2][2][64][4]

__host__ __device__ inline int nmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int nround(int x, int m) { return (x + m - 1) / m * m; }

// The per-latent kernels' shared memory, byte offsets: the resident weights w1 (q_w1 or v_w1) and w2 (fw), a
// latent's G, the operands F, HV, T ([64][W] each), PL (dpre's three planes [64][H W]; later du's three
// planes, dhv and dF in f32), the invariants, the softmax weights or dlog [64][H], the column sums' and the row
// sums' exchanges.
// A row contraction reads 64 columns of its A (F, HV or T) from where W of them start: past them it reads the
// next buffer's bytes into the rows of its result that it drops.
struct NarrowLatent {
  int w1, w2, gb, f, hv, t, pl, inv, sp, cs, xs, total;
};
__host__ __device__ inline NarrowLatent nl_layout(int W, int H) {
  NarrowLatent L;
  const int HH = H * W;
  L.w1 = 0;
  L.w2 = L.w1 + W * W * 2;
  L.gb = L.w2 + W * W * 2;
  L.f = L.gb + W * HH * 2;
  L.hv = L.f + TILE * W * 2;
  L.t = L.hv + TILE * W * 2;
  L.pl = L.t + TILE * W * 2;
  L.inv = L.pl + nmax(3 * TILE * HH * 2, 3 * TILE * W * 2 + TILE * W * 2 + TILE * W * 4);
  L.sp = L.inv + TILE * MAX_I * 4;
  L.cs = L.sp + nround(TILE * H * 4, 16);
  L.xs = L.cs + 4 * nmax(HH, W) * 4;
  L.total = L.xs + NXS;
  return L;
}
// The tail kernel's: two weight buffers, two buffers of three planes [64][H D] (PA: nbar, the cotangents; PB),
// two activations X1, X2 [64][xc], the bf16 stage DT [64][H D] (dt1, then dy), psum [64][H], the column sums'
// and the row sums' exchanges. xc rounds H D up to the 64 columns a row contraction reads of its A; its reads of the last head of
// nbar (dm_w2's A) run on into PB, into rows of its result that it drops.
struct NarrowTail {
  int wb, pa, pb, pc, x1, x2, xc, dt, psum, cs, xs, total;
};
__host__ __device__ inline NarrowTail nt_layout(int W, int H) {
  NarrowTail L;
  const int HD = H * W;
  const int wbytes = nmax(HD * HD, nmax(HD * W, W * W)) * 2;
  L.pc = HD;
  L.xc = nround(HD, 64);
  L.wb = 0;
  L.pa = L.wb + 2 * wbytes;
  L.pb = L.pa + 3 * TILE * L.pc * 2;
  L.x1 = L.pb + 3 * TILE * L.pc * 2;
  L.x2 = L.x1 + TILE * L.xc * 2;
  L.dt = L.x2 + TILE * L.xc * 2;
  L.psum = L.dt + TILE * HD * 2;
  L.cs = L.psum + nround(TILE * H * 4, 16);
  L.xs = L.cs + 4 * nmax(HD, W) * 4;
  L.total = L.xs + NXS;
  return L;
}

// gelu of the tanh form, 0.5 x (1 + tanh(u)), u = sqrt(2 / pi) (x + 0.044715 x^3), as x s with s = sigmoid(2 u) =
// 1 / (1 + exp(-2 u)) by __expf and a fast quotient (within a few ulp of tanhf's form, far below the bf16 rounding
// the values meet; x -> -inf: s -> 0), and with it gelu'(x) = s + 2 x s (1 - s) u'(x).
__device__ __forceinline__ float nsig(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-1.5957691216057308f * (x + 0.044715f * x * x * x)));
}
__device__ __forceinline__ float ngelu(float x) { return x * nsig(x); }
__device__ __forceinline__ float2 ngelu2(float x) {
  const float sg = nsig(x);
  return make_float2(x * sg, fmaf(2.0f * x * sg * (1.0f - sg), 0.7978845608028654f * (1.0f + 0.134145f * x * x), sg));
}

// Element (r, c) of an R-row bf16 operand (R a multiple of 8): core matrices of 8 rows x 8 columns (128 bytes),
// the row groups of a column group 128 bytes apart, the column groups R 16 bytes apart (R = 64: a16_index). Read
// K-major (its rows are a product's M or N, its columns K): LBO R 16, SBO 128; MN-major (its rows are K): LBO
// 128, SBO R 16.
__host__ __device__ inline int op_index(int r, int c, int R) { return (((c >> 3) * (R >> 3) + (r >> 3)) << 6) + ((r & 7) << 3) + (c & 7); }
__device__ __forceinline__ uint64_t kdesc(const bf16* p, int R) { return smem_desc(p, R * 16, 128); }
__device__ __forceinline__ uint64_t mdesc(const bf16* p, int R) { return smem_desc(p, 128, R * 16); }

// D (64 x N f32, this thread's N / 2 values in the fragment order of K1's products) (+)= A (64 x 16) x B (16 x N), bf16 in
// shared memory; TA / TB: read MN-major.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_t(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 64) {
    wgmma_ss<TA, TB>(d, adesc, bdesc, accumulate);
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TA), "n"(TB));
  } else if constexpr (N == 8) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, %8;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(adesc), "l"(bdesc), "r"(accumulate), "n"(TA), "n"(TB));
  }
}

// acc (this thread's N / 2 values of its warpgroup's 64 x N part of a product 2N wide) = sum over nks k steps of
// A x B, the products of A's and B's bf16 terms i + j <= 2 (AP / BP planes `aps` / `bps` elements apart), the
// smallest first, in the accumulator. A's k step ks at a + ks astep (an R = ra-row operand, MN-major with TA), B's
// likewise, from the first column of the product: warpgroup wg reads columns wg N .. of B (its rows, R = rb, MN-major;
// its rows 8 apart, K-major). Every thread calls it, both warpgroups the same products: it starts with the writers'
// fence and a block barrier (the operands are written) and ends with the product complete in every warp and a block
// barrier (any buffer may be written).
template <int N, int TA, int TB, int AP, int BP>
__device__ __forceinline__ void nmma(float (&acc)[N / 2], const bf16* a, int ra, int astep, int aps, const bf16* b,
                                     int rb, int bstep, int bps, int nks) {
  constexpr int S = AP + BP - 2 < 2 ? AP + BP - 2 : 2;
  b += (threadIdx.x >> 7) * N * (TB ? rb : 8);
  fence_async_smem();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  wg_fence_operands<N / 2>(acc);
  wg_fence();
  for (int ks = 0; ks < nks; ++ks) {
#pragma unroll
    for (int s = S; s >= 0; --s)
#pragma unroll
      for (int i = AP - 1; i >= 0; --i) {
        const int j = s - i;
        if (j < 0 || j >= BP) continue;
        const bf16* pa = a + i * aps + ks * astep;
        const bf16* pb = b + j * bps + ks * bstep;
        wgmma_t<N, TA, TB>(acc, TA ? mdesc(pa, ra) : kdesc(pa, ra), TB ? mdesc(pb, rb) : kdesc(pb, rb), 1);
      }
  }
  wg_commit();
  wg_wait0();
  wg_fence_operands<N / 2>(acc);
  __syncthreads();
}

// This thread's part of its warpgroup's 64 x N part of a product (columns cb = wg N ..): element i, its row r =
// r0 + 8 hr (r0 = 16 warp + g, the warp's rank in its warpgroup) and its column col = cb + 8 j + 2 tq + e of the
// product; N_PAIRS visits the pairs (col, col + 1) at i, i + 1. Loops unrolled into constant register indices.
#define N_FRAG(N) \
  const int tq = threadIdx.x & 3, r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2), cb = (threadIdx.x >> 7) * (N)
#define N_PAIRS(NJ, ...)                                                                    \
  _Pragma("unroll") for (int j_ = 0; j_ < (NJ); ++j_)                                        \
    _Pragma("unroll") for (int hr = 0; hr < 2; ++hr) {                                       \
      const int i = 4 * j_ + 2 * hr, col = cb + 8 * j_ + 2 * tq, r = r0 + 8 * hr;             \
      __VA_ARGS__                                                                            \
    }

// Sums over a row of a product whose columns the two warpgroups split: this thread's two rows' values summed over
// its quad, then the warpgroups' sums added through xs (a block barrier), the first warpgroup's first: the same bits
// in both. xs alternates between two halves (`par`), so that a warpgroup ahead writes the next sums into the half
// nobody still reads.
template <int NV>
__device__ __forceinline__ void xsum(float (&v)[2][NV], float* xs, int& par) {
  const int tq = threadIdx.x & 3, r0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2), wg = threadIdx.x >> 7;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 1);
      v[h][k] += __shfl_xor_sync(0xffffffffu, v[h][k], 2);
    }
  if (blockDim.x == 128) return;  // one warpgroup: the row is whole in the quad
  float* buf = xs + par * (2 * TILE * 4);
  par ^= 1;
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < NV; ++k) buf[(wg * TILE + r0 + 8 * h) * 4 + k] = v[h][k];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < NV; ++k) v[h][k] = buf[(r0 + 8 * h) * 4 + k] + buf[(TILE + r0 + 8 * h) * 4 + k];
}
// mean and 1 / sqrt(var + eps) of `width` values from their sum and sum of squares (var = E[x^2] - E[x]^2).
__device__ __forceinline__ void moments(float s, float ss, int width, float& mean, float& rs) {
  mean = s / width;
  rs = 1.0f / sqrtf(ss / width - mean * mean + LN_EPS);
}

// The column sums over the 64 rows of a slab 2N wide that an epilogue makes: cv[2 j + e] this thread's two rows' sum
// in column cb + 8 j + 2 tq + e (its warpgroup's N columns from cb = wg N); summed over the warp's rows by shuffles,
// then over its warpgroup's four warps in order through cs ([2][4][N]); dst[n] (+)= the sum (first: store), n < 2N.
// Every thread calls it (two block barriers).
template <int N>
__device__ __forceinline__ void ncol_out(float (&cv)[N / 4], float* cs, float* dst, bool first) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    float v = cv[k];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    cv[k] = v;
  }
  __syncthreads();  // the last readers of cs are done
  if (lane < 4)
#pragma unroll
    for (int k = 0; k < N / 4; ++k) cs[(wg * 4 + warp) * N + 8 * (k >> 1) + 2 * lane + (k & 1)] = cv[k];
  __syncthreads();
  for (int i = threadIdx.x; i < (int)(blockDim.x >> 7) * N; i += blockDim.x) {
    const float* c = cs + (i / N) * 3 * N + i;  // warpgroup i / N's four warps at column i % N
    const float v = ((c[0] + c[N]) + c[2 * N]) + c[3 * N];
    dst[i] = first ? v : dst[i] + v;
  }
}
#define N_COL_ADD(cv, v0, v1) \
  {                           \
    (cv)[2 * j_] += (v0);     \
    (cv)[2 * j_ + 1] += (v1); \
  }

// A row contraction into a block-private partial: dst[(m0 + m) ld + n0 + n] (+)= sum over the 64 rows t of
// X[t][m0 + m] Y[t][n0 + n] for m < M - m0 (one m64 tile of X's columns), n < 2N (warpgroup wg's N columns from
// wg N); X in XP planes (64-row operands `xs` elements apart), Y in YP planes (`ys`), both read MN-major. The old
// values are loaded before they are stored, two columns a load (dst + ld and n0 on 8 bytes).
template <int N, int XP, int YP>
__device__ __forceinline__ void nrows_part(const bf16* X, int xs, int m0, int M, const bf16* Y, int ys, int n0,
                                           float* dst, int ld, bool first) {
  N_FRAG(N);
  float acc[N / 2];
  nmma<N, 1, 1, XP, YP>(acc, X + m0 * 64, 64, 128, xs, Y + n0 * 64, 64, 128, ys, 4);
  float2 old[N / 4];
  N_PAIRS(N / 8, {
    const int k = 2 * j_ + hr;
    old[k] = make_float2(0.0f, 0.0f);
    if (!first && m0 + r < M) old[k] = *reinterpret_cast<const float2*>(dst + (size_t)(m0 + r) * ld + n0 + col);
  })
  N_PAIRS(N / 8, {
    const int k = 2 * j_ + hr;
    if (m0 + r < M)
      *reinterpret_cast<float2*>(dst + (size_t)(m0 + r) * ld + n0 + col) = make_float2(old[k].x + acc[i], old[k].y + acc[i + 1]);
  })
}

// s_inv[t I + i] = inv[(c0 + t) I + i] of a latent's tile, zero past the last coordinate.
__device__ __forceinline__ void nload_inv(float* s_inv, const float* src, int rows, int I) {
  for (int idx = threadIdx.x; idx < TILE * I; idx += blockDim.x) s_inv[idx] = idx / I < rows ? src[idx] : 0.0f;
}
// F = [sin | cos](2 pi s_inv coeff) (fast_sincos) of the tile's 64 rows, W / 2 projections a row, in bf16.
__device__ __forceinline__ void nfeatures(const float* s_inv, int I, const float* __restrict__ coeff, int W, bf16* F) {
  const int half = W / 2, pairs = half / 2;
  for (int u = threadIdx.x; u < TILE * pairs; u += blockDim.x) {
    const int t = u / pairs, j = 2 * (u - t * pairs);
    float p0 = 0.0f, p1 = 0.0f;
    for (int k = 0; k < I; ++k) {
      const float xi = s_inv[t * I + k];
      p0 = fmaf(xi, __ldg(coeff + k * half + j), p0);
      p1 = fmaf(xi, __ldg(coeff + k * half + j + 1), p1);
    }
    float s0, k0, s1, k1;
    fast_sincos(p0, &s0, &k0);
    fast_sincos(p1, &s1, &k1);
    store2(F, t, j, s0, s1);
    store2(F, t, half + j, k0, k1);
  }
}
// dinv[t, i] (+)= sum_j (sin'_j dF[t, j] + cos'_j dF[t, half + j]) coeff[i, j] for t < rows (dF f32 [64][W]), the
// derivatives of fast_sincos's polynomials recomputed: a lane a projection j (half = W / 2 of them), a row's sums over
// its lanes by shuffles (rff_vjp's sums: the shuffles it adds past half lanes add zeros). Below half = 32 a warp takes
// 32 / half rows at once and interleaves the I sums (at hid 16 the RFF VJP's time fell by about half, PERF.md §6);
// at half = 32, a row a warp, a sum after another (interleaved they took longer there).
template <int W>
__device__ __forceinline__ void nrff_vjp(const float* s_inv, int I, const float* __restrict__ coeff, const float* dF,
                                         float* dinv, int rows, bool add) {
  constexpr int half = W / 2, per = 32 / half;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, j = lane % half;
  for (int t = warp * per + lane / half; t < TILE; t += (blockDim.x / 32) * per) {
    float proj = 0.0f;
    for (int i = 0; i < I; ++i) proj = fmaf(s_inv[t * I + i], __ldg(coeff + i * half + j), proj);
    float s, co, ds, dc;
    fast_sincos(proj, &s, &co, &ds, &dc);
    const float dproj = ds * dF[t * W + j] + dc * dF[t * W + half + j];
    if constexpr (per == 1) {
#pragma unroll
      for (int i = 0; i < MAX_I; ++i) {
        if (i >= I) break;
        const float sum = warp_sum(dproj * __ldg(coeff + i * half + j));
        if (lane == 0 && t < rows) dinv[t * I + i] = add ? dinv[t * I + i] + sum : sum;
      }
    } else {
      float acc[MAX_I];
#pragma unroll
      for (int i = 0; i < MAX_I; ++i) acc[i] = i < I ? dproj * __ldg(coeff + i * half + j) : 0.0f;
#pragma unroll
      for (int o = half / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < MAX_I; ++i)
          if (i < I) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (j == 0 && t < rows)
#pragma unroll
        for (int i = 0; i < MAX_I; ++i)
          if (i < I) dinv[t * I + i] = add ? dinv[t * I + i] + acc[i] : acc[i];
    }
  }
}
// `floats` floats from global memory into shared memory by 16-byte cp.async, one group (not waited for).
__device__ __forceinline__ void ncopy(void* dst, const float* src, int floats) {
  float* d = reinterpret_cast<float*>(dst);
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * blockDim.x) cp_async16(d + i, src + i);
  cp_async_commit();
}

// The weight images (`narrow_prep`): q_w1, v_w1, fw, m_w2, o_w, p_w1, p_w2, h_w1, h_w2, each K x N in op_index's
// layout with its K rows, at x_w[j] floats of the workspace.
enum { NI_Q = 0, NI_V, NI_F, NI_M, NI_O, NI_P1, NI_P2, NI_H1, NI_H2 };
__host__ __device__ inline void narrow_image_shape(const Dims& d, int j, int& K, int& N) {
  const int W = d.nw, HD = d.HD;
  const int k[9] = {W, W, W, W, HD, HD, HD, HD, W}, n[9] = {W, W, W, W, HD, HD, HD, W, W};
  K = k[j];
  N = n[j];
}

// Pass 0: the weight images and G [b, z] (K = hid rows, N = H hidm) in bf16, rounded to nearest.
__global__ void narrow_prep(const Params P) {
  const Dims& d = P.d;
  const float* src[9] = {P.q_w1, P.v_w1, P.fw, P.m_w2, P.o_w, P.p_w1, P.p_w2, P.h_w1, P.h_w2};
  bf16* out = reinterpret_cast<bf16*>(P.work);
  const int W = d.nw, HH = d.HH;
  const long long nimg = 2 * d.x_g, total = nimg + (long long)d.B * d.Z * W * HH;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += (long long)gridDim.x * blockDim.x) {
    int R, N, j = 0;
    const float* s;
    long long e;
    if (idx < nimg) {  // image j, the last whose start is at most idx
      for (int jj = 1; jj < d.n_img; ++jj)
        if (2 * d.x_w[jj] <= idx) j = jj;
      e = idx - 2 * d.x_w[j];
      narrow_image_shape(d, j, R, N);
      s = src[j];
    } else {
      const long long g = idx - nimg, per = (long long)W * HH;
      R = W;
      N = HH;
      s = P.G + (g / per) * per;
      e = g % per;
    }
    const int r = (int)(e / N), c = (int)(e % N);  // element e of the source, row-major: where the image holds it
    out[(idx < nimg ? 2 * d.x_w[j] : 2 * d.x_g + (idx - nimg - e)) + op_index(r, c, R)] = __float2bfloat16_rn(s[e]);
  }
}

// An item (b z, tile) of the per-latent kernels' plan: its row b z, batch row, tile, first coordinate and rows.
struct NItem {
  long long bz;
  int b, c0, rows, tile;
};
__device__ __forceinline__ NItem nitem(const Dims& d, long long item) {
  NItem it;
  it.bz = item / d.nt;
  it.tile = (int)(item % d.nt);
  it.b = (int)(it.bz / d.Z);
  it.c0 = it.tile * TILE;
  it.rows = min(TILE, d.C - it.c0);
  return it;
}
__device__ __forceinline__ float* wimg(const Params& P, int j) { return P.work + P.d.x_w[j]; }

// hq = relu(F q_w1 + q_b1) (or hv with v_w1, v_b1): the first layer of a latent's chain from its features.
template <int W>
__device__ __forceinline__ void nfirst(float (&acc)[ncols(W) / 2], const bf16* F, const bf16* Wt, const float* __restrict__ bias) {
  N_FRAG(ncols(W));
  nmma<ncols(W), 0, 1, 1, 1>(acc, F, 64, 1024, 0, Wt, W, 128, 0, W / 16);
  N_PAIRS(ncols(W) / 8, {
    acc[i] = fmaxf(acc[i] + __ldg(bias + col), 0.0f);
    acc[i + 1] = fmaxf(acc[i + 1] + __ldg(bias + col + 1), 0.0f);
  })
  (void)r0;
}

// 1. A latent's logits: hq . A[b, z] + ab + wb (A and hq rounded to bf16) into LG [b z][C padded][H], every row of
// the tile (the padded ones from zero invariants).
template <int W>
__global__ void __launch_bounds__(nthreads(W), nminb(W)) narrow_logits(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const NarrowLatent L = nl_layout(W, d.H);
  char* base = reinterpret_cast<char*>(smem);
  bf16 *Wq = reinterpret_cast<bf16*>(base + L.w1), *F = reinterpret_cast<bf16*>(base + L.f);
  float *s_inv = reinterpret_cast<float*>(base + L.inv), *xs = reinterpret_cast<float*>(base + L.xs);
  float* LG = P.work + d.x_lg;
  const int H = d.H;
  int par = 0;
  N_FRAG(ncols(W));
  ncopy(Wq, wimg(P, NI_Q), W * W / 2);
  const long long lo = (long long)blockIdx.x * d.ipb_l, hi = min(lo + d.ipb_l, d.items_l);
  for (long long item = lo; item < hi; ++item) {
    const NItem it = nitem(d, item);
    nload_inv(s_inv, P.inv + (it.bz * d.C + it.c0) * d.I, it.rows, d.I);
    __syncthreads();
    nfeatures(s_inv, d.I, P.q_coeff, W, F);
    cp_async_wait<0>();
    float acc[ncols(W) / 2];
    nfirst<W>(acc, F, Wq, P.q_b1);
    const float* Az = P.A + it.bz * W * H;
    for (int h = 0; h < H; ++h) {
      float lg[2][1] = {{0.0f}, {0.0f}};
      N_PAIRS(ncols(W) / 8, {
        lg[hr][0] = fmaf(bf16_round(acc[i]), bf16_round(__ldg(Az + (col) * H + h)), lg[hr][0]);
        lg[hr][0] = fmaf(bf16_round(acc[i + 1]), bf16_round(__ldg(Az + (col + 1) * H + h)), lg[hr][0]);
      })
      xsum<1>(lg, xs, par);
      if (tq == 0 && cb == 0)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          const float w = r < it.rows ? __ldg(P.wb + it.bz * d.C + it.c0 + r) : 0.0f;
          LG[(it.bz * d.cp + it.c0 + r) * H + h] = lg[hr][0] + __ldg(P.ab + it.bz * H + h) + w;
        }
    }
  }
}

// u = hv fw + fb from HV: the value chain's second layer.
template <int W>
__device__ __forceinline__ void nsecond(float (&acc)[ncols(W) / 2], const Params& P, const bf16* HV, const bf16* Wf) {
  N_FRAG(ncols(W));
  nmma<ncols(W), 0, 1, 1, 1>(acc, HV, 64, 1024, 0, Wf, W, 128, 0, W / 16);
  N_PAIRS(ncols(W) / 8, {
    acc[i] += __ldg(P.fb + col);
    acc[i + 1] += __ldg(P.fb + col + 1);
  })
  (void)r0;
}
// The value chain of a latent up to G's product: hv = relu(F v_w1 + v_b1) into HV, u = hv fw + fb, t =
// normalize(gelu(u)) into T.
template <int W>
__device__ __forceinline__ void nvalue_chain(const Params& P, const bf16* F, const bf16* Wv, const bf16* Wf, bf16* HV,
                                             bf16* T, float* xs, int& par) {
  N_FRAG(ncols(W));
  float acc[ncols(W) / 2];
  nfirst<W>(acc, F, Wv, P.v_b1);
  N_PAIRS(ncols(W) / 8, store2(HV, r, col, acc[i], acc[i + 1]);)
  nsecond<W>(acc, P, HV, Wf);
  float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  N_PAIRS(ncols(W) / 8, {
    const float x0 = ngelu(acc[i]), x1 = ngelu(acc[i + 1]);
    acc[i] = x0;
    acc[i + 1] = x1;
    v[hr][0] += x0 + x1;
    v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
  })
  xsum<2>(v, xs, par);
  float mean[2], rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) moments(v[h][0], v[h][1], W, mean[h], rs[h]);
  N_PAIRS(ncols(W) / 8, store2(T, r, col, (acc[i] - mean[hr]) * rs[hr], (acc[i + 1] - mean[hr]) * rs[hr]);)
}

// 2. The softmax over latents of the tile's rows (every latent's logits, in latent order; this item's weights into
// Pz [b z][C padded][H]), then the latent's value chain: nn = normalize(gelu(t G[b, z] + c)) a head, in bf16, into
// NN [b z][C padded][H hidm].
template <int W>
__global__ void __launch_bounds__(nthreads(W), nminb(W)) narrow_values(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int H = d.H, Z = d.Z, HH = d.HH;
  const NarrowLatent L = nl_layout(W, H);
  char* base = reinterpret_cast<char*>(smem);
  bf16 *Wv = reinterpret_cast<bf16*>(base + L.w1), *Wf = reinterpret_cast<bf16*>(base + L.w2);
  bf16 *GB = reinterpret_cast<bf16*>(base + L.gb), *F = reinterpret_cast<bf16*>(base + L.f);
  bf16 *HV = reinterpret_cast<bf16*>(base + L.hv), *T = reinterpret_cast<bf16*>(base + L.t);
  float *s_inv = reinterpret_cast<float*>(base + L.inv), *xs = reinterpret_cast<float*>(base + L.xs);
  const float *LG = P.work + d.x_lg;
  float* Pz = P.work + d.x_p;
  __nv_bfloat162* NN = reinterpret_cast<__nv_bfloat162*>(P.work + d.x_nn);
  int par = 0;
  N_FRAG(ncols(W));
  ncopy(Wv, wimg(P, NI_V), W * W / 2);
  ncopy(Wf, wimg(P, NI_F), W * W / 2);
  const long long lo = (long long)blockIdx.x * d.ipb_l, hi = min(lo + d.ipb_l, d.items_l);
  for (long long item = lo; item < hi; ++item) {
    const NItem it = nitem(d, item);
    ncopy(GB, P.work + d.x_g + it.bz * W * HH / 2, W * HH / 2);
    const long long row0 = (long long)it.b * Z * d.cp + it.c0;  // latent 0's first row of the tile
    for (int idx = threadIdx.x; idx < TILE * H; idx += blockDim.x) {
      const int r = idx / H, h = idx - r * H;
      float m = -INFINITY;
#pragma unroll 8
      for (int z = 0; z < Z; ++z) m = fmaxf(m, LG[(row0 + (long long)z * d.cp + r) * H + h]);
      float sum = 0.0f;
#pragma unroll 8
      for (int z = 0; z < Z; ++z) sum += expf(LG[(row0 + (long long)z * d.cp + r) * H + h] - m);
      Pz[(it.bz * d.cp + it.c0 + r) * H + h] = expf(LG[(it.bz * d.cp + it.c0 + r) * H + h] - m) / sum;
    }
    nload_inv(s_inv, P.inv + (it.bz * d.C + it.c0) * d.I, it.rows, d.I);
    __syncthreads();
    nfeatures(s_inv, d.I, P.v_coeff, W, F);
    cp_async_wait<0>();
    nvalue_chain<W>(P, F, Wv, Wf, HV, T, xs, par);
    for (int h = 0; h < H; ++h) {
      float acc[ncols(W) / 2];
      nmma<ncols(W), 0, 1, 1, 1>(acc, T, 64, 1024, 0, GB + h * W * W, W, 128, 0, W / 16);
      float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
      const float* cz = P.c + it.bz * HH + h * W;
      N_PAIRS(ncols(W) / 8, {
        const float x0 = ngelu(acc[i] + __ldg(cz + col)), x1 = ngelu(acc[i + 1] + __ldg(cz + col + 1));
        acc[i] = x0;
        acc[i + 1] = x1;
        v[hr][0] += x0 + x1;
        v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
      })
      xsum<2>(v, xs, par);
      float mean[2], rs[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) moments(v[k][0], v[k][1], W, mean[k], rs[k]);
      N_PAIRS(ncols(W) / 8, {
        NN[((it.bz * d.cp + it.c0 + r) * HH + h * W + col) / 2] =
            __floats2bfloat162_rn((acc[i] - mean[hr]) * rs[hr], (acc[i + 1] - mean[hr]) * rs[hr]);
      })
    }
  }
}

// 3. A (b, tile) item: psum = sum_z bf16(p_z) and nbar = sum_z bf16(p_z) nn_z (latent order; three planes), the
// tail forward (y = nbar m_w2 + psum m_b2 a head, y1, t1 = normalize(gelu(q1)) over H D, y2 = gelu(q2), h1 =
// gelu(q3), h2 = gelu(q4)) and its VJP from g (every input gradient dX = bf16(dY W^T), each cotangent in three
// planes; q1, gelu'(q2), gelu'(q3) in the block's workspace, read back by the thread that wrote them), with weight
// gradients each row contraction after its cotangent (the activation's image copied back from the workspace into
// X2) and the bias sums in the cotangents' epilogues; then the mixer's VJP: <dy_h, m_b2> into DYB [b][C padded][H],
// dm_b2 and dm_w2 a head (nbar's planes copied back), e_h = dy_h m_w2^T (f32) into E [b][C padded][H hidm]. The
// weights are streamed through two buffers in the order the products read them (`seq`), each copied while the
// product before it runs.
template <int W, bool TAIL>
__global__ void __launch_bounds__(nthreads(W), nminb(W)) narrow_tail(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int H = d.H, Z = d.Z, HH = d.HH, HD = d.HD, od = d.out;
  const NarrowTail L = nt_layout(W, H);
  char* base = reinterpret_cast<char*>(smem);
  bf16* WB[2] = {reinterpret_cast<bf16*>(base + L.wb), reinterpret_cast<bf16*>(base + L.wb + (L.pa - L.wb) / 2)};
  bf16 *PA = reinterpret_cast<bf16*>(base + L.pa), *PB = reinterpret_cast<bf16*>(base + L.pb);
  bf16 *X1 = reinterpret_cast<bf16*>(base + L.x1), *X2 = reinterpret_cast<bf16*>(base + L.x2);
  bf16* DT = reinterpret_cast<bf16*>(base + L.dt);
  float *psum = reinterpret_cast<float*>(base + L.psum), *cs = reinterpret_cast<float*>(base + L.cs);
  float* xs = reinterpret_cast<float*>(base + L.xs);
  int par = 0;
  const int PS = TILE * L.pc;          // elements between the planes of PA / PB
  const int XE = TILE * L.xc / 2;      // floats of an activation's image
  float* ws = P.work + d.x_t + (size_t)blockIdx.x * d.t_ws;
  float *Q1 = ws + d.t_q1, *G2 = ws + d.t_g2, *G3 = ws + d.t_g3;
  auto img = [&](int k) { return ws + d.t_img + (size_t)k * XE; };  // y, y1, t1, y2
  float* nbimg = ws + d.t_nb;
  const float *Pz = P.work + d.x_p;
  const __nv_bfloat162* NN = reinterpret_cast<const __nv_bfloat162*>(P.work + d.x_nn);
  float *E = P.work + d.x_ee, *DYB = P.work + d.x_dyb;
  float* pw = P.part + (size_t)d.grid_l * d.part_l + (size_t)blockIdx.x * d.part_t;
  const bool wgr = d.wgrad;
  constexpr bool tail = TAIL;  // a constant: no product on a branch ptxas cannot prove uniform (it would serialize
                               // their wgmma, C7520)
  N_FRAG(ncols(W));
  // The weights in the order the products read them: forward m_w2, o_w, p_w1, p_w2, h_w1, h_w2, then the VJP's
  // h_w2 ... m_w2; m_w2 alone without the tail.
  const int seq[12] = {NI_M, NI_O, NI_P1, NI_P2, NI_H1, NI_H2, NI_H2, NI_H1, NI_P2, NI_P1, NI_O, NI_M};
  const int nseq = tail ? 12 : 1;
  auto wcopy = [&](int k) {  // weight k of seq into buffer k % 2 (an empty group past the end)
    if (k < nseq) {
      int K, N;
      narrow_image_shape(d, seq[k], K, N);
      float* dst = reinterpret_cast<float*>(WB[k & 1]);
      const float* src = wimg(P, seq[k]);
      for (int i = 4 * threadIdx.x; i < K * N / 2; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  auto wready = [&]() { cp_async_wait<1>(); };  // this thread's copies of all but the newest group have landed
  auto reload = [&](bf16* dst, const float* src, int floats) {  // an image back into shared memory, landed
    ncopy(dst, src, floats);
    cp_async_wait<0>();
  };
  constexpr int NJ = ncols(W) / 8;
  const long long lo = (long long)blockIdx.x * d.ipb_t, hi = min(lo + d.ipb_t, d.items_t);
  for (long long item = lo; item < hi; ++item) {
    const int b = (int)(item / d.nt), c0 = (int)(item % d.nt) * TILE, rows = min(TILE, d.C - c0);
    const bool first = item == lo;
    const long long row0 = (long long)b * Z * d.cp + c0;  // latent 0's first row of the tile
    const float* gsrc = P.g + ((size_t)b * d.C + c0) * od;
    wcopy(0);
    wcopy(1);
    // psum and nbar's three planes in PA (and their image with weight gradients).
    for (int idx = threadIdx.x; idx < TILE * H; idx += blockDim.x) {
      const int rr = idx / H, h = idx - rr * H;
      float s = 0.0f;
#pragma unroll 8
      for (int z = 0; z < Z; ++z) s += bf16_round(Pz[(row0 + (long long)z * d.cp + rr) * H + h]);
      psum[idx] = s;
    }
    constexpr int NB = 4;  // pairs of nbar a thread sums at once, every latent's loads of them in flight together
    for (int i0 = threadIdx.x; i0 < TILE * HH / 2; i0 += NB * blockDim.x) {
      float v[NB][2];
      int rr[NB], hh[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int idx = min(i0 + k * (int)blockDim.x, TILE * HH / 2 - 1);
        rr[k] = idx / (HH / 2);
        hh[k] = 2 * (idx - rr[k] * (HH / 2));
      }
#pragma unroll 2
      for (int z = 0; z < Z; ++z) {
        float p[NB];
        float2 nn[NB];
        const long long rz = row0 + (long long)z * d.cp;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          p[k] = Pz[(rz + rr[k]) * H + hh[k] / W];
          nn[k] = __bfloat1622float2(NN[((rz + rr[k]) * HH + hh[k]) / 2]);
        }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const float q = bf16_round(p[k]);
          v[k][0] = z ? v[k][0] + q * nn[k].x : q * nn[k].x;
          v[k][1] = z ? v[k][1] + q * nn[k].y : q * nn[k].y;
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (i0 + k * (int)blockDim.x >= TILE * HH / 2) break;
        store3(PA, PS, rr[k], hh[k], v[k][0], v[k][1]);
        if (wgr) store3(reinterpret_cast<bf16*>(nbimg), PS, rr[k], hh[k], v[k][0], v[k][1]);
      }
    }
    const bf16* DY;  // dy: one plane in DT (the tail's), or three in PB (g)
    int dyp;
    float acc[ncols(W) / 2];
    if (tail) {
      wready();  // m_w2
      for (int h = 0; h < H; ++h) {  // y = nbar m_w2 + psum m_b2 a head, into X1
        nmma<ncols(W), 0, 1, 3, 1>(acc, PA + h * W * 64, 64, 1024, PS, WB[0], W, 128, 0, W / 16);
        const float q[2] = {psum[r0 * H + h], psum[(r0 + 8) * H + h]};
        N_PAIRS(NJ, {
          const float y0 = fmaf(q[hr], __ldg(P.m_b2 + col), acc[i]), y1 = fmaf(q[hr], __ldg(P.m_b2 + col + 1), acc[i + 1]);
          store2(X1, r, h * W + col, y0, y1);
          if (wgr) store2(reinterpret_cast<bf16*>(img(0)), r, h * W + col, y0, y1);
        })
      }
      wcopy(2);
      wready();  // o_w
      for (int s = 0; s < H; ++s) {  // y1 = y o_w + o_b, into X2
        nmma<ncols(W), 0, 1, 1, 1>(acc, X1, 64, 1024, 0, WB[1] + s * W * HD, HD, 128, 0, HD / 16);
        N_PAIRS(NJ, {
          const int n = s * W + col;
          const float a0 = acc[i] + __ldg(P.o_b + n), a1 = acc[i + 1] + __ldg(P.o_b + n + 1);
          store2(X2, r, n, a0, a1);
          if (wgr) store2(reinterpret_cast<bf16*>(img(1)), r, n, a0, a1);
        })
      }
      wcopy(3);
      wready();  // p_w1
      {  // q1 = y1 p_w1 + p_b1 (into Q1); t1 = normalize(gelu(q1)) over H D, into X1
        float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        for (int s = 0; s < H; ++s) {
          nmma<ncols(W), 0, 1, 1, 1>(acc, X2, 64, 1024, 0, WB[0] + s * W * HD, HD, 128, 0, HD / 16);
          N_PAIRS(NJ, {
            const int n = s * W + col;
            const float qa = acc[i] + __ldg(P.p_b1 + n), qb = acc[i + 1] + __ldg(P.p_b1 + n + 1);
            __stcg(reinterpret_cast<float2*>(Q1 + r * HD + n), make_float2(qa, qb));
            const float x0 = ngelu(qa), x1 = ngelu(qb);
            v[hr][0] += x0 + x1;
            v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
          })
        }
        xsum<2>(v, xs, par);
        float mean[2], rs[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) moments(v[k][0], v[k][1], HD, mean[k], rs[k]);
        for (int s = 0; s < H; ++s)
          N_PAIRS(NJ, {
            const int n = s * W + col;
            const float2 q = __ldcg(reinterpret_cast<const float2*>(Q1 + r * HD + n));
            const float t0 = (ngelu(q.x) - mean[hr]) * rs[hr], t1 = (ngelu(q.y) - mean[hr]) * rs[hr];
            store2(X1, r, n, t0, t1);
            if (wgr) store2(reinterpret_cast<bf16*>(img(2)), r, n, t0, t1);
          })
      }
      wcopy(4);
      wready();  // p_w2
      for (int s = 0; s < H; ++s) {  // q2 = t1 p_w2 + p_b2; y2 = gelu(q2) into X2, gelu'(q2) into G2
        nmma<ncols(W), 0, 1, 1, 1>(acc, X1, 64, 1024, 0, WB[1] + s * W * HD, HD, 128, 0, HD / 16);
        N_PAIRS(NJ, {
          const int n = s * W + col;
          const float2 g0 = ngelu2(acc[i] + __ldg(P.p_b2 + n)), g1 = ngelu2(acc[i + 1] + __ldg(P.p_b2 + n + 1));
          store2(X2, r, n, g0.x, g1.x);
          if (wgr) store2(reinterpret_cast<bf16*>(img(3)), r, n, g0.x, g1.x);
          __stcg(reinterpret_cast<float2*>(G2 + r * HD + n), make_float2(g0.y, g1.y));
        })
      }
      wcopy(5);
      wready();  // h_w1: q3 = y2 h_w1 + h_b1; h1 = gelu(q3) into X1, gelu'(q3) into G3
      nmma<ncols(W), 0, 1, 1, 1>(acc, X2, 64, 1024, 0, WB[0], HD, 128, 0, HD / 16);
      N_PAIRS(NJ, {
        const float2 g0 = ngelu2(acc[i] + __ldg(P.h_b1 + col)), g1 = ngelu2(acc[i + 1] + __ldg(P.h_b1 + col + 1));
        store2(X1, r, col, g0.x, g1.x);
        __stcg(reinterpret_cast<float2*>(G3 + r * W + col), make_float2(g0.y, g1.y));
      })
      wcopy(6);
      wready();  // h_w2: q4 = h1 h_w2 + h_b2; h2 = gelu(q4) (into X2 with weight gradients); dq4 = dh2 gelu'(q4),
                 // dh2 = bf16(g h_w3^T) on the CUDA cores, three planes in PB
      nmma<ncols(W), 0, 1, 1, 1>(acc, X1, 64, 1024, 0, WB[1], W, 128, 0, W / 16);
      {
        float cv[ncols(W) / 4] = {};
        N_PAIRS(NJ, {
          const float2 g0 = ngelu2(acc[i] + __ldg(P.h_b2 + col)), g1 = ngelu2(acc[i + 1] + __ldg(P.h_b2 + col + 1));
          float s0 = 0.0f, s1 = 0.0f;
          if (r < rows)
            for (int o = 0; o < od; ++o) {
              const float gg = __ldg(gsrc + r * od + o);
              s0 = fmaf(gg, bf16_round(__ldg(P.h_w3 + col * od + o)), s0);
              s1 = fmaf(gg, bf16_round(__ldg(P.h_w3 + (col + 1) * od + o)), s1);
            }
          const float q0 = bf16_round(s0) * g0.y, q1 = bf16_round(s1) * g1.y;
          store3(PB, PS, r, col, q0, q1);
          N_COL_ADD(cv, q0, q1);
          if (wgr) store2(X2, r, col, g0.x, g1.x);
        })
        wcopy(7);
        if (wgr) {
          __syncthreads();  // h2
          float* dw = pw + d.tw_off[18];
          for (int idx = threadIdx.x; idx < W * od; idx += blockDim.x) {  // dh_w3 = h2^T g, dh_b3 = sum g
            const int k = idx / od, o = idx - k * od;
            float s = 0.0f;
            for (int t = 0; t < rows; ++t) s = fmaf(__bfloat162float(X2[a16_index(t, k)]), __ldg(gsrc + t * od + o), s);
            dw[idx] = first ? s : dw[idx] + s;
          }
          for (int o = threadIdx.x; o < od; o += blockDim.x) {
            float s = 0.0f;
            for (int t = 0; t < rows; ++t) s += __ldg(gsrc + t * od + o);
            pw[d.tw_off[19] + o] = first ? s : pw[d.tw_off[19] + o] + s;
          }
          ncol_out<ncols(W)>(cv, cs, pw + d.tw_off[17], first);                               // dh_b2
          nrows_part<ncols(W), 1, 3>(X1, 0, 0, W, PB, PS, 0, pw + d.tw_off[16], W, first);  // dh_w2 = h1^T dq4
        }
      }
      wready();  // h_w2: dh1 = bf16(dq4 h_w2^T); dq3 = dh1 gelu'(q3), three planes in PA
      nmma<ncols(W), 0, 0, 3, 1>(acc, PB, 64, 1024, PS, WB[0], W, W * 16, 0, W / 16);
      {
        float cv[ncols(W) / 4] = {};
        N_PAIRS(NJ, {
          const float2 gd = __ldcg(reinterpret_cast<const float2*>(G3 + r * W + col));
          const float q0 = bf16_round(acc[i]) * gd.x, q1 = bf16_round(acc[i + 1]) * gd.y;
          store3(PA, PS, r, col, q0, q1);
          N_COL_ADD(cv, q0, q1);
        })
        wcopy(8);
        if (wgr) {
          ncol_out<ncols(W)>(cv, cs, pw + d.tw_off[15], first);  // dh_b1
          reload(X2, img(3), XE);                          // dh_w1 = y2^T dq3
          for (int m0 = 0; m0 < HD; m0 += 64) nrows_part<ncols(W), 1, 3>(X2, 0, m0, HD, PA, PS, 0, pw + d.tw_off[14], W, first);
        }
      }
      wready();  // h_w1: dy2 = bf16(dq3 h_w1^T); dq2 = dy2 gelu'(q2), three planes in PB
      for (int s = 0; s < H; ++s) {
        nmma<ncols(W), 0, 0, 3, 1>(acc, PA, 64, 1024, PS, WB[1] + s * W * 8, HD, HD * 16, 0, W / 16);
        float cv[ncols(W) / 4] = {};
        N_PAIRS(NJ, {
          const int n = s * W + col;
          const float2 gd = __ldcg(reinterpret_cast<const float2*>(G2 + r * HD + n));
          const float q0 = bf16_round(acc[i]) * gd.x, q1 = bf16_round(acc[i + 1]) * gd.y;
          store3(PB, PS, r, n, q0, q1);
          N_COL_ADD(cv, q0, q1);
        })
        if (wgr) ncol_out<ncols(W)>(cv, cs, pw + d.tw_off[13] + s * W, first);  // dp_b2
      }
      wcopy(9);
      if (wgr) {  // dp_w2 = t1^T dq2
        reload(X2, img(2), XE);
        for (int m0 = 0; m0 < HD; m0 += 64)
          for (int s = 0; s < H; ++s) nrows_part<ncols(W), 1, 3>(X2, 0, m0, HD, PB, PS, s * W, pw + d.tw_off[12], HD, first);
      }
      wready();  // p_w2: dt1 = bf16(dq2 p_w2^T) (into DT); dq1 by the LayerNorm-gelu VJP over H D, three planes in PA
      {
        float v[2][4] = {};
        for (int s = 0; s < H; ++s) {
          nmma<ncols(W), 0, 0, 3, 1>(acc, PB, 64, 1024, PS, WB[0] + s * W * 8, HD, HD * 16, 0, HD / 16);
          N_PAIRS(NJ, {
            const int n = s * W + col;
            const float2 q = __ldcg(reinterpret_cast<const float2*>(Q1 + r * HD + n));
            const float x0 = ngelu(q.x), x1 = ngelu(q.y);
            const float d0 = bf16_round(acc[i]), d1 = bf16_round(acc[i + 1]);
            store2(DT, r, n, d0, d1);
            v[hr][0] += x0 + x1;
            v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
            v[hr][2] += d0 + d1;
            v[hr][3] = fmaf(d0, x0, fmaf(d1, x1, v[hr][3]));
          })
        }
        wcopy(10);
        xsum<4>(v, xs, par);
        float mean[2], rs[2], md[2], mdn[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          moments(v[k][0], v[k][1], HD, mean[k], rs[k]);
          md[k] = v[k][2] / HD;
          mdn[k] = rs[k] * (v[k][3] - mean[k] * v[k][2]) / HD;
        }
        for (int s = 0; s < H; ++s) {
          float cv[ncols(W) / 4] = {};
          N_PAIRS(NJ, {
            const int n = s * W + col;
            const float2 q = __ldcg(reinterpret_cast<const float2*>(Q1 + r * HD + n));
            const float2 dd = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(DT + a16_index(r, n)));
            const float2 g0 = ngelu2(q.x), g1 = ngelu2(q.y);
            const float m0 = (g0.x - mean[hr]) * rs[hr], m1 = (g1.x - mean[hr]) * rs[hr];
            const float q0 = rs[hr] * (dd.x - md[hr] - m0 * mdn[hr]) * g0.y;
            const float q1 = rs[hr] * (dd.y - md[hr] - m1 * mdn[hr]) * g1.y;
            store3(PA, PS, r, n, q0, q1);
            N_COL_ADD(cv, q0, q1);
          })
          if (wgr) ncol_out<ncols(W)>(cv, cs, pw + d.tw_off[11] + s * W, first);  // dp_b1
        }
      }
      if (wgr) {  // dp_w1 = y1^T dq1
        reload(X2, img(1), XE);
        for (int m0 = 0; m0 < HD; m0 += 64)
          for (int s = 0; s < H; ++s) nrows_part<ncols(W), 1, 3>(X2, 0, m0, HD, PA, PS, s * W, pw + d.tw_off[10], HD, first);
      }
      wready();  // p_w1: dy1 = bf16(dq1 p_w1^T), into X1
      for (int s = 0; s < H; ++s) {
        nmma<ncols(W), 0, 0, 3, 1>(acc, PA, 64, 1024, PS, WB[1] + s * W * 8, HD, HD * 16, 0, HD / 16);
        float cv[ncols(W) / 4] = {};
        N_PAIRS(NJ, {
          const float q0 = bf16_round(acc[i]), q1 = bf16_round(acc[i + 1]);
          store2(X1, r, s * W + col, q0, q1);
          N_COL_ADD(cv, q0, q1);
        })
        if (wgr) ncol_out<ncols(W)>(cv, cs, pw + d.tw_off[9] + s * W, first);  // do_b
      }
      wcopy(11);
      if (wgr) {  // do_w = y^T dy1 (dy1 is bf16: one plane)
        reload(X2, img(0), XE);
        for (int m0 = 0; m0 < HD; m0 += 64)
          for (int s = 0; s < H; ++s) nrows_part<ncols(W), 1, 1>(X2, 0, m0, HD, X1, 0, s * W, pw + d.tw_off[8], HD, first);
      }
      wready();  // o_w: dy = bf16(dy1 o_w^T), into DT
      for (int s = 0; s < H; ++s) {
        nmma<ncols(W), 0, 0, 1, 1>(acc, X1, 64, 1024, 0, WB[0] + s * W * 8, HD, HD * 16, 0, HD / 16);
        N_PAIRS(NJ, store2(DT, r, s * W + col, acc[i], acc[i + 1]);)
      }
      wcopy(12);
      DY = DT;
      dyp = 1;
    } else {
      for (int idx = threadIdx.x; idx < TILE * HD / 2; idx += blockDim.x) {  // dy = g, three planes in PB
        const int rr = idx / (HD / 2), n = 2 * (idx - rr * (HD / 2));
        const float v0 = rr < rows ? __ldg(gsrc + rr * HD + n) : 0.0f, v1 = rr < rows ? __ldg(gsrc + rr * HD + n + 1) : 0.0f;
        store3(PB, PS, rr, n, v0, v1);
      }
      DY = PB;
      dyp = 3;
    }
    // The mixer's VJP.
    const int dps = dyp == 3 ? PS : 0;
    __syncthreads();  // dy
    auto dyv = [&](int t, int n) {
      const int i = a16_index(t, n);
      float v = __bfloat162float(DY[i]);
      for (int p = 1; p < dyp; ++p) v += __bfloat162float(DY[i + p * dps]);
      return v;
    };
    for (int idx = threadIdx.x; idx < TILE * H; idx += blockDim.x) {  // <dy_h, m_b2>
      const int t = idx / H, h = idx - t * H;
      float s = 0.0f;
      for (int n = 0; n < W; ++n) s = fmaf(dyv(t, h * W + n), __ldg(P.m_b2 + n), s);
      DYB[((long long)b * d.cp + c0 + t) * H + h] = s;
    }
    if (wgr) {
      for (int n = threadIdx.x; n < W; n += blockDim.x) {  // dm_b2 = sum psum dy
        float s = 0.0f;
        for (int t = 0; t < TILE; ++t)
          for (int h = 0; h < H; ++h) s = fmaf(psum[t * H + h], dyv(t, h * W + n), s);
        pw[d.tw_off[7] + n] = first ? s : pw[d.tw_off[7] + n] + s;
      }
      if (tail) reload(PA, nbimg, 3 * PS / 2);  // nbar's planes
      for (int h = 0; h < H; ++h) {  // dm_w2 = nbar_h^T dy_h, each head's own partial
        float* dst = pw + d.tw_off[6] + (size_t)h * W * W;
        if (tail)
          nrows_part<ncols(W), 3, 1>(PA + h * W * 64, PS, 0, W, DY + h * W * 64, 0, 0, dst, W, first);
        else
          nrows_part<ncols(W), 3, 3>(PA + h * W * 64, PS, 0, W, DY + h * W * 64, PS, 0, dst, W, first);
      }
    }
    wready();  // m_w2: e_h = dy_h m_w2^T, not rounded
    bf16* WM = WB[tail ? 1 : 0];
    for (int h = 0; h < H; ++h) {
      if (tail)
        nmma<ncols(W), 0, 0, 1, 1>(acc, DY + h * W * 64, 64, 1024, 0, WM, W, W * 16, 0, W / 16);
      else
        nmma<ncols(W), 0, 0, 3, 1>(acc, DY + h * W * 64, 64, 1024, PS, WM, W, W * 16, 0, W / 16);
      N_PAIRS(NJ, __stcg(reinterpret_cast<float2*>(E + ((long long)b * d.cp + c0 + r) * HH + h * W + col), make_float2(acc[i], acc[i + 1]));)
    }
  }
}

// 4. A latent's value chain again, then its VJP: in each head's G epilogue dn = bf16(bf16(p) e), dp = bf16(<e, bf16(n)>
// + <dy, m_b2>) (into DP [b z][C padded][H]) and dpre (three planes in PL), dc; dG = t^T dpre; dt = bf16(dpre G^T)
// and du by the LayerNorm-gelu VJP in its epilogue; dfw, dfb; dhv = bf16(du fw^T)
// where hv > 0; dv_w1, dv_b1; dF = bf16(dhv v_w1^T) and the RFF VJP into dinv. u is taken again (hv fw + fb) for
// du: a product of the block's own, no workspace.
template <int W>
__global__ void __launch_bounds__(nthreads(W), nminb(W)) narrow_value_vjp(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int H = d.H, HH = d.HH;
  const NarrowLatent L = nl_layout(W, H);
  char* base = reinterpret_cast<char*>(smem);
  bf16 *Wv = reinterpret_cast<bf16*>(base + L.w1), *Wf = reinterpret_cast<bf16*>(base + L.w2);
  bf16 *GB = reinterpret_cast<bf16*>(base + L.gb), *F = reinterpret_cast<bf16*>(base + L.f);
  bf16 *HV = reinterpret_cast<bf16*>(base + L.hv), *T = reinterpret_cast<bf16*>(base + L.t);
  bf16* PL = reinterpret_cast<bf16*>(base + L.pl);  // dpre [3][64][H W]; then du [3][64][W], dhv [64][W], dF f32 [64][W]
  bf16 *DU = PL, *DHV = PL + 3 * TILE * W;
  float* DF = reinterpret_cast<float*>(PL + 4 * TILE * W);
  float *s_inv = reinterpret_cast<float*>(base + L.inv), *sp = reinterpret_cast<float*>(base + L.sp);
  float *cs = reinterpret_cast<float*>(base + L.cs), *xs = reinterpret_cast<float*>(base + L.xs);
  const int PLS = TILE * HH, DUS = TILE * W;
  int par = 0;
  const float *Pz = P.work + d.x_p, *E = P.work + d.x_ee, *DYB = P.work + d.x_dyb;
  float* DP = P.work + d.x_dp;
  float* pb = P.part + (size_t)blockIdx.x * d.part_l;
  float* pw = pb + (size_t)d.slots * d.lr_row;
  const bool wgr = d.wgrad;
  constexpr int NJ = ncols(W) / 8;
  N_FRAG(ncols(W));
  ncopy(Wv, wimg(P, NI_V), W * W / 2);
  ncopy(Wf, wimg(P, NI_F), W * W / 2);
  const long long lo = (long long)blockIdx.x * d.ipb_l, hi = min(lo + d.ipb_l, d.items_l);
  const long long bz_first = lo / d.nt;
  for (long long item = lo; item < hi; ++item) {
    const NItem it = nitem(d, item);
    const bool first_row = item == lo || it.tile == 0, first_w = item == lo;
    float* pr = pb + (size_t)(it.bz - bz_first) * d.lr_row;
    float *pG = pr + d.lr_A + d.lr_ab, *pc = pG + d.lr_G;
    ncopy(GB, P.work + d.x_g + it.bz * W * HH / 2, W * HH / 2);
    const long long row = it.bz * d.cp + it.c0, brow = (long long)it.b * d.cp + it.c0;
    for (int idx = threadIdx.x; idx < TILE * H; idx += blockDim.x) sp[idx] = Pz[row * H + idx];
    nload_inv(s_inv, P.inv + (it.bz * d.C + it.c0) * d.I, it.rows, d.I);
    __syncthreads();
    nfeatures(s_inv, d.I, P.v_coeff, W, F);
    cp_async_wait<0>();
    nvalue_chain<W>(P, F, Wv, Wf, HV, T, xs, par);
    float acc[ncols(W) / 2];
    for (int h = 0; h < H; ++h) {  // pre = t G + c; dpre, dp and dc of head h
      nmma<ncols(W), 0, 1, 1, 1>(acc, T, 64, 1024, 0, GB + h * W * W, W, 128, 0, W / 16);
      const float* cz = P.c + it.bz * HH + h * W;
      float v[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, gd[ncols(W) / 2];  // gelu into acc, gelu' into gd
      float2 ev[ncols(W) / 4];                                          // e of this thread's pairs
      N_PAIRS(NJ, {
        ev[2 * j_ + hr] = __ldcg(reinterpret_cast<const float2*>(E + (brow + r) * HH + h * W + col));
        const float2 g0 = ngelu2(acc[i] + __ldg(cz + col)), g1 = ngelu2(acc[i + 1] + __ldg(cz + col + 1));
        acc[i] = g0.x;
        acc[i + 1] = g1.x;
        gd[i] = g0.y;
        gd[i + 1] = g1.y;
        v[hr][0] += g0.x + g1.x;
        v[hr][1] = fmaf(g0.x, g0.x, fmaf(g1.x, g1.x, v[hr][1]));
      })
      xsum<2>(v, xs, par);
      float mean[2], rs[2], pz[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        moments(v[k][0], v[k][1], W, mean[k], rs[k]);
        pz[k] = bf16_round(sp[(r0 + 8 * k) * H + h]);
      }
      float w[2][3] = {};  // sums of e bf16(n), dn and dn n
      N_PAIRS(NJ, {
        const float2 e = ev[2 * j_ + hr];
        const float m0 = (acc[i] - mean[hr]) * rs[hr], m1 = (acc[i + 1] - mean[hr]) * rs[hr];
        const float d0 = bf16_round(e.x * pz[hr]), d1 = bf16_round(e.y * pz[hr]);
        w[hr][0] = fmaf(e.x, bf16_round(m0), fmaf(e.y, bf16_round(m1), w[hr][0]));
        w[hr][1] += d0 + d1;
        w[hr][2] = fmaf(d0, m0, fmaf(d1, m1, w[hr][2]));
      })
      xsum<3>(w, xs, par);
      if (tq == 0 && cb == 0)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int t = r0 + 8 * k;
          DP[(row + t) * H + h] = bf16_round(w[k][0] + __ldcg(DYB + (brow + t) * H + h));
        }
      float cv[ncols(W) / 4] = {};
      N_PAIRS(NJ, {
        const float2 e = ev[2 * j_ + hr];
        const float m0 = (acc[i] - mean[hr]) * rs[hr], m1 = (acc[i + 1] - mean[hr]) * rs[hr];
        const float d0 = bf16_round(e.x * pz[hr]), d1 = bf16_round(e.y * pz[hr]);
        const float md = w[hr][1] / W, mdn = w[hr][2] / W;
        const float q0 = rs[hr] * (d0 - md - m0 * mdn) * gd[i], q1 = rs[hr] * (d1 - md - m1 * mdn) * gd[i + 1];
        store3(PL, PLS, r, h * W + col, q0, q1);
        N_COL_ADD(cv, q0, q1);
      })
      ncol_out<ncols(W)>(cv, cs, pc + h * W, first_row);  // dc
    }
    for (int h = 0; h < H; ++h) nrows_part<ncols(W), 1, 3>(T, 0, 0, W, PL, PLS, h * W, pG, HH, first_row);  // dG = t^T dpre
    float u[ncols(W) / 2];
    nsecond<W>(u, P, HV, Wf);  // u again, the same bits
    nmma<ncols(W), 0, 0, 3, 1>(acc, PL, 64, 1024, PLS, GB, W, W * 16, 0, HH / 16);  // dt = bf16(dpre G^T); du, three planes
    {
      float v[2][4] = {};
      N_PAIRS(NJ, {
        const float x0 = ngelu(u[i]), x1 = ngelu(u[i + 1]);
        const float d0 = bf16_round(acc[i]), d1 = bf16_round(acc[i + 1]);
        acc[i] = d0;
        acc[i + 1] = d1;
        v[hr][0] += x0 + x1;
        v[hr][1] = fmaf(x0, x0, fmaf(x1, x1, v[hr][1]));
        v[hr][2] += d0 + d1;
        v[hr][3] = fmaf(d0, x0, fmaf(d1, x1, v[hr][3]));
      })
      xsum<4>(v, xs, par);
      float mean[2], rs[2], md[2], mdn[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        moments(v[k][0], v[k][1], W, mean[k], rs[k]);
        md[k] = v[k][2] / W;
        mdn[k] = rs[k] * (v[k][3] - mean[k] * v[k][2]) / W;
      }
      float cv[ncols(W) / 4] = {};
      N_PAIRS(NJ, {
        const float2 g0 = ngelu2(u[i]), g1 = ngelu2(u[i + 1]);
        const float m0 = (g0.x - mean[hr]) * rs[hr], m1 = (g1.x - mean[hr]) * rs[hr];
        const float q0 = rs[hr] * (acc[i] - md[hr] - m0 * mdn[hr]) * g0.y;
        const float q1 = rs[hr] * (acc[i + 1] - md[hr] - m1 * mdn[hr]) * g1.y;
        store3(DU, DUS, r, col, q0, q1);
        N_COL_ADD(cv, q0, q1);
      })
      if (wgr) {
        ncol_out<ncols(W)>(cv, cs, pw + d.lw_off[5], first_w);                         // dfb
        nrows_part<ncols(W), 1, 3>(HV, 0, 0, W, DU, DUS, 0, pw + d.lw_off[4], W, first_w);  // dfw = hv^T du
      }
    }
    nmma<ncols(W), 0, 0, 3, 1>(acc, DU, 64, 1024, DUS, Wf, W, W * 16, 0, W / 16);  // dhv = bf16(du fw^T), 0 where hv <= 0
    {
      float cv[ncols(W) / 4] = {};
      N_PAIRS(NJ, {
        const float2 h2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(HV + a16_index(r, col)));
        const float q0 = h2.x > 0.0f ? bf16_round(acc[i]) : 0.0f, q1 = h2.y > 0.0f ? bf16_round(acc[i + 1]) : 0.0f;
        store2(DHV, r, col, q0, q1);
        N_COL_ADD(cv, q0, q1);
      })
      if (wgr) {
        ncol_out<ncols(W)>(cv, cs, pw + d.lw_off[3], first_w);                        // dv_b1
        nrows_part<ncols(W), 1, 1>(F, 0, 0, W, DHV, 0, 0, pw + d.lw_off[2], W, first_w);  // dv_w1 = F^T dhv
      }
    }
    nmma<ncols(W), 0, 0, 1, 1>(acc, DHV, 64, 1024, 0, Wv, W, W * 16, 0, W / 16);  // dF = bf16(dhv v_w1^T)
    N_PAIRS(NJ, *reinterpret_cast<float2*>(DF + r * W + col) = make_float2(bf16_round(acc[i]), bf16_round(acc[i + 1]));)
    __syncthreads();
    nrff_vjp<W>(s_inv, d.I, P.v_coeff, DF, P.dinv + (it.bz * d.C + it.c0) * d.I, it.rows, false);
    __syncthreads();  // s_inv, DF and sp are read
  }
}

// 5. The softmax's VJP of a latent's rows (dlog = p (dp - sum_z' p_z' dp_z'), every latent's in latent order), then
// its query chain again and its VJP: in q_w1's epilogue dhq = (hq > 0) bf16(dlog A^T); dA = bf16(hq)^T dlog, dab,
// dwb; dq_w1, dq_b1; dF = bf16(dhq q_w1^T) and the RFF VJP added into dinv.
template <int W>
__global__ void __launch_bounds__(nthreads(W), nminb(W)) narrow_query_vjp(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const Dims& d = P.d;
  const int H = d.H, Z = d.Z;
  const NarrowLatent L = nl_layout(W, H);
  char* base = reinterpret_cast<char*>(smem);
  bf16 *Wq = reinterpret_cast<bf16*>(base + L.w1), *F = reinterpret_cast<bf16*>(base + L.f);
  bf16 *HQ = reinterpret_cast<bf16*>(base + L.hv), *DHQ = reinterpret_cast<bf16*>(base + L.t);
  float* DF = reinterpret_cast<float*>(base + L.pl);
  float *s_inv = reinterpret_cast<float*>(base + L.inv), *dl = reinterpret_cast<float*>(base + L.sp);
  float* cs = reinterpret_cast<float*>(base + L.cs);
  const float *Pz = P.work + d.x_p, *DP = P.work + d.x_dp;
  float* pb = P.part + (size_t)blockIdx.x * d.part_l;
  float* pw = pb + (size_t)d.slots * d.lr_row;
  const bool wgr = d.wgrad;
  constexpr int NJ = ncols(W) / 8;
  N_FRAG(ncols(W));
  ncopy(Wq, wimg(P, NI_Q), W * W / 2);
  const long long lo = (long long)blockIdx.x * d.ipb_l, hi = min(lo + d.ipb_l, d.items_l);
  const long long bz_first = lo / d.nt;
  for (long long item = lo; item < hi; ++item) {
    const NItem it = nitem(d, item);
    const bool first_row = item == lo || it.tile == 0, first_w = item == lo;
    float* pA = pb + (size_t)(it.bz - bz_first) * d.lr_row;
    float* pab = pA + d.lr_A;
    const long long row = it.bz * d.cp + it.c0, row0 = (long long)it.b * Z * d.cp + it.c0;
    for (int idx = threadIdx.x; idx < TILE * H; idx += blockDim.x) {
      const int rr = idx / H, h = idx - rr * H;
      float s = 0.0f;
#pragma unroll 8
      for (int z = 0; z < Z; ++z) {
        const long long k = (row0 + (long long)z * d.cp + rr) * H + h;
        s = fmaf(Pz[k], DP[k], s);
      }
      dl[idx] = Pz[row * H + idx] * (DP[row * H + idx] - s);
    }
    nload_inv(s_inv, P.inv + (it.bz * d.C + it.c0) * d.I, it.rows, d.I);
    __syncthreads();
    nfeatures(s_inv, d.I, P.q_coeff, W, F);
    cp_async_wait<0>();
    float acc[ncols(W) / 2];
    nfirst<W>(acc, F, Wq, P.q_b1);
    const float* Az = P.A + it.bz * W * H;
    float cv[ncols(W) / 4] = {};
    N_PAIRS(NJ, {
      float dh[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.0f;
        for (int h = 0; h < H; ++h) s = fmaf(dl[r * H + h], bf16_round(__ldg(Az + (col + e) * H + h)), s);
        dh[e] = acc[i + e] > 0.0f ? bf16_round(s) : 0.0f;
      }
      store2(HQ, r, col, acc[i], acc[i + 1]);
      store2(DHQ, r, col, dh[0], dh[1]);
      N_COL_ADD(cv, dh[0], dh[1]);
    })
    __syncthreads();  // hq
    for (int idx = threadIdx.x; idx < W * H; idx += blockDim.x) {  // dA = bf16(hq)^T dlog
      const int k = idx / H, h = idx - k * H;
      float s = 0.0f;
      for (int t = 0; t < TILE; ++t) s = fmaf(__bfloat162float(HQ[a16_index(t, k)]), dl[t * H + h], s);
      pA[idx] = first_row ? s : pA[idx] + s;
    }
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.0f;
      for (int t = 0; t < TILE; ++t) s += dl[t * H + h];
      pab[h] = first_row ? s : pab[h] + s;
    }
    for (int t = threadIdx.x; t < it.rows; t += blockDim.x) {
      float s = 0.0f;
      for (int h = 0; h < H; ++h) s += dl[t * H + h];
      P.dwb[it.bz * d.C + it.c0 + t] = s;
    }
    if (wgr) {
      ncol_out<ncols(W)>(cv, cs, pw + d.lw_off[1], first_w);                          // dq_b1
      nrows_part<ncols(W), 1, 1>(F, 0, 0, W, DHQ, 0, 0, pw + d.lw_off[0], W, first_w);  // dq_w1 = F^T dhq
    }
    nmma<ncols(W), 0, 0, 1, 1>(acc, DHQ, 64, 1024, 0, Wq, W, W * 16, 0, W / 16);  // dF = bf16(dhq q_w1^T)
    N_PAIRS(NJ, *reinterpret_cast<float2*>(DF + r * W + col) = make_float2(bf16_round(acc[i]), bf16_round(acc[i + 1]));)
    __syncthreads();
    nrff_vjp<W>(s_inv, d.I, P.q_coeff, DF, P.dinv + (it.bz * d.C + it.c0) * d.I, it.rows, true);
    __syncthreads();  // s_inv, DF and dl are read
  }
}

// Pass 2 of the narrow design: out = [dA | dab | dG | dc] over the (b, z) rows, then the weight gradients; each
// element sums its partials in block order: a row's slots in the per-latent blocks whose runs touch it, a
// weight's in every block of its kernel's grid (q_w1 ... fb the per-latent kernels', m_w2 ... h_b3 the tail's).
// The gradients of what JAX casts to bf16 (A, G and the weight matrices) are rounded once whole; m_w2's a head.
__global__ void narrow_reduce(const float* __restrict__ part, float* __restrict__ out, const Dims d) {
  const long long R = (long long)d.B * d.Z;
  const long long sec_len[4] = {(long long)d.hid * d.H, d.H, (long long)d.hid * d.HH, d.HH};
  const long long sec_off[4] = {0, d.lr_A, d.lr_A + d.lr_ab, d.lr_A + d.lr_ab + d.lr_G};
  const long long n_row = R * (sec_len[0] + sec_len[1] + sec_len[2] + sec_len[3]);
  const long long total = n_row + d.l_wo;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < total; o += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    if (o < n_row) {
      long long rem = o;
      int sec = 0;
      while (rem >= R * sec_len[sec]) rem -= R * sec_len[sec++];
      const long long bz = rem / sec_len[sec], e = rem - bz * sec_len[sec];
      const long long k0 = bz * d.nt / d.ipb_l, k1 = ((bz + 1) * d.nt - 1) / d.ipb_l;
#pragma unroll 4
      for (long long k = k0; k <= k1; ++k) {
        const long long slot = bz - k * d.ipb_l / d.nt;
        s += part[k * d.part_l + slot * d.lr_row + sec_off[sec] + e];
      }
      if (sec == 0 || sec == 2) s = bf16_round(s);  // dA, dG
    } else {
      const long long ow = o - n_row;
      int i = 0;  // the weight holding ow
      while (i + 1 < d.n_w && d.o_off[i + 1] <= ow) ++i;
      const long long e = ow - d.o_off[i];
      const int heads = i == 6 ? d.H : 1;
      for (int h = 0; h < heads; ++h) {
        float sh = 0.0f;
        if (i < 6)
#pragma unroll 8
          for (long long k = 0; k < d.grid_l; ++k) sh += part[k * d.part_l + (long long)d.slots * d.lr_row + d.lw_off[i] + e];
        else
#pragma unroll 8
          for (long long k = 0; k < d.grid_t; ++k)
            sh += part[(long long)d.grid_l * d.part_l + k * d.part_t + d.tw_off[i] + h * d.o_len[i] + e];
        s += i % 2 == 0 ? bf16_round(sh) : sh;
      }
    }
    out[o] = s;
  }
}

// The narrow design's shape: hid = hidm = D = 16, 32 or 64, at most NH_MAX heads and NHD_MAX columns H D, both
// layouts within SMEM_CAP; false for what it does not take.
inline bool narrow_shape(Dims& d) {
  const int W = d.hid;
  if (d.hidm != W || d.D != W || (W != 16 && W != 32 && W != 64)) return false;
  if (d.H > NH_MAX || d.HD > NHD_MAX) return false;
  d.nw = W;
  d.nt = (d.C + TILE - 1) / TILE;
  d.cp = (long long)d.nt * TILE;
  d.items = (long long)d.B * d.nt;
  d.items_t = d.items;
  d.items_l = d.items * d.Z;
  d.smem = nl_layout(W, d.H).total;
  d.smem_t = nt_layout(W, d.H).total;
  return d.smem <= SMEM_CAP && d.smem_t <= SMEM_CAP && d.items_l <= 2147483647LL;
}

// The narrow design's plan for per_sm blocks of the per-latent kernels and per_sm_t of the tail on each of sms
// SMs: persistent blocks, a contiguous run of ipb items each; then its partials (a block's: the (b, z) rows its
// run touches, padded sections, then with weight gradients the weights its kernels sum) and the workspace.
inline void narrow_plan(Dims& d, int per_sm, int sms) {
  auto r4 = [](long long n) { return (n + 3) / 4 * 4; };
  auto run = [](long long items, long long most, int& grid, int& ipb) {
    most = most < items ? most : items;
    most = most < 1 ? 1 : most;
    ipb = (int)((items + most - 1) / most);
    grid = (int)((items + ipb - 1) / ipb);
  };
  const int W = d.nw, H = d.H, HD = d.HD, HH = d.HH;
  d.per_sm = per_sm;
  run(d.items_l, (long long)per_sm * sms, d.grid_l, d.ipb_l);
  d.per_sm_t = SM_BYTES / (d.smem_t + 1024);  // the tail's blocks an SM by its shared memory (its grid follows)
  const int most = 2048 / nthreads(W);
  d.per_sm_t = d.per_sm_t < most ? d.per_sm_t : most;
  // With weight gradients a tail block takes at least two items: its partials (the tail's weights, H D x H D each)
  // are stored once for both (the e and <dy, m_b2> it writes are an item's own: nothing else depends on the split).
  run(d.items_t, d.wgrad ? ((long long)d.per_sm_t * sms < (d.items_t + 1) / 2 ? (long long)d.per_sm_t * sms : (d.items_t + 1) / 2)
                         : (long long)d.per_sm_t * sms, d.grid_t, d.ipb_t);
  d.grid = d.grid_l;
  d.ipb = d.ipb_l;
  const long long rows_bz = (long long)d.B * d.Z;
  // The (b, z) rows a run of ipb items can touch: ipb / nt where runs are whole rows, one where a row holds whole
  // runs, else as `plan` counts them.
  d.slots = d.ipb_l % d.nt == 0 ? d.ipb_l / d.nt : d.nt % d.ipb_l == 0 ? 1 : (int)((d.ipb_l + d.nt - 2) / d.nt + 1);
  d.slots = d.slots > rows_bz ? (int)rows_bz : d.slots;
  d.lr_A = r4((long long)W * H);
  d.lr_ab = r4(H);
  d.lr_G = (long long)W * HH;
  d.lr_c = r4(HH);
  d.lr_row = d.lr_A + d.lr_ab + d.lr_G + d.lr_c;
  long long o = 0;  // the weights after the row slots
  for (int i = 0; i < 6; ++i) {
    d.lw_off[i] = o;
    if (d.wgrad) o += r4(d.o_len[i]);
  }
  d.part_l = (long long)d.slots * d.lr_row + o;
  o = 0;
  for (int i = 0; i < 20; ++i) {
    d.tw_off[i] = o;
    if (i >= 6 && i < d.n_w) o += r4(d.o_len[i] * (i == 6 ? H : 1));
  }
  d.part_t = o;
  d.part = d.part_l;
  // The workspace: the weight images, G's, every latent's logits (then dp), softmax weights and nn, e and <dy, m_b2>
  // a batch row, the tail's pieces a tail block.
  d.n_img = d.tail ? 9 : 4;
  o = 0;
  for (int j = 0; j < 9; ++j) {
    int K, N;
    narrow_image_shape(d, j, K, N);
    d.x_w[j] = o;
    if (j < d.n_img) o += r4((long long)K * N / 2);
  }
  d.x_g = o;
  o += r4(rows_bz * W * HH / 2);
  const long long lat_rows = rows_bz * d.cp, b_rows = (long long)d.B * d.cp;
  d.x_lg = d.x_dp = o; o += r4(lat_rows * H);  // the logits, read last by narrow_values; then dp
  d.x_p = o; o += r4(lat_rows * H);
  d.x_nn = o; o += r4(lat_rows * HH / 2);
  d.x_ee = o; o += r4(b_rows * HH);
  d.x_dyb = o; o += r4(b_rows * H);
  const NarrowTail T = nt_layout(W, H);
  long long t = 0;
  d.t_q1 = t; if (d.tail) t += TILE * HD;
  d.t_g2 = t; if (d.tail) t += TILE * HD;
  d.t_g3 = t; if (d.tail) t += TILE * W;
  d.t_img = t; if (d.tail && d.wgrad) t += 4LL * TILE * T.xc / 2;
  d.t_nb = t; if (d.wgrad) t += 3LL * TILE * T.pc / 2;
  d.t_ws = t;
  d.x_t = o;
  o += (long long)d.grid_t * d.t_ws;
  d.ws_total = o;
}

// Pass 2: out = [dA | dab | dG | dc] over all rows (each [B, Z, ...]), then the weight
// gradients; each element sums its partials in block order: a row's slots in the blocks whose
// runs touch it, a weight's in every block. The gradients of what JAX casts to bf16 (A, G and the
// weight matrices: the even entries of weight_shapes) are rounded to bf16 once whole; m_w2's a
// head, then the heads' sum.
__global__ void fused_decode_bwd_reduce(const float* __restrict__ part, float* __restrict__ out, const Dims d) {
  const long long n_row = (long long)d.B * d.l_row;
  const long long total = n_row + d.l_wo;
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
      const long long k0 = b * d.nt / d.ipb, k1 = ((b + 1) * d.nt - 1) / d.ipb;
      for (long long k = k0; k <= k1; ++k) {
        const long long slot = b - k * d.ipb / d.nt;
        s += part[k * d.part + slot * d.l_row + sec_off + e];
      }
      if (sec == 0 || sec == 2) s = bf16_round(s);  // dA, dG
    } else {
      const long long ow = o - n_row;
      int i = 0;  // the weight holding ow
      while (i + 1 < d.n_w && d.o_off[i + 1] <= ow) ++i;
      const long long e = (long long)d.slots * d.l_row + d.w_off[i] + (ow - d.o_off[i]);
      const int heads = i == 6 ? d.H : 1;
      for (int h = 0; h < heads; ++h) {
        float sh = 0.0f;
        for (long long k = 0; k < d.grid; ++k) sh += part[k * d.part + e + h * d.o_len[i]];
        s += i % 2 == 0 ? bf16_round(sh) : sh;
      }
    }
    out[o] = s;
  }
}

// The launcher's hooks (fused_decode_bwd_host.cuh): threads of `weights_kernel` (one a bf16 of the
// converted weights, two a float), floats of the reduced output (m_w2 summed over its heads), of the workspace
// and of the partials.
inline long long weight_threads(const Dims& d) { return 2 * (d.w128 ? d.g_off : d.split_total); }
inline long long out_floats(const Dims& d) { return d.l_wo; }
inline long long work_floats(const Dims& d) { return d.narrow ? d.ws_total : d.split_total + (long long)d.grid * d.work; }
inline long long part_floats(const Dims& d) {
  return d.narrow ? (long long)d.grid_l * d.part_l + (long long)d.grid_t * d.part_t : (long long)d.grid * d.part;
}

// The launcher's hooks for the program's own designs (fused_decode_bwd_host.cuh): whether a launch takes the W128
// or the narrow design; its kernels' attributes and the blocks an SM its plan takes; the plan's own part (after
// `plan`); its launch, every pass.
inline bool own_design(const Dims& d) { return d.w128 || d.narrow; }
template <class K>
cudaError_t own_attributes(K* kernel, size_t smem, int threads, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  return err;
}
// The narrow design's kernels at width W; the per-latent kernels' blocks an SM (the fewest of the four) into per_sm.
// Each launch lays its shape out twice (`fused_decode_bwd_sizes`, then the launch): the attributes and the
// occupancy of the last shared-memory sizes a device and width were prepared for are kept (ten runtime calls fewer a
// layout, the host's share of a launch of a few hundred microseconds).
struct NarrowPrepared {
  int dev = -1, smem = -1, smem_t = -1, tail = -1, per_sm = 0;
};
template <int W>
cudaError_t prepare_narrow(const Dims& d, int* per_sm) {
  static NarrowPrepared last[8];
  int dev = 0;
  cudaError_t err0 = cudaGetDevice(&dev);
  if (err0 != cudaSuccess) return err0;
  NarrowPrepared& k = last[dev & 7];
  if (k.dev == dev && k.smem == (int)d.smem && k.smem_t == d.smem_t && k.tail == d.tail) {
    *per_sm = k.per_sm;
    return cudaSuccess;
  }
  int n[4] = {0, 0, 0, 0}, tail = 0;
  cudaError_t err = own_attributes(narrow_logits<W>, (size_t)d.smem, nthreads(W), &n[0]);
  if (err == cudaSuccess) err = own_attributes(narrow_values<W>, (size_t)d.smem, nthreads(W), &n[1]);
  if (err == cudaSuccess) err = own_attributes(narrow_value_vjp<W>, (size_t)d.smem, nthreads(W), &n[2]);
  if (err == cudaSuccess) err = own_attributes(narrow_query_vjp<W>, (size_t)d.smem, nthreads(W), &n[3]);
  if (err == cudaSuccess)
    err = d.tail ? own_attributes(narrow_tail<W, true>, (size_t)d.smem_t, nthreads(W), &tail)
                 : own_attributes(narrow_tail<W, false>, (size_t)d.smem_t, nthreads(W), &tail);
  *per_sm = n[0];
  for (int i = 1; i < 4; ++i) *per_sm = n[i] < *per_sm ? n[i] : *per_sm;
  if (err == cudaSuccess && tail < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) k = NarrowPrepared{dev, (int)d.smem, d.smem_t, d.tail, *per_sm};
  return err;
}
cudaError_t prepare_own(Dims& d, int* per_sm) {
  if (d.w128) return own_attributes(fused_decode_bwd_w128, (size_t)d.smem, THREADS, per_sm);
  switch (d.nw) {
    case 64: return prepare_narrow<64>(d, per_sm);
    case 32: return prepare_narrow<32>(d, per_sm);
    default: return prepare_narrow<16>(d, per_sm);
  }
}
inline void own_plan(Dims& d, int per_sm, int sms) {
  if (d.narrow)
    narrow_plan(d, per_sm, sms);
  else
    d.part = (d.part + 3) / 4 * 4;  // each block's partials on 16 bytes (the W128 design adds two at a time)
}
template <int W>
void launch_narrow(const Params& P, cudaStream_t s) {
  const Dims& d = P.d;
  long long pb = (2 * d.x_g + (long long)d.B * d.Z * W * d.HH + THREADS - 1) / THREADS;
  narrow_prep<<<(int)(pb > 4096 ? 4096 : pb), THREADS, 0, s>>>(P);
  narrow_logits<W><<<d.grid_l, nthreads(W), d.smem, s>>>(P);
  narrow_values<W><<<d.grid_l, nthreads(W), d.smem, s>>>(P);
  if (d.tail)
    narrow_tail<W, true><<<d.grid_t, nthreads(W), d.smem_t, s>>>(P);
  else
    narrow_tail<W, false><<<d.grid_t, nthreads(W), d.smem_t, s>>>(P);
  narrow_value_vjp<W><<<d.grid_l, nthreads(W), d.smem, s>>>(P);
  narrow_query_vjp<W><<<d.grid_l, nthreads(W), d.smem, s>>>(P);
  long long rb = ((long long)d.B * d.l_row + d.l_wo + THREADS - 1) / THREADS;
  narrow_reduce<<<(int)(rb > 4096 ? 4096 : (rb < 1 ? 1 : rb)), THREADS, 0, s>>>(P.part, P.out, d);
}
cudaError_t launch_own(const Params& P, cudaStream_t s) {
  const Dims& d = P.d;
  if (d.w128) {
    long long sb = (weight_threads(d) + THREADS - 1) / THREADS;
    weights_kernel<64><<<(int)(sb > 1024 ? 1024 : sb), THREADS, 0, s>>>(P);
    long long gb = (2LL * d.B * d.Z * W128_GBLK + THREADS - 1) / THREADS;
    w128_g_kernel<<<(int)(gb > 4096 ? 4096 : gb), THREADS, 0, s>>>(P);
    fused_decode_bwd_w128<<<d.grid, THREADS, (size_t)d.smem, s>>>(P);
    long long rb = ((long long)d.B * d.l_row + d.l_wo + THREADS - 1) / THREADS;
    fused_decode_bwd_reduce<<<(int)(rb > 4096 ? 4096 : (rb < 1 ? 1 : rb)), THREADS, 0, s>>>(P.part, P.out, d);
  } else {
    switch (d.nw) {
      case 64: launch_narrow<64>(P, s); break;
      case 32: launch_narrow<32>(P, s); break;
      default: launch_narrow<16>(P, s); break;
    }
  }
  return cudaGetLastError();
}

}  // namespace

#define K2_CLASS64_ONLY  // the narrow classes take the narrow design: the class design is instantiated at the class 64 alone
#include "fused_decode_bwd_host.cuh"  // the launcher's C interface (shared with the f32 program)
