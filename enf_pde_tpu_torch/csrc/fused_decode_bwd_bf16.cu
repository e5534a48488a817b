// Fused ENF decode, backward, the bf16 program: CUDA C++ for Hopper (sm_90a), the VJP of the
// bf16 forward (fused_decode_fwd_bf16.cu) with its products on bf16 wgmma, f32 accumulation.
//
// Replaces the TPU kernel `_bwd_kernel` launched by `_bwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py) in its bf16 mode (`_Spec.compute_dtype` bf16): the VJP of
// `_tile_decode` at bf16, as JAX's autodiff takes it through the casts. The plain PyTorch version
// of the same function is `fused_decode_bwd_plain(..., compute_dtype=torch.bfloat16)` in
// enf_pde_tpu_torch/ops/fused_decode.py (autograd over the plain bf16 forward). The f32 program
// (3xTF32) is fused_decode_bwd.cu; this source is that design (its header states the passes, the
// blocks, the workspace and the partials; fused_decode_bwd_common.cuh and fused_decode_bwd_host.cuh
// hold what the two programs share) with what the bf16 function changes:
//   - every forward product takes its operands rounded to bf16 (bf16_mma.cuh): one bf16 wgmma
//     m64nWNk16 a 16-deep chunk. An input gradient dX = dY W^T is JAX's dot of the f32 cotangent
//     dY with the bf16 W, rounded to bf16 after the product (the cotangent of a bf16 operand):
//     dY goes in as three bf16 terms (exact to f32 rounding; three wgmma) and the epilogue
//     rounds. A row contraction X^T dY takes the bf16 X and dY in three terms; nbar (the
//     softmax-weighted sum of the mixer's normalized hidden, which JAX never rounds) takes three
//     too: with both operands in three terms, the six products of terms i + j <= 2. The shared
//     weights are converted to bf16 once a launch, both ways (`weights_kernel`), one part
//     where the f32 program keeps two;
//   - the gradients of the bf16 operands JAX casts (A, G and every weight matrix) are rounded to
//     bf16 once their sums are whole, in pass 2; m_w2's a head (JAX casts it in each head's
//     product), so its partials are kept a head;
//   - the softmax weights weight the values rounded to bf16 and do not sum to 1: y = nbar m_w2 +
//     (sum_z p16) m_b2, dm_b2 takes the same sums, and the softmax's cotangent is
//     dp = bf16(<e, n16> + <dy, m_b2>) (the bias term no longer cancels);
//   - the polynomial sin / cos of `_fast_sincos` and its derivative in the RFF VJP.
// Partials stay f32 and are reduced in a fixed order: two launches give the same bits.
// What bounds it: the products at the bf16 rate, 0.128 / 0.176 ms at NS 80 x 512 without / with
// weight gradients. Measured (PERF.md §6, an H100): 6.32 / 9.10 ms against 7.42 / 10.46 for
// the f32 program; every gradient group within 0.24 of the bf16 function's distance from f32 of
// the plain bf16 version (chip_smoke.py phase 35). The LayerNorm passes, the partials and the
// product loops' overhead remain (fused_decode_bwd.cu's findings), the cotangent products at three terms.
// Shared memory (k2_smem_bytes mirrors it, with compute_dtype=torch.bfloat16): the f32
// program's with the staging at three quarters of its floats (three bf16 parts a slab) and two
// [64][H] rows, the sums of the rounded softmax weights and <dy, m_b2>.

#include "fused_decode_bwd_common.cuh"  // constants, wgmma / cp.async helpers, shared row passes
#include "bf16_mma.cuh"                  // bf16_round, pack_bf16, split3_bf16, wgmma_bf16, fast_sincos

namespace {

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
  if (d.hid % d.wn || d.hidm % d.wn || d.D % d.wn) return false;
  int wide = d.HH > d.HD ? d.HH : d.HD;
  wide = wide > d.hid ? wide : d.hid;
  d.ldh = row_stride(d.hid);
  d.ldw = row_stride(wide);
  d.n_w2 = TILE * (d.ldw > 2 * d.ldh ? d.ldw : 2 * d.ldh);
  // A third buffer copies the bf16 weights two chunks ahead. At the width class 64 (one
  // block an SM) it is free; below it would cost the second block an SM (PERF.md §6).
  for (d.stages = d.wn == 64 ? 3 : 2; d.stages >= 2; --d.stages) {
    d.smem = 4LL * (stage_floats(d.wn, d.stages) + (long long)TILE * d.ldw + (long long)TILE * d.ldh + d.n_w2 +
                    2LL * d.Z * TILE * d.H + 2LL * TILE * d.H + (long long)TILE * d.I);
    if (d.smem <= SMEM_CAP) break;
  }
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
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < 2 * d.split_total;
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
// converted weights, two a float) and floats of the reduced output (m_w2 summed over its heads).
inline long long weight_threads(const Dims& d) { return 2 * d.split_total; }
inline long long out_floats(const Dims& d) { return d.l_wo; }

}  // namespace

#include "fused_decode_bwd_host.cuh"  // the launcher's C interface (shared with the f32 program)
