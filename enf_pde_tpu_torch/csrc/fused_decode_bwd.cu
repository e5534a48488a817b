// Fused ENF decode, backward: CUDA C++ for Hopper (sm_90a), its products on the tensor
// cores at f32 accuracy (3xTF32 wgmma over 64-row tiles).
//
// Replaces the TPU kernel `_bwd_kernel` launched by `_bwd_pallas`
// (enf_pde_tpu/ops/pallas_decode.py), which recomputes one coordinate tile's forward
// decode and applies its VJP. The plain PyTorch version of the same function is
// `fused_decode_bwd_plain` in enf_pde_tpu_torch/ops/fused_decode.py (autograd over
// `fused_decode_plain`); the forward it differentiates is kernel K1
// (fused_decode_fwd.cu), whose header states the math. What this program shares with the bf16
// one (fused_decode_bwd_bf16.cu) lives in fused_decode_bwd_common.cuh (constants, the wgmma and
// cp.async helpers, the epilogues, the row passes both take alike) and fused_decode_bwd_host.cuh
// (the launcher).
//
// Outputs, for cotangent g [B, C, out]:
//   dinv [B, Z, C, I], dwb [B, Z, C]            one value per coordinate: written once
//   dA, dab, dG, dc    [B, Z, ...]               summed over a batch row's coordinates
//   weight gradients (optional, flag)            summed over every coordinate of the grid
// The RFF coefficients get no gradient (stop_gradient in JAX, fixed buffers here).
//
// The mixer is linear, so its product is taken once a tile, not once a latent: with
// nbar_h = sum_z p_zh nn_zh (nn the normalized mixer hidden of latent z, head h),
// y_h = nbar_h m_w2 + m_b2 (the softmax weights sum to 1); with e_h = dy_h m_w2^T, the
// mixer's input gradient of latent z is p_zh e_h, its softmax gradient dp_zh = <e_h, nn_zh>
// (the bias term <dy_h, m_b2> cancels in dlogit = p (dp - sum_z p dp)), and
// dm_w2 = sum_h nbar_h^T dy_h.
//
// Design. A block of 256 threads (two warpgroups) takes work items (batch row, tile of
// TILE = 64 coordinates: JAX's tile_c_bwd) in a fixed, contiguous run: persistent blocks, as
// many as the SMs hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor; at least
// MIN_IPB items a block). Per item:
//   1. per latent: the query chain (RFF features, q_w1, the logits on the CUDA cores);
//      then the softmax over latents;
//   2. per latent: the value chain (v_w1, fw, LayerNorm-gelu, G, LayerNorm-gelu per head),
//      weighted into nbar; y = nbar m_w2 + m_b2;
//   3. the tail forward, its activations kept in the block's workspace slice, then its VJP:
//      dy; e = dy m_w2^T into the workspace slice;
//   4. per latent: the value chain again (recomputed: nothing of step 2 is kept), dp, the
//      mixer-LayerNorm VJP (dpre), dG += t^T dpre, dt = dpre G^T, the LayerNorm VJP, fw's and
//      v_w1's VJPs, the RFF VJP into dinv; then dlogit = p (dp - sum_z p dp);
//   5. per latent: the query chain again, dA, dab, dwb, dhq, q_w1's VJP, dinv.
// Hand-written VJPs: sin/cos features (d proj = 2 pi (cos dS - sin dC)), ReLU, tanh-gelu,
// and the scale-free LayerNorm (dx = r (dn - mean(dn) - n mean(dn n))), each recomputing
// the forward values of its row from the pre-activation (gelu and gelu' from one tanh).
// The LayerNorm passes take width / 8 lanes a segment (at most 32), 8 values a lane.
//
// Products. Every product runs on 3xTF32 wgmma m64nWNk8 (A from registers, B K-major from
// shared memory), WN the width class (`width_class`: 64 at hid 128, 32 at 64, 16 at 32, 8
// at 16; each warpgroup takes WN columns, or one m64 tile of a row contraction): forward
// layers Y = X W, input gradients dX = dY W^T and row contractions X^T dY (the weight
// gradients and dG, over the tile's 64 rows; M, the width of X, in m64 tiles padded with
// zero rows). `gemm` stages B in 16-deep chunks, split into tf32 (big, small) halves in the
// blocked layout wgmma reads (K1's `split_weights` layout), in a ring of chunk buffers, one
// barrier a chunk. The nine shared weights are split once a launch by `weights_kernel`
// into that layout, both ways (as the B of X W and of dY W^T), in the workspace; their chunks
// go into the ring whole by 16-byte cp.async, two chunks ahead of the products at the width
// class 64 (a ring of three) and one below it (two: a third buffer would cost the second block
// an SM). G[b, z], the tile's gradient in shared memory and the activations kept in the
// workspace are loaded into registers two chunks ahead, then split and stored one ahead while
// a chunk's wgmma run. A's fragments are loaded from shared memory (row-major, or transposed
// for a row contraction) and split in registers. 3xTF32: x = big + small, both tf32, and a b
// = ab bb + ab bs + as bb with as bs dropped, about 2^-21 relative per product. The tensor
// core aligns its addends to the largest and truncates, so a long sum kept in its
// accumulator drifts toward zero (1.8e-3 rel-L2 on the weight gradients, measured on the PR 7
// build): each k step of 8 goes into a fresh accumulator (its first wgmma does not
// accumulate) that is added into an f32 register sum, two accumulators in flight.
// ptxas serializes every wgmma of a kernel where one crosses a function call or sits on a
// path that differs within a warpgroup, so `gemm` is inlined and a warpgroup without a unit
// in a round multiplies its partner's again and skips only the epilogue.
//
// Memory. Shared memory at Navier-Stokes width (hid = hidm = D = 128, H = 2, I = 4):
//   stage  3 x 2 slabs x 16 k x 64 n x (big, small)   49,152 B   B chunks
//   P      [64 x 260] f32                              66,560 B   hv, pre / dpre, y, the tail's wide
//   X1     [64 x 132] f32                              33,792 B   features, u, hq, dhv
//   W2     [64 x 264] f32 (X2 and X3, or one wide)     67,584 B   nbar, hv, t / dt / du, the tail's wide
//   softmax weights and dp / dlogit [2][Z][64][H], the invariants [64][I]:
//   222,208 B at Z = 4 (`k2_smem_bytes` mirrors it; past Z = 14 the ring has two buffers,
//   past Z = 30 the shape is refused): one block an SM.
// A workspace in device memory: the pre-split shared weights (5.0 MB at Navier-Stokes width),
// then a slice a block, written and read back within an item: e [64][H hidm], nbar (with
// weight gradients), and the tail's activations (q1, q2, q3, q4; with weight gradients also y
// and y1, which two row contractions read as their B; t1, y2 are recomputed from q1, q2 for
// theirs): 256 KB a block at Navier-Stokes width without weight gradients, 448 KB with.
// Partial sums, per block: one slot of dA | dab | dG | dc for each batch row its run touches
// (the first item of a row in the run stores, later ones add), and the weight gradients,
// accumulated over the whole run (stored by its first item, added by later ones); an
// epilogue that adds reads every old value before it writes any. Pass 2
// (`fused_decode_bwd_reduce`) sums the slots of a row's blocks, or every block's weight
// gradients, in block order: no atomics, two launches give the same bits.
//
// What bounds it. About 3.1 MFLOP of matmul per point without weight gradients and 4.2
// with them (`decode_bwd_flops_per_point`; this design recomputes the value and query
// chains once more and takes the mixer once a tile, about +8 % / -5 % of that): bound by
// operations, 0.77 / 1.05 ms at the ode step's 80 x 512 for the three TF32 products of
// each product on the tensor cores.
// Measured (PERF.md, PR 18; NVIDIA H100 80GB HBM3 at 700 W, tools/k2_compare.py beside the PR 17
// build): 7.33 / 10.48 ms without / with weight gradients at 80 x 512 (PR 17: 8.15 / 13.71),
// 7.28 / 10.05 at shallow water's 10 x 2048, 36.86 / 52.52 at 400 x 512, 1.8-2.6x the PR 17
// build at the narrow widths: 9.5-11.5x the bound. The product loops take about half (issue
// bound: the A split, the fresh accumulators' adds, a barrier a chunk; the wgmma themselves
// about an eighth), the LayerNorm passes a fifth, and with weight gradients the adds into the
// partials a quarter.

#include "fused_decode_bwd_common.cuh"  // constants, wgmma / cp.async helpers, shared row passes
#include "tf32_mma.cuh"                  // gelu_tanh, aligned16 (shared with K1)

namespace {

constexpr float TWO_PI = 6.283185307179586f;
// Floats of the B staging: a ring of `stages` chunk buffers of two slabs of 32 wn (big and small,
// 16 k, wn n).
__host__ __device__ constexpr int stage_floats(int wn, int stages) { return stages * 2 * 32 * wn; }

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
  // The shared weights pre-split for the products (`weights_kernel`) at the workspace's
  // start: entry j (SPLIT_* order) at split_off[j], its B K x N (split_K, split_N); split_n of
  // the 18 are laid out (the tail's only with the tail).
  long long split_off[18], split_total;
  int split_K[18], split_N[18], split_n;
  // Workspace floats per block after them, and the offsets of its pieces ([64][width] each).
  long long w_e, w_n, w_y, w_y1, w_q1, w_q2, w_q3, w_q4, work;
  // Partials: per-row sections, the weights (8 attention + 12 tail), floats per block.
  long long l_A, l_ab, l_G, l_c, l_row;
  long long w_off[20], w_len[20];
  int n_w;
  long long l_w, part;
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
  // A third buffer copies the pre-split weights two chunks ahead. At the width class 64 (one
  // block an SM) it is free; below it would cost the second block an SM (PERF.md, PR 18).
  for (d.stages = d.wn == 64 ? 3 : 2; d.stages >= 2; --d.stages) {
    d.smem = 4LL * (stage_floats(d.wn, d.stages) + (long long)TILE * d.ldw + (long long)TILE * d.ldh + d.n_w2 +
                    2LL * d.Z * TILE * d.H + (long long)TILE * d.I);
    if (d.smem <= SMEM_CAP) break;
  }
  if (d.smem > SMEM_CAP) return false;
  d.nt = (d.C + TILE - 1) / TILE;
  d.items = (long long)d.B * d.nt;
  if (d.items > 2147483647LL) return false;

  // The shared weights each product reads as its B, pre-split: as X W (K x N = the weight's
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
      if (i < per) d.split_total += 2LL * d.split_K[j] * d.split_N[j];
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
  d.l_w = 0;
  for (int i = 0; i < 20; ++i) d.w_off[i] = d.w_len[i] = 0;
  for (int i = 0; i < d.n_w; ++i) {
    d.w_off[i] = d.l_w;
    d.w_len[i] = (long long)rows[i] * (cols[i] ? cols[i] : 1);
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

// x rounded to tf32 (to nearest, ties away from zero), as tf32_mma.cuh's split_tf32_int rounds.
__device__ __forceinline__ float tf32_round(float x) { return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u); }

// The hooks of fused_decode_bwd_common.cuh: f32 operands (the products split them into tf32
// parts themselves), sin and cos by sincosf.
__device__ __forceinline__ float operand(float x) { return x; }
__device__ __forceinline__ void rff_sincos(float proj, float* s, float* c) { sincosf(TWO_PI * proj, s, c); }

// ---- wgmma ------------------------------------------------------------------------------------
// D (64 x N, f32, this thread's N / 2 values) = A (64 x 8 tf32, registers: this warp's 16 rows in
// the m16n8k8 A-fragment order) x B (8 x N tf32, K-major in shared memory, `desc`) + (accumulate ?
// D : 0), one asynchronous warpgroup product, N = 8, 16, 32 or 64. D's fragment: n8 tile j at
// d[4 j .. 4 j + 3] = (row g, col 8 j + 2 t), (g, 8 j + 2 t + 1), (g + 8, 8 j + 2 t),
// (g + 8, 8 j + 2 t + 1) of the warp's 16 rows.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc, int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 8) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 16) {
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

template <int WN>
struct Cls {
  static constexpr int SLOT = 32 * WN;     // floats of one staged slab: part, k step, n group, k group, 8 n, 4 k
  static constexpr int BUF = 2 * SLOT;     // a chunk of two slabs
  static constexpr int GROUPS = 8 * WN;    // float4 groups (4 k of one n) of a chunk of two slabs
  static constexpr int GPT = (GROUPS + THREADS - 1) / THREADS;
  static constexpr int NACC = WN / 2;      // accumulator registers a thread
};

// out(m, n) = sum_k A(m, k) B(k, n) on the tensor cores at f32 accuracy; epi(m, n, v0, v1) gets
// columns n and n + 1 of row m. A_T false: A(m, k) = A[m * lda + k], M = 64 (the tile's rows);
// true: A(m, k) = A[k * lda + m] for m < M, zero beyond (a row contraction, K = 64). B per BMODE
// with row stride ldb. K is a multiple of KC, N of WN. Units (an m64 tile, a WN slab) go in
// rounds of two, one a warpgroup; the two units of a round share each staged chunk (one slab
// when they differ in m, two when in n). The staging is a ring of nst (2 or 3) chunk buffers:
// a pre-split weight's chunks are copied by cp.async nst - 1 chunks ahead of the products; any
// other B is loaded into registers two chunks ahead and split and stored one ahead, while the
// products run. Per chunk: A fragments of both k steps from shared memory, split; three wgmma
// per k step into a fresh accumulator; the accumulators added into f32 sums. Every thread of
// the block calls it; it starts with a barrier and does not end with one.
template <int WN, bool A_T, int BMODE, class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, int M, int K, const float* B, int ldb, int N,
                                     float* stage, int nst, Epi epi) {
  using Cl = Cls<WN>;
  constexpr int NACC = Cl::NACC, GPT = Cl::GPT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, wg = warp >> 2, w = warp & 3;
  const int mtiles = A_T ? (M + TILE - 1) / TILE : 1;
  const int units = mtiles * (N / WN), nk = K / KC;
  for (int u0 = 0; u0 < units; u0 += 2) {
    const int u1 = u0 + 1 < units ? u0 + 1 : u0;  // a lone last unit: the second warpgroup repeats it
    const int u = wg ? u1 : u0;
    const bool valid = u0 + wg < units;
    const int mt = u % mtiles, ns = u / mtiles, ns0 = u0 / mtiles, ns1 = u1 / mtiles;
    const int nslots = ns1 == ns0 ? 1 : 2;
    const float* st0 = stage + (ns == ns0 ? 0 : Cl::SLOT);
    const int m0 = mt * TILE + 16 * w + g, m1 = m0 + 8;
    // This thread's groups of a chunk: a source offset (without the chunk's k) and a staging offset.
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
      dst_off[i] = s * Cl::SLOT + (kq >> 1) * 8 * WN + (n >> 3) * 64 + (kq & 1) * 32 + (n & 7) * 4;
    }
    // B_SPLIT: chunk c's slabs copied whole into ring buffer buf, one cp.async group a chunk (an
    // empty one past the last, so that the waits count uniformly).
    auto copy = [&](int c, int buf) {
      if (c < nk) {
        const int nsl = N / WN;
        float* dst = stage + buf * Cl::BUF;
        for (int i = tid; i < nslots * Cl::SLOT / 4; i += THREADS) {
          const int sl = i / (Cl::SLOT / 4), off = 4 * (i % (Cl::SLOT / 4));
          cp_async16(dst + sl * Cl::SLOT + off, B + ((size_t)c * nsl + (sl ? ns1 : ns0)) * Cl::SLOT + off);
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
    auto store = [&](int buf) {  // the loaded chunk's values, split into (big, small), into ring buffer buf
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        if (!has[i]) continue;
        const float4 v = raw[i];
        const float4 big = make_float4(tf32_round(v.x), tf32_round(v.y), tf32_round(v.z), tf32_round(v.w));
        const float4 small = make_float4(tf32_round(v.x - big.x), tf32_round(v.y - big.y), tf32_round(v.z - big.z),
                                         tf32_round(v.w - big.w));
        float* dst = stage + buf * Cl::BUF + dst_off[i];
        *reinterpret_cast<float4*>(dst) = big;
        *reinterpret_cast<float4*>(dst + 16 * WN) = small;
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
    float sum[NACC], f0[NACC], f1[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = f0[i] = f1[i] = 0.0f;
    int cur = 0, nxt = 1, prv = nst - 1;  // ring buffers of chunks c, c + 1 and c - 1 (c + nst - 1)
    for (int c = 0; c < nk; ++c) {
      if (BMODE == B_SPLIT) copy(c + nst - 1, prv);  // into the buffer chunk c - 1 used: under this chunk's products
      uint32_t ab[2][4], as[2][4];  // A's parts: big, small
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = c * KC + 8 * q + tq;
        float v[4];
        if (A_T) {
          v[0] = m0 < M ? A[k * lda + m0] : 0.0f;
          v[1] = m1 < M ? A[k * lda + m1] : 0.0f;
          v[2] = m0 < M ? A[(k + 4) * lda + m0] : 0.0f;
          v[3] = m1 < M ? A[(k + 4) * lda + m1] : 0.0f;
        } else {
          v[0] = A[m0 * lda + k];
          v[1] = A[m1 * lda + k];
          v[2] = A[m0 * lda + k + 4];
          v[3] = A[m1 * lda + k + 4];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float big = tf32_round(v[e]);
          ab[q][e] = __float_as_uint(big);
          as[q][e] = __float_as_uint(tf32_round(v[e] - big));
        }
      }
      const float* st = st0 + cur * Cl::BUF;
      wg_fence_operands<NACC>(f0);
      wg_fence_operands<NACC>(f1);
      wg_fence();
      // k step 0 into f0, k step 1 into f1: small x big (not accumulating: a fresh accumulator),
      // big x small, big x big. Part p (big 0, small 1) of k step q is at st + 16 WN p + 8 WN q.
      wgmma_tf32<WN>(f0, as[0], wg_desc(st), 0);
      wgmma_tf32<WN>(f0, ab[0], wg_desc(st + 16 * WN), 1);
      wgmma_tf32<WN>(f0, ab[0], wg_desc(st), 1);
      wgmma_tf32<WN>(f1, as[1], wg_desc(st + 8 * WN), 0);
      wgmma_tf32<WN>(f1, ab[1], wg_desc(st + 24 * WN), 1);
      wgmma_tf32<WN>(f1, ab[1], wg_desc(st + 8 * WN), 1);
      wg_commit();
      if (BMODE != B_SPLIT && c + 1 < nk) {
        store(nxt);
        if (c + 2 < nk) load(c + 2);
        fence_async_smem();
      }
      wg_wait0();
      wg_fence_operands<NACC>(f0);
      wg_fence_operands<NACC>(f1);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        sum[i] += f0[i];
        sum[i] += f1[i];
      }
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

// dinv[t, i] (+)= sum_j 2 pi (cos_j dF[t, j] - sin_j dF[t, half + j]) coeff[i, j] for t < rows,
// sin and cos recomputed from the invariants. A warp per row, lanes along j.
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
      float s, co;
      sincosf(TWO_PI * proj, &s, &co);
      const float dproj = TWO_PI * (co * dF[t * ldd + j] - s * dF[t * ldd + half + j]);
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
// prob[t, seg] E (the mixer's input gradient of one latent, dX's old value unread), and
// dp[t, seg] = <E, n>.
template <int NV>
__device__ __noinline__ void ln_gelu_vjp_nv(float* dX, int ldd, const float* P, int ldp, int segs, int width, int L,
                                            const float* E, int lde, const float* prob, float* dp) {
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
    const float pr = E && ok ? prob[r] : 0.0f;
    float sd = 0.0f, sdn = 0.0f, se = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      if (ok && n < width) {
        gv[i] = (gv[i] - mean) * rs;  // n
        se = fmaf(dn[i], gv[i], se);  // <E, n> before the scale
        if (E) dn[i] *= pr;
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
    if (E && ok && sub == 0) dp[r] = se;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int n = sub + L * i;
      if (ok && n < width) dX[t * ldd + o + n] = rs * (dn[i] - md - gv[i] * mdn) * gd[i];
    }
  }
}

__device__ void ln_gelu_vjp(float* dX, int ldd, const float* P, int ldp, int segs, int width,
                            const float* E = nullptr, int lde = 0, const float* prob = nullptr, float* dp = nullptr) {
  const int L = seg_lanes(width);
  if (width <= 8 * L)
    ln_gelu_vjp_nv<8>(dX, ldd, P, ldp, segs, width, L, E, lde, prob, dp);
  else
    ln_gelu_vjp_nv<16>(dX, ldd, P, ldp, segs, width, L, E, lde, prob, dp);
}

// The softmax over latents of s_prob [Z][64][H], in place.
__device__ __noinline__ void softmax_z(float* s_prob, int Z, int H) {
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
    for (int z = 0; z < Z; ++z) s_prob[z * TILE * H + idx] /= sum;
  }
}

// ---- The kernels -------------------------------------------------------------------------------
// Pass 0: the shared weights into the staged layout `gemm` copies whole (B_SPLIT), once a launch:
// entry j's B (K x N) as blocks of SLOT floats, one per 16-deep chunk kc and WN slab s (kc major),
// each holding part, k step q, n group, k group, 8 rows, 4 k, i.e. element (16 kc + 8 q + 4 kg + i,
// WN s + 8 ng + r) of B; part p the tf32 rounding of what parts 0 .. p - 1 left.
template <int WN>
__global__ void weights_kernel(const Params P) {
  using Cl = Cls<WN>;
  const Dims& d = P.d;
  const float* src[9] = {P.q_w1, P.v_w1, P.fw, P.m_w2, P.o_w, P.p_w1, P.p_w2, P.h_w1, P.h_w2};
  const int per = d.split_n / 2;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < d.split_total;
       idx += (long long)gridDim.x * blockDim.x) {
    int j = 0;  // the laid-out entry holding idx: the last whose offset is at most idx
    for (int jj = 1; jj < 18; ++jj)
      if (jj % 9 < per && d.split_off[jj] <= idx) j = jj;
    const long long e = idx - d.split_off[j];
    const int K = d.split_K[j], N = d.split_N[j];
    const long long blk = e / Cl::SLOT;
    const int w = (int)(e % Cl::SLOT);
    const int kc = (int)(blk / (N / WN)), sl = (int)(blk % (N / WN));
    const int part = w / (16 * WN), q = w % (16 * WN) / (8 * WN), ng = w % (8 * WN) / 64, kg = w % 64 / 32;
    const int r = w % 32 / 4, i = w % 4;
    const int k = 16 * kc + 8 * q + 4 * kg + i, n = WN * sl + 8 * ng + r;
    float x = j < 9 ? src[j][(size_t)k * N + n] : src[j - 9][(size_t)n * K + k];  // B of X W, or of dY W^T
    float v = tf32_round(x);
    for (int pt = 0; pt < part; ++pt) {
      x -= v;
      v = tf32_round(x);
    }
    P.work[idx] = v;
  }
}

// Pass 1.
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
  float* s_prob = W2 + d.n_w2;                   // [Z][64][H] softmax weights
  float* s_dlog = s_prob + Z * TILE * H;         // [Z][64][H] dp, then dlogit
  float* s_inv = s_dlog + Z * TILE * H;          // [64][I]

  float* ws = P.work + d.split_total + (size_t)blockIdx.x * d.work;
  auto wsplit = [&](int j) { return P.work + d.split_off[j]; };  // a pre-split weight
  float* pb = P.part + (size_t)blockIdx.x * d.part;
  float* pw = pb + (size_t)d.slots * d.l_row;    // the weight gradients, over the whole run
  const bool wgr = d.wgrad, tail = d.tail;
  const long long lo = (long long)blockIdx.x * d.ipb;
  const long long hi = lo + d.ipb < d.items ? lo + d.ipb : d.items;
  const int b_first = (int)(lo / d.nt);

  // Epilogues: a shared-memory store (with a bias and a ReLU), a store into device memory, an
  // add into a block-private partial (stored by its first contribution), and that add transposed.
  auto to_smem = [](float* Y, int ld, const float* bias, bool relu) {
    return [=](int m, int n, float v0, float v1) {
      if (bias) { v0 += __ldg(bias + n); v1 += __ldg(bias + n + 1); }
      if (relu) { v0 = fmaxf(v0, 0.0f); v1 = fmaxf(v1, 0.0f); }
      Y[m * ld + n] = v0;
      Y[m * ld + n + 1] = v1;
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
      gemm<WN, false, B_SPLIT>(X1, ldh, TILE, hid, wsplit(SPLIT_Q), 0, hid, stage, nst, to_smem(X2, ldh, P.q_b1, true));
      logits(X2, ldh, hid, P.A + bz * hid * H, P.ab + bz * H, P.wb + bz * C + c0, rows, H, s_prob + z * TILE * H);
    }
    softmax_z(s_prob, Z, H);

    // 2. Value chains, weighted into nbar (W2, row stride ldw).
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      load_inv(s_inv, P.inv + (bz * C + c0) * I, rows, I);
      rff(s_inv, I, P.v_coeff, half, X1, ldh);
      gemm<WN, false, B_SPLIT>(X1, ldh, TILE, hid, wsplit(SPLIT_V), 0, hid, stage, nst, to_smem(Pb, ldh, P.v_b1, true));  // hv
      gemm<WN, false, B_SPLIT>(Pb, ldh, TILE, hid, wsplit(SPLIT_F), 0, hid, stage, nst, to_smem(X1, ldh, P.fb, false));     // u
      ln_gelu(X1, ldh, X1, ldh, 1, hid);                                                                   // t
      gemm<WN, false, B_KN>(X1, ldh, TILE, hid, P.G + bz * hid * HH, HH, HH, stage, nst,
                            to_smem(Pb, ldw, P.c + bz * HH, false));                                      // pre
      ln_gelu(Pb, ldw, Pb, ldw, H, hidm);                                                                  // nn
      accum_nbar(W2, Pb, ldw, s_prob + z * TILE * H, H, hidm, z == 0);
    }
    if (wgr) copy_out(ws + d.w_n, W2, ldw, HH);

    // 3. The tail forward (its activations into the workspace) and its VJP: dy in W2.
    const float* gsrc = P.g + ((size_t)b * C + c0) * d.out;
    if (tail) {
      for (int h = 0; h < H; ++h)  // y = nbar m_w2 + m_b2, a head at a time
        gemm<WN, false, B_SPLIT>(W2 + h * hidm, ldw, TILE, hidm, wsplit(SPLIT_M), 0, D, stage, nst,
                              to_smem(Pb + h * D, ldw, P.m_b2, false));
      if (wgr) copy_out(ws + d.w_y, Pb, ldw, HD);
      gemm<WN, false, B_SPLIT>(Pb, ldw, TILE, HD, wsplit(SPLIT_O), 0, HD, stage, nst, to_smem(W2, ldw, P.o_b, false));  // y1
      if (wgr) copy_out(ws + d.w_y1, W2, ldw, HD);
      gemm<WN, false, B_SPLIT>(W2, ldw, TILE, HD, wsplit(SPLIT_P1), 0, HD, stage, nst, to_smem(Pb, ldw, P.p_b1, false));  // q1
      copy_out(ws + d.w_q1, Pb, ldw, HD);
      ln_gelu(Pb, ldw, Pb, ldw, 1, HD);                                                                    // t1
      gemm<WN, false, B_SPLIT>(Pb, ldw, TILE, HD, wsplit(SPLIT_P2), 0, HD, stage, nst, to_smem(W2, ldw, P.p_b2, false));  // q2
      copy_out(ws + d.w_q2, W2, ldw, HD);
      gelu_rows(W2, ldw, W2, ldw, HD);                                                                     // y2
      gemm<WN, false, B_SPLIT>(W2, ldw, TILE, HD, wsplit(SPLIT_H1), 0, hid, stage, nst, to_smem(X1, ldh, P.h_b1, false));  // q3
      copy_out(ws + d.w_q3, X1, ldh, hid);
      gelu_rows(X1, ldh, X1, ldh, hid);                                                                    // h1
      gemm<WN, false, B_SPLIT>(X1, ldh, TILE, hid, wsplit(SPLIT_H2), 0, hid, stage, nst, to_smem(Pb, ldh, P.h_b2, false));  // q4
      copy_out(ws + d.w_q4, Pb, ldh, hid);
      gelu_rows(Pb, ldh, Pb, ldh, hid);                                                                    // h2
      // Head layer 3 on the CUDA cores: dh2 into X2; then dq4 = dh2 gelu'(q4).
      head_vjp(gsrc, rows, d.out, P.h_w3, hid, X2, ldh, Pb, ldh, wgr ? pw + d.w_off[18] : nullptr,
               pw + d.w_off[19], first_w);
      mul_gelu_grad(X2, ldh, ws + d.w_q4, hid);
      if (wgr) {  // dh_w2 = h1^T dq4 (h1 in X1)
        gemm<WN, true, B_KN_SMEM>(X1, ldh, hid, TILE, X2, ldh, hid, stage, nst, to_part(pw + d.w_off[16], hid, first_w));
        col_sums(X2, ldh, hid, hid, pw + d.w_off[17], first_w);
      }
      gemm<WN, false, B_SPLIT>(X2, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_H2), 0, hid, stage, nst, to_smem(X3, ldh, nullptr, false));  // dh1
      mul_gelu_grad(X3, ldh, ws + d.w_q3, hid);                                                              // dq3
      if (wgr) {  // dh_w1 = y2^T dq3: dq3^T y2 transposed, y2 = gelu(q2) recomputed into P
        gelu_rows(ws + d.w_q2, HD, Pb, ldw, HD);
        gemm<WN, true, B_KN_SMEM>(X3, ldh, hid, TILE, Pb, ldw, HD, stage, nst, to_part_t(pw + d.w_off[14], hid, first_w));
        col_sums(X3, ldh, hid, hid, pw + d.w_off[15], first_w);
      }
      gemm<WN, false, B_SPLIT>(X3, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_H1), 0, HD, stage, nst, to_smem(Pb, ldw, nullptr, false));  // dy2
      mul_gelu_grad(Pb, ldw, ws + d.w_q2, HD);                                                               // dq2
      if (wgr) {  // dp_w2 = t1^T dq2, t1 recomputed from q1 into W2
        ln_gelu(ws + d.w_q1, HD, W2, ldw, 1, HD);
        gemm<WN, true, B_KN_SMEM>(Pb, ldw, HD, TILE, W2, ldw, HD, stage, nst, to_part_t(pw + d.w_off[12], HD, first_w));
        col_sums(Pb, ldw, HD, HD, pw + d.w_off[13], first_w);
      }
      gemm<WN, false, B_SPLIT>(Pb, ldw, TILE, HD, wsplit(SPLIT_T + SPLIT_P2), 0, HD, stage, nst, to_smem(W2, ldw, nullptr, false));  // dt1
      ln_gelu_vjp(W2, ldw, ws + d.w_q1, HD, 1, HD);                                                        // dq1
      if (wgr) {  // dp_w1 = y1^T dq1
        gemm<WN, true, B_KN>(W2, ldw, HD, TILE, ws + d.w_y1, HD, HD, stage, nst, to_part_t(pw + d.w_off[10], HD, first_w));
        col_sums(W2, ldw, HD, HD, pw + d.w_off[11], first_w);
      }
      gemm<WN, false, B_SPLIT>(W2, ldw, TILE, HD, wsplit(SPLIT_T + SPLIT_P1), 0, HD, stage, nst, to_smem(Pb, ldw, nullptr, false));  // dy1
      if (wgr) {  // do_w = y^T dy1
        gemm<WN, true, B_KN>(Pb, ldw, HD, TILE, ws + d.w_y, HD, HD, stage, nst, to_part_t(pw + d.w_off[8], HD, first_w));
        col_sums(Pb, ldw, HD, HD, pw + d.w_off[9], first_w);
      }
      gemm<WN, false, B_SPLIT>(Pb, ldw, TILE, HD, wsplit(SPLIT_T + SPLIT_O), 0, HD, stage, nst, to_smem(W2, ldw, nullptr, false));  // dy
    } else {
      load_g(W2, ldw, gsrc, rows, HD);
    }

    // The mixer's VJP: dm_w2 = sum_h nbar_h^T dy_h (dy_h^T nbar_h transposed), dm_b2, and
    // e_h = dy_h m_w2^T into the workspace.
    if (wgr) {
      for (int h = 0; h < H; ++h)
        gemm<WN, true, B_KN>(W2 + h * D, ldw, D, TILE, ws + d.w_n + h * hidm, HH, hidm, stage, nst,
                             to_part_t(pw + d.w_off[6], D, first_w && h == 0));
      col_sums(W2, ldw, HD, D, pw + d.w_off[7], first_w);
    }
    for (int h = 0; h < H; ++h) {
      float* e = ws + d.w_e + h * hidm;
      gemm<WN, false, B_SPLIT>(W2 + h * D, ldw, TILE, D, wsplit(SPLIT_T + SPLIT_M), 0, hidm, stage, nst,
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
      gemm<WN, false, B_SPLIT>(X1, ldh, TILE, hid, wsplit(SPLIT_V), 0, hid, stage, nst, to_smem(X2, ldh, P.v_b1, true));  // hv
      gemm<WN, false, B_SPLIT>(X2, ldh, TILE, hid, wsplit(SPLIT_F), 0, hid, stage, nst, to_smem(X1, ldh, P.fb, false));     // u
      ln_gelu(X1, ldh, X3, ldh, 1, hid);                                                                   // t
      gemm<WN, false, B_KN>(X3, ldh, TILE, hid, Gz, HH, HH, stage, nst, to_smem(Pb, ldw, P.c + bz * HH, false));  // pre
      // dpre from dn = p e, and dp = <e, nn>, per head.
      ln_gelu_vjp(Pb, ldw, Pb, ldw, H, hidm, ws + d.w_e, HH, s_prob + z * TILE * H, s_dlog + z * TILE * H);
      gemm<WN, true, B_KN_SMEM>(X3, ldh, hid, TILE, Pb, ldw, HH, stage, nst, to_part(pG + (size_t)z * hid * HH, HH, first_row));
      col_sums(Pb, ldw, HH, HH, pc + (size_t)z * HH, first_row);
      gemm<WN, false, B_NK>(Pb, ldw, TILE, HH, Gz, HH, hid, stage, nst, to_smem(X3, ldh, nullptr, false));  // dt
      ln_gelu_vjp(X3, ldh, X1, ldh, 1, hid);                                                            // du
      if (wgr) {  // dfw = hv^T du
        gemm<WN, true, B_KN_SMEM>(X2, ldh, hid, TILE, X3, ldh, hid, stage, nst, to_part(pw + d.w_off[4], hid, first_w && z == 0));
        col_sums(X3, ldh, hid, hid, pw + d.w_off[5], first_w && z == 0);
      }
      gemm<WN, false, B_SPLIT>(X3, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_F), 0, hid, stage, nst, to_smem(X1, ldh, nullptr, false));  // dhv
      relu_mask(X1, ldh, X2, ldh, hid);
      if (wgr) {  // dv_w1 = F^T dhv, the features recomputed into X2
        rff(s_inv, I, P.v_coeff, half, X2, ldh);
        gemm<WN, true, B_KN_SMEM>(X2, ldh, hid, TILE, X1, ldh, hid, stage, nst, to_part(pw + d.w_off[2], hid, first_w && z == 0));
        col_sums(X1, ldh, hid, hid, pw + d.w_off[3], first_w && z == 0);
      }
      gemm<WN, false, B_SPLIT>(X1, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_V), 0, hid, stage, nst, to_smem(X3, ldh, nullptr, false));  // dF
      rff_vjp(s_inv, I, P.v_coeff, half, X3, ldh, P.dinv + (bz * C + c0) * I, rows, false);
    }
    softmax_vjp(s_prob, s_dlog, Z, H);

    // 5. Per latent: the query chain again, then its VJP.
    for (int z = 0; z < Z; ++z) {
      const size_t bz = (size_t)b * Z + z;
      load_inv(s_inv, P.inv + (bz * C + c0) * I, rows, I);
      rff(s_inv, I, P.q_coeff, half, X1, ldh);
      gemm<WN, false, B_SPLIT>(X1, ldh, TILE, hid, wsplit(SPLIT_Q), 0, hid, stage, nst, to_smem(X2, ldh, P.q_b1, true));  // hq
      logit_vjp(X2, ldh, hid, s_dlog + z * TILE * H, H, P.A + bz * hid * H, pA + (size_t)z * hid * H,
                pab + (size_t)z * H, P.dwb + bz * C + c0, rows, first_row, X3, ldh);                       // dhq
      if (wgr) {  // dq_w1 = F^T dhq
        gemm<WN, true, B_KN_SMEM>(X1, ldh, hid, TILE, X3, ldh, hid, stage, nst, to_part(pw + d.w_off[0], hid, first_w && z == 0));
        col_sums(X3, ldh, hid, hid, pw + d.w_off[1], first_w && z == 0);
      }
      gemm<WN, false, B_SPLIT>(X3, ldh, TILE, hid, wsplit(SPLIT_T + SPLIT_Q), 0, hid, stage, nst, to_smem(X2, ldh, nullptr, false));  // dF
      rff_vjp(s_inv, I, P.q_coeff, half, X2, ldh, P.dinv + (bz * C + c0) * I, rows, true);
    }
  }
}

// Pass 2: out = [dA | dab | dG | dc] over all rows (each [B, Z, ...]), then the weight
// gradients; each element sums its partials in block order: a row's slots in the blocks whose
// runs touch it, a weight's in every block.
__global__ void fused_decode_bwd_reduce(const float* __restrict__ part, float* __restrict__ out, const Dims d) {
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
      const long long k0 = b * d.nt / d.ipb, k1 = ((b + 1) * d.nt - 1) / d.ipb;
      for (long long k = k0; k <= k1; ++k) {
        const long long slot = b - k * d.ipb / d.nt;
        s += part[k * d.part + slot * d.l_row + sec_off + e];
      }
    } else {
      const long long e = (long long)d.slots * d.l_row + (o - n_row);
      for (long long k = 0; k < d.grid; ++k) s += part[k * d.part + e];
    }
    out[o] = s;
  }
}

// The launcher's hooks (fused_decode_bwd_host.cuh): threads of `weights_kernel` (one a float of
// the split weights) and floats of the reduced output.
inline long long weight_threads(const Dims& d) { return d.split_total; }
inline long long out_floats(const Dims& d) { return d.l_w; }
// No design of its own beside the width classes.
inline long long work_floats(const Dims& d) { return d.split_total + (long long)d.grid * d.work; }
inline long long part_floats(const Dims& d) { return (long long)d.grid * d.part; }
inline bool own_design(const Dims&) { return false; }
inline cudaError_t prepare_own(Dims&, int*) { return cudaErrorNotSupported; }
inline void own_plan(Dims&, int, int) {}
inline cudaError_t launch_own(const Params&, cudaStream_t) { return cudaErrorNotSupported; }

}  // namespace

#include "fused_decode_bwd_host.cuh"  // the launcher's C interface (shared with the bf16 program)
