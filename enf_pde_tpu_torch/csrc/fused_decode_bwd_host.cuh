// Fused ENF decode, backward (kernel K2): the launcher's C interface, shared by its two programs
// (fused_decode_bwd.cu, fused_decode_bwd_bf16.cu). Each source includes it last, after its
// kernels (`weights_kernel<WN>`, which lays the shared weights out, `fused_decode_bwd_kernel<WN>`
// and `fused_decode_bwd_reduce`), its Dims and `shape`, and the hooks `weight_threads`, `out_floats`,
// `work_floats`, `part_floats` and, for the designs of the program's own beside its width classes (the
// bf16 program's W128 and narrow designs), `own_design`, `prepare_own`, `own_plan` and `launch_own`
// (fused_decode_bwd_common.cuh holds the rest that they share). K2_CLASS64_ONLY: the class design is
// instantiated at the width class 64 alone (the bf16 program's narrow design takes the others).

#pragma once

namespace {

// The grid: as many blocks as the SMs hold at once (per_sm of them on each of sms), or one per
// MIN_IPB items when there are fewer; each takes a contiguous run of ipb items.
inline void plan(Dims& d, int per_sm, int sms) {
  d.per_sm = per_sm;
  long long most = (long long)per_sm * sms;
  const long long few = (d.items + MIN_IPB - 1) / MIN_IPB;
  most = most < few ? most : few;
  most = most < 1 ? 1 : most;
  const long long g = d.items < most ? d.items : most;
  d.ipb = (int)((d.items + g - 1) / g);
  d.grid = (int)((d.items + d.ipb - 1) / d.ipb);
  d.slots = (d.ipb + d.nt - 2) / d.nt + 1;  // batch rows a run of ipb items can touch
  d.slots = d.slots > d.B ? d.B : d.slots;
  d.part = d.slots * d.l_row + d.l_w;
}

// Sets the kernel's shared memory; with `per_sm`, the blocks an SM holds at that size.
template <int WN>
cudaError_t prepare(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(fused_decode_bwd_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_decode_bwd_kernel<WN>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && per_sm)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_decode_bwd_kernel<WN>, THREADS, smem);
  return err;
}

cudaError_t prepare_class(int wn, size_t smem, int* per_sm) {
  switch (wn) {
    case 64: return prepare<64>(smem, per_sm);
#ifndef K2_CLASS64_ONLY
    case 32: return prepare<32>(smem, per_sm);
    case 16: return prepare<16>(smem, per_sm);
    default: return prepare<8>(smem, per_sm);
#else
    default: return cudaErrorInvalidValue;
#endif
  }
}

// shape + the grid the card holds; cudaErrorInvalidValue for shapes the kernel does not take.
cudaError_t layout(const int* dims, int n_dims, Dims& d) {
  if (n_dims != kNumDims || !shape(dims, d)) return cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = own_design(d) ? prepare_own(d, &per_sm) : prepare_class(d.wn, (size_t)d.smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan(d, per_sm, sms);
  if (own_design(d)) own_plan(d, per_sm, sms);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dims: B, Z, C, I, hid, H, D, hidm, out_dim, with_tail, weight_grads.
// sizes <- floats of the reduced output, of the workspace and of the partials.
int fused_decode_bwd_sizes(const int* dims, int n_dims, long long* sizes) {
  Dims d;
  const cudaError_t err = layout(dims, n_dims, d);
  if (err != cudaSuccess) return (int)err;
  sizes[0] = (long long)d.B * d.l_row + out_floats(d);
  sizes[1] = work_floats(d);
  sizes[2] = part_floats(d);
  return 0;
}

// out <- the dynamic shared memory in bytes, the blocks an SM, the grid, the row slots a block
// and the floats of scratch (workspace and partials) of a launch with these dims. Returns the
// cudaError_t (cudaErrorInvalidValue for shapes the kernel does not take); sets the kernel's
// attributes as a launch does.
int fused_decode_bwd_occupancy(const int* dims, int n_dims, long long* out) {
  Dims d;
  const cudaError_t err = layout(dims, n_dims, d);
  if (err != cudaSuccess) return (int)err;
  out[0] = d.smem;
  out[1] = d.per_sm;
  out[2] = d.grid;
  out[3] = d.slots;
  out[4] = work_floats(d) + part_floats(d);
  return 0;
}

// ptrs: inv, wb, A, ab, G, c, the 10 folded weights, the 12 tail weights (null
// without the tail), g, dinv, dwb, out (reduced gradients), workspace, partials;
// sized by `fused_decode_bwd_sizes`. Launches the three passes on `stream` and returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape the kernel does not take, or
// for G or the workspace not starting on 16 bytes).
int fused_decode_bwd_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                            void* stream) {
  Params P;
  if (n_ptrs != kNumPtrs) return (int)cudaErrorInvalidValue;
  cudaError_t err = layout(dims, n_dims, P.d);
  if (err != cudaSuccess) return (int)err;
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
  // G is read a float4 at a time (the B of dpre G^T), the workspace copied by 16-byte cp.async.
  if (!aligned16(P.G) || !aligned16(P.work)) return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (own_design(P.d)) return (int)launch_own(P, s);  // the design's own passes, its reduction included
  const size_t smem = (size_t)P.d.smem;
  long long sb = (weight_threads(P.d) + THREADS - 1) / THREADS;
  const int split_blocks = (int)(sb > 1024 ? 1024 : sb);
  switch (P.d.wn) {
    case 64:
      weights_kernel<64><<<split_blocks, THREADS, 0, s>>>(P);
      fused_decode_bwd_kernel<64><<<P.d.grid, THREADS, smem, s>>>(P);
      break;
#ifndef K2_CLASS64_ONLY
    case 32:
      weights_kernel<32><<<split_blocks, THREADS, 0, s>>>(P);
      fused_decode_bwd_kernel<32><<<P.d.grid, THREADS, smem, s>>>(P);
      break;
    case 16:
      weights_kernel<16><<<split_blocks, THREADS, 0, s>>>(P);
      fused_decode_bwd_kernel<16><<<P.d.grid, THREADS, smem, s>>>(P);
      break;
    default:
      weights_kernel<8><<<split_blocks, THREADS, 0, s>>>(P);
      fused_decode_bwd_kernel<8><<<P.d.grid, THREADS, smem, s>>>(P);
      break;
#else
    default:
      return (int)cudaErrorInvalidValue;
#endif
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)P.d.B * P.d.l_row + out_floats(P.d);
  long long blocks = (total + THREADS - 1) / THREADS;
  blocks = blocks > 4096 ? 4096 : (blocks < 1 ? 1 : blocks);
  fused_decode_bwd_reduce<<<(int)blocks, THREADS, 0, s>>>(P.part, P.out, P.d);
  return (int)cudaGetLastError();
}

const char* fused_decode_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
