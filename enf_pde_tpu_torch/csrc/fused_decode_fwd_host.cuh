// Fused ENF decode, forward (kernel K1): the launcher's C interface, shared by its two programs
// (fused_decode_fwd.cu, fused_decode_fwd_bf16.cu). Each source includes it last, after its
// kernel `fused_decode_fwd_kernel<WN, WITH_TAIL>` and its `layout` (fused_decode_fwd_common.cuh
// holds the rest that they share).

#pragma once

namespace {

// The shape dims of the launcher's interface into P.
void set_dims(Params& P, const int* dims) {
  P.B = dims[0]; P.Z = dims[1]; P.C = dims[2]; P.I = dims[3]; P.hid = dims[4];
  P.H = dims[5]; P.D = dims[6]; P.hidm = dims[7]; P.out_dim = dims[8];
  P.lg_global = 0;
  P.lg = nullptr;
  P.tile = TILE;
}

// The instantiation that launches class `cls`: the class itself, or, where the program defines
// K1_WIDE_CLASS (the bf16 one), that instantiation for hidm or D past WG_N at the class WG_N.
inline int instance(const Params& P, int cls) {
#ifdef K1_WIDE_CLASS
  if (cls == WG_N && (P.hidm > WG_N || P.D > WG_N)) return K1_WIDE_CLASS;
#endif
  return cls;
}

// Sets the kernel's shared memory (and, narrow, asks for the largest carve-out, so that
// several blocks fit an SM); with `per_sm`, the blocks an SM holds at that size.
template <int WN, bool TAIL>
cudaError_t prepare(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(fused_decode_fwd_kernel<WN, TAIL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && WN < WG_N)
    err = cudaFuncSetAttribute(fused_decode_fwd_kernel<WN, TAIL>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && per_sm)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_decode_fwd_kernel<WN, TAIL>, THREADS, smem);
  return err;
}

// One block per (tile, batch row), or (`persistent_class`) persistent blocks, as many as the SMs
// hold at once (the class 128: one an SM, whatever more would fit), or one per work item when there
// are fewer, an item `item_tile` coordinates of a batch row.
template <int WN, bool TAIL>
cudaError_t launch(Params P, size_t smem, cudaStream_t s) {
  dim3 grid((P.C + TILE - 1) / TILE, P.B);
  const bool persistent = persistent_class(WN);
  int per_sm = 0;
  cudaError_t err = prepare<WN, TAIL>(smem, persistent ? &per_sm : nullptr);
  if (err != cudaSuccess) return err;
  if (persistent) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (WN >= WG_N) per_sm = 1;  // a block's slot of the logits workspace: one an SM
#ifdef K1_NARROW_SLOTS
    else if (K1_NARROW_SLOTS(WN, smem) < per_sm) per_sm = K1_NARROW_SLOTS(WN, smem);  // and BLOCKS<class>
#endif
    const long long most = (long long)per_sm * sms;
    P.tile = item_tile(WN < WG_N ? WN : WG_N, P.B, P.C, most);
    const long long items = (long long)P.B * ((P.C + P.tile - 1) / P.tile);
    grid = dim3((unsigned)(items < most ? items : most));
  }
  fused_decode_fwd_kernel<WN, TAIL><<<grid, THREADS, smem, s>>>(P);
  return cudaGetLastError();
}

// `launch` or `prepare` of the instantiation for class `cls` and the tail flag.
template <template <int, bool> class F, class... Args>
cudaError_t by_class(int cls, bool tail, Args... args) {
  switch (cls) {
    case 16: return tail ? F<16, true>::run(args...) : F<16, false>::run(args...);
    case 32: return tail ? F<32, true>::run(args...) : F<32, false>::run(args...);
    case 64: return tail ? F<64, true>::run(args...) : F<64, false>::run(args...);
#ifdef K1_WIDE_CLASS
    case K1_WIDE_CLASS: return tail ? F<K1_WIDE_CLASS, true>::run(args...) : F<K1_WIDE_CLASS, false>::run(args...);
#endif
    default: return tail ? F<WG_N, true>::run(args...) : F<WG_N, false>::run(args...);
  }
}
template <int WN, bool TAIL>
struct Launch {
  static cudaError_t run(const Params& P, size_t smem, cudaStream_t s) { return launch<WN, TAIL>(P, smem, s); }
};
template <int WN, bool TAIL>
struct Prepare {
  static cudaError_t run(size_t smem, int* per_sm) { return prepare<WN, TAIL>(smem, per_sm); }
};

}  // namespace

extern "C" {

// ptrs: inv, wb, A, ab, G, c, the 10 folded weights, the 12 tail weights (null without
// the tail), out, then the blocks of q_w1, v_w1, fw and m_w2 (split_weights' tf32 parts in the
// f32 program, bf16_weights' in the bf16 one); then, for a bf16 launch whose logits do not fit
// shared memory (`layout`), the logits workspace: B ceil(C / TILE) Z TILE H floats, or at the bf16
// program's class 128 a slot of Z 64 H floats for each block of the grid (`fused_decode_fwd_plan`).
// dims: B, Z, C, I, hid, H, D, hidm, out_dim, with_tail. Launches on `stream` and returns
// the cudaError_t of the launch (cudaErrorInvalidValue for shapes it does not take, or for a
// weight staged by cp.async (G, the blocks, the tail's wide weights) that does not start
// on 16 bytes, or for a launch that needs the workspace and was given none).
int fused_decode_fwd_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                            void* stream) {
  if ((n_ptrs != kNumPtrs && n_ptrs != kNumPtrs + 1) || n_dims != kNumDims) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  Params P;
  P.inv = f[0]; P.wb = f[1]; P.A = f[2]; P.ab = f[3]; P.G = f[4]; P.c = f[5];
  P.q_coeff = f[6]; P.q_b1 = f[8]; P.v_coeff = f[9]; P.v_b1 = f[11]; P.fb = f[13]; P.m_b2 = f[15];
  P.o_w = f[16]; P.o_b = f[17]; P.p_w1 = f[18]; P.p_b1 = f[19]; P.p_w2 = f[20]; P.p_b2 = f[21];
  P.h_w1 = f[22]; P.h_b1 = f[23]; P.h_w2 = f[24]; P.h_b2 = f[25]; P.h_w3 = f[26]; P.h_b3 = f[27];
  P.out = const_cast<float*>(f[28]);
  P.q_w1s = f[29]; P.v_w1s = f[30]; P.fws = f[31]; P.m_w2s = f[32];
  set_dims(P, dims);
  const bool with_tail = dims[9] != 0;
  size_t smem = 0;
  int cls = 0;
  if (!layout(P, with_tail, &smem, &cls)) return (int)cudaErrorInvalidValue;
  if (P.lg_global) {
    if (n_ptrs == kNumPtrs || !f[kNumPtrs]) return (int)cudaErrorInvalidValue;
    P.lg = const_cast<float*>(f[kNumPtrs]);
  }
  // The weights staged by 16-byte cp.async must start on 16 bytes.
  const float* staged[] = {P.G, P.q_w1s, P.v_w1s, P.fws, P.m_w2s, P.o_w, P.p_w1, P.p_w2, P.h_w1, P.h_w2};
  for (int i = 0; i < (with_tail ? 10 : 5); ++i)
    if (!aligned16(staged[i])) return (int)cudaErrorInvalidValue;
  if (P.B == 0 || P.C == 0) return (int)cudaSuccess;
  return (int)by_class<Launch>(instance(P, cls), with_tail, (const Params&)P, smem, static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a launch with these dims takes, or -1 for shapes the
// kernel does not take (the launcher's dims).
long long fused_decode_fwd_smem_bytes(const int* dims, int n_dims) {
  if (n_dims != kNumDims) return -1;
  Params P;
  set_dims(P, dims);
  size_t smem = 0;
  int cls = 0;
  return layout(P, dims[9] != 0, &smem, &cls) ? (long long)smem : -1;
}

// For a launch with these dims: out[0] its width class, out[1] the blocks of it an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory; a narrow launch's grid
// is that times the SMs). Returns the cudaError_t (cudaErrorInvalidValue for shapes it does
// not take); sets the kernel's attributes as a launch does.
int fused_decode_fwd_occupancy(const int* dims, int n_dims, int* out) {
  if (n_dims != kNumDims) return (int)cudaErrorInvalidValue;
  Params P;
  set_dims(P, dims);
  size_t smem = 0;
  int cls = 0;
  if (!layout(P, dims[9] != 0, &smem, &cls)) return (int)cudaErrorInvalidValue;
  out[0] = cls;
  out[1] = 0;
  return (int)by_class<Prepare>(instance(P, cls), dims[9] != 0, smem, out + 1);
}

// For a launch with these dims: out[0] its width class, out[1] the blocks of it an SM holds (at most
// K1_NARROW_SLOTS where the program caps them), out[2] the coordinates a work item takes and out[3] the grid,
// as `launch` plans them on this device.
// Returns the cudaError_t (cudaErrorInvalidValue for shapes it does not take).
int fused_decode_fwd_plan(const int* dims, int n_dims, int* out) {
  int occ[2];
  const int rc = fused_decode_fwd_occupancy(dims, n_dims, occ);
  if (rc != (int)cudaSuccess) return rc;
  Params P;
  set_dims(P, dims);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = occ[0];
  out[1] = occ[1];
  out[2] = TILE;
  out[3] = (P.C + TILE - 1) / TILE * P.B;
  if (persistent_class(occ[0])) {
#ifdef K1_NARROW_SLOTS
    if (occ[0] < WG_N) {
      size_t smem = 0;
      int cls = 0;
      layout(P, dims[9] != 0, &smem, &cls);
      if (K1_NARROW_SLOTS(occ[0], smem) < occ[1]) out[1] = occ[1] = K1_NARROW_SLOTS(occ[0], smem);
    }
#endif
    const long long most = (long long)(occ[0] == WG_N ? 1 : occ[1]) * sms;
    out[2] = item_tile(occ[0], P.B, P.C, most);
    const long long items = (long long)P.B * ((P.C + out[2] - 1) / out[2]);
    out[3] = (int)(items < most ? items : most);
  }
  return (int)cudaSuccess;
}

const char* fused_decode_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
