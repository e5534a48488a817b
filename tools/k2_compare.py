"""Kernel K2 against earlier builds of it and its plain version, on one card.

    python3 tools/k2_compare.py [--old path/to/fused_decode_bwd_old.cu ...] [--skip PHASE ...]
        [--skip-base path/to/source.cu] [--variant V ...] [--shape NAME ...] [--f64] [--dtype f32|bf16|both]

Builds ``enf_pde_tpu_torch/csrc/fused_decode_bwd.cu`` (and each ``--old``, a source with
the same C interface, named by its file name; for each ``--skip`` a copy of the current
source, or of ``--skip-base``, that leaves one phase out (``SKIPS``: its results are wrong,
its time says what the phase costs); for each ``--variant`` a copy of the current source
built to another design (``VARIANTS``)) with plain ``nvcc`` in parallel, and prints the
compiler's register and spill report. At each ``--shape`` (repeatable; ``navier_stokes`` by
default) it holds every build against the plain version (autograd over the plain decode)
in all four modes (tail / no tail x with / without weight gradients), each gradient
tensor's rel-L2 on one line (the cotangent 0 at the points near a ReLU's kink, as
``chip_smoke.py`` checks), prints each build's scratch bytes per launch (workspace and
partials, from its ``fused_decode_bwd_sizes``) and, where the build reports them, its
shared memory, blocks an SM and grid, then times them in turns -- plain, old, variants,
new, new, variants, old, plain -- with and without weight gradients, beside the bounds:
f32 on the CUDA cores and 3xTF32 on the tensor cores by operations, and by bytes. A shape
is a config's ode step (batch x ``traj_len_train`` frames x ``max_num_sampled_points``:
``navier_stokes`` 80 x 512, ``shallow_water`` 10 x 2048, ``diffusion_plane`` 80 x 1024,
``cahn_hilliard`` 80 x 2048, ``diff_sphere`` 20 x 2048, ``ihc`` 10 x 2048,
``navier_stokes_nonmaml`` 80 x 2048), ``rollout``, the Navier-Stokes step at the
50-frame horizon (400 x 512), or a narrow config's nef step or fit on ``nef.backend: pallas``
(``<config>_nef`` / ``<config>_fit``: ``diffusion_plane`` 32 / 8 x 1024, ``cahn_hilliard`` 24 / 8 x 2048,
``diff_sphere`` 8 / 2 x 2048, ``ihc`` 2 / 1 x 2048). With ``--f64``, also holds every build and the plain f32
version against the plain version in float64 (the whole cotangent, at the first shape) and
prints the largest dinv differences beside the points' ReLU margins. Prints the card's name
and power limit. Exits 1 when the new build misses the rel-L2 tolerance of
``chip_smoke.py``, or two of its launches on the same inputs differ in a bit.

``--dtype bf16`` (or ``both``) also builds the bf16 program, ``fused_decode_bwd_bf16.cu`` ("new16"),
holds it against the plain bf16 version with ``chip_smoke.py``'s bf16 gates (``k2_bf16_check``:
the cotangent 0 within ``BF16_TIE_MARGIN`` of a kink, two launches bit for bit) in the tail mode with
and without weight gradients, and times it in the same turns beside its bound at the bf16
tensor-core rate. ``--dtype both`` applies ``--old``, ``--skip`` and ``--variant`` to the f32 program;
``--dtype bf16`` leaves the f32 program out and applies them to the bf16 program: ``--skip`` a phase of
``SKIPS16`` (the earlier design's ``*_old`` with ``--skip-base`` its source, the current design's
without), ``--variant`` one of ``VARIANTS16`` (``copy``: the same program built from its expanded text,
the spread between two builds), ``--old`` an earlier bf16 source. Each bf16 build but the skips is held
against the plain bf16 version with phase 35's gates, two of its launches bit for bit and dinv ... dc
the same bits with and without weight gradients. For every build the layout line prints its shared
memory, blocks an SM, grid, items a block and scratch bytes. An ``--old`` build of the program under test
is also compared with it bit for bit (the tail mode with weight gradients: a ``[same]`` line).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.ops import cuda_lib  # noqa: E402
from enf_pde_tpu_torch.ops import fused_decode as fd  # noqa: E402

# Shape name -> (config, frames or None for the config's ode step). ``<config>_nef`` / ``<config>_fit``: the
# nef step's and the fit's K2 launch on ``nef.backend: pallas`` (batch x fit_on_num_steps, batch; phase 35's).
SHAPES = {
    "navier_stokes": ("navier_stokes", None),
    "shallow_water": ("shallow_water", None),
    "rollout": ("navier_stokes", cs.NUM_SIGNALS * cs.LONG_HORIZON),
    "diffusion_plane": ("diffusion_plane", None),
    "cahn_hilliard": ("cahn_hilliard", None),
    "diff_sphere": ("diff_sphere", None),
    "ihc": ("ihc", None),
    "navier_stokes_nonmaml": ("navier_stokes_nonmaml", None),
    "diffusion_plane_nef": ("diffusion_plane", 32), "diffusion_plane_fit": ("diffusion_plane", 8),
    "cahn_hilliard_nef": ("cahn_hilliard", 24), "cahn_hilliard_fit": ("cahn_hilliard", 8),
    "diff_sphere_nef": ("diff_sphere", 8), "diff_sphere_fit": ("diff_sphere", 2),
    "ihc_nef": ("ihc", 2), "ihc_fit": ("ihc", 1),
}

_ALL = -1  # an edit's occurrence: every one
_ANY = -2  # every one, and none is no error (a part that an older source does not have)
# Phase -> edits (text of the source, its replacement, which occurrence or _ALL); each
# leaves that phase out of a build. The PR 17 build (3xTF32 mma.sync on 32-row tiles,
# per-block partials of 1,280 blocks; ``--skip-base`` its source):
SKIPS = {
    # the mma of every product (its operand loads and staging stay)
    "mma_sync": [("mma_3xtf32(part, ab[mi], as[mi], bb, bs);",
                  "part[0] += __uint_as_float(ab[mi][0] ^ as[mi][3] ^ bb[1] ^ bs[0]);", _ALL)],
    # the forward layers and input gradients, staging and mma (dense_tc's chunk loops)
    "dense_tc": [("      for (int k0 = 0; k0 < K; k0 += TC_KC) {",
                  "      for (int k0 = 0; k0 < K && K < 0; k0 += TC_KC) {", _ALL)],
    # the row contractions: weight gradients and dG (tn_tc's row loop)
    "tn_tc": [("      for (int r0 = 0; r0 < R; r0 += TN_RC) {",
               "      for (int r0 = 0; r0 < R && R < 0; r0 += TN_RC) {", 0)],
    # every weight gradient (its row contraction and bias sums)
    "wgrad": [("                      float* dW, float* db, float* S, bool add) {",
               "                      float* dW, float* db, float* S, bool add) {\n  if (K > 0) return;", 0)],
    # the LayerNorm-gelu passes and their VJPs
    "rownorm": [("  for (int r0 = warp; r0 < TILE * segs; r0 += 2 * WARPS) {",
                 "  for (int r0 = warp; r0 < TILE * segs && segs < 0; r0 += 2 * WARPS) {", _ALL),
                ("  for (int r = warp; r < TILE * segs; r += WARPS) {",
                 "  for (int r = warp; r < TILE * segs && segs < 0; r += WARPS) {", _ALL)],
    # the tail's gelu passes and the ReLU / gelu masks of the VJPs
    "elementwise": [("  for (int t = warp; t < TILE; t += WARPS)\n#pragma unroll 4",
                     "  for (int t = warp; t < TILE && width < 0; t += WARPS)\n#pragma unroll 4", _ALL)],
    "rff": [("    sincosf(TWO_PI * proj, &s, &co);", "    s = proj; co = 1.0f - proj;", 0)],
    # the softmax VJP (dp = <dy, v> per latent and head)
    "softmax_vjp": [("    for (int i0 = (tid >> 5) * 4; i0 < Z * TILE * H; i0 += WARPS * 4) {",
                     "    for (int i0 = (tid >> 5) * 4; i0 < Z * TILE * H && Z < 0; i0 += WARPS * 4) {", 0)],
    # pass 2, the reduction of the partials
    "reduce": [("  fused_decode_bwd_reduce<<<(int)blocks, THREADS, 0, s>>>(P.part, P.out, P.d);", "", 0)],
    # The PR 18 build (3xTF32 wgmma on 64-row tiles, persistent blocks):
    # every product's chunk loop (staging, wgmma, sums; each round's first chunk stays)
    "gemm": [("    for (int c = 0; c < nk; ++c) {", "    for (int c = 0; c < nk && K < 0; ++c) {", 0)],
    # the wgmma alone (fences, commits and waits stay)
    "wgmma": [('  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");',
               '  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");\n  if (accumulate >= 0) return;', 0)],
    # the staging of the chunks after each round's first (split, store, loads; the pre-split
    # weights' copies)
    "staging": [("        store(nxt);\n        if (c + 2 < nk) load(c + 2);", "", 0),
                ("      if (BMODE == B_SPLIT) copy(c + nst - 1, prv);", "", 0)],
    # the epilogues that add into the block's partials (dG, the weight gradients)
    "partials": [("  auto at = [&](int m, int n) { return p.trans", "  return;\n  auto at = [&](int m, int n) { return p.trans", 0)],
    # the LayerNorm-gelu passes and their VJPs
    "layernorm": [("  for (int base = warp * spw; base < TILE * segs; base += WARPS * spw) {",
                   "  for (int base = warp * spw; base < TILE * segs && segs < 0; base += WARPS * spw) {", _ALL)],
    # the elementwise passes (gelu, gelu', ReLU masks, workspace copies, nbar)
    "passes": [("  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {",
                "  for (int idx = threadIdx.x; idx < TILE * width && width < 0; idx += THREADS) {", _ALL),
               ("  for (int idx = threadIdx.x; idx < TILE * HH; idx += THREADS) {",
                "  for (int idx = threadIdx.x; idx < TILE * HH && HH < 0; idx += THREADS) {", 0)],
    # sin and cos of the RFF features and their VJPs
    "sincos": [("sincosf(TWO_PI * proj, &s, &co);", "s = proj; co = 1.0f - proj;", _ALL),
               ("sincosf(TWO_PI * proj, s, c);", "*s = proj; *c = 1.0f - proj;", _ANY)],
    # the CUDA-core dot products: logits, dA, bias and dc column sums
    "dots": [("    for (int k = 0; k < hid; ++k) s = fmaf(operand(hq[t * ldh + k]), operand(__ldg(Az + k * H + h)), s);",
              "", 0),
             ("    for (int t = 0; t < TILE; ++t) s = fmaf(operand(hq[t * ldh + k]), dlog[t * H + h], s);", "", 0),
             ("      for (int h = n; h < width; h += fold) s += dY[t * ld + h];", "", 0)],
}
# Other designs of the current source, right and timed beside it: a ring of two chunk buffers at
# the class 64 too (the pre-split weights copied one chunk ahead) instead of three; the narrow width classes with
# room for one block an SM (255 registers a thread, no spills) instead of two.
VARIANTS = {
    "ring2": [("  for (d.stages = d.wn == 64 ? 3 : 2; d.stages >= 2; --d.stages) {",
               "  for (d.stages = 2; d.stages >= 2; --d.stages) {", 0)],
    "minb1": [("constexpr int MINB32 = 2;", "constexpr int MINB32 = 1;", 0), ("constexpr int MINB16 = 2;", "constexpr int MINB16 = 1;", 0),
              ("constexpr int MINB8 = 2;", "constexpr int MINB8 = 1;", 0)],
}


# The bf16 program's phases, each left out of a copy by its edits (timing only). The earlier design (at
# b9553c7; ``--skip-base`` its source: the f32 program's with bf16 products, a block barrier and a fresh
# accumulator a 16-deep chunk, A's fragments loaded from f32 shared memory and rounded or split in three
# each chunk, row passes over f32 shared memory): every product's chunk loop, the wgmma instructions, the
# staging of B after each product's first chunk, the adds of each chunk's fresh accumulator into the f32
# sums, the block barrier a chunk, A's fragment loads and three-way splits, the LayerNorm passes and their
# VJPs, the elementwise passes, the adds into the block's partials, the CUDA-core dots, the RFF features'
# sin and cos, pass 2.
SKIPS16 = {
    "gemm_old": SKIPS["gemm"],
    "wgmma_old": SKIPS["wgmma"],
    "staging_old": SKIPS["staging"],
    "fresh_old": [("      for (int i = 0; i < NACC; ++i) sum[i] += f0[i];", "", 0)],
    "chunkbar_old": [("      __syncthreads();  // the next chunk is staged; everyone is done with this one", "", 0)],
    "afrag_old": [("            v[4 * q + e] = m0 < M ? A[kk * lda + m0] : 0.0f;\n"
                   "            v[4 * q + 2 + e] = m1 < M ? A[kk * lda + m1] : 0.0f;",
                   "            v[4 * q + e] = kk;\n            v[4 * q + 2 + e] = kk + 1;", 0),
                  ("            v[4 * q + e] = A[m0 * lda + kk];\n            v[4 * q + 2 + e] = A[m1 * lda + kk];",
                   "            v[4 * q + e] = kk;\n            v[4 * q + 2 + e] = kk + 1;", 0),
                  ("          split3_bf16(v[2 * r], v[2 * r + 1], t3);",
                   "          t3[0] = t3[1] = t3[2] = __float_as_uint(v[2 * r]);", 0)],
    "layernorm_old": SKIPS["layernorm"],
    "passes_old": SKIPS["passes"],
    "partials_old": SKIPS["partials"],
    "dots_old": SKIPS["dots"],
    "sincos_old": [("    rff_sincos(proj, &s, &co);", "    s = proj; co = 1.0f - proj;", 0),
                   ("      fast_sincos(proj, &s, &co, &ds, &dc);", "      s = proj; co = 1.0f - proj; ds = 1.0f; dc = -1.0f;", 0)],
    "reduce": SKIPS["reduce"],
}
# The current design's (the W128 design, `fused_decode_bwd_w128`: bf16 operand planes in shared memory, every product
# a wgmma from them, its columns split between the warpgroups, the LayerNorm VJPs in the epilogues): the
# products' chunk loops, the row contractions (dG and the weight gradients), the wgmma instructions, the ring's
# copies, the warpgroup barrier a chunk, the row sums' exchange between the warpgroups, the column sums (bias
# gradients, dc), the RFF features and their VJP, G's bf16 blocks (pass 0), the tail (its forward and VJP), the
# row contractions' loads and stores of the partials (dG, the weight gradients).
SKIPS16.update({
    "products": [("  for (int c = 0; c < g.nc; ++c) {\n    cp_async_wait<W128_STAGES - 3>();",
                  "  for (int c = 0; c < g.nc && g.nks < 0; ++c) {\n    cp_async_wait<W128_STAGES - 3>();", 0)],
    "rows": [("  for (int u = wg; u < units; u += 2) {", "  for (int u = wg; u < units && M < 0; u += 2) {", 0)],
    "w128wgmma": [("__device__ __forceinline__ void wgmma_ss(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {",
                 "__device__ __forceinline__ void wgmma_ss(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {\n"
                 "  if (accumulate >= 0) return;", 0)],
    "ring": [("      cp_async16(st + q * 512 + 4 * g.lt, g.src + ((size_t)ks * g.nsl + s) * 512 + 4 * g.lt);", "", 0)],
    "ringbar": [("    wg_bar(g.bar);                   // everyone's; chunk c - 2's products are complete", "", 0)],
    "exchange": [("  if (!cross) return;\n  float* buf", "  return;\n  float* buf", 0)],
    "colsums": [("  for (int n = threadIdx.x; n < 128 * NP; n += THREADS) {", "  for (int n = threadIdx.x; n < 128 * NP && NP < 0; n += THREADS) {", 0),
                ("  for (int n = threadIdx.x; n < W128_HID; n += THREADS) {\n    float s = 0.0f;",
                 "  for (int n = threadIdx.x; n < W128_HID && npl < 0; n += THREADS) {\n    float s = 0.0f;", 0)],
    "rffvjp": [("  for (int t = warp; t < TILE; t += WARPS) {\n    float acc[MAX_I];",
                "  for (int t = warp; t < TILE && I < 0; t += WARPS) {\n    float acc[MAX_I];", 0)],
    "features": [("  for (int u = threadIdx.x; u < units; u += THREADS) {", "  for (int u = threadIdx.x; u < units && I < 0; u += THREADS) {", 0)],
    "gblocks": [("  w128_g_kernel<<<(int)(gb > 4096 ? 4096 : gb), THREADS, 0, s>>>(P);", "", 0)],
    "tail": [("      w128_tail_fwd(c, rg, par, gsrc, rows, wgr, first_w, pw);\n      w128_tail_vjp(c, rg, par, gsrc, rows, wgr, first_w, pw);", "", 0)],
    "partials": SKIPS["partials"],
    "w128partials": [("      for (int j = 0; j < 8; ++j) old[h][j] = first ? make_float2(0.0f, 0.0f) : row[h][4 * j];",
                    "      for (int j = 0; j < 8; ++j) old[h][j] = make_float2(0.0f, 0.0f);", 0),
                   ("        row[h][4 * j] = first ? make_float2(", "        if (M < 0) row[h][4 * j] = first ? make_float2(", 0)],
})
# The narrow design's (`narrow_logits` ... `narrow_query_vjp`, every launch below the width class 64): the tail kernel's
# weight gradients, the loads of the partials' old values in the row contractions, the block barrier that ends each
# product, the two warpgroups' row-sum exchange, every wgmma, the RFF VJP and features, the tail's nbar, the column sums.
SKIPS16.update({
    "ntailwg": [("  const bool wgr = d.wgrad;\n  constexpr bool tail = TAIL;", "  const bool wgr = false;\n  constexpr bool tail = TAIL;", 0)],
    "nrmw": [("    if (!first && m0 + r < M) old[k] = *reinterpret_cast<const float2*>", "    if (M < 0) old[k] = *reinterpret_cast<const float2*>", 0)],
    "nsync": [("  wg_commit();\n  wg_wait0();\n  wg_fence_operands<N / 2>(acc);\n  __syncthreads();\n}",
               "  wg_commit();\n  wg_wait0();\n  wg_fence_operands<N / 2>(acc);\n}", 0)],
    "nxsum": [("  if (blockDim.x == 128) return;  // one warpgroup", "  return;  // one warpgroup", 0)],
    "nwgmma": [('  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");\n  if constexpr (N == 64) {',
                '  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma width");\n  if (accumulate >= 0) return;\n  if constexpr (N == 64) {', 0)],
    "nrffvjp": [("  for (int t = warp; t < TILE; t += blockDim.x / 32) {", "  for (int t = warp; t < TILE && I < 0; t += blockDim.x / 32) {", 0)],
    "nfeatures": [("  for (int u = threadIdx.x; u < TILE * pairs; u += blockDim.x) {", "  for (int u = threadIdx.x; u < TILE * pairs && I < 0; u += blockDim.x) {", 0)],
    "nnbar": [("    for (int i0 = threadIdx.x; i0 < TILE * HH / 2; i0 += NB * blockDim.x) {", "    for (int i0 = threadIdx.x; i0 < TILE * HH / 2 && Z < 0; i0 += NB * blockDim.x) {", 0)],
    "ncolsums": [("  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;\n#pragma unroll\n  for (int k = 0; k < N / 4; ++k) {",
                  "  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;\n  if (N > 0) return;\n#pragma unroll\n  for (int k = 0; k < N / 4; ++k) {", 0)],
})
# Other designs of the current bf16 source, right and timed beside it: ``copy``, the same program built from
# its expanded text (two builds of one long kernel differ in time: up to 14 % for K1's bf16 class 128).
VARIANTS16 = {
    "copy": [],
    "noinline": [("#define W128_PHASE __forceinline__", "#define W128_PHASE __noinline__", 0)],
}


def edited_source(label: str, base: Path, edits: list) -> tuple:
    """(label, path) of a copy of ``base`` under csrc/_build/ with ``edits``."""
    src = cuda_lib.expanded_source(base)
    for text, repl, which in edits:
        parts = src.split(text)
        if which == _ANY:
            src = repl.join(parts)
            continue
        if len(parts) <= max(which, 0) + 1:
            raise SystemExit(f"k2_compare: {label}: {text.strip()!r} is not in {base}")
        if which == _ALL:
            src = repl.join(parts)
        else:
            src = text.join(parts[:which + 1]) + repl + text.join(parts[which + 1:])
    path = cuda_lib.BUILD_DIR / f"fused_decode_bwd_{label}{'_bf16' if 'bf16' in base.name else ''}.cu"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return label, str(path)


def layout_note(sources: dict, dims: list) -> str:
    """Each build's scratch bytes per launch (workspace + partials) and, where it reports them,
    its shared memory, blocks an SM, grid, items a block and row slots."""
    parts = []
    for name, src in sources.items():
        lib = fd._bwd_lib(src)
        sizes = (ctypes.c_longlong * 3)()
        if lib.fused_decode_bwd_sizes((ctypes.c_int * len(dims))(*dims), len(dims), sizes) != 0:
            parts.append(f"{name} refuses the shape")
            continue
        note = f"{name} scratch {4 * (sizes[1] + sizes[2]) / 1e6:.1f} MB"
        if hasattr(lib, "fused_decode_bwd_occupancy"):
            lay = fd.k2_occupancy(dims, src)
            # the bf16 narrow design's items are (b, z, tile); a build's own (earlier designs') are (b, tile)
            narrow = "bf16" in Path(src).name and "narrow_query_vjp" in Path(src).read_text() \
                and fd.k2_width_class(dims[4], dims[7], dims[6]) < 64
            items = dims[0] * (dims[1] if narrow else 1) * -(-dims[2] // 64)
            note += (f", {lay['smem']} B shared, {lay['per_sm']} blocks an SM, grid {lay['grid']}, "
                     f"{-(-items // lay['grid'])} items a block, {lay['slots']} row slots a block")
        parts.append(note)
    return "; ".join(parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[],
                    help="an earlier K2 source with the same C interface (repeatable)")
    ap.add_argument("--skip", action="append", default=[], choices=sorted({*SKIPS, *SKIPS16}),
                    help="also build the source without this phase (timing only; repeatable)")
    ap.add_argument("--skip-base", default=None,
                    help="the source the --skip copies edit (default: the current one)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted({*VARIANTS, *VARIANTS16}),
                    help="also build and time this design of the current source (repeatable)")
    ap.add_argument("--iters", type=int, default=10, help="kernel launches per timed sample")
    ap.add_argument("--shape", action="append", choices=sorted(SHAPES),
                    help="a decode shape K2 runs at (repeatable; default navier_stokes)")
    ap.add_argument("--dtype", choices=("f32", "bf16", "both"), default="f32",
                    help="the programs held and timed: f32 (3xTF32), bf16, or both in the same turns")
    ap.add_argument("--f64", action="store_true",
                    help="also hold every build and the plain f32 version against the plain version in "
                         "float64, with the whole cotangent, and show the largest dinv differences")
    opts = ap.parse_args()
    bf = opts.dtype == "bf16"  # --old, --skip and --variant apply to the bf16 program
    skips, variants_of = (SKIPS16, VARIANTS16) if bf else (SKIPS, VARIANTS)
    for name in opts.skip + opts.variant:
        if name not in skips and name not in variants_of:
            raise SystemExit(f"k2_compare: {name} is not a phase or variant of the {'bf16' if bf else 'f32'} program")
    if not torch.cuda.is_available():
        print("k2_compare: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    current = cuda_lib.CSRC_DIR / (fd.BWD_KERNEL_SOURCE_BF16 if bf else fd.BWD_KERNEL_SOURCE)
    sources = {"new": str(cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE)} if not bf else {}
    if opts.dtype != "f32":
        sources["new16"] = str(cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE_BF16)
    olds = [Path(p).stem for p in opts.old]
    sources.update({name: str(Path(p).resolve()) for name, p in zip(olds, opts.old)})
    base = Path(opts.skip_base).resolve() if opts.skip_base else current
    extra = dict(edited_source(f"skip_{p}", base, skips[p]) for p in opts.skip)
    extra.update(edited_source(v, current, variants_of[v]) for v in opts.variant)
    sources.update(extra)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(cuda_lib.build, sources.values())))
    for name, path in paths.items():
        report = path.with_name(path.name.replace(".so", ".ptxas.txt")).read_text().splitlines()
        for ln in report:
            if any(w in ln for w in ("registers", "spill", "Compiling entry", "warning", "wgmma")):
                cs.log(f"[build] {name}: {ln.strip()}")
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")

    dtypes = {name: torch.bfloat16 if name == "new16" or (bf and name != "new") else torch.float32 for name in sources}
    kernels = {name: partial(fd._launch_bwd, lib=fd._bwd_lib(src), compute_dtype=dtypes[name])
               for name, src in sources.items()}
    worst, bitwise = {name: 0.0 for name in kernels}, True
    for i, shape in enumerate(opts.shape or ["navier_stokes"]):
        name, frames = SHAPES[shape]
        cfg = cs.shape_config(name)
        args, g = cs.k2_inputs(cfg, cs.config_coords(cfg), torch.device("cuda"), frames)
        inv, ws = args[0], args[6]
        B, Z, C, I = inv.shape
        H, D = cfg.nef.num_heads, cfg.nef.num_hidden
        cs.log(f"[shape] {shape}: b={B} z={Z} c={C} I={I} hid={ws[1].shape[0]} H={H} num_out={cfg.nef.num_out}")
        for wg in (False, True):
            dims = [B, Z, C, I, ws[1].shape[0], H, D, ws[8].shape[0], cfg.nef.num_out, 1, int(wg)]
            cs.log(f"[layout] K2 {shape} {'with' if wg else 'without'} weight grads: " + layout_note(sources, dims))
        for name_, bwd in kernels.items():  # a skip build's results are wrong by design
            if name_.startswith("skip_"):
                continue
            if dtypes[name_] == torch.float32:
                worst[name_] = max(worst[name_], check(cfg, args, g, f"{shape} {name_}", bwd))
                continue
            try:
                check16(cfg, args, g[True], f"{shape} {name_}", bwd)
            except (AssertionError, RuntimeError, ValueError) as e:
                cs.log(f"[check] {shape} {name_}: {e}")
                worst[name_] = float("inf")
        if "new" in kernels:
            bitwise &= repeat_check(cfg, args, g, kernels["new"], shape)
        for name_ in olds:  # an earlier build of the same program: the same bits (tail, weight gradients)?
            new = "new16" if dtypes[name_] == torch.bfloat16 else "new"
            if new in kernels:
                H_, D_ = cfg.nef.num_heads, cfg.nef.num_hidden
                a = list(flat(kernels[name_](*args, g[True], H_, D_, True)))
                b = list(flat(kernels[new](*args, g[True], H_, D_, True)))
                same = all(x is None or torch.equal(x, y) for x, y in zip(a, b))
                cs.log(f"[same] K2 {shape}: {name_} and {new} {'equal' if same else 'DIFFER'} bit for bit")
        if opts.f64 and i == 0:
            against_f64(cfg, args, g[True], {n: k for n, k in kernels.items() if n != "new16"})

        news = [n for n in ("new", "new16") if n in kernels]
        olds_ = [n for n in olds if n in kernels]
        order = ["plain", *olds_, *extra, *news, *news[::-1], *list(extra)[::-1], *olds_[::-1], "plain"]
        for wg in (False, True):
            fns = {name_: partial(bwd, *args, g[True], H, D, wg) for name_, bwd in kernels.items()}
            fns["plain"] = partial(fd.fused_decode_bwd_plain, *args, g[True], H, D, wg,
                                   compute_dtype=torch.bfloat16 if bf else torch.float32)
            samples = {name_: [] for name_ in fns}
            for name_ in order:
                iters = 3 if name_ == "plain" else opts.iters
                samples[name_].append(cs.cuda_ms(fns[name_], iters=iters, warmup=1 if name_ == "plain" else 2))
            bd = cs.k2_bounds(cfg, args, g[True], wg)
            label = "with" if wg else "without"
            cs.log(f"[timing] K2 {shape} {label} weight grads, turns {order}: " + "; ".join(
                f"{n} {', '.join(f'{v:.4f}' for v in vals)} ms (mean {statistics.mean(vals):.4f})"
                for n, vals in samples.items()))
            cs.log(f"[bound] K2 {shape} {label} weight grads: {bd['flops'] / 1e9:.3f} GFLOP, {bd['moved'] / 1e6:.3f} "
                   f"MB; f32 CUDA cores {bd['f32_ms']:.4f} ms, 3xTF32 tensor cores {bd['tc_ms']:.4f} ms, bytes "
                   f"{bd['bytes_ms']:.4f} ms; bf16 tensor cores {bd['flops'] / cs.PEAK_BF16_FLOPS * 1e3:.4f} ms; "
                      + "; ".join(f"{n} at {bd['flops'] / statistics.mean(samples[n]) / 1e9:.2f} TFLOP/s" for n in news))
        del args, g
        torch.cuda.empty_cache()
    cs.log(cs.nvidia_smi())
    return 0 if worst.get("new", 0.0) <= cs.REL_L2_TOL and worst.get("new16", 0.0) == 0.0 and bitwise else 1


def check16(cfg, args, g, name: str, bwd) -> None:
    """A bf16 build against the plain bf16 version with phase 35's gates (``chip_smoke.bf16_gates``, tail
    mode, with and without weight gradients, the cotangent 0 within ``BF16_TIE_MARGIN`` of a ReLU's kink);
    two launches bit for bit; dinv ... dc the same bits with and without weight gradients. Raises past a
    gate."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    gk = g * (~cs.relu_ties(args, cs.BF16_TIE_MARGIN))[..., None]
    first = {}
    for wg in (False, True):
        got = bwd(*args, gk, H, D, wg)
        again = bwd(*args, gk, H, D, wg)
        if not all(x is None or torch.equal(x, y) for x, y in zip(flat(got), flat(again))):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        first[wg] = got
        cs.bf16_gates(f"K2 {name} {'with' if wg else 'without'} weight grads", got,
                      fd.fused_decode_bwd_plain(*args, gk, H, D, wg, compute_dtype=torch.bfloat16),
                      fd.fused_decode_bwd_plain(*args, gk, H, D, wg), absolute=False, groups=cs.K2_GROUPS)
    same = all(torch.equal(x, y) for x, y in zip(first[False][:6], first[True][:6]))
    cs.log(f"[repeat] K2 {name}: two launches equal bit for bit; dinv ... dc {'the same' if same else 'DIFFER'} "
           "with and without weight gradients")
    if not same:
        raise AssertionError(f"{name}: dinv ... dc differ with and without weight gradients")


def repeat_check(cfg, args, g, bwd, shape: str) -> bool:
    """Two launches of ``bwd`` on the same inputs, with weight gradients and the tail: equal
    bit for bit (the partials are reduced in a fixed order, with no atomics)."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    a = list(flat(bwd(*args, g[True], H, D, True)))
    b = list(flat(bwd(*args, g[True], H, D, True)))
    same = all(x is None or torch.equal(x, y) for x, y in zip(a, b))
    cs.log(f"[repeat] K2 {shape}: two launches {'equal' if same else 'DIFFER'} bit for bit")
    return same


def check(cfg, args, g, name: str, bwd) -> float:
    """Every gradient tensor of ``bwd`` against the plain version, one line per mode
    (rel-L2 of each tensor, and where the worst one's error sits), with the cotangent 0 at
    the points ``chip_smoke.relu_ties`` finds, as ``chip_smoke.py`` holds K2 (the worst
    rel-L2 with the whole cotangent is printed too); the worst rel-L2. A build that refuses
    the shape (an older one) is reported and counts as no error."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    worst = 0.0
    keep = ~cs.relu_ties(args)
    for tail in (True, False):
        kargs = args if tail else (*args[:7], ())
        for wg in (False, True):
            try:
                whole = cs.grad_errors(bwd(*kargs, g[tail], H, D, wg),
                                       fd.fused_decode_bwd_plain(*kargs, g[tail], H, D, wg))
            except (RuntimeError, ValueError) as e:
                if name.endswith(" new"):
                    raise
                cs.log(f"[check] {name} refused: {e}")
                return 0.0
            gk = g[tail] * keep[..., None]
            got = bwd(*kargs, gk, H, D, wg)
            want = fd.fused_decode_bwd_plain(*kargs, gk, H, D, wg)
            rels = []
            for i, (x, ref) in enumerate(zip(flat(got), flat(want))):
                if ref is None:
                    continue
                rel = cs.rel_l2(x, ref) if torch.isfinite(x).all() else float("inf")
                rels.append((rel, i, x, ref))
            rel, i, x, ref = max(rels, key=lambda r: r[0])
            err = (x - ref).abs()
            cs.log(f"[check] {name} {'tail' if tail else 'no-tail'} {'with' if wg else 'without'} weight "
                   f"grads (whole cotangent: worst {whole[0]:.3e}; 0 at {int((~keep).sum())} of {keep.numel()} "
                   f"points near a ReLU's kink): worst rel_l2 {rel:.3e} (tensor {i}: max abs err {float(err.max()):.3e}, "
                   f"max |ref| {float(ref.abs().max()):.3e}, {int((err > 1e-4 * ref.abs().max()).sum())} of "
                   f"{ref.numel()} off by > 1e-4 max |ref|); all: "
                   + " ".join(f"{r:.1e}" for r, *_ in rels))
            worst = max(worst, rel)
    torch.cuda.synchronize()
    return worst


def against_f64(cfg, args, g, kernels: dict) -> None:
    """Tail mode, the whole cotangent: each build's and the plain f32 version's rel-L2 per
    gradient tensor against the plain version run in float64 on the same f32 inputs; then
    the 4 dinv entries where the new build and the plain f32 version differ most, beside
    the float64 value and the point's least ReLU margin (``chip_smoke.relu_margins``)."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden

    def f64(x):
        return tuple(f64(v) for v in x) if isinstance(x, (tuple, list)) else x.double()

    margins = cs.relu_margins(args)
    for wg in (False, True):
        ref = fd.fused_decode_bwd_plain(*f64(args), g.double(), H, D, wg)
        runs = {name: bwd(*args, g, H, D, wg) for name, bwd in kernels.items()}
        runs["plain"] = fd.fused_decode_bwd_plain(*args, g, H, D, wg)
        for name, got in runs.items():
            rels = [cs.rel_l2(x.double(), r) for x, r in zip(flat(got), flat(ref)) if r is not None]
            cs.log(f"[f64] {name} {'with' if wg else 'without'} weight grads vs float64: worst {max(rels):.3e}; "
                   "all: " + " ".join(f"{r:.1e}" for r in rels))
        if not wg:
            new, plain, want = runs["new"][0], runs["plain"][0], ref[0]
            B, Z, C, I = new.shape
            for t in torch.topk((new - plain).abs().flatten(), 4).indices.tolist():
                b, z, c, i = t // (Z * C * I), t // (C * I) % Z, t // I % C, t % I
                cs.log(f"[f64] dinv[{b},{z},{c},{i}]: new {float(new[b, z, c, i]):.6e}, plain "
                       f"{float(plain[b, z, c, i]):.6e}, float64 {float(want[b, z, c, i]):.6e}; least ReLU margin "
                       f"of the point {float(margins[b, z, c]):.2e}")


def flat(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from flat(v)
    else:
        yield x


if __name__ == "__main__":
    sys.exit(main())
