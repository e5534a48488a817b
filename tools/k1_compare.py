"""Kernel K1 against earlier builds of it and its plain version, on one card.

    python3 tools/k1_compare.py [--old path/to/fused_decode_fwd_old.cu ...] [--skip PHASE ...] [--variant V ...]
        [--shape navier_stokes|diffusion_plane|cahn_hilliard|diff_sphere|shallow_water|ihc|navier_stokes_nonmaml ...]
        [--latents Z ...]
        [--dtype f32|bf16|both]

Builds ``enf_pde_tpu_torch/csrc/fused_decode_fwd.cu``, each ``--old`` (an earlier K1
source, named by its file name; one with the 29-pointer interface from before the
pre-split weights is handed the first 29 pointers), and for each ``--skip`` a copy of the
current source that leaves one phase out (``SKIPS``: its results are wrong, its time says
what the phase costs), and for each ``--variant`` a copy built to another design
(``VARIANTS``: the class 64 with its shared weights resident, one or three blocks an SM
at the classes 16 and 32, groups of at most 4 latents at 16 and 6 at 32, a latent pair's
G products one after the other), with plain ``nvcc`` in parallel, and prints the
compiler's register, spill and ``wgmma`` report and each build's width class and blocks
an SM per shape. Holds every build against the plain version, with and without the
tail, at each ``--shape`` config's widths (``navier_stokes``, the default;
``diffusion_plane``, z = 4; ``cahn_hilliard``, z = 9; I = 2 and hid = 64 for both planar
ones; ``diff_sphere``, z = 18, I = 1, hid = 16; ``shallow_water``, z = 8 of latent 32,
I = 4, hid = 128, three outputs; ``ihc``, z = 25 of latent 32, I = 5, hid = 32, 3 heads;
``navier_stokes_nonmaml``, NS width at its validation's 160 x 2048)
and launch shapes: the forecast's and validation's 160 x chunk (512 / 1024 / 2048),
160 x 512, 80 x 512, 8 x 4096 and a ragged 8 x 1000 (for ``ihc`` also validation's
14 x 2048), and for each ``--latents`` Z the ragged 8 x 1000 with Z latents; one rel-L2
per shape and mode. Then times plain, old, variants, new, new, variants, old, plain at
160 x chunk and at the next shape (80 x 512 for Navier-Stokes, 14 x 2048 for ``ihc``,
160 x 512 for the others), the shared weights split once as the forecast decode splits
them, beside the bounds (f32 on the CUDA cores and 3xTF32 on the tensor cores by
operations, and by bytes) and the design's L2 weight bytes per point. Prints the card's name and power limit. Exits 1 when
the new build misses the rel-L2 tolerance of ``chip_smoke.py`` at any shape.

``--dtype bf16`` (or ``both``) also builds the bf16 program, ``fused_decode_fwd_bf16.cu`` ("new16"),
holds it against the plain bf16 version with ``chip_smoke.py``'s bf16 gates (``bf16_gates``) at every
shape and mode, and times it in the same turns (what it reads laid out once, ``k1_operands``, as the
forecast decode lays it out) beside its bound at the bf16 tensor-core rate. ``--dtype both`` applies
``--old``, ``--skip`` and ``--variant`` to the f32 program; ``--dtype bf16`` leaves the f32 program out
and applies them to the bf16 one: ``--old`` an earlier bf16 source (one that reads G and the tail in f32,
as the first bf16 design at 2697ec8 does at every class and the narrow classes' earlier design at e909e65
does at 16 / 32 / 64, is handed them in f32 there), ``--skip`` a phase of ``SKIPS16`` (the current
designs', or with ``--skip-base`` the narrow classes' earlier design's ``*_old``), ``--variant`` one of
``VARIANTS16``. The narrow design's phases: ``nfeatures`` (the RFF features), ``nlogits`` (the logits product and its
B operand), ``nsoftmax``, ``nlayernorm``, ``ngelu``, ``nqvf`` (q_w1's, v_w1's and fw's products), ``ng`` (G's
products), ``ngcopy`` (G's copies), ``nmixer`` (m_w2's products), ``ntail``, ``nwaits`` (the products' waits),
``nbarriers`` (the warpgroups' barriers). Each bf16 build other than new16 is held against the plain bf16
version too (skip builds only printed), and every ``[timing]`` line of a bf16 build gives its
item tile, blocks an SM, grid and L2 weight bytes per point where its library reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Optional

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.ops import cuda_lib  # noqa: E402
from enf_pde_tpu_torch.ops import fused_decode as fd  # noqa: E402


BF16 = torch.bfloat16


class _RawLatents:
    """A bf16 build that reads G and the tail's wide weights in f32, as the fold gives them: the design at
    2697ec8 at every width class, or (``narrow_only``) the narrow classes' earlier design (at e909e65, whose
    class 128 reads them blocked). ``launch`` hands the wrapper's pointer list over with those swapped for
    the f32 tensors of the call."""

    def __init__(self, lib, narrow_only: bool = False):
        self._lib, self.G, self.tws, self.narrow_only = lib, None, (), narrow_only
        self.fused_decode_fwd_error_string = lib.fused_decode_fwd_error_string

    def fused_decode_fwd_launch(self, ptrs, n_ptrs, dims, n_dims, stream):
        p = list(ptrs)
        p[4] = self.G.data_ptr()
        for name in fd.BLOCKED_TAIL_NAMES if self.tws else ():
            i = fd.TAIL_WEIGHT_NAMES.index(name)
            p[16 + i] = self.tws[i].data_ptr()
        return self._lib.fused_decode_fwd_launch((ctypes.c_void_p * n_ptrs)(*p), n_ptrs, dims, n_dims, stream)

    def launch(self, inv, wb, A, ab, G, c, ws, tws, *rest, **kw):
        self.G, self.tws = G, tws
        raw = not self.narrow_only or fd._ws_class(ws) < fd.WG_N
        return fd._launch(inv, wb, A, ab, G, c, ws, tws, *rest, lib=self if raw else self._lib, **kw)


class _FirstPointers:
    """An older build's library whose launcher takes only the first ``n`` pointers."""

    def __init__(self, lib, n: int):
        self._lib, self._n = lib, n
        self.fused_decode_fwd_error_string = lib.fused_decode_fwd_error_string

    def fused_decode_fwd_launch(self, ptrs, n_ptrs, dims, n_dims, stream):
        return self._lib.fused_decode_fwd_launch((ctypes.c_void_p * self._n)(*ptrs[:self._n]), self._n,
                                                 dims, n_dims, stream)


_LOOP = "  for (int c = 0; c < total; ++c) {"
_KLOOP = "    for (int ks = 0; ks < nks; ++ks) {"
# Phase -> edits (text of the source, its replacement, which occurrence); each leaves that phase
# out. mma32 and wgmma leave out every class's 32-row and group products.
SKIPS = {
    "mma32": [(_LOOP, "  for (int c = 0; c < total && K < 0; ++c) {", 0),   # dense32's chunk loop
              (_KLOOP, "    for (int ks = 0; ks < nks && K < 0; ++ks) {", 0)],  # dense32_direct's
    "wgmma": [(_LOOP, "  for (int c = 0; c < total && K < 0; ++c) {", 1)],  # gemm_wg's chunk loop
    "tail": [("  if (WITH_TAIL) {", "  if (WITH_TAIL && P.B < 0) {", 0)],
    "normalize": [("  for (int base = SPW * warp; base < n_seg;", "  for (int base = SPW * warp; base < n_seg && ldx < 0;", 0)],
    "dots": [("  for (int o = warp; o < count; o += WARPS) {", "  for (int o = warp; o < count && K < 0; o += WARPS) {", 0)],
    "rff": [("    rff_sincos(proj, &s, &co);", "    s = proj; co = 1.0f - proj;", 0)],
    # The online softmax: its per-group update of max, sum and weights; the rescale of acc.
    "online": [("    if (softmax) online_softmax(z0, nz);", "", 0)],
    "rescale": [("    if (softmax && z0 > 0)", "    if (softmax && z0 < 0)", 0)],
    # Parts of the class-128 32-row products' chunk loop (dense32).
    "mma32_mma": [("      for (int q = 0; q < 2; ++q) mma_3xtf32_tiles(p, ab[q], as[q], bb[q], bs[q]);",
                   "      for (int q = 0; q < 2; ++q)"
                   " p[0][0][0] += __uint_as_float(ab[q][0][0] ^ as[q][1][3] ^ bb[q][0][0] ^ bs[q][NJ - 1][1]);", 0)],
    "mma32_aload": [("          const float2 v[4] = {a[0], a[8 * LDA], a[4], a[8 * LDA + 4]};",
                     "          const float2 v[4] = {make_float2(q, mi), make_float2(g, 1.0f), make_float2(tq, 2.0f),"
                     " make_float2(c, 3.0f)};", 0)],
    "mma32_bload": [("            const float2 w = split_tf32_int(st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g]);",
                     "            const float2 w = split_tf32_int((float)(8 * q + tq + 4 * r + j));", 0)],
    "mma32_bsplit": [("            const float2 w = split_tf32_int(st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g]);",
                      "            const float w0 = st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g];"
                      " const float2 w = make_float2(w0, w0);", 0)],
    "mma32_asplit": [("    if (c + 1 < total) split_x(kc + 1 == nk ? 0 : (kc + 1) * KC, (c + 1) & 1);", "", 0)],
}
# Other designs of the current source, right and timed beside it: the class 64 with its shared
# weights resident (one block an SM) instead of in a ring of narrow blocks (two); the classes
# 16 and 32 with room for one or three blocks an SM; the class 16 with groups of at most 4
# latents, the class 32 of at most 6 (two m64 tiles a warpgroup).
VARIANTS = {
    "res64": [("constexpr int RES64 = 0;", "constexpr int RES64 = 1;", 0),
              ("constexpr int MINB64 = 2;", "constexpr int MINB64 = 1;", 0)],
    "minb1": [("constexpr int MINB16 = 2;", "constexpr int MINB16 = 1;", 0),
              ("constexpr int MINB32 = 2;", "constexpr int MINB32 = 1;", 0)],
    "minb3": [("constexpr int MINB16 = 2;", "constexpr int MINB16 = 3;", 0),
              ("constexpr int MINB32 = 2;", "constexpr int MINB32 = 3;", 0)],
    "zg4": [("constexpr int ZG16 = 8;", "constexpr int ZG16 = 4;", 0)],
    "zg6": [("constexpr int ZG32 = 4;", "constexpr int ZG32 = 6;", 0)],
    # A latent pair's two G products one after the other on all eight warps.
    "pair_serial": [("          if (np == 2) {  // the pair's products side by side: warps 0-3 the first, 4-7 the second",
                     "          if (np < 0) {", 0),
                    ("            const size_t bz = (size_t)b * Z + z0 + zp;\n"
                     "            dense32_direct<ACT_NONE>(X + zp * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH, P.c + bz * HH, Y, ldP);",
                     "            for (int zz = 0; zz < np; ++zz) {\n"
                     "              const size_t bz = (size_t)b * Z + z0 + zp + zz;\n"
                     "              dense32_direct<ACT_NONE>(X + (zp + zz) * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH,"
                     " P.c + bz * HH, Y + zz * TILE * ldP, ldP, zz == 0);\n"
                     "            }", 0)],
}


# The bf16 program's phases, each left out of a copy by its edits. The narrow classes' earlier design (at
# e909e65; ``--skip-base`` its expanded source; 32 coordinates a block, G and the tail on 32-row mma.sync
# read from L2 in f32, row passes over f32 shared memory): the RFF features, the LayerNorm passes of t and
# of each head's pre, the CUDA-core dots (the logits, the head's output), the softmax pass, G's 32-row
# products, the tail (its 32-row products alone, its LayerNorm pass alone, or all of it), the mixer, the
# ring's staging waits (class 64), the group rows' wgmma (q_w1, v_w1, fw; the mixer's too).
_D32 = "dense32_direct<ACT_NONE>("
SKIPS16 = {
    "rff_old": [("      rff_features(s_inv, nz * TILE, I, coeff, hid / 2, X, ldX);", "", 0)],
    "layernorm_old": [("  for (int base = SPW * warp; base < n_seg;",
                     "  for (int base = SPW * warp; base < n_seg && ldx < 0;", 0)],
    "dots_old": [("  for (int o = warp; o < count; o += WARPS) {", "  for (int o = warp; o < count && K < 0; o += WARPS) {", 0)],
    "softmax_old": [("    for (int idx = tid; idx < TILE * H; idx += THREADS) {\n      float m = -INFINITY;",
                   "    for (int idx = tid; idx < 0; idx += THREADS) {\n      float m = -INFINITY;", 0)],
    "g_old": [("          " + _D32 + "X + (zp + zz) * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH, P.c + bz * HH,\n"
               "                                   Y + zz * TILE * ldP, ldP, false, zz * WARPS / 2, WARPS / 2);", "", 0),
              ("          " + _D32 + "X + zp * TILE * ldX, ldX, hid, P.G + bz * hid * HH, HH, P.c + bz * HH, Y, ldP);",
               "", 0)],
    "tail32_old": [("      " + _D32 + "acc, ldW, HD, P.o_w, HD, P.o_b, Y, ldW);\n"
                    "      " + _D32 + "Y, ldW, HD, P.p_w1, HD, P.p_b1, acc, ldW);", "", 0),
                   ("      dense32_direct<ACT_GELU>(acc, ldW, HD, P.p_w2, HD, P.p_b2, Y, ldW);\n"
                    "      dense32_direct<ACT_GELU>(Y, ldW, HD, P.h_w1, hid, P.h_b1, acc, ldW);\n"
                    "      dense32_direct<ACT_GELU>(acc, ldW, hid, P.h_w2, hid, P.h_b2, Y, ldW);", "", 0)],
    "tailln_old": [("      normalize_rows(acc, ldW, HD);", "", 0)],
    "tail_old": [("    if (WITH_TAIL) {\n      " + _D32 + "acc, ldW, HD, P.o_w",
                  "    if (WITH_TAIL) {\n      if (P.B >= 0) return;\n      " + _D32 + "acc, ldW, HD, P.o_w", 0)],
    "mixer_old": [("        mixer<WN, MT, RES>(Y, P.ldP, np, H, hidm, D, Wm, P.m_b2, s_prob + (z0 + zp) * TILE * H, acc, ldW, ring);",
                 "", 0)],
    "staging_old": [("      cp_async_wait<STAGES - 2>();\n      fence_async_smem();", "      fence_async_smem();", 0)],
    "wgmma_old": [(_LOOP, "  for (int c = 0; c < total && K < 0; ++c) {", 0)],
}
# The current design's (64-row tiles, every product a wgmma from shared memory, the LayerNorms in the
# epilogues): the RFF features, the logits' dots (q_w1's epilogue), the softmax pass, the LayerNorms
# (their exchange's barrier kept), gelu, the products of q_w1, v_w1 and fw, G's products, the mixer's
# products, the tail, the staging waits, every wgmma instruction, the warpgroups' barriers a chunk.
_STEP_WGMMA = ("      wgmma_bf16_ss64(acc, a16_desc(a + (ks0 + p) * A16_KSTEP), wg_desc(b + p * bstep), ks0 + p > 0);")
SKIPS16.update({
    "features": [("hid, X16, tid, THREADS);", "0, X16, tid, THREADS);", 0), ("hid, X16, tid, THREADS);", "0, X16, tid, THREADS);", 0)],
    "logits": [("      for (int h0 = 0; h0 < H; h0 += 2) {  // two heads a time", "      for (int h0 = 0; h0 < 0; h0 += 2) {", 0)],
    "softmax": [("    for (int idx = tid; idx < TILE128 * H; idx += THREADS) {", "    for (int idx = tid; idx < 0; idx += THREADS) {", 0)],
    "layernorm": [("    row_moments(v, N, mean, rstd);", "    mean[0] = mean[1] = 0.0f;\n    rstd[0] = rstd[1] = 1.0f;", 0),
                  ("      layer_norm(acc, n0, hid, xs, par);", "      __syncthreads();", 0),
                  ("        layer_norm(acc, n0, hidm, xs, par);", "        __syncthreads();", 0)],
    "gelu": [("        x0 = gelu_tanh(x0);\n        x1 = gelu_tanh(x1);", "", 0),
             ("        acc[i] = gelu_tanh(acc[i] + bf.x);\n        acc[i + 1] = gelu_tanh(acc[i + 1] + bf.y);",
              "        acc[i] = acc[i] + bf.x;\n        acc[i + 1] = acc[i + 1] + bf.y;", 0),
             ("            acc[i] = gelu_tanh(acc[i] + cc.x);\n            acc[i + 1] = gelu_tanh(acc[i + 1] + cc.y);",
              "            acc[i] = acc[i] + cc.x;\n            acc[i + 1] = acc[i + 1] + cc.y;", 0)],
    "qvf": [("      product(st, X16, acc);\n      ACC_PAIRS(if (n0 + col < hid) {\n        const float2 bq", "      cp_async_wait<0>();\n      ACC_PAIRS(if (n0 + col < hid) {\n        const float2 bq", 0),
            ("      product(st, X16, acc);\n      prime(st, P.fws", "      cp_async_wait<0>();\n      prime(st, P.fws", 0),
            ("      product(st, Y16, acc);", "      cp_async_wait<0>();", 0)],
    "g": [("        product(st, X16, acc);", "        cp_async_wait<0>();", 0)],
    "mixer": [("        product_resident(mw2, wg, Y16, hidm / 16, acc);", "", 0)],
    "tail": [("    if constexpr (WITH_TAIL) {\n      // The tail:", "    if constexpr (WITH_TAIL) {\n      if (P.B >= 0) continue;\n      // The tail:", 0)],
    "staging": [("    cp_async_wait<STAGES128 - 3>();  // this thread's copies of chunk c have landed", "", 0)],
    "wgmma": [(_STEP_WGMMA, "", 0)],
    "barriers": [("    wg_bar(s.bar);                   // everyone's; chunk c - 2's products are complete", "", 0)],
})
# The narrow classes' design (64-coordinate items, a latent a warpgroup, every product a wgmma from shared
# memory): the RFF features, the logits' dots (q_w1's epilogue), the softmax pass, the LayerNorms (t's and each
# head's from a quad's shuffles, the tail's exchanged), gelu (fw's, G's and the tail's epilogues), the products of
# q_w1, v_w1 and fw, G's products, G's copies, the mixer's products, the tail, the waits for the products, the
# warpgroups' barriers.
_NSOFTMAX = "    for (int idx = tid; idx < TILE128 * H; idx += THREADS) {"
_NBAR = ("      wg_bar(bar);", "", 0)
SKIPS16.update({
    "nfeatures": [("rows, P.q_coeff, hid, XA, lt, 128);", "rows, P.q_coeff, 0, XA, lt, 128);", 0),
                  ("rows, P.v_coeff, hid, XA, lt, 128);", "rows, P.v_coeff, 0, XA, lt, 128);", 0)],
    "nlogits": [("      for (int e = lt; e < hid * NL; e += 128) {", "      for (int e = lt; e < hid * NL && P.B < 0; e += 128) {", 0),
                ("      product_ss<NL>(lg, YA, GB, 16 * NL, nk);", "      for (int i = 0; i < NL / 2; ++i) lg[i] = 0.0f;", 0)],
    "nsoftmax": [(_NSOFTMAX, "    for (int idx = tid; idx < 0; idx += THREADS) {", 1)],
    "nlayernorm": [("    rstd[h] = rsqrtf(v[h][1] * inv - mean[h] * mean[h] + LN_EPS);", "    mean[h] = 0.0f;\n    rstd[h] = 1.0f;", 0),
                   ("    row_moments(v, N, mean, rstd);", "    mean[0] = mean[1] = 0.0f;\n    rstd[0] = rstd[1] = 1.0f;", 1)],
    "ngelu": [("  return __fdividef(x, 1.0f + __expf(-1.5957691216057308f * (x + 0.044715f * x * x * x)));", "  return x;", 0)],
    "nqvf": [(f"      product_ss<WN>(acc, {a}, {w}, 16 * WN, nk);", "      for (int i = 0; i < NA; ++i) acc[i] = 0.0f;", 0)
             for a, w in (("XA", "Wq"), ("XA", "Wv"), ("YA", "Wf"))],
    "ng": [("        product_ss<WN>(ag, XA, GB + h * hid * WN, 16 * WN, nk);", "        for (int i = 0; i < NA; ++i) ag[i] = 0.0f;", 0)],
    "ngcopy": [("      for (int k = 4 * lt; k < gfl; k += 4 * 128)", "      for (int k = 4 * lt; k < gfl && P.B < 0; k += 4 * 128)", 0)],
    "nmixer": [("        product_ss<WN>(am, YA, Wm, 16 * WN, hidm / 16);", "        for (int i = 0; i < NA; ++i) am[i] = 0.0f;", 0)],
    "ntail": [("      tail_layer_n<WN>(TX, TY, P.o_w,", "      if (P.B >= 0) continue;\n      tail_layer_n<WN>(TX, TY, P.o_w,", 0)],
    "nwaits": [("  wg_commit();\n  wg_wait0();\n  wg_fence_operands<N / 2>(acc);", "  wg_commit();\n  wg_fence_operands<N / 2>(acc);", 0)],
    "nbarriers": [_NBAR] * 9,
})
# Other designs of the current bf16 source, right and timed beside it: each 16-deep k step's product in
# a fresh accumulator summed in f32 registers (K2's rule; ROADMAP Queue 2, item 8); warpgroup rings of
# three or six 4 KB chunks (copies one or four chunks ahead, not two); the narrow classes' blocks an SM
# (`nblocks1`, `nblocks2`); and `copy`, the same program
# built from its expanded text (the spread between two builds of one program: the class 128's code
# is long, and two builds of it differed by up to 12 % on an H100).
VARIANTS16 = {
    "fresh": [("constexpr int FRESH_ACC = 0;", "constexpr int FRESH_ACC = 1;", 0)],
    "stages3": [("constexpr int STAGES128 = 4;", "constexpr int STAGES128 = 3;", 0)],
    "stages6": [("constexpr int STAGES128 = 4;", "constexpr int STAGES128 = 6;", 0)],
    "copy": [],
    # The narrow classes: one block an SM at the classes 16 and 32 (not three and two), or two at the class 16.
    "nblocks1": [("constexpr int BLOCKS16 = 3;", "constexpr int BLOCKS16 = 1;", 0),
                 ("constexpr int BLOCKS32 = 2;", "constexpr int BLOCKS32 = 1;", 0)],
    "nblocks2": [("constexpr int BLOCKS16 = 3;", "constexpr int BLOCKS16 = 2;", 0)],
}


def edited_source(label: str, edits: list, base: Optional[Path] = None) -> tuple:
    """(label, path) of a copy of ``base`` (the current f32 K1 source by default) under csrc/_build/
    with ``edits``."""
    base = base or cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE
    src = cuda_lib.expanded_source(base)
    for text, repl, which in edits:
        parts = src.split(text)
        if len(parts) <= which + 1:
            raise SystemExit(f"k1_compare: {label}: {text.strip()!r} is no longer in {base.name}")
        src = text.join(parts[:which + 1]) + repl + text.join(parts[which + 1:])
    path = cuda_lib.BUILD_DIR / f"fused_decode_fwd_{label}.cu"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return label, str(path)


def occupancy_line(sources: dict, args, H: int, D: int, out_dim: int) -> str:
    """Each build's width class and blocks an SM for the launch of ``args`` (builds from before
    the width classes have no such entry point)."""
    inv, ws = args[0], args[6]
    B, Z, C, I = inv.shape
    dims = [B, Z, C, I, ws[1].shape[0], H, D, ws[8].shape[0], out_dim, 1]
    parts = []
    for name, path in sources.items():
        try:
            cls, per_sm = fd.k1_occupancy(dims, path)
        except AttributeError:
            continue
        parts.append(f"{name} class {cls}, {per_sm} blocks/SM")
    return "; ".join(parts)


def compare_shape(shape: str, opts, kernels: dict, dtypes: dict, prepare: dict, sources: dict, olds: list,
                  extra: list, worst: dict) -> None:
    """Every build against the plain version of its program at ``shape``'s widths and launch shapes,
    then their times in turns at the first two; the worst rel-L2 of each f32 build into ``worst``
    (a bf16 build that misses phase 35's gates: inf)."""
    cfg = cs.shape_config(shape)
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    dev = torch.device("cuda")
    coords = cs.config_coords(cfg)
    chunk = cfg.training.max_num_sampled_points
    shapes = [(160, chunk), (160, 512), (80, 512), (8, 4096), (8, 1000)]  # the first two are timed
    if shape == "ihc":  # validation's launch (batch 1 x 14 frames) is the second timed
        shapes.insert(1, (cfg.dataset.batch_size * (cfg.dataset.traj_len_train + cfg.dataset.traj_len_out_horizon),
                          chunk))
    shapes = {f"b={b} c={c}": (b, c) for b, c in dict.fromkeys(shapes)}
    inputs = {label: cs.decode_inputs(cfg, coords, dev, b, c, cs.SEED + 7 + i)
              for i, (label, (b, c)) in enumerate(shapes.items())}
    for z in opts.latents:
        inputs[f"z={z} b=8 c=1000"] = cs.decode_inputs(
            cs.shape_config(shape, f"nef.num_latents={z}"), coords, dev, 8, 1000, cs.SEED + 20 + z)
    cs.log(f"[shape] {shape}: z={cfg.nef.num_latents} I={inputs[next(iter(inputs))][0].shape[-1]} "
           f"hid={cfg.nef.num_hidden} H={H} latent_dim={cfg.nef.latent_dim}")
    skips = {n for n in kernels if n.startswith("skip_")}
    with torch.no_grad():
        for label, args in inputs.items():
            for tail, kargs in ((True, args), (False, (*args[:7], ()))):
                ref = fd.fused_decode_plain(*kargs, H, D)
                ref16 = fd.fused_decode_plain(*kargs, H, D, torch.bfloat16) if BF16 in dtypes.values() else None
                parts, outs = [], {}
                for name, k1 in kernels.items():
                    try:
                        out = outs[name] = k1(*kargs, H, D)
                    except RuntimeError as e:  # an older build's layout may refuse the shape
                        if name in ("new", "new16"):
                            raise
                        parts.append(f"{name} refused ({e})")
                        continue
                    if dtypes[name] == BF16 and name not in skips:
                        try:
                            cs.bf16_gates(f"K1 {shape} {'tail' if tail else 'no-tail'} {label} {name}", out, ref16, ref,
                                          absolute=True)
                        except AssertionError as e:
                            cs.log(f"[check] {e}")
                            worst[name] = float("inf")
                        continue
                    rel = cs.rel_l2(out, ref16 if dtypes[name] == BF16 else ref) if torch.isfinite(out).all() \
                        else float("inf")
                    if name not in skips:
                        worst[name] = max(worst[name], rel)
                    parts.append(f"{name} {rel:.3e} (max abs {float((out - ref).abs().max()):.3e})")
                if parts:
                    cs.log(f"[check] K1 {shape} {'tail' if tail else 'no-tail'} {label} rel_l2 vs plain: "
                           + "; ".join(parts))
                for name in olds:  # an earlier build of the same program: the same bits?
                    new = "new16" if dtypes.get(name) == BF16 else "new"
                    if name in outs and new in outs:
                        cs.log(f"[same] K1 {shape} {'tail' if tail else 'no-tail'} {label}: {name} and {new} "
                               f"{'equal' if torch.equal(outs[name], outs[new]) else 'DIFFER'} bit for bit")
        torch.cuda.synchronize()

        news = [n for n in ("new", "new16") if n in kernels]
        order = ["plain", *olds, *extra, *news, *news[::-1], *extra[::-1], *olds[::-1], "plain"]
        for label in list(inputs)[:2]:
            args = inputs[label]
            fns = {name: partial(k1, *args, H, D, split=prepare[name](args, H)) for name, k1 in kernels.items()}
            fns["plain"] = partial(fd.fused_decode_plain, *args, H, D)
            samples = {name: [] for name in fns}
            for name in order:
                iters = 5 if name == "plain" else opts.iters
                samples[name].append(cs.cuda_ms(fns[name], iters=iters, warmup=1 if name == "plain" else 2))
            bd = cs.k1_bounds(cfg, args, fns[news[0]]())
            cs.log(f"[occupancy] K1 {shape} {label}: " + occupancy_line(sources, args, H, D, cfg.nef.num_out))
            cs.log(f"[timing] K1 {shape} tail {label}, turns {order}: " + "; ".join(
                f"{n} {', '.join(f'{v:.4f}' for v in vals)} ms (mean {statistics.mean(vals):.4f})"
                for n, vals in samples.items()))
            cs.log(f"[bound] K1 {shape} {label}: {bd['flops'] / 1e9:.3f} GFLOP, {bd['moved'] / 1e6:.3f} MB; f32 CUDA "
                   f"cores {bd['f32_ms']:.4f} ms, 3xTF32 tensor cores {bd['tc_ms']:.4f} ms, bytes "
                   f"{bd['bytes_ms']:.4f} ms; bf16 tensor cores {bd['flops'] / cs.PEAK_BF16_FLOPS * 1e3:.4f} ms; "
                   + "; ".join(f"{n} at {bd['flops'] / statistics.mean(samples[n]) / 1e9:.2f} TFLOP/s" for n in news)
                   + f"; L2 weight bytes per point {bd['l2_per_point'] / 1e3:.1f} KB")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[],
                    help="an earlier K1 source of the program with a compatible C interface (repeatable)")
    ap.add_argument("--skip", action="append", default=[], choices=sorted({*SKIPS, *SKIPS16}),
                    help="also build the current source (or --skip-base) without this phase (timing only; repeatable)")
    ap.add_argument("--skip-base", default=None, help="the source that --skip edits (default: the current one)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted({*VARIANTS, *VARIANTS16}),
                    help="also build and time this design of the current source (repeatable)")
    ap.add_argument("--iters", type=int, default=20, help="kernel launches per timed sample")
    ap.add_argument("--shape", action="append", choices=("navier_stokes", "diffusion_plane", "cahn_hilliard",
                                                         "diff_sphere", "shallow_water", "ihc", "navier_stokes_nonmaml"),
                    help="a config whose widths K1 runs at (repeatable; default navier_stokes)")
    ap.add_argument("--latents", action="append", type=int, default=[],
                    help="also check K1 with this many latents at each shape's widths, 8 x 1000 (repeatable)")
    ap.add_argument("--dtype", choices=("f32", "bf16", "both"), default="f32",
                    help="the programs held and timed: f32 (3xTF32), bf16, or both in the same turns")
    opts = ap.parse_args()
    bf = opts.dtype == "bf16"  # --old, --skip and --variant apply to the bf16 program
    skips, variants_of = (SKIPS16, VARIANTS16) if bf else (SKIPS, VARIANTS)
    for name in opts.skip + opts.variant:
        if name not in skips and name not in variants_of:
            raise SystemExit(f"k1_compare: {name} is not a phase or variant of the {'bf16' if bf else 'f32'} program")
    if not torch.cuda.is_available():
        print("k1_compare: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    current = cuda_lib.CSRC_DIR / (fd.KERNEL_SOURCE_BF16 if bf else fd.KERNEL_SOURCE)
    sources = {"new": str(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE)} if opts.dtype != "bf16" else {}
    if opts.dtype != "f32":
        sources["new16"] = str(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE_BF16)
    olds = [Path(p).stem for p in opts.old]
    sources.update({name: str(Path(p).resolve()) for name, p in zip(olds, opts.old)})
    base = Path(opts.skip_base).resolve() if opts.skip_base else current
    variants = dict(edited_source(f"skip_{p}", skips[p], base) for p in opts.skip)
    variants.update(edited_source(v, variants_of[v], current) for v in opts.variant)
    extra = list(variants)
    sources.update(variants)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(cuda_lib.build, sources.values())))
    kernels, dtypes, prepare = {}, {}, {}
    for name, path in paths.items():
        report = path.with_name(path.name.replace(".so", ".ptxas.txt")).read_text().splitlines()
        for ln in report:
            if any(w in ln for w in ("registers", "spill", "Compiling entry", "Function properties", "warning", "wgmma")):
                cs.log(f"[build] {name}: {ln.strip()}")
        lib = fd._fwd_lib(sources[name])
        text = cuda_lib.expanded_source(Path(sources[name]))
        n_ptrs = int(re.search(r"kNumPtrs = (\d+);", text).group(1)) if name in olds else None
        if n_ptrs is not None and n_ptrs < 33:
            lib = _FirstPointers(lib, n_ptrs)
        dtypes[name] = BF16 if name == "new16" or (bf and name != "new") else torch.float32
        # A build from before the width classes reads the shared weights in WG_N slabs at every width.
        width = None if "fused_decode_fwd_occupancy" in text else fd.WG_N
        if dtypes[name] == BF16 and ("TILE128" not in text or "void dense32_direct(" in text):  # G and the tail in f32
            kernels[name] = partial(_RawLatents(lib, "TILE128" in text).launch, width=width, compute_dtype=BF16)
        else:
            kernels[name] = partial(fd._launch, lib=lib, width=width, compute_dtype=dtypes[name])
        # What the build reads laid out once, as the forecast decode lays it out.
        prepare[name] = partial(lambda a, H, w, dt: fd.k1_operands(a[4], a[6], a[7], H, dt) if w is None
                                else fd.shared_weights(a[6], dt, width=w), w=width, dt=dtypes[name])
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")

    worst = {name: 0.0 for name in kernels}
    for shape in opts.shape or ["navier_stokes"]:
        compare_shape(shape, opts, kernels, dtypes, prepare, sources, olds, extra, worst)
    cs.log(cs.nvidia_smi())
    return 0 if worst.get("new", 0.0) <= cs.REL_L2_TOL and worst.get("new16", 0.0) == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
