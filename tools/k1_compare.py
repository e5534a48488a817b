"""Kernel K1 against earlier builds of it and its plain version, on one card.

    python3 tools/k1_compare.py [--old path/to/fused_decode_fwd_old.cu ...] [--skip PHASE ...] [--variant V ...]
        [--shape navier_stokes|diffusion_plane|cahn_hilliard|diff_sphere|shallow_water|ihc ...] [--latents Z ...]
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
I = 4, hid = 128, three outputs; ``ihc``, z = 25 of latent 32, I = 5, hid = 32, 3 heads)
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
shape and mode, and times it in the same turns (its shared weights laid out once by
``bf16_weights``) beside its bound at the bf16 tensor-core rate; ``--old``, ``--skip`` and
``--variant`` apply to the f32 program. ``--dtype bf16`` leaves the f32 program out of the turns.
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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.ops import cuda_lib  # noqa: E402
from enf_pde_tpu_torch.ops import fused_decode as fd  # noqa: E402


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


def edited_source(label: str, edits: list) -> tuple:
    """(label, path) of a copy of the current K1 source under csrc/_build/ with ``edits``."""
    src = cuda_lib.expanded_source(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE)
    for text, repl, which in edits:
        parts = src.split(text)
        if len(parts) <= which + 1:
            raise SystemExit(f"k1_compare: {label}: {text.strip()!r} is no longer in {fd.KERNEL_SOURCE}")
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


def compare_shape(shape: str, opts, kernels: dict, widths: dict, sources: dict, olds: list, extra: list,
                  worst: dict) -> None:
    bf = "new16" in kernels
    """Every build against the plain version at ``shape``'s widths and launch shapes, then
    their times in turns at the first two; the worst rel-L2 of each build into ``worst``."""
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
    with torch.no_grad():
        for label, args in inputs.items():
            for tail, kargs in ((True, args), (False, (*args[:7], ()))):
                ref = fd.fused_decode_plain(*kargs, H, D)
                if bf:
                    try:
                        cs.bf16_gates(f"K1 {shape} {'tail' if tail else 'no-tail'} {label} new16", kernels["new16"](
                            *kargs, H, D), fd.fused_decode_plain(*kargs, H, D, torch.bfloat16), ref, absolute=True)
                    except AssertionError as e:
                        cs.log(f"[check] {e}")
                        worst["new16"] = float("inf")
                parts = []
                for name, k1 in kernels.items():
                    if name == "new16":
                        continue
                    try:
                        out = k1(*kargs, H, D)
                    except RuntimeError as e:  # an older build's layout may refuse the shape
                        if name == "new":
                            raise
                        parts.append(f"{name} refused ({e})")
                        continue
                    rel = cs.rel_l2(out, ref) if torch.isfinite(out).all() else float("inf")
                    worst[name] = max(worst[name], rel)
                    parts.append(f"{name} {rel:.3e} (max abs {float((out - ref).abs().max()):.3e})")
                cs.log(f"[check] K1 {shape} {'tail' if tail else 'no-tail'} {label} rel_l2 vs plain: " + "; ".join(parts))
        torch.cuda.synchronize()

        f32s = [n for n in ("new",) if n in kernels]
        news = [*f32s, *(["new16"] if bf else [])]
        order = ["plain", *olds, *extra, *news, *news[::-1], *extra[::-1], *olds[::-1], "plain"]
        for label in list(inputs)[:2]:
            args = inputs[label]
            splits = {w: fd.shared_weights(args[6], width=w) for w in set(widths.values())}  # once, as the forecast decode splits
            fns = {name: partial(k1, *args, H, D, split=splits[widths[name]]) for name, k1 in kernels.items()
                   if name != "new16"}
            fns["plain"] = partial(fd.fused_decode_plain, *args, H, D)
            if bf:
                fns["new16"] = partial(kernels["new16"], *args, H, D, split=fd.shared_weights(args[6], torch.bfloat16))
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
                    help="an earlier K1 source with a compatible C interface (repeatable)")
    ap.add_argument("--skip", action="append", default=[], choices=sorted(SKIPS),
                    help="also build the current source without this phase (timing only; repeatable)")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="also build and time this design of the current source (repeatable)")
    ap.add_argument("--iters", type=int, default=20, help="kernel launches per timed sample")
    ap.add_argument("--shape", action="append", choices=("navier_stokes", "diffusion_plane",
                                                         "cahn_hilliard", "diff_sphere", "shallow_water", "ihc"),
                    help="a config whose widths K1 runs at (repeatable; default navier_stokes)")
    ap.add_argument("--latents", action="append", type=int, default=[],
                    help="also check K1 with this many latents at each shape's widths, 8 x 1000 (repeatable)")
    ap.add_argument("--dtype", choices=("f32", "bf16", "both"), default="f32",
                    help="the programs held and timed: f32 (3xTF32), bf16, or both in the same turns")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    sources = {"new": str(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE)} if opts.dtype != "bf16" else {}
    if opts.dtype != "f32":
        sources["new16"] = str(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE_BF16)
    olds = [Path(p).stem for p in opts.old]
    sources.update({name: str(Path(p).resolve()) for name, p in zip(olds, opts.old)})
    variants = dict(edited_source(f"skip_{p}", SKIPS[p]) for p in opts.skip)
    variants.update(edited_source(v, VARIANTS[v]) for v in opts.variant)
    extra = list(variants)
    sources.update(variants)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(cuda_lib.build, sources.values())))
    kernels, widths = {}, {}
    for name, path in paths.items():
        report = path.with_name(path.name.replace(".so", ".ptxas.txt")).read_text().splitlines()
        for ln in report:
            if any(w in ln for w in ("registers", "spill", "Compiling entry", "Function properties", "warning", "wgmma")):
                cs.log(f"[build] {name}: {ln.strip()}")
        lib = fd._fwd_lib(sources[name])
        n_ptrs = int(re.search(r"kNumPtrs = (\d+);", Path(sources[name]).read_text()).group(1)) \
            if name in olds else None
        if n_ptrs is not None and n_ptrs < 33:
            lib = _FirstPointers(lib, n_ptrs)
        # A build from before the width classes reads the shared weights in WG_N slabs at every width.
        widths[name] = None if "fused_decode_fwd_occupancy" in Path(sources[name]).read_text() else fd.WG_N
        kernels[name] = partial(fd._launch, lib=lib, width=widths[name],
                                **({"compute_dtype": torch.bfloat16} if name == "new16" else {}))
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")

    worst = {name: 0.0 for name in kernels}
    for shape in opts.shape or ["navier_stokes"]:
        compare_shape(shape, opts, kernels, widths, sources, olds, extra, worst)
    cs.log(cs.nvidia_smi())
    return 0 if worst.get("new", 0.0) <= cs.REL_L2_TOL and worst.get("new16", 0.0) == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
