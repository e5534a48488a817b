"""Kernel K1 against earlier builds of it and its plain version, on one card.

    python3 tools/k1_compare.py [--old path/to/fused_decode_fwd_old.cu ...] [--skip PHASE ...]
        [--shape navier_stokes|diffusion_plane|cahn_hilliard|diff_sphere|shallow_water ...] [--latents Z ...]

Builds ``enf_pde_tpu_torch/csrc/fused_decode_fwd.cu``, each ``--old`` (an earlier K1
source, named by its file name; one with the 29-pointer interface from before the
pre-split weights is handed the first 29 pointers), and for each ``--skip`` a copy of the
current source that leaves one phase out (``SKIPS``: its results are wrong, its time says
what the phase costs), with plain ``nvcc`` in parallel, and prints the compiler's
register, spill and ``wgmma`` report. Holds every build against the plain version, with
and without the tail, at each ``--shape`` config's widths (``navier_stokes``, the default;
``diffusion_plane``, z = 4; ``cahn_hilliard``, z = 9; I = 2 and hid = 64 for both planar
ones; ``diff_sphere``, z = 18, I = 1, hid = 16; ``shallow_water``, z = 8 of latent 32,
I = 4, hid = 128, three outputs) and launch shapes: the forecast's and
validation's 160 x chunk (512 / 1024 / 2048), 160 x 512, 80 x 512, 8 x 4096 and a ragged
8 x 1000, and for each ``--latents`` Z the ragged 8 x 1000 with Z latents; one rel-L2 per
shape and mode. Then
times plain, old, variants, new, new, variants, old, plain at 160 x chunk and at the next
shape (80 x 512 for Navier-Stokes, 160 x 512 for the planar configs), the shared weights
split once as the forecast decode splits them,
beside the bounds (f32 on
the CUDA cores and 3xTF32 on the tensor cores by operations, and by bytes) and the
design's L2 weight bytes per point. Prints the card's name and power limit. Exits 1 when
the new build misses the rel-L2 tolerance of ``chip_smoke.py`` at any shape.
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
# Phase -> (text of the source, its replacement, which occurrence); each leaves that phase out.
SKIPS = {
    "mma32": (_LOOP, "  for (int c = 0; c < total && K < 0; ++c) {", 0),   # dense32's chunk loop
    "wgmma": (_LOOP, "  for (int c = 0; c < total && K < 0; ++c) {", 1),   # gemm_wg's chunk loop
    "tail": ("  if (WITH_TAIL) {", "  if (WITH_TAIL && P.B < 0) {", 0),
    "normalize": ("  for (int base = 4 * warp; base < n_seg;", "  for (int base = 4 * warp; base < n_seg && ldx < 0;", 0),
    "dots": ("  for (int o = warp; o < count; o += WARPS) {", "  for (int o = warp; o < count && K < 0; o += WARPS) {", 0),
    "rff": ("    sincosf(TWO_PI * proj, &s, &co);", "    s = proj; co = 1.0f - proj;", 0),
    # The online softmax: its per-group update of max, sum and weights; the rescale of acc.
    "online": ("    if (softmax) online_softmax(z0, nz);", "", 0),
    "rescale": ("    if (softmax && z0 > 0)", "    if (softmax && z0 < 0)", 0),
    # Parts of the 32-row products' chunk loop (dense32).
    "mma32_mma": ("      for (int q = 0; q < 2; ++q) mma_3xtf32_tiles(p, ab[q], as[q], bb[q], bs[q]);",
                  "      for (int q = 0; q < 2; ++q)"
                  " p[0][0][0] += __uint_as_float(ab[q][0][0] ^ as[q][1][3] ^ bb[q][0][0] ^ bs[q][NJ - 1][1]);", 0),
    "mma32_aload": ("          const float2 v[4] = {a[0], a[8 * LDA], a[4], a[8 * LDA + 4]};",
                    "          const float2 v[4] = {make_float2(q, mi), make_float2(g, 1.0f), make_float2(tq, 2.0f),"
                    " make_float2(c, 3.0f)};", 0),
    "mma32_bload": ("            const float2 w = split_tf32_int(st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g]);",
                    "            const float2 w = split_tf32_int((float)(8 * q + tq + 4 * r + j));", 0),
    "mma32_bsplit": ("            const float2 w = split_tf32_int(st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g]);",
                     "            const float w0 = st[(8 * q + tq + 4 * r) * LD + warp * WN + 8 * j + g];"
                     " const float2 w = make_float2(w0, w0);", 0),
    "mma32_asplit": ("    if (c + 1 < total) split_x(kc + 1 == nk ? 0 : (kc + 1) * KC, (c + 1) & 1);", "", 0),
}


def skip_source(phase: str) -> tuple:
    """(label, path) of a source under csrc/_build/ that leaves ``phase`` out of K1."""
    text, repl, which = SKIPS[phase]
    src = (cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE).read_text().replace('#include "', '#include "../')
    parts = src.split(text)
    if len(parts) <= which + 1:
        raise SystemExit(f"k1_compare: --skip {phase}: its text is no longer in {fd.KERNEL_SOURCE}")
    src = text.join(parts[:which + 1]) + repl + text.join(parts[which + 1:])
    path = cuda_lib.BUILD_DIR / f"fused_decode_fwd_skip_{phase}.cu"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return f"skip_{phase}", str(path)


def compare_shape(shape: str, opts, kernels: dict, olds: list, extra: list, worst: dict) -> None:
    """Every build against the plain version at ``shape``'s widths and launch shapes, then
    their times in turns at the first two; the worst rel-L2 of each build into ``worst``."""
    cfg = cs.shape_config(shape)
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    dev = torch.device("cuda")
    coords = cs.config_coords(cfg)
    chunk = cfg.training.max_num_sampled_points
    shapes = [(160, chunk), (160, 512), (80, 512), (8, 4096), (8, 1000)]  # the first two are timed
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
                parts = []
                for name, k1 in kernels.items():
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

        order = ["plain", *olds, *extra, "new", "new", *extra[::-1], *olds[::-1], "plain"]
        for label in list(inputs)[:2]:
            args = inputs[label]
            split = fd.split_weights(args[6])[1]  # once, as the forecast decode splits
            fns = {name: partial(k1, *args, H, D, split=split) for name, k1 in kernels.items()}
            fns["plain"] = partial(fd.fused_decode_plain, *args, H, D)
            samples = {name: [] for name in fns}
            for name in order:
                iters = 5 if name == "plain" else opts.iters
                samples[name].append(cs.cuda_ms(fns[name], iters=iters, warmup=1 if name == "plain" else 2))
            bd = cs.k1_bounds(cfg, args, fns["new"]())
            cs.log(f"[timing] K1 {shape} tail {label}, turns {order}: " + "; ".join(
                f"{n} {', '.join(f'{v:.4f}' for v in vals)} ms (mean {statistics.mean(vals):.4f})"
                for n, vals in samples.items()))
            cs.log(f"[bound] K1 {shape} {label}: {bd['flops'] / 1e9:.3f} GFLOP, {bd['moved'] / 1e6:.3f} MB; f32 CUDA "
                   f"cores {bd['f32_ms']:.4f} ms, 3xTF32 tensor cores {bd['tc_ms']:.4f} ms, bytes "
                   f"{bd['bytes_ms']:.4f} ms; new at {bd['flops'] / statistics.mean(samples['new']) / 1e9:.2f} "
                   f"TFLOP/s; L2 weight bytes per point {bd['l2_per_point'] / 1e3:.1f} KB")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[],
                    help="an earlier K1 source with a compatible C interface (repeatable)")
    ap.add_argument("--skip", action="append", default=[], choices=sorted(SKIPS),
                    help="also build the current source without this phase (timing only; repeatable)")
    ap.add_argument("--iters", type=int, default=20, help="kernel launches per timed sample")
    ap.add_argument("--shape", action="append", choices=("navier_stokes", "diffusion_plane",
                                                         "cahn_hilliard", "diff_sphere", "shallow_water"),
                    help="a config whose widths K1 runs at (repeatable; default navier_stokes)")
    ap.add_argument("--latents", action="append", type=int, default=[],
                    help="also check K1 with this many latents at each shape's widths, 8 x 1000 (repeatable)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    sources = {"new": str(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE)}
    olds = [Path(p).stem for p in opts.old]
    sources.update({name: str(Path(p).resolve()) for name, p in zip(olds, opts.old)})
    variants = dict(skip_source(p) for p in opts.skip)
    extra = list(variants)
    sources.update(variants)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(cuda_lib.build, sources.values())))
    kernels = {}
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
        kernels[name] = partial(fd._launch, lib=lib)
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")

    worst = {name: 0.0 for name in kernels}
    for shape in opts.shape or ["navier_stokes"]:
        compare_shape(shape, opts, kernels, olds, extra, worst)
    cs.log(cs.nvidia_smi())
    return 0 if worst["new"] <= cs.REL_L2_TOL else 1


if __name__ == "__main__":
    sys.exit(main())
