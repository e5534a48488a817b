"""Kernel K2 against an earlier build of it and its plain version, on one card.

    python3 tools/k2_compare.py [--old path/to/fused_decode_bwd_old.cu ...] [--shape navier_stokes|shallow_water]

Builds ``enf_pde_tpu_torch/csrc/fused_decode_bwd.cu`` (and each ``--old``, a source with
the same C interface, named by its file name) with plain ``nvcc`` in parallel, prints
the compiler's register and spill report, holds every build against the plain version
(autograd over the plain decode) in all four modes (tail / no tail x with / without
weight gradients) at the ode step's decode shape of ``--shape`` (``navier_stokes``, the
default: 80 frames x 512 points, z = 4, one output; ``shallow_water``: 10 frames x 2048
points, z = 8 of latent 32, three outputs), each gradient tensor's rel-L2 on one line (the
cotangent 0 at the points near a ReLU's kink, as ``chip_smoke.py`` checks), then times them in
turns -- plain, old, new, new, old, plain -- with and without weight gradients,
beside the bounds: f32 on the CUDA cores and 3xTF32 on the tensor cores by
operations, and by bytes. With ``--f64``, also holds every build and the plain f32
version against the plain version in float64 (the whole cotangent) and prints the largest
dinv differences beside the points' ReLU margins. Prints the card's name and power limit.
Exits 1 when the new build misses the rel-L2 tolerance of ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[],
                    help="an earlier K2 source with the same C interface (repeatable)")
    ap.add_argument("--iters", type=int, default=10, help="kernel launches per timed sample")
    ap.add_argument("--shape", default="navier_stokes", choices=("navier_stokes", "shallow_water"),
                    help="the config whose ode step's decode shape K2 runs at")
    ap.add_argument("--f64", action="store_true",
                    help="also hold every build and the plain f32 version against the plain version in "
                         "float64, with the whole cotangent, and show the largest dinv differences")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_compare: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    sources = {"new": fd.BWD_KERNEL_SOURCE}
    olds = [Path(p).stem for p in opts.old]
    sources.update({name: str(Path(p).resolve()) for name, p in zip(olds, opts.old)})
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(cuda_lib.build, sources.values())))
    for name, path in paths.items():
        report = path.with_name(path.name.replace(".so", ".ptxas.txt")).read_text().splitlines()
        for ln in report:
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                cs.log(f"[build] {name}: {ln.strip()}")
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")

    cfg = cs.shape_config(opts.shape)
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    dev = torch.device("cuda")
    args, g = cs.k2_inputs(cfg, cs.config_coords(cfg), dev)
    cs.log(f"[shape] {opts.shape}: b={args[0].shape[0]} z={args[0].shape[1]} c={args[0].shape[2]} "
           f"I={args[0].shape[3]} hid={cfg.nef.num_hidden} num_out={cfg.nef.num_out}")
    kernels = {name: partial(fd._launch_bwd, lib=fd._bwd_lib(src)) for name, src in sources.items()}
    worst = {name: check(cfg, args, g, name, bwd) for name, bwd in kernels.items()}
    if opts.f64:
        against_f64(cfg, args, g[True], kernels)

    order = ["plain", *olds, "new", "new", *olds[::-1], "plain"]
    for wg in (False, True):
        fns = {name: partial(bwd, *args, g[True], H, D, wg) for name, bwd in kernels.items()}
        fns["plain"] = partial(fd.fused_decode_bwd_plain, *args, g[True], H, D, wg)
        samples = {name: [] for name in fns}
        for name in order:
            iters = 3 if name == "plain" else opts.iters
            samples[name].append(cs.cuda_ms(fns[name], iters=iters, warmup=1 if name == "plain" else 2))
        bd = cs.k2_bounds(cfg, args, g[True], wg)
        label = "with" if wg else "without"
        cs.log(f"[timing] K2 {label} weight grads, turns {order}: " + "; ".join(
            f"{n} {', '.join(f'{v:.4f}' for v in vals)} ms (mean {statistics.mean(vals):.4f})"
            for n, vals in samples.items()))
        cs.log(f"[bound] K2 {label} weight grads: {bd['flops'] / 1e9:.3f} GFLOP, {bd['moved'] / 1e6:.3f} MB; "
               f"f32 CUDA cores {bd['f32_ms']:.4f} ms, 3xTF32 tensor cores {bd['tc_ms']:.4f} ms, "
               f"bytes {bd['bytes_ms']:.4f} ms; new at {bd['flops'] / statistics.mean(samples['new']) / 1e9:.2f} "
               f"TFLOP/s")
    cs.log(cs.nvidia_smi())
    return 0 if worst["new"] <= cs.REL_L2_TOL else 1


def check(cfg, args, g, name: str, bwd) -> float:
    """Every gradient tensor of ``bwd`` against the plain version, one line per mode
    (rel-L2 of each tensor, and where the worst one's error sits), with the cotangent 0 at
    the points ``chip_smoke.relu_ties`` finds, as ``chip_smoke.py`` holds K2 (the worst
    rel-L2 with the whole cotangent is printed too); the worst rel-L2."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    worst = 0.0
    keep = ~cs.relu_ties(args)
    for tail in (True, False):
        kargs = args if tail else (*args[:7], ())
        for wg in (False, True):
            whole = cs.grad_errors(bwd(*kargs, g[tail], H, D, wg), fd.fused_decode_bwd_plain(*kargs, g[tail], H, D, wg))
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
