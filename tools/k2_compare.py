"""Kernel K2 against an earlier build of it and its plain version, on one card.

    python3 tools/k2_compare.py [--old path/to/fused_decode_bwd_old.cu ...]

Builds ``enf_pde_tpu_torch/csrc/fused_decode_bwd.cu`` (and each ``--old``, a source with
the same C interface, named by its file name) with plain ``nvcc`` in parallel, prints
the compiler's register and spill report, holds every build against the plain version
(autograd over the plain decode) in all four modes (tail / no tail x with / without
weight gradients) at the ode step's decode shape (80 frames x 512 points,
Navier-Stokes width), each gradient tensor's rel-L2 on one line, then times them in
turns -- plain, old, new, new, old, plain -- with and without weight gradients,
beside the bounds: f32 on the CUDA cores and 3xTF32 on the tensor cores by
operations, and by bytes. Prints the card's name and power limit. Exits 1 when the
new build misses the rel-L2 tolerance of ``chip_smoke.py``.
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
from enf_pde_tpu_torch.config import load_experiment_config  # noqa: E402
from enf_pde_tpu_torch.data import planar_coords  # noqa: E402
from enf_pde_tpu_torch.ops import cuda_lib  # noqa: E402
from enf_pde_tpu_torch.ops import fused_decode as fd  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[],
                    help="an earlier K2 source with the same C interface (repeatable)")
    ap.add_argument("--iters", type=int, default=10, help="kernel launches per timed sample")
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

    cfg = load_experiment_config("navier_stokes")
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    dev = torch.device("cuda")
    args, g = cs.k2_inputs(cfg, planar_coords(cs.GRID, cs.GRID), dev)
    kernels = {name: partial(fd._launch_bwd, lib=fd._bwd_lib(src)) for name, src in sources.items()}
    worst = {name: check(cfg, args, g, name, bwd) for name, bwd in kernels.items()}

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
    (rel-L2 of each tensor, and where the worst one's error sits); the worst rel-L2."""
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    worst = 0.0
    for tail in (True, False):
        kargs = args if tail else (*args[:7], ())
        for wg in (False, True):
            got = bwd(*kargs, g[tail], H, D, wg)
            want = fd.fused_decode_bwd_plain(*kargs, g[tail], H, D, wg)
            rels = []
            for i, (x, ref) in enumerate(zip(flat(got), flat(want))):
                if ref is None:
                    continue
                rel = cs.rel_l2(x, ref) if torch.isfinite(x).all() else float("inf")
                rels.append((rel, i, x, ref))
            rel, i, x, ref = max(rels, key=lambda r: r[0])
            err = (x - ref).abs()
            cs.log(f"[check] {name} {'tail' if tail else 'no-tail'} {'with' if wg else 'without'} weight "
                   f"grads: worst rel_l2 {rel:.3e} (tensor {i}: max abs err {float(err.max()):.3e}, "
                   f"max |ref| {float(ref.abs().max()):.3e}, {int((err > 1e-4 * ref.abs().max()).sum())} of "
                   f"{ref.numel()} off by > 1e-4 max |ref|); all: "
                   + " ".join(f"{r:.1e}" for r, *_ in rels))
            worst = max(worst, rel)
    torch.cuda.synchronize()
    return worst


def flat(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from flat(v)
    else:
        yield x


if __name__ == "__main__":
    sys.exit(main())
