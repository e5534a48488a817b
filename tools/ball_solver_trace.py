"""Where a step of the Boussinesq ball solver spends its time, on one card.

    python3 tools/ball_solver_trace.py [--steps 20] [--batch 2]

Builds the full-size solver (lmax 23, nmax 24) of ``enf_pde_tpu_torch/data/ball_convection.py``
on the card, times ``--steps`` steps of a batch of seeds warm (host clock between
synchronisations), then traces as many steps with ``torch.profiler`` (CPU and CUDA) and
prints the device kernels a step, the device time a step against the traced wall time (the
device's busy share), and the profiler's tables by device time and by call count. Prints the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.data.ball_convection import MAX_DT, BallConvectionSolver  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ball_solver_trace: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    solver = BallConvectionSolver(device="cuda")
    seeds = list(range(args.batch))
    stop = (args.steps - 0.5) * MAX_DT  # the first steps run at the largest dt

    def run():
        solver.simulate(seeds, stop_time=stop, num_frames=1, t_start_record=stop)
        torch.cuda.synchronize()

    run()  # warm: LU factors, cuFFT plans, allocator
    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced = time.perf_counter() - t0
    ev = prof.key_averages()
    kernels = [e for e in ev if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n = max(steps for steps, _, _ in solver.last_run)
    print(f"{cs.nvidia_smi()} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"ball solver, lmax 23 / nmax 24, batch {args.batch}, {n} steps and one frame: warm {warm * 1e3:.1f} ms "
          f"({warm * 1e3 / n:.2f} ms a step); traced {traced * 1e3:.1f} ms with {device_ms:.1f} ms of device time "
          f"({100 * device_ms / (traced * 1e3):.1f} % busy), {sum(e.count for e in kernels) / n:.0f} device kernels "
          f"and {device_ms / n:.3f} ms of device time a step")
    print(ev.table(sort_by="self_device_time_total", row_limit=20))
    print(ev.table(sort_by="count", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
