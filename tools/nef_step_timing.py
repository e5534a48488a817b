"""The nef step and the fit of the narrow configs on the kernels and on the eager decoder, on one card.

    python3 tools/nef_step_timing.py [--repeats 5]

For each of ``diffusion_plane``, ``cahn_hilliard``, ``diff_sphere`` and ``ihc`` at full width with
``nef.backend=pallas`` (seeded random weights and a seeded random trajectory, as ``chip_smoke.py``'s phase 34):
one nef step's loss and gradients (``MetaSGDTrainer.nef_grads``) and one fit (``fit_latents``), each on the
kernels (``train_backend`` ``kernel``: K1 and K2's bf16 programs) and on the eager decoder, warm medians of
``--repeats`` runs in ms between two device synchronisations, and K2's launches of one step and one fit by
weight-gradient mode. Run from a tree's root to time that tree (an older tree unpacked with this script beside
its ``chip_smoke.py`` times the older kernels). Prints the card's name and power limit; exits 2 without a card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from collections import Counter
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.ops.fused_decode import fused_decode_bwd  # noqa: E402

CONFIGS = ("diffusion_plane", "cahn_hilliard", "diff_sphere", "ihc")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=cs.WARM_REPEATS, help="warm runs a median takes")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("nef_step_timing: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")
    for name in CONFIGS:
        cfg = cs.shape_config(name, "nef.backend=pallas")
        coords = cs.config_coords(cfg)
        trainer = cs.make_trainer(cfg, coords)
        state = trainer.init_state()
        gen = torch.Generator().manual_seed(cs.SEED + 40)
        traj = (0.5 * torch.randn(cfg.dataset.batch_size, cfg.dataset.traj_len_train, coords.shape[0],
                                  cfg.nef.num_out, generator=gen)).to("cuda")
        ms, k2 = {}, {}
        for backend in ("kernel", "eager"):
            trainer.train_backend = backend
            for what, fn in (("nef step", lambda: trainer.nef_grads(state, traj)),
                             ("fit", lambda: trainer.fit_latents(state, traj[:, 0]))):
                fn()  # warm: builds, caches
                before = Counter(fused_decode_bwd.launches_by_program)
                fn()
                k2[(backend, what)] = {wg: sum(v for k, v in (Counter(fused_decode_bwd.launches_by_program) - before).items()
                                               if k[-1] == wg) for wg in (False, True)}
                ms[(backend, what)] = statistics.median(cs.sync_time(fn)[1] * 1e3 for _ in range(opts.repeats))
        cs.log(f"[nef step] {name} (nef.backend=pallas), warm medians of {opts.repeats}: nef step {ms[('kernel', 'nef step')]:.2f} "
               f"ms on the kernels, {ms[('eager', 'nef step')]:.2f} eager; fit {ms[('kernel', 'fit')]:.2f} / "
               f"{ms[('eager', 'fit')]:.2f} ms; K2 launches without / with weight gradients: nef step "
               f"{k2[('kernel', 'nef step')][False]} / {k2[('kernel', 'nef step')][True]}, fit {k2[('kernel', 'fit')][False]} / "
               f"{k2[('kernel', 'fit')][True]}")
        del trainer, state, traj
        torch.cuda.empty_cache()
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
