"""The bf16 nef step's second order on the kernels against right bf16 evaluations, on one card.

    python3 tools/nef_witness.py [--draws 8]

The Navier-Stokes nef step with ``nef.backend=pallas`` (second order through K1 and K2 in bf16, as
``chip_smoke.py``'s phase 35 takes it) on ``--draws`` draws (trainer seed, the step's frames and points),
beside the exact bf16 function (``x16``: the plain bf16 composition with float64 sums), its witnesses (the
plain bf16 composition on the card, ``plain16``, and on the CPU, ``cpu16``) and ``plain32``. Two more sides
take each kernel's share alone: ``k1_fwd``, whose value is K1 bf16's and every derivative the plain bf16
composition's, and ``k2_bwd``, whose value is the plain bf16 composition's and whose first derivative is K2
bf16's (its second the plain VJP's, as ``FusedDecodeVJP`` takes it). Each of the three is held by
``chip_smoke.witness_gates`` against the same witnesses (the loss printed, ungated), one line a draw, side and
gradient group: its distance to x16 and to plain32 in the gap between them. Prints the card's name and power
limit. Exits 1 when a gated group of the kernels lies past the witnesses' spread.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.ops import cuda_lib  # noqa: E402
from enf_pde_tpu_torch.ops import fused_decode as fd  # noqa: E402


class MixedDecode(torch.nn.Module):
    """``decoder`` whose kernel backend gives one kernel's share alone (``mode``): ``k1_fwd``, the value of
    K1 bf16 with every derivative of the plain bf16 composition; ``k2_bwd``, the value of the plain bf16
    composition with K2 bf16's first derivative (the kernel path's, through ``FusedDecode``)."""

    def __init__(self, decoder, mode: str):
        super().__init__()
        self.decoder, self.mode = decoder, mode
        self.plain = cs.PlainDecode(decoder, cs.BF16)

    def forward(self, x, p, a, w, backend="eager"):
        if backend == "eager":
            return self.decoder(x, p, a, w)
        plain = self.plain(x, p, a, w, backend)
        if self.mode == "k1_fwd":
            with torch.no_grad():
                kern = self.decoder(x, p, a, w, backend=backend)
            return plain + (kern - plain).detach()
        kern = self.decoder(x, p, a, w, backend=backend)
        return kern + (plain - kern).detach()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=8, help="draws of the nef step (trainer seed, frames, points)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("nef_witness: torch.cuda.is_available() is False; this needs a CUDA card.", file=sys.stderr)
        return 2
    for src in (fd.KERNEL_SOURCE_BF16, fd.BWD_KERNEL_SOURCE_BF16):
        cuda_lib.load(src)
    cs.log(f"[device] {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()} | torch {torch.__version__}")
    cfg = cs.load_experiment_config("navier_stokes", ["nef.backend=pallas"])
    coords = cs.planar_coords(cs.GRID, cs.GRID)
    traj = torch.from_numpy(cs.smooth_trajectories(cs.NUM_SIGNALS, cs.TRAIN_FRAMES, cs.GRID, cs.SEED + 3)).to("cuda")
    K, M, N = cfg.meta.num_inner_steps, cfg.training.max_num_sampled_points, coords.shape[0]
    witnesses = {"plain16": dict(dtype=cs.BF16), "cpu16": dict(dtype=cs.BF16, device="cpu"),
                 "x16": dict(dtype=cs.BF16, sums=torch.float64), "plain32": dict(dtype=torch.float32)}
    steps = {side: [] for side in ("kernel", "k1_fwd", "k2_bwd")}
    for s in range(opts.draws):
        t0 = time.perf_counter()
        trainer = cs.make_trainer(cfg, coords, seed=cs.SEED + s)
        state = trainer.init_state()
        gen = torch.Generator().manual_seed(cs.SEED + 60 + s)
        masks = torch.stack([torch.randperm(N, generator=gen)[:M] for _ in range(K + 1)])
        frame_idx = torch.randperm(cfg.dataset.traj_len_train, generator=gen)[:cfg.training.nef.fit_on_num_steps]
        decoder, out = trainer.decoder, {}
        sides = {"kernel": decoder, "k1_fwd": MixedDecode(decoder, "k1_fwd"), "k2_bwd": MixedDecode(decoder, "k2_bwd"),
                 **{tag: cs.PlainDecode(decoder, **kw) for tag, kw in witnesses.items()}}
        for tag, dec in sides.items():
            trainer.decoder = dec
            out[tag] = trainer.nef_grads(state, traj, frame_idx=frame_idx, masks=masks)
            torch.cuda.synchronize()
        trainer.decoder = decoder
        for side in steps:
            steps[side].append({"kernel": out[side], **{tag: out[tag] for tag in witnesses}})
        losses = "; ".join(f"{tag} {float(v[0]):.9e}" for tag, v in out.items())
        cs.log(f"[draw] {s}: losses {losses} ({time.perf_counter() - t0:.1f} s)")
        del trainer, state, out
        torch.cuda.empty_cache()
    groups = lambda name: "loss" if name == "0" else name.split(".")[1]  # noqa: E731
    bad = []
    for side, draws in steps.items():
        try:
            cs.witness_gates(f"nef step, {side}", draws, groups, ungated=("loss",))
        except AssertionError as e:
            cs.log(f"[witness] nef step, {side}: {e}")
            bad.append(side)
    cs.log(cs.nvidia_smi())
    return 1 if "kernel" in bad else 0


if __name__ == "__main__":
    sys.exit(main())
