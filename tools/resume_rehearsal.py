"""A CPU rehearsal of ``chip_smoke.py`` phase 37's checks (c) and (d) on the trained runs it resumes.

    python tools/resume_rehearsal.py --data <dataset path> [--batch N] [--run ns8192_s0 ...]

No kernel runs on the CPU, so the plain compositions stand in for them, as the kernel wrappers run them
on CPU tensors: ``pallas`` is the plain bf16 composition (the ``kernel`` backend's compute dtype set to
bf16 on the CPU as well), ``pallas_interpret`` the plain f32 one, beside the eager decoder. From each export's restored state (its optimizer states
loaded), on the first ``--batch`` test trajectories of ``<dataset path>`` (a cache as ``get_dataloader``
writes it: ``python -m enf_pde_tpu_torch.experiments.fit``'s data, or ``enf_pde_tpu_torch.data.generate``
with ``--device cpu``), it prints:

- ``chip_smoke.drift_check``: DRIFT_STEPS ode and dual steps on each side, the losses and the largest
  relative drift from eager, beside JAX's TPU record (past it, the gate's message is printed);
- ``chip_smoke.first_loss_sides`` at the ode step's own decode inputs, the plain bf16 composition with f32
  sums in the kernels' place (a right bf16 evaluation, as a kernel's is): ``chip_smoke.first_loss_gates``;
- ``chip_smoke.restored_vs_fresh``: the first ode step with the restored against fresh optimizer states.

The numbers predict phase 37's on the card; they are CPU numbers, not the card's.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from enf_pde_tpu_torch.builders import build_models  # noqa: E402
from enf_pde_tpu_torch.config import Config  # noqa: E402
from enf_pde_tpu_torch.convert import load_jax_export, load_opt_state  # noqa: E402
from enf_pde_tpu_torch.data import get_dataloader  # noqa: E402
from enf_pde_tpu_torch.models import decoder as decoder_module  # noqa: E402
from enf_pde_tpu_torch.ops.fused_decode import fused_decode_plain  # noqa: E402
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer  # noqa: E402

BF16 = torch.bfloat16


def rehearse(run: str, data: str, batch: int) -> None:
    t0 = time.perf_counter()
    cfg, params, record = load_jax_export(chip_smoke.WEIGHTS_DIR / run)
    opt, _, _ = load_opt_state(chip_smoke.WEIGHTS_DIR / run, cfg)
    test_cfg = Config(cfg.to_dict())
    for k, v in {"dataset.path": data, "dataset.num_signals_test": batch, "dataset.batch_size": batch}.items():
        test_cfg.set_path(k, v)
    _, test = get_dataloader(test_cfg.dataset, device="cpu")
    traj = torch.cat([torch.as_tensor(b[0]) for b in test])[:batch]
    trainer = MetaSGDTrainer(cfg, *build_models(cfg), test.coords, seed=cfg.seed, device="cpu")
    state = trainer.load_state(params, opt)
    draws = chip_smoke.resume_draws(cfg, trainer.coords.shape[0], chip_smoke.DRIFT_STEPS, chip_smoke.SEED + 37)
    chip_smoke.log(f"[rehearsal] {run}: {tuple(traj.shape)} test trajectories of {data} on the CPU, from epoch "
                   f"{record['epoch']}; optimizer counts " + ", ".join(f"{g} {s['count']}" for g, s in opt.items()))
    as_on_card = lambda backend, device: BF16 if backend == "kernel" else torch.float32  # noqa: E731
    with mock.patch.object(decoder_module, "kernel_compute_dtype", as_on_card):
        try:
            chip_smoke.drift_check(run, trainer, state, traj, draws)
        except AssertionError as e:  # the plain f32 composition past JAX's record: printed, the rehearsal goes on
            chip_smoke.log(f"[rehearsal] {run}: {e}")
    decoder, capture = trainer.decoder, chip_smoke.CaptureDecode(trainer.decoder)
    trainer.decoder = capture
    trainer.ode_grads(state, traj, **draws[0])  # the step's decode inputs
    trainer.decoder = decoder
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    first = chip_smoke.first_loss_sides(capture.args, chip_smoke.rollout_targets(traj, draws[0]["ode_masks"]), H, D,
                                        kernel=fused_decode_plain(*capture.args, H, D, compute_dtype=BF16))
    try:
        chip_smoke.first_loss_gates(f"[rehearsal] {run} first ode step's loss (the plain bf16 composition in the "
                                    "kernels' place)", *first)
    except AssertionError as e:
        chip_smoke.log(f"[rehearsal] {run}: past the gates: {e}")
    chip_smoke.restored_vs_fresh(run, trainer, state, traj, draws[0])
    chip_smoke.log(f"[rehearsal] {run} in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="a dataset path holding the runs' test splits")
    ap.add_argument("--batch", type=int, default=None, help="trajectories a step (default the run's batch size)")
    ap.add_argument("--run", nargs="+", default=list(chip_smoke.RESUME_RUNS), choices=chip_smoke.RESUME_RUNS)
    args = ap.parse_args(argv)
    for run in args.run:
        batch = args.batch or load_jax_export(chip_smoke.WEIGHTS_DIR / run)[0].dataset.batch_size
        rehearse(run, args.data, batch)


if __name__ == "__main__":
    main()
