"""Where the bf16 K1 moves a trained run's first ode loss: each side's decode at the ode step, on the card.

    python tools/first_loss_probe.py [--run sw_full_s1 ns8192_s0]

``chip_smoke.py`` phase 37 holds the bf16 kernels' first-step loss beside right evaluations of the same bf16
function (``chip_smoke.first_loss_gates``). This tool says where a loss's distance comes from. For each run it
generates the test trajectories phase 37 trains on (8 Navier-Stokes, 4 shallow-water; under ``chiprun_out/``,
removed after), restores the export with its optimizer states, takes the first ode step's decode inputs on the
draws phase 37 takes and the loss's gradient g with respect to the decode (through the plain f32 composition), and
prints for K1 bf16 and the right evaluations ``plain16`` and ``cpu16`` (``chip_smoke.plain_sides``):

- the decode's distance from the exact bf16 function ``x16`` as a tensor, in gaps |plain32 - x16|; the loss's
  first-order change <g, e> (e = o - x16) and its cosine with g; e's scale on the output u, <e, u> / <u, u>;
- the same for x16's tail (out-projection, FFN and head, bf16 operands, float64 sums) on each side's attention
  output: how much of a loss's distance comes with the attention output into the tail;
- the attention output's own distance from x16's, in its gap;
- ``chip_smoke.first_loss_sides`` and ``first_loss_gates``.

Needs a CUDA device; builds K1's two programs.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from enf_pde_tpu_torch.builders import build_models  # noqa: E402
from enf_pde_tpu_torch.config import load_experiment_config  # noqa: E402
from enf_pde_tpu_torch.convert import load_jax_export, load_opt_state  # noqa: E402
from enf_pde_tpu_torch.data import get_dataloader  # noqa: E402
from enf_pde_tpu_torch.ops import cuda_lib  # noqa: E402
from enf_pde_tpu_torch.ops.fused_decode import _mm, _normalize, fused_decode_fwd, fused_decode_plain  # noqa: E402
from enf_pde_tpu_torch.ops.layers import gelu  # noqa: E402
from enf_pde_tpu_torch.train.meta_sgd import MetaSGDTrainer  # noqa: E402

BF16 = torch.bfloat16
# Each run's dataset and the test trajectories phase 37 trains on.
SPLITS = {"sw_full_s1": ("shallow_water", cs.SW_SIGNALS), "ns8192_s0": ("navier_stokes", cs.VAL_SIGNALS)}


class PlainCapture(torch.nn.Module):
    """``decoder`` whose kernel backends decode through the plain f32 composition, keeping the last decode's kernel
    inputs (``args``) and the cotangent its output receives (``g``)."""

    def __init__(self, decoder):
        super().__init__()
        self.decoder, self.args, self.g = decoder, None, None

    def forward(self, x, p, a, w, backend="eager"):
        d = self.decoder
        if backend == "eager":
            return d(x, p, a, w)
        with torch.no_grad():
            self.args = d.kernel_inputs(x, p, a, w)
        out = fused_decode_plain(*d.kernel_inputs(x, p, a, w), d.num_heads, d.num_hidden)
        out.register_hook(lambda g: setattr(self, "g", g.detach()))
        return out


def bf16_tail(y, tws):
    """``fused_decode_plain``'s tail in its bf16 mode on the attention output ``y``."""
    o_w, o_b, p_w1, p_b1, p_w2, p_b2, h_w1, h_b1, h_w2, h_b2, h_w3, h_b3 = tws
    y = _mm(y, o_w, True) + o_b
    t = _normalize(gelu(_mm(y, p_w1, True) + p_b1))
    y = gelu(_mm(t, p_w2, True) + p_b2)
    h = gelu(_mm(gelu(_mm(y, h_w1, True) + h_b1), h_w2, True) + h_b2)
    return _mm(h, h_w3, True) + h_b3


def probe(run: str, coords, traj) -> None:
    cfg, params, _ = load_jax_export(cs.WEIGHTS_DIR / run)
    opt, _, _ = load_opt_state(cs.WEIGHTS_DIR / run, cfg)
    trainer = MetaSGDTrainer(cfg, *build_models(cfg), coords, seed=cfg.seed, device="cuda")
    state = trainer.load_state(params, opt)
    draws = cs.resume_draws(cfg, trainer.coords.shape[0], 1, cs.SEED + 37)[0]
    decoder, capture = trainer.decoder, PlainCapture(trainer.decoder)
    trainer.decoder = capture
    trainer.ode_grads(state, traj, **draws)
    trainer.decoder = decoder
    args, g = capture.args, capture.g.double()
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    with torch.no_grad():
        x64 = (*(t.double() for t in args[:6]), [t.double() for t in args[6]], [t.double() for t in args[7]])
        no_tail = (*args[:7], ())
        ys = {"kernel": fused_decode_fwd(*no_tail, num_heads=H, head_dim=D, compute_dtype=BF16),
              **{k: v for k, v in cs.plain_sides(no_tail, H, D).items()}}
        outs = {"kernel": fused_decode_fwd(*args, num_heads=H, head_dim=D, compute_dtype=BF16),
                **cs.plain_sides(args, H, D)}
        tail64 = [t.double() for t in args[7]]
        for side in ("kernel", "plain16", "cpu16"):
            outs[f"x16 tail of {side}'s attention output"] = bf16_tail(ys[side].double(), tail64)
        u = fused_decode_plain(*x64, H, D, BF16)
        gap = float((outs["plain32"].double() - u).norm())
        cs.log(f"[probe] {run}: decode {tuple(u.shape)}, rms {float(u.pow(2).mean().sqrt()):.4e}, its gap |plain32 - x16| "
               f"{gap:.4e} ({gap / float(u.norm()):.3e} of it); |g| {float(g.norm()):.4e}")
        for side, o in outs.items():
            if side == "x16":
                continue
            e = o.double() - u
            proj = float((g * e).sum())
            cs.log(f"[probe] {run} {side}: {float(e.norm()) / gap:.4f} gap from x16; <g, e> {proj:+.4e} (cosine "
                   f"{proj / float(g.norm() * e.norm()):+.4f}); <e, u> / <u, u> {float((e * u).sum() / (u * u).sum()):+.3e}")
        y16 = ys["x16"].double()
        y_gap = float((ys["plain32"].double() - y16).norm())
        cs.log(f"[probe] {run} attention output, from x16's in its gap: " + ", ".join(
            f"{side} {float((ys[side].double() - y16).norm()) / y_gap:.4f}" for side in ("kernel", "plain16", "cpu16")))
        loss, dist = cs.first_loss_sides(args, cs.rollout_targets(traj, draws["ode_masks"]), H, D, kernel=outs["kernel"])
    try:
        cs.first_loss_gates(f"[probe] {run}", loss, dist)
    except AssertionError as e:
        cs.log(f"[probe] {run}: past the gates: {e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", nargs="+", default=list(SPLITS), choices=list(SPLITS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("first_loss_probe needs a CUDA device")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(cuda_lib.build, (cs.KERNEL_SOURCE, cs.KERNEL_SOURCE_BF16)))
    cs.log(f"[probe] {cs.nvidia_smi()}")
    for run in args.run:
        name, n = SPLITS[run]
        path = cs.fresh_dir(cs.OUT_DIR / f"probe_{name}_data")
        cfg = load_experiment_config(name, [f"dataset.path={path}", f"dataset.num_signals_test={n}",
                                            "dataset.num_signals_train=1"])
        _, test = get_dataloader(cfg.dataset, device="cuda")
        test.ensure_all()
        cs.keep_test_split(name, path, n)
        shutil.rmtree(path)
        batch = load_jax_export(cs.WEIGHTS_DIR / run)[0].dataset.batch_size
        probe(run, test.coords, torch.from_numpy(cs.TEST_SPLITS[cfg.dataset.name][:batch]).cuda())


if __name__ == "__main__":
    main()
