"""Optimizers of the meta-SGD trainer, with optax's exact update rules.

Counterpart of ``enf_pde_tpu/train/state.py``. Each optimizer updates one group of
named tensors (a plain dict) in place and keeps its state in a plain dict:

- decoder (``nef``) and ODE: ``optax.chain(clip_by_global_norm(1.0), adamw(lr))``,
  the ODE with its own weight decay (``optimizer.weight_decay_ode``, default 1e-4);
- shared init latents (``autodecoder``): ``optax.adam(learning_rate_codes)``;
- meta-SGD inner learning rates: ``optax.adam(learning_rate_meta_sgd)``, the caller
  clips the result to [1e-6, 10].

What optax does, and ``torch.optim`` does differently: the clip is
``g * max_norm / ||g||`` only when ``||g|| >= max_norm``, over the group's whole tree
(``clip_grad_norm_`` adds 1e-6 to the norm); Adam's eps 1e-8 is added outside the
square root of the bias-corrected second moment; AdamW's decoupled decay
``lr * wd * param`` applies to every leaf of the group. The decoder's group holds its
RFF coefficients too: JAX keeps them as (stop-gradient) params, so they decay every
step with zero gradient, and so they do here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["Adam", "clip_by_global_norm", "make_optimizers", "moment_mismatches", "restore_opt_states"]

Group = Dict[str, torch.Tensor]


def clip_by_global_norm(grads: Group, max_norm: float) -> Group:
    """optax ``clip_by_global_norm``: scale all leaves by ``max_norm / ||g||`` if above.

    The squares are summed in float64 (each exact there), so the norm does not depend on a
    leaf's memory layout: an f32 reduction's order follows its strides and alignment, which
    differ between autograd's gradients and the views a data mesh's all-reduce hands back."""
    norm = torch.sqrt(sum(torch.sum(g.double() * g.double()) for g in grads.values())).float()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return {k: g * scale for k, g in grads.items()}


class Adam:
    """optax ``adam`` / ``adamw`` (b1 0.9, b2 0.999, eps 1e-8), optionally after a clip.

    Args:
        lr: learning rate.
        weight_decay: AdamW's decoupled decay (0 for plain Adam).
        clip_norm: global-norm clip applied to the gradients first (None: none).
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, weight_decay: float = 0.0, clip_norm: Optional[float] = None):
        self.lr, self.weight_decay, self.clip_norm = float(lr), float(weight_decay), clip_norm

    def init(self, params: Group) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: Group, state: dict, params: Group) -> dict:
        """Apply one step to ``params`` in place; returns the new state.

        ``grads`` has the keys of ``params``; a missing key means a zero gradient.
        """
        grads = {k: grads[k] if grads.get(k) is not None else torch.zeros_like(v)
                 for k, v in params.items()}
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = self.b1 * state["mu"][k] + (1.0 - self.b1) * g
            nu[k] = self.b2 * state["nu"][k] + (1.0 - self.b2) * g * g
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(self.lr * u)
        return {"count": count, "mu": mu, "nu": nu}


def make_optimizers(cfg) -> Dict[str, Adam]:
    """The four optimizers of ``enf_pde_tpu/train/state.py::make_optimizers``."""
    lr_enf = float(cfg.optimizer.learning_rate_enf)
    wd_ode = float(cfg.get_path("optimizer.weight_decay_ode", 1e-4))
    return {
        "nef": Adam(lr_enf, weight_decay=1e-4, clip_norm=1.0),  # optax.adamw's default decay
        "autodecoder": Adam(float(cfg.optimizer.learning_rate_codes)),
        "ode": Adam(lr_enf, weight_decay=wd_ode, clip_norm=1.0),
        "meta_sgd": Adam(float(cfg.get_path("meta.learning_rate_meta_sgd", 1e-4))),
    }


def moment_mismatches(opt: dict, shapes: Dict[str, Dict[str, tuple]]) -> list:
    """Each way the moments of ``opt`` (``{group: {'count', 'mu', 'nu'}}``, as ``Adam.init`` makes
    them) differ from ``shapes`` (``{group: {key: shape}}``): a group, a moment's key or its shape,
    named."""
    odd = [f"{'unexpected' if g in opt else 'missing'} optimizer state {g}" for g in sorted(set(opt) ^ set(shapes))]
    for g in sorted(set(opt) & set(shapes)):
        for moment in ("mu", "nu"):
            got, want = opt[g][moment], shapes[g]
            odd += [f"{'unexpected' if k in got else 'missing'} {g} moment {moment} {k}" for k in sorted(set(got) ^ set(want))]
            odd += [f"{g} moment {moment} {k} has shape {tuple(got[k].shape)}, its group's {tuple(want[k])}"
                    for k in sorted(set(got) & set(want)) if tuple(got[k].shape) != tuple(want[k])]
    return odd


def restore_opt_states(opt: dict, groups: Dict[str, Group], device) -> dict:
    """The optimizer states ``opt`` (as ``Adam.init`` makes them and ``convert.convert_opt_state``
    converts JAX's) checked against ``groups``, the tensors each optimizer updates, and copied to
    ``device``. Raises ``KeyError`` naming every group, moment key or shape that differs."""
    odd = moment_mismatches(opt, {g: {k: tuple(v.shape) for k, v in t.items()} for g, t in groups.items()})
    if odd:
        raise KeyError("; ".join(odd))
    return {g: {"count": int(opt[g]["count"]),
                **{m: {k: torch.as_tensor(v, dtype=torch.float32).to(device, copy=True) for k, v in opt[g][m].items()}
                   for m in ("mu", "nu")}}
            for g in groups}
