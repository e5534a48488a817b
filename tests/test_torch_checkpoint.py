"""The trained paper-scale Navier-Stokes checkpoint decoded by both packages.

``results/ckpt/ns8192_s0/checkpoints/30`` (30 epochs on 8192 trajectories) is
restored with the JAX ``CheckpointManager`` from a copy in a temporary directory,
converted with ``enf_pde_tpu_torch.convert``, and 2 frames x 4096 points are decoded
by the JAX eager decoder, the port's eager decoder and the port's kernel backend
(its plain version on the CPU). Full published width: hidden 128, 2 heads, 4 latents.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from enf_pde_tpu.builders import build_models as jax_build_models
from enf_pde_tpu.config import Config as JaxConfig
from enf_pde_tpu.train.checkpoint import CheckpointManager
from enf_pde_tpu.train.meta_sgd import MetaSGDTrainer as JaxTrainer

from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.convert import convert_params
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.inference import Forecaster
from tests.test_torch_modules import assert_close, np_tree

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parents[1] / "results" / "ckpt" / "ns8192_s0"
EPOCH = 30


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    work = tmp_path_factory.mktemp("ckpt") / CKPT.name
    shutil.copytree(CKPT, work)
    mgr = CheckpointManager(str(work))
    cfg = JaxConfig(mgr.restore_config(EPOCH))
    coords = planar_coords(64, 64)
    decoder, ode = jax_build_models(cfg)
    trainer = JaxTrainer(cfg, decoder, ode, coords, seed=0)
    state = mgr.restore(trainer.init_state(), EPOCH)
    mgr.close()
    return cfg, trainer, state, coords


def test_config_matches_checkpoint_widths(restored):
    cfg, _, _, _ = restored
    port = load_experiment_config("navier_stokes")
    assert port.nef.to_dict() == cfg.nef.to_dict()
    assert port.node.to_dict() == cfg.node.to_dict()
    assert port.meta.to_dict() == cfg.meta.to_dict()


def test_trained_decode_matches_jax(restored):
    cfg, trainer, state, coords = restored
    fc = Forecaster(load_experiment_config("navier_stokes"), coords,
                    params=convert_params(np_tree(state.params)), device="cpu")
    rng = np.random.default_rng(0)
    init = {k: np.asarray(v) for k, v in state.params["autodecoder"].items()}
    p = (init["p_pos"] + 0.1 * rng.standard_normal((2, 4, 2))).astype(np.float32)
    a = (init["a"] + 0.5 * rng.standard_normal((2, 4, 16))).astype(np.float32)
    w = np.repeat(init["gaussian_window"], 2, axis=0)
    xs = np.broadcast_to(coords[None], (2, *coords.shape))
    want = np.asarray(trainer.decoder.apply(state.params["nef"], xs, p, a, w))
    assert want.shape == (2, 4096, 1) and np.abs(want).max() > 0.1

    dec = fc.trainer.decoder
    args = [torch.from_numpy(np.ascontiguousarray(v)) for v in (xs, p, a, w)]
    with torch.no_grad():
        eager = dec(*args, backend="eager")
        kernel = dec(*args, backend="kernel")
    assert_close(eager, want)
    assert_close(kernel, want)
