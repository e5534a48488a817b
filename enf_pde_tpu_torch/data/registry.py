"""Per-dataset generator and coordinate registry shared by loaders and the generation CLI.

Counterpart of ``enf_pde_tpu/data/registry.py``. ``dataset_spec(name)`` returns what
caches and loaders need: train/test batch generators, the coordinate grid, per-split
frame handling and the solver batch size. Ported: the Navier-Stokes datasets, the
SE(2) planar ones (``diffusion_plane``, ``cahn_hilliard``), the heat equation on the
sphere (``diff_sphere``, on its 128 x 64 (phi, theta) grid) and the Galewsky-jet shallow
water on the sphere (``shallow_water`` on its 192 x 96 generation grid and
``shallow_water_low_res`` on the 96 x 48 one, 2 x 2 mean-pooled; one cache serves both),
and the Boussinesq convection in the ball (``ihc``, on its 48 x 24 x 24 output grid).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from enf_pde_tpu_torch.data.cache import test_seed

__all__ = ["DatasetSpec", "dataset_spec", "DATASET_NAMES"]

DATASET_NAMES = (
    "navier_stokes",
    "navier_stokes_long",
    "diffusion_plane",
    "cahn_hilliard",
    "diff_sphere",
    "shallow_water",
    "shallow_water_low_res",
    "ihc",
)


class DatasetSpec(NamedTuple):
    gen_train: Callable[[np.ndarray], np.ndarray]
    gen_test: Callable[[np.ndarray], np.ndarray]
    coords: np.ndarray
    n_frames_train: Optional[int]  # truncation applied to the train split
    batch_size_gen: int
    cache_name: str  # subdirectory under the dataset path (shared between variants)
    postprocess: Callable[[np.ndarray], np.ndarray]  # applied per trajectory at load


def _identity(x: np.ndarray) -> np.ndarray:
    return x


def dataset_spec(name: str, dataset_cfg=None, device="cuda") -> DatasetSpec:
    """The spec of dataset ``name``; its solvers run on ``device``."""
    from enf_pde_tpu_torch.data import angular_coords, ball_coords, planar_coords

    if name in ("navier_stokes", "navier_stokes_long"):
        from enf_pde_tpu_torch.data.navier_stokes import generate_ns_trajectories

        if name == "navier_stokes":
            t_horizon = 20
        else:
            t_horizon = dataset_cfg.traj_len_train + dataset_cfg.traj_len_out_horizon

        return DatasetSpec(
            gen_train=lambda ids: generate_ns_trajectories(ids, t_horizon=t_horizon, device=device),
            gen_test=lambda ids: generate_ns_trajectories(
                [test_seed(i) for i in ids], t_horizon=t_horizon, device=device),
            coords=planar_coords(64, 64),
            n_frames_train=20,
            batch_size_gen=16,
            cache_name=name,
            postprocess=_identity,
        )
    if name == "diffusion_plane":
        from enf_pde_tpu_torch.data.diffusion_plane import generate_diffusion_trajectories

        return DatasetSpec(
            gen_train=lambda ids: generate_diffusion_trajectories(ids, test=False, device=device),
            gen_test=lambda ids: generate_diffusion_trajectories(
                [test_seed(i) for i in ids], test=True, device=device),
            coords=planar_coords(64, 64),
            n_frames_train=20,
            batch_size_gen=32,
            cache_name=name,
            postprocess=_identity,
        )
    if name == "cahn_hilliard":
        from enf_pde_tpu_torch.data.cahn_hilliard import generate_ch_trajectories

        return DatasetSpec(
            gen_train=lambda ids: generate_ch_trajectories(ids, device=device),
            gen_test=lambda ids: generate_ch_trajectories([test_seed(i) for i in ids], device=device),
            coords=planar_coords(64, 64),
            n_frames_train=20,
            batch_size_gen=8,
            cache_name=name,
            postprocess=_identity,
        )
    if name == "diff_sphere":
        from enf_pde_tpu_torch.data.diffusion_sphere import (
            generate_sphere_diffusion_trajectories,
            sphere_diffusion_grid,
        )

        grid = sphere_diffusion_grid(device=device)
        return DatasetSpec(
            gen_train=lambda ids: generate_sphere_diffusion_trajectories(ids, grid=grid),
            gen_test=lambda ids: generate_sphere_diffusion_trajectories(
                [test_seed(i) for i in ids], grid=grid),
            coords=angular_coords(grid.phi, grid.theta),
            n_frames_train=20,
            batch_size_gen=16,
            cache_name=name,
            postprocess=_identity,
        )
    if name in ("shallow_water", "shallow_water_low_res"):
        from enf_pde_tpu_torch.data.shallow_water import _avg_pool_2x2, generate_sw_trajectories, sw_grid
        from enf_pde_tpu_torch.data.sphere_harmonics import SphereGrid

        grid = sw_grid(device=device)
        if name.endswith("low_res"):
            coarse = SphereGrid(grid.nphi // 2, grid.ntheta // 2, device="cpu")
            coords = angular_coords(coarse.phi, coarse.theta)
            post = lambda t: _avg_pool_2x2(t[6:])  # noqa: E731
        else:
            coords = angular_coords(grid.phi, grid.theta)
            post = lambda t: t[6:]  # noqa: E731
        return DatasetSpec(
            gen_train=lambda ids: generate_sw_trajectories(ids, grid=grid),
            gen_test=lambda ids: generate_sw_trajectories([test_seed(i) for i in ids], grid=grid),
            coords=coords,
            n_frames_train=None,  # the 6-frame skip is the postprocess's
            batch_size_gen=4,
            cache_name="shallow_water",  # both resolutions share the cache
            postprocess=post,
        )
    if name == "ihc":
        from enf_pde_tpu_torch.data.ihc import full_size_solver, generate_ihc_trajectories

        # Ra 1e6 Boussinesq convection (reference pdes.py:738-846), the solver built once at
        # the first generation.
        return DatasetSpec(
            gen_train=lambda ids: generate_ihc_trajectories(ids, full_size_solver(device)),
            gen_test=lambda ids: generate_ihc_trajectories([test_seed(i) for i in ids], full_size_solver(device)),
            coords=ball_coords(48, 24, 24),
            n_frames_train=None,
            batch_size_gen=2,  # one batched block of two trajectories
            cache_name="ihc_convection",
            postprocess=lambda t: t[6:],
        )
    raise ValueError(f"Unknown dataset name: {name!r}")
