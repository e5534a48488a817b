"""The port's data layer and override parser against the JAX package's, on the CPU.

Navier-Stokes solver pieces from the same inputs (the PRNG streams differ, so the
Gaussian coefficients and initial fields are handed in): ``sqrt_eig`` rtol 1e-6, the
forcing atol 1e-6, the initial field rel-L2 1e-6, the rollout rel-L2 1e-4 at 3 x 50
and 5 x 200 steps (both f32; only the FFTs' rounding differs). The cache, loader,
registry and override parser are compared exactly. Caches are filled through their
writers with seeded arrays; no test runs the 50,000-step generation protocol.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import Config as JaxConfig
from enf_pde_tpu.config import _parse_value as jax_parse_value
from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data import get_dataloader as jax_get_dataloader
from enf_pde_tpu.data import planar_coords as jax_planar_coords
from enf_pde_tpu.data import navier_stokes as jns
from enf_pde_tpu.data.cache import TrajectoryCache as JaxCache
from enf_pde_tpu.data.cache import test_seed as jax_test_seed
from enf_pde_tpu.data.loader import TrajectoryLoader as JaxLoader

from enf_pde_tpu_torch.config import Config, _parse_value, load_experiment_config
from enf_pde_tpu_torch.data import get_dataloader, planar_coords
from enf_pde_tpu_torch.data import navier_stokes as tns
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.cache import test_seed as port_test_seed
from enf_pde_tpu_torch.data.generate import main as generate_main
from enf_pde_tpu_torch.data.loader import TrajectoryLoader
from enf_pde_tpu_torch.data.registry import DATASET_NAMES, dataset_spec

torch.set_num_threads(1)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def gaussian_coefficients(n: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n, size, size)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ----------------------------------------------------------------- solver


def test_sqrt_eig_and_forcing_match_jax():
    np.testing.assert_allclose(tns.GaussianRF2D(64).sqrt_eig.numpy(),
                               np.asarray(jns.GaussianRF2D(64).sqrt_eig), rtol=1e-6)
    np.testing.assert_allclose(tns.default_forcing(64, "cpu").numpy(),
                               np.asarray(jns.default_forcing(64)), atol=1e-6)


def test_field_from_coefficients_matches_jax():
    coeff = gaussian_coefficients(3, 64, seed=0)
    want = jnp.fft.ifftn(jns.GaussianRF2D(64).sqrt_eig[None] * coeff, axes=(-2, -1)).real
    got = tns.GaussianRF2D(64).field(torch.from_numpy(coeff))
    assert got.shape == (3, 64, 64)
    assert rel_l2(got, want) <= 1e-6


@pytest.mark.parametrize("record_steps,steps_per_record", [(3, 50), (5, 200)])
def test_rollout_matches_jax(record_steps, steps_per_record):
    coeff = gaussian_coefficients(2, 64, seed=1)
    w0 = np.asarray(jnp.fft.ifftn(jns.GaussianRF2D(64).sqrt_eig[None] * coeff, axes=(-2, -1)).real)
    f = np.asarray(jns.default_forcing(64))
    want, want_final = jns.navier_stokes_rollout(jnp.asarray(w0), jnp.asarray(f), 1e-3, 1e-3,
                                                 record_steps, steps_per_record)
    got, got_final = tns.navier_stokes_rollout(torch.from_numpy(w0.copy()), torch.from_numpy(f.copy()),
                                               1e-3, 1e-3, record_steps, steps_per_record)
    assert got.shape == (2, record_steps, 64, 64)
    np.testing.assert_allclose(got[:, 0].numpy(), w0, atol=1e-6)  # the first snapshot: the input
    assert rel_l2(got, want) <= 1e-4
    assert rel_l2(got_final, want_final) <= 1e-4


def test_coefficients_are_seeded_on_the_cpu_and_generation_composes():
    sampler = tns.GaussianRF2D(16)
    a, b = sampler.coefficients(7), sampler.coefficients(7)
    assert a.device.type == "cpu" and a.dtype == torch.complex64
    assert torch.equal(a, b) and not torch.equal(a, sampler.coefficients(8))
    assert torch.equal(sampler.sample([7, 8], "cpu")[0], sampler.field(a))

    traj = tns.generate_ns_trajectories([3, 4], size=16, t_horizon=3, delta_t=1e-2, burn_in=0.05,
                                        device="cpu")
    assert traj.shape == (2, 3, 16, 16, 1) and traj.dtype == np.float32
    f = tns.default_forcing(16, "cpu")
    _, burned = tns.navier_stokes_rollout(sampler.sample([3, 4], "cpu"), f, 1e-3, 1e-2, 1, 5)
    want, _ = tns.navier_stokes_rollout(burned, f, 1e-3, 1e-2, 3, 100)
    np.testing.assert_array_equal(traj[..., 0], want.numpy())
    np.testing.assert_allclose(traj.mean(axis=(2, 3, 4)), 0.0, atol=1e-5)  # zero-mean physics


# ----------------------------------------------------------------- cache


def seeded_trajectories(n: int, seed: int, shape=(4, 8, 8, 1)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *shape)).astype(np.float32)


def test_cache_files_are_interchangeable_both_ways(tmp_path):
    data = seeded_trajectories(3, seed=2)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_cache, port_cache = JaxCache(str(jax_dir), None), TrajectoryCache(str(port_dir), None)
    for i, traj in enumerate(data):
        jax_cache._write_traj(i, traj)
        port_cache.write(i, traj)
    for i, traj in enumerate(data):
        np.testing.assert_array_equal(TrajectoryCache(str(jax_dir), None).get(i), traj)
        np.testing.assert_array_equal(JaxCache(str(port_dir), None).get(i), traj)
        for name in (f"traj_{i:06d}.raw", "shape.json"):
            assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes()
    assert JaxCache(str(port_dir), None).shape() == jax_cache.shape() == (4, 8, 8, 1)
    assert port_cache.raw_path(1) == jax_cache.raw_path(1).replace(str(jax_dir), str(port_dir))


def test_cache_generates_the_same_aligned_blocks_as_jax(tmp_path):
    calls = {"jax": [], "port": []}

    def generator(tag):
        def gen(ids):
            calls[tag].append([int(i) for i in ids])
            return seeded_trajectories(len(ids), seed=int(ids[0]))
        return gen

    jax_cache = JaxCache(str(tmp_path / "jax"), generator("jax"), batch_size_gen=4)
    port_cache = TrajectoryCache(str(tmp_path / "port"), generator("port"), batch_size_gen=4)
    for cache in (jax_cache, port_cache):
        cache.get(5)
        cache.ensure([0, 5, 6, 9])
        cache.get(2)
    assert calls["port"] == calls["jax"] == [[4, 5, 6, 7], [0, 1, 2, 3], [8, 9, 10, 11]]
    for i in range(12):
        np.testing.assert_array_equal(port_cache.get(i), jax_cache.get(i))


def test_cache_raises_when_generation_fails(tmp_path):
    def broken(ids):
        raise RuntimeError("solver failed")

    with pytest.raises(RuntimeError, match="solver failed"):
        TrajectoryCache(str(tmp_path), broken, batch_size_gen=2).get(0)
    assert not list(tmp_path.glob("traj_*"))


# ----------------------------------------------------------------- loader


def test_loader_batch_order_matches_jax():
    data = seeded_trajectories(10, seed=3, shape=(5, 4, 4, 1))
    coords = planar_coords(4, 4)
    kw = dict(indices=range(10), coords=coords, batch_size=3, shuffle=True, seed=0, max_frames=2)
    jax_loader = JaxLoader(lambda i: data[i], **kw)
    port_loader = TrajectoryLoader(lambda i: data[i], device="cpu", **kw)
    cached = TrajectoryLoader(lambda i: data[i], device="cpu", **kw)
    assert cached.enable_device_cache()
    assert len(port_loader) == len(jax_loader) == 3  # drop-last: 10 // 3
    for _ in range(3):
        for (jt, jc, jids), (pt, pc, pids), (ct, _, cids) in zip(jax_loader, port_loader, cached,
                                                                 strict=True):
            np.testing.assert_array_equal(pids, jids)
            np.testing.assert_array_equal(cids, jids)
            assert pt.shape == (3, 2, 4, 4, 1)
            np.testing.assert_array_equal(pt, jt)
            assert isinstance(ct, torch.Tensor) and ct.device.type == "cpu"
            np.testing.assert_array_equal(ct.numpy(), jt)
            np.testing.assert_array_equal(pc, jc)
    assert not TrajectoryLoader(lambda i: data[i], device="cpu", **kw).enable_device_cache(max_bytes=100)


# ----------------------------------------------------------------- registry, get_dataloader


def test_registry_names_and_test_seeds(monkeypatch):
    assert port_test_seed(3) == jax_test_seed(3) == 2**31 - 4
    seen = []

    def fake_generate(seeds, t_horizon, device):
        seen.append((list(seeds), t_horizon, device))
        return np.zeros((len(seeds), t_horizon, 64, 64, 1), np.float32)

    monkeypatch.setattr(tns, "generate_ns_trajectories", fake_generate)
    spec = dataset_spec("navier_stokes", device="cpu")
    spec.gen_train(np.arange(2))
    spec.gen_test(np.arange(2))
    assert seen == [([0, 1], 20, "cpu"), ([jax_test_seed(0), jax_test_seed(1)], 20, "cpu")]
    assert (spec.n_frames_train, spec.batch_size_gen, spec.cache_name) == (20, 16, "navier_stokes")
    long = dataset_spec("navier_stokes_long", Config({"traj_len_train": 10, "traj_len_out_horizon": 50}))
    long.gen_train(np.arange(1))
    assert seen[-1][1] == 60 and long.cache_name == "navier_stokes_long"
    # diffusion_plane, cahn_hilliard (tests/test_torch_planar_data.py), diff_sphere
    # (tests/test_torch_sphere_data.py), both shallow-water datasets
    # (tests/test_torch_shallow_water_data.py) and ihc (tests/test_torch_ihc_data.py) have specs.
    assert DATASET_NAMES[4] == "diff_sphere" and dataset_spec("diff_sphere", device="cpu").cache_name == "diff_sphere"
    assert DATASET_NAMES[5:7] == ("shallow_water", "shallow_water_low_res")
    assert {dataset_spec(n, device="cpu").cache_name for n in DATASET_NAMES[5:7]} == {"shallow_water"}
    assert DATASET_NAMES[7:] == ("ihc",) and dataset_spec("ihc", device="cpu").cache_name == "ihc_convection"
    with pytest.raises(ValueError):
        dataset_spec("no_such_dataset")


def fill_ns_cache(root, group: str, ids, seed: int, frames: int = 20):
    cache = TrajectoryCache(os.path.join(root, "navier_stokes", group), None)
    for i, traj in zip(ids, seeded_trajectories(len(ids), seed, (frames, 64, 64, 1))):
        cache.write(int(i), traj)


def test_get_dataloader_on_a_filled_cache_matches_jax(tmp_path, monkeypatch):
    fill_ns_cache(tmp_path, "train", range(4), seed=4)
    fill_ns_cache(tmp_path, "test", range(2), seed=5)
    cfg = {"name": "navier_stokes", "path": str(tmp_path), "batch_size": 2,
           "num_signals_train": 4, "num_signals_test": 2, "traj_len_train": 10,
           "traj_len_out_horizon": 50}
    train, test = get_dataloader(Config(cfg), device="cpu")
    train.ensure_all()
    test.ensure_all()
    monkeypatch.setattr("enf_pde_tpu.data.native_loader.native_available", lambda: False)
    jtrain, jtest = jax_get_dataloader(JaxConfig(cfg))
    np.testing.assert_array_equal(train.coords, jax_planar_coords(64, 64))
    for port, jax_loader, batches in ((train, jtrain, 2), (test, jtest, 1)):
        assert len(port) == len(jax_loader) == batches
        for _ in range(2):
            for (pt, _, pids), (jt, _, jids) in zip(port, jax_loader, strict=True):
                assert pt.shape == (2, 20, 64, 64, 1)
                np.testing.assert_array_equal(pids, jids)
                np.testing.assert_array_equal(pt, jt)


def test_generate_cli_writes_the_given_ids(tmp_path, monkeypatch):
    seen = []

    def fake_generate(seeds, t_horizon, device):
        seen.append(list(seeds))
        return seeded_trajectories(len(seeds), seed=6, shape=(t_horizon, 4, 4, 1))

    monkeypatch.setattr(tns, "generate_ns_trajectories", fake_generate)
    generate_main(["navier_stokes", "--path", str(tmp_path), "--group", "test", "--ids", "0,2",
                   "--device", "cpu"])
    generate_main(["navier_stokes", "--path", str(tmp_path), "--group", "test", "--count", "3",
                   "--device", "cpu"])
    assert seen == [[jax_test_seed(0), jax_test_seed(2)], [jax_test_seed(1)]]
    cache = JaxCache(str(tmp_path / "navier_stokes" / "test"), None)
    assert cache.shape() == (20, 4, 4, 1)
    np.testing.assert_array_equal(cache.get(2), seeded_trajectories(2, 6, (20, 4, 4, 1))[1])


# ----------------------------------------------------------------- config overrides

OVERRIDE_VALUES = [
    "3", "-2", "+3", "012", "09", "0x1F", "0b101", "1_000", "1:30", "1.0e-4", "1e-4", "1.0e4",
    "1.0e+4", ".5", "1.", "-.Inf", ".nan", "true", "False", "yes", "off", "null", "~", "",
    "abc", "data/", "outputs/ns run", "[1, 2]", "[a, 1.5, true]", "[]", "[[1, 2], [x]]",
    "'quoted'", '"double"', "1.5.3", "[1,2", "a # comment", "190:20:30.15",
]


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_override_parser_matches_jax(raw):
    got, want = _parse_value(raw), jax_parse_value(raw)
    if isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got)
    else:
        assert got == want and type(got) is type(want)


def test_override_parser_refuses_mappings():
    with pytest.raises(ValueError, match="does not parse"):
        _parse_value("{a: 1}")


def test_load_experiment_config_with_overrides_matches_jax():
    overrides = ["seed=2", "nef.num_hidden=32", "optimizer.learning_rate_enf=1.0e-3",
                 "logging.resume=true", "dataset.path=/tmp/ns", "new.key=[1, 2]"]
    got = load_experiment_config("navier_stokes", overrides)
    want = jax_load_config("navier_stokes", overrides)
    assert json.loads(json.dumps(got.to_dict())) == json.loads(json.dumps(want.to_dict()))
    with pytest.raises(ValueError, match="key.subkey=value"):
        load_experiment_config("navier_stokes", ["seed"])
