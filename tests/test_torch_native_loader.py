"""The port's native trajectory prefetcher (``data/native_loader.py``, ``csrc/trajloader.cc``).

Mirrors ``tests/test_native_loader.py``: the g++ build and a round trip, overlapped
batch reads (also a batch larger than the read-ahead), the fetch errors, the cache's raw
companions; then the prefetcher on a cache the JAX package wrote (byte for byte), and
``get_dataloader`` with the device cache off (its batches through the prefetcher) against
the device cache on and against JAX's ``get_dataloader``. A source that does not compile
raises with the compiler's output: there is no fallback.
"""

import os

import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.data import get_dataloader as jax_get_dataloader
from enf_pde_tpu.data.cache import TrajectoryCache as JaxTrajectoryCache

from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import get_dataloader
from enf_pde_tpu_torch.data import native_loader
from enf_pde_tpu_torch.data.cache import TrajectoryCache
from enf_pde_tpu_torch.data.native_loader import SOURCE, NativePrefetcher, build_library
from enf_pde_tpu_torch.ops.cuda_lib import BUILD_DIR
from tests.test_torch_fit import fill_cache


def test_build_and_roundtrip(tmp_path):
    lib = build_library()
    assert lib.parent == BUILD_DIR and lib.exists() and "native" not in lib.parts
    assert build_library() == lib  # keyed by the source's hash: built once
    ref = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)
    path = str(tmp_path / "a.raw")
    ref.tofile(path)
    with NativePrefetcher(num_threads=2) as p:
        np.testing.assert_array_equal(p.fetch(p.submit(path), ref.shape), ref)


@pytest.mark.parametrize("n_files, max_inflight", [(6, 16), (9, 4)])
def test_batch_overlapped_reads(tmp_path, n_files, max_inflight):
    """All reads in flight at once, and a batch of more files than the read-ahead."""
    shape = (2, 8, 8, 1)
    refs = [np.full(shape, float(i), dtype=np.float32) for i in range(n_files)]
    paths = []
    for i, arr in enumerate(refs):
        paths.append(str(tmp_path / f"t{i}.raw"))
        arr.tofile(paths[-1])
    with NativePrefetcher(num_threads=3, max_inflight=max_inflight) as p:
        np.testing.assert_array_equal(p.load_batch(paths, shape), np.stack(refs))
        np.testing.assert_array_equal(p.load_batch(paths[::-1], shape), np.stack(refs[::-1]))


def test_fetch_errors(tmp_path):
    with NativePrefetcher() as p:
        t = p.submit(str(tmp_path / "missing.raw"))
        with pytest.raises(IOError, match="could not be read"):
            p.fetch(t, (4,))
        path = str(tmp_path / "b.raw")
        np.zeros(8, dtype=np.float32).tofile(path)
        t = p.submit(path)
        with pytest.raises(IOError, match="size mismatch"):
            p.fetch(t, (4,))
        # A failed batch releases the reads it still held; the prefetcher goes on.
        with pytest.raises(IOError):
            p.load_batch([str(tmp_path / "missing.raw")] + [path] * 20, (8,))
        np.testing.assert_array_equal(p.load_batch([path] * 20, (8,)), np.zeros((20, 8), np.float32))


def test_cache_writes_raw_companions(tmp_path):
    def gen(ids):
        return np.stack([np.full((2, 3, 3, 1), float(i), dtype=np.float32) for i in ids])

    cache = TrajectoryCache(str(tmp_path / "c"), gen, batch_size_gen=2)
    assert cache.shape() is None
    data = cache.get(0)
    assert cache.shape() == (2, 3, 3, 1)
    raw = np.fromfile(cache.raw_path(0), dtype=np.float32).reshape(cache.shape())
    np.testing.assert_array_equal(raw, data)
    os.remove(cache.raw_path(1))  # a companion lost: rewritten from the npz
    with NativePrefetcher() as p:
        out = p.load_batch([cache.ensure_raw(i) for i in (0, 1)], cache.shape())
    np.testing.assert_array_equal(out[1], cache.get(1))


def test_prefetcher_reads_a_cache_the_jax_package_wrote(tmp_path):
    rng = np.random.default_rng(3)
    block = rng.standard_normal((4, 5, 6, 6, 1)).astype(np.float32)
    jax_cache = JaxTrajectoryCache(str(tmp_path / "j"), lambda ids: block[ids], batch_size_gen=4)
    want = np.stack([jax_cache.get(i) for i in range(4)])
    np.testing.assert_array_equal(want, block)
    port_cache = TrajectoryCache(str(tmp_path / "j"), None)
    assert port_cache.shape() == jax_cache.shape() == block.shape[1:]
    with NativePrefetcher() as p:
        got = p.load_batch([port_cache.ensure_raw(i) for i in (3, 0, 2, 1)], port_cache.shape())
    assert got.tobytes() == want[[3, 0, 2, 1]].tobytes()


def _batches(loader) -> list:
    return [(np.asarray(torch.as_tensor(traj).cpu()), np.asarray(ids)) for traj, _, ids in loader]


def test_get_dataloader_prefetches_the_batches_of_the_device_cache_and_of_jax(tmp_path, monkeypatch):
    data_dir = tmp_path / "data"
    fill_cache(data_dir, "train", 4, seed=0)
    fill_cache(data_dir, "test", 2, seed=100)
    over = {"dataset.path": str(data_dir), "dataset.num_signals_train": 4,
            "dataset.num_signals_test": 2, "dataset.batch_size": 2}
    cfg = load_experiment_config("navier_stokes", [f"{k}={v}" for k, v in over.items()])
    reads = []
    real = native_loader.NativePrefetcher.load_batch
    monkeypatch.setattr(native_loader.NativePrefetcher, "load_batch",
                        lambda self, paths, shape: reads.append(len(paths)) or real(self, paths, shape))
    prefetched = [_batches(ldr) for ldr in get_dataloader(cfg.dataset, device="cpu")]
    assert reads == [2, 2, 2]  # every batch through the prefetcher: 2 train, 1 test
    cached_loaders = get_dataloader(cfg.dataset, device="cpu")
    for ldr in cached_loaders:
        assert ldr.enable_device_cache()
    cached = [_batches(ldr) for ldr in cached_loaders]
    assert len(reads) == 3  # the device cache reads the npz files, not the raw ones
    jax_cfg = jax_load_config("navier_stokes", [f"{k}={v}" for k, v in over.items()])
    jax_batches = [_batches(ldr) for ldr in jax_get_dataloader(jax_cfg.dataset)]
    for got, via_cache, want in zip(prefetched, cached, jax_batches):
        assert len(got) == len(want) > 0
        for (x, ids), (xc, idc), (xj, idj) in zip(got, via_cache, want):
            np.testing.assert_array_equal(ids, idj)
            np.testing.assert_array_equal(idc, idj)
            assert x.dtype == np.float32 and x.shape == (2, 20, 64, 64, 1)
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(xc, xj)


def test_a_source_that_does_not_compile_raises(tmp_path):
    bad = tmp_path / "trajloader_broken.cc"
    bad.write_text(SOURCE.read_text().replace("int64_t Submit(", "int64_t Submit(undeclared_type "))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build_library(bad)
    assert "undeclared_type" in str(err.value)
    assert not list(BUILD_DIR.glob("trajloader_broken-*"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        NativePrefetcher(source=bad)
