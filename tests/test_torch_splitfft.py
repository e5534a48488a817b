"""The split-complex DFT (``data/splitfft.py``) and the split Navier-Stokes path.

Each transform against the JAX package's ``splitfft`` and ``np.fft`` (atol 1e-4 of the
reference's largest entry); the split rollout against JAX's ``navier_stokes_rollout_split``
from one numpy field, 3 records x 50 steps (rel-L2 1e-5), and against the port's complex
rollout over 1,000 steps (rel-L2 1e-4); the split initial field and
``generate_ns_trajectories(split_fft=True)`` against the complex path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.data import navier_stokes as jax_ns
from enf_pde_tpu.data import splitfft as jax_splitfft

from enf_pde_tpu_torch.data import splitfft
from enf_pde_tpu_torch.data.navier_stokes import (
    GaussianRF2D,
    default_forcing,
    generate_ns_trajectories,
    navier_stokes_rollout,
    navier_stokes_rollout_split,
)

torch.set_num_threads(1)

N = 64


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, scale=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=scale * np.abs(want).max())


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 3, N, N)).astype(np.float32)


def test_dft_matrices_equal_jax():
    C, S = splitfft.dft_matrices(N)
    jC, jS = jax_splitfft.dft_matrices(N)
    assert C.dtype == torch.float32 and C.shape == (N, N)
    np.testing.assert_array_equal(C.numpy(), np.asarray(jC))
    np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
    np.testing.assert_array_equal(C.numpy(), C.numpy().T)


@pytest.mark.parametrize("name", ["fft2_split", "ifft2_split", "fft2_real_input", "ifft2_real_output"])
def test_transforms_match_jax_and_numpy(planes, name):
    a, b = planes
    C, S = splitfft.dft_matrices(N)
    jC, jS = jax_splitfft.dft_matrices(N)
    args = (a,) if name == "fft2_real_input" else (a, b)
    got = getattr(splitfft, name)(*(torch.from_numpy(x) for x in args), C, S)
    want_jax = getattr(jax_splitfft, name)(*(jnp.asarray(x) for x in args), jC, jS)
    z = a.astype(np.float64) + (0 if name == "fft2_real_input" else 1j * b.astype(np.float64))
    ref = np.fft.fft2(z) if name.startswith("fft") else np.fft.ifft2(z)
    if name == "ifft2_real_output":
        got, want_jax, ref = (got,), (want_jax,), (ref.real,)
    else:
        ref = (ref.real, ref.imag)
    for g, w, r in zip(got, want_jax, ref):
        assert g.shape == (3, N, N)
        close(g, w)
        close(g, r)


def test_split_sample_matches_the_complex_sample():
    grf = GaussianRF2D(N)
    got, want = grf.sample_split([5, 9], "cpu"), grf.sample([5, 9], "cpu")
    assert rel_l2(got, want) < 1e-5 and float(want.abs().max()) > 0.1


def test_split_rollout_matches_jax():
    w0 = GaussianRF2D(N).sample([3, 4], "cpu")
    f = default_forcing(N, "cpu")
    snaps, final = navier_stokes_rollout_split(w0, f, 1e-3, 1e-3, record_steps=3, steps_per_record=50)
    want_snaps, want_final = jax_ns.navier_stokes_rollout_split(
        jnp.asarray(w0.numpy()), jnp.asarray(f.numpy()), 1e-3, 1e-3, record_steps=3, steps_per_record=50)
    assert snaps.shape == (2, 3, N, N)
    assert torch.equal(snaps[:, 0], w0) or rel_l2(snaps[:, 0], w0) < 1e-6  # the first record: the start
    assert rel_l2(snaps, want_snaps) < 1e-5
    assert rel_l2(final, want_final) < 1e-5
    assert rel_l2(final, w0) > 1e-3  # the field moved


def test_split_rollout_matches_the_complex_rollout_over_1000_steps():
    w0 = GaussianRF2D(N).sample([11], "cpu")
    f = default_forcing(N, "cpu")
    _, split = navier_stokes_rollout_split(w0, f, 1e-3, 1e-3, record_steps=1, steps_per_record=1000)
    _, complex_ = navier_stokes_rollout(w0, f, 1e-3, 1e-3, record_steps=1, steps_per_record=1000)
    assert rel_l2(split, complex_) < 1e-4
    assert rel_l2(split, w0) > 1e-2


def test_generate_with_split_fft_matches_the_complex_path():
    kw = dict(size=16, t_horizon=2, delta_t=1e-2, burn_in=0.1, device="cpu")
    got = generate_ns_trajectories([1, 2], split_fft=True, **kw)
    want = generate_ns_trajectories([1, 2], **kw)
    assert got.shape == want.shape == (2, 2, 16, 16, 1) and got.dtype == np.float32
    assert rel_l2(got, want) < 1e-4
