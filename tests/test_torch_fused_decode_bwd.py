"""The port's backward decode (plain version of kernel K2, ``FusedDecode``) on the CPU.

On the CPU the K2 wrapper runs its plain version (autograd over the plain forward);
the CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``. Here:

- the plain VJP against ``jax.vjp`` of JAX ``_reference_decode`` on identical inputs,
  with and without the tail (rtol 2e-4 / atol 2e-5, as ``tests/test_pallas.py``);
- the kernel backend's gradients through ``FusedDecode`` against the eager decoder's;
- what ``FusedDecode`` computes (only the gradients asked for), and its double
  backward against the eager decoder's;
- the wrapper's dispatch, its input checks and the C interface it binds.
"""

import re

import jax
import numpy as np
import pytest
import torch

from enf_pde_tpu.ops import pallas_decode as jpd

from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops import fused_decode as fd
from tests.test_torch_fused_decode import jax_fused_inputs
from tests.test_torch_modules import B, D, H, N, Z, assert_close, decoder_pair, t

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def pair():
    return decoder_pair(seed=13)


def port_args(dec, inputs, jargs, with_tail):
    """JAX's kernel inputs as the port's tensors: identical values, the port's shapes."""
    x, p, a, sigma = inputs
    with torch.no_grad():
        ref = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    conv = lambda vals, refs: tuple(torch.from_numpy(np.array(v)).reshape(r.shape)  # noqa: E731
                                    for v, r in zip(vals, refs))
    return (*conv(jargs[:6], ref[:6]), conv(jargs[6], ref[6]),
            conv(jargs[7], ref[7]) if with_tail else ())


@pytest.mark.parametrize("with_tail", [True, False])
def test_plain_vjp_matches_jax_reference(pair, with_tail):
    jdec, params, dec, (x, p, a, sigma) = pair
    spec, jargs = jax_fused_inputs(jdec, params, x, p, a, sigma, with_tail)
    out, vjp = jax.vjp(lambda *args: jpd._reference_decode(spec, *args), *jargs)
    g = np.random.default_rng(4).standard_normal(out.shape).astype(np.float32)
    jgrads = vjp(g)
    args = port_args(dec, (x, p, a, sigma), jargs, with_tail)
    got = fd.fused_decode_bwd_plain(*args, torch.from_numpy(g), H, D)
    for name, gv, jv in zip(("dinv", "dwb", "dA", "dab", "dG", "dc"), got[:6], jgrads[:6]):
        jv = np.asarray(jv)
        assert float(np.abs(jv).max()) > 0, name
        assert_close(gv, jv.reshape(gv.shape), rtol=RTOL, atol=ATOL)
    for i, (gw, jw) in enumerate(zip((*got[6], *got[7]), (*jgrads[6], *jgrads[7]))):
        if (i if i < len(fd.WEIGHT_NAMES) else -1) in fd.COEFF_INDICES:
            assert gw is None and not np.asarray(jw).any()  # stop_gradient in JAX
            continue
        assert_close(gw, np.asarray(jw).reshape(gw.shape), rtol=RTOL, atol=ATOL)
    assert len(got[7]) == (len(fd.TAIL_WEIGHT_NAMES) if with_tail else 0)


def test_kernel_backend_gradients_equal_eager(pair):
    """FusedDecode's gradients reach the latents and every parameter as eager autograd's."""
    _, _, dec, (x, p, a, sigma) = pair
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((B, N, 1)).astype(np.float32))
    params = [q for q in dec.parameters()]
    grads = {}
    for backend in ("eager", "kernel"):
        lat = [t(v).requires_grad_(True) for v in (p, a, sigma)]
        out = dec(t(x), *lat, backend=backend)
        grads[backend] = torch.autograd.grad(out, lat + params, g, allow_unused=True)
    nonzero = 0
    for ge, gk in zip(grads["eager"], grads["kernel"]):
        assert (ge is None) == (gk is None)
        if ge is not None:
            nonzero += bool(ge.abs().max() > 0)
            assert_close(gk, ge, rtol=RTOL, atol=ATOL)
    assert nonzero >= len(params)  # the window's gradient included


def test_fused_decode_computes_only_what_is_needed(pair, monkeypatch):
    _, _, dec, (x, p, a, sigma) = pair
    seen = []
    real = fd.fused_decode_bwd

    def spy(*args, **kw):
        seen.append(args[-1] if len(args) > 11 else kw.get("weight_grads", True))
        return real(*args, **kw)

    monkeypatch.setattr(fd, "fused_decode_bwd", spy)
    pl = t(p).requires_grad_(True)
    for q in dec.parameters():
        q.requires_grad_(False)
    try:
        out = dec(t(x), pl, t(a), t(sigma), backend="kernel")
        (gp,) = torch.autograd.grad(out.sum(), [pl])
    finally:
        for q in dec.parameters():
            q.requires_grad_(True)
    out = dec(t(x), pl, t(a), t(sigma), backend="kernel")
    torch.autograd.grad(out.sum(), [pl, dec.latent_stem.weight])
    assert seen == [False, True]
    assert float(gp.abs().max()) > 0


def test_double_backward_through_fused_decode_raises(pair):
    """A double backward through FusedDecode, which raised before second order was ported,
    now gives the eager decoder's second derivatives (one inner SGD step on the latents,
    then the outer gradient, as tests/test_pallas.py runs JAX's): K2 gives the inner
    gradient's values, the plain composition their derivatives. rtol 2e-3 / atol 1e-4,
    as tests/test_pallas.py holds JAX's kernels' second order."""
    _, _, dec, (x, p, a, sigma) = pair
    target = torch.from_numpy(np.random.default_rng(6).standard_normal((B, N, 1)).astype(np.float32))
    params = [q for q in dec.parameters()]
    grads = {}
    for backend in ("eager", "kernel"):
        lat = [t(v).requires_grad_(True) for v in (p, a)]
        inner = ((dec(t(x), *lat, t(sigma), backend=backend) - target) ** 2).mean()
        steps = torch.autograd.grad(inner, lat, create_graph=True)
        assert all(s.requires_grad for s in steps)
        moved = [v - 0.05 * s for v, s in zip(lat, steps)]
        outer = ((dec(t(x), *moved, t(sigma), backend=backend) - target) ** 2).mean()
        grads[backend] = torch.autograd.grad(outer, params + lat)
    for ge, gk in zip(grads["eager"], grads["kernel"]):
        assert_close(gk, ge, rtol=2e-3, atol=1e-4)
    # The latents' outer gradient differs from the first-order one: second order is live.
    lat = [t(v).requires_grad_(True) for v in (p, a)]
    first = torch.autograd.grad(((dec(t(x), *lat, t(sigma)) - target) ** 2).mean(), lat)
    assert float((grads["kernel"][-1] - first[1]).abs().max()) > 1e-4


def test_bwd_wrapper_runs_plain_on_cpu_without_counting(pair):
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    g = torch.ones(B, N, 1)
    before = fd.fused_decode_bwd.launches, dict(fd.fused_decode_bwd.launches_by_shape)
    got = fd.fused_decode_bwd(*args, g, H, D, weight_grads=False)
    want = fd.fused_decode_bwd_plain(*args, g, H, D, weight_grads=False)
    for gv, wv in zip(got[:6], want[:6]):
        assert torch.equal(gv, wv)
    assert all(w is None for w in (*got[6], *got[7]))
    assert (fd.fused_decode_bwd.launches, dict(fd.fused_decode_bwd.launches_by_shape)) == before
    assert got[0].shape == (B, Z, N, 4) and got[1].shape == (B, Z, N)


def test_bwd_launch_checks_inputs_and_needs_nvcc(pair, monkeypatch, tmp_path):
    """The K2 path validates its inputs and builds with nvcc or raises: no fallback."""
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        inv, wb, A, ab, G, c, ws, tws = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    g = torch.ones(B, N, 1)
    with pytest.raises(ValueError, match="g has shape"):
        fd._launch_bwd(inv, wb, A, ab, G, c, ws, tws, g[:, :-1], H, D, True)
    with pytest.raises(TypeError, match="float32"):
        fd._launch_bwd(inv, wb, A, ab, G, c, ws, tws, g.double(), H, D, True)
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fd._launch_bwd(inv, wb, A, ab, G, c, ws, tws, g, H, D, True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fd.fused_decode_bwd(inv.to("meta"), wb, A, ab, G, c, ws, tws, g, H, D)


def test_bwd_kernel_source_matches_the_binding():
    """What the ctypes binding passes is what the C launcher unpacks (no nvcc here)."""
    src = (cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE).read_text()
    n_ptrs = int(re.search(r"kNumPtrs = (\d+);", src).group(1))
    n_dims = int(re.search(r"kNumDims = (\d+);", src).group(1))
    # inputs, weights, tail weights, g, then dinv, dwb, reduced output, workspace, partials
    assert n_ptrs == 6 + len(fd.WEIGHT_NAMES) + len(fd.TAIL_WEIGHT_NAMES) + 1 + 5
    assert n_dims == 11
    for sym in ("fused_decode_bwd_launch", "fused_decode_bwd_sizes", "fused_decode_bwd_error_string"):
        assert re.search(rf"\b{sym}\(", src)
    # Two passes (per-block partials, then a reduction kernel), no atomics, no libraries.
    assert src.count("__global__") == 2 and "atomicAdd" not in src
    assert 'extern "C"' in src and "torch/extension.h" not in src and "cublas" not in src.lower()
    # The weight-gradient layout the wrapper splits: 8 attention weights + 12 tail ones.
    assert len(fd.WEIGHT_NAMES) - len(fd.COEFF_INDICES) == 8 and len(fd.TAIL_WEIGHT_NAMES) == 12


def test_bwd_kernel_products_run_on_the_tensor_cores_at_f32_accuracy():
    """K2's products go through the 3xTF32 mma.sync helper (tf32_mma.cuh, which it shares
    with K1): every product shape calls it, each operand is split into two tf32 parts,
    and no library GEMM is linked."""
    src = ((cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE).read_text()
           + (cuda_lib.CSRC_DIR / "tf32_mma.cuh").read_text())
    assert src.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") == 1
    assert src.count("cvt.rna.tf32.f32") == 1
    helper = re.search(r"void mma_3xtf32\(.*?\n}", src, re.S).group(0)
    assert helper.count("mma_tf32(") == 3  # small x big, big x small, big x big
    # Forward layers and input gradients (dense_tc), row contractions (tn_tc).
    for fn in ("dense_tc", "tn_tc"):
        body = re.search(rf"void {fn}\(.*?\n}}\n", src, re.S).group(0)
        assert "mma_3xtf32" in body or "dense_chunk" in body
    assert re.search(r"void dense_chunk\(.*?mma_3xtf32", src, re.S)
    for banned in ("wmma", "cutlass", "cublas", "fmaf(xs[i], ys[j]"):
        assert banned not in src.lower()


def test_bwd_flop_count_at_navier_stokes_width():
    fwd = fd.decode_flops_per_point(2, 128, 128, 128, 4, 4, 1)
    without = fd.decode_bwd_flops_per_point(2, 128, 128, 128, 4, 4, 1, weight_grads=False)
    with_w = fd.decode_bwd_flops_per_point(2, 128, 128, 128, 4, 4, 1, weight_grads=True)
    assert (without, with_w) == (3_095_040, 4_242_176)
    assert 2 * fwd < without < with_w < 3 * fwd + 1
