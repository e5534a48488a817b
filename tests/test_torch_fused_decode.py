"""The port's fused decode (fold + plain version of kernel K1) against the JAX package.

On the CPU the kernel's wrapper runs its plain PyTorch version; the CUDA kernel itself
is held against that plain version on the card by ``chip_smoke.py``. Here:

- the fold (A, ab, G, c and the folded weights) against JAX ``_fold_weights``;
- the plain version against JAX ``_reference_decode`` and against the JAX decoder
  with ``backend="pallas_interpret"`` (the TPU kernel run by the Pallas interpreter);
- the folded math against the port's own unfolded eager decoder;
- the wrapper's dispatch, its input checks, and the C interface it binds.

All in f32, rtol 1e-4 / atol 2e-5 (as ``tests/test_pallas.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.geometry.invariants import RelativePositionPeriodic as JaxPeriodic
from enf_pde_tpu.ops import pallas_decode as jpd

from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops import fused_decode as fd
from enf_pde_tpu_torch.ops.layers import reset_parameters
from tests.test_torch_modules import (
    B,
    D,
    H,
    N,
    Z,
    assert_close,
    decoder_pair,
    jax_decoder,
    port_decoder,
    t,
    torus_inputs,
)

torch.set_num_threads(1)


def jax_fused_inputs(jdec, params, x, p, a, sigma, with_tail=True):
    """The JAX decoder's folded kernel inputs, built as ``_call_pallas_full`` builds them."""
    bound = jdec.bind(params)
    block = bound.cross_attention_block
    a_norm = block.layer_norm_attn(bound.latent_stem(a))
    k, v = block.attn.a_to_k(a_norm), block.attn.a_to_v(a_norm)
    inv = JaxPeriodic(2)(x, p)
    wb = JaxPeriodic(2).gaussian_window(x, p, sigma=sigma)[..., 0]
    prm = params["params"]
    weights = jpd.extract_attention_weights(prm["cross_attention_block"]["attn"])
    folded, A, ab, G, c = jpd._fold_weights(weights, k, v, H, D)
    ws = tuple(jpd._as2d(folded[n]) for n in jpd._WEIGHT_NAMES)
    tws = ()
    if with_tail:
        tail = jpd.extract_tail_weights(prm["cross_attention_block"]["attn"]["out_proj"],
                                        prm["cross_attention_block"]["pointwise_ffn"],
                                        prm["out_proj"])
        ft = jpd._fold_tail_weights(tail)
        tws = tuple(jpd._as2d(ft[n]) for n in jpd._TAIL_WEIGHT_NAMES)
    spec = jpd._Spec(num_heads=H, head_dim=D, out_dim=1 if with_tail else H * D,
                     with_tail=with_tail, compute_dtype=jnp.float32, tile_c=N, tile_c_bwd=N,
                     interpret=True)
    inv_lm, wb_lm = jnp.swapaxes(inv, 1, 2), jnp.swapaxes(wb, 1, 2)[..., None]
    return spec, (inv_lm, wb_lm, A, ab, G, c, ws, tws)


@pytest.fixture(scope="module")
def pair():
    return decoder_pair(seed=11)


def test_fold_matches_jax(pair):
    jdec, params, dec, (x, p, a, sigma) = pair
    _, (jinv, jwb, jA, jab, jG, jc, jws, jtws) = jax_fused_inputs(jdec, params, x, p, a, sigma)
    with torch.no_grad():
        inv, wb, A, ab, G, c, ws, tws = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    assert inv.shape == (B, Z, N, 4) and wb.shape == (B, Z, N)
    assert A.shape == (B, Z, D, H) and G.shape == (B, Z, D, H * D)
    for got, want in [(inv, jinv), (wb, jwb[..., 0]), (A, jA), (ab, jab), (G, jG), (c, jc)]:
        assert_close(got, want)
    assert len(ws) == len(fd.WEIGHT_NAMES) and len(tws) == len(fd.TAIL_WEIGHT_NAMES)
    for got, want in zip((*ws, *tws), (*jws, *jtws)):
        assert_close(got, np.asarray(want).reshape(got.shape))


@pytest.mark.parametrize("with_tail", [True, False])
def test_plain_matches_jax_reference_decode(pair, with_tail):
    jdec, params, dec, (x, p, a, sigma) = pair
    spec, jargs = jax_fused_inputs(jdec, params, x, p, a, sigma, with_tail)
    want = jpd._reference_decode(spec, *jargs)
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
        if not with_tail:
            args = (*args[:7], ())
        got = fd.fused_decode_plain(*args, num_heads=H, head_dim=D)
    assert got.shape == ((B, N, 1) if with_tail else (B, N, H * D))
    assert_close(got, want)


def test_kernel_backend_matches_jax_pallas_interpret(pair):
    """The port's kernel backend (plain on CPU) against the TPU kernel in interpret mode."""
    jdec, params, dec, (x, p, a, sigma) = pair
    want = jax_decoder("pallas_interpret").apply(params, x, p, a, sigma)
    with torch.no_grad():
        got = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
    assert got.shape == (B, N, 1)
    assert_close(got, want)


def test_folded_equals_unfolded_eager():
    x, p, a, sigma = torus_inputs(12)
    dec = port_decoder(hidden=64)
    reset_parameters(dec, torch.Generator().manual_seed(3))
    with torch.no_grad():
        eager = dec(t(x), t(p), t(a), t(sigma), backend="eager")
        folded = dec(t(x), t(p), t(a), t(sigma), backend="kernel")
    assert float(eager.abs().max()) > 1e-2
    assert_close(folded, eager)


def test_no_tail_equals_eager_cross_attention(pair):
    """Without the tail the fused decode is the attention output before out_proj."""
    _, _, dec, (x, p, a, sigma) = pair
    attn = dec.cross_attention_block.attn
    a_in = torch.randn(B, Z, D, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        inv = attn.invariant(t(x), t(p)).transpose(1, 2).contiguous()
        wb = attn.invariant.gaussian_window(t(x), t(p), t(sigma))[..., 0].transpose(1, 2).contiguous()
        folded = fd.fold_decode_weights(attn.a_to_k(a_in), attn.a_to_v(a_in),
                                        fd.extract_attention_weights(attn), H, D)
        y = fd.fused_decode_fwd(inv, wb, *folded, num_heads=H, head_dim=D)
        want = attn(t(x), t(p), a_in, t(sigma))
    assert y.shape == (B, N, H * D)
    assert_close(attn.out_proj(y), want)


def test_wrapper_runs_plain_on_cpu_without_counting(pair):
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    before = fd.fused_decode_fwd.launches
    got = fd.fused_decode_fwd(*args, num_heads=H, head_dim=D)
    assert torch.equal(got, fd.fused_decode_plain(*args, num_heads=H, head_dim=D))
    assert fd.fused_decode_fwd.launches == before


def test_launch_checks_inputs_and_needs_nvcc(pair, monkeypatch, tmp_path):
    """The kernel path validates its inputs and builds with nvcc or raises: no fallback."""
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        inv, wb, A, ab, G, c, ws, tws = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    with pytest.raises(ValueError, match="wb has shape"):
        fd._launch(inv, wb[:, :, :-1], A, ab, G, c, ws, tws, H, D)
    with pytest.raises(TypeError, match="float32"):
        fd._launch(inv, wb, A.double(), ab, G, c, ws, tws, H, D)
    with pytest.raises(ValueError, match="contiguous"):
        fd._launch(inv, wb, A, ab, G.transpose(2, 3).contiguous().transpose(2, 3), c, ws, tws, H, D)
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fd._launch(inv, wb, A, ab, G, c, ws, tws, H, D)
    assert not (tmp_path / "build").exists()


def test_kernel_source_matches_the_binding():
    """What the ctypes binding passes is what the C launcher unpacks (no nvcc here)."""
    src = (cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE).read_text()
    n_ptrs = int(re.search(r"kNumPtrs = (\d+);", src).group(1))
    n_dims = int(re.search(r"kNumDims = (\d+);", src).group(1))
    assert n_ptrs == 6 + len(fd.WEIGHT_NAMES) + len(fd.TAIL_WEIGHT_NAMES) + 1
    assert n_dims == 10
    for sym in ("fused_decode_fwd_launch", "fused_decode_fwd_error_string"):
        assert re.search(rf"\b{sym}\(", src)
    assert 'extern "C"' in src and "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


def test_flop_count_at_navier_stokes_width():
    folded = fd.decode_flops_per_point(2, 128, 128, 128, 4, 4, 1)
    assert folded == 1_415_424  # 0.92 MFLOP over the four latents + 0.49 MFLOP tail
    assert folded < jpd.decode_flops_per_point(2, 128, 128, 4, 4, 1)  # the unfolded model count


def test_package_imports_no_jax():
    """The port and chip_smoke.py stay importable where jax/flax/optax/orbax/yaml are absent."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "for n in ('jax', 'flax', 'optax', 'orbax', 'yaml'):\n"
        "    sys.modules[n] = None\n"
        "import enf_pde_tpu_torch, enf_pde_tpu_torch.inference, enf_pde_tpu_torch.convert, chip_smoke\n"
        "assert not any(m == 'enf_pde_tpu' or m.startswith('enf_pde_tpu.') for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for path in list((root / "enf_pde_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax|yaml|enf_pde_tpu)\b(?!_torch)",
                             text, re.M), path
        assert "cpp_extension" not in text, path
