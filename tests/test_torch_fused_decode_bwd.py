"""The port's backward decode (plain version of kernel K2, ``FusedDecode``) on the CPU.

On the CPU the K2 wrapper runs its plain version (autograd over the plain forward);
the CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``. Here:

- the plain VJP against ``jax.vjp`` of JAX ``_reference_decode`` on identical inputs,
  with and without the tail (rtol 2e-4 / atol 2e-5, as ``tests/test_pallas.py``);
- the kernel backend's gradients through ``FusedDecode`` against the eager decoder's;
- what ``FusedDecode`` computes (only the gradients asked for), and its double
  backward against the eager decoder's;
- the wrapper's dispatch, its input checks and the C interface it binds;
- the kernel's layout (``k2_smem_bytes``, ``k2_scratch_bytes``, the mirrors of its
  source's ``shape`` and ``plan``) at every shipped config's K2 launch shapes.
"""

import re

import jax
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.geometry.invariants import get_ca_invariant as jax_get_ca_invariant
from enf_pde_tpu.ops import pallas_decode as jpd

from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops import fused_decode as fd
from tests.test_torch_fused_decode import ABLATION_RUNS, SHIPPED_CONFIGS, jax_fused_inputs, program_text
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
    before = fd.fused_decode_bwd.launches, dict(fd.fused_decode_bwd.launches_by_program)
    got = fd.fused_decode_bwd(*args, g, H, D, weight_grads=False)
    want = fd.fused_decode_bwd_plain(*args, g, H, D, weight_grads=False)
    for gv, wv in zip(got[:6], want[:6]):
        assert torch.equal(gv, wv)
    assert all(w is None for w in (*got[6], *got[7]))
    assert (fd.fused_decode_bwd.launches, dict(fd.fused_decode_bwd.launches_by_program)) == before
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
    src = program_text(fd.BWD_KERNEL_SOURCE)
    n_ptrs = int(re.search(r"kNumPtrs = (\d+);", src).group(1))
    n_dims = int(re.search(r"kNumDims = (\d+);", src).group(1))
    # inputs, weights, tail weights, g, then dinv, dwb, reduced output, workspace, partials
    assert n_ptrs == 6 + len(fd.WEIGHT_NAMES) + len(fd.TAIL_WEIGHT_NAMES) + 1 + 5
    assert n_dims == 11
    for sym in ("fused_decode_bwd_launch", "fused_decode_bwd_sizes", "fused_decode_bwd_error_string"):
        assert re.search(rf"\b{sym}\(", src)
    # Three passes (the shared weights pre-split, per-block partials, then a reduction kernel),
    # no atomics, no libraries.
    assert src.count("__global__") == 3 and "atomicAdd" not in src
    assert 'extern "C"' in src and "torch/extension.h" not in src and "cublas" not in src.lower()
    # The weight-gradient layout the wrapper splits: 8 attention weights + 12 tail ones.
    assert len(fd.WEIGHT_NAMES) - len(fd.COEFF_INDICES) == 8 and len(fd.TAIL_WEIGHT_NAMES) == 12


def test_bwd_kernel_products_run_on_the_tensor_cores_at_f32_accuracy():
    """K2's products run on 3xTF32 wgmma over 64-row tiles (m64nNk8 at each width class's N:
    8, 16, 32, 64), A split into tf32 halves in registers, B split and staged in shared memory
    (the shared weights pre-split once a launch and copied by cp.async); each k step's three
    wgmma go into a fresh accumulator (the first does not accumulate) that is added into an f32
    register sum; a persistent grid sized by occupancy; partials reduced in a fixed order with no
    float atomics; no mma.sync, WMMA, CUTLASS or cuBLAS."""
    src = program_text(fd.BWD_KERNEL_SOURCE)
    assert '#include "tf32_mma.cuh"' in src
    for n in (8, 16, 32, 64):
        assert src.count(f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32") == 1, n
    assert "wgmma.mma_async" not in src.replace("wgmma.mma_async.sync.aligned.m64n", "")
    assert "mma.sync" not in src and "mma_3xtf32" not in src and not re.search(r"\bmma_tf32\(", src)
    body = re.search(r"\n__device__ __forceinline__ void gemm\(.*?\n}\n", src, re.S).group(0)
    # Two k steps a chunk, each into its own accumulator (f0, f1): small x big first, not
    # accumulating (a fresh accumulator), then big x small and big x big; after the wait both
    # are added into the f32 sum. Part p (big, small) of k step q sits at st + 16 WN p + 8 WN q.
    call = re.compile(r"wgmma_tf32<WN>\((f[01]), (a[bs])\[([01])\], wg_desc\(st(?: \+ (\d+) \* WN)?\), ([01])\);")
    calls = call.findall(body)
    assert len(calls) == 6
    for f, q in (("f0", 0), ("f1", 1)):
        chain = [(a, int(k), int(off or 0), int(acc)) for ff, a, k, off, acc in calls if ff == f]
        assert chain == [("as", q, 8 * q, 0), ("ab", q, 16 + 8 * q, 1), ("ab", q, 8 * q, 1)], chain
        assert f"sum[i] += {f}[i];" in body
    assert body.count("wg_commit();") == 1 and body.count("wg_wait0();") == 1
    assert "tf32_round(" in body and "fence_async_smem();" in body
    # B of the next chunk split and stored while this chunk's wgmma run, the one after loaded;
    # a pre-split shared weight copied by 16-byte cp.async a chunk ahead of the products.
    assert body.index("wg_commit();") < body.index("store(nxt);") < body.index("wg_wait0();")
    assert body.index("copy(c + nst - 1, prv);") < body.index("wg_fence();")
    assert "cp.async.cg.shared.global" in src and "cp_async16(" in body
    for w in ("Q", "V", "F", "M", "O", "P1", "P2", "H1", "H2"):  # every shared weight, both ways
        assert f"wsplit(SPLIT_{w})" in src and f"wsplit(SPLIT_T + SPLIT_{w})" in src, w
    # Persistent blocks sized by occupancy; a fixed-order reduction, no float atomics.
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
    assert not re.search(r"\batomic\w*\s*\(", src)  # no atomicAdd, atomicCAS, ...: no float atomics
    for banned in ("wmma", "cutlass", "cublas"):
        assert banned not in src.lower()


def _parent_scratch_bytes(B, Z, C, I, hid, H, D, hidm, out, tail, weight_grads):
    """The workspace and partials of one launch of the PR 17 build of K2 (3xTF32 mma.sync on
    32-coordinate tiles, 1,320 blocks targeted, every activation of a block kept in device
    memory), as its ``make_dims`` laid them out: what the new layout is held against."""
    T, HD, HH = 32, H * D, H * hidm
    W = (max(HD, HH, hid, out) + 31) // 32 * 32 + 16
    ntiles = -(-C // T)
    bpr = min(max(-(-1320 // B), 1), ntiles)
    tpb = -(-ntiles // bpr)
    bpr = -(-ntiles // tpb)
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    work = (5 * r4(Z * T * hid) + r4(Z * tpb * T * hid) + r4(Z * tpb * T * HH) + 2 * r4(Z * T * HH)
            + r4(Z * T * HD) + r4(Z * T) + r4(Z * T * H) + 2 * r4(T * W) + 5 * r4(T * HD) + 4 * r4(T * hid) + r4(T))
    l_row = Z * (hid * H + H + hid * HH + HH)
    l_w = 0
    if weight_grads:
        l_w = 3 * (hid * hid + hid) + hidm * D + D
        if tail:
            l_w += 3 * (HD * HD + HD) + HD * hid + hid + hid * hid + hid + hid * out + out
    return 4 * B * bpr * (work + l_row + l_w)


def _k2_shapes(name):
    """(label, widths, frames, points) of each K2 launch a config makes: the ode and dual
    steps' rollout decode (batch x traj_len_train frames), the nef step's inner decodes on
    ``nef.backend: pallas`` (batch x fit_on_num_steps) and a fit's (batch); Navier-Stokes also
    at the 50-frame rollout's 400 x 512."""
    cfg_name, *overrides = name.split()
    cfg = jax_load_config(cfg_name, overrides)
    nef, ds = cfg.nef, cfg.dataset
    widths = dict(Z=nef.num_latents, I=jax_get_ca_invariant(nef).dim, hid=nef.num_hidden, H=nef.num_heads,
                  D=nef.num_hidden, hidm=nef.num_hidden, out=3 if cfg_name == "shallow_water" else 1)
    points = cfg.training.max_num_sampled_points
    shapes = [("ode step", ds.batch_size * ds.traj_len_train), ("nef step", ds.batch_size * cfg.training.nef.fit_on_num_steps),
              ("fit", ds.batch_size)]
    if cfg_name == "navier_stokes" and not overrides:
        shapes.append(("rollout T=50", ds.batch_size * 50))
    return widths, [(label, b, points) for label, b in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", SHIPPED_CONFIGS + ABLATION_RUNS)
def test_k2_layout_fits_every_shipped_decode_shape(name, dtype):
    """``k2_smem_bytes`` and ``k2_scratch_bytes`` (the mirrors of K2's ``shape`` and ``plan``, its
    constants read from the source) at each config's widths (I from its cross-attention invariant,
    hid = hidm = D = nef.num_hidden, H heads, its latents) and at each of its K2 launch shapes: the
    shared memory fits 227 KB, and the scratch of a launch (workspace + partials, at the most blocks
    an SM can hold, an upper bound of the grid's) is at most a quarter of the PR 17 build's, in all
    four modes. The bf16 program (``fused_decode_bwd_bf16.cu``) stages half the floats a chunk and
    keeps two more [TILE][H] rows; its shared memory is the f32 program's or less, but at the narrow widths
    (its narrow design) room for two of its per-latent blocks an SM."""
    w, shapes = _k2_shapes(name)
    smem = fd.k2_smem_bytes(w["Z"], w["I"], w["hid"], w["H"], w["D"], w["hidm"], dtype)
    assert 0 < smem <= fd.k2_constants(dtype)["SMEM_CAP"] == 232_448
    if dtype == torch.bfloat16 and fd.k2_narrow_design(w["hid"], w["hidm"], w["D"]):
        # The narrow design: two of its per-latent blocks an SM (233,472 B, 1,024 B kept back a block), its tail's
        # block within the cap.
        assert 2 * (smem + 1024) <= 233_472
        assert fd.k2_narrow_layout(w["hid"], w["H"], w["D"], w["hidm"])["smem_t"] <= 232_448
    elif dtype == torch.bfloat16:
        assert smem <= fd.k2_smem_bytes(w["Z"], w["I"], w["hid"], w["H"], w["D"], w["hidm"])
    for label, b, c in shapes:
        for tail in (True, False):
            for wg in (False, True):
                out = w["out"] if tail else w["H"] * w["D"]
                args = (b, w["Z"], c, w["I"], w["hid"], w["H"], w["D"], w["hidm"], out, tail, wg)
                new, old = fd.k2_scratch_bytes(*args, compute_dtype=dtype), _parent_scratch_bytes(*args)
                assert 0 < new <= old / 4, (label, tail, wg, new, old)


def test_k2_layout_mirror_refuses_what_the_kernel_refuses(pair, monkeypatch, tmp_path):
    """The mirror's numbers at Navier-Stokes width (one block an SM, 128 blocks at the ode step),
    the parent's scratch as its library reported it on the card (2,240.9 / 3,843.2 MB, PERF.md), and
    the shapes K2 refuses: too many latents for its shared memory, widths it does not take. An
    oversized Z raises ValueError on the host in ``_launch_bwd``, before any build or launch."""
    assert fd.k2_smem_bytes(4, 4, 128, 2, 128, 128) == 205_824 + 16_384  # a third ring buffer
    assert fd.k2_smem_bytes(25, 4, 128, 2, 128, 128) == 205_824 + 21 * 1024  # two ring buffers
    assert fd.k2_width_class(128, 128, 128) == 64 and fd.k2_width_class(16, 16, 16) == 8
    ns = (80, 4, 512, 4, 128, 2, 128, 128, 1, True)
    assert round(_parent_scratch_bytes(*ns, False) / 1e6, 1) == 2240.9
    assert round(_parent_scratch_bytes(*ns, True) / 1e6, 1) == 3843.2
    split = 2 * 2 * (5 * 128 * 128 + 3 * 256 * 256 + 256 * 128)  # both orientations, two tf32 parts
    assert fd.k2_scratch_bytes(*ns, False, per_sm=1) == 4 * (split + 128 * (64 * 256 * 3 + 64 * 256 + 2 * 133_128))
    for bad in ((31, 4, 128, 2, 128, 128), (4, 9, 128, 2, 128, 128), (4, 4, 136, 2, 128, 128),
                (4, 4, 8, 2, 8, 8), (4, 4, 128, 3, 128, 128), (0, 4, 128, 2, 128, 128)):
        with pytest.raises(ValueError):
            fd.k2_smem_bytes(*bad)
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        inv, wb, A, ab, G, c, ws, tws = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    big = 2000  # latents: [b, z, hid, H*hidm] G alone is 16 MB at this test's widths
    rep = lambda x: x[:, :1].expand(-1, big, *x.shape[2:]).contiguous()  # noqa: E731
    monkeypatch.setattr(cuda_lib, "build", lambda *a: pytest.fail("a refused shape reached the build"))
    with pytest.raises(ValueError, match="latents"):
        fd._launch_bwd(rep(inv), rep(wb), rep(A), rep(ab), rep(G), rep(c), ws, tws, torch.ones(B, N, 1), H, D, True)


def test_bwd_flop_count_at_navier_stokes_width():
    fwd = fd.decode_flops_per_point(2, 128, 128, 128, 4, 4, 1)
    without = fd.decode_bwd_flops_per_point(2, 128, 128, 128, 4, 4, 1, weight_grads=False)
    with_w = fd.decode_bwd_flops_per_point(2, 128, 128, 128, 4, 4, 1, weight_grads=True)
    assert (without, with_w) == (3_095_040, 4_242_176)
    assert 2 * fwd < without < with_w < 3 * fwd + 1


@pytest.mark.parametrize("name", SHIPPED_CONFIGS + ABLATION_RUNS)
def test_k2_bf16_ns_design_mirror_at_every_shipped_shape(name):
    """The bf16 program's W128 design (``k2_w128_design``, ``fused_decode_bwd_w128``) is what every decoder of
    Navier-Stokes width launches (hid = hidm = D = 128, two heads: NS, shallow water, the ablations),
    and no other config: its shared memory is ``W128_SMEM`` and 1,024 B a latent (the source header's
    table), and its scratch a launch at each of the config's K2 shapes is the shared weights in bf16,
    G's bf16 blocks both ways (128 KB a latent) and each block's workspace and partials (padded to 16
    bytes a block), as ``shape`` and ``plan`` lay them out for one block an SM on 132 SMs."""
    bf = torch.bfloat16
    w, shapes = _k2_shapes(name)
    w128 = fd.k2_w128_design(w["Z"], w["hid"], w["H"], w["D"], w["hidm"])
    assert w128 == (w["hid"] == 128 and w["H"] == 2)
    smem = fd.k2_smem_bytes(w["Z"], w["I"], w["hid"], w["H"], w["D"], w["hidm"], bf)
    if not w128:
        return
    assert fd.k2_constants(bf)["W128_SMEM"] == 207_872 and smem == 207_872 + 1024 * w["Z"]
    assert f"{smem:,} B" in (cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE_BF16).read_text()
    HD = 256
    for label, b, c in shapes:
        for tail in (True, False):
            for wg in (False, True):
                items = b * -(-c // 64)
                grid0 = min(items, 132, -(-items // 2))
                ipb = -(-items // grid0)
                grid = -(-items // ipb)
                slots = min(b, (ipb + -(-c // 64) - 2) // -(-c // 64) + 1)
                work = 64 * ((2 * HD + 128) if tail else (HD + 128)) + wg * 64 * HD + (tail and wg) * 2 * 64 * HD
                l_row = w["Z"] * (128 * 2 + 2 + 128 * HD + HD)
                l_w = (3 * (128 * 128 + 128) + 2 * 128 * 128 + 128 if wg else 0) + (
                    (3 * (HD * HD + HD) + HD * 128 + 128 + 128 * 128 + 128 + 128 * w["out"] + w["out"]) if tail and wg else 0)
                split = 3 * 128 * 128 + 128 * 128 + ((3 * HD * HD + HD * 128 + 128 * 128) if tail else 0)
                out = w["out"] if tail else HD
                part = -(-(slots * l_row + l_w) // 4) * 4  # each block's partials on 16 bytes
                want = 4 * (split + b * w["Z"] * 128 * HD + grid * (work + part))
                got = fd.k2_scratch_bytes(b, w["Z"], c, w["I"], 128, 2, 128, 128, out, tail, wg, per_sm=1, compute_dtype=bf)
                assert got == want, (label, tail, wg)


def test_k2_bf16_ns_design_refusals():
    """Where the W128 design does not take a shape of the class 64 the class design does (25 latents at
    NS width; one head; hid 192), with its own layout, and past both the shape is refused on the host
    with a ValueError, as the kernel's ``shape`` refuses it."""
    bf = torch.bfloat16
    assert fd.k2_w128_design(24, 128, 2, 128, 128) and fd.k2_smem_bytes(24, 4, 128, 2, 128, 128, bf) == 207_872 + 24 * 1024
    for z, hid, h in ((25, 128, 2), (4, 128, 1), (4, 192, 1)):
        assert not fd.k2_w128_design(z, hid, h, hid, hid)
        assert fd.k2_smem_bytes(z, 4, hid, h, hid, hid, bf) == {25: 232_448, 128: 175_616, 192: 228_864}[z if z == 25 else hid]
    for bad in ((40, 4, 128, 2, 128, 128), (4, 9, 128, 2, 128, 128), (4, 4, 128, 3, 128, 128), (4, 4, 272, 1, 128, 128)):
        with pytest.raises(ValueError):
            fd.k2_smem_bytes(*bad, bf)


NARROW_CONFIGS = ("diffusion_plane", "cahn_hilliard", "ihc", "diff_sphere")


@pytest.mark.parametrize("name", SHIPPED_CONFIGS + ABLATION_RUNS)
def test_k2_bf16_narrow_design_mirror_at_every_shipped_shape(name):
    """The bf16 program's narrow design (``k2_narrow_design``: ``narrow_logits`` ... ``narrow_query_vjp``) is what
    every bf16 K2 launch below the width class 64 takes, and no other: the four narrow configs. Its shared
    memory, the per-latent kernels' and the tail's, is the source header's table; its plan and scratch at each
    of the config's K2 shapes (ode step, nef step, fit; tail or not; weight gradients or not) are ``narrow_plan``'s
    for the most per-latent blocks an SM their shared memory and threads allow on 132 SMs (blocks of two warpgroups
    from hid 32, of one below): persistent blocks, a contiguous run of (b, z, tile) items each, the (b, z) rows a run
    touches counted exactly; the tail's (b, tile) items on the blocks an SM its shared memory allows, at least two a
    block with weight gradients; the workspace and the partials piece by piece."""
    bf = torch.bfloat16
    w, shapes = _k2_shapes(name)
    W, H, Z, I = w["hid"], w["H"], w["Z"], w["I"]
    narrow = fd.k2_narrow_design(W, w["hidm"], w["D"])
    assert narrow == (name.split()[0] in NARROW_CONFIGS and W < 128)
    if not narrow:
        return
    lay = fd.k2_narrow_layout(W, H, W, W)
    table = {(64, 2): (115_200, 219_648), (32, 3): (67_840, 162_048), (16, 2): (27_648, 54_272)}
    assert (lay["smem"], lay["smem_t"]) == table[(W, H)] and fd.k2_smem_bytes(Z, I, W, H, W, W, bf) == lay["smem"]
    text = (cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE_BF16).read_text()
    assert f"{lay['smem']:,} B" in text and f"{lay['smem_t']:,} B" in text
    HD, r4 = H * W, lambda n: -(-n // 4) * 4  # noqa: E731
    most = 2048 // (256 if W >= 32 else 128)  # threads an SM over a block's: two warpgroups from hid 32, one below
    per_sm, per_sm_t = min(most, 233_472 // (lay["smem"] + 1024)), min(most, 233_472 // (lay["smem_t"] + 1024))
    for label, b, c in shapes:
        nt = -(-c // 64)
        for tail in (True, False):
            for wg in (False, True):
                out = w["out"] if tail else HD
                items, items_t = b * Z * nt, b * nt
                ipb = -(-items // min(items, per_sm * 132))
                grid = -(-items // ipb)
                ipb_t = -(-items_t // min(items_t, per_sm_t * 132, -(-items_t // 2) if wg else items_t))
                grid_t = -(-items_t // ipb_t)
                slots = min(b * Z, ipb // nt if ipb % nt == 0 else 1 if nt % ipb == 0 else (ipb + nt - 2) // nt + 1)
                row = r4(W * H) + r4(H) + W * HD + r4(HD)
                lat_w = 3 * (W * W + r4(W)) if wg else 0
                mix_w = (H * W * W + r4(W)) if wg else 0
                tail_w = (3 * (HD * HD + r4(HD)) + HD * W + 2 * r4(W) + W * W + r4(W * out) + r4(out)) if wg and tail else 0
                images = 4 * W * W // 2 + ((3 * HD * HD + HD * W + W * W) // 2 if tail else 0)
                per_latent = 2 * b * Z * nt * 64 * H + b * Z * nt * 64 * HD // 2
                per_row = b * nt * 64 * (HD + H)
                tail_ws = (64 * (2 * HD + W) if tail else 0) + (2 * 64 * -(-HD // 64) * 64 if tail and wg else 0) \
                    + (3 * 64 * HD // 2 if wg else 0)
                want = 4 * (images + b * Z * W * HD // 2 + per_latent + per_row + grid_t * tail_ws
                            + grid * (slots * row + lat_w) + grid_t * (mix_w + tail_w))
                plan = fd.k2_narrow_plan(b, Z, c, I, W, H, W, W, out, tail, wg)
                assert (plan["grid"], plan["ipb"], plan["slots"], plan["grid_t"]) == (grid, ipb, slots, grid_t), label
                assert plan["scratch"] == want == fd.k2_scratch_bytes(b, Z, c, I, W, H, W, W, out, tail, wg,
                                                                      compute_dtype=bf), (label, tail, wg)


@pytest.mark.parametrize("widths", [(32, 64, 32, 2), (48, 48, 48, 2), (16, 16, 16, 9), (64, 64, 64, 3), (64, 64, 128, 1)])
def test_k2_bf16_narrow_design_refusals(widths, monkeypatch):
    """Below the width class 64 the bf16 program has the narrow design alone (the class design is built at the
    class 64 only): it takes hid = hidm = D = 16, 32 or 64 with at most ``NH_MAX`` = 8 heads and H D <=
    ``NHD_MAX`` = 128, and the rest of those classes is refused on the host, before any build, with a
    ValueError (the f32 program still takes them)."""
    hid, hidm, D, H = widths
    bf = torch.bfloat16
    k = fd.k2_constants(bf)
    assert (k["NH_MAX"], k["NHD_MAX"], k["NWIDE"]) == (8, 128, 32)
    assert fd.k2_narrow_design(hid, hidm, D) and not fd.k2_w128_design(4, hid, H, D, hidm)
    with pytest.raises(ValueError, match="narrow design"):
        fd.k2_smem_bytes(4, 2, hid, H, D, hidm, bf)
    assert fd.k2_smem_bytes(4, 2, hid, H, D, hidm) > 0
    monkeypatch.setattr(cuda_lib, "build", lambda *a: pytest.fail("a refused shape reached the build"))
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    ws = [r(2, hid // 2), r(hid, hid), r(hid), r(2, hid // 2), r(hid, hid), r(hid), r(hid, hid), r(hid), r(hidm, D), r(D)]
    args = (r(1, 4, 64, 2), r(1, 4, 64), r(1, 4, hid, H), r(1, 4, H), r(1, 4, hid, H * hidm), r(1, 4, H * hidm))
    with pytest.raises(ValueError, match="narrow design"):
        fd._launch_bwd(*args, ws, (), r(1, 64, H * D), H, D, True, compute_dtype=bf)
