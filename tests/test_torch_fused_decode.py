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
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.config import load_experiment_config as jax_load_config
from enf_pde_tpu.geometry.invariants import RelativePositionPeriodic as JaxPeriodic
from enf_pde_tpu.geometry.invariants import get_ca_invariant as jax_get_ca_invariant
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


def program_text(source: str) -> str:
    """A kernel program's text: its source and the fused-decode headers it includes (the parts
    that a kernel's two programs share), not the product helpers (tf32_mma.cuh, bf16_mma.cuh)."""
    return "\n".join(p.read_text() for p in cuda_lib.included_files(cuda_lib.CSRC_DIR / source)
                     if p.name.startswith("fused_decode"))


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
    before = fd.fused_decode_fwd.launches, dict(fd.fused_decode_fwd.launches_by_program)
    got = fd.fused_decode_fwd(*args, num_heads=H, head_dim=D)
    assert torch.equal(got, fd.fused_decode_plain(*args, num_heads=H, head_dim=D))
    assert (fd.fused_decode_fwd.launches, dict(fd.fused_decode_fwd.launches_by_program)) == before


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


def test_launch_refuses_weights_cp_async_cannot_stage(pair):
    """K1 stages G, the split blocks and the tail's wide weights by 16-byte cp.async. The
    wrapper refuses one that does not start on 16 bytes (a contiguous view at a storage
    offset of one float) or a split of the wrong shape before anything is built; the C
    launcher refuses the same pointers with an error code."""
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        inv, wb, A, ab, G, c, ws, tws = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))

    def shifted(w):
        return torch.empty(w.numel() + 1)[1:].view(w.shape).copy_(w)

    assert shifted(G).is_contiguous() and shifted(G).data_ptr() % 16
    with pytest.raises(ValueError, match="G must start on 16 bytes"):
        fd._launch(inv, wb, A, ab, shifted(G), c, ws, tws, H, D)
    for name in ("o_w", "p_w1", "p_w2", "h_w1", "h_w2"):
        i = fd.TAIL_WEIGHT_NAMES.index(name)
        bad = (*tws[:i], shifted(tws[i]), *tws[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on 16 bytes"):
            fd._launch(inv, wb, A, ab, G, c, ws, bad, H, D)
    _, split = fd.split_weights(ws)
    for i, name in enumerate(fd.SPLIT_WEIGHT_NAMES):
        bad = (*split[:i], shifted(split[i]), *split[i + 1:])
        with pytest.raises(ValueError, match=f"split {name} must start on 16 bytes"):
            fd._launch(inv, wb, A, ab, G, c, ws, tws, H, D, split=bad)
    with pytest.raises(ValueError, match="split m_w2 has shape"):
        fd._launch(inv, wb, A, ab, G, c, ws, tws, H, D, split=(*split[:3], split[3].reshape(-1)))
    src = program_text(fd.KERNEL_SOURCE)
    staged = re.search(r"const float\* staged\[\] = \{([^}]*)\};", src).group(1)
    names = [n.strip().removeprefix("P.") for n in staged.split(",")]
    assert names == ["G", *(f"{n}s" for n in fd.SPLIT_WEIGHT_NAMES), "o_w", "p_w1", "p_w2", "h_w1", "h_w2"]
    assert "i < (with_tail ? 10 : 5)" in src and "if (!aligned16(staged[i])) return (int)cudaErrorInvalidValue;" in src
    header = (cuda_lib.CSRC_DIR / "tf32_mma.cuh").read_text()
    assert "__host__ __device__ __forceinline__ bool aligned16(" in header  # the launcher is host code


def test_kernel_source_matches_the_binding():
    """What the ctypes binding passes is what the C launcher unpacks (no nvcc here)."""
    src = program_text(fd.KERNEL_SOURCE)
    n_ptrs = int(re.search(r"kNumPtrs = (\d+);", src).group(1))
    n_dims = int(re.search(r"kNumDims = (\d+);", src).group(1))
    # inputs, folded weights, tail weights, out, then the pre-split shared weights
    assert n_ptrs == 6 + len(fd.WEIGHT_NAMES) + len(fd.TAIL_WEIGHT_NAMES) + 1 + len(fd.SPLIT_WEIGHT_NAMES)
    assert n_dims == 10
    for sym in ("fused_decode_fwd_launch", "fused_decode_fwd_error_string"):
        assert re.search(rf"\b{sym}\(", src)
    assert 'extern "C"' in src and "torch/extension.h" not in src
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


def test_kernel_products_run_on_the_tensor_cores_at_f32_accuracy():
    """K1's wide products run on the tensor cores in 3xTF32: the products over a latent
    group's rows (q_w1, v_w1, fw over the rows of every latent of a group, m_w2 over heads and
    a latent pair) on wgmma at each width class's own width (m64n16k8, m64n32k8, and m64n64k8,
    twice a slab at 128), the 32-row ones (G, the tail) on the shared mma.sync helper; the
    class 128 stages every weight by cp.async in a ring of at least two stages, the narrow
    classes keep the shared weights resident (or in a ring of narrow blocks) and load G and
    the tail's B fragments into registers a k step ahead; no library GEMM."""
    src = program_text(fd.KERNEL_SOURCE)
    header = (cuda_lib.CSRC_DIR / "tf32_mma.cuh").read_text()
    assert '#include "tf32_mma.cuh"' in src
    assert "mma.sync.aligned" not in src and "cvt.rna" not in src  # only through the shared helper
    assert header.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") == 1
    tiles = re.search(r"void mma_3xtf32_tiles\(.*?\n}", header, re.S).group(0)
    assert tiles.count("mma_tf32(") == 3  # small x big, big x small, big x big, across the tiles
    for n in (16, 32, 64):
        assert src.count(f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32") == 1, n
    assert "wgmma.mma_async" not in src.replace("wgmma.mma_async.sync.aligned.m64n", "")
    body_of = lambda name: re.search(rf"\n(?:template <[^\n]*>\n)?__(?:device|global)__[^\n]* {name}\(.*?\n}}\n", src, re.S).group(0)
    wg = body_of("gemm_wg")
    # Three wgmma per k step (small x big, big x small, big x big) at the class's width NB (two
    # n64 halves at 128), a slab's whole sum in the accumulator: one commit and wait a chunk.
    assert wg.count("wgmma_tf32<NB>(") == 3 and "split_tf32_int(" in wg and "fence_async_smem()" in wg
    assert "constexpr int NB = WN < 64 ? WN : 64;" in wg and "constexpr int NACC = WN / 2;" in wg
    assert wg.count("wg_commit();") == 1 and wg.count("wg_wait0();") == 1
    d32 = body_of("dense32")
    assert "mma_3xtf32_tiles(" in d32 and "split_tf32_int(" in d32
    for gemm in (wg, d32):  # the ring: 16-byte cp.async, waited for two chunks late
        assert "cp_async16(" in gemm and "cp_async_wait<STAGES - 2>()" in gemm
    assert "if constexpr (!RES)" in wg  # resident weights: no ring and no barrier past the first
    direct = body_of("dense32_direct")
    assert "mma_3xtf32_tiles(p," in direct and "acc[mi][j][e] += p[mi][j][e];" in direct
    assert "if (ks & 1) {" in direct  # a fresh accumulator per two k steps, as dense32's
    # B fragments into registers a k step ahead, the first before the barrier; not inlined.
    assert "load(nxt, n0, ks + 1)" in direct and "cp_async" not in direct and "__noinline__" in direct
    assert direct.index("load(cur, n0, 0)") < direct.index("if (sync) __syncthreads();")
    assert "cp.async.cg.shared.global" in src
    assert int(re.search(r"constexpr int STAGES = (\d+);", src).group(1)) >= 2
    # mma.sync: a fresh accumulator per staged chunk (two k steps), added into f32 registers.
    assert "acc[mi][j][e] += p[mi][j][e];" in d32 and "mma_3xtf32_tiles(p," in d32
    assert "#define K1_" not in src and "#ifndef" not in src  # no build-time variants
    body = body_of("fused_decode_fwd_kernel")
    for w in ("Wq", "Wv", "Wf"):
        assert re.search(rf"dense_group<WN, MT, RES, ACT_\w+>\([^;]*nz \* TILE, hid, {w},", body), w
    for w in ("q_w1s", "v_w1s", "fws", "m_w2s"):  # resident (narrow) or streamed from global
        assert re.search(rf"RES \? ring[^;]*: P\.{w};", body), w
    assert int(re.search(r"constexpr int ZG = (\d+);", src).group(1)) * 32 == 128
    assert "gemm_wg<WN, MT, RES>(" in body_of("mixer") and re.search(r"mixer<WN, MT, RES>\([^;]*Wm,", body)
    assert re.search(r"dense32<ACT_\w+>\([^;]*P\.G \+ bz", body) and re.search(r"dense32_direct<ACT_\w+>\([^;]*P\.G \+ bz", body)
    for w in ("o_w", "p_w1", "p_w2", "h_w1", "h_w2"):
        assert re.search(rf"dense32<ACT_\w+>\([^;]*P\.{w},", body), w
        assert re.search(rf"dense32_direct<ACT_\w+>\([^;]*P\.{w},", body), w
    # No f32 FMA loop over a weight tile is left for the wide products.
    assert "fmaf(x, w[j]" not in src and "Ws[(kk + q) * SLAB" not in src
    for banned in ("wmma", "cutlass", "cublas", "torch/extension.h"):
        assert banned not in src.lower() and banned not in header.lower()


# (hid, hidm, D) -> width class: the narrow classes pad N up to their width, the class 128 to
# slabs of WG_N (D = 136: two slabs); N of the shared weights is hid (48, 40: padded) and D.
SPLIT_CASES = {16: (16, 16, 8), 32: (32, 16, 32), 64: (48, 64, 40), 128: (32, 16, 136)}


@pytest.mark.parametrize("wn", sorted(SPLIT_CASES))
def test_split_weights_reconstruct_and_match_the_launcher(wn):
    """The pre-split copies of the shared weights of the products over a latent group's rows,
    for each width class: big and small are tf32 (13 low bits clear), big is W rounded to
    nearest with ties away from zero, big + small is within 2^-21 |W| of W, the blocks are the
    K-major layout the kernel's wgmma descriptors read at the class's slab width, and the views
    go to the launcher in the order it unpacks them."""
    hid, hidm, D = SPLIT_CASES[wn]
    assert fd.k1_width_class(hid, hidm, D) == wn
    gen = torch.Generator().manual_seed(3)
    shapes = ((4, hid // 2), (hid, hid), (hid,), (4, hid // 2), (hid, hid), (hid,), (hid, hid), (hid,),
              (hidm, D), (D,))
    ws = [torch.randn(*shape, generator=gen) * 10.0 ** torch.randint(-3, 3, shape, generator=gen)
          for shape in shapes]
    buf, views = fd.split_weights(ws)
    assert buf.is_contiguous() and buf.dtype == torch.float32
    off = 0
    for name, view in zip(fd.SPLIT_WEIGHT_NAMES, views):
        w = ws[fd.WEIGHT_NAMES.index(name)]
        K, N = w.shape
        slabs = -(-N // wn)
        assert view.shape == (K // 16, slabs, 2, 2, wn // 8, 2, 8, 4)
        assert slabs == 1 or wn == fd.WG_N  # a narrow class's weight is one slab: resident whole
        assert view.data_ptr() == buf.data_ptr() + off * 4
        off += view.numel()
        # Element W[16 kc + 8 q + 4 kg + i, wn s + 8 ng + r] sits at [kc, s, part, q, ng, kg, r, i].
        parts = view.permute(2, 0, 3, 5, 7, 1, 4, 6).reshape(2, K, slabs * wn)
        big, small = parts[0, :, :N], parts[1, :, :N]
        assert not parts[:, :, N:].any()  # columns past N are zero
        for part in (big, small):
            assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()
        assert ((big + small) - w).abs().le(2.0 ** -21 * w.abs()).all()
        assert (w - big).abs().le(2.0 ** -11 * w.abs()).all()
        kc, s, q, ng, kg, r, i = K // 16 - 1, slabs - 1, 1, wn // 8 - 1, 1, 5, 2
        k, n = 16 * kc + 8 * q + 4 * kg + i, wn * s + 8 * ng + r
        if n < N:
            assert view[kc, s, 0, q, ng, kg, r, i] == big[k, n]
        # One block per chunk and slab: 32 wn floats, the kernel's BLOCK.
        assert view[0, 0].numel() == 32 * wn
    assert off == buf.numel()
    one = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23, 3.0])
    assert fd._tf32(one).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0]
    src = program_text(fd.KERNEL_SOURCE)
    first = 6 + len(fd.WEIGHT_NAMES) + len(fd.TAIL_WEIGHT_NAMES) + 1
    for i, name in enumerate(fd.SPLIT_WEIGHT_NAMES):
        assert re.search(rf"P\.{name}s = f\[{first + i}\];", src), name
    # The descriptors: a block of wn columns; 8 rows x 4 k (16 bytes) per core matrix, the two
    # k groups of a k step 128 bytes apart, groups of 8 columns 256 bytes apart, at every class.
    assert int(re.search(r"constexpr int WG_N = (\d+);", src).group(1)) == fd.WG_N
    assert "static constexpr int BLOCK = 2 * 2 * 8 * WN;" in src
    lbo, sbo = map(int, re.search(r"constexpr int WG_LBO = (\d+), WG_SBO = (\d+);", src).groups())
    assert (lbo, sbo) == (8 * 4 * 4, 2 * 8 * 4 * 4)
    # The classes the mirror names are the source's.
    assert "return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : WG_N;" in src
    assert fd.NARROW_CLASSES == (16, 32, 64)


def test_build_key_covers_included_headers(tmp_path):
    """A library is named by its source, every header it includes (recursively) and the
    flags, so an edited header never loads a stale build."""
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\nint x;\n')
    assert [p.name for p in cuda_lib.included_files(src)] == ["k.cu", "outer.cuh", "inner.cuh"]
    # One translation unit, each header once in its include's place (what the layout mirrors read).
    text = cuda_lib.expanded_source(src)
    assert text.count("// inner") == 1 and '#include "' not in text and "pragma once" not in text
    assert text.index("// inner") < text.index("int x;")
    keys = {cuda_lib.build_key(src)}
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    keys.add(cuda_lib.build_key(src))
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    keys.add(cuda_lib.build_key(src))
    assert len(keys) == 3
    for source, shared in ((fd.KERNEL_SOURCE, "fused_decode_fwd"), (fd.BWD_KERNEL_SOURCE, "fused_decode_bwd")):
        names = [p.name for p in cuda_lib.included_files(cuda_lib.CSRC_DIR / source)]
        assert names == [source, f"{shared}_common.cuh", "tf32_mma.cuh", f"{shared}_host.cuh"]


def test_flop_count_at_navier_stokes_width():
    folded = fd.decode_flops_per_point(2, 128, 128, 128, 4, 4, 1)
    assert folded == 1_415_424  # 0.92 MFLOP over the four latents + 0.49 MFLOP tail
    assert folded < jpd.decode_flops_per_point(2, 128, 128, 4, 4, 1)  # the unfolded model count


SHIPPED_CONFIGS = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "enf_pde_tpu" / "experiments"
                                           / "configs").glob("*.yaml"))


# The paper's ablations run on the navier_stokes config with another invariant, and
# ball_lat (I = 6) on the ihc config.
ABLATION_RUNS = [f"navier_stokes nef.invariant_type={name}" for name in ("abs_pos", "rel_pos", "norm_rel_pos")]
ABLATION_RUNS.append("ihc nef.invariant_type=ball_lat")


# The width class each config's decode takes: Navier-Stokes and shallow water keep the class
# 128 design, the planar configs take 64, ihc 32, diff_sphere 16.
CONFIG_CLASSES = {"navier_stokes": 128, "navier_stokes_nonmaml": 128, "shallow_water": 128,
                  "diffusion_plane": 64, "cahn_hilliard": 64, "ihc": 32, "diff_sphere": 16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", SHIPPED_CONFIGS + ABLATION_RUNS)
def test_k1_layout_accepts_every_shipped_decode_shape(name, dtype):
    """``k1_smem_bytes`` (the mirror of K1's ``layout``, its constants read from the source)
    accepts each config's decode widths: I from the config's cross-attention invariant,
    hid = hidm = D = nef.num_hidden, H heads, its latents; the size does not grow with Z.
    The ablation runs add I = 2 and I = 1 at Navier-Stokes width. Each config takes its
    width class (``k1_width_class``); a narrow class leaves room for its blocks an SM (the f32
    program's ``MINB<wn>``, the bf16 program's ``BLOCKS<wn>``). The bf16 program
    (``fused_decode_fwd_bf16.cu``) holds every latent's logits, 4 TILE128 H bytes a latent (its work
    items have 64 rows at every class), and its shared weights in bf16: at the class 128 less than the
    f32 program's at each config's Z. Where the logits do not fit beside the rest they go to a global workspace
    (``k1_logits_floats``: a slot for each block of its persistent grid, ``k1_plan``), so the bf16
    layout takes every Z that the f32 one takes."""
    name, *overrides = name.split()
    nef = jax_load_config(name, overrides).nef
    I, hid, H = jax_get_ca_invariant(nef).dim, nef.num_hidden, nef.num_heads
    assert set(CONFIG_CLASSES) == set(SHIPPED_CONFIGS)
    wn = fd.k1_width_class(hid, hid, hid)
    assert wn == CONFIG_CLASSES[name]
    smem = fd.k1_smem_bytes(nef.num_latents, I, hid, H, hid, hid, dtype)
    assert 0 < smem <= fd.k1_constants(dtype)["SMEM_CAP"] == 232_448
    if dtype == torch.float32:
        assert {fd.k1_smem_bytes(z, I, hid, H, hid, hid) for z in (1, 4, 5, 8, 9, 16, 25, 64, 1000)} == {smem}
    else:
        k = fd.k1_constants(dtype)
        rows = k["TILE128"]  # a latent's logits: 64 rows at every class
        assert fd.k1_smem_bytes(nef.num_latents + 1, I, hid, H, hid, hid, dtype) - smem == 4 * rows * H
        if wn == fd.WG_N:  # the narrow classes' 64-row items take more than the f32 program's 32-row tiles
            assert smem < fd.k1_smem_bytes(nef.num_latents, I, hid, H, hid, hid)
        assert fd.k1_logits_floats(2, nef.num_latents, 100, I, hid, H, hid, hid, dtype) == 0
        for z in (1, 4, 5, 8, 9, 16, 25, 64, 1000):
            assert 0 < fd.k1_smem_bytes(z, I, hid, H, hid, hid, dtype) <= smem + 4 * rows * H * max(0, z - nef.num_latents)
        # 2 x 100 coordinates: 8 items of 32 (32 where items of 64 would leave half of the grid idle), a
        # block and a slot each.
        assert fd.k1_plan(2, 1000, 100, I, hid, H, hid, hid, dtype) == (32, 8, 8)
        assert fd.k1_logits_floats(2, 1000, 100, I, hid, H, hid, hid, dtype) == 8 * 1000 * rows * H
    if wn < fd.WG_N:  # an SM has 233,472 B, 1,024 B of it kept back per block
        blocks = fd.k1_constants(dtype)[f"MINB{wn}" if dtype == torch.float32 else f"BLOCKS{wn}"]
        assert blocks * (smem + 1024) <= 233_472


def test_k1_layout_mirror_refuses_what_layout_refuses():
    assert fd.k1_smem_bytes(8, 4, 128, 2, 128, 128) == 231_168  # shallow_water: z = 8 at NS width
    assert "231,168 B" in (cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE).read_text()  # the header's table
    # The bf16 program's class 128 (its header's table): NS (z = 4) and shallow water (z = 8); it takes
    # hidm and D up to 256, as the f32 program does (past 128 in its wide instantiation, whose layout is
    # the same: the operand buffers hold 256 columns), and refuses them past 256.
    bf = torch.bfloat16
    assert (fd.k1_smem_bytes(4, 4, 128, 2, 128, 128, bf), fd.k1_smem_bytes(8, 4, 128, 2, 128, 128, bf)) == (202_752, 204_800)
    assert all(f"{n:,} B" in (cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE_BF16).read_text() for n in (202_752, 204_800))
    for wide in ((4, 4, 128, 1, 256, 128), (4, 4, 128, 1, 128, 160), (4, 4, 64, 1, 144, 64), (4, 4, 128, 1, 256, 256)):
        fd.k1_smem_bytes(*wide)  # the f32 program takes them
        assert fd.k1_smem_bytes(*wide, bf) == 200_704 + 4 * 4 * 64 * 1  # SMEM128 and four latents' logits of one head
    for bad in ((4, 4, 128, 1, 272, 128), (4, 4, 128, 1, 128, 272), (4, 4, 128, 2, 144, 128)):
        for dtype in (torch.float32, bf):
            with pytest.raises(ValueError):
                fd.k1_smem_bytes(*bad, dtype)
    G = torch.randn(2, 3, 128, 256)
    assert fd.bf16_g_blocks(G, 1).shape == (2, 3, 1, 8, 2, 16, 2, 8, 8)  # a head of 256: two slabs a chunk
    assert fd.bf16_g_blocks(G, 2).shape == (2, 3, 2, 8, 16, 2, 8, 8)
    blk = fd.bf16_g_blocks(G, 1)
    assert torch.equal(blk[1, 2, 0, 3, 1, 5, 1, 6, 7].float(), G[1, 2, 16 * 3 + 8 + 7, 128 + 8 * 5 + 6].bfloat16().float())
    # Its launch plan: 64 coordinates an item and one persistent block an SM (132 on an H100), 32 where
    # items of 64 would leave half of the blocks idle (the fit's 8 x 512), never below one wave.
    assert fd.k1_plan(160, 4, 512, 4, 128, 2, 128, 128, bf) == (64, 1280, 132)
    assert fd.k1_plan(16, 4, 512, 4, 128, 2, 128, 128, bf) == (64, 128, 128)
    assert fd.k1_plan(8, 4, 512, 4, 128, 2, 128, 128, bf) == (32, 128, 128)
    assert fd.k1_plan(8, 4, 512, 4, 128, 2, 128, 128) == (32, 128, 128)  # the f32 program: one block a tile
    # The narrow classes' table (diff_sphere, ihc, the planar configs): each class's own group size.
    assert (fd.k1_smem_bytes(18, 1, 16, 2, 16, 16), fd.k1_smem_bytes(25, 5, 32, 3, 32, 32),
            fd.k1_smem_bytes(4, 2, 64, 2, 64, 64)) == (57_600, 93_824, 114_944)
    for bad in ((4, 4, 136, 2, 128, 128), (4, 4, 120, 2, 128, 128), (4, 4, 128, 3, 128, 128),
                (4, 4, 128, 1, 128, 272), (0, 4, 128, 2, 128, 128), (4, 21, 16, 2, 16, 16)):
        with pytest.raises(ValueError):
            fd.k1_smem_bytes(*bad)


def test_package_imports_no_jax():
    """The port and chip_smoke.py stay importable where jax/flax/optax/orbax/yaml are absent, and a
    trained JAX run's export loads and serves there (``Forecaster.from_jax_export`` on the CPU)."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "for n in ('jax', 'flax', 'optax', 'orbax', 'yaml', 'tensorstore', 'zstandard'):\n"
        "    sys.modules[n] = None\n"
        "import enf_pde_tpu_torch, enf_pde_tpu_torch.inference, enf_pde_tpu_torch.convert, chip_smoke\n"
        "cfg, params, record = enf_pde_tpu_torch.convert.load_jax_export('weights/ns8192_s0')\n"
        "fc = enf_pde_tpu_torch.inference.Forecaster.from_jax_export('weights/ns8192_s0', device='cpu')\n"
        "assert fc.record['epoch'] == 30 and params['meta_sgd_lrs'] is not None\n"
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
