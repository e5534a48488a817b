"""The bf16 programs of the fused decode (JAX's ``compute_dtype=bfloat16``) on the CPU.

The JAX kernel runs its products with bf16 operands and f32 sums on the chip
(``fused_enf_decode``'s default; the decoder's ``pallas`` backend), and that mode computes a
different function from the strict-f32 one: the polynomial sin/cos, every product operand
rounded, the softmax weights rounded. The port's plain version takes it as
``compute_dtype=torch.bfloat16``; its kernels' bf16 programs are held against that on the card
by ``chip_smoke.py``. Here:

- the plain bf16 forward, with and without the tail, and its VJP (autograd through the casts)
  against ``_reference_decode`` / ``jax.vjp`` at ``compute_dtype=jnp.bfloat16``. Two right bf16
  implementations differ by chaotic roundings (about 1e-3), so the gates are relative to JAX's
  own distance between its bf16 and f32 functions, ``d(jax16, jax32)`` (d = rel-L2), per output
  and per gradient: ``d(port16, jax16) <= 0.35 d(jax16, jax32)`` and ``d(port16, jax32) /
  d(jax16, jax32)`` in [0.9, 1.1];
- ``fast_sincos`` against JAX's ``_fast_sincos``, bit for bit;
- the double backward through ``FusedDecode`` in bf16 against the plain bf16 composition's;
- the backends: ``pallas_interpret`` is ``kernel_f32``, and ``kernel`` decodes in bf16 on CUDA
  tensors and in f32 on CPU tensors (the resolution; nothing is launched);
- the bf16 programs' instructions in the sources: bf16 ``wgmma`` (K1's from shared memory only);
- K1's bf16 blocks of G and the tail at the narrow classes and its layout mirrors at phase 35's launch shapes.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enf_pde_tpu.ops import pallas_decode as jpd

from enf_pde_tpu_torch.builders import decoder_backend, resolve_backend
from enf_pde_tpu_torch.models.decoder import KERNEL_BACKENDS, kernel_compute_dtype
from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops import fused_decode as fd
from tests.test_torch_fused_decode import jax_fused_inputs, program_text
from tests.test_torch_fused_decode_bwd import port_args
from tests.test_torch_modules import B, D, H, N, decoder_pair, t

torch.set_num_threads(1)

# The gates (see the module's docstring).
NEAR, LO, HI = 0.35, 0.9, 1.1
BF16 = torch.bfloat16



def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64).ravel(), np.asarray(b, dtype=np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def gate(name, port16, jax16, jax32):
    """The ratio gates of one output or gradient; returns (d(port16, jax16) / gap, d(port16, jax32) / gap)."""
    gap = rel(jax16, jax32)
    if gap == 0:  # no product on its path (the head's bias): both modes compute it alike
        assert rel(port16, jax16) <= 1e-6, name
        return 0.0, 1.0
    near, ratio = rel(port16, jax16) / gap, rel(port16, jax32) / gap
    assert near <= NEAR, (name, near, gap)
    assert LO <= ratio <= HI, (name, ratio, gap)
    return near, ratio


@pytest.fixture(scope="module")
def pair():
    return decoder_pair(seed=11)


def bf16_spec(spec):
    return spec._replace(compute_dtype=jnp.bfloat16)


@pytest.mark.parametrize("with_tail", [True, False])
def test_plain_bf16_matches_jax_bf16(pair, with_tail):
    jdec, params, dec, (x, p, a, sigma) = pair
    spec, jargs = jax_fused_inputs(jdec, params, x, p, a, sigma, with_tail)
    j32 = np.asarray(jpd._reference_decode(spec, *jargs))
    j16 = np.asarray(jpd._reference_decode(bf16_spec(spec), *jargs))
    args = port_args(dec, (x, p, a, sigma), jargs, with_tail)
    with torch.no_grad():
        got = fd.fused_decode_plain(*args, num_heads=H, head_dim=D, compute_dtype=BF16)
        f32 = fd.fused_decode_plain(*args, num_heads=H, head_dim=D)
    assert got.dtype == torch.float32 and got.shape == ((B, N, 1) if with_tail else (B, N, H * D))
    assert rel(f32, j32) < 1e-5  # the f32 mode is unchanged
    gate("out", got, j16, j32)


@pytest.mark.parametrize("with_tail", [True, False])
def test_plain_bf16_vjp_matches_jax_bf16(pair, with_tail):
    """The VJP through the casts against ``jax.vjp`` of the bf16 ``_reference_decode``: every
    gradient group (inv, wb, A, ab, G, c and each trained weight) within the gates."""
    jdec, params, dec, (x, p, a, sigma) = pair
    spec, jargs = jax_fused_inputs(jdec, params, x, p, a, sigma, with_tail)
    out, vjp32 = jax.vjp(lambda *args: jpd._reference_decode(spec, *args), *jargs)
    _, vjp16 = jax.vjp(lambda *args: jpd._reference_decode(bf16_spec(spec), *args), *jargs)
    g = np.random.default_rng(4).standard_normal(out.shape).astype(np.float32)
    j32, j16 = vjp32(g), vjp16(g)
    args = port_args(dec, (x, p, a, sigma), jargs, with_tail)
    got = fd.fused_decode_bwd_plain(*args, torch.from_numpy(g), H, D, compute_dtype=BF16)
    names = ["dinv", "dwb", "dA", "dab", "dG", "dc"]
    pairs = list(zip(got[:6], j16[:6], j32[:6]))
    for i, (gw, w16, w32) in enumerate(zip((*got[6], *got[7]), (*j16[6], *j16[7]), (*j32[6], *j32[7]))):
        if gw is not None:
            names.append(f"d{(*fd.WEIGHT_NAMES, *fd.TAIL_WEIGHT_NAMES)[i]}")
            pairs.append((gw, w16, w32))
    assert len(pairs) == 6 + 8 + (12 if with_tail else 0)
    for name, (gv, w16, w32) in zip(names, pairs):
        gate(name, gv.detach(), np.asarray(w16).reshape(gv.shape), np.asarray(w32).reshape(gv.shape))


def test_fast_sincos_is_jax_bit_for_bit():
    proj = np.random.default_rng(0).uniform(-3.0, 3.0, 4096).astype(np.float32)
    proj[:6] = [0.0, 0.5, -0.5, 0.25, 1e-8, 2.5]  # ties of the rounding, quarter turns
    s, c = fd.fast_sincos(torch.from_numpy(proj))
    js, jc = jpd._fast_sincos(jnp.asarray(proj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert np.abs(s.numpy() - np.sin(2 * np.pi * proj.astype(np.float64))).max() < 2e-5


def test_fused_decode_bf16_double_backward_is_the_plain_composition(pair):
    """Second order through ``FusedDecode`` at bf16 (K2's values, the plain composition's
    derivatives, as JAX's shields run ``_reference_decode`` at the spec's dtype) against double
    autograd through the plain bf16 composition."""
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    inv, wb, A, ab, G, c, ws, tws = args
    gen = np.random.default_rng(7)
    g = torch.from_numpy(gen.standard_normal((B, N, 1)).astype(np.float32))
    v = torch.from_numpy(gen.standard_normal(A.shape).astype(np.float32))

    def second(fn):
        xs = [inv.clone().requires_grad_(True), A.clone().requires_grad_(True)]
        w1 = ws[1].clone().requires_grad_(True)
        ws_ = (*ws[:1], w1, *ws[2:])
        out = fn(xs[0], xs[1], ws_)
        dA, = torch.autograd.grad(out, xs[1], g, create_graph=True)
        return torch.autograd.grad((dA * v).sum(), [xs[0], w1])

    kern = second(lambda i, a_, w: fd.FusedDecode.apply(H, D, len(tws), BF16, i, wb, a_, ab, G, c, *w, *tws))
    plain = second(lambda i, a_, w: fd.fused_decode_plain(i, wb, a_, ab, G, c, w, tws, H, D, BF16))
    for k, p_ in zip(kern, plain):
        assert float(p_.abs().max()) > 0
        torch.testing.assert_close(k, p_, rtol=1e-5, atol=1e-6)
    f32 = second(lambda i, a_, w: fd.fused_decode_plain(i, wb, a_, ab, G, c, w, tws, H, D))
    assert rel(plain[0], f32[0]) > 1e-4  # the bf16 function's second derivative, not the f32 one


def test_backends_map_as_the_jax_decoder_maps_them(pair):
    """``pallas`` is the kernel backend, ``pallas_interpret`` its strict-f32 programs; on CUDA
    tensors ``kernel`` picks bf16 (JAX: ``compute_dtype=jnp.float32 if interpret else
    jnp.bfloat16``), on CPU tensors f32 (the interpreter's), and ``kernel_f32`` f32 on both."""
    assert (decoder_backend("xla"), decoder_backend("pallas"), decoder_backend("pallas_interpret")) == (
        "eager", "kernel", "kernel_f32")
    assert KERNEL_BACKENDS == ("kernel", "kernel_f32")
    assert kernel_compute_dtype("kernel", torch.device("cuda")) == BF16
    assert kernel_compute_dtype("kernel", "cuda:1") == BF16
    assert kernel_compute_dtype("kernel", torch.device("cpu")) == torch.float32
    for dev in ("cpu", "cuda"):
        assert kernel_compute_dtype("kernel_f32", dev) == torch.float32
    with pytest.raises(ValueError, match="kernel backend"):
        kernel_compute_dtype("eager", "cuda")
    _, _, dec, (x, p, a, sigma) = pair
    assert resolve_backend("pallas_interpret", dec) == "kernel_f32"
    with torch.no_grad():  # on the CPU both kernel backends are the plain f32 decode
        outs = [dec(t(x), t(p), t(a), t(sigma), backend=b) for b in ("kernel", "kernel_f32")]
    assert torch.equal(outs[0], outs[1])
    assert (fd.kernel_sources(torch.float32), fd.kernel_sources(BF16)) == (
        (fd.KERNEL_SOURCE, fd.BWD_KERNEL_SOURCE), (fd.KERNEL_SOURCE_BF16, fd.BWD_KERNEL_SOURCE_BF16))
    with pytest.raises(ValueError, match="compute_dtype"):
        fd.kernel_sources(torch.float16)


def test_bf16_weights_layout_and_wrapper_checks(pair, monkeypatch):
    """K1's bf16 blocks: every shared weight rounded to bf16 at [kc, s, ng, kg, r, i] = W[16 kc +
    8 kg + i, wn s + 8 ng + r], zero past N; the wrapper refuses a split of the other program;
    past the latents whose logits fit shared memory the logits go to a global workspace, and the
    wrapper takes the launch to the build rather than refusing it."""
    gen = torch.Generator().manual_seed(3)
    for wn, (hid, hidm, D_) in {16: (16, 16, 8), 32: (32, 16, 32), 64: (48, 64, 40), 128: (32, 16, 136)}.items():
        shapes = ((4, hid // 2), (hid, hid), (hid,), (4, hid // 2), (hid, hid), (hid,), (hid, hid), (hid,),
                  (hidm, D_), (D_,))
        ws = [torch.randn(*s, generator=gen) for s in shapes]
        buf, views = fd.bf16_weights(ws)
        assert buf.dtype == BF16 and fd.k1_width_class(hid, hidm, D_) == wn
        for name, view in zip(fd.SPLIT_WEIGHT_NAMES, views):
            w = ws[fd.WEIGHT_NAMES.index(name)]
            K, Nw = w.shape
            slabs = -(-Nw // wn)
            assert view.shape == (K // 16, slabs, wn // 8, 2, 8, 8)
            back = view.permute(0, 3, 5, 1, 2, 4).reshape(K, slabs * wn)
            assert torch.equal(back[:, :Nw], w.to(BF16)) and not back[:, Nw:].float().any()
            kc, s, ng, kg, r, i = K // 16 - 1, slabs - 1, 0, 1, 3, 5
            k, n = 16 * kc + 8 * kg + i, wn * s + 8 * ng + r
            if n < Nw:
                assert view[kc, s, ng, kg, r, i] == w[k, n].to(BF16)
    _, _, dec, (x, p, a, sigma) = pair
    with torch.no_grad():
        args = dec.kernel_inputs(t(x), t(p), t(a), t(sigma))
    with pytest.raises((ValueError, TypeError), match="split q_w1"):
        fd._launch(*args, H, D, split=fd.shared_weights(args[6]), compute_dtype=BF16)
    assert [v.dtype for v in fd.shared_weights(args[6], BF16)] == [BF16] * 4
    # Every latent's logits (64 rows) in shared memory up to z = 62 at NS width, past it in global
    # memory: a slot of [z][64][H] for each block of the persistent grid (132 on an H100).
    assert fd.k1_smem_bytes(62, 4, 128, 2, 128, 128, BF16) == 232_448
    assert fd.k1_logits_floats(160, 62, 512, 4, 128, 2, 128, 128, BF16) == 0
    assert fd.k1_smem_bytes(63, 4, 128, 2, 128, 128, BF16) == 200_704 == fd.k1_smem_bytes(1000, 4, 128, 2, 128, 128, BF16)
    assert fd.k1_logits_floats(160, 64, 512, 4, 128, 2, 128, 128, BF16) == 132 * 64 * 64 * 2
    assert fd.k1_logits_floats(160, 64, 512, 4, 128, 2, 128, 128, BF16, sms=114) == 114 * 64 * 64 * 2
    assert fd.k1_logits_floats(160, 1000, 512, 4, 128, 2, 128, 128) == 0  # the f32 program takes none
    big = 700  # latents: past the class 32's shared memory at this test's widths
    rep = lambda x: x[:, :1].expand(-1, big, *x.shape[2:]).contiguous()  # noqa: E731
    inv, wb, A, ab, G, c, ws, tws = args
    hid, hidm = ws[fd.WEIGHT_NAMES.index("q_w1")].shape[1], ws[fd.WEIGHT_NAMES.index("m_w2")].shape[0]
    assert fd.k1_width_class(hid, hidm, D) == 32
    assert fd.k1_logits_floats(inv.shape[0], big, inv.shape[2], inv.shape[3], hid, H, D, hidm, BF16) > 0

    class Built(Exception):
        pass

    def build(*_):
        raise Built

    monkeypatch.setattr(cuda_lib, "build", build)
    with pytest.raises(Built):
        fd._launch(rep(inv), rep(wb), rep(A), rep(ab), rep(G), rep(c), ws, tws, H, D, compute_dtype=BF16)


def test_bf16_blocked_g_and_tail_rebuild_and_the_wrapper_refuses_another_layout(monkeypatch):
    """The bf16 program's class 128 reads G (each head's columns padded to 128) and the tail's wide
    weights in bf16 blocks, laid out once a decode (``k1_operands``): the blocks rebuild the matrices
    they came from, rounded to bf16, zero past each head; the f32 program and the narrow classes take
    none; the wrapper refuses a G or tail of another layout before anything is built and takes the
    right one to the build."""
    gen = torch.Generator().manual_seed(5)
    b, z, hid, H_, hidm, I, C = 2, 3, 80, 2, 80, 4, 5
    G = torch.randn(b, z, hid, H_ * hidm, generator=gen)
    g16 = fd.bf16_g_blocks(G, H_)
    assert g16.dtype == BF16 and g16.is_contiguous() and g16.shape == (b, z, H_, hid // 16, 16, 2, 8, 8)
    back = g16.permute(0, 1, 2, 3, 5, 7, 4, 6).reshape(b, z, H_, hid, 128)  # [b, z, h, k, n]
    want = G.reshape(b, z, hid, H_, hidm).transpose(2, 3)
    assert torch.equal(back[..., :hidm], want.to(BF16)) and not back[..., hidm:].float().any()
    kc, ng, kg, r, i = 4, 9, 1, 2, 7  # one element by its index: G[.., 16 kc + 8 kg + i, h hidm + 8 ng + r]
    assert g16[1, 2, 1, kc, ng, kg, r, i] == G[1, 2, 16 * kc + 8 * kg + i, hidm + 8 * ng + r].to(BF16)
    HD = H_ * hid
    ws = [torch.randn(*s, generator=gen) for s in ((I, hid // 2), (hid, hid), (hid,), (I, hid // 2), (hid, hid), (hid,),
                                                   (hid, hid), (hid,), (hidm, hid), (hid,))]
    tws = [torch.randn(*s, generator=gen) for s in ((HD, HD), (HD,), (HD, HD), (HD,), (HD, HD), (HD,), (HD, hid), (hid,),
                                                    (hid, hid), (hid,), (hid, 1), (1,))]
    ops = fd.k1_operands(G, ws, tws, H_, BF16)
    assert fd.k1_width_class(hid, hidm, hid) == fd.WG_N and torch.equal(ops.G, g16)
    for name, blk in zip(fd.BLOCKED_TAIL_NAMES, ops.tail):
        w = tws[fd.TAIL_WEIGHT_NAMES.index(name)]
        K, Nw = w.shape
        slabs = -(-Nw // 128)
        rebuilt = blk.permute(0, 3, 5, 1, 2, 4).reshape(K, slabs * 128)
        assert blk.shape == (K // 16, slabs, 16, 2, 8, 8)
        assert torch.equal(rebuilt[:, :Nw], w.to(BF16)) and not rebuilt[:, Nw:].float().any()
    assert fd.k1_operands(G, ws, tws, H_).G is None and fd.k1_operands(G, ws, (), H_, BF16).tail == ()
    # The wrapper: inputs of this shape on the CPU reach its layout checks (it launches nothing here).
    inv, wb = torch.randn(b, z, C, I, generator=gen), torch.randn(b, z, C, generator=gen)
    A, ab, c = torch.randn(b, z, hid, H_, generator=gen), torch.randn(b, z, H_, generator=gen), torch.randn(b, z, H_ * hidm)
    args = (inv, wb, A, ab, G, c, ws, tws, H_, hid)
    with pytest.raises(TypeError, match="blocked G must be bfloat16"):
        fd._launch(*args, split=ops._replace(G=G), compute_dtype=BF16)
    with pytest.raises(ValueError, match="blocked G has shape"):
        fd._launch(*args, split=ops._replace(G=g16.reshape(b, z, -1)), compute_dtype=BF16)
    with pytest.raises(ValueError, match="blocked o_w has shape"):  # h_w1's blocks (one slab) in o_w's place (two)
        fd._launch(*args, split=ops._replace(tail=(ops.tail[3], *ops.tail[1:])), compute_dtype=BF16)
    with pytest.raises(ValueError, match="expected 5 blocked tail weights"):
        fd._launch(*args, split=ops._replace(tail=ops.tail[:4]), compute_dtype=BF16)
    # Its f32 operands are read two at a time: each must start on 8 bytes.
    c_odd = torch.empty(c.numel() + 1)[1:].view(c.shape).copy_(c)
    with pytest.raises(ValueError, match="c must start on 8 bytes"):
        fd._launch(inv, wb, A, ab, G, c_odd, ws, tws, H_, hid, split=ops, compute_dtype=BF16)

    class Built(Exception):
        pass

    def build(*_):
        raise Built

    monkeypatch.setattr(cuda_lib, "build", build)
    for split in (ops, ops.shared, None):  # laid out once a decode, or here for this launch
        with pytest.raises(Built):
            fd._launch(*args, split=split, compute_dtype=BF16)


# The narrow classes' blocks (hid, H, hidm, D at each): `diff_sphere`'s widths, `ihc`'s, and a class 64 whose heads
# (hidm 48) and tail (H D = 96) stop short of the class width.
NARROW_BLOCK_WIDTHS = {16: (16, 2, 16, 16), 32: (32, 3, 32, 32), 64: (64, 2, 48, 48)}


@pytest.mark.parametrize("wn", sorted(NARROW_BLOCK_WIDTHS))
def test_bf16_narrow_blocks_and_the_wrapper_refuses_another_layout(wn, monkeypatch):
    """The narrow classes read G (each head's hidm columns padded to the class width) and the tail's wide weights in
    bf16 blocks at the class width, laid out once a decode (``k1_operands``): each element where its index says,
    the blocks rebuild the matrices rounded to bf16, zero past each head and past N; a latent's heads one after the
    other. The wrapper refuses G or the tail in another layout (the class 128's blocks, f32) before anything is
    built, and takes the right one to the build."""
    gen = torch.Generator().manual_seed(wn)
    hid, H_, hidm, D_ = NARROW_BLOCK_WIDTHS[wn]
    b, z, I, C, HD = 2, 3, 2, 5, H_ * D_
    assert fd.k1_width_class(hid, hidm, D_) == wn
    G = torch.randn(b, z, hid, H_ * hidm, generator=gen)
    g16 = fd.bf16_g_blocks(G, H_, wn)
    assert g16.dtype == BF16 and g16.is_contiguous() and g16.shape == (b, z, H_, hid // 16, wn // 8, 2, 8, 8)
    back = g16.permute(0, 1, 2, 3, 5, 7, 4, 6).reshape(b, z, H_, hid, wn)  # [b, z, h, k, n]
    want = G.reshape(b, z, hid, H_, hidm).transpose(2, 3)
    assert torch.equal(back[..., :hidm], want.to(BF16)) and not back[..., hidm:].float().any()
    for kc, ng, kg, r, i in ((0, 0, 0, 0, 0), (hid // 16 - 1, hidm // 8 - 1, 1, 7, 7), (hid // 16 - 1, 1, 0, 5, 2)):
        h = H_ - 1  # element G[.., 16 kc + 8 kg + i, h hidm + 8 ng + r]
        assert g16[1, 2, h, kc, ng, kg, r, i] == G[1, 2, 16 * kc + 8 * kg + i, h * hidm + 8 * ng + r].to(BF16)
    flat = g16.reshape(b, z, -1)  # a latent's heads one after the other, 16 wn bf16 a chunk of 16 rows
    assert torch.equal(flat[1, 2, hid * wn:hid * wn + 16 * wn], g16[1, 2, 1, 0].reshape(-1))
    ws = [torch.randn(*s, generator=gen) for s in ((I, hid // 2), (hid, hid), (hid,), (I, hid // 2), (hid, hid), (hid,),
                                                   (hid, hid), (hid,), (hidm, D_), (D_,))]
    tws = [torch.randn(*s, generator=gen) for s in ((HD, HD), (HD,), (HD, HD), (HD,), (HD, HD), (HD,), (HD, hid), (hid,),
                                                    (hid, hid), (hid,), (hid, 1), (1,))]
    ops = fd.k1_operands(G, ws, tws, H_, BF16)
    assert torch.equal(ops.G, g16) and len(ops.tail) == len(fd.BLOCKED_TAIL_NAMES)
    for name, blk in zip(fd.BLOCKED_TAIL_NAMES, ops.tail):
        w = tws[fd.TAIL_WEIGHT_NAMES.index(name)]
        K, Nw = w.shape
        slabs = -(-Nw // wn)
        assert blk.shape == (K // 16, slabs, wn // 8, 2, 8, 8)
        rebuilt = blk.permute(0, 3, 5, 1, 2, 4).reshape(K, slabs * wn)
        assert torch.equal(rebuilt[:, :Nw], w.to(BF16)) and not rebuilt[:, Nw:].float().any()
        kc, s_, ng, kg, r, i = K // 16 - 1, slabs - 1, 0, 1, 3, 6  # element W[16 kc + 8 kg + i, wn s + 8 ng + r]
        assert blk[kc, s_, ng, kg, r, i] == w[16 * kc + 8 * kg + i, wn * s_ + 8 * ng + r].to(BF16)
    assert fd.k1_operands(G, ws, tws, H_).G is None and fd.k1_operands(G, ws, (), H_, BF16).tail == ()
    with pytest.raises(ValueError, match="at most"):  # a head wider than the class
        fd.bf16_g_blocks(torch.randn(1, 1, 16, 2 * (wn + 16)), 2, wn)
    inv, wb = torch.randn(b, z, C, I, generator=gen), torch.randn(b, z, C, generator=gen)
    A, ab, c = torch.randn(b, z, hid, H_, generator=gen), torch.randn(b, z, H_, generator=gen), torch.randn(b, z, H_ * hidm)
    args = (inv, wb, A, ab, G, c, ws, tws, H_, D_)
    with pytest.raises(TypeError, match="blocked G must be bfloat16"):
        fd._launch(*args, split=ops._replace(G=G), compute_dtype=BF16)
    with pytest.raises(ValueError, match="blocked G has shape"):  # the class 128's blocks
        fd._launch(*args, split=ops._replace(G=fd.bf16_g_blocks(G, H_)), compute_dtype=BF16)
    with pytest.raises(ValueError, match="blocked o_w has shape"):
        fd._launch(*args, split=ops._replace(tail=fd._tail_blocks(tws)), compute_dtype=BF16)

    class Built(Exception):
        pass

    def build(*_):
        raise Built

    monkeypatch.setattr(cuda_lib, "build", build)
    for split in (ops, ops.shared, None):  # laid out once a decode, or here for this launch
        with pytest.raises(Built):
            fd._launch(*args, split=split, compute_dtype=BF16)


# The bf16 K1's layout mirrors at every narrow launch shape of `chip_smoke.py`'s phase 35 (BF16_K1_SHAPES and
# BF16_K1_MANY_LATENTS): shared bytes, whether the logits lie in global memory, blocks an SM, (tile, items, grid) on
# 132 SMs, and the logits workspace's floats (a slot of [Z][64][H] a block).
NARROW_LAUNCHES = {
    ("diffusion_plane", (), 160, 1024): (172_032, False, 1, (64, 2560, 132), 0),
    ("cahn_hilliard", (), 160, 2048): (174_592, False, 1, (64, 5120, 132), 0),
    ("diff_sphere", (), 160, 2048): (44_032, False, 3, (64, 5120, 396), 0),
    ("diff_sphere", (), 40, 2048): (44_032, False, 3, (64, 1280, 396), 0),
    ("ihc", (), 160, 2048): (111_360, False, 2, (64, 5120, 264), 0),
    ("ihc", (), 14, 2048): (111_360, False, 2, (64, 448, 264), 0),
    ("diffusion_plane", ("nef.num_latents=600",), 8, 1000): (169_984, True, 1, (64, 128, 128), 128 * 600 * 64 * 2),
    ("diff_sphere", ("nef.num_latents=1000",), 8, 1000): (34_816, True, 3, (32, 256, 256), 256 * 1000 * 64 * 2),
}


def test_bf16_narrow_mirrors_at_every_phase35_launch():
    """``k1_smem_bytes``, ``k1_plan`` and ``k1_logits_floats`` of the bf16 program at each narrow launch shape that
    ``chip_smoke.py`` holds on the card (its configs' widths, I from their invariants): the narrow layout (the shared
    weights; each warpgroup's X, Y and G; the attention output's two shares or the tail's stage and weights; the
    logits) and its plan, 64 coordinates an item (32 where items of 64 leave half of the 132 SMs' slots idle), three
    blocks an SM at 16, two at 32, one at 64 (each within its share of an SM's 233,472 B, 1,024 B of it kept back a
    block); past the latents whose logits fit, a workspace slot for each block of the grid."""
    import chip_smoke as cs
    from enf_pde_tpu_torch.config import load_experiment_config
    from enf_pde_tpu_torch.geometry.invariants import get_ca_invariant

    shapes = {(n, o, b, c) for n, o, b, c, _ in cs.BF16_K1_SHAPES} | set(cs.BF16_K1_MANY_LATENTS)
    k = fd.k1_constants(BF16)
    seen = set()
    for name, over, b, c in sorted(shapes):
        nef = load_experiment_config(name, list(over)).nef
        I, hid, H_, Z = get_ca_invariant(nef).dim, nef.num_hidden, nef.num_heads, nef.num_latents
        wn = fd.k1_width_class(hid, hid, hid)
        if wn == fd.WG_N:
            continue
        smem, glob, slots, plan, floats = NARROW_LAUNCHES[(name, over, b, c)]
        seen.add((name, over, b, c))
        assert fd._k1_layout(Z, I, hid, H_, hid, hid, BF16) == (smem, glob, slots)
        assert fd.k1_smem_bytes(Z, I, hid, H_, hid, hid, BF16) == smem
        assert fd.k1_plan(b, Z, c, I, hid, H_, hid, hid, BF16) == plan
        assert fd.k1_logits_floats(b, Z, c, I, hid, H_, hid, hid, BF16) == floats
        assert slots == k[f"BLOCKS{wn}"] and slots * (smem + k["SM_KEPT"]) <= k["SM_SHARED"] == 233_472
        assert (plan[0] == 32) == (2 * b * -(-c // 64) <= slots * 132) and plan[2] == min(plan[1], slots * 132)
    assert seen == set(NARROW_LAUNCHES)


def test_bf16_programs_run_on_bf16_tensor_cores():
    """The bf16 programs' products: K1 on bf16 wgmma with both operands in shared memory and nothing
    else (no mma.sync, no wgmma with A in registers, no operand rounded in registers), m64n64k16 at
    the class 128 and m64nWNk16 at the narrow classes WN = 16, 32, 64 (a product as wide as the class,
    `wgmma_bf16_ss<WN>`); K2's class design on bf16 wgmma at N = 8, 16, 32, 64
    with a cotangent operand in three bf16 terms, its W128 design on bf16 wgmma m64n64k16 with both
    operands in shared memory (transposed for its row contractions) and the cotangents in three bf16
    planes; the shared helper holds each instruction once (at n16-n64 once with A in registers, once
    with A in shared memory); no TF32 product, library GEMM, WMMA or
    atomics."""
    header = (cuda_lib.CSRC_DIR / "bf16_mma.cuh").read_text()
    assert "mma.sync" not in header  # every bf16 product a wgmma
    for n in (8, 16, 32, 64):  # A from registers; at n = 16, 32, 64 also A in shared memory (wgmma_bf16_ss)
        assert header.count(f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16") == 1 + (n > 8), n
    for d in ("%8, %9", "%16, %17", "%32, %33"):  # two descriptors, neither transposed
        assert header.count(f'"{d}, p, 1, 1, 0, 0;\\n"') == 1, d
    assert "__fmul_rn" in header and "rintf(p)" in header  # fast_sincos: no contraction, round half even
    k1 = (cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE_BF16).read_text()
    k2 = (cuda_lib.CSRC_DIR / fd.BWD_KERNEL_SOURCE_BF16).read_text()
    for src in (k1, k2):  # each program's own source; the headers it shares with the f32 program below
        assert '#include "bf16_mma.cuh"' in src
        assert "tf32.tf32" not in src and "wgmma_tf32" not in src and "mma_3xtf32" not in src
        assert "fast_sincos(" in src and "sincosf" not in src
        for banned in ("wmma", "cutlass", "cublas", "torch/extension.h", "atomic"):
            assert banned not in src.lower()
    # K1: no mma.sync, no wgmma with A in registers, no operand rounded in registers (stored in bf16 once by
    # the epilogue before its product), none of the 32-row products; the softmax weights rounded.
    for banned in ("mma_bf16(", "wgmma_bf16<", "pack_bf16(", "dense32", "gemm_wg", "mma.sync.aligned"):
        assert banned not in k1, banned
    assert k1.count("bf16_round(prob[z * TILE128 * H + idx] / l)") == 2
    c128 = k1[k1.index("// ---- The width class 128"):k1.index("template <int WN, bool WITH_TAIL>\n__global__")]
    # A slab's whole sum in the wgmma accumulator; k1_compare's variant `fresh` (ROADMAP Queue 2, item 8)
    # flips FRESH_ACC to a fresh accumulator a 16-deep k step, summed in f32.
    assert "constexpr int FRESH_ACC = 0;" in c128 and "acc[i] = two ? s + part[1][i] : s;" in c128
    assert c128.count("wgmma_bf16_ss64(") == 3 and "mma_bf16(" not in c128 and "wgmma_bf16<" not in c128
    assert "bf16_round(prob[z * TILE128 * H + idx] / l)" in c128
    # The narrow classes (a latent a warpgroup): every product one wgmma_bf16_ss<N> instruction in `product_ss`,
    # its K in one group (q_w1, v_w1, fw, G, m_w2 and the tail's five layers at N = WN; the logits, hq times A[b, z]
    # with the heads padded to NL = 16 columns); no wgmma on a path that differs between the warpgroups; the
    # LayerNorms from a quad's shuffles (`quad_norm`), the tail's exchanged (`row_sums`).
    narrow = k1[k1.index("// ---- The narrow classes"):k1.index("template <int WN, bool WITH_TAIL>\n__global__")]
    assert narrow.count("wgmma_bf16_ss<N>(") == 1 and "wgmma_bf16_ss64(" not in narrow
    assert narrow.count("product_ss<WN>(") == 6 and narrow.count("product_ss<NL>(") == 1
    assert narrow.count("tail_layer_n<WN>(") == 5 and "wg_wait1();" not in narrow and "__shfl" in narrow
    assert narrow.count("quad_norm<NJ>(") == 2 and narrow.count("row_sums<2>(") == 1
    assert "normalize<" not in narrow and "normalize_rows(" not in narrow and "lane_dots(" not in narrow  # no row pass
    # A cotangent operand in three bf16 terms (split3_bf16): the products of terms i + j <= 2.
    gemm = re.search(r"\n__device__ __forceinline__ void gemm\(.*?\n}\n", k2, re.S).group(0)
    assert gemm.count("wgmma_bf16<WN>(") == 10 and gemm.count("split3_bf16(") == 3  # B two values a call, A one pair
    assert "static_assert((AP == 1 || AP == 3) && (BP == 1 || BP == 3)" in gemm
    # Passes 0 (the shared weights; the W128 design's G blocks; the narrow design's images), 1 (the class design at
    # the class 64 alone; the W128 design; the narrow design's five kernels) and 2 (the reduction, the narrow design's).
    assert k2.count("__global__") == 12 and "#define K2_CLASS64_ONLY" in k2
    # The W128 design (hid = hidm = D = 128, two heads): every product a wgmma m64n64k16 with both operands
    # in shared memory (a row contraction's transposed: its instruction takes the transpose flags), none
    # with A in registers, no operand rounded in registers; f32 cotangents and nbar as three bf16 planes.
    w128 = k2[k2.index("// ---- The W128 design"):k2.index("// ---- The narrow design")]
    assert w128.count("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16") == 1
    assert '"%32, %33, p, 1, 1, %35, %36;\\n"' in w128 and "wgmma_ss<1, 1>(" in w128 and "wgmma_ss<0, 0>(" in w128
    assert "wgmma_bf16<" not in w128 and "mma_bf16(" not in w128 and "pack_bf16(" not in w128
    assert w128.count("store3(") >= 8 and "split3_bf16(v0, v1, t);" in w128
    # The narrow design (every launch below the width class 64): every product a wgmma with both operands in shared
    # memory by descriptor (`nmma`: m64nNk16 at N = 8, 16, 32 and wgmma_ss's n64, each with the transpose flags), none
    # with A in registers, no operand rounded in registers; the cotangents and nbar in three bf16 planes; the
    # LayerNorms, their VJPs and dp in the epilogues (no row pass over f32 shared memory, no staging of B).
    narrow = k2[k2.index("// ---- The narrow design"):k2.index("// Pass 2: out")]
    for n in (8, 16, 32):
        assert narrow.count(f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16") == 1
    assert narrow.count('"%4, %5, p, 1, 1, %7, %8;\\n"') == 1 and narrow.count("wgmma_ss<TA, TB>(") == 1
    assert narrow.count("wgmma_t<N, TA, TB>(") == 1 and narrow.count("nmma<") >= 20 and narrow.count("__global__") == 7
    for banned in ("wgmma_bf16<", "mma_bf16(", "pack_bf16(", "gemm<", "ln_gelu(", "ln_gelu_vjp(", "gelu_rows(",
                   "mul_gelu_grad(", "softmax_z(", "accum_nbar(", "B_SPLIT", "B_KN", "Cls<"):
        assert banned not in narrow, banned
    assert narrow.count("store3(") >= 8 and narrow.count("xsum<") >= 6 and "__shfl_xor_sync" in narrow
    # The headers shared with the f32 program multiply through the program's own hooks: the
    # operand rounding (`operand`: bf16_round here) and the RFF sin / cos (`rff_sincos`).
    for src, source in ((k1, fd.KERNEL_SOURCE_BF16), (k2, fd.BWD_KERNEL_SOURCE_BF16)):
        assert "float operand(float x) { return bf16_round(x); }" in src
        assert "void rff_sincos(float proj, float* s, float* c) { fast_sincos(proj, s, c); }" in src
        shared = program_text(source).replace(src, "")
        assert "tf32.tf32" not in shared and "bf16_round(" not in shared and "rff_sincos(proj" in shared
        for banned in ("wmma", "cutlass", "cublas", "torch/extension.h", "atomic"):
            assert banned not in shared.lower()
    names = [p.name for p in cuda_lib.included_files(cuda_lib.CSRC_DIR / fd.KERNEL_SOURCE_BF16)]
    assert names == [fd.KERNEL_SOURCE_BF16, "fused_decode_fwd_common.cuh", "bf16_mma.cuh", "fused_decode_fwd_host.cuh",
                     "tf32_mma.cuh"]


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """f32 rounded to bf16 (to nearest, ties to even) and back, by integer arithmetic in numpy."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("K", [16, 32, 64, 128, 256])
def test_a16_layout_and_its_descriptors_against_numpy(K):
    """``a16_index`` (the bf16 programs' 64-row operand in shared memory, K = hid at K1's narrow classes) against
    the core-matrix layout
    built directly in numpy: 8 x 8 blocks, the row groups of a k group 128 bytes apart, the k groups
    1,024 bytes. Read as wgmma reads a descriptor without swizzle, K-major (LBO 1,024 B, SBO 128 B: a
    product's A) the buffer gives X, and MN-major (LBO 128 B, SBO 1,024 B: a row contraction's operand,
    its K the 64 rows) it gives X^T, from any 16-row step and 64-column view the W128 design starts at."""
    rng = np.random.default_rng(K)
    X = rng.standard_normal((64, K)).astype(np.float32)
    direct = X.reshape(8, 8, K // 8, 8).transpose(2, 0, 1, 3).reshape(-1)  # [k group][row group][row][k]
    r, k = np.meshgrid(np.arange(64), np.arange(K), indexing="ij")
    buf = np.empty(64 * K, np.float32)
    buf[fd.a16_index(r, k)] = X
    np.testing.assert_array_equal(buf, direct)

    def read(start, a, b, lbo, sbo, mn):  # element (a, b) of a descriptor's 64 x 16 (or 16 x 64) tile
        off = 2 * start + (a // 8) * sbo + (b // 8) * lbo + ((b % 8) * 16 + (a % 8) * 2 if mn else (a % 8) * 16 + (b % 8) * 2)
        return buf[off // 2]
    m, kk = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for ks in range(K // 16):  # a product's A: rows m, k step ks
        got = read(fd.a16_index(0, 16 * ks), m, kk, 1024, 128, False)
        np.testing.assert_array_equal(got, X[:, 16 * ks:16 * ks + 16])
    for ks in range(4):  # a row contraction's operand: columns 64 mt .. of X as M, rows 16 ks .. as K
        for mt in range(K // 64):
            got = read(fd.a16_index(16 * ks, 64 * mt), m, kk, 128, 1024, True)
            np.testing.assert_array_equal(got, X[16 * ks:16 * ks + 16, 64 * mt:64 * mt + 64].T)


def test_split3_bf16_against_numpy():
    """``split3_bf16`` (an f32 operand as three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
    hi - mid)) against the same steps in numpy bit for bit, over values across twelve decades and zeros;
    (hi + mid) + lo in f32 is x exactly."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(20_000) * 10.0 ** rng.uniform(-6, 6, 20_000)).astype(np.float32)
    x[:10] = 0.0
    hi, mid, lo = (t.float().numpy() for t in fd.split3_bf16(torch.from_numpy(x)))
    h = _bf16_rne(x)
    rest = (x - h).astype(np.float32)
    mm = _bf16_rne(rest)
    np.testing.assert_array_equal(hi.view(np.uint32), h.view(np.uint32))
    np.testing.assert_array_equal(mid.view(np.uint32), mm.view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), _bf16_rne((rest - mm).astype(np.float32)).view(np.uint32))
    np.testing.assert_array_equal(((hi + mid).astype(np.float32) + lo).astype(np.float32), x)
