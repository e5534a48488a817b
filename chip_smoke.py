"""Drive the PyTorch port (``enf_pde_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, one line each, flushed as they go:

1. build: compile every CUDA kernel of the forecast path with plain ``nvcc``
   (the build's seconds, the compiler's register/spill report, the card's name
   and power limit);
2. kernel K1 (``fused_decode_fwd``) against its plain PyTorch version at the full
   Navier-Stokes width, batch 8 x 4096 points, with and without the fused tail;
3. the Navier-Stokes forecast end to end at full width with seeded random weights:
   ``Forecaster.forecast`` of 8 smooth periodic 64x64 frames for 20 frames
   (3-step latent fit, 19 Euler steps of the PONITA ODE, decode of 160 frames x
   4096 points through K1), the launch count of K1 in that run, the output's
   shape and finiteness, the decoded field against the plain decode of the same
   latents, and the time of the call and of each stage (median of 5 warm repeats);
4. K1's time at the forecast's launch shape beside its plain version's and the
   card's bound for the same work, and the decode's PyTorch prologue (weight fold,
   geometry).

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when there is no CUDA device or any phase fails.
Every float check is in f32: rel-L2 <= 1e-5 against the plain version.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from enf_pde_tpu_torch.builders import build_models
from enf_pde_tpu_torch.config import load_experiment_config
from enf_pde_tpu_torch.data import planar_coords
from enf_pde_tpu_torch.inference import Forecaster
from enf_pde_tpu_torch.models.decoder import decode_chunked
from enf_pde_tpu_torch.ops import cuda_lib
from enf_pde_tpu_torch.ops.fused_decode import (
    KERNEL_SOURCE,
    decode_flops_per_point,
    fused_decode_fwd,
    fused_decode_plain,
)
from enf_pde_tpu_torch.ops.layers import reset_parameters

SEED = 0
REL_L2_TOL = 1e-5  # f32 kernel vs f32 plain version: only the order of the sums differs
GRID = 64
NUM_SIGNALS = 8
NUM_FRAMES = 20
WARM_REPEATS = 5
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 on the CUDA cores, the kernel's operand type
PEAK_BF16_FLOPS = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Fail unless ``out`` matches ``ref`` within REL_L2_TOL; return the max abs error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite values")
    rel = rel_l2(out, ref)
    err = float((out - ref).abs().max())
    log(f"[check] {name}: rel_l2 {rel:.3e} max_abs_err {err:.3e} (tol rel_l2 {REL_L2_TOL:g})")
    if not rel <= REL_L2_TOL:
        raise AssertionError(f"{name}: rel_l2 {rel:.3e} > {REL_L2_TOL:g}")
    return err


def sync_time(fn):
    """(result, seconds) of ``fn()`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smooth_frames(n: int, size: int, seed: int) -> np.ndarray:
    """``n`` smooth periodic fields on a size x size torus grid, [n, size, size, 1]."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2 * np.pi, size, endpoint=False)
    X, Y = np.meshgrid(ang, ang, indexing="ij")
    frames = np.zeros((n, size, size), dtype=np.float64)
    for i in range(n):
        for kx in range(0, 5):
            for ky in range(-4, 5):
                if kx == 0 and ky <= 0:
                    continue
                amp = rng.standard_normal() / (kx * kx + ky * ky)
                frames[i] += amp * np.cos(kx * X + ky * Y + rng.uniform(0, 2 * np.pi))
        frames[i] /= np.abs(frames[i]).max()
    return frames[..., None].astype(np.float32)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card.",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = cuda_lib.build(KERNEL_SOURCE)
    cuda_lib.load(KERNEL_SOURCE)
    build_s = time.perf_counter() - t0
    ptxas = lib_path.with_name(lib_path.name.replace(".so", ".ptxas.txt"))
    report = [ln.strip() for ln in ptxas.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if ptxas.exists() else []
    log(f"[build] {KERNEL_SOURCE} with nvcc in {build_s:.2f} s -> {lib_path.name}")
    for ln in report:
        log(f"[build] ptxas: {ln}")
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    cfg = load_experiment_config("navier_stokes")
    H, D = cfg.nef.num_heads, cfg.nef.num_hidden
    coords = planar_coords(GRID, GRID)
    max_errs = []

    # 2. K1 against its plain version at full width, b=8, C=4096.
    decoder, _ = build_models(cfg)
    reset_parameters(decoder, torch.Generator().manual_seed(SEED))
    decoder.to(dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    b, Z = NUM_SIGNALS, cfg.nef.num_latents
    x = torch.from_numpy(coords)[None].expand(b, -1, -1).to(dev)
    p = (torch.rand(b, Z, 2, generator=gen) * 2 - 1).to(dev)
    a = (1 + 0.5 * torch.randn(b, Z, cfg.nef.latent_dim, generator=gen)).to(dev)
    w = torch.full((b, Z, 1), 1.0, device=dev)
    with torch.no_grad():
        args = decoder.kernel_inputs(x, p, a, w)
        out_k = fused_decode_fwd(*args, num_heads=H, head_dim=D)
        out_p = fused_decode_plain(*args, num_heads=H, head_dim=D)
        max_errs.append(check_close("K1 tail b=8 C=4096", out_k, out_p))
        no_tail = (*args[:7], ())
        out_k = fused_decode_fwd(*no_tail, num_heads=H, head_dim=D)
        out_p = fused_decode_plain(*no_tail, num_heads=H, head_dim=D)
        max_errs.append(check_close("K1 no-tail b=8 C=4096", out_k, out_p))
    torch.cuda.synchronize()
    del decoder, args, out_k, out_p

    # 3. The forecast end to end, at full width.
    frames = smooth_frames(NUM_SIGNALS, GRID, SEED)
    (fc, init_s) = sync_time(lambda: Forecaster(cfg, coords, device="cuda"))
    log(f"[forecast] Forecaster built on {dev} (random weights, seed {SEED}) in {init_s:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    fused_decode_fwd.launches = 0
    out, fc_s = sync_time(lambda: fc.forecast(frames, num_frames=NUM_FRAMES))
    launches = fused_decode_fwd.launches
    expect = (NUM_SIGNALS, NUM_FRAMES, GRID * GRID, 1)
    log(f"[forecast] forecast(8 frames, num_frames={NUM_FRAMES}) -> {tuple(out.shape)} in "
        f"{fc_s:.3f} s (first call); K1 launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(out.shape) != expect:
        raise AssertionError(f"forecast shape {tuple(out.shape)} != {expect}")
    if not torch.isfinite(out).all():
        raise AssertionError("forecast has non-finite values")
    if launches == 0:
        raise AssertionError("the forecast did not launch K1")

    # Warm repeats: the whole call, then the path stage by stage; medians are reported
    # because the host-bound fit and rollout vary from call to call.
    totals = [sync_time(lambda: fc.forecast(frames, num_frames=NUM_FRAMES))[1] * 1e3
              for _ in range(WARM_REPEATS)]
    log(f"[forecast] warm forecast x{WARM_REPEATS}: median {statistics.median(totals):.2f} ms "
        f"(samples {', '.join(f'{v:.2f}' for v in totals)} ms)")
    stages = {"fit": [], "rollout": [], "decode": []}
    for _ in range(WARM_REPEATS):
        fitted, fit_s = sync_time(lambda: fc.fit(frames))
        traj, roll_s = sync_time(lambda: fc.rollout(fitted, NUM_FRAMES))
        field, dec_s = sync_time(lambda: fc.decode(traj))
        for name, sec in (("fit", fit_s), ("rollout", roll_s), ("decode", dec_s)):
            stages[name].append(sec * 1e3)
    log("[forecast] stages (warm, median of " + str(WARM_REPEATS) + "): " + " | ".join(
        f"{n} {statistics.median(v):.2f} ms (samples {', '.join(f'{x:.2f}' for x in v)})"
        for n, v in stages.items()))
    dec = fc.trainer.decoder
    pb, tb = traj[0].shape[:2]
    flat = [t.reshape(pb * tb, *t.shape[2:]) for t in traj]
    xs = fc.trainer.coords[None].expand(pb * tb, -1, -1)
    chunk = cfg.training.max_num_sampled_points
    with torch.no_grad():
        folded = dec.fold(flat[0], flat[1])
        plain = decode_chunked(
            lambda xc, pp, aa, ww: fused_decode_plain(*dec.kernel_geometry(xc, pp, ww), *folded,
                                                      num_heads=H, head_dim=D),
            xs, *flat, chunk_size=chunk,
        ).reshape(field.shape)
    max_errs.append(check_close("forecast decode vs plain decode", field, plain))
    del plain

    # 4. K1 at the forecast's launch shape: kernel, plain version, bound; and the
    # decode's PyTorch prologue (one weight fold per decode, geometry per chunk).
    with torch.no_grad():
        fold_ms = cuda_ms(lambda: dec.fold(flat[0], flat[1]), iters=5, warmup=1)
        geom_ms = cuda_ms(lambda: dec.kernel_geometry(xs[:, :chunk], flat[0], flat[2]), iters=20)
        args = (*dec.kernel_geometry(xs[:, :chunk], flat[0], flat[2]), *folded)
        kernel_ms = cuda_ms(lambda: fused_decode_fwd(*args, num_heads=H, head_dim=D), iters=20)
        plain_ms = cuda_ms(lambda: fused_decode_plain(*args, num_heads=H, head_dim=D), iters=5, warmup=1)
        out_k = fused_decode_fwd(*args, num_heads=H, head_dim=D)
    log(f"[timing] decode prologue: weight fold {fold_ms:.4f} ms per decode, geometry "
        f"{geom_ms:.4f} ms per chunk x {launches} chunks")
    inv, ws, tws = args[0], args[6], args[7]
    B, Zl, C, I = inv.shape
    hid, hidm = ws[1].shape[0], ws[8].shape[0]
    flops = decode_flops_per_point(H, D, hid, hidm, Zl, I, cfg.nef.num_out) * B * C
    moved = nbytes(args[:6]) + nbytes(ws) + nbytes(tws) + nbytes([out_k])
    bound_bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    log(f"[timing] K1 at the forecast launch shape b={B} z={Zl} c={C}: {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.2f} TFLOP/s f32); plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} (f32 {bound_ops_ms:.4f} ms, bf16 tensor "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms, bytes {bound_bytes_ms:.4f} ms: "
        f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.3f} MB); forecast launches {launches}, "
        f"decode total at this time {kernel_ms * launches:.3f} ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    kernels = [{
        "name": "fused_decode_fwd",
        "route": "cuda",
        "source": f"enf_pde_tpu_torch/csrc/{KERNEL_SOURCE}",
        "replaces": "enf_pde_tpu/ops/pallas_decode.py:548",
        "launches": launches,
        "max_abs_err": max(max_errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
