#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Builds the CUDA kernels of ``rpg_open_remode_tpu_torch/csrc`` and checks each
against its plain PyTorch version at the main path's shapes; drives the
single-keyframe engine through ``Depthmap`` at 640x480 (the hardened
``over_table`` protocol: 200 frames, one keyframe, a 200-iteration denoise)
and at 1280x720 (80 frames, focal-scaled config), checking the launch
counters and the accuracy against the scene's ground truth; then times each
kernel beside its plain version and its bound. Imports nothing of JAX.

Exits non-zero, printing no result, when CUDA is absent or any phase fails.
The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel measurements as JSON. ``--out`` also writes everything
measured to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HARDEN = dict(noise_sigma=0.01, vignette=0.15, n_textureless=3, n_spheres=2)
CAM_640 = dict(fx=481.2, fy=-480.0, cx=319.5, cy=239.5)
CAM_720 = dict(fx=962.4, fy=-960.0, cx=639.5, cy=359.5)
# over_table row of the JAX package's EVAL.json and the bounds held here
OVER_TABLE = dict(converged_pct=68.3, within_raw=0.936, within_denoised=0.980)
HD_ROW = dict(converged_pct=64.8, within_raw=0.906)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

KERNELS = {
    "sweep": dict(source="rpg_open_remode_tpu_torch/csrc/sweep.cu",
                  replaces="rpg_open_remode_tpu/ops/sweep_pallas.py:86"),
    "resample_rows": dict(source="rpg_open_remode_tpu_torch/csrc/resample.cu",
                          replaces="rpg_open_remode_tpu/ops/warp_pallas.py:73"),
    "resample_cols": dict(source="rpg_open_remode_tpu_torch/csrc/resample.cu",
                          replaces="rpg_open_remode_tpu/ops/warp_pallas.py:124"),
    "tvl1": dict(source="rpg_open_remode_tpu_torch/csrc/tvl1.cu",
                 replaces="rpg_open_remode_tpu/ops/denoise_pallas.py:36, "
                          "rpg_open_remode_tpu/ops/denoise_pallas.py:177"),
}


def log(*args):
    print(*args, flush=True)


def Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def cuda_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between its
    own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# -- kernel parity -----------------------------------------------------------


def sweep_inputs(torch, dev, rng, h, w, pad, planes):
    ref = rng.random((h, w), dtype=np.float32)
    curr = rng.random((h, w + 2 * pad), dtype=np.float32)
    d = planes // 3
    curr[:, pad - d: pad - d + w] = 0.5 * curr[:, pad - d: pad - d + w] + 0.5 * ref
    valid = np.ones((h, w), np.float32)
    valid[:, :16] = 0.0
    xlim = np.tile(np.array([[-float(pad), w + float(pad)]], np.float32), (h, 1))
    lo = rng.uniform(0, planes - 20, (h, w)).astype(np.float32)
    hi = lo + rng.uniform(1, 30, (h, w)).astype(np.float32)
    lo[: h // 8], hi[: h // 8] = np.inf, -np.inf
    return [torch.tensor(a, device=dev) for a in (curr, xlim, ref, valid, lo, hi)]


def check_sweep(sweep_cuda, args, thr, planes, pad, patch, refine, label, bulk=0.0):
    """found agrees on >= 0.999 of pixels; where both found, disparity within
    1e-3 and NCC within 1e-4 on all but a ``bulk`` fraction of them. Real
    frames need bulk = 1e-3: near-flat (saturated) patches cancel in the
    NCC denominator, and knife-edge ties between distant planes flip, in
    either version's rounding. Returns the max errors where both found."""
    got = sweep_cuda.disparity_sweep(*args, thr, planes, pad, patch, refine)
    want = sweep_cuda.disparity_sweep_plain(*args, thr, planes, pad, patch, refine)
    fk, fp = got[2].cpu().numpy(), want[2].cpu().numpy()
    agree = float((fk == fp).mean())
    both = fk & fp
    d = np.abs(got[0].cpu().numpy() - want[0].cpu().numpy())[both]
    n = np.abs(got[1].cpu().numpy() - want[1].cpu().numpy())[both]
    outside = float(np.mean((d > 1e-3) | (n > 1e-4))) if both.any() else 0.0
    d_err = float(d.max()) if both.any() else 0.0
    n_err = float(n.max()) if both.any() else 0.0
    log(f"  sweep {label}: found agree {agree:.6f} ({int(both.sum())} both), "
        f"max |d disp| {d_err:.3g}, max |d ncc| {n_err:.3g}, "
        f"outside tolerance {outside:.3g} (allowed {bulk:g})")
    if not (agree >= 0.999 and outside <= bulk):
        raise AssertionError(f"sweep kernel disagrees with plain version ({label})")
    return d_err, n_err


def check_resample(torch, resample_cuda, dev, rng, c, hs, w, ho, wo, label):
    img = torch.tensor(rng.random((c, hs, w), dtype=np.float32), device=dev)
    q = torch.tensor(rng.uniform(-2, hs + 2, (ho, w)).astype(np.float32), device=dev)
    mid = resample_cuda.resample_rows(img, q)
    e_rows = float((mid - resample_cuda.resample_rows_plain(img, q)).abs().max())
    u = torch.tensor(rng.uniform(-2, w + 2, (ho, wo)).astype(np.float32), device=dev)
    out = resample_cuda.resample_cols(mid, u)
    e_cols = float((out - resample_cuda.resample_cols_plain(mid, u)).abs().max())
    log(f"  resample {label}: rows max err {e_rows:.3g}, cols max err {e_cols:.3g}")
    if not (e_rows <= 1e-5 and e_cols <= 1e-5):
        raise AssertionError(f"resample kernels disagree with plain versions ({label})")
    return e_rows, e_cols


def check_tvl1(torch, denoise_cuda, cfg, noisy, g, label, iters=200):
    got = denoise_cuda.tvl1(noisy, g, 0.5, iters, cfg)
    want = denoise_cuda.tvl1_plain(noisy, g, 0.5, iters, cfg)
    err = float((got - want).abs().max())
    rng_v = float(noisy.max() - noisy.min())
    log(f"  tvl1 {label} ({iters} it): max err {err:.3g} (bound {1e-5 * rng_v:.3g})")
    if not err <= 1e-5 * rng_v:
        raise AssertionError(f"tvl1 kernel disagrees with plain version ({label})")
    return err


def tvl1_weights(state, cfg):
    from rpg_open_remode_tpu_torch.ops import denoise

    large = state.scene.depth_range ** 2 * cfg.large_sigma_sq_factor
    return denoise.compute_weights(state.a, state.b, state.sigma_sq, large).contiguous()


def kernel_parity(torch, dev, P):
    from rpg_open_remode_tpu_torch.ops import denoise, denoise_cuda, resample_cuda, sweep_cuda
    from rpg_open_remode_tpu_torch.ops.rect_match import rect_shape

    errs = {k: 0.0 for k in KERNELS}
    rng = np.random.default_rng(0)
    for name, (w, h, fx) in {"640x480": (640, 480, 481.2), "1280x720": (1280, 720, 962.4)}.items():
        cfg = P.RemodeConfig.for_camera(fx)
        rh, rw = rect_shape(h, w)
        pad, K, patch = cfg.disp_pad, cfg.num_planes, cfg.patch_side
        log(f" {name}: rect {rh}x{rw}, pad {pad}, planes {K}, patch {patch}")
        args = sweep_inputs(torch, dev, rng, rh, rw, pad, K)
        errs["sweep"] = max(errs["sweep"], *check_sweep(
            sweep_cuda, args, cfg.ncc_threshold, K, pad, patch, True, f"{name} full"))
        pad_h, k_h = pad // 2, min(pad // 2 - 1, K // 2 + 1)
        args = sweep_inputs(torch, dev, rng, rh, rw // 2, pad_h, k_h)
        errs["sweep"] = max(errs["sweep"], *check_sweep(
            sweep_cuda, args, cfg.ncc_threshold, k_h, pad_h, patch, False, f"{name} coarse"))
        for c, hs, ws, ho, wo, lab in [(5, h, w, rh, rw, "ref stack"),
                                       (1, h, w, rh, rw + 2 * pad, "curr"),
                                       (3, rh, rw, h, w, "back-warp")]:
            er, ec = check_resample(torch, resample_cuda, dev, rng, c, hs, ws, ho, wo,
                                    f"{name} {lab}")
            errs["resample_rows"] = max(errs["resample_rows"], er)
            errs["resample_cols"] = max(errs["resample_cols"], ec)
        noisy, a, b, sig = (
            torch.tensor(rng.uniform(lo, hi, (h, w)).astype(np.float32), device=dev)
            for lo, hi in ((1.0, 2.0), (5, 20), (5, 20), (0.001, 0.05)))
        g = denoise.compute_weights(a, b, sig, 1.7 * 1.7 * cfg.large_sigma_sq_factor)
        errs["tvl1"] = max(errs["tvl1"], check_tvl1(torch, denoise_cuda, cfg, noisy, g, name))
    return errs


# -- main path -----------------------------------------------------------------


def accuracy(eng, gt, depth_range, P):
    """eval.py's _accuracy: converged %, within 2.6 % of range raw/denoised."""
    err_bound = 0.026 * depth_range
    conv = eng.convergence_map()
    mu = eng.depthmap()
    interior = np.zeros_like(conv, bool)
    interior[5:-5, 5:-5] = True
    valid_gt = np.isfinite(gt) & interior
    converged = (conv == int(P.ConvergenceState.CONVERGED)) & valid_gt
    err_raw = np.abs(mu - gt)
    out = dict(
        converged_pct=100.0 * converged.sum() / valid_gt.sum(),
        within_raw=float((err_raw[converged] < err_bound).mean()) if converged.any() else float("nan"),
    )
    return out, converged, err_bound


def drive(torch, P, kernels, width, height, cam, n_frames, keep_frame=None):
    """Set the keyframe, run n_frames - 1 updates and the denoise through the
    port's Depthmap with the launch counts zeroed just before and read just
    after. Returns timings, accuracy and the counts."""
    from rpg_open_remode_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    frames = synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam,
                                seed=1, step=0.023, **HARDEN)
    log(f"  generated {n_frames} frames in {time.perf_counter() - t0:.1f} s")
    f0 = frames[0]
    gt = f0.depth
    d0 = gt[np.isfinite(gt)]
    depth_range = float(d0.max() - d0.min())
    eng = P.Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    eng.set_reference_image(f0.image, Tcw(f0), d0.min(), d0.max())
    kept = None
    events = []
    for i, fr in enumerate(frames[1:], 1):
        if i == keep_frame:
            kept = (eng.state, fr.image, Tcw(fr))
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        eng.update(fr.image, Tcw(fr))
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    frame_ms = np.array([s.elapsed_time(e) for s, e in events])
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    den = eng.denoised_depthmap(0.5, 200)
    e.record()
    torch.cuda.synchronize()
    denoise_ms = s.elapsed_time(e)
    launches = dict(kernels.LAUNCHES)
    acc, converged, err_bound = accuracy(eng, gt, depth_range, P)
    acc["within_denoised"] = (float((np.abs(den - gt)[converged] < err_bound).mean())
                              if converged.any() else float("nan"))
    if not np.isfinite(den).all() or not np.isfinite(eng.depthmap()).all():
        raise AssertionError("non-finite depth output")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return dict(eng=eng, kept=kept, frames=n_frames, launches=launches,
                frame_ms_median=float(np.median(frame_ms)),
                frame_ms_p90=float(np.percentile(frame_ms, 90)),
                frame_ms_first=float(frame_ms[0]), denoise_ms=float(denoise_ms),
                accuracy=acc)


def report_run(label, r):
    a = r["accuracy"]
    log(f"  {label}: converged {a['converged_pct']:.4f} %, within 2.6 % raw "
        f"{100 * a['within_raw']:.4f} %, denoised {100 * a['within_denoised']:.4f} %")
    log(f"  {label}: per frame median {r['frame_ms_median']:.3f} ms, p90 "
        f"{r['frame_ms_p90']:.3f} ms (first {r['frame_ms_first']:.3f} ms); "
        f"denoise {r['denoise_ms']:.3f} ms")
    log(f"  {label}: launches {r['launches']}")


def real_input_parity(torch, P, run640):
    """Kernel against plain version on real inputs: one young frame's
    rectification warps (GPU kernels vs the plain path on the CPU) and full
    sweep (kernel vs plain on the card), and the denoise of the final state.
    Returns the young frame's sweep inputs."""
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, rect_match, sweep_cuda
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

    state, img, T = run640["kept"]
    eng = run640["eng"]
    cfg = eng.cfg
    dev = state.mu.device
    cam_cpu = PinholeCamera.create(**{k: float(getattr(eng.cam, k)) for k in ("fx", "fy", "cx", "cy")},
                                   device="cpu")
    st_cpu = P.state_from_numpy(P.state_to_numpy(state), device="cpu")
    out = {}
    for name, st, cam, d in (("cuda", state, eng.cam, dev), ("cpu", st_cpu, cam_cpu, "cpu")):
        img_t = torch.tensor(img, device=d)
        Tcr = se3.compose(torch.tensor(T, device=d), st.T_world_ref)
        out[name] = rect_match.prepare_sweep(st, img_t, Tcr, cam, cfg)
    g, c = out["cuda"], out["cpu"]
    e_ref = float((g["ref_img_r"].cpu() - c["ref_img_r"]).abs().max())
    e_curr = float((g["curr_img_r"].cpu() - c["curr_img_r"]).abs().max())
    log(f"  real frame warps, GPU kernels vs CPU plain: ref max err {e_ref:.3g}, "
        f"curr max err {e_curr:.3g}")
    if not (e_ref <= 1e-4 and e_curr <= 1e-4):
        raise AssertionError("rectification warps disagree on real inputs")
    args = [g[k] for k in ("curr_img_r", "xlim", "ref_img_r", "valid_r", "disp_lo", "disp_hi")]
    check_sweep(sweep_cuda, args, cfg.ncc_threshold, cfg.num_planes, cfg.disp_pad,
                cfg.patch_side, cfg.subplane_refine, "640x480 real frame", bulk=1e-3)
    final = eng.state
    check_tvl1(torch, denoise_cuda, cfg, final.mu.contiguous(), tvl1_weights(final, cfg),
               "640x480 final state")
    return g


# -- kernel timings ------------------------------------------------------------


def sweep_ops(torch, args, planes, pad, patch):
    """Operations this call's data needs: per admitted (pixel, plane) pair
    5 flops per tap plus ~12; per swept pixel 4 flops per template tap."""
    from rpg_open_remode_tpu_torch.ops.sweep_cuda import box_zero

    curr, xlim, ref, valid, lo, hi = args
    area = patch * patch
    st = box_zero(ref, patch)
    denom = area * box_zero(ref * ref, patch) - st * st
    ref_ok = (box_zero((valid > 0.999).float(), patch) > area - 0.5) & (denom > 1e-10)
    klo = torch.clamp(torch.ceil(lo - 0.5), min=0.0)
    khi = torch.clamp(torch.floor(hi + 0.5), max=planes - 1.0)
    x = torch.arange(ref.shape[1], device=ref.device, dtype=torch.float32)[None, :]
    k0 = torch.maximum(klo, torch.ceil(x - xlim[:, 1:2]))
    k1 = torch.minimum(khi, torch.floor(x - xlim[:, 0:1]))
    n_in_band = torch.where(klo <= khi, khi - klo + 1, torch.zeros_like(klo))
    n_full = torch.where(k0 <= k1, k1 - k0 + 1, torch.zeros_like(k0))
    swept = ref_ok & (n_in_band > 0)
    pairs = float(torch.where(swept, n_full, torch.zeros_like(n_full)).sum())
    return pairs * (5 * area + 12) + float(swept.sum()) * 4 * area


def kernel_timings(torch, dev, P, run640, real):
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, resample_cuda, sweep_cuda

    eng = run640["eng"]
    cfg = eng.cfg
    n_updates = run640["frames"] - 1
    rows = {}

    # sweep: the full pass on the young frame's real inputs
    args = [real[k] for k in ("curr_img_r", "xlim", "ref_img_r", "valid_r", "disp_lo", "disp_hi")]
    call = (cfg.ncc_threshold, cfg.num_planes, cfg.disp_pad, cfg.patch_side, cfg.subplane_refine)
    h, w = args[2].shape
    nbytes = 4 * (args[0].numel() + args[1].numel() + 4 * h * w + 2 * h * w) + h * w
    flops = sweep_ops(torch, args, cfg.num_planes, cfg.disp_pad, cfg.patch_side)
    rows["sweep"] = dict(
        ms=cuda_ms(torch, lambda: sweep_cuda.disparity_sweep(*args, *call), 20),
        plain_ms=cuda_ms(torch, lambda: sweep_cuda.disparity_sweep_plain(*args, *call), 3, 1),
        bound=bound(nbytes, flops), work="full pass, frame 10 of over_table (640x480)")

    # resampling: the three calls of one frame at 640x480
    rng = np.random.default_rng(1)
    rh, rw, pad = h, w, cfg.disp_pad
    shapes = [(5, 480, 640, rh, rw), (1, 480, 640, rh, rw + 2 * pad), (3, rh, rw, 480, 640)]
    tot = {k: dict(ms=0.0, plain_ms=0.0, bytes=0.0, flops=0.0)
           for k in ("resample_rows", "resample_cols")}
    for c, hs, ws, ho, wo in shapes:
        img = torch.tensor(rng.random((c, hs, ws), dtype=np.float32), device=dev)
        q = torch.tensor(rng.uniform(0, hs - 1, (ho, ws)).astype(np.float32), device=dev)
        mid = resample_cuda.resample_rows(img, q)
        u = torch.tensor(rng.uniform(0, ws - 1, (ho, wo)).astype(np.float32), device=dev)
        for k, fn, plain, n_in, n_coord, n_out in (
            ("resample_rows", resample_cuda.resample_rows, resample_cuda.resample_rows_plain,
             c * hs * ws, ho * ws, c * ho * ws),
            ("resample_cols", resample_cuda.resample_cols, resample_cuda.resample_cols_plain,
             c * ho * ws, ho * wo, c * ho * wo),
        ):
            a, b = (img, q) if k == "resample_rows" else (mid, u)
            tot[k]["ms"] += cuda_ms(torch, lambda: fn(a, b), 50)
            tot[k]["plain_ms"] += cuda_ms(torch, lambda: plain(a, b), 20)
            tot[k]["bytes"] += 4 * (n_in + n_coord + n_out)
            tot[k]["flops"] += 3 * n_out
    for k, t in tot.items():
        rows[k] = dict(ms=t["ms"], plain_ms=t["plain_ms"], bound=bound(t["bytes"], t["flops"]),
                       work="the 3 calls of one 640x480 frame (ref stack, curr, back-warp)")

    # tvl1: one 200-iteration solve on the run's final state
    g = tvl1_weights(eng.state, cfg)
    mu = eng.state.mu.contiguous()
    hh, ww = mu.shape
    rows["tvl1"] = dict(
        ms=cuda_ms(torch, lambda: denoise_cuda.tvl1(mu, g, 0.5, 200, cfg), 5),
        plain_ms=cuda_ms(torch, lambda: denoise_cuda.tvl1_plain(mu, g, 0.5, 200, cfg), 2, 1),
        bound=bound(4 * 3 * hh * ww, 200 * 28 * hh * ww), work="200 iterations at 640x480")

    for k, r in rows.items():
        r["launches"] = run640["launches"][k]
        r["launches_per_frame"] = r["launches"] / n_updates
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the measurements to this JSON file")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import rpg_open_remode_tpu_torch as P
    from rpg_open_remode_tpu_torch import kernels

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("== card")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, devices {torch.cuda.device_count()}")

    log("== build")
    kernels.library()
    log(f"kernels built and loaded in {kernels.build_seconds:.2f} s")

    log("== kernel parity (numpy-seeded inputs, main-path shapes)")
    errs = kernel_parity(torch, dev, P)

    log("== main path 640x480 (over_table: 200 frames, one keyframe, denoise)")
    run640 = drive(torch, P, kernels, 640, 480, CAM_640, 200, keep_frame=10)
    report_run("640x480", run640)
    a = run640["accuracy"]
    if not (abs(a["converged_pct"] - OVER_TABLE["converged_pct"]) <= 1.5
            and a["within_raw"] >= 0.925 and a["within_denoised"] >= 0.970):
        raise AssertionError(f"640x480 accuracy outside the bounds: {a}")
    log(f"  within bounds of the JAX over_table row {OVER_TABLE}")

    log("== kernel parity (real inputs of frame 10)")
    real = real_input_parity(torch, P, run640)

    log("== main path 1280x720 (80 frames, focal-scaled config, denoise)")
    run720 = drive(torch, P, kernels, 1280, 720, CAM_720, 80)
    report_run("1280x720", run720)
    log(f"  beside the JAX hd_1280x720 row {HD_ROW}")

    log("== kernel timings (640x480 main-path shapes)")
    rows = kernel_timings(torch, dev, P, run640, real)
    out = []
    for k, r in rows.items():
        log(f"  {k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}), {r['launches_per_frame']:.2f} "
            f"launches per frame; {r['work']}; no single PyTorch call computes it")
        out.append(dict(name=k, route="cuda", **KERNELS[k], launches=r["launches"],
                        max_abs_err=errs[k], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None))
    log(f"== total {time.perf_counter() - t_start:.1f} s")
    if opts.out:
        keep = ("frames", "launches", "frame_ms_median", "frame_ms_p90", "frame_ms_first",
                "denoise_ms", "accuracy")
        with open(opts.out, "w") as f:
            json.dump(dict(card=smi, build_s=kernels.build_seconds, kernels=out,
                           run640={k: run640[k] for k in keep},
                           run720={k: run720[k] for k in keep},
                           work={k: r["work"] for k, r in rows.items()}), f, indent=1)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
