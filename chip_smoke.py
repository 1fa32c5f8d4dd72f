#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--baseline DIR]

Builds the CUDA kernels of ``rpg_open_remode_tpu_torch/csrc`` and checks each
against its plain PyTorch version at the main path's shapes (numpy-seeded,
ragged-band and edge-case inputs); drives the single-keyframe engine
through ``Depthmap`` at 640x480 (the hardened ``over_table`` protocol: 200
frames, one keyframe, a 200-iteration denoise) and at 1280x720 (80 frames,
focal-scaled config), checking the launch counters and the accuracy against
the scene's ground truth. The 640x480 run keeps the kernel inputs of frame
10 (the full sweep, three warps) and of the last earlier frame that runs the
coarse sweep; each kernel is held bit for bit against its plain version and
timed on those. A replay of the 640x480 run under ``torch.profiler`` sums
each kernel's device time and the device's busy share; it also keeps every
sweep call's inputs, and afterwards each call's work, bound and lane use
(measured by the sweep kernel's counting build) are added up over the run.

``--baseline DIR`` also builds the kernels of another checkout's
``rpg_open_remode_tpu_torch/csrc`` (for example the parent commit, unpacked
with ``git archive``) in a temporary directory, times both versions on the
same inputs in turns (old, new, new, old), and profiles a replay with each.
Imports nothing of JAX.

Exits non-zero, printing no result, when CUDA is absent or any phase fails.
The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel measurements as JSON. ``--out`` also writes everything
measured to a JSON file.
"""

from __future__ import annotations

import os

# The synthetic scene renders its frames in threads; OpenBLAS's own threads
# would contend with them on the skinny [pixels, 3] x [3, 48] texture
# products, which give the same bits on one thread. Set before numpy loads
# OpenBLAS.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HARDEN = dict(noise_sigma=0.01, vignette=0.15, n_textureless=3, n_spheres=2)
CAM_640 = dict(fx=481.2, fy=-480.0, cx=319.5, cy=239.5)
CAM_720 = dict(fx=962.4, fy=-960.0, cx=639.5, cy=359.5)
# over_table row of the JAX package's EVAL.json and the bounds held here
OVER_TABLE = dict(converged_pct=68.3, within_raw=0.936, within_denoised=0.980)
HD_ROW = dict(converged_pct=64.8, within_raw=0.906)
KEEP_FRAME = 10
# the coarse pass runs only while wide bands cover > 15 % of the rect grid:
# in the 640x480 run on frame 7 but not on frame 10; its inputs are kept
# from the last frame up to KEEP_FRAME that runs it
COARSE_FROM = 3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# warp width; a one-thread-per-pixel sweep runs 32 consecutive x in a warp
WARP = 32

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
# substrings of the device kernels' names in a profiler trace
KERNEL_SYMBOLS = {"sweep": "sweep_kernel", "resample_rows": "resample_rows_kernel",
                  "resample_cols": "resample_cols_kernel", "tvl1": "tvl1_"}
WARP_LABELS = {5: "ref stack", 1: "curr", 3: "back-warp"}


T_START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(title):
    log(f"== {title} (at {time.perf_counter() - T_START:.1f} s)")


def Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def cuda_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between its
    own pair of CUDA events (for the plain versions: many launches each)."""
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


def graph_ms(torch, fn, n=20, reps=7):
    """Device milliseconds per call of a kernel wrapper ``fn``: ``n`` calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA events;
    the median replay over ``n``. The graph keeps the host's launch cost out
    of the time; the inputs stay in L2 from one call to the next, as a
    frame's freshly written tensors do on the main path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times))


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(got, want):
    """Max |got - want| over tensors of one shape; 0 only when they are equal
    bit for bit where finite and NaN at the same places; inf on any other
    NaN or inf mismatch."""
    g, w = got.float(), want.float()
    same = (g == w) | (g.isnan() & w.isnan())
    if bool(same.all()):
        return 0.0
    d = (g - w).abs()[~same]
    return float("inf") if not bool(d.isfinite().all()) else float(d.max())


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


def check_sweep(sweep_cuda, args, thr, planes, pad, patch, refine, label):
    """The kernel equals the plain version bit for bit: disparity, NCC and
    found at every pixel. Returns the max error (0)."""
    got = sweep_cuda.disparity_sweep(*args, thr, planes, pad, patch, refine)
    want = sweep_cuda.disparity_sweep_plain(*args, thr, planes, pad, patch, refine)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    log(f"  sweep {label}: {int(want[2].sum())} found, max err disp {errs[0]:.3g}, "
        f"ncc {errs[1]:.3g}, found {errs[2]:.3g}")
    if max(errs) != 0.0:
        raise AssertionError(f"sweep kernel differs from the plain version ({label})")
    return max(errs)


def check_resample(resample_cuda, kind, img, coord, label):
    """The kernel equals the plain version bit for bit. Returns (max error,
    kernel output)."""
    fn, plain = ((resample_cuda.resample_rows, resample_cuda.resample_rows_plain)
                 if kind == "rows" else
                 (resample_cuda.resample_cols, resample_cuda.resample_cols_plain))
    out = fn(img, coord)
    err = max_err(out, plain(img, coord))
    log(f"  resample_{kind} {label}: max err {err:.3g}")
    if err != 0.0:
        raise AssertionError(f"resample_{kind} kernel differs from the plain version ({label})")
    return err, out


def check_tvl1(torch, denoise_cuda, cfg, noisy, g, label, iters=200):
    """The kernel equals the plain version bit for bit. Returns the max
    error (0)."""
    err = max_err(denoise_cuda.tvl1(noisy, g, 0.5, iters, cfg),
                  denoise_cuda.tvl1_plain(noisy, g, 0.5, iters, cfg))
    log(f"  tvl1 {label} ({iters} it): max err {err:.3g}")
    if err != 0.0:
        raise AssertionError(f"tvl1 kernel differs from the plain version ({label})")
    return err


def tvl1_weights(state, cfg):
    from rpg_open_remode_tpu_torch.ops import denoise

    large = state.scene.depth_range ** 2 * cfg.large_sigma_sq_factor
    return denoise.compute_weights(state.a, state.b, state.sigma_sq, large).contiguous()


def kernel_parity(torch, dev, P):
    from rpg_open_remode_tpu_torch.ops import denoise, denoise_cuda, resample_cuda, sweep_cuda
    from rpg_open_remode_tpu_torch.ops.rect_match import rect_shape
    from rpg_open_remode_tpu_torch.testing import sweep_cases

    errs = {k: 0.0 for k in KERNELS}
    rng = np.random.default_rng(0)

    def tensors(arrays):
        return [torch.tensor(a, device=dev) for a in arrays]

    for name, (w, h, fx) in {"640x480": (640, 480, 481.2), "1280x720": (1280, 720, 962.4)}.items():
        cfg = P.RemodeConfig.for_camera(fx)
        rh, rw = rect_shape(h, w)
        pad, K, patch, thr = cfg.disp_pad, cfg.num_planes, cfg.patch_side, cfg.ncc_threshold
        log(f" {name}: rect {rh}x{rw}, pad {pad}, planes {K}, patch {patch}")
        pad_h, k_h = pad // 2, min(pad // 2 - 1, K // 2 + 1)
        cases = [
            (sweep_inputs(torch, dev, rng, rh, rw, pad, K), K, pad, True, "full"),
            (sweep_inputs(torch, dev, rng, rh, rw // 2, pad_h, k_h), k_h, pad_h, False, "coarse"),
            (tensors(sweep_cases.ragged_bands(rng, rh, rw, pad, K)), K, pad, True, "ragged full"),
            (tensors(sweep_cases.ragged_bands(rng, rh, rw // 2, pad_h, k_h)), k_h, pad_h, False,
             "ragged coarse"),
            (tensors(sweep_cases.edge_cases(patch)), 127, 128, True, "edge cases"),
            (tensors(sweep_cases.edge_cases(patch)), 127, 128, False, "edge cases, no refine"),
        ]
        for args, k, p, refine, lab in cases:
            errs["sweep"] = max(errs["sweep"], check_sweep(
                sweep_cuda, args, thr, k, p, patch, refine, f"{name} {lab}"))
        for c, hs, ws, ho, wo, lab in [(5, h, w, rh, rw, "ref stack"),
                                       (1, h, w, rh, rw + 2 * pad, "curr"),
                                       (3, rh, rw, h, w, "back-warp")]:
            img = torch.tensor(rng.random((c, hs, ws), dtype=np.float32), device=dev)
            q = torch.tensor(rng.uniform(-2, hs + 2, (ho, ws)).astype(np.float32), device=dev)
            e, mid = check_resample(resample_cuda, "rows", img, q, f"{name} {lab} random q")
            errs["resample_rows"] = max(errs["resample_rows"], e)
            u = torch.tensor(rng.uniform(-2, ws + 2, (ho, wo)).astype(np.float32), device=dev)
            e, _ = check_resample(resample_cuda, "cols", mid, u, f"{name} {lab} random u")
            errs["resample_cols"] = max(errs["resample_cols"], e)
        noisy, a, b, sig = (
            torch.tensor(rng.uniform(lo, hi, (h, w)).astype(np.float32), device=dev)
            for lo, hi in ((1.0, 2.0), (5, 20), (5, 20), (0.001, 0.05)))
        g = denoise.compute_weights(a, b, sig, 1.7 * 1.7 * cfg.large_sigma_sq_factor)
        for iters in (200, 37):  # 37: the last launch runs fewer iterations
            errs["tvl1"] = max(errs["tvl1"], check_tvl1(torch, denoise_cuda, cfg, noisy, g,
                                                        name, iters))
    return errs


# -- main path -----------------------------------------------------------------


@contextlib.contextmanager
def intercept(hook):
    """Call ``hook(kind, args)`` before every sweep ('sweep') and warp pass
    ('rows', 'cols') that the engine makes inside the block (no hook: no
    change). The wrappers themselves are untouched, so their launch counts
    are too."""
    if hook is None:
        yield
        return
    from rpg_open_remode_tpu_torch.ops import rect_match, resample_cuda

    saved = (rect_match.disparity_sweep, resample_cuda.resample_rows,
             resample_cuda.resample_cols)

    def wrap(kind, fn):
        def call(*args):
            hook(kind, args)
            return fn(*args)
        return call

    rect_match.disparity_sweep = wrap("sweep", saved[0])
    resample_cuda.resample_rows = wrap("rows", saved[1])
    resample_cuda.resample_cols = wrap("cols", saved[2])
    try:
        yield
    finally:
        rect_match.disparity_sweep, resample_cuda.resample_rows, \
            resample_cuda.resample_cols = saved


def make_frames(width, height, cam, n_frames, step=0.023):
    from rpg_open_remode_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    frames = synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam,
                                seed=1, step=step, **HARDEN)
    log(f"  generated {n_frames} frames in {time.perf_counter() - t0:.1f} s")
    return frames


def replay(torch, P, frames, cam, kernels=None, events=None, kept=None, hook=None):
    """Set the keyframe on frames[0], update on the rest, denoise. With
    ``kernels`` the launch counts are zeroed just before the keyframe;
    ``events`` collects a pair of CUDA events around every update and the
    denoise (last); ``kept`` (a dict with a ``frame`` index) receives that
    frame's state, image and pose, and, per frame from COARSE_FROM to it,
    every sweep and warp input the engine passes to the kernels; ``hook(i,
    kind, args)`` (not with ``kept``) sees every sweep and warp call of frame
    i. Returns (engine,
    denoised, wall ms from the keyframe to the denoise's end)."""
    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    height, width = f0.image.shape
    eng = P.Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"])
    torch.cuda.synchronize()
    if kernels is not None:
        kernels.reset_launches()
    t0 = time.perf_counter()
    eng.set_reference_image(f0.image, Tcw(f0), d0.min(), d0.max())

    def timed(fn):
        if events is None:
            return fn()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        events.append((s, e))
        return out

    for i, fr in enumerate(frames[1:], 1):
        T = Tcw(fr)
        frame_hook = None if hook is None else (lambda kind, args, i=i: hook(i, kind, args))
        if kept is not None and COARSE_FROM <= i <= kept["frame"]:
            if i == kept["frame"]:
                kept.update(state=eng.state, img=fr.image, T=T)
            calls = kept.setdefault("calls", {}).setdefault(i, [])
            frame_hook = (lambda kind, args: calls.append((kind, args)))
        with intercept(frame_hook):
            timed(lambda: eng.update(fr.image, T))
    den = timed(lambda: eng.denoised_depthmap(0.5, 200))
    torch.cuda.synchronize()
    return eng, den, (time.perf_counter() - t0) * 1e3


def accuracy(eng, den, gt, depth_range, P):
    """eval.py's _accuracy: converged %, within 2.6 % of range raw/denoised
    (``den`` None: raw only, as eval.py's denoise=False)."""
    err_bound = 0.026 * depth_range
    conv = eng.convergence_map()
    mu = eng.depthmap()
    interior = np.zeros_like(conv, bool)
    interior[5:-5, 5:-5] = True
    valid_gt = np.isfinite(gt) & interior
    converged = (conv == int(P.ConvergenceState.CONVERGED)) & valid_gt

    def within(d):
        return float((np.abs(d - gt)[converged] < err_bound).mean()) if converged.any() else float("nan")

    out = dict(converged_pct=100.0 * converged.sum() / valid_gt.sum(), within_raw=within(mu))
    if den is not None:
        out["within_denoised"] = within(den)
    return out


def drive(torch, P, kernels, frames, cam, keep_frame=None):
    """The timed run: the engine through ``Depthmap`` with the launch counts
    zeroed just before and read just after. With ``keep_frame`` it also keeps
    that frame's state and kernel inputs (``replay``). Returns timings,
    accuracy, the counts and what was kept."""
    kept = None if keep_frame is None else dict(frame=keep_frame)
    events = []
    eng, den, wall_ms = replay(torch, P, frames, cam, kernels=kernels, events=events, kept=kept)
    launches = dict(kernels.LAUNCHES)
    times = np.array([s.elapsed_time(e) for s, e in events])
    frame_ms, denoise_ms = times[:-1], float(times[-1])
    gt = frames[0].depth
    d0 = gt[np.isfinite(gt)]
    acc = accuracy(eng, den, gt, float(d0.max() - d0.min()), P)
    if not np.isfinite(den).all() or not np.isfinite(eng.depthmap()).all():
        raise AssertionError("non-finite depth output")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return dict(eng=eng, kept=kept, frames=len(frames), launches=launches, wall_ms=wall_ms,
                frame_ms_median=float(np.median(frame_ms)),
                frame_ms_p90=float(np.percentile(frame_ms, 90)),
                frame_ms_first=float(frame_ms[0]), denoise_ms=denoise_ms,
                accuracy=acc)


def report_run(label, r):
    a = r["accuracy"]
    log(f"  {label}: converged {a['converged_pct']:.4f} %, within 2.6 % raw "
        f"{100 * a['within_raw']:.4f} %, denoised {100 * a['within_denoised']:.4f} %")
    log(f"  {label}: per frame median {r['frame_ms_median']:.3f} ms, p90 "
        f"{r['frame_ms_p90']:.3f} ms (first {r['frame_ms_first']:.3f} ms); "
        f"denoise {r['denoise_ms']:.3f} ms")
    n = r["frames"] - 1
    log(f"  {label}: launches {r['launches']}; per frame "
        + ", ".join(f"{k} {v / n:.2f}" for k, v in r["launches"].items()))


def frame_calls(run):
    """Frame KEEP_FRAME's kernel inputs by role: 'sweep full', and
    ('rows'|'cols', warp label) for its three warps; and 'sweep coarse' from
    the last frame up to it that runs the coarse pass (its number under
    'coarse frame')."""
    kept = run["kept"]["calls"]
    out = {}
    for kind, args in kept[KEEP_FRAME]:
        if kind == "sweep":
            out["sweep full" if args[10] else "sweep coarse"] = args
        else:
            out[(kind, WARP_LABELS[args[0].shape[0]])] = args
    coarse = [(i, args) for i in sorted(kept) for kind, args in kept[i]
              if kind == "sweep" and not args[10]]
    if "sweep full" not in out or not coarse:
        raise AssertionError(f"frames {COARSE_FROM}-{KEEP_FRAME} ran no coarse or no full sweep")
    out["coarse frame"], out["sweep coarse"] = coarse[-1]
    log(f"  full pass and warps of frame {KEEP_FRAME}; coarse pass of frame "
        f"{out['coarse frame']}, the last up to {KEEP_FRAME} that runs it")
    return out


def real_input_parity(torch, P, run640, calls):
    """Kernel against plain version, bit for bit, on frame KEEP_FRAME's own
    kernel inputs (both sweep passes, the three warps' passes); its
    rectification warps on the card against the plain path on the CPU; the
    denoise of the final state."""
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, rect_match, resample_cuda, sweep_cuda
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

    errs = {k: 0.0 for k in KERNELS}
    for key, args in calls.items():
        if key == "coarse frame":
            continue
        if isinstance(key, str):
            frame = KEEP_FRAME if key == "sweep full" else calls["coarse frame"]
            errs["sweep"] = max(errs["sweep"], check_sweep(
                sweep_cuda, args[:6], *args[6:], f"frame {frame} {key.split()[1]} pass"))
        else:
            kind, lab = key
            e, _ = check_resample(resample_cuda, kind, *args, f"frame {KEEP_FRAME} {lab}")
            errs[f"resample_{kind}"] = max(errs[f"resample_{kind}"], e)

    kept, eng = run640["kept"], run640["eng"]
    state, cfg = kept["state"], eng.cfg
    cam_cpu = PinholeCamera.create(**{k: float(getattr(eng.cam, k)) for k in ("fx", "fy", "cx", "cy")},
                                   device="cpu")
    st_cpu = P.state_from_numpy(P.state_to_numpy(state), device="cpu")
    out = {}
    for name, st, cam, d in (("cuda", state, eng.cam, state.mu.device), ("cpu", st_cpu, cam_cpu, "cpu")):
        img_t = prep_image(torch.as_tensor(np.asarray(kept["img"])).to(d))
        Tcr = se3.compose(torch.tensor(kept["T"], device=d), st.T_world_ref)
        out[name] = rect_match.prepare_sweep(st, img_t, Tcr, cam, cfg)
    g, c = out["cuda"], out["cpu"]
    e_ref = float((g["ref_img_r"].cpu() - c["ref_img_r"]).abs().max())
    e_curr = float((g["curr_img_r"].cpu() - c["curr_img_r"]).abs().max())
    log(f"  frame {KEEP_FRAME} warps, GPU kernels vs CPU plain path: ref max err {e_ref:.3g}, "
        f"curr max err {e_curr:.3g}")
    if not (e_ref <= 1e-4 and e_curr <= 1e-4):
        raise AssertionError("rectification warps disagree on real inputs")
    final = eng.state
    errs["tvl1"] = check_tvl1(torch, denoise_cuda, cfg, final.mu.contiguous(),
                              tvl1_weights(final, cfg), "640x480 final state")
    return errs


# -- work, bounds and lane use ------------------------------------------------------


def sweep_work(torch, args):
    """What one sweep call's data needs. ``pairs``: the (pixel, plane)
    pairs its band, footprint limits and plane cap admit at pixels whose
    reference patch passes the guards; ``flops``/``bytes``: for the bound.
    ``slots_pixel_model``: the lane-slots that a one-thread-per-pixel loop
    (the sweep before its tile-balanced design) takes by a model of its
    schedule, not a measurement (a warp of 32 consecutive x runs as long as
    its longest band)."""
    from rpg_open_remode_tpu_torch.ops.sweep_cuda import box_zero

    curr, xlim, ref, valid, lo, hi, _, planes, _, patch, _ = args
    area = patch * patch
    h, w = ref.shape
    st = box_zero(ref, patch)
    denom = area * box_zero(ref * ref, patch) - st * st
    ref_ok = (box_zero((valid > 0.999).float(), patch) > area - 0.5) & (denom > 1e-10)
    klo = torch.clamp(torch.ceil(lo - 0.5), min=0.0)
    khi = torch.clamp(torch.floor(hi + 0.5), max=planes - 1.0)
    x = torch.arange(w, device=ref.device, dtype=torch.float32)[None, :]
    k0 = torch.maximum(klo, torch.ceil(x - xlim[:, 1:2]))
    k1 = torch.minimum(khi, torch.floor(x - xlim[:, 0:1]))
    zero = torch.zeros_like(klo)
    swept = ref_ok & (klo <= khi)
    n_band = torch.where(swept, khi - klo + 1, zero)
    n_pair = torch.where(swept & (k0 <= k1), k1 - k0 + 1, zero)
    rows = torch.nn.functional.pad(n_band, (0, -(-w // WARP) * WARP - w))
    slots_pixel = float(rows.reshape(h, -1, WARP).amax(-1).sum() * WARP)
    pairs = float(n_pair.sum())
    pixels = float((n_pair > 0).sum())
    nbytes = 4 * (curr.numel() + xlim.numel() + 6 * h * w) + h * w
    return dict(pairs=pairs, pixels=pixels, slots_pixel_model=slots_pixel,
                flops=pairs * (5 * area + 12) + float(swept.sum()) * 4 * area, bytes=nbytes)


def resample_bytes(kind, img, coord):
    c = img.shape[0]
    n_out = c * coord.shape[0] * coord.shape[1]
    return 4 * (img.numel() + coord.numel() + n_out), 3 * n_out


def lane_use(torch, args):
    """The sweep kernel's measured lane use on one call's inputs (its
    counting build): lanes that ran over lane-slots, for the scoring loop and
    for the per-pixel loops; and the model of a one-thread-per-pixel loop
    beside it."""
    from rpg_open_remode_tpu_torch.ops.sweep_cuda import sweep_lanes

    wk = sweep_work(torch, args)
    lanes = sweep_lanes(*args)
    return dict(work=wk, pairs=wk["pairs"], scoring=list(lanes["scoring"]),
                per_pixel=list(lanes["per_pixel"]),
                pixel_loop_model=[wk["pairs"], wk["slots_pixel_model"]])


def share(pair):
    ran, slots = pair
    return ran / slots if slots else float("nan")


def run_work(torch, calls):
    """Sum, over the run's kept calls, each sweep pass's admitted pairs,
    bound and measured lane use, and each warp pass's bound."""
    tot = {k: dict(calls=0, pairs=0.0, bound_ms=0.0, busy_frames=[], scoring=[0, 0],
                   per_pixel=[0, 0], pixel_loop_model=[0.0, 0.0])
           for k in ("sweep full", "sweep coarse")}
    tot.update({k: dict(calls=0, bound_ms=0.0) for k in ("rows", "cols")})
    for i, kind, x in calls:
        if kind == "sweep":
            t = tot["sweep full" if x[10] else "sweep coarse"]
            lu = lane_use(torch, x)
            wk = lu["work"]
            t["pairs"] += wk["pairs"]
            t["bound_ms"] += bound(wk["bytes"], wk["flops"])[0]
            for f in ("scoring", "per_pixel", "pixel_loop_model"):
                t[f] = [a + b for a, b in zip(t[f], lu[f])]
            if wk["pixels"] > 1000:
                t["busy_frames"].append(i)
        else:
            t = tot[kind]
            t["bound_ms"] += bound(*x)[0]
        t["calls"] += 1
    for key in ("sweep full", "sweep coarse"):
        t = tot[key]
        f = t["busy_frames"]
        log(f"  {key}: {t['calls']} calls, {t['pairs']:.4g} pairs, summed bound "
            f"{t['bound_ms']:.4f} ms; {len(f)} calls sweep > 1000 pixels (frames "
            f"{f[0] if f else '-'}-{f[-1] if f else '-'}); lane use measured: scoring loop "
            f"{share(t['scoring']):.3f}, per-pixel loops {share(t['per_pixel']):.3f}; "
            f"one-thread-per-pixel loop by the schedule model (not measured) "
            f"{share(t['pixel_loop_model']):.3f}")
    for key in ("rows", "cols"):
        log(f"  resample_{key}: {tot[key]['calls']} calls, summed bound "
            f"{tot[key]['bound_ms']:.4f} ms")
    return tot


def profile_run(torch, P, frames, cam, label, wall_ms, account=False):
    """Replay the 640x480 run under torch.profiler (CPU and CUDA activity):
    each kernel's summed device ms and launches, and the device's busy share
    (the union of all device activity, over the span from the first to the
    last device event, and over ``wall_ms``, an unprofiled run's wall time).
    With ``account`` the replay also keeps every sweep call's inputs and each
    warp pass's bytes, and ``run_work`` adds them up after the profiler has
    stopped. Returns (profile, engine)."""
    from torch.profiler import ProfilerActivity, profile

    calls = []

    def keep(i, kind, args):
        calls.append((i, kind, args if kind == "sweep" else resample_bytes(kind, *args)))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng, _, _ = replay(torch, P, frames, cam, hook=keep if account else None)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    out = dict(busy_ms=busy / 1e3, span_ms=span / 1e3, wall_ms=wall_ms,
               busy_share_span=busy / span, busy_share_wall=busy / 1e3 / wall_ms, kernels={})
    for k, sym in KERNEL_SYMBOLS.items():
        evs = [e for e in dev_events if sym in e.name]
        out["kernels"][k] = dict(ms=sum(e.time_range.end - e.time_range.start for e in evs) / 1e3,
                                 launches=len(evs))
    log(f"  profile {label}: device busy {out['busy_ms']:.3f} ms = "
        f"{100 * out['busy_share_span']:.2f} % of the profiled span {out['span_ms']:.1f} ms, "
        f"{100 * out['busy_share_wall']:.2f} % of an unprofiled run's wall {wall_ms:.1f} ms")
    for k, r in out["kernels"].items():
        log(f"  profile {label}: {k} {r['ms']:.4f} ms device over {r['launches']} launches")
    if account:
        out["work"] = run_work(torch, calls)
    return out, eng


# -- keyframe lifecycle ---------------------------------------------------------


FAST_STEP = 1.61 / 60.0   # eval.py's fast_motion pace (paper Table I, 60 fps)
# eval.py's keyframe-segment rows of EVAL.json (mean converged % per keyframe,
# mean within 2.6 % of range, raw): held to +-1.5 points converged and at
# most 1.5 points below on within
LIFECYCLE_ROWS = {
    "over_table_lifecycle": dict(frames="over_table", n=198, seg=int(0.5 / 0.023) + 1,
                                 propagate=False, converged_pct=72.9, within=88.7),
    "over_table_lifecycle_propagated": dict(frames="over_table", n=198,
                                            seg=int(0.5 / 0.023) + 1, propagate=True,
                                            converged_pct=75.8, within=85.6),
    "fast_motion": dict(frames="fast_motion", n=190, seg=int(0.5 / FAST_STEP) + 1,
                        propagate=False, converged_pct=33.8, within=91.4),
    "fast_motion_propagated": dict(frames="fast_motion", n=190, seg=int(0.5 / FAST_STEP) + 1,
                                   propagate=True, converged_pct=65.5, within=91.0),
}
KEEP_SWITCH = 2          # the fast_motion_propagated switch whose inputs are kept
PROP_LABEL = "propagated_reseed"


def keyframe_segments(torch, P, frames, cam, seg, propagate, keep_switch=None,
                      reseed_wrap=None):
    """eval.py's eval_keyframe_segments through the port's ``Depthmap``: a
    new keyframe every ``seg`` frames, bounds padded 0.5x / 2.5x, accuracy
    per keyframe without denoise against the GT range. ``keep_switch``
    keeps that switch's outgoing state, image, pose and bounds;
    ``reseed_wrap()`` is a context around every switch after the first.
    Returns (mean converged %, mean within %, keyframes), kept."""
    h, w = frames[0].image.shape
    cfg = P.RemodeConfig(propagate_depth=True) if propagate else None
    eng = P.Depthmap(w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"], cfg=cfg)
    per_kf, kept = [], None
    for k, i in enumerate(range(0, len(frames) - seg + 1, seg)):
        gt = frames[i].depth
        d = gt[np.isfinite(gt)]
        bounds = (0.5 * float(d.min()), 2.5 * float(d.max()))
        if k == keep_switch:
            kept = dict(eng=eng, state=eng.state, img=frames[i].image, T=Tcw(frames[i]),
                        bounds=bounds)
        with reseed_wrap() if reseed_wrap and k else contextlib.nullcontext():
            eng.set_reference_image(frames[i].image, Tcw(frames[i]), *bounds)
        for fr in frames[i + 1:i + seg]:
            eng.update(fr.image, Tcw(fr))
        per_kf.append(accuracy(eng, None, gt, float(d.max() - d.min()), P))

    def mean_of(key):
        vals = [a[key] for a in per_kf if np.isfinite(a[key])]
        return float(np.mean(vals)) if vals else float("nan")

    return dict(converged_pct=mean_of("converged_pct"), within=100 * mean_of("within_raw"),
                keyframes=len(per_kf)), kept


def lifecycle_accuracy(torch, P, over_table, fast):
    """The four keyframe-segment rows of EVAL.json on the card. Returns the
    results and the kept fast_motion_propagated switch."""
    out, kept, bad = {}, None, []
    for name, row in LIFECYCLE_ROWS.items():
        t0 = time.perf_counter()
        frames = (over_table if row["frames"] == "over_table" else fast)[:row["n"]]
        keep = KEEP_SWITCH if name == "fast_motion_propagated" else None
        r, k = keyframe_segments(torch, P, frames, CAM_640, row["seg"], row["propagate"],
                                 keep_switch=keep)
        kept = k or kept
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        ok = (abs(r["converged_pct"] - row["converged_pct"]) <= 1.5
              and r["within"] >= row["within"] - 1.5)
        log(f"  {name}: {r['keyframes']} keyframes of {row['seg']} frames, converged per "
            f"keyframe {r['converged_pct']:.4f} %, within 2.6 % {r['within']:.4f} % (EVAL.json "
            f"{row['converged_pct']} / {row['within']}; {'ok' if ok else 'OUTSIDE'}), "
            f"{r['seconds']:.1f} s")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"lifecycle rows outside the EVAL.json bounds: {bad}")
    return out, kept


def propagation(torch, P, kept):
    """Depth propagation on the kept switch: each of its resample calls (C=3,
    full image) against the plain version; one whole propagated reseed timed
    with CUDA events; the reseed's resample calls timed as a CUDA graph
    beside their summed bound and their plain versions; one reseed under the
    profiler for its device launches."""
    from torch.profiler import ProfilerActivity, profile

    from rpg_open_remode_tpu_torch.models import depthmap
    from rpg_open_remode_tpu_torch.models.state import SceneParams
    from rpg_open_remode_tpu_torch.ops import propagate, resample_cuda

    eng = kept["eng"]
    img = eng.input_image(kept["img"])
    T = torch.tensor(kept["T"], device=eng.device)
    scene = SceneParams.create(*kept["bounds"], eng.cfg, device=eng.device)

    def reseed():
        return depthmap._set_reference_propagated(kept["state"], img, T, scene, eng.cam, eng.cfg)

    calls = {"rows": [], "cols": []}
    with intercept(lambda kind, args: calls[kind].append(args)):
        state = reseed()
    h, w = img.shape
    for kind, args in calls.items():
        shapes = {(tuple(a.shape), tuple(c.shape)) for a, c in args}
        if len(args) != propagate.PLANES or shapes != {((3, h, w), (h, w))}:
            raise AssertionError(f"propagation made {len(args)} {kind} calls of {shapes}")
    out = dict(carried_pct=100.0 * float((state.sigma_sq != scene.sigma_sq_max).float().mean()))
    for kind, args in calls.items():
        fn = getattr(resample_cuda, f"resample_{kind}")
        plain = getattr(resample_cuda, f"resample_{kind}_plain")
        err = max(max_err(fn(*a), plain(*a)) for a in args)
        log(f"  {len(args)} resample_{kind} calls (C=3, {h}x{w}) of the reseed: max err {err:.3g}")
        if err != 0.0:
            raise AssertionError(f"resample_{kind} differs from its plain version in propagation")
        nb = sum(resample_bytes(kind, *a)[0] for a in args)
        nf = sum(resample_bytes(kind, *a)[1] for a in args)
        out[f"resample_{kind}"] = dict(
            calls=len(args), max_abs_err=err, bound=bound(nb, nf),
            ms=graph_ms(torch, lambda: [fn(*a) for a in args], n=2, reps=5),
            plain_ms=cuda_ms(torch, lambda: [plain(*a) for a in args], 3, 1))
    out["reseed_ms"] = cuda_ms(torch, reseed, 5, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reseed()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_ops_per_switch"] = len(names)
    out["copies_per_switch"] = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    log(f"  propagated reseed {out['reseed_ms']:.3f} ms (CUDA events), {out['carried_pct']:.2f} % "
        f"of pixels carried; {out['device_ops_per_switch']} device operations per switch "
        f"({out['copies_per_switch']} copies or fills; profiler)")
    for kind in ("rows", "cols"):
        r = out[f"resample_{kind}"]
        log(f"  resample_{kind}, the reseed's {r['calls']} calls: {r['ms']:.4f} ms (CUDA graph; "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]})")
    return out


FENCE_S = 0.002   # idle device time on either side of a fenced reseed


def profile_lifecycle(torch, P, fast):
    """Replay fast_motion_propagated under torch.profiler with each
    propagated reseed in a ``PROP_LABEL`` range, fenced: the device is idle
    for FENCE_S before the range opens and after it closes, and the range
    ends with a synchronization. A device event counts as the reseed's when
    it starts within FENCE_S / 2 of a range, which tolerates that much skew
    between the host's and the device's clocks. Returns per-kernel device
    ms and launches, in the reseeds and over the run, and the device
    operations per switch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    @contextlib.contextmanager
    def fenced():
        torch.cuda.synchronize()
        time.sleep(FENCE_S)
        with record_function(PROP_LABEL):
            yield
            torch.cuda.synchronize()
        time.sleep(FENCE_S)

    row = LIFECYCLE_ROWS["fast_motion_propagated"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        keyframe_segments(torch, P, fast[:row["n"]], CAM_640, row["seg"], True, reseed_wrap=fenced)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    margin = FENCE_S / 2 * 1e6   # profiler times are in us
    spans = [(e.time_range.start - margin, e.time_range.end + margin) for e in events
             if e.name == PROP_LABEL and e.device_type != cuda]
    dev = [e for e in events if e.device_type == cuda and e.name != PROP_LABEL]
    inside = [e for e in dev if any(s <= e.time_range.start <= t for s, t in spans)]
    out = dict(switches=len(spans), device_ops_per_switch=len(inside) / max(len(spans), 1),
               kernels={})
    for k, sym in KERNEL_SYMBOLS.items():
        row_k = {}
        for where, evs in (("run", dev), ("reseeds", inside)):
            mine = [e for e in evs if sym in e.name]
            row_k[where] = dict(launches=len(mine), ms=sum(
                e.time_range.end - e.time_range.start for e in mine) / 1e3)
        out["kernels"][k] = row_k
        log(f"  profile fast_motion_propagated: {k} {row_k['run']['ms']:.4f} ms over "
            f"{row_k['run']['launches']} launches, of which the {len(spans)} reseeds "
            f"{row_k['reseeds']['ms']:.4f} ms over {row_k['reseeds']['launches']}")
    log(f"  profile fast_motion_propagated: {out['device_ops_per_switch']:.1f} device "
        f"operations per propagated reseed; each resampler launched "
        f"{out['kernels']['resample_rows']['reseeds']['launches']} times in the reseeds "
        f"(by construction {len(spans)} x 96)")
    return out


@contextlib.contextmanager
def timed_node(torch, rec):
    """Inside the block, CUDA events around every ``DepthmapNode.process_frame``
    and ``Depthmap.set_reference_image`` (``rec['frame']``, ``rec['reseed']``),
    and the host clock around every finalization on the worker thread
    (``rec['finalize_s']``), with the stream it ran on (``rec['streams']``)."""
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode

    saved = (DepthmapNode.process_frame, Depthmap.set_reference_image,
             DepthmapNode._complete_keyframe)

    def events(fn, key):
        def call(self, *args, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(self, *args, **kw)
            e.record()
            rec.setdefault(key, []).append((s, e))
            return out
        return call

    def complete(self, *args):
        rec.setdefault("streams", set()).add(torch.cuda.current_stream().cuda_stream)
        t0 = time.perf_counter()
        saved[2](self, *args)
        rec.setdefault("finalize_s", []).append(time.perf_counter() - t0)

    DepthmapNode.process_frame = events(saved[0], "frame")
    Depthmap.set_reference_image = events(saved[1], "reseed")
    DepthmapNode._complete_keyframe = complete
    try:
        yield
    finally:
        DepthmapNode.process_frame, Depthmap.set_reference_image, \
            DepthmapNode._complete_keyframe = saved


def rotation_to_quat(R):
    """(qx, qy, qz, qw) of a rotation with a positive trace (the synthetic
    camera turns by a few degrees)."""
    tr = float(np.trace(R))
    if tr <= 0:
        raise ValueError("rotation too far from the identity")
    s = 2.0 * np.sqrt(tr + 1.0)
    return ((R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, s / 4)


def write_dataset(root, frames):
    """The reference's on-disk layout (test/dataset.cpp): 8-bit PGM images,
    ASCII-centimetre ``.depth`` files, a sequence file of T_world_curr."""
    (root / "images").mkdir(parents=True)
    (root / "depthmaps").mkdir()
    lines = []
    for i, fr in enumerate(frames):
        name = f"frame_{i:04d}"
        img = np.clip(np.round(fr.image * 255.0), 0, 255).astype(np.uint8)
        h, w = img.shape
        (root / "images" / f"{name}.pgm").write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())
        np.savetxt(root / "depthmaps" / f"{name}.depth", fr.depth * 100.0, fmt="%.4f")
        t, q = fr.T_world_curr[:, 3], rotation_to_quat(fr.T_world_curr[:, :3].astype(np.float64))
        lines.append(" ".join([f"{name}.pgm"] + [f"{v:.9g}" for v in (*t, *q)]))
    (root / "sequence.txt").write_text("\n".join(lines) + "\n")


def cli_run(torch, P, kernels, argv, out_dir, propagate):
    """``cli.main(argv)`` in-process with the launch counts zeroed just
    before and read just after; checks the exit, the exported files, the
    last checkpoint against the node's last keyframe, the worker's stream
    and the counts against the path (TV-L1: 50 a keyframe; each resampler:
    3 an update and 96 a propagated switch). Returns its figures."""
    from rpg_open_remode_tpu_torch import cli
    from rpg_open_remode_tpu_torch.io import load_state
    from rpg_open_remode_tpu_torch.ops import propagate as prop

    rec = {}
    main_stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_node(torch, rec):
        node = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_kf, n_refs, n_frames = len(node.keyframes), len(rec["reseed"]), len(rec["frame"])
    n_updates = n_frames - n_refs
    n_prop = n_refs - 1 if propagate else 0
    per_warp = 3 * n_updates + prop.PLANES * n_prop
    want = dict(resample_rows=per_warp, resample_cols=per_warp, tvl1=50 * n_kf)
    problems = [f"{k}: {launches[k]} launches, want {v}" for k, v in want.items()
                if launches[k] != v]
    if n_kf < 1 or launches["sweep"] < n_updates:
        problems.append(f"{n_kf} keyframes, {launches['sweep']} sweeps for {n_updates} updates")
    if rec.get("streams") != {main_stream}:
        problems.append(f"finalization ran on streams {rec.get('streams')}, not {main_stream}")
    stems = [out_dir / f"kf_{i:03d}" for i in range(n_kf)]
    suffixes = ("_depth.npy", "_cloud.ply", "_convergence.png", "_state.npz")
    missing = [str(s) + x for s in stems for x in suffixes if not Path(str(s) + x).is_file()]
    if not (out_dir / "global_map.ply").is_file():
        missing.append("global_map.ply")
    if missing:
        problems.append(f"missing exports {missing}")
    else:
        last = load_state(str(stems[-1]) + "_state.npz", device="cuda")
        want_state = node.keyframes[-1].state
        differ = [f.name for f in dataclasses.fields(last) if f.name != "scene" and not torch.equal(
            getattr(last, f.name), getattr(want_state, f.name))]
        differ += [f"scene.{f.name}" for f in dataclasses.fields(last.scene) if not torch.equal(
            getattr(last.scene, f.name), getattr(want_state.scene, f.name))]
        if differ:
            problems.append(f"the last checkpoint differs from the last keyframe in {differ}")
    ms = np.array([s.elapsed_time(e) for s, e in rec["frame"]])
    reseed_ms = np.array([s.elapsed_time(e) for s, e in rec["reseed"]])
    r = dict(frames=n_frames, keyframes=n_kf, updates=n_updates, switches=n_refs - 1,
             launches=launches, wall_s=wall, frame_ms_median=float(np.median(ms)),
             frame_ms_p90=float(np.percentile(ms, 90)),
             switch_ms_median=float(np.median(reseed_ms[1:])) if n_refs > 1 else float("nan"),
             finalize_ms_median=1e3 * float(np.median(rec["finalize_s"])),
             converged_pct=[k.converged_percentage for k in node.keyframes])
    log(f"  {n_frames} frames, {n_kf} keyframes, {n_refs - 1} switches "
        f"({'propagated' if propagate else 'flat'}), {wall:.1f} s; launches {launches} "
        f"(want {want}); per frame median {r['frame_ms_median']:.3f} ms, p90 "
        f"{r['frame_ms_p90']:.3f} ms; switch median {r['switch_ms_median']:.3f} ms; "
        f"finalization on the worker thread median {r['finalize_ms_median']:.1f} ms "
        f"(TV-L1, download, exports)")
    if problems:
        raise AssertionError("; ".join(problems))
    return r


def host_io_timing(native, root, cloud):
    """The host IO of a dataset run and of a keyframe's export: the depth
    parse per frame of the on-disk dataset on both backends (median ms over
    its first 10 frames; the values must be equal) and the share of a busy
    Python loop on this thread that survives while a second thread parses
    those files, as the prefetcher's thread does beside the frame loop
    (ctypes releases the GIL for the native call; the numpy version's split
    holds it); beside them the numpy PGM read per frame and the numpy PLY
    write of the keyframe cloud ``cloud`` (median of 5, the same bytes)."""
    depths = sorted((root / "depthmaps").glob("*.depth"))[:10]
    images = sorted((root / "images").glob("*.pgm"))[:10]
    raw = cloud.read_bytes()
    pts = np.frombuffer(raw[raw.index(b"end_header\n") + 11:], "<f4").reshape(-1, 4)
    h, w = native.read_pgm(str(images[0])).shape
    backends = dict(numpy=native.parse_float_file_numpy)
    if native.backend() == "native":
        backends["native"] = native.parse_float_file

    def spin(thread):
        n, t0 = 0, time.perf_counter()
        thread.start()
        while thread.is_alive():
            n += 1
        return n / (time.perf_counter() - t0)

    def median_ms(fn, args):
        times = []
        for a in args:
            t0 = time.perf_counter()
            fn(*a)
            times.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(times))

    target = cloud.parent / "host_io.ply"
    out = dict(pgm_ms=median_ms(native.read_pgm, [(str(im),) for im in images]),
               ply_ms=median_ms(native.write_ply, [(str(target), pts[:, :3], pts[:, 3])] * 5))
    if target.read_bytes() != raw:
        raise AssertionError("the PLY writer wrote other bytes for the same cloud")
    log(f"  host IO (numpy): PGM read {out['pgm_ms']:.3f} ms per {w}x{h} frame, PLY write "
        f"{out['ply_ms']:.3f} ms for {pts.shape[0]} points")
    alone = spin(threading.Thread(target=time.sleep, args=(0.5,)))
    got = {}
    for name, parse in backends.items():
        args = [(str(d), h * w, 0.01) for d in depths]
        r = dict(parse_ms=median_ms(parse, args),
                 loop_share=spin(threading.Thread(target=lambda: [parse(*a) for a in args]))
                 / alone)
        got[name] = [parse(*a) for a in args[-1:]]
        out[name] = r
        log(f"  host IO {name}: depth parse {r['parse_ms']:.3f} ms per {w}x{h} frame (median "
            f"of {len(depths)}); a Python loop beside a parsing thread keeps "
            f"{r['loop_share']:.3f} of its rate")
    if "native" in got and not np.array_equal(got["native"][0], got["numpy"][0]):
        raise AssertionError("the native and numpy depth parses disagree")
    return out


def cli_phase(torch, P, kernels, over_table):
    """The CLI as a user starts it: the synthetic run with propagation, map,
    checkpoints and convergence overlays, then a run on an on-disk dataset
    written from the first 40 over_table frames."""
    from rpg_open_remode_tpu_torch import native

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        out = {}
        log("  run --synthetic --frames 200 --propagate --map-voxel 0.01 --checkpoint "
            "--conv-every 10")
        argv = ["--device", "cuda", "run", "--synthetic", "--frames", "200", "--propagate",
                "--map-voxel", "0.01", "--checkpoint", "--conv-every", "10",
                "--out", str(tmp / "synthetic")]
        out["synthetic"] = cli_run(torch, P, kernels, argv, tmp / "synthetic", True)
        if not (tmp / "synthetic" / "conv_latest.png").is_file():
            raise AssertionError("--conv-every wrote no conv_latest.png")
        t0 = time.perf_counter()
        write_dataset(tmp / "dataset", over_table[:40])
        log(f"  wrote a 40-frame dataset in {time.perf_counter() - t0:.1f} s; host IO "
            f"backend: {native.backend()}")
        last_cloud = tmp / "synthetic" / f"kf_{out['synthetic']['keyframes'] - 1:03d}_cloud.ply"
        out["host_io"] = host_io_timing(native, tmp / "dataset", last_cloud)
        argv = ["--device", "cuda", "run", "--data-path", str(tmp / "dataset"), "--sequence",
                "sequence.txt", "--checkpoint", "--out", str(tmp / "dataset_out")]
        out["dataset"] = cli_run(torch, P, kernels, argv, tmp / "dataset_out", False)
        out["native_backend"] = native.backend()
    return out


# -- kernel timings ------------------------------------------------------------


def kernel_timings(torch, dev, P, run640, run720, calls):
    """Each kernel's time on frame KEEP_FRAME's own inputs (and the warps' on
    random coordinates too), beside its plain version and its bound; TV-L1
    also on the 1280x720 run's final state (the shapes of the tiled Pallas
    kernel, row 5)."""
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, resample_cuda, sweep_cuda

    eng = run640["eng"]
    cfg = eng.cfg
    rows = {}
    for key in ("sweep full", "sweep coarse"):
        args = calls[key]
        lu = lane_use(torch, args)
        wk = lu["work"]
        rows[key] = dict(
            ms=graph_ms(torch, lambda: sweep_cuda.disparity_sweep(*args)),
            plain_ms=cuda_ms(torch, lambda: sweep_cuda.disparity_sweep_plain(*args), 3, 1),
            bound=bound(wk["bytes"], wk["flops"]), lanes=lu,
            work=f"{key.split()[1]} pass, frame "
            f"{KEEP_FRAME if key == 'sweep full' else calls['coarse frame']} of over_table")

    rng = np.random.default_rng(1)
    for kind in ("rows", "cols"):
        fn = getattr(resample_cuda, f"resample_{kind}")
        plain = getattr(resample_cuda, f"resample_{kind}_plain")
        t = dict(ms=0.0, ms_random=0.0, plain_ms=0.0, bytes=0.0, flops=0.0, per_call={})
        for lab in WARP_LABELS.values():
            img, coord = calls[(kind, lab)]
            n = img.shape[-2] if kind == "rows" else img.shape[-1]
            rand = torch.tensor(rng.uniform(0, n - 1, tuple(coord.shape)).astype(np.float32),
                                device=dev)
            ms = graph_ms(torch, lambda: fn(img, coord))
            ms_r = graph_ms(torch, lambda: fn(img, rand))
            nb, nf = resample_bytes(kind, img, coord)
            t["per_call"][lab] = dict(ms=ms, ms_random=ms_r, bound_ms=bound(nb, nf)[0])
            t["ms"] += ms
            t["ms_random"] += ms_r
            t["plain_ms"] += cuda_ms(torch, lambda: plain(img, coord), 20)
            t["bytes"] += nb
            t["flops"] += nf
        rows[f"resample_{kind}"] = dict(
            ms=t["ms"], ms_random=t["ms_random"], plain_ms=t["plain_ms"],
            bound=bound(t["bytes"], t["flops"]), per_call=t["per_call"],
            work=f"the 3 calls of frame {KEEP_FRAME} (ref stack, curr, back-warp)")

    g = tvl1_weights(eng.state, cfg)
    mu = eng.state.mu.contiguous()
    hh, ww = mu.shape
    rows["tvl1"] = dict(
        ms=graph_ms(torch, lambda: denoise_cuda.tvl1(mu, g, 0.5, 200, cfg), n=2, reps=5),
        plain_ms=cuda_ms(torch, lambda: denoise_cuda.tvl1_plain(mu, g, 0.5, 200, cfg), 2, 1),
        bound=bound(4 * 3 * hh * ww, 200 * 28 * hh * ww), work="200 iterations at 640x480")
    e720 = run720["eng"]
    g720, mu720 = tvl1_weights(e720.state, e720.cfg), e720.state.mu.contiguous()
    h7, w7 = mu720.shape
    rows["tvl1 1280x720"] = dict(
        ms=graph_ms(torch, lambda: denoise_cuda.tvl1(mu720, g720, 0.5, 200, e720.cfg), n=2, reps=5),
        plain_ms=cuda_ms(torch, lambda: denoise_cuda.tvl1_plain(mu720, g720, 0.5, 200, e720.cfg),
                         2, 1),
        bound=bound(4 * 3 * h7 * w7, 200 * 28 * h7 * w7),
        work="200 iterations at 1280x720 (the tiled Pallas kernel's shapes)")
    for k, r in rows.items():
        extra = ""
        if "lanes" in r:
            lu = r["lanes"]
            extra = (f", {lu['pairs']:.4g} pairs; lane use measured: scoring loop "
                     f"{share(lu['scoring']):.3f}, per-pixel loops {share(lu['per_pixel']):.3f}; "
                     f"one-thread-per-pixel loop by the schedule model (not measured) "
                     f"{share(lu['pixel_loop_model']):.3f}")
        if "ms_random" in r:
            extra = f", random coordinates {r['ms_random']:.4f} ms"
        log(f"  {k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}){extra}; {r['work']}")
    return rows


def baseline_library(kernels, csrc, build_dir):
    """Build and load the kernels of another checkout's ``csrc`` behind the
    C interface that this package's wrappers call. A ``remode_tvl1`` that
    reports no launch count (the older interface: one launch per
    iteration) gets a shim that reports ``iterations``."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(kernels.build(csrc, build_dir)))
    counts = "int* launches" in (csrc / "tvl1.cu").read_text()
    signatures = {
        "remode_sweep": [P] * 9 + [I] * 5 + [F, I, P],
        "remode_resample_rows": [P] * 3 + [I] * 4 + [P],
        "remode_resample_cols": [P] * 3 + [I] * 4 + [P],
        "remode_tvl1": [P] * 10 + [I] * 3 + [F] * 4 + [P] * (2 if counts else 1),
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    tvl1 = lib.remode_tvl1
    if not counts:
        def tvl1(*args):
            *rest, launches, stream = args
            launches.contents.value = rest[12]
            return lib.remode_tvl1(*rest, stream)
    return types.SimpleNamespace(
        remode_sweep=lib.remode_sweep, remode_resample_rows=lib.remode_resample_rows,
        remode_resample_cols=lib.remode_resample_cols, remode_tvl1=tvl1)


@contextlib.contextmanager
def with_library(kernels, lib):
    """Route the package's kernel wrappers through ``lib`` inside the block."""
    saved = kernels.library()
    kernels._lib = lib
    try:
        yield
    finally:
        kernels._lib = saved


def baseline_compare(torch, P, kernels, baseline_dir, calls, frames, run640, run720):
    """Build another checkout's kernels; time both versions on frame
    KEEP_FRAME's inputs (and TV-L1 on the final state of each run) and the
    per-frame median of the 640x480 run in turns (old, new, new, old), and
    profile a replay with each. The profiled replays' depth maps must agree
    bit for bit, since both versions equal the plain ones."""
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, resample_cuda, sweep_cuda

    csrc = Path(baseline_dir) / "rpg_open_remode_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = dict(old=baseline_library(kernels, csrc, Path(tmp)), new=kernels.library())
        log(f"  baseline kernels from {csrc} built in {time.perf_counter() - t0:.2f} s")
        cases = {
            "sweep full": lambda: sweep_cuda.disparity_sweep(*calls["sweep full"]),
            "sweep coarse": lambda: sweep_cuda.disparity_sweep(*calls["sweep coarse"]),
        }
        rng = np.random.default_rng(2)
        for kind in ("rows", "cols"):
            fn = getattr(resample_cuda, f"resample_{kind}")
            for lab in WARP_LABELS.values():
                img, coord = calls[(kind, lab)]
                n = img.shape[-2] if kind == "rows" else img.shape[-1]
                rand = torch.tensor(rng.uniform(0, n - 1, tuple(coord.shape)).astype(np.float32),
                                    device=coord.device)
                cases[f"{kind} {lab}"] = (lambda f=fn, a=img, b=coord: f(a, b))
                cases[f"{kind} {lab} random"] = (lambda f=fn, a=img, b=rand: f(a, b))
        for size, run in (("640x480", run640), ("1280x720", run720)):
            eng = run["eng"]
            g, mu = tvl1_weights(eng.state, eng.cfg), eng.state.mu.contiguous()
            cases[f"tvl1 200 iterations {size}"] = (
                lambda g=g, mu=mu, cfg=eng.cfg: denoise_cuda.tvl1(mu, g, 0.5, 200, cfg))
        out = {}
        for name, fn in cases.items():
            t = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                with with_library(kernels, libs[which]):
                    t[which].append(graph_ms(torch, fn, *((2, 5) if "tvl1" in name else ())))
            out[name] = {k: float(np.mean(v)) for k, v in t.items()}
            log(f"  {name}: old {out[name]['old']:.4f} ms, new {out[name]['new']:.4f} ms "
                f"(each the mean of two turns: {t['old']} / {t['new']})")
        frame_ms = {"old": [], "new": []}
        wall = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            events = []
            with with_library(kernels, libs[which]):
                wall[which].append(replay(torch, P, frames, CAM_640, events=events)[2])
            frame_ms[which].append(float(np.median([s.elapsed_time(e) for s, e in events[:-1]])))
        log(f"  640x480 per-frame median, in turns: old {frame_ms['old']} ms, "
            f"new {frame_ms['new']} ms")
        profiles = {}
        depth = {}
        for which, lib in libs.items():
            with with_library(kernels, lib):
                profiles[which], eng = profile_run(torch, P, frames, CAM_640, f"{which} kernels",
                                                   float(np.mean(wall[which])))
            depth[which] = eng.depthmap()
        same = bool(np.array_equal(depth["old"], depth["new"], equal_nan=True))
        log(f"  old and new kernels give the same depth map bit for bit: {same}")
        if not same:
            raise AssertionError("the old and new kernels' runs differ")
    return dict(timings=out, frame_ms=frame_ms, profiles=profiles)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the measurements to this JSON file")
    parser.add_argument("--baseline", help="a checkout whose kernels to time beside these")
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
    phase("card")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, devices {torch.cuda.device_count()}")

    phase("build")
    kernels.library()
    log(f"kernels built and loaded in {kernels.build_seconds:.2f} s")

    phase("kernel parity (numpy-seeded, ragged-band and edge-case inputs, main-path shapes)")
    errs = kernel_parity(torch, dev, P)

    phase("main path 640x480 (over_table: 200 frames, one keyframe, denoise)")
    frames640 = make_frames(640, 480, CAM_640, 200)
    run640 = drive(torch, P, kernels, frames640, CAM_640, keep_frame=KEEP_FRAME)
    report_run("640x480", run640)
    a = run640["accuracy"]
    if not (abs(a["converged_pct"] - OVER_TABLE["converged_pct"]) <= 1.5
            and a["within_raw"] >= 0.925 and a["within_denoised"] >= 0.970):
        raise AssertionError(f"640x480 accuracy outside the bounds: {a}")
    log(f"  within bounds of the JAX over_table row {OVER_TABLE}")

    phase(f"kernel parity (frame {KEEP_FRAME}'s own kernel inputs)")
    calls = frame_calls(run640)
    for k, e in real_input_parity(torch, P, run640, calls).items():
        errs[k] = max(errs[k], e)

    phase("profiler over a replay of the 640x480 run; work, bounds and lane use of its calls")
    prof, _ = profile_run(torch, P, frames640, CAM_640, "640x480 run", run640["wall_ms"],
                          account=True)
    work = prof.pop("work")

    phase("main path 1280x720 (80 frames, focal-scaled config, denoise)")
    run720 = drive(torch, P, kernels, make_frames(1280, 720, CAM_720, 80), CAM_720)
    report_run("1280x720", run720)
    log(f"  beside the JAX hd_1280x720 row {HD_ROW}")

    phase("keyframe lifecycle accuracy (eval.py's keyframe segments, 640x480, hardened scene)")
    fast = make_frames(640, 480, CAM_640, LIFECYCLE_ROWS["fast_motion"]["n"], step=FAST_STEP)
    life, kept = lifecycle_accuracy(torch, P, frames640, fast)

    phase(f"depth propagation (switch {KEEP_SWITCH} of the fast_motion_propagated run)")
    prop = propagation(torch, P, kept)
    errs["resample_rows"] = max(errs["resample_rows"], prop["resample_rows"]["max_abs_err"])
    errs["resample_cols"] = max(errs["resample_cols"], prop["resample_cols"]["max_abs_err"])
    prop_run = profile_lifecycle(torch, P, fast)
    del kept, fast

    phase("the CLI on the card (cli.main in-process)")
    cli_out = cli_phase(torch, P, kernels, frames640)

    phase(f"kernel timings (frame {KEEP_FRAME} of the 640x480 run; TV-L1 also at 1280x720)")
    rows = kernel_timings(torch, dev, P, run640, run720, calls)

    base = None
    if opts.baseline:
        phase(f"baseline kernels from {opts.baseline}, timed in turns with these")
        base = baseline_compare(torch, P, kernels, opts.baseline, calls, frames640, run640,
                                run720)

    out = []
    for k in KERNELS:
        r = rows["sweep full" if k == "sweep" else k]
        entry = dict(name=k, route="cuda", **KERNELS[k], launches=run640["launches"][k],
                     max_abs_err=errs[k], ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None,
                     run_ms=prof["kernels"][k]["ms"], run_launches=prof["kernels"][k]["launches"])
        if k == "sweep":
            c = rows["sweep coarse"]
            entry.update(lane_efficiency_scoring=share(r["lanes"]["scoring"]),
                         lane_efficiency_per_pixel=share(r["lanes"]["per_pixel"]),
                         ms_coarse=c["ms"], plain_ms_coarse=c["plain_ms"])
        if k.startswith("resample"):
            pr = prop[k]
            entry.update(ms_random_coords=r["ms_random"], launches_per_switch=pr["calls"],
                         ms_switch=pr["ms"], plain_ms_switch=pr["plain_ms"],
                         bound_ms_switch=pr["bound"][0],
                         run_ms_reseeds=prop_run["kernels"][k]["reseeds"]["ms"])
        if k == "tvl1":
            t7 = rows["tvl1 1280x720"]
            entry.update(ms_1280x720=t7["ms"], plain_ms_1280x720=t7["plain_ms"],
                         bound_ms_1280x720=t7["bound"][0])
        entry["launches_lifecycle"] = cli_out["synthetic"]["launches"][k]
        out.append(entry)
    log("  no single PyTorch call computes any of these kernels' functions (library_ms null)")
    log(f"== total {time.perf_counter() - t_start:.1f} s")
    if opts.out:
        keep = ("frames", "launches", "wall_ms", "frame_ms_median", "frame_ms_p90",
                "frame_ms_first", "denoise_ms", "accuracy")

        def plain(x):
            return json.loads(json.dumps(x, default=float))

        with open(opts.out, "w") as f:
            json.dump(plain(dict(
                card=smi, build_s=kernels.build_seconds, kernels=out,
                run640={k: run640[k] for k in keep}, run720={k: run720[k] for k in keep},
                timings=rows, work=work, profile=prof, lifecycle=life, propagation=prop,
                profile_lifecycle=prop_run, cli=cli_out, baseline=base)), f, indent=1)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
