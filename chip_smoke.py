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

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

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


def log(*args):
    print(*args, flush=True)


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


def make_frames(width, height, cam, n_frames):
    from rpg_open_remode_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    frames = synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam,
                                seed=1, step=0.023, **HARDEN)
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
    """eval.py's _accuracy: converged %, within 2.6 % of range raw/denoised."""
    err_bound = 0.026 * depth_range
    conv = eng.convergence_map()
    mu = eng.depthmap()
    interior = np.zeros_like(conv, bool)
    interior[5:-5, 5:-5] = True
    valid_gt = np.isfinite(gt) & interior
    converged = (conv == int(P.ConvergenceState.CONVERGED)) & valid_gt

    def within(d):
        return float((np.abs(d - gt)[converged] < err_bound).mean()) if converged.any() else float("nan")

    return dict(converged_pct=100.0 * converged.sum() / valid_gt.sum(),
                within_raw=within(mu), within_denoised=within(den))


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


# -- kernel timings ------------------------------------------------------------


def kernel_timings(torch, dev, P, run640, calls):
    """Each kernel's time on frame KEEP_FRAME's own inputs (and the warps' on
    random coordinates too), beside its plain version and its bound."""
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
    log("== card")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, devices {torch.cuda.device_count()}")

    log("== build")
    kernels.library()
    log(f"kernels built and loaded in {kernels.build_seconds:.2f} s")

    log("== kernel parity (numpy-seeded, ragged-band and edge-case inputs, main-path shapes)")
    errs = kernel_parity(torch, dev, P)

    log("== main path 640x480 (over_table: 200 frames, one keyframe, denoise)")
    frames640 = make_frames(640, 480, CAM_640, 200)
    run640 = drive(torch, P, kernels, frames640, CAM_640, keep_frame=KEEP_FRAME)
    report_run("640x480", run640)
    a = run640["accuracy"]
    if not (abs(a["converged_pct"] - OVER_TABLE["converged_pct"]) <= 1.5
            and a["within_raw"] >= 0.925 and a["within_denoised"] >= 0.970):
        raise AssertionError(f"640x480 accuracy outside the bounds: {a}")
    log(f"  within bounds of the JAX over_table row {OVER_TABLE}")

    log(f"== kernel parity (frame {KEEP_FRAME}'s own kernel inputs)")
    calls = frame_calls(run640)
    for k, e in real_input_parity(torch, P, run640, calls).items():
        errs[k] = max(errs[k], e)

    log("== profiler over a replay of the 640x480 run; work, bounds and lane use of its calls")
    prof, _ = profile_run(torch, P, frames640, CAM_640, "640x480 run", run640["wall_ms"],
                          account=True)
    work = prof.pop("work")

    log("== main path 1280x720 (80 frames, focal-scaled config, denoise)")
    run720 = drive(torch, P, kernels, make_frames(1280, 720, CAM_720, 80), CAM_720)
    report_run("1280x720", run720)
    log(f"  beside the JAX hd_1280x720 row {HD_ROW}")

    log(f"== kernel timings (frame {KEEP_FRAME} of the 640x480 run)")
    rows = kernel_timings(torch, dev, P, run640, calls)

    base = None
    if opts.baseline:
        log(f"== baseline kernels from {opts.baseline}, timed in turns with these")
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
            entry.update(ms_random_coords=r["ms_random"])
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
                timings=rows, work=work, profile=prof, baseline=base)), f, indent=1)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
