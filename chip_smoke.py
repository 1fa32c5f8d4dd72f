#!/usr/bin/env python3
"""The card's check run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--mesh-only]

It checks and does not time: speed is measured by the benchmark
(``python3 -m benchmark.run --workload <cell> --seed <n>``), one kernel or
phase alone by ``rpg_open_remode_tpu_torch/scripts/``. Imports nothing of
JAX. The phases, in order:

- build: the CUDA kernels of ``rpg_open_remode_tpu_torch/csrc``.
- kernel parity: each kernel bit for bit against its plain PyTorch version
  at the main path's shapes (640x480, 1280x720; numpy-seeded, ragged-band
  and edge-case inputs) and at those of EVAL.json's live and FHD rows
  (752x480; 1920x1080 at patch 15 and 17 with 383 planes).
- main path: the single-keyframe engine through ``Depthmap`` at 640x480
  (the hardened ``over_table`` protocol: 200 frames, one keyframe, a
  200-iteration denoise), its accuracy held to the JAX package's
  over_table row and its launch counts to the path; frame 10's own kernel
  inputs (full sweep, three warps, the pure-rotation warp) and the last
  earlier coarse sweep held bit for bit against the plain versions, and
  its rectification warps against the plain path on the CPU.
- the fused tail (``csrc/seed_update.cu``) and the plane sweep
  (``csrc/planesweep.cu``) bit for bit against their plain versions on
  the main path's own inputs at 640x480 and 752x480; the rectified step's
  head kernels (``csrc/rect_head.cu``) likewise on the lateral stream's
  first updates, with the coarse gate on and off, stragglers and no valid
  rect pixel, and ``rect_match``'s chains against the walk of the plain
  pieces.
- a replay of the 640x480 run under ``torch.profiler``: each kernel's
  launches in the trace held to the launch counts.
- 1280x720 (80 frames), 752x480 and 1920x1080 (12 frames each) through
  ``Depthmap`` at ``for_camera(fx)``: launch counts, and frame 10's warps
  (at 1280x720 and 1920x1080 its head kernels, at 1920x1080 its sweeps and
  the final TV-L1) bit for bit.
- the lens-undistortion path (the 1-D resamplers of ``csrc/resample.cu``).
- graphs: every CUDA graph replay of ``models/programs.py`` bit for bit
  against the eager ``update_step`` it captured, with equal launch counts
  (the 640x480 run, a sequence through all three matcher regimes, whose
  replays are held to their kernels (a rectified update: the head's eight,
  two sweeps, three warps and the tail), the undistortion run, two
  propagated switches, ``update_chunk`` with K = 16, a ring of 4, 1280x720
  and 1920x1080); 54 replayed frames and a replayed
  propagated switch under ``torch.cuda.set_sync_debug_mode("error")``; the
  replayed switch's warp launches in a trace.
- the keyframe lifecycle: eval.py's keyframe-segment rows (through
  ``rpg_open_remode_tpu_torch.eval``) within EVAL.json's bounds;
  propagation's warp calls; the CLI in-process (exports, checkpoint, exact
  launch counts, the finalization's stream) and the host IO backends.
- the concurrent-keyframe ring: four slots bit for bit against four single
  engines, ``MultiKeyframeNode`` at B = 1, 2 and 4, the CLI's ``run
  --keyframes 4 --propagate``, the epipolar-walk oracle against the
  rectified matcher.
- the device mesh (``parallel/``): the sharded step at (1,1,1) (NCCL, one
  rank), (1,2,2) and (2,1,2) (four spawned ranks sharing the card over
  gloo; with four cards a card each over NCCL), replayed against eager and
  against single engines fed alike, the band slabs' kernel calls, the
  sharded TV-L1 and its gather, each program's form, a profiled replay's
  launches, and the CLI's ``run --mesh 2,1,2 --keyframes 2 --propagate``.

``--mesh-only`` runs the card, build and device mesh phases alone and
prints no ``ok`` line: on a machine with four cards every layout runs a
card a rank over NCCL, where each of the mesh's programs must be one CUDA
graph with its collectives captured inside.

Exits non-zero, printing no result, when CUDA is absent or any check
fails. The last line is ``{"ok": true, "device": {...}}``; the line before
it, ``{"checks": {...}}``, holds each check's errors and readings.
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
import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HARDEN = dict(noise_sigma=0.01, vignette=0.15, n_textureless=3, n_spheres=2)
CAM_640 = dict(fx=481.2, fy=-480.0, cx=319.5, cy=239.5)
CAM_720 = dict(fx=962.4, fy=-960.0, cx=639.5, cy=359.5)
CAM_752 = dict(fx=481.2, fy=-480.0, cx=375.5, cy=239.5)   # eval.py's live_752x480 row
# over_table row of the JAX package's EVAL.json and the bounds held here
OVER_TABLE = dict(converged_pct=68.3, within_raw=0.936, within_denoised=0.980)
HD_ROW = dict(converged_pct=64.8, within_raw=0.906)
KEEP_FRAME = 10
# the coarse pass runs only while wide bands cover > 15 % of the rect grid:
# in the 640x480 run on frame 7 but not on frame 10; its inputs are kept
# from the last frame up to KEEP_FRAME that runs it
COARSE_FROM = 3

# substrings of the device kernels' names in a profiler trace
KERNEL_SYMBOLS = {"sweep": "sweep_kernel", "warp": "homography_warp_kernel",
                  "resample_rows": "resample_rows_kernel",
                  "resample_cols": "resample_cols_kernel", "tvl1": "tvl1_",
                  "seed_update": "seed_update_kernel", "planesweep": "planesweep_match_kernel",
                  "classify": "classify_kernel", "rect_geometry": "rect_geometry_kernel",
                  "ref_fruitless": "ref_fruitless_kernel", "ref_bands": "ref_bands_kernel",
                  "rect_bands": "rect_bands_kernel", "rect_rebase": "rect_rebase_kernel",
                  "coarse_narrow": "coarse_narrow_kernel", "back_stack": "back_stack_kernel"}
# the rectified step's head kernels (csrc/rect_head.cu): one launch each a
# rectified update (the coarse pass on: every configuration here)
HEAD_KERNELS = ("classify", "rect_geometry", "ref_fruitless", "ref_bands", "rect_bands",
                "rect_rebase", "coarse_narrow", "back_stack")
# the kernels of the engine's path; the 1-D resamplers run on the
# undistortion path (UNDISTORT)
PATH_KERNELS = ("sweep", "warp", "tvl1", "seed_update")
WARP_LABELS = {5: "ref stack", 1: "curr", 3: "back-warp"}
RECT_WARPS = tuple(WARP_LABELS.values())


T_START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(title):
    log(f"== {title} (at {time.perf_counter() - T_START:.1f} s)")


def Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


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


def warp_call(args):
    """A ``warp_cuda.homography_warp`` call's positional arguments, with the
    defaults filled in: (img, H, out_h, out_w, x0, y0, want_uv)."""
    img, H, ho, wo, *rest = args
    x0, y0, want_uv = list(rest) + [0.0, 0.0, True][len(rest):]
    return img, H, ho, wo, x0, y0, want_uv


def check_warp(args, label):
    """The fused warp kernel equals its plain version bit for bit (the
    image, and u and v where the call asks for them). Returns the max
    error (0)."""
    from rpg_open_remode_tpu_torch.ops import warp_cuda

    call = warp_call(args)
    got = warp_cuda.homography_warp(*call)
    want = warp_cuda.homography_warp_plain(*call[:6])
    err = max(max_err(g, w) for g, w in zip(got, want) if g is not None)
    img, H = call[:2]
    log(f"  warp {label} (C={img.shape[0]}, {tuple(img.shape[1:])} -> {call[2]}x{call[3]}, "
        f"x0 {call[4]}, y0 {call[5]}, {H.shape[0]} homographies): max err {err:.3g}")
    if err != 0.0:
        raise AssertionError(f"warp kernel differs from the plain version ({label})")
    return err


def rect_homographies(rng, p, hs, ws, ho, wo):
    """P rectifying-like homographies from an ``ho x wo`` output grid onto an
    ``hs x ws`` source: scale, a small rotation and perspective, a shift."""
    out = []
    for _ in range(p):
        th = rng.uniform(-0.05, 0.05)
        sx, sy = ws / wo * rng.uniform(0.97, 1.03), hs / ho * rng.uniform(0.97, 1.03)
        out.append([[sx * np.cos(th), -np.sin(th), rng.uniform(-8, 8)],
                    [np.sin(th), sy * np.cos(th), rng.uniform(-8, 8)],
                    [rng.uniform(-2e-5, 2e-5), rng.uniform(-2e-5, 2e-5), 1.0]])
    return np.asarray(out, np.float32)


# homographies whose denominators are exactly 0, -0.0 or below 1e-8 in
# magnitude with either sign: the near-zero guard's both branches in u, v
# and in pass 1 (tests/test_torch_warp_fused.py)
DEGENERATE = np.asarray([
    [[1e-10, 0.0, 0.0], [0.0, 1.0, 0.0], [1e-10, 0.0, -5e-10]],
    [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.125, 0.0, -1.0]],
    [[0.0, 1.0, 2.0], [1.0, 0.0, -1.0], [0.0, -0.0, -0.0]],
], np.float32)


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


# kernel parity sizes: name -> (width, height, fx, for_camera overrides).
# The main path's, and those of EVAL.json's live and FHD rows (patch 5 at
# 752x480, whose width leaves the resamplers a partial last block; patch 15
# with 383 planes at 1920x1080, and its patch-17 row)
MAIN_SIZES = {"640x480": (640, 480, 481.2, {}), "1280x720": (1280, 720, 962.4, {})}
ROW_SIZES = {"752x480": (752, 480, 481.2, {}), "1920x1080": (1920, 1080, 1443.6, {}),
             "1920x1080 p17": (1920, 1080, 1443.6, dict(patch_side=17))}


def kernel_parity(torch, dev, P, sizes):
    """Each kernel against its plain version, bit for bit, at each size's
    shapes: the sweep on numpy-seeded, ragged-band and edge-case inputs (full
    pass and half-width coarse pass), both resamplers on random coordinates
    and the fused warp on random images at the three warps' shapes, TV-L1
    at 200 and 37 iterations (warps and TV-L1 once per image size). Returns
    the max error per kernel (0)."""
    from rpg_open_remode_tpu_torch.ops import denoise, denoise_cuda, resample_cuda, sweep_cuda
    from rpg_open_remode_tpu_torch.ops.rect_match import rect_shape
    from rpg_open_remode_tpu_torch.testing import sweep_cases

    errs = {k: 0.0 for k in KERNEL_SYMBOLS}
    rng = np.random.default_rng(0)
    done = set()

    def tensors(arrays):
        return [torch.tensor(a, device=dev) for a in arrays]

    for name, (w, h, fx, over) in sizes.items():
        cfg = P.RemodeConfig.for_camera(fx, **over)
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
        del cases
        if (w, h) in done:
            continue
        done.add((w, h))
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
            # the fused warp on random images: rectifying-like homographies
            # and the degenerate ones, at the warp's output window
            H = torch.tensor(np.concatenate([rect_homographies(rng, 2, hs, ws, ho, wo),
                                             DEGENERATE]), device=dev)
            x0 = -float(pad) if lab == "curr" else 0.0
            errs["warp"] = max(errs["warp"], check_warp(
                (img, H, ho, wo, x0, 0.0, True), f"{name} {lab} random"))
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
    """Call ``hook(kind, args)`` before every sweep ('sweep'), fused warp
    ('warp') and 1-D resampling pass ('rows', 'cols') that the engine makes
    inside the block (no hook: no change). A coarse sweep whose device gate
    is off (launched, it scores nothing) is 'sweep off'; its gate is read on
    the host, so hooks go with eager steps only. The wrappers themselves are
    untouched, so their launch counts are too. A CUDA graph replay calls no
    wrapper: instrumented runs drive the eager step (``eager_update``)."""
    if hook is None:
        yield
        return
    from rpg_open_remode_tpu_torch.ops import rect_match, resample_cuda, warp_cuda

    targets = ((rect_match, "disparity_sweep", "sweep"), (warp_cuda, "homography_warp", "warp"),
               (resample_cuda, "resample_rows", "rows"), (resample_cuda, "resample_cols", "cols"))
    saved = [getattr(mod, name) for mod, name, _ in targets]

    import torch

    def wrap(kind, fn):
        def call(*args, **kw):
            # a capture's calls launch nothing, and its tensors live in the
            # graph's pool: not shown
            if not torch.cuda.is_current_stream_capturing():
                gate = kw.get("gate")
                hook(kind if gate is None or bool(gate) else "sweep off", args)
            return fn(*args, **kw)
        return call

    for (mod, name, kind), fn in zip(targets, saved):
        setattr(mod, name, wrap(kind, fn))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(targets, saved):
            setattr(mod, name, fn)


def make_frames(width, height, cam, n_frames, step=0.023):
    from rpg_open_remode_tpu_torch.utils import synthetic

    return synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam, seed=1,
                              step=step, **HARDEN)


def eager_update(eng, img, T):
    """``eng.update`` as the eager ``update_step`` on the engine's own state
    buffers, with the regime its programs would choose: the same result and
    launches as a replay, through the Python wrappers (which a replay does
    not call), so ``intercept`` sees every kernel input."""
    import torch

    from rpg_open_remode_tpu_torch.models.depthmap import update_step
    from rpg_open_remode_tpu_torch.models.state import copy_into

    prog = eng.programs
    T32 = np.asarray(T, np.float32)
    new, stats = update_step(prog.state, eng.input_image(img), torch.tensor(T32, device=eng.device),
                             eng.cam, eng.cfg, prog.regime(T32))
    copy_into(prog.state, new)
    return stats


def replay(torch, P, frames, cam, kernels=None, kept=None):
    """Set the keyframe on frames[0], update on the rest, denoise. With
    ``kernels`` the launch counts are zeroed just before the keyframe;
    ``kept`` (a dict with a ``frame`` index) receives that frame's state,
    image and pose, and, per frame from COARSE_FROM to it, every sweep and
    warp input the engine passes to the kernels. The updates are graph
    replays (``Depthmap.update``) except on the frames that ``kept``
    watches, which take ``eager_update``. Returns (engine, denoised)."""
    from rpg_open_remode_tpu_torch.models.state import clone

    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    height, width = f0.image.shape
    eng = P.Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"])
    torch.cuda.synchronize()
    if kernels is not None:
        kernels.reset_launches()
    eng.set_reference_image(f0.image, Tcw(f0), d0.min(), d0.max())
    for i, fr in enumerate(frames[1:], 1):
        T = Tcw(fr)
        frame_hook = None
        if kept is not None and kept.get("first", COARSE_FROM) <= i <= kept["frame"]:
            if i == kept["frame"]:
                # eng.state is the engine's own buffers, which later updates
                # overwrite: ``before`` is a copy of the state this frame
                # updates
                kept.update(state=eng.state, before=clone(eng.state), img=fr.image, T=T)
            calls = kept.setdefault("calls", {}).setdefault(i, [])
            frame_hook = (lambda kind, args: calls.append((kind, args)))
        update = eng.update if frame_hook is None else functools.partial(eager_update, eng)
        with intercept(frame_hook):
            update(fr.image, T)
    den = eng.denoised_depthmap(0.5, 200)
    torch.cuda.synchronize()
    return eng, den


def accuracy(conv, mu, den, gt, depth_range, P):
    """eval.py's _accuracy on a convergence map and depth map: converged %,
    within 2.6 % of range raw/denoised (``den`` None: raw only, as
    eval.py's denoise=False)."""
    err_bound = 0.026 * depth_range
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


def drive(torch, P, kernels, frames, cam, keep_frame=None, first=COARSE_FROM):
    """The engine through ``Depthmap`` with the launch counts zeroed just
    before and read just after, held to the path. With ``keep_frame`` it
    also keeps that frame's state, and the kernel inputs of frames ``first``
    to it (``replay``). Returns the accuracy, the counts and what was
    kept."""
    kept = None if keep_frame is None else dict(frame=keep_frame, first=first)
    eng, den = replay(torch, P, frames, cam, kernels=kernels, kept=kept)
    launches = dict(kernels.LAUNCHES)
    gt = frames[0].depth
    d0 = gt[np.isfinite(gt)]
    acc = accuracy(eng.convergence_map(), eng.depthmap(), den, gt, float(d0.max() - d0.min()), P)
    if not np.isfinite(den).all() or not np.isfinite(eng.depthmap()).all():
        raise AssertionError("non-finite depth output")
    missing = [k for k in PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    # every frame of these sequences takes the rectified matcher: three
    # warps (a pure-rotation frame would make one)
    if launches["warp"] != 3 * (len(frames) - 1):
        raise AssertionError(f"{launches['warp']} warps for {len(frames) - 1} updates")
    if launches["seed_update"] != len(frames) - 1:
        raise AssertionError(f"{launches['seed_update']} fused tails for {len(frames) - 1} "
                             f"updates")
    off = {k: launches[k] for k in HEAD_KERNELS if launches[k] != len(frames) - 1}
    if off:
        raise AssertionError(f"head kernels launched other than once an update: {off}")
    return dict(eng=eng, kept=kept, frames=len(frames), launches=launches, accuracy=acc)


def report_run(label, r):
    a = r["accuracy"]
    log(f"  {label}: converged {a['converged_pct']:.4f} %, within 2.6 % raw "
        f"{100 * a['within_raw']:.4f} %, denoised {100 * a['within_denoised']:.4f} %")
    n = r["frames"] - 1
    log(f"  {label}: launches {r['launches']}; per frame "
        + ", ".join(f"{k} {v / n:.2f}" for k, v in r["launches"].items()))


def frame_calls(run):
    """Frame KEEP_FRAME's kernel inputs by role: 'sweep full', and under
    'warps' its warps (``frame_warps``); and 'sweep coarse' from the last
    frame up to it that runs the coarse pass (its number under 'coarse
    frame')."""
    kept = run["kept"]["calls"]
    out = dict(warps=frame_warps(run))
    for kind, args in kept[KEEP_FRAME]:
        if kind == "sweep":
            out["sweep full" if args[10] else "sweep coarse"] = args
    coarse = [(i, args) for i in sorted(kept) for kind, args in kept[i]
              if kind == "sweep" and not args[10]]
    if "sweep full" not in out or not coarse:
        raise AssertionError(f"frames {min(kept)}-{KEEP_FRAME} ran no coarse or no full sweep")
    out["coarse frame"], out["sweep coarse"] = coarse[-1]
    log(f"  full pass and warps of frame {KEEP_FRAME}; coarse pass of frame "
        f"{out['coarse frame']}, the last up to {KEEP_FRAME} that runs it")
    return out


def frame_warps(run):
    """Label -> arguments of frame KEEP_FRAME's three warps (the rectified
    matcher's: 'ref stack', 'curr', 'back-warp'; no other warp or 1-D pass
    is allowed on the frame), and of 'pure rotation': the warp that the
    pure-rotation matcher makes on that frame's state, image and pose (the
    branch a near-zero baseline takes)."""
    calls = run["kept"]["calls"][KEEP_FRAME]
    out = {WARP_LABELS[args[0].shape[0]]: args for kind, args in calls if kind == "warp"}
    kinds = [kind for kind, _ in calls if not kind.startswith("sweep")]
    if sorted(out) != sorted(RECT_WARPS) or kinds != ["warp"] * 3:
        raise AssertionError(f"frame {KEEP_FRAME} made the calls {kinds}")
    out["pure rotation"] = rotation_warp(run)
    return out


def rotation_warp(run):
    """The arguments of the warp that ``rect_match.match_pure_rotation``
    makes on frame KEEP_FRAME's kept state, image and pose."""
    import torch

    from rpg_open_remode_tpu_torch.ops import rect_match
    from rpg_open_remode_tpu_torch.utils import se3

    kept, eng = run["kept"], run["eng"]
    img = eng.input_image(kept["img"])
    Tcr = se3.compose(torch.tensor(kept["T"], device=img.device), kept["state"].T_world_ref)
    calls = []
    with intercept(lambda kind, args: calls.append((kind, args))):
        rect_match.match_pure_rotation(kept["state"], img, Tcr, eng.cam, eng.cfg)
    warps = [args for kind, args in calls if kind == "warp"]
    if len(warps) != 1:
        raise AssertionError(f"the pure-rotation matcher made {len(warps)} warps")
    return warps[0]


def real_input_parity(torch, P, run640, calls, size="640x480", cpu_check=True):
    """Kernel against plain version, bit for bit, on frame KEEP_FRAME's own
    kernel inputs (both sweep passes, the three warps and the pure-rotation
    warp); with ``cpu_check`` its rectification warps on the card against
    the plain path on the CPU; the denoise of the final state."""
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, rect_match, sweep_cuda
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

    errs = {k: 0.0 for k in KERNEL_SYMBOLS}
    for key in ("sweep full", "sweep coarse"):
        frame = KEEP_FRAME if key == "sweep full" else calls["coarse frame"]
        args = calls[key]
        errs["sweep"] = max(errs["sweep"], check_sweep(
            sweep_cuda, args[:6], *args[6:], f"frame {frame} {key.split()[1]} pass"))
    for lab, args in calls["warps"].items():
        errs["warp"] = max(errs["warp"], check_warp(args, f"{size} frame {KEEP_FRAME} {lab}"))

    kept, eng = run640["kept"], run640["eng"]
    state, cfg = kept["state"], eng.cfg
    final = eng.state
    errs["tvl1"] = check_tvl1(torch, denoise_cuda, cfg, final.mu.contiguous(),
                              tvl1_weights(final, cfg), f"{size} final state")
    if not cpu_check:
        return errs
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
    return errs


# -- the FHD configuration --------------------------------------------------------

FHD_FRAMES = 12


def size_run(torch, P, kernels, label, width, height, cam, n_frames):
    """A short run of the hardened scene at another size through
    ``Depthmap`` at ``for_camera(fx)`` (launch counts zeroed just before,
    read just after, every kernel of the path launched): frame KEEP_FRAME's
    own sweep (full and the last coarse pass) and warp inputs, its
    pure-rotation warp, its head kernels (``run_head``) and the final
    state's TV-L1, held bit for bit against the plain versions. Returns the
    run and the max errors."""
    frames = make_frames(width, height, cam, n_frames)
    run = drive(torch, P, kernels, frames, cam, keep_frame=KEEP_FRAME, first=1)
    run["rendered"] = frames
    cfg = run["eng"].cfg
    log(f"  config for_camera({cam['fx']}): patch {cfg.patch_side}, {cfg.num_planes} "
        f"planes, disp_pad {cfg.disp_pad}")
    report_run(label, run)
    errs = real_input_parity(torch, P, run, frame_calls(run), size=label, cpu_check=False)
    for k, e in run_head(torch, run, label).items():
        errs[k] = max(errs[k], e)
    return run, errs


# -- the profiled replay -------------------------------------------------------


def traced_launches(torch, prof):
    """Each KERNEL_SYMBOLS kernel's launches (device events) in a profiler
    trace."""
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(sym in name for name in names) for k, sym in KERNEL_SYMBOLS.items()}


def profile_run(torch, P, kernels, frames, cam, label):
    """The 640x480 run as ``drive`` runs its updates, each a graph replay,
    under torch.profiler (CPU and CUDA activity), with the launch counts
    zeroed just before and read just after: each kernel's launches in the
    trace must equal them, so the trace shows that the replays launched
    what the counts say. Returns the counts."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay(torch, P, frames, cam, kernels=kernels)
    launches = dict(kernels.LAUNCHES)
    traced = traced_launches(torch, prof)
    log(f"  profile {label}: launches traced (counted) "
        + ", ".join(f"{k} {n} ({launches[k]})" for k, n in traced.items()))
    off = {k: (n, launches[k]) for k, n in traced.items() if n != launches[k]}
    if off:
        raise AssertionError(f"{label}: the trace's launches differ from the counts "
                             f"(traced, counted): {off}")
    return launches


# -- keyframe lifecycle ---------------------------------------------------------


# eval.py's keyframe-segment rows of EVAL.json, run by the port's eval
# (``rpg_open_remode_tpu_torch.eval``) on frames rendered once here: the
# over_table rows on the first 198 of the 640x480 run's 200 frames (the
# renderer's frames do not depend on the sequence length), the fast_motion
# rows on 190 frames at 1.61 m/s and 60 fps. Held, as the eval holds every
# row, to +-1.5 points converged per keyframe and at most 1.5 points below
# on within 2.6 %.
LIFECYCLE_ROWS = ("over_table_lifecycle", "over_table_lifecycle_propagated", "fast_motion",
                  "fast_motion_propagated")
KEEP_SWITCH = 2          # the fast_motion_propagated switch whose inputs are kept


def segment_row(name, over_table, fast, **hooks):
    """One keyframe-segment row through the port's eval on the card, on the
    frames rendered here; ``hooks`` are eval_keyframe_segments' own."""
    from rpg_open_remode_tpu_torch import eval as peval

    fn, kw = peval.rows()[name]
    frames = fast if name.startswith("fast_motion") else over_table
    return fn(**kw, device="cuda", frames=frames[:kw["n_frames"]], **hooks)


def lifecycle_accuracy(torch, P, over_table, fast):
    """The four keyframe-segment rows of EVAL.json on the card. Returns the
    results and the kept fast_motion_propagated switch."""
    from rpg_open_remode_tpu_torch import eval as peval

    out, kept, bad = {}, None, []
    for name in LIFECYCLE_ROWS:
        keep = KEEP_SWITCH if name == "fast_motion_propagated" else None
        r = segment_row(name, over_table, fast, keep_switch=keep)
        kept = r.pop("kept", None) or kept
        ok, line = peval.judge(name, r)
        out[name] = dict(converged_pct=r["mean_converged_pct_per_kf"],
                         within=100 * r["mean_within_2p6pct"], keyframes=r["keyframes"], ok=ok)
        log(f"  {name}: {r['keyframes']} keyframes of {r['updates_per_keyframe'] + 1} frames, "
            f"per keyframe {line}")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"lifecycle rows outside the EVAL.json bounds: {bad}")
    return out, kept


def propagation(torch, P, kept):
    """Depth propagation on the kept switch: the reseed makes one warp call
    a chunk of ``propagate.WARP_CHUNK`` planes (C=3, full image), and each
    is held bit for bit against the plain version. Returns the max
    error."""
    from rpg_open_remode_tpu_torch.models import depthmap
    from rpg_open_remode_tpu_torch.models.state import SceneParams
    from rpg_open_remode_tpu_torch.ops import propagate

    eng = kept["eng"]
    img = eng.input_image(kept["img"])
    T = torch.tensor(kept["T"], device=eng.device)
    scene = SceneParams.create(*kept["bounds"], eng.cfg, device=eng.device)
    calls = []
    with intercept(lambda kind, args: calls.append((kind, args))):
        depthmap._set_reference_propagated(kept["state"], img, T, scene, eng.cam, eng.cfg)
    h, w = img.shape
    warps = [warp_call(args) for kind, args in calls if kind == "warp"]
    n_calls = -(-propagate.PLANES // propagate.WARP_CHUNK)
    shapes = sorted({(tuple(c[0].shape), c[2], c[3]) for c in warps})
    planes = [c[1].shape[0] for c in warps]
    if (len(calls) != n_calls or len(warps) != n_calls or shapes != [((3, h, w), h, w)]
            or sum(planes) != propagate.PLANES):
        raise AssertionError(f"propagation made the calls {[k for k, _ in calls]} of {shapes}, "
                             f"{planes} planes")
    return max(check_warp(c, f"reseed call {k}") for k, c in enumerate(warps))


@contextlib.contextmanager
def watched_node(torch, rec, ring=False):
    """Inside the block, count every ``process_frame`` of the node
    (``DepthmapNode``, or ``MultiKeyframeNode`` with ``ring``) and every
    keyframe seed (``Depthmap.set_reference_image``,
    ``BatchedDepthmap.seed_keyframe``) (``rec['frame']``, ``rec['reseed']``),
    and record the stream every finalization on the worker thread ran on
    (``rec['streams']``)."""
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap
    from rpg_open_remode_tpu_torch.models.multikeyframe import BatchedDepthmap, MultiKeyframeNode
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode, LifecycleNode

    node_cls, (eng_cls, seed) = ((MultiKeyframeNode, (BatchedDepthmap, "seed_keyframe")) if ring
                                 else (DepthmapNode, (Depthmap, "set_reference_image")))
    saved = (node_cls.process_frame, getattr(eng_cls, seed), LifecycleNode._complete_keyframe)
    rec.update(frame=0, reseed=0, streams=set())

    def counted(fn, key):
        def call(self, *args, **kw):
            rec[key] += 1
            return fn(self, *args, **kw)
        return call

    def complete(self, *args):
        rec["streams"].add(torch.cuda.current_stream().cuda_stream)
        saved[2](self, *args)

    node_cls.process_frame = counted(saved[0], "frame")
    setattr(eng_cls, seed, counted(saved[1], "reseed"))
    LifecycleNode._complete_keyframe = complete
    try:
        yield
    finally:
        node_cls.process_frame, LifecycleNode._complete_keyframe = saved[0], saved[2]
        setattr(eng_cls, seed, saved[1])


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


def cli_run(torch, P, kernels, argv, out_dir, propagate, keyframes=1):
    """``cli.main(argv)`` in-process with the launch counts zeroed just
    before and read just after; checks the exit, the exported files, with
    ``--checkpoint`` the last checkpoint against the node's last keyframe,
    the worker's stream and the counts against the path (TV-L1: 50 a
    keyframe; the warp: 3 a slot-update and one a chunk of planes in a
    propagated reseed; the 1-D resamplers: none; the sweep 1 or 2 a
    slot-update). ``keyframes`` > 1: the ring's run. Returns its counts."""
    from rpg_open_remode_tpu_torch import cli
    from rpg_open_remode_tpu_torch.io import load_state
    from rpg_open_remode_tpu_torch.ops import propagate as prop

    rec = {}
    main_stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    kernels.reset_launches()
    with watched_node(torch, rec, ring=keyframes > 1):
        node = cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_kf, n_seeds, n_frames = len(node.keyframes), rec["reseed"], rec["frame"]
    # the first frame seeds every slot, flat; each later seed is a switch
    if keyframes > 1:
        n_updates = (n_frames - 1) * keyframes
    else:
        n_updates = n_frames - n_seeds
    n_switches = n_seeds - keyframes
    per_reseed = -(-prop.PLANES // prop.WARP_CHUNK)
    want = dict(warp=3 * n_updates + per_reseed * (n_switches if propagate else 0),
                resample_rows=0, resample_cols=0, tvl1=50 * n_kf)
    problems = [f"{k}: {launches[k]} launches, want {v}" for k, v in want.items()
                if launches[k] != v]
    if n_kf < 1 or not n_updates <= launches["sweep"] <= 2 * n_updates:
        problems.append(f"{n_kf} keyframes, {launches['sweep']} sweeps for {n_updates} updates")
    if rec["streams"] != {main_stream}:
        problems.append(f"finalization ran on streams {rec['streams']}, not {main_stream}")
    checkpoint = "--checkpoint" in argv
    stems = [out_dir / f"kf_{i:03d}" for i in range(n_kf)]
    suffixes = ("_depth.npy", "_cloud.ply", "_convergence.png") + (
        ("_state.npz",) if checkpoint else ())
    missing = [str(s) + x for s in stems for x in suffixes if not Path(str(s) + x).is_file()]
    if not (out_dir / "global_map.ply").is_file():
        missing.append("global_map.ply")
    if missing:
        problems.append(f"missing exports {missing}")
    elif checkpoint:
        last = load_state(str(stems[-1]) + "_state.npz", device="cuda")
        want_state = node.keyframes[-1].state
        differ = [f.name for f in dataclasses.fields(last) if f.name != "scene" and not torch.equal(
            getattr(last, f.name), getattr(want_state, f.name))]
        differ += [f"scene.{f.name}" for f in dataclasses.fields(last.scene) if not torch.equal(
            getattr(last.scene, f.name), getattr(want_state.scene, f.name))]
        if differ:
            problems.append(f"the last checkpoint differs from the last keyframe in {differ}")
    log(f"  {n_frames} frames, {n_kf} keyframes, {n_switches} switches "
        f"({'propagated' if propagate else 'flat'}); launches {launches} (want {want}, sweep "
        f"{n_updates}-{2 * n_updates}); finalization on the loop's stream")
    if problems:
        raise AssertionError("; ".join(problems))
    return dict(frames=n_frames, keyframes=n_kf, switches=n_switches, launches=launches)


def host_io_parity(native, root, cloud):
    """The host IO backends on a dataset run and a keyframe's export: the
    native depth parse equals the numpy one on the dataset's first 10
    depth files, and the PLY writer writes the keyframe cloud ``cloud``
    again to the same bytes."""
    raw = cloud.read_bytes()
    pts = np.frombuffer(raw[raw.index(b"end_header\n") + 11:], "<f4").reshape(-1, 4)
    target = cloud.parent / "host_io.ply"
    native.write_ply(str(target), pts[:, :3], pts[:, 3])
    if target.read_bytes() != raw:
        raise AssertionError("the PLY writer wrote other bytes for the same cloud")
    if native.backend() != "native":
        log("  host IO: the numpy backend alone (no native library)")
        return
    images = sorted((root / "images").glob("*.pgm"))
    h, w = native.read_pgm(str(images[0])).shape
    depths = sorted((root / "depthmaps").glob("*.depth"))[:10]
    differ = [d.name for d in depths if not np.array_equal(
        native.parse_float_file(str(d), h * w, 0.01),
        native.parse_float_file_numpy(str(d), h * w, 0.01))]
    log(f"  host IO: the native and numpy depth parses equal on {len(depths) - len(differ)} of "
        f"{len(depths)} files; the PLY rewritten to the same bytes")
    if differ:
        raise AssertionError(f"the native and numpy depth parses disagree on {differ}")


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
        write_dataset(tmp / "dataset", over_table[:40])
        log(f"  wrote a 40-frame dataset; host IO backend: {native.backend()}")
        last_cloud = tmp / "synthetic" / f"kf_{out['synthetic']['keyframes'] - 1:03d}_cloud.ply"
        host_io_parity(native, tmp / "dataset", last_cloud)
        argv = ["--device", "cuda", "run", "--data-path", str(tmp / "dataset"), "--sequence",
                "sequence.txt", "--checkpoint", "--out", str(tmp / "dataset_out")]
        out["dataset"] = cli_run(torch, P, kernels, argv, tmp / "dataset_out", False)
        out["native_backend"] = native.backend()
    return out


# -- concurrent-keyframe ring ---------------------------------------------------


RING_SIZES = (1, 2, 4)
RING_EXACT_B, RING_EXACT_FRAMES = 4, 40


def gt_bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


def ring_exactness(torch, P, frames):
    """A ``BatchedDepthmap`` of RING_EXACT_B slots against as many single
    ``Depthmap``s fed alike over RING_EXACT_FRAMES frames: every slot is
    seeded on frame 0 and slot i reseeded flat on frame 10 i. Each slot's
    mu, sigma_sq, a and b must equal its engine's bit for bit, its conv map
    too, and each frame's stats. Returns the max errors."""
    h, w = frames[0].image.shape
    cam = (CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"])
    ring = P.BatchedDepthmap(RING_EXACT_B, w, h, *cam)
    singles = [P.Depthmap(w, h, *cam) for _ in range(RING_EXACT_B)]
    stats_err = 0.0
    for j, fr in enumerate(frames[:RING_EXACT_FRAMES]):
        T = Tcw(fr)
        if j:
            got = ring.update(fr.image, T)["packed"]
            for i, eng in enumerate(singles):
                stats_err = max(stats_err, max_err(got[i], eng.update(fr.image, T)["packed"]))
        for i, eng in enumerate(singles):
            if j == 10 * i or j == 0:
                ring.seed_keyframe(i, fr.image, T, *gt_bounds(fr))
                eng.set_reference_image(fr.image, T, *gt_bounds(fr))
    errs = {name: max(max_err(getattr(ring.keyframe_state(i), name), getattr(eng.state, name))
                      for i, eng in enumerate(singles))
            for name in ("mu", "sigma_sq", "a", "b")}
    conv_equal = all(torch.equal(ring.keyframe_state(i).conv, eng.state.conv)
                     for i, eng in enumerate(singles))
    log(f"  ring of {RING_EXACT_B} against {RING_EXACT_B} Depthmaps over {RING_EXACT_FRAMES} "
        f"frames: max err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; conv equal {conv_equal}; stats max err {stats_err:.3g}")
    if max(errs.values()) != 0.0 or stats_err != 0.0 or not conv_equal:
        raise AssertionError("a ring slot differs from a single Depthmap fed alike")
    return dict(errs, stats=stats_err, conv_equal=conv_equal)


def ring_node_run(torch, P, kernels, frames, B):
    """``MultiKeyframeNode`` over ``frames`` with B slots (default stride
    and stagger), each frame with its own GT bounds as the CLI gives them,
    the launch counts zeroed just before and read just after (every kernel
    must run), the finalization on the loop's stream, and each finalized
    keyframe keyed on a frame's pose; its accuracy against that frame's GT
    is printed."""
    h, w = frames[0].image.shape
    node = P.MultiKeyframeNode(P.BatchedDepthmap(
        B, w, h, CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"]))
    rec = {}
    main_stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    kernels.reset_launches()
    with watched_node(torch, rec, ring=True):
        for fr in frames:
            node.process_frame(fr.image, Tcw(fr), *gt_bounds(fr))
        node.close()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the ring at B={B}: {missing}")
    if rec["streams"] != {main_stream}:
        raise AssertionError(f"ring finalization ran on streams {rec['streams']}")
    poses = np.stack([fr.T_world_curr for fr in frames]).reshape(len(frames), -1)
    accs = []
    for kf in node.keyframes:
        d = np.abs(poses - kf.state.T_world_ref.cpu().numpy().reshape(1, -1)).max(1)
        i = int(np.argmin(d))
        if d[i] > 1e-3:
            raise AssertionError("a finalized keyframe matches no frame's pose")
        lo, hi = gt_bounds(frames[i])
        accs.append(accuracy(kf.state.conv.cpu().numpy(), kf.state.mu.cpu().numpy(), None,
                             frames[i].depth, hi - lo, P))

    def mean_of(key):
        vals = [a[key] for a in accs if np.isfinite(a[key])]
        return float(np.mean(vals)) if vals else float("nan")

    r = dict(B=B, frames=len(frames), keyframes=len(node.keyframes), switches=rec["reseed"] - B,
             launches=launches, converged_pct=mean_of("converged_pct"),
             within=100 * mean_of("within_raw"))
    log(f"  ring B={B}: {r['frames']} frames, {r['keyframes']} keyframes finalized, "
        f"{r['switches']} reseeds; finalization on the loop's stream; per finalized keyframe "
        f"converged {r['converged_pct']:.4f} %, within 2.6 % {r['within']:.4f} %; launches "
        f"{launches}")
    if not node.keyframes:
        raise AssertionError(f"the ring finalized no keyframe at B={B}")
    return r


def walk_oracle(torch, P, run640):
    """The epipolar-walk oracle on frame KEEP_FRAME of the 640x480 run
    (its kept state, image and pose) beside the rectified matcher: where
    both are confident (NCC > 0.9, 10 px inside the image) their matches
    must lie within a median 1.5 px (tests/test_matching.py)."""
    from rpg_open_remode_tpu_torch.ops import epipolar
    from rpg_open_remode_tpu_torch.utils import se3

    kept, eng = run640["kept"], run640["eng"]
    state, cfg = kept["state"], eng.cfg
    img = eng.input_image(kept["img"])
    T_curr_ref = se3.compose(torch.tensor(kept["T"], device=img.device), state.T_world_ref)
    rect = epipolar.match(state, img, T_curr_ref, eng.cam, cfg)
    wk = epipolar.match_epipolar_walk(state, img, T_curr_ref, eng.cam, cfg)
    both = rect.found & wk.found & (rect.best_ncc > 0.9) & (wk.best_ncc > 0.9)
    inside = torch.zeros_like(both)
    inside[10:-10, 10:-10] = True
    both = both & inside
    err = torch.hypot(rect.u - wk.u, rect.v - wk.v)[both]
    r = dict(steps=cfg.max_walk_steps, found_pct=100 * float(wk.found.float().mean()),
             both=int(both.sum()), median_px=float(err.median()) if err.numel() else float("nan"),
             p90_px=float(torch.quantile(err, 0.9)) if err.numel() else float("nan"))
    h, w = img.shape
    log(f"  walk oracle, frame {KEEP_FRAME} at {w}x{h} ({r['steps']} steps of "
        f"[{h}, {w}, {cfg.patch_area}] gathers): found {r['found_pct']:.2f} %; against the "
        f"rectified matcher on {r['both']} pixels both confident: median {r['median_px']:.4f} "
        f"px, p90 {r['p90_px']:.4f} px")
    if r["both"] < 1000 or not r["median_px"] < 1.5:
        raise AssertionError(f"walk and rectified matcher disagree: {r}")
    return r


def ring_phase(torch, P, kernels, frames640, run640):
    """The ring: bit-exactness, the node at each RING_SIZES over all
    frames, the CLI's ``--keyframes 4 --propagate`` run, the walk oracle."""
    out = dict(exact=ring_exactness(torch, P, frames640))
    out["node"] = {B: ring_node_run(torch, P, kernels, frames640, B) for B in RING_SIZES}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        log("  run --synthetic --frames 200 --keyframes 4 --propagate --map-voxel 0.01")
        argv = ["--device", "cuda", "run", "--synthetic", "--frames", "200", "--keyframes", "4",
                "--propagate", "--map-voxel", "0.01", "--out", str(Path(tmp) / "ring")]
        out["cli"] = cli_run(torch, P, kernels, argv, Path(tmp) / "ring", True, keyframes=4)
    out["walk"] = walk_oracle(torch, P, run640)
    return out


# -- the device mesh ------------------------------------------------------------


MESH_SHAPES = ((1, 1, 1), (1, 2, 2), (2, 1, 2))
MESH_FRAMES = 40
MESH_RESEED = 10         # kf = 2: slot 1 is reseeded on this frame, as the node's stagger
MESH_DENOISE = ((1, 2, 2), (2, 1, 2))   # the layouts that run the sharded TV-L1
# conv agreement with the single-device engine: (1,1,1) runs the single
# path's math; the bands add a halo and a band-local coarse gate, held as
# the JAX package's own sharded rect path (tests/test_sharded.py:201)
MESH_CONV = {(1, 1, 1): 0.999, (1, 2, 2): 0.995, (2, 1, 2): 0.995}
# converged-mu relative difference over the pixels converged in both: the
# p99 is held below 2 %, as the JAX package's own sharded-against-single
# check holds it (__graft_entry__.py:192-200: "band seams admit a few
# per-pixel outliers"). MULTICHIP_r05 read a max of 2.8 % there (128x160,
# ~820 converged pixels); here the max is printed beside that figure, and
# the share of pixels above it is held to MESH_MU_OVER, 5x the sound runs'
# readings (<= 0.01 %), below what one corrupted band row (up to 768
# pixels, ~0.4 %) would give
MESH_MU_P99 = 0.02
MESH_MU_REL = 0.028
MESH_MU_OVER = 5e-4
# rank 0 of each layout replays the sequence's last frames again under the
# profiler (their programs are all captured by then)
MESH_PROFILE_FRAMES = 8


def slab_calls(torch, kept, keep_frame):
    """Frame ``keep_frame``'s sweep and warp calls, plus the coarse sweep of
    the last frame up to it that ran one (None when no frame did); a coarse
    sweep whose device gate was off scores nothing and is left out."""
    out = [(keep_frame, kind, args) for kind, args in kept[keep_frame] if kind != "sweep off"]
    coarse = [(i, kind, args) for i in sorted(kept) for kind, args in kept[i]
              if kind == "sweep" and not args[10]]
    if coarse and not any(kind == "sweep" and not args[10] for _, kind, args in out):
        out.append(coarse[-1])
    return out


def tiles_err(a, b):
    """``max_err`` over every leaf of two ``local_block`` dicts."""
    import torch

    pairs = [(a[k], b[k]) for k in a if k != "scene"]
    pairs += [(a["scene"][k], b["scene"][k]) for k in a["scene"]]
    return max(max_err(torch.as_tensor(x), torch.as_tensor(y)) for x, y in pairs)


def mesh_device_regime(torch, mesh, states, T_curr_world, cam, cfg, height, width):
    """The sharded step's regime decided on the device, as the JAX step
    decides it: ``_degenerate`` of each local slot, an ``all_reduce`` max
    over ``kf`` and a host read; None where the config has no choice. The
    eager oracle's regime (the replay's is ``sharded_regime``, on the
    host)."""
    from rpg_open_remode_tpu_torch.parallel import collectives
    from rpg_open_remode_tpu_torch.parallel.sharded import _degenerate
    from rpg_open_remode_tpu_torch.utils import se3

    if not (cfg.match_mode == "rect" and cfg.zero_baseline_fallback):
        return None
    return tuple(bool(collectives.all_reduce(mesh, _degenerate(
        se3.compose(T_curr_world, st.T_world_ref), st.scene, cam, cfg, height, width), "kf",
        "max") > 0) for st in states)


def mesh_rank(mesh, io, frames, denoise):
    """One rank of a parallel-phase mesh (a spawned process): the ring of
    one slot per kf row, seeded on frame 0 with the sharded reseed and
    stepped over the other frames (slot 1 reseeded on MESH_RESEED), twice
    from the same start and frame by frame in turns: replayed (the mesh's
    compiled programs, ``parallel.ShardedPrograms``, with the regime chosen
    on the host) and eager (the ``build_sharded_*`` functions they capture,
    with the regime decided on the device, ``mesh_device_regime``, and held
    equal to the host's). Per frame and path: the launch counts and staged
    bytes it added; the replayed (1, 1, 1) frames run under
    ``set_sync_debug_mode("error")``. Keeps the eager frames
    COARSE_FROM..KEEP_FRAME's kernel calls (the band's slab shapes) and
    holds each of KEEP_FRAME's, and the last coarse pass up to it, against
    its plain version; with ``denoise`` also runs the sharded TV-L1 both
    ways. Last, the last MESH_PROFILE_FRAMES frames are replayed again with
    the launch counts zeroed just before, rank 0 under the profiler: each
    kernel's launches in its trace against the counts. Returns the rank's
    tiles and check results."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from rpg_open_remode_tpu_torch import kernels
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.state import SceneParams, empty_state
    from rpg_open_remode_tpu_torch.parallel import (
        ShardedPrograms, build_sharded_denoise, build_sharded_reseed, build_sharded_update,
    )
    from rpg_open_remode_tpu_torch.parallel.distributed import local_block
    from rpg_open_remode_tpu_torch.parallel.sharded import tile_state
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

    dev = mesh.device
    h, w = frames[0][0].shape
    cam = PinholeCamera.create(CAM_640["fx"], CAM_640["fy"], CAM_640["cx"], CAM_640["cy"],
                               device=dev)
    cfg = RemodeConfig.for_camera(CAM_640["fx"])
    step = build_sharded_update(mesh, cam, cfg, h, w)
    reseed = build_sharded_reseed(mesh, cam, cfg, h, w)
    progs = ShardedPrograms(mesh, h, w, cam, (CAM_640["fx"], CAM_640["fy"]), cfg)
    in_graph = mesh.size == 1 or mesh.backend == "nccl"
    # what the eager oracle's device regime stages a frame over gloo on a
    # kf = 2 mesh, which the replay does not: each local slot's int32 flag
    # out to pinned memory and back
    regime_bytes = 8 if mesh.axis_size("kf") > 1 and mesh.backend == "gloo" else 0

    def counts():
        torch.cuda.synchronize()
        return dict(kernels.LAUNCHES), mesh.staged["bytes"]

    def since(c0):
        c1 = counts()
        return {k: c1[0][k] - c0[0][k] for k in c0[0]}, c1[1] - c0[1]

    def eager_inputs(j):
        img, T, bounds = frames[j]
        T = torch.tensor(T, device=dev)
        return torch.as_tensor(img).to(dev), T, SceneParams.create(*bounds, cfg, device=dev)

    def reseed_both(slot, j):
        nonlocal states
        img, T, scene = eager_inputs(j)
        states = reseed(states, slot, img, se3.inv(T), scene)
        progs.load_bounds(*frames[j][2])
        progs.reseed(slot, se3.inv(progs.inputs.pose))

    states = [tile_state(empty_state(h, w, cam), mesh)]
    progs.load_frame(frames[0][0], frames[0][1])
    for slot in range(mesh.axis_size("kf")):
        reseed_both(slot, 0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kept = {}
    per = {"eager": [], "replay": []}   # per frame: (launches, staged bytes)
    debug_frames = 0
    regime_off = 0       # frames whose host regime is not the device's
    reseed_err = None
    for j in range(1, len(frames)):
        for which in (("eager", "replay") if j % 2 else ("replay", "eager")):
            c0 = counts()
            if which == "eager":
                calls = kept.setdefault(j, []) if COARSE_FROM <= j <= KEEP_FRAME else None
                img, T, _ = eager_inputs(j)
                regime = mesh_device_regime(torch, mesh, states, T, cam, cfg, h, w)
                regime_off += regime != progs.regime(np.asarray(frames[j][1], np.float32))
                with intercept(None if calls is None else
                               (lambda kind, args: calls.append((kind, args)))):
                    states, stats = step(states, img, T, regime)
            else:
                T_host = progs.load_frame(frames[j][0], frames[j][1])
                prog = progs.cache.get(("step", progs.dtype, progs.regime(T_host)))
                # one graph with its collectives inside: no host sync
                debug = in_graph and prog is not None and prog.graph is not None
                if debug:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    progs.step(T_host)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                debug_frames += debug
            per[which].append(since(c0))
        if mesh.axis_size("kf") == 2 and j == MESH_RESEED:
            reseed_both(1, j)
            reseed_err = tiles_err(local_block(progs.states), local_block(states))
    torch.cuda.synchronize()
    step_prog = [p for key, p in progs.cache.items() if key[0] == "step"]
    out = dict(rank=mesh.rank, backend=mesh.backend, device=str(dev),
               launches={k: [x[0] for x in v] for k, v in per.items()},
               staged={k: [x[1] for x in v] for k, v in per.items()},
               state=local_block(progs.states),
               state_err=tiles_err(local_block(progs.states), local_block(states)),
               reseed_err=reseed_err, debug_frames=debug_frames, regime_off=regime_off,
               regime_bytes=regime_bytes * len(states),
               packed=progs.packed.cpu().numpy(),
               packed_err=max_err(progs.packed, stats["packed"]),
               exchange_points=[len(p.exchanges) for p in step_prog],
               graphs=[len(p.graph) for p in step_prog])
    # one rank at a time, so that no other rank's work shares the card
    for turn in range(mesh.size):
        if turn == mesh.rank:
            out["calls"] = slab_parity(torch, slab_calls(torch, kept, KEEP_FRAME))
        dist.barrier()
    if denoise:
        run = build_sharded_denoise(mesh, cfg, h, w, iterations=cfg.denoise_iters)
        slots = list(range(len(states)))
        den = run(states, cfg.denoise_lambda)
        for _ in ("first call", "replay"):
            progs.snapshot(slots)
            got = progs.denoise(slots, cfg.denoise_lambda)
        torch.cuda.synchronize()
        (dprog,) = [p for key, p in progs.cache.items() if key[0] == "denoise"]
        out.update(denoise=np.stack([d.cpu().numpy() for d in got]),
                   denoise_err=max(max_err(g, d) for g, d in zip(got, den)),
                   denoise_exchange_points=len(dprog.exchanges),
                   # the leader's gathered slots: each slot's fields, then its denoised depth
                   gathered=None if progs.gathered is None else progs.gathered.cpu().numpy())
    # each program's form: (graphs, exchange points, collectives)
    out["forms"] = {p.label: (len(p.graph), len(p.exchanges), len(p.signatures))
                    for p in progs.captures()}
    # the replayed run again over the last frames (after every comparison
    # with the eager run), the counts zeroed just before: rank 0's trace
    # must hold the launches they add up to
    again = range(len(frames) - MESH_PROFILE_FRAMES, len(frames))
    cached, replays = len(progs.cache), sum(p.replays for p in progs.cache.values())
    dist.barrier()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if mesh.rank == 0 else contextlib.nullcontext()) as prof:
        for j in again:
            progs.step(progs.load_frame(frames[j][0], frames[j][1]))
        torch.cuda.synchronize()
    counted = dict(kernels.LAUNCHES)
    if (len(progs.cache) != cached
            or sum(p.replays for p in progs.cache.values()) - replays != len(again)):
        raise AssertionError("the profiled frames were not all replays of captured programs")
    if prof is not None:
        out["profile"] = dict(frames=len(again), counted=counted,
                              traced=traced_launches(torch, prof))
    return out


def slab_parity(torch, calls):
    """Each kept kernel call against its plain version."""
    from rpg_open_remode_tpu_torch.ops import resample_cuda, sweep_cuda, warp_cuda

    out = []
    for i, kind, args in calls:
        if kind == "warp":
            call = warp_call(args)
            got = warp_cuda.homography_warp(*call)
            want = warp_cuda.homography_warp_plain(*call[:6])
            err = max(max_err(g, x) for g, x in zip(got, want) if g is not None)
            img, H, ho, wo, x0, y0, _ = call
            name = f"warp {WARP_LABELS[img.shape[0]]} C={img.shape[0]}"
            shape = (tuple(img.shape), (ho, wo), (x0, y0))
        elif kind == "sweep":
            got = sweep_cuda.disparity_sweep(*args)
            want = sweep_cuda.disparity_sweep_plain(*args)
            err = max(max_err(g, x) for g, x in zip(got, want))
            name = "sweep " + ("full" if args[10] else "coarse")
            shape = tuple(args[2].shape)
        else:
            err = max_err(getattr(resample_cuda, f"resample_{kind}")(*args),
                          getattr(resample_cuda, f"resample_{kind}_plain")(*args))
            name = f"resample_{kind} C={args[0].shape[0]}"
            shape = (tuple(args[0].shape), tuple(args[1].shape))
        out.append(dict(frame=i, name=name, shape=str(shape), max_abs_err=err))
    return out


def mesh_reference(torch, P, frames):
    """The single-device engine fed alike: ``Depthmap``s seeded on frame 0
    and on MESH_RESEED, each updated on every later frame (the slots of a
    kf = 2 mesh). Returns them."""
    h, w = frames[0].image.shape
    cam = (CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"])
    out = []
    for first in (0, MESH_RESEED):
        eng = P.Depthmap(w, h, *cam)
        eng.set_reference_image(frames[first].image, Tcw(frames[first]), *gt_bounds(frames[first]))
        for fr in frames[first + 1:MESH_FRAMES]:
            eng.update(fr.image, Tcw(fr))
        out.append(eng)
    torch.cuda.synchronize()
    return out


def mesh_agreement(P, got, eng):
    """conv agreement of a gathered slot with a single engine; over the
    pixels converged in both, the relative difference of mu (median, p99,
    max, and how many exceed MESH_MU_REL) and its max for sigma_sq; whether
    mu, sigma_sq, a, b and conv are equal bit for bit."""
    conv, want = got["conv"], eng.state.conv.cpu().numpy()
    both = (conv == int(P.ConvergenceState.CONVERGED)) & (want == int(P.ConvergenceState.CONVERGED))

    def rel(name):
        a, b = got[name][both], getattr(eng.state, name).cpu().numpy()[both]
        return np.abs(a - b) / np.abs(b)

    mu, sig = rel("mu"), rel("sigma_sq")
    q = np.percentile(mu, [50, 99, 100]) if mu.size else [float("nan")] * 3
    exact = all(np.array_equal(got[f], getattr(eng.state, f).cpu().numpy())
                for f in ("mu", "sigma_sq", "a", "b", "conv"))
    return dict(conv=float((conv == want).mean()), converged=int(both.sum()),
                mu_rel_median=float(q[0]), mu_rel_p99=float(q[1]), mu_rel_max=float(q[2]),
                mu_over=int((mu > MESH_MU_REL).sum()),
                sigma_sq_rel_max=float(sig.max()) if sig.size else float("nan"), exact=exact)


def mesh_phase(torch, P, kernels, frames640):
    """The device mesh on the card: the sharded step at each MESH_SHAPES
    over the first MESH_FRAMES frames, replayed (the mesh's compiled
    programs) and eager from the same start, in turns, held to each other
    bit for bit (states, the reseeded slot, the TV-L1 at MESH_DENOISE;
    the host regime and the device's; launches and staged bytes a frame),
    rank 0's profiled replay to the launch counts, and to the single
    engine; the kernel calls of the band slabs against their plain
    versions, the sharded TV-L1 against the single-device one and its
    gather against the joined tiles, each program's form (one graph with
    its collectives inside under NCCL and on one rank, segments between
    exchange points under gloo), and the CLI's ``run --mesh 2,1,2
    --keyframes 2 --propagate``. Ranks are spawned processes: with a card
    each, NCCL; sharing one card, gloo collectives staged through pinned
    host memory; one rank, NCCL. Returns each layout's errors."""
    from rpg_open_remode_tpu_torch.models.depthmap import denoise_depthmap
    from rpg_open_remode_tpu_torch.parallel import join_state_numpy, run_ranks
    from rpg_open_remode_tpu_torch.parallel.programs import GATHERED

    frames = frames640[:MESH_FRAMES]
    feed = [(fr.image, Tcw(fr), gt_bounds(fr)) for fr in frames]
    refs = mesh_reference(torch, P, frames)
    out, bad = {}, []
    for shape in MESH_SHAPES:
        ranks = run_ranks(mesh_rank, shape, (feed, shape in MESH_DENOISE), device="cuda",
                          timeout=600)
        got = join_state_numpy([r["state"] for r in ranks], shape)
        n = len(ranks)
        r = dict(backend=ranks[0]["backend"], devices=[x["device"] for x in ranks],
                 launches=[{k: sum(f[k] for f in x["launches"]["replay"]) for k in
                            x["launches"]["replay"][0]} for x in ranks],
                 state_err=max(x["state_err"] for x in ranks),
                 packed_err=max(x["packed_err"] for x in ranks),
                 reseed_err=None if shape[0] != 2 else max(x["reseed_err"] for x in ranks),
                 exchange_points=ranks[0]["exchange_points"], graphs=ranks[0]["graphs"],
                 debug_frames=ranks[0]["debug_frames"], slots=[])
        # the eager frame stages the replay's bytes plus its device regime's
        same_counts = all(x["launches"]["replay"] == x["launches"]["eager"]
                          and [b + x["regime_bytes"] for b in x["staged"]["replay"]]
                          == x["staged"]["eager"] for x in ranks)
        r["regime_off"] = sum(x["regime_off"] for x in ranks)
        log(f"  mesh {shape}: {n} rank(s), backend {r['backend']}, devices {r['devices']}; "
            f"replayed (host regime) against eager (device regime, "
            f"{ranks[0]['regime_bytes']} B staged a frame per rank for its kf max) from the same "
            f"start, max err states {r['state_err']:.3g}, packed stats {r['packed_err']:.3g}"
            + ("" if r["reseed_err"] is None else
               f", the slot reseeded on frame {MESH_RESEED} {r['reseed_err']:.3g}")
            + f"; frames whose host regime differs from the device's (all ranks) "
            f"{r['regime_off']}; launches of every frame equal, staged bytes equal but for the "
            f"device regime's: {same_counts}; replayed launches per rank {r['launches']}")
        if (r["state_err"] != 0.0 or r["packed_err"] != 0.0 or r["reseed_err"]
                or r["regime_off"] or not same_counts):
            bad.append(f"{shape}: the replayed run differs from the eager run")
        prof = ranks[0]["profile"]
        off = {k: (t, prof["counted"][k]) for k, t in prof["traced"].items()
               if t != prof["counted"][k]}
        log(f"  mesh {shape}: rank 0 replayed its last {prof['frames']} frames again under the "
            f"profiler: launches traced (counted) "
            + ", ".join(f"{k} {t} ({prof['counted'][k]})" for k, t in prof["traced"].items()))
        if off or any(prof["counted"][k] <= 0 for k in ("sweep", "warp")):
            bad.append(f"{shape}: the profiled replay's launches (traced, counted) {off}, "
                       f"counted {prof['counted']}")
        for k in range(shape[0]):
            a = mesh_agreement(P, {f: got[f][k] for f in ("conv", "mu", "sigma_sq", "a", "b")},
                               refs[k])
            r["slots"].append(a)
            ok = a["conv"] >= MESH_CONV[shape] and (
                not a["converged"] or (a["mu_rel_p99"] <= MESH_MU_P99
                                       and a["mu_over"] <= MESH_MU_OVER * a["converged"]))
            if shape == (1, 1, 1):
                ok = ok and a["exact"]   # the single engine's replay, bit for bit
            log(f"  mesh {shape} slot {k} (seeded on frame {0 if k == 0 else MESH_RESEED}) "
                f"replayed against a single Depthmap (replayed): conv agreement {a['conv']:.5f} "
                f"(>= {MESH_CONV[shape]}); {a['converged']} pixels converged in both, mu rel diff "
                f"median {a['mu_rel_median']:.3g}, p99 {a['mu_rel_p99']:.3g} (<= {MESH_MU_P99}), "
                f"max {a['mu_rel_max']:.4g} (MULTICHIP_r05 read {MESH_MU_REL}), {a['mu_over']} "
                f"pixels above {MESH_MU_REL} (<= {MESH_MU_OVER * a['converged']:.0f}); sigma_sq "
                f"max {a['sigma_sq_rel_max']:.3g}; mu, sigma_sq, a, b and conv bit-exact "
                f"{a['exact']}{'' if ok else ' OUTSIDE'}")
            if not ok:
                bad.append(f"{shape} slot {k}")
        calls = [dict(c, rank=x["rank"]) for x in ranks for c in x["calls"]]
        for c in calls:
            log(f"    rank {c['rank']} frame {c['frame']} {c['name']} {c['shape']}: max err "
                f"{c['max_abs_err']:.3g}")
            if c["max_abs_err"] != 0.0:
                bad.append(f"{shape} rank {c['rank']} {c['name']} differs from its plain version")
        r["calls_max_abs_err"] = max((c["max_abs_err"] for c in calls), default=0.0)
        if shape in MESH_DENOISE:
            den = join_state_numpy([{"mu": x["denoise"]} for x in ranks], shape)["mu"]
            cfg = refs[0].cfg
            err, ok, gathered_err = 0.0, True, 0.0
            for k in range(shape[0]):
                st = P.state_from_numpy({f: v[k] if f != "scene" else {
                    s: y[k] for s, y in v.items()} for f, v in got.items()},
                    device=refs[0].device)
                want = denoise_depthmap(st, cfg, lam=cfg.denoise_lambda,
                                        iterations=cfg.denoise_iters).cpu().numpy()
                e = np.abs(den[k] - want)
                err = max(err, float(e.max()))
                ok = ok and bool((e <= 1e-5 + 1e-4 * np.abs(want)).all())
                # the leader of slot k's row gathered the slot and its denoised depth
                (lead,) = [x for x in ranks if x["gathered"] is not None
                           and x["rank"] // (shape[1] * shape[2]) == k]
                fields = np.stack([got[f][k].astype(np.float32) for f in GATHERED] + [den[k]])
                gathered_err = max(gathered_err, float(np.abs(lead["gathered"][0] - fields).max()))
            rep_err = max(x["denoise_err"] for x in ranks)
            r["denoise"] = dict(max_abs_err=err, within=ok, replay_err=rep_err,
                                gathered_err=gathered_err,
                                exchange_points=ranks[0]["denoise_exchange_points"])
            log(f"  mesh {shape} sharded TV-L1 ({cfg.denoise_iters} iterations, 1-px halos, "
                f"plain PyTorch) and the gather to each row's leader: "
                f"{r['denoise']['exchange_points']} exchange points, so "
                f"{r['denoise']['exchange_points'] + 1} graph segments; "
                f"replayed against eager max err {rep_err:.3g}; against the single-device "
                f"denoise max abs err {err:.3g} (rtol 1e-4, atol 1e-5: "
                f"{'ok' if ok else 'OUTSIDE'}); gathered against the joined tiles max err "
                f"{gathered_err:.3g}")
            if not ok or rep_err != 0.0 or gathered_err != 0.0:
                bad.append(f"{shape} denoise")
        # each program's form: one graph with no exchange point under NCCL
        # and on one rank; segments between exchange points under gloo
        forms = [x["forms"] for x in ranks]
        r["forms"] = forms
        log(f"  mesh {shape}: program forms (graphs, exchange points, collectives inside or "
            f"between them), rank 0: "
            + "; ".join(f"{lab} {f}" for lab, f in forms[0].items())
            + ("" if n == 1 else "; other ranks: "
               + " | ".join(", ".join(f"{lab} {f}" for lab, f in x.items()) for x in forms[1:])))
        labels = {str(sorted(x)) for x in forms}
        if r["backend"] == "nccl" or n == 1:
            one_graph = all(f[:2] == (1, 0) for x in forms for f in x.values())
            if not one_graph or len(labels) != 1:
                bad.append(f"{shape}: not every program is one graph with no exchange point on "
                           f"every rank: {forms}")
        elif not all(f[1] > 0 and f[0] == f[1] + 1 for x in forms for lab, f in x.items()
                     if lab.startswith(("step", "denoise"))):
            bad.append(f"{shape}: the gloo step and denoise programs are not segments between "
                       f"exchange points: {forms}")
        if shape == (1, 1, 1) or r["backend"] == "nccl":
            log(f"  mesh {shape}: {r['debug_frames']} replayed frames under "
                f"set_sync_debug_mode('error'): no host synchronization")
            if r["debug_frames"] < MESH_FRAMES - 3 or r["graphs"] != [1] * len(r["graphs"]):
                bad.append(f"{shape}: {r['debug_frames']} frames under sync debug, graphs "
                           f"{r['graphs']}")
        missing = [(i, k) for i, x in enumerate(r["launches"]) for k in ("sweep", "warp")
                   if x[k] <= 0]
        if missing or not calls:
            bad.append(f"{shape}: kernels not launched {missing}")
        out[str(shape)] = r
    out["cli"] = mesh_cli(torch, kernels)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def mesh_cli(torch, kernels):
    """``run --synthetic --frames 60 --mesh 2,1,2 --keyframes 2 --propagate
    --map-voxel 0.01`` through ``cli.main`` in this process: it exports
    keyframes, and every rank launched the sweep and the warp."""
    from rpg_open_remode_tpu_torch import cli

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        out_dir = Path(tmp) / "mesh"
        argv = ["--device", "cuda", "run", "--synthetic", "--frames", "60", "--mesh", "2,1,2",
                "--keyframes", "2", "--propagate", "--map-voxel", "0.01", "--out", str(out_dir)]
        log("  " + " ".join(argv[2:-2]))
        res = cli.main(argv)
        files = sorted(p.name for p in out_dir.iterdir())
    n_kf = len(res.keyframes)
    r = dict(keyframes=n_kf, switches=res.switches, launches=[x["launches"] for x in res.ranks])
    for x in res.ranks:
        log(f"    rank {x['rank']} ({x['device']}, {x['backend']}): launches {x['launches']}, "
            f"{x['keyframes']} keyframes exported, staged {x['staged']['bytes'] / 1e6:.1f} MB")
    log(f"  the CLI's mesh run: {n_kf} keyframes, switches {res.switches}")
    want = {f"kf_{i:03d}{s}" for i in range(n_kf) for s in ("_depth.npy", "_cloud.ply",
                                                            "_convergence.png")}
    problems = []
    if n_kf < 1 or not want <= set(files) or "global_map.ply" not in files:
        problems.append(f"{n_kf} keyframes, files {files}")
    problems += [f"rank {x['rank']} launched no {k}" for x in res.ranks
                 for k in ("sweep", "warp") if x["launches"][k] <= 0]
    if problems:
        raise AssertionError("the CLI's mesh run: " + "; ".join(problems))
    return r


# -- the compiled programs: CUDA graph replays against the eager step --------------


GRAPH_KEEP = (10, 100, 199)          # frames of the over_table run whose states are held
SYNC_SCHEDULE = dict(frames=80, switches=(20, 50), debug=(25, 80))
CHUNK_K = 16


def leaves(state):
    """A state's tensors by name, the scene's as ``scene.<field>``."""
    out = {f.name: getattr(state, f.name) for f in dataclasses.fields(state) if f.name != "scene"}
    out.update({"scene." + f.name: getattr(state.scene, f.name)
                for f in dataclasses.fields(state.scene)})
    return out


def state_err(got, want):
    """The largest ``max_err`` over every leaf of two states."""
    g, w = leaves(got), leaves(want)
    return max(max_err(g[k], w[k]) for k in w)


class EagerEngine:
    """The eager functional core driven as ``Depthmap`` drives its programs:
    ``set_reference`` (flat, or ``_set_reference_propagated`` with
    ``propagate``), ``update_step`` with the regime read on the device (the
    oracle's own choice), the frame prepped and undistorted eagerly."""

    def __init__(self, torch, P, width, height, cam, cfg=None, grid=None):
        from rpg_open_remode_tpu_torch.models.state import clone, empty_state
        from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

        self.torch = torch
        self.cfg = cfg or P.RemodeConfig.for_camera(cam["fx"])
        self.cam = PinholeCamera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                        device="cuda")
        self.state = clone(empty_state(height, width, self.cam))
        self.grid = grid
        self.has_reference = False

    def image(self, img):
        from rpg_open_remode_tpu_torch.models.depthmap import prep_image
        from rpg_open_remode_tpu_torch.utils import warp as warp_ops

        x = prep_image(self.torch.as_tensor(np.asarray(img)).to("cuda"))
        return x if self.grid is None else warp_ops.warp_grid(x, *self.grid)

    def pose(self, T):
        return self.torch.tensor(np.asarray(T, np.float32), device="cuda")

    def set_reference_image(self, img, T, lo, hi):
        from rpg_open_remode_tpu_torch.models import depthmap
        from rpg_open_remode_tpu_torch.models.state import SceneParams

        scene = SceneParams.create(lo, hi, self.cfg, device="cuda")
        if self.cfg.propagate_depth and self.has_reference and self.grid is None:
            self.state = depthmap._set_reference_propagated(
                self.state, self.image(img), self.pose(T), scene, self.cam, self.cfg)
        else:
            self.state = depthmap.set_reference(self.state, self.image(img), self.pose(T), scene,
                                                self.cfg)
        self.has_reference = True

    def update(self, img, T):
        from rpg_open_remode_tpu_torch.models.depthmap import update_step

        self.state, stats = update_step(self.state, self.image(img), self.pose(T), self.cam,
                                        self.cfg)
        return stats

    def denoised_depthmap(self, lam=0.5, iterations=200):
        from rpg_open_remode_tpu_torch.models.depthmap import denoise_depthmap

        return denoise_depthmap(self.state, self.cfg, lam=lam, iterations=iterations).cpu().numpy()


def engine_of(torch, P, which, frames, cam, cfg=None, undistort=None):
    h, w = frames[0].image.shape
    if which == "eager":
        grid = None
        if undistort is not None:
            from rpg_open_remode_tpu_torch.models.depthmap import undistort_map
            from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

            c = PinholeCamera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"], device="cuda")
            grid = undistort_map(h, w, c, **undistort)
        return EagerEngine(torch, P, w, h, cam, cfg, grid)
    eng = P.Depthmap(w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"], cfg=cfg)
    if undistort is not None:
        eng.init_undistortion_map(**undistort)
    return eng


def run_sequence(torch, P, kernels, which, frames, cam, cfg=None, undistort=None,
                 poses=None, switches=(), keep=(), denoise=False, debug=None):
    """One engine (``which``: "graph", a ``Depthmap``; "eager", the eager
    core) over ``frames``: keyframe on frame 0, a reseed (propagated with
    ``cfg.propagate_depth``) at each frame of ``switches``, an update on
    every other; ``poses[i]`` overrides frame i's pose. Launch counts zeroed
    before, read after; every update's packed stats; the states after the
    frames in ``keep`` (copies); ``debug`` = (first, end): frames run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from rpg_open_remode_tpu_torch.models.state import clone

    poses = poses or {}
    eng = engine_of(torch, P, which, frames, cam, cfg, undistort)
    torch.cuda.synchronize()
    kernels.reset_launches()
    packed, kept = [], {}
    for i, fr in enumerate(frames):
        T = poses.get(i, Tcw(fr))
        if debug is not None and i == debug[0]:
            torch.cuda.set_sync_debug_mode("error")
        if i == 0 or i in switches:
            eng.set_reference_image(fr.image, T, *gt_bounds(fr))
        else:
            packed.append(eng.update(fr.image, T)["packed"])
        if debug is not None and i + 1 == debug[1]:
            torch.cuda.set_sync_debug_mode(0)
        if i in keep:
            kept[i] = clone(eng.state if which == "eager" else eng.programs.state)
    den = eng.denoised_depthmap(0.5, 200) if denoise else None
    torch.cuda.synchronize()
    return dict(eng=eng, launches=dict(kernels.LAUNCHES), denoised=den, packed=packed,
                kept=kept, state=eng.state if which == "eager" else eng.programs.state)


def compare_runs(label, graph, eager, frames_kept=()):
    """Graph against eager, bit for bit: the final states, the kept states,
    every frame's packed stats, the denoised maps; and the launch counts.
    Raises on any difference."""
    errs = dict(state=state_err(graph["state"], eager["state"]),
                stats=max((max_err(g, w) for g, w in zip(graph["packed"], eager["packed"])),
                          default=0.0))
    for i in frames_kept:
        errs[f"frame {i}"] = state_err(graph["kept"][i], eager["kept"][i])
    if graph["denoised"] is not None:
        errs["denoised"] = float(np.nanmax(np.abs(graph["denoised"] - eager["denoised"])))
    same_launches = graph["launches"] == eager["launches"]
    log(f"  {label}: graph against eager, max err " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f"; launches {graph['launches']} (eager {'equal' if same_launches else eager['launches']})")
    if max(errs.values()) != 0.0 or len(graph["packed"]) != len(eager["packed"]):
        raise AssertionError(f"{label}: the graph replays differ from the eager step")
    if not same_launches:
        raise AssertionError(f"{label}: launch counts differ, graph {graph['launches']}, "
                             f"eager {eager['launches']}")
    return dict(errs, launches=graph["launches"])


def graph_against_eager(torch, P, kernels, label, frames, cam, keep=(), denoise=False):
    """``run_sequence`` with the eager core, then with a ``Depthmap``, the
    graph run held against the eager one (``compare_runs``)."""
    eager, graph = (run_sequence(torch, P, kernels, which, frames, cam, keep=keep,
                                 denoise=denoise) for which in ("eager", "graph"))
    return compare_runs(label, graph, eager, keep)


def regime_poses(frames):
    """Poses that take the matcher through all three regimes on frames
    1-12: the keyframe's own pose (zero baseline, pure rotation) on 1-4, a
    move along the optical axis (axial, plane sweep) on 5-8, the sequence's
    own lateral poses on 9-12."""
    T0 = Tcw(frames[0]).astype(np.float64)
    poses = {}
    for i in range(1, 5):
        poses[i] = T0.astype(np.float32)
    for i in range(5, 9):
        T = T0.copy()
        T[2, 3] -= 0.02 * (i - 4)
        poses[i] = T.astype(np.float32)
    return poses


def regimes_run(torch, P, kernels, frames):
    """Graph against eager over a sequence that reaches every regime; the
    host's regime against the device's on every frame; the programs of each
    regime captured."""
    from rpg_open_remode_tpu_torch.ops import rect_match
    from rpg_open_remode_tpu_torch.utils import se3

    poses = regime_poses(frames)
    seq = frames[:13]
    g = run_sequence(torch, P, kernels, "graph", seq, CAM_640, poses=poses)
    e = run_sequence(torch, P, kernels, "eager", seq, CAM_640, poses=poses)
    cmp = compare_runs("three regimes (13 frames)", g, e)
    prog, eng = g["eng"].programs, g["eng"]
    host, dev = [], []
    for i in range(1, 13):
        T = poses.get(i, Tcw(seq[i]))
        host.append(prog.regime(T))
        Tcr = se3.compose(torch.tensor(T, device="cuda"), prog.state.T_world_ref)
        dev.append(int(rect_match.regime_device(prog.state, Tcr, eng.cam, eng.cfg, *seq[0].image.shape)))
    regimes = sorted({k[-1] for k in prog.cache if k[0] == "update"})
    log(f"  regimes by frame, host {host}, device {dev}; update programs for regimes {regimes}")
    if host != dev or regimes != [0, 1, 2]:
        raise AssertionError("the host's regime differs from the device's, or a regime went "
                             "unvisited")
    # each regime's replay launches: the head kernels once a rectified
    # update, the classification alone in the other regimes
    want = {rect_match.PURE_ROTATION: {"classify": 1, "warp": 1, "seed_update": 1},
            rect_match.PLANE_SWEEP: {"classify": 1, "planesweep": 1, "seed_update": 1},
            rect_match.RECTIFIED: dict.fromkeys(HEAD_KERNELS, 1) | {"sweep": 2, "warp": 3,
                                                                    "seed_update": 1}}
    recorded = {k[-1]: {n: c for n, c in p.launches.items() if c}
                for k, p in prog.cache.items() if k[0] == "update"}
    log(f"  a replay's launches by regime: {recorded}")
    if recorded != want:
        raise AssertionError(f"a regime's replay launches other kernels: {recorded}, want {want}")
    return dict(cmp, host=host, device=dev, launches=recorded)


def undistortion_graphs(torch, P, kernels, frames):
    g = run_sequence(torch, P, kernels, "graph", frames[:UNDISTORT_FRAMES], CAM_640,
                     undistort=UNDISTORT, denoise=True)
    e = run_sequence(torch, P, kernels, "eager", frames[:UNDISTORT_FRAMES], CAM_640,
                     undistort=UNDISTORT, denoise=True)
    return compare_runs(f"undistortion ({UNDISTORT_FRAMES} frames)", g, e)


def propagated_graphs(torch, P, kernels, frames):
    """Two propagated switches, graph against eager; the second switch is a
    replay, and it and the frames around it run under
    ``set_sync_debug_mode("error")``: any host read fails the run. Then one
    more replayed switch under the profiler, the launch counts zeroed just
    before and read just after: the trace's launches must equal them, and
    the warp must launch once a chunk of ``propagate.WARP_CHUNK`` planes."""
    from torch.profiler import ProfilerActivity, profile

    from rpg_open_remode_tpu_torch.ops import propagate

    cfg = dataclasses.replace(P.RemodeConfig.for_camera(CAM_640["fx"]), propagate_depth=True)
    sched = SYNC_SCHEDULE
    seq = frames[:sched["frames"]]
    keep = tuple(k + 1 for k in sched["switches"])
    g = run_sequence(torch, P, kernels, "graph", seq, CAM_640, cfg=cfg,
                     switches=sched["switches"], keep=keep, debug=sched["debug"])
    e = run_sequence(torch, P, kernels, "eager", seq, CAM_640, cfg=cfg,
                     switches=sched["switches"], keep=keep)
    cmp = compare_runs(f"propagated switches at {sched['switches']} ({len(seq)} frames)", g, e,
                       keep)
    n_debug = sum(1 for i in range(*sched["debug"]) if i not in sched["switches"])
    log(f"  {n_debug} replayed frames and the replayed switch at frame {sched['switches'][-1]} "
        f"under set_sync_debug_mode('error'): no host synchronization")
    eng = g["eng"]
    fr = seq[sched["switches"][-1]]
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.set_reference_image(fr.image, Tcw(fr), *gt_bounds(fr))
        torch.cuda.synchronize()
    counted = dict(kernels.LAUNCHES)
    traced = traced_launches(torch, prof)
    per = -(-propagate.PLANES // propagate.WARP_CHUNK)
    log(f"  a replayed propagated switch under the profiler: launches traced (counted) "
        + ", ".join(f"{k} {n} ({counted[k]})" for k, n in traced.items())
        + f"; the warp by construction {per}")
    if any(n != counted[k] for k, n in traced.items()) or traced["warp"] != per:
        raise AssertionError("the replayed switch's warp launches are not one a chunk of planes, "
                             "or its trace differs from the counts")
    return dict(cmp, debug_frames=n_debug, switch_launches=traced)


def chunk_graphs(torch, P, kernels, frames):
    """``Depthmap.update_chunk`` with K = CHUNK_K (K replays a call, no host
    read between them) over three chunks against the eager chain."""
    seq = frames[:1 + 3 * CHUNK_K]
    h, w = seq[0].image.shape
    eng = P.Depthmap(w, h, CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    eng.set_reference_image(seq[0].image, Tcw(seq[0]), *gt_bounds(seq[0]))
    packed = []
    for c in range(3):
        part = seq[1 + c * CHUNK_K: 1 + (c + 1) * CHUNK_K]
        imgs = np.stack([fr.image for fr in part])
        Ts = np.stack([Tcw(fr) for fr in part])
        packed.append(eng.update_chunk(imgs, Ts))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ref = run_sequence(torch, P, kernels, "eager", seq, CAM_640)
    errs = dict(state=state_err(eng.programs.state, ref["state"]),
                stats=max_err(torch.cat(packed), torch.stack(ref["packed"])))
    log(f"  update_chunk K={CHUNK_K}, 3 chunks: max err state {errs['state']:.3g}, stats "
        f"{errs['stats']:.3g}; launches {launches} (eager "
        f"{'equal' if launches == ref['launches'] else ref['launches']})")
    if max(errs.values()) != 0.0 or launches != ref["launches"]:
        raise AssertionError("update_chunk differs from the eager chain")
    return dict(errs, launches=launches)


def ring_graphs(torch, P, frames):
    """A ring of RING_EXACT_B slots (each slot's update and reseed a replay)
    against as many eager chains fed alike over RING_EXACT_FRAMES frames
    (slot i reseeded flat on frame 10 i), bit for bit."""
    h, w = frames[0].image.shape
    ring = P.BatchedDepthmap(RING_EXACT_B, w, h, CAM_640["fx"], CAM_640["cx"], CAM_640["fy"],
                             CAM_640["cy"])
    chains = [engine_of(torch, P, "eager", frames, CAM_640) for _ in range(RING_EXACT_B)]
    stats_err = 0.0
    for j, fr in enumerate(frames[:RING_EXACT_FRAMES]):
        T = Tcw(fr)
        if j:
            got = ring.update(fr.image, T)["packed"]
            for i, ch in enumerate(chains):
                stats_err = max(stats_err, max_err(got[i], ch.update(fr.image, T)["packed"]))
        for i, ch in enumerate(chains):
            if j == 10 * i or j == 0:
                ring.seed_keyframe(i, fr.image, T, *gt_bounds(fr))
                ch.set_reference_image(fr.image, T, *gt_bounds(fr))
    err = max(state_err(p.state, ch.state) for p, ch in zip(ring.programs, chains))
    log(f"  ring of {RING_EXACT_B} (graphs) against {RING_EXACT_B} eager chains over "
        f"{RING_EXACT_FRAMES} frames: max err state {err:.3g}, stats {stats_err:.3g}")
    if err != 0.0 or stats_err != 0.0:
        raise AssertionError("a ring slot's replays differ from its eager chain")
    return dict(state=err, stats=stats_err)


def graphs_phase(torch, P, kernels, frames640, frames720, frames1080):
    """The compiled programs on the card: every replay against the eager
    ``update_step`` it captured, bit for bit."""
    from rpg_open_remode_tpu_torch.eval import CAM_1080

    return {
        "640x480": graph_against_eager(
            torch, P, kernels, f"640x480 over_table ({len(frames640)} frames, denoise)",
            frames640, CAM_640, keep=GRAPH_KEEP, denoise=True),
        "regimes": regimes_run(torch, P, kernels, frames640),
        "undistortion": undistortion_graphs(torch, P, kernels, frames640),
        "propagated": propagated_graphs(torch, P, kernels, frames640),
        "chunk": chunk_graphs(torch, P, kernels, frames640),
        "ring": ring_graphs(torch, P, frames640),
        "1280x720": graph_against_eager(torch, P, kernels, f"1280x720 ({len(frames720)} frames)",
                                        frames720, CAM_720),
        "1920x1080": graph_against_eager(torch, P, kernels,
                                         f"1920x1080 ({len(frames1080)} frames)", frames1080,
                                         CAM_1080),
    }


# -- the other sizes, the fused tail, the plane sweep, undistortion -----------------


def warp_instances(warps, size):
    """``frame_warps``' warps labelled with their image size."""
    return {f"{size} {lab}": args for lab, args in warps.items()}


def warp_run(torch, P, kernels, label, width, height, cam, n_frames):
    """A short run through ``Depthmap`` at ``for_camera(fx)`` (launch
    counts zeroed just before, read just after, every kernel of the path
    launched) that keeps frame KEEP_FRAME's warps (``frame_warps``), each
    held bit for bit against the plain version. Returns the run."""
    frames = make_frames(width, height, cam, n_frames)
    run = drive(torch, P, kernels, frames, cam, keep_frame=KEEP_FRAME, first=KEEP_FRAME)
    report_run(label, run)
    warps = warp_instances(frame_warps(run), label)
    run["warp_err"] = max(check_warp(args, lab) for lab, args in warps.items())
    return run


SEED_UPDATE_SIZES = ((640, 480), (752, 480))
SEED_UPDATE_FRAMES = 4


def seed_update_phase(torch):
    """The fused tail (``csrc/seed_update.cu``) against its plain version
    at the main path's shapes: at each of SEED_UPDATE_SIZES, on
    SEED_UPDATE_FRAMES consecutive frames of ``scripts/profile_update.setup``
    (the state after its warm-up updates), each flavour (the rectified
    matcher's back-warped planes, and their unrectified match) bit for bit
    in every leaf. Returns the max error."""
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image
    from rpg_open_remode_tpu_torch.ops import rect_match, seed_check, seed_update_cuda
    from rpg_open_remode_tpu_torch.scripts.profile_update import WARMUP, setup
    from rpg_open_remode_tpu_torch.utils import se3

    dev = torch.device("cuda")
    err = 0.0
    for w, h in SEED_UPDATE_SIZES:
        x = setup(w, h, dev, k=SEED_UPDATE_FRAMES)
        border = seed_check.border_mask(h, w, x.cfg, device=dev)
        state = x.state
        for n in range(SEED_UPDATE_FRAMES):
            i = WARMUP + n   # the first frame after setup's warm-up updates
            T_curr_ref = se3.compose(x.Ts[i], state.T_world_ref)
            T_ref_curr = se3.inv(T_curr_ref)
            conv1 = seed_check.classify_seeds(state.mu, state.sigma_sq, state.a, state.b,
                                              state.scene.epsilon, border, x.cfg)
            state1 = dataclasses.replace(state, conv=conv1)
            planes = rect_match.match_rectified_planes(state1, prep_image(x.imgs[i]), T_curr_ref,
                                                       x.cam, x.cfg)
            res = rect_match.unrectify(planes, x.cfg)
            for flavour, match in (("rectified", planes), ("generic", res)):
                args = (state1, match, T_ref_curr, x.cam, x.cfg)
                got = seed_update_cuda.fused_seed_update(*args)
                want = seed_update_cuda.seed_update_plain(*args)
                leaves = [(getattr(got[0], f), getattr(want[0], f))
                          for f in ("mu", "sigma_sq", "a", "b", "conv", "match_u", "match_v")]
                leaves += [(got[1], want[1]), (got[2], want[2])]   # counts, NCC plane
                e = max(max_err(g, v) for g, v in leaves)
                log(f"  {w}x{h} frame {i} {flavour}: max err {e:.3g} over every leaf")
                err = max(err, e)
            state = want[0]
    if err != 0.0:
        raise AssertionError(f"the fused tail differs from its plain version (max err {err})")
    return err


PLANESWEEP_SIZES = ((640, 480), (752, 480))
PLANESWEEP_FRAMES = 4
# a ragged tile of the mesh's shape: seed planes smaller than the image
PLANESWEEP_TILE = (100, 150, 173, 261)


def planesweep_phase(torch):
    """The plane-sweep kernel (``csrc/planesweep.cu``) against its plain
    version on a forward dolly (``testing/planesweep_cases``), whose updates
    all take the PLANE_SWEEP regime: at each of PLANESWEEP_SIZES, on
    PLANESWEEP_FRAMES consecutive frames, the whole image bit for bit in
    every output, and on the first frame a ragged mesh-shaped tile and the
    bands narrowed to a few planes (most planes of a tile skipped). Returns
    the max error."""
    from rpg_open_remode_tpu_torch.models.depthmap import update_step
    from rpg_open_remode_tpu_torch.ops import epipolar, planesweep_cuda
    from rpg_open_remode_tpu_torch.testing import planesweep_cases as cases
    from rpg_open_remode_tpu_torch.utils import se3

    dev = torch.device("cuda")
    err = 0.0
    for w, h in PLANESWEEP_SIZES:
        x = cases.forward_sequence(w, h, PLANESWEEP_FRAMES + 3, dev)
        state = x.state
        for n, (img, T) in enumerate(x.frames):
            st = cases.classified(state, x.cfg)
            T_curr_ref = se3.compose(T, st.T_world_ref)
            args = epipolar.planesweep_args(st, img, T_curr_ref, x.cam, x.cfg)
            calls = {"whole": args}
            if n == 0:
                calls["tile"] = cases.tile_args(args, *PLANESWEEP_TILE)
                narrow = cases.classified(cases.narrowed(state, 1e-3), x.cfg)
                calls["narrow"] = epipolar.planesweep_args(narrow, img, T_curr_ref, x.cam, x.cfg)
            for label, a in calls.items():
                got = planesweep_cuda.planesweep_match(*a)
                want = planesweep_cuda.planesweep_match_plain(*a)
                e = max(max_err(g, v) for g, v in zip(got, want))
                log(f"  {w}x{h} frame {n} {label}: max err {e:.3g} over found, u, v, best NCC")
                err = max(err, e)
            state, _ = update_step(state, img, T, x.cam, x.cfg)
    if err != 0.0:
        raise AssertionError(f"the plane-sweep kernel differs from its plain version (max err {err})")
    return err


RECT_HEAD_SIZES = ((640, 480), (752, 480))


def hold_head(errs, label, cam, cfg, state, img, T_curr_ref):
    """``rect_head_cases.head_mismatches`` on one input: each head kernel
    against the plain version of its piece, and ``rect_match``'s chains
    against the walk of the plain pieces. Folds the max error per kernel
    into ``errs`` and returns what differs."""
    from rpg_open_remode_tpu_torch.testing import rect_head_cases as cases

    found = cases.head_mismatches(cam, cfg, state, img, T_curr_ref)
    for k, leaves in found.items():
        e = max(float(v[1]) if isinstance(v[1], (int, float)) else float("inf")
                for v in leaves.values())
        errs[k] = max(errs.get(k, 0.0), e)
    log(f"  {label}: " + ("every kernel and chain bit for bit" if not found
                          else f"DIFFERS {found}"))
    return found


def rect_head_phase(torch):
    """The head kernels (``csrc/rect_head.cu``) against their plain versions
    on the first 5 updates of the lateral stream (``testing/rect_head_cases``)
    at each of RECT_HEAD_SIZES, and on its straggler and no-valid cases
    (``hold_head``). Returns the max error per kernel (0)."""
    from rpg_open_remode_tpu_torch.ops import rect_match
    from rpg_open_remode_tpu_torch.testing import rect_head_cases as cases

    errs = dict.fromkeys(HEAD_KERNELS, 0.0)
    bad = {}
    gates = set()
    for w, h in RECT_HEAD_SIZES:
        cam, cfg, steps = cases.lateral_stream(w, h, "cuda")
        for i, name in cases.runs(steps):
            state, img, T_curr_ref = cases.case(steps[i], cfg, name)
            found = hold_head(errs, f"{w}x{h} update {i + 1} {name}", cam, cfg, state, img,
                              T_curr_ref)
            gates.add(bool(rect_match.prepare_sweep(state, img, T_curr_ref, cam, cfg)["gate"]))
            if found:
                bad[(w, i, name)] = found
    if bad or gates != {True, False}:
        raise AssertionError(f"the head kernels differ from their plain versions: {bad}; "
                             f"coarse gates seen {gates}")
    return errs


def run_head(torch, run, label):
    """``hold_head`` on frame KEEP_FRAME of a ``drive`` run (the state it
    updates, classified, its image and pose) at the run's own config: the
    head's shapes at another size. Returns the max error per kernel (0)."""
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image
    from rpg_open_remode_tpu_torch.testing import rect_head_cases as cases
    from rpg_open_remode_tpu_torch.utils import se3

    kept, eng = run["kept"], run["eng"]
    state = cases.classified(kept["before"], eng.cfg)
    img = prep_image(torch.as_tensor(np.asarray(kept["img"])).to(state.mu.device))
    Tcr = se3.compose(torch.tensor(kept["T"], device=img.device), state.T_world_ref)
    errs = dict.fromkeys(HEAD_KERNELS, 0.0)
    found = hold_head(errs, f"{label} frame {KEEP_FRAME}, head kernels", eng.cam, eng.cfg, state,
                      img, Tcr)
    if found:
        raise AssertionError(f"{label}: the head kernels differ from their plain versions: "
                             f"{found}")
    return errs


# the undistortion run: a mild plumb-bob lens on the 640x480 camera, over
# the first frames of the over_table sequence (rendered without distortion:
# the run drives the path, its accuracy is not held)
UNDISTORT = dict(k1=-0.05, k2=0.01, p1=5e-4, p2=-5e-4)
UNDISTORT_FRAMES = 12


def undistortion_run(torch, P, kernels, frames):
    """``Depthmap`` with ``init_undistortion_map(**UNDISTORT)`` over
    UNDISTORT_FRAMES frames and a denoise, the launch counts zeroed just
    before the keyframe and read just after the denoise: the 1-D resamplers
    once each per input image (``utils/warp.warp_grid``), and every kernel
    of the engine's path at least once. The last image's two passes (from
    ``input_image``, the eager form of what the programs replay) are held
    bit for bit against their plain versions. Returns the counts and
    errors."""
    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    h, w = f0.image.shape
    eng = P.Depthmap(w, h, CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"])
    eng.init_undistortion_map(**UNDISTORT)
    calls = {}

    def keep(kind, args):
        if kind in ("rows", "cols"):
            calls[kind] = args

    torch.cuda.synchronize()
    kernels.reset_launches()
    eng.set_reference_image(f0.image, Tcw(f0), d0.min(), d0.max())
    for fr in frames[1:UNDISTORT_FRAMES]:
        eng.update(fr.image, Tcw(fr))
    den = eng.denoised_depthmap(0.5, 200)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    with intercept(keep):
        eng.input_image(frames[UNDISTORT_FRAMES - 1].image)
    problems = [f"resample_{k}: {launches['resample_' + k]} launches, want {UNDISTORT_FRAMES}"
                for k in ("rows", "cols") if launches["resample_" + k] != UNDISTORT_FRAMES]
    problems += [f"{k} not launched" for k in PATH_KERNELS if launches[k] <= 0]
    if not np.isfinite(den).all():
        problems.append("non-finite denoised depth")
    log(f"  {UNDISTORT_FRAMES} frames with the undistortion grid {UNDISTORT}: launches "
        f"{launches}")
    if problems:
        raise AssertionError("the undistortion run: " + "; ".join(problems))
    from rpg_open_remode_tpu_torch.ops import resample_cuda

    errs = {f"resample_{k}": check_resample(resample_cuda, k, *args, "undistortion, last image")[0]
            for k, args in calls.items()}
    return dict(launches=launches, errs=errs)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mesh-only", action="store_true",
                        help="run only the device mesh phase (with four cards: a card a rank, "
                             "NCCL) and print no ok line")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import rpg_open_remode_tpu_torch as P
    from rpg_open_remode_tpu_torch import eval as peval
    from rpg_open_remode_tpu_torch import kernels

    dev = torch.device("cuda")
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
    log("kernels built and loaded")

    if opts.mesh_only:
        phase(f"the device mesh alone ({torch.cuda.device_count()} card(s))")
        mesh = mesh_phase(torch, P, kernels, make_frames(640, 480, CAM_640, MESH_FRAMES))
        log(f"== total {time.perf_counter() - T_START:.1f} s")
        print(json.dumps({"checks": {"mesh": mesh}}, default=float))
        return 0

    phase("kernel parity (numpy-seeded, ragged-band and edge-case inputs, main-path shapes)")
    errs = kernel_parity(torch, dev, P, MAIN_SIZES)

    phase("kernel parity at the live and FHD rows' configurations (752x480; 1920x1080 at "
          "patch 15 and 17 with 383 planes)")
    for k, e in kernel_parity(torch, dev, P, ROW_SIZES).items():
        errs[k] = max(errs[k], e)

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

    phase(f"the fused tail (csrc/seed_update.cu) against its plain version, both flavours, "
          f"at {', '.join(f'{w}x{h}' for w, h in SEED_UPDATE_SIZES)}")
    errs["seed_update"] = seed_update_phase(torch)

    phase(f"the plane-sweep kernel (csrc/planesweep.cu) against its plain version on a forward "
          f"dolly at {', '.join(f'{w}x{h}' for w, h in PLANESWEEP_SIZES)}")
    errs["planesweep"] = planesweep_phase(torch)

    phase("the rectified step's head kernels (csrc/rect_head.cu) against their plain versions "
          "on the lateral stream's first updates, 640x480 and 752x480")
    errs.update(rect_head_phase(torch))

    phase("profiler over the replayed 640x480 run (the trace's launches held to the counts)")
    launches = profile_run(torch, P, kernels, frames640, CAM_640, "640x480 run")
    if {k: launches[k] for k in PATH_KERNELS} != {k: run640["launches"][k] for k in PATH_KERNELS}:
        raise AssertionError(f"the profiled replay's launches {launches} differ from "
                             f"the main path's {run640['launches']}")

    phase("main path 1280x720 (80 frames, focal-scaled config, denoise)")
    frames720 = make_frames(1280, 720, CAM_720, 80)
    run720 = drive(torch, P, kernels, frames720, CAM_720, keep_frame=KEEP_FRAME, first=KEEP_FRAME)
    report_run("1280x720", run720)
    log(f"  beside the JAX hd_1280x720 row {HD_ROW}")
    for lab, args in warp_instances(frame_warps(run720), "1280x720").items():
        errs["warp"] = max(errs["warp"], check_warp(args, lab))
    for k, e in run_head(torch, run720, "1280x720").items():
        errs[k] = max(errs[k], e)

    phase(f"752x480 ({FHD_FRAMES} frames through Depthmap at for_camera({CAM_752['fx']}); "
          f"frame {KEEP_FRAME}'s warps, whose output rows end in a partial tile)")
    run752 = warp_run(torch, P, kernels, "752x480", 752, 480, CAM_752, FHD_FRAMES)
    errs["warp"] = max(errs["warp"], run752["warp_err"])

    phase(f"the 1920x1080 configuration ({FHD_FRAMES} frames through Depthmap at "
          f"for_camera(1443.6); frame {KEEP_FRAME}'s own kernel inputs)")
    run1080, fhd_errs = size_run(torch, P, kernels, "1920x1080", 1920, 1080, peval.CAM_1080,
                                    FHD_FRAMES)
    for k, e in fhd_errs.items():
        errs[k] = max(errs[k], e)

    phase("the lens-undistortion path (the 1-D resamplers of utils/warp.warp_grid)")
    undist = undistortion_run(torch, P, kernels, frames640)
    for k, e in undist["errs"].items():
        errs[k] = max(errs[k], e)

    phase("the compiled programs: every step, chunk and reseed a CUDA graph replay, held bit "
          "for bit against the eager update_step")
    graphs = graphs_phase(torch, P, kernels, frames640, frames720, run1080.pop("rendered"))
    del frames720

    phase("keyframe lifecycle accuracy (eval.py's keyframe segments, 640x480, hardened scene)")
    fast = make_frames(640, 480, CAM_640, 190, step=peval.FAST_STEP)
    life, kept = lifecycle_accuracy(torch, P, frames640, fast)

    phase(f"depth propagation (switch {KEEP_SWITCH} of the fast_motion_propagated run)")
    errs["warp"] = max(errs["warp"], propagation(torch, P, kept))
    del kept, fast

    phase("the CLI on the card (cli.main in-process)")
    cli_out = cli_phase(torch, P, kernels, frames640)

    phase("concurrent-keyframe ring (bit-exactness, the node at B = 1, 2, 4, the CLI's "
          "--keyframes 4 run, the walk oracle)")
    ring = ring_phase(torch, P, kernels, frames640, run640)

    phase(f"the device mesh (the sharded step at {', '.join(map(str, MESH_SHAPES))} over "
          f"{MESH_FRAMES} frames, band slab kernels, sharded TV-L1, the CLI's --mesh 2,1,2 run)")
    mesh = mesh_phase(torch, P, kernels, frames640)

    log(f"== total {time.perf_counter() - T_START:.1f} s")
    checks = dict(max_abs_err=errs, over_table_640x480=a, lifecycle=life, graphs=graphs,
                  cli=cli_out, ring=ring, mesh=mesh)
    print(json.dumps({"checks": checks}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
