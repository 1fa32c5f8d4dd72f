#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--baseline DIR] [--mesh-only]

Builds the CUDA kernels of ``rpg_open_remode_tpu_torch/csrc`` and checks
each against its plain PyTorch version at the main path's shapes
(numpy-seeded, ragged-band and edge-case inputs), and again at the shapes of
EVAL.json's live and FHD rows (752x480; 1920x1080 at patch 15 and 17 with
383 planes), with the sweep's shared memory per block and blocks per SM
there; drives the single-keyframe engine through ``Depthmap`` at 640x480
(the hardened ``over_table`` protocol: 200 frames, one keyframe, a
200-iteration denoise) and at 1280x720 (80 frames, focal-scaled config),
checking the launch counters and the accuracy against the scene's ground
truth. The 640x480 run keeps the kernel inputs of frame 10 (the full sweep,
three warps) and of the last earlier frame that runs the coarse sweep; each
kernel is held bit for bit against its plain version and timed on those. A
12-frame 1920x1080 run at ``for_camera(1443.6)`` does the same on its own
frame-10 inputs and prints the plain versions' peak device memory. A replay
of the 640x480 run under ``torch.profiler`` sums each kernel's device time
and the device's busy share; it also keeps every sweep call's inputs, and
afterwards each call's work, bound and lane use (measured by the sweep
kernel's counting build) are added up over the run. Then the keyframe
lifecycle: eval.py's keyframe-segment rows (through the port's
``rpg_open_remode_tpu_torch.eval``), propagation, and the CLI in-process;
then the concurrent-keyframe ring: four slots held bit for bit against four
single engines, ``MultiKeyframeNode`` over the 200 frames at B = 1, 2 and 4,
the CLI's ``run --keyframes 4 --propagate`` with exact launch counts, and
the epipolar-walk oracle against the rectified matcher on frame 10. Then the
device mesh (``parallel/``): the sharded step at (1,1,1) (NCCL, one rank),
(1,2,2) and (2,1,2) (four spawned ranks sharing the card, gloo collectives
staged through pinned host memory; with four cards a card each over NCCL)
over the first 40 frames against single engines fed alike, every rank's
band-slab sweep and resample calls of frame 10 held bit for bit against
their plain versions and timed, the sharded TV-L1 and its gather against
the single-device denoise and the joined tiles, each program's form
printed and held (one graph under NCCL, segments between exchange points
under gloo), and the CLI's ``run --mesh 2,1,2 --keyframes 2
--propagate``. Then the port's bench, scaling report,
profile scripts (640x480 and 752x480) and roofline, each through its
``main()`` at its defaults in a process of its own with the launch counts
zeroed before and read after, the bench's accuracy held to the JAX engine's figures for the same
sequence. Each resample pass and each warp is also timed as one
``grid_sample`` call, the library yardstick.

The two-pass homography warp runs as one fused kernel (``csrc/warp.cu``):
three launches a rectified frame, one a pure-rotation frame, one a chunk of
planes in a propagated reseed. It is held bit for bit against its plain
version on every warp that the main path makes at 640x480 (frame 10's
three, and its pure-rotation warp), 752x480, 1280x720 and 1920x1080, on
the band slabs of the mesh and on the kept reseed's batches, and timed
there in turns (unfused, fused, fused, unfused) against the unfused route
it replaced (the coordinate fields in plain PyTorch, then the two 1-D
resampling kernels of ``csrc/resample.cu``); the 640x480 run is replayed
with each route in turns and must give the same depth map bit for bit. The
1-D kernels stay on the path of the lens-undistortion grid
(``Depthmap.init_undistortion_map``), which a short run of its own drives.

The engine's compiled programs (``models/programs.py``): on the card every
``Depthmap.update``, each frame of ``update_chunk``, every keyframe seed and
every ring slot's update is one CUDA graph replay, so the timed runs above
and after go through the graphs; the runs that watch the kernels' inputs
(``intercept``) drive the eager ``update_step`` on the engine's state
(``eager_update``), since a replay calls no wrapper. The ``graphs`` phase
holds the replays against the eager step bit for bit: the 200-frame
over_table run's state at frames 10, 100 and 199 and its denoised map, a
sequence that reaches all three matcher regimes (the host's choice against
the device's on every frame), the undistortion run, two propagated
switches, ``update_chunk`` with K = 16, and a ring of 4 against four eager
chains, with equal launch counts; it runs 54 replayed frames and a
replayed propagated switch under ``torch.cuda.set_sync_debug_mode("error")``,
and times graph against eager in turns at 640x480, 1280x720 and 1920x1080
(CUDA events and host clock), with the busy share of a replayed run, the
switch, the chunk, the captures and the graph pools.

``--baseline DIR`` also builds the kernels of another checkout's
``rpg_open_remode_tpu_torch/csrc`` (for example the parent commit, unpacked
with ``git archive``) in a temporary directory, times both versions on the
same inputs in turns (old, new, new, old), and profiles a replay with each.
Imports nothing of JAX.

``--mesh-only`` runs the card, build and device mesh phases alone and
prints no result line: on a machine with four cards every layout
runs a card a rank over NCCL, where each of the mesh's programs
must be one CUDA graph with its collectives captured inside.

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
import functools  # noqa: E402
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
CAM_752 = dict(fx=481.2, fy=-480.0, cx=375.5, cy=239.5)   # eval.py's live_752x480 row
# over_table row of the JAX package's EVAL.json and the bounds held here
OVER_TABLE = dict(converged_pct=68.3, within_raw=0.936, within_denoised=0.980)
HD_ROW = dict(converged_pct=64.8, within_raw=0.906)
KEEP_FRAME = 10
# the coarse pass runs only while wide bands cover > 15 % of the rect grid:
# in the 640x480 run on frame 7 but not on frame 10; its inputs are kept
# from the last frame up to KEEP_FRAME that runs it
COARSE_FROM = 3
# warp width; a one-thread-per-pixel sweep runs 32 consecutive x in a warp
WARP = 32

KERNELS = {
    "sweep": dict(source="rpg_open_remode_tpu_torch/csrc/sweep.cu",
                  replaces="rpg_open_remode_tpu/ops/sweep_pallas.py:86"),
    "warp": dict(source="rpg_open_remode_tpu_torch/csrc/warp.cu",
                 replaces="rpg_open_remode_tpu/ops/warp_pallas.py:73, "
                          "rpg_open_remode_tpu/ops/warp_pallas.py:124"),
    "resample_rows": dict(source="rpg_open_remode_tpu_torch/csrc/resample.cu",
                          replaces="rpg_open_remode_tpu/ops/warp_pallas.py:73"),
    "resample_cols": dict(source="rpg_open_remode_tpu_torch/csrc/resample.cu",
                          replaces="rpg_open_remode_tpu/ops/warp_pallas.py:124"),
    "tvl1": dict(source="rpg_open_remode_tpu_torch/csrc/tvl1.cu",
                 replaces="rpg_open_remode_tpu/ops/denoise_pallas.py:36, "
                          "rpg_open_remode_tpu/ops/denoise_pallas.py:177"),
    "seed_update": dict(source="rpg_open_remode_tpu_torch/csrc/seed_update.cu",
                        replaces="none: the frame step's tail after the back-warp, which XLA "
                                 "fused in the JAX package"),
}
# substrings of the device kernels' names in a profiler trace
KERNEL_SYMBOLS = {"sweep": "sweep_kernel", "warp": "homography_warp_kernel",
                  "resample_rows": "resample_rows_kernel",
                  "resample_cols": "resample_cols_kernel", "tvl1": "tvl1_",
                  "seed_update": "seed_update_kernel", "planesweep": "planesweep_match_kernel"}
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


def unfused_warp(img, H, out_h, out_w, x0=0.0, y0=0.0, want_uv=True):
    """The warp's unfused route, which the fused kernel replaced: per
    homography, the coordinate fields in plain PyTorch
    (``warp_cuda.two_pass_coords``), then the vertical and the horizontal
    1-D resampling kernels. The same arguments and values as
    ``warp_cuda.homography_warp``."""
    import torch

    from rpg_open_remode_tpu_torch.ops import resample_cuda, warp_cuda

    outs, us, vs = [], [], []
    for p in range(H.shape[0]):
        q, u, v = warp_cuda.two_pass_coords(H[p:p + 1], img.shape[-1], out_h, out_w, x0, y0)
        mid = resample_cuda.resample_rows(img, q[0])
        outs.append(resample_cuda.resample_cols(mid, u[0]))
        us.append(u)
        vs.append(v)
    if len(outs) == 1:
        out, u, v = outs[0][None], us[0], vs[0]
    else:
        out, u, v = torch.stack(outs), torch.cat(us), torch.cat(vs)
    return (out, u, v) if want_uv else (out, None, None)


@contextlib.contextmanager
def unfused_route():
    """Inside the block every warp of the engine takes ``unfused_warp``."""
    from rpg_open_remode_tpu_torch.ops import warp_cuda

    saved = warp_cuda.homography_warp
    warp_cuda.homography_warp = unfused_warp
    try:
        yield
    finally:
        warp_cuda.homography_warp = saved


def warp_work(args):
    """(bytes, operations) of one fused warp call: the source read once, the
    homographies read, the output (and u and v, when asked) written once;
    ~48 + 12 C operations a pixel (coordinates 48, a division counted as
    one; 3 lerps a channel)."""
    img, H, ho, wo, _, _, want_uv = warp_call(args)
    c, p = img.shape[0], H.shape[0]
    n = p * ho * wo
    return 4 * (img.numel() + 9 * p + c * n + (2 * n if want_uv else 0)), (48 + 12 * c) * n


def host_ms(torch, fn, n=20):
    """Host-clock milliseconds a call of ``fn()``: n calls from the first
    enqueue to the end of a device sync, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


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

    errs = {k: 0.0 for k in KERNELS}
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


def launch_figures(sizes):
    """The sweep's launch figures (dynamic shared memory per block, blocks
    per SM) for the full and coarse pass of each size's config."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.ops.sweep_cuda import sweep_occupancy

    out = {}
    for name, (_, _, fx, over) in sizes.items():
        cfg = RemodeConfig.for_camera(fx, **over)
        k_h = min(cfg.disp_pad // 2 - 1, cfg.num_planes // 2 + 1)
        for lab, k in (("full", cfg.num_planes), ("coarse", k_h)):
            occ = sweep_occupancy(cfg.patch_side, k)
            out[f"{name} {lab}"] = dict(occ, patch=cfg.patch_side, planes=k)
            log(f"  sweep launch, {name} {lab} pass (patch {cfg.patch_side}, {k} planes): "
                f"{occ['smem_bytes']} B of dynamic shared memory a block, "
                f"{occ['blocks_per_sm']} blocks of 256 threads an SM")
    return out


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

    t0 = time.perf_counter()
    frames = synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam,
                                seed=1, step=step, **HARDEN)
    log(f"  generated {n_frames} frames in {time.perf_counter() - t0:.1f} s")
    return frames


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


def replay(torch, P, frames, cam, kernels=None, events=None, kept=None, hook=None):
    """Set the keyframe on frames[0], update on the rest, denoise. With
    ``kernels`` the launch counts are zeroed just before the keyframe;
    ``events`` collects a pair of CUDA events around every update and the
    denoise (last); ``kept`` (a dict with a ``frame`` index) receives that
    frame's state, image and pose, and, per frame from COARSE_FROM to it,
    every sweep and warp input the engine passes to the kernels; ``hook(i,
    kind, args)`` (not with ``kept``) sees every sweep and warp call of frame
    i. The updates are graph replays (``Depthmap.update``) except on the
    frames that ``kept`` or ``hook`` watch, which take ``eager_update``.
    Returns (engine, denoised, wall ms from the keyframe to the denoise's
    end)."""
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
        if kept is not None and kept.get("first", COARSE_FROM) <= i <= kept["frame"]:
            if i == kept["frame"]:
                kept.update(state=eng.state, img=fr.image, T=T)
            calls = kept.setdefault("calls", {}).setdefault(i, [])
            frame_hook = (lambda kind, args: calls.append((kind, args)))
        update = eng.update if frame_hook is None else functools.partial(eager_update, eng)
        with intercept(frame_hook):
            timed(lambda: update(fr.image, T))
    den = timed(lambda: eng.denoised_depthmap(0.5, 200))
    torch.cuda.synchronize()
    return eng, den, (time.perf_counter() - t0) * 1e3


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
    """The timed run: the engine through ``Depthmap`` with the launch counts
    zeroed just before and read just after. With ``keep_frame`` it also keeps
    that frame's state, and the kernel inputs of frames ``first`` to it
    (``replay``). Returns timings, accuracy, the counts and what was kept."""
    kept = None if keep_frame is None else dict(frame=keep_frame, first=first)
    events = []
    eng, den, wall_ms = replay(torch, P, frames, cam, kernels=kernels, events=events, kept=kept)
    launches = dict(kernels.LAUNCHES)
    times = np.array([s.elapsed_time(e) for s, e in events])
    frame_ms, denoise_ms = times[:-1], float(times[-1])
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

    errs = {k: 0.0 for k in KERNELS}
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


def plain_peaks(torch, calls, eng):
    """Peak device memory of each plain version on the FHD run's own inputs:
    ``torch.cuda.max_memory_allocated`` over the call, less what was
    allocated before it. Returns bytes per call."""
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, sweep_cuda, warp_cuda

    cfg = eng.cfg
    g, mu = tvl1_weights(eng.state, cfg), eng.state.mu.contiguous()
    cases = {key: (lambda a=calls[key]: sweep_cuda.disparity_sweep_plain(*a))
             for key in ("sweep full", "sweep coarse")}
    for lab in RECT_WARPS:
        cases[f"warp {lab}"] = (
            lambda a=warp_call(calls["warps"][lab]): warp_cuda.homography_warp_plain(*a[:6]))
    cases["tvl1 200 iterations"] = lambda: denoise_cuda.tvl1_plain(mu, g, 0.5, 200, cfg)
    out = {}
    for key, fn in cases.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = fn()
        torch.cuda.synchronize()
        out[key] = torch.cuda.max_memory_allocated() - base
        del result
    log("  plain versions' peak device memory above their inputs at 1920x1080: "
        + ", ".join(f"{k} {v / 2 ** 20:.1f} MiB" for k, v in out.items())
        + f"; {torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f} GiB on the card")
    return out


def size_run(torch, P, kernels, label, width, height, cam, n_frames):
    """A short run of the hardened scene at another size through
    ``Depthmap`` at ``for_camera(fx)`` (launch counts zeroed just before,
    read just after, every kernel of the path launched): frame KEEP_FRAME's
    own sweep (full and the last coarse pass) and warp inputs, its
    pure-rotation warp, and the final state's TV-L1, held bit for bit
    against the plain versions."""
    frames = make_frames(width, height, cam, n_frames)
    run = drive(torch, P, kernels, frames, cam, keep_frame=KEEP_FRAME, first=1)
    run["rendered"] = frames
    cfg = run["eng"].cfg
    log(f"  config for_camera({cam['fx']}): patch {cfg.patch_side}, {cfg.num_planes} "
        f"planes, disp_pad {cfg.disp_pad}")
    report_run(label, run)
    calls = frame_calls(run)
    errs = real_input_parity(torch, P, run, calls, size=label, cpu_check=False)
    return run, calls, errs


def fhd_run(torch, P, kernels):
    """``size_run`` of the 1920x1080 scene at ``for_camera(1443.6)`` (patch
    15, 383 planes); the plain versions' peak memory; each kernel timed on
    frame KEEP_FRAME's inputs beside its bound and plain time, the warps in
    turns with the unfused route."""
    from rpg_open_remode_tpu_torch.eval import CAM_1080

    run, calls, errs = size_run(torch, P, kernels, "1920x1080", 1920, 1080, CAM_1080,
                                FHD_FRAMES)
    peaks = plain_peaks(torch, calls, run["eng"])
    rows = sweep_timings(torch, calls, f"the {FHD_FRAMES}-frame 1920x1080 run")
    rows["warp"] = warp_timings(torch, warp_instances(calls["warps"], "1920x1080"))
    rows["tvl1"] = tvl1_timing(torch, run["eng"], "200 iterations at 1920x1080")
    log_timings(rows)
    return dict(run=run, errs=errs, peaks=peaks, timings=rows)


# -- work, bounds and lane use ------------------------------------------------------


def sweep_work(torch, args):
    """What one sweep call's data needs (``ops/accounting.call_work``: the
    pairs the kernel scores, the ZNCC's operations on them, which the bound
    takes, the kernel's own count and the bytes), and ``slots_pixel_model``:
    the lane-slots that a one-thread-per-pixel loop (the sweep before its
    tile-balanced design) takes by a model of its schedule, not a
    measurement (a warp of 32 consecutive x runs as long as its longest
    band)."""
    from rpg_open_remode_tpu_torch.ops.accounting import call_work

    wk = call_work(*args)
    band = wk.pop("band")
    h, w = band.shape
    rows = torch.nn.functional.pad(band, (0, -(-w // WARP) * WARP - w))
    wk["slots_pixel_model"] = float(rows.reshape(h, -1, WARP).amax(-1).sum() * WARP)
    return wk


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
    bound and measured lane use, and each warp's bound."""
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms

    tot = {k: dict(calls=0, pairs=0.0, bound_ms=0.0, busy_frames=[], scoring=[0, 0],
                   per_pixel=[0, 0], pixel_loop_model=[0.0, 0.0])
           for k in ("sweep full", "sweep coarse")}
    tot.update({k: dict(calls=0, bound_ms=0.0) for k in ("warp", "rows", "cols", "sweep off")})
    for i, kind, x in calls:
        if kind == "sweep off":
            tot[kind]["calls"] += 1   # a coarse pass gated off on the device: no work
            continue
        if kind == "sweep":
            t = tot["sweep full" if x[10] else "sweep coarse"]
            lu = lane_use(torch, x)
            wk = lu["work"]
            t["pairs"] += wk["pairs"]
            t["bound_ms"] += bound_ms(wk["bytes"], wk["flops"])[0]
            for f in ("scoring", "per_pixel", "pixel_loop_model"):
                t[f] = [a + b for a, b in zip(t[f], lu[f])]
            if wk["pixels"] > 1000:
                t["busy_frames"].append(i)
        else:
            t = tot[kind]
            t["bound_ms"] += bound_ms(*x)[0]
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
    log(f"  sweep coarse gated off on the device: {tot['sweep off']['calls']} calls")
    for key in ("warp", "rows", "cols"):
        log(f"  {'warp' if key == 'warp' else 'resample_' + key}: {tot[key]['calls']} calls, "
            f"summed bound {tot[key]['bound_ms']:.4f} ms")
    return tot


def traced_kernels(torch, prof):
    """Each KERNEL_SYMBOLS kernel's device events in a profiler trace:
    {kernel: dict(ms=summed device ms, launches=events)}."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for k, sym in KERNEL_SYMBOLS.items():
        evs = [e for e in dev if sym in e.name]
        out[k] = dict(ms=sum(e.time_range.end - e.time_range.start for e in evs) / 1e3,
                      launches=len(evs))
    return out


def profile_run(torch, P, kernels, frames, cam, label, account=False):
    """The 640x480 run as ``drive`` runs its updates, each a graph replay
    (no hook), under torch.profiler (CPU and CUDA activity): each kernel's
    summed device ms and launches, and the device's busy share (the union
    of all device activity, over the span from the first to the last device
    event, and over the wall time of the same run unprofiled, made just
    before). The launch counts are zeroed just before the profiled run and
    read just after, and each kernel's launches in the trace must equal
    them: the trace shows that the replays launched what the counts say.
    With ``account`` an eager pass (not profiled: ``replay``'s hook makes
    every update ``eager_update``, whose wrappers see the inputs) keeps
    every sweep call's inputs and each warp pass's bytes, and ``run_work``
    adds them up. Returns (profile, engine)."""
    from torch.profiler import ProfilerActivity, profile

    from rpg_open_remode_tpu_torch.utils.profiling import device_busy_ms

    _, _, wall_ms = replay(torch, P, frames, cam)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng, _, _ = replay(torch, P, frames, cam, kernels=kernels)
    launches = dict(kernels.LAUNCHES)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = device_busy_ms(prof)
    if busy is None:
        raise AssertionError("the profiler recorded no device activity")
    span = (max(e.time_range.end for e in dev_events)
            - min(e.time_range.start for e in dev_events)) / 1e3
    out = dict(busy_ms=busy, span_ms=span, wall_ms=wall_ms, busy_share_span=busy / span,
               busy_share_wall=busy / wall_ms, launches=launches,
               kernels=traced_kernels(torch, prof))
    log(f"  profile {label}: device busy {out['busy_ms']:.3f} ms = "
        f"{100 * out['busy_share_span']:.2f} % of the profiled span {out['span_ms']:.1f} ms, "
        f"{100 * out['busy_share_wall']:.2f} % of the same run's unprofiled wall {wall_ms:.1f} ms")
    for k, r in out["kernels"].items():
        log(f"  profile {label}: {k} {r['ms']:.4f} ms device over {r['launches']} launches "
            f"(counted {launches[k]})")
    off = {k: (r["launches"], launches[k]) for k, r in out["kernels"].items()
           if r["launches"] != launches[k]}
    if off:
        raise AssertionError(f"{label}: the trace's launches differ from the counts "
                             f"(traced, counted): {off}")
    if account:
        calls = []

        def keep(i, kind, args):
            calls.append((i, kind, args if kind.startswith("sweep") else warp_work(args)
                          if kind == "warp" else resample_bytes(kind, *args)))

        replay(torch, P, frames, cam, hook=keep)
        out["work"] = run_work(torch, calls)
    return out, eng


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
PROP_LABEL = "propagated_reseed"


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
        t0 = time.perf_counter()
        keep = KEEP_SWITCH if name == "fast_motion_propagated" else None
        r = segment_row(name, over_table, fast, keep_switch=keep)
        kept = r.pop("kept", None) or kept
        r["seconds"] = time.perf_counter() - t0
        ok, line = peval.judge(name, r)
        out[name] = dict(converged_pct=r["mean_converged_pct_per_kf"],
                         within=100 * r["mean_within_2p6pct"], keyframes=r["keyframes"],
                         seconds=r["seconds"], ok=ok)
        log(f"  {name}: {r['keyframes']} keyframes of {r['updates_per_keyframe'] + 1} frames, "
            f"per keyframe {line}, {r['seconds']:.1f} s")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"lifecycle rows outside the EVAL.json bounds: {bad}")
    return out, kept


def propagation(torch, P, kept):
    """Depth propagation on the kept switch: each of its warp calls (C=3,
    full image, ``propagate.WARP_CHUNK`` planes a call) against the plain
    version; those calls timed as CUDA graphs and on the host clock in turns
    with the unfused route (one warp a plane), beside their summed bound,
    their plain versions and grid_sample; the whole reseed with each route
    in turns (CUDA events; the seeded states must agree bit for bit); one
    reseed with each route under the profiler for its device operations."""
    from torch.profiler import ProfilerActivity, profile

    from rpg_open_remode_tpu_torch.models import depthmap
    from rpg_open_remode_tpu_torch.models.state import SceneParams
    from rpg_open_remode_tpu_torch.ops import propagate, warp_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    eng = kept["eng"]
    img = eng.input_image(kept["img"])
    T = torch.tensor(kept["T"], device=eng.device)
    scene = SceneParams.create(*kept["bounds"], eng.cfg, device=eng.device)

    def reseed():
        return depthmap._set_reference_propagated(kept["state"], img, T, scene, eng.cam, eng.cfg)

    calls = []
    with intercept(lambda kind, args: calls.append((kind, args))):
        state = reseed()
    h, w = img.shape
    warps = [warp_call(args) for kind, args in calls if kind == "warp"]
    n_calls = -(-propagate.PLANES // propagate.WARP_CHUNK)
    shapes = sorted({(tuple(c[0].shape), c[2], c[3]) for c in warps})
    planes = [c[1].shape[0] for c in warps]
    if (len(calls) != n_calls or len(warps) != n_calls or shapes != [((3, h, w), h, w)]
            or sum(planes) != propagate.PLANES):
        raise AssertionError(f"propagation made the calls {[k for k, _ in calls]} of {shapes}, "
                             f"{planes} planes")
    out = dict(carried_pct=100.0 * float((state.sigma_sq != scene.sigma_sq_max).float().mean()))
    err = max(check_warp(c, f"reseed call {k}") for k, c in enumerate(warps))
    routes = dict(fused=lambda: [warp_cuda.homography_warp(*c) for c in warps],
                  unfused=lambda: [unfused_warp(*c) for c in warps])
    turns = {k: [] for k in ("fused", "unfused", "fused_host", "unfused_host", "reseed_fused",
                             "reseed_unfused")}
    states = {}
    for which in ("unfused", "fused", "fused", "unfused"):
        turns[which].append(graph_ms(routes[which], n=2, reps=5))
        turns[which + "_host"].append(host_ms(torch, routes[which], n=3))
        with unfused_route() if which == "unfused" else contextlib.nullcontext():
            turns["reseed_" + which].append(cuda_ms(torch, reseed, 5, 1))
            states[which] = reseed()
    differ = [f.name for f in dataclasses.fields(state) if f.name != "scene" and max_err(
        getattr(states["fused"], f.name), getattr(states["unfused"], f.name)) != 0.0]
    if differ:
        raise AssertionError(f"the fused and unfused reseeds differ in {differ}")
    libs = [grid_sample_warp(torch, c) for c in warps]
    lib_err = max(e for _, e, _ in libs)
    if lib_err > GRID_SAMPLE_TOL:
        raise AssertionError(f"grid_sample is no bilinear sample at the warp's (u, v): {lib_err:.3g}")
    work = [warp_work(c) for c in warps]
    mean = {k: float(np.mean(v)) for k, v in turns.items()}
    out["warp"] = dict(
        calls=len(warps), planes=planes, max_abs_err=err,
        bound=bound_ms(sum(b for b, _ in work), sum(f for _, f in work)),
        ms=mean["fused"], unfused_ms=mean["unfused"], host_ms=mean["fused_host"],
        unfused_host_ms=mean["unfused_host"], turns=turns,
        plain_ms=cuda_ms(torch, lambda: [warp_cuda.homography_warp_plain(*c[:6]) for c in warps],
                         3, 1),
        library_ms=graph_ms(lambda: [f() for f, _, _ in libs], n=2, reps=5), library_err=lib_err,
        library_vs_two_pass=max(d for _, _, d in libs))
    del libs
    out["reseed_ms"], out["reseed_ms_unfused"] = mean["reseed_fused"], mean["reseed_unfused"]
    for which in ("fused", "unfused"):
        with unfused_route() if which == "unfused" else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                reseed()
                torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        tag = "" if which == "fused" else "_unfused"
        out["device_ops_per_switch" + tag] = len(names)
        out["copies_per_switch" + tag] = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    r = out["warp"]
    log(f"  propagated reseed, in turns (unfused, fused, fused, unfused): fused "
        f"{turns['reseed_fused']} ms, unfused {turns['reseed_unfused']} ms (CUDA events); "
        f"states equal bit for bit; {out['carried_pct']:.2f} % of pixels carried; "
        f"{out['device_ops_per_switch']} device operations per switch fused "
        f"({out['copies_per_switch']} copies or fills), {out['device_ops_per_switch_unfused']} "
        f"unfused ({out['copies_per_switch_unfused']}; profiler)")
    log(f"  warp, the reseed's {r['calls']} calls of {planes} planes: {r['ms']:.4f} ms (CUDA "
        f"graph; the unfused route's {propagate.PLANES} planes {r['unfused_ms']:.4f} ms), host "
        f"clock {r['host_ms']:.4f} ms (unfused {r['unfused_host_ms']:.4f} ms); plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, share "
        f"{r['bound'][0] / r['ms']:.3f}; grid_sample {r['library_ms']:.4f} ms (max err "
        f"{lib_err:.3g} against the bilinear gather, {r['library_vs_two_pass']:.3g} against "
        f"the two-pass value)")
    return out


def reseed_operations(torch, events, label):
    """The device operations that each ``label`` range of a profiler trace
    launched, one list of ``(name, ms)`` a range. The profiler gives every
    kernel, copy and fill the correlation id of the host call that launched
    it (a kernel launch, a copy, or for each kernel of a CUDA graph the
    graph's launch); an operation is the range's when that call ran inside
    the range. Only the host's clock is read: skew between the host's and
    the device's clocks cannot move an operation into or out of a range."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [e.time_range for e in events if e.name == label and e.device_type != cuda]
    calls = {e.id: e.time_range.start for e in events
             if e.device_type != cuda and e.name.startswith("cu")}
    ops = [[] for _ in ranges]
    for e in events:
        if e.device_type == cuda and e.name != label and e.id in calls:
            t = calls[e.id]
            for i, r in enumerate(ranges):
                if r.start <= t <= r.end:
                    ops[i].append((e.name, (e.time_range.end - e.time_range.start) / 1e3))
    return ops


def profile_lifecycle(torch, P, fast):
    """Replay fast_motion_propagated under torch.profiler with each
    propagated reseed in a ``PROP_LABEL`` range; a device operation is the
    reseed's when a host call inside the range launched it
    (``reseed_operations``). Returns per-kernel device ms and launches, in
    the reseeds and over the run, and the device operations per switch;
    fails unless every reseed launched the warp once a chunk of planes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from rpg_open_remode_tpu_torch.ops import propagate

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        segment_row("fast_motion_propagated", None, fast,
                    reseed_wrap=lambda: record_function(PROP_LABEL))
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in events
           if e.device_type == cuda and e.name != PROP_LABEL]
    spans = reseed_operations(torch, events, PROP_LABEL)
    inside = [op for ops in spans for op in ops]
    out = dict(switches=len(spans), device_ops_per_switch=len(inside) / max(len(spans), 1),
               kernels={})
    for k, sym in KERNEL_SYMBOLS.items():
        row_k = {}
        for where, ops in (("run", dev), ("reseeds", inside)):
            mine = [ms for name, ms in ops if sym in name]
            row_k[where] = dict(launches=len(mine), ms=sum(mine))
        out["kernels"][k] = row_k
        log(f"  profile fast_motion_propagated: {k} {row_k['run']['ms']:.4f} ms over "
            f"{row_k['run']['launches']} launches, of which the {len(spans)} reseeds "
            f"{row_k['reseeds']['ms']:.4f} ms over {row_k['reseeds']['launches']}")
    per = -(-propagate.PLANES // propagate.WARP_CHUNK)
    warps = [sum(KERNEL_SYMBOLS["warp"] in name for name, _ in ops) for ops in spans]
    log(f"  profile fast_motion_propagated: {out['device_ops_per_switch']:.1f} device "
        f"operations per propagated reseed; the warp launched {warps} times in the "
        f"{len(spans)} reseeds (by construction {per} each)")
    if not spans or any(w != per for w in warps):
        raise AssertionError("the reseeds' warp launches are not one a chunk of planes")
    return out


@contextlib.contextmanager
def timed_node(torch, rec, ring=False):
    """Inside the block, CUDA events around every ``process_frame`` of the
    node (``DepthmapNode``, or ``MultiKeyframeNode`` with ``ring``) and
    every keyframe seed (``Depthmap.set_reference_image``,
    ``BatchedDepthmap.seed_keyframe``) (``rec['frame']``, ``rec['reseed']``),
    and the host clock around every finalization on the worker thread
    (``rec['finalize_s']``), with the stream it ran on (``rec['streams']``)."""
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap
    from rpg_open_remode_tpu_torch.models.multikeyframe import BatchedDepthmap, MultiKeyframeNode
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode, LifecycleNode

    node_cls, (eng_cls, seed) = ((MultiKeyframeNode, (BatchedDepthmap, "seed_keyframe")) if ring
                                 else (DepthmapNode, (Depthmap, "set_reference_image")))
    saved = (node_cls.process_frame, getattr(eng_cls, seed), LifecycleNode._complete_keyframe)

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

    node_cls.process_frame = events(saved[0], "frame")
    setattr(eng_cls, seed, events(saved[1], "reseed"))
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
    slot-update). ``keyframes`` > 1: the ring's run. Returns its figures."""
    from rpg_open_remode_tpu_torch import cli
    from rpg_open_remode_tpu_torch.io import load_state
    from rpg_open_remode_tpu_torch.ops import propagate as prop

    rec = {}
    main_stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_node(torch, rec, ring=keyframes > 1):
        node = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_kf, n_seeds, n_frames = len(node.keyframes), len(rec["reseed"]), len(rec["frame"])
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
    if rec.get("streams") != {main_stream}:
        problems.append(f"finalization ran on streams {rec.get('streams')}, not {main_stream}")
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
    ms = np.array([s.elapsed_time(e) for s, e in rec["frame"]])
    reseed_ms = np.array([s.elapsed_time(e) for s, e in rec["reseed"]])[keyframes:]
    r = dict(frames=n_frames, keyframes=n_kf, updates=n_updates, switches=n_switches,
             launches=launches, wall_s=wall, frame_ms_median=float(np.median(ms)),
             frame_ms_p90=float(np.percentile(ms, 90)),
             switch_ms_median=float(np.median(reseed_ms)) if n_switches else float("nan"),
             finalize_ms_median=1e3 * float(np.median(rec["finalize_s"])),
             converged_pct=[k.converged_percentage for k in node.keyframes])
    log(f"  {n_frames} frames, {n_kf} keyframes, {n_switches} switches "
        f"({'propagated' if propagate else 'flat'}), {wall:.1f} s; launches {launches} "
        f"(want {want}, sweep {n_updates}-{2 * n_updates}); per frame median "
        f"{r['frame_ms_median']:.3f} ms, p90 {r['frame_ms_p90']:.3f} ms; switch median "
        f"{r['switch_ms_median']:.3f} ms; finalization on the worker thread median "
        f"{r['finalize_ms_median']:.1f} ms (TV-L1, download, exports)")
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
    must run): per-frame ms (CUDA events, the seeding frame left out),
    switch ms, finalization ms on the worker (which must run on the loop's
    stream), and each finalized keyframe's accuracy against the GT of the
    frame it was keyed on."""
    h, w = frames[0].image.shape
    node = P.MultiKeyframeNode(P.BatchedDepthmap(
        B, w, h, CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"]))
    rec = {}
    main_stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with timed_node(torch, rec, ring=True):
        for fr in frames:
            node.process_frame(fr.image, Tcw(fr), *gt_bounds(fr))
        node.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the ring at B={B}: {missing}")
    if rec.get("streams") != {main_stream}:
        raise AssertionError(f"ring finalization ran on streams {rec.get('streams')}")
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
    ms = np.array([s.elapsed_time(e) for s, e in rec["frame"][1:]])
    switch = np.array([s.elapsed_time(e) for s, e in rec["reseed"][B:]])

    def mean_of(key):
        vals = [a[key] for a in accs if np.isfinite(a[key])]
        return float(np.mean(vals)) if vals else float("nan")

    r = dict(B=B, frames=len(frames), keyframes=len(node.keyframes), wall_s=wall,
             launches=launches, frame_ms_median=float(np.median(ms)),
             frame_ms_p90=float(np.percentile(ms, 90)),
             switch_ms_median=float(np.median(switch)) if switch.size else float("nan"),
             switches=int(switch.size),
             finalize_ms_median=1e3 * float(np.median(rec["finalize_s"])),
             converged_pct=mean_of("converged_pct"), within=100 * mean_of("within_raw"))
    log(f"  ring B={B}: {r['frames']} frames, {r['keyframes']} keyframes finalized, "
        f"{r['switches']} reseeds, {wall:.1f} s; per frame median {r['frame_ms_median']:.3f} ms, "
        f"p90 {r['frame_ms_p90']:.3f} ms; switch median {r['switch_ms_median']:.3f} ms; "
        f"finalization on the loop's stream, median {r['finalize_ms_median']:.2f} ms; per "
        f"finalized keyframe converged {r['converged_pct']:.4f} %, within 2.6 % "
        f"{r['within']:.4f} %; launches {launches}")
    if not node.keyframes:
        raise AssertionError(f"the ring finalized no keyframe at B={B}")
    return r


def walk_oracle(torch, P, run640):
    """The epipolar-walk oracle on frame KEEP_FRAME of the 640x480 run
    (its kept state, image and pose) beside the rectified matcher: where
    both are confident (NCC > 0.9, 10 px inside the image) their matches
    must lie within a median 1.5 px (tests/test_matching.py); and the
    walk's time (CUDA events)."""
    from rpg_open_remode_tpu_torch.ops import epipolar
    from rpg_open_remode_tpu_torch.utils import se3

    kept, eng = run640["kept"], run640["eng"]
    state, cfg = kept["state"], eng.cfg
    img = eng.input_image(kept["img"])
    T_curr_ref = se3.compose(torch.tensor(kept["T"], device=img.device), state.T_world_ref)
    rect = epipolar.match(state, img, T_curr_ref, eng.cam, cfg)

    def walk():
        return epipolar.match_epipolar_walk(state, img, T_curr_ref, eng.cam, cfg)

    wk = walk()
    both = rect.found & wk.found & (rect.best_ncc > 0.9) & (wk.best_ncc > 0.9)
    inside = torch.zeros_like(both)
    inside[10:-10, 10:-10] = True
    both = both & inside
    err = torch.hypot(rect.u - wk.u, rect.v - wk.v)[both]
    r = dict(steps=cfg.max_walk_steps, found_pct=100 * float(wk.found.float().mean()),
             both=int(both.sum()), median_px=float(err.median()) if err.numel() else float("nan"),
             p90_px=float(torch.quantile(err, 0.9)) if err.numel() else float("nan"),
             ms=cuda_ms(torch, walk, 3, 1))
    h, w = img.shape
    log(f"  walk oracle, frame {KEEP_FRAME} at {w}x{h} ({r['steps']} steps of "
        f"[{h}, {w}, {cfg.patch_area}] gathers): found {r['found_pct']:.2f} %; against the "
        f"rectified matcher on {r['both']} pixels both confident: median {r['median_px']:.4f} "
        f"px, p90 {r['p90_px']:.4f} px; {r['ms']:.2f} ms")
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
# the switch frames of the CLI's mesh run when its node ran eagerly (NVIDIA
# H100 80GB HBM3 at 700 W): printed beside the replayed ones
MESH_SWITCH_EAGER_MS = "1293.7-1647.7"
# the limit of a switch frame's and the next frame's loop time: one frame
# period at 30 fps (PERF.md section 2); printed against, not held
FRAME_PERIOD_MS = 33.0
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
    equal to the host's). Per frame and path: the host-clock ms
    (synchronized), the launch counts and staged bytes it added; the
    replayed (1, 1, 1) frames run under ``set_sync_debug_mode("error")``.
    Keeps the eager frames COARSE_FROM..KEEP_FRAME's kernel calls (the
    band's slab shapes) and holds each of KEEP_FRAME's, and the last coarse
    pass up to it, against its plain version; times them; with ``denoise``
    also runs the sharded TV-L1 both ways. Last, the last
    MESH_PROFILE_FRAMES frames are replayed again with the launch counts
    zeroed just before, rank 0 under the profiler: each kernel's launches
    in its trace against the counts. Returns the rank's tiles and
    figures."""
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
    per = {"eager": [], "replay": []}   # per frame: (ms, launches, staged bytes)
    debug_frames = 0
    regime_off = 0       # frames whose host regime is not the device's
    reseed_err = None
    for j in range(1, len(frames)):
        for which in (("eager", "replay") if j % 2 else ("replay", "eager")):
            c0 = counts()
            t0 = time.perf_counter()
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
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            per[which].append((ms, *since(c0)))
        if mesh.axis_size("kf") == 2 and j == MESH_RESEED:
            reseed_both(1, j)
            reseed_err = tiles_err(local_block(progs.states), local_block(states))
    torch.cuda.synchronize()
    step_prog = [p for key, p in progs.cache.items() if key[0] == "step"]
    out = dict(rank=mesh.rank, backend=mesh.backend, device=str(dev),
               frame_ms={k: [x[0] for x in v] for k, v in per.items()},
               launches={k: [x[1] for x in v] for k, v in per.items()},
               staged={k: [x[2] for x in v] for k, v in per.items()},
               state=local_block(progs.states),
               state_err=tiles_err(local_block(progs.states), local_block(states)),
               reseed_err=reseed_err, debug_frames=debug_frames, regime_off=regime_off,
               regime_bytes=regime_bytes * len(states),
               packed=progs.packed.cpu().numpy(),
               packed_err=max_err(progs.packed, stats["packed"]),
               exchange_points=[len(p.exchanges) for p in step_prog],
               graphs=[len(p.graph) for p in step_prog],
               captures={p.label: p.capture_s for p in progs.captures()})
    # one rank at a time, so that no other rank's work shares the card
    for turn in range(mesh.size):
        if turn == mesh.rank:
            out["calls"] = slab_parity(torch, slab_calls(torch, kept, KEEP_FRAME))
        dist.barrier()
    if denoise:
        run = build_sharded_denoise(mesh, cfg, h, w, iterations=cfg.denoise_iters)
        slots = list(range(len(states)))
        den_ms, dev_ms = {}, []
        for which in ("eager", "first call", "replay", "replay"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "eager":
                den = run(states, cfg.denoise_lambda)
            else:
                progs.snapshot(slots)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                got = progs.denoise(slots, cfg.denoise_lambda)
                ev[1].record()
            torch.cuda.synchronize()
            den_ms.setdefault(which, []).append(1e3 * (time.perf_counter() - t0))
            if which == "replay":
                dev_ms.append(ev[0].elapsed_time(ev[1]))
        (dprog,) = [p for key, p in progs.cache.items() if key[0] == "denoise"]
        out.update(denoise=np.stack([d.cpu().numpy() for d in got]),
                   denoise_err=max(max_err(g, d) for g, d in zip(got, den)),
                   denoise_ms={k: min(v) for k, v in den_ms.items()},
                   denoise_device_ms=min(dev_ms),
                   denoise_exchange_points=len(dprog.exchanges),
                   denoise_capture_s=dprog.capture_s,
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
                              traced=traced_kernels(torch, prof))
    out["pool_mib"] = progs.pool_bytes() / 2 ** 20
    return out


def slab_parity(torch, calls):
    """Each kept kernel call against its plain version, and its time (CUDA
    graph) beside its bound, the plain version's time and, for a warp, one
    ``grid_sample`` call's and the unfused route's in turns
    (``warp_timing``)."""
    from rpg_open_remode_tpu_torch.ops import resample_cuda, sweep_cuda, warp_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    out = []
    for i, kind, args in calls:
        library_ms = None
        if kind == "warp":
            call = warp_call(args)
            got = warp_cuda.homography_warp(*call)
            want = warp_cuda.homography_warp_plain(*call[:6])
            err = max(max_err(g, x) for g, x in zip(got, want) if g is not None)
            img, H, ho, wo, x0, y0, _ = call
            r = warp_timing(torch, None, call)
            out.append(dict(frame=i, name=f"warp {WARP_LABELS[img.shape[0]]} C={img.shape[0]}",
                            shape=str((tuple(img.shape), (ho, wo), (x0, y0))), max_abs_err=err,
                            **{k: r[k] for k in ("ms", "bound", "plain_ms", "library_ms",
                                                 "unfused_ms", "host_ms", "unfused_host_ms",
                                                 "share")}))
            continue
        if kind == "sweep":
            got = sweep_cuda.disparity_sweep(*args)
            want = sweep_cuda.disparity_sweep_plain(*args)
            err = max(max_err(g, x) for g, x in zip(got, want))
            wk = sweep_work(torch, args)
            name = "sweep " + ("full" if args[10] else "coarse")
            fn = (lambda a=args: sweep_cuda.disparity_sweep(*a))
            bnd = bound_ms(wk["bytes"], wk["flops"])
            plain = (lambda a=args: sweep_cuda.disparity_sweep_plain(*a))
            shape = tuple(args[2].shape)
        else:
            fn_k = getattr(resample_cuda, f"resample_{kind}")
            plain_k = getattr(resample_cuda, f"resample_{kind}_plain")
            err = max_err(fn_k(*args), plain_k(*args))
            name = f"resample_{kind} C={args[0].shape[0]}"
            fn, bnd = (lambda f=fn_k, a=args: f(*a)), bound_ms(*resample_bytes(kind, *args))
            plain = (lambda f=plain_k, a=args: f(*a))
            lib, _ = grid_sample_call(torch, kind, *args)
            library_ms = graph_ms(lib)
            shape = (tuple(args[0].shape), tuple(args[1].shape))
        out.append(dict(frame=i, name=name, shape=str(shape), max_abs_err=err,
                        ms=graph_ms(fn), bound=bnd, plain_ms=cuda_ms(torch, plain, 3, 1),
                        library_ms=library_ms))
    return out


def mesh_reference(torch, P, frames):
    """The single-device engine fed alike: ``Depthmap``s seeded on frame 0
    and on MESH_RESEED, each updated on every later frame (the slots of a
    kf = 2 mesh). Returns their final states and the per-frame ms of the
    first (CUDA events)."""
    h, w = frames[0].image.shape
    cam = (CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"])
    out, ms = [], []
    for first in (0, MESH_RESEED):
        eng = P.Depthmap(w, h, *cam)
        eng.set_reference_image(frames[first].image, Tcw(frames[first]), *gt_bounds(frames[first]))
        for fr in frames[first + 1:MESH_FRAMES]:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            eng.update(fr.image, Tcw(fr))
            e.record()
            if first == 0:
                ms.append((s, e))
        out.append(eng)
    torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in ms]


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


def fmt_ms(xs):
    return f"median {np.median(xs):.3f} ms, p90 {np.percentile(xs, 90):.3f} ms"


def fmt_max(x):
    return "none" if x is None else f"{x:.1f}"


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
    host memory; one rank, NCCL."""
    from rpg_open_remode_tpu_torch.models.depthmap import denoise_depthmap
    from rpg_open_remode_tpu_torch.parallel import join_state_numpy, run_ranks
    from rpg_open_remode_tpu_torch.parallel.programs import GATHERED

    frames = frames640[:MESH_FRAMES]
    feed = [(fr.image, Tcw(fr), gt_bounds(fr)) for fr in frames]
    refs, ref_ms = mesh_reference(torch, P, frames)
    out = dict(single_ms_median=float(np.median(ref_ms)),
               single_ms_p90=float(np.percentile(ref_ms, 90)), meshes={})
    log(f"  single engine (replayed), first {MESH_FRAMES} frames: per frame "
        f"{fmt_ms(ref_ms)} (CUDA events)")
    bad = []
    for shape in MESH_SHAPES:
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, shape, (feed, shape in MESH_DENOISE), device="cuda",
                          timeout=600)
        got = join_state_numpy([r["state"] for r in ranks], shape)
        n = len(ranks)
        ms = {k: np.array(v) for k, v in ranks[0]["frame_ms"].items()}
        r = dict(seconds=time.perf_counter() - t0, backend=ranks[0]["backend"],
                 devices=[x["device"] for x in ranks],
                 frame_ms_median=float(np.median(ms["replay"])),
                 frame_ms_p90=float(np.percentile(ms["replay"], 90)),
                 eager_ms_median=float(np.median(ms["eager"])),
                 eager_ms_p90=float(np.percentile(ms["eager"], 90)),
                 staged_bytes_per_frame=sum(sum(x["staged"]["replay"]) for x in ranks) / len(
                     ms["replay"]),
                 launches=[{k: sum(f[k] for f in x["launches"]["replay"]) for k in
                            x["launches"]["replay"][0]} for x in ranks],
                 state_err=max(x["state_err"] for x in ranks),
                 packed_err=max(x["packed_err"] for x in ranks),
                 reseed_err=None if shape[0] != 2 else max(x["reseed_err"] for x in ranks),
                 exchange_points=ranks[0]["exchange_points"], graphs=ranks[0]["graphs"],
                 captures=[x["captures"] for x in ranks], pool_mib=[x["pool_mib"] for x in ranks],
                 debug_frames=ranks[0]["debug_frames"], slots=[], calls=[])
        # the eager frame stages the replay's bytes plus its device regime's
        same_counts = all(x["launches"]["replay"] == x["launches"]["eager"]
                          and [b + x["regime_bytes"] for b in x["staged"]["replay"]]
                          == x["staged"]["eager"] for x in ranks)
        r["regime_off"] = sum(x["regime_off"] for x in ranks)
        log(f"  mesh {shape}: replayed (host regime) against eager (device regime, "
            f"{ranks[0]['regime_bytes']} B staged a frame per rank for its kf max) from the same "
            f"start, max err states {r['state_err']:.3g}, packed stats {r['packed_err']:.3g}"
            + ("" if r["reseed_err"] is None else
               f", the slot reseeded on frame {MESH_RESEED} {r['reseed_err']:.3g}")
            + f"; frames whose host regime differs from the device's (all ranks) "
            f"{r['regime_off']}; launches of every frame equal, staged bytes equal but for the "
            f"device regime's: {same_counts}")
        if (r["state_err"] != 0.0 or r["packed_err"] != 0.0 or r["reseed_err"]
                or r["regime_off"] or not same_counts):
            bad.append(f"{shape}: the replayed run differs from the eager run")
        prof = r["profile"] = ranks[0]["profile"]
        off = {k: (t["launches"], prof["counted"][k]) for k, t in prof["traced"].items()
               if t["launches"] != prof["counted"][k]}
        log(f"  mesh {shape}: rank 0 replayed its last {prof['frames']} frames again under the "
            f"profiler: launches traced (counted) "
            + ", ".join(f"{k} {t['launches']} ({prof['counted'][k]})"
                        for k, t in prof["traced"].items())
            + f"; sweep {prof['traced']['sweep']['ms']:.3f} ms, warp "
            f"{prof['traced']['warp']['ms']:.3f} ms device")
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
        for x in ranks:
            for c in x["calls"]:
                c = dict(c, rank=x["rank"])
                r["calls"].append(c)
                lib = ("" if c["library_ms"] is None
                       else f", grid_sample {c['library_ms']:.4f} ms")
                if "unfused_ms" in c:
                    lib += (f"; the unfused route {c['unfused_ms']:.4f} ms, host clock "
                            f"{c['unfused_host_ms']:.4f} ms against {c['host_ms']:.4f} ms, "
                            f"share of the bound {c['share']:.3f}")
                log(f"    rank {x['rank']} frame {c['frame']} {c['name']} {c['shape']}: max err "
                    f"{c['max_abs_err']:.3g}; {c['ms']:.4f} ms (CUDA graph), bound "
                    f"{c['bound'][0]:.4f} ms by {c['bound'][1]}, plain {c['plain_ms']:.4f} ms{lib}")
                if c["max_abs_err"] != 0.0:
                    bad.append(f"{shape} rank {x['rank']} {c['name']} differs from its plain version")
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
            d_ms = {k: max(x["denoise_ms"][k] for x in ranks) for k in ranks[0]["denoise_ms"]}
            r["denoise"] = dict(ms=d_ms["replay"], eager_ms=d_ms["eager"],
                                device_ms=max(x["denoise_device_ms"] for x in ranks),
                                first_call_ms=d_ms["first call"], max_abs_err=err,
                                within=ok, replay_err=rep_err, gathered_err=gathered_err,
                                exchange_points=ranks[0]["denoise_exchange_points"],
                                capture_s=[x["denoise_capture_s"] for x in ranks])
            log(f"  mesh {shape} sharded TV-L1 ({cfg.denoise_iters} iterations, 1-px halos, "
                f"plain PyTorch) and the gather to each row's leader: replayed "
                f"{d_ms['replay']:.1f} ms host clock, {r['denoise']['device_ms']:.1f} ms CUDA "
                f"events (slowest rank), eager {d_ms['eager']:.1f} ms, first call (eager "
                f"warm-up and capture) {d_ms['first call']:.1f} ms; "
                f"{r['denoise']['exchange_points']} exchange points, so "
                f"{r['denoise']['exchange_points'] + 1} graph segments; capture "
                f"{', '.join(f'{c or 0.0:.2f}' for c in r['denoise']['capture_s'])} s per rank; "
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
        caps = [f"{max(c.values()):.3f}" for c in r["captures"] if c] or ["none"]
        log(f"  mesh {shape}: {n} rank(s), backend {r['backend']}, devices {r['devices']}; "
            f"sharded step per frame (rank 0, host clock, synchronized, in turns) replayed "
            f"{fmt_ms(ms['replay'])}, eager {fmt_ms(ms['eager'])}; {r['exchange_points']} "
            f"exchange points a frame ({r['graphs']} graphs); slowest capture per rank "
            f"{', '.join(caps)} s; graph pool {', '.join(f'{m:.1f}' for m in r['pool_mib'])} "
            f"MiB per rank; staged {r['staged_bytes_per_frame'] / 1e6:.3f} MB per frame over all "
            f"ranks; replayed launches per rank {r['launches']}; {r['seconds']:.1f} s")
        if shape == (1, 1, 1) or r["backend"] == "nccl":
            log(f"  mesh {shape}: {r['debug_frames']} replayed frames under "
                f"set_sync_debug_mode('error'): no host synchronization")
            if r["debug_frames"] < MESH_FRAMES - 3 or r["graphs"] != [1] * len(r["graphs"]):
                bad.append(f"{shape}: {r['debug_frames']} frames under sync debug, graphs "
                           f"{r['graphs']}")
        missing = [(i, k) for i, x in enumerate(r["launches"]) for k in ("sweep", "warp")
                   if x[k] <= 0]
        if missing or not r["calls"]:
            bad.append(f"{shape}: kernels not launched {missing}")
        out["meshes"][str(shape)] = r
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
        t0 = time.perf_counter()
        res = cli.main(argv)
        wall = time.perf_counter() - t0
        files = sorted(p.name for p in out_dir.iterdir())
    n_kf = len(res.keyframes)
    # the switch frames that replayed every program, and the frames after them
    replayed = [(ms, x["after_switch_ms"][i] if i < len(x["after_switch_ms"]) else None)
                for x in res.ranks for i, ms in enumerate(x["switch_ms"])
                if not x["switch_first_call"][i]]
    r = dict(wall_s=wall, keyframes=n_kf, switches=res.switches,
             launches=[x["launches"] for x in res.ranks],
             frame_ms_median=float(np.median(res.ranks[0]["frame_ms"])),
             frame_ms_p90=float(np.percentile(res.ranks[0]["frame_ms"], 90)),
             frame_ms_max=max(max(x["frame_ms"]) for x in res.ranks),
             switch_ms=[x["switch_ms"] for x in res.ranks],
             after_switch_ms=[x["after_switch_ms"] for x in res.ranks],
             switch_first_call=[x["switch_first_call"] for x in res.ranks],
             replayed_switch_ms_max=max((a for a, _ in replayed), default=None),
             replayed_after_switch_ms_max=max((b for _, b in replayed if b is not None),
                                              default=None),
             staged_bytes=[x["staged"]["bytes"] for x in res.ranks],
             converged_pct=[k.converged_percentage for k in res.keyframes])
    for x in res.ranks:
        sw = ", ".join(f"{t:.1f}" + (" (first call)" if first else "")
                       for t, first in zip(x["switch_ms"], x["switch_first_call"]))
        nxt = ", ".join(f"{t:.1f}" for t in x["after_switch_ms"])
        log(f"    rank {x['rank']} ({x['device']}, {x['backend']}): launches {x['launches']}, "
            f"{x['keyframes']} keyframes exported, staged {x['staged']['bytes'] / 1e6:.1f} MB; "
            f"the loop's ms on the frames that finalized a keyframe (snapshot, reseeds, the "
            f"sharded TV-L1 and the gather, replayed) {sw}; on the frame after each {nxt} (an "
            f"eager node's switch frame: {MESH_SWITCH_EAGER_MS} ms)")
    log(f"  the CLI's mesh run: {n_kf} keyframes, switches {res.switches}, {wall:.1f} s; per "
        f"frame median {r['frame_ms_median']:.3f} ms, p90 {r['frame_ms_p90']:.3f} ms (rank 0), "
        f"max {r['frame_ms_max']:.1f} ms (any rank); the switch frames with no first call, "
        f"max {fmt_max(r['replayed_switch_ms_max'])} ms, the frames after them max "
        f"{fmt_max(r['replayed_after_switch_ms_max'])} ms (one frame period: "
        f"{FRAME_PERIOD_MS} ms)")
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


def grid_sample_call(torch, kind, img, coord):
    """One ``torch.nn.functional.grid_sample`` call (bilinear, border
    padding, align_corners) that computes ``resample_<kind>(img, coord)``:
    the resampled coordinate normalized, the other pinned to its integer
    index. Returns (the call, max |call - plain version| over the image's
    largest magnitude). The grid is built outside the call."""
    from rpg_open_remode_tpu_torch.ops import resample_cuda

    c, hs, ws = img.shape
    ho, wo = coord.shape
    dev = img.device
    if kind == "rows":
        gx = (2.0 * torch.arange(wo, device=dev, dtype=torch.float32) / (ws - 1) - 1.0).expand(ho, wo)
        gy = 2.0 * coord / (hs - 1) - 1.0
    else:
        gx = 2.0 * coord / (ws - 1) - 1.0
        gy = (2.0 * torch.arange(ho, device=dev, dtype=torch.float32) / (hs - 1) - 1.0)[:, None]
        gy = gy.expand(ho, wo)
    grid = torch.stack([gx, gy], -1)[None].contiguous()
    src = img[None].contiguous()

    def call():
        return torch.nn.functional.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                                               align_corners=True)[0]

    plain = getattr(resample_cuda, f"resample_{kind}_plain")(img, coord)
    scale = max(float(img.abs().max()), 1e-30)
    return call, float((call() - plain).abs().max()) / scale


# grid_sample's normalized coordinate rounds the pinned index and the
# resampled coordinate by ~1e-7 of the axis length (<= ~1e-4 px here), so
# it may differ from the plain version by that fraction of a step between
# neighbours: held at 1e-3 of the image's largest magnitude
GRID_SAMPLE_TOL = 1e-3


# -- the port's bench, scaling, profile and roofline scripts -----------------


# The JAX engine's figures for the bench's 60-frame 640x480 sequence: the JAX
# package on the CPU (JAX_PLATFORMS=cpu), following bench.py:140-194 step for
# step (the port on the CPU gives 73.7542 % and 0.995745). The port's bench
# line is held within BENCH_CONVERGED points and BENCH_WITHIN of them.
JAX_BENCH = dict(converged_percent=73.75390625, within_2p6pct_range=0.9957541090690818)
BENCH_CONVERGED, BENCH_WITHIN = 0.1, 0.002
PROFILE_SIZES = ("640x480", "752x480")
# each script's module, and the kernels its path launches (the profile
# scripts and the scaling report run no denoise; the roofline times the
# sweep alone)
SCRIPTS = {
    "bench": ("rpg_open_remode_tpu_torch.bench", []),
    "bench_scaling": ("rpg_open_remode_tpu_torch.bench_scaling", []),
    "profile_update": ("rpg_open_remode_tpu_torch.scripts.profile_update", list(PROFILE_SIZES)),
    "profile_match": ("rpg_open_remode_tpu_torch.scripts.profile_match", list(PROFILE_SIZES)),
    "roofline": ("rpg_open_remode_tpu_torch.scripts.roofline", []),
}
SCRIPT_KERNELS = {
    "bench": ("sweep", "warp", "tvl1"),
    "bench_scaling": ("sweep", "warp"),
    "profile_update": ("sweep", "warp"),
    "profile_match": ("sweep", "warp"),
    "roofline": ("sweep",),
}
SCRIPT_TIMEOUT_S = 600


def positive(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and np.isfinite(x) and x > 0


def run_script(torch, kernels, name, path):
    """``--script NAME``: the script's ``main()`` at its defaults in this
    process, with the launch counts zeroed just before and read just after.
    Writes its exit code, launches, seconds and JSON record to ``path``."""
    import importlib

    module, argv = SCRIPTS[name]
    main = importlib.import_module(module).main
    line = path + ".line"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = main(argv + ["--json", line])
    torch.cuda.synchronize()
    out = dict(rc=rc, launches=dict(kernels.LAUNCHES), seconds=time.perf_counter() - t0)
    with open(line) as f:
        out["record"] = json.load(f)
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def scripts_phase():
    """Each script through its ``main()`` at its full defaults (the bench,
    the scaling report, both profile scripts at PROFILE_SIZES, the roofline
    at its three points), each in a process of its own as a user starts it
    (``run_script``: every kernel of its path must have launched). A fresh
    process also keeps the profile scripts' busy column readable:
    ``torch.profiler`` loses the last device records of its sessions in a
    process that has run for some minutes. Held: every fps and ms of the
    bench and scaling lines finite and > 0, the FHD point present, no
    ``error`` in the bench line, its accuracy within BENCH_CONVERGED /
    BENCH_WITHIN of JAX_BENCH; every profile row's device span, wall and
    device busy time and every roofline point's sweep time finite and > 0."""
    out, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (module, argv) in SCRIPTS.items():
            path = os.path.join(tmp, f"{name}.json")
            log(f"  python -m {module} {' '.join(argv + ['--json', '...'])} (a process of "
                f"its own)")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                   "--script", name, "--script-out", path],
                                  cwd=Path(__file__).resolve().parent, timeout=SCRIPT_TIMEOUT_S)
            process_s = time.perf_counter() - t0
            if proc.returncode != 0 or not os.path.exists(path):
                raise AssertionError(f"{name}: its process exited {proc.returncode}")
            with open(path) as f:
                res = json.load(f)
            missing = [k for k in SCRIPT_KERNELS[name] if res["launches"][k] <= 0]
            log(f"  {name}: exit {res['rc']}, {res['seconds']:.1f} s in main() "
                f"({process_s:.1f} s the process), launches {res['launches']}")
            if res["rc"] != 0 or missing:
                bad.append(f"{name}: exit {res['rc']}, kernels not launched {missing}")
            out[name] = dict(res, process_seconds=process_s)

    line = out["bench"]["record"]
    timed = [k for k in line if k.endswith(("_fps", "_ms"))] + ["value"]
    bad += [f"bench {k} = {line[k]}" for k in timed if not positive(line[k])]
    if line.get("fhd_1080p_fps") is None or line.get("fhd_1080p_denoise_ms") is None:
        bad.append("bench: no FHD point")
    if '"error"' in json.dumps(line):
        bad.append("bench: an error in the line")
    dc = line["converged_percent"] - JAX_BENCH["converged_percent"]
    dw = line["within_2p6pct_range"] - JAX_BENCH["within_2p6pct_range"]
    ok = abs(dc) <= BENCH_CONVERGED and abs(dw) <= BENCH_WITHIN
    log(f"  bench accuracy: converged {line['converged_percent']} % (JAX engine "
        f"{JAX_BENCH['converged_percent']:.4f}), within 2.6 % {line['within_2p6pct_range']} "
        f"(JAX {JAX_BENCH['within_2p6pct_range']:.4f}): {'ok' if ok else 'OUTSIDE'}")
    if not ok:
        bad.append("bench accuracy outside the JAX engine's figures")
    scaling = out["bench_scaling"]["record"]
    bad += [f"scaling {k} = {v}" for k, v in scaling.items()
            if k not in ("metric", "backend", "device_name", "power_limit_w") and not positive(v)]
    for name in ("profile_update", "profile_match"):
        for size, rows in out[name]["record"]["points"].items():
            bad += [f"{name} {size} {r['phase']} {c} = {r[c]}" for r in rows
                    for c in ("device", "wall", "busy") if not positive(r[c])]
    for pt in out["roofline"]["record"]["points"]:
        if not positive(pt["sweep_ms_measured"]):
            bad.append(f"roofline {pt['point']}: sweep {pt['sweep_ms_measured']}")
    if bad:
        raise AssertionError("; ".join(bad))
    return out


# -- the compiled programs: CUDA graph replays against the eager step --------------


GRAPH_TURNS = ("eager", "graph", "graph", "eager")
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


def timed_sequence(torch, P, kernels, which, frames, cam, cfg=None, undistort=None,
                   poses=None, switches=(), keep=(), denoise=False, debug=None):
    """One engine (``which``: "graph", a ``Depthmap``; "eager", the eager
    core) over ``frames``: keyframe on frame 0, a reseed (propagated with
    ``cfg.propagate_depth``) at each frame of ``switches``, an update on
    every other; ``poses[i]`` overrides frame i's pose. Launch counts zeroed
    before, read after; CUDA events and the host clock around every call;
    the states after the frames in ``keep`` (copies); ``debug`` = (first,
    end): frames run under ``torch.cuda.set_sync_debug_mode("error")``."""
    from rpg_open_remode_tpu_torch.models.state import clone

    poses = poses or {}
    eng = engine_of(torch, P, which, frames, cam, cfg, undistort)
    torch.cuda.synchronize()
    kernels.reset_launches()
    rec = dict(frame=[], switch=[], host=[], switch_host=[], packed=[], kept={})
    t_start = time.perf_counter()
    for i, fr in enumerate(frames):
        T = poses.get(i, Tcw(fr))
        if debug is not None and i == debug[0]:
            torch.cuda.set_sync_debug_mode("error")
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        if i == 0 or i in switches:
            eng.set_reference_image(fr.image, T, *gt_bounds(fr))
            key = "switch"
        else:
            rec["packed"].append(eng.update(fr.image, T)["packed"])
            key = "frame"
        e.record()
        rec[key].append((s, e))
        rec["host" if key == "frame" else "switch_host"].append(1e3 * (time.perf_counter() - t0))
        if debug is not None and i + 1 == debug[1]:
            torch.cuda.set_sync_debug_mode(0)
        if i in keep:
            rec["kept"][i] = clone(eng.state if which == "eager" else eng.programs.state)
    den = eng.denoised_depthmap(0.5, 200) if denoise else None
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t_start)
    ms = np.array([s.elapsed_time(e) for s, e in rec["frame"]])
    out = dict(eng=eng, launches=dict(kernels.LAUNCHES), wall_ms=wall, denoised=den,
               packed=rec["packed"], kept=rec["kept"],
               state=eng.state if which == "eager" else eng.programs.state,
               frame_ms_median=float(np.median(ms)), frame_ms_p90=float(np.percentile(ms, 90)),
               host_ms_median=float(np.median(rec["host"])),
               host_ms_p90=float(np.percentile(rec["host"], 90)),
               switch_ms=[s.elapsed_time(e) for s, e in rec["switch"][1:]],
               switch_host_ms=rec["switch_host"][1:])
    return out


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


def steady_busy(torch, eng, frames):
    """The device's busy share of a replayed run with every program already
    captured: ``eng`` (a ``Depthmap`` that ran ``frames``) keyed on frame 0
    again and updated on the rest, once by the wall clock and once under
    the profiler (``utils/profiling.profiled``, marker-checked)."""
    from rpg_open_remode_tpu_torch.utils.profiling import device_busy_ms, profiled

    def run():
        eng.set_reference_image(frames[0].image, Tcw(frames[0]), *gt_bounds(frames[0]))
        for fr in frames[1:]:
            eng.update(fr.image, Tcw(fr))

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    prof, marker = profiled(run)
    busy = device_busy_ms(prof, before=marker)
    return dict(wall_ms=wall, busy_ms=busy, busy_share_wall=busy / wall,
                frame_ms=wall / (len(frames) - 1))


def in_turns(torch, P, kernels, label, frames, cam, keep=(), denoise=False, busy=False):
    """``timed_sequence`` with each engine in turns (``GRAPH_TURNS``): the
    per-frame median and p90 (CUDA events and host clock) of each turn, and
    the first graph turn held against the first eager turn; with ``busy``
    the busy share of a steady replayed run (``steady_busy``)."""
    runs = {"eager": [], "graph": []}
    for which in GRAPH_TURNS:
        runs[which].append(timed_sequence(torch, P, kernels, which, frames, cam, keep=keep,
                                          denoise=denoise))
    cmp = compare_runs(label, runs["graph"][0], runs["eager"][0], keep)
    out = dict(compare=cmp, frames=len(frames))
    for which, rs in runs.items():
        for f in ("frame_ms_median", "frame_ms_p90", "host_ms_median", "host_ms_p90", "wall_ms"):
            out[f"{which}_{f}"] = [r[f] for r in rs]
    caps = runs["graph"][-1]["eng"].programs.captures()
    out["captures"] = [dict(label=p.label, capture_s=p.capture_s, captured_bytes=p.captured_bytes)
                       for p in caps]
    out["pool_bytes"] = runs["graph"][-1]["eng"].programs.pool_bytes()
    log(f"  {label} in turns {GRAPH_TURNS}: per frame median, CUDA events: graph "
        f"{fmt(out['graph_frame_ms_median'])} ms (p90 {fmt(out['graph_frame_ms_p90'])}), eager "
        f"{fmt(out['eager_frame_ms_median'])} ms (p90 {fmt(out['eager_frame_ms_p90'])}); host "
        f"clock a call: graph {fmt(out['graph_host_ms_median'])} ms (p90 "
        f"{fmt(out['graph_host_ms_p90'])}), eager {fmt(out['eager_host_ms_median'])} ms (p90 "
        f"{fmt(out['eager_host_ms_p90'])}); wall graph {fmt(out['graph_wall_ms'])} ms, eager "
        f"{fmt(out['eager_wall_ms'])} ms")
    if busy:
        out["steady"] = st = steady_busy(torch, runs["graph"][-1]["eng"], frames)
        log(f"  {label}, replayed with every program captured: wall {st['wall_ms']:.1f} ms "
            f"({st['frame_ms']:.3f} ms a frame), device busy {st['busy_ms']:.1f} ms = "
            f"{100 * st['busy_share_wall']:.2f} % of the wall (profiler)")
    log(f"  {label}: graph pool {out['pool_bytes'] / 2 ** 20:.1f} MiB; captures "
        + ", ".join(f"{c['label']} {1e3 * c['capture_s']:.1f} ms (+{c['captured_bytes'] / 2 ** 20:.1f}"
                    " MiB reserved)" for c in out["captures"]))
    return out


def fmt(xs):
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


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
    g = timed_sequence(torch, P, kernels, "graph", seq, CAM_640, poses=poses)
    e = timed_sequence(torch, P, kernels, "eager", seq, CAM_640, poses=poses)
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
    return dict(cmp, host=host, device=dev)


def undistortion_graphs(torch, P, kernels, frames):
    g = timed_sequence(torch, P, kernels, "graph", frames[:UNDISTORT_FRAMES], CAM_640,
                       undistort=UNDISTORT, denoise=True)
    e = timed_sequence(torch, P, kernels, "eager", frames[:UNDISTORT_FRAMES], CAM_640,
                       undistort=UNDISTORT, denoise=True)
    return compare_runs(f"undistortion ({UNDISTORT_FRAMES} frames)", g, e)


def propagated_graphs(torch, P, kernels, frames):
    """Two propagated switches, graph against eager; the second switch is a
    replay, and it and the frames around it run under
    ``set_sync_debug_mode("error")``: any host read fails the run. Then a
    replayed switch under the profiler: its device operations."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(P.RemodeConfig.for_camera(CAM_640["fx"]), propagate_depth=True)
    sched = SYNC_SCHEDULE
    seq = frames[:sched["frames"]]
    keep = tuple(k + 1 for k in sched["switches"])
    g = timed_sequence(torch, P, kernels, "graph", seq, CAM_640, cfg=cfg,
                       switches=sched["switches"], keep=keep, debug=sched["debug"])
    e = timed_sequence(torch, P, kernels, "eager", seq, CAM_640, cfg=cfg,
                       switches=sched["switches"], keep=keep)
    cmp = compare_runs(f"propagated switches at {sched['switches']} ({len(seq)} frames)", g, e,
                       keep)
    n_debug = sum(1 for i in range(*sched["debug"]) if i not in sched["switches"])
    eng = g["eng"]
    fr = seq[sched["switches"][-1]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.set_reference_image(fr.image, Tcw(fr), *gt_bounds(fr))
        torch.cuda.synchronize()
    ops = sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)
    prog = [p for k, p in eng.programs.cache.items() if k[0] == "set_reference_propagated"][0]
    out = dict(cmp, switch_ms=g["switch_ms"], switch_host_ms=g["switch_host_ms"],
               eager_switch_ms=e["switch_ms"], device_ops_per_switch=ops,
               capture_s=prog.capture_s, captured_bytes=prog.captured_bytes,
               pool_bytes=eng.programs.pool_bytes(), debug_frames=n_debug)
    log(f"  {n_debug} replayed frames and the replayed switch at frame {sched['switches'][-1]} "
        f"under set_sync_debug_mode('error'): no host synchronization")
    log(f"  propagated switch (replayed): {fmt(out['switch_ms'])} ms (CUDA events), host "
        f"{fmt(out['switch_host_ms'])} ms; eager {fmt(out['eager_switch_ms'])} ms; "
        f"{ops} device operations (profiler); capture {1e3 * prog.capture_s:.1f} ms; graph pool "
        f"{out['pool_bytes'] / 2 ** 20:.1f} MiB")
    return out


def chunk_graphs(torch, P, kernels, frames):
    """``Depthmap.update_chunk`` with K = CHUNK_K (K replays a call, no host
    read between them) over three chunks against the eager chain; the
    third chunk timed (CUDA events a call, over K)."""
    seq = frames[:1 + 3 * CHUNK_K]
    h, w = seq[0].image.shape
    eng = P.Depthmap(w, h, CAM_640["fx"], CAM_640["cx"], CAM_640["fy"], CAM_640["cy"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    eng.set_reference_image(seq[0].image, Tcw(seq[0]), *gt_bounds(seq[0]))
    packed, events, host = [], [], []
    for c in range(3):
        part = seq[1 + c * CHUNK_K: 1 + (c + 1) * CHUNK_K]
        imgs = np.stack([fr.image for fr in part])
        Ts = np.stack([Tcw(fr) for fr in part])
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        packed.append(eng.update_chunk(imgs, Ts))
        e.record()
        host.append(1e3 * (time.perf_counter() - t0))
        events.append((s, e))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ref = timed_sequence(torch, P, kernels, "eager", seq, CAM_640)
    errs = dict(state=state_err(eng.programs.state, ref["state"]),
                stats=max_err(torch.cat(packed), torch.stack(ref["packed"])))
    ms = [s.elapsed_time(e) / CHUNK_K for s, e in events]
    log(f"  update_chunk K={CHUNK_K}, 3 chunks: max err state {errs['state']:.3g}, stats "
        f"{errs['stats']:.3g}; launches {launches} (eager {'equal' if launches == ref['launches'] else ref['launches']}); "
        f"per frame {fmt(ms)} ms (CUDA events over a chunk / K), host {fmt([x / CHUNK_K for x in host])} ms")
    if max(errs.values()) != 0.0 or launches != ref["launches"]:
        raise AssertionError("update_chunk differs from the eager chain")
    return dict(errs, frame_ms=ms, host_ms=[x / CHUNK_K for x in host], launches=launches)


def ring_graphs(torch, P, frames):
    """A ring of RING_EXACT_B slots (each slot's update and reseed a replay)
    against as many eager chains fed alike over RING_EXACT_FRAMES frames
    (slot i reseeded flat on frame 10 i), bit for bit; the slots' graph
    pools."""
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
    pools = [p.pool_bytes() for p in ring.programs]
    log(f"  ring of {RING_EXACT_B} (graphs) against {RING_EXACT_B} eager chains over "
        f"{RING_EXACT_FRAMES} frames: max err state {err:.3g}, stats {stats_err:.3g}; graph "
        f"pools {[round(b / 2 ** 20, 1) for b in pools]} MiB, "
        f"{sum(pools) / 2 ** 20:.1f} MiB in all")
    if err != 0.0 or stats_err != 0.0:
        raise AssertionError("a ring slot's replays differ from its eager chain")
    return dict(state=err, stats=stats_err, pool_bytes=pools)


def graphs_phase(torch, P, kernels, frames640, frames720, frames1080):
    """The compiled programs on the card: every replay against the eager
    ``update_step`` it captured, bit for bit, and the timings graph against
    eager in turns."""
    out = {}
    out["640x480"] = in_turns(torch, P, kernels, f"640x480 over_table ({len(frames640)} frames, "
                              "denoise)", frames640, CAM_640, keep=GRAPH_KEEP, denoise=True,
                              busy=True)
    out["regimes"] = regimes_run(torch, P, kernels, frames640)
    out["undistortion"] = undistortion_graphs(torch, P, kernels, frames640)
    out["propagated"] = propagated_graphs(torch, P, kernels, frames640)
    out["chunk"] = chunk_graphs(torch, P, kernels, frames640)
    out["ring"] = ring_graphs(torch, P, frames640)
    from rpg_open_remode_tpu_torch.eval import CAM_1080

    out["1280x720"] = in_turns(torch, P, kernels, f"1280x720 ({len(frames720)} frames)",
                               frames720, CAM_720, busy=True)
    out["1920x1080"] = in_turns(torch, P, kernels, f"1920x1080 ({len(frames1080)} frames)",
                                frames1080, CAM_1080, busy=True)
    return out


# -- kernel timings ------------------------------------------------------------


def sweep_timings(torch, calls, what):
    """The full and coarse sweep passes of ``calls`` (``frame_calls``):
    CUDA-graph time, plain time, bound and measured lane use."""
    from rpg_open_remode_tpu_torch.ops import sweep_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    rows = {}
    for key in ("sweep full", "sweep coarse"):
        args = calls[key]
        lu = lane_use(torch, args)
        wk = lu["work"]
        rows[key] = dict(
            ms=graph_ms(lambda: sweep_cuda.disparity_sweep(*args)),
            plain_ms=cuda_ms(torch, lambda: sweep_cuda.disparity_sweep_plain(*args), 3, 1),
            bound=bound_ms(wk["bytes"], wk["flops"]), lanes=lu,
            work=f"{key.split()[1]} pass, frame "
            f"{KEEP_FRAME if key == 'sweep full' else calls['coarse frame']} of {what}")
    return rows


def resample_timings(torch, calls):
    """The undistortion path's two 1-D passes (``calls``: kind -> one call's
    arguments): CUDA-graph time, plain time, one ``grid_sample`` call (the
    library yardstick), bound."""
    from rpg_open_remode_tpu_torch.ops import resample_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    rows = {}
    for kind, (img, coord) in calls.items():
        fn = getattr(resample_cuda, f"resample_{kind}")
        plain = getattr(resample_cuda, f"resample_{kind}_plain")
        lib, lib_err = grid_sample_call(torch, kind, img, coord)
        if lib_err > GRID_SAMPLE_TOL:
            raise AssertionError(f"grid_sample is no resample_{kind}: {lib_err:.3g}")
        rows[f"resample_{kind}"] = dict(
            ms=graph_ms(lambda: fn(img, coord)), plain_ms=cuda_ms(torch, lambda: plain(img, coord), 20),
            library_ms=graph_ms(lib), library_err=lib_err,
            bound=bound_ms(*resample_bytes(kind, img, coord)),
            work=f"one call of the undistortion run ({tuple(img.shape)} -> {tuple(coord.shape)})")
    return rows


def warp_instances(warps, size):
    """``frame_warps``' warps labelled with their image size."""
    return {f"{size} {lab}": args for lab, args in warps.items()}


def warp_run(torch, P, kernels, label, width, height, cam, n_frames):
    """A short run through ``Depthmap`` at ``for_camera(fx)`` (launch
    counts zeroed just before, read just after, every kernel of the path
    launched) that keeps frame KEEP_FRAME's warps (``frame_warps``), each
    held bit for bit against the plain version. Returns (run, label ->
    arguments)."""
    frames = make_frames(width, height, cam, n_frames)
    run = drive(torch, P, kernels, frames, cam, keep_frame=KEEP_FRAME, first=KEEP_FRAME)
    report_run(label, run)
    warps = warp_instances(frame_warps(run), label)
    run["warp_err"] = max(check_warp(args, lab) for lab, args in warps.items())
    return run, warps


def grid_sample_warp(torch, call):
    """One ``grid_sample`` call (bilinear, border padding, align_corners,
    one batch entry a homography) at the warp's source coordinates (u, v),
    the grid built outside the call. grid_sample is a 2-D bilinear sample,
    not the two-pass value: it is held to the plain 4-tap bilinear gather
    at (u, v) within GRID_SAMPLE_TOL of the image's largest magnitude, and
    its difference from the two-pass value is reported. Returns (the call,
    that error, the difference)."""
    from rpg_open_remode_tpu_torch.ops import warp_cuda
    from rpg_open_remode_tpu_torch.utils.interp import bilinear

    img, H, ho, wo, x0, y0, _ = call
    c, hs, ws = img.shape
    p = H.shape[0]
    two_pass, u, v = warp_cuda.homography_warp_plain(img, H, ho, wo, x0, y0)
    grid = torch.stack([2.0 * u / (ws - 1) - 1.0, 2.0 * v / (hs - 1) - 1.0], -1).contiguous()
    src = img[None].expand(p, c, hs, ws).contiguous()

    def lib():
        return torch.nn.functional.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                                               align_corners=True)

    got = lib()
    scale = max(float(img.abs().max()), 1e-30)
    err = max(float((got[k] - bilinear(img, u[k], v[k])).abs().max()) for k in range(p)) / scale
    return lib, err, float((got - two_pass).abs().max()) / scale


def warp_timing(torch, label, args):
    """One warp call: the fused kernel and the unfused route in turns
    (unfused, fused, fused, unfused), each as a CUDA graph (device ms a
    call) and on the host clock (ms a call); one grid_sample call; the
    plain version; the bound. Logged under ``label`` (None: not logged)."""
    from rpg_open_remode_tpu_torch.ops import warp_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    call = warp_call(args)
    routes = dict(fused=lambda: warp_cuda.homography_warp(*call),
                  unfused=lambda: unfused_warp(*call))
    turns = {k: [] for k in ("fused", "unfused", "fused_host", "unfused_host")}
    for which in ("unfused", "fused", "fused", "unfused"):
        turns[which].append(graph_ms(routes[which]))
        turns[which + "_host"].append(host_ms(torch, routes[which]))
    lib, lib_err, lib_two_pass = grid_sample_warp(torch, call)
    if lib_err > GRID_SAMPLE_TOL:
        raise AssertionError(f"grid_sample is no bilinear sample at the warp's (u, v): {lib_err:.3g}")
    nb, nf = warp_work(call)
    r = dict(ms=float(np.mean(turns["fused"])), host_ms=float(np.mean(turns["fused_host"])),
             unfused_ms=float(np.mean(turns["unfused"])),
             unfused_host_ms=float(np.mean(turns["unfused_host"])), turns=turns,
             library_ms=graph_ms(lib), library_err=lib_err, library_vs_two_pass=lib_two_pass,
             plain_ms=cuda_ms(torch, lambda: warp_cuda.homography_warp_plain(*call[:6]), 5, 1),
             bytes=nb, flops=nf, bound=bound_ms(nb, nf))
    r["share"] = r["bound"][0] / r["ms"]
    if label is None:
        return r
    img, H = call[:2]
    log(f"  warp {label} (C={img.shape[0]}, {H.shape[0]} x {call[2]}x{call[3]}): fused "
        f"{r['ms']:.4f} ms device (CUDA graph), {r['host_ms']:.4f} ms host clock a call; "
        f"unfused route {r['unfused_ms']:.4f} ms device, {r['unfused_host_ms']:.4f} ms host; "
        f"plain {r['plain_ms']:.4f} ms; grid_sample {r['library_ms']:.4f} ms; bound "
        f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, share {r['share']:.3f} (turns "
        f"{turns['unfused'][0]:.4f}/{turns['fused'][0]:.4f}/{turns['fused'][1]:.4f}/"
        f"{turns['unfused'][1]:.4f} ms; grid_sample max err {lib_err:.3g} against the bilinear "
        f"gather, {lib_two_pass:.3g} against the two-pass value, of the image's largest "
        f"magnitude)")
    return r


def warp_timings(torch, instances):
    """``warp_timing`` of each instance (label -> arguments); the sums over
    the rectified matcher's three warps (the per-frame figures)."""
    per = {lab: warp_timing(torch, lab, args) for lab, args in instances.items()}
    rect = [r for lab, r in per.items() if lab.split(" ", 1)[1] in RECT_WARPS]
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms

    out = {k: sum(r[k] for r in rect) for k in ("ms", "host_ms", "unfused_ms",
                                               "unfused_host_ms", "plain_ms", "library_ms")}
    out.update(bound=bound_ms(sum(r["bytes"] for r in rect), sum(r["flops"] for r in rect)),
               per_call=per, work="the 3 warps of frame 10 (ref stack, curr, back-warp)")
    return out


def tvl1_timing(torch, eng, work):
    """TV-L1's 200 iterations on ``eng``'s final state: CUDA-graph time,
    plain time, bound."""
    from rpg_open_remode_tpu_torch.ops import denoise_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    g, mu, cfg = tvl1_weights(eng.state, eng.cfg), eng.state.mu.contiguous(), eng.cfg
    h, w = mu.shape
    return dict(
        ms=graph_ms(lambda: denoise_cuda.tvl1(mu, g, 0.5, 200, cfg), n=2, reps=5),
        plain_ms=cuda_ms(torch, lambda: denoise_cuda.tvl1_plain(mu, g, 0.5, 200, cfg), 2, 1),
        bound=bound_ms(4 * 3 * h * w, 200 * 28 * h * w), work=work)


def log_timings(rows):
    for k, r in rows.items():
        extra = ""
        if "lanes" in r:
            lu = r["lanes"]
            extra = (f", {lu['pairs']:.4g} pairs; lane use measured: scoring loop "
                     f"{share(lu['scoring']):.3f}, per-pixel loops {share(lu['per_pixel']):.3f}; "
                     f"one-thread-per-pixel loop by the schedule model (not measured) "
                     f"{share(lu['pixel_loop_model']):.3f}")
        if "unfused_ms" in r:
            extra = (f"; the unfused route {r['unfused_ms']:.4f} ms device, host clock "
                     f"{r['unfused_host_ms']:.4f} ms against the fused {r['host_ms']:.4f} ms; "
                     f"grid_sample {r['library_ms']:.4f} ms")
        elif "library_ms" in r:
            extra = (f", grid_sample {r['library_ms']:.4f} ms (max err {r['library_err']:.3g} "
                     f"of the image's largest magnitude)")
        log(f"  {k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}){extra}; {r['work']}")


SEED_UPDATE_SIZES = ((640, 480), (752, 480))
SEED_UPDATE_FRAMES = 4


def seed_update_bytes(h, w, rectified):
    """What the fused tail must move: the planes it reads (conv, mu,
    sigma_sq, a, b, f_ref x3, match_u, match_v, and the back-warp x3 or
    found (1 byte), u, v, best_ncc) and writes (mu, sigma_sq, a, b, conv,
    match_u, match_v, the NCC plane), each once, and the counts."""
    read = (13 * 4 if rectified else 13 * 4 + 1) * h * w
    return read + 8 * 4 * h * w + 5 * 4


def seed_update_phase(torch):
    """The fused tail (``csrc/seed_update.cu``) against its plain version
    at the main path's shapes: at each of SEED_UPDATE_SIZES, on
    SEED_UPDATE_FRAMES consecutive frames of ``scripts/profile_update.setup``
    (the state after its warm-up updates), each flavour (the rectified
    matcher's back-warped planes, and their unrectified match) bit for bit
    in every leaf; on the first frame each flavour's device time a call from
    CUDA graphs, the plain version's (CUDA events), the bound by bytes at
    3.35 TB/s. Returns the max error and the timings."""
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image
    from rpg_open_remode_tpu_torch.ops import rect_match, seed_check, seed_update_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms
    from rpg_open_remode_tpu_torch.scripts.profile_update import WARMUP, setup
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    dev = torch.device("cuda")
    err, rows = 0.0, {}
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
                if n == 0:
                    rows[f"{w}x{h} {flavour}"] = dict(
                        ms=graph_ms(lambda a=args: seed_update_cuda.fused_seed_update(*a)),
                        plain_ms=cuda_ms(torch, lambda a=args: seed_update_cuda.seed_update_plain(
                            *a), 20, 3),
                        plain_graph_ms=graph_ms(
                            lambda a=args: seed_update_cuda.seed_update_plain(*a), n=5),
                        bound=bound_ms(seed_update_bytes(h, w, flavour == "rectified"), 0.0),
                        work=f"{flavour} flavour, frame {i} at {w}x{h}")
            state = want[0]
    log_timings(rows)
    if err != 0.0:
        raise AssertionError(f"the fused tail differs from its plain version (max err {err})")
    return dict(err=err, rows=rows)


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
    bands narrowed to a few planes (most planes of a tile skipped); on the
    first frame the call's device time from CUDA graphs (with the einsum and
    plane set before the launch), the plain version's, the bound by
    operations or bytes at the card's peaks, and the share of (tile, plane)
    pairs skipped. Returns the max error and the timings."""
    from rpg_open_remode_tpu_torch.models.depthmap import update_step
    from rpg_open_remode_tpu_torch.ops import epipolar, planesweep_cuda
    from rpg_open_remode_tpu_torch.ops.accounting import bound_ms, planesweep_work
    from rpg_open_remode_tpu_torch.testing import planesweep_cases as cases
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    dev = torch.device("cuda")
    err, rows, skipped = 0.0, {}, {}
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
                planesweep_cuda.plane_counts(reset=True)
                got = planesweep_cuda.planesweep_match(*a)
                counts = planesweep_cuda.plane_counts(reset=True)
                want = planesweep_cuda.planesweep_match_plain(*a)
                e = max(max_err(g, v) for g, v in zip(got, want))
                share = counts["skipped"] / counts["pairs"]
                log(f"  {w}x{h} frame {n} {label}: max err {e:.3g} over found, u, v, best NCC; "
                    f"{counts['skipped']} of {counts['pairs']} (tile, plane) pairs skipped "
                    f"({100 * share:.1f} %)")
                err = max(err, e)
                skipped[f"{w}x{h} frame {n} {label}"] = share
                if n == 0 and label == "whole":
                    th, tw = a[2].shape
                    work = planesweep_work(th, tw, h, w, x.cfg.num_planes, x.cfg.patch_side)
                    rows[f"planesweep {w}x{h}"] = dict(
                        ms=graph_ms(lambda a=a: planesweep_cuda.planesweep_match(*a)),
                        plain_ms=graph_ms(lambda a=a: planesweep_cuda.planesweep_match_plain(*a),
                                          n=2, reps=3),
                        bound=bound_ms(work["bytes"], work["flops"]),
                        work=f"frame {n} at {w}x{h}, {work['pairs']:.4g} pairs, "
                             f"{100 * share:.1f} % of the (tile, plane) pairs skipped")
            state, _ = update_step(state, img, T, x.cam, x.cfg)
    log_timings(rows)
    if err != 0.0:
        raise AssertionError(f"the plane-sweep kernel differs from its plain version (max err {err})")
    return dict(err=err, rows=rows, skipped=skipped)


def kernel_timings(torch, run640, run720, calls, warps):
    """Each kernel's time on frame KEEP_FRAME's own inputs beside its plain
    version and its bound: the sweep, every warp of ``warps`` (size ->
    label -> arguments) in turns with the unfused route, TV-L1 (also on the
    1280x720 run's final state, the shapes of the tiled Pallas kernel, row
    5)."""
    rows = sweep_timings(torch, calls, "over_table")
    for size, instances in warps.items():
        rows["warp" if size == "640x480" else f"warp {size}"] = warp_timings(torch, instances)
    rows["tvl1"] = tvl1_timing(torch, run640["eng"], "200 iterations at 640x480")
    rows["tvl1 1280x720"] = tvl1_timing(
        torch, run720["eng"], "200 iterations at 1280x720 (the tiled Pallas kernel's shapes)")
    log_timings(rows)
    return rows


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
    bit for bit against their plain versions and timed
    (``resample_timings``). Returns the counts, errors and timings."""
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
    rows = resample_timings(torch, calls)
    log_timings(rows)
    return dict(launches=launches, errs=errs, timings=rows)


def route_turns(torch, P, frames, n=4):
    """The 640x480 run replayed with the unfused warp route and with the
    fused kernel in turns (unfused, fused, fused, unfused): the per-frame
    median of each replay (CUDA events) and its wall time; the depth maps
    must agree bit for bit."""
    routes = ("unfused", "fused", "fused", "unfused")[:n]
    out = {"unfused": [], "fused": [], "wall_unfused": [], "wall_fused": []}
    depth = {}
    for which in routes:
        events = []
        with unfused_route() if which == "unfused" else contextlib.nullcontext():
            eng, _, wall = replay(torch, P, frames, CAM_640, events=events)
        out[which].append(float(np.median([s.elapsed_time(e) for s, e in events[:-1]])))
        out["wall_" + which].append(wall)
        depth[which] = eng.depthmap()
    same = bool(np.array_equal(depth["unfused"], depth["fused"], equal_nan=True))
    log(f"  640x480 per-frame median, in turns: unfused route {out['unfused']} ms, fused "
        f"{out['fused']} ms; the depth maps equal bit for bit: {same}")
    if not same:
        raise AssertionError("the unfused and fused warp routes give other depth maps")
    return out


def baseline_library(kernels, csrc, build_dir):
    """Build and load the kernels of another checkout's ``csrc`` behind the
    C interface that this package's wrappers call. A ``remode_tvl1`` that
    reports no launch count (the older interface: one launch per
    iteration) gets a shim that reports ``iterations``; a checkout without
    ``warp.cu`` takes this package's fused warp (both turns then run it)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sources = [name for name in kernels.SOURCES if (csrc / name).exists()]
    lib = ctypes.CDLL(str(kernels.build(csrc, build_dir, sources)))
    counts = "int* launches" in (csrc / "tvl1.cu").read_text()
    signatures = {
        "remode_sweep": [P] * 9 + [I] * 5 + [F, I, P],
        "remode_resample_rows": [P] * 3 + [I] * 4 + [P],
        "remode_resample_cols": [P] * 3 + [I] * 4 + [P],
        "remode_tvl1": [P] * 10 + [I] * 3 + [F] * 4 + [P] * (2 if counts else 1),
    }
    if "warp.cu" in sources:
        signatures["remode_homography_warp"] = kernels._SIGNATURES["remode_homography_warp"]
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
    if "warp.cu" not in sources:
        log(f"  {csrc} has no warp.cu: its turns run this package's fused warp")
    warp = (lib if "warp.cu" in sources else kernels.library()).remode_homography_warp
    return types.SimpleNamespace(
        remode_sweep=lib.remode_sweep, remode_homography_warp=warp,
        remode_resample_rows=lib.remode_resample_rows,
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
    from rpg_open_remode_tpu_torch.ops import denoise_cuda, sweep_cuda, warp_cuda
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    csrc = Path(baseline_dir) / "rpg_open_remode_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = dict(old=baseline_library(kernels, csrc, Path(tmp)), new=kernels.library())
        log(f"  baseline kernels from {csrc} built in {time.perf_counter() - t0:.2f} s")
        cases = {
            "sweep full": lambda: sweep_cuda.disparity_sweep(*calls["sweep full"]),
            "sweep coarse": lambda: sweep_cuda.disparity_sweep(*calls["sweep coarse"]),
        }
        for lab in RECT_WARPS:
            cases[f"warp {lab}"] = (
                lambda a=warp_call(calls["warps"][lab]): warp_cuda.homography_warp(*a))
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
                    t[which].append(graph_ms(fn, *((2, 5) if "tvl1" in name else ())))
            out[name] = {k: float(np.mean(v)) for k, v in t.items()}
            log(f"  {name}: old {out[name]['old']:.4f} ms, new {out[name]['new']:.4f} ms "
                f"(each the mean of two turns: {t['old']} / {t['new']})")
        frame_ms = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            events = []
            with with_library(kernels, libs[which]):
                replay(torch, P, frames, CAM_640, events=events)
            frame_ms[which].append(float(np.median([s.elapsed_time(e) for s, e in events[:-1]])))
        log(f"  640x480 per-frame median, in turns: old {frame_ms['old']} ms, "
            f"new {frame_ms['new']} ms")
        profiles = {}
        depth = {}
        for which, lib in libs.items():
            with with_library(kernels, lib):
                profiles[which], eng = profile_run(torch, P, kernels, frames, CAM_640,
                                                   f"{which} kernels")
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
    parser.add_argument("--mesh-only", action="store_true",
                        help="run only the device mesh phase (with four cards: a card a rank, "
                             "NCCL) and print no result line")
    parser.add_argument("--script", choices=SCRIPTS, help=argparse.SUPPRESS)
    parser.add_argument("--script-out", help=argparse.SUPPRESS)
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import rpg_open_remode_tpu_torch as P
    from rpg_open_remode_tpu_torch import eval as peval
    from rpg_open_remode_tpu_torch import kernels

    if opts.script:
        return run_script(torch, kernels, opts.script, opts.script_out)
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

    if opts.mesh_only:
        phase(f"the device mesh alone ({torch.cuda.device_count()} card(s))")
        mesh = mesh_phase(torch, P, kernels, make_frames(640, 480, CAM_640, MESH_FRAMES))
        log(f"== total {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            with open(opts.out, "w") as f:
                json.dump(json.loads(json.dumps(dict(card=smi, mesh=mesh), default=float)), f,
                          indent=1)
        return 0

    phase("kernel parity (numpy-seeded, ragged-band and edge-case inputs, main-path shapes)")
    errs = kernel_parity(torch, dev, P, MAIN_SIZES)

    phase("kernel parity at the live and FHD rows' configurations (752x480; 1920x1080 at "
          "patch 15 and 17 with 383 planes)")
    t_phase = time.perf_counter()
    for k, e in kernel_parity(torch, dev, P, ROW_SIZES).items():
        errs[k] = max(errs[k], e)
    launch = launch_figures(ROW_SIZES)
    log(f"  phase took {time.perf_counter() - t_phase:.1f} s")

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
          f"at {', '.join(f'{w}x{h}' for w, h in SEED_UPDATE_SIZES)}; its device time a call "
          f"from CUDA graphs")
    tail = seed_update_phase(torch)
    errs["seed_update"] = tail["err"]

    phase(f"the plane-sweep kernel (csrc/planesweep.cu) against its plain version on a forward "
          f"dolly at {', '.join(f'{w}x{h}' for w, h in PLANESWEEP_SIZES)}; its device time a call "
          f"from CUDA graphs")
    sweep_planes = planesweep_phase(torch)

    phase("profiler over the replayed 640x480 run (the trace's launches held to the counts); "
          "work, bounds and lane use of its calls from an eager pass")
    prof, _ = profile_run(torch, P, kernels, frames640, CAM_640, "640x480 run", account=True)
    work = prof.pop("work")
    if {k: prof["launches"][k] for k in PATH_KERNELS} != {
            k: run640["launches"][k] for k in PATH_KERNELS}:
        raise AssertionError(f"the profiled replay's launches {prof['launches']} differ from "
                             f"the main path's {run640['launches']}")

    phase("main path 1280x720 (80 frames, focal-scaled config, denoise)")
    frames720 = make_frames(1280, 720, CAM_720, 80)
    run720 = drive(torch, P, kernels, frames720, CAM_720, keep_frame=KEEP_FRAME, first=KEEP_FRAME)
    report_run("1280x720", run720)
    log(f"  beside the JAX hd_1280x720 row {HD_ROW}")
    warps720 = warp_instances(frame_warps(run720), "1280x720")
    for lab, args in warps720.items():
        errs["warp"] = max(errs["warp"], check_warp(args, lab))

    phase(f"752x480 ({FHD_FRAMES} frames through Depthmap at for_camera({CAM_752['fx']}); "
          f"frame {KEEP_FRAME}'s warps, whose output rows end in a partial tile)")
    run752, warps752 = warp_run(torch, P, kernels, "752x480", 752, 480, CAM_752, FHD_FRAMES)
    errs["warp"] = max(errs["warp"], run752["warp_err"])

    phase(f"the 1920x1080 configuration ({FHD_FRAMES} frames through Depthmap at "
          f"for_camera(1443.6); frame {KEEP_FRAME}'s own kernel inputs; kernel timings)")
    t_phase = time.perf_counter()
    fhd = fhd_run(torch, P, kernels)
    for k, e in fhd["errs"].items():
        errs[k] = max(errs[k], e)
    log(f"  phase took {time.perf_counter() - t_phase:.1f} s")

    phase("the lens-undistortion path (the 1-D resamplers of utils/warp.warp_grid)")
    undist = undistortion_run(torch, P, kernels, frames640)
    for k, e in undist["errs"].items():
        errs[k] = max(errs[k], e)

    phase("the compiled programs: every step, chunk and reseed a CUDA graph replay, held bit "
          "for bit against the eager update_step; graph against eager in turns")
    t_phase = time.perf_counter()
    graphs = graphs_phase(torch, P, kernels, frames640, frames720, fhd["run"].pop("rendered"))
    del frames720
    log(f"  phase took {time.perf_counter() - t_phase:.1f} s")

    phase("keyframe lifecycle accuracy (eval.py's keyframe segments, 640x480, hardened scene)")
    fast = make_frames(640, 480, CAM_640, 190, step=peval.FAST_STEP)
    life, kept = lifecycle_accuracy(torch, P, frames640, fast)

    phase(f"depth propagation (switch {KEEP_SWITCH} of the fast_motion_propagated run)")
    prop = propagation(torch, P, kept)
    errs["warp"] = max(errs["warp"], prop["warp"]["max_abs_err"])
    prop_run = profile_lifecycle(torch, P, fast)
    del kept, fast

    phase("the CLI on the card (cli.main in-process)")
    cli_out = cli_phase(torch, P, kernels, frames640)

    phase("concurrent-keyframe ring (bit-exactness, the node at B = 1, 2, 4, the CLI's "
          "--keyframes 4 run, the walk oracle)")
    ring = ring_phase(torch, P, kernels, frames640, run640)

    phase(f"the device mesh (the sharded step at {', '.join(map(str, MESH_SHAPES))} over "
          f"{MESH_FRAMES} frames, band slab kernels, sharded TV-L1, the CLI's --mesh 2,1,2 run)")
    mesh = mesh_phase(torch, P, kernels, frames640)

    phase("the port's bench, scaling, profile and roofline scripts (each main() at its "
          "defaults, in a process of its own)")
    t_phase = time.perf_counter()
    scripts = scripts_phase()
    log(f"  phase took {time.perf_counter() - t_phase:.1f} s")

    phase(f"kernel timings (frame {KEEP_FRAME} of the 640x480, 752x480 and 1280x720 runs, the "
          f"warps in turns with the unfused route; TV-L1 also at 1280x720)")
    rows = kernel_timings(torch, run640, run720, calls, {
        "640x480": warp_instances(calls["warps"], "640x480"), "752x480": warps752,
        "1280x720": warps720})

    phase("the 640x480 run with the unfused warp route and with the fused kernel, in turns; "
          "a profiled replay with the unfused route")
    turns = route_turns(torch, P, frames640)
    with unfused_route():
        prof_unfused, _ = profile_run(torch, P, kernels, frames640, CAM_640,
                                      "640x480 run, unfused route")

    base = None
    if opts.baseline:
        phase(f"baseline kernels from {opts.baseline}, timed in turns with these")
        base = baseline_compare(torch, P, kernels, opts.baseline, calls, frames640, run640,
                                run720)

    out = []
    for k in KERNELS:
        path = undist if k.startswith("resample") else run640
        r = (rows["sweep full"] if k == "sweep" else undist["timings"][k]
             if k.startswith("resample") else tail["rows"]["640x480 rectified"]
             if k == "seed_update" else rows[k])
        entry = dict(name=k, route="cuda", **KERNELS[k], launches=path["launches"][k],
                     max_abs_err=errs[k], ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound"][0], bound_by=r["bound"][1],
                     library_ms=r.get("library_ms"),
                     run_ms=prof["kernels"][k]["ms"], run_launches=prof["kernels"][k]["launches"])
        if k == "sweep":
            c = rows["sweep coarse"]
            entry.update(lane_efficiency_scoring=share(r["lanes"]["scoring"]),
                         lane_efficiency_per_pixel=share(r["lanes"]["per_pixel"]),
                         ms_coarse=c["ms"], plain_ms_coarse=c["plain_ms"])
        if k.startswith("resample"):
            entry.update(path="the undistortion run (utils/warp.warp_grid)",
                         launches_unfused_640x480=prof_unfused["kernels"][k]["launches"])
        if k == "warp":
            pr = prop["warp"]
            per = {lab: {f: x[f] for f in ("ms", "host_ms", "unfused_ms", "unfused_host_ms",
                                            "plain_ms", "library_ms", "share")}
                   | dict(bound_ms=x["bound"][0], bound_by=x["bound"][1])
                   for rw in [rows[key] for key in rows if key.startswith("warp")]
                   + [fhd["timings"]["warp"]] for lab, x in rw["per_call"].items()}
            entry.update(
                host_ms=r["host_ms"], unfused_ms=r["unfused_ms"],
                unfused_host_ms=r["unfused_host_ms"], per_call=per,
                launches_per_switch=pr["calls"], ms_switch=pr["ms"],
                unfused_ms_switch=pr["unfused_ms"], host_ms_switch=pr["host_ms"],
                unfused_host_ms_switch=pr["unfused_host_ms"], plain_ms_switch=pr["plain_ms"],
                bound_ms_switch=pr["bound"][0], library_ms_switch=pr["library_ms"],
                run_ms_reseeds=prop_run["kernels"][k]["reseeds"]["ms"],
                reseed_ms=prop["reseed_ms"], reseed_ms_unfused=prop["reseed_ms_unfused"],
                device_ops_per_switch=prop["device_ops_per_switch"],
                device_ops_per_switch_unfused=prop["device_ops_per_switch_unfused"],
                frame_ms_median_turns=turns["fused"], frame_ms_median_turns_unfused=turns["unfused"],
                busy_share_wall=prof["busy_share_wall"],
                busy_share_wall_unfused=prof_unfused["busy_share_wall"],
                launches_752x480=run752["launches"][k], launches_1280x720=run720["launches"][k])
        if k == "seed_update":
            entry.update(per_call={lab: {f: x[f] for f in ("ms", "plain_ms", "plain_graph_ms")}
                                   | dict(bound_ms=x["bound"][0]) for lab, x in tail["rows"].items()},
                         launches_752x480=run752["launches"][k])
        if k == "tvl1":
            t7 = rows["tvl1 1280x720"]
            entry.update(ms_1280x720=t7["ms"], plain_ms_1280x720=t7["plain_ms"],
                         bound_ms_1280x720=t7["bound"][0])
        # the 1920x1080 run (for_camera(1443.6), patch 15, 383 planes): its
        # launches, and the kernel timed on its frame-10 inputs (the sweep's
        # full pass; the 3 warps' passes; TV-L1 on its final state)
        f = fhd["timings"].get("sweep full" if k == "sweep" else k)
        entry["launches_1920x1080"] = fhd["run"]["launches"][k]
        if f is not None:
            entry.update(ms_1920x1080=f["ms"], plain_ms_1920x1080=f["plain_ms"],
                         bound_ms_1920x1080=f["bound"][0],
                         library_ms_1920x1080=f.get("library_ms"))
        if k == "sweep":
            c = fhd["timings"]["sweep coarse"]
            entry.update(ms_coarse_1920x1080=c["ms"], plain_ms_coarse_1920x1080=c["plain_ms"],
                         bound_ms_coarse_1920x1080=c["bound"][0],
                         smem_bytes_1920x1080=launch["1920x1080 full"]["smem_bytes"],
                         blocks_per_sm_1920x1080=launch["1920x1080 full"]["blocks_per_sm"])
        entry["launches_lifecycle"] = cli_out["synthetic"]["launches"][k]
        entry["launches_ring"] = ring["cli"]["launches"][k]
        entry["launches_mesh"] = sum(x[k] for x in mesh["cli"]["launches"])
        # the slowest of every rank's frame-10 slab calls (full sweep, or
        # one resample pass), with that call's own bound
        slab = [c for m in mesh["meshes"].values() for c in m["calls"]
                if (c["name"] == "sweep full" if k == "sweep" else c["name"].split()[0] == k)]
        if slab:
            slow = max(slab, key=lambda c: c["ms"])
            entry.update(ms_slab_slowest=slow["ms"], bound_ms_slab_slowest=slow["bound"][0],
                         plain_ms_slab_slowest=slow["plain_ms"],
                         library_ms_slab_slowest=slow["library_ms"],
                         slab_slowest=f"{slow['name']} {slow['shape']}")
        out.append(entry)
    r = sweep_planes["rows"]["planesweep 640x480"]
    out.append(dict(
        name="planesweep", route="cuda", source="rpg_open_remode_tpu_torch/csrc/planesweep.cu",
        replaces="none: the PLANE_SWEEP regime's matcher, which XLA fused in the JAX package",
        max_abs_err=sweep_planes["err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None,
        ms_752x480=sweep_planes["rows"]["planesweep 752x480"]["ms"],
        skipped_share=sweep_planes["skipped"]))
    log("  library_ms: one grid_sample call per resample pass, and per warp (a 2-D bilinear "
        "sample at (u, v), not the two-pass value); no single PyTorch call computes the sweep "
        "or TV-L1 (null)")
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
                timings=rows, work=work, profile=prof, profile_unfused=prof_unfused,
                route_turns=turns, run752={k: run752[k] for k in keep},
                undistortion=dict(launches=undist["launches"], timings=undist["timings"]),
                lifecycle=life, propagation=prop,
                profile_lifecycle=prop_run, cli=cli_out, ring=ring, mesh=mesh,
                launch_figures=launch, fhd=dict(run={k: fhd["run"][k] for k in keep},
                                                peaks=fhd["peaks"], timings=fhd["timings"]),
                scripts=scripts, baseline=base, graphs=graphs)), f, indent=1)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
