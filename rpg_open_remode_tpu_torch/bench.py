"""Benchmark of the port: depthmap update throughput on one NVIDIA GPU at
the reference scenario and the paper's other operating points (counterpart
of the repository's root ``bench.py``, which drives the JAX package).

The same protocol, step for step (the reference's offline benchmark,
test/dataset_main.cpp:101-135): 60 synthetic 640x480 frames (the plain
scene, seed 1) fed as uint8, as a camera gives them; a keyframe at frame 0
with the ground-truth depth bounds; ``RemodeConfig()``; 5 warm-up frames;
then

  streaming         every frame uploaded and updated; best of 3 passes, each
                    restored to the post-warm-up state so that every pass
                    does identical work
  latency           one more update of the last frame, by the host clock to
                    the end of a device sync
  accuracy          against frame 0's ground truth, after the third pass and
                    that update
  denoise           the 200-iteration TV-L1, marginal time per call
                    (``Timer.amortized`` between CUDA events)
  node_lifecycle    ``DepthmapNode`` over the same frames, 2 passes, a fresh
                    node each
  offline_chunked   the frames staged on the card, K = 16 a call of
                    ``update_chunk``: K replays of the captured frame step
                    (``models/programs.py``) with no host read between them
                    (the poses read back once a call)
  offline_staged    the frames staged on the card, pre-sliced, one update
                    (one replay) each
  fast_motion, live_752, hd_720p, fhd_1080p
                    staged replays at the paper's other operating points and
                    beyond (``POINTS``), each accounted on its young and its
                    steady state (``ops/accounting``), with the HD and FHD
                    denoise

The headline ``value`` is the better of the two offline rates. Each rate
takes the best of its passes; ``spread`` keeps every pass, and the best
pass's per-frame median and p90 by CUDA events. ``h2d_probes`` time 8
pageable uploads of a 480x640 float32 buffer between the paths (Mbit/s).

The ``vs_baseline`` keys hold a rate against the paper's Table II figures
for the reference CUDA implementation on its own GPU: 38.2 ms an update
(over table), 49.9 ms (fast motion), 30.1 ms (752x480) and 110.7 ms for the
denoise. They are that GPU's numbers, not targets of this card. The line
names the card and its power limit (``device_name``, ``power_limit_w``).

    python -m rpg_open_remode_tpu_torch.bench [--device cuda|cpu] [--json PATH]

Prints ONE JSON line. Without CUDA and without ``--device cpu`` the line
holds ``error`` and the exit code is 1. Every function takes the sizes,
frame counts and passes as parameters, with the protocol's values as
defaults; ``main()`` runs those. Imports torch and numpy, never JAX or the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.eval import CAM_640, CAM_720, CAM_752, CAM_1080, _Tcw

REF_UPDATE_S = 0.0382       # paper Table II, 'over table' mean update time
REF_FAST_S = 0.0499         # paper Table II, fast motion
REF_LIVE_S = 0.0301         # paper Table II, 752x480
REF_DENOISE_S = 0.1107      # paper Table II, 200-iteration denoise

METRIC = dict(metric="depthmap_update_fps_per_chip", unit="frames/s/chip")

# the staged operating points (bench.py:305-417), ``staged_point``'s
# arguments: fast motion (1.61 m/s at 60 fps, depth bounds padded as in
# eval.py) and the live camera's 752x480 at the bench's RemodeConfig(); HD
# and FHD over a whole keyframe life at the engine's focal-scaled default
# (cfg None: RemodeConfig.for_camera(fx)), each with its denoise's chain
# length
POINTS = {
    "fast_motion": dict(width=640, height=480, cam=CAM_640, step=0.0268,
                        bound_pad=(0.5, 2.5), cfg=RemodeConfig()),
    "live_752": dict(width=752, height=480, cam=CAM_752, step=0.023,
                     bound_pad=(1.0, 1.0), cfg=RemodeConfig()),
    "hd_720p": dict(width=1280, height=720, cam=CAM_720, step=0.023,
                    bound_pad=(1.0, 1.0), n=40, wu=3, cfg=None, denoise_n=12),
    "fhd_1080p": dict(width=1920, height=1080, cam=CAM_1080, step=0.023,
                      bound_pad=(1.0, 1.0), n=40, wu=2, cfg=None, n_pass=2, denoise_n=8),
}


def as_u8(img):
    """8-bit frames, as a camera gives them (the reference ingests CV_8U and
    converts to float on the device, depthmap.cpp:103-106)."""
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _engine(width, height, cam, cfg, device):
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap

    return Depthmap(width, height, fx=cam["fx"], cx=cam["cx"], fy=cam["fy"], cy=cam["cy"],
                    cfg=cfg, device=device)


def _wait(eng) -> None:
    """Wait for the engine's device work through a scalar fetch."""
    from rpg_open_remode_tpu_torch.utils.profiling import force

    force(eng.programs.state.mu)


class Record:
    """What the bench line collects besides its headline figures: each
    operating point's passes (``spread``), the H2D probes and the sweep
    accounting (``efficiency``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.spread: dict = {}
        self.probes: list = []
        self.efficiency: dict = {}

    def rec(self, name, times_s, frame_ms=None):
        """Every pass (ms a frame), their mean and variance (as
        dataset_main reports them, test/dataset_main.cpp:123-135), the best,
        and the best pass's per-frame median and p90 (CUDA events)."""
        ms = [1e3 * t for t in times_s]
        self.spread[name] = {
            "passes_ms_per_frame": [round(v, 3) for v in ms],
            "mean_ms": round(float(np.mean(ms)), 3),
            "var_ms2": round(float(np.var(ms)), 5),
            "best_ms": round(min(ms), 3),
        }
        if frame_ms is not None and len(frame_ms):
            self.spread[name]["median_ms"] = round(float(np.median(frame_ms)), 3)
            self.spread[name]["p90_ms"] = round(float(np.percentile(frame_ms, 90)), 3)

    def probe_h2d(self, label) -> float:
        """Mbit/s of 8 pageable uploads of a 480x640 float32 buffer, to the
        end of a device sync."""
        buf = np.random.default_rng(0).random((480, 640)).astype(np.float32)
        torch.from_numpy(buf).to(self.device)            # warm the path
        t0 = time.perf_counter()
        for _ in range(8):
            dp = torch.from_numpy(buf).to(self.device)
        float(torch.sum(dp))
        mbps = buf.nbytes * 8 / (time.perf_counter() - t0) / 1e6
        self.probes.append({"after": label, "h2d_mbps": round(mbps, 1)})
        return mbps

    def account(self, name, eng, img, T, dt_s) -> None:
        """The sweep work of the engine's next update on this frame against
        the measured frame time (``ops/accounting.frame_accounting``)."""
        from rpg_open_remode_tpu_torch.ops import accounting

        self.efficiency[name] = accounting.frame_accounting(eng, img, T, dt_s)


def timed_passes(eng, snap, steps, n_frames, n_pass):
    """The best-of protocol: each pass restores ``snap`` (untimed), runs
    every call of ``steps`` (each timed between CUDA events) and waits for
    the device. Returns the seconds a frame of each pass (``n_frames``
    frames a pass) and the best pass's ms a frame, call by call."""
    from rpg_open_remode_tpu_torch.utils.profiling import FrameClock

    times, per_call = [], []
    for _ in range(n_pass):
        eng.state = snap
        clock = FrameClock(eng.device)
        t0 = time.perf_counter()
        for step in steps:
            clock(step)
        _wait(eng)
        times.append((time.perf_counter() - t0) / n_frames)
        per_call.append(clock.ms() * len(steps) / n_frames)
    return times, per_call[int(np.argmin(times))]


def accuracy(eng, gt, d0) -> dict:
    """bench.py's accuracy against the keyframe's ground truth: converged %
    of all pixels, and over the converged ones the depth RMSE, median error
    and the fraction within 2.6 % of the depth range."""
    converged = eng.convergence_map() == int(ConvergenceState.CONVERGED)
    depth_range = float(d0.max() - d0.min())
    if converged.any():
        err = np.abs(eng.depthmap() - gt)[converged]
        rmse = float(np.sqrt(np.mean(err ** 2)))
        median_err = float(np.median(err))
        within = float((err < 0.026 * depth_range).mean())
    else:
        rmse, median_err, within = float("nan"), float("nan"), 0.0
    return dict(converged_percent=100 * float(converged.mean()), depth_rmse_m=rmse,
                depth_median_err_m=median_err, within_2p6pct_range=within)


def stream_point(frames, cam, cfg, warmup, n_pass, device, record):
    """bench.py:134-194: keyframe on frame 0, ``warmup`` updates, then the
    streaming passes over the remaining frames (each uploads its uint8
    frame), one more update of the last frame for the latency, and the
    accuracy. Returns (engine, best seconds a frame, latency seconds,
    accuracy)."""
    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    height, width = f0.image.shape
    images = [as_u8(fr.image) for fr in frames]
    poses = [_Tcw(fr) for fr in frames]
    eng = _engine(width, height, cam, cfg, device)
    eng.set_reference_image(images[0], poses[0], d0.min(), d0.max())
    for i in range(1, warmup + 1):
        eng.update(images[i], poses[i])
    _wait(eng)
    record.probe_h2d("warmup")
    timed = range(warmup + 1, len(frames))
    steps = [lambda i=i: eng.update(images[i], poses[i]) for i in timed]
    times, frame_ms = timed_passes(eng, eng.state, steps, len(timed), n_pass)
    record.rec("streaming", times, frame_ms)
    t0 = time.perf_counter()
    eng.update(images[-1], poses[-1])
    _wait(eng)
    latency_s = time.perf_counter() - t0
    return eng, min(times), latency_s, accuracy(eng, f0.depth, d0)


def denoise_seconds(eng, n, repeats=2) -> float:
    """Marginal seconds of a 200-iteration denoise of the engine's state
    over a chain of ``n`` calls (varying lambda, as the JAX bench does to
    defeat result caching)."""
    from rpg_open_remode_tpu_torch.models.depthmap import denoise_depthmap
    from rpg_open_remode_tpu_torch.utils.profiling import Timer

    eng.denoised_depthmap(0.5, 200)
    return max(Timer.amortized(
        lambda j: denoise_depthmap(eng.programs.state, eng.cfg, lam=0.5 + 1e-4 * j,
                                   iterations=200),
        n=n, repeats=repeats), 1e-9)


def node_lifecycle(frames, cam, cfg, warmup, n_pass, device, record):
    """bench.py:220-238: the keyframe lifecycle loop (``DepthmapNode``:
    switch policy, metrics, finalization on its worker) over the frames, a
    fresh node each pass. Returns (best seconds a frame, keyframes)."""
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode
    from rpg_open_remode_tpu_torch.utils.profiling import FrameClock

    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    height, width = f0.image.shape
    bounds = (float(d0.min()), float(d0.max()))
    images = [as_u8(fr.image) for fr in frames]
    poses = [_Tcw(fr) for fr in frames]
    n = len(frames)
    times, per_frame, keyframes = [], [], 0
    for _ in range(n_pass):
        eng = _engine(width, height, cam, cfg, device)
        node = DepthmapNode(eng)
        try:
            for i in range(warmup + 1):
                node.process_frame(images[i], poses[i], *bounds)
            node.drain()
            _wait(eng)
            clock = FrameClock(eng.device)
            t0 = time.perf_counter()
            for i in range(warmup + 1, n):
                clock(lambda i=i: node.process_frame(images[i], poses[i], *bounds))
            node.drain()
            _wait(eng)
            times.append((time.perf_counter() - t0) / (n - warmup - 1))
            per_frame.append(clock.ms())
        finally:
            node.close()
        keyframes = len(node.keyframes)
    record.rec("node_lifecycle", times, per_frame[int(np.argmin(times))])
    return min(times), keyframes


def offline_chunked(frames, cam, cfg, chunk, n_pass, device, record):
    """bench.py:248-268: the dataset staged on the card, ``chunk`` frames a
    call of ``update_chunk``; one warm chunk, then every whole chunk after
    it. Returns (best seconds a frame, staged images, staged poses)."""
    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    height, width = f0.image.shape
    eng = _engine(width, height, cam, cfg, device)
    eng.set_reference_image(as_u8(f0.image), _Tcw(f0), d0.min(), d0.max())
    d_imgs = torch.from_numpy(np.stack([as_u8(fr.image) for fr in frames])).to(eng.device)
    d_Ts = torch.from_numpy(np.stack([_Tcw(fr) for fr in frames])).to(eng.device)
    float(torch.sum(d_imgs.float()))
    eng.update_chunk(d_imgs[1:1 + chunk], d_Ts[1:1 + chunk])
    _wait(eng)
    starts = range(1 + chunk, len(frames) - chunk + 1, chunk)
    steps = [lambda s=s: eng.update_chunk(d_imgs[s:s + chunk], d_Ts[s:s + chunk])
             for s in starts]
    times, frame_ms = timed_passes(eng, eng.state, steps, chunk * len(starts), n_pass)
    record.rec("offline_chunked", times, frame_ms)
    return min(times), d_imgs, d_Ts


def staged_replay(name, eng, imgs, Ts, wu, n_pass, record, probe=None):
    """bench.py:282-300, 315-352: ``wu`` warm-up updates (frames 1 ..
    ``wu``), then the per-frame replay of the rest of the staged frames
    (``timed_passes``, each pass from the post-warm-up state), an H2D probe
    (labelled ``probe``, else ``name``), and the sweep accounting of both
    regimes the passes average over: the steady (end) state on the last
    frame and the young (post-warm-up) state on the first timed frame. The
    engine is left at its end state. Returns the best seconds a frame."""
    for i in range(1, wu + 1):
        eng.update(imgs[i], Ts[i])
    _wait(eng)
    snap = eng.state
    steps = [lambda i=i: eng.update(imgs[i], Ts[i]) for i in range(wu + 1, len(imgs))]
    times, frame_ms = timed_passes(eng, snap, steps, len(steps), n_pass)
    record.rec(name, times, frame_ms)
    best = min(times)
    record.probe_h2d(probe or name)
    end = eng.state
    record.account(f"{name}_steady", eng, imgs[-1], Ts[-1], best)
    eng.state = snap
    record.account(f"{name}_young", eng, imgs[wu + 1], Ts[wu + 1], best)
    eng.state = end
    return best


def offline_staged(frames, cam, cfg, warmup, n_pass, d_imgs, d_Ts, device, record):
    """bench.py:282-300: the staged dataset pre-sliced on the card, one
    update a frame (the reference's loop shape with the frames already in
    device memory), accounted as ``staged_replay`` does. Returns the best
    seconds a frame."""
    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    height, width = f0.image.shape
    eng = _engine(width, height, cam, cfg, device)
    eng.set_reference_image(as_u8(f0.image), _Tcw(f0), d0.min(), d0.max())
    imgs = [d_imgs[i] for i in range(len(frames))]
    Ts = [d_Ts[i] for i in range(len(frames))]
    return staged_replay("offline_staged", eng, imgs, Ts, warmup, n_pass, record,
                         probe="offline")


def staged_point(name, width, height, cam, step, bound_pad, device, record, n=28, wu=4,
                 cfg=None, n_pass=3, seed=1):
    """bench.py:305-352: one operating point as a staged per-frame replay of
    ``n`` frames (``wu`` warm-up), the depth bounds scaled by ``bound_pad``
    (``staged_replay``). Returns (frames/s, the engine at its end)."""
    from rpg_open_remode_tpu_torch.utils import synthetic

    seq = synthetic.generate(n_frames=n, width=width, height=height, cam=cam, seed=seed,
                             step=step)
    g0 = seq[0].depth[np.isfinite(seq[0].depth)]
    e = _engine(width, height, cam, cfg, device)
    e.set_reference_image(as_u8(seq[0].image), _Tcw(seq[0]),
                          bound_pad[0] * float(g0.min()), bound_pad[1] * float(g0.max()))
    imgs = [torch.from_numpy(as_u8(fr.image)).to(e.device) for fr in seq]
    Ts = [torch.from_numpy(_Tcw(fr)).to(e.device) for fr in seq]
    return 1.0 / staged_replay(name, e, imgs, Ts, wu, n_pass, record), e


def run(device="cuda", width=640, height=480, cam=CAM_640, n_frames=60, warmup=5, n_pass=3,
        node_passes=2, chunk=16, denoise_n=24, points=POINTS) -> dict:
    """The whole bench; returns the line as a dict (``main`` prints it).
    ``points`` maps each staged point's name to its ``staged_point``
    arguments plus ``denoise_n`` (HD and FHD: the denoise's chain length)."""
    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device
    from rpg_open_remode_tpu_torch.utils import synthetic
    from rpg_open_remode_tpu_torch.utils.devices import card_info

    device = resolve_device(device)
    card = card_info(device)
    record = Record(device)
    cfg = RemodeConfig()
    frames = synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam, seed=1)

    eng, mean_update, latency_s, acc = stream_point(frames, cam, cfg, warmup, n_pass, device,
                                                    record)
    denoise_s = denoise_seconds(eng, denoise_n)
    del eng
    record.probe_h2d("streaming+denoise")
    node_dt, node_kf = node_lifecycle(frames, cam, cfg, warmup, node_passes, device, record)
    offline_dt, d_imgs, d_Ts = offline_chunked(frames, cam, cfg, chunk, n_pass, device, record)
    staged_dt = offline_staged(frames, cam, cfg, warmup, n_pass, d_imgs, d_Ts, device, record)
    best_offline_dt = min(offline_dt, staged_dt)
    del d_imgs, d_Ts

    fps, denoise = {}, {}
    for name, kw in points.items():
        kw = dict(kw)
        n_den = kw.pop("denoise_n", None)
        fps[name], e = staged_point(name, device=device, record=record, **kw)
        if n_den:
            denoise[name] = denoise_seconds(e, n_den)
        del e
    h2d_mbps = record.probe_h2d("final")

    return {
        **METRIC,
        "value": round(1.0 / best_offline_dt, 2),
        "vs_baseline": round((1.0 / best_offline_dt) * REF_UPDATE_S, 3),
        "streaming_fps": round(1.0 / mean_update, 2),
        "update_ms": round(mean_update * 1000, 2),
        "update_latency_ms": round(latency_s * 1000, 2),
        "h2d_mbps": round(h2d_mbps, 1),
        "node_fps": round(1.0 / node_dt, 2),
        "offline_chunked_fps": round(1.0 / offline_dt, 2),
        "offline_staged_fps": round(1.0 / staged_dt, 2),
        "node_keyframes": node_kf,
        "fast_motion_fps": round(fps["fast_motion"], 2),
        "fast_motion_vs_baseline": round(fps["fast_motion"] * REF_FAST_S, 3),
        "live_752_fps": round(fps["live_752"], 2),
        "live_752_vs_baseline": round(fps["live_752"] * REF_LIVE_S, 3),
        "hd_720p_fps": round(fps["hd_720p"], 2),
        "hd_720p_denoise_ms": round(denoise["hd_720p"] * 1000, 1),
        "fhd_1080p_fps": round(fps["fhd_1080p"], 2),
        "fhd_1080p_denoise_ms": round(denoise["fhd_1080p"] * 1000, 1),
        "denoise_200it_ms": round(denoise_s * 1000, 1),
        "denoise_vs_baseline": round(REF_DENOISE_S / denoise_s, 3),
        "converged_percent": round(acc["converged_percent"], 2),
        "depth_rmse_m": round(acc["depth_rmse_m"], 4),
        "depth_median_err_m": round(acc["depth_median_err_m"], 4),
        "within_2p6pct_range": round(acc["within_2p6pct_range"], 3),
        "backend": device.type,
        **card,
        "spread": record.spread,
        "h2d_probes": record.probes,
        # the sweep's work per point (ops/accounting.py): the (pixel, plane)
        # pairs the CUDA kernel scores against the whole cost volume, FLOPs,
        # and shares of the card's fp32 peak over the measured frame time
        "efficiency": record.efficiency,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--json", default=None, help="also write the line to this path")
    a = p.parse_args(argv)
    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device

    try:
        resolve_device(a.device)
    except RuntimeError as exc:
        print(json.dumps({**METRIC, "value": None, "vs_baseline": None, "error": str(exc)}))
        return 1
    result = run(a.device)
    print(json.dumps(result), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
