"""Command-line interface of the port (counterpart of
``rpg_open_remode_tpu/cli.py``; the reference's executables).

  run    the keyframe lifecycle over a dataset, the synthetic scene or a
         stdin stream (the reference's ``depthmap_node`` + dataset replay):
         drives ``models/node.DepthmapNode``, or with ``--keyframes N > 1``
         the concurrent-keyframe ring ``models/multikeyframe.MultiKeyframeNode``,
         and writes per keyframe
         ``kf_NNN_depth.npy``, ``kf_NNN_cloud.ply``,
         ``kf_NNN_convergence.png`` and, with ``--checkpoint``,
         ``kf_NNN_state.npz``, plus the fused ``global_map.ply``.
  bench  single-keyframe timed benchmark against ground truth (the
         reference's ``dataset_main``, test/dataset_main.cpp).

    python -m rpg_open_remode_tpu_torch.cli run --synthetic --propagate
    python -m rpg_open_remode_tpu_torch.cli run --synthetic --device cpu
    python -m rpg_open_remode_tpu_torch.cli run --synthetic --keyframes 4

``--device`` defaults to ``cuda`` and fails without a GPU; ``cpu`` runs the
kernels' plain PyTorch versions. The device mesh (``--mesh``,
``--distributed``, ``--host-devices``) is not ported yet and exits with an
error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

UNPORTED = (
    "not ported yet: the device mesh (--mesh, --distributed, --host-devices) "
    "is ROADMAP.md Queue 1 item 17"
)


def _stdin_frames(args):
    """Live input, one frame per stdin line:

        <image-path> tx ty tz qx qy qz qw [min_depth max_depth]

    (the reference's /svo/dense_input topic, src/main_ros.cpp:36-41, as a
    pipe; an empty line or EOF ends the stream). Depth bounds, when present,
    set the scene bounds of the next keyframe."""
    from rpg_open_remode_tpu_torch.io.dataset import DatasetEntry, read_gray_image

    def gen():
        for line in sys.stdin:
            parts = line.split()
            if not parts:
                break
            try:
                path, vals = parts[0], [float(v) for v in parts[1:]]
            except ValueError:
                vals = []
            if len(vals) not in (7, 9):
                print(f"skipping malformed line: {line.rstrip()}", flush=True)
                continue
            entry = DatasetEntry(
                image_file=path, depthmap_file="",
                translation=np.asarray(vals[:3], np.float32),
                quaternion=np.asarray(vals[3:7], np.float32),
            )
            # bounds ride the gt slot as a (min, max) array
            gt = np.array(vals[7:9], np.float32) if len(vals) == 9 else None
            yield path, read_gray_image(path), entry.T_curr_world, gt

    cx = args.cx if args.cx is not None else (args.width - 1) / 2.0
    cy = args.cy if args.cy is not None else (args.height - 1) / 2.0
    return gen(), (args.width, args.height, args.fx, cx, args.fy, cy)


def _load_frames(args):
    """-> (frames iterable of (name, image, T_curr_world, gt_depth|None),
    (width, height, fx, cx, fy, cy))."""
    if args.stdin:
        return _stdin_frames(args)
    if args.synthetic:
        from rpg_open_remode_tpu_torch.utils import synthetic

        cam = dict(
            fx=args.fx or 481.2,
            fy=args.fy or -480.0,
            cx=args.cx if args.cx is not None else (args.width - 1) / 2.0,
            cy=args.cy if args.cy is not None else (args.height - 1) / 2.0,
        )
        frames = synthetic.generate(n_frames=args.frames or 100, width=args.width,
                                    height=args.height, cam=cam, seed=args.seed,
                                    step=args.motion_step)

        def gen():
            for i, fr in enumerate(frames):
                T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
                yield (f"synthetic_{i:04d}", fr.image,
                       np.linalg.inv(T)[:3].astype(np.float32), fr.depth)

        return gen(), (args.width, args.height, cam["fx"], cam["cx"], cam["fy"], cam["cy"])

    from rpg_open_remode_tpu_torch.io.dataset import Dataset, FramePrefetcher

    ds = Dataset(args.sequence, path=args.data_path)
    if ds.path is None and not ds.load_path_from_env():
        sys.exit("no dataset path: pass --data-path or set RMD_TEST_DATA_PATH")
    if not ds.read_data_sequence(args.start, args.end):
        sys.exit(f"cannot read sequence file {ds.path / ds.sequence_file}")

    def gen():
        # read-ahead on a thread: decoding overlaps the device's work
        gt_shape = (args.width, args.height) if args.use_gt_depth else None
        pf = FramePrefetcher(ds, depth=4, gt_shape=gt_shape)
        try:
            for entry, img, gt in pf:
                yield entry.image_file, img, entry.T_curr_world, gt
        finally:
            pf.close()

    cx = args.cx if args.cx is not None else 319.5
    cy = args.cy if args.cy is not None else 239.5
    return gen(), (args.width, args.height, args.fx, cx, args.fy, cy)


def _make_engine(geom, args):
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap

    cfg = RemodeConfig(propagate_depth=True) if getattr(args, "propagate", False) else None
    width, height, fx, cx, fy, cy = geom
    return Depthmap(width, height, fx=fx, cx=cx, fy=fy, cy=cy, cfg=cfg, device=args.device)


def _make_node(geom, args, export):
    """The lifecycle node of the run: the ring with ``--keyframes N > 1``,
    else ``DepthmapNode`` with its convergence overlays and metrics."""
    from rpg_open_remode_tpu_torch.io.png import write_png
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode

    if args.keyframes > 1:
        from rpg_open_remode_tpu_torch.config import RemodeConfig
        from rpg_open_remode_tpu_torch.models.multikeyframe import (
            BatchedDepthmap, MultiKeyframeNode,
        )

        if args.metrics:
            print("note: --metrics NDJSON is single-keyframe only; ignored", flush=True)
        if args.conv_every:
            print("note: --conv-every is single-keyframe only; ignored", flush=True)
        width, height, fx, cx, fy, cy = geom
        # ring slots warm-start from their own outgoing posterior
        cfg = RemodeConfig.for_camera(fx, propagate_depth=True) if args.propagate else None
        engine = BatchedDepthmap(args.keyframes, width, height, fx=fx, cx=cx, fy=fy, cy=cy,
                                 cfg=cfg, device=args.device)
        return MultiKeyframeNode(engine, on_keyframe=export)

    engine = _make_engine(geom, args)
    node_cfg = on_conv = None
    if args.conv_every:
        node_cfg = dataclasses.replace(engine.cfg, publish_conv_every_n=args.conv_every)

        def on_conv(overlay):
            write_png(os.path.join(args.out, "conv_latest.png"), overlay)

    return DepthmapNode(engine, cfg=node_cfg, on_keyframe=export, on_convergence=on_conv,
                        metrics_path=args.metrics or None)


def cmd_run(args):
    """The lifecycle run; returns the closed node (``DepthmapNode``, or
    ``MultiKeyframeNode`` with ``--keyframes N > 1``)."""
    from rpg_open_remode_tpu_torch import native
    from rpg_open_remode_tpu_torch.io import (
        GlobalMap, backproject_converged, convergence_overlay, save_state,
    )
    from rpg_open_remode_tpu_torch.io.png import write_png

    frames, geom = _load_frames(args)
    os.makedirs(args.out, exist_ok=True)
    kf_idx = [0]
    gmap = GlobalMap(voxel=args.map_voxel) if args.map_voxel else None

    def export(result):
        i = kf_idx[0]
        kf_idx[0] += 1
        stem = os.path.join(args.out, f"kf_{i:03d}")
        np.save(stem + "_depth.npy", result.denoised_depth)
        # one back-projection feeds both the keyframe's cloud and the map
        xyz, inten = backproject_converged(result.state, result.denoised_depth)
        native.write_ply(stem + "_cloud.ply", xyz, inten)
        write_png(stem + "_convergence.png", convergence_overlay(result.state))
        if gmap is not None:
            gmap.add_points(xyz, inten)
        if args.checkpoint:
            save_state(stem + "_state.npz", result.state)
        print(f"[keyframe {i}] {result.converged_percentage:.1f}% converged, "
              f"{result.n_updates} updates, {xyz.shape[0]} points", flush=True)

    node = _make_node(geom, args, export)
    last_bounds = None
    n_frames = 0
    t0 = time.perf_counter()
    next_due = t0
    try:
        for name, img, T_cw, gt in frames:
            if args.rate_hz:
                # paced replay (the dataset_publisher analog,
                # test/publish_dataset.cpp:43-47)
                now = time.perf_counter()
                if now < next_due:
                    time.sleep(next_due - now)
                next_due += 1.0 / args.rate_hz
            if gt is not None:
                finite = gt[np.isfinite(gt)]
                if finite.size:
                    last_bounds = (float(finite.min()), float(finite.max()))
            if last_bounds is None:
                last_bounds = (args.min_depth, args.max_depth)
            stats = node.process_frame(img, T_cw, *last_bounds)
            n_frames += 1
            if args.verbose and "converged_percentage" in stats:
                print(f"{name}: {stats['converged_percentage']:.1f}% converged", flush=True)
            elif args.verbose and "slots" in stats:
                pcts = "/".join(f"{sl['converged_percentage']:.1f}" for sl in stats["slots"])
                print(f"{name}: {pcts}% converged per slot", flush=True)
    finally:
        node.close()
    if gmap is not None and gmap.n_keyframes:
        n_pts = gmap.save_ply(os.path.join(args.out, "global_map.ply"))
        print(f"global map: {n_pts} points over {gmap.n_keyframes} keyframes "
              f"(voxel {gmap.voxel} m)")
    dt = time.perf_counter() - t0
    print(f"processed {n_frames} frames in {dt:.1f}s ({n_frames / dt:.1f} fps), "
          f"{len(node.keyframes)} keyframes -> {args.out}")
    return node


def cmd_bench(args):
    """Frame 0 is the reference, the rest update it; per-update times in
    blocks of 10 frames, each ended by a scalar fetch, and accuracy against
    frame 0's ground truth. Prints one JSON line."""
    from rpg_open_remode_tpu_torch.config import ConvergenceState
    from rpg_open_remode_tpu_torch.utils.profiling import force

    frames, geom = _load_frames(args)
    frames = list(frames)
    engine = _make_engine(geom, args)

    _, img0, T0, gt0 = frames[0]
    if gt0 is not None and gt0.ndim == 1:
        gt0 = None   # --stdin bounds, not a ground-truth map
    if gt0 is not None:
        finite = gt0[np.isfinite(gt0)]
        bounds = (float(finite.min()), float(finite.max()))
    else:
        bounds = (args.min_depth, args.max_depth)
    engine.set_reference_image(img0, T0, *bounds)

    seq = frames[1:]
    if seq:   # frame 1 warms up untimed (the kernels build at first use)
        _, img, T_cw, _ = seq[0]
        engine.update(img, T_cw)
        force(engine.state.mu)
    BLOCK = 10
    times = []
    i = 1
    while i < len(seq):
        j = min(i + BLOCK, len(seq))
        t0 = time.perf_counter()
        for _, img, T_cw, _ in seq[i:j]:
            engine.update(img, T_cw)
        force(engine.state.mu)
        times.append((time.perf_counter() - t0) / (j - i))
        i = j
    if not times:
        times = [float("nan")]

    out = {
        "device": str(engine.device),
        "frames": max(len(seq) - 1, 0),
        "warmup_frames": 1,
        "timing_block_frames": BLOCK,
        "mean_update_s": float(np.mean(times)),
        "var_update_s": float(np.var(times)),
        "fps": 1.0 / float(np.mean(times)),
        "converged_percent": engine.converged_percentage(),
    }
    if gt0 is not None:
        conv = engine.convergence_map() == int(ConvergenceState.CONVERGED)
        err = np.abs(engine.depthmap() - gt0)[conv & np.isfinite(gt0)]
        if err.size:
            out["depth_rmse_m"] = float(np.sqrt(np.mean(err ** 2)))
            out["within_2p6pct_range"] = float((err < 0.026 * (bounds[1] - bounds[0])).mean())
    engine.denoised_depthmap(0.5, 200)      # warm-up
    t0 = time.perf_counter()
    engine.denoised_depthmap(0.5, 200)
    out["denoise_200it_s"] = time.perf_counter() - t0
    print(json.dumps(out))


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns what it returns (the
    closed node for ``run``)."""
    p = argparse.ArgumentParser(prog="remode-torch", description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu (the kernels' "
                        "plain PyTorch versions)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("run", cmd_run), ("bench", cmd_bench)]:
        s = sub.add_parser(name)
        s.set_defaults(fn=fn)
        s.add_argument("--data-path", default=None,
                       help="dataset root (default: $RMD_TEST_DATA_PATH)")
        s.add_argument("--sequence",
                       default="first_200_frames_traj_over_table_input_sequence.txt")
        s.add_argument("--stdin", action="store_true",
                       help="live input: read '<image-path> tx ty tz qx qy qz qw "
                            "[min max]' lines from stdin")
        s.add_argument("--synthetic", action="store_true",
                       help="use the built-in ray-traced synthetic scene")
        s.add_argument("--frames", type=int, default=None)
        s.add_argument("--start", type=int, default=0)
        s.add_argument("--end", type=int, default=0)
        s.add_argument("--width", type=int, default=640)
        s.add_argument("--height", type=int, default=480)
        s.add_argument("--fx", type=float, default=481.2)
        s.add_argument("--fy", type=float, default=-480.0)
        s.add_argument("--cx", type=float, default=None,
                       help="principal point x (default: 319.5 for datasets, "
                            "image center for --synthetic)")
        s.add_argument("--cy", type=float, default=None)
        s.add_argument("--min-depth", type=float, default=0.5)
        s.add_argument("--max-depth", type=float, default=5.0)
        s.add_argument("--use-gt-depth", action=argparse.BooleanOptionalAction, default=True,
                       help="read per-frame GT .depth files for scene bounds and "
                            "accuracy metrics")
        s.add_argument("--seed", type=int, default=1)
        s.add_argument("--motion-step", type=float, default=0.023,
                       help="synthetic camera travel per frame in metres")
        s.add_argument("--out", default="remode_out")
        s.add_argument("--keyframes", type=int, default=1,
                       help="concurrent reference keyframes (> 1 drives the keyframe "
                            "ring; run only)")
        s.add_argument("--mesh", default=None, metavar="KF,TY,TX", help="not ported")
        s.add_argument("--distributed", default=None, metavar="COORD:PORT",
                       help="not ported")
        s.add_argument("--host-devices", type=int, default=None, help="not ported")
        s.add_argument("--conv-every", type=int, default=0,
                       help="write the convergence overlay every N frames "
                            "(conv_latest.png; 0 = off)")
        s.add_argument("--map-voxel", type=float, default=0.01,
                       help="voxel size (m) of the fused global map "
                            "(global_map.ply); 0 disables it")
        s.add_argument("--checkpoint", action="store_true",
                       help="save each keyframe's SeedState as .npz")
        s.add_argument("--propagate", action="store_true",
                       help="warm-start each new keyframe from the previous "
                            "keyframe's posterior (ops/propagate.py)")
        s.add_argument("--verbose", action="store_true")
        s.add_argument("--metrics", default=None,
                       help="write per-frame stats as NDJSON to this path")
        s.add_argument("--rate-hz", type=float, default=None,
                       help="pace the replay at this frame rate")
    args = p.parse_args(argv)
    if args.mesh or args.distributed or args.host_devices:
        sys.exit(f"remode-torch: {UNPORTED}")

    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device
    from rpg_open_remode_tpu_torch.utils.devices import check_devices

    if resolve_device(args.device).type == "cuda":
        check_devices(verbose=True)
    else:
        print("[remode] device cpu: the kernels' plain PyTorch versions")
    return args.fn(args)


if __name__ == "__main__":
    main()
