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
    python -m rpg_open_remode_tpu_torch.cli run --synthetic --mesh 2,1,2 --keyframes 2
    python -m rpg_open_remode_tpu_torch.cli --device cpu run --synthetic --mesh 1,1,2 \
        --host-devices 2

``--device`` defaults to ``cuda`` and fails without a GPU; ``cpu`` runs the
kernels' plain PyTorch versions. ``--mesh KF,TY,TX`` runs the lifecycle on a
device mesh (``parallel/node.ShardedDepthmapNode``): this process starts one
rank per mesh position (rank r on card ``r mod device_count``, or on the
CPU), feeds every rank each frame, and writes the keyframes the ranks
finalize. ``--distributed COORD:PORT --nproc P --proc I`` makes it host I of
P, starting its ``KF*TY*TX / P`` ranks (global ranks ``I*local + i``) and
writing ``kf_pI_NNN_*``; ``--host-devices N`` asks for N CPU ranks here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

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


def _make_engine(geom, device, propagate=False):
    """The single-keyframe engine: ``RemodeConfig.for_camera(fx)``, or with
    ``propagate`` the unscaled ``RemodeConfig(propagate_depth=True)`` (the
    JAX CLI's ``run --propagate``)."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap

    cfg = RemodeConfig(propagate_depth=True) if propagate else None
    width, height, fx, cx, fy, cy = geom
    return Depthmap(width, height, fx=fx, cx=cx, fy=fy, cy=cy, cfg=cfg, device=device)


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

    engine = _make_engine(geom, args.device, args.propagate)
    node_cfg = on_conv = None
    if args.conv_every:
        node_cfg = dataclasses.replace(engine.cfg, publish_conv_every_n=args.conv_every)

        def on_conv(overlay):
            write_png(os.path.join(args.out, "conv_latest.png"), overlay)

    return DepthmapNode(engine, cfg=node_cfg, on_keyframe=export, on_convergence=on_conv,
                        metrics_path=args.metrics or None)


def _paced(frames, args):
    """``(name, image, T_curr_world, (min_depth, max_depth))`` per frame:
    the scene bounds from the frame's ground truth when it has one, else the
    last known (or ``--min-depth/--max-depth``); paced at ``--rate-hz``."""
    last_bounds = None
    next_due = time.perf_counter()
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
        yield name, img, T_cw, last_bounds


def _print_stats(verbose, name, stats):
    if verbose and "converged_percentage" in stats:
        print(f"{name}: {stats['converged_percentage']:.1f}% converged", flush=True)
    elif verbose and "slots" in stats:
        pcts = "/".join(f"{sl['converged_percentage']:.1f}" for sl in stats["slots"])
        print(f"{name}: {pcts}% converged per slot", flush=True)


def _mesh_layout(args):
    """(mesh shape, hosts, this host's first rank and rank count,
    coordinator) of ``--mesh`` [``--distributed``]."""
    from rpg_open_remode_tpu_torch.parallel.launch import free_port

    try:
        shape = tuple(int(v) for v in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        sys.exit(f"remode-torch: --mesh wants KF,TY,TX, got {args.mesh!r}")
    world = int(np.prod(shape))
    if not args.distributed:
        if args.nproc is not None or args.proc is not None:
            sys.exit("remode-torch: --nproc and --proc go with --distributed")
        return shape, 1, 0, world, f"localhost:{free_port()}"
    if args.nproc is None or args.proc is None:
        sys.exit("remode-torch: --distributed needs --nproc and --proc")
    if world % args.nproc or not 0 <= args.proc < args.nproc:
        sys.exit(f"remode-torch: {world} ranks do not split over --nproc {args.nproc} "
                 f"as host --proc {args.proc}")
    local = world // args.nproc
    return shape, args.nproc, args.proc * local, local, args.distributed


def _mesh_rank(mesh, io, geom, opts):
    """One rank of ``run --mesh``: its ``ShardedDepthmapNode`` over the
    frames the launching process sends; finalized keyframes go back to it as
    numpy. Returns the rank's figures."""
    from rpg_open_remode_tpu_torch import kernels
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.state import state_to_numpy
    from rpg_open_remode_tpu_torch.parallel import ShardedDepthmapNode

    width, height, fx, cx, fy, cy = geom
    # sharded slots warm-start from their own outgoing posterior
    cfg = RemodeConfig.for_camera(fx, propagate_depth=True) if opts["propagate"] else None

    def ship(result):
        io.post((result.index, state_to_numpy(result.state), result.denoised_depth,
                 result.converged_percentage, result.n_updates))

    node = ShardedDepthmapNode(mesh, width, height, fx=fx, cx=cx, fy=fy, cy=cy,
                               n_keyframes=opts["keyframes"] if opts["keyframes"] > 1 else None,
                               cfg=cfg, on_keyframe=ship)
    frame_s, switch_at, first_calls = [], [], []
    for name, img, T_cw, bounds in io.inputs():
        captured = len(node.programs.captures())
        t0 = time.perf_counter()
        stats = node.process_frame(img, T_cw, *bounds)
        frame_s.append(time.perf_counter() - t0)
        if stats.get("event") == "keyframe_complete":
            switch_at.append(len(frame_s) - 1)
            # a program's first call (its warm-up and capture) ran in it
            first_calls.append(len(node.programs.captures()) > captured)
        if mesh.rank == 0:
            _print_stats(opts["verbose"], name, stats)
    node.close()
    return dict(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
                launches=dict(kernels.LAUNCHES), keyframes=len(node.keyframes),
                switches=node.switches, staged=dict(mesh.staged), frames=len(frame_s),
                frame_ms=[1e3 * t for t in frame_s],
                switch_ms=[1e3 * frame_s[i] for i in switch_at], switch_first_call=first_calls,
                # the frame after each switch: its regime read waits for the reseeds
                after_switch_ms=[1e3 * frame_s[i + 1] for i in switch_at if i + 1 < len(frame_s)])


def _run_mesh(args, frames, geom, export):
    """``run --mesh``: start this host's ranks, send each of them every
    frame, and export the keyframes they finalize in the order the policy
    numbered them. Returns a summary with ``keyframes`` (the exported
    ``KeyframeResult``s), ``ranks`` (each rank's figures), ``switches`` and
    ``frames``."""
    import types

    import torch

    from rpg_open_remode_tpu_torch.models.node import KeyframeResult
    from rpg_open_remode_tpu_torch.models.state import state_from_numpy
    from rpg_open_remode_tpu_torch.parallel import RankGroup
    from rpg_open_remode_tpu_torch.parallel.collectives import backend_for

    shape, hosts, first, local, coordinator = args.layout
    if args.metrics or args.conv_every:
        print("note: --metrics/--conv-every are single-device only; ignored under --mesh",
              flush=True)
    opts = dict(propagate=args.propagate, keyframes=args.keyframes, verbose=args.verbose)
    done, waiting = [], {}

    def on_message(rank, payload):
        index, state, den, pct, n_updates = payload
        waiting[index] = KeyframeResult(state=state_from_numpy(state, device="cpu"),
                                        denoised_depth=den, converged_percentage=pct,
                                        n_updates=n_updates, index=index)
        while len(done) in waiting:
            done.append(waiting.pop(len(done)))
            export(done[-1])

    kind = torch.device(args.device).type   # rank r takes card r mod device_count
    n_frames = 0
    with RankGroup(_mesh_rank, shape, (geom, opts), device=kind, coordinator=coordinator,
                   first_rank=first, local_ranks=local, hosts=hosts, inputs=True) as group:
        devs = ", ".join(f"rank {first + i} -> {d}" for i, d in enumerate(group.devices()))
        print(f"[remode] mesh kf={shape[0]} ty={shape[1]} tx={shape[2]}: host {first // local} "
              f"of {hosts}, backend {backend_for(kind, local)}; {devs}", flush=True)
        for name, img, T_cw, bounds in _paced(frames, args):
            group.send((name, img, T_cw, bounds), on_message)
            group.poll(on_message)
            n_frames += 1
        ranks = group.join(on_message)
    if waiting:
        raise RuntimeError(f"keyframes {sorted(waiting)} arrived without their predecessors")
    switches = ranks[0]["switches"]
    print(f"switches (frame, slot): {switches}", flush=True)
    return types.SimpleNamespace(keyframes=done, ranks=ranks, switches=switches,
                                 frames=n_frames, shape=shape)


def cmd_run(args):
    """The lifecycle run; returns the closed node (``DepthmapNode``, or
    ``MultiKeyframeNode`` with ``--keyframes N > 1``), or with ``--mesh``
    the run's summary (``_run_mesh``)."""
    from rpg_open_remode_tpu_torch import native
    from rpg_open_remode_tpu_torch.io import (
        GlobalMap, backproject_converged, convergence_overlay, save_state,
    )
    from rpg_open_remode_tpu_torch.io.png import write_png

    frames, geom = _load_frames(args)
    os.makedirs(args.out, exist_ok=True)
    kf_idx = [0]
    gmap = GlobalMap(voxel=args.map_voxel) if args.map_voxel else None

    # hosts of a multi-host mesh write their own keyframes and partial map
    tag = f"p{args.proc}_" if args.mesh and args.distributed else ""

    def export(result):
        i = kf_idx[0]
        kf_idx[0] += 1
        stem = os.path.join(args.out, f"kf_{tag}{i:03d}")
        np.save(stem + "_depth.npy", result.denoised_depth)
        # one back-projection feeds both the keyframe's cloud and the map
        xyz, inten = backproject_converged(result.state, result.denoised_depth)
        native.write_ply(stem + "_cloud.ply", xyz, inten)
        write_png(stem + "_convergence.png", convergence_overlay(result.state))
        if gmap is not None:
            gmap.add_points(xyz, inten)
        if args.checkpoint:
            save_state(stem + "_state.npz", result.state)
        print(f"[keyframe {tag}{i}] {result.converged_percentage:.1f}% converged, "
              f"{result.n_updates} updates, {xyz.shape[0]} points", flush=True)

    t0 = time.perf_counter()
    if args.mesh:
        node = _run_mesh(args, frames, geom, export)
        n_frames = node.frames
    else:
        node = _make_node(geom, args, export)
        n_frames = 0
        try:
            for name, img, T_cw, bounds in _paced(frames, args):
                stats = node.process_frame(img, T_cw, *bounds)
                n_frames += 1
                _print_stats(args.verbose, name, stats)
        finally:
            node.close()
    if gmap is not None and gmap.n_keyframes:
        map_name = f"global_map_p{args.proc}.ply" if tag else "global_map.ply"
        n_pts = gmap.save_ply(os.path.join(args.out, map_name))
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
    engine = _make_engine(geom, args.device)   # always for_camera(fx), as the JAX bench

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
        force(engine.programs.state.mu)
    BLOCK = 10
    times = []
    i = 1
    while i < len(seq):
        j = min(i + BLOCK, len(seq))
        t0 = time.perf_counter()
        for _, img, T_cw, _ in seq[i:j]:
            engine.update(img, T_cw)
        force(engine.programs.state.mu)
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
        s.add_argument("--mesh", default=None, metavar="KF,TY,TX",
                       help="run the lifecycle on a device mesh: KF concurrent keyframes x "
                            "TY*TX spatial tiles, one rank per position (run only)")
        s.add_argument("--distributed", default=None, metavar="COORD:PORT",
                       help="be one host of a multi-host mesh: rank 0's address (with "
                            "--mesh, --nproc and --proc)")
        s.add_argument("--nproc", type=int, default=None,
                       help="number of hosts for --distributed")
        s.add_argument("--proc", type=int, default=None,
                       help="this host's index for --distributed")
        s.add_argument("--host-devices", type=int, default=None,
                       help="N CPU ranks on this host (with --device cpu; N must equal "
                            "this host's mesh ranks)")
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
    if args.mesh:
        if args.cmd != "run":
            sys.exit("remode-torch: --mesh drives run only")
        if args.host_devices and args.device != "cpu":
            sys.exit("remode-torch: --host-devices N means N CPU ranks: pass --device cpu")
        args.layout = _mesh_layout(args)
        if args.host_devices and args.host_devices != args.layout[3]:
            sys.exit(f"remode-torch: --host-devices {args.host_devices} must equal this "
                     f"host's {args.layout[3]} mesh ranks")
    elif args.distributed or args.host_devices or args.nproc is not None or args.proc is not None:
        sys.exit("remode-torch: --distributed, --nproc, --proc and --host-devices go with --mesh")

    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device
    from rpg_open_remode_tpu_torch.utils.devices import check_devices

    if resolve_device(args.device).type == "cuda":
        check_devices(verbose=True)
    else:
        print("[remode] device cpu: the kernels' plain PyTorch versions")
    return args.fn(args)


if __name__ == "__main__":
    main()
