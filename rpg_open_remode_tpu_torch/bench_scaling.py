"""Scaling report of the port: keyframe-updates per second on one NVIDIA GPU
(counterpart of the repository's root ``bench_scaling.py``, which drives the
JAX package).

  - B1: one ``Depthmap``, the single-keyframe throughput;
  - B2, B4: ``BatchedDepthmap`` rings of 2 and 4 keyframes (slots seeded on
    frames 0, 2, 4 and 6) that each absorb every frame: keyframe-updates/s,
    and the gain over running the B keyframes one after another through
    the single engine (``B{B}_gain_vs_serial``, not divided by B);
  - the full sharded step on a (1,1,1) mesh, a ``torch.distributed`` world
    of one rank started in this process (NCCL on the card, gloo on the
    CPU), against B1: the cost of the mesh wrapping without communication.
    The step is the mesh's compiled program (``parallel.ShardedPrograms``:
    one CUDA graph replay a frame, as B1's engine replays its own; its
    config has ``zero_baseline_fallback`` off, so no regime to choose),
    timed in turns with the eager
    ``parallel.build_sharded_update`` step it captures
    (``sharded_mesh1_eager_updates_per_s``).

40 synthetic 640x480 frames (the plain scene, seed 1) are staged on the
device as uint8 once. Every figure is the best of 2 passes, each restored
(untimed) to the same post-warm-up state, so the passes do identical work.

    python -m rpg_open_remode_tpu_torch.bench_scaling [--device cuda|cpu] [--json PATH]

Prints ONE JSON line, with the card's name and power limit. Without CUDA
and without ``--device cpu`` the line holds ``error`` and the exit code is
1. Imports torch and numpy, never JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from rpg_open_remode_tpu_torch.eval import CAM_640, _Tcw


def _best_of(passes, fn, n_calls, setup):
    """Min over passes of the seconds a call; ``setup`` (untimed) restores
    the engine to the same post-warm-up state before every pass, so min()
    picks the least noisy pass of identical work."""
    times = []
    for _ in range(passes):
        setup()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) / n_calls)
    return min(times)


MESH1_TURNS = ("eager", "replay", "replay", "eager")


def sharded_mesh1(imgs, poses, bounds, width, height, cam, first, end, device):
    """Seconds a frame of the sharded step on a (1,1,1) mesh over frames
    ``first`` .. ``end - 1`` after warm-up updates 1 .. ``first - 1``, in a
    one-rank world that this call starts and ends: ``(replayed, eager)``,
    each the best of its passes in ``MESH1_TURNS``, every pass restored
    (untimed) to the same post-warm-up state."""
    import torch.distributed as dist

    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap
    from rpg_open_remode_tpu_torch.models.state import (
        clone, copy_into, stack_states, state_to_numpy,
    )
    from rpg_open_remode_tpu_torch.parallel import (
        ShardedPrograms, build_sharded_update, make_mesh,
    )
    from rpg_open_remode_tpu_torch.parallel.distributed import initialize
    from rpg_open_remode_tpu_torch.parallel.launch import free_port
    from rpg_open_remode_tpu_torch.utils.profiling import force

    if device.type == "cuda" and device.index is None:   # NCCL wants the card's index
        device = torch.device("cuda", torch.cuda.current_device())
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    initialize(f"localhost:{free_port()}", 1, 0, device)
    try:
        mesh = make_mesh(1, kf=1, ty=1, tx=1, device=device)
        cfg = RemodeConfig(zero_baseline_fallback=False)
        eng = Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"], cfg=cfg,
                       device=device)
        eng.set_reference_image(imgs[0], poses[0], *bounds)
        progs = ShardedPrograms(mesh, height, width, eng.cam, (cam["fx"], cam["fy"]), cfg)
        progs.load_numpy(state_to_numpy(stack_states([eng.state])))
        for i in range(1, first):
            progs.update(imgs[i], poses[i])
        force(progs.states[0].mu)
        snap = [clone(st) for st in progs.states]
        step = build_sharded_update(mesh, eng.cam, cfg, height, width)
        holder = [None]

        def reset():
            for dst, src in zip(progs.states, snap):
                copy_into(dst, src)
            holder[0] = [clone(st) for st in snap]
            force(holder[0][0].mu)

        def run_replay():
            for i in range(first, end):
                progs.step(progs.load_frame(imgs[i], poses[i]))
            force(progs.states[0].mu)

        def run_eager():
            for i in range(first, end):
                holder[0], _ = step(holder[0], imgs[i], poses[i], None)   # no choice
            force(holder[0][0].mu)

        times = {"replay": [], "eager": []}
        for which in MESH1_TURNS:
            times[which].append(_best_of(1, run_replay if which == "replay" else run_eager,
                                         end - first, reset))
        return min(times["replay"]), min(times["eager"])
    finally:
        dist.destroy_process_group()


def run(device="cuda", width=640, height=480, cam=CAM_640, n_frames=40, end=36,
        batches=(2, 4), n_pass=2) -> dict:
    """The report as a dict (``main`` prints it): B1 and the sharded step
    warm up on frames 1-5 and time frames 6 .. ``end - 1``; each ring seeds
    its slots on frames 0, 2, 4, ..., warms up on frames 8-11 and times
    frames 12 .. ``end - 1``."""
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap, resolve_device
    from rpg_open_remode_tpu_torch.models.multikeyframe import BatchedDepthmap
    from rpg_open_remode_tpu_torch.utils import synthetic
    from rpg_open_remode_tpu_torch.utils.devices import card_info
    from rpg_open_remode_tpu_torch.utils.profiling import force

    device = resolve_device(device)
    card = card_info(device)
    frames = synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam, seed=1)
    # staged once: the signal is the batching and sharding efficiency of the
    # device work, not the per-frame upload
    imgs = [torch.from_numpy(np.clip(fr.image * 255.0, 0, 255).astype(np.uint8)).to(device)
            for fr in frames]
    poses = [torch.from_numpy(_Tcw(fr)).to(device) for fr in frames]
    force(imgs[-1].float().sum() + poses[-1].sum())
    out = {"metric": "keyframe_updates_per_s"}

    def bounds(fr):
        d = fr.depth[np.isfinite(fr.depth)]
        return float(d.min()), float(d.max())

    # single keyframe
    eng = Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"], device=device)
    eng.set_reference_image(imgs[0], poses[0], *bounds(frames[0]))
    for i in range(1, 6):
        eng.update(imgs[i], poses[i])
    force(eng.programs.state.mu)
    snap_b1 = eng.state

    def reset_b1():
        eng.state = snap_b1

    def run_b1():
        for i in range(6, end):
            eng.update(imgs[i], poses[i])
        force(eng.programs.state.mu)

    per = _best_of(n_pass, run_b1, end - 6, reset_b1)
    out["B1_updates_per_s"] = round(1.0 / per, 1)
    del eng, snap_b1

    for B in batches:
        beng = BatchedDepthmap(B, width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                               device=device)
        for slot in range(B):
            beng.seed_keyframe(slot, imgs[2 * slot], poses[2 * slot], *bounds(frames[2 * slot]))
        for i in range(8, 12):
            beng.update(imgs[i], poses[i])
        force(beng.programs[-1].state.mu)
        # copies of the slots' states: restoring each slot is all a pass
        # needs (update() reads nothing else)
        snap_bb = beng.slots

        def reset_bb():
            for slot, st in enumerate(snap_bb):
                beng.restore(slot, st)

        def run_bb():
            for i in range(12, end):
                beng.update(imgs[i], poses[i])
            force(beng.programs[-1].state.mu)

        per = _best_of(n_pass, run_bb, end - 12, reset_bb)
        out[f"B{B}_updates_per_s"] = round(B / per, 1)
        # throughput against the B keyframes run one after another through
        # the single engine; not divided by B
        out[f"B{B}_gain_vs_serial"] = round((B / per) / out["B1_updates_per_s"], 3)
        del beng, snap_bb

    per, per_eager = sharded_mesh1(imgs, poses, bounds(frames[0]), width, height, cam, 6, end,
                                   device)
    out["sharded_mesh1_updates_per_s"] = round(1.0 / per, 1)
    out["sharded_mesh1_eager_updates_per_s"] = round(1.0 / per_eager, 1)
    out["sharded_mesh1_overhead_vs_B1"] = round(out["B1_updates_per_s"] / (1.0 / per), 3)
    out["backend"] = device.type
    out.update(card)
    return out


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
        print(json.dumps({"metric": "keyframe_updates_per_s", "error": str(exc)}))
        return 1
    out = run(a.device)
    print(json.dumps(out), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
