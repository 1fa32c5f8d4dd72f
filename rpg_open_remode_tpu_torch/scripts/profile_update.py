"""Phase-level timing of ``update_step`` (counterpart of the repository's
``scripts_profile_update.py``).

At each size (``WxH``; default 640x480 and 752x480) the synthetic scene
(seed 1) is rendered with the bench's focal convention (fx 481.2 at 640 and
752 wide, 962.4 at 1280, else scaled with the width) and run through
``update_step`` at ``RemodeConfig.for_camera(fx)`` for 7 warm-up frames; the
phases are measured on the first frame after them (frame 8):

  classify          seed_check.classify_seeds
  match(rect)       epipolar.match on frame i of 0 .. K - 1 (the JAX script's
                    inputs: the classified post-warm-up state)
  seed_update       seed_update.update_seeds with frame 8's match
  stats             reduction.convergence_stats and the found-masked NCC sum
  FULL update_step  K frames chained from the post-warm-up state, eager
  FULL update_step (replayed)
                    the same K frames as replays of the captured step
                    (``models/programs.Programs``; each regime's program
                    captured before the timing)

Each phase runs K = 16 times (``utils/profiling.phase_ms``): ``device`` is
the CUDA events' span over the K calls a call, ``wall`` the host clock from
the first enqueue to the end of a sync, ``busy`` the device's busy time in
a profiled rerun. Phases timed alone lose the overlap of host and device
across phases: use the rows for ranking. Without ``--device cpu`` it needs
CUDA, and only ``wall`` is measured on the CPU.

    python -m rpg_open_remode_tpu_torch.scripts.profile_update [WxH ...]
        [--device cuda|cpu] [--json PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import types

import numpy as np
import torch

K = 16
WARMUP = 8


def setup(width, height, device, k=K, warmup=WARMUP):
    """The profile's inputs: the config, camera, staged frames and poses, and
    the state after ``warmup - 1`` updates, as the JAX scripts build them."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.eval import _Tcw
    from rpg_open_remode_tpu_torch.models.depthmap import update_step
    from rpg_open_remode_tpu_torch.models.state import SceneParams, empty_state
    from rpg_open_remode_tpu_torch.ops import seed_init
    from rpg_open_remode_tpu_torch.utils import synthetic
    from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
    from rpg_open_remode_tpu_torch.utils.profiling import force

    # the bench's focal convention: 640 and 752 wide use the real camera's
    # fx = 481.2, 1280 the doubled 962.4; other widths scale with W
    fscale = {640: 1.0, 752: 1.0, 1280: 2.0}.get(width, width / 640.0)
    cfg = RemodeConfig.for_camera(481.2 * fscale)
    cam_kw = dict(fx=481.2 * fscale, fy=-480.0 * fscale, cx=(width - 1) / 2,
                  cy=(height - 1) / 2)
    frames = synthetic.generate(n_frames=k + 8, width=width, height=height, seed=1, cam=cam_kw)
    cam = PinholeCamera.create(**cam_kw, device=device)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    scene = SceneParams.create(d.min(), d.max(), cfg, device=device)
    state = seed_init.init_seeds(
        empty_state(height, width, cam), torch.as_tensor(f0.image).to(device),
        torch.as_tensor(f0.T_world_curr, dtype=torch.float32).to(device), scene, cfg)
    imgs = torch.as_tensor(np.stack([fr.image for fr in frames])).to(device)
    Ts = torch.as_tensor(np.stack([_Tcw(fr) for fr in frames])).to(device)
    for i in range(1, warmup):
        state, _ = update_step(state, imgs[i], Ts[i], cam, cfg)
    force(state.mu)
    return types.SimpleNamespace(cfg=cfg, cam=cam, imgs=imgs, Ts=Ts, state=state)


def profile(width, height, device="cuda", k=K, warmup=WARMUP):
    """The phase rows at one size: ``(rows, full_state)``, each row
    ``{"phase", "device", "wall", "busy"}`` (ms a call), ``full_state`` the
    state the FULL update_step row's chain ends in."""
    from rpg_open_remode_tpu_torch.config import ConvergenceState
    from rpg_open_remode_tpu_torch.models import programs
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image, update_step
    from rpg_open_remode_tpu_torch.models.state import copy_into
    from rpg_open_remode_tpu_torch.ops import epipolar, reduction, seed_check, seed_update
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils.profiling import force, phase_ms

    x = setup(width, height, device, k, warmup)
    cfg, cam, imgs, Ts, state = x.cfg, x.cam, x.imgs, x.Ts, x.state
    M = warmup
    T_curr_ref = se3.compose(Ts[M], state.T_world_ref)
    border = seed_check.border_mask(height, width, cfg, device=imgs.device)
    conv1 = seed_check.classify_seeds(state.mu, state.sigma_sq, state.a, state.b,
                                      state.scene.epsilon, border, cfg)
    state1 = dataclasses.replace(state, conv=conv1)
    res = epipolar.match(state1, prep_image(imgs[M]), T_curr_ref, cam, cfg)
    active = conv1 == int(ConvergenceState.UPDATE)
    conv2 = epipolar.apply_match_to_conv(conv1, active, res.found)
    force(res.u)
    T_ref_curr = se3.inv(T_curr_ref)
    chain = [state]

    def full(i):
        if i == 0:
            chain[0] = state
        chain[0], _ = update_step(chain[0], imgs[i], Ts[i], cam, cfg)
        return chain[0].mu

    prog = programs.Programs(height, width, cam, (float(cam.fx), float(cam.fy)), cfg,
                             imgs.device)
    prog.load(state)
    Ts_host = Ts.cpu().numpy()

    def replayed(i):
        if i == 0:
            # the same keyframe: the host copies of its pose stay valid
            copy_into(prog.state, state)
        prog.inputs.images[torch.float32].copy_(imgs[i])
        prog.inputs.pose.copy_(Ts[i])
        prog.step(torch.float32, Ts_host[i])
        return prog.state.mu

    for i in range(k):   # capture every regime's program before the timing
        replayed(i)

    phases = [
        ("classify", lambda i: seed_check.classify_seeds(
            state.mu, state.sigma_sq, state.a, state.b, state.scene.epsilon, border, cfg)),
        ("match(rect)", lambda i: epipolar.match(
            state1, prep_image(imgs[i]), se3.compose(Ts[i], state.T_world_ref), cam,
            cfg).best_ncc),
        ("seed_update", lambda i: seed_update.update_seeds(
            state1, conv2, res.u, res.v, T_ref_curr, cam, cfg).mu),
        ("stats", lambda i: (reduction.convergence_stats(conv2)["update"],
                             torch.sum(torch.where(res.found, res.best_ncc,
                                                   torch.zeros_like(res.best_ncc))))),
        ("FULL update_step", full),
        ("FULL update_step (replayed)", replayed),
    ]
    rows = [dict(phase=name, **phase_ms(fn, k, imgs.device)) for name, fn in phases]
    return rows, chain[0]


def format_row(r, indent="") -> str:
    def ms(v):
        return "    n/a" if v is None else f"{v:7.3f}"

    return (f"{indent}{r['phase']:28s} {ms(r['device'])} ms/iter device span, "
            f"{ms(r['wall'])} ms/iter wall, {ms(r['busy'])} ms/iter device busy")


def parse_size(a: str) -> tuple[int, int]:
    w, _, h = a.partition("x")
    return int(w), int(h) if h else 480


def run_cli(argv, description, profile_fn, k=K, warmup=WARMUP) -> int:
    """The command line the two profile scripts share: sizes, ``--device``
    and ``--json``; runs ``profile_fn`` with ``k`` calls a phase after
    ``warmup`` frames and prints the card, then each size's rows."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("sizes", nargs="*", default=["640x480", "752x480"],
                   help="WxH (a bare width means W x 480)")
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--json", default=None, help="also write the rows to this path")
    a = p.parse_args(argv)
    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device
    from rpg_open_remode_tpu_torch.utils.devices import card_info

    device = resolve_device(a.device)
    card = card_info(device)
    print(f"{card['device_name']}, power limit {card['power_limit_w']} W", flush=True)
    out = dict(card, points={})
    for size in a.sizes:
        w, h = parse_size(size)
        rows = profile_fn(w, h, device, k, warmup)[0]
        print(f"[{w}x{h}]", flush=True)
        for r in rows:
            print(format_row(r, "  "), flush=True)
        out["points"][f"{w}x{h}"] = rows
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def main(argv=None) -> int:
    return run_cli(argv, __doc__.split("\n\n")[0], profile)


if __name__ == "__main__":
    sys.exit(main())
