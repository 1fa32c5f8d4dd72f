"""Sweep roofline of the port: the CUDA disparity sweep's time against its
bound at each operating point (counterpart of the repository's
``scripts/roofline.py``).

At 640x480, 1280x720 and 1920x1080 (``POINTS``: the bench's cameras,
``RemodeConfig.for_camera(fx)``, the plain synthetic scene at 0.023 m a
frame, seed 1) the engine runs its warm-up frames; the next frame's sweep
inputs are built as its update builds them (classify, then
``rect_match.prepare_sweep``), and the sweep is timed alone on them: the
full pass, and the coarse pass where that frame runs one, each replayed
from a CUDA graph (``utils/profiling.graph_ms``: device time without the
host's launch cost). Beside each time stands its bound, the larger of the
bytes the call must move (each input read once, each output written once)
at 3.35 TB/s and the operations the ZNCC function needs on these inputs at
67 TFLOP/s fp32 (``ops/accounting``: 12 hp + 11 for each (pixel, plane)
pair the kernel scores; the kernel's own count, with its direct patch taps,
stands beside it as ``*_gflops_exec`` and bounds nothing). The JAX script's
TPU issue-slot model and clock range have no counterpart on the card.

Prints one JSON line per point, after a line naming the card and its
power limit; ``--json PATH`` also writes them to a file. On the CPU
(``--device cpu``) the inputs, counts and bounds are computed and the
measured fields are null.

    python -m rpg_open_remode_tpu_torch.scripts.roofline [--device cuda|cpu] [--json PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

POINTS = [
    ("640x480", 640, 480, 481.2, -480.0, 10),
    ("1280x720", 1280, 720, 962.4, -960.0, 8),
    ("1920x1080", 1920, 1080, 1443.6, -1440.0, 6),
]


def point(name, width, height, fx, fy, wu, device="cuda") -> dict:
    """One point's line: the full pass (and the coarse pass, where the
    frame runs it) timed, counted and bounded."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.eval import _Tcw
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap, prep_image, to_device
    from rpg_open_remode_tpu_torch.ops import accounting, rect_match, seed_check, sweep_cuda
    from rpg_open_remode_tpu_torch.utils import se3, synthetic
    from rpg_open_remode_tpu_torch.utils.profiling import graph_ms

    cam_kw = dict(fx=fx, fy=fy, cx=(width - 1) / 2, cy=(height - 1) / 2)
    cfg = RemodeConfig.for_camera(fx)
    frames = synthetic.generate(n_frames=wu + 4, width=width, height=height, cam=cam_kw,
                                seed=1, step=0.023)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    eng = Depthmap(width, height, fx, cam_kw["cx"], fy, cam_kw["cy"], cfg=cfg, device=device)
    eng.set_reference_image(f0.image, _Tcw(f0), d.min(), d.max())
    for fr in frames[1:wu + 1]:
        eng.update(fr.image, _Tcw(fr))

    # the exact sweep inputs the next update would run
    tgt = frames[wu + 1]
    st = eng.state
    T_curr_ref = se3.compose(to_device(_Tcw(tgt), eng.device, pose=True), st.T_world_ref)
    border = seed_check.border_mask(height, width, cfg, device=eng.device)
    conv1 = seed_check.classify_seeds(st.mu, st.sigma_sq, st.a, st.b, st.scene.epsilon,
                                      border, cfg)
    prep = rect_match.prepare_sweep(dataclasses.replace(st, conv=conv1),
                                    prep_image(to_device(tgt.image, eng.device)), T_curr_ref,
                                    eng.cam, cfg)
    full = (prep["curr_img_r"], prep["xlim"], prep["ref_img_r"], prep["valid_r"],
            prep["disp_lo"], prep["disp_hi"], cfg.ncc_threshold, cfg.num_planes, cfg.disp_pad,
            cfg.patch_side, cfg.subplane_refine)
    cuda = eng.device.type == "cuda"
    out = {"point": name, "patch": cfg.patch_side, "num_planes": cfg.num_planes,
           "rect_shape": list(prep["ref_img_r"].shape), "coarse_fired": False}
    passes = [("sweep", full)]
    if prep["gate"] is not None and bool(prep["gate"]):
        out["coarse_fired"] = True
        passes.append(("coarse", prep["coarse_args"]))
    for label, args in passes:
        work = accounting.call_work(*args)
        ms = graph_ms(lambda args=args: sweep_cuda.disparity_sweep(*args)) if cuda else None
        b_ms, b_by = accounting.bound_ms(work["bytes"], work["flops"])
        out.update({
            f"{label}_ms_measured": ms,
            f"{label}_bound_ms": b_ms,
            f"{label}_bound_by": b_by,
            f"{label}_bound_over_measured_pct": None if ms is None else 100 * b_ms / ms,
            f"{label}_pairs": work["pairs"],
            f"{label}_pixels": work["pixels"],
            f"{label}_ns_per_pair": None if ms is None else ms * 1e6 / max(work["pairs"], 1.0),
            f"{label}_gflops_alg": work["flops"] / 1e9,
            f"{label}_gflops_exec": work["flops_exec"] / 1e9,
            f"{label}_bytes": work["bytes"],
        })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--json", default=None, help="also write the points to this path")
    a = p.parse_args(argv)
    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device
    from rpg_open_remode_tpu_torch.utils.devices import card_info

    device = resolve_device(a.device)
    card = card_info(device)
    print(f"{card['device_name']}, power limit {card['power_limit_w']} W", flush=True)
    out = dict(card, points=[])
    for pt in POINTS:
        out["points"].append(point(*pt, device=device))
        print(json.dumps(out["points"][-1]), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
