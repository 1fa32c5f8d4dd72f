"""Accuracy evaluation of the port (counterpart of the repository's root
``eval.py``, which drives the JAX package).

The same protocols on the same hardened synthetic scene, through the port's
``Depthmap``:

  eval_fixed_keyframe     one keyframe on frame 0, every later frame
                          updates it, a final denoise (the reference's
                          test/dataset_main.cpp), optionally with VO-like
                          pose noise on every update pose
  eval_keyframe_segments  a new keyframe every ``seg_len`` frames, bounds
                          padded 0.5x / 2.5x, mean accuracy per keyframe
  eval_real_dataset       the reference experiment on an on-disk dataset
                          in the reference's layout

``main()`` runs eval.py's 14 synthetic rows with eval.py's configs and
prints, per row, the JAX package's ``EVAL.json`` figures (``REFERENCE``)
beside the port's, each ``ok`` or ``OUTSIDE``: converged within +-1.5
points, and within 2.6 % of the depth range (raw, and denoised where the
row has it) at most 1.5 points below. It exits non-zero if a row is
OUTSIDE. It never writes ``EVAL.json``; ``--json PATH`` writes the port's
own record.

    python -m rpg_open_remode_tpu_torch.eval [--rows over_table,fhd_1920x1080]
        [--device cuda|cpu] [--json PATH] [--data-path DIR [--frames N]]

Imports torch and numpy, never JAX or the JAX package: ``HARDEN``, the
pose-noise draw and the accuracy function are copies of eval.py's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rpg_open_remode_tpu_torch.utils.profiling import FrameClock

HARDEN = dict(noise_sigma=0.01, vignette=0.15, n_textureless=3, n_spheres=2)

CAM_640 = dict(fx=481.2, fy=-480.0, cx=319.5, cy=239.5)
CAM_752 = dict(fx=481.2, fy=-480.0, cx=375.5, cy=239.5)
CAM_720 = dict(fx=962.4, fy=-960.0, cx=639.5, cy=359.5)
CAM_1080 = dict(fx=1443.6, fy=-1440.0, cx=959.5, cy=539.5)
FAST_STEP = 1.61 / 60.0   # paper Table I: 1.61 m/s at 60 fps

# The JAX package's EVAL.json figures: converged %, within 2.6 % of range
# raw and denoised as fractions (the keyframe-segment rows: their means per
# keyframe, raw only). tests/test_torch_eval.py holds them equal to the file.
REFERENCE = {
    "over_table": (68.30260047281324, 0.935740986135559, 0.9804988034255652),
    "over_table_posenoise": (58.33299560959136, 0.9085072138208935, 0.9774843102290359),
    "over_table_posenoise_modeled_0.05": (63.173590003377235, 0.926161544342099,
                                          0.9786856412751194),
    "over_table_posenoise_modeled_0.1": (58.25261735900034, 0.9240923901070232,
                                         0.9779344410560857),
    "over_table_posenoise_modeled_0.2": (42.211077338736914, 0.8681302855496972,
                                         0.9537631913719027),
    "fast_motion": (33.76534954407295, 0.9143780305282995, None),
    "fast_motion_propagated": (65.54562647754136, 0.9098068776754291, None),
    "over_table_lifecycle": (72.89181582798604, 0.8869792832207926, None),
    "over_table_lifecycle_propagated": (75.82727306840782, 0.8563772480530752, None),
    "live_752x480": (72.44365429833114, 0.9411850854971501, 0.9865816972767575),
    "hd_1280x720": (64.80448042586227, 0.9064451981887319, 0.9456020618062709),
    "hd_1280x720_p5_wide": (52.70744149939004, 0.6738795151316218, 0.8620006186048567),
    "fhd_1920x1080": (53.41341684200225, 0.9422394444902483, 0.9538727201106623),
    "fhd_1920x1080_p17": (55.296521015804665, 0.9553913609032869, 0.9628208247979152),
}
CONVERGED_POINTS = 1.5   # converged % within +-1.5 points of the row
WITHIN_POINTS = 1.5      # within-2.6 % at most 1.5 points below the row


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _accuracy(eng, gt, depth_range, denoise=True):
    from rpg_open_remode_tpu_torch.config import ConvergenceState

    err_bound = 0.026 * depth_range
    conv = eng.convergence_map()
    mu = eng.depthmap()
    interior = np.zeros_like(conv, bool)
    interior[5:-5, 5:-5] = True
    valid_gt = np.isfinite(gt) & interior
    converged = (conv == int(ConvergenceState.CONVERGED)) & valid_gt
    err_raw = np.abs(mu - gt)
    out = {
        "converged_pct": 100.0 * converged.sum() / valid_gt.sum(),
        "rmse_converged_raw_m": float(np.sqrt(np.mean(err_raw[converged] ** 2)))
        if converged.any() else float("nan"),
        "median_err_converged_m": float(np.median(err_raw[converged]))
        if converged.any() else float("nan"),
        "within_2p6pct_raw": float((err_raw[converged] < err_bound).mean())
        if converged.any() else float("nan"),
    }
    if denoise and converged.any():
        den = eng.denoised_depthmap(0.5, 200)
        err_den = np.abs(den - gt)
        out["rmse_converged_denoised_m"] = float(
            np.sqrt(np.mean(err_den[converged] ** 2))
        )
        out["within_2p6pct_denoised"] = float(
            (err_den[converged] < err_bound).mean()
        )
    return out, (valid_gt, converged, err_raw, err_bound)


def _noisy_Tcw(T_cw, rng, sigma_rot_rad, sigma_t_m):
    """Perturb a 3x4 world->camera pose with small rotation/translation
    noise (eval.py's model of a VO front end's pose error): a rotation of
    normal axis-angle ``sigma_rot_rad`` applied on the left, then normal
    translation noise ``sigma_t_m``; drawn and composed in float64, returned
    as float32."""
    w = rng.normal(0.0, sigma_rot_rad, 3)
    th = np.linalg.norm(w)
    if th > 1e-12:
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        dR = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    else:
        dR = np.eye(3)
    T = np.array(T_cw, np.float64)
    T[:, :3] = dR @ T[:, :3]
    T[:, 3] = dR @ T[:, 3] + rng.normal(0.0, sigma_t_m, 3)
    return T.astype(np.float32)


def _generate(width, height, cam, n_frames, step, seed):
    from rpg_open_remode_tpu_torch.utils import synthetic

    return synthetic.generate(n_frames=n_frames, width=width, height=height,
                              cam=cam, seed=seed, step=step, **HARDEN)


def eval_fixed_keyframe(width, height, cam, n_frames, step, seed=1,
                        curve=False, sweep=False, cfg=None,
                        pose_noise=None, device=None, frames=None):
    """dataset_main-style: frame 0 is the only keyframe. ``pose_noise``
    = (sigma_rot_deg, sigma_t_m): per-frame VO-like pose error applied to
    every UPDATE pose (the keyframe pose stays exact). ``device`` None means
    CUDA; ``frames``, when given, are ``n_frames`` frames of the hardened
    scene already rendered with these arguments. Adds to eval.py's report
    the per-update median and p90 in ms (CUDA events on the card, the host
    clock on the CPU)."""
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap

    if frames is None:
        frames = _generate(width, height, cam, n_frames, step, seed)
    f0 = frames[0]
    gt = f0.depth
    d0 = gt[np.isfinite(gt)]
    depth_range = float(d0.max() - d0.min())
    eng = Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                   cfg=cfg, device=device)
    eng.set_reference_image(f0.image, _Tcw(f0), d0.min(), d0.max())
    nrng = np.random.default_rng(seed + 1000) if pose_noise else None
    clock = FrameClock(eng.device)
    conv_curve = []
    for i, fr in enumerate(frames[1:], 1):
        T = _Tcw(fr)
        if pose_noise:
            T = _noisy_Tcw(T, nrng, np.deg2rad(pose_noise[0]), pose_noise[1])
        clock(lambda: eng.update(fr.image, T))
        if curve and i % 20 == 0:
            conv_curve.append(
                {"frame": i, "converged_pct": eng.converged_percentage()}
            )

    report, (valid_gt, converged, err_raw, err_bound) = _accuracy(
        eng, gt, depth_range
    )
    ms = clock.ms()
    report.update({
        "frames": n_frames,
        "resolution": f"{width}x{height}",
        "motion_step_m": step,
        "depth_range_m": depth_range,
        "frame_ms_median": float(np.median(ms)),
        "frame_ms_p90": float(np.percentile(ms, 90)),
    })
    if pose_noise:
        report["pose_noise"] = {"sigma_rot_deg": pose_noise[0],
                                "sigma_t_m": pose_noise[1]}
    if curve:
        report["convergence_curve"] = conv_curve
    if sweep:
        sigma_sq = eng.state.sigma_sq.cpu().numpy()
        rows = []
        for thr in [1e-4, 3e-4, 6e-4, 1e-3, 3e-3, 1e-2, 3e-2]:
            accepted = (sigma_sq < thr) & valid_gt
            n_acc = int(accepted.sum())
            rows.append({
                "sigma_sq_thr": thr,
                "completeness": n_acc / int(valid_gt.sum()),
                "precision": float((err_raw[accepted] < err_bound).mean())
                if n_acc else float("nan"),
            })
        report["precision_completeness"] = rows
    return report


def eval_keyframe_segments(width, height, cam, n_frames, step, seg_len,
                           seed=1, bound_pad=(0.5, 2.5), cfg=None,
                           device=None, frames=None, keep_switch=None,
                           reseed_wrap=None):
    """Fast-motion style: a new keyframe every ``seg_len`` frames (the live
    system switches keyframes by the distance rule, depthmap_node.cpp:148).

    ``bound_pad`` scales the GT depth bounds before seeding, as a live
    SVO-fed system would; the accuracy criterion (2.6 % of range) still
    uses the GT range, and each keyframe's accuracy is taken without
    denoise. ``device`` and ``frames`` as in ``eval_fixed_keyframe``.
    Two hooks for a caller that inspects a run: ``keep_switch`` k puts the
    k-th keyframe seed's inputs under ``report["kept"]`` (the engine, the
    outgoing state, image, pose and bounds), and ``reseed_wrap()`` is a
    context entered around every keyframe seed after the first."""
    import contextlib

    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap

    if frames is None:
        frames = _generate(width, height, cam, n_frames, step, seed)
    eng = Depthmap(width, height, cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                   cfg=cfg, device=device)
    per_kf = []
    kept = None
    i = 0
    while i + seg_len <= n_frames:
        f_ref = frames[i]
        gt = f_ref.depth
        d = gt[np.isfinite(gt)]
        depth_range = float(d.max() - d.min())
        bounds = (bound_pad[0] * d.min(), bound_pad[1] * d.max())
        if len(per_kf) == keep_switch:
            kept = dict(eng=eng, state=eng.state, img=f_ref.image, T=_Tcw(f_ref),
                        bounds=(float(bounds[0]), float(bounds[1])))
        wrap = reseed_wrap() if reseed_wrap and per_kf else contextlib.nullcontext()
        with wrap:
            eng.set_reference_image(f_ref.image, _Tcw(f_ref), *bounds)
        for fr in frames[i + 1 : i + seg_len]:
            eng.update(fr.image, _Tcw(fr))
        acc, _ = _accuracy(eng, gt, depth_range, denoise=False)
        per_kf.append(acc)
        i += seg_len

    def mean_of(key):
        vals = [k[key] for k in per_kf if np.isfinite(k[key])]
        return float(np.mean(vals)) if vals else float("nan")

    report = {
        "frames": n_frames,
        "resolution": f"{width}x{height}",
        "motion_step_m": step,
        "keyframes": len(per_kf),
        "updates_per_keyframe": seg_len - 1,
        "mean_converged_pct_per_kf": mean_of("converged_pct"),
        "mean_rmse_converged_m": mean_of("rmse_converged_raw_m"),
        "mean_within_2p6pct": mean_of("within_2p6pct_raw"),
    }
    if keep_switch is not None:
        report["kept"] = kept
    return report


def eval_real_dataset(
    data_path, n_frames=200, denoise=True,
    sequence="first_200_frames_traj_over_table_input_sequence.txt",
    size=(640, 480), cam=None, device=None,
):
    """The reference experiment on the traj_over_table dataset
    (test/dataset_main.cpp:32-135) through the port's ``io.Dataset``:
    camera (481.2, -480.0, 319.5, 239.5) at 640x480, frame 0 the reference
    with min/max depth from its ground-truth depthmap, frames 1..n-1 update,
    a final denoise(0.5, 200); accuracy of converged seeds against frame 0's
    GT. ``sequence``/``size``/``cam`` let tests drive the same path on a
    small dataset written on the fly.

    Timing: the updates run in blocks of 10 frames, as eval.py blocks them;
    each block is timed between two CUDA events on the card (on the CPU, by
    the host clock after a scalar fetch ends it), and mean/var are over the
    blocks' per-frame means."""
    from rpg_open_remode_tpu_torch.io import Dataset
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap
    from rpg_open_remode_tpu_torch.utils.profiling import force

    cam = cam or dict(fx=481.2, cx=319.5, fy=-480.0, cy=239.5)
    ds = Dataset(sequence, path=data_path)
    if not ds.read_data_sequence(0, n_frames):
        raise FileNotFoundError(
            f"cannot read {ds.path / ds.sequence_file} — fetch the dataset "
            "with scripts/fetch_traj_over_table.sh"
        )
    W, H = size
    entry0 = ds[0]
    img0 = ds.read_image(entry0)
    gt = ds.read_depthmap(entry0, W, H)
    d0 = gt[np.isfinite(gt)]
    depth_range = float(d0.max() - d0.min())
    eng = Depthmap(W, H, **cam, device=device)
    eng.set_reference_image(img0, entry0.T_curr_world, float(d0.min()),
                            float(d0.max()))

    entries = list(ds)[1:]
    images = [ds.read_image(e) for e in entries]   # decode off the clock
    BLOCK = 10
    clock = FrameClock(eng.device)
    sizes = []
    i = 0
    while i < len(entries):
        j = min(i + BLOCK, len(entries))

        def block(i=i, j=j):
            for k in range(i, j):
                eng.update(images[k], entries[k].T_curr_world)
            if not clock.cuda:
                force(eng.programs.state.mu[0, 0])

        clock(block)
        sizes.append(j - i)
        i = j
    times = clock.ms() / 1e3 / np.array(sizes) if sizes else np.array([float("nan")])
    report, _ = _accuracy(eng, gt, depth_range, denoise=denoise)
    report.update({
        "frames": len(ds),
        "resolution": f"{W}x{H}",
        "depth_range_m": depth_range,
        "mean_update_s": float(np.mean(times)),
        "var_update_s": float(np.var(times)),
        "timing_block_frames": BLOCK,
        "data_path": str(ds.path),
    })
    return report


def rows():
    """eval.py's 14 synthetic rows in its order: name -> (protocol,
    keyword arguments). ``cfg`` None means ``RemodeConfig.for_camera(fx)``."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig

    over = dict(width=640, height=480, cam=CAM_640, n_frames=200, step=0.023)
    fast = dict(width=640, height=480, cam=CAM_640, n_frames=190, step=FAST_STEP,
                seg_len=int(0.5 / FAST_STEP) + 1)
    life = dict(width=640, height=480, cam=CAM_640, n_frames=198, step=0.023,
                seg_len=int(0.5 / 0.023) + 1)
    prop = RemodeConfig(propagate_depth=True)
    out = {
        "over_table": (eval_fixed_keyframe, dict(over, curve=True, sweep=True)),
        "over_table_posenoise": (eval_fixed_keyframe, dict(over, pose_noise=(0.1, 0.002))),
    }
    for rot in (0.05, 0.1, 0.2):
        out[f"over_table_posenoise_modeled_{rot}"] = (eval_fixed_keyframe, dict(
            over, pose_noise=(rot, 0.002),
            cfg=RemodeConfig(pose_noise_rot_deg=rot, pose_noise_trans_m=0.002)))
    out.update({
        "fast_motion": (eval_keyframe_segments, fast),
        "fast_motion_propagated": (eval_keyframe_segments, dict(fast, cfg=prop)),
        "over_table_lifecycle": (eval_keyframe_segments, life),
        "over_table_lifecycle_propagated": (eval_keyframe_segments, dict(life, cfg=prop)),
        "live_752x480": (eval_fixed_keyframe, dict(width=752, height=480, cam=CAM_752,
                                                   n_frames=120, step=0.023)),
        "hd_1280x720": (eval_fixed_keyframe, dict(width=1280, height=720, cam=CAM_720,
                                                  n_frames=80, step=0.023)),
        "hd_1280x720_p5_wide": (eval_fixed_keyframe, dict(
            width=1280, height=720, cam=CAM_720, n_frames=80, step=0.023,
            cfg=RemodeConfig(disp_pad=256, num_planes=255))),
        "fhd_1920x1080": (eval_fixed_keyframe, dict(width=1920, height=1080, cam=CAM_1080,
                                                    n_frames=120, step=0.023)),
        "fhd_1920x1080_p17": (eval_fixed_keyframe, dict(
            width=1920, height=1080, cam=CAM_1080, n_frames=60, step=0.023,
            cfg=RemodeConfig.for_camera(CAM_1080["fx"], patch_side=17))),
    })
    return out


def figures(report) -> dict:
    """A report's figures on EVAL.json's terms: converged %, within raw and
    (where the protocol has it) denoised, as fractions."""
    if "mean_converged_pct_per_kf" in report:
        return dict(converged_pct=report["mean_converged_pct_per_kf"],
                    within_raw=report["mean_within_2p6pct"])
    out = dict(converged_pct=report["converged_pct"], within_raw=report["within_2p6pct_raw"])
    if "within_2p6pct_denoised" in report:
        out["within_denoised"] = report["within_2p6pct_denoised"]
    return out


def judge(name, report):
    """(ok, the line that sets the port's figures beside the row's):
    converged within +-CONVERGED_POINTS, each within at most WITHIN_POINTS
    below."""
    conv, raw, den = REFERENCE[name]
    got = figures(report)
    ok = abs(got["converged_pct"] - conv) <= CONVERGED_POINTS
    parts = [f"converged {got['converged_pct']:.4f} % (EVAL.json {conv:.2f})"]
    for key, want in (("within_raw", raw), ("within_denoised", den)):
        if want is None:
            continue
        have = got.get(key, float("nan"))
        ok = ok and 100 * have >= 100 * want - WITHIN_POINTS
        parts.append(f"within 2.6 % {key.split('_')[1]} {100 * have:.4f} % "
                     f"(EVAL.json {100 * want:.2f})")
    return ok, "; ".join(parts) + f": {'ok' if ok else 'OUTSIDE'}"


def main_real(data_path, n_frames, device=None):
    """The real traj_over_table row on the dataset at ``data_path``."""
    try:
        r = eval_real_dataset(data_path, n_frames=n_frames, device=device)
    except FileNotFoundError as e:
        raise SystemExit(f"SKIPPED (no real dataset): {e}")
    print(f"traj_over_table (REAL): conv {r['converged_pct']:.1f}%  "
          f"RMSE {r['rmse_converged_raw_m']*1000:.1f} mm  "
          f"within-2.6% {100*r['within_2p6pct_raw']:.1f}%  "
          f"update {r['mean_update_s']*1000:.1f} ms "
          f"(paper: 38.2 ms, >60% within 2.6%)", flush=True)
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default=None,
                   help="comma-separated row names (default: all 14 synthetic rows)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--json", default=None, help="write the port's record to this path")
    p.add_argument("--data-path", default=None,
                   help="run the real traj_over_table row on the dataset at this path "
                        "instead of the synthetic rows")
    p.add_argument("--frames", type=int, default=200)
    a = p.parse_args(argv)

    from rpg_open_remode_tpu_torch.models.depthmap import resolve_device

    device = resolve_device(a.device)
    record = {"device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu", "scene_hardening": HARDEN}
    bad = []
    if a.data_path:
        record["traj_over_table_real"] = main_real(a.data_path, a.frames, device)
    else:
        table = rows()
        names = list(table) if a.rows is None else a.rows.split(",")
        unknown = [n for n in names if n not in table]
        if unknown:
            p.error(f"unknown rows {unknown}; the rows are {list(table)}")
        cache = {}
        for name in names:
            fn, kw = table[name]
            key = tuple(kw[k] if k != "cam" else tuple(kw[k].items())
                        for k in ("width", "height", "cam", "n_frames", "step"))
            if key not in cache:    # rows that share a sequence render it once
                cache.clear()
                t0 = time.perf_counter()
                cache[key] = _generate(kw["width"], kw["height"], kw["cam"],
                                       kw["n_frames"], kw["step"], seed=1)
                print(f"{name}: rendered {kw['n_frames']} frames at {kw['width']}x"
                      f"{kw['height']} in {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            r = fn(**kw, device=device, frames=cache[key])
            r["seconds"] = time.perf_counter() - t0
            ok, line = judge(name, r)
            r["ok"] = ok
            timing = (f"; per frame median {r['frame_ms_median']:.3f} ms, p90 "
                      f"{r['frame_ms_p90']:.3f} ms" if "frame_ms_median" in r else "")
            print(f"{name}: {line}; {r['seconds']:.1f} s{timing}", flush=True)
            record[name] = r
            if not ok:
                bad.append(name)
        if "over_table" in record:
            print(f"{'sigma^2_thr':>12} {'completeness':>13} {'precision':>10}")
            for row in record["over_table"]["precision_completeness"]:
                print(f"{row['sigma_sq_thr']:>12.0e} {row['completeness']:>13.3f} "
                      f"{row['precision']:>10.3f}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(record, f, indent=2, default=float)
    if bad:
        print(f"rows OUTSIDE the EVAL.json bounds: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
