"""The port's accuracy evaluation (``rpg_open_remode_tpu_torch/eval.py``)
against the root ``eval.py`` (the JAX package's), on the CPU at small sizes.

The protocols run on the hardened scene at 160x120 (fx 120.3, 0.06 m a frame:
at a quarter of the 640x480 focal length the scene's disparities need the
larger step to converge within a few dozen frames); the real-dataset path on
a dataset written on the fly, as tests/test_eval_real.py writes it. Held:
converged % within 0.1 point and within-2.6 % (raw and denoised) within 0.2
point of eval.py's figures. The pose-noise draw is held bit for bit. One
case forces the FHD configuration (patch 15, 383 planes) onto a 320x240
image so that it runs through the whole update on the CPU.
"""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import eval as jeval
import rpg_open_remode_tpu as J
from rpg_open_remode_tpu.utils import synthetic
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch import eval as peval

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
STEP = 0.06


def _assert_close(got, want, keys, points):
    for key in keys:
        scale = 1.0 if key.endswith("pct") or key.endswith("per_kf") else 100.0
        assert abs(scale * got[key] - scale * want[key]) <= points[key], (key, got[key], want[key])


def test_noisy_poses_equal_eval_py_bit_for_bit():
    """The same generator state gives the same perturbed pose, in the same
    order of draws, over a seeded sequence of poses."""
    frames = synthetic.generate(n_frames=25, width=32, height=24, seed=4, step=0.03)
    rng_p, rng_j = np.random.default_rng(1001), np.random.default_rng(1001)
    for sigma in ((0.1, 0.002), (0.2, 0.002), (0.0, 0.0), (1.5, 0.05)):
        for fr in frames:
            T = peval._Tcw(fr)
            np.testing.assert_array_equal(T, jeval._Tcw(fr))
            got = peval._noisy_Tcw(T, rng_p, np.deg2rad(sigma[0]), sigma[1])
            want = jeval._noisy_Tcw(T, rng_j, np.deg2rad(sigma[0]), sigma[1])
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert peval.HARDEN == jeval.HARDEN


def test_reference_figures_equal_eval_json():
    """``REFERENCE`` holds EVAL.json's figures for every synthetic row, and
    ``rows()`` runs exactly those rows in eval.py's order."""
    ev = json.loads((ROOT / "EVAL.json").read_text())
    rows = [k for k in ev if isinstance(ev[k], dict) and k != "scene_hardening"]
    assert list(peval.rows()) == rows == list(peval.REFERENCE)
    for name in rows:
        r = ev[name]
        if "mean_converged_pct_per_kf" in r:
            want = (r["mean_converged_pct_per_kf"], r["mean_within_2p6pct"], None)
        else:
            want = (r["converged_pct"], r["within_2p6pct_raw"], r["within_2p6pct_denoised"])
        assert peval.REFERENCE[name] == want, name


def test_row_configs_equal_eval_py():
    """Each row's protocol arguments and config are eval.py's: ``cfg`` None
    resolves to ``for_camera(fx)``; the explicit configs equal the JAX
    package's field by field."""
    rows = peval.rows()
    want_cfg = {
        "hd_1280x720_p5_wide": J.RemodeConfig(disp_pad=256, num_planes=255),
        "fhd_1920x1080_p17": J.RemodeConfig.for_camera(1443.6, patch_side=17),
        "fast_motion_propagated": J.RemodeConfig(propagate_depth=True),
        "over_table_lifecycle_propagated": J.RemodeConfig(propagate_depth=True),
    }
    for rot in (0.05, 0.1, 0.2):
        want_cfg[f"over_table_posenoise_modeled_{rot}"] = J.RemodeConfig(
            pose_noise_rot_deg=rot, pose_noise_trans_m=0.002)
    for name, (fn, kw) in rows.items():
        cfg = kw.get("cfg")
        if name in want_cfg:
            assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg[name]), name
        else:
            assert cfg is None, name
    fhd = rows["fhd_1920x1080"][1]
    assert (fhd["width"], fhd["height"], fhd["n_frames"], fhd["cam"]["fx"]) == (1920, 1080, 120,
                                                                                1443.6)
    assert rows["fhd_1920x1080_p17"][1]["n_frames"] == 60
    assert rows["live_752x480"][1]["cam"]["cx"] == 375.5
    assert rows["fast_motion"][1]["seg_len"] == 19
    assert rows["over_table_lifecycle"][1]["seg_len"] == 22
    assert rows["over_table_posenoise"][1]["pose_noise"] == (0.1, 0.002)


def test_judge_bounds():
    """A row is ok within +-1.5 points converged and at most 1.5 points
    below on each within figure; the segment rows have no denoised one."""
    conv, raw, den = peval.REFERENCE["over_table"]
    base = dict(converged_pct=conv, within_2p6pct_raw=raw, within_2p6pct_denoised=den)
    assert peval.judge("over_table", base)[0]
    assert peval.judge("over_table", dict(base, converged_pct=conv + 1.49))[0]
    assert not peval.judge("over_table", dict(base, converged_pct=conv - 1.51))[0]
    assert peval.judge("over_table", dict(base, within_2p6pct_raw=raw + 0.05))[0]
    assert not peval.judge("over_table", dict(base, within_2p6pct_denoised=den - 0.016))[0]
    c, w, _ = peval.REFERENCE["fast_motion"]
    seg = dict(mean_converged_pct_per_kf=c, mean_within_2p6pct=w - 0.014)
    ok, line = peval.judge("fast_motion", seg)
    assert ok and "denoised" not in line


@pytest.mark.parametrize("variant", ["plain", "pose_noise_modeled"])
def test_fixed_keyframe_matches_eval_py(variant):
    """eval_fixed_keyframe, 24 frames at 160x120, plain and with pose noise
    (0.1 deg, 2 mm) and the modeled config: converged within 0.1 point,
    within raw and denoised within 0.2 point, the same precision/
    completeness table within 0.2 point."""
    kw_j, kw_p = {}, {}
    if variant == "pose_noise_modeled":
        kw_j = dict(pose_noise=(0.1, 0.002),
                    cfg=J.RemodeConfig(pose_noise_rot_deg=0.1, pose_noise_trans_m=0.002))
        kw_p = dict(pose_noise=(0.1, 0.002),
                    cfg=P.RemodeConfig(pose_noise_rot_deg=0.1, pose_noise_trans_m=0.002))
    want = jeval.eval_fixed_keyframe(160, 120, CAM, 24, STEP, sweep=True, curve=True, **kw_j)
    got = peval.eval_fixed_keyframe(160, 120, CAM, 24, STEP, sweep=True, curve=True,
                                    device="cpu", **kw_p)
    assert want["converged_pct"] > 20.0
    _assert_close(got, want, ("converged_pct", "within_2p6pct_raw", "within_2p6pct_denoised"),
                  dict(converged_pct=0.1, within_2p6pct_raw=0.2, within_2p6pct_denoised=0.2))
    for key in ("frames", "resolution", "motion_step_m", "depth_range_m", "pose_noise"):
        assert got.get(key) == want.get(key), key
    assert [c["frame"] for c in got["convergence_curve"]] == [20]
    for g, w in zip(got["precision_completeness"], want["precision_completeness"]):
        assert g["sigma_sq_thr"] == w["sigma_sq_thr"]
        assert abs(g["completeness"] - w["completeness"]) <= 2e-3
    assert got["frame_ms_median"] > 0 and got["frame_ms_p90"] >= got["frame_ms_median"]


@pytest.mark.parametrize("propagate", [False, True])
def test_keyframe_segments_match_eval_py(propagate):
    """eval_keyframe_segments, 40 frames at 160x120 in two 20-frame
    keyframes with bounds padded 0.5x / 2.5x, flat and propagated."""
    cfg_j = J.RemodeConfig(propagate_depth=True) if propagate else None
    cfg_p = P.RemodeConfig(propagate_depth=True) if propagate else None
    want = jeval.eval_keyframe_segments(160, 120, CAM, 40, STEP, 20, cfg=cfg_j)
    seen = []

    @contextlib.contextmanager
    def reseed_wrap():
        seen.append(1)
        yield

    got = peval.eval_keyframe_segments(
        160, 120, CAM, 40, STEP, 20, cfg=cfg_p, device="cpu", keep_switch=1,
        reseed_wrap=reseed_wrap)
    kept = got.pop("kept")
    assert want["keyframes"] == got["keyframes"] == 2
    assert want["mean_converged_pct_per_kf"] > 20.0
    _assert_close(got, want, ("mean_converged_pct_per_kf", "mean_within_2p6pct"),
                  dict(mean_converged_pct_per_kf=0.1, mean_within_2p6pct=0.2))
    assert set(want) <= set(got)
    assert seen == [1]      # one switch after the first keyframe
    frame = synthetic.generate(n_frames=21, width=160, height=120, cam=CAM, seed=1, step=STEP,
                               **peval.HARDEN)[20]
    d = frame.depth[np.isfinite(frame.depth)]
    assert kept["bounds"] == (float(0.5 * d.min()), float(2.5 * d.max()))
    np.testing.assert_array_equal(kept["img"], frame.image)
    np.testing.assert_array_equal(kept["T"], peval._Tcw(frame))
    assert kept["state"].shape == (120, 160)


def _rot_to_quat_xyzw(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    return np.array([(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w), w], np.float64)


def test_real_dataset_matches_eval_py(tmp_path):
    """eval_real_dataset on a 30-frame dataset in the reference's layout
    (PNG images, ASCII-centimetre depth, a sequence file of T_world_curr),
    written as tests/test_eval_real.py writes it: the port's row against
    eval.py's, raw and denoised."""
    from PIL import Image

    frames = synthetic.generate(n_frames=30, width=160, height=120, cam=CAM, seed=5)
    (tmp_path / "images").mkdir()
    (tmp_path / "depthmaps").mkdir()
    lines = []
    for i, fr in enumerate(frames):
        name = f"scene_{i:03d}.png"
        Image.fromarray(np.clip(fr.image * 255.0, 0, 255).astype(np.uint8), mode="L").save(
            tmp_path / "images" / name)
        depth_cm = np.where(np.isfinite(fr.depth), fr.depth * 100.0, 1e9)
        (tmp_path / "depthmaps" / f"scene_{i:03d}.depth").write_text(
            " ".join(f"{v:.4f}" for v in depth_cm.ravel()))
        t, q = fr.T_world_curr[:, 3], _rot_to_quat_xyzw(fr.T_world_curr[:, :3])
        lines.append(f"{name} " + " ".join(f"{v:.9f}" for v in (*t, *q)))
    seq = "first_200_frames_traj_over_table_input_sequence.txt"
    (tmp_path / seq).write_text("\n".join(lines) + "\n")
    cam = dict(fx=CAM["fx"], cx=CAM["cx"], fy=CAM["fy"], cy=CAM["cy"])
    want = jeval.eval_real_dataset(str(tmp_path), n_frames=30, size=(160, 120), cam=cam)
    got = peval.eval_real_dataset(str(tmp_path), n_frames=30, size=(160, 120), cam=cam,
                                  device="cpu")
    assert want["converged_pct"] > 20.0
    _assert_close(got, want, ("converged_pct", "within_2p6pct_raw", "within_2p6pct_denoised"),
                  dict(converged_pct=0.1, within_2p6pct_raw=0.2, within_2p6pct_denoised=0.2))
    for key in ("frames", "resolution", "depth_range_m", "timing_block_frames", "data_path"):
        assert got[key] == want[key], key
    assert got["mean_update_s"] > 0 and got["var_update_s"] >= 0
    with pytest.raises(FileNotFoundError, match="fetch_traj_over_table"):
        peval.eval_real_dataset(str(tmp_path / "missing"), device="cpu")


def test_fhd_config_on_a_small_image_matches_jax():
    """``for_camera(1443.6)`` (patch 15, disp_pad 384, 383 planes) forced
    onto a 320x240 image at its own focal length: five updates through the
    whole step on the CPU against the JAX engine. conv agrees on >= 0.999 of
    pixels and mu within rtol 1e-4 on >= 0.999 of them (read: 1.0 and max
    relative 5e-5 at the 99th percentile)."""
    cam = dict(fx=240.6, fy=-240.0, cx=159.5, cy=119.5)
    frames = synthetic.generate(n_frames=6, width=320, height=240, cam=cam, seed=1,
                                step=0.023, **peval.HARDEN)
    d = frames[0].depth[np.isfinite(frames[0].depth)]
    out = []
    for pkg, kw in ((P, dict(device="cpu")), (J, {})):
        cfg = pkg.RemodeConfig.for_camera(1443.6)
        assert (cfg.patch_side, cfg.disp_pad, cfg.num_planes) == (15, 384, 383)
        eng = pkg.Depthmap(320, 240, cam["fx"], cam["cx"], cam["fy"], cam["cy"], cfg=cfg, **kw)
        eng.set_reference_image(frames[0].image, peval._Tcw(frames[0]), d.min(), d.max())
        for fr in frames[1:]:
            eng.update(fr.image, peval._Tcw(fr))
        out.append((eng.convergence_map(), eng.depthmap(), np.asarray(eng.state.sigma_sq)))
    (conv_p, mu_p, sig_p), (conv_j, mu_j, sig_j) = out
    assert np.mean(conv_p == conv_j) >= 0.999
    matched = conv_j == int(J.ConvergenceState.UPDATE)
    assert matched.mean() > 0.5
    assert np.mean(sig_j[matched] < sig_j.max()) > 0.5    # the updates measured depth
    assert np.mean(np.abs(mu_p - mu_j) <= 1e-4 * np.abs(mu_j)) >= 0.999
