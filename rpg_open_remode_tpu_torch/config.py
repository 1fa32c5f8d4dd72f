"""Frozen configuration for the dense-mapping engine (PyTorch port).

A field-for-field copy of ``rpg_open_remode_tpu/config.py``: the port keeps
its own copy because importing the JAX package's config would import JAX.
The fields must stay equal to the JAX package's (tests/test_torch_config.py).

The reference (uzh-rpg/rpg_open_remode) spreads its algorithm constants over
compile-time ``-D`` defines (``CMakeLists.txt:51-53``), hard-coded kernel
literals (``src/seed_matrix.cu:96-104``, ``src/depthmap_denoiser.cu:124-141``)
and ROS params (``src/depthmap_node.cpp:40-81``). Here they are a single
runtime dataclass; the defaults reproduce the reference behaviour and are
load-bearing for accuracy parity.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class ConvergenceState(enum.IntEnum):
    """Per-seed lifecycle states.

    Values match the reference enum (``include/rmd/seed_matrix.cuh:31-43``)
    so convergence maps are directly comparable.
    """

    UPDATE = 0
    CONVERGED = 1
    BORDER = 2
    DIVERGED = 3
    NO_MATCH = 4
    NOT_VISIBLE = 5


@dataclasses.dataclass(frozen=True)
class RemodeConfig:
    """All algorithm constants. Defaults reproduce the reference.

    Citations point into uzh-rpg/rpg_open_remode (the CUDA reference).
    """

    # --- NCC patch correlation (CMakeLists.txt:51-53, mvs_device_data.cuh:39-43)
    patch_side: int = 5          # RMD_CORR_PATCH_SIDE (must be odd)
    max_epipolar_extent: float = 100.0  # RMD_MAX_EXTENT_EPIPOLAR_SEARCH, px
    epi_step_px: float = 0.7     # epipolar walk step (epipolar_match.cu:88)
    ncc_threshold: float = 0.5   # accept threshold (epipolar_match.cu:131)
    sigma_band: float = 3.0      # search +-3 sigma (epipolar_match.cu:69-71)
    min_search_depth: float = 0.01  # clamp on mu-3sigma (epipolar_match.cu:69)

    # --- Bayesian seed filter (seed_matrix.cu:96-104, seed_init.cu:56-60)
    a_init: float = 10.0
    b_init: float = 10.0
    eta_inlier: float = 0.7
    eta_outlier: float = 0.05
    epsilon_factor: float = 1e-3     # epsilon = depth_range * factor
    sigma_sq_max_factor: float = 1.0 / 36.0  # sigma_sq_max = range^2 * factor

    # --- TV-L1 primal-dual denoiser (depthmap_denoiser.cu:124-141, :226-229)
    tv_tau: float = 0.02
    tv_theta: float = 0.5
    tv_lambda: float = 0.2           # default; overridden per call
    large_sigma_sq_factor: float = 1.0 / 72.0
    denoise_lambda: float = 0.5      # lifecycle denoise call (depthmap_node.cpp:167)
    denoise_iters: int = 200

    # --- Keyframe lifecycle (depthmap_node.cpp:79-80)
    ref_compl_perc: float = 10.0     # % converged to trigger new keyframe
    max_dist_from_ref: float = 0.5   # meters travelled to trigger new keyframe
    publish_conv_every_n: int = 10   # mid-keyframe convergence-map publish
                                     # cadence (remode/publish_conv_every_n,
                                     # src/depthmap_node.cpp:81,158-162);
                                     # only paid when a consumer registers

    # --- TPU-native matcher design (no reference analog: this replaces the
    # per-pixel epipolar walk with a masked inverse-depth plane sweep)
    # depth/disparity hypotheses per sweep; the rectified matcher's padded
    # the sweep buffer admits at most disp_pad - 1 integer disparities (the
    # x-box-sum rolls need 2 lanes of slack) and asserts rather than
    # silently truncating; widen disp_pad to raise the ceiling
    num_planes: int = 127
    disp_pad: int = 128              # static disparity-window padding of the
                                     # rectified current image; num_planes <=
                                     # disp_pad - 1. At 2x focal length (HD)
                                     # per-frame disparity ranges double:
                                     # disp_pad=256 + num_planes=255 restores
                                     # the full-range search (see eval.py)
    # JAX-package switches, kept so the two configs stay field-for-field
    # equal; the port ignores both: on CUDA tensors it always launches its
    # kernels, on CPU tensors it always runs their plain versions
    use_pallas: bool = True
    pallas_interpret: bool = False
    # "rect" (rectified disparity sweep, the TPU-native hot path) |
    # "sweep" (homography plane sweep) | "walk" (reference-semantics oracle)
    match_mode: str = "rect"
    # guard the rectified matcher with a pure-rotation fallback for
    # near-zero baselines (vmapped/batched engines disable it: under vmap a
    # cond becomes a select that pays for both branches every frame)
    zero_baseline_fallback: bool = True
    # fall back to the inverse-depth plane sweep when an epipole lies
    # inside/near the image footprint (dominantly axial motion, where
    # rectification degenerates; the reference's walk covers any motion,
    # epipolar_match.cu:63-96). Requires zero_baseline_fallback.
    forward_motion_fallback: bool = True
    # rebase the disparity window per frame so large baselines stay
    # searchable (reference-faithful coverage: its walk has no absolute
    # disparity cap). Trades a small gross-outlier tail (harder long-range
    # matches) for substantially higher completeness; robust accuracy
    # metrics (within-bound fraction, precision) are nearly unchanged.
    disp_rebase: bool = True
    subplane_refine: bool = True     # parabolic NCC-peak refinement
    # coarse-to-fine sweep: when the per-pixel Bayesian disparity bands are
    # still wide (young keyframes), an x-decimated half-resolution sweep
    # first localizes each pixel's NCC peak, and the full-resolution sweep
    # then only covers +-coarse_refine_radius planes around it (per-pixel
    # band masks + per-band group skipping turn that into real skipped
    # work). A lax.cond skips the coarse pass entirely once the bands are
    # already narrower than the refine window (converged steady state).
    coarse_to_fine: bool = True
    coarse_refine_radius: float = 6.0
    # straggler band slicing (beyond-reference; ops/rect_match.
    # straggler_slice_bands): seeds that keep failing to match (mostly
    # outlier Beta evidence after straggler_after fruitless frames) stop
    # sweeping their full +-3 sigma band every frame and instead sweep a
    # rotating (2*coarse_refine_radius + 2)-plane slice of it — a
    # golden-ratio-stepped exploration window two frames out of three, a
    # mu-centered exploitation window on the third. The full band is still
    # covered over successive frames (low-discrepancy rotation), so a
    # late-appearing match is found within a few frames; meanwhile the
    # per-block plane hulls that set the sweep kernel's cost stop being
    # inflated by unmatchable pixels (measured: the dominant HD/FHD cost,
    # BENCH_r05 efficiency records). The slice phase derives from the
    # maximum per-seed outlier count (a per-keyframe frame-counter
    # estimate), so it is identical across pixels and mesh shards.
    # straggler_after = 10 from the round-5 hardened-HD dose-response:
    # after=6 truncates matchable pixels' full-band search before their
    # first match (8.0 ms/frame but -1 conv pt); after=10 keeps the young
    # phase intact and then the narrower rotating search produces CLEANER
    # evidence than the full band (fewer spurious above-threshold NCC
    # peaks per frame): conv 64.8% vs 60.6% unsliced at 0.93x the time;
    # after=14 converges back to the unsliced behavior.
    straggler_slice: bool = True
    straggler_after: float = 10.0
    # keyframe-to-keyframe depth propagation (beyond-reference,
    # ops/propagate.py): warm-start new keyframes' seeds from the previous
    # keyframe's posterior via an inverse-depth plane sweep of homography
    # warps. Propagated seeds get a narrowed variance (their own posterior
    # inflated 4x, floored at (propagate_sigma_factor * depth_range)^2)
    # but RESTART from the flat Beta prior (a=b=a_init/b_init): carrying
    # accumulated evidence was measured to trade accuracy for convergence
    # (round-4 dose-response, ops/propagate.py docstring). Pixels whose
    # reprojection misses by more than propagate_tol_px keep the
    # reference's flat prior entirely. tol = 2 px matches the sweep's
    # plane-spacing placement precision (~1.5 px at fx*baseline ~ 240;
    # ops/propagate.PLANES).
    propagate_depth: bool = False
    propagate_sigma_factor: float = 1.0 / 32.0
    propagate_tol_px: float = 2.0
    # pose-noise measurement model (beyond-reference; default off =
    # reference-exact): the reference's tau models only the one-pixel
    # matching angle (triangulation.cu:52-68), so VO pose error registers
    # as OUTLIER evidence (b += via low normpdf) instead of wider
    # measurement variance — convergence collapses under noisy poses
    # (EVAL.json over_table_posenoise, round 4). With these set to the
    # VO's expected per-frame error, ops/seed_update.py widens tau:
    # rotational error adds to the triangulation angle exactly like the
    # pixel angle (both perturb beta first-order), translational error
    # scales depth by the relative baseline error (z * dt/|t|).
    pose_noise_rot_deg: float = 0.0
    pose_noise_trans_m: float = 0.0

    @classmethod
    def for_camera(cls, fx: float, **overrides) -> "RemodeConfig":
        """Defaults scaled to the camera's focal length.

        The reference's constants are tuned for its ~481 px focal cameras
        (test/dataset_main.cpp:37, 640/752-wide). At higher focal lengths
        two of them silently degrade (measured, round 4, 1280x720 at
        fx=962.4 on the hardened synthetic scene):

        * the 5x5 NCC patch covers half the angular footprint, doubling
          match ambiguity — within-2.6%-of-range of converged seeds fell
          to 0.67. Scaling the patch to the same angular footprint
          (side = odd(5 * fx/481.2) -> 9 at 2x) restored 0.90 and raised
          convergence 51.8% -> 61.0% with better RMSE.
        * per-frame disparity ranges scale with fx, so the default
          127-plane window under-searches; the window doubles with the
          focal ratio (num_planes 255 / disp_pad 256 at 2x).

        At fx <= ~481 this returns the reference-exact defaults. Explicit
        ``overrides`` win over the scaling.
        """
        s = max(abs(float(fx)) / 481.2, 1.0)
        scaled: dict = {}
        side = int(5 * s)
        side -= (side + 1) % 2          # largest odd <= 5*s
        if side > 5:
            scaled["patch_side"] = side
        if s >= 1.5:
            k = int(round(s))
            scaled["disp_pad"] = 128 * k
            scaled["num_planes"] = 128 * k - 1
        scaled.update(overrides)
        return cls(**scaled)

    @property
    def patch_offset(self) -> int:
        # RMD_CORR_PATCH_OFFSET = -RMD_CORR_PATCH_SIDE/2 (C int division)
        return -(self.patch_side // 2)

    @property
    def patch_area(self) -> int:
        return self.patch_side * self.patch_side

    @property
    def tv_sigma(self) -> float:
        # sigma_d = (1/L^2)/tau with L = sqrt(8) (depthmap_denoiser.cu:124-131)
        L = math.sqrt(8.0)
        return (1.0 / (L * L)) / self.tv_tau

    @property
    def max_walk_steps(self) -> int:
        """Static trip count for the epipolar-walk oracle.

        half_length <= max_extent/2 so the walk visits at most
        floor(2*half_length/step)+1 samples (epipolar_match.cu:73-88).
        """
        return int(self.max_epipolar_extent / self.epi_step_px) + 1


DEFAULT_CONFIG = RemodeConfig()
