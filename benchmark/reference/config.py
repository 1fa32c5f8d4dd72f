"""Frozen copy of rpg_open_remode_tpu_torch/config.py (the fields the
rectified engine reads, with the same defaults and derived values)."""

from __future__ import annotations

import dataclasses
import math

UPDATE, CONVERGED, BORDER, DIVERGED, NO_MATCH, NOT_VISIBLE = range(6)


@dataclasses.dataclass(frozen=True)
class Config:
    patch_side: int = 5
    max_epipolar_extent: float = 100.0
    epi_step_px: float = 0.7
    ncc_threshold: float = 0.5
    sigma_band: float = 3.0
    min_search_depth: float = 0.01
    a_init: float = 10.0
    b_init: float = 10.0
    eta_inlier: float = 0.7
    eta_outlier: float = 0.05
    epsilon_factor: float = 1e-3
    sigma_sq_max_factor: float = 1.0 / 36.0
    tv_tau: float = 0.02
    tv_theta: float = 0.5
    tv_lambda: float = 0.2
    large_sigma_sq_factor: float = 1.0 / 72.0
    denoise_lambda: float = 0.5
    denoise_iters: int = 200
    ref_compl_perc: float = 10.0
    max_dist_from_ref: float = 0.5
    publish_conv_every_n: int = 10
    num_planes: int = 127
    disp_pad: int = 128
    use_pallas: bool = True
    pallas_interpret: bool = False
    match_mode: str = "rect"
    zero_baseline_fallback: bool = True
    forward_motion_fallback: bool = True
    disp_rebase: bool = True
    subplane_refine: bool = True
    coarse_to_fine: bool = True
    coarse_refine_radius: float = 6.0
    straggler_slice: bool = True
    straggler_after: float = 10.0
    propagate_depth: bool = False
    propagate_sigma_factor: float = 1.0 / 32.0
    propagate_tol_px: float = 2.0
    pose_noise_rot_deg: float = 0.0
    pose_noise_trans_m: float = 0.0

    @property
    def patch_offset(self) -> int:
        return -(self.patch_side // 2)

    @property
    def patch_area(self) -> int:
        return self.patch_side * self.patch_side

    @property
    def tv_sigma(self) -> float:
        L = math.sqrt(8.0)
        return (1.0 / (L * L)) / self.tv_tau
