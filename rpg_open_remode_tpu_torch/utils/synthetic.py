"""Procedural ray-traced synthetic dataset with exact ground truth.

A copy of ``rpg_open_remode_tpu/utils/synthetic.py`` (numpy only), so the
port never imports the JAX package: the same seed gives bit-identical frames.

Stands in for the REMODE "traj_over_table" evaluation dataset (paper Table I:
640x480, depth 0.827-2.84 m, ~0.023 m/frame at 30 fps), which is not
redistributable here. The scene is a tilted textured plane (the "table") plus
a sphere, viewed by a camera translating laterally with gentle rotation; the
texture is a band-limited random Fourier field evaluated at the 3-D surface
point, so two views of the same point have *exactly* the same intensity and
NCC matching has a well-defined optimum. Ground-truth depth is the analytic
along-ray distance — the same quantity the seed filter's ``mu`` estimates.

Everything is deterministic in ``seed`` and pure numpy (host-side data
generation, not device compute).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Matches the reference evaluation camera (test/dataset_main.cpp:37).
# Note the negative fy — legal and exercised on purpose.
DEFAULT_CAM = dict(fx=481.2, fy=-480.0, cx=319.5, cy=239.5)


@dataclasses.dataclass
class SyntheticFrame:
    image: np.ndarray        # [H, W] float32 in [0, 1]
    depth: np.ndarray        # [H, W] float32 along-ray ground truth
    T_world_curr: np.ndarray  # (3, 4) float32 camera-to-world


class _Texture:
    """Smooth random Fourier texture over R^3, values in ~[0.05, 0.95]."""

    def __init__(self, rng: np.random.Generator, n_waves: int = 48):
        # wavelengths from ~2 cm to ~60 cm
        freqs = 2.0 * np.pi / rng.uniform(0.02, 0.6, size=n_waves)
        dirs = rng.normal(size=(n_waves, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        self.k = (dirs * freqs[:, None]).astype(np.float32)  # [N, 3]
        self.phase = rng.uniform(0, 2 * np.pi, size=n_waves).astype(np.float32)
        self.amp = (rng.uniform(0.3, 1.0, size=n_waves) / np.sqrt(n_waves)).astype(
            np.float32
        )

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        """pts [..., 3] -> intensity [...]."""
        phase = pts @ self.k.T + self.phase  # [..., N]
        val = np.cos(phase) @ self.amp
        return (0.5 + 0.4 * np.tanh(1.5 * val)).astype(np.float32)


def _rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def generate(
    n_frames: int = 50,
    width: int = 640,
    height: int = 480,
    cam: dict | None = None,
    seed: int = 0,
    step: float = 0.023,
    noise_sigma: float = 0.0,
    vignette: float = 0.0,
    n_textureless: int = 0,
    n_spheres: int = 1,
    motion: str = "lateral",
) -> list[SyntheticFrame]:
    """Render the sequence. World frame == first camera frame.

    Photometric-hardening knobs (all off by default — the defaults keep the
    ideal brightness-constant scene used by the kernel parity tests):

      noise_sigma    per-frame additive Gaussian intensity noise (e.g. 0.01
                     ~ 2.5 gray levels of an 8-bit camera)
      vignette       radial intensity falloff strength in [0, ~0.4]; breaks
                     brightness constancy across views like a real lens
      n_textureless  number of flat-intensity discs painted on the table
                     surface (NCC is undefined there — seeds must NOT
                     converge on them)
      n_spheres      1 or 2 floating occluders (2 adds occlusion structure
                     on the far side of the scene)
    """
    cam = dict(DEFAULT_CAM if cam is None else cam)
    rng = np.random.default_rng(seed)
    tex = _Texture(rng)

    # Scene geometry, in world coords (z forward from the first camera):
    # a tilted plane ~1.6 m ahead and a sphere resting in front of it.
    plane_n = np.array([0.05, -0.12, -1.0], np.float32)
    plane_n /= np.linalg.norm(plane_n)
    plane_p = np.array([0.0, 0.0, 1.7], np.float32)
    sph_c = np.array([0.25, 0.12, 1.25], np.float32)
    sph_r = 0.22
    sph2_c = np.array([-0.32, -0.16, 1.42], np.float32)
    sph2_r = 0.15

    # flat-intensity discs on the table (textureless regions): fixed 3-D
    # centers on the plane so the same surface patch is textureless in
    # every view (as a real blank sheet of paper would be)
    patch_centers = []
    patch_vals = []
    for k in range(n_textureless):
        off = np.array(
            [0.55 * np.cos(2.3 * k + 0.7), 0.4 * np.sin(1.9 * k + 0.3), 0.0],
            np.float32,
        )
        c = plane_p + off
        # project onto the plane
        c = c - float((c - plane_p) @ plane_n) * plane_n
        patch_centers.append(c)
        patch_vals.append(0.35 + 0.12 * k)
    patch_r = 0.13

    # Pixel ray directions in camera frame (unnormalized then normalized)
    v, u = np.meshgrid(
        np.arange(height, dtype=np.float32),
        np.arange(width, dtype=np.float32),
        indexing="ij",
    )
    dirs_cam = np.stack(
        [
            (u - cam["cx"]) / cam["fx"],
            (v - cam["cy"]) / cam["fy"],
            np.ones_like(u),
        ],
        axis=-1,
    )
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)

    frames: list[SyntheticFrame] = []
    for i in range(n_frames):
        if motion == "forward":
            # Dominantly axial dolly (epipole inside the image): the
            # degenerate regime for stereo rectification, handled by the
            # matcher's planesweep fallback
            t_wc = np.array(
                [0.08 * step * np.sin(i * 0.13), 0.06 * step * np.sin(i * 0.1),
                 step * i],
                np.float32,
            )
        elif motion == "tumble":
            # Diagonal translation under strong mixed rotation (~9 deg
            # amplitude incl. roll): stresses the rectification fit and the
            # warp resamplers' wide-tap-window variants
            t_wc = np.array(
                [0.7 * step * i, 0.5 * step * np.sin(i * 0.23),
                 0.3 * step * np.sin(i * 0.17)],
                np.float32,
            )
        else:
            # Lateral dolly with gentle sinusoidal look-around
            t_wc = np.array(
                [step * i, 0.25 * step * np.sin(i * 0.11),
                 0.1 * step * np.sin(i * 0.07)],
                np.float32,
            )
        if motion == "tumble":
            R_wc = _rot_xyz(
                0.15 * np.sin(i * 0.31), 0.12 * np.sin(i * 0.27),
                0.15 * np.sin(i * 0.21),
            )
        else:
            R_wc = _rot_xyz(
                0.02 * np.sin(i * 0.05), -0.03 * np.sin(i * 0.04),
                0.01 * np.sin(i * 0.09),
            )
        T_world_curr = np.concatenate([R_wc, t_wc[:, None]], axis=1)

        d_world = dirs_cam @ R_wc.T  # rays in world frame
        o = t_wc

        # plane intersection
        denom = d_world @ plane_n
        t_plane = ((plane_p - o) @ plane_n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t_plane = np.where(t_plane > 0, t_plane, np.inf)

        # sphere intersection(s)
        def sphere_t(c, r):
            oc = o - c
            bq = d_world @ oc
            cq = oc @ oc - r * r
            disc = bq * bq - cq
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = np.where(disc > 0, -bq - sq, np.inf)
            return np.where(t > 0, t, np.inf)

        t_sph = sphere_t(sph_c, sph_r)
        if n_spheres >= 2:
            t_sph = np.minimum(t_sph, sphere_t(sph2_c, sph2_r))

        t_hit = np.minimum(t_plane, t_sph)
        pts = o + d_world * t_hit[..., None]
        img = tex(pts)

        # textureless discs (painted on the table surface, view-consistent)
        for c, val in zip(patch_centers, patch_vals):
            on_plane = t_plane <= t_sph
            inside = (np.linalg.norm(pts - c, axis=-1) < patch_r) & on_plane
            img = np.where(inside, np.float32(val), img)

        # photometric hardening: vignetting then sensor noise
        if vignette > 0.0:
            ru2 = ((u - cam["cx"]) ** 2 + (v - cam["cy"]) ** 2) / (
                cam["cx"] ** 2 + cam["cy"] ** 2
            )
            img = img * (1.0 - vignette * ru2) ** 2
        if noise_sigma > 0.0:
            img = img + rng.normal(0.0, noise_sigma, size=img.shape)
        img = np.clip(img, 0.0, 1.0).astype(np.float32)

        frames.append(
            SyntheticFrame(
                image=img.astype(np.float32),
                depth=t_hit.astype(np.float32),
                T_world_curr=T_world_curr.astype(np.float32),
            )
        )
    return frames

