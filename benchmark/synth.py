"""The benchmark's frame bank: a PyTorch rewrite of
rpg_open_remode_tpu_torch/utils/synthetic.py's renderer, run on the device.

The scene stands in for REMODE's "traj_over_table" (ICRA 2014, Table I): a
tilted plane textured by a band-limited random Fourier field over R^3, two
floating spheres, flat-intensity discs painted on the plane, a lens
vignette and additive sensor noise. The camera follows the generator's
lateral dolly with a gentle look-around, centred on the scene, so a bank of
N frames spans positions -N/2 .. N/2 - 1. The poses are fixed by the
traffic mix and the seed draws only the texture and the noise, so every
seed gives the same poses, sizes and arrivals. Frames are rendered on the
device in float32 and handed back as uint8 host arrays, as a camera
delivers them, with each frame's T_curr_world and the finite range of its
ground-truth depth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

N_WAVES = 48


@dataclasses.dataclass
class Bank:
    images: np.ndarray    # [N, H, W] uint8
    poses: np.ndarray     # [N, 3, 4] float32 T_curr_world
    bounds: np.ndarray    # [N, 2] float32 (min, max) ground-truth depth


def _rot_xyz(rx, ry, rz) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def trajectory(n: int, step: float, motion: str) -> np.ndarray:
    """T_world_curr [n, 3, 4] (float64) of positions i = -n/2 .. n/2 - 1:
    the "lateral" dolly, or the "forward" (axial) one that takes the
    matcher's plane-sweep fallback, so that such a cell is a data file."""
    out = []
    for i in np.arange(n) - n // 2:
        if motion == "lateral":
            t = [step * i, 0.25 * step * np.sin(i * 0.11), 0.1 * step * np.sin(i * 0.07)]
        elif motion == "forward":
            t = [0.08 * step * np.sin(i * 0.13), 0.06 * step * np.sin(i * 0.1), step * i]
        else:
            raise ValueError(f"unknown motion {motion!r}")
        R = _rot_xyz(0.02 * np.sin(i * 0.05), -0.03 * np.sin(i * 0.04), 0.01 * np.sin(i * 0.09))
        out.append(np.concatenate([R, np.asarray(t)[:, None]], axis=1))
    return np.stack(out)


def curr_world(T_world_curr: np.ndarray) -> np.ndarray:
    """The inverse rigid transforms, [n, 3, 4] float32."""
    R = T_world_curr[:, :, :3]
    t = T_world_curr[:, :, 3:]
    Rt = np.swapaxes(R, 1, 2)
    return np.concatenate([Rt, -Rt @ t], axis=2).astype(np.float32)


def render_bank(camera: dict, scene: dict, n: int, step: float, motion: str, seed: int,
                device) -> Bank:
    """``n`` frames of the hardened scene (``scene``: noise_sigma, vignette,
    n_textureless, n_spheres) for ``camera`` (width, height, fx, fy, cx,
    cy), drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev, dtype=f32)

    # texture: N_WAVES plane waves, wavelengths 2-60 cm
    freqs = 2.0 * np.pi / uniform(0.02, 0.6, (N_WAVES,))
    dirs = torch.randn((N_WAVES, 3), generator=gen, device=dev, dtype=f32)
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    k = dirs * freqs[:, None]
    phase = uniform(0.0, 2.0 * np.pi, (N_WAVES,))
    amp = uniform(0.3, 1.0, (N_WAVES,)) / np.sqrt(N_WAVES)

    def texture(pts):
        return 0.5 + 0.4 * torch.tanh(1.5 * (torch.cos(pts @ k.T + phase) @ amp))

    def vec(*v):
        return torch.tensor(v, dtype=f32, device=dev)

    plane_n = vec(0.05, -0.12, -1.0)
    plane_n = plane_n / torch.linalg.norm(plane_n)
    plane_p = vec(0.0, 0.0, 1.7)
    spheres = [(vec(0.25, 0.12, 1.25), 0.22), (vec(-0.32, -0.16, 1.42), 0.15)]
    spheres = spheres[:max(1, int(scene["n_spheres"]))]
    discs = []
    for j in range(int(scene["n_textureless"])):
        c = plane_p + vec(0.55 * np.cos(2.3 * j + 0.7), 0.4 * np.sin(1.9 * j + 0.3), 0.0)
        discs.append((c - torch.dot(c - plane_p, plane_n) * plane_n, 0.35 + 0.12 * j))
    disc_r = 0.13

    w, h = int(camera["width"]), int(camera["height"])
    cx, cy, fx, fy = (float(camera[key]) for key in ("cx", "cy", "fx", "fy"))
    v, u = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                          torch.arange(w, dtype=f32, device=dev), indexing="ij")
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    dirs_cam = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    ru2 = ((u - cx) ** 2 + (v - cy) ** 2) / (cx * cx + cy * cy)
    falloff = (1.0 - float(scene["vignette"]) * ru2) ** 2
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)

    T_wc = trajectory(n, step, motion)
    images = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    bounds = torch.empty((n, 2), dtype=f32, device=dev)
    for i in range(n):
        R = torch.tensor(T_wc[i, :, :3], dtype=f32, device=dev)
        o = torch.tensor(T_wc[i, :, 3], dtype=f32, device=dev)
        d = dirs_cam @ R.T
        denom = d @ plane_n
        denom = torch.where(torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
        t_plane = torch.dot(plane_p - o, plane_n) / denom
        t_plane = torch.where(t_plane > 0, t_plane, inf)
        t_sph = torch.full_like(t_plane, float("inf"))
        for c, r in spheres:
            oc = o - c
            bq = d @ oc
            disc = bq * bq - (torch.dot(oc, oc) - r * r)
            t = torch.where(disc > 0, -bq - torch.sqrt(torch.clamp(disc, min=0.0)), inf)
            t_sph = torch.minimum(t_sph, torch.where(t > 0, t, inf))
        t_hit = torch.minimum(t_plane, t_sph)
        pts = o + d * t_hit[..., None]
        img = texture(pts)
        on_plane = t_plane <= t_sph
        for c, val in discs:
            inside = (torch.linalg.norm(pts - c, dim=-1) < disc_r) & on_plane
            img = torch.where(inside, torch.full_like(img, val), img)
        img = img * falloff
        img = img + float(scene["noise_sigma"]) * torch.randn(img.shape, generator=gen,
                                                              device=dev, dtype=f32)
        images[i] = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
        finite = t_hit[torch.isfinite(t_hit)]
        bounds[i, 0] = finite.min()
        bounds[i, 1] = finite.max()
    return Bank(images=images.cpu().numpy(), poses=curr_world(T_wc),
                bounds=bounds.cpu().numpy())


def ping_pong(t: int, n: int) -> int:
    """Bank index of stream position ``t`` over a bank of ``n`` frames played
    there and back: 0, 1, .., n-1, n-2, .., 1, 0, 1, .."""
    if n < 2:
        return 0
    m = t % (2 * n - 2)
    return m if m < n else 2 * n - 2 - m
