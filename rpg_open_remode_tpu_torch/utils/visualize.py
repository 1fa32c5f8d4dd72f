"""Visual diagnostics, numpy only (the port's own copy of
``rpg_open_remode_tpu/utils/visualize.py``): the reference's epipolar
inspector and a depth colorizer.

The reference ships an interactive epipolar-geometry debugger: click a
pixel in the reference image and it draws the projected point and the
fundamental-matrix epipolar line in the current image
(test/epipolar_test.cpp:90-136, host-side Eigen math at :54-84). Here the
same diagnostic is an image export: pick pixels, get the annotated pair back
as an RGB array. The depth colorizer applies a matplotlib-free color ramp to
the min-max normalized depth (``Depthmap.scale_mat``, depthmap.cpp:158-169).
"""

from __future__ import annotations

import numpy as np


def fundamental_matrix(T_curr_ref: np.ndarray, K: np.ndarray) -> np.ndarray:
    """F mapping ref pixels to epipolar lines in curr pixels
    (the Eigen computation of test/epipolar_test.cpp:54-84)."""
    T = np.asarray(T_curr_ref, np.float64)
    R, t = T[:, :3], T[:, 3]
    tx = np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float64
    )
    E = tx @ R
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    return Kinv.T @ E @ Kinv


def _to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(gray * 255.0, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _draw_disc(rgb, x, y, color, r=3):
    h, w = rgb.shape[:2]
    yy, xx = np.ogrid[:h, :w]
    rgb[(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = color


def _draw_line(rgb, line, color):
    """Draw ax + by + c = 0 clipped to the image."""
    h, w = rgb.shape[:2]
    a, b, c = line
    if abs(b) > abs(a):
        xs = np.arange(w)
        ys = np.round(-(a * xs + c) / b).astype(int)
        ok = (ys >= 0) & (ys < h)
        rgb[ys[ok], xs[ok]] = color
    elif abs(a) > 1e-12:
        ys = np.arange(h)
        xs = np.round(-(b * ys + c) / a).astype(int)
        ok = (xs >= 0) & (xs < w)
        rgb[ys[ok], xs[ok]] = color


def epipolar_pair(
    ref_img: np.ndarray,
    curr_img: np.ndarray,
    T_curr_ref: np.ndarray,
    cam,
    pixels,                     # [(x, y), ...] reference pixels to inspect
    depths=None,                # optional per-pixel depths to project
) -> np.ndarray:
    """Side-by-side RGB: picked pixels in ref (green) + their epipolar
    lines (red) and optional depth-projected points (blue) in curr."""
    K = np.array(
        [
            [float(cam.fx), 0, float(cam.cx)],
            [0, float(cam.fy), float(cam.cy)],
            [0, 0, 1],
        ]
    )
    F = fundamental_matrix(np.asarray(T_curr_ref), K)
    left = _to_rgb(np.asarray(ref_img))
    right = _to_rgb(np.asarray(curr_img))
    T = np.asarray(T_curr_ref, np.float64)
    for idx, (x, y) in enumerate(pixels):
        _draw_disc(left, x, y, [0, 255, 0])
        line = F @ np.array([x, y, 1.0])
        _draw_line(right, line, [255, 0, 0])
        if depths is not None:
            f = np.linalg.inv(K) @ np.array([x, y, 1.0])
            f = f / np.linalg.norm(f)
            p = T[:, :3] @ (f * depths[idx]) + T[:, 3]
            u = K[0, 0] * p[0] / p[2] + K[0, 2]
            v = K[1, 1] * p[1] / p[2] + K[1, 2]
            if 0 <= u < right.shape[1] and 0 <= v < right.shape[0]:
                _draw_disc(right, int(u), int(v), [0, 128, 255])
    return np.concatenate([left, right], axis=1)


_TURBO_ANCHORS = np.array(
    [
        [48, 18, 59], [70, 107, 227], [40, 178, 251], [27, 229, 181],
        [124, 252, 79], [223, 220, 56], [253, 149, 39], [239, 62, 20],
        [122, 4, 3],
    ],
    np.float32,
)


def colorize_depth(depth: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Min-max normalized depth -> RGB via a turbo-like ramp; masked
    pixels are black (the displayable analog of scaleMat + a colormap)."""
    d = np.asarray(depth, np.float32)
    valid = np.isfinite(d) if mask is None else (mask & np.isfinite(d))
    if valid.any():
        lo, hi = d[valid].min(), d[valid].max()
        t = np.clip((d - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    else:
        t = np.zeros_like(d)
    pos = t * (len(_TURBO_ANCHORS) - 1)
    i0 = np.clip(pos.astype(int), 0, len(_TURBO_ANCHORS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _TURBO_ANCHORS[i0] * (1 - frac) + _TURBO_ANCHORS[i0 + 1] * frac
    rgb = rgb.astype(np.uint8)
    rgb[~valid] = 0
    return rgb
