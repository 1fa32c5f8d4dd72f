"""Numpy-seeded inputs that hold the disparity sweep to its semantics.

``ragged_bands`` gives main-path-sized inputs whose per-pixel bands are
ragged as a real frame's are (most 4-12 planes, ~3 % 60-120), the case
that balances work across lanes. ``edge_cases`` gives a small grid of
hand-built row groups, one per rule of ``disparity_sweep_plain``: equal
NCC at two planes, a best at a band's first or last plane, a masked
neighbour of the best, bands at plane 0 and at K - 1, bands that admit no
plane, +-inf and NaN bounds, and footprint limits (``xlim``) that cut a
band. Both return ``(curr_pad, xlim, ref, valid, disp_lo, disp_hi)`` as
float32 numpy arrays, the argument order of ``disparity_sweep``.
"""

from __future__ import annotations

import numpy as np

GROUP_ROWS = 24   # rows of one edge-case group: at the largest patch, 17, its
                  # rows whose patches stay inside it number 24 - 2 * 8 = 8
EDGE_GROUPS = (
    "tie", "best_first", "best_last", "masked_right", "plane_0_and_last",
    "no_plane", "inf_nan", "xlim_cut", "random",
)
TIE_PERIOD = 32   # the tie group's current image repeats every 32 columns
D_TRUE = 20       # true disparity of the structured groups


def ragged_bands(rng: np.random.Generator, h: int, w: int, pad: int, planes: int):
    """Random texture with a true disparity of ``planes // 3`` on half the
    signal, bands centred on it or anywhere, 4-12 planes wide (~3 % 60-120),
    one row in 16 empty, per-row footprint limits that cut the left and right
    ends of some bands."""
    d = planes // 3
    curr = rng.random((h, w + 2 * pad), dtype=np.float32)
    ref = 0.5 * rng.random((h, w), dtype=np.float32) + 0.5 * curr[:, pad - d: pad - d + w]
    valid = np.ones((h, w), np.float32)
    valid[:, :16] = 0.0
    xmin = rng.uniform(-pad, 12.0, (h, 1)).astype(np.float32)
    xmax = rng.uniform(w - 12.0, w + pad, (h, 1)).astype(np.float32)
    xlim = np.concatenate([xmin, xmax], axis=1)
    width = np.where(rng.random((h, w)) < 0.03, rng.uniform(60, 120, (h, w)),
                     rng.uniform(4, 12, (h, w)))
    centre = np.where(rng.random((h, w)) < 0.5, d + rng.uniform(-3, 3, (h, w)),
                      rng.uniform(0, planes, (h, w)))
    lo = (centre - 0.5 * width).astype(np.float32)
    hi = (centre + 0.5 * width).astype(np.float32)
    lo[::16], hi[::16] = np.inf, -np.inf
    return curr, xlim, ref.astype(np.float32), valid, lo, hi


def edge_group_rows(name: str) -> slice:
    g = EDGE_GROUPS.index(name)
    return slice(g * GROUP_ROWS, (g + 1) * GROUP_ROWS)


def edge_interior_rows(name: str, patch_side: int) -> slice:
    """The rows of a group whose patches stay inside the group."""
    rows = edge_group_rows(name)
    hp = patch_side // 2
    return slice(rows.start + hp, rows.stop - hp)


def edge_cases(patch_side: int, w: int = 256, pad: int = 128, planes: int = 127,
               seed: int = 0):
    """The edge-case grid: ``len(EDGE_GROUPS)`` groups of ``GROUP_ROWS``
    rows. Structured groups copy the current image into the reference at a
    true disparity, so the NCC peaks at 1 there."""
    rng = np.random.default_rng(seed)
    hp = patch_side // 2
    h = GROUP_ROWS * len(EDGE_GROUPS)
    wc = w + 2 * pad
    curr = rng.random((h, wc), dtype=np.float32)
    d_true = np.full((h, w), D_TRUE, np.int64)
    xlim = np.tile(np.array([[-float(pad), w + float(pad)]], np.float32), (h, 1))
    valid = np.ones((h, w), np.float32)
    lo = np.full((h, w), D_TRUE - 8.0, np.float32)
    hi = np.full((h, w), D_TRUE + 8.0, np.float32)
    x = np.arange(w)

    # two planes with equal NCC: the current rows repeat every TIE_PERIOD
    # columns, so planes D_TRUE and D_TRUE + TIE_PERIOD read identical patches
    r = edge_group_rows("tie")
    base = rng.random((GROUP_ROWS, TIE_PERIOD), dtype=np.float32)
    curr[r] = np.tile(base, (1, wc // TIE_PERIOD + 1))[:, :wc]
    lo[r], hi[r] = D_TRUE - 10.0, D_TRUE + TIE_PERIOD + 8.0

    # the best at the band's first plane / at its last plane
    r = edge_group_rows("best_first")
    lo[r], hi[r] = float(D_TRUE), D_TRUE + 8.0
    r = edge_group_rows("best_last")
    lo[r], hi[r] = D_TRUE - 8.0, float(D_TRUE)

    # the best's right neighbour masked: by a textureless current patch
    # (constant stripes 2 hp + 1 wide) in the top half, by the footprint
    # limit in the bottom half (plane D_TRUE + 1 fails x - k >= xmin at
    # x = 100, and the cut moves through the band along the row)
    r = edge_group_rows("masked_right")
    for c0 in range(pad + 8, pad + w - 16, 24):
        curr[r, c0: c0 + 2 * hp + 1] = 0.5
    lo[r], hi[r] = D_TRUE - 10.0, D_TRUE + 10.0
    half = slice(r.start + GROUP_ROWS // 2, r.stop)
    xlim[half, 0] = 100.0 - D_TRUE - 0.5

    # bands at plane 0 (true disparity 1) and at plane K - 1 (true K - 1)
    r = edge_group_rows("plane_0_and_last")
    left = x < w // 2
    d_true[r] = np.where(left, 1, planes - 1)
    lo[r] = np.where(left, -3.0, planes - 3.0)
    hi[r] = np.where(left, 2.0, planes + 5.0)

    # no plane admitted: bands beyond the plane cap, footprint limits that
    # admit no plane, an invalid reference
    r = edge_group_rows("no_plane")
    third = w // 3
    lo[r, :third], hi[r, :third] = planes + 10.0, planes + 20.0
    xlim[r.start: r.start + GROUP_ROWS // 2, 0] = w + 10.0
    valid[r, 2 * third:] = 0.0

    # infinite and NaN bounds, one kind per column block
    r = edge_group_rows("inf_nan")
    kinds = [(np.inf, -np.inf), (-np.inf, np.inf), (np.nan, D_TRUE + 8.0),
             (D_TRUE - 8.0, np.nan), (-np.inf, -np.inf), (np.inf, np.inf),
             (np.nan, np.nan), (D_TRUE - 8.0, D_TRUE + 8.0)]
    block = w // len(kinds)
    for i, (a, b) in enumerate(kinds):
        lo[r, i * block:(i + 1) * block] = a
        hi[r, i * block:(i + 1) * block] = b

    # footprint limits that fall inside the bands: k <= x - 60 cuts the top
    # of the band for x in [70, 100], k >= x - 200 cuts its bottom for x in
    # [210, 240]
    r = edge_group_rows("xlim_cut")
    xlim[r] = np.array([60.0, 200.0], np.float32)
    lo[r], hi[r] = 10.0, 40.0
    d_true[r] = 25

    # random bands over random texture (no true disparity)
    r = edge_group_rows("random")
    c = rng.uniform(0, planes, (GROUP_ROWS, w))
    wd = rng.uniform(1, 40, (GROUP_ROWS, w))
    lo[r], hi[r] = c - 0.5 * wd, c + 0.5 * wd

    ref = np.take_along_axis(curr, x[None, :] + pad - d_true, axis=1)
    r = edge_group_rows("random")
    ref[r] = rng.random((GROUP_ROWS, w), dtype=np.float32)
    return (curr, xlim, ref.astype(np.float32), valid, lo.astype(np.float32),
            hi.astype(np.float32))
