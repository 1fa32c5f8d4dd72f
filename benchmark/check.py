"""What decides ``correct``: each sampled keyframe that the program
delivered, recomputed by the plain reference from the same frames, poses,
bounds and switch frames, and compared leaf by leaf; the lifecycle's
switch policy, replayed on the reference's own state over those keyframes
and over the one still open at the end; and the lifecycle's bookkeeping
(every frame fed went into the keyframe it was fed to).

The numbers, each the worst over the sampled keyframes:

  conv_mismatch_pct    % of pixels whose convergence state differs
  mu_off_pct           % of pixels whose mu is off by more than 1 % of the
                       keyframe's depth range
  denoised_off_pct     the same of the denoised depth
  mu_err               largest |mu - mu_ref| over the depth range
  denoised_err         largest |denoised - denoised_ref| over the depth range
  switches_off         replayed keyframes that the program ended on another
                       update than the switch policy does on the reference's
                       state: late, early, or never (exact: limit 0)
  frames_misfiled      frames whose keyframe's update count disagrees with
                       the stream (exact: limit 0)
  captured_in_window   programs the engine captured inside the window
                       (exact: limit 0; the warm-up must capture them all)

Each limit comes from the configuration's ``limits``.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.config import CONVERGED

COMPARED = ("conv_mismatch_pct", "mu_off_pct", "denoised_off_pct", "mu_err", "denoised_err")
OFF = 0.01   # share of the depth range past which a pixel is off


def _err(got: np.ndarray, want: np.ndarray, scale: float) -> np.ndarray:
    """|got - want| / scale per pixel; a NaN on one side only is infinitely
    off, on both sides not off."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)) / scale
    nan_got, nan_want = np.isnan(got), np.isnan(want)
    d[nan_got & nan_want] = 0.0
    d[nan_got != nan_want] = np.inf
    return d


def compare(got: dict, want: dict) -> dict:
    """The compared numbers of one keyframe: ``got`` the program's (or a
    control's) host arrays, ``want`` the reference's; each a dict with mu,
    conv, denoised and depth_range."""
    rng = want["depth_range"]
    mu = _err(got["mu"], want["mu"], rng)
    den = _err(got["denoised"], want["denoised"], rng)
    return dict(
        conv_mismatch_pct=100.0 * float(np.mean(got["conv"] != want["conv"])),
        mu_off_pct=100.0 * float(np.mean(mu > OFF)),
        denoised_off_pct=100.0 * float(np.mean(den > OFF)),
        mu_err=float(mu.max()),
        denoised_err=float(den.max()),
    )


def worst(readings: list) -> dict:
    """The largest of each number over keyframes (0 where none was read)."""
    return {k: max([r[k] for r in readings], default=0.0) for k in COMPARED}


class SwitchPolicy:
    """The lifecycle's keyframe switch (the program's ``DepthmapNode``;
    upstream depthmap_node.cpp:142-157) over one keyframe's updates: the
    stats of every ``stride``-th update are read one stride later, when the
    next strided update is fed, or at once by a flush (``drains``: the
    update counts at which the stream was flushed); the keyframe ends on
    the update at which a read finds more than ``ref_compl_perc`` % of its
    ``npx`` seeds converged or the camera more than ``max_dist`` from the
    reference. ``at`` is that update, None while the keyframe goes on.
    Called after each replayed update, it returns True to end a replay of
    ``n`` updates early, once the keyframe has ended before its last."""

    def __init__(self, stride: int, ref_compl_perc: float, max_dist: float, npx: int,
                 drains=(), n: int | None = None):
        self.stride, self.ref_compl_perc, self.max_dist = stride, ref_compl_perc, max_dist
        self.npx, self.drains, self.n = npx, set(drains), n
        self.switch = {}
        self.at = None

    def decide(self, c: int, converged: int, dist: float) -> bool:
        """Update ``c`` (from 1) with its converged count and distance;
        True once the keyframe has ended."""
        s = self.stride
        if self.at is None:
            if c % s == 0:
                self.switch[c] = (converged / self.npx * 100.0 > self.ref_compl_perc
                                  or dist > self.max_dist)
            last = c - c % s
            if ((c % s == 0 and c >= 2 * s and self.switch[c - s])
                    or (c in self.drains and last >= s and self.switch[last])):
                self.at = c
        return self.at is not None

    def __call__(self, c: int, state, dist) -> bool:
        read = c % self.stride == 0
        converged = int((state.conv == CONVERGED).sum()) if read else 0
        ended = self.decide(c, converged, float(dist) if read else 0.0)
        return ended and self.n is not None and self.at < self.n


def misfiled(refs: list, last: int, n_updates: list) -> int:
    """Frames whose delivered keyframe disagrees with the stream: keyframe k
    was set on stream position ``refs[k]`` and updated by every frame up to
    the next reference (or to ``last``); the program delivers keyframes in
    order. A keyframe missing before the last counts all its frames."""
    bad = 0
    for k, r in enumerate(refs):
        end = refs[k + 1] - 1 if k + 1 < len(refs) else last
        want = end - r
        if k < len(n_updates):
            bad += abs(n_updates[k] - want)
        elif k + 1 < len(refs):
            bad += want + 1
    bad += sum(n + 1 for n in n_updates[len(refs):])
    return bad


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is at most its limit."""
    table = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(not np.isnan(t["value"]) and t["value"] <= t["limit"] for t in table.values())
    return ok, table
