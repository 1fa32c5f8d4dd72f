"""Whole-image reductions and per-frame metrics (counterpart of
``rpg_open_remode_tpu/ops/reduction.py``; the reference's
src/reduction.cu)."""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState


def image_sum(img: torch.Tensor) -> torch.Tensor:
    """ImageReducer<T>::sum (src/reduction.cu:80-131)."""
    return torch.sum(img)


def count_equal(img: torch.Tensor, value) -> torch.Tensor:
    """ImageReducer<T>::countEqual (src/reduction.cu:133-173)."""
    return torch.sum(img == value).to(torch.int32)


def convergence_stats(conv: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-frame counts of each seed state."""
    return {
        "update": count_equal(conv, int(ConvergenceState.UPDATE)),
        "converged": count_equal(conv, int(ConvergenceState.CONVERGED)),
        "border": count_equal(conv, int(ConvergenceState.BORDER)),
        "diverged": count_equal(conv, int(ConvergenceState.DIVERGED)),
        "no_match": count_equal(conv, int(ConvergenceState.NO_MATCH)),
    }
