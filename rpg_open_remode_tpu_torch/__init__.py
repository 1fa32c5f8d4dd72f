"""PyTorch/CUDA port of rpg_open_remode_tpu: probabilistic monocular dense
reconstruction on an NVIDIA H100.

The engine: per-pixel recursive Bayesian depth seeds over a
reference keyframe, updated per frame by a rectified NCC disparity sweep,
then a weighted TV-L1 denoise. Plain tensor code is PyTorch; the sweep, the
two scanline resampling passes and the TV-L1 iteration are CUDA kernels
(``csrc/``) built with ``nvcc`` at first use. On CPU tensors every kernel
wrapper runs its plain PyTorch version instead.

The package imports neither JAX nor the JAX package ``rpg_open_remode_tpu``;
its tests hold each module against the JAX counterpart.
"""

import torch as _torch

# Geometry precision: TF32 keeps ~3 decimal digits, far below what sub-pixel
# matching needs (counterpart of the JAX package's
# jax_default_matmul_precision="highest").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig  # noqa: E402
from rpg_open_remode_tpu_torch.models.state import (  # noqa: E402
    SceneParams,
    SeedState,
    state_from_numpy,
    state_to_numpy,
    states_from_numpy,
)
from rpg_open_remode_tpu_torch.models.depthmap import Depthmap  # noqa: E402
from rpg_open_remode_tpu_torch.models.multikeyframe import (  # noqa: E402
    BatchedDepthmap,
    MultiKeyframeNode,
)

__version__ = "0.1.0"

__all__ = [
    "RemodeConfig",
    "ConvergenceState",
    "SeedState",
    "SceneParams",
    "Depthmap",
    "BatchedDepthmap",
    "MultiKeyframeNode",
    "state_from_numpy",
    "state_to_numpy",
    "states_from_numpy",
    "__version__",
]
