"""Engine state, the single-keyframe engine, its lifecycle node and the
concurrent-keyframe ring."""

from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState  # noqa: F401
from rpg_open_remode_tpu_torch.models.depthmap import Depthmap  # noqa: F401
from rpg_open_remode_tpu_torch.models.node import DepthmapNode  # noqa: F401
from rpg_open_remode_tpu_torch.models.multikeyframe import (  # noqa: F401
    BatchedDepthmap, MultiKeyframeNode,
)
