"""The device mesh of the port on ``torch.distributed``, one rank per mesh
position (counterpart of ``rpg_open_remode_tpu/parallel``)."""

from rpg_open_remode_tpu_torch.models.state import stack_states
from rpg_open_remode_tpu_torch.parallel.distributed import (
    gather_kf_slot,
    initialize as initialize_distributed,
    local_block,
    local_stats,
    make_distributed_mesh,
    replicate_frame,
    shard_local_keyframes,
)
from rpg_open_remode_tpu_torch.parallel.halo import exchange_halo_1d, exchange_halo_2d
from rpg_open_remode_tpu_torch.parallel.launch import RankGroup, run_ranks
from rpg_open_remode_tpu_torch.parallel.mesh import Mesh, make_mesh
from rpg_open_remode_tpu_torch.parallel.node import ShardedDepthmapNode
from rpg_open_remode_tpu_torch.parallel.programs import ShardedPrograms
from rpg_open_remode_tpu_torch.parallel.sharded import (
    SHARDED_PACKED_KEYS,
    build_sharded_denoise,
    build_sharded_reseed,
    build_sharded_update,
    join_state_numpy,
    shard_state,
    sharded_regime,
    split_state_numpy,
)

__all__ = [
    "Mesh", "make_mesh", "exchange_halo_1d", "exchange_halo_2d", "build_sharded_update",
    "build_sharded_denoise", "build_sharded_reseed", "shard_state", "stack_states",
    "SHARDED_PACKED_KEYS", "ShardedDepthmapNode", "initialize_distributed",
    "make_distributed_mesh", "replicate_frame", "shard_local_keyframes", "local_block",
    "local_stats", "gather_kf_slot", "split_state_numpy", "join_state_numpy", "RankGroup",
    "run_ranks", "ShardedPrograms", "sharded_regime",
]
