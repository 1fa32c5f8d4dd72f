"""Concurrent-keyframe ring (counterpart of
``rpg_open_remode_tpu/models/multikeyframe.py``): several keyframes that
each absorb every incoming frame, and the staggered lifecycle loop that
drives them (``remode run --keyframes N``).

``BatchedDepthmap`` holds each slot in the buffers of its own
``models/programs.Programs`` and runs ``models/depthmap.update_step`` once
per slot per frame, unchanged (the JAX ring's ``lax.scan`` body): on the
card each slot's update and reseed is one CUDA graph replay, with the
slot's own buffers (a graph's addresses are fixed), graph pool and
host-side regime, so each slot evolves bit for bit as a single
``Depthmap`` fed alike. What the slots share is the frame's upload: one
staged copy into the inputs all their programs read. What the worker
holds is never written in place: ``keyframe_state`` is a copy made when it
is read, which ``MultiKeyframeNode`` hands to its worker thread to
finalize while the loop reseeds the slot.

The ring keeps the full regime dispatch of ``ops/rect_match.match``
(pure-rotation and plane-sweep fallbacks), as the JAX ring does.
"""

from __future__ import annotations

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models import programs
from rpg_open_remode_tpu_torch.models.depthmap import PACKED_STATS_KEYS, resolve_device
from rpg_open_remode_tpu_torch.models.node import LifecycleNode, _fetch
from rpg_open_remode_tpu_torch.models.state import SeedState, stack_states
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


class BatchedDepthmap:
    """Ring of ``n_keyframes`` concurrently updating keyframes on ``device``
    (``None`` means CUDA and raises without it; ``"cpu"`` runs the kernels'
    plain versions)."""

    def __init__(self, n_keyframes: int, width: int, height: int, fx: float, cx: float,
                 fy: float, cy: float, cfg: RemodeConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or RemodeConfig.for_camera(fx)
        self.cam = PinholeCamera.create(fx, fy, cx, cy, device=self.device)
        self.n = n_keyframes
        self.height, self.width = height, width
        inputs = programs.Inputs(height, width, self.device)
        self.programs = [
            programs.Programs(height, width, self.cam, (fx, fy), self.cfg, self.device, inputs)
            for _ in range(n_keyframes)
        ]
        self.inputs = inputs
        self._active = [False] * n_keyframes

    def seed_keyframe(self, slot: int, img, T_curr_world, min_depth, max_depth) -> None:
        """New keyframe in ``slot``: warm-started from the slot's own
        outgoing posterior with ``cfg.propagate_depth`` once the slot is
        active, else flat."""
        propagated = self.cfg.propagate_depth and self._active[slot]
        self.programs[slot].set_reference(img, T_curr_world, min_depth, max_depth, propagated)
        self._active[slot] = True

    def restore(self, slot: int, state: SeedState) -> None:
        """Adopt a keyframe state in ``slot`` (e.g. one carried across with
        ``states_from_numpy``): copied into the slot's buffers."""
        if state.shape != (self.height, self.width):
            raise ValueError(f"state shape {state.shape} != {(self.height, self.width)}")
        self.programs[slot].load(state)
        self._active[slot] = True

    def update(self, img, T_curr_world) -> dict:
        """Fuse one frame into every slot. Returns the stats with each key
        a float32 ``[B]`` view of ``packed`` ``[B, 7]`` (``PACKED_STATS_KEYS``
        order), on the device."""
        dtype = self.inputs.load_image(img)
        T_host = self.inputs.load_pose(T_curr_world)
        for prog in self.programs:
            prog.step(dtype, T_host)
        return programs.stats_of(torch.stack([prog.packed for prog in self.programs]))

    def converged_fraction(self) -> np.ndarray:
        conv = self.states.conv.cpu().numpy()
        return (conv == int(ConvergenceState.CONVERGED)).mean(axis=(1, 2))

    def keyframe_state(self, slot: int) -> SeedState:
        """A device copy of the slot's state, made at this read."""
        return self.programs[slot].snapshot()

    @property
    def slots(self) -> list[SeedState]:
        """A device copy of every slot's state, made at this read."""
        return [prog.snapshot() for prog in self.programs]

    @property
    def states(self) -> SeedState:
        """The slots stacked ``[B, ...]`` (a copy, for inspection)."""
        return stack_states([prog.state for prog in self.programs])


class MultiKeyframeNode(LifecycleNode):
    """Staggered keyframe-ring mapping loop, the multi-keyframe sibling of
    ``models.node.DepthmapNode``.

    The first frame seeds every slot; slot ``i`` is force-reseeded on frame
    ``i * stagger`` so that the slots' completions spread out. Each slot
    runs the reference's switch policy on its own (converged % above
    ``ref_compl_perc`` or a camera distance above ``max_dist_from_ref``,
    depthmap_node.cpp:148): the ``[B, 7]`` stats of every ``policy_stride``-th
    frame are copied to pinned memory at dispatch and read a stride later
    (``models.node._fetch``). A finished slot's frozen state is denoised and
    handed to ``on_keyframe`` on the worker thread, on the loop's stream,
    while the loop reseeds the slot from the newest frame."""

    def __init__(self, engine: BatchedDepthmap, cfg: RemodeConfig | None = None,
                 on_keyframe=None, policy_stride: int = 6, stagger: int = 10):
        super().__init__()
        self.engine = engine
        self.cfg = cfg or engine.cfg
        self.on_keyframe = on_keyframe
        self.policy_stride = max(int(policy_stride), 1)
        self.stagger = max(int(stagger), 1)
        B = engine.n
        self.num_msgs = 0
        self._n_updates = [0] * B
        self._generation = [0] * B
        self._forced_reseed_done = [False] * B
        # _pending_stats: (frame_no, generations, update counts, host tensor, event)

    def process_frame(self, image, T_curr_world, min_depth, max_depth) -> dict:
        """Feed one frame with its scene depth bounds. Returns the newest
        per-slot metrics the lagged stats make known without a wait."""
        eng = self.engine
        self._bounds = (float(min_depth), float(max_depth))
        if self.num_msgs == 0:
            # the first frame fills the ring; the stagger below diversifies it
            for slot in range(eng.n):
                eng.seed_keyframe(slot, image, T_curr_world, *self._bounds)
            self.num_msgs = 1
            return {"event": "reference_set"}

        self.num_msgs += 1
        self._last_frame = (image, T_curr_world)
        stats = eng.update(image, T_curr_world)
        for s in range(eng.n):
            self._n_updates[s] += 1
        # snapshot before any reseed below: the stats belong to the
        # generations the slots had when the update ran
        gens_at_dispatch = tuple(self._generation)
        n_upds_at_dispatch = tuple(self._n_updates)

        n = self.num_msgs - 1
        if n % self.stagger == 0:
            slot = n // self.stagger
            if 0 < slot < eng.n and not self._forced_reseed_done[slot]:
                self._reseed(slot, finalize=False)
                self._forced_reseed_done[slot] = True

        out = {"event": "updated"}
        if n % self.policy_stride == 0:
            host, event = _fetch(stats["packed"])
            self._pending_stats.append(
                (self.num_msgs, gens_at_dispatch, n_upds_at_dispatch, host, event))
            while len(self._pending_stats) > 1:
                out = self._resolve_oldest()
        return out

    def _resolve_oldest(self) -> dict:
        frame_no, gens, n_upds, host, event = self._pending_stats.popleft()
        if event is not None:
            event.synchronize()
        eng = self.engine
        npx = eng.width * eng.height
        out = {"event": "updated", "frame": frame_no, "slots": []}
        for slot, row in enumerate(host.tolist()):
            vals = dict(zip(PACKED_STATS_KEYS, row))
            conv_pct = vals["converged"] / npx * 100.0
            vals["converged_percentage"] = conv_pct
            out["slots"].append(vals)
            # stats dispatched before this slot's last reseed never switch it
            if gens[slot] != self._generation[slot]:
                continue
            if (conv_pct > self.cfg.ref_compl_perc
                    or vals["dist_from_ref"] > self.cfg.max_dist_from_ref):
                self._reseed(slot, finalize=True, conv_pct=conv_pct, n_updates=n_upds[slot])
                out["event"] = "keyframe_complete"
        return out

    def _reseed(self, slot: int, finalize: bool, conv_pct: float = 0.0,
                n_updates: int = 0) -> None:
        eng = self.engine
        if finalize:
            self._submit(self._complete_keyframe, eng.keyframe_state(slot), conv_pct, n_updates)
        img, T = self._last_frame
        eng.seed_keyframe(slot, img, T, *self._bounds)
        self._generation[slot] += 1
        self._n_updates[slot] = 0
