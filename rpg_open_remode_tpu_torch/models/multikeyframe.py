"""Concurrent-keyframe ring (counterpart of
``rpg_open_remode_tpu/models/multikeyframe.py``): several keyframes that
each absorb every incoming frame, and the staggered lifecycle loop that
drives them (``remode run --keyframes N``).

``BatchedDepthmap`` holds its slots as a list of frozen ``SeedState``s and
runs ``models/depthmap.update_step`` once per slot per frame, unchanged (the
JAX ring's ``lax.scan`` body), so each slot evolves bit for bit as a single
``Depthmap`` fed alike. What the ring shares is the per-frame fixed cost:
the current frame's upload and uint8 prep happen once for all slots. A slot
is replaced, never written in place: ``MultiKeyframeNode`` hands a slot's
state to its worker thread to finalize while the loop reseeds that slot.

The ring keeps the full regime dispatch of ``ops/rect_match.match``
(pure-rotation and plane-sweep fallbacks), as the JAX ring does.
"""

from __future__ import annotations

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.depthmap import (
    PACKED_STATS_KEYS, _set_reference_propagated, prep_image, resolve_device,
    set_reference, to_device, update_step,
)
from rpg_open_remode_tpu_torch.models.node import LifecycleNode, _fetch
from rpg_open_remode_tpu_torch.models.state import (
    SceneParams, SeedState, empty_state, stack_states,
)
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
        self.slots: list[SeedState] = [empty_state(height, width, self.cam)] * n_keyframes
        self._active = [False] * n_keyframes

    def _image(self, img) -> torch.Tensor:
        return prep_image(to_device(img, self.device))

    def _pose(self, T) -> torch.Tensor:
        return to_device(T, self.device, pose=True)

    def seed_keyframe(self, slot: int, img, T_curr_world, min_depth, max_depth) -> None:
        """New keyframe in ``slot``: warm-started from the slot's own
        outgoing posterior with ``cfg.propagate_depth`` once the slot is
        active, else flat."""
        scene = SceneParams.create(min_depth, max_depth, self.cfg, device=self.device)
        img, T = self._image(img), self._pose(T_curr_world)
        if self.cfg.propagate_depth and self._active[slot]:
            self.slots[slot] = _set_reference_propagated(
                self.slots[slot], img, T, scene, self.cam, self.cfg)
        else:
            self.slots[slot] = set_reference(self.slots[slot], img, T, scene, self.cfg)
        self._active[slot] = True

    def restore(self, slot: int, state: SeedState) -> None:
        """Adopt a keyframe state in ``slot`` (e.g. one carried across with
        ``states_from_numpy``)."""
        if state.shape != (self.height, self.width):
            raise ValueError(f"state shape {state.shape} != {(self.height, self.width)}")
        self.slots[slot] = state
        self._active[slot] = True

    def update(self, img, T_curr_world) -> dict:
        """Fuse one frame into every slot. Returns the stats with each key
        shaped ``[B]`` and ``packed`` ``[B, 7]`` (``PACKED_STATS_KEYS``
        order), on the device."""
        img, T = self._image(img), self._pose(T_curr_world)
        per_slot = []
        for s in range(self.n):
            self.slots[s], stats = update_step(self.slots[s], img, T, self.cam, self.cfg)
            per_slot.append(stats)
        return {k: torch.stack([st[k] for st in per_slot]) for k in per_slot[0]}

    def converged_fraction(self) -> np.ndarray:
        conv = self.states.conv.cpu().numpy()
        return (conv == int(ConvergenceState.CONVERGED)).mean(axis=(1, 2))

    def keyframe_state(self, slot: int) -> SeedState:
        return self.slots[slot]

    @property
    def states(self) -> SeedState:
        """The slots stacked ``[B, ...]`` (a copy, for inspection)."""
        return stack_states(self.slots)


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
