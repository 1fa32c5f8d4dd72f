"""The keyframe lifecycle on a mesh (counterpart of
``rpg_open_remode_tpu/parallel/node.py``): a ring of concurrent keyframes
whose slots are spread over the ``kf`` axis and tiled over ``(ty, tx)``,
driven through the reference's lifecycle (the converged% / distance switch
policy, depthmap_node.cpp:142-157; staggered reseeds; TV-L1 at
finalization; export on a worker thread).

Every rank runs this loop on the same frames, and every decision comes from
values that are equal on every rank: the step's ``[KF, 6]`` metrics matrix
is summed over the whole world, and the policy reads it every
``policy_stride`` frames, a stride late (copied to pinned memory behind an
event at dispatch, ``models/node._fetch``), so WHICH values it sees depends
only on frame counts. So every rank issues the same collectives in the same
order.

Every step, reseed and TV-L1 is a replay of the mesh's compiled programs
(``parallel/programs.ShardedPrograms``), which hold the local slots in
fixed buffers: a reseed overwrites its slot. Finalizing slots, on the
loop's thread and as JAX ``_finalize_slots`` does it, nothing waits: the
kf row's ranks copy the slots into their snapshots, every rank reseeds
them in slot order, then the kf row's ranks replay the denoise program on
the snapshots (the sharded TV-L1 and the gather of each slot's tiles and
denoised tiles to the row's spatial leader), all in stream order, so the
next frame's regime read waits for the reseeds only. Under NCCL each of
these is one graph replay; under gloo the host runs the programs'
exchanges. The leader starts a copy of each gathered keyframe to host
memory behind an event; only its worker thread waits on that event, then
assembles the ``KeyframeResult`` (host tensors: the gathered fields, the
snapshot's keyframe pose and scene) and calls ``on_keyframe``. Keyframes
are numbered per host in the order the policy finalizes them
(``KeyframeResult.index``), which every rank knows.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.node import KeyframeResult, LifecycleNode, _fetch
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.parallel.programs import GATHERED, ShardedPrograms
from rpg_open_remode_tpu_torch.parallel.sharded import SHARDED_PACKED_KEYS
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


class ShardedDepthmapNode(LifecycleNode):
    """Keyframe-ring mapping loop over a ``(kf, ty, tx)`` mesh; every rank
    of the mesh runs one, on the same frames.

    ``n_keyframes`` defaults to the kf axis size (one slot per kf row); any
    multiple works. ``on_keyframe(result)`` fires on the worker thread of
    the finalized slot's spatial leader, which also keeps the result in
    ``keyframes``."""

    def __init__(self, mesh, width: int, height: int, fx: float, cx: float, fy: float,
                 cy: float, n_keyframes: int | None = None, cfg: RemodeConfig | None = None,
                 on_keyframe=None, policy_stride: int = 6, stagger: int = 10):
        super().__init__()
        self.mesh = mesh
        self.cfg = cfg or RemodeConfig.for_camera(fx)
        self.cam = PinholeCamera.create(fx, fy, cx, cy, device=mesh.device)
        self.width, self.height = width, height
        kf_axis = mesh.axis_size("kf")
        self.n = n_keyframes or kf_axis
        if self.n % kf_axis:
            raise ValueError(f"n_keyframes={self.n} must be a multiple of the kf mesh axis "
                             f"({kf_axis})")
        self.n_local = self.n // kf_axis
        self.on_keyframe = on_keyframe
        self.policy_stride = max(int(policy_stride), 1)
        self.stagger = max(int(stagger), 1)

        self.programs = ShardedPrograms(mesh, height, width, self.cam, (fx, fy), self.cfg,
                                        self.n)
        self._f_ref = (self.cam.bearing_grid(height, width).cpu() if self.programs.leader
                       else None)

        self.num_msgs = 0
        self._n_updates = [0] * self.n
        self._generation = [0] * self.n
        self._forced_reseed_done = [False] * self.n
        self._exports_by_host = [0] * mesh.hosts
        self.switches: list[tuple[int, int]] = []   # (frame, slot) of every finalization
        # _pending_stats: (frame_no, generations, update counts, host tensor, event)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _local(self, slot: int) -> int | None:
        """The local index of global slot ``slot`` on this rank, or None."""
        i = slot - self.mesh.axis_index("kf") * self.n_local
        return i if 0 <= i < self.n_local else None

    # -- frame ingestion -----------------------------------------------------

    def process_frame(self, image, T_curr_world, min_depth, max_depth) -> dict:
        """Feed one frame with its scene depth bounds. Returns the newest
        per-slot metrics the lagged stats make known without a wait."""
        T_host = self.programs.load_frame(image, T_curr_world)
        self._bounds = (float(min_depth), float(max_depth))
        if self.num_msgs == 0:
            # the first frame fills the ring; the stagger below diversifies it
            for slot in range(self.n):
                self._reseed_program(slot)
            self.num_msgs = 1
            return {"event": "reference_set"}

        self.num_msgs += 1
        self.programs.step(T_host)
        n = self.num_msgs - 1
        # the static packed output, copied right after the replay that wrote it
        fetched = _fetch(self.programs.packed) if n % self.policy_stride == 0 else None
        for s in range(self.n):
            self._n_updates[s] += 1
        # snapshot before any reseed below: the stats belong to the
        # generations the slots had when the step ran
        gens_at_dispatch = tuple(self._generation)
        n_upds_at_dispatch = tuple(self._n_updates)

        if n % self.stagger == 0:
            slot = n // self.stagger
            if 0 < slot < self.n and not self._forced_reseed_done[slot]:
                self._reseed_slot(slot)
                self._forced_reseed_done[slot] = True

        out = {"event": "updated"}
        if fetched is not None:
            self._pending_stats.append(
                (self.num_msgs, gens_at_dispatch, n_upds_at_dispatch, *fetched))
            while len(self._pending_stats) > 1:
                out = self._resolve_oldest()
        return out

    def _resolve_oldest(self) -> dict:
        frame_no, gens, n_upds, host, event = self._pending_stats.popleft()
        if event is not None:
            event.synchronize()
        npx = self.width * self.height
        out = {"event": "updated", "frame": frame_no, "slots": []}
        finalizing = []
        for slot, row in enumerate(host.tolist()):
            vals = dict(zip(SHARDED_PACKED_KEYS, row))
            conv_pct = vals["converged"] / npx * 100.0
            vals["converged_percentage"] = conv_pct
            out["slots"].append(vals)
            if gens[slot] != self._generation[slot]:
                continue   # stats predate this slot's reseed
            if (conv_pct > self.cfg.ref_compl_perc
                    or vals["dist_from_ref"] > self.cfg.max_dist_from_ref):
                finalizing.append(slot)
                out["event"] = "keyframe_complete"
        if finalizing:
            self._finalize_slots(finalizing, n_upds, frame_no)
        return out

    # -- slot lifecycle --------------------------------------------------------

    def _finalize_slots(self, slots, n_upds, frame_no: int) -> None:
        # the finalizing slots are copied before any of them is reseeded,
        # and denoised from the copies after the reseeds (the stream orders
        # them so)
        mine = [s for s in slots if self._local(s) is not None]
        self.programs.snapshot([self._local(s) for s in mine])
        indices = {}
        for slot in slots:
            host = self.mesh.host_of((slot // self.n_local) * self.mesh.axis_size("sp"))
            indices[slot] = self._exports_by_host[host]
            self._exports_by_host[host] += 1
            self.switches.append((frame_no, slot))
            self._reseed_slot(slot)
        if not mine:
            return
        self.programs.denoise([self._local(s) for s in mine], self.cfg.denoise_lambda)
        if self.programs.leader:
            for slot in mine:
                self._submit(self._export, *self.programs.export(self._local(slot)),
                             n_upds[slot], indices[slot])

    def _reseed_program(self, slot: int) -> None:
        """The reseed of ``slot`` from the loaded frame, at the inverse of
        its pose, and the frame's bounds."""
        self.programs.load_bounds(*self._bounds)
        self.programs.reseed(slot, se3.inv(self.programs.inputs.pose))

    def _reseed_slot(self, slot: int) -> None:
        self._reseed_program(slot)
        self._generation[slot] += 1
        self._n_updates[slot] = 0

    def _export(self, host: torch.Tensor, event, n_updates: int, index: int) -> None:
        """On the leader's worker thread: once ``event`` has passed, the
        gathered keyframe (``ShardedPrograms.export``'s host copy) as a
        ``KeyframeResult`` on the host, kept and handed over."""
        if event is not None:
            event.synchronize()
        full, T_world_ref, scene = self.programs.unpack(host)
        leaves = dict(zip(GATHERED, full))
        leaves["conv"] = leaves["conv"].to(torch.int32)
        state = SeedState(f_ref=self._f_ref, T_world_ref=T_world_ref, scene=scene, **leaves)
        # exact converged% at snapshot time (the policy's lags a stride)
        exact_pct = 100.0 * float((state.conv == int(ConvergenceState.CONVERGED)).float().mean())
        result = KeyframeResult(state=state, denoised_depth=full[len(GATHERED)].numpy(),
                                converged_percentage=exact_pct, n_updates=n_updates, index=index)
        self.keyframes.append(result)
        if self.on_keyframe is not None:
            self.on_keyframe(result)
