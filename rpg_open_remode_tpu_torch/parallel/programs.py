"""The mesh's compiled programs (counterpart of the three ``jax.jit``
wrappers of ``rpg_open_remode_tpu/parallel/sharded.py``: the sharded step,
:225, the sharded TV-L1, :320, and the sharded reseed, :490): each captured
once per rank as a CUDA graph and replayed after, as ``models/programs.py``
does for the single engine.

  * ``ShardedPrograms`` owns the rank's local slots' tile states in fixed
    buffers (``states``), their snapshots (``snaps``, what a finalization
    reads), the static inputs (the frame, its pose, the scene bounds and a
    keyframe pose), a static ``[KF, 6]`` packed output (``packed``, the
    step's metrics matrix), static denoised tiles (``denoised``) and, on a
    kf row's spatial leader, each local slot's gathered keyframe
    (``gathered``), with a cache of ``SegmentedProgram``s keyed by the
    step's (input dtype, regime), the reseed's (input dtype, slot) and the
    denoise's (local slots, lambda).
  * The form of a program follows the mesh's backend
    (``parallel/collectives.py``). Under NCCL (a card per rank) its
    collectives are captured with the body: each program is one graph and a
    replay one launch, as each JAX program is one ``jax.jit`` of a
    ``shard_map``. Under gloo (ranks sharing a card, or CPU ranks), which
    cannot be captured, each collective is an exchange point between graph
    segments (``collectives.Exchange``), and a replay runs the segments
    with the exchanges between them on the host. A one-rank world has no
    collective, so at (1, 1, 1) each program is one graph either way.
  * The step's regime is chosen on the host (``sharded.sharded_regime``)
    from host copies of every global slot's keyframe pose and mean depth.
    Every rank reseeds every slot alike (the node calls the reseed on every
    rank with the same frame, pose and bounds), so every reseed program,
    also on the ranks that do not hold the slot, writes the slot's row of a
    small device table (``refs``), copied to the host behind an event and
    read at the next step: every rank chooses the same regime and so runs
    the same collectives. The band's coarse gate stays on the device
    (``parallel/rect_sharded.py``).
  * A finalization copies the slots into their snapshots (``snapshot``),
    so the reseeds that follow do not wait for the TV-L1: the denoise
    program reads the snapshots, after the reseeds in stream order, and
    gathers each slot's fields and denoised depth to the spatial leader in
    the same program. The regime's host copy is recorded after the reseeds,
    so the next frame's read waits for them and not for the TV-L1.
  * Every rank must call the same programs in the same order: a program's
    first call runs its body eagerly with its real collectives (the call's
    result) before the capture. Under NCCL a graph holds the communicators
    it captured, and destroying the process group waits until every such
    graph is freed: drop the programs first (``launch`` collects them
    before it destroys the group).

The eager ``build_sharded_*`` functions of ``parallel/sharded.py`` are the
captured bodies and the oracle the replays are held against.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models.node import _fetch
from rpg_open_remode_tpu_torch.models.programs import Inputs, Program, pool_bytes
from rpg_open_remode_tpu_torch.models.state import SceneParams, clone, copy_into, empty_state
from rpg_open_remode_tpu_torch.parallel import collectives
from rpg_open_remode_tpu_torch.parallel.distributed import gather_kf_slot
from rpg_open_remode_tpu_torch.parallel.sharded import (
    SHARDED_PACKED_KEYS, build_sharded_denoise, build_sharded_reseed, build_sharded_update,
    shard_state, sharded_regime, tile_state,
)
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# the image fields a finalization gathers, in this order (then the denoised
# depth)
GATHERED = ("ref_img", "sum_templ", "const_templ_denom", "mu", "sigma_sq", "a", "b", "conv",
            "match_u", "match_v")
_SCENE = tuple(f.name for f in dataclasses.fields(SceneParams))


class SegmentedProgram(Program):
    """A ``Program`` whose body runs collectives. Under NCCL each runs inline
    and is captured with the body, so ``graph`` is one segment and a replay
    one graph launch. Under gloo each is an exchange point
    (``collectives.Exchange``) between two graph segments: the warm-up makes
    one per collective it meets, with its static buffers; the capture ends
    a segment at each, so ``graph`` is the list of segment graphs; a replay
    runs each exchange between its segments, on the host. A body with no
    collective captures as one segment. Every run must meet the warm-up's
    collectives (``signatures``) in its order, or it raises."""

    def __init__(self, body, device: torch.device, pool, label: str):
        super().__init__(body, device, pool, label)
        self.signatures: list = []    # every collective of the body, in order
        self.exchanges: list = []     # the exchange points (gloo), in order
        self._segments = None         # the graphs captured so far, while capturing
        self._met = 0                 # collectives met in this run of the body
        self._held = False            # the warm-up has run: hold later runs to it

    # -- called by parallel/collectives -------------------------------------------

    def collective(self, signature) -> int:
        """The index of the body's next collective: recorded on the first
        run, then held to its ``signature``."""
        i = self._met
        self._met += 1
        if i == len(self.signatures):
            if self._held:
                raise RuntimeError(f"{self.label}: collective {i} {signature} is one the "
                                   "warm-up did not meet")
            self.signatures.append(signature)
        if self.signatures[i] != signature:
            raise RuntimeError(f"{self.label}: collective {i} is {signature}, "
                               f"was {self.signatures[i]}")
        return i

    def exchange_point(self, signature, make):
        """The exchange point of the body's next collective: made by
        ``make()`` on the first run, then held to its ``signature``."""
        i = self.collective(signature)
        if i == len(self.exchanges):
            self.exchanges.append(make())
        return self.exchanges[i]

    def exchange_boundary(self, point) -> None:
        """While capturing: end this segment and begin the next. Otherwise:
        run the exchange."""
        if self._segments is None:
            point.run()
            return
        self._segments[-1].capture_end()
        self._begin_segment()

    def _begin_segment(self) -> None:
        graph = torch.cuda.CUDAGraph()
        self._segments.append(graph)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    # -- Program's hooks -----------------------------------------------------------

    def _through_exchanges(self) -> None:
        self._met = 0
        with collectives.exchange_points(self):
            self.body()
        if self._met != len(self.signatures):
            raise RuntimeError(f"{self.label}: {self._met} collectives, the warm-up "
                               f"met {len(self.signatures)}")
        self._held = True

    def _run(self) -> None:
        self._through_exchanges()

    def _capture(self) -> list:
        self._segments = segments = []
        try:
            self._begin_segment()
            self._through_exchanges()
        except BaseException:
            with contextlib.suppress(Exception):
                segments[-1].capture_end()
            raise
        finally:
            self._segments = None
        segments[-1].capture_end()
        return segments

    def _replay(self) -> None:
        for k, graph in enumerate(self.graph):
            graph.replay()
            if k < len(self.exchanges):
                self.exchanges[k].run()


class ShardedPrograms:
    """This rank's part of ``n_keyframes`` (default: the kf axis size)
    concurrent keyframes on ``mesh`` and the programs that advance it.
    ``cam_host`` is ``(fx, fy)`` as host numbers (the regime's camera)."""

    def __init__(self, mesh, height: int, width: int, cam: PinholeCamera, cam_host,
                 cfg: RemodeConfig, n_keyframes: int | None = None):
        self.mesh = mesh
        self.height, self.width = height, width
        self.cam = cam
        self.cam_host = tuple(np.float32(v) for v in cam_host)
        self.cfg = cfg
        kf = mesh.axis_size("kf")
        self.n = n_keyframes or kf
        if self.n % kf:
            raise ValueError(f"n_keyframes={self.n} must be a multiple of the kf mesh axis ({kf})")
        self.n_local = self.n // kf
        self.first = mesh.axis_index("kf") * self.n_local   # global index of local slot 0
        dev = self.device = mesh.device
        self.inputs = Inputs(height, width, dev)
        self.ref_pose = torch.zeros((3, 4), dtype=torch.float32, device=dev)
        self.dtype = torch.uint8   # the input dtype of the loaded frame
        empty = tile_state(empty_state(height, width, cam), mesh)
        # one buffer per leaf of every local slot
        self.states = [clone(empty) for _ in range(self.n_local)]
        self.snaps = [clone(empty) for _ in range(self.n_local)]
        _, _, th, tw = mesh.tile(height, width)
        self.packed = torch.zeros((self.n, len(SHARDED_PACKED_KEYS)), dtype=torch.float32,
                                  device=dev)
        self.denoised = torch.zeros((self.n_local, th, tw), dtype=torch.float32, device=dev)
        self.leader = mesh.axis_index("sp") == 0
        self.gathered = torch.zeros((self.n_local, len(GATHERED) + 1, height, width),
                                    dtype=torch.float32, device=dev) if self.leader else None
        # every global slot's T_world_ref (12) and scene.avg_depth (1)
        self.refs = torch.cat([empty.T_world_ref.reshape(-1),
                               empty.scene.avg_depth.reshape(1)]).repeat(self.n, 1)
        cuda = dev.type == "cuda"
        self._host_refs = torch.zeros(self.refs.shape, dtype=torch.float32, pin_memory=cuda)
        self._host_event = torch.cuda.Event() if cuda else None
        self._host = None
        self._refresh_host()
        self.cache: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self._step_fn = build_sharded_update(mesh, cam, cfg, height, width)
        self._reseed_fn = build_sharded_reseed(mesh, cam, cfg, height, width)
        self._denoise_fn = build_sharded_denoise(mesh, cfg, height, width,
                                                 iterations=cfg.denoise_iters)

    # -- the host copies of the slots' keyframe poses and mean depths ----------

    def _refresh_host(self) -> None:
        """Start the copy of ``refs`` to the host, in stream order after the
        program that wrote it (no wait here)."""
        cuda = self._host_event is not None
        self._host_refs.copy_(self.refs, non_blocking=cuda)
        if cuda:
            self._host_event.record(torch.cuda.current_stream(self.device))
        self._host = None

    def regime(self, T_host: np.ndarray):
        """``sharded_regime`` of a frame at host pose ``T_host``: one
        tile-plane-sweep flag per local slot, or None."""
        if not (self.cfg.match_mode == "rect" and self.cfg.zero_baseline_fallback):
            return None
        if self._host is None:
            if self._host_event is not None:
                self._host_event.synchronize()
            self._host = self._host_refs.numpy().copy()
        slots = [(row[:12].reshape(3, 4), row[12]) for row in self._host]
        return sharded_regime(T_host, slots, self.cam_host, self.cfg, self.height, self.width,
                              self.mesh.axis_size("kf"))

    # -- the programs ------------------------------------------------------------

    def program(self, key: tuple) -> SegmentedProgram:
        """The cached program of ``key``: ("step", dtype, regime),
        ("reseed", dtype, slot) or ("denoise", slots, lam)."""
        prog = self.cache.get(key)
        if prog is None:
            body = getattr(self, "_" + key[0])(*key[1:])
            label = " ".join(str(v).replace("torch.", "") for v in key)
            prog = self.cache[key] = SegmentedProgram(body, self.device, self.pool, label)
        return prog

    def _step(self, dtype, regime):
        def body():
            new, stats = self._step_fn(self.states, self.inputs.images[dtype], self.inputs.pose,
                                       regime)
            for dst, src in zip(self.states, new):
                copy_into(dst, src)
            self.packed.copy_(stats["packed"])
        return body

    def _reseed(self, dtype, slot: int):
        local = slot - self.first

        def body():
            scene = SceneParams.from_bounds(self.inputs.bounds, self.cfg)
            self.refs[slot, :12].copy_(self.ref_pose.reshape(-1))
            self.refs[slot, 12].copy_(scene.avg_depth)
            if 0 <= local < self.n_local:
                new = self._reseed_fn(self.states, slot, self.inputs.images[dtype], self.ref_pose, scene)
                copy_into(self.states[local], new[local])
        return body

    def _denoise(self, slots: tuple, lam: float):
        def body():
            self.finalize(self.snaps, slots, lam)
        return body

    def finalize(self, snaps, slots, lam: float) -> None:
        """The sharded TV-L1 of local slots ``slots`` of ``snaps`` into
        ``denoised``, then each slot's ``GATHERED`` fields and denoised
        depth gathered into ``gathered`` on the spatial leader (the denoise
        program's body)."""
        for i, u in zip(slots, self._denoise_fn(snaps, lam, list(slots))):
            self.denoised[i].copy_(u)
            fields = [getattr(snaps[i], f).float() for f in GATHERED] + [u]
            full = gather_kf_slot(self.mesh, torch.stack(fields))
            if full is not None:
                self.gathered[i].copy_(full)

    # -- what the node calls -------------------------------------------------------

    def load_frame(self, img, T_curr_world) -> np.ndarray:
        """The frame and its pose into the static inputs; returns the pose's
        float32 host copy."""
        self.dtype = self.inputs.load_image(img)
        return self.inputs.load_pose(T_curr_world)

    def load_bounds(self, min_depth, max_depth) -> None:
        self.inputs.load_bounds(min_depth, max_depth)

    def step(self, T_host: np.ndarray) -> None:
        """One sharded step of the local slots on the loaded frame
        (``T_host`` its pose's host copy); the metrics land in ``packed``."""
        self.program(("step", self.dtype, self.regime(T_host)))()

    def update(self, img, T_curr_world) -> dict:
        """``load_frame`` and ``step``; returns ``stats()``."""
        self.step(self.load_frame(img, T_curr_world))
        return self.stats()

    def reseed(self, slot: int, T_world_ref) -> None:
        """Re-seed global slot ``slot`` from the loaded frame and bounds, at
        keyframe pose ``T_world_ref`` (an array, or a tensor on the device),
        flat or propagated as the config's ``propagate_depth`` says; every
        rank calls it alike."""
        self.inputs.upload(self.ref_pose, T_world_ref)
        self.program(("reseed", self.dtype, slot))()
        self._refresh_host()

    def snapshot(self, slots) -> None:
        """Copy local slots ``slots`` into their snapshots (``snaps``), which
        the denoise program reads; the slots may then be reseeded."""
        for i in slots:
            copy_into(self.snaps[i], self.states[i])

    def denoise(self, slots, lam: float) -> list[torch.Tensor]:
        """The sharded TV-L1 of the snapshots of local slots ``slots``, with
        each slot gathered to the spatial leader (``gathered``): views of
        ``denoised``, valid until the next denoise; every rank of the kf row
        calls it alike."""
        self.program(("denoise", tuple(slots), float(lam)))()
        return [self.denoised[i] for i in slots]

    def export(self, i: int):
        """On the spatial leader, after ``denoise``: start the copy of local
        slot ``i``'s gathered keyframe and its snapshot's keyframe pose and
        scene to host memory. Returns ``(host, event)`` (``_fetch``) for
        ``unpack``; the event None when the copy is complete."""
        snap = self.snaps[i]
        meta = torch.cat([snap.T_world_ref.reshape(-1)]
                         + [getattr(snap.scene, f).reshape(1) for f in _SCENE])
        return _fetch(torch.cat([self.gathered[i].reshape(-1), meta]))

    def unpack(self, host: torch.Tensor):
        """``export``'s host copy as ``(fields, T_world_ref, scene)``:
        ``fields`` the ``GATHERED`` fields, then the denoised depth, each
        ``[H, W]``."""
        n = (len(GATHERED) + 1) * self.height * self.width
        fields = host[:n].reshape(len(GATHERED) + 1, self.height, self.width)
        meta = host[n:]
        scene = SceneParams(**{f: meta[12 + k] for k, f in enumerate(_SCENE)})
        return fields, meta[:12].reshape(3, 4), scene

    def stats(self) -> dict:
        """The last step's stats as the eager step returns them, from a copy
        of ``packed``."""
        full = self.packed.clone()
        local = full[self.first:self.first + self.n_local]
        out = {k: local[:, j].to(torch.int32) for j, k in enumerate(SHARDED_PACKED_KEYS[:5])}
        out["dist_from_ref"] = local[:, 5]
        out["packed"] = full
        return out

    def load_numpy(self, arrays: dict) -> None:
        """Adopt a batched numpy state of every global slot (the layout
        ``sharded.split_state_numpy`` takes): this rank's tiles into the
        buffers, every slot's keyframe pose and mean depth into ``refs``."""
        for dst, src in zip(self.states, shard_state(arrays, self.mesh)):
            copy_into(dst, src)
        refs = np.concatenate([np.asarray(arrays["T_world_ref"], np.float32).reshape(self.n, 12),
                               np.asarray(arrays["scene"]["avg_depth"],
                                          np.float32).reshape(self.n, 1)], axis=1)
        self.inputs.upload(self.refs, refs)
        self._refresh_host()

    def pool_bytes(self) -> int:
        return pool_bytes(self.pool)

    def captures(self) -> list[SegmentedProgram]:
        return [p for p in self.cache.values() if p.graph is not None]
