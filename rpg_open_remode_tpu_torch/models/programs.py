"""The engine's compiled programs (counterpart of ``_jits_for`` in
``rpg_open_remode_tpu/models/depthmap.py``): each frame step, chunk frame
and keyframe reseed captured once as a CUDA graph and then replayed with
one launch.

The JAX engine compiles one program each for set_reference (flat, with
the undistortion grid, propagated), update (plain and undistorted) and
update_chunk (a ``lax.scan`` of update), in a cache shared by every engine
and so keyed by the config with its switch-policy fields normalised, and
specialised by tracing on the image shape and input dtype. Its matcher
decides the regime (``lax.switch``) and the coarse pass (``lax.cond``)
inside the program. Here:

  * ``Programs`` owns one engine state as a persistent set of buffers (a
    graph reads and writes fixed addresses), the engine's config and a
    cache of ``Program``s. The cache is the engine's own, so its config and
    image shape are fixed, and a program is keyed by (kind, input dtype,
    undistortion grid, regime). Their graphs share one memory pool: they
    are replayed one at a time on one stream, and each leaves nothing alive
    in it.
  * The regime is chosen on the host (``ops/rect_match.regime_index``) from
    the frame's pose and host copies of the keyframe pose and mean depth.
    Those are copied from the device once per keyframe, behind an event,
    right after the program that wrote them; the coarse gate stays on the
    device (``ops/rect_match.prepare_sweep``). A frame step reads nothing
    on the host.
  * Inputs are staged through pinned host buffers (``Inputs``) with
    non-blocking copies into the programs' static inputs, each pinned
    buffer guarded by an event, as ``jax.device_put`` does.
  * A ``Program``'s first call runs its body eagerly on a side stream (the
    warm-up, which computes this call's real result and does every
    first-use build and setting, e.g. the kernels' build and the sweep's
    shared-memory opt-in), then captures the body on that stream. Every
    later call is one replay. The body writes the new state back into the
    buffers and the packed stats into a static output, so the next replay
    reads them. A capture records the kernel launches its wrappers would
    make (``kernels.recording``) and each replay adds them to
    ``kernels.LAUNCHES``.
  * On the CPU a call runs the body: the same function and the same
    copies, nothing captured. There is no fallback: a failed capture or
    replay raises.

Spans (``utils/profiling.span``, nothing while the tracer is off):
``programs.stage`` around each upload with ``programs.staging_wait`` for a
pinned buffer, ``programs.regime`` with ``programs.refs_wait`` for the
keyframe's host copies, ``programs.replay`` around each graph launch (with
CUDA events right before and after it), ``programs.stats_copy`` around the
stats' copy.

The functional ``update_step``, ``update_chunk`` and
``_set_reference_propagated`` of ``models/depthmap.py`` stay eager: they
are the bodies captured here and the oracle the replays are held against.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models import depthmap as dm
from rpg_open_remode_tpu_torch.models.state import (
    SceneParams, SeedState, clone, copy_into, empty_state,
)
from rpg_open_remode_tpu_torch.ops import rect_match
from rpg_open_remode_tpu_torch.utils import warp as warp_ops
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
from rpg_open_remode_tpu_torch.utils.profiling import span

_PINNED_DEPTH = 3        # pinned staging buffers per shape and dtype
_capture_streams: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


def stats_of(packed: torch.Tensor) -> dict:
    """The stats dict of a packed vector ``[..., 7]`` (``PACKED_STATS_KEYS``
    order): each key a float32 view, and ``packed`` itself."""
    out = {k: packed[..., i] for i, k in enumerate(dm.PACKED_STATS_KEYS)}
    out["packed"] = packed
    return out


class Program:
    """``body()`` captured as a CUDA graph at its first call on the card
    (after an eager warm-up that is the call's result) and replayed after;
    on the CPU every call runs ``body()``. A subclass may run, capture and
    replay the body otherwise (``_run``, ``_capture``, ``_replay``)."""

    def __init__(self, body, device: torch.device, pool, label: str):
        self.body = body
        self.device = device
        self.pool = pool
        self.label = label
        self.graph = None
        self.launches: dict | None = None   # kernel launches of one replay
        self.capture_s: float | None = None  # host seconds of the capture
        self.captured_bytes: int | None = None  # reserved memory it added
        self.replays = 0

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self._run()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            with span("programs.replay", self.label, device=True):
                self._replay()
            kernels.add_launches(self.launches)
            self.replays += 1

    def _run(self) -> None:
        """The body, run eagerly."""
        self.body()

    def _capture(self):
        """The body captured on the current stream: what ``_replay``
        replays."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            self.body()
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        graph.capture_end()
        return graph

    def _replay(self) -> None:
        self.graph.replay()

    def _warm_up_and_capture(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._run()
            # garbage that owns a graph (a dropped engine) must not be
            # collected inside the capture: destroying a graph there
            # invalidates it
            gc.collect()
            gc_on = gc.isenabled()
            gc.disable()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            try:
                with kernels.recording() as launches:
                    graph = self._capture()
            finally:
                if gc_on:
                    gc.enable()
            self.capture_s = time.perf_counter() - t0
            self.captured_bytes = torch.cuda.memory_reserved(self.device) - reserved
        current.wait_stream(side)
        self.graph, self.launches = graph, launches


class Inputs:
    """The static inputs of an engine's programs: the frame (one buffer
    per input dtype, uint8 or float32), the pose ``[3, 4]`` and the scene
    bounds ``[2]``, with the chunks' device buffers. Host data reaches them
    through a ring of pinned buffers and a non-blocking copy; an event
    recorded after each copy guards its pinned buffer, so the host waits
    only when it runs ``_PINNED_DEPTH`` copies ahead of the device."""

    def __init__(self, height: int, width: int, device: torch.device):
        self.height, self.width = height, width
        self.device = device
        self.images = {
            dt: torch.zeros((height, width), dtype=dt, device=device)
            for dt in (torch.uint8, torch.float32)
        }
        self.pose = torch.zeros((3, 4), dtype=torch.float32, device=device)
        self.bounds = torch.zeros(2, dtype=torch.float32, device=device)
        self._chunks: dict = {}
        self._pinned: dict = {}

    @staticmethod
    def dtype_of(x) -> torch.dtype:
        dt = x.dtype if isinstance(x, torch.Tensor) else np.asarray(x).dtype
        return torch.uint8 if dt in (torch.uint8, np.uint8) else torch.float32

    def upload(self, dst: torch.Tensor, x) -> None:
        """Copy ``x`` (an array, or a tensor on any device) into ``dst`` in
        stream order, converting to its dtype, without a host sync."""
        with span("programs.stage"):
            self._upload(dst, x)

    def _upload(self, dst: torch.Tensor, x) -> None:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            dst.copy_(x)
            return
        src = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if dst.device.type != "cuda":
            dst.copy_(src)
            return
        key = (tuple(dst.shape), dst.dtype)
        ring, i = self._pinned.get(key, (None, 0))
        if ring is None:
            ring = [[torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True), None]
                    for _ in range(_PINNED_DEPTH)]
        buf, event = ring[i]
        if event is not None:
            with span("programs.staging_wait"):
                event.synchronize()   # the copy that last read this buffer
        buf.copy_(src)
        dst.copy_(buf, non_blocking=True)
        if event is None:
            event = ring[i][1] = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dst.device))
        self._pinned[key] = (ring, (i + 1) % _PINNED_DEPTH)

    def load_image(self, img) -> torch.dtype:
        """The frame into its dtype's buffer; returns that dtype."""
        dt = self.dtype_of(img)
        self.upload(self.images[dt], img)
        return dt

    def load_pose(self, T) -> np.ndarray:
        """The pose into the pose buffer; returns its float32 host copy (a
        pose on the card is read back: once per call)."""
        host = _host_f32(T)
        self.upload(self.pose, host if not isinstance(T, torch.Tensor) or T.is_cpu else T)
        return host

    def load_bounds(self, min_depth, max_depth) -> None:
        self.upload(self.bounds, np.array([min_depth, max_depth], np.float32))

    def load_chunk(self, imgs, Ts):
        """K frames and poses: ``(images [K, H, W] on the device, their
        dtype, poses [K, 3, 4] on the device, poses on the host)``; host
        arrays are uploaded once for the chunk, poses on the card read back
        once."""
        dt = self.dtype_of(imgs)
        host_Ts = _host_f32(Ts)
        k = len(host_Ts)
        if (isinstance(imgs, torch.Tensor) and imgs.device.type == self.device.type
                and imgs.dtype == dt):
            d_imgs = imgs
        else:
            d_imgs = self._chunk_buffer("imgs", (k, self.height, self.width), dt)
            self.upload(d_imgs, imgs)
        if isinstance(Ts, torch.Tensor) and Ts.device.type == self.device.type:
            d_Ts = Ts.to(torch.float32)
        else:
            d_Ts = self._chunk_buffer("poses", (k, 3, 4), torch.float32)
            self.upload(d_Ts, host_Ts)
        return d_imgs, dt, d_Ts, host_Ts

    def _chunk_buffer(self, name, shape, dtype) -> torch.Tensor:
        key = (name, shape, dtype)
        if key not in self._chunks:
            self._chunks[key] = torch.empty(shape, dtype=dtype, device=self.device)
        return self._chunks[key]


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class Programs:
    """One engine state in persistent buffers (``state``), the engine's
    config (``cfg``) and the programs that advance it. ``cam_host`` is
    ``(fx, fy)`` as host numbers (the regime's camera); ``inputs`` may be
    shared (the ring's slots share theirs)."""

    def __init__(self, height: int, width: int, cam: PinholeCamera, cam_host,
                 cfg: RemodeConfig, device: torch.device, inputs: Inputs | None = None):
        self.height, self.width = height, width
        self.cam = cam
        self.fx, self.fy = (np.float32(v) for v in cam_host)
        self.cfg = cfg
        self.device = device
        self.inputs = inputs or Inputs(height, width, device)
        # one buffer per leaf (empty_state shares one zero plane among them)
        self.state = clone(empty_state(height, width, cam))
        self.packed = torch.zeros(len(dm.PACKED_STATS_KEYS), dtype=torch.float32,
                                  device=device)
        self.cache: dict = {}
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._host_buf = torch.zeros(13, dtype=torch.float32,
                                     pin_memory=device.type == "cuda")
        self._host_event = torch.cuda.Event() if device.type == "cuda" else None
        self._host_refs = None
        self._refresh_host()

    # -- host copies of the keyframe pose and mean depth ---------------------

    def _refresh_host(self) -> None:
        """Start the copy of ``T_world_ref`` and ``scene.avg_depth`` to the
        host, in stream order after what wrote them (no wait here)."""
        st = self.state
        nb = self.device.type == "cuda"
        self._host_buf[:12].copy_(st.T_world_ref.reshape(-1), non_blocking=nb)
        self._host_buf[12:].copy_(st.scene.avg_depth.reshape(1), non_blocking=nb)
        if nb:
            self._host_event.record(torch.cuda.current_stream(self.device))
        self._host_refs = None

    def regime(self, T_host: np.ndarray) -> int | None:
        """The rectified matcher's branch for a frame at host pose
        ``T_host`` (None for the walk and sweep match modes, which have
        none)."""
        if self.cfg.match_mode != "rect":
            return None
        with span("programs.regime"):
            if self._host_refs is None:
                if self._host_event is not None:
                    with span("programs.refs_wait"):
                        self._host_event.synchronize()
                buf = self._host_buf.numpy().copy()
                self._host_refs = (buf[:12].reshape(3, 4), buf[12])
            T_ref, avg = self._host_refs
            return rect_match.regime_index(T_host, T_ref, avg, self.fx, self.fy, self.height,
                                           self.width, self.cfg)

    # -- the programs ---------------------------------------------------------

    def _image(self, dtype, grid) -> torch.Tensor:
        img = dm.prep_image(self.inputs.images[dtype])
        if grid is not None:
            img = warp_ops.warp_grid(img, *grid)
        return img

    def program(self, kind: str, dtype: torch.dtype, grid=None, regime=None) -> Program:
        """The cached program of ``kind`` ("update", "set_reference",
        "set_reference_propagated") for input ``dtype``, undistortion
        ``grid`` ((gu, gv) or None) and matcher ``regime``."""
        key = (kind, dtype, None if grid is None else id(grid), regime)
        prog = self.cache.get(key)
        if prog is None:
            body = getattr(self, "_" + kind)(dtype, grid, regime)
            label = f"{kind} {str(dtype).split('.')[-1]}" + (" undistorted" if grid else "") + (
                "" if regime is None else f" regime {regime}")
            prog = self.cache[key] = Program(body, self.device, self.pool, label)
        return prog

    def _update(self, dtype, grid, regime):
        def body():
            new, stats = dm.update_step(self.state, self._image(dtype, grid), self.inputs.pose,
                                        self.cam, self.cfg, regime)
            copy_into(self.state, new)
            self.packed.copy_(stats["packed"])
        return body

    def _set_reference(self, dtype, grid, regime):
        def body():
            scene = SceneParams.from_bounds(self.inputs.bounds, self.cfg)
            new = dm.set_reference(self.state, self._image(dtype, grid), self.inputs.pose,
                                   scene, self.cfg)
            copy_into(self.state, new)
        return body

    def _set_reference_propagated(self, dtype, grid, regime):
        def body():
            scene = SceneParams.from_bounds(self.inputs.bounds, self.cfg)
            new = dm._set_reference_propagated(self.state, self._image(dtype, grid),
                                               self.inputs.pose, scene, self.cam, self.cfg)
            copy_into(self.state, new)
        return body

    # -- what the engines call --------------------------------------------------

    def set_reference(self, img, T_curr_world, min_depth, max_depth, propagated: bool,
                      grid=None) -> None:
        """New keyframe: one program call (flat, or warm-started from the
        outgoing state)."""
        dtype = self.inputs.load_image(img)
        self.inputs.load_pose(T_curr_world)
        self.inputs.load_bounds(min_depth, max_depth)
        kind = "set_reference_propagated" if propagated else "set_reference"
        self.program(kind, dtype, grid)()
        self._refresh_host()

    def step(self, dtype, T_host, grid=None) -> None:
        """One update of the state from the frame and pose already in the
        inputs (``T_host`` the pose's host copy); the stats land in
        ``packed``."""
        self.program("update", dtype, grid, self.regime(T_host))()

    def update(self, img, T_curr_world, grid=None) -> dict:
        """One measurement frame; returns its stats (a fresh packed vector
        and a float32 view of it per key)."""
        dtype = self.inputs.load_image(img)
        T_host = self.inputs.load_pose(T_curr_world)
        self.step(dtype, T_host, grid)
        with span("programs.stats_copy"):
            packed = self.packed.clone()
        return stats_of(packed)

    def update_chunk(self, imgs, Ts_curr_world, grid=None) -> torch.Tensor:
        """K frames, one replay each with no host read between them; returns
        the ``[K, 7]`` packed stats on the device."""
        d_imgs, dtype, d_Ts, host_Ts = self.inputs.load_chunk(imgs, Ts_curr_world)
        out = torch.empty((len(host_Ts), len(dm.PACKED_STATS_KEYS)), dtype=torch.float32,
                          device=self.device)
        for k, T_host in enumerate(host_Ts):
            self.inputs.images[dtype].copy_(d_imgs[k])
            self.inputs.pose.copy_(d_Ts[k])
            self.step(dtype, T_host, grid)
            out[k].copy_(self.packed)
        return out

    def load(self, state: SeedState) -> None:
        """Adopt ``state``: copied into the buffers."""
        copy_into(self.state, state)
        self._refresh_host()

    def snapshot(self) -> SeedState:
        """A device copy of the state, made now (``models.state.clone``)."""
        return clone(self.state)

    def pool_bytes(self) -> int:
        """Device memory held by this engine's graph pool; 0 on the CPU."""
        return pool_bytes(self.pool)

    def captures(self) -> list[Program]:
        return [p for p in self.cache.values() if p.graph is not None]


def pool_bytes(pool) -> int:
    """Device memory held by graph pool ``pool`` (its segments in the
    caching allocator); 0 for None (the CPU)."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
