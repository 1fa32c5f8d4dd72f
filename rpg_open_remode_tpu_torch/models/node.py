"""Keyframe-lifecycle mapping node (counterpart of
``rpg_open_remode_tpu/models/node.py``; the reference's
``rmd::DepthmapNode``, src/depthmap_node.cpp:96-182).

  TAKE_REFERENCE_FRAME: the next frame (with its pose and scene depth
      bounds) becomes the reference keyframe.
  UPDATE: every frame is fused into the seed filter; when the converged
      percentage exceeds ``ref_compl_perc`` or the camera has moved more
      than ``max_dist_from_ref`` from the keyframe (depthmap_node.cpp:148),
      the keyframe is finalized (denoise, publish) and a new reference is
      taken.

Two mechanisms keep the frame loop off the device's clock:

  * **Strided, lagged switch policy.** Only every ``policy_stride``-th
    frame's packed stats are fetched: copied into a pinned host tensor with
    ``non_blocking=True`` behind a recorded CUDA event at dispatch, and read
    one stride later after ``event.synchronize()`` (on the CPU the copy is
    synchronous). Which frame's stats the policy acts on depends only on
    frame counts, never on transfer timing, so the same stats give the same
    switch frames as the JAX node.
  * **Finalization on a worker thread.** The finished keyframe's state,
    ``engine.state`` (a device copy made at the switch: the engine's
    programs keep writing their own buffers), is handed to a one-thread
    executor that denoises it (TV-L1), downloads it and calls
    ``on_keyframe``, while the loop re-seeds. The worker launches on the
    stream that was current on the loop's thread at the switch, so its
    reads of the snapshot are ordered after the copy, and no side stream
    is involved. The stats vector a frame returns is a copy too, made in
    stream order right after the frame's replay, which ``_fetch`` reads.

Spans (``utils/profiling.span``, nothing while the tracer is off):
``node.frame`` around each ``process_frame`` (its frame number is the node's
``num_msgs``), ``node.reference``, ``node.fetch``, ``node.resolve`` with
``node.stats_wait``, ``node.switch`` on the loop; ``node.finalize`` with
``node.denoise`` (also on the device), ``node.download`` and
``node.deliver`` on the worker, under the number of the frame that decided
the switch. The gauge ``node.keyframes_device_bytes`` follows
``keyframes_device_bytes``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.io.pointcloud import tint_convergence
from rpg_open_remode_tpu_torch.models.depthmap import (
    PACKED_STATS_KEYS, Depthmap, denoise_depthmap,
)
from rpg_open_remode_tpu_torch.models.state import SeedState, state_bytes
from rpg_open_remode_tpu_torch.utils.profiling import MetricsLog, carried, gauge, span


class NodeState(enum.Enum):
    TAKE_REFERENCE_FRAME = 0
    UPDATE = 1


@dataclasses.dataclass
class KeyframeResult:
    """Everything produced when a keyframe completes."""

    state: SeedState              # frozen filter state of the keyframe
    denoised_depth: np.ndarray    # TV-L1 regularized depth map
    converged_percentage: float
    n_updates: int
    # the keyframe's number among those its host exports (parallel/node.py;
    # None where one process numbers its own exports)
    index: int | None = None


def _fetch(packed: torch.Tensor):
    """Start the device-to-host copy of a stats vector: ``(host tensor,
    event)``, the event None when the copy is already complete."""
    with span("node.fetch"):
        if not packed.is_cuda:
            return packed.clone(), None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(packed.device))
        return host, event


class LifecycleNode:
    """What the lifecycle nodes share: finalization on one worker thread,
    the finalized ``keyframes`` and the teardown. A subclass sets
    ``engine``, ``cfg`` and ``on_keyframe``, queues its stats packets in
    ``_pending_stats`` and resolves them in ``_resolve_oldest``.
    ``keyframes_device_bytes`` counts the bytes of the states appended to
    ``keyframes``."""

    def __init__(self):
        self._pending_stats: collections.deque = collections.deque()
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []
        self.keyframes: list[KeyframeResult] = []
        self.keyframes_device_bytes = 0

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # -- worker thread -------------------------------------------------------

    def _submit(self, fn, *args) -> None:
        """Run ``fn(*args)`` on the worker thread, on the stream current
        here (the loop's), so that it sees every frame launched so far."""
        self._prune_pending()
        dev = self.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def task():
            with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
                fn(*args)

        self._pending.append(self._executor.submit(carried(task)))

    def _prune_pending(self) -> None:
        """Drop completed worker futures, re-raising their exceptions now
        rather than at close()."""
        still = []
        for f in self._pending:
            if f.done():
                f.result()   # raises if the worker task failed
            else:
                still.append(f)
        self._pending = still

    # -- keyframe completion (denoiseAndPublishResults, :165-182) ------------

    def _complete_keyframe(self, snapshot: SeedState, conv_pct: float, n_updates: int) -> None:
        with span("node.finalize"):
            with span("node.denoise", device=True):
                denoised = denoise_depthmap(snapshot, self.engine.cfg,
                                            lam=self.cfg.denoise_lambda,
                                            iterations=self.cfg.denoise_iters)
            with span("node.download"):
                denoised = denoised.cpu().numpy()
            result = KeyframeResult(state=snapshot, denoised_depth=denoised,
                                    converged_percentage=conv_pct, n_updates=n_updates)
            with span("node.deliver"):
                self.keyframes.append(result)
                self.keyframes_device_bytes += state_bytes(snapshot)
                gauge("node.keyframes_device_bytes", self.keyframes_device_bytes)
                if self.on_keyframe is not None:
                    self.on_keyframe(result)

    def drain(self) -> dict | None:
        """Resolve every in-flight stats packet (possibly finalizing
        keyframes); returns the last resolved metrics."""
        out = None
        while self._pending_stats:
            out = self._resolve_oldest()
        return out

    def flush(self) -> None:
        """Wait for all worker tasks, re-raising their exceptions."""
        self.drain()
        for f in self._pending:
            f.result()
        self._pending = []

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._executor.shutdown(wait=True)


class DepthmapNode(LifecycleNode):
    """Drives a ``Depthmap`` engine through the keyframe lifecycle.

    ``on_keyframe(result: KeyframeResult)`` is invoked on the worker thread
    whenever a keyframe is finalized (the reference's std::async publish,
    depthmap_node.cpp:170-172); ``on_convergence(overlay)`` receives the RGB
    convergence overlay every ``cfg.publish_conv_every_n`` messages, also on
    the worker thread. ``policy_stride`` is how often, in frames, the switch
    policy samples the device's stats."""

    def __init__(
        self,
        engine: Depthmap,
        cfg: RemodeConfig | None = None,
        on_keyframe: Callable[[KeyframeResult], None] | None = None,
        on_convergence: Callable[[np.ndarray], None] | None = None,
        metrics_path: str | None = None,
        policy_stride: int = 6,
    ):
        super().__init__()
        self.engine = engine
        self.cfg = cfg or engine.cfg
        self.state = NodeState.TAKE_REFERENCE_FRAME
        self.on_keyframe = on_keyframe
        self.on_convergence = on_convergence
        self.policy_stride = max(int(policy_stride), 1)
        self.num_msgs = 0
        self._n_updates = 0
        self._generation = 0          # bumps on every keyframe switch
        # _pending_stats: (frame_no, generation, host tensor, event)
        self.metrics = MetricsLog(metrics_path)

    # -- frame ingestion (denseInputCallback, depthmap_node.cpp:96-162) ----

    def process_frame(self, image, T_curr_world, min_depth: float | None = None,
                      max_depth: float | None = None) -> dict:
        """Feed one frame. min/max depth are required for the frame that
        becomes a reference (depthmap_node.cpp:131-136).

        Returns the resolved metrics of the newest strided frame known
        without waiting on the device (about 2 * policy_stride frames old),
        or ``{"event": "updated"}`` between samples."""
        self.num_msgs += 1
        with span("node.frame", frame=self.num_msgs):
            return self._process_frame(image, T_curr_world, min_depth, max_depth)

    def _process_frame(self, image, T_curr_world, min_depth, max_depth) -> dict:
        if self.state == NodeState.TAKE_REFERENCE_FRAME:
            if min_depth is None or max_depth is None:
                raise ValueError("reference frame needs min/max depth bounds")
            with span("node.reference"):
                self.engine.set_reference_image(image, T_curr_world, min_depth, max_depth)
            self._n_updates = 0
            self.state = NodeState.UPDATE
            return {"event": "reference_set"}

        stats = self.engine.update(image, T_curr_world)
        self._n_updates += 1
        # mid-keyframe convergence publishing (depthmap_node.cpp:158-162),
        # only for a registered consumer, on the worker thread
        n_conv = self.cfg.publish_conv_every_n
        if self.on_convergence is not None and n_conv > 0 and self.num_msgs % n_conv == 0:
            st = self.engine.programs.state   # copies of the two planes it reads
            self._submit(self._publish_convergence, st.ref_img.clone(), st.conv.clone())
        out = {"event": "updated"}
        if self._n_updates % self.policy_stride == 0:
            host, event = _fetch(stats["packed"])
            self._pending_stats.append(
                (self.num_msgs, self._generation, host, event)
            )
            # read the previous strided sample, dispatched a stride ago
            while len(self._pending_stats) > 1:
                out = self._resolve_oldest()
        return out

    def _resolve_oldest(self) -> dict:
        with span("node.resolve"):
            return self._resolve(*self._pending_stats.popleft())

    def _resolve(self, frame_no, gen, host, event) -> dict:
        if event is not None:
            with span("node.stats_wait"):
                event.synchronize()
        stats = {k: float(v) for k, v in zip(PACKED_STATS_KEYS, host.tolist())}
        npx = self.engine.width * self.engine.height
        conv_pct = stats["converged"] / npx * 100.0
        stats["converged_percentage"] = conv_pct
        stats["event"] = "updated"

        # keyframe switch policy (depthmap_node.cpp:142-157): only stats of
        # the current keyframe generation may trigger a switch
        if (
            gen == self._generation
            and self.state == NodeState.UPDATE
            and (conv_pct > self.cfg.ref_compl_perc
                 or stats["dist_from_ref"] > self.cfg.max_dist_from_ref)
        ):
            self._finalize_keyframe(conv_pct)
            self.state = NodeState.TAKE_REFERENCE_FRAME
            self._generation += 1
            stats["event"] = "keyframe_complete"
        self.metrics.log(frame_no, stats)
        return stats

    def _publish_convergence(self, ref_img: torch.Tensor, conv: torch.Tensor) -> None:
        self.on_convergence(tint_convergence(ref_img, conv))

    # -- keyframe completion (denoiseAndPublishResults, :165-182) ------------

    def _finalize_keyframe(self, conv_pct: float) -> None:
        with span("node.switch"):
            self._submit(self._complete_keyframe, self.engine.state, conv_pct, self._n_updates)

    def close(self) -> None:
        try:
            super().close()
        finally:
            self.metrics.close()
