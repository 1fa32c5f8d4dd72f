"""The program's tracer (``utils/profiling.TRACER``) inside the lifecycle,
the facade and the programs: a tiny ``DepthmapNode`` over the CPU with the
tracer on records every span with its nesting, frame numbers and threads,
and the keyframe bytes counter; results are bit-identical with the tracer on
and off; off, it records and allocates nothing.

On the CPU a program runs its body and the loop waits on no event. So the
CPU cases give each program a device that reads as the card and a stand-in
graph (its body, which ``Program.__call__`` replays through its own replay
branch and span) and the keyframe pose copy and stats fetch no-op events; the
pinned staging ring, and with it ``programs.staging_wait``, exists only on
the card, where the ``cuda`` case checks it with the device intervals. The
file imports no JAX, so it runs on the card with ``--noconftest``.
"""

import collections
import threading
import tracemalloc

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.models import node as node_mod
from rpg_open_remode_tpu_torch.models import programs
from rpg_open_remode_tpu_torch.models.state import state_bytes
from rpg_open_remode_tpu_torch.utils import profiling
from rpg_open_remode_tpu_torch.utils import synthetic

torch.set_num_threads(2)
W, H = 96, 72
CAM = dict(fx=72.2, fy=-72.0, cx=47.5, cy=35.5)
N_FRAMES = 22
CFG = dict(num_planes=48, max_dist_from_ref=0.09, denoise_iters=20)

# span -> the span it opens inside (None: a root on its thread; a flush
# resolves the last stats outside any frame)
NESTING = {
    "node.frame": None,
    "node.reference": "node.frame",
    "node.fetch": "node.frame",
    "node.resolve": ("node.frame", None),
    "node.stats_wait": "node.resolve",
    "node.switch": "node.resolve",
    "node.finalize": None,
    "node.denoise": "node.finalize",
    "node.download": "node.finalize",
    "node.deliver": "node.finalize",
    "programs.stage": ("node.frame", "node.reference"),
    "programs.regime": "node.frame",
    "programs.refs_wait": "programs.regime",
    "programs.replay": ("node.frame", "node.reference"),
    "programs.stats_copy": "node.frame",
}
CUDA_ONLY = {"programs.staging_wait": "programs.stage"}
WORKER = {"node.finalize", "node.denoise", "node.download", "node.deliver"}


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


@pytest.fixture(scope="module")
def frames():
    return synthetic.generate(n_frames=N_FRAMES, width=W, height=H, cam=CAM, seed=4,
                              step=0.023)


class _Event:
    """A CUDA event's waits, for the CPU."""

    def record(self, *args):
        pass

    def synchronize(self):
        pass


class _Replayed(programs.Program):
    """A program on a device that reads as the card, whose stand-in graph
    is its body: ``Program.__call__`` takes its own capture and replay
    branches, and its ``programs.replay`` span is the program's."""

    def __init__(self, body, device, pool, label):
        super().__init__(body, _AsCuda(device), pool, label)

    def _warm_up_and_capture(self):
        self._run()
        self.graph, self.launches = self.body, {}

    def _replay(self):
        self.graph()


class _AsCuda:
    """A CPU device that reads as the card to ``Program.__call__``."""

    type = "cuda"

    def __init__(self, device):
        self.index = torch.device(device).index


def _stand_ins(monkeypatch):
    monkeypatch.setattr(programs, "Program", _Replayed)
    fetch = node_mod._fetch
    monkeypatch.setattr(node_mod, "_fetch", lambda packed: (fetch(packed)[0], _Event()))


def _run(frames, device="cpu", events=0, traced=True):
    """The node over ``frames``; returns what it delivered, its keyframes'
    bytes counter and the tracer's records (None untraced)."""
    engine = P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"],
                        cfg=P.RemodeConfig(**CFG), device=device)
    if device == "cpu":
        engine.programs._host_event = _Event()
    delivered = []
    node = node_mod.DepthmapNode(engine, on_keyframe=delivered.append, policy_stride=2)
    if traced:
        profiling.enable(events=events)
    try:
        for fr in frames:
            node.process_frame(fr.image, _Tcw(fr), *_bounds(fr))
        node.flush()
        if device != "cpu":
            torch.cuda.synchronize()
    finally:
        profiling.disable()
        node.close()
    records = profiling.take() if traced else None
    return dict(delivered=delivered, node=node, records=records)


@pytest.fixture(scope="module")
def runs(frames):
    mp = pytest.MonkeyPatch()
    try:
        _stand_ins(mp)
        return {"on": _run(frames), "off": _run(frames, traced=False)}
    finally:
        mp.undo()


def _by_id(records):
    return {s.id: s for s in records.spans}


def test_every_span_nests_as_the_layers_open_it(runs):
    records = runs["on"]["records"]
    by_id = _by_id(records)
    names = collections.Counter(s.name for s in records.spans)
    assert set(names) == set(NESTING), names
    for s in records.spans:
        want = NESTING[s.name]
        got = None if s.parent is None else by_id[s.parent].name
        assert got in (want if isinstance(want, tuple) else (want,)), (s.name, got)
        if s.parent is not None:   # inside its parent, on its thread
            p = by_id[s.parent]
            assert p.thread == s.thread and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # every program call after each program's first is a replay
    assert names["programs.replay"] == N_FRAMES - len(runs["on"]["node"].engine.programs.cache)


def test_frames_switches_and_finalizations_are_counted(runs):
    records, delivered = runs["on"]["records"], runs["on"]["delivered"]
    spans = records.spans
    frame_spans = [s for s in spans if s.name == "node.frame"]
    assert len(frame_spans) == N_FRAMES
    assert sorted(s.frame for s in frame_spans) == list(range(1, N_FRAMES + 1))
    assert len(delivered) >= 2
    switches = [s for s in spans if s.name == "node.switch"]
    finals = [s for s in spans if s.name == "node.finalize"]
    assert len(switches) == len(finals) == len(delivered)
    loop = frame_spans[0].thread
    assert loop == threading.main_thread().ident
    assert all(s.thread == loop for s in spans if s.name not in WORKER)
    assert all(s.thread != loop for s in spans if s.name in WORKER)
    # every span of a frame carries its number; the worker's carry the
    # number of the frame that decided the switch
    by_id = _by_id(records)
    for s in spans:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.frame == root.frame
    decided = collections.Counter(s.frame for s in switches)
    assert collections.Counter(s.frame for s in finals) == decided
    assert collections.Counter(s.frame for s in spans if s.name in WORKER) == collections.Counter(
        {f: 4 * n for f, n in decided.items()})
    assert sum(n for f, n in decided.items() if f is not None) >= 1


def test_keyframes_device_bytes_counts_the_states_held(runs):
    node, records = runs["on"]["node"], runs["on"]["records"]
    held = sum(state_bytes(r.state) for r in node.keyframes)
    assert held == node.keyframes_device_bytes > 0
    # a keyframe: 13 float32 planes, its [3, 4] pose and the scene's scalars
    assert held == len(node.keyframes) * (13 * W * H + 12 + 6) * 4
    samples = records.counters["node.keyframes_device_bytes"]
    assert [v for _, v in samples][-1] == held and len(samples) == len(node.keyframes)
    assert runs["off"]["node"].keyframes_device_bytes == held


def test_results_are_bit_identical_with_the_tracer_on_and_off(runs):
    on, off = runs["on"]["delivered"], runs["off"]["delivered"]
    assert len(on) == len(off) >= 2
    for a, b in zip(on, off):
        assert torch.equal(a.state.mu, b.state.mu)
        assert torch.equal(a.state.conv, b.state.conv)
        assert np.array_equal(a.denoised_depth, b.denoised_depth)
        assert a.n_updates == b.n_updates


def test_off_the_tracer_records_and_allocates_nothing(frames):
    assert not profiling.TRACER.on
    assert profiling.span("node.frame", frame=1) is profiling.NO_SPAN
    assert profiling.span("programs.replay", "x", device=True) is profiling.NO_SPAN
    fn = object()
    assert profiling.carried(fn) is fn
    run = _run(frames[:8], traced=False)
    profiling.gauge("node.keyframes_device_bytes", 1.0)
    records = profiling.take()
    assert records.spans == [] and records.counters == {}
    assert run["node"].num_msgs == 8
    # no allocation in the tracer's module over many spans
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(2000):
            with profiling.span("node.frame", frame=i):
                with profiling.span("programs.replay", "update", device=True):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert grown == []


def test_spans_open_profiler_ranges_while_the_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("node.frame", frame=1):
                with profiling.span("programs.stage"):
                    torch.ones(4).sum()
        with profiling.span("node.frame", frame=2):   # the profiler is off again
            pass
    finally:
        profiling.disable()
    names = [e.name for e in prof.events()]
    assert names.count("node.frame") == 1 and names.count("programs.stage") == 1
    assert [s.frame for s in profiling.take().spans] == [1, 1, 2]


def test_enable_drops_the_last_records_and_take_clears_them():
    profiling.enable()
    with profiling.span("a"):
        pass
    profiling.enable()
    with profiling.span("b"):
        pass
    profiling.disable()
    records = profiling.take()
    assert [s.name for s in records.spans] == ["b"] and records.anchor_error_ns is None
    assert records.window[0] <= records.spans[0].start_ns <= records.window[1]
    assert profiling.take().spans == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and CUDA events have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
def test_device_intervals_lie_in_the_window_on_the_anchored_clock(cuda, frames):
    run = _run(frames, device=cuda, events=256)
    records = run["records"]
    names = {s.name for s in records.spans}
    assert names == set(NESTING) | set(CUDA_ONLY), names
    by_id = _by_id(records)
    for s in records.spans:
        if s.name in CUDA_ONLY:
            assert by_id[s.parent].name == CUDA_ONLY[s.name]
    assert records.dropped == 0 and 0 <= records.anchor_error_ns < 1e6
    timed = [s for s in records.spans if s.device is not None]
    assert {s.name for s in timed} == {"programs.replay", "node.denoise"}
    assert all(s.name not in ("programs.replay", "node.denoise") or s.device for s in
               records.spans)
    lo, hi = records.window
    err = records.anchor_error_ns   # the most an anchored time is off
    for s in timed:
        start, end = s.device
        assert lo - err <= start <= end <= hi + err, (s.name, start - lo, hi - end)
        # the device ran it after the host began the span around it
        assert start >= by_id[s.parent].start_ns - err
    # one thread's intervals follow one another on its stream
    for thread in {s.thread for s in timed}:
        mine = sorted((s.device for s in timed if s.thread == thread))
        assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    assert len(run["delivered"]) >= 2

