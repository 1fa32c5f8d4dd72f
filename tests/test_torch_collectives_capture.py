"""The form of the mesh's compiled programs (``parallel/programs.
SegmentedProgram``) by backend, on a stub mesh and a recording collective,
on the CPU: under NCCL every collective runs inline in the body and the
capture takes one graph with no exchange point; under gloo each collective
is an exchange point between graph segments, run on the host between
replays. ``torch.cuda.CUDAGraph`` is replaced by a recorder, so the capture
and replay logic runs here without a card (the card itself:
``tests/test_torch_graphs_sharded_cuda.py``).
"""

import types

import pytest
import torch

from rpg_open_remode_tpu_torch.parallel import collectives
from rpg_open_remode_tpu_torch.parallel.programs import SegmentedProgram


def _mesh(backend):
    return types.SimpleNamespace(backend=backend, device=torch.device("cpu"),
                                 staged={"copies": 0, "bytes": 0})


class Recorder:
    """Collectives that record their calls: a sum over two fake ranks (the
    other rank's value is ``peer``) and a gather of two."""

    def __init__(self, log, peer=10.0, fail=False):
        self.log, self.peer, self.fail = log, peer, fail

    def all_reduce(self, send, recv):
        self.log.append(("all_reduce", send[0].clone()))
        if self.fail:
            raise RuntimeError("the collective failed")
        send[0].add_(self.peer)

    def all_gather(self, send, recv):
        self.log.append(("all_gather", send[0].clone()))
        recv[0].copy_(send[0])
        recv[1].copy_(send[0] + self.peer)


def _body(mesh, x, rec, out):
    """Two collectives with work before, between and after them."""
    def body():
        y = x * 2.0
        (s,) = collectives._collect(mesh, "all_reduce", "sp", [y], None, rec.all_reduce)
        like = (tuple(s.shape), s.dtype)
        a, b = collectives._collect(mesh, "all_gather", "tx", [s + 1.0], [like, like],
                                    rec.all_gather)
        out.copy_(a - b + s)
    return body


class FakeGraph:
    """``torch.cuda.CUDAGraph`` as a recorder of the capture and replay
    order."""

    events: list = []

    def __init__(self):
        self.index = sum(1 for e in FakeGraph.events if e[0] == "begin")

    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        FakeGraph.events.append(("begin", self.index))

    def capture_end(self):
        FakeGraph.events.append(("end", self.index))

    def replay(self):
        FakeGraph.events.append(("replay", self.index))


@pytest.fixture
def fake_graph(monkeypatch):
    FakeGraph.events = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    return FakeGraph


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_program_results_equal_eager(backend):
    """The body through the program, twice, equals the body with no
    program; the collectives saw the same inputs."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    want_log, want = [], torch.empty(2, 3)
    _body(_mesh(backend), x, Recorder(want_log), want)()
    log, out = [], torch.empty(2, 3)
    prog = SegmentedProgram(_body(_mesh(backend), x, Recorder(log), out), torch.device("cpu"),
                            None, "t")
    for _ in range(2):
        out.zero_()
        prog()
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert [k for k, _ in log] == [k for k, _ in want_log] * 2
    for (_, got), (_, ref) in zip(log, want_log * 2):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert [sig[:2] for sig in prog.signatures] == [("all_reduce", "sp"), ("all_gather", "tx")]


def test_nccl_program_runs_collectives_inline():
    """Under NCCL no exchange point is made: each collective runs in the
    body, on the tensors the body computed."""
    log = []
    x = torch.ones(2, 3)
    prog = SegmentedProgram(_body(_mesh("nccl"), x, Recorder(log), torch.empty(2, 3)),
                            torch.device("cpu"), None, "t")
    prog()
    assert prog.exchanges == []
    assert len(prog.signatures) == 2
    torch.testing.assert_close(log[0][1], x * 2.0)


def test_gloo_program_makes_exchange_points():
    """Under gloo each collective is an exchange point with static buffers,
    which the collective runs on."""
    log = []
    prog = SegmentedProgram(_body(_mesh("gloo"), torch.ones(2, 3), Recorder(log),
                                  torch.empty(2, 3)), torch.device("cpu"), None, "t")
    prog()
    assert [p.signature for p in prog.exchanges] == prog.signatures
    assert len(prog.exchanges) == 2
    assert prog.exchanges[1].recv[0].shape == (2, 3)


def test_nccl_capture_is_one_graph(fake_graph):
    """Under NCCL the capture is one segment, with the collectives called
    inside it, and a replay is one graph launch with no host collective."""
    log = []
    prog = SegmentedProgram(_body(_mesh("nccl"), torch.ones(2, 3), Recorder(log),
                                  torch.empty(2, 3)), torch.device("cpu"), None, "t")
    prog._run()
    n = len(log)
    prog.graph = prog._capture()
    assert len(prog.graph) == 1
    assert fake_graph.events == [("begin", 0), ("end", 0)]
    assert len(log) == 2 * n     # captured with the body
    fake_graph.events.clear()
    prog._replay()
    assert fake_graph.events == [("replay", 0)]
    assert len(log) == 2 * n     # nothing on the host


def test_gloo_capture_is_segments_between_exchanges(fake_graph):
    """Under gloo the capture ends a segment at each exchange point and
    runs no collective; a replay runs each exchange between two segments."""
    log = []
    prog = SegmentedProgram(_body(_mesh("gloo"), torch.ones(2, 3), Recorder(log),
                                  torch.empty(2, 3)), torch.device("cpu"), None, "t")
    prog._run()
    n = len(log)
    prog.graph = prog._capture()
    assert len(prog.graph) == len(prog.exchanges) + 1 == 3
    assert fake_graph.events == [("begin", 0), ("end", 0), ("begin", 1), ("end", 1),
                                 ("begin", 2), ("end", 2)]
    assert len(log) == n         # the capture ran no collective
    fake_graph.events.clear()
    prog._replay()
    assert fake_graph.events == [("replay", 0), ("replay", 1), ("replay", 2)]
    assert [k for k, _ in log[n:]] == ["all_reduce", "all_gather"]


@pytest.mark.parametrize("stage", ["warm-up", "capture"])
def test_nccl_failure_propagates(fake_graph, stage):
    """A failing collective of an NCCL mesh's program raises out of the
    warm-up and out of the capture; it is never turned into segments."""
    rec = Recorder([], fail=stage == "warm-up")
    prog = SegmentedProgram(_body(_mesh("nccl"), torch.ones(2, 3), rec, torch.empty(2, 3)),
                            torch.device("cpu"), None, "t")
    if stage == "capture":
        prog._run()
        rec.fail = True
    with pytest.raises(RuntimeError, match="the collective failed"):
        prog._run() if stage == "warm-up" else prog._capture()
    assert prog.exchanges == [] and prog.graph is None
    if stage == "capture":
        # the one segment was begun and ended, no other
        assert fake_graph.events == [("begin", 0), ("end", 0)]


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_program_holds_collectives_to_the_warm_up(backend):
    """A run that meets other collectives than the warm-up raises."""
    state = {"kind": "all_reduce"}

    def body():
        x = torch.ones(3)
        if state["kind"] == "all_reduce":
            collectives._collect(mesh, "all_reduce", "sp", [x], None, lambda s, r: None)
        else:
            collectives._collect(mesh, "all_reduce", "tx", [x], None, lambda s, r: None)

    mesh = _mesh(backend)
    prog = SegmentedProgram(body, torch.device("cpu"), None, "t")
    prog()
    state["kind"] = "other"
    with pytest.raises(RuntimeError, match="collective 0"):
        prog()
