"""The readers of the program's spans: each against a hand-built
program-traced window, and the window itself at a small size on the CPU."""

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests.tiny import tiny_cell
from rpg_open_remode_tpu_torch.utils.profiling import Span

torch.set_num_threads(2)
LOOP, WORKER = 1, 2
MS = 1_000_000   # ns


def _frame(t, frame, first_id, stage=(0.10, 0.05), regime=0.04, launch=0.02, wait=0.0,
           device=(0.2, 1.2), label="update uint8 regime 0"):
    """One frame's loop spans from ``t`` ms: stage (two uploads), regime,
    replay (with its device interval), stats copy; the node's own time
    fills the rest of 1.4 ms."""
    out, at, i = [], t, first_id + 1
    for d in stage:
        out.append(Span("programs.stage", LOOP, round(at * MS), round((at + d) * MS), i,
                        first_id, frame))
        at, i = at + d, i + 1
    if wait:
        out.append(Span("programs.staging_wait", LOOP, round((at - wait) * MS), round(at * MS),
                        i, i - 1, frame))
        i += 1
    out.append(Span("programs.regime", LOOP, round(at * MS), round((at + regime) * MS), i,
                    first_id, frame))
    at, i = at + regime, i + 1
    dev = (round((t + device[0]) * MS), round((t + device[1]) * MS))
    out.append(Span("programs.replay", LOOP, round(at * MS), round((at + launch) * MS), i,
                    first_id, frame, label, dev))
    out.append(Span("node.frame", LOOP, round(t * MS), round((t + 1.4) * MS), first_id, None,
                    frame))
    return out


def _window(**kw):
    spans_ = _frame(0.0, 1, 0, **kw) + _frame(1.4, 2, 100, **kw)
    return spans.Traced(spans=spans_, counters={}, window=(0, round(2.8 * MS)), loop=LOOP,
                        frames=2)


def read(metric, tw):
    return harness.reader(metric)({"program_trace": tw})


def test_idle_share_from_the_device_intervals():
    tw = _window()
    # busy 1.0 ms of each 1.4 ms frame
    assert read("device_idle_pct.offline", tw) == pytest.approx(100 * (1 - 2.0 / 2.8))
    # a TV-L1 on the worker covering the gap between the frames
    tw.spans.append(Span("node.denoise", WORKER, 0, 1, 900, 899, 1, None,
                         (round(1.2 * MS), round(1.6 * MS))))
    assert read("device_idle_pct.offline", tw) == pytest.approx(100 * (1 - 2.4 / 2.8))
    assert read("replay_device_ms_p50.offline", tw) == pytest.approx(1.0)
    # a reseed's replay is left out of the update replays' median
    tw.spans.append(Span("programs.replay", LOOP, 0, 1, 901, 0, 1, "set_reference uint8",
                         (0, round(0.1 * MS))))
    assert read("replay_device_ms_p50.offline", tw) == pytest.approx(1.0)


def test_idle_gaps_go_to_the_innermost_open_span():
    tw = _window()
    by = spans.idle_by_span(tw)
    # idle 0-0.2 ms (mid 0.1: the second upload's start), 1.2-1.6 (mid 1.4:
    # frame 2's first upload) and 2.6-2.8 (node.frame alone)
    assert by == {"programs.stage": pytest.approx(0.6 * MS, abs=2),
                  "node.frame": pytest.approx(0.2 * MS, abs=2)}
    assert spans.frame_cover_pct(tw) == pytest.approx(100.0)
    # past the last frame's end no span is open
    tw.window = (0, round(3.0 * MS))
    assert spans.idle_by_span(tw) == {"programs.stage": pytest.approx(0.6 * MS, abs=2),
                                      spans.OTHER: pytest.approx(0.4 * MS, abs=2)}

def test_host_stage_metrics_and_self_time():
    tw = _window(stage=(0.12, 0.04), regime=0.05, launch=0.03, wait=0.02)
    assert read("launch_ms_p50.offline", tw) == pytest.approx(0.03)
    # both uploads, less the wait for a pinned buffer inside the second
    assert read("stage_ms_p50.offline", tw) == pytest.approx(0.16 - 0.02)
    assert read("regime_ms_p50.offline", tw) == pytest.approx(0.05)
    # 1.4 less the node's direct children (the wait sits inside an upload)
    assert read("node_self_ms_p50.offline", tw) == pytest.approx(1.4 - 0.16 - 0.05 - 0.03)
    assert read("device_wait_ms_per_frame.offline", tw) == pytest.approx(0.02)


def test_lifecycle_readers():
    tw = _window()
    tw.counters["node.keyframes_device_bytes"] = [(1, 16.0e6), (2, 32.0e6)]
    for k, d in enumerate((0.5, 0.7, 0.9)):
        tw.spans.append(Span("node.switch", LOOP, 0, round(d * MS), 200 + k, None, 5))
        tw.spans.append(Span("node.finalize", WORKER, 0, round(3 * d * MS), 300 + k, None, 5))
    assert read("keyframes_held_gb.offline", tw) == pytest.approx(0.032)
    # what the node held when the window opened is not the window's
    tw.held_bytes = 8.0e6
    assert read("keyframes_held_gb.offline", tw) == pytest.approx(0.024)
    assert read("switch_ms_p50.live", tw) == pytest.approx(0.7)
    assert read("finalize_ms_p50.live", tw) == pytest.approx(2.1)
    assert read("keyframes_held_gb.offline", _window()) is None


def test_readers_read_nothing_from_a_program_without_the_tracer(monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert harness.program_window(None, None, 0, {}, False) == (None, None)
    for metric in ("device_idle_pct.offline", "stage_ms_p50.offline", "switch_ms_p50.live",
                   "keyframes_held_gb.offline"):
        assert harness.reader(metric)({"program_trace": None}) is None
        assert harness.reader(metric)({}) is None


def test_window_runs_the_harness_node_with_the_tracer_on(monkeypatch, capsys):
    """The window at 128x96 on the CPU, on the node that the measured window
    fed: the node's spans, frames and keyframes, the idle line on standard
    error, and the check over both windows' keyframes still correct."""
    from benchmark import check

    monkeypatch.setattr(spans, "SECONDS", 1.5)
    ctx = harness.run_cell(tiny_cell(), 2**31 + 77, None, True, "cpu", frames=12)
    tw = spans.window(ctx)
    assert tw is ctx["program_trace"] and tw.frames > 0
    assert ctx["last"] == ctx["window"].start + ctx["window"].fed + tw.frames - 1
    frames = spans.named(tw, "node.frame")
    assert len(frames) == tw.frames and {s.thread for s in frames} == {tw.loop}
    # the node that the measured window fed: its frame numbers go on
    assert min(s.frame for s in frames) >= ctx["window"].fed
    assert spans.frame_cover_pct(tw) > 50
    assert spans.device_intervals(tw) == []
    names = {s.name for s in tw.spans}
    assert {"node.frame", "programs.stage", "programs.regime"} <= names
    assert "program-traced window:" in capsys.readouterr().err
    ok, table = check.verdict(ctx["numbers"], ctx["cell"].config["limits"])
    assert ok, table
