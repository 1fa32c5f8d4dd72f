"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window
through ``DepthmapNode.process_frame``, with ``--trace 1`` on the same node
the program-traced window (``spans.py``) and the profiler's window after it,
then the check of what the windows produced against the plain reference
(``check.py``).

Everything a cell names is found by name: its configuration in
``configs/<config>.json``, its own limits, where it has them, in
``limits/<workload>.json``, its traffic mix in ``traffic/<traffic>.json`` and
each metric's reader in ``metrics/<metric>.py`` (``read(ctx)``, a number, or
None where it finds nothing to read). Of the program the harness sees only
what a user's loop sees: each ``process_frame`` call's return and the
``KeyframeResult`` handed to ``on_keyframe``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import check, profiling, spans, synth
from benchmark.accounting import frame_bound_ms
from benchmark.reference import engine as ref_engine
from benchmark.reference import match as ref_match
from benchmark.reference.config import Config

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rpg_open_remode_tpu")
FEED, WAIT = "bench.feed", "bench.wait_due"
LABELS = {profiling.WINDOW, FEED, WAIT}
REGIME_SPAN = 48   # frames after a reference that the regime survey covers
SPIN = 0.002       # seconds before a due time that the open loop stops sleeping


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int = 1


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    traffic mix and the metrics it reports. Where ``limits/<name>.json``
    exists, its ``limits`` replace the configuration's of the same names
    in this cell."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    own = HERE / "limits" / f"{name}.json"
    if own.exists():
        config["limits"] = dict(config["limits"], **json.loads(own.read_text())["limits"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, config=config,
                traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]),
                chips=w["chips"])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -- the stream ---------------------------------------------------------------------

class Stream:
    """The cell's frames in stream order: position ``t`` plays bank frame
    ``ping_pong(t)`` with its pose and scene bounds."""

    def __init__(self, bank: synth.Bank):
        self.bank = bank
        self.n = len(bank.poses)
        self.bounds = [(float(a), float(b)) for a, b in bank.bounds]

    def index(self, t: int) -> int:
        return synth.ping_pong(t, self.n)

    def feed(self, node, t: int) -> dict:
        i = self.index(t)
        return node.process_frame(self.bank.images[i], self.bank.poses[i], *self.bounds[i])


def stream_regimes(bank: synth.Bank, cfg: Config, camera: dict):
    """``(regime, reference, update)``, the matcher regime and the bank
    indices, of every pair of the ping-pong stream: each reference position
    with the ``REGIME_SPAN`` frames after it."""
    n = len(bank.poses)
    fx, fy = np.float32(camera["fx"]), np.float32(camera["fy"])
    for t0 in range(max(2 * n - 2, 1)):
        r = synth.ping_pong(t0, n)
        T = bank.poses[r].astype(np.float64)
        T_ref = np.concatenate([T[:, :3].T, -T[:, :3].T @ T[:, 3:]], axis=1).astype(np.float32)
        avg = np.float32((bank.bounds[r, 0] + bank.bounds[r, 1]) / 2)
        for t in range(t0 + 1, t0 + 1 + REGIME_SPAN):
            j = synth.ping_pong(t, n)
            yield (ref_match.regime_index(bank.poses[j], T_ref, avg, fx, fy, camera["height"],
                                          camera["width"], cfg), r, j)


def reachable_regimes(bank: synth.Bank, cfg: Config, camera: dict) -> dict:
    """Matcher regime -> the first (reference, update) pair of bank indices
    of ``stream_regimes`` that reaches it."""
    out = {}
    for g, r, j in stream_regimes(bank, cfg, camera):
        out.setdefault(g, (r, j))
    return out


# -- the loop -------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What the loop saw: the stream positions fed and the reference
    positions among them; per frame, where recorded, its due time, call,
    return and completion on the host clock (s) and its CUDA events."""
    start: int
    fed: int = 0
    refs: list = dataclasses.field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    due: list = dataclasses.field(default_factory=list)
    call: list = dataclasses.field(default_factory=list)
    ret: list = dataclasses.field(default_factory=list)
    done: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    def device_ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.events]


def wait_until(due: float) -> None:
    """Return at ``due`` on the host clock: a sleep to ``SPIN`` seconds
    before it (a sleep overshoots by up to a millisecond), then yields of
    the processor, which also release the interpreter lock, so that the
    node's worker thread runs meanwhile."""
    ahead = due - time.perf_counter()
    if ahead > SPIN:
        time.sleep(ahead - SPIN)
    while time.perf_counter() < due:
        os.sched_yield()


def drive(node, stream: Stream, start: int, traffic: dict, cuda: bool, *,
          seconds: float | None = None, frames: int | None = None, spans: bool = False,
          labelled: bool = False) -> Window:
    """Feed frames from stream position ``start``. Closed loop: back to back,
    for ``seconds`` or ``frames``. Open loop: ``frames`` (or ``seconds`` x
    ``rate_hz``) frames due on a fixed schedule; each waits for its due time
    and its completion is stamped once a CUDA event recorded behind it has
    fired. ``spans`` records every call's host times and CUDA events;
    ``labelled`` marks each call and wait for the profiler."""
    from torch.profiler import record_function

    def label(name):
        return record_function(name) if labelled else contextlib.nullcontext()

    open_loop = traffic["loop"] == "open"
    if open_loop and frames is None:
        frames = round(seconds * traffic["rate_hz"])
    period = 1.0 / traffic["rate_hz"] if open_loop else 0.0
    stamp = spans or open_loop
    w = Window(start=start)
    t = start
    w.t0 = time.perf_counter()
    end = w.t0 + (seconds or 0.0)
    while frames is None or t - start < frames:
        if open_loop:
            due = w.t0 + (t - start) * period
            with label(WAIT):
                wait_until(due)
            w.due.append(due)
        if cuda and spans:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        c = time.perf_counter()
        with label(FEED):
            out = stream.feed(node, t)
        r = time.perf_counter()
        if out.get("event") == "reference_set":
            w.refs.append(t)
        if stamp:
            w.call.append(c)
            w.ret.append(r)
            if cuda:
                ev1 = torch.cuda.Event(enable_timing=spans)
                ev1.record()
                if spans:
                    w.events.append((ev0, ev1))
                if open_loop:
                    ev1.synchronize()
            if open_loop:
                w.done.append(time.perf_counter())
        t += 1
        if frames is None and time.perf_counter() >= end:
            break
    w.fed = t - start
    return w


# -- the run ----------------------------------------------------------------------------

def _host(result) -> dict:
    st = result.state
    return dict(mu=st.mu.cpu().numpy(), conv=st.conv.cpu().numpy(),
                denoised=np.asarray(result.denoised_depth),
                depth_range=float(st.scene.depth_range))


def run_cell(cell: Cell, seed: int, seconds: float | None, trace: bool, device: str = "cuda",
             t_process: float | None = None, frames: int | None = None) -> dict:
    """One run of ``cell``: a window of ``seconds``. Returns the context that
    the metric readers and the check read. ``frames``, which only the CPU
    tests give, makes it a window of that many frames instead: a fixed
    amount of work, where a loaded host would feed too few in a window of
    time."""
    from rpg_open_remode_tpu_torch import Depthmap
    from rpg_open_remode_tpu_torch.config import RemodeConfig
    from rpg_open_remode_tpu_torch.models.node import DepthmapNode

    t_process = time.perf_counter() if t_process is None else t_process
    cuda = torch.device(device).type == "cuda"
    cam, tr = cell.config["camera"], cell.traffic
    bank = synth.render_bank(cam, cell.config["scene"], tr["bank_frames"], tr["step_m"],
                             tr["motion"], seed, device)
    stream = Stream(bank)
    engine = Depthmap(cam["width"], cam["height"], cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                      cfg=RemodeConfig(**cell.config["remode"]), device=device)
    stride = cell.config["policy_stride"]

    # warm-up: the lifecycle until a keyframe has been finalized, then one
    # frame of every other matcher regime the stream reaches
    warm = []
    node = DepthmapNode(engine, on_keyframe=warm.append, policy_stride=stride)
    t = 0
    while t < tr["warmup_frames"] or not warm:
        stream.feed(node, t)
        t += 1
        if t >= tr["warmup_frames"] and not warm:
            node.flush()
        if t > 10 * tr["warmup_frames"]:
            raise RuntimeError("the warm-up finalized no keyframe")
    node.close()
    for regime, (r, j) in sorted(reachable_regimes(bank, Config(**cell.config["remode"]),
                                                   cam).items()):
        if regime != ref_match.RECTIFIED:
            engine.set_reference_image(bank.images[r], bank.poses[r], *stream.bounds[r])
            engine.update(bank.images[j], bank.poses[j])
    del warm, node
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    captured = len(engine.programs.cache)
    setup_s = time.perf_counter() - t_process

    # the measured window, then with --trace 1 the program-traced window and
    # the profiler's
    delivered = []
    node = DepthmapNode(engine, on_keyframe=delivered.append, policy_stride=stride)
    win = drive(node, stream, t, tr, cuda, seconds=seconds, frames=frames, spans=trace)
    node.flush()
    if cuda:
        torch.cuda.synchronize()
    win.t1 = time.perf_counter()
    refs = list(win.refs)
    t = win.start + win.fed
    flushes = [t - 1]
    program_trace, traced, traced_at = None, None, range(0)
    if trace:
        program_trace, w = program_window(node, stream, t, tr, cuda)
        if w is not None:
            refs.extend(w.refs)
            t = w.start + w.fed
            flushes.append(t - 1)
    if trace and cuda:
        box = {"next": t}

        def run():
            from torch.profiler import record_function

            with record_function(profiling.WINDOW):
                w = drive(node, stream, box["next"], tr, cuda, frames=tr["trace_frames"],
                          labelled=True)
            refs.extend(w.refs)
            box["next"] = w.start + w.fed
            box["w"] = w

        # the program's spans as ranges, so that the breakdown names them;
        # the profiler shows them on the device too, where they are no work
        prog = spans.tracer() if program_trace is not None else None
        if prog is not None:
            prog.enable()
        try:
            prof, marker = profiling.profiled(run)
        finally:
            if prog is not None:
                prog.disable()
        names = {s.name for s in prog.take().spans} if prog is not None else set()
        traced = profiling.reduce(prof, marker, box["w"].fed, LABELS | names)
        traced_at = range(box["w"].start, box["w"].start + box["w"].fed)
        del prof
        t = box["next"]
        node.flush()
        flushes.append(t - 1)
    captured_in_window = len(engine.programs.cache) - captured

    # the program's sampled results to the host, then its state freed: the
    # longest keyframe and others drawn from the seed, and every keyframe
    # that the traced window touched (the roofline counts their sweeps)
    n_updates = [r.n_updates for r in delivered]
    refs.sort()
    sample = {k for k, n in enumerate(n_updates)
              if k < len(refs) and refs[k] < traced_at.stop and refs[k] + n >= traced_at.start}
    if n_updates:
        rng = np.random.default_rng(seed)
        sample.add(int(np.argmax(n_updates)))
        k = min(tr["check_keyframes"] - 1, len(n_updates))
        sample.update(int(x) for x in rng.choice(len(n_updates), size=k, replace=False))
    outputs = {k: _host(delivered[k]) for k in sorted(sample)}
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    node.close()
    del node, engine, delivered
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ctx = dict(cell=cell, seed=seed, setup_s=setup_s, window=win, trace=traced,
               program_trace=program_trace, traced_at=traced_at,
               memory_peak_bytes=memory_peak, device=device, stream=stream, refs=refs,
               last=t - 1, flushes=flushes, n_updates=n_updates, outputs=outputs)
    t_check = time.perf_counter()
    ctx.update(recheck(ctx))
    ctx["check_s"] = time.perf_counter() - t_check
    ctx["numbers"]["captured_in_window"] = captured_in_window
    return ctx


def program_window(node, stream: Stream, start: int, traffic: dict, cuda: bool):
    """The program-traced window (``spans.py``): ``node`` fed from stream
    position ``start`` for ``spans.SECONDS`` with the program's tracer on,
    then flushed. Returns the ``spans.Traced`` window and the loop's
    ``Window``; ``(None, None)`` for a program without the tracer."""
    prog = spans.tracer()
    if prog is None:
        return None, None
    held = node.keyframes_device_bytes
    prog.enable(events=spans.EVENTS if cuda else 0)
    try:
        w = drive(node, stream, start, traffic, cuda, seconds=spans.SECONDS)
        node.flush()
        if cuda:
            torch.cuda.synchronize()
    finally:
        prog.disable()
    rec = prog.take()
    tw = spans.Traced(spans=rec.spans, counters=rec.counters, window=rec.window,
                      loop=threading.get_ident(), frames=w.fed, held_bytes=held,
                      anchor_error_ns=rec.anchor_error_ns, dropped=rec.dropped)
    spans.report(tw)
    return tw, w


def keyframe_frames(ctx: dict, k: int, n: int | None = None) -> list:
    """Bank indices of keyframe ``k`` as the program filed it: its
    reference frame, then its ``n`` update frames (the program's count
    of a keyframe it delivered)."""
    r = ctx["refs"][k]
    n = ctx["n_updates"][k] if n is None else n
    return [ctx["stream"].index(p) for p in range(r, r + 1 + n)]


def replay(ctx: dict, frames: list, precision: str = "fp32", observe=None,
           denoised: bool = True, on_update=None) -> dict:
    cell, bank = ctx["cell"], ctx["stream"].bank
    state, den = ref_engine.replay_keyframe(
        bank.images, bank.poses, bank.bounds, frames,
        ref_engine.Camera(**cell.config["camera"]), Config(**cell.config["remode"]),
        ctx["device"], precision, observe, denoised, on_update)
    return dict(mu=state.mu.cpu().numpy(), conv=state.conv.cpu().numpy(),
                denoised=None if den is None else den.cpu().numpy(),
                depth_range=float(state.scene.depth_range))


def recheck(ctx: dict) -> dict:
    """The reference's side. Every sampled keyframe is recomputed and
    compared, and the keyframe still open at the end is replayed too; over
    each the switch policy runs on the reference's state, and the sweeps
    of the updates in the traced window are counted. Returns ``numbers``,
    the reference's keyframes (``references``) and ``sweep_bound_ms``, the
    least time of the traced window's sweeps (None without a trace)."""
    cell, refs, n_updates = ctx["cell"], ctx["refs"], ctx["n_updates"]
    cfg = Config(**cell.config["remode"])
    cam = cell.config["camera"]
    traced = ctx["traced_at"]
    readings, references, bounds, off = [], {}, {}, 0
    todo = [(k, n_updates[k]) for k in sorted(ctx["outputs"])]
    if len(refs) > len(n_updates):   # the keyframe that was still open
        todo.append((len(refs) - 1, ctx["last"] - refs[-1]))
    for k, n in todo:
        r = refs[k]
        policy = check.SwitchPolicy(cell.config["policy_stride"], cfg.ref_compl_perc,
                                    cfg.max_dist_from_ref, cam["width"] * cam["height"],
                                    [f - r for f in ctx["flushes"] if f > r], n)

        def observe(j, p, r=r):
            if r + 1 + j in traced:
                bounds[r + 1 + j] = frame_bound_ms(p, cfg)

        got = ctx["outputs"].get(k)
        ref = replay(ctx, keyframe_frames(ctx, k, n), observe=observe if len(traced) else None,
                     denoised=got is not None, on_update=policy)
        if got is None:
            off += policy.at is not None
            continue
        off += policy.at != n
        if policy.at is None or policy.at == n:   # the replay ran all n updates
            references[k] = ref
            readings.append(check.compare(got, ref))
    numbers = check.worst(readings)
    numbers["switches_off"] = off
    numbers["frames_misfiled"] = check.misfiled(refs, ctx["last"], n_updates)
    return dict(numbers=numbers, references=references,
                sweep_bound_ms=sum(bounds.values()) if len(traced) else None)


def result(ctx: dict, trace: bool) -> dict:
    """The result line: ``correct`` from the numbers against the
    configuration's limits, the cell's metrics, the device, and last the
    numbers compared."""
    cell = ctx["cell"]
    ok, table = check.verdict(ctx["numbers"], cell.config["limits"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    win = ctx["window"]
    failed = int(ctx["numbers"]["frames_misfiled"])
    if not ok:
        failed = max(failed, 1)
    on_gpu = torch.device(ctx["device"]).type == "cuda"
    device = {"platform": "gpu" if on_gpu else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu", "count": cell.chips,
              "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    out = {"correct": ok, "attempted": win.fed, "failed": failed, "metrics": metrics,
           "device": device}
    tr = ctx["trace"]
    if trace and tr is not None:
        device["busy_s"] = tr.busy_us() / 1e6
        device["window_s"] = (tr.window[1] - tr.window[0]) / 1e6
        out["breakdown"] = breakdown(tr)
    out["checks"] = table
    return out


def breakdown(tr: profiling.Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    stretches of the traced window by the host range that was open at
    their midpoint (the innermost; "host: other" where none was)."""
    from benchmark import stats

    ops = {}
    for name, s, e in tr.device:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    idle = sorted(stats.gaps([(s, e) for _, s, e in tr.device], *tr.window),
                  key=lambda g: g[0] - g[1])[:500]
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    outer = [h for h in host if h[0] in LABELS]
    by = {}
    for s, e in idle:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        inner = [h for h in host[max(0, i - 400):i] if mid < h[2]]
        inner = inner or [h for h in outer if h[1] <= mid < h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host: other"
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return {"device_ops": sorted(ops.items(), key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(by.items(), key=lambda x: -x[1])[:top]}


def control_readings(cell: Cell, ctx: dict, precision: str) -> dict:
    """The control's numbers: the sampled keyframes recomputed by the
    reference in ``precision`` in the program's place, against the float32
    reference."""
    readings = []
    for k, want in ctx["references"].items():
        readings.append(check.compare(replay(ctx, keyframe_frames(ctx, k), precision), want))
    return check.worst(readings)
