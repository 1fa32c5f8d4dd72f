"""A cell of the benchmark at a size the CPU runs in seconds: the
configuration and traffic mix of a workload at 128x96, keyframes of ~8
frames. The harness runs the program's plain PyTorch versions there."""

from __future__ import annotations

from benchmark import harness


def tiny_cell(workload: str = "over_table_640.offline") -> harness.Cell:
    cell = harness.load_cell(workload)
    config = dict(cell.config)
    config["camera"] = {"width": 128, "height": 96, "fx": 96.24, "fy": -96.0, "cx": 63.5,
                        "cy": 47.5}
    config["remode"] = dict(config["remode"], max_dist_from_ref=0.05)
    config["policy_stride"] = 2
    mix = dict(cell.traffic, bank_frames=40, warmup_frames=8, check_keyframes=2, step_m=0.0115)
    if mix["loop"] == "open":
        mix["rate_hz"] = 4
    return harness.Cell(name=cell.name, config=config, traffic=mix,
                        end_to_end=cell.end_to_end, per_layer=cell.per_layer)
