"""On the card: a short run of each cell is correct, and the control, the
plain reference with TF32 matrix products (the nearest precision below the
configuration's float32 with TF32 off) put in the program's place, is not.
``python3 -m benchmark.control`` takes the same readings on many seeds,
from which the limits were set."""

import pytest
import torch

from benchmark import check, harness


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["over_table_640.offline", "live_752.camera30",
                                  "over_table_640.forward"])
def test_program_passes_and_control_fails(cuda, cell):
    c = harness.load_cell(cell)
    ctx = harness.run_cell(c, 2**31 + 101, 3.0, False, cuda)
    limits = c.config["limits"]
    ok, table = check.verdict(ctx["numbers"], limits)
    assert ok, table
    out = harness.result(ctx, False)
    assert list(out)[-1] == "checks" and out["device"]["platform"] == "gpu"
    assert {m["name"] for m in c.end_to_end} == set(out["metrics"])
    control = harness.control_readings(c, ctx, "tf32")
    assert not check.verdict(control, limits)[0], control
