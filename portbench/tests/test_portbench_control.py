"""The comparison fails what it has to: the float8 control in the
program's place, and the timed path broken underneath a whole run (a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced)."""
import time

import pytest
import torch

from portbench import harness
from portbench.faults import FAULTS
from portbench.run import Context

DATA = harness.BENCH / "tests" / "data"
CPU = torch.device("cpu")
SEEDS = [2**31 + 11, 2**31 + 12]


@pytest.mark.parametrize("cell", ["tiny-sd2-ddim", "tiny-wukong-dpm", "tiny-wukong-ft",
                                  "tiny-sd2-serve"])
def test_control_fails(cell):
    c = harness.resolve(cell, DATA)
    rows = harness.traffic_kind(c.traffic["kind"]).calibrate(c, SEEDS[:1], SEEDS, CPU)
    limits = c.cell["limits"]
    for r in rows:
        over = [k for k, lim in limits.items() if r[k] > lim]
        assert (r["side"] == "control") == bool(over), r


def _run(cell):
    c = harness.resolve(cell, DATA)
    return harness.traffic_kind(c.traffic["kind"]).run(
        Context(c, SEEDS[0], 0.3, False, CPU, time.monotonic()))


@pytest.mark.parametrize("cell,fault", [
    ("tiny-sd2-ddim", "unchanged_ddim"), ("tiny-sd2-ddim", "half_unet"),
    ("tiny-sd2-ddim", "altered_image"), ("tiny-wukong-dpm", "unchanged_dpm"),
    ("tiny-wukong-dpm", "half_unet"), ("tiny-wukong-dpm", "altered_image"),
    ("tiny-sd2-serve", "unchanged_dpm"), ("tiny-sd2-serve", "half_unet"),
    ("tiny-sd2-serve", "altered_image"), ("tiny-wukong-ft", "unchanged_step"),
    ("tiny-wukong-ft", "half_batch")])
def test_fault_is_not_correct(cell, fault):
    with FAULTS[fault]():
        assert not _run(cell).correct
    assert _run(cell).correct          # restored
