"""The control on the card: the reference computed with TF32 on, put in the
program's place, must fail one of the cell's limits that the program
meets. Runs `calibrate.py`'s readings at each cell's own size."""

import pytest

from benchmark import calibrate
from benchmark.lib import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.read_json(
    harness.ROOT + "/BENCHMARK.json")["workloads"]])
def test_control_fails_a_limit_the_program_meets(gpu, cell):
    spec = harness.load_cell(cell)
    fn = calibrate.train_readings if spec["traffic"]["kind"] == "train_loop" \
        else calibrate.serve_readings
    out = fn(spec, 20260417, gpu)
    limits = spec["limits"]["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control_tf32"].get(k) is not None and out["control_tf32"][k] > v
               for k, v in limits.items()), out
