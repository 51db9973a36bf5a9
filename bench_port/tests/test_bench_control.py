"""The control of each cell, the reference in the next lower precision
(TF32 for a float32 stage, float8 operands for a bfloat16 one) put in the
program's place, comes out not correct: at least one of the cell's numbers
passes its limit, while the program's own stay within theirs. Run at a
tiny size; it needs the card (TF32 exists only there), and skips without
one."""

import pytest

from bench_port import harness
from bench_port.calibrate import readings
from bench_port.tests.tiny import tiny

CELLS = sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json"))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    w, c = tiny(cell)
    limits = w["limits"]
    for seed in (21, 22, 23):
        r = readings(cell, seed, 0.5, device=card, workload=w, config=c)
        assert any(r["control"][k] > limits[k] or r["control"][k] != r["control"][k]
                   for k in limits), r
        assert all(r["program"][k] <= limits[k] for k in limits), r
