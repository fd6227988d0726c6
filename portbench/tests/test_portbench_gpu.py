"""On the card: each cell runs briefly from a fresh seed and comes out
correct.  ``python -m pytest portbench/tests -q -m gpu`` there."""

import io
import json
import time

import pytest

from portbench.core import harness, loader


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  loader.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cuda, cell):
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", "4000000017",
                       "--seconds", "2", "--trace", "0"],
                      time.perf_counter(), device=cuda, out=out)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
