"""A short run of each cell on the card (skips without one): a result
line with the cell's end-to-end metrics and `correct` true."""

import pytest
import torch

from slambench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fleet.track64", "multipass.replay32"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = run.load_cell(cell)
    out = run.run_cell(spec, 77, 1.0, False)
    assert out["correct"], out["checks"]
    assert {m["name"] for m in spec["end_to_end"]} <= set(out["metrics"])
