"""The cells on the card: each runs through ``run.py`` as the driver runs
it, traced and untraced, and comes out correct with every metric it
reports.  Needs a CUDA card; skips without one (decided in the test)."""

import json
import subprocess
import sys

import pytest

from benchmark import cells
from benchmark.cells import ROOT

from tiny import cell_names


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cell_names())
def test_cell_runs_correct_on_the_card(name, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "4242424242", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    cell = cells.load(name)
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) <= {m["name"] for m in wanted}
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert len(r["breakdown"]["device_ops"]) <= 10
    else:
        assert set(r["metrics"]) == {m["name"] for m in wanted}


def test_no_card_no_result():
    """Without a card (or where this machine has none) run.py prints no
    result and exits with a code other than 0."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fd8_z.contour",
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
