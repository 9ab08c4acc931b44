"""The port's parity CLI (``python -m tfqmrgpu_tpu_torch.bench``) in its
``tfQMR`` mode on a small FD problem file, on the CPU (``TFQ_DEVICE=cpu``):
'z', 'c' and 'm' each return 0 and print the status line; 'm' reaches the
file's tolerance of 1e-9, which 'c' cannot, so it ran the mixed path (the
JAX package's CLI maps 'm' to 'c')."""

import re
import subprocess
import sys
import pathlib

import pytest

from tfqmrgpu_tpu_torch import bench
from tfqmrgpu_tpu_torch.generator import generate_fd_problem
from tfqmrgpu_tpu_torch.io.xmlio import write_xml

STATUS = re.compile(r"# converged: status=(\d+) iterations=(\d+) "
                    r"residuum=(\S+)")


@pytest.fixture(scope="module")
def fd_file(tmp_path_factory):
    prob = generate_fd_problem(rtb=3.75, reference=True)
    assert prob.tolerance == 1e-9
    path = tmp_path_factory.mktemp("cli") / "FD_example.xml"
    write_xml(prob, str(path))
    return str(path)


def _run(capsys, monkeypatch, *argv):
    monkeypatch.setenv("TFQ_DEVICE", "cpu")
    rc = bench.main(list(argv))
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("precision", ["z", "c", "m"])
def test_tfqmr_mode(capsys, monkeypatch, fd_file, precision):
    rc, out = _run(capsys, monkeypatch, "tfQMR", fd_file, precision, "1",
                   "400")
    assert rc == 0, out
    status, iters, residuum = STATUS.search(out).groups()
    assert "# deviation from reference solution" in out
    assert "TFlop/s" in out
    if precision == "c":
        assert float(residuum) > 1e-9          # float32 stalls above it
    else:
        assert int(status) == 0 and float(residuum) <= 1e-9
    assert ("# mixed: c stage" in out) == (precision == "m")


def test_run_tfqmr_reports_the_mixed_path(fd_file):
    run = bench.run_tfqmr(fd_file, "m", max_iterations=400, echo=0,
                          device="cpu")
    assert run.rc == 0 and run.gate == bench.GATE_F64
    assert run.maxdev < bench.GATE_F64
    r = run.info.refinement
    assert r["c_iterations"] < run.info.iterations_needed and r["rounds"] >= 1
    assert run.info.residuum_reached <= 1e-9


def test_multi_mode_and_unknown_mode(capsys, monkeypatch):
    rc, out = _run(capsys, monkeypatch, "multi", "plan.txt")
    assert rc != 0 and "not ported" in out
    rc, _ = _run(capsys, monkeypatch, "nosuchmode")
    assert rc != 0


def test_module_entry_point(fd_file):
    """``python -m tfqmrgpu_tpu_torch.bench`` in a process of its own."""
    root = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, "-m", "tfqmrgpu_tpu_torch.bench", "tfQMR", fd_file,
         "z", "1", "400"], cwd=root, capture_output=True, text=True,
        timeout=300, env={"TFQ_DEVICE": "cpu", "PATH": "/usr/bin:/bin",
                          "PYTHONPATH": str(root)})
    assert res.returncode == 0, res.stderr[-2000:]
    assert STATUS.search(res.stdout).group(1) == "0"
