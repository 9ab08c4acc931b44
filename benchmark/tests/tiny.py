"""Cells of ``BENCHMARK.json`` cut to a size that a CPU test can hold: the
same files, mix and limits, with fewer block rows and columns."""

from __future__ import annotations

import copy

from benchmark import cells

TINY = {
    "fd8_z": {"rsb": 1.75, "rtb": 4.75},
}


def tiny_cell(name: str) -> cells.Cell:
    cell = copy.deepcopy(cells.load(name))
    cell.config.update(TINY[cell.config["name"]])
    return cell


def cell_names() -> list:
    return [w["name"] for w in cells.benchmark()["workloads"]]
