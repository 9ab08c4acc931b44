"""Cells by name: ``BENCHMARK.json`` and the files it names.

A cell ``<config>.<traffic>`` is an entry of ``workloads``; its
configuration is the ``configs`` entry of that name, whose ``file`` holds
the configuration as it is run; its traffic mix's points for this
configuration are ``traffic/<traffic>/<config>.json`` beside this file.  Nothing here names a cell: a later
cell is new entries and new files.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    points: dict          # traffic/<mix>/<config>.json
    end_to_end: list      # BENCHMARK.json's metrics that this cell reports
    per_layer: list


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError if there is none."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    mix = w["traffic"]
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        points=_load(HERE / "traffic" / mix / f"{w['config']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])
