"""A cell as the data files describe it: ``BENCHMARK.json``'s entry, the
cell's own file ``portbench/workloads/<cell>.json`` and its configuration's
``portbench/configs/<config>.json``.  Everything is found by name."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    kind: str                 # the traffic driver: portbench/traffic/<kind>.py
    params: dict              # the traffic's parameters
    limits: dict              # the correctness limits, by compared number
    config: dict              # the configuration file
    end_to_end: list          # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load(cell_name: str, bench: dict | None = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    spec = load_json(BENCH / "workloads" / f"{cell_name}.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf["file"])
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, cell_name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, cell_name, names)]
    return Cell(name=cell_name, chips=int(entry["chips"]),
                kind=spec["kind"], params=spec["params"],
                limits=spec["limits"], config=config, end_to_end=e2e,
                per_layer=per_layer)
