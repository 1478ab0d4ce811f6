"""One run of one cell: set-up and window by the cell's traffic driver, the
reference check, the metrics by their readers, the result line.

A traffic driver is ``portbench/traffic/<kind>.py`` with ``run(run)``; a
metric is ``portbench/metrics/<name>.py`` with ``read(run)``, which returns
a number or ``None`` when it finds nothing to read.  Both are found by the
names in the data files, so a new cell, traffic kind or metric is a new
file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time

import numpy as np
import torch

from portbench.harness import cell as cell_mod

BENCH = cell_mod.BENCH
FORBIDDEN = ("jax", "jaxlib", "flax", "transeditor_tpu")


@dataclasses.dataclass
class Run:
    cell: cell_mod.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                      # perf_counter at process start
    setup_s: float | None = None
    window_s: float | None = None
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    traced: object = None               # trace.TraceSummary
    data: dict = dataclasses.field(default_factory=dict)
    compared: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)

    def compare(self, name: str, value: float, where: str = "") -> None:
        """Record a compared number beside its limit from the cell file."""
        limit = self.cell.limits[name]
        value = float(value)
        if not value <= 1e30:              # NaN and inf print as 1e30
            value = 1e30
        self.compared[name] = {"value": value, "limit": float(limit)}
        if where:
            self.notes.append(f"{name}: worst at {where}")

    def record(self, numbers: dict) -> None:
        """Compare each of ``numbers`` ({name: (value, where)}) that the
        cell sets a limit for; note the readings of the others."""
        for name, (value, where) in numbers.items():
            if name in self.cell.limits:
                self.compare(name, value, where)
            else:
                self.notes.append(f"reading {name} {value!r} (no limit; "
                                  f"not compared) at {where}")

    @property
    def correct(self) -> bool:
        ok = all(c["value"] <= c["limit"] for c in self.compared.values())
        return ok and self.failed == 0 and bool(self.compared)

    def window_start(self) -> None:
        """Set-up ends here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = int(max(
                torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count())))


def derive(seed: int, *words) -> int:
    """A 63-bit seed derived from the run's seed and ``words``."""
    key = [abs(int(seed)), int(seed) < 0] + [
        int.from_bytes(str(w).encode(), "little") % (2 ** 63) for w in words]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
               >> 1)


def load_file(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no {kind} file {path.relative_to(BENCH.parent)}")
    key = f"portbench_{kind}_{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(run: Run) -> dict:
    """Drive the cell and read its metrics; returns the result line."""
    driver = load_file("traffic", run.cell.kind)
    driver.run(run)
    entries = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = {}
    for m in entries:
        value = load_file("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": run.cell.chips, "memory_peak_bytes": run.memory_peak}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.traced is not None:
        device["busy_s"] = run.traced.busy_s
        device["window_s"] = run.traced.window_s
        out["breakdown"] = run.traced.breakdown()
    out["compared"] = run.compared
    return out


def report(out: dict, run: Run) -> None:
    """The notes, then each compared number beside its limit as the last
    lines of standard error; the result as the last line of standard
    output."""
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, c in run.compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
