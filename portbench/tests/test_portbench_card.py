"""On the card only (marked ``cuda``; skipped here): one short run of each
cell ``BENCHMARK.json`` lists, through the benchmark's command.

    python -m pytest portbench/tests -m cuda -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import cell as cell_mod

LISTED = [w["name"] for w in
          cell_mod.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", LISTED)
def test_cell_runs_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 3), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], out.stderr[-2000:]
