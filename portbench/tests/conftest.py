"""Shared fixtures of the benchmark's own tests: cells cut to a tiny width
for the CPU, and the card check for the tests marked ``cuda``."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import cell as cell_mod  # noqa: E402
from portbench.harness import runner  # noqa: E402

TINY = dict(size=32, style_dim=32, param_dim=32, n_trans=1, max_channels=16)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def tiny_cell(name: str, dtype: str | None = None, **params):
    """The cell at a width the CPU runs in seconds: 32px, 32-wide codes, 16
    channels, one attention block; training at batch 4 with a 4-step
    cadence."""
    c = cell_mod.load(name)
    c.config["model"].update(TINY)
    if dtype is not None:
        c.config["dtype"] = dtype
    c.config["train"].update(batch_size=4, d_reg_every=4, g_reg_every=2)
    c.params["real_batches"] = 4
    c.params.update(params)
    return c


def run_tiny(cell, trace: bool = False, seconds: float = 1.0,
             seed: int = SEED) -> tuple[dict, runner.Run]:
    run = runner.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                     device=torch.device("cpu"), t_start=time.perf_counter())
    return runner.execute(run), run


def cells() -> list:
    bench = cell_mod.load_json(ROOT / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]
