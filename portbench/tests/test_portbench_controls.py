"""Each cell's control at a size a test run holds comes out as not correct
under the cell's limits.  The control is the precision below the
configuration's: for bf16 training the reference in fp8 (e4m3 operands,
e5m2 gradients).  The same control at the cell's own size:
portbench/control.py on the card; PERF.md gives its readings."""

import time

import pytest
import torch

from conftest import SEED, cells, tiny_cell
from portbench.harness import runner, train_check
from portbench.reference import model as ref_model

TRAIN = [c for c in cells() if c.endswith("train_b16")]


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fails(name):
    """fp8 in the program's place fails the cell's limits at this size, as
    it does at the cell's own size on the card (PERF.md gives those
    readings)."""
    cell = tiny_cell(name)
    tc = cell.config["train"]
    reals = train_check.real_pool(SEED, 3, tc["batch_size"],
                                  cell.model["size"])
    ref = train_check.reference_readings(cell.config, SEED, reals, "cpu")
    ctrl = train_check.reference_readings(
        cell.config, SEED, reals, "cpu",
        quant=ref_model.Quant(8, "all", "fp8"))
    run = runner.Run(cell=cell, seed=SEED, seconds=0, trace=False,
                     device=torch.device("cpu"), t_start=time.perf_counter())
    train_check.judge(run, ctrl, ref)
    assert not run.correct, run.compared
