"""Every cell runs end to end at a tiny width on the CPU and prints the
result line the contract asks for."""

import json

import pytest

from conftest import cells, run_tiny, tiny_cell

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def check_line(out: dict, cell, trace: bool) -> None:
    keys = list(out)
    assert keys[:5] == list(REQUIRED)
    assert keys[-1] == "compared"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "compared"}
    json.loads(json.dumps(out, allow_nan=False))
    allowed = {m["name"]: m["unit"] for m in
               (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= set(allowed)
    for name, m in out["metrics"].items():
        assert m["unit"] == allowed[name]
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", cells())
def test_cell_runs_and_is_correct_in_float32(name):
    """At float32 the program and the reference agree, so the run is
    correct under the cell's limits; every end-to-end metric is there."""
    cell = tiny_cell(name, dtype="float32")
    out, run = run_tiny(cell)
    check_line(out, cell, trace=False)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", cells())
def test_traced_run_reports_per_layer_metrics(name):
    cell = tiny_cell(name, dtype="float32")
    out, run = run_tiny(cell, trace=True, seconds=2.0)
    check_line(out, cell, trace=True)
    assert run.traced is not None and run.traced.window_s > 0
    # on the CPU no kernel runs: kernel rooflines find nothing to read
    assert not any(k.endswith("roofline") for k in out["metrics"])


@pytest.mark.parametrize("name", cells())
def test_same_seed_same_inputs(name):
    """The inputs come from the seed alone: two set-ups of one seed hand the
    program the same weights and the same schedule or batches."""
    from portbench.harness import weights

    cell = tiny_cell(name)
    a, _ = weights.make(cell.model, 5, "cpu")
    b, _ = weights.make(cell.model, 5, "cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert (x == y).all(), k
