"""step_ms_reg.train: mean host-clock time of the training steps with R1
and/or path length, each step synchronised, over the traced run's first
cadence period (so in the cadence's proportion: one R1 + path step to three
path steps)."""

import statistics


def read(run):
    ms = (run.data.get("step_ms") or {}).get("reg")
    return statistics.mean(ms) if ms else None
