"""step_ms_plain.train: median host-clock time of a plain training step (no
R1, no path length), each step synchronised, over the traced run's first
cadence period."""

import statistics


def read(run):
    ms = (run.data.get("step_ms") or {}).get("plain")
    return statistics.median(ms) if ms else None
