"""idle_share.train: 1 - (union of device intervals / span) over the
profiled cadence period of a training run."""


def read(run):
    t = run.traced
    if t is None or not run.data.get("traced_steps"):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
