"""A traced span of the window, reduced in memory to what the readers use.

``torch.profiler`` (CPU and CUDA activities; nothing is written to disk)
records the span; the raw kineto events are then reduced once:

* ``busy_s``: the union of every device interval (kernels, copies, sets)
  inside the span, so overlapping streams count once;
* ``kernels``: device seconds and launches by name;
* ``idle_gaps``: the device's idle intervals inside the span, each named by
  the innermost host operation running at its midpoint (a harness span
  ``bench.*`` or an ``aten::`` op), or ``host: no torch op`` where the host
  ran Python or numpy alone.

The span's bounds are the harness's own ``bench.traced`` annotation, read
from the same trace, so the device and host clocks agree.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict            # name -> [seconds, launches]
    idle_gaps: dict          # host activity -> seconds idle

    def seconds(self, *patterns: str) -> tuple[float, int]:
        """Device seconds and launches of kernels whose name holds any of
        ``patterns``."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if any(p in name for p in patterns):
                s += sec
                n += cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short(k), v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


class Traced:
    """``with Traced(device) as t: ...`` profiles the block, synchronised at
    both ends; ``t.reduce()`` then returns the summary (call it once the
    window has closed: the reduction takes host time)."""

    def __init__(self, device: torch.device):
        self.device = device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function("bench.traced")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> TraceSummary:
        summary = reduce_events(self._prof.profiler.kineto_results.events())
        del self._prof
        return summary


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so its first start (CUPTI's
    set-up, seconds) falls in set-up and not in the traced span."""
    with Traced(device) as t:
        torch.zeros(1, device=device).add_(1)
    t.reduce()


def reduce_events(events, min_gap_ns: int = 20_000) -> TraceSummary:
    from torch.autograd import DeviceType

    lo = hi = None
    dev, host = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == "bench.traced":
                lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
            elif name.startswith("bench.") or name.startswith("aten::"):
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             name))
        elif e.duration_ns() > 0 and not _annotation(e, name):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if lo is None:
        raise RuntimeError("the traced span's annotation is not in the trace")

    kernels: dict = {}
    spans = []
    for s, t, name in dev:
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) / 1e9
        k[1] += 1
        spans.append((s, t))
    spans.sort()
    busy, gaps, cur = 0, [], lo
    run_s = run_t = None
    for s, t in spans:
        if run_t is None or s > run_t:
            if run_t is not None:
                busy += run_t - run_s
            run_s, run_t = s, t
        else:
            run_t = max(run_t, t)
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if run_t is not None:
        busy += run_t - run_s
    if hi > cur:
        gaps.append((cur, hi))

    host.sort()
    starts = [h[0] for h in host]
    idle: dict = {}
    for a, b in gaps:
        if b - a < min_gap_ns:
            label = "gaps under 20 us"
        else:
            label = _host_at((a + b) // 2, host, starts)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                        kernels=kernels, idle_gaps=idle)


def _annotation(e, name: str) -> bool:
    """A span of annotations mirrored on the device's timeline, not work."""
    return (e.is_user_annotation() or name.startswith("bench.")
            or name.startswith("aten::"))


def _host_at(m: int, host: list, starts: list, look: int = 400) -> str:
    """The innermost host event running at ``m``."""
    i = bisect.bisect_right(starts, m)
    best = None
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        s, t, name = host[j]
        if t >= m and (best is None or t - s < best[0]):
            best = (t - s, name)
    if best is None:
        return "host: no torch op"
    return best[1]
