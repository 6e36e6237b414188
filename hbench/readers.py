"""The arithmetic the metric readers under `hbench/metrics/` share.

A reader takes the run's context: `setup_s`, `steps` (host-clock start, end
and work of each step of the window), `traced` (`tracing.summarize`'s
numbers of the traced steps, or None), `driver`. It returns a number, or
None where the run has nothing for it to read (the harness then leaves the
metric out).
"""

from __future__ import annotations

import statistics

from hbench import roofline


def setup(ctx) -> float:
    return ctx["setup_s"]


def rate(ctx) -> float:
    """Work a second over the whole window: every step's work over the time
    from the first step's start to the last one's end."""
    steps = ctx["steps"]
    return sum(w for _, _, w in steps) / (steps[-1][1] - steps[0][0])


def p95_s(ctx) -> float:
    """The 95th percentile of the steps' host-clock latencies."""
    lat = [e - s for s, e, _ in ctx["steps"]]
    return statistics.quantiles(lat, n=20, method="inclusive")[-1] if len(lat) > 1 else lat[0]


def step_s(ctx) -> float:
    """The untraced window's host-clock time a step."""
    steps = ctx["steps"]
    return (steps[-1][1] - steps[0][0]) / len(steps)


def idle_share(ctx):
    """1 - the device's busy time a traced step over the untraced window's
    time a step. The profiler records every host operation and stretches
    the steps of a host-bound cell (it about doubles a batch of openings)
    but not the device's work, so the traced steps' own host window would
    read the profiler's cost as idle."""
    t = ctx["traced"]
    return None if t is None else 1 - t["busy_s"] / t["n_steps"] / step_s(ctx)


def perm_roofline(ctx):
    """The least time of the permutations the traced steps needed, over the
    device time of the package's own kernels in them, in %."""
    t = ctx["traced"]
    if t is None or t["own_kernel_s"] <= 0:
        return None
    perms = ctx["driver"].perms_per_step * t["n_steps"]
    return 100 * roofline.least_perm_s() * perms / t["own_kernel_s"]


def glue_ms_per_step(ctx):
    t = ctx["traced"]
    return None if t is None else 1e3 * t["glue_s"] / t["n_steps"]


def launches_per_step(ctx):
    t = ctx["traced"]
    return None if t is None else (t["kernel_launches"] + t["graph_launches"]) / t["n_steps"]


def device_ms_per_work(ctx):
    t = ctx["traced"]
    return None if t is None else 1e3 * t["busy_s"] / sum(t["works"])


def launches_per_work(ctx):
    t = ctx["traced"]
    return None if t is None else (t["kernel_launches"] + t["graph_launches"]) / sum(t["works"])
