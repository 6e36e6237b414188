"""Roofline accounting in field multiplications and `torch.profiler`
traces: the counterpart of `hades252_tpu/utils/profiling.py`.

The permutation's work is fixed by the algorithm:

    field muls / permutation = 1972  (297 S-box + 1675 MDS)

The schedules execute fewer machine multiplies (sparse partial rounds,
tensor-core constant products), but the metric is defined against the
algorithmic 1972, so that numbers stay comparable across backends and with
other implementations.
"""

from __future__ import annotations

import contextlib
import os

import torch

#: Algorithmic field multiplications per permutation
MULS_PER_PERM = 1972


def roofline_report(perms_per_sec: float) -> dict[str, float]:
    """Throughput -> field multiplications a second and the wall time of
    one in ns: a hardware-independent way to compare with other 255-bit
    Montgomery multiply implementations."""
    muls_per_sec = perms_per_sec * MULS_PER_PERM
    return {
        "perms_per_sec": float(perms_per_sec),
        "field_muls_per_sec": muls_per_sec,
        "ns_per_field_mul": 1e9 / muls_per_sec if muls_per_sec else float("inf"),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with `torch.profiler` (the host, and the card where
    there is one) and write it as a Chrome trace, `log_dir/trace.json`
    (Perfetto or chrome://tracing read it). Yields the profiler, whose
    `events()` and `key_averages()` the caller may read after the block.
    Where profiling cannot start, it raises."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
