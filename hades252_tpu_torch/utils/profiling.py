"""`torch.profiler` traces: the counterpart of
`hades252_tpu/utils/profiling.py`'s trace helper.

A trace records the program's spans (`utils/metrics.span`) as annotations
beside the host's operations and the card's, on one clock.
"""

from __future__ import annotations

import contextlib
import os

import torch


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
