"""Counters and timers for the models and the sharded paths.

Port of `hades252_tpu/utils/metrics.py`: a process-global registry of
monotonic counters and wall-clock timers, no-ops unless `enable()` was
called. The models call `count()` at host-level call sites, once per
batched call; `parallel/dist.merkle_root_sharded` times its build with
`timer()`.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_enabled = False
_counters: dict[str, int] = defaultdict(int)
_timers: dict[str, float] = defaultdict(float)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _counters.clear()
    _timers.clear()


def count(name: str, n: int = 1) -> None:
    """Increment a monotonic counter (no-op unless enabled)."""
    if _enabled:
        _counters[name] += int(n)


@contextmanager
def timer(name: str):
    """Accumulate wall-clock seconds under `name` (no-op unless enabled).

    Kernel launches are asynchronous: a block timed for its device work
    must end in a synchronisation (`torch.cuda.synchronize`)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _timers[name] += time.perf_counter() - t0


def snapshot() -> dict[str, dict[str, float]]:
    """Current counters and timers (copies)."""
    return {"counters": dict(_counters), "timers": dict(_timers)}


def report() -> str:
    """One line a metric: the counters, then the timers in seconds."""
    lines = [f"{k}: {_counters[k]}" for k in sorted(_counters)]
    lines += [f"{k}: {_timers[k]:.6f}s" for k in sorted(_timers)]
    return "\n".join(lines)
