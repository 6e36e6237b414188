"""Counters for the models.

Port of the counter API of `hades252_tpu/utils/metrics.py`: a
process-global registry of monotonic counters, no-ops unless `enable()`
was called. The models call `count()` at host-level call sites, once per
batched call.
"""

from __future__ import annotations

from collections import defaultdict

_enabled = False
_counters: dict[str, int] = defaultdict(int)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _counters.clear()


def count(name: str, n: int = 1) -> None:
    """Increment a monotonic counter (no-op unless enabled)."""
    if _enabled:
        _counters[name] += int(n)


def snapshot() -> dict[str, dict[str, int]]:
    """Current counters (a copy)."""
    return {"counters": dict(_counters)}
