"""Counters and spans for the models, the provers and the sharded paths.

Started as the port of `hades252_tpu/utils/metrics.py`: a process-global
registry of monotonic counters, no-ops unless `enable()` was called. The
models call `count()` at host-level call sites, once per batched call.

`span(name)` marks a stage of the program (a layer boundary: a tree level,
a prover phase, a host stop). It costs one check when nothing records:
- while `torch.profiler` records, the span is a `record_function`
  annotation, on the profiler's own clock, so that a trace can attribute
  each device operation and each idle gap of the device to a stage;
- after `enable()`, the span adds its host seconds and a call count under
  its name and, on a card outside a graph capture, records a pair of CUDA
  events on the current stream, so `snapshot()` also gives the card's
  stream time from each span's start to its end, without a profiler.

A span inside a CUDA graph's body runs only at the capture; a replay is
timed by the span around it (`graph.replay`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_enabled = False
_counters: dict[str, int] = defaultdict(int)
#: name -> [calls, host seconds, device ms of the resolved CUDA event pairs]
_spans: dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
#: (name, start event, end event) whose device time is not read yet, oldest first
_pending: list = []
#: pairs kept unresolved before the oldest finished ones are read
_PENDING_CAP = 4096

_profiling = torch.autograd._profiler_enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _counters.clear()
    _spans.clear()
    _pending.clear()


def count(name: str, n: int = 1) -> None:
    """Increment a monotonic counter (no-op unless enabled)."""
    if _enabled:
        _counters[name] += int(n)


#: The span where nothing records.
_OFF = contextlib.nullcontext()


class _Span:
    def __init__(self, name: str, annotate: bool):
        self.name = name
        self._note = torch.profiler.record_function(name) if annotate else None
        self._events = self._t0 = None

    def __enter__(self):
        if self._note is not None:
            self._note.__enter__()
        if _enabled:
            if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _enabled and self._t0 is not None:
            entry = _spans[self.name]
            entry[0] += 1
            entry[1] += time.perf_counter() - self._t0
            if self._events is not None:
                self._events[1].record()
                _pending.append((self.name, *self._events))
                if len(_pending) > _PENDING_CAP:
                    _resolve(wait=False)
        if self._note is not None:
            self._note.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks the stage `name` (see the module's
    docstring); it does nothing unless metrics are enabled or a profiler
    records."""
    annotate = _profiling()
    if not (_enabled or annotate):
        return _OFF
    return _Span(name, annotate)


def _resolve(wait: bool) -> None:
    """Add the device time of the pending event pairs to their spans: all of
    them (waiting for the card), or only the finished ones at the front."""
    done = 0
    for name, start, end in _pending:
        if wait:
            end.synchronize()
        elif not end.query():
            break
        _spans[name][2] += start.elapsed_time(end)
        done += 1
    del _pending[:done]


def snapshot() -> dict:
    """Current counters and spans (copies): {"counters": {name: n},
    "spans": {name: {"calls", "host_s", "device_ms"}}}. Waits for the card
    once where spans recorded CUDA events."""
    _resolve(wait=True)
    return {"counters": dict(_counters),
            "spans": {k: {"calls": c, "host_s": h, "device_ms": d}
                      for k, (c, h, d) in _spans.items()}}


def report() -> str:
    """One line a metric: the counters, then the spans."""
    snap = snapshot()
    lines = [f"{k}: {v}" for k, v in sorted(snap["counters"].items())]
    lines += [f"{k}: {s['calls']} calls, host {s['host_s']:.6f}s, device {s['device_ms']:.3f}ms"
              for k, s in sorted(snap["spans"].items())]
    return "\n".join(lines)
