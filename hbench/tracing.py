"""The traced slice of a run: a few steps under `torch.profiler`.

Each step runs inside a host span `hbench.step` (`record_function`). From
the profiler's events this keeps what the per-layer readers under
`hbench/metrics/` need:

- the window: the host clock from the first step's start to the last one's
  end (so host time before, between and after the device work counts),
  which the profiler stretches where the host launches many small
  operations; the idle share (`readers.idle_share`) therefore sets the
  busy time a traced step against the untraced window's time a step;
- busy: the union of the device operations' intervals inside the window;
- the device time of the package's own kernels (names holding `hades_`) and
  of every other device operation (the plain-torch glue, copies);
- the host's launch calls: `cudaLaunchKernel` / `cuLaunchKernel` (and their
  `Ex` forms) and `cudaGraphLaunch` (one for a whole graph replay);
- a breakdown: the device operations that took most time, and the idle gaps
  of the device by what the host was doing then (the innermost host span).
"""

from __future__ import annotations

import bisect
import time

STEP = "hbench.step"
OWN_KERNEL = "hades_"
_KERNEL_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
_GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def _events(prof):
    """(name, is_device, start_ns, end_ns, is_annotation) of every event,
    read from the profiler's kineto results (the public `prof.events()`
    builds a Python object an event, too slow for a proof's 124,000
    launches)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA, start, start + e.duration_ns(),
               e.is_user_annotation())


def summarize(events, works: list[int]) -> dict:
    """The slice's numbers from `_events`' tuples and the steps' work."""
    steps, device, host, kernels, graphs = [], [], [], 0, 0
    for name, on_device, start, end, note in events:
        if name == STEP:
            if not on_device:
                steps.append((start, end))
            continue
        if on_device:
            if not note:
                device.append((start, end, name))
            continue
        if name.startswith(_KERNEL_CALLS):
            kernels += 1
        elif name.startswith(_GRAPH_CALLS):
            graphs += 1
        host.append((start, end, name))
    if not steps:
        raise RuntimeError("the trace holds no step span")
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi)
    busy, reach, gaps = 0, lo, []
    own = glue = 0
    by_op: dict[str, int] = {}
    for s, e, n in device:
        if s > reach:
            gaps.append((reach, s))
        busy += max(0, e - max(s, reach))
        reach = max(reach, e)
        if OWN_KERNEL in n:
            own += e - s
        else:
            glue += e - s
        by_op[n] = by_op.get(n, 0) + (e - s)
    if hi > reach:
        gaps.append((reach, hi))
    return {"n_steps": len(steps), "works": works, "window_s": (hi - lo) / 1e9,
            "busy_s": busy / 1e9, "own_kernel_s": own / 1e9, "glue_s": glue / 1e9,
            "kernel_launches": kernels, "graph_launches": graphs,
            "breakdown": {"device_ops": _top(by_op), "idle_gaps": _top(_gaps_by_host(gaps, host))}}


def _top(by_name: dict) -> list:
    return [[n, t / 1e9] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]


def _gaps_by_host(gaps, host) -> dict:
    """Each idle gap's length, under the innermost host span open at its
    middle (the one that began last of the 64 before it), or "host, no
    traced call" where none was."""
    host = sorted(host)
    starts = [s for s, _, _ in host]
    out: dict[str, int] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        name = "host, no traced call"
        i = bisect.bisect_right(starts, mid)
        for hs, he, hn in reversed(host[max(0, i - 64):i]):
            if he >= mid:
                name = hn
                break
        out[name] = out.get(name, 0) + (e - s)
    return out


def trace_steps(drv, n: int, device) -> dict:
    """Run n steps of the driver under the profiler and summarize them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    works = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            with record_function(STEP):
                works.append(drv.step())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = summarize(_events(prof), works)
    out["read_s"] = time.perf_counter() - t0
    return out
