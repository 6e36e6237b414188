"""The program's spans in a traced slice: which stage of hades252_tpu_torch
launched each device operation.

The package marks its stages with `utils/metrics.span`; while
`torch.profiler` records, each span is a `record_function` annotation on
the host, on the same clock as the device's operations. The profiler pairs
each device operation with the host call that launched it by a correlation
id: a kernel with its `cudaLaunchKernel`, a copy with its `cudaMemcpyAsync`,
and every kernel of a CUDA graph's replay with the one `cudaGraphLaunch`.
So an operation belongs to the program spans open on the launching thread
at the launch, whenever it ran.

`attribute` gives, for each span name:
- `device_ms`: the device time of the operations launched inside the span,
  at any depth;
- `self_ms`: those launched where it is the innermost program span, and
  `self_own_ms` the part of them in the package's own kernels (`hades_`);
- `launches`: the host's kernel and graph launch calls inside it;
- `calls`: the span's occurrences; `host_ms`: their host time, less the
  time in `*.fetch` spans inside them (the host waiting for a copy back);
- `idle_ms`: the time the device was idle while it was the innermost
  program span open on the host (the gaps between the device's
  operations, from the first `hbench.step` span's start to the last one's
  end, or over the device's operations where there is none);
and `outside_ms`, the device time launched outside every program span
(the harness's own work), `idle_outside_ms`, the idle time under no
program span, and `unlinked_ms`, the device time of operations whose
launch the trace does not hold.

The readers at the end take a run's context (`readers.py`) whose traced
slice holds `spans` (this attribution) and `states` (the delta of
`perm_cuda.states` over the traced steps); each returns None where the
slice has no spans, as a program without them gives.
"""

from __future__ import annotations

import re

from hbench.tracing import STEP

#: The program's span names start with one of these (its layers).
PREFIXES = ("merkle.", "perm.", "graph.", "prove.", "fri.", "dist.")
FETCH = ".fetch"
OWN_KERNEL = "hades_"
#: CUDA runtime and driver calls (the host side of a correlation)
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")


def events(prof):
    """(name, on_device, start_ns, end_ns, is_annotation, correlation id,
    thread) of every event of a finished profiler, read from its kineto
    results."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA, start, start + e.duration_ns(),
               e.is_user_annotation(), e.correlation_id(), e.start_thread_id())


def _stacks(spans: list, launches: list) -> dict:
    """The names of the program spans open at each launch, outermost
    first: spans (start, end, name, thread), launches (time, thread,
    correlation) -> {correlation: names}. Spans of one thread nest (they
    are context managers), so one sweep a thread keeps the open ones."""
    by_thread: dict = {}
    for s, e, name, tid in spans:
        by_thread.setdefault(tid, []).append((s, 0, e, name))
    for t, tid, corr in launches:
        by_thread.setdefault(tid, []).append((t, 1, corr, None))
    out = {}
    for items in by_thread.values():
        items.sort(key=lambda x: (x[0], x[1]))
        open_: list = []
        for t, kind, value, name in items:
            while open_ and open_[-1][0] < t:
                open_.pop()
            if kind == 0:
                open_.append((value, name))
            else:
                out[value] = tuple(n for _, n in open_)
    return out


def attribute(evs) -> dict:
    """The spans' numbers (see the module's docstring) from `events`' tuples."""
    spans, steps, device = [], [], []
    runtime: dict = {}
    for name, on_device, start, end, note, corr, tid in evs:
        if on_device:
            if not note:
                device.append((start, end, name, corr))
        elif note:
            if name.startswith(PREFIXES):
                spans.append((start, end, name, tid))
            elif name == STEP:
                steps.append((start, end))
        elif _RUNTIME.match(name):
            runtime[corr] = (start, tid, name.startswith(_LAUNCH_CALLS))
    stacks = _stacks(spans, [(t, tid, corr) for corr, (t, tid, _) in runtime.items()])
    out: dict = {}

    def entry(name):
        return out.setdefault(name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                     "self_ms": 0.0, "self_own_ms": 0.0, "launches": 0,
                                     "idle_ms": 0.0})

    for corr, (_, _, launch) in runtime.items():
        if launch:
            for name in set(stacks[corr]):
                entry(name)["launches"] += 1
    outside = unlinked = 0
    for start, end, name, corr in device:
        ns = end - start
        stack = stacks.get(corr) if corr in runtime else None
        if stack is None:
            unlinked += ns
        elif not stack:
            outside += ns
        else:
            for s in set(stack):
                entry(s)["device_ms"] += ns / 1e6
            inner = entry(stack[-1])
            inner["self_ms"] += ns / 1e6
            if OWN_KERNEL in name:
                inner["self_own_ms"] += ns / 1e6
    _host_ms(spans, entry)
    idle_outside = _idle_ms(spans, steps, device, entry)
    return {"by_span": out, "outside_ms": outside / 1e6, "idle_outside_ms": idle_outside / 1e6,
            "unlinked_ms": unlinked / 1e6}


def _host_ms(spans: list, entry) -> None:
    """Each name's calls and host time: the time of its outermost
    occurrences (a name inside itself counts once), less the `*.fetch`
    spans inside them."""
    spans = sorted(spans, key=lambda x: (x[3], x[0], -x[1]))
    fetches = [(s, e, tid) for s, e, n, tid in spans if n.endswith(FETCH)]
    reach: dict = {}
    for s, e, name, tid in spans:
        got = entry(name)
        got["calls"] += 1
        if s < reach.get((name, tid), s):
            continue
        reach[(name, tid)] = e
        waited = 0 if name.endswith(FETCH) else \
            sum(fe - fs for fs, fe, ft in fetches if ft == tid and s <= fs and fe <= e)
        got["host_ms"] += (e - s - waited) / 1e6


def _idle_ms(spans: list, steps: list, device: list, entry) -> int:
    """Add each device idle gap's time to the innermost program span open
    on the host over it, piece by piece (the spans of the thread that has
    most of them); returns the idle ns under none."""
    if steps:
        lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    elif device:
        lo, hi = min(s for s, *_ in device), max(e for _, e, *_ in device)
    else:
        return 0
    gaps, reach = [], lo
    for s, e, *_ in sorted(device):
        if s > reach and s > lo:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, min(e, hi))
    if hi > reach:
        gaps.append((reach, hi))
    tids = [tid for *_, tid in spans]
    tid = max(set(tids), key=tids.count) if tids else None
    # the innermost span as segments (start, end, name or None) in time order
    bounds = sorted([(s, 1, -e, n) for s, e, n, t in spans if t == tid]
                    + [(e, 0, 0, None) for s, e, n, t in spans if t == tid])
    segments, open_, at = [], [], lo
    for t, kind, neg_e, name in bounds:
        segments.append((at, t, open_[-1][1] if open_ else None))
        at = t
        if kind:
            open_.append((-neg_e, name))
        else:
            while open_ and open_[-1][0] <= t:
                open_.pop()
    segments.append((at, hi, open_[-1][1] if open_ else None))
    outside, i = 0, 0
    for a, b in gaps:
        while i < len(segments) and segments[i][1] <= a:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < b:
            s, e, name = segments[j]
            part = min(b, e) - max(a, s)
            if part > 0:
                if name is None:
                    outside += part
                else:
                    entry(name)["idle_ms"] += part / 1e6
            j += 1
    return outside


# ---------------------------------------------------------------------------
# Readers of the per-layer metrics
# ---------------------------------------------------------------------------


def _traced(ctx):
    t = ctx.get("traced")
    return t if t is not None and t.get("spans") is not None else None


def _by(t, name: str, key: str) -> float:
    return t["spans"]["by_span"].get(name, {}).get(key, 0.0)


def stage_reader(names: tuple, key: str, per: str):
    """A reader: the sum of `key` over the spans `names`, a unit of work
    (per="work") or a step (per="step"), or None without spans."""
    def read(ctx):
        t = _traced(ctx)
        if t is None:
            return None
        total = sum(_by(t, n, key) for n in names)
        return total / (sum(t["works"]) if per == "work" else t["n_steps"])
    return read


def wrapper_glue_ms_per_step(ctx):
    """Device ms a step of the operations the permutation's wrapper launches
    itself (layout copies, conversions) and that are not its kernels."""
    t = _traced(ctx)
    if t is None:
        return None
    return (_by(t, "perm.call", "self_ms") - _by(t, "perm.call", "self_own_ms")) / t["n_steps"]


def states_per_work(ctx):
    """States handed to the permutation kernels a unit of work."""
    t = _traced(ctx)
    if t is None or t.get("states") is None:
        return None
    return sum(t["states"].values()) / sum(t["works"])


host_stop_ms_per_proof = stage_reader(("prove.host", "fri.host"), "host_ms", "work")
grand_product_ms_per_proof = stage_reader(("prove.phase2",), "device_ms", "work")
deep_ms_per_proof = stage_reader(("fri.deep",), "device_ms", "work")
tree_ms_per_proof = stage_reader(("fri.commit",), "device_ms", "work")
convert_ms_per_tree = stage_reader(("merkle.convert",), "device_ms", "step")

#: The per-layer metrics these readers give, by name, and the cells they read.
METRICS = {
    "host_stop_ms_per_proof": (host_stop_ms_per_proof,
                               ("plonk-preimage-978.batch16", "plonk-preimage-978.succinct-prod")),
    "grand_product_ms_per_proof": (grand_product_ms_per_proof,
                                   ("plonk-preimage-978.batch16",
                                    "plonk-preimage-978.succinct-prod")),
    "deep_ms_per_proof": (deep_ms_per_proof, ("plonk-preimage-978.succinct-prod",)),
    "tree_ms_per_proof": (tree_ms_per_proof, ("plonk-preimage-978.succinct-prod",)),
    "convert_ms_per_tree": (convert_ms_per_tree, ("merkle-a4-h17.build",)),
    "wrapper_glue_ms.build": (wrapper_glue_ms_per_step, ("merkle-a4-h17.build",)),
    "wrapper_glue_ms.openings": (wrapper_glue_ms_per_step, ("merkle-a4-h17.openings",)),
    "perm_states_per_proof": (states_per_work, ("plonk-preimage-978.succinct-prod",)),
}
