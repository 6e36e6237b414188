"""Where a cell's steps go by the program's own stages, and what the spans
cost.

    python3 hbench/stages.py --workload <cell> --seed <n> [--steps k] [--rounds r]

from the root of a checkout, on a card. After the cell's driver has set up
(as `run.py` does), it runs `rounds` times k steps with the spans off and k
steps with `metrics.enable()` (host clock a step, and the spans' calls, host
seconds and CUDA-event device ms), then k steps under `torch.profiler` as
`tracing.trace_steps` does, and reads that slice twice: `tracing.summarize`
(busy time, launches, the idle gaps by host span) and `spans.attribute`
(device time by the program span that launched it), with the delta of
`perm_cuda.states` over it. It prints one JSON object: those numbers, the
per-layer metrics that `spans.METRICS`' readers give on the slice, the
benchmark's per-layer metrics of the cell on the same slice (with the last
block of untraced steps as the window), and for a succinct cell each traced
proof's states against `succinct_states`. It checks no output: `run.py`
does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from hbench import run, spans, tracing  # noqa: E402


def tree_states(b: int, npos: int, bs: int) -> int:
    """States of `fri_cuda._block_tree_body` over (b, npos, bs) blocks: one
    a block and sponge chunk of 4 values, then every node of the arity-4
    tree over npos leaves padded to a power of 4."""
    h = 0
    while 4 ** h < npos:
        h += 1
    return b * (npos * max(1, -(-bs // 4)) + (4 ** h - 1) // 3)


def succinct_states(n: int, params, nonces: list) -> int:
    """States that `fri_cuda.prove_succinct_device_batch` hands the kernels
    for len(nonces) instances of a circuit of domain n at `params` (not zk),
    whose grinding found `nonces`: the w, z and t paired-block trees, the
    FRI phase (a challenge a fold, and on each committed layer its tree and
    the absorb of its root) and one window of candidates a round of
    grinding until every instance has its nonce."""
    from hades252_tpu_torch import fri

    if params.zk:
        raise ValueError("succinct_states counts the plain (not zk) prover")
    sch = fri.proof_schema(n, params)
    b, m0 = len(nonces), sch["m0"]
    total = sum(tree_states(b, m0 // 2, 2 * cols) for cols in (4, 1, 1))
    total += b * sch["n_folds"]
    for k, bs in sch["sched"]:
        total += tree_states(b, (m0 >> k) // bs, bs) + b
    if params.pow_bits:
        window = max(4096, min(2 << params.pow_bits, 1 << 17))
        total += b * window * (max(nonces) // window + 1)
    return total


def _smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def _steps(drv, k: int) -> list:
    out = []
    for _ in range(k):
        t0 = time.perf_counter()
        work = drv.step()
        out.append((t0, time.perf_counter(), work))
    return out


def measure(args, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hades252_tpu_torch.ops import perm_cuda
    from hades252_tpu_torch.utils import metrics

    bench, work, conf = run.cell(args.workload)
    drivers = run.load_module(HERE / "drivers" / f"{work['driver']}.py", work["driver"])
    drv = drivers.Driver(conf, work["traffic"], args.seed, device)
    off, on = [], []
    metrics.reset()
    for _ in range(args.rounds):
        off.append(_steps(drv, args.steps))
        metrics.enable()
        try:
            on.append(_steps(drv, args.steps))
        finally:
            metrics.disable()
    enabled = metrics.snapshot()
    metrics.reset()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    works, walls, nonces = [], [], []
    before = dict(perm_cuda.states)
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            with record_function(tracing.STEP):
                works.append(drv.step())
            walls.append(time.perf_counter() - t0)
            if work["driver"] == "plonk_succinct":
                nonces.append(drv.proofs[-1][1].pow_nonce)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    states = {s: perm_cuda.states[s] - before[s] for s in perm_cuda.SCHEDULES}
    t0 = time.perf_counter()
    evs = list(spans.events(prof))
    traced = tracing.summarize([e[:5] for e in evs], works)
    traced["spans"], traced["states"] = spans.attribute(evs), states
    read_s = time.perf_counter() - t0
    ctx = {"setup_s": None, "steps": off[-1], "traced": traced, "driver": drv}
    per_layer = {m["name"]: run.load_module(HERE / "metrics" / f"{m['name']}.py", m["name"])
                 .read(ctx) for m in run.metrics_of(bench, args.workload, True)}
    new = {name: read(ctx) for name, (read, cells) in spans.METRICS.items()
           if args.workload in cells}
    out = {"cell": args.workload, "seed": args.seed, "card": _smi(),
           "step_s": {"off": [e - s for blk in off for s, e, _ in blk],
                      "enabled": [e - s for blk in on for s, e, _ in blk], "traced": walls},
           "work_a_step": statistics.fmean(w for blk in off for _, _, w in blk),
           "enabled_spans": enabled["spans"], "enabled_work": sum(w for blk in on
                                                                   for _, _, w in blk),
           "traced": traced, "read_s": read_s, "per_layer": per_layer, "new_per_layer": new}
    if nonces:
        from hades252_tpu_torch import fri

        want = sum(succinct_states(drv.vk.n, fri.FriParams(**drv.preset), [v]) for v in nonces)
        out["states_check"] = {"nonces": nonces, "counted": sum(states.values()),
                               "from_shapes": want}
    drv.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("hbench.stages: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(measure(args, torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
