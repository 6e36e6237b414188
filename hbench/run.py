"""One run of one cell of the benchmark of hades252_tpu_torch.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell
(`hbench/workloads/<cell>.json`) names its configuration
(`hbench/configs/<config>.json`), its driver (`hbench/drivers/<driver>.py`)
and its traffic. The run:

1. sets up: imports, the driver's inputs made on the card from the seed, the
   program's keys and the warm-up of the cell's own shapes (`setup_s`, from
   the start of this process to the first timed step);
2. runs whole steps, one client in a closed loop, until `--seconds` have
   passed; each step ends with its result read back on the host;
3. with `--trace 1`, traces a few more steps with `torch.profiler`;
4. reads the card's peak memory, frees the program's state and holds the
   outputs the driver kept to the plain reference under `hbench/reference/`;
5. prints each number compared beside its limit on standard error, and as
   the last line of standard output one JSON object: `correct`, `attempted`,
   `failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
   its per-layer ones, each read by `hbench/metrics/<name>.py`), `device`,
   with `--trace 1` `breakdown`, and last `checks`.

It exits with another code than 0, and prints no result, where there is no
card, or too few, or where JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "hades252_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the harness found by file name (a metric's name holds dots)."""
    spec = importlib.util.spec_from_file_location(f"hbench_{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's workload file, its configuration file)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"hbench: no cell {name!r} in BENCHMARK.json")
    work = load_json(HERE / "workloads" / f"{name}.json")
    if work["config"] != entry["config"]:
        raise SystemExit(f"hbench: {name}: the workload file names {work['config']!r}")
    conf = load_json(HERE / "configs" / f"{entry['config']}.json")
    return bench, work, conf


def metrics_of(bench: dict, name: str, trace: bool) -> list[dict]:
    """The cell's metrics: end-to-end without the trace, per-layer with it."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def window(drv, seconds: float) -> list[tuple[float, float, int]]:
    """Whole steps until `seconds` have passed: (start, end, work) each.
    Prints the steps' spread and the collector's pauses in the window on
    standard error (what a rate's spread from run to run is looked for in)."""
    steps, pauses = [], {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
    began = [0.0]

    def collected(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            pauses[info["generation"]][0] += 1
            pauses[info["generation"]][1] += time.perf_counter() - began[0]

    gc.callbacks.append(collected)
    try:
        start = time.perf_counter()
        while not steps or steps[-1][1] - start < seconds:
            t0 = time.perf_counter()
            work = drv.step()
            steps.append((t0, time.perf_counter(), work))
    finally:
        gc.callbacks.remove(collected)
    lat = [e - s for s, e, _ in steps]
    print(f"hbench: window: {len(steps)} steps, s a step: mean {statistics.fmean(lat):.6f}, "
          f"stdev {statistics.pstdev(lat):.6f}, min {min(lat):.6f}, "
          f"median {statistics.median(lat):.6f}, max {max(lat):.6f}; collections (count, s) "
          + ", ".join(f"gen{g} {n} {t:.4f}" for g, (n, t) in pauses.items()), file=sys.stderr)
    return steps


def _allocator(torch, device) -> dict:
    """The CUDA caching allocator's counts of device allocations, frees and
    retries (a free on the device waits for it), or {} on the CPU."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                         "num_alloc_retries", "num_sync_all_streams")}


def run(args, *, device=None, driver_hook=None, control=False) -> tuple[int, dict | None]:
    """The run; returns (exit code, the result or None). `device` other than
    None skips the look for a card (the harness's own tests drive a run on
    the CPU at a small size); `driver_hook` may break the driver's timed
    path underneath (the same tests); `control` judges the control's outputs
    (the reference one partial round short) in the program's place
    (`hbench/control.py`)."""
    bench, work, conf = cell(args.workload)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "hbench" / "triton"))
    import torch

    from hbench import tracing

    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"hbench: the cell needs {chips} CUDA device(s), found {found}", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    drivers = load_module(HERE / "drivers" / f"{work['driver']}.py", work["driver"])
    drv = drivers.Driver(conf, work["traffic"], args.seed, device)
    if driver_hook is not None:
        driver_hook(drv)
    setup_s = time.perf_counter() - _T0
    before = _allocator(torch, device)
    steps = window(drv, args.seconds)
    after = _allocator(torch, device)
    if after:
        print("hbench: window: the caching allocator's " + ", ".join(
            f"{k} {after[k] - before[k]}" for k in after), file=sys.stderr)
    traced = None
    if args.trace:
        traced = tracing.trace_steps(drv, int(work["traffic"].get("trace_steps", 3)), device)
    dev = device_info(torch, chips) if device.type == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    drv.release()
    t0 = time.perf_counter()
    checks, failed = drv.check(drv.control()) if control else drv.check()
    print(f"hbench: {len(steps)} steps; the reference's check took {time.perf_counter() - t0:.1f} s"
          + (f"; the trace's reading {traced['read_s']:.1f} s" if traced else ""), file=sys.stderr)
    ctx = {"setup_s": setup_s, "steps": steps, "traced": traced, "driver": drv}
    values = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", m["name"])
        v = reader.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(steps) + (traced["n_steps"] if traced else 0),
              "failed": failed, "metrics": values, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return 0, result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    code, result = run(args)
    if result is None:
        return code
    found = forbidden_modules()
    if found:
        print(f"hbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"hbench check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())
