"""The port's tooling: `utils/roofline.py` (the H100's bound on each
permutation kernel, moved out of chip_smoke.py), `utils/profiling.py`
(`torch.profiler` traces) and the counters and spans of `utils/metrics.py`,
against the JAX package's `metrics` and the bounds PERF.md records."""

import json

import pytest
import torch

from hades252_tpu.utils import metrics as jmetrics
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.utils import metrics, profiling, roofline

#: PERF.md's bounds at B = 2^14 (T / C / M ms, then the bound), rounded to
#: 4 places as PERF.md prints them.
PERF_MD_BOUNDS = {
    "naive": (0, 0.2848, 0.0031, 0.2848),
    "opt": (0, 0.1504, 0.0031, 0.1504),
    "mxu8": (0.0559, 0.1113, 0.0031, 0.1113),
    "hyb": (0.0865, 0.0626, 0.0051, 0.0865),
    "hybp": (0.0865, 0.0626, 0.0052, 0.0865),
    "mxu": (0.1119, 0.1113, 0.0032, 0.1119),
    "hyb13": (0.0865, 0.1871, 0.0051, 0.1871),
    "hybp13": (0.0865, 0.1871, 0.0052, 0.1871),
}


@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
def test_bound_keeps_the_numbers_of_perf_md(schedule):
    got = roofline.bound(schedule, 1 << 14)
    t, c, m, b = PERF_MD_BOUNDS[schedule]
    assert [round(got[k], 4) for k in ("tensor_ms", "cores_ms", "bytes_ms", "bound_ms")] == [t, c, m, b]
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == max(got["tensor_ms"], got["cores_ms"], got["bytes_ms"])


@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
def test_roofline_names_the_binding_resource_and_the_fraction(schedule):
    got = roofline.roofline(schedule, 1 << 14, measured_ms=1.0)
    binding = {"tensor_ms": "tensor cores", "cores_ms": "cuda cores", "bytes_ms": "memory"}
    want = max(binding, key=lambda k: got[k])
    assert got["binding_resource"] == binding[want]
    assert got["achieved_fraction"] == got["bound_ms"]
    assert got["ceiling_perms_per_sec"] == pytest.approx((1 << 14) / got["bound_ms"] * 1e3)
    assert "achieved_fraction" not in roofline.roofline(schedule, 1 << 14)


def test_bound_scales_with_the_batch_and_refuses_an_unknown_schedule():
    small, large = roofline.bound("opt", 1 << 10), roofline.bound("opt", 1 << 20)
    assert large["cores_ms"] == pytest.approx(small["cores_ms"] * (1 << 10))
    with pytest.raises(ValueError):
        roofline.bound("pallas", 1 << 14)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, dtype=torch.int64).cumsum(0)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_metrics_timers_and_report_take_the_jax_package_shape():
    """The counters keep the JAX package's shape; the port's spans take the
    timers' place (calls, host seconds, device ms: 0 without a card)."""
    for m in (metrics, jmetrics):
        m.reset()
        m.enable()
        try:
            m.count("dist.merkle_builds", 2)
            snap = m.snapshot()
            report = m.report().splitlines()
        finally:
            m.disable()
            m.reset()
        assert snap["counters"] == {"dist.merkle_builds": 2}
        assert report[0] == "dist.merkle_builds: 2"
    metrics.enable()
    try:
        for _ in range(2):
            with metrics.span("dist.merkle"):
                pass
        snap = metrics.snapshot()
        report = metrics.report().splitlines()
    finally:
        metrics.disable()
        metrics.reset()
    assert list(snap["spans"]) == ["dist.merkle"]
    got = snap["spans"]["dist.merkle"]
    assert got["calls"] == 2 and got["host_s"] >= 0 and got["device_ms"] == 0
    assert report == [f"dist.merkle: 2 calls, host {got['host_s']:.6f}s, device 0.000ms"]
    with metrics.span("off"):  # disabled: nothing recorded
        pass
    assert metrics.snapshot() == {"counters": {}, "spans": {}}
