"""Whole runs of the two cells of the note-membership configuration's PR on
the CPU at a tiny size, as `test_hbench_run.py` runs the first four: each
correct, refused under the control, and refused under the faults of the
batched prover's timed path (a proof altered, half of a batch left out, the
warm-up's proofs returned again).

The membership cell runs at height 2 over 4 populated leaves (one level
opened above the built tree, 1,973 gates, n = 2,048); `plonk-preimage-978.batch64`
at a batch of 4 from 8."""

from __future__ import annotations

import pytest
from test_hbench_run import _prove_altered, _prove_half, _prove_stale, cpu_run

TINY = {
    "plonk-membership-a4-h17.batch8": {"leaves": 4, "height": 2, "gates": 1973, "domain": 2048,
                                       "batch": 2, "pool": 4, "trace_steps": 1},
    "plonk-preimage-978.batch64": {"batch": 4, "pool": 8, "trace_steps": 1},
}

FAULTS = {"answer altered": _prove_altered, "half left out": _prove_half,
          "state unchanged": _prove_stale}


@pytest.mark.parametrize("trace", [0, 1])
def test_membership_correct(monkeypatch, trace):
    name = "plonk-membership-a4-h17.batch8"
    result = cpu_run(monkeypatch, name, trace=trace, traffic=TINY[name])
    assert result["correct"] is True and list(result["checks"]) == ["proofs_wrong"]
    want = {"idle_share.prove", "device_ms_per_proof", "host_launches_per_proof"} if trace \
        else {"setup_s", "proofs_per_s"}
    assert set(result["metrics"]) == want


def test_batch64_correct(monkeypatch):
    name = "plonk-preimage-978.batch64"
    result = cpu_run(monkeypatch, name, traffic=TINY[name])
    assert result["correct"] is True and set(result["metrics"]) == {"setup_s", "proofs_per_s"}


@pytest.mark.parametrize("name", list(TINY))
def test_control_is_not_correct(monkeypatch, name):
    result = cpu_run(monkeypatch, name, control=True, traffic=TINY[name])
    assert result["correct"] is False
    assert result["checks"]["proofs_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", list(TINY))
def test_batch_faults(monkeypatch, name, fault):
    from hades252_tpu_torch import prover_cuda

    monkeypatch.setattr(prover_cuda, "prove_batched", FAULTS[fault](prover_cuda.prove_batched))

    def hook(drv):
        if name == "plonk-preimage-978.batch64":
            drv.steps = 1                    # the window starts at the pool's second batch
            drv.checked = list(range(4, 8))  # and the check holds that batch

    result = cpu_run(monkeypatch, name, hook=hook, traffic=TINY[name])
    assert result["correct"] is False
