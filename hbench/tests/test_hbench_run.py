"""Whole runs of the harness on the CPU at a tiny size: the result's line,
the refusals, and `correct` coming out false under the control and under
each fault of the timed path that a cell can have (an answer altered where
it is produced, half of a batch left out, a step that leaves its state
unchanged). One card and no exchange between cards: that fault has no
place here.

The look for a card is skipped (`run.run(..., device=cpu)`); the package's
kernels then run their plain versions."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from hbench import run

CPU = torch.device("cpu")
TINY = {
    "merkle-a4-h17.build": {"leaves": 16, "height": 4, "pool": 2, "trace_steps": 1},
    "merkle-a4-h17.openings": {"leaves": 64, "height": 5, "batch": 8, "batches": 2,
                               "tamper_share": 0.25, "trace_steps": 1},
    "plonk-preimage-978.batch16": {"batch": 2, "pool": 4, "trace_steps": 1},
}


def cpu_run(monkeypatch, name: str, *, hook=None, control=False, trace=0, traffic=None):
    orig = run.cell

    def tiny(cell):
        bench, work, conf = orig(cell)
        small = traffic or TINY[cell]
        work["traffic"].update(small)
        conf.update({k: v for k, v in small.items() if k in conf})
        return bench, work, conf

    monkeypatch.setattr(run, "cell", tiny)
    args = run.parse(["--workload", name, "--seed", "4294967311", "--seconds", "0.2",
                      "--trace", str(trace)])
    code, result = run.run(args, device=CPU, driver_hook=hook, control=control)
    assert code == 0
    return result


# ---------------------------------------------------------------------------
# The result's line and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(monkeypatch, trace):
    result = cpu_run(monkeypatch, "merkle-a4-h17.build", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {"idle_share.build", "glue_ms_per_tree"} if trace else \
        {"setup_s", "leaves_per_s", "root_s_p95"}
    assert want <= set(result["metrics"])
    assert list(result["checks"]) == ["roots_wrong"]
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = run.main(["--workload", "merkle-a4-h17.build", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "CUDA device" in out.err


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "hades252_tpu_torch_lookalike", types.ModuleType("x"))
    assert "hades252_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in run.forbidden_modules()


def test_alone_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and hbench/, a run exits
    with another code than 0 and prints no result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "hbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "hbench/run.py", "--workload", "merkle-a4-h17.build",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


# ---------------------------------------------------------------------------
# The control and the faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TINY))
def test_control_is_not_correct(monkeypatch, name):
    result = cpu_run(monkeypatch, name, control=True)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _wrap(module, **broken):
    """The driver's handle on a package module, with some functions broken."""
    ns = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module)
                                  if not k.startswith("__")})
    for k, fn in broken.items():
        setattr(ns, k, fn(getattr(module, k)))
    return ns


def _flip_digit(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[0] ^= 1
    return x


MERKLE_FAULTS = {
    "answer altered": dict(merkle_levels=lambda f: lambda leaves, *a: (
        lambda lv: lv[:-1] + [_flip_digit(lv[-1])])(f(leaves, *a))),
    "half left out": dict(merkle_levels=lambda f: lambda leaves, *a: f(torch.cat(
        [leaves[: len(leaves) // 2], torch.zeros_like(leaves[len(leaves) // 2:])]), *a)),
    "state unchanged": dict(merkle_levels=lambda f: lambda leaves, *a: f(leaves, lambda s: s)),
}


@pytest.mark.parametrize("fault", list(MERKLE_FAULTS))
def test_build_faults(monkeypatch, fault):
    def hook(drv):
        drv.merkle = _wrap(drv.merkle, **MERKLE_FAULTS[fault])

    assert cpu_run(monkeypatch, "merkle-a4-h17.build", hook=hook)["correct"] is False


def _verify_half(f):
    def verify(root, leaves, sibs, poss, height, *a):
        k = leaves.shape[0] // 2
        out = torch.zeros(leaves.shape[0], dtype=torch.bool)
        out[:k] = f(root, leaves[:k], sibs[:k], poss[:k], height, *a)
        return out
    return verify


OPENINGS_FAULTS = {
    "answer altered": dict(merkle_verify_batched=lambda f: lambda *a: ~f(*a)),
    "half left out": dict(merkle_verify_batched=_verify_half),
    "state unchanged": dict(merkle_verify_batched=lambda f: lambda r, lv, s, p, h: f(
        r, lv, s, p, h, lambda st: st)),
    "sibling altered": dict(merkle_open_batched=lambda f: lambda lv, idx: (
        lambda sp: (_flip_digit(sp[0]), sp[1]))(f(lv, idx))),
}


@pytest.mark.parametrize("fault", list(OPENINGS_FAULTS))
def test_openings_faults(monkeypatch, fault):
    def hook(drv):
        drv.merkle = _wrap(drv.merkle, **OPENINGS_FAULTS[fault])

    assert cpu_run(monkeypatch, "merkle-a4-h17.openings", hook=hook)["correct"] is False


def _prove_altered(f):
    def prove(composers, key, **kw):
        proofs = f(composers, key, **kw)
        for p in proofs:
            p.t = [(p.t[0] + 1)] + list(p.t[1:])
        return proofs
    return prove


def _prove_half(f):
    def prove(composers, key, **kw):
        half = f(composers[: len(composers) // 2], key, **kw)
        return half + half
    return prove


def _prove_stale(f):
    """Every call returns the proofs of the first (the warm-up's batch)."""
    held = []

    def prove(composers, key, **kw):
        if not held:
            held.extend(f(composers, key, **kw))
        return list(held)
    return prove


@pytest.mark.parametrize("fault", ["answer altered", "half left out", "state unchanged"])
def test_batch_faults(monkeypatch, fault):
    from hades252_tpu_torch import prover_cuda

    broken = {"answer altered": _prove_altered, "half left out": _prove_half,
              "state unchanged": _prove_stale}[fault]
    monkeypatch.setattr(prover_cuda, "prove_batched", broken(prover_cuda.prove_batched))

    def hook(drv):
        drv.steps = 1                        # the window starts at the pool's second batch
        drv.checked = [2, 3]                 # and the check holds that batch

    result = cpu_run(monkeypatch, "plonk-preimage-978.batch16", hook=hook)
    assert result["correct"] is False


# ---------------------------------------------------------------------------
# The succinct cell, on a circuit of 11 gates (the preimage circuit's 978 at
# the prod preset take minutes on the CPU): the same driver, reference and
# checks, with the circuit swapped on both sides.
# ---------------------------------------------------------------------------

SUCCINCT = {"pool": 2, "checked_proofs": 2, "trace_steps": 1,
            "preset": {"blowup": 2, "n_queries": 2, "final_degree": 2, "pow_bits": 0, "zk": False}}


def _squares(words, image):
    """The package's circuit: each word squared, bound to its square."""
    from hades252_tpu_torch.gadget import Composer, Constraint

    c = Composer()
    for w in words:
        sq = c.gate_mul(Constraint().mult(1).a(c.append_witness(w)).b(c.append_witness(w)))
        c.append_gate(Constraint().left(1).a(sq).public(-(w * w)))
    return c


def _squares_ref(words, image):
    from hbench.reference import plonk as pl

    cs = pl.Composer()
    for w in words:
        sq = cs.add(pl.Gate(q_m=1), a=cs.witness(w), b=cs.witness(w))
        g = pl.Gate(q_l=1, pi=(-(w * w)) % pl.P)
        g.wires = [sq, 0, 0, 0]
        cs.gates.append(g)
    return cs


def succinct_run(monkeypatch, **kw):
    from hbench.drivers import plonk_batch
    from hbench.reference import plonk as pl

    monkeypatch.setattr(plonk_batch, "composer", _squares)
    monkeypatch.setattr(pl, "preimage_circuit", _squares_ref)
    orig = run.cell

    def small(cell):
        bench, work, conf = orig(cell)
        conf.update(gates=11, domain=16)
        return bench, work, conf

    monkeypatch.setattr(run, "cell", small)
    return cpu_run(monkeypatch, "plonk-preimage-978.succinct-prod", traffic=SUCCINCT, **kw)


def test_succinct_correct(monkeypatch):
    result = succinct_run(monkeypatch)
    assert result["correct"] is True and list(result["checks"]) == ["proofs_wrong"]


def test_succinct_control(monkeypatch):
    assert succinct_run(monkeypatch, control=True)["correct"] is False


def _succinct_altered(f):
    def prove(*a, **kw):
        proof = f(*a, **kw)
        proof.evals["a"] = (proof.evals["a"] + 1) % (2**255)
        return proof
    return prove


def _succinct_stale(f):
    held = []

    def prove(*a, **kw):
        if not held:
            held.append(f(*a, **kw))
        return held[0]
    return prove


@pytest.mark.parametrize("fault", ["answer altered", "state unchanged"])
def test_succinct_faults(monkeypatch, fault):
    from hades252_tpu_torch import fri_cuda

    broken = {"answer altered": _succinct_altered, "state unchanged": _succinct_stale}[fault]
    monkeypatch.setattr(fri_cuda, "prove_succinct_device",
                        broken(fri_cuda.prove_succinct_device))

    def hook(drv):
        drv.steps = 1                        # the window starts at the pool's second instance

    assert succinct_run(monkeypatch, hook=hook)["correct"] is False
