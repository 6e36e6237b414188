"""The port's examples (`hades252_tpu_torch/examples/`) run on the CPU in a
subprocess where JAX and the JAX package cannot be imported, as on the GPU
host: every verdict line true, the known first word of perm([1..5])."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PERM_LINE = "perm([1..5])[0] = 0x5082aaf0060eeafea9119f97d3fb7b92be07825ab67ec37b8d2df57c1c64080c"

_RUN = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["hades252_tpu"] = None
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
assert not any(k == "jax" or k.startswith(("jax.", "hades252_tpu."))
               for k, v in sys.modules.items() if v is not None)
"""


def _run(argv, timeout_s, python_path=ROOT):
    env = dict(os.environ, PYTHONPATH=str(python_path), OMP_NUM_THREADS="1")
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout_s)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.splitlines()


def _example(name, *args):
    return _run([sys.executable, "-c", _RUN, f"hades252_tpu_torch.examples.{name}", *args], 240)


def _verdicts(lines):
    return [ln for ln in lines if "True" in ln or "False" in ln]


def test_quickstart_on_the_cpu():
    lines = _example("quickstart", "--device", "cpu")
    verdicts = _verdicts(lines)
    assert PERM_LINE in lines and len(verdicts) == 10
    assert not any("False" in ln for ln in verdicts)
    assert "batched: (8, 5, 16)" in lines
    assert "device verification entry points: [True, True] | aggregate: True" in lines


def test_multichip_merkle_on_cpu_ranks():
    lines = _example("multichip_merkle", "--device", "cpu", "--ranks", "2")
    assert lines[:3] == ["256 leaves over 2 devices: roots match",
                         "checkpoint/resume: roots match", "--- metrics ---"]
    assert "perms.executed: 170" in lines and "dist.collective_bytes: 128" in lines


@pytest.mark.parametrize("name", ["quickstart", "multichip_merkle"])
def test_examples_need_the_card_by_default(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", f"hades252_tpu_torch.examples.{name}"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.slow
def test_quickstart_prints_the_jax_examples_lines():
    """The JAX quickstart beside the port's: the same lines, each up to its
    parenthesis (the zk proofs' sizes follow their random blinding)."""
    jax_lines = _run([sys.executable, "examples/quickstart.py"], 600)
    port = _example("quickstart", "--device", "cpu")
    assert [ln.split(" (")[0] for ln in jax_lines] == [ln.split(" (")[0] for ln in port]
