"""The port loads and runs where JAX and the JAX package cannot be imported,
as on the GPU host."""

import os
import subprocess
import sys
from pathlib import Path

import torch

from hades252_tpu_torch import selftest

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["hades252_tpu"] = None
import hades252_tpu_torch
names = ["hades252_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(hades252_tpu_torch.__path__, "hades252_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its main does not run on import
assert not any(k == "jax" or k.startswith(("jax.", "hades252_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 12  # every module of the package


def test_kat_gate_on_cpu_takes_the_plain_path():
    from hades252_tpu_torch.ops import perm_cuda

    perm_cuda.reset_launches()
    assert selftest.verify_device("cpu") == []
    assert perm_cuda.launches == {"naive": 0, "opt": 0}
