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
for name in ("utils.checkpoint", "utils.native", "utils.encoding", "gadget", "circuits",
             "plonk", "utils.asset_gen", "ops.ntt", "prover_cuda", "fri", "serialize",
             "aggregate", "fri_cuda"):
    assert "hades252_tpu_torch." + name in names, name
from hades252_tpu_torch.utils import checkpoint, encoding, native
assert encoding.scalar_from_bytes(encoding.scalar_to_bytes(5)) == 5
assert checkpoint.highest_saved_level("no-such-directory", 2, 16) is None
assert native._opt_payload()  # the port's own schedule, without the JAX package
from hades252_tpu_torch import plonk, prover_cuda
from hades252_tpu_torch.gadget import Composer, Constraint
c = Composer()
a = c.append_witness(3)
c.gate_mul(Constraint().mult(1).a(a).b(a))
key = plonk.preprocess(c)
proof, = prover_cuda.prove_batched([c], key, device="cpu")
assert plonk.verify(key, proof, [g.pi for g in c.gates])
from hades252_tpu_torch import fri, serialize
c.append_gate(Constraint().left(1).a(a).public(-3))
pk, vk = fri.preprocess_succinct(c, fri.FriParams(blowup=4, n_queries=6, final_degree=16,
                                                  pow_bits=2))
succinct = serialize.proof_from_bytes(serialize.proof_to_bytes(fri.prove_succinct(c, pk), vk), vk)
assert fri.verify_succinct(vk, succinct, [g.pi for g in c.gates])
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the package: the cipher, the checkpoint, the native
    # binding, the host proof layers, the NTT, the batched prover and the
    # succinct argument with its codecs, aggregation and card seam
    assert int(proc.stdout.strip()) >= 28


def test_kat_gate_on_cpu_takes_the_plain_path():
    from hades252_tpu_torch.ops import perm_cuda

    perm_cuda.reset_launches()
    assert selftest.verify_device("cpu") == []
    assert perm_cuda.launches == {s: 0 for s in perm_cuda.SCHEDULES}
