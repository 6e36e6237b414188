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
             "aggregate", "fri_cuda", "parallel.dist", "parallel.multihost", "utils.roofline",
             "utils.profiling", "utils.graphs", "entry", "examples.quickstart",
             "examples.multichip_merkle"):
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
from hades252_tpu_torch import fri_cuda
from hades252_tpu_torch.ops import perm_cuda
# the device prover on CPU tensors: the plain version of the opt kernel
# (about 0.7 s a call on a CPU, so no grinding), no launch
pk, vk = fri.preprocess_succinct(c, fri.FriParams(blowup=4, n_queries=3, final_degree=8,
                                                  pow_bits=0))
perm_cuda.reset_launches()
on_cpu = fri_cuda.prove_succinct_device(c, pk, device="cpu")
assert not any(perm_cuda.launches.values())
assert serialize.proof_to_bytes(on_cpu, vk) == serialize.proof_to_bytes(fri.prove_succinct(c, pk), vk)
# the device verifiers' entry points, and the fused plan on the tiny proof's entries
assert all(callable(f) for f in (fri_cuda.prove_aggregate_device, fri_cuda.device_chain_fn,
                                 fri_cuda.fused_entries_check, fri_cuda.verify_succinct_device_batch,
                                 fri_cuda.verify_aggregate_device))
seen = []
def spy(entries):
    seen.append(fri_cuda._fused_verify_plan(entries, vk.params.n_queries))
    return fri.pooled_entries_verify(entries, fri.default_pcs_perm())
assert fri.verify_succinct_batched(vk, [on_cpu], [[g.pi for g in c.gates]], entries_check=spy)[0]
leaf_blocks, nodes_lvls, sels, root_sels, root_owner = seen[0]
assert len(leaf_blocks) == 4 + len(fri.proof_schema(vk.n, vk.params)["sched"])
assert sorted(e for slot in root_owner for e in slot) == list(range(len(leaf_blocks)))
# a world-1 gloo group: the sharded root equals the unsharded one
import socket
import numpy as np
import torch
from hades252_tpu_torch import field
from hades252_tpu_torch.models import merkle
from hades252_tpu_torch.parallel import dist, multihost
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo", timeout_s=60)
try:
    mesh = multihost.global_mesh(device="cpu")
    leaves = torch.from_numpy(field.np_random_elements((4,), np.random.default_rng(3)).astype(np.int32))
    assert torch.equal(dist.merkle_root_sharded(leaves, mesh), merkle.merkle_root(leaves))
finally:
    torch.distributed.destroy_process_group()
assert not any(k == "jax" or k.startswith(("jax.", "hades252_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    # one thread, as this process: beside the other test workers, the
    # subprocess's own pool of a thread a core oversubscribes the cores
    # (about 5x its time alone on eight cores shared with six workers)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the package: the cipher, the checkpoint, the native
    # binding, the host proof layers, the NTT, the batched prover and the
    # succinct argument with its codecs, aggregation, card seam and device
    # prover (a tiny proof through the plain version, byte-identical), the
    # device verifiers' fused plan on that proof's entries, the sharded
    # paths (a world-1 gloo Merkle root) and the tooling
    assert int(proc.stdout.strip()) >= 33


def test_kat_gate_on_cpu_takes_the_plain_path():
    from hades252_tpu_torch.ops import perm_cuda

    perm_cuda.reset_launches()
    assert selftest.verify_device(device="cpu") == []
    assert perm_cuda.launches == {s: 0 for s in perm_cuda.SCHEDULES}
