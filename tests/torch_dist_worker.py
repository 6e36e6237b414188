"""Gloo process groups on the CPU for tests/test_torch_dist.py and
tests/test_torch_multihost.py: `run_group` (called by a test) spawns one
process a rank, each of which runs this file,

    python tests/torch_dist_worker.py RANK WORLD HOST:PORT JOB DIR

reads DIR/inputs.pkl, joins the group through
`multihost.initialize(..., backend="gloo")`, runs JOB on a CPU mesh of
every rank and writes what it computed to DIR/JOB.RANK.pkl. A rank blocks
JAX and the JAX package before it runs its job and reports whether any of
them was loaded, as on the GPU host, which has neither.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

from hades252_tpu_torch import fri, fri_cuda, plonk, prover_cuda, serialize
from hades252_tpu_torch.gadget import Composer, Constraint
from hades252_tpu_torch.parallel import dist, multihost
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils import metrics, native

ROOT = Path(__file__).resolve().parents[1]

#: Seconds a collective waits for the other ranks: a rank that hangs fails
#: its group well inside the test's own wall limit.
TIMEOUT_S = 60


def tiny(a_val: int, b_val: int) -> Composer:
    """The JAX tests' two-gate circuit: a * b, then a + b against a public
    input."""
    c = Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(Constraint().mult(1).a(a).b(b))
    c.gate_add(Constraint().left(1).a(a).right(1).b(b).public(-((a_val + b_val) % P)))
    return c


def native_kernel(states: torch.Tensor, schedule: str) -> torch.Tensor:
    """fri_cuda's kernel seam on the native engine (the tests' swap): the
    plain PyTorch permutation takes about 0.7 s a call on a CPU."""
    out = native.perm_batch_digits(states.numpy().astype(np.uint32))
    return torch.from_numpy(out.astype(np.int32))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def roots(mesh, leaf_sets) -> list:
    """Each leaf set's sharded root, and the counters and span names of its build."""
    out = []
    for leaves in leaf_sets:
        metrics.reset()
        metrics.enable()
        root = dist.merkle_root_sharded(t(leaves), mesh)
        metrics.disable()
        snap = metrics.snapshot()
        out.append((root.numpy(), snap["counters"], sorted(snap["spans"])))
    return out


def provers(mesh, inp) -> dict:
    """prove_batched and the device succinct and aggregate provers with the
    mesh, on the instances the inputs name."""
    fri_cuda.permute_cuda = native_kernel
    cs = [tiny(a, b) for a, b in inp["instances"]]
    key = plonk.preprocess(cs[0])
    proofs = prover_cuda.prove_batched(cs, key, device="cpu", mesh=mesh)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**inp["params"]))
    succinct = fri_cuda.prove_succinct_device_batch(cs, pk, device="cpu", mesh=mesh)
    agg = fri_cuda.prove_aggregate_device(cs, pk, device="cpu", mesh=mesh)
    pis = [[g.pi for g in c.gates] for c in cs]
    return {"plonk": [(p.wires, p.z, p.t, p.commitments) for p in proofs],
            "succinct": [serialize.proof_to_bytes(p, vk) for p in succinct],
            "aggregate": serialize.aggregate_to_bytes(agg, vk),
            "verified": (list(fri_cuda.verify_succinct_device_batch(vk, succinct, pis,
                                                                    device="cpu", mesh=mesh)),
                         fri_cuda.verify_aggregate_device(vk, agg, pis, device="cpu",
                                                          mesh=mesh))}


def world2(mesh, inp) -> dict:
    out = {"roots": roots(mesh, inp["merkle"]),
           "perm": dist.permute_sharded(t(inp["perm"]), mesh).numpy(),
           "sponge": dist.sponge_hash_sharded(t(inp["msgs"]), mesh).numpy()}
    key, nonce, msg = (t(a) for a in inp["cipher"])
    ct, tag = dist.cipher_sharded(key, nonce, msg, mesh)
    pt, tag_back = dist.cipher_sharded(key, nonce, ct, mesh, decrypt=True)
    out["cipher"] = tuple(a.numpy() for a in (ct, tag, pt, tag_back))
    node, sibs, poss = inp["chain"]
    out["chain"] = dist.chain_nodes_sharded(t(node), t(sibs), torch.from_numpy(poss),
                                            mesh).numpy()
    k = inp["chain_pool"]
    out["chain_pool"] = fri_cuda.mesh_chain_fn(mesh)(node[:k], sibs[:k], poss[:k])
    out.update(provers(mesh, inp))
    return out


JOBS = {
    "merkle": lambda mesh, inp: {"roots": roots(mesh, inp["merkle"])},
    "world2": world2,
    "provers": provers,
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(job: str, world: int, inputs: dict, out_dir: Path,
              wall_s: float = 120) -> list:
    """Run JOB on a gloo group of `world` spawned ranks over `inputs`; every
    rank must finish inside wall_s seconds and exit 0. Returns the ranks'
    results in rank order. The native engine is built first, here, so that
    the ranks do not each build it."""
    native._lib()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), coord, job,
                               str(out_dir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + wall_s
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{job} on {world} ranks: not done in {wall_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job}, rank {r} of {world}:\n{log[-3000:]}"
    results = []
    for r in range(world):
        with open(out_dir / f"{job}.{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def main() -> None:
    sys.modules["jax"] = None
    sys.modules["hades252_tpu"] = None
    rank, world, coord, job, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4], Path(sys.argv[5]))
    torch.set_num_threads(1)
    with open(out_dir / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    multihost.initialize(coord, world, rank, backend="gloo", timeout_s=TIMEOUT_S)
    try:
        mesh = multihost.global_mesh(device="cpu")
        out = JOBS[job](mesh, inp)
        out["rank"], out["primary"] = mesh.rank, multihost.is_primary()
        out["mesh_timeout_s"] = mesh.group._get_backend(
            torch.device("cpu")).options._timeout.total_seconds()
        try:
            out["default_device"] = str(dist.make_mesh().device)
        except RuntimeError as e:  # no card: the default does not fall back to the CPU
            out["default_device"] = str(e)
        out["jax_loaded"] = any(k == "jax" or k.startswith(("jax.", "hades252_tpu."))
                                for k, v in sys.modules.items() if v is not None)
    finally:
        tdist.destroy_process_group()
    with open(out_dir / f"{job}.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
