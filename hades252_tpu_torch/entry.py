"""Entry points on the port: the counterpart of `__graft_entry__.py`.

`entry()` is the one-card compile check: the KAT gate for the default
kernel, then the kernel and one planar batch to call it on.
`dryrun_multichip(n)` spawns n ranks on `torch.distributed` and runs every
sharded path at tiny shapes, each against its one-device value.

    python -c "from hades252_tpu_torch.entry import entry; fn, args = entry(); fn(*args)"

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import prover_cuda, selftest
from .models import cipher, merkle, sponge
from .ops import field_cuda, perm_cuda, permute, resolve_device
from .parallel import dist, multihost
from .params import P
from .utils import native
from .utils.encoding import ints_to_digits

#: The dry run's ranks must all report within it.
DRYRUN_WALL_S = 300
#: A collective's wait for the other ranks in the dry run.
DRYRUN_GROUP_TIMEOUT_S = 120


def entry(device="cuda"):
    """(fn, args) of the flagship step, the fused batched permutation.

    On the card: the known-answer gate for the default schedule
    (canonical path, selftest.assert_device_correct) first, since a build
    that launches can still compute wrong values; then `fn` is the default
    schedule's kernel over planar state and `args` one (5, 16, 1024)
    planar batch from numpy seed 0. The kernel takes canonical digits, so
    each element's top digit is reduced below p's. With device="cpu": the
    torch oracle `permute` and a (256, 5, 16) batch of raw 16-bit digits
    from the same seed, as the JAX entry gives off the TPU. Without a card
    the default raises."""
    dev = resolve_device("entry", device)
    rng = np.random.default_rng(0)
    if dev.type == "cuda":
        selftest.assert_device_correct(schedules=(perm_cuda.DEFAULT_SCHEDULE,), device=dev,
                                       include_mont=False)
        x = rng.integers(0, 1 << 16, (5, 16, 1024), dtype=np.int64)
        x[:, 15] %= P >> 240
        fn = functools.partial(perm_cuda.permute_planar, schedule=perm_cuda.DEFAULT_SCHEDULE)
        return fn, (torch.from_numpy(x.astype(np.int32)).to(dev),)
    x = rng.integers(0, 1 << 16, (256, 5, 16), dtype=np.uint32)
    return permute, (torch.from_numpy(x.astype(np.int32)).to(dev),)


def _rand_scalars(rng: np.random.Generator, shape) -> np.ndarray:
    flat = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(int(np.prod(shape)))]
    return ints_to_digits(flat, shape=tuple(shape)).astype(np.int32)


def _dryrun_rank(rank: int, world: int, coordinator: str, backend: str, device) -> dict:
    """One rank of dryrun_multichip. Every rank draws the same global inputs
    from seed 42 and checks the global results. Returns its kernel launches
    by schedule."""
    multihost.initialize(coordinator, world, rank, backend=backend,
                         timeout_s=DRYRUN_GROUP_TIMEOUT_S)
    try:
        mesh = dist.make_mesh(device=device)
        dev = mesh.device
        rng = np.random.default_rng(42)

        def scalars(*shape):
            return torch.from_numpy(_rand_scalars(rng, shape)).to(dev)

        engine = native if native.available() else None
        perm_cuda.reset_launches()

        # data-parallel batched permutation
        x = scalars(4 * world, 5)
        out = dist.permute_sharded(x, mesh)
        if out.shape != (4 * world, 5, 16) or not torch.equal(out, perm_cuda.permute_cuda(x)):
            raise RuntimeError("permute_sharded != the one-device permutation")
        # stream-sharded sponge
        msgs = scalars(world, 4)
        digest = dist.sponge_hash_sharded(msgs, mesh)
        if digest.shape != (world, 16) or not torch.equal(digest, sponge.sponge_hash(msgs)):
            raise RuntimeError("sponge_hash_sharded != the one-device sponge")
        # batch-sharded duplex cipher against the native engine (an
        # independent implementation), else the one-device cipher
        key, nonce, pt = scalars(world, 2), scalars(world), scalars(world, 4)
        ct_s, tag_s = dist.cipher_sharded(key, nonce, pt, mesh)
        if engine is not None:
            ct_1, tag_1 = engine.cipher_digits(key.cpu().numpy(), nonce.cpu().numpy(),
                                               pt.cpu().numpy())
        else:
            ct_1, tag_1 = (t.cpu().numpy() for t in cipher.encrypt(key, nonce, pt))
        if not (np.array_equal(ct_s.cpu().numpy(), ct_1)
                and np.array_equal(tag_s.cpu().numpy(), tag_1)):
            raise RuntimeError("cipher_sharded != the one-device cipher")
        # the sharded Merkle build over the largest power-of-two submesh
        # (every rank builds the submesh: new_group's rule)
        n_tree = 1 << (world.bit_length() - 1)
        tree_mesh = mesh if n_tree == world else dist.make_mesh(n_tree, device=device)
        leaves = scalars(4 * n_tree)
        if tree_mesh is not None:
            root = dist.merkle_root_sharded(leaves, tree_mesh).cpu().numpy()
            want = (engine.merkle_root_digits(leaves.cpu().numpy()) if engine is not None
                    else merkle.merkle_root(leaves).cpu().numpy())
            if not np.array_equal(root, want):
                raise RuntimeError("sharded Merkle root != the one-device root")
        # the proving stack: the instance-sharded wire iNTT (prover phase 1)
        phase1, _, _ = dist.sharded_phases(mesh)
        wires = field_cuda.to_mont(scalars(world, 4, 4))
        if not torch.equal(phase1(wires), prover_cuda._phase1_wires(wires)):
            raise RuntimeError("the mesh-sharded prover phase != the one-device phase")
        return dict(perm_cuda.launches)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, *, backend: str = "nccl", device=None) -> list:
    """The sharded paths over a mesh of n_devices ranks at tiny shapes: the
    batched permutation, the sponge, the cipher (against the native
    engine), the Merkle build over the largest power-of-two submesh
    (against the native engine) and prover phase 1, each held to its
    one-device value. The ranks are spawned processes joined over TCP on
    127.0.0.1 (multihost.spawn), all reporting within DRYRUN_WALL_S and
    ended after.

    backend "nccl": one card a rank (NCCL refuses two ranks on one card),
    so the host needs n_devices cards; "gloo": ranks on the CPU
    (device="cpu") or sharing the card. device: each rank's (dist.make_mesh's
    default, its card, when None). Returns each rank's kernel launches by
    schedule, in rank order."""
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices for NCCL, have {have}; "
                               "pass backend='gloo' to share one card or run on the CPU")
    return multihost.spawn(_dryrun_rank, n_devices, backend, device, wall_s=DRYRUN_WALL_S)
