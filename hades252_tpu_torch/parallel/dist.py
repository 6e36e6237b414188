"""Data-parallel sharding on `torch.distributed`: the counterpart of
`hades252_tpu/parallel/dist.py`.

The JAX package runs one controller over a 1-D device mesh and
`shard_map`s each function over it. PyTorch runs one process (a rank) a
device, so a `Mesh` here is a process group, and the call shapes stay the
JAX package's:

  * every rank of the mesh calls a function with the same global input;
  * each rank computes its contiguous shard, rows [r B/n, (r+1) B/n), on
    its own device (`Mesh.device`), through the same kernels as the
    unsharded path (`opt` by default);
  * every rank returns the global result, bit-identical to the unsharded
    function's and to the JAX package's.

Collectives. `merkle_root_sharded` keeps the JAX package's one
`all_gather`: each rank builds its subtree h levels up with no
communication (children never cross a shard's boundary), where
h = max{h : 4^h | N/n}, gathers the level at that height, and finishes the
top levels replicated. The tree is the global one, so the root does not
depend on the mesh. Every other function has no collective in JAX, whose
output stays sharded for one controller to read; a torch rank cannot read
another's shard, so each ends in one `all_gather` of its output. No
collective runs inside a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as tdist

from .. import field
from ..models.merkle import ARITY, _level_up, _pad_to_pow4, tree_levels
from ..params import N_DIGITS
from ..utils import metrics

AXIS = "data"

#: How long a collective of a mesh's group waits for the other ranks before
#: it fails: the default group's timeout, as multihost.initialize set it
#: (None where the caller joined the group itself: the backend's default).
_group_timeout: datetime.timedelta | None = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D data-parallel mesh as seen from one rank: the process group,
    its size, this rank's index in it and this rank's device."""

    group: tdist.ProcessGroup
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        """{AXIS: size}, as a JAX mesh's `shape` reads."""
        return {AXIS: self.size}


def local_rank(rank: int) -> int:
    """The card of a rank on its host: the rank modulo the host's cards
    (ranks numbered host by host)."""
    return rank % max(torch.cuda.device_count(), 1)


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh | None:
    """1-D data-parallel mesh over the first n_devices ranks of the default
    process group (all of them by default), on this rank's `device`: the
    card `cuda:<local rank>` unless the caller names another (the tests
    pass "cpu"); without a card the default raises. Every rank of the
    default group must call it (`torch.distributed.new_group`'s rule); a
    rank outside the first n_devices gets None. The mesh's group waits as
    long as the default group (multihost.initialize's timeout_s)."""
    if not tdist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(multihost.initialize does it)")
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if n_devices is None:
        n_devices = world
    if not 1 <= n_devices <= world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {world}")
    dev = torch.device(f"cuda:{local_rank(rank)}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a mesh on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    group = tdist.new_group(list(range(n_devices)), timeout=_group_timeout)
    if rank >= n_devices:
        return None
    return Mesh(group, n_devices, rank, dev)


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The device a call given `mesh` runs on: the mesh's. A `device` that
    names another raises; "cuda" without an index names any card."""
    want = torch.device(device)
    if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
        raise ValueError(f"device {want} contradicts the mesh's device {mesh.device}")
    return mesh.device


def _check_rows(rows: int, mesh: Mesh, what: str = "batch") -> None:
    if rows % mesh.shape[AXIS] != 0:
        raise ValueError(f"{what} {rows} not divisible by mesh size {mesh.shape[AXIS]}")


def _local(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of a global tensor, on its device."""
    k = x.shape[0] // mesh.size
    return x[mesh.rank * k : (mesh.rank + 1) * k].to(mesh.device)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global tensor from every rank's rows, in rank order: one
    all_gather over the mesh's group."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    tdist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def permute_sharded(x: torch.Tensor, mesh: Mesh, perm_fn=None) -> torch.Tensor:
    """Batch-sharded permutation: x (B, WIDTH, N_DIGITS) canonical int32
    digits, B divisible by the mesh size. perm_fn defaults to the `opt`
    kernel (its plain version on a CPU mesh)."""
    if perm_fn is None:
        from ..ops.perm_cuda import permute_cuda as perm_fn
    _check_rows(x.shape[0], mesh)
    return _gather(perm_fn(_local(x, mesh)), mesh)


def sponge_hash_sharded(msgs: torch.Tensor, mesh: Mesh, perm_mont_fn=None) -> torch.Tensor:
    """Stream-sharded sponge: msgs (B, L, N_DIGITS), B divisible by the
    mesh size; returns the (B, N_DIGITS) digests."""
    from ..models.sponge import sponge_hash

    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(mesh.device)
    _check_rows(msgs.shape[0], mesh)
    return _gather(sponge_hash(_local(msgs, mesh), perm_mont_fn), mesh)


def cipher_sharded(key, nonce, data, mesh: Mesh, *, decrypt: bool = False, perm_mont_fn=None):
    """Batch-sharded duplex cipher (models/cipher.py): every tensor's
    leading batch axis shards over the mesh; rows are independent streams.
    Returns (out, tags) for the whole batch."""
    from ..models import cipher

    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(mesh.device)
    _check_rows(key.shape[0], mesh)
    out, tags = cipher._run(_local(key, mesh), _local(nonce, mesh), _local(data, mesh),
                            perm_mont_fn, decrypt=decrypt)
    return _gather(out, mesh), _gather(tags, mesh)


def chain_nodes_sharded(node, sibs, poss, mesh: Mesh, perm_fn=None) -> torch.Tensor:
    """Mesh-sharded verification chains: the K compact-opening rows of a
    pooled height group shard over the mesh (rows are independent chains)
    and each rank runs its whole h-level chain through
    fri_cuda._chain_nodes_body, the body of the unsharded device_chain_fn.
    node (K, N_DIGITS) int32 canonical digits, sibs (K, h, 3, N_DIGITS)
    int32, poss (K, h) integer; K divisible by the mesh size. Returns the
    (K, N_DIGITS) root-level digests, bit-identical to fri's host loop.
    perm_fn defaults to the `opt` kernel."""
    from ..fri_cuda import _chain_nodes_body, _node_tag, _perm_fn
    from ..ops.perm_cuda import DEFAULT_SCHEDULE

    if perm_fn is None:
        perm_fn = _perm_fn(DEFAULT_SCHEDULE)
    _check_rows(node.shape[0], mesh, "openings")
    digests = _chain_nodes_body(_local(node, mesh), _local(sibs, mesh),
                                _local(poss, mesh).long(), perm_fn, _node_tag(mesh.device))
    return _gather(digests, mesh)


def _data_parallel(fn, n_sharded: int, mesh: Mesh):
    """fn over this rank's rows of its first n_sharded arguments (the
    others replicated, already on the mesh's device), its output gathered."""

    def run(*args):
        _check_rows(args[0].shape[0], mesh)
        local = [_local(a, mesh) for a in args[:n_sharded]]
        return _gather(fn(*local, *args[n_sharded:]), mesh)

    return run


def sharded_phases(mesh: Mesh):
    """Data-parallel PLONK proving: prover_cuda's three device phases over
    the INSTANCE axis, as the JAX package's `in_specs` shard them. Phase 1
    shards its one argument; phase 2 its (wires, beta, gamma) and
    replicates the three tables; phase 3 its (wires, z, PI columns, beta,
    gamma, alpha) and replicates the seven tables. Instances are
    independent, so each phase's one collective is the gather of its
    output. Returns (phase1, phase2, phase3) drop-ins, each returning the
    global tensor; prover_cuda.prove_batched(mesh=...) and fri_cuda's
    provers use them and stay bit-identical to the unsharded path."""
    from .. import prover_cuda as pc

    return (_data_parallel(pc._phase1_wires, 1, mesh),
            _data_parallel(pc._phase2_grand_product, 3, mesh),
            _data_parallel(pc._phase3_quotient, 6, mesh))


def _local_tree_height(n_local: int) -> int:
    h = 0
    while n_local % (ARITY ** (h + 1)) == 0:
        h += 1
    return h


def merkle_root_sharded(leaves: torch.Tensor, mesh: Mesh, perm_mont_fn=None) -> torch.Tensor:
    """Sharded arity-4 Merkle root, bit-identical to models.merkle.merkle_root.

    leaves: (N, N_DIGITS) canonical int32 digits; N is padded to a power of
    4 globally, and the padded count must be divisible by the mesh size.
    Returns the (N_DIGITS,) canonical root on the mesh's device.
    """
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(mesh.device)
    if leaves.dim() != 2 or leaves.shape[-1] != N_DIGITS:
        raise ValueError(f"expected (N, {N_DIGITS}), got {tuple(leaves.shape)}")
    n_dev = mesh.shape[AXIS]
    padded = _pad_to_pow4(leaves)
    n = padded.shape[0]
    if n % n_dev != 0:
        raise ValueError(f"padded leaf count {n} not divisible by mesh {n_dev}")
    h_local = _local_tree_height(n // n_dev)
    total_h = tree_levels(n)
    metrics.count("dist.merkle_builds", 1)
    metrics.count("perms.executed", (n - 1) // (ARITY - 1))
    # bytes each rank receives in the one all_gather at height h_local
    gathered = n // ARITY**h_local
    metrics.count("dist.collective_bytes", (gathered - gathered // n_dev) * N_DIGITS * 4)
    with metrics.span("dist.merkle"):
        level = field.to_mont(_local(padded, mesh))
        for _ in range(h_local):
            level = _level_up(level, perm_mont_fn)
        level = _gather(level, mesh)
        for _ in range(total_h - h_local):
            level = _level_up(level, perm_mont_fn)
        return field.from_mont(level[0])
