"""Multi-process set-up on `torch.distributed`: the counterpart of
`hades252_tpu/parallel/multihost.py`.

The JAX package attaches every process to one global runtime with
`jax.distributed`; here every process is one rank of the default process
group, with one device. `dist.make_mesh` then builds meshes over the
ranks, and the sharded functions' collectives cross hosts the same way
they cross cards of one host.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as tdist

from . import dist


def initialize(coordinator_address: str, num_processes: int, process_id: int, *,
               backend: str = "nccl", timeout_s: float = 300) -> None:
    """Join this process to the default process group as rank `process_id`
    of `num_processes`.

    coordinator_address: "host:port" of rank 0's rendezvous (TCP).
    backend: the caller's choice, never switched: "nccl" for one card a
    rank (this process's card, `dist.local_rank`, becomes its current
    device first), "gloo" for ranks on the CPU or several ranks on one
    card (NCCL refuses two ranks on one card). timeout_s bounds every
    collective's wait for the other ranks: the default group's, and that of
    every mesh `dist.make_mesh` builds over it.
    """
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: the nccl backend needs a CUDA device; "
                               "pass backend='gloo' to run on the CPU")
        torch.cuda.set_device(dist.local_rank(process_id))
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id, timeout=timeout)
    dist._group_timeout = timeout


def global_mesh(axis: str = dist.AXIS, *, device=None) -> dist.Mesh:
    """1-D mesh over every rank of the default group, on this rank's
    `device` (dist.make_mesh's default: the card). The sharded functions
    read one axis, `dist.AXIS`."""
    if axis != dist.AXIS:
        raise ValueError(f"a mesh has the one axis {dist.AXIS!r}, not {axis!r}")
    return dist.make_mesh(device=device)


def is_primary() -> bool:
    """True on rank 0, and in a process that joined no group."""
    return not tdist.is_initialized() or tdist.get_rank() == 0
