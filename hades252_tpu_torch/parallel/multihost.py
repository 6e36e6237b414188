"""Multi-process set-up on `torch.distributed`: the counterpart of
`hades252_tpu/parallel/multihost.py`.

The JAX package attaches every process to one global runtime with
`jax.distributed`; here every process is one rank of the default process
group, with one device. `dist.make_mesh` then builds meshes over the
ranks, and the sharded functions' collectives cross hosts the same way
they cross cards of one host. `spawn` starts the ranks of one host as
processes and gathers what each returns.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback

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


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked: a coordinator's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, coordinator: str, args: tuple, out) -> None:
    try:
        result = fn(rank, world, coordinator, *args)
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    out.put((rank, True, result))


def spawn(fn, world: int, *args, wall_s: float) -> list:
    """fn(rank, world, coordinator, *args) on `world` spawned processes, one
    a rank, with coordinator "127.0.0.1:<a free port>" for their
    `initialize`. fn must be picklable (a module-level function) and so
    must its result and args. Every rank must return and exit 0 within
    wall_s seconds, or this raises RuntimeError (with a failed rank's
    traceback). Returns the results in rank order; every process is ended
    before it returns, a rank still alive at the wall killed."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, coordinator, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline, results, dead = time.monotonic() + wall_s, {}, []
    try:
        while len(results) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                if dead:  # exited a second ago, and nothing of theirs came since
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive() and p.exitcode]
                    codes = [procs[r].exitcode for r in dead]
                    raise RuntimeError(f"ranks {dead} of {world} exited with {codes} "
                                       "before they reported") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {sorted(set(range(world)) - set(results))} of "
                                       f"{world} did not report within {wall_s} s") from None
                # a rank that died in its start-up reports nothing
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive() and p.exitcode]
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{res}")
            results[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks of {world}: exit codes {codes}")
    return [results[r] for r in range(world)]
