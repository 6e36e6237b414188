"""Sharded Merkle build across ranks, with metrics and checkpoint/resume,
on the PyTorch port.

    python -m hades252_tpu_torch.examples.multichip_merkle              # one NCCL rank a card
    python -m hades252_tpu_torch.examples.multichip_merkle --ranks 2 --backend gloo
    python -m hades252_tpu_torch.examples.multichip_merkle --device cpu --ranks 4

The steps and printed lines are those of `examples/multichip_merkle.py`
(the JAX package's). Each rank is a spawned process of one
`torch.distributed` group on 127.0.0.1 (parallel/multihost.py): NCCL with
one card a rank, or gloo for ranks that share a card or run on the CPU
(the default with --device cpu). Rank 0 holds the sharded root against the
one-device `merkle_root`, then builds the tree checkpointed and resumes it
from disk, and returns its metrics. Without a card the default raises.
"""

from __future__ import annotations

import argparse

#: Every rank must report within it.
WALL_S = 300
#: The tree's leaves, as the JAX example's.
N_LEAVES = 1 << 8


def _rank(rank: int, world: int, coordinator: str, backend: str, device: str) -> dict | None:
    """One rank: the sharded build over every rank; on rank 0 also the
    one-device root, the checkpointed build and its resume, and the report
    of the metrics."""
    import tempfile

    import numpy as np
    import torch

    from hades252_tpu_torch.models.merkle import merkle_root
    from hades252_tpu_torch.parallel import dist, multihost
    from hades252_tpu_torch.utils import checkpoint, metrics
    from hades252_tpu_torch.utils.encoding import ints_to_digits

    multihost.initialize(coordinator, world, rank, backend=backend, timeout_s=WALL_S / 2)
    try:
        mesh = multihost.global_mesh(device=None if device == "cuda" else device)
        metrics.enable()
        leaves = torch.from_numpy(ints_to_digits(list(range(N_LEAVES)), shape=(N_LEAVES,))
                                  .astype(np.int32)).to(mesh.device)
        # sharded build over every rank; the root is bit-identical to one device's
        root_sharded = dist.merkle_root_sharded(leaves, mesh)
        if rank:
            return None
        root_single = merkle_root(leaves)
        if not torch.equal(root_sharded, root_single):
            raise RuntimeError("the sharded root != the one-device root")
        # checkpointed build: kill/restart-safe for long jobs
        with tempfile.TemporaryDirectory() as d:
            root_ckpt = checkpoint.merkle_root_checkpointed(leaves, d)
            resumed = checkpoint.merkle_root_checkpointed(leaves, d)  # from disk
        ckpt_ok = torch.equal(root_ckpt, root_single) and torch.equal(resumed, root_single)
        return {"devices": mesh.shape[dist.AXIS], "ckpt": ckpt_ok, "report": metrics.report()}
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    import torch

    from hades252_tpu_torch.parallel import multihost

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="each rank's device: its card (default) or the CPU")
    parser.add_argument("--ranks", type=int, default=None,
                        help="ranks to spawn (default: one a card; 2 on the CPU)")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="nccl (default on the card: one card a rank) or gloo "
                             "(default on the CPU)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("multichip_merkle: no CUDA device; pass --device cpu")
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    if backend == "nccl" and ranks > torch.cuda.device_count():
        raise SystemExit(f"multichip_merkle: {ranks} NCCL ranks need {ranks} cards, "
                         f"have {torch.cuda.device_count()}; pass --backend gloo")

    result = multihost.spawn(_rank, ranks, backend, args.device, wall_s=WALL_S)[0]
    print(f"{N_LEAVES} leaves over {result['devices']} devices: roots match")
    if not result["ckpt"]:
        raise SystemExit("checkpoint/resume: the roots differ")
    print("checkpoint/resume: roots match")
    print("--- metrics ---")
    print(result["report"])


if __name__ == "__main__":
    main()
