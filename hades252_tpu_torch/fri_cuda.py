"""The succinct argument's device side: the counterpart of
`hades252_tpu/fri_tpu.py`.

It holds the card's permutation seam for the host-orchestrated proof
paths of `fri` and `aggregate`: their commitment trees, leaf-block
sponges, proof-of-work grinding and pooled multiproof checks all take a
batched canonical `perm_fn`, and `device_pool_perm` makes one that runs
the hand-written kernels. The JAX package's `_device_pool_perm`
(`fri_tpu.py:1541-1560`) pads every batch to the kernel's block so that
the TPU keeps one executable; the CUDA kernels mask their tail, so
nothing is padded here. Proofs and verdicts are bit-identical to those
through the native engine or the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.perm_cuda import DEFAULT_SCHEDULE, _check_schedule, permute_cuda


def device_pool_perm(schedule: str = DEFAULT_SCHEDULE, device="cuda"):
    """A batched canonical permutation for `fri` and `aggregate`'s
    `perm_fn`: (B, WIDTH, N_DIGITS) uint32 digits in, the same out,
    through the CUDA kernel of `schedule` on the card. It runs on the
    card unless the caller asks for the CPU (device="cpu": the kernel's
    plain version, for the tests); without a card it raises, and it never
    falls back to the native engine or to the plain version."""
    _check_schedule(schedule)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_pool_perm: no CUDA device (pass device='cpu' for the "
                           "plain version)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {dev}")

    def perm(states):
        x = torch.from_numpy(np.asarray(states, np.uint32).astype(np.int32)).to(dev)
        return permute_cuda(x, schedule=schedule).cpu().numpy().astype(np.uint32)

    return perm
