"""Checkpoint and resume for long Merkle builds.

Port of `hades252_tpu/utils/checkpoint.py`. The one long-running,
restartable job is a large arity-4 Merkle build. The build is
deterministic, so after each tree level is computed that level is
persisted, and a restart resumes from the highest level on disk. Levels are
stored as canonical 32-byte little-endian scalars, independent of the
in-memory Montgomery domain, of the device and of the package: the layout
and every byte are the JAX package's, so a directory written by either
package resumes in the other.

Layout: <dir>/level_<k>.bin (4^(H-k) scalars) and <dir>/meta.json.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from .. import field
from ..models.merkle import ARITY, _level_up, _pad_to_pow4, tree_levels
from ..params import N_DIGITS
from .encoding import bytes_to_digits, digits_to_bytes


def _meta_path(d):
    return os.path.join(d, "meta.json")


def _level_path(d, k):
    return os.path.join(d, f"level_{k}.bin")


def save_level(d: str, k: int, level_canonical) -> None:
    """Persist tree level k (0 = leaves) as canonical little-endian bytes,
    atomically. level_canonical: (N, N_DIGITS) digits, numpy or CPU tensor."""
    os.makedirs(d, exist_ok=True)
    tmp = _level_path(d, k) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(digits_to_bytes(level_canonical))
    os.replace(tmp, _level_path(d, k))


def load_level(d: str, k: int, n: int) -> np.ndarray:
    """Load level k as (n, N_DIGITS) uint32 digits; raises FileNotFoundError
    or ValueError on bad data."""
    with open(_level_path(d, k), "rb") as f:
        data = f.read()
    if len(data) != n * 32:
        raise ValueError(f"level {k}: expected {n * 32} bytes, got {len(data)}")
    return bytes_to_digits(data, (n,))


def highest_saved_level(d: str, height: int, n_leaves_padded: int) -> int | None:
    """Highest level index with a complete, well-sized file (None if none)."""
    for k in range(height, -1, -1):
        path = _level_path(d, k)
        n = n_leaves_padded // ARITY**k
        if os.path.exists(path) and os.path.getsize(path) == n * 32:
            return k
    return None


def merkle_root_checkpointed(leaves: torch.Tensor, d: str, perm_mont_fn=None,
                             save_leaves: bool = False) -> torch.Tensor:
    """Arity-4 Merkle root with per-level checkpointing.

    Persists every computed level under `d` and resumes from the highest
    complete level found there, so a killed build restarts with only one
    level of lost work. Bit-identical to models.merkle.merkle_root.

    leaves: (N, N_DIGITS) int32 canonical digits; their device is where the
    tree is built, and perm_mont_fn defaults to ops.default_perm_mont_fn for
    it. save_leaves=False skips persisting level 0 (usually the caller
    already durably owns the leaves); resume then starts at level >= 1 if
    present, else recomputes from the passed leaves.
    """
    if leaves.dim() != 2 or leaves.shape[-1] != N_DIGITS:
        raise ValueError(f"expected (N, {N_DIGITS}), got {tuple(leaves.shape)}")
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(leaves.device)

    padded = _pad_to_pow4(leaves)
    n = padded.shape[0]
    height = tree_levels(n)

    # fingerprint the actual leaves: resuming a directory built from other
    # leaves of the same shape must fail loudly, not return the old root.
    # The int32 digits have the bytes of the JAX package's uint32 ones.
    padded_host = np.ascontiguousarray(padded.cpu().numpy())
    fp = hashlib.sha256(padded_host.tobytes())
    meta = {"n_leaves_padded": int(n), "height": int(height), "arity": ARITY,
            "leaves_sha256": fp.hexdigest()}
    os.makedirs(d, exist_ok=True)
    if os.path.exists(_meta_path(d)):
        with open(_meta_path(d)) as f:
            prior = json.load(f)
        if prior != meta:
            raise ValueError(
                f"checkpoint dir {d} holds a different build: {prior} != {meta}"
            )
    else:
        # through a temporary file, as save_level writes a level: a kill
        # mid-write leaves no cut-short meta.json to refuse the next resume
        tmp = _meta_path(d) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, _meta_path(d))

    start = highest_saved_level(d, height, n)
    if start is None or (start == 0 and not save_leaves):
        level = field.to_mont(padded)
        start = 0
        if save_leaves:
            save_level(d, 0, padded_host)
    else:
        loaded = load_level(d, start, n // ARITY**start).astype(np.int32)
        level = field.to_mont(torch.from_numpy(loaded).to(leaves.device))

    for k in range(start, height):
        level = _level_up(level, perm_mont_fn)
        save_level(d, k + 1, field.from_mont(level).cpu().numpy())
    return field.from_mont(level[0]) if height > 0 else padded[0]
