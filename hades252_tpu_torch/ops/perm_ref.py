"""Plain PyTorch Hades252 permutation on the dense schedule: the torch oracle.

Port of `hades252_tpu/ops/perm_ref.py`: 4 full rounds, 59 partial rounds,
4 full rounds; ARK on all five words every round; x^5 on every word (full)
or on word 4 (partial); the 5x5 MDS with its terms folded j-ascending.
State is (..., WIDTH, N_DIGITS) int32 digits on any device; internally it
lives in the Montgomery domain, with the constants pre-converted.
"""

from __future__ import annotations

import functools

import torch

from .. import field
from ..params import N_DIGITS, PARTIAL_ROUNDS, TOTAL_FULL_ROUNDS, WIDTH, perm_tables


@functools.cache
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    t = perm_tables()
    return t["ark_mont"].to(device), t["mds_mont"].to(device)


def _mds(state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """MDS matrix-vector product; state (..., WIDTH, N_DIGITS) Montgomery."""
    # prods[..., k, j, :] = mds[k, j] * state[j]   (Montgomery product)
    prods = field.mont_mul(mds, state[..., None, :, :])
    acc = prods[..., 0, :]
    for j in range(1, WIDTH):  # fixed order, as every backend folds
        acc = field.add_mod(acc, prods[..., j, :])
    return acc


def _round(state: torch.Tensor, consts: torch.Tensor, mds: torch.Tensor,
           full: bool) -> torch.Tensor:
    state = field.add_mod(state, consts)
    if full:
        state = field.quintic_sbox_mont(state)
    else:
        last = field.quintic_sbox_mont(state[..., WIDTH - 1, :])
        state = torch.cat([state[..., : WIDTH - 1, :], last[..., None, :]], dim=-2)
    return _mds(state, mds)


def _check_state(state: torch.Tensor) -> None:
    if state.shape[-2:] != (WIDTH, N_DIGITS):
        raise ValueError(f"state must be (..., {WIDTH}, {N_DIGITS}), got {tuple(state.shape)}")


def permute_mont(state: torch.Tensor) -> torch.Tensor:
    """The 67-round permutation on Montgomery-domain state
    (..., WIDTH, N_DIGITS), each word < p. Returns int32 digits."""
    _check_state(state)
    ark, mds = _tables(state.device)
    half = TOTAL_FULL_ROUNDS // 2
    for r in range(TOTAL_FULL_ROUNDS + PARTIAL_ROUNDS):
        full = r < half or r >= half + PARTIAL_ROUNDS
        state = _round(state, ark[r], mds, full)
    return state


def permute(state: torch.Tensor) -> torch.Tensor:
    """The permutation on canonical-digit state (..., WIDTH, N_DIGITS)."""
    _check_state(state)
    return field.from_mont(permute_mont(field.to_mont(state)))
