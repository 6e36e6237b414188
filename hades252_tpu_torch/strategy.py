"""User-facing strategy API, mirroring the reference crate's surface.

Port of `hades252_tpu/strategy.py:34-177`. The `Strategy` base class is the
round-schedule engine; `ScalarStrategy` executes its three primitive ops on
field elements. Its width-5 int-list path runs the schedule in exact
Python-int arithmetic: the port's own oracle, independent of every tensor
backend, and the one the GPU host uses to check the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import (
    P,
    PARTIAL_ROUNDS,
    ROUNDS,
    TOTAL_FULL_ROUNDS,
    WIDTH,
    mds_matrix_int,
    round_constants_int,
)


class Strategy:
    """The backend-agnostic Hades round-schedule engine. Subclasses supply
    the three primitive ops; the schedule methods are shared."""

    def add_round_key(self, constants, words) -> None:
        """Add the next WIDTH round constants to the words in place."""
        raise NotImplementedError

    def quintic_s_box(self, value):
        """x -> x^5."""
        raise NotImplementedError

    def mul_matrix(self, constants, values) -> None:
        """Multiply the state by the MDS matrix in place."""
        raise NotImplementedError

    @staticmethod
    def rounds() -> int:
        return ROUNDS

    @staticmethod
    def next_c(constants):
        """Consume the next ARK constant; running out is an error."""
        try:
            return next(constants)
        except StopIteration:
            raise RuntimeError("out of ARK constants") from None

    def apply_full_round(self, constants, words) -> None:
        """ARK -> quintic S-box on ALL words -> MDS."""
        self.add_round_key(constants, words)
        for i in range(len(words)):
            words[i] = self.quintic_s_box(words[i])
        self.mul_matrix(constants, words)

    def apply_partial_round(self, constants, words) -> None:
        """ARK (all words) -> S-box on the LAST word -> MDS."""
        self.add_round_key(constants, words)
        words[-1] = self.quintic_s_box(words[-1])
        self.mul_matrix(constants, words)

    def perm(self, data) -> None:
        """The 67-round permutation, in place; the constants iterator
        restarts at 0 on each call."""
        if len(data) != WIDTH:
            raise ValueError(f"state must have exactly {WIDTH} words")
        constants = iter(round_constants_int())
        half = TOTAL_FULL_ROUNDS // 2
        for _ in range(half):
            self.apply_full_round(constants, data)
        for _ in range(PARTIAL_ROUNDS):
            self.apply_partial_round(constants, data)
        for _ in range(half):
            self.apply_full_round(constants, data)


class ScalarStrategy(Strategy):
    """Executes the permutation on actual field elements.

    Two call paths:
      * `perm(list_of_5_ints)`: in place on a width-5 list, by the schedule
        engine in exact Python ints; also returns the list.
      * `perm(array)`: batched (..., WIDTH, N_DIGITS) canonical digits (a
        tensor or a numpy array) through `backend`: "ref" (the torch oracle,
        on the tensor's device), "cuda" (the `opt` kernel; the state is
        moved to the current CUDA device) or "native" (the C++ host engine,
        `utils/native.perm_batch_digits`; it raises NativeUnavailable where
        the engine cannot be built). Returns an int32 tensor; "native"'s is
        on the CPU.
    """

    def __init__(self, backend: str = "ref"):
        if backend not in ("ref", "cuda", "native"):
            raise ValueError(f"unknown backend: {backend}")
        self._backend = backend

    def add_round_key(self, constants, words) -> None:
        for i in range(len(words)):
            words[i] = (words[i] + self.next_c(constants)) % P

    def quintic_s_box(self, value):
        return pow(value, 5, P)

    def mul_matrix(self, constants, values) -> None:
        # the scalar backend ignores the constants iterator here; the sum
        # runs j-ascending
        mds = mds_matrix_int()
        values[:] = [
            sum(mds[k][j] * values[j] for j in range(WIDTH)) % P for k in range(WIDTH)
        ]

    def perm(self, values):
        if isinstance(values, (list, tuple)):
            if len(values) != WIDTH:
                raise ValueError(f"state must have exactly {WIDTH} words")
            words = [int(v) % P for v in values]
            Strategy.perm(self, words)
            if isinstance(values, list):
                values[:] = words  # in place, like &mut [BlsScalar; 5]
            return words
        if isinstance(values, np.ndarray):
            values = torch.from_numpy(values.astype(np.int32))
        if values.dim() < 2 or values.shape[-2] != WIDTH:
            raise ValueError(f"state must be (..., {WIDTH}, N_DIGITS)")
        values = values.to(torch.int32)
        if self._backend == "ref":
            from .ops.perm_ref import permute

            return permute(values)
        if self._backend == "native":
            from .utils import native

            flat = values.reshape(-1, WIDTH, values.shape[-1]).cpu().numpy()
            out = native.perm_batch_digits(flat).astype(np.int32)
            return torch.from_numpy(out).reshape(values.shape)
        from .ops.perm_cuda import permute_cuda

        flat = values.reshape(-1, WIDTH, values.shape[-1]).to("cuda")
        return permute_cuda(flat).reshape(values.shape)
