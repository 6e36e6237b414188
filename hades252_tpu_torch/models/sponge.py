"""Rate-4 sponge over the Hades252 permutation, batched and streaming.

Port of `hades252_tpu/models/sponge.py` (BASELINE.md config 3):

  * rate 4 / capacity 1 over the width-5 state;
  * the capacity word (word 0) starts as the message length L, so messages
    are zero-padded to a multiple of the rate with no bit padding;
  * absorption adds message words into words 1..4 (a modular add, which
    commutes with the Montgomery domain), then permutes;
  * the digest is word 1 after the final permutation;
  * streams are the batch axis. Absorption within a stream is a serial
    chain, so the chunks run as a Python loop, one batched permutation
    call per chunk, with the state staying on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import field
from ..params import N_DIGITS, WIDTH
from ..utils import metrics
from ..utils.encoding import digits_to_ints, ints_to_digits

RATE = WIDTH - 1  # 4
CAPACITY_INDEX = 0
DIGEST_INDEX = 1


def _initial_state(n_streams: int, length: int, device) -> torch.Tensor:
    """(B, WIDTH, N_DIGITS) Montgomery state: the length in the capacity
    word, zeros elsewhere."""
    iv = torch.from_numpy(ints_to_digits([length])[0].astype(np.int32))
    state = torch.zeros((n_streams, WIDTH, N_DIGITS), dtype=torch.int32, device=device)
    state[:, CAPACITY_INDEX, :] = field.to_mont(iv).to(device)
    return state


def _absorb(state: torch.Tensor, chunk_mont: torch.Tensor, perm_mont_fn) -> torch.Tensor:
    fed = field.add_mod(state[:, 1:, :], chunk_mont)
    return perm_mont_fn(torch.cat([state[:, :1, :], fed], dim=1))


def sponge_hash(msgs: torch.Tensor, perm_mont_fn=None) -> torch.Tensor:
    """Hash B fixed-length messages of L field elements each.

    msgs: (B, L, N_DIGITS) int32 canonical digits. Returns (B, N_DIGITS)
    int32 canonical digest digits. perm_mont_fn defaults to
    ops.default_perm_mont_fn for msgs' device.
    """
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(msgs.device)
    if msgs.dim() != 3 or msgs.shape[-1] != N_DIGITS:
        raise ValueError(f"expected (B, L, {N_DIGITS}), got {tuple(msgs.shape)}")
    b, length, _ = msgs.shape
    if length == 0:
        raise ValueError("empty message")

    pad = (-length) % RATE
    msgs = torch.nn.functional.pad(msgs, (0, 0, 0, pad))
    n_chunks = (length + pad) // RATE
    chunks = field.to_mont(msgs).reshape(b, n_chunks, RATE, N_DIGITS)

    state = _initial_state(b, length, msgs.device)
    for c in range(n_chunks):
        state = _absorb(state, chunks[:, c], perm_mont_fn)
    metrics.count("sponge.messages", b)
    metrics.count("sponge.elements_absorbed", b * length)
    metrics.count("perms.executed", b * n_chunks)
    return field.from_mont(state[:, DIGEST_INDEX, :])


class SpongeState:
    """Incremental rate-4 sponge over batched streams.

    Equivalent to sponge_hash for the same total input: the capacity word
    starts as the declared total length, chunks absorb into words 1..4, and
    the first squeezed word equals sponge_hash's digest. Each permutation
    yields RATE output words. absorb() takes any word count; partial chunks
    wait in a buffer until full, or are zero-padded at the first squeeze.
    The state lives on `device`, the card unless the caller asks for the
    CPU (`device="cpu"`); without a card the default raises.
    """

    def __init__(self, n_streams: int, total_length: int, perm_mont_fn=None,
                 *, device="cuda"):
        if total_length <= 0:
            raise ValueError("total_length must be positive")
        if perm_mont_fn is None:
            from ..ops import default_perm_mont_fn

            perm_mont_fn = default_perm_mont_fn(device)
        self._perm = perm_mont_fn
        self._b = n_streams
        self._total = total_length
        self._absorbed = 0
        self._pending: list[torch.Tensor] = []  # buffered (B, k, D) mont words
        self._pending_n = 0
        self._squeezed: int | None = None
        self._digest: torch.Tensor | None = None
        self._state = _initial_state(n_streams, total_length, device)

    def absorb(self, words: torch.Tensor) -> "SpongeState":
        """Feed (B, k, N_DIGITS) int32 canonical digit words, any k >= 1."""
        if self._squeezed is not None:
            raise RuntimeError("cannot absorb after squeezing")
        if words.dim() != 3 or words.shape[0] != self._b or words.shape[-1] != N_DIGITS:
            raise ValueError(f"expected ({self._b}, k, {N_DIGITS}), got {tuple(words.shape)}")
        k = words.shape[1]
        if self._absorbed + k > self._total:
            raise ValueError("absorbing past the declared total length")
        self._absorbed += k
        self._pending.append(field.to_mont(words.to(self._state.device)))
        self._pending_n += k
        if self._pending_n >= RATE:
            buf = torch.cat(self._pending, dim=1)
            n_full = self._pending_n // RATE
            for c in range(n_full):
                self._mix(buf[:, c * RATE : (c + 1) * RATE, :])
            rest = buf[:, n_full * RATE :, :]
            self._pending = [rest] if rest.shape[1] else []
            self._pending_n = rest.shape[1]
        return self

    def _mix(self, chunk_mont: torch.Tensor) -> None:
        self._state = _absorb(self._state, chunk_mont, self._perm)
        metrics.count("perms.executed", self._b)

    def _finalize(self) -> None:
        if self._absorbed != self._total:
            raise RuntimeError(f"absorbed {self._absorbed} of declared {self._total} words")
        if self._pending_n:
            buf = torch.cat(self._pending, dim=1)
            self._mix(torch.nn.functional.pad(buf, (0, 0, 0, RATE - self._pending_n)))
            self._pending = []
            self._pending_n = 0
        self._squeezed = 0
        # the digest is squeeze word 0 of this state; keep it so digest()
        # stays the same whatever is squeezed later
        self._digest = field.from_mont(self._state[:, DIGEST_INDEX, :])

    def squeeze(self, n_words: int = 1) -> torch.Tensor:
        """(B, n_words, N_DIGITS) canonical output words; the first equals
        sponge_hash's digest. Permutes every RATE words."""
        if self._squeezed is None:
            self._finalize()
        out = []
        for _ in range(n_words):
            if self._squeezed == RATE:
                self._state = self._perm(self._state)
                metrics.count("perms.executed", self._b)
                self._squeezed = 0
            out.append(self._state[:, DIGEST_INDEX + self._squeezed, :])
            self._squeezed += 1
        return field.from_mont(torch.stack(out, dim=1))

    def digest(self) -> torch.Tensor:
        """(B, N_DIGITS) canonical digest, equal to sponge_hash's; does not
        consume squeeze output."""
        if self._squeezed is None:
            self._finalize()
        return self._digest


def sponge_hash_ints(words, perm_mont_fn=None, *, device="cuda") -> int:
    """Hash one message given as a list of canonical ints, on `device`: the
    card unless the caller asks for the CPU; without a card the default
    raises."""
    digits = torch.from_numpy(ints_to_digits([[int(w) for w in words]]).astype(np.int32))
    out = sponge_hash(digits.to(device), perm_mont_fn)
    return int(digits_to_ints(out[0].cpu().numpy()))
