"""Authenticated stream cipher over the Hades252 permutation (duplex mode).

Port of `hades252_tpu/models/cipher.py`, the same spec and bit-identical
outputs (a standard duplex-sponge construction, as in dusk-poseidon's
PoseidonCipher use of the permutation):

    state0 = [ TAG_ENC + L*2^32 , k0 , k1 , nonce , 1 ]      (canonical)
    state  = perm(state0)
    for each rate-4 chunk m of the (zero-padded) message:
        c_i        = m_i + state[1+i]    (mod p, i = 0..3)
        state[1+i] = c_i                 (duplex: the ciphertext re-enters)
        state      = perm(state)
    tag = state[1]

The capacity word binds the domain and the padded length L, so a truncated
or extended ciphertext never verifies; word 4 is the constant 1. Decryption
runs the same schedule with m_i = c_i - state[1+i] and recomputes the tag.

Batched over B independent (key, nonce, message) rows. The chunk loop is a
Python loop, one batched permutation call per chunk, with the Montgomery
state staying on the device between them. One (key, nonce) pair must
encrypt at most one message, as in every stream cipher.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field_cuda
from ..params import N_DIGITS, WIDTH
from ..utils import metrics
from ..utils.encoding import ints_to_digits

RATE = WIDTH - 1
TAG_ENC = 6  # domain tag (Merkle trees use 4, the arity; the sponge uses L)


def _mont_word(value: int, b: int, device) -> torch.Tensor:
    """(b, 1, N_DIGITS) int32: the Montgomery form of a canonical int."""
    digits = torch.from_numpy(ints_to_digits([value])[0].astype(np.int32))
    return field_cuda.to_mont(digits).to(device).expand(b, 1, N_DIGITS)


def _pad(msgs: torch.Tensor) -> torch.Tensor:
    if msgs.dim() != 3 or msgs.shape[-1] != N_DIGITS:
        raise ValueError(f"data must be (B, L, {N_DIGITS}), got {tuple(msgs.shape)}")
    return torch.nn.functional.pad(msgs, (0, 0, 0, (-msgs.shape[1]) % RATE))


def _init_state(key, nonce, n_padded: int, perm_mont_fn) -> torch.Tensor:
    b = key.shape[0]
    state = torch.cat([_mont_word(TAG_ENC + (n_padded << 32), b, key.device),
                       field_cuda.to_mont(key), field_cuda.to_mont(nonce)[:, None],
                       _mont_word(1, b, key.device)], dim=1)
    return perm_mont_fn(state)


def _duplex(state, chunk_mont, perm_mont_fn, decrypt: bool):
    """One duplex step. chunk_mont: (B, RATE, D) message (encrypt) or
    ciphertext (decrypt) in Montgomery form. Returns (state', out_mont)."""
    ks = state[:, 1 : 1 + RATE]
    if decrypt:
        out = field_cuda.sub_mod(chunk_mont, ks)      # plaintext
        fed = chunk_mont                         # the duplex absorbs ciphertext
    else:
        out = field_cuda.add_mod(chunk_mont, ks)      # ciphertext
        fed = out
    state = torch.cat([state[:, :1], fed, state[:, 1 + RATE :]], dim=1)
    return perm_mont_fn(state), out


def _run(key, nonce, data, perm_mont_fn, decrypt: bool):
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(key.device)
    if key.dim() != 3 or tuple(key.shape[1:]) != (2, N_DIGITS):
        raise ValueError(f"key must be (B, 2, {N_DIGITS}), got {tuple(key.shape)}")
    if tuple(nonce.shape) != (key.shape[0], N_DIGITS):
        raise ValueError(f"nonce must be (B, {N_DIGITS}), got {tuple(nonce.shape)}")
    if data.dim() != 3 or data.shape[-1] != N_DIGITS:
        raise ValueError(f"data must be (B, L, {N_DIGITS}), got {tuple(data.shape)}")
    if data.shape[1] % RATE != 0:
        raise ValueError("data length must be a multiple of the rate")
    b, n_padded = data.shape[0], data.shape[1]
    chunks = field_cuda.to_mont(data).reshape(b, n_padded // RATE, RATE, N_DIGITS)
    state = _init_state(key, nonce.to(key.device), n_padded, perm_mont_fn)
    outs = []
    for c in range(chunks.shape[1]):
        state, out = _duplex(state, chunks[:, c], perm_mont_fn, decrypt)
        outs.append(out)
    out = torch.cat(outs, dim=1) if outs else data.new_zeros(data.shape)
    return field_cuda.from_mont(out), field_cuda.from_mont(state[:, 1])


def encrypt(key, nonce, msgs, perm_mont_fn=None):
    """Encrypt a batch: key (B, 2, D), nonce (B, D), msgs (B, L, D), all
    canonical int32 digit tensors on one device. Returns (ciphertext
    (B, L', D), tag (B, D)) where L' = L rounded up to the rate (padding
    words encrypt zeros and must be transmitted: the tag binds the padded
    length). perm_mont_fn defaults to ops.default_perm_mont_fn for key's
    device."""
    data = _pad(msgs)
    metrics.count("cipher.encrypts", int(key.shape[0]))
    metrics.count("perms.executed", int(key.shape[0]) * (1 + data.shape[1] // RATE))
    return _run(key, nonce, data, perm_mont_fn, decrypt=False)


def decrypt(key, nonce, ciphertext, tag, perm_mont_fn=None):
    """Decrypt and authenticate a batch. Returns (msgs (B, L, D), ok (B,)):
    rows where ok is False carry an invalid tag, and their plaintext must be
    discarded (it is returned only so that the batch keeps its shape)."""
    if ciphertext.dim() != 3 or ciphertext.shape[-1] != N_DIGITS:
        raise ValueError(f"data must be (B, L, {N_DIGITS}), got {tuple(ciphertext.shape)}")
    if ciphertext.shape[1] % RATE != 0:
        raise ValueError("ciphertext length must be a multiple of the rate")
    metrics.count("cipher.decrypts", int(ciphertext.shape[0]))
    metrics.count("perms.executed",
                  int(ciphertext.shape[0]) * (1 + ciphertext.shape[1] // RATE))
    msgs, tag2 = _run(key, nonce, ciphertext, perm_mont_fn, decrypt=True)
    ok = (tag2 == tag.to(tag2.device)).all(dim=-1)
    return msgs, ok
