"""Regenerate the Hades252 constant assets from first principles.

Port of `hades252_tpu/utils/asset_gen.py`: its bytes equal the asset blobs
the port's `params` reads by path (tests/test_torch_plonk.py).

Independent reimplementation of the reference's asset-generation recipes
(reference: assets/HOWTO.md:21-53 for ark.bin, :69-113 for mds.bin) so the
vendored binaries are reproducible, not trusted blobs:

  * ARK: a SHA-512 chain seeded with b"poseidon-for-plonk"; each constant is
    c_k = from_bytes_wide(h_k) + c_{k-1} (c_{-1} = 1), where from_bytes_wide
    interprets the 64-byte digest as a little-endian integer reduced mod p.
  * MDS: the 5x5 Cauchy matrix 1/(x_i + y_j) with x_i = i, y_j = j + 5.
  * Serialization: `internal_repr()` = the MONTGOMERY form (value * R mod p,
    R = 2^256) as 4 u64 little-endian limbs — this is why the loader treats
    the stored bytes as the *effective* canonical constants (SURVEY.md §2.2:
    the reference decodes them with from_raw, i.e. without converting back).
"""

from __future__ import annotations

import hashlib

from ..params import N_ROUND_CONSTANTS, P, R, WIDTH

_R_MOD_P = R % P


def _internal_repr(x: int) -> bytes:
    """Serialize a canonical field element the way the reference does:
    Montgomery limbs, 32 bytes little-endian (HOWTO.md:44-47, 102-107)."""
    return ((x * _R_MOD_P) % P).to_bytes(32, "little")


def generate_ark() -> bytes:
    """The 960 round constants, bit-identical to assets/ark.bin."""
    out = []
    prev = 1  # BlsScalar::one() (HOWTO.md:23)
    digest = b"poseidon-for-plonk"
    for _ in range(N_ROUND_CONSTANTS):
        digest = hashlib.sha512(digest).digest()
        wide = int.from_bytes(digest, "little") % P  # from_bytes_wide
        c = (wide + prev) % P
        out.append(_internal_repr(c))
        prev = c
    return b"".join(out)


def generate_mds() -> bytes:
    """The 5x5 Cauchy MDS matrix, bit-identical to assets/mds.bin."""
    out = []
    for i in range(WIDTH):
        for j in range(WIDTH):
            out.append(_internal_repr(pow(i + j + WIDTH, -1, P)))
    return b"".join(out)
