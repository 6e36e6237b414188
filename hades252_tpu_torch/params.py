"""Parameter layer: the Hades252 constants, decoded bit-exactly.

PyTorch port of `hades252_tpu/params.py`. The port carries its own copy of
this layer because importing anything from `hades252_tpu` imports JAX, and
the GPU host has none. The asset blobs are not copied: they are read from
`hades252_tpu/assets/{ark,mds}.bin` by file path.

Each 32-byte little-endian record of the assets is a canonical field
element (SURVEY.md §2.2). Every derived form (Montgomery constants, the
sparse partial-round schedule) is computed once with exact Python ints and
handed out as numpy uint32 digit tables identical to the JAX package's, so
the two packages can be compared key by key.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

#: State width
WIDTH = 5
#: Total full rounds, R_F
TOTAL_FULL_ROUNDS = 8
#: Partial rounds, R_P
PARTIAL_ROUNDS = 59
#: Total rounds
ROUNDS = TOTAL_FULL_ROUNDS + PARTIAL_ROUNDS
#: Round constants consumed per permutation: 5 per round, 67 rounds = 335
CONSTANTS_PER_PERM = ROUNDS * WIDTH
#: Number of preloaded ARK constants
N_ROUND_CONSTANTS = 960

#: BLS12-381 scalar field modulus
P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# A field element is 16 little-endian digits of 16 bits. The CUDA kernels
# hold the same value as 8 limbs of 32 bits; both radices give R = 2^256,
# so Montgomery-domain values agree bit for bit across the two layouts.
DIGIT_BITS = 16
N_DIGITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1
LIMB_BITS = 32

#: Montgomery radix R = 2^256
R_EXP = DIGIT_BITS * N_DIGITS
R = 1 << R_EXP
R_MOD_P = R % P
R2_MOD_P = (R * R) % P
#: -p^{-1} mod R (full-word Montgomery constant, used by the digit REDC)
P_PRIME = (-pow(P, -1, R)) % R
#: -p^{-1} mod 2^32 (word-level constant of the 32-bit-limb CIOS kernels).
#: p = 1 (mod 2^32), so this is 2^32 - 1.
P_PRIME_WORD = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def int_to_digits(x: int, n: int = N_DIGITS) -> np.ndarray:
    """Decompose a non-negative int into n little-endian 16-bit digits."""
    if x < 0 or x >= (1 << (DIGIT_BITS * n)):
        raise ValueError(f"value out of range for {n} digits: {x}")
    return np.array(
        [(x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(n)], dtype=np.uint32
    )


def digits_to_int(d) -> int:
    """Recompose little-endian digits (any integer array) into a Python int."""
    d = np.asarray(d)
    return sum(int(v) << (DIGIT_BITS * i) for i, v in enumerate(d.reshape(-1)))


# ---------------------------------------------------------------------------
# Asset decoding (assets/ark.bin 960 x 32 B, assets/mds.bin 25 x 32 B)
# ---------------------------------------------------------------------------

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, "hades252_tpu", "assets"
)


def _load_scalars(name: str, count: int) -> list[int]:
    path = os.path.join(_ASSET_DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    if len(data) != count * 32:
        raise ValueError(f"{name}: expected {count * 32} bytes, got {len(data)}")
    vals = [int.from_bytes(data[i * 32 : (i + 1) * 32], "little") for i in range(count)]
    for i, v in enumerate(vals):
        if v >= P:
            raise ValueError(f"{name}[{i}] is not a canonical field element")
    return vals


@functools.cache
def round_constants_int() -> tuple[int, ...]:
    """All 960 ARK constants as canonical Python ints."""
    return tuple(_load_scalars("ark.bin", N_ROUND_CONSTANTS))


@functools.cache
def mds_matrix_int() -> tuple[tuple[int, ...], ...]:
    """The 5x5 MDS matrix as canonical Python ints, row-major."""
    flat = _load_scalars("mds.bin", WIDTH * WIDTH)
    return tuple(tuple(flat[i * WIDTH : (i + 1) * WIDTH]) for i in range(WIDTH))


def _to_mont(x: int) -> int:
    return (x * R_MOD_P) % P


# ---------------------------------------------------------------------------
# Sparse-factored partial-round schedule (exact algebraic transform)
#
# A partial round is s <- M @ sbox4(s + c). Split M = D @ S with
#   D = [[A, 0], [0, 1]]   (A = M[0:4, 0:4])
#   S = [[I, A^-1 v], [w, m]]   (v = M[0:4, 4], w = M[4, 0:4], m = M[4, 4]).
# D commutes with sbox4, so with x_r := D^-r @ (s_r + c_r) the chain is
#   x <- s + c_0
#   for r in 0..58:  x[4] <- sbox(x[4]);  x <- S_r @ x;  x += D^-(r+1) c_{r+1}
#   s_out <- D^59 @ x
# where S_r = [[I, A^-r u], [w A^r, m]] has 9 non-identity entries.
# ---------------------------------------------------------------------------


def _mat_mul(a, b):
    n, k, m2 = len(a), len(b), len(b[0])
    return tuple(
        tuple(sum(a[i][t] * b[t][j] for t in range(k)) % P for j in range(m2))
        for i in range(n)
    )


def _mat_vec(a, x):
    return tuple(sum(a[i][j] * x[j] for j in range(len(x))) % P for i in range(len(a)))


def _mat_inv(a):
    """Gauss-Jordan inverse mod P (exact; raises if singular)."""
    n = len(a)
    aug = [[a[i][j] % P for j in range(n)] + [1 if i == j else 0 for j in range(n)]
           for i in range(n)]
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r][col] != 0), None)
        if piv is None:
            raise ValueError("singular matrix")
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, P)
        aug[col] = [(x * inv) % P for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(aug[r][j] - f * aug[col][j]) % P for j in range(2 * n)]
    return tuple(tuple(row[n:]) for row in aug)


@functools.cache
def optimized_partial_int() -> dict:
    """Exact int-valued constants for the sparse partial-round schedule.

    Keys (canonical ints mod P): c0 (WIDTH,), u (PARTIAL_ROUNDS, 4),
    w (PARTIAL_ROUNDS, 4), m (scalar), d (PARTIAL_ROUNDS - 1, WIDTH),
    final (4, 4) = A^59.
    """
    mds = mds_matrix_int()
    ark = round_constants_int()
    half = TOTAL_FULL_ROUNDS // 2
    cs = [tuple(ark[(half + r) * WIDTH + i] for i in range(WIDTH))
          for r in range(PARTIAL_ROUNDS)]

    a_hat = tuple(tuple(mds[i][j] for j in range(4)) for i in range(4))
    v = tuple(mds[i][4] for i in range(4))
    w = tuple(mds[4][j] for j in range(4))
    m = mds[4][4]
    a_inv = _mat_inv(a_hat)
    u0 = _mat_vec(a_inv, v)

    ident = tuple(tuple(1 if i == j else 0 for j in range(4)) for i in range(4))
    a_pow = [ident]          # A^r
    a_inv_pow = [ident]      # A^-r
    for _ in range(PARTIAL_ROUNDS):
        a_pow.append(_mat_mul(a_pow[-1], a_hat))
        a_inv_pow.append(_mat_mul(a_inv_pow[-1], a_inv))

    u = tuple(_mat_vec(a_inv_pow[r], u0) for r in range(PARTIAL_ROUNDS))
    wr = tuple(_mat_vec(tuple(zip(*a_pow[r])), w) for r in range(PARTIAL_ROUNDS))
    d = tuple(
        tuple(_mat_vec(a_inv_pow[r + 1], cs[r + 1][:4])) + (cs[r + 1][4],)
        for r in range(PARTIAL_ROUNDS - 1)
    )
    return {
        "c0": cs[0],
        "u": u,
        "w": wr,
        "m": m,
        "d": d,
        "final": a_pow[PARTIAL_ROUNDS],
    }


@functools.cache
def perm_constants_np() -> dict[str, np.ndarray]:
    """Numpy digit tables of the dense schedule, equal key by key to
    `hades252_tpu.params.perm_constants_np()`.

    Keys: ark_mont (ROUNDS, WIDTH, N_DIGITS), mds_mont (WIDTH, WIDTH,
    N_DIGITS), p, p_prime, r2, one (N_DIGITS,), ark_full
    (N_ROUND_CONSTANTS, N_DIGITS). All uint32.
    """
    ark = round_constants_int()
    mds = mds_matrix_int()
    ark_mont = np.stack(
        [int_to_digits(_to_mont(c)) for c in ark[:CONSTANTS_PER_PERM]]
    ).reshape(ROUNDS, WIDTH, N_DIGITS)
    mds_mont = np.stack(
        [int_to_digits(_to_mont(m)) for row in mds for m in row]
    ).reshape(WIDTH, WIDTH, N_DIGITS)
    ark_full = np.stack([int_to_digits(c) for c in ark])
    return {
        "ark_mont": ark_mont,
        "mds_mont": mds_mont,
        "p": int_to_digits(P),
        "p_prime": int_to_digits(P_PRIME),
        "r2": int_to_digits(R2_MOD_P),
        "one": int_to_digits(1),
        "ark_full": ark_full,
    }


@functools.cache
def opt_schedule_np() -> dict[str, np.ndarray]:
    """Montgomery-form digit tables of the sparse schedule, equal key by
    key to `hades252_tpu.params.opt_schedule_np()`.

    Keys: ark_fr (TOTAL_FULL_ROUNDS, WIDTH, N_DIGITS) for global rounds
    0..3 and 63..66; c0 (WIDTH, N_DIGITS); u, w (PARTIAL_ROUNDS, 4,
    N_DIGITS); m (1, N_DIGITS); d (PARTIAL_ROUNDS, WIDTH, N_DIGITS), last
    row zero; final (4, 4, N_DIGITS) = A^59. All uint32.
    """
    opt = optimized_partial_int()
    half = TOTAL_FULL_ROUNDS // 2
    ark = round_constants_int()

    def mont_digits(x):
        return int_to_digits(_to_mont(x))

    fr_rounds = list(range(half)) + list(range(half + PARTIAL_ROUNDS, ROUNDS))
    ark_fr = np.stack(
        [np.stack([mont_digits(ark[g * WIDTH + i]) for i in range(WIDTH)])
         for g in fr_rounds]
    )
    d = np.zeros((PARTIAL_ROUNDS, WIDTH, N_DIGITS), np.uint32)
    for r, row in enumerate(opt["d"]):
        d[r] = np.stack([mont_digits(x) for x in row])
    return {
        "ark_fr": ark_fr,
        "c0": np.stack([mont_digits(x) for x in opt["c0"]]),
        "u": np.stack([np.stack([mont_digits(x) for x in row]) for row in opt["u"]]),
        "w": np.stack([np.stack([mont_digits(x) for x in row]) for row in opt["w"]]),
        "m": mont_digits(opt["m"])[None],
        "d": d,
        "final": np.stack(
            [np.stack([mont_digits(x) for x in row]) for row in opt["final"]]
        ),
    }


def from_jax_tables(perm_constants: dict, opt_schedule: dict) -> dict[str, torch.Tensor]:
    """Carry numpy digit tables (the JAX package's `perm_constants_np()` and
    `opt_schedule_np()`, or this module's equal copies) across as the
    port's int32 CPU tensors, one key per table. The two dicts share no
    key; a clash raises."""
    out = {}
    for src in (perm_constants, opt_schedule):
        for k, v in src.items():
            if k in out:
                raise ValueError(f"table {k!r} given twice")
            v = np.asarray(v)
            if v.dtype != np.uint32 or v.shape[-1] != N_DIGITS or (v >> DIGIT_BITS).any():
                raise ValueError(f"table {k!r} is not a uint32 16-bit digit array")
            out[k] = torch.from_numpy(v.astype(np.int32))
    return out


@functools.cache
def perm_tables() -> dict[str, torch.Tensor]:
    """The port's constant tensors (int32 digits, CPU): every key of
    `perm_constants_np()` and `opt_schedule_np()`."""
    return from_jax_tables(perm_constants_np(), opt_schedule_np())


def digits_to_limbs(digits: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit digits -> (..., 8) uint32 limbs of 32 bits, the
    layout of the CUDA kernels' constant tables."""
    d = np.asarray(digits).astype(np.uint32)
    return np.ascontiguousarray(d[..., 0::2] | (d[..., 1::2] << np.uint32(DIGIT_BITS)))
