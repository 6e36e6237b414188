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
def dot_schedule_int() -> dict:
    """The full-expansion partial-round schedule, equal to
    `hades252_tpu.params.dot_schedule_int()` (hades252_tpu/params.py:253).

    The 59 partial rounds apply the S-box to word 4 only, so the whole chain
    is affine except for the 59 S-box outputs. Over the basis
        e = [1, x_0..x_4, s_0..s_58]          (65 elements)
    where x_i is the state entering the chain (after full round 3's MDS,
    before any partial ARK) and s_r the r-th partial S-box output, every
    S-box input and the chain's output are fixed linear maps:
        t_r       = alpha[r] . e[:6+r]        (s_r = t_r^5)
        state_out = omega    . e
    with every ARK constant folded into the coefficient of basis element 1.

    Returns canonical ints mod P: alpha, a tuple of 59 tuples (alpha[r] has
    length 6+r), and omega, (5, 65).
    """
    mds = mds_matrix_int()
    ark = round_constants_int()
    half = TOTAL_FULL_ROUNDS // 2
    n_basis = 1 + WIDTH + PARTIAL_ROUNDS

    def unit(j):
        return [1 if i == j else 0 for i in range(n_basis)]

    state = [unit(1 + i) for i in range(WIDTH)]
    alpha = []
    for r in range(PARTIAL_ROUNDS):
        for i in range(WIDTH):
            state[i][0] = (state[i][0] + ark[(half + r) * WIDTH + i]) % P
        alpha.append(tuple(state[4][: 6 + r]))
        state[4] = unit(6 + r)
        state = [
            [sum(mds[k][j] * state[j][b] for j in range(WIDTH)) % P for b in range(n_basis)]
            for k in range(WIDTH)
        ]
    return {"alpha": tuple(alpha), "omega": tuple(tuple(row) for row in state)}


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


# ---------------------------------------------------------------------------
# The mxu8 schedule's constant matmul weights (hades252_tpu/params.py:347-402)
#
# A 256-bit value enters a constant product as 32 byte rows; a weight block
# is the Toeplitz matrix of the constant's bytes, so (weights @ byte rows)
# gives the base-256 columns, un-carried, of constant * value.
# ---------------------------------------------------------------------------


def _byte_pos(r: int) -> int:
    """Byte position encoded by input row r of the byte-row layout: rows
    0..15 are the low bytes of 16-bit digits 0..15 (positions 0, 2, .., 30),
    rows 16..31 the high bytes (positions 1, 3, .., 31)."""
    return 2 * r if r < N_DIGITS else 2 * (r - N_DIGITS) + 1


def _value_bytes(x: int) -> list[int]:
    return list(int(x).to_bytes(32, "little"))


def _toeplitz_rows(value: int, n_cols: int) -> np.ndarray:
    """(n_cols, 32) float32 weight block: W[c, r] = byte_{c - pos(r)} of
    value, so W @ (byte rows of a variable) = the base-256 columns of
    value * variable."""
    vb = _value_bytes(value)
    w = np.zeros((n_cols, 2 * N_DIGITS), np.float32)
    for r in range(2 * N_DIGITS):
        pos = _byte_pos(r)
        for c in range(n_cols):
            e = c - pos
            if 0 <= e < 32:
                w[c, r] = vb[e]
    return w


@functools.cache
def mxu_weights_np() -> dict[str, np.ndarray]:
    """The mxu8 schedule's weights as float32 arrays of bytes 0..255, equal
    key by key to `hades252_tpu.params.mxu_weights_np()`.

    w_lin (5*63, 5*32): the Montgomery MDS as one digit convolution; row
      k*63+c is base-256 column c of sum_j mds_mont[k][j] * state[j], column
      j*32+r is byte row r of state word j. Max column sum 160*255^2 < 2^24.
    w_pp (32, 32): truncated Toeplitz of P' = -p^-1 mod R (byte rows of
      T_lo -> columns of T_lo P' mod R, columns >= 32 dropped).
    w_p (63, 32): Toeplitz of p (byte rows of m -> columns of m p).
    """
    mds = mds_matrix_int()
    w_lin = np.zeros((WIDTH * 63, WIDTH * 2 * N_DIGITS), np.float32)
    for k in range(WIDTH):
        for j in range(WIDTH):
            w_lin[k * 63 : (k + 1) * 63, j * 32 : (j + 1) * 32] = (
                _toeplitz_rows(_to_mont(mds[k][j]), 63)
            )
    return {
        "w_lin": w_lin,
        "w_pp": _toeplitz_rows(P_PRIME, 32),
        "w_p": _toeplitz_rows(P, 63),
    }


#: Rows of one output word's weight block in the CUDA kernel's tables: the
#: 63 base-256 columns padded to a multiple of the MMA's 16 rows.
MXU8_BLOCK_ROWS = 64

# K index in the kernel's layout = byte position: column pos(r) <- row r
_NATURAL_ORDER = np.argsort([_byte_pos(r) for r in range(2 * N_DIGITS)])


def _natural_k(w: np.ndarray) -> np.ndarray:
    """Reorder the K (last) axis of byte weights from the JAX layout to
    natural byte order inside every 32-byte element block."""
    k = w.shape[-1]
    order = np.concatenate([j * 32 + _NATURAL_ORDER for j in range(k // 32)])
    return w[..., order]


def _pad_blocks(w: np.ndarray) -> np.ndarray:
    """(..., 63 n, K) byte weights -> (..., 64 n, K) uint8: every 63-row
    block followed by a zero row."""
    *lead, rows, k = w.shape
    n = rows // 63
    out = np.zeros((*lead, n, MXU8_BLOCK_ROWS, k), np.uint8)
    out[..., :63, :] = w.reshape(*lead, n, 63, k)
    return out.reshape(*lead, n * MXU8_BLOCK_ROWS, k)


def _kernel_weights(w_lin: np.ndarray, w_pp: np.ndarray, w_p: np.ndarray) -> dict:
    """Byte weights in the JAX layout -> the CUDA kernel's: uint8, the K
    axis in natural byte order (so a word's byte rows are its 32-bit limbs as
    stored), and every 63-row block padded with a zero row to 64."""
    return {
        "w_lin": _pad_blocks(_natural_k(w_lin)),
        "w_pp": np.ascontiguousarray(_natural_k(w_pp)),
        "w_p": _pad_blocks(_natural_k(w_p)),
    }


def _as_bytes(w: np.ndarray, key: str) -> np.ndarray:
    w = np.asarray(w)
    if (w < 0).any() or (w > 255).any() or (w != np.round(w)).any():
        raise ValueError(f"{key} is not a table of bytes")
    return w.astype(np.uint8)


@functools.cache
def mxu8_tables() -> dict[str, np.ndarray]:
    """The CUDA mxu8 kernel's tables (`ops/csrc/perm_mxu8.cu`): ark_mont
    (ROUNDS, WIDTH, N_DIGITS) and r2 (N_DIGITS,) uint32 digits; w_lin
    (320, 160), w_pp (32, 32), w_p (64, 32) uint8, unsigned bytes (Hopper's
    integer MMA takes .u8 operands, so no offset encoding)."""
    w = mxu_weights_np()
    c = perm_constants_np()
    return {"ark_mont": c["ark_mont"], "r2": c["r2"],
            **_kernel_weights(*(_as_bytes(w[k], k) for k in ("w_lin", "w_pp", "w_p")))}


def from_jax_mxu8_tables(consts) -> dict[str, np.ndarray]:
    """Carry the JAX package's mxu8 constants across: `consts` is the tuple
    of `hades252_tpu/ops/perm_pallas.py:_const_arrays_mxu8()`, (ark_mont,
    fc, w_lin, w_pp, w_p as int8 weights offset by -128, and their int32
    row sums). Checks every row sum against its weights and fc's modulus,
    and returns the tables of `mxu8_tables()`."""
    ark, fc, *rest = consts
    if len(rest) != 6:
        raise ValueError(f"expected 8 arrays, got {2 + len(rest)}")
    fc = np.asarray(fc)
    if not np.array_equal(fc[0], int_to_digits(P)):
        raise ValueError("fc[0] is not the modulus p")
    unsigned = []
    for key, w_s8, rowsum in zip(("w_lin", "w_pp", "w_p"), rest[:3], rest[3:]):
        w_s8 = np.asarray(w_s8)
        if w_s8.dtype != np.int8:
            raise ValueError(f"{key} is not int8")
        if not np.array_equal(w_s8.astype(np.int32).sum(axis=1, keepdims=True),
                              np.asarray(rowsum)):
            raise ValueError(f"{key}: row sums do not match the weights")
        unsigned.append((w_s8.astype(np.int32) + 128).astype(np.uint8))
    return {"ark_mont": np.asarray(ark, np.uint32), "r2": fc[2].astype(np.uint32),
            **_kernel_weights(*unsigned)}


def mxu_tables() -> dict[str, np.ndarray]:
    """The CUDA mxu kernel's tables (`ops/csrc/perm_mxu.cu`): the keys,
    shapes and bytes of `mxu8_tables()`. The kernel keeps the weights and
    the byte rows as bytes in shared memory and widens them to bf16 in
    registers when it loads an MMA fragment (0..255 are exact in bf16), so
    it takes mxu8's layout unchanged: uint8, K in natural byte order, every
    63-row block padded to 64."""
    return mxu8_tables()


def from_jax_mxu_tables(consts) -> dict[str, np.ndarray]:
    """Carry the JAX package's mxu constants across: `consts` is the tuple
    of `hades252_tpu/ops/perm_pallas.py:_const_arrays_mxu(as_bf16=False)`,
    (ark_mont, fc, w_lin, w_pp, w_p with the weights as float32 arrays of
    bytes). Checks fc's modulus, that every weight is a byte, and that the
    result equals the port's own `mxu_tables()`, which it returns."""
    if len(consts) != 5:
        raise ValueError(f"expected 5 arrays, got {len(consts)}")
    ark, fc, *weights = consts
    fc = np.asarray(fc)
    if not np.array_equal(fc[0], int_to_digits(P)):
        raise ValueError("fc[0] is not the modulus p")
    carried = {"ark_mont": np.asarray(ark, np.uint32), "r2": fc[2].astype(np.uint32),
               **_kernel_weights(*(_as_bytes(w, k)
                                   for w, k in zip(weights, ("w_lin", "w_pp", "w_p"))))}
    own = mxu_tables()
    for key, want in own.items():
        if carried[key].shape != want.shape or not np.array_equal(carried[key], want):
            raise ValueError(f"{key} differs from the port's own table")
    return carried


# ---------------------------------------------------------------------------
# The hyb and hybp schedules' weights (hades252_tpu/params.py:405-522)
#
# Unsigned bytes throughout: Hopper's integer MMA takes .u8 operands, so
# there is no offset encoding, no row sums and no running column sum. Basis
# elements that are absent or not yet computed meet zero weights, so their
# bytes never count, whatever they are.
# ---------------------------------------------------------------------------

#: Rounds 0..26 touch at most 32 basis elements, rounds 27..58 at most 64;
#: each segment's weights are zero-padded to the segment's width.
HYB_SEG1_ROUNDS = 27
HYB_SEG1_ELEMS = 32
HYB_SEG2_ELEMS = 64
HYB_N_BASIS = 1 + WIDTH + PARTIAL_ROUNDS  # 65
#: Bytes of one state's basis buffer in the CUDA kernels: 65 elements of 32
#: bytes and one of padding, so that every K is a multiple of 64.
HYB_KERNEL_K_OUT = 32 * (HYB_N_BASIS + 1)


def _coeff_row_block(coeffs, n_elems: int) -> np.ndarray:
    """One weight block (63, 32 n_elems) uint8: per basis element j the
    Toeplitz byte block of its Montgomery-form coefficient, zero where the
    coefficient is absent or zero."""
    w = np.zeros((63, 32 * n_elems), np.uint8)
    for j, c in enumerate(coeffs):
        if c:
            w[:, 32 * j : 32 * (j + 1)] = _toeplitz_rows(_to_mont(c), 63)
    return w


def _chain_extras() -> dict[str, np.ndarray]:
    return {
        "pmul17": np.stack([int_to_digits(k * P, N_DIGITS + 1) for k in (16, 8, 4, 2, 1)]),
        "one_mont": int_to_digits(R_MOD_P),
    }


@functools.cache
def hyb_weights_np() -> dict[str, np.ndarray]:
    """The hyb schedule's weights in the JAX layout (K axis: low bytes of
    the 16 digits, then high bytes, per element), as unsigned bytes: each
    equals `hades252_tpu.params.hyb_weights_np()`'s int8 array plus 128.

    w_seg1 (27, 63, 32*32): rounds 0..26; w_seg2 (32, 63, 32*64): rounds
    27..58; w_out (5*63, 32*65): the chain's exit map omega, word k in rows
    63k..63k+62; pmul17 (5, 17) uint32: 16p, 8p, 4p, 2p, p as 17 digits,
    the conditional-subtract ladder of the big REDC (t < 31p); one_mont
    (N_DIGITS,) uint32: basis element 0, R mod p.
    """
    d = dot_schedule_int()
    alpha, omega = d["alpha"], d["omega"]
    return {
        "w_seg1": np.stack([_coeff_row_block(alpha[r], HYB_SEG1_ELEMS)
                            for r in range(HYB_SEG1_ROUNDS)]),
        "w_seg2": np.stack([_coeff_row_block(alpha[r], HYB_SEG2_ELEMS)
                            for r in range(HYB_SEG1_ROUNDS, PARTIAL_ROUNDS)]),
        "w_out": np.concatenate([_coeff_row_block(row, HYB_N_BASIS) for row in omega]),
        **_chain_extras(),
    }


@functools.cache
def hybp_weights_np() -> dict[str, np.ndarray]:
    """The hybp schedule's weights, unsigned, in the JAX layout: round r's
    dot splits into the big one over the older elements (wo_seg1, wo_seg2:
    as hyb's with the newest element's block zeroed, round 0 kept whole) and
    a small one of the newest element s_{r-1} alone (w_new (59, 63, 32), row
    0 unused and zero). w_out, pmul17 and one_mont are hyb's."""
    alpha = dot_schedule_int()["alpha"]

    def older(r, n_pad):
        coeffs = list(alpha[r])
        if r > 0:
            coeffs[-1] = 0
        return _coeff_row_block(coeffs, n_pad)

    base = hyb_weights_np()
    return {
        "wo_seg1": np.stack([older(r, HYB_SEG1_ELEMS) for r in range(HYB_SEG1_ROUNDS)]),
        "wo_seg2": np.stack([older(r, HYB_SEG2_ELEMS)
                             for r in range(HYB_SEG1_ROUNDS, PARTIAL_ROUNDS)]),
        "w_new": np.stack([_coeff_row_block(alpha[r][-1:] if r > 0 else (), 1)
                           for r in range(PARTIAL_ROUNDS)]),
        **{k: base[k] for k in ("w_out", "pmul17", "one_mont")},
    }


_HYB_WEIGHT_KEYS = ("w_seg1", "w_seg2", "w_out")
_HYBP_WEIGHT_KEYS = ("wo_seg1", "wo_seg2", "w_new", "w_out")


def _chain_tables(weights: dict, keys) -> dict[str, np.ndarray]:
    """Chain weights in the JAX layout -> the CUDA kernels': the K axis of
    every 32-byte element block in natural byte order, every 63-row block
    padded to 64, and w_out's K axis padded with one zero element block to
    HYB_KERNEL_K_OUT (the kernels' dot over the basis steps 64 bytes of K at
    a time); one_mont rides along."""
    out = {k: _pad_blocks(_natural_k(weights[k])) for k in keys}
    out["w_out"] = np.pad(out["w_out"], ((0, 0), (0, HYB_KERNEL_K_OUT - out["w_out"].shape[1])))
    out["one_mont"] = np.asarray(weights["one_mont"], np.uint32)
    return out


@functools.cache
def hyb_tables() -> dict[str, np.ndarray]:
    """The chain tables of the CUDA hyb and hyb13 kernels
    (`ops/csrc/perm_hybp.cu`): w_seg1 (27, 64, 1024),
    w_seg2 (32, 64, 2048), w_out (320, 2112) uint8 and one_mont (N_DIGITS,)
    uint32. Their full rounds use `mxu8_tables()`."""
    return _chain_tables(hyb_weights_np(), _HYB_WEIGHT_KEYS)


@functools.cache
def hybp_tables() -> dict[str, np.ndarray]:
    """The CUDA hybp kernel's chain tables: wo_seg1 (27, 64, 1024), wo_seg2
    (32, 64, 2048), w_new (59, 64, 32), w_out (320, 2112) uint8 and
    one_mont."""
    return _chain_tables(hybp_weights_np(), _HYBP_WEIGHT_KEYS)


def _from_jax_chain(weights: dict, keys) -> dict[str, np.ndarray]:
    """Carry one of the JAX package's chain dictionaries across: int8
    weights offset by -128 under `keys`, their int32 row sums under the
    same names with "rs" for the leading "w", pmul17 and one_mont. Checks
    every row sum, the ladder and R mod p."""
    extras = _chain_extras()
    for key, want in extras.items():
        if not np.array_equal(np.asarray(weights[key]), want):
            raise ValueError(f"{key} does not match the modulus")
    unsigned = dict(extras)
    for key in keys:
        w_s8 = np.asarray(weights[key])
        if w_s8.dtype != np.int8:
            raise ValueError(f"{key} is not int8")
        rowsum = np.asarray(weights["rs" + key[1:]])
        if not np.array_equal(w_s8.sum(axis=-1, keepdims=True, dtype=np.int32), rowsum):
            raise ValueError(f"{key}: row sums do not match the weights")
        unsigned[key] = (w_s8.astype(np.int32) + 128).astype(np.uint8)
    return _chain_tables(unsigned, keys)


def from_jax_hyb_tables(weights: dict) -> dict[str, np.ndarray]:
    """`hades252_tpu.params.hyb_weights_np()`, as numpy arrays, -> the
    tables of `hyb_tables()`."""
    return _from_jax_chain(weights, _HYB_WEIGHT_KEYS)


def from_jax_hybp_tables(weights: dict) -> dict[str, np.ndarray]:
    """`hades252_tpu.params.hybp_weights_np()`, as numpy arrays, -> the
    tables of `hybp_tables()`."""
    return _from_jax_chain(weights, _HYBP_WEIGHT_KEYS)


def digits_to_limbs(digits: np.ndarray) -> np.ndarray:
    """(..., 16) 16-bit digits -> (..., 8) uint32 limbs of 32 bits, the
    layout of the CUDA kernels' constant tables."""
    d = np.asarray(digits).astype(np.uint32)
    return np.ascontiguousarray(d[..., 0::2] | (d[..., 1::2] << np.uint32(DIGIT_BITS)))
