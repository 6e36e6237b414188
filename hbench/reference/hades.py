"""The plain reference of the Hades252 permutation and of the arity-4 tree.

Written for this benchmark from the published definition, and independent of
the package under test: it imports nothing of it. The constants are read from
the asset blobs (`hades252_tpu/assets/ark.bin`, `mds.bin`: 32-byte
little-endian canonical scalars) by path.

The permutation over BLS12-381's scalar field: width 5, 4 full rounds, 59
partial rounds, 4 full rounds. A round adds 5 round constants (in partial
rounds too), raises every word (full) or the last word (partial) to the 5th
power, and multiplies the state by the 5 x 5 MDS matrix; the constants
iterator restarts at 0 on each call.

Two forms:

- `perm_int`: one state of Python ints, the schedule written out (the
  transcripts' permutation);
- `permute`: a batch of states as torch tensors of 16-bit digits, vectorised
  over the batch, on any device. Field elements are 17 digits in int64 in a
  Montgomery domain of R = 2^272, kept below 2p and only partly carried
  between operations: R > 4p lets every product and MDS row be reduced
  without a conditional subtraction. The products by constants (the MDS
  rows, the Montgomery factors) are float64 matrix products, exact because
  every partial sum stays below 2^53. The carry into the upper half of a
  reduction is read from the float64 sum of the top columns of the lower
  half: that half is an exact multiple of R, so the sum is an integer that
  rounding recovers.

`partial_rounds` may be set below 59 only to build the benchmark's control.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
WIDTH = 5
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 59
ARITY = 4
TAG = ARITY          # the capacity word of a tree node
DIGEST_INDEX = 1     # the node's digest is word 1 of the permuted state

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                      "hades252_tpu", "assets")

_BITS = 16
_MASK = (1 << _BITS) - 1
_N = 17                       # digits of an element here
_R = 1 << (_BITS * _N)        # Montgomery radix 2^272
_P_PRIME = (-pow(P, -1, _R)) % _R


def _scalars(name: str, count: int) -> list[int]:
    with open(os.path.join(ASSETS, name), "rb") as f:
        data = f.read()
    if len(data) != 32 * count:
        raise ValueError(f"{name}: {len(data)} bytes, expected {32 * count}")
    vals = [int.from_bytes(data[32 * i:32 * i + 32], "little") for i in range(count)]
    if any(v >= P for v in vals):
        raise ValueError(f"{name}: a value is not canonical")
    return vals


@functools.cache
def round_constants() -> tuple[int, ...]:
    return tuple(_scalars("ark.bin", 960))


@functools.cache
def mds() -> tuple[tuple[int, ...], ...]:
    flat = _scalars("mds.bin", WIDTH * WIDTH)
    return tuple(tuple(flat[WIDTH * i:WIDTH * i + WIDTH]) for i in range(WIDTH))


def perm_int(words, partial_rounds: int = PARTIAL_ROUNDS) -> list[int]:
    """The permutation of one state of 5 canonical ints."""
    if len(words) != WIDTH:
        raise ValueError(f"a state has {WIDTH} words")
    s = [int(w) % P for w in words]
    ark, m = iter(round_constants()), mds()
    half = FULL_ROUNDS // 2
    for r in range(FULL_ROUNDS + partial_rounds):
        s = [(w + next(ark)) % P for w in s]
        if r < half or r >= half + partial_rounds:
            s = [pow(w, 5, P) for w in s]
        else:
            s[-1] = pow(s[-1], 5, P)
        s = [sum(m[i][j] * s[j] for j in range(WIDTH)) % P for i in range(WIDTH)]
    return s


# ---------------------------------------------------------------------------
# Digits
# ---------------------------------------------------------------------------


def int_digits(x: int, n: int = _N) -> list[int]:
    return [(x >> (_BITS * i)) & _MASK for i in range(n)]


def ints_to_digits(values) -> np.ndarray:
    """Canonical ints -> (..., 16) uint16-valued int32 digits, little-endian."""
    arr = np.asarray(values, dtype=object)
    flat = [int(v) for v in arr.reshape(-1)]
    buf = b"".join(v.to_bytes(32, "little") for v in flat)
    out = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return out.reshape(arr.shape + (16,))


def digits_to_ints(digits) -> list:
    """(..., 16) digits (numpy or tensor) -> nested lists of Python ints."""
    d = np.asarray(digits.cpu() if isinstance(digits, torch.Tensor) else digits)
    flat = d.reshape(-1, d.shape[-1]).astype("<u2").tobytes()
    n = 2 * d.shape[-1]
    vals = [int.from_bytes(flat[n * i:n * i + n], "little") for i in range(len(flat) // n)]
    return np.asarray(vals, dtype=object).reshape(d.shape[:-1]).tolist()


def _toeplitz(digits: list[int], rows: int, cols: int) -> np.ndarray:
    """W[c, j] = digits[j - c]: x (rows digits) @ W = the columns of x times
    the constant, cut to `cols` columns."""
    w = np.zeros((rows, cols))
    for c in range(rows):
        for k, v in enumerate(digits):
            if c + k < cols:
                w[c, c + k] = v
    return w


class _Tables:
    """The constants of `permute` on one device."""

    def __init__(self, device: torch.device):
        f64 = functools.partial(torch.tensor, dtype=torch.float64, device=device)
        self.pprime = f64(_toeplitz(int_digits(_P_PRIME), _N, _N))
        self.p = f64(_toeplitz(int_digits(P), _N, 2 * _N))
        mont = lambda x: x * _R % P
        self.r2 = f64(_toeplitz(int_digits(_R * _R % P), _N, 2 * _N))
        # x * 2^256 and x * 2^-256 (the package's own Montgomery radix)
        self.to256 = f64(_toeplitz(int_digits((1 << 256) * _R % P), _N, 2 * _N))
        self.from256 = f64(_toeplitz(int_digits(pow(1 << 256, -1, P) * _R % P), _N, 2 * _N))
        m = mds()
        w = np.zeros((WIDTH, _N, WIDTH, 2 * _N))
        for i in range(WIDTH):
            for k in range(WIDTH):
                w[k, :, i, :] = _toeplitz(int_digits(mont(m[i][k])), _N, 2 * _N)
        self.mds = f64(w.reshape(WIDTH * _N, WIDTH * 2 * _N))
        ark = [int_digits(mont(c)) for c in round_constants()]
        self.ark = torch.tensor(ark, dtype=torch.int64, device=device)
        self.low = f64([2.0 ** (_BITS * (c - _N)) for c in range(_N - 4, _N)])


@functools.cache
def _tables(device: torch.device) -> _Tables:
    return _Tables(device)


def _carry(d: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Move each digit's bits above 16 into the next digit, `passes` times
    over the whole row at once: from digits below 2^40 to digits of at most
    2^16. The carry out of the top digit is dropped (it is 0 wherever the
    value fits, and the reduction mod R where that is wanted)."""
    for _ in range(passes):
        d = (d & _MASK) + F.pad(d[..., :-1] >> _BITS, (1, 0))
    return d


def _redc(cols: torch.Tensor, t: _Tables) -> torch.Tensor:
    """Montgomery reduction of 34 column sums (each below 2^45) of a value T
    below R p: 17 digits of T R^-1 mod p, a value below 2p."""
    cols = _carry(cols)
    m = _carry((cols[..., :_N].double() @ t.pprime).long())        # T p' mod R
    u = cols + (m.double() @ t.p).long()                             # T + m p
    into = (u[..., _N - 4:_N].double() @ t.low).round().long()      # (its low half) / R
    high = u[..., _N:].clone()
    high[..., 0] += into
    return _carry(high)


def _mul(a: torch.Tensor, b: torch.Tensor, t: _Tables) -> torch.Tensor:
    prods = a[..., :, None] * b[..., None, :]
    lead = prods.shape[:-2]
    skew = F.pad(prods, (0, _N + 1)).reshape(*lead, _N * (2 * _N + 1))
    cols = skew[..., :2 * _N * _N].reshape(*lead, _N, 2 * _N).sum(-2)
    return _redc(cols, t)


def _sbox(x: torch.Tensor, t: _Tables) -> torch.Tensor:
    x2 = _mul(x, x, t)
    return _mul(_mul(x2, x2, t), x, t)


def _by_const(x: torch.Tensor, table: torch.Tensor, t: _Tables) -> torch.Tensor:
    return _redc((x.double() @ table).long(), t)


def _canonical(x: torch.Tensor) -> torch.Tensor:
    """17 lazily carried digits of a value below 2p -> 16 canonical digits."""
    digits, carry = [], torch.zeros_like(x[..., 0])
    for i in range(_N):
        v = x[..., i] + carry
        digits.append(v & _MASK)
        carry = v >> _BITS
    d = torch.stack(digits, -1)
    diff, borrow = [], torch.zeros_like(d[..., 0])
    p = int_digits(P)
    for i in range(_N):
        v = d[..., i] - p[i] - borrow
        borrow = (v < 0).long()
        diff.append(v + (borrow << _BITS))
    d = torch.where((borrow == 0)[..., None], torch.stack(diff, -1), d)
    return d[..., :16].to(torch.int32)


def _lift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x.to(torch.int64), (0, _N - x.shape[-1]))


def permute(states: torch.Tensor, partial_rounds: int = PARTIAL_ROUNDS,
            block: int = 1 << 16) -> torch.Tensor:
    """The permutation of (B, 5, 16) canonical digits, on their device, in
    blocks of `block` states; returns (B, 5, 16) int32 canonical digits."""
    if states.dim() != 3 or states.shape[1:] != (WIDTH, 16):
        raise ValueError(f"expected (B, {WIDTH}, 16), got {tuple(states.shape)}")
    return torch.cat([_permute_block(states[i:i + block], partial_rounds)
                      for i in range(0, states.shape[0], block)] or [states])


def _permute_block(states: torch.Tensor, partial_rounds: int) -> torch.Tensor:
    t = _tables(states.device)
    b = states.shape[0]
    s = _by_const(_lift(states), t.r2, t)
    half = FULL_ROUNDS // 2
    for r in range(FULL_ROUNDS + partial_rounds):
        s = s + t.ark[WIDTH * r:WIDTH * r + WIDTH]
        if r < half or r >= half + partial_rounds:
            s = _sbox(s, t)
        else:
            s = torch.cat([s[:, :WIDTH - 1], _sbox(s[:, WIDTH - 1:], t)], 1)
        cols = (s.reshape(b, WIDTH * _N).double() @ t.mds).long()
        s = _redc(cols.reshape(b, WIDTH, 2 * _N), t)
    return _canonical(_redc(F.pad(s, (0, _N)), t))


def to_mont256(x: torch.Tensor) -> torch.Tensor:
    """Canonical digits -> the digits of x 2^256 mod p, the package's
    Montgomery form, worked out again here."""
    t = _tables(x.device)
    return _canonical(_by_const(_lift(x), t.to256, t))


def from_mont256(x: torch.Tensor) -> torch.Tensor:
    """Digits of any value below 2^256 -> canonical digits of x 2^-256 mod p."""
    t = _tables(x.device)
    return _canonical(_by_const(_lift(x), t.from256, t))


# ---------------------------------------------------------------------------
# The arity-4 tree
# ---------------------------------------------------------------------------


def _tag(n: int, device) -> torch.Tensor:
    tag = torch.zeros((n, 1, 16), dtype=torch.int32, device=device)
    tag[:, 0, 0] = TAG
    return tag


def tree_levels(leaves: torch.Tensor, partial_rounds: int = PARTIAL_ROUNDS) -> list:
    """Every level of the tree over (N, 16) canonical leaves, leaves first,
    as canonical digits: the leaves zero-padded to a power of 4, each parent
    word 1 of perm([4, c0, c1, c2, c3])."""
    n, full = leaves.shape[0], 1
    while full < n:
        full *= ARITY
    level = F.pad(leaves.to(torch.int32), (0, 0, 0, full - n))
    levels = [level]
    while level.shape[0] > 1:
        k = level.shape[0] // ARITY
        states = torch.cat([_tag(k, level.device), level.reshape(k, ARITY, 16)], 1)
        level = permute(states, partial_rounds)[:, DIGEST_INDEX]
        levels.append(level)
    return levels


def walk(leaves: torch.Tensor, sibs: torch.Tensor, poss: torch.Tensor,
         partial_rounds: int = PARTIAL_ROUNDS) -> torch.Tensor:
    """Walk K openings up to their roots: leaves (K, 16) canonical, sibs
    (K, height, 3, 16) canonical, poss (K, height) in [0, 4). Returns the
    (K, 16) canonical roots."""
    node, k = leaves.to(torch.int32), leaves.shape[0]
    rows = torch.arange(k, device=leaves.device)
    for lvl in range(sibs.shape[1]):
        pos = poss[:, lvl].long()
        children = torch.empty((k, ARITY, 16), dtype=torch.int32, device=leaves.device)
        slot = torch.arange(ARITY - 1, device=leaves.device)
        others = slot + (slot >= pos[:, None])                       # (K, 3)
        children[rows[:, None], others] = sibs[:, lvl].to(torch.int32)
        children[rows, pos] = node
        node = permute(torch.cat([_tag(k, leaves.device), children], 1),
                       partial_rounds)[:, DIGEST_INDEX]
    return node


def empty_digests(height: int, device, partial_rounds: int = PARTIAL_ROUNDS) -> torch.Tensor:
    """(height, 16) canonical digests of the empty subtrees of heights 0 to
    height - 1: an empty leaf is 0, an empty parent the node of 4 of them."""
    z = [torch.zeros(16, dtype=torch.int32, device=device)]
    for _ in range(height - 1):
        states = torch.cat([_tag(1, device), z[-1].expand(1, ARITY, 16)], 1)
        z.append(permute(states, partial_rounds)[0, DIGEST_INDEX])
    return torch.stack(z)


def lift_root(root: torch.Tensor, dense: int, height: int,
              partial_rounds: int = PARTIAL_ROUNDS) -> torch.Tensor:
    """The root of a tree of `height` whose leftmost subtree of height
    `dense` has the (16,) canonical root `root` and whose other leaves are
    all 0: each level above it hashes the node with 3 empty subtrees."""
    z = empty_digests(height, root.device, partial_rounds)
    node = root.to(torch.int32)
    for h in range(dense, height):
        children = torch.stack([node, z[h], z[h], z[h]])[None]
        node = permute(torch.cat([_tag(1, root.device), children], 1),
                       partial_rounds)[0, DIGEST_INDEX]
    return node
