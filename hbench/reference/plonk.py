"""The plain reference of the permutation-preimage circuit and its PLONK proof.

A frozen copy, cut to what proving needs, of the package's host code (the
composer and the permutation gadget of `gadget.py` with the round schedule
of `strategy.py`, and `plonk.py`'s preprocessing and prover), in exact
Python ints, with `hbench/reference/hades.py`'s constants and permutation in
place of the package's. It imports nothing of the package. A proof is its
wire, grand-product and quotient polynomials and the SHA-256 commitments to
them, bound by a Fiat-Shamir transcript through the permutation.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from hbench.reference import hades

P, WIDTH = hades.P, hades.WIDTH
TWO_ADICITY = 32
ROOT_OF_UNITY = pow(7, (P - 1) >> TWO_ADICITY, P)
K_SHIFTS = (1, 7, 13, 17)
SELECTORS = ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c")


# ---------------------------------------------------------------------------
# The circuit: composer and the permutation gadget
# ---------------------------------------------------------------------------


@dataclass
class Gate:
    """q_m a b + q_l a + q_r b + q_4 d + q_o o + q_c + pi = 0 over wires
    a, b, o, d (witness indices; 0 is the reserved zero)."""

    q_m: int = 0
    q_l: int = 0
    q_r: int = 0
    q_o: int = 0
    q_4: int = 0
    q_c: int = 0
    pi: int = 0
    wires: list = field(default_factory=lambda: [0, 0, 0, 0])


class Composer:
    def __init__(self):
        self.values = [0]
        self.gates: list[Gate] = []
        self.gates.append(Gate(q_l=1))                  # 1 * zero = 0

    def witness(self, v: int) -> int:
        self.values.append(int(v) % P)
        return len(self.values) - 1

    def add(self, g: Gate, a: int = 0, b: int = 0, d: int = 0) -> int:
        """Allocate o = q_m a b + q_l a + q_r b + q_4 d + q_c + pi and
        constrain it (q_o = -1)."""
        va, vb, vd = self.values[a], self.values[b], self.values[d]
        out = self.witness(g.q_m * va * vb + g.q_l * va + g.q_r * vb + g.q_4 * vd + g.q_c + g.pi)
        g.q_o, g.wires = P - 1, [a, b, out, d]
        self.gates.append(g)
        return out


def gadget(cs: Composer, x: list[int]) -> list[int]:
    """The permutation as gates on witnesses x (5 indices): round 0's ARK as
    5 gates, each S-box as 3 products, each MDS row as 2 fan-in-3 adds with
    the next round's ARK constant folded into the second."""
    partial_rounds = hades.PARTIAL_ROUNDS
    rounds = hades.FULL_ROUNDS + partial_rounds
    ark, m = iter(hades.round_constants()), hades.mds()
    x = [cs.add(Gate(q_l=1, q_c=next(ark)), a=w) for w in x]
    half = hades.FULL_ROUNDS // 2

    def sbox(v):
        v2 = cs.add(Gate(q_m=1), a=v, b=v)
        v4 = cs.add(Gate(q_m=1), a=v2, b=v2)
        return cs.add(Gate(q_m=1), a=v4, b=v)

    for r in range(rounds):
        if r < half or r >= half + partial_rounds:
            x = [sbox(v) for v in x]
        else:
            x[-1] = sbox(x[-1])
        out = []
        for j in range(WIDTH):
            c = next(ark) if r + 1 < rounds else 0
            t = cs.add(Gate(q_l=m[j][0], q_r=m[j][1], q_4=m[j][2]), a=x[0], b=x[1], d=x[2])
            out.append(cs.add(Gate(q_l=m[j][3], q_r=m[j][4], q_4=1, q_c=c), a=x[3], b=x[4], d=t))
        x = out
    return x


def preimage_circuit(words: list[int], image: list[int]) -> Composer:
    """The permutation of the 5 words, each output bound to its image
    through the public-input column."""
    cs = Composer()
    outs = gadget(cs, [cs.witness(w) for w in words])
    for w, e in zip(outs, image):
        g = Gate(q_l=1, pi=(-e) % P)
        g.wires = [w, 0, 0, 0]
        cs.gates.append(g)
    return cs


# ---------------------------------------------------------------------------
# Polynomials over the scalar field
# ---------------------------------------------------------------------------


def domain_root(n: int) -> int:
    return pow(ROOT_OF_UNITY, (1 << TWO_ADICITY) // n, P)


def ntt(coeffs: list[int], invert: bool = False) -> list[int]:
    a = [c % P for c in coeffs]
    n = len(a)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = domain_root(length)
        if invert:
            w_len = pow(w_len, P - 2, P)
        half = length >> 1
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * w % P
                a[k], a[k + half] = (u + v) % P, (u - v) % P
                w = w * w_len % P
        length <<= 1
    if invert:
        n_inv = pow(n, P - 2, P)
        a = [x * n_inv % P for x in a]
    return a


def batch_inverse(vals: list[int]) -> list[int]:
    prefix, acc = [], 1
    for v in vals:
        acc = acc * v % P
        prefix.append(acc)
    inv = pow(acc, P - 2, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * (prefix[i - 1] if i else 1) % P
        inv = inv * vals[i] % P
    return out


def coset_eval(coeffs: list[int], m: int, shift: int) -> list[int]:
    scaled, s = [], 1
    for c in list(coeffs) + [0] * (m - len(coeffs)):
        scaled.append(c * s % P)
        s = s * shift % P
    return ntt(scaled)


def coset_interp(evals: list[int], shift: int) -> list[int]:
    out, s, inv_s = [], 1, pow(shift, P - 2, P)
    for c in ntt(evals, invert=True):
        out.append(c * s % P)
        s = s * inv_s % P
    return out


def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


# ---------------------------------------------------------------------------
# Commitments and the transcript
# ---------------------------------------------------------------------------


def _sha(chunks) -> int:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little") % P


def commit(coeffs: list[int]) -> int:
    return _sha(int(c % P).to_bytes(32, "little") for c in coeffs)


def key_digest(key: "Key") -> int:
    def chunks():
        yield key.n.to_bytes(8, "little")
        yield key.n_gates.to_bytes(8, "little")
        for name in sorted(key.selectors):
            for c in key.selectors[name]:
                yield int(c % P).to_bytes(32, "little")
        for s in key.sigmas:
            for c in s:
                yield int(c % P).to_bytes(32, "little")
    return _sha(chunks())


def statement_digest(digest: int, pi_col: list[int]) -> int:
    return _sha([digest.to_bytes(32, "little")]
                + [int(v % P).to_bytes(32, "little") for v in pi_col])


class Transcript:
    """The Fiat-Shamir sponge: width 5, capacity word chained, rate 4."""

    def __init__(self, partial_rounds: int = hades.PARTIAL_ROUNDS,
                 label: int = 0x4841444553):
        self.state = [label % P, 0, 0, 0, 0]
        self.partial_rounds = partial_rounds

    def perm(self) -> None:
        self.state = hades.perm_int(self.state, self.partial_rounds)

    def absorb(self, *values: int) -> None:
        vals = [v % P for v in values]
        for i in range(0, len(vals), 4):
            for j, v in enumerate(vals[i:i + 4]):
                self.state[1 + j] = (self.state[1 + j] + v) % P
            self.perm()

    def challenge(self) -> int:
        c = self.state[1]
        self.perm()
        return c


# ---------------------------------------------------------------------------
# Keys and the prover
# ---------------------------------------------------------------------------


@dataclass
class Key:
    n: int
    omega: int
    selectors: dict
    sigmas: tuple
    n_gates: int


@dataclass
class Proof:
    wires: tuple
    z: list
    t: list
    commitments: dict


def wire_columns(cs: Composer) -> list[list[int]]:
    return [[g.wires[c] for g in cs.gates] for c in range(4)]


def preprocess(cs: Composer) -> Key:
    n_gates = len(cs.gates)
    n = 1
    while n < n_gates:
        n <<= 1
    omega = domain_root(n)
    sel = {name: [getattr(g, name) for g in cs.gates] + [0] * (n - n_gates)
           for name in SELECTORS}
    selectors = {name: ntt(v, invert=True) for name, v in sel.items()}
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * omega % P
    ids = [[k * pows[i] % P for i in range(n)] for k in K_SHIFTS]
    by_witness: dict[int, list] = {}
    for c, col in enumerate(wire_columns(cs)):
        for i, w in enumerate(col):
            by_witness.setdefault(w, []).append((c, i))
    sigma = [list(ids[c]) for c in range(4)]
    for positions in by_witness.values():
        for t, (c, i) in enumerate(positions):
            c2, i2 = positions[(t + 1) % len(positions)]
            sigma[c][i] = ids[c2][i2]
    return Key(n=n, omega=omega, selectors=selectors,
               sigmas=tuple(ntt(v, invert=True) for v in sigma), n_gates=n_gates)


def _pows(key: Key) -> list[int]:
    out = [1] * key.n
    for i in range(1, key.n):
        out[i] = out[i - 1] * key.omega % P
    return out


def grand_product(wire_evals, key: Key, beta: int, gamma: int) -> list[int]:
    n, pows = key.n, _pows(key)
    sigma_evals = [coset_eval(s, n, 1) for s in key.sigmas]
    nums, dens = [], []
    for i in range(n - 1):
        num = den = 1
        for c in range(4):
            w = wire_evals[c][i]
            num = num * (w + beta * K_SHIFTS[c] * pows[i] + gamma) % P
            den = den * (w + beta * sigma_evals[c][i] + gamma) % P
        nums.append(num)
        dens.append(den)
    inv = batch_inverse(dens)
    z = [1] * n
    for i in range(n - 1):
        z[i + 1] = z[i] * nums[i] * inv[i] % P
    return ntt(z, invert=True)


def quotient(key: Key, wires, z, pi_col, beta: int, gamma: int, alpha: int,
             m: int | None = None) -> list[int]:
    """t on an m-point coset (4n by default) of shift 7."""
    n, pows = key.n, _pows(key)
    m, g = m or 4 * n, 7
    ce = lambda poly: coset_eval(poly, m, g)
    a_c, b_c, o_c, d_c = (ce(w) for w in wires)
    s_c = [ce(s) for s in key.sigmas]
    q = {name: ce(poly) for name, poly in key.selectors.items()}
    pi_c = ce(ntt(pi_col, invert=True))
    z_c = ce(z)
    zw_c = ce([z[i] * pows[i % n] % P for i in range(len(z))])
    zh, xs, gx, w_m = [], [], g, domain_root(m)
    for _ in range(m):
        zh.append((pow(gx, n, P) - 1) % P)
        xs.append(gx)
        gx = gx * w_m % P
    zh_inv = batch_inverse(zh)
    l1_den_inv = batch_inverse([n * (x - 1) % P for x in xs])
    t = []
    for i in range(m):
        gate = (q["q_m"][i] * a_c[i] % P * b_c[i] + q["q_l"][i] * a_c[i] + q["q_r"][i] * b_c[i]
                + q["q_o"][i] * o_c[i] + q["q_4"][i] * d_c[i] + q["q_c"][i] + pi_c[i]) % P
        num, den = z_c[i], zw_c[i]
        for c, w_c in enumerate((a_c, b_c, o_c, d_c)):
            num = num * (w_c[i] + beta * K_SHIFTS[c] * xs[i] + gamma) % P
            den = den * (w_c[i] + beta * s_c[c][i] + gamma) % P
        boundary = zh[i] * l1_den_inv[i] % P * (z_c[i] - 1) % P
        t.append((gate + alpha * ((num - den) % P) + alpha * alpha % P * boundary) % P
                 * zh_inv[i] % P)
    return coset_interp(t, g)


def prove(cs: Composer, key: Key, partial_rounds: int = hades.PARTIAL_ROUNDS) -> Proof:
    cols = wire_columns(cs)
    wire_evals = [[cs.values[i] for i in col] + [0] * (key.n - key.n_gates) for col in cols]
    wires = tuple(ntt(v, invert=True) for v in wire_evals)
    pi_col = [g.pi for g in cs.gates] + [0] * (key.n - key.n_gates)
    tr = Transcript(partial_rounds)
    tr.absorb(statement_digest(key_digest(key), pi_col))
    cm = {}
    for name, poly in zip("abod", wires):
        cm[name] = commit(poly)
        tr.absorb(cm[name])
    beta, gamma = tr.challenge(), tr.challenge()
    z = grand_product(wire_evals, key, beta, gamma)
    cm["z"] = commit(z)
    tr.absorb(cm["z"])
    alpha = tr.challenge()
    t = quotient(key, wires, z, pi_col, beta, gamma, alpha)
    cm["t"] = commit(t)
    return Proof(wires=wires, z=z, t=t, commitments=cm)


def prove_instances(words: list, images: list, ids: list,
                    partial_rounds: int = hades.PARTIAL_ROUNDS) -> dict:
    """{id: the proof of that instance}, with one key for all. The circuits
    are the true ones; `partial_rounds` sets the transcript's permutation
    (below 59 only for the control)."""
    circuits = [preimage_circuit(w, e) for w, e in zip(words, images)]
    key = preprocess(circuits[0])
    return {i: prove(c, key, partial_rounds) for i, c in zip(ids, circuits)}
