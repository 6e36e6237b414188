"""Curve-free PLONK-style prove/verify over F_r for the gadget backend.

Port of `hades252_tpu/plonk.py`, host code the port carries its own copy of
(importing anything from `hades252_tpu` imports JAX). Proofs, keys and
challenges are bit-identical to the JAX package's; the transcripts permute
through the port's native engine binding or its int oracle.

The reference's cross-backend oracle is a real
PLONK prove+verify cycle (reference: src/strategies/gadget.rs:198-271 via
dusk-plonk), while the rebuild only evaluated each gate against the witness
column. This module supplies the polynomial-level argument, built entirely
from field arithmetic (no elliptic curves):

  * Evaluation domain: radix-2 subgroup H of F_r (|F_r^*| = p-1 has
    2-adicity 32, generator 7 — the standard BLS12-381 scalar-field facts),
    with NTT/iNTT interpolation.
  * Gate identity: q_m a b + q_l a + q_r b + q_4 d + q_o o + q_c + PI = 0
    on H, enforced as divisibility by Z_H(X) = X^n - 1.
  * Copy constraints: the standard PLONK permutation grand product z(X)
    over the 4 wire columns with coset shifts (1, k1, k2, k3), plus the
    L_1 (z(1) = 1) boundary term.
  * Quotient: t(X) = [gate + alpha perm + alpha^2 boundary] / Z_H computed
    on a 4n coset; the verifier checks the combined identity at a
    Fiat-Shamir challenge zeta and the degree bound on t.

Soundness model (documented honestly): this is the "transparent PIOP"
instantiation — proofs carry the full wire/z/t polynomials, commitments are
hashes binding the Fiat-Shamir transcript, and the verifier re-evaluates
everything at zeta itself, so a false statement fails with probability
>= 1 - 5n/|F| by Schwartz-Zippel. What it does NOT provide is succinctness
or zero-knowledge; the reference gets those from dusk-plonk's KZG
commitment scheme. The SUCCINCT instantiation of this same argument lives
in the JAX package's fri.py (prove_succinct / verify_succinct): Hades-Merkle
vector commitments + DEEP-FRI replace commit(), proofs become sublinear,
and the verifier touches no full polynomial. This module remains the
maximally-simple oracle the succinct mode is tested against.

The prover is host-side by design: constraint synthesis and proving are
sequential big-int bookkeeping (SURVEY.md §2.4); `prover_cuda.py` moves
the polynomial passes of many instances onto the card.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from .gadget import Composer
from .params import P
from .strategy import ScalarStrategy

# ---------------------------------------------------------------------------
# F_r facts (BLS12-381 scalar field): p - 1 = 2^32 * odd; 7 generates F_r^*.
# ---------------------------------------------------------------------------

TWO_ADICITY = 32
_ODD = (P - 1) >> TWO_ADICITY
#: Generator of the 2^32-torsion: 7^((p-1)/2^32) mod p.
ROOT_OF_UNITY = pow(7, _ODD, P)

#: Wire-column coset shifts k_a=1, k_b, k_o, k_d — non-residues so the
#: shifted domains k_i H are pairwise disjoint (the dusk-plonk/PLONK-paper
#: construction; 7 generates F_r^* so small powers of 7 work).
K_SHIFTS = (1, 7, 13, 17)

assert pow(ROOT_OF_UNITY, 1 << TWO_ADICITY, P) == 1
assert pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - 1), P) != 1


def _domain_root(n: int) -> int:
    """Primitive n-th root of unity (n a power of two <= 2^32)."""
    if n & (n - 1) or n > (1 << TWO_ADICITY):
        raise ValueError(f"domain size must be a power of two <= 2^32: {n}")
    return pow(ROOT_OF_UNITY, (1 << TWO_ADICITY) // n, P)


# ---------------------------------------------------------------------------
# NTT over F_r (iterative radix-2, Python ints — circuits here are ~1k gates)
# ---------------------------------------------------------------------------


def ntt(coeffs: list[int], invert: bool = False) -> list[int]:
    """In-place-style radix-2 NTT: coefficients -> evaluations on H (or the
    inverse transform when invert=True)."""
    a = [c % P for c in coeffs]
    n = len(a)
    if n & (n - 1):
        raise ValueError("NTT size must be a power of two")
    # bit-reversal permutation
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
        w_len = _domain_root(length)
        if invert:
            w_len = pow(w_len, P - 2, P)
        half = length >> 1
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * w % P
                a[k] = (u + v) % P
                a[k + half] = (u - v) % P
                w = w * w_len % P
        length <<= 1
    if invert:
        n_inv = pow(n, P - 2, P)
        a = [x * n_inv % P for x in a]
    return a


def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery's batch-inversion trick: one modexp for any number of
    nonzero values (the prover's grand-product and coset divisions would
    otherwise pay thousands of modexps each)."""
    prefix = []
    acc = 1
    for v in vals:
        acc = acc * v % P
        prefix.append(acc)
    if acc == 0:
        raise ZeroDivisionError("batch_inverse over a zero element")
    inv = pow(acc, P - 2, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * (prefix[i - 1] if i else 1) % P
        inv = inv * vals[i] % P
    return out


def _coset_eval(coeffs: list[int], m: int, shift: int) -> list[int]:
    """Evaluate a polynomial (deg < m) on the coset shift*H_m."""
    scaled = []
    s = 1
    for c in list(coeffs) + [0] * (m - len(coeffs)):
        scaled.append(c * s % P)
        s = s * shift % P
    return ntt(scaled)


def _coset_interp(evals: list[int], shift: int) -> list[int]:
    """Inverse of _coset_eval."""
    coeffs = ntt(evals, invert=True)
    inv_s = pow(shift, P - 2, P)
    out = []
    s = 1
    for c in coeffs:
        out.append(c * s % P)
        s = s * inv_s % P
    return out


# ---------------------------------------------------------------------------
# Fiat-Shamir transcript: polynomial hashes chained through the Hades sponge
# (the framework hashing its own proofs; SHA-256 compresses the coefficient
# stream to field elements first — the sponge is the random oracle).
# ---------------------------------------------------------------------------


def commit(coeffs: list[int]) -> int:
    """Binding commitment stand-in: hash of the coefficient stream as one
    field element. A production system replaces this with a polynomial
    commitment scheme (the reference uses dusk-plonk's KZG)."""
    h = hashlib.sha256()
    for c in coeffs:
        h.update(int(c % P).to_bytes(32, "little"))
    return int.from_bytes(h.digest(), "little") % P


def commit_bytes(stream: bytes) -> int:
    """commit() on a pre-serialized coefficient stream (32-byte LE per
    canonical value): bit-identical to commit(coeffs) for the same values,
    without re-serializing int-by-int (the batched prover hashes device
    output buffers directly)."""
    return int.from_bytes(hashlib.sha256(stream).digest(), "little") % P


def key_digest(key: "CircuitKey") -> int:
    """Digest of the preprocessed circuit (selectors, sigmas, domain) as one
    field element. Absorbed into the Fiat-Shamir transcript together with
    the public-input column BEFORE any challenge is drawn, so every
    challenge is bound to the statement being proven (the post-CVE
    dusk-plonk transcript discipline; weak-FS "Frozen Heart" otherwise lets
    a prover rebind one honest proof to other public inputs)."""
    h = hashlib.sha256()
    h.update(key.n.to_bytes(8, "little"))
    h.update(key.n_gates.to_bytes(8, "little"))
    for name in sorted(key.selectors):
        for c in key.selectors[name]:
            h.update(int(c % P).to_bytes(32, "little"))
    for s in key.sigmas:
        for c in s:
            h.update(int(c % P).to_bytes(32, "little"))
    return int.from_bytes(h.digest(), "little") % P


def statement_digest(key_or_digest, pi_col) -> int:
    """One field element binding the full statement: the circuit digest
    (key_digest, or its precomputed int) and the public-input column.
    Absorbed ONCE into the transcript instead of streaming the n-element
    column through the sponge — binding is equivalent (SHA-256 compresses
    the statement; the sponge remains the random oracle for challenges)
    and the host cost drops from O(n/4) Hades permutations to one SHA
    pass, which dominated batched proving."""
    digest = (key_or_digest if isinstance(key_or_digest, int)
              else key_digest(key_or_digest))
    h = hashlib.sha256()
    h.update(digest.to_bytes(32, "little"))
    for v in pi_col:
        h.update(int(v % P).to_bytes(32, "little"))
    return int.from_bytes(h.digest(), "little") % P


_TRANSCRIPT_PERM = None


def _transcript_perm():
    """Width-5 host permutation for Fiat-Shamir transcripts: the native
    C++ engine when it builds (bit-identical to the int oracle by the
    KAT suite, ~10x faster per call), else the exact Python schedule.
    Cached module-wide: transcript throughput gates every prover and
    verifier on the host side."""
    global _TRANSCRIPT_PERM
    if _TRANSCRIPT_PERM is not None:
        return _TRANSCRIPT_PERM
    from .utils import native

    if native.available():
        from .utils.encoding import digits_to_ints, ints_to_digits

        def perm(ws):
            arr = ints_to_digits([w % P for w in ws], shape=(1, 5))
            out = native.perm_batch_digits(arr)
            return [int(v) for v in digits_to_ints(out[0])]
    else:
        strat = ScalarStrategy()

        def perm(ws):
            return strat.perm(list(ws))
    _TRANSCRIPT_PERM = perm
    return perm


class Transcript:
    """Hades-sponge Fiat-Shamir transcript (width-5 permutation, capacity
    word chained, rate 4)."""

    def __init__(self, label: int = 0x4841444553):  # "HADES"
        self._perm = _transcript_perm()
        self._state = [label % P, 0, 0, 0, 0]

    def absorb(self, *values: int) -> None:
        vals = [v % P for v in values]
        for i in range(0, len(vals), 4):
            chunk = vals[i : i + 4]
            for j, v in enumerate(chunk):
                self._state[1 + j] = (self._state[1 + j] + v) % P
            self._state = self._perm(self._state)

    def challenge(self) -> int:
        c = self._state[1]
        self._state = self._perm(self._state)
        return c

    # -- state sync (device-resident transcript interop) --------------------
    # a device prover may run stretches of the Fiat-Shamir stream on the
    # device (the JAX package's fri_tpu does, in its FRI fold phase); these
    # accessors hand the 5-word sponge state across the host/device
    # boundary so the stream continues bit-identically.

    @property
    def state(self) -> list:
        return list(self._state)

    def set_state(self, state) -> None:
        if len(state) != len(self._state):
            raise ValueError("transcript state must be 5 field elements")
        self._state = [int(v) % P for v in state]


class BatchedTranscript:
    """B independent Fiat-Shamir transcripts advanced in lock-step: every
    absorb/challenge step runs ONE batched host permutation over all B
    sponge states (native engine when available) instead of B sequential
    single-state calls. Bit-identical to B separate `Transcript`s fed the
    same per-instance streams; prover_cuda.prove_batched advances its B
    transcripts through it. Only single-value absorbs are exposed: the
    batched prover's stream is statement digest + one commitment per
    absorb (Transcript.absorb permutes after every <=4-value chunk, so a
    single-value absorb is one add + one permutation)."""

    def __init__(self, b: int, label: int = 0x4841444553):
        self._states = [[label % P, 0, 0, 0, 0] for _ in range(b)]
        self._perm_all = _transcript_perm_batch()

    def absorb_each(self, values) -> None:
        """values: one field element per transcript (length B)."""
        if len(values) != len(self._states):
            raise ValueError("one absorbed value per transcript required")
        for st, v in zip(self._states, values):
            st[1] = (st[1] + int(v)) % P
        self._states = self._perm_all(self._states)

    def challenge_each(self) -> list:
        out = [st[1] for st in self._states]
        self._states = self._perm_all(self._states)
        return out

    @property
    def states(self) -> list:
        return [list(st) for st in self._states]


_TRANSCRIPT_PERM_BATCH = None


def _transcript_perm_batch():
    """Batched width-5 host permutation ((B, 5) int rows -> (B, 5)): one
    native call for the whole batch when the C++ engine builds, else the
    exact per-row Python schedule."""
    global _TRANSCRIPT_PERM_BATCH
    if _TRANSCRIPT_PERM_BATCH is not None:
        return _TRANSCRIPT_PERM_BATCH
    from .utils import native

    if native.available():
        from .utils.encoding import digits_to_ints, ints_to_digits

        def batch(states):
            arr = ints_to_digits(
                [v % P for st in states for v in st],
                shape=(len(states), 5),
            )
            out = digits_to_ints(native.perm_batch_digits(arr))
            return [[int(v) for v in row] for row in out]
    else:
        perm = _transcript_perm()

        def batch(states):
            return [perm(list(st)) for st in states]
    _TRANSCRIPT_PERM_BATCH = batch
    return batch


def statement_digest_rows(digest: int, pi_digits) -> list:
    """statement_digest for B instances straight from a (B, n, N_DIGITS)
    canonical digit buffer: each row's '<u2' byte stream IS the
    concatenated 32-byte-LE scalar encoding statement_digest hashes, so
    the per-value Python to_bytes loop disappears. Bit-identical to
    [statement_digest(digest, col) for col in columns]."""
    rows = np.ascontiguousarray(np.asarray(pi_digits)).astype("<u2")
    dbytes = int(digest).to_bytes(32, "little")
    return [
        int.from_bytes(
            hashlib.sha256(dbytes + rows[i].tobytes()).digest(), "little"
        ) % P
        for i in range(rows.shape[0])
    ]


# ---------------------------------------------------------------------------
# Preprocessing: selector + permutation (sigma) polynomials
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CircuitKey:
    """Preprocessed circuit: everything prover and verifier share."""

    n: int                      # domain size (power of two >= gate count)
    omega: int                  # primitive n-th root of unity
    selectors: dict             # name -> coefficient list (deg < n)
    sigmas: tuple               # 4 coefficient lists (sigma_a..sigma_d)
    n_gates: int


def _wire_indices(composer: Composer) -> list[list[int]]:
    return [
        [c.w_a.index for c in composer.gates],
        [c.w_b.index for c in composer.gates],
        [c.w_o.index for c in composer.gates],
        [c.w_d.index for c in composer.gates],
    ]


def preprocess(composer: Composer) -> CircuitKey:
    """Interpolate selector polynomials and build the copy-constraint
    permutation sigma over the 4 wire columns (the PLONK preprocessing the
    reference gets from Compiler::compile, gadget.rs:198-205)."""
    n_gates = len(composer.gates)
    n = 1
    while n < n_gates:
        n <<= 1
    omega = _domain_root(n)

    sel_evals = {name: [0] * n for name in
                 ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c")}
    for i, c in enumerate(composer.gates):
        for name in sel_evals:
            sel_evals[name][i] = getattr(c, name)
    selectors = {name: ntt(v, invert=True) for name, v in sel_evals.items()}

    # position ids: column c, row i -> k_c * omega^i. sigma maps every
    # position to the next position sharing its witness (cycle structure).
    cols = _wire_indices(composer)
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % P
    ids = [[k * omega_pows[i] % P for i in range(n)] for k in K_SHIFTS]

    by_witness: dict[int, list[tuple[int, int]]] = {}
    for c, col in enumerate(cols):
        for i, w in enumerate(col):
            by_witness.setdefault(w, []).append((c, i))
    sigma_evals = [list(ids[c]) for c in range(4)]  # identity on padding rows
    for positions in by_witness.values():
        m = len(positions)
        for t, (c, i) in enumerate(positions):
            c2, i2 = positions[(t + 1) % m]  # cyclic shift within the class
            sigma_evals[c][i] = ids[c2][i2]
    sigmas = tuple(ntt(v, invert=True) for v in sigma_evals)
    return CircuitKey(n=n, omega=omega, selectors=selectors, sigmas=sigmas,
                      n_gates=n_gates)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclass
class Proof:
    """Transparent proof: commitments bind the transcript; the full
    polynomials let the verifier evaluate at zeta itself (see module
    docstring for the soundness model)."""

    wires: tuple            # a, b, o, d coefficient lists
    z: list                 # grand-product polynomial
    t: list                 # quotient polynomial (deg <= 4n - 4)
    commitments: dict       # name -> field element


def _public_input_column(composer: Composer, n: int) -> list[int]:
    pi = [0] * n
    for i, c in enumerate(composer.gates):
        pi[i] = c.pi
    return pi


def _wire_polys(composer: Composer, key: CircuitKey):
    """(wire_evals, wires): the 4 witness columns on H and their
    coefficient forms."""
    cols = _wire_indices(composer)
    vals = composer._values
    wire_evals = [
        [vals[idx] for idx in col] + [0] * (key.n - key.n_gates)
        for col in cols
    ]
    return wire_evals, tuple(ntt(v, invert=True) for v in wire_evals)


def _omega_pows(key: CircuitKey) -> list[int]:
    out = [1] * key.n
    for i in range(1, key.n):
        out[i] = out[i - 1] * key.omega % P
    return out


def _grand_product(wire_evals, key: CircuitKey, beta: int,
                   gamma: int) -> list[int]:
    """The PLONK copy-constraint grand-product polynomial z (coefficient
    form): z(1) = 1, z(omega^{i+1}) = z(omega^i) * prod(num_i/den_i)."""
    n = key.n
    omega_pows = _omega_pows(key)
    sigma_evals = [_coset_eval(s, n, 1) for s in key.sigmas]
    nums, dens = [], []
    for i in range(n - 1):
        num = den = 1
        for c in range(4):
            w = wire_evals[c][i]
            num = num * (w + beta * K_SHIFTS[c] * omega_pows[i] + gamma) % P
            den = den * (w + beta * sigma_evals[c][i] + gamma) % P
        nums.append(num)
        dens.append(den)
    den_invs = batch_inverse(dens)
    z_evals = [1] * n
    for i in range(n - 1):
        z_evals[i + 1] = z_evals[i] * nums[i] * den_invs[i] % P
    return ntt(z_evals, invert=True)


def _quotient(key: CircuitKey, wires, z, pi_col, beta: int, gamma: int,
              alpha: int, m: int | None = None) -> list[int]:
    """The quotient polynomial t = [gate + alpha perm + alpha^2 boundary]
    / Z_H, computed on an m-point coset (default 4n — enough for
    unblinded witnesses: gate poly degree <= 3(n-1); perm terms <= 5n.
    fri.py's zero-knowledge mode passes a larger m because Z_H-blinded
    wires push the combined degree past 4n)."""
    n = key.n
    omega_pows = _omega_pows(key)
    if m is None:
        m = 4 * n
    g = 7  # coset shift: generator, g^m H_m never meets H
    ce = lambda poly: _coset_eval(poly, m, g)
    a_c, b_c, o_c, d_c = (ce(w) for w in wires)
    s_c = [ce(s) for s in key.sigmas]
    q_c = {name: ce(poly) for name, poly in key.selectors.items()}
    pi_c = ce(ntt(pi_col, invert=True))
    z_c = ce(z)
    zw = [z[i] * omega_pows[i % n] % P for i in range(len(z))]  # z(omega X)
    zw_c = ce(zw)
    # L_1 on the coset: (X^n - 1) / (n (X - 1))
    zh_c, xs = [], []
    gx = g
    for i in range(m):
        xn = pow(gx, n, P)
        zh_c.append((xn - 1) % P)
        xs.append(gx)
        gx = gx * _domain_root(m) % P
    zh_inv = batch_inverse(zh_c)
    l1_den_inv = batch_inverse([n * (x - 1) % P for x in xs])
    l1_c = [zh_c[i] * l1_den_inv[i] % P for i in range(m)]

    t_evals = []
    for i in range(m):
        gate = (
            q_c["q_m"][i] * a_c[i] % P * b_c[i]
            + q_c["q_l"][i] * a_c[i]
            + q_c["q_r"][i] * b_c[i]
            + q_c["q_o"][i] * o_c[i]
            + q_c["q_4"][i] * d_c[i]
            + q_c["q_c"][i]
            + pi_c[i]
        ) % P
        num = z_c[i]
        den = zw_c[i]
        for c, w_c in enumerate((a_c, b_c, o_c, d_c)):
            num = num * (w_c[i] + beta * K_SHIFTS[c] * xs[i] + gamma) % P
            den = den * (w_c[i] + beta * s_c[c][i] + gamma) % P
        perm = (num - den) % P
        boundary = l1_c[i] * (z_c[i] - 1) % P
        combined = (gate + alpha * perm + alpha * alpha % P * boundary) % P
        t_evals.append(combined * zh_inv[i] % P)
    return _coset_interp(t_evals, g)


def prove(composer: Composer, key: CircuitKey | None = None) -> Proof:
    """Produce the polynomial argument for the composer's witness.

    Mirrors prover.prove (reference: gadget.rs:217): the witness column is
    the composer's, the statement is the preprocessed circuit + the public
    input column."""
    if key is None:
        key = preprocess(composer)
    wire_evals, wires = _wire_polys(composer, key)
    pi_col = _public_input_column(composer, key.n)

    tr = Transcript()
    # statement binding: circuit digest + full PI column enter the
    # transcript before any challenge (see key_digest/statement_digest)
    tr.absorb(statement_digest(key, pi_col))
    cm = {}
    for name, poly in zip("abod", wires):
        cm[name] = commit(poly)
        tr.absorb(cm[name])
    beta = tr.challenge()
    gamma = tr.challenge()

    z = _grand_product(wire_evals, key, beta, gamma)
    cm["z"] = commit(z)
    tr.absorb(cm["z"])
    alpha = tr.challenge()

    t = _quotient(key, wires, z, pi_col, beta, gamma, alpha)
    cm["t"] = commit(t)
    return Proof(wires=wires, z=z, t=t, commitments=cm)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

#: Honest quotient degree bound: gate <= 3n, perm <= 5n... all divided by
#: Z_H (degree n); the largest term is z * 4 linear wire factors (deg 5n-4),
#: so deg(t) <= 4n - 4. A cheating "quotient" from a non-divisible
#: combination interpolates to degree 4n-1 generically; the zeta identity
#: check is what catches it (Schwartz-Zippel), the degree check is belt —
#: and it enforces exactly the derived bound (a degree-(4n-1) forgery is
#: rejected here before any evaluation: tests/test_plonk.py).
def _t_degree_bound(n: int) -> int:
    return 4 * n - 4


def verify(key: CircuitKey, proof: Proof, public_inputs: list[int]) -> bool:
    """Check the polynomial argument (reference analogue: verifier.verify,
    gadget.rs:220). public_inputs: the PI column values by gate row
    (padded/truncated to the gate count)."""
    n, omega = key.n, key.omega
    pi = [0] * n
    for i, v in enumerate(public_inputs[:key.n_gates]):
        pi[i] = v % P
    # 1. transcript binding: statement (circuit digest + PI column) first,
    # then recompute commitments + challenges
    tr = Transcript()
    tr.absorb(statement_digest(key, pi))
    for name, poly in zip("abod", proof.wires):
        if commit(poly) != proof.commitments.get(name):
            return False
        tr.absorb(proof.commitments[name])
    beta = tr.challenge()
    gamma = tr.challenge()
    if commit(proof.z) != proof.commitments.get("z"):
        return False
    tr.absorb(proof.commitments["z"])
    alpha = tr.challenge()
    if commit(proof.t) != proof.commitments.get("t"):
        return False
    tr.absorb(proof.commitments["t"])
    zeta = tr.challenge()

    # 2. degree bounds
    if len(proof.t) > 4 * n or any(
        c % P for c in proof.t[_t_degree_bound(n) + 1 :]
    ):
        return False
    if any(len(w) > n for w in proof.wires) or len(proof.z) > n:
        return False

    # 3. evaluate everything at zeta
    a_z, b_z, o_z, d_z = (poly_eval(w, zeta) for w in proof.wires)
    z_z = poly_eval(proof.z, zeta)
    zw_z = poly_eval(proof.z, zeta * omega % P)
    t_z = poly_eval(proof.t, zeta)
    s_z = [poly_eval(s, zeta) for s in key.sigmas]
    q_z = {name: poly_eval(poly, zeta) for name, poly in key.selectors.items()}

    pi_z = poly_eval(ntt(pi, invert=True), zeta)

    zh_z = (pow(zeta, n, P) - 1) % P
    if zh_z == 0:  # zeta landed in H (probability n/|F|): resample honestly
        return False
    l1_z = zh_z * pow(n * (zeta - 1) % P, P - 2, P) % P

    gate = (
        q_z["q_m"] * a_z % P * b_z
        + q_z["q_l"] * a_z
        + q_z["q_r"] * b_z
        + q_z["q_o"] * o_z
        + q_z["q_4"] * d_z
        + q_z["q_c"]
        + pi_z
    ) % P
    num = z_z
    den = zw_z
    for c, w_z in enumerate((a_z, b_z, o_z, d_z)):
        num = num * (w_z + beta * K_SHIFTS[c] * zeta + gamma) % P
        den = den * (w_z + beta * s_z[c] + gamma) % P
    perm = (num - den) % P
    boundary = l1_z * (z_z - 1) % P
    combined = (gate + alpha * perm + alpha * alpha % P * boundary) % P
    return combined == t_z * zh_z % P
