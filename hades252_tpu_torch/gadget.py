"""GadgetStrategy: synthesize the Hades252 permutation as PLONK constraints.

Port of `hades252_tpu/gadget.py`, host code the port carries its own copy
of (importing anything from `hades252_tpu` imports JAX): the same classes,
the same gates, with the port's `params` and `strategy`.

Host-side equivalent of the reference's `GadgetStrategy`
(reference: src/strategies/gadget.rs:15-133). Circuit synthesis is
inherently sequential wire bookkeeping (SURVEY.md §2.4), so this runs on the
host in exact big-int arithmetic; the device surface of the framework is the
execution path, and the cross-backend consistency oracle (scalar perm ==
gadget perm witness values) ties the two together exactly as the reference's
prove/verify tests do (gadget.rs:207-271).

Gate schedule parity with the reference:
  * ARK constraints are emitted ONLY for round 0 (gadget.rs:50-57); every
    later round's ARK constants are folded into the `constant` term of the
    previous round's linear-layer gates (gadget.rs:101-128). This is
    algebraically identical to the scalar path because ARK precedes the
    S-box in the next round (SURVEY.md §3.2).
  * Quintic S-box: 3 `gate_mul` (v^2, v^4, v^5) (gadget.rs:60-69).
  * MDS row: 2 fan-in-3 `gate_add` using the left/right/fourth wires
    (gadget.rs:109-128); the second gate carries the folded constant, which
    is zero for the final round (gadget.rs:103-107).
  * Total: 1 reserved zero-gate + 5 ARK + 8*15 + 59*3 S-box + 67*10 MDS
    = 973 gates per permutation (reference CHANGELOG.md:130-135).

The `Composer` here mirrors dusk-plonk's arithmetic-gate Composer surface
(append_witness / gate_add / gate_mul / assert_equal) with the standard
PLONK arithmetic gate:
    q_m*a*b + q_l*a + q_r*b + q_4*d + q_o*o + q_c + pi = 0
plus `check_satisfied()` and a columnar export for downstream provers.
The actual prove/verify cycle (gate identity + copy-constraint grand
product over a radix-2 domain, the analogue of the reference's
prover.prove/verifier.verify via dusk-plonk) lives in plonk.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .params import P, ROUNDS, WIDTH, mds_matrix_int


@dataclass(frozen=True)
class Witness:
    """A wire index into the composer's witness column."""

    index: int


@dataclass
class Constraint:
    """Builder for one arithmetic gate (mirrors dusk-plonk's Constraint)."""

    q_m: int = 0
    q_l: int = 0
    q_r: int = 0
    q_o: int = 0
    q_4: int = 0
    q_c: int = 0
    pi: int = 0
    w_a: Optional[Witness] = None
    w_b: Optional[Witness] = None
    w_o: Optional[Witness] = None
    w_d: Optional[Witness] = None

    def mult(self, v):
        self.q_m = v % P
        return self

    def left(self, v):
        self.q_l = v % P
        return self

    def right(self, v):
        self.q_r = v % P
        return self

    def output(self, v):
        self.q_o = v % P
        return self

    def fourth(self, v):
        self.q_4 = v % P
        return self

    def constant(self, v):
        self.q_c = v % P
        return self

    def public(self, v):
        self.pi = v % P
        return self

    def a(self, w: Witness):
        self.w_a = w
        return self

    def b(self, w: Witness):
        self.w_b = w
        return self

    def o(self, w: Witness):
        self.w_o = w
        return self

    def d(self, w: Witness):
        self.w_d = w
        return self


class Composer:
    """Arithmetic constraint system: witness column + gate list.

    Gate equation: q_m*a*b + q_l*a + q_r*b + q_4*d + q_o*o + q_c + pi = 0.
    Like dusk-plonk, index 0 is the reserved ZERO witness, constrained to
    zero by an initial dummy gate (this is the +1 in the 973 gate count).
    """

    def __init__(self):
        self._values: list[int] = [0]
        self.gates: list[Constraint] = []
        self.ZERO = Witness(0)
        # reserved gate: 1 * zero = 0
        self.append_gate(Constraint().left(1).a(self.ZERO))

    # -- witnesses ---------------------------------------------------------

    def append_witness(self, value: int) -> Witness:
        self._values.append(int(value) % P)
        return Witness(len(self._values) - 1)

    def value(self, w: Witness) -> int:
        return self._values[w.index]

    def __len__(self) -> int:
        return len(self.gates)

    # -- gates -------------------------------------------------------------

    def _normalize_wires(self, c: Constraint) -> Constraint:
        for wire in ("w_a", "w_b", "w_o", "w_d"):
            if getattr(c, wire) is None:
                setattr(c, wire, self.ZERO)
        return c

    def append_gate(self, c: Constraint) -> None:
        self.gates.append(self._normalize_wires(c))

    def _eval_partial(self, c: Constraint) -> int:
        a = self._values[c.w_a.index]
        b = self._values[c.w_b.index]
        d = self._values[c.w_d.index]
        return (c.q_m * a * b + c.q_l * a + c.q_r * b + c.q_4 * d + c.q_c + c.pi) % P

    def gate_add(self, c: Constraint) -> Witness:
        """Allocate o = q_l*a + q_r*b + q_4*d + q_c + pi and constrain it
        (dusk-plonk sets q_o = -1)."""
        out = self.append_witness(self._eval_partial(self._normalize_wires(c)))
        c.q_o = P - 1
        c.w_o = out
        self.append_gate(c)
        return out

    def gate_mul(self, c: Constraint) -> Witness:
        """Allocate o = q_m*a*b + ... and constrain it (q_o = -1)."""
        return self.gate_add(c)

    def assert_equal(self, a: Witness, b: Witness) -> None:
        self.append_gate(Constraint().left(1).a(a).right(P - 1).b(b))

    # -- evaluation / export -------------------------------------------------

    def check_satisfied(self) -> bool:
        """Evaluate every gate against the witness column."""
        for c in self.gates:
            lhs = (
                self._eval_partial(c) + c.q_o * self._values[c.w_o.index]
            ) % P
            if lhs != 0:
                return False
        return True

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Columnar export (selectors as 32-byte LE rows, wire index columns)
        for downstream provers / inspection."""
        n = len(self.gates)
        sel = np.zeros((n, 6, 32), np.uint8)
        wires = np.zeros((n, 4), np.int64)
        for i, c in enumerate(self.gates):
            for j, q in enumerate((c.q_m, c.q_l, c.q_r, c.q_o, c.q_4, c.q_c)):
                sel[i, j] = np.frombuffer(int(q).to_bytes(32, "little"), np.uint8)
            wires[i] = [c.w_a.index, c.w_b.index, c.w_o.index, c.w_d.index]
        return {"selectors": sel, "wires": wires}


from .strategy import Strategy


class GadgetStrategy(Strategy):
    """Emits the 67-round permutation as gates on witness wires
    (reference: src/strategies/gadget.rs:28-133). The round schedule comes
    from the shared Strategy engine (strategy.py) — one schedule, N
    backends, exactly like the reference trait."""

    def __init__(self, composer: Composer):
        self.cs = composer
        self.count = 0

    @staticmethod
    def gadget(composer: Composer, x: list[Witness]) -> None:
        """Permute the slice of witnesses in place (gadget.rs:28-32)."""
        GadgetStrategy(composer).perm(x)

    # -- the three primitive ops (mirroring the reference trait impls) ------

    def add_round_key(self, constants, words: list[Witness]) -> None:
        # ARK gates only for round 0; later ARKs fold into the previous
        # round's linear layer (gadget.rs:44-58)
        if self.count == 0:
            for i, w in enumerate(words):
                c = self.next_c(constants)
                words[i] = self.cs.gate_add(Constraint().left(1).a(w).constant(c))

    def quintic_s_box(self, value: Witness) -> Witness:
        v2 = self.cs.gate_mul(Constraint().mult(1).a(value).b(value))
        v4 = self.cs.gate_mul(Constraint().mult(1).a(v2).b(v2))
        return self.cs.gate_mul(Constraint().mult(1).a(v4).b(value))

    def mul_matrix(self, constants, values: list[Witness]) -> None:
        mds = mds_matrix_int()
        self.count += 1
        result = []
        for j in range(WIDTH):
            c = self.next_c(constants) if self.count < ROUNDS else 0
            r = self.cs.gate_add(
                Constraint()
                .left(mds[j][0]).a(values[0])
                .right(mds[j][1]).b(values[1])
                .fourth(mds[j][2]).d(values[2])
            )
            r = self.cs.gate_add(
                Constraint()
                .left(mds[j][3]).a(values[3])
                .right(mds[j][4]).b(values[4])
                .fourth(1).d(r)
                .constant(c)
            )
            result.append(r)
        values[:] = result

    # the round schedule itself (perm / apply_full_round /
    # apply_partial_round) is inherited from Strategy


#: Gates emitted per permutation, including the composer's reserved gate
#: (parity target: reference CHANGELOG.md:130-135)
GATES_PER_PERM = 973
