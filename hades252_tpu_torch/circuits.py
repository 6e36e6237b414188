"""In-circuit gadget counterparts of every model family (sponge / Merkle / cipher).

Port of `hades252_tpu/circuits.py`: the same gadgets and circuits on the
port's `gadget`; `merkle_path_ints` reads the port's torch Merkle levels.

The reference's GadgetStrategy exists so the Hades permutation can run INSIDE
PLONK circuits (reference: src/strategies/gadget.rs:15-133); its downstream
ecosystem (dusk-poseidon) builds sponge-hash, Merkle-opening, and cipher
gadgets on top of exactly that primitive. This module completes the same
story for this framework: each gadget emits constraints that mirror the
corresponding scalar model's documented spec bit-exactly, so

    composer.value(<gadget output wire>) == <models.* output>

for every input (tests/test_circuits.py for the JAX package;
tests/test_torch_plonk.py holds this copy's circuits equal to it). The
proving stack (plonk.prove and prover_cuda.prove_batched here; the JAX
package's fri and aggregate too) is circuit-agnostic, so every circuit
built here is provable and verifiable unchanged.

Gate accounting (PERM_GATES = 972 per in-circuit permutation; the composer's
reserved zero-gate is counted once per circuit, reference
CHANGELOG.md:130-135):

  * sponge hash, L words:  ceil(L/4) perms + 4 feed-adds per chunk after the
    first + 1 IV constant gate.
  * Merkle membership, height h: h perms + 13 position/selection gates per
    level + 1 tag constant gate.
  * cipher encryption, L words: 1 + ceil(L/4) perms + 4 duplex adds per
    chunk + 2 constant gates.

Position selection in the Merkle gadget is the standard 2-bit multiplexer:
with boolean bits b0, b1 (little-endian position pos = b0 + 2*b1) and child
group g0..g3,

    selected = g0 + b0*(g1-g0) + b1*(g2-g0) + b0*b1*(g3-g2-g1+g0)

equals g[pos] for all four positions; the gadget constrains selected == node,
which pins the running node to its claimed slot inside the hashed group.
Soundness of the path itself comes from the hash chain ending in the public
root, exactly like the host-side verifier (models/merkle.py node rule:
parent = perm([TAG, g0..g3])[1], TAG = 4).
"""

from __future__ import annotations

from .gadget import Composer, Constraint, GadgetStrategy, Witness

#: gates emitted by one in-circuit permutation (5 ARK + 8*15 + 59*3 + 67*10)
PERM_GATES = 972

# model-spec constants, mirrored from models/sponge.py, models/merkle.py,
# models/cipher.py (single source of truth for the numeric values)
RATE = 4
DIGEST_INDEX = 1
MERKLE_ARITY = 4
MERKLE_TAG = MERKLE_ARITY
CIPHER_TAG = 6


def constant_witness(composer: Composer, value: int) -> Witness:
    """Allocate a wire constrained to the constant `value`."""
    return composer.gate_add(Constraint().constant(value))


def assert_boolean(composer: Composer, w: Witness) -> None:
    """Constrain w in {0, 1}: w*w - w = 0."""
    composer.append_gate(
        Constraint().mult(1).a(w).b(w).output(-1).o(w)
    )


def expose_public(composer: Composer, w: Witness, value: int) -> None:
    """Bind wire w to `value` through the public-input column
    (the reference TestCircuit's output binding, gadget.rs:170-176)."""
    composer.append_gate(Constraint().left(1).a(w).public(-value))


# ---------------------------------------------------------------------------
# Sponge hash gadget (models/sponge.py spec)
# ---------------------------------------------------------------------------


def sponge_hash_gadget(composer: Composer, msg: list[Witness]) -> Witness:
    """Hash L message wires with the rate-4 sponge, in-circuit.

    Mirrors models/sponge.py exactly: capacity word = the message length L
    as a field element (fixed-length domain separation), zero-padding to a
    multiple of the rate, absorption adds into words 1..4, digest = word 1
    after the final permutation. Returns the digest wire.
    """
    length = len(msg)
    if length == 0:
        raise ValueError("empty message")
    msg = list(msg) + [composer.ZERO] * ((-length) % RATE)
    iv = constant_witness(composer, length)
    state: list[Witness] = [iv] + [composer.ZERO] * RATE
    for c in range(len(msg) // RATE):
        chunk = msg[c * RATE : (c + 1) * RATE]
        for i in range(RATE):
            if c == 0:
                # first chunk: state words 1..4 are the ZERO wire, so the
                # fed word IS the message wire — no add gate needed
                state[1 + i] = chunk[i]
            else:
                state[1 + i] = composer.gate_add(
                    Constraint().left(1).a(state[1 + i]).right(1).b(chunk[i])
                )
        GadgetStrategy.gadget(composer, state)
    return state[DIGEST_INDEX]


# ---------------------------------------------------------------------------
# Merkle membership gadget (models/merkle.py node rule)
# ---------------------------------------------------------------------------


def merkle_membership_gadget(
    composer: Composer,
    leaf: Witness,
    groups: list[list[Witness]],
    bits: list[tuple[Witness, Witness]],
) -> Witness:
    """Walk an arity-4 Merkle path in-circuit; returns the root wire.

    groups: per level (bottom-up) the FULL 4-child group as wires;
    bits: per level the little-endian position bits (b0, b1) of the running
    node inside that group (pos = b0 + 2*b1). Constrains the bits boolean,
    the node to sit at its claimed slot (the 2-bit multiplexer identity in
    the module docstring), and hashes each group with the models/merkle.py
    node rule perm([TAG, g0..g3])[1].
    """
    if len(groups) != len(bits):
        raise ValueError("groups and bits must have equal height")
    if not groups:
        raise ValueError("empty path")
    tag = constant_witness(composer, MERKLE_TAG)
    node = leaf
    for g, (b0, b1) in zip(groups, bits):
        if len(g) != MERKLE_ARITY:
            raise ValueError(f"child groups must have {MERKLE_ARITY} wires")
        assert_boolean(composer, b0)
        assert_boolean(composer, b1)
        t = composer.gate_mul(Constraint().mult(1).a(b0).b(b1))
        e1 = composer.gate_add(
            Constraint().left(1).a(g[1]).right(-1).b(g[0])
        )
        e2 = composer.gate_add(
            Constraint().left(1).a(g[2]).right(-1).b(g[0])
        )
        e3a = composer.gate_add(
            Constraint().left(1).a(g[3]).right(-1).b(g[2]).fourth(-1).d(g[1])
        )
        e3 = composer.gate_add(
            Constraint().left(1).a(e3a).right(1).b(g[0])
        )
        m1 = composer.gate_mul(Constraint().mult(1).a(b0).b(e1))
        m2 = composer.gate_mul(Constraint().mult(1).a(b1).b(e2))
        m3 = composer.gate_mul(Constraint().mult(1).a(t).b(e3))
        s1 = composer.gate_add(
            Constraint().left(1).a(g[0]).right(1).b(m1).fourth(1).d(m2)
        )
        sel = composer.gate_add(
            Constraint().left(1).a(s1).right(1).b(m3)
        )
        composer.assert_equal(sel, node)
        state = [tag] + list(g)
        GadgetStrategy.gadget(composer, state)
        node = state[DIGEST_INDEX]
    return node


def index_from_bits_gadget(
    composer: Composer, bits: list[tuple[Witness, Witness]]
) -> Witness:
    """Recompose the leaf index wire from per-level position bits:
    index = sum_lvl (b0 + 2*b1) * 4^lvl (bits bottom-up, like the gadget)."""
    acc = composer.ZERO
    for lvl, (b0, b1) in enumerate(bits):
        acc = composer.gate_add(
            Constraint()
            .left(1).a(acc)
            .right(4**lvl).b(b0)
            .fourth(2 * 4**lvl).d(b1)
        )
    return acc


# ---------------------------------------------------------------------------
# Duplex cipher gadget (models/cipher.py spec)
# ---------------------------------------------------------------------------


def cipher_encrypt_gadget(
    composer: Composer,
    key: tuple[Witness, Witness],
    nonce: Witness,
    msg: list[Witness],
) -> tuple[list[Witness], Witness]:
    """Encrypt L message wires with the duplex cipher, in-circuit.

    Mirrors models/cipher.py exactly: init state
    [TAG_ENC + L'*2^32, k0, k1, nonce, 1] (L' = padded length), permute,
    then per rate-4 chunk c_i = m_i + state[1+i], duplex the ciphertext
    back in, permute; tag = word 1 of the final state. Returns
    (ciphertext wires [L' of them], tag wire). Proving this circuit shows
    knowledge of (key, message) consistent with a public ciphertext+tag.
    """
    if not msg:
        raise ValueError("empty message")
    msg = list(msg) + [composer.ZERO] * ((-len(msg)) % RATE)
    n_padded = len(msg)
    state: list[Witness] = [
        constant_witness(composer, CIPHER_TAG + (n_padded << 32)),
        key[0],
        key[1],
        nonce,
        constant_witness(composer, 1),
    ]
    GadgetStrategy.gadget(composer, state)
    ct: list[Witness] = []
    for c in range(n_padded // RATE):
        for i in range(RATE):
            word = composer.gate_add(
                Constraint()
                .left(1).a(msg[c * RATE + i])
                .right(1).b(state[1 + i])
            )
            state[1 + i] = word
            ct.append(word)
        GadgetStrategy.gadget(composer, state)
    return ct, state[DIGEST_INDEX]


# ---------------------------------------------------------------------------
# Complete public-statement circuits
# ---------------------------------------------------------------------------


def sponge_preimage_circuit(msg_ints: list[int], digest: int) -> Composer:
    """Prove knowledge of a message hashing to the PUBLIC digest
    (models/sponge.py semantics; the sponge analogue of the reference's
    preimage test circuit, gadget.rs:151-178)."""
    c = Composer()
    msg = [c.append_witness(m) for m in msg_ints]
    d = sponge_hash_gadget(c, msg)
    expose_public(c, d, digest)
    return c


def merkle_membership_circuit(
    leaf: int,
    groups_ints,
    positions,
    root: int,
    index: int | None = None,
) -> Composer:
    """Prove knowledge of a leaf and an arity-4 path to the PUBLIC root.

    groups_ints: (height, 4) canonical child-group values bottom-up;
    positions: (height,) node positions within each group. If `index` is
    given it is exposed as a public input and constrained to equal the
    positions' radix-4 recomposition (binding the statement to WHERE the
    leaf sits, not just that it is present). Use merkle_path_ints() to
    extract these from a models/merkle.py tree build.
    """
    c = Composer()
    leaf_w = c.append_witness(leaf)
    groups_w = [[c.append_witness(int(v)) for v in g] for g in groups_ints]
    bits_w = [
        (c.append_witness(int(p) & 1), c.append_witness(int(p) >> 1))
        for p in positions
    ]
    root_w = merkle_membership_gadget(c, leaf_w, groups_w, bits_w)
    expose_public(c, root_w, root)
    if index is not None:
        idx_w = index_from_bits_gadget(c, bits_w)
        expose_public(c, idx_w, index)
    return c


def cipher_encryption_circuit(
    key: tuple[int, int],
    nonce: int,
    msg_ints: list[int],
    ciphertext: list[int],
    tag: int,
) -> Composer:
    """Prove knowledge of (key, message) that encrypts — under the PUBLIC
    nonce — to the PUBLIC ciphertext and authentication tag
    (models/cipher.py semantics)."""
    c = Composer()
    key_w = (c.append_witness(key[0]), c.append_witness(key[1]))
    nonce_w = c.append_witness(nonce)
    expose_public(c, nonce_w, nonce)
    msg_w = [c.append_witness(m) for m in msg_ints]
    ct_w, tag_w = cipher_encrypt_gadget(c, key_w, nonce_w, msg_w)
    if len(ct_w) != len(ciphertext):
        raise ValueError(
            f"ciphertext must carry the padded length {len(ct_w)}"
        )
    for w, v in zip(ct_w, ciphertext):
        expose_public(c, w, v)
    expose_public(c, tag_w, tag)
    return c


# ---------------------------------------------------------------------------
# Host-side witness extraction from model outputs
# ---------------------------------------------------------------------------


def merkle_path_ints(levels, index: int):
    """Canonical-int path data for merkle_membership_circuit from a
    models/merkle.py `merkle_levels` build (torch tensors on any device):
    returns
    (leaf, groups (height, 4) ints, positions (height,), root)."""
    from . import field
    from .models import merkle
    from .utils.encoding import digits_to_ints

    def ints(mont):
        return digits_to_ints(field.from_mont(mont).cpu().numpy())

    path = merkle.merkle_open(levels, index)
    groups = [[int(v) for v in ints(sibs)] for sibs, _ in path]
    positions = [pos for _, pos in path]
    leaf = int(ints(levels[0][index]))
    root = int(ints(levels[-1][0]))
    return leaf, groups, positions, root


def public_input_column(composer: Composer) -> list[int]:
    """The circuit's public-input column, as plonk.verify /
    fri.verify_succinct expect it."""
    return [g.pi for g in composer.gates]
