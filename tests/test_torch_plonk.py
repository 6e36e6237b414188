"""The port's host proof layers (gadget, circuits, plonk, asset_gen) against
the JAX package's, exactly.

Both sides are host Python: the same seeded inputs build the same
composers, keys, proofs and transcripts, which must be equal object for
object. Proving runs at n <= 64; the 973-gate circuits are held to the
JAX package's through their columns and keys only.
"""

import numpy as np
import pytest
import torch

from hades252_tpu import circuits as jcircuits
from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu.utils import asset_gen as jasset_gen
from hades252_tpu_torch import circuits, gadget, plonk
from hades252_tpu_torch.models import merkle
from hades252_tpu_torch.params import P, WIDTH, _ASSET_DIR
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils import asset_gen
from hades252_tpu_torch.utils.encoding import ints_to_digits

torch.set_num_threads(1)


def _ints(rng, k):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]


def _perm5(state):
    return ScalarStrategy().perm([int(v) % P for v in state])


def _sponge_oracle(words):
    """models/sponge.py spec on canonical ints."""
    msg = list(words) + [0] * ((-len(words)) % 4)
    st = [len(words), 0, 0, 0, 0]
    for c in range(len(msg) // 4):
        st = _perm5([st[0]] + [(st[1 + i] + msg[c * 4 + i]) % P for i in range(4)])
    return st[1]


def _cipher_oracle(key, nonce, words):
    """models/cipher.py spec on canonical ints."""
    msg = list(words) + [0] * ((-len(words)) % 4)
    st = _perm5([6 + (len(msg) << 32), key[0], key[1], nonce, 1])
    ct = []
    for c in range(len(msg) // 4):
        cw = [(msg[c * 4 + i] + st[1 + i]) % P for i in range(4)]
        ct += cw
        st = _perm5([st[0]] + cw)
    return ct, st[1]


def _int_tree(leaves):
    """Pure-int arity-4 tree levels over a power-of-4 leaf count."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        level = levels[-1]
        levels.append([_perm5([4] + level[g * 4 : (g + 1) * 4])[1]
                       for g in range(len(level) // 4)])
    return levels


def _small_circuit(mod, values, public):
    """A circuit of 2 n_values + 1 gates with shared wires (copy constraints), a
    public input and constants, built through `mod`'s Composer: the JAX
    package's or the port's gadget module."""
    c = mod.Composer()
    Constraint = mod.Constraint
    ws = [c.append_witness(v) for v in values]
    acc = ws[0]
    for w in ws[1:]:
        prod = c.gate_mul(Constraint().mult(1).a(acc).b(w))
        acc = c.gate_add(Constraint().left(1).a(prod).right(2).b(w).fourth(3).d(ws[0]).constant(5))
    total = (c.value(acc) + public) % P
    c.append_gate(Constraint().left(1).a(acc).constant(public).public(-total))
    c.assert_equal(ws[1], ws[1])
    return c


def _both(rng, n_values):
    values = _ints(rng, n_values)
    public = _ints(rng, 1)[0]
    return _small_circuit(jgadget, values, public), _small_circuit(gadget, values, public)


def _assert_arrays_equal(jc, c):
    want, got = jc.to_arrays(), c.to_arrays()
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    assert jc._values == c._values
    assert c.check_satisfied() == jc.check_satisfied()


def _assert_keys_equal(jkey, key):
    for name in ("n", "omega", "selectors", "sigmas", "n_gates"):
        assert getattr(jkey, name) == getattr(key, name), name


def _assert_proofs_equal(jproof, proof):
    assert proof.wires == jproof.wires
    assert proof.z == jproof.z
    assert proof.t == jproof.t
    assert proof.commitments == jproof.commitments


# -- composers and circuits ---------------------------------------------------


@pytest.mark.parametrize("length", [1, 5])
def test_sponge_preimage_circuit_equals_jax(rng, length):
    msg = _ints(rng, length)
    digest = _sponge_oracle(msg)
    jc = jcircuits.sponge_preimage_circuit(msg, digest)
    c = circuits.sponge_preimage_circuit(msg, digest)
    _assert_arrays_equal(jc, c)
    assert c.check_satisfied()
    assert circuits.public_input_column(c) == jcircuits.public_input_column(jc)


def test_merkle_membership_circuit_equals_jax(rng):
    """merkle_path_ints reads the port's torch levels (16 leaves on the
    CPU); the path must be the int tree's and the circuit the JAX
    package's."""
    leaves = _ints(rng, 16)
    levels = merkle.merkle_levels(torch.from_numpy(ints_to_digits(leaves, shape=(16,)).astype(np.int32)))
    leaf, groups, positions, root = circuits.merkle_path_ints(levels, 9)
    tree = _int_tree(leaves)
    assert leaf == leaves[9] and root == tree[-1][0]
    assert groups == [tree[0][8:12], tree[1][0:4]] and positions == [1, 2]
    jc = jcircuits.merkle_membership_circuit(leaf, groups, positions, root, index=9)
    c = circuits.merkle_membership_circuit(leaf, groups, positions, root, index=9)
    _assert_arrays_equal(jc, c)
    assert c.check_satisfied()


def test_cipher_encryption_circuit_equals_jax(rng):
    key, nonce, words = _ints(rng, 2), _ints(rng, 1)[0], _ints(rng, 3)
    ct, tag = _cipher_oracle(key, nonce, words)
    jc = jcircuits.cipher_encryption_circuit(key, nonce, words, ct, tag)
    c = circuits.cipher_encryption_circuit(key, nonce, words, ct, tag)
    _assert_arrays_equal(jc, c)
    assert c.check_satisfied()
    with pytest.raises(ValueError, match="padded length"):
        circuits.cipher_encryption_circuit(key, nonce, words, ct[:3], tag)


def test_permutation_gadget_equals_jax_and_oracle(rng):
    x = _ints(rng, WIDTH)
    jc, c = jgadget.Composer(), gadget.Composer()
    jws = [jc.append_witness(v) for v in x]
    ws = [c.append_witness(v) for v in x]
    jgadget.GadgetStrategy.gadget(jc, jws)
    gadget.GadgetStrategy.gadget(c, ws)
    assert len(c) == gadget.GATES_PER_PERM == len(jc)
    assert [c.value(w) for w in ws] == _perm5(x) == [jc.value(w) for w in jws]
    _assert_arrays_equal(jc, c)


# -- preprocess, prove, verify ------------------------------------------------


def test_preprocess_keys_equal_jax_at_full_width(rng):
    """The 973-gate permutation-preimage circuit, n = 1024."""
    x = _ints(rng, WIDTH)
    expected = _perm5(x)
    built = []
    for mod in (jgadget, gadget):
        c = mod.Composer()
        ws = [c.append_witness(v) for v in x]
        mod.GadgetStrategy.gadget(c, ws)
        for w, e in zip(ws, expected):
            c.append_gate(mod.Constraint().left(1).a(w).public(-e))
        built.append(c)
    jkey, key = jplonk.preprocess(built[0]), plonk.preprocess(built[1])
    assert key.n == 1024
    _assert_keys_equal(jkey, key)
    assert plonk.key_digest(key) == jplonk.key_digest(jkey)


@pytest.mark.parametrize("n_values", [2, 6, 30])
def test_prove_verify_equal_jax(rng, n_values):
    jc, c = _both(rng, n_values)
    _assert_arrays_equal(jc, c)
    jkey, key = jplonk.preprocess(jc), plonk.preprocess(c)
    _assert_keys_equal(jkey, key)
    assert key.n <= 64
    jproof, proof = jplonk.prove(jc, jkey), plonk.prove(c, key)
    _assert_proofs_equal(jproof, proof)
    pi = circuits.public_input_column(c)
    assert plonk.verify(key, proof, pi) and jplonk.verify(jkey, jproof, pi)
    # a tampered quotient and a rebound public input: both reject
    bad_t = plonk.Proof(wires=proof.wires, z=proof.z,
                        t=[(proof.t[0] + 1) % P] + proof.t[1:],
                        commitments=proof.commitments)
    jbad_t = jplonk.Proof(wires=jproof.wires, z=jproof.z, t=bad_t.t,
                          commitments=jproof.commitments)
    assert not plonk.verify(key, bad_t, pi) and not jplonk.verify(jkey, jbad_t, pi)
    rebound = [(v + 1) % P if v else v for v in pi]
    assert not plonk.verify(key, proof, rebound) and not jplonk.verify(jkey, jproof, rebound)


def test_host_transforms_equal_jax(rng):
    coeffs = _ints(rng, 16)
    assert plonk.ntt(coeffs) == jplonk.ntt(coeffs)
    assert plonk.ntt(coeffs, invert=True) == jplonk.ntt(coeffs, invert=True)
    assert plonk._coset_eval(coeffs[:5], 16, 7) == jplonk._coset_eval(coeffs[:5], 16, 7)
    assert plonk._coset_interp(coeffs, 7) == jplonk._coset_interp(coeffs, 7)
    assert plonk.batch_inverse(coeffs) == jplonk.batch_inverse(coeffs)
    assert plonk.commit(coeffs) == jplonk.commit(coeffs)
    stream = ints_to_digits(coeffs, shape=(16,)).astype("<u2").tobytes()
    assert plonk.commit_bytes(stream) == plonk.commit(coeffs)
    with pytest.raises(ValueError, match="power of two"):
        plonk.ntt(coeffs[:6])


# -- transcripts --------------------------------------------------------------


def test_transcripts_equal_jax(rng):
    """Transcript and BatchedTranscript challenges over 5 steps equal the
    JAX package's, and the batched one equals B single ones."""
    b = 5
    streams = [_ints(rng, 5) for _ in range(b)]
    bt, jbt = plonk.BatchedTranscript(b), jplonk.BatchedTranscript(b)
    singles = [plonk.Transcript() for _ in range(b)]
    jsingles = [jplonk.Transcript() for _ in range(b)]
    for step in range(5):
        vals = [streams[i][step] for i in range(b)]
        bt.absorb_each(vals)
        jbt.absorb_each(vals)
        for i in range(b):
            singles[i].absorb(vals[i])
            jsingles[i].absorb(vals[i])
        got = bt.challenge_each()
        assert got == jbt.challenge_each()
        assert got == [t.challenge() for t in singles] == [t.challenge() for t in jsingles]
    assert bt.states == jbt.states == [t.state for t in singles]
    with pytest.raises(ValueError, match="one absorbed value"):
        bt.absorb_each([1] * (b + 1))
    multi, jmulti = plonk.Transcript(), jplonk.Transcript()
    multi.absorb(*streams[0])
    jmulti.absorb(*streams[0])
    assert multi.challenge() == jmulti.challenge()


def test_transcript_falls_back_to_the_int_oracle(rng, monkeypatch):
    """Without the native engine the transcripts permute through the
    port's ScalarStrategy: the same challenges."""
    from hades252_tpu_torch.utils import native

    vals = _ints(rng, 3)
    want = plonk.Transcript()
    want.absorb(*vals)
    want_bt = plonk.BatchedTranscript(3)
    want_bt.absorb_each(vals)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(plonk, "_TRANSCRIPT_PERM", None)
    monkeypatch.setattr(plonk, "_TRANSCRIPT_PERM_BATCH", None)
    got = plonk.Transcript()
    got.absorb(*vals)
    got_bt = plonk.BatchedTranscript(3)
    got_bt.absorb_each(vals)
    assert got.challenge() == want.challenge()
    assert got_bt.challenge_each() == want_bt.challenge_each()


def test_statement_digests_equal_jax(rng):
    digest = _ints(rng, 1)[0]
    cols = [_ints(rng, 6) for _ in range(3)]
    rows = ints_to_digits(cols, shape=(3, 6))
    got = plonk.statement_digest_rows(digest, rows)
    assert got == jplonk.statement_digest_rows(digest, rows)
    assert got == [plonk.statement_digest(digest, col) for col in cols]
    assert got == [jplonk.statement_digest(digest, col) for col in cols]


# -- constant assets ----------------------------------------------------------


@pytest.mark.parametrize("name", ["ark", "mds"])
def test_generated_assets_equal_jax_and_files(name):
    got = getattr(asset_gen, f"generate_{name}")()
    assert got == getattr(jasset_gen, f"generate_{name}")()
    with open(f"{_ASSET_DIR}/{name}.bin", "rb") as f:
        assert got == f.read()
