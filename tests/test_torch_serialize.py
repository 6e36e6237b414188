"""The port's wire format (`hades252_tpu_torch.serialize`) against the JAX
package's `hades252_tpu.serialize`, on the CPU.

The same seeded proofs and keys, made by each package's own `fri` and
`aggregate`, are encoded by each package's own `serialize`: the bytes
must be equal, each package must decode the other's bytes to a proof that
verifies, and every malformed input of the JAX tests' rejection battery
must be refused by both with the same `ValueError` message. Tolerance:
none (bytes, messages and verdicts are equal). Sizes are the JAX tests'
own: the tiny composers at small `FriParams`.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from hades252_tpu import aggregate as jagg
from hades252_tpu import fri as jfri
from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu import serialize as jser
from hades252_tpu_torch import aggregate, fri, gadget, plonk, serialize

torch.set_num_threads(1)

JPERM = jfri.default_pcs_perm()
PERM = fri.default_pcs_perm()
PLAIN = dict(blowup=8, n_queries=8, final_degree=8, pow_bits=3)
ZK = dict(blowup=4, n_queries=6, final_degree=16, zk=True)


def tiny(g, a_val: int = 3, b_val: int = 5):
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(1).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-(a_val + b_val)))
    return c


def _pi(c) -> list[int]:
    return [g.pi for g in c.gates]


class Side:
    """One package's view of the same statement: its modules, composer,
    keys and proof."""

    def __init__(self, fri_mod, ser, agg, g, perm, params, seed):
        self.fri, self.ser, self.agg, self.perm = fri_mod, ser, agg, perm
        self.c = tiny(g)
        self.pk, self.vk = fri_mod.preprocess_succinct(self.c, fri_mod.FriParams(**params), perm)
        rng = np.random.default_rng(seed) if seed is not None else None
        self.proof = fri_mod.prove_succinct(self.c, self.pk, perm, rng=rng)
        self.agg_cs = [tiny(g, 3, 5), tiny(g, 2, 9), tiny(g, 7, 11)]
        rng = np.random.default_rng(seed + 1) if seed is not None else None
        self.agg_proof = agg.prove_aggregate(self.agg_cs, self.pk, perm, rng=rng)

    def proof_bytes(self) -> bytes:
        return self.ser.proof_to_bytes(self.proof, self.vk)

    def agg_bytes(self) -> bytes:
        return self.ser.aggregate_to_bytes(self.agg_proof, self.vk)


def _sides(params, seed=None):
    return (Side(fri, serialize, aggregate, gadget, PERM, params, seed),
            Side(jfri, jser, jagg, jgadget, JPERM, params, seed))


@pytest.fixture(scope="module")
def plain():
    return _sides(PLAIN)


@pytest.fixture(scope="module")
def zk():
    return _sides(ZK, seed=7)


@pytest.fixture(params=["plain", "zk"])
def sides(request, plain, zk):
    return plain if request.param == "plain" else zk


# -- the same bytes, and each package reads the other's -----------------------------


def test_proof_bytes_alike_and_cross_decode(sides):
    mine, theirs = sides
    data = mine.proof_bytes()
    assert data == theirs.proof_bytes()
    assert len(data) <= serialize.expected_proof_size(
        mine.vk.n, mine.vk.params, n_final=len(mine.proof.fri.final_coeffs))
    back = serialize.proof_from_bytes(data, mine.vk)
    assert serialize.proof_to_bytes(back, mine.vk) == data
    assert fri.verify_succinct(mine.vk, back, _pi(mine.c), PERM)
    jback = jser.proof_from_bytes(data, theirs.vk)
    assert jfri.verify_succinct(theirs.vk, jback, _pi(theirs.c), JPERM)


def test_vk_bytes_alike_and_cross_decode(sides):
    mine, theirs = sides
    data = serialize.vk_to_bytes(mine.vk)
    assert data == jser.vk_to_bytes(theirs.vk)
    assert serialize.vk_from_bytes(data) == mine.vk
    assert jser.vk_from_bytes(data) == theirs.vk


def test_aggregate_bytes_alike_and_cross_decode(sides):
    mine, theirs = sides
    data = mine.agg_bytes()
    assert data == theirs.agg_bytes()
    assert len(data) <= serialize.expected_aggregate_size(
        mine.vk.n, mine.vk.params, 3, n_final=len(mine.agg_proof.fri.final_coeffs))
    pis = [_pi(c) for c in mine.agg_cs]
    back = serialize.aggregate_from_bytes(data, mine.vk)
    assert serialize.aggregate_to_bytes(back, mine.vk) == data
    assert aggregate.verify_aggregate(mine.vk, back, pis, PERM)
    assert jagg.verify_aggregate(theirs.vk, jser.aggregate_from_bytes(data, theirs.vk), pis, JPERM)


def test_byte_breakdowns_and_sizes_alike(sides):
    mine, theirs = sides
    bd = serialize.proof_byte_breakdown(mine.proof, mine.vk)
    assert bd == jser.proof_byte_breakdown(theirs.proof, theirs.vk)
    assert bd["total"] == len(mine.proof_bytes())
    for b in (1, 3, 64):
        assert (serialize.expected_aggregate_size(1024, mine.vk.params, b)
                == jser.expected_aggregate_size(1024, theirs.vk.params, b))


def test_proven_preset_key_round_trips_alike():
    p, jp = fri.FriParams.proven(), jfri.FriParams.proven()
    assert serialize.expected_proof_size(1024, p) == jser.expected_proof_size(1024, jp)
    vk = fri.VerifyingKey(n=1024, omega=plonk._domain_root(1024), n_gates=978, digest=1,
                          k_root=2, params=p)
    jvk = jfri.VerifyingKey(n=1024, omega=jplonk._domain_root(1024), n_gates=978, digest=1,
                            k_root=2, params=jp)
    blob = serialize.vk_to_bytes(vk)
    assert blob == jser.vk_to_bytes(jvk) and serialize.vk_from_bytes(blob) == vk


# -- the rejection battery: the same refusal from both ------------------------------


def _node_count_offset(side) -> int:
    """Where the w tree's pruned-node count sits in a plain proof."""
    vk, proof = side.vk, side.proof
    schema = side.fri.proof_schema(vk.n, vk.params)
    u0 = len(proof.open_blocks["w"])
    bs_w = 2 * len(side.fri.tree_columns(vk.params.zk)["w"])
    return (len(side.ser.MAGIC_PROOF) + side.ser._PROOF_HEADER.size
            + 32 * (3 + len(side.fri.eval_order(vk.params.zk)) + len(schema["sched"])
                    + len(proof.fri.final_coeffs))
            + 8 + 2 + u0 * bs_w * 32)


def _malformed(kind: str, side, other):
    """(decoder, bytes, key) of one malformed input, for one package."""
    ser, vk = side.ser, side.vk
    proof, vkb, agg = side.proof_bytes(), ser.vk_to_bytes(vk), side.agg_bytes()
    hdr = len(ser.MAGIC_PROOF) + ser._PROOF_HEADER.size

    def patched(data, off, new):
        data = bytearray(data)
        data[off : off + len(new)] = new
        return bytes(data)

    vk_hdr = len(ser.MAGIC_VK)
    return {
        "bad magic": (ser.proof_from_bytes, b"XXXX" + proof[4:], vk),
        "v1 magic": (ser.proof_from_bytes, b"HSP1" + proof[4:], vk),
        "vk bad magic": (ser.vk_from_bytes, b"YYYY" + vkb[4:], None),
        "truncated proof": (ser.proof_from_bytes, proof[:-1], vk),
        "trailing proof": (ser.proof_from_bytes, proof + b"\x00", vk),
        "truncated vk": (ser.vk_from_bytes, vkb[:-1], None),
        "trailing vk": (ser.vk_from_bytes, vkb + b"\x00", None),
        "non-canonical root": (ser.proof_from_bytes, patched(proof, hdr, b"\xff" * 32), vk),
        "impossible node count": (ser.proof_from_bytes, patched(
            proof, _node_count_offset(side), (10 ** 6).to_bytes(4, "little")), vk),
        "header and key disagree": (ser.proof_from_bytes, proof, other.vk),
        "vk n not a power of two": (ser.vk_from_bytes, patched(
            vkb, vk_hdr, (3).to_bytes(4, "little")), None),
        "vk gate count above n": (ser.vk_from_bytes, patched(
            vkb, vk_hdr + 4, (vk.n + 1).to_bytes(4, "little")), None),
        "aggregate bad magic": (ser.aggregate_from_bytes, b"XXXX" + agg[4:], vk),
        "aggregate with a proof's magic": (ser.aggregate_from_bytes,
                                           ser.MAGIC_PROOF + agg[4:], vk),
        "aggregate truncated": (ser.aggregate_from_bytes, agg[:-1], vk),
        "aggregate trailing": (ser.aggregate_from_bytes, agg + b"\x00", vk),
        "aggregate of no instance": (ser.aggregate_from_bytes, patched(
            agg, len(ser.MAGIC_AGG) + ser._AGG_HEADER.size - 4, (0).to_bytes(4, "little")), vk),
        "aggregate header and key disagree": (ser.aggregate_from_bytes, agg,
                                              replace(vk, n=2 * vk.n)),
    }[kind]


MALFORMED = ["bad magic", "v1 magic", "vk bad magic", "truncated proof", "trailing proof",
             "truncated vk", "trailing vk", "non-canonical root", "impossible node count",
             "header and key disagree", "vk n not a power of two", "vk gate count above n",
             "aggregate bad magic", "aggregate with a proof's magic", "aggregate truncated",
             "aggregate trailing", "aggregate of no instance",
             "aggregate header and key disagree"]


@pytest.mark.parametrize("kind", MALFORMED)
def test_malformed_input_refused_alike(kind, plain, zk):
    (mine, theirs), (zk_mine, zk_theirs) = plain, zk
    fn, data, key = _malformed(kind, mine, zk_mine)
    jfn, jdata, jkey = _malformed(kind, theirs, zk_theirs)
    assert data == jdata
    messages = []
    for decode, blob, k in ((fn, data, key), (jfn, jdata, jkey)):
        with pytest.raises(ValueError) as e:
            decode(blob) if k is None else decode(blob, k)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _unserialisable(kind: str, side):
    proof = side.proof
    if kind == "short block":
        blocks = {k: [list(b) for b in v] for k, v in proof.open_blocks.items()}
        blocks["w"][0] = blocks["w"][0][:-1]
        return replace(proof, open_blocks=blocks)
    if kind == "oversized node set":
        return replace(proof, open_nodes={**proof.open_nodes,
                                          "w": np.zeros((10 ** 4, 16), np.uint32)})
    roots = dict(proof.roots)
    del roots["z"]
    return replace(proof, roots=roots)


@pytest.mark.parametrize("kind", ["short block", "oversized node set", "missing root"])
def test_serializer_refuses_a_malformed_proof_alike(kind, plain):
    mine, theirs = plain
    with pytest.raises(ValueError) as e:
        serialize.proof_to_bytes(_unserialisable(kind, mine), mine.vk)
    with pytest.raises(ValueError) as je:
        jser.proof_to_bytes(_unserialisable(kind, theirs), theirs.vk)
    assert str(e.value) == str(je.value)


# -- a changed byte decodes but does not verify ------------------------------------


@pytest.mark.parametrize("where", ["first root", "pow nonce", "aggregate opened value"])
def test_changed_byte_verifies_false_alike(where, plain):
    mine, theirs = plain
    vk, schema = mine.vk, fri.proof_schema(mine.vk.n, mine.vk.params)
    hdr = len(serialize.MAGIC_PROOF) + serialize._PROOF_HEADER.size
    if where == "aggregate opened value":
        data = bytearray(mine.agg_bytes())
        scalars = (3 + 3 * 7 + 10 + len(schema["sched"])
                   + len(mine.agg_proof.fri.final_coeffs))
        data[len(serialize.MAGIC_AGG) + serialize._AGG_HEADER.size + 32 * scalars + 10] ^= 1
        pis = [_pi(c) for c in mine.agg_cs]
        got = aggregate.verify_aggregate(vk, serialize.aggregate_from_bytes(bytes(data), vk),
                                         pis, PERM)
        want = jagg.verify_aggregate(theirs.vk, jser.aggregate_from_bytes(bytes(data), theirs.vk),
                                     pis, JPERM)
    else:
        data = bytearray(mine.proof_bytes())
        off = hdr if where == "first root" else hdr + 32 * (
            3 + len(fri.eval_order(False)) + len(schema["sched"])
            + len(mine.proof.fri.final_coeffs))
        if where == "pow nonce":
            assert int.from_bytes(data[off : off + 8], "little") == mine.proof.pow_nonce
        data[off] ^= 1
        got = fri.verify_succinct(vk, serialize.proof_from_bytes(bytes(data), vk),
                                  _pi(mine.c), PERM)
        want = jfri.verify_succinct(theirs.vk, jser.proof_from_bytes(bytes(data), theirs.vk),
                                    _pi(theirs.c), JPERM)
    assert got is want is False
