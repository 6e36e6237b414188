"""The port's aggregated argument (`hades252_tpu_torch.aggregate`) against
the JAX package's `hades252_tpu.aggregate`, on the CPU.

The same seeded instances go through both packages' host code: the
proofs must be byte-identical through both packages' `aggregate_to_bytes`,
plain and zk (one seeded `np.random.Generator` for each side), and the
verdicts equal, tampered proofs included. Tolerance: none. Sizes are the
JAX tests' own: the tiny composers at
`FriParams(blowup=4, n_queries=6, final_degree=16, pow_bits=2)`.
"""

import math

import numpy as np
import pytest
import torch

from hades252_tpu import aggregate as jagg
from hades252_tpu import fri as jfri
from hades252_tpu import gadget as jgadget
from hades252_tpu import serialize as jser
from hades252_tpu_torch import aggregate, fri, fri_cuda, gadget, serialize
from hades252_tpu_torch.params import P

torch.set_num_threads(1)

JPERM = jfri.default_pcs_perm()
PERM = fri.default_pcs_perm()
PARAMS = dict(blowup=4, n_queries=6, final_degree=16, pow_bits=2)
WITNESSES = [(3, 5), (2, 9), (7, 11), (4, 6)]


def tiny(g, a_val: int, b_val: int):
    """a*b allocated, then a + b + pi = 0 with pi = -(a+b): one structure,
    per-instance witnesses and public inputs."""
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(1).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-(a_val + b_val)))
    return c


def _pis(composers):
    return [[g.pi for g in c.gates] for c in composers]


def _keys(**params):
    pk, vk = fri.preprocess_succinct(tiny(gadget, 3, 5), fri.FriParams(**params), PERM)
    jpk, jvk = jfri.preprocess_succinct(tiny(jgadget, 3, 5), jfri.FriParams(**params), JPERM)
    return pk, vk, jpk, jvk


@pytest.fixture(scope="module")
def keys():
    return _keys(**PARAMS)


@pytest.fixture(scope="module")
def zk_keys():
    return _keys(**{**PARAMS, "zk": True})


def _prove_both(keys, witnesses, seed=None):
    pk, vk, jpk, jvk = keys
    cs = [tiny(gadget, *w) for w in witnesses]
    jcs = [tiny(jgadget, *w) for w in witnesses]
    rng, jrng = ((np.random.default_rng(seed), np.random.default_rng(seed)) if seed is not None
                 else (None, None))
    proof = aggregate.prove_aggregate(cs, pk, PERM, rng=rng)
    jproof = jagg.prove_aggregate(jcs, jpk, JPERM, rng=jrng)
    return proof, jproof, _pis(cs)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_prove_aggregate_bytes_alike(keys, b):
    proof, jproof, pis = _prove_both(keys, WITNESSES[:b])
    pk, vk, jpk, jvk = keys
    data = serialize.aggregate_to_bytes(proof, vk)
    assert data == jser.aggregate_to_bytes(jproof, jvk)
    assert proof.n_instances == b
    assert aggregate.aggregate_size_field_elements(proof) == jagg.aggregate_size_field_elements(
        jproof)
    assert aggregate.verify_aggregate(vk, proof, pis, PERM)
    assert jagg.verify_aggregate(jvk, jproof, pis, JPERM)


@pytest.mark.parametrize("seed,witnesses", [(7, WITNESSES[:2]), (8, [(3, 5), (3, 5)])])
def test_prove_aggregate_zk_bytes_alike_with_a_shared_generator(zk_keys, seed, witnesses):
    proof, jproof, pis = _prove_both(zk_keys, witnesses, seed)
    pk, vk, jpk, jvk = zk_keys
    assert serialize.aggregate_to_bytes(proof, vk) == jser.aggregate_to_bytes(jproof, jvk)
    assert proof.r_eval == jproof.r_eval is not None
    assert aggregate.verify_aggregate(vk, proof, pis, PERM)


def _tamper(kind: str, proof, pis):
    """One changed thing in an aggregate of 2 instances (or its
    statement): (proof, public inputs). Changes the proof in place."""
    pis = [list(p) for p in pis]
    if kind == "eval":
        proof.evals[1]["a"] = (proof.evals[1]["a"] + 1) % P
    elif kind == "key eval":
        name = next(iter(proof.key_evals))
        proof.key_evals[name] = (proof.key_evals[name] + 1) % P
    elif kind == "public input":
        pis[1][-1] = (pis[1][-1] + 1) % P
    elif kind == "swapped instances":
        pis = pis[::-1]
    elif kind == "opening":
        blocks = [list(b) for b in proof.open_blocks["z"]]
        blocks[0][1] = (blocks[0][1] + 1) % P
        proof.open_blocks["z"] = blocks
    elif kind == "node":
        nodes = np.asarray(proof.open_nodes["w"]).copy()
        nodes[0, 0] ^= 1
        proof.open_nodes["w"] = nodes
    elif kind == "nonce":
        proof.pow_nonce += 1
    elif kind == "too few statements":
        pis = pis[:1]
    elif kind == "instance count":
        proof.n_instances = 3
        pis = pis + [[0, 0]]
    else:
        assert kind == "honest"
    return proof, pis


@pytest.mark.parametrize("kind", ["honest", "eval", "key eval", "public input",
                                  "swapped instances", "opening", "node", "nonce",
                                  "too few statements", "instance count"])
def test_verify_aggregate_verdicts_alike(keys, kind):
    pk, vk, jpk, jvk = keys
    proof, jproof, pis = _prove_both(keys, WITNESSES[:2])
    proof, mine = _tamper(kind, proof, pis)
    jproof, theirs = _tamper(kind, jproof, pis)
    got = aggregate.verify_aggregate(vk, proof, mine, PERM)
    assert got == jagg.verify_aggregate(jvk, jproof, theirs, JPERM) == (kind == "honest")


def test_verify_aggregate_through_device_pool_perm_on_the_cpu(keys):
    """The card's seam on its plain path accepts what the native engine
    proved (one verification: the plain version takes 0.5 s a call here)."""
    pk, vk, _, _ = keys
    proof, _, pis = _prove_both(keys, WITNESSES[:2])
    perm = fri_cuda.device_pool_perm("hybp", device="cpu")
    assert aggregate.verify_aggregate(vk, proof, pis, perm)


@pytest.mark.parametrize("case", ["mixed structure", "empty", "unsatisfied instance"])
def test_prove_aggregate_refusals_alike(keys, case):
    pk, _, jpk, _ = keys
    messages = []
    for g, agg, key in ((gadget, aggregate, pk), (jgadget, jagg, jpk)):
        if case == "mixed structure":
            other = g.Composer()
            w = other.append_witness(2)
            other.gate_mul(g.Constraint().mult(1).a(w).b(w))
            cs = [tiny(g, 3, 5), other]
        elif case == "empty":
            cs = []
        else:
            bad = tiny(g, 3, 5)
            bad._values[0] = (bad._values[0] + 1) % P
            cs = [tiny(g, 2, 6), bad]
        with pytest.raises(ValueError) as e:
            agg.prove_aggregate(cs, key)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_aggregate_specs_and_security_bits_alike():
    for zk in (False, True):
        for b in (1, 2, 5):
            assert aggregate.agg_tree_specs(zk, b) == jagg.agg_tree_specs(zk, b)
    assert aggregate.WIRE_EVAL_ORDER == jagg.WIRE_EVAL_ORDER
    assert aggregate.KEY_EVAL_ORDER == jagg.KEY_EVAL_ORDER
    for params in ({}, PARAMS, {"n_queries": 10_000}):
        for b in (1, 256, 1 << 20):
            got = aggregate.aggregate_security_bits(fri.FriParams(**params), 1024, b)
            assert got == jagg.aggregate_security_bits(jfri.FriParams(**params), 1024, b)
    f1, fb = (aggregate.aggregate_security_bits(fri.FriParams(n_queries=10_000), 1024, b)
              for b in (1, 256))
    assert abs((f1 - fb) - 8) < 1e-9 and math.isfinite(f1)
