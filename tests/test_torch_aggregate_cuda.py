"""The port's device aggregate prover (`fri_cuda.prove_aggregate_device`, the
counterpart of `hades252_tpu/fri_tpu.py:1187-1465`) against both packages'
host `aggregate.prove_aggregate`, on the CPU.

The same seeded instances, plain and zk (one seeded generator on each side),
at B = 1 and 3, give aggregates whose bytes equal the port's and the JAX
package's (through both packages' `serialize.aggregate_to_bytes`), and that
both packages' `verify_aggregate` accept. Tolerance: none; every digit,
byte and nonce must be equal.

Sizes are the JAX tests' (the two-gate circuit, blowup 4, 3 queries; zk at
blowup 2 and one query, with the JAX tests' own zk preset marked slow). The
plain PyTorch permutation takes about 0.7 s a call on a CPU, so the
prover's permutations run through the native engine on CPU tensors, through
the seam `fri_cuda.permute_cuda` (tests/test_torch_fri_cuda.py does the
same for the succinct prover).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hades252_tpu import aggregate as jagg
from hades252_tpu import fri as jfri
from hades252_tpu import gadget as jgadget
from hades252_tpu import serialize as jser
from hades252_tpu_torch import aggregate, fri, fri_cuda, gadget, serialize
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils import native

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its main does not run on import)

torch.set_num_threads(1)

JPERM = jfri.default_pcs_perm()
PERM = fri.default_pcs_perm()
PARAMS = dict(blowup=4, n_queries=3, final_degree=8, pow_bits=2)
ZK_SMALL = dict(blowup=2, n_queries=1, final_degree=8, pow_bits=2, zk=True)


@pytest.fixture
def calls(monkeypatch):
    """The prover's kernel seam on the native engine: records the schedule
    and batch of every call."""
    seen = []

    def kernel(states, schedule):
        seen.append((schedule, states.shape[0]))
        out = native.perm_batch_digits(states.numpy().astype(np.uint32))
        return torch.from_numpy(out.astype(np.int32))

    monkeypatch.setattr(fri_cuda, "permute_cuda", kernel)
    return seen


def tiny(g, a_val: int = 3, b_val: int = 5):
    """The JAX tests' two-gate circuit in either package: a * b, then a + b
    against a public input."""
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(1).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-(a_val + b_val)))
    return c


def _instances(g, b):
    return [tiny(g, 3 + k, 5 + 2 * k) for k in range(b)]


def _aggregate_alike(params, b, calls, seed=21):
    cs, jcs = _instances(gadget, b), _instances(jgadget, b)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**params), PERM)
    jpk, jvk = jfri.preprocess_succinct(jcs[0], jfri.FriParams(**params), JPERM)
    agg = fri_cuda.prove_aggregate_device(cs, pk, np.random.default_rng(seed), device="cpu")
    data = serialize.aggregate_to_bytes(agg, vk)
    host = aggregate.prove_aggregate(cs, pk, PERM, rng=np.random.default_rng(seed))
    jhost = jagg.prove_aggregate(jcs, jpk, JPERM, rng=np.random.default_rng(seed))
    assert data == serialize.aggregate_to_bytes(host, vk) == jser.aggregate_to_bytes(jhost, jvk)
    assert agg.n_instances == b and (agg.r_eval is not None) == bool(params.get("zk"))
    pis = [[g_.pi for g_ in c.gates] for c in cs]
    assert aggregate.verify_aggregate(vk, agg, pis, PERM)
    assert jagg.verify_aggregate(jvk, jser.aggregate_from_bytes(data, jvk), pis, JPERM)
    bad = [list(p) for p in pis]
    bad[-1][-1] = (bad[-1][-1] + 1) % P
    assert not aggregate.verify_aggregate(vk, agg, bad, PERM)
    # every permutation went through the kernel seam, as many calls as planned
    eager, in_graph = chip_smoke.device_aggregate_launches(vk, b, agg.pow_nonce)
    assert len(calls) == eager + in_graph and {s for s, _ in calls} == {"opt"}
    return agg


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("final_degree", [8, 2])
def test_device_aggregate_equals_host_and_jax(calls, b, final_degree):
    """Plain mode: final degree 8 commits no FRI layer, 2 one quad layer."""
    _aggregate_alike(dict(PARAMS, final_degree=final_degree), b, calls)


@pytest.mark.parametrize("b", [1, 3])
def test_device_aggregate_zk_equals_host_and_jax(calls, b):
    """zk at blowup 2 and one query (three folds, a quad and a pair layer):
    the wire blinds of every instance, then every z blind, then the one
    shared mask, from one generator, as the host prover draws them."""
    _aggregate_alike(ZK_SMALL, b, calls, seed=5)


@pytest.mark.slow
def test_device_aggregate_zk_at_the_jax_tests_size(calls):
    """zk at the JAX tests' own preset (m0 = 512), B = 3."""
    _aggregate_alike(dict(PARAMS, zk=True), 3, calls)


def test_device_aggregate_takes_the_schedule_asked_for(calls):
    cs = _instances(gadget, 2)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**dict(PARAMS, pow_bits=0)), PERM)
    got = fri_cuda.prove_aggregate_device(cs, pk, schedule="hyb13", device="cpu")
    assert calls and {s for s, _ in calls} == {"hyb13"}
    assert got.pow_nonce == 0
    assert serialize.aggregate_to_bytes(got, vk) == serialize.aggregate_to_bytes(
        aggregate.prove_aggregate(cs, pk, PERM), vk)


@pytest.mark.parametrize("case", ["mixed structure", "empty", "unsatisfied instance"])
def test_device_aggregate_refuses_as_the_host_prover_does(calls, case):
    """The same ValueError, word for word, as the port's and the JAX
    package's host prover."""
    messages = []
    for g, prove in ((gadget, fri_cuda.prove_aggregate_device), (gadget, aggregate.prove_aggregate),
                     (jgadget, jagg.prove_aggregate)):
        if case == "mixed structure":
            other = g.Composer()
            w = other.append_witness(2)
            other.gate_mul(g.Constraint().mult(1).a(w).b(w))
            cs = [tiny(g), other]
        elif case == "empty":
            cs = []
        else:
            bad = tiny(g)
            bad._values[bad.gates[0].w_a.index] = 4  # a * b no longer equals the product wire
            cs = [tiny(g, 2, 6), bad]
        pkg = fri if g is gadget else jfri
        perm = PERM if g is gadget else JPERM
        pk, _ = pkg.preprocess_succinct(tiny(g), pkg.FriParams(**dict(PARAMS, pow_bits=0)), perm)
        kwargs = {"device": "cpu"} if prove is fri_cuda.prove_aggregate_device else {}
        with pytest.raises(ValueError) as e:
            prove(cs, pk, **kwargs)
        messages.append(str(e.value))
    assert messages[0] == messages[1] == messages[2]
    if case != "unsatisfied instance":
        assert calls == []


def test_device_aggregate_refuses_a_bad_device_or_schedule(calls):
    cs = _instances(gadget, 2)
    pk, _ = fri.preprocess_succinct(cs[0], fri.FriParams(**dict(PARAMS, pow_bits=0)), PERM)
    with pytest.raises(ValueError, match="unknown schedule"):
        fri_cuda.prove_aggregate_device(cs, pk, schedule="nope", device="cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        fri_cuda.prove_aggregate_device(cs, pk, device="meta")
    if not torch.cuda.is_available():  # the default is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fri_cuda.prove_aggregate_device(cs, pk)
    assert calls == []
