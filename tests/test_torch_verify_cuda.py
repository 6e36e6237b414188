"""The port's device verifiers (`hades252_tpu_torch.fri_cuda`, the counterpart
of `hades252_tpu/fri_tpu.py:1467-1821`) against the JAX package and both
packages' host verifiers, on the CPU.

- `merkle.chain_nodes` under the tree nodes' tag / `device_chain_fn`, the
  sibling-opening chain, equal to the JAX body and to
  `fri.tree_verify_batched`'s host loop;
- `_fused_verify_plan` equal, array for array, to the JAX package's on the
  entries both packages' verifiers build (captured through an
  `entries_check` spy), its shapes the same for every query set, its
  guards the same;
- `_fused_pool_body`'s roots equal to the JAX body's, run eagerly on the
  host permutation;
- `verify_succinct_device_batch` (fused and not) and
  `verify_aggregate_device` give both packages' host verdicts on mixed
  batches with tampered proofs and on JAX-made bytes.

Tolerance: none. Sizes are the JAX tests' (the two-gate circuit, blowup 4,
3 queries, 2 PoW bits). The permutations run through the native engine on
CPU tensors, through the seam `fri_cuda.permute_cuda` (the plain version
takes about 0.7 s a call here); a CUDA graph needs the card, so the graphs
are held to their bodies in `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import functools
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from hades252_tpu import aggregate as jagg
from hades252_tpu import fri as jfri
from hades252_tpu import fri_tpu as jfri_tpu
from hades252_tpu import gadget as jgadget
from hades252_tpu import serialize as jser
from hades252_tpu_torch import aggregate, fri, fri_cuda, gadget, serialize
from hades252_tpu_torch.models import merkle
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils import native
from hades252_tpu_torch.utils.encoding import ints_to_digits

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its main does not run on import)

torch.set_num_threads(1)

JPERM = jfri.default_pcs_perm()
PERM = fri.default_pcs_perm()
CPU = torch.device("cpu")
PARAMS = dict(blowup=4, n_queries=3, final_degree=8, pow_bits=2)


def native_perm(states: torch.Tensor) -> torch.Tensor:
    out = native.perm_batch_digits(states.numpy().astype(np.uint32))
    return torch.from_numpy(out.astype(np.int32))


def jperm_rows(states):
    return np.asarray(JPERM(np.asarray(states, np.uint32)))


@pytest.fixture
def calls(monkeypatch):
    """The verifiers' kernel seam on the native engine: records the schedule
    and batch of every call."""
    seen = []

    def kernel(states, schedule):
        seen.append((schedule, states.shape[0]))
        return native_perm(states)

    monkeypatch.setattr(fri_cuda, "permute_cuda", kernel)
    return seen


def tiny(g, a_val: int = 3, b_val: int = 5):
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(1).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-(a_val + b_val)))
    return c


def _pis(cs):
    return [[g_.pi for g_ in c.gates] for c in cs]


@functools.cache
def _keys(zk: bool):
    params = dict(PARAMS, zk=zk)
    pk, vk = fri.preprocess_succinct(tiny(gadget), fri.FriParams(**params), PERM)
    jpk, jvk = jfri.preprocess_succinct(tiny(jgadget), jfri.FriParams(**params), JPERM)
    return pk, vk, jpk, jvk


def _tamper(kind: str, proof):
    """A copy of a succinct proof with one thing changed; one that reaches
    the pooled Merkle phase except "eval" (the zeta identity)."""
    if kind == "node":
        nodes = {k: np.array(v, copy=True) for k, v in proof.open_nodes.items()}
        nodes["w"][0, 0] ^= 1
        return replace(proof, open_nodes=nodes)
    if kind == "swapped blocks":
        blocks = dict(proof.open_blocks)
        w = [list(b) for b in blocks["w"]]
        w[0], w[1] = w[1], w[0]
        blocks["w"] = w
        return replace(proof, open_blocks=blocks)
    if kind == "layer node":
        layer_nodes = [np.array(v, copy=True) for v in proof.fri.layer_nodes]
        layer_nodes[0][0, 3] ^= 1
        return replace(proof, fri=replace(proof.fri, layer_nodes=layer_nodes))
    assert kind == "eval"
    return replace(proof, evals={**proof.evals, "a": (proof.evals["a"] + 1) % P})


@functools.cache
def _batch(zk: bool):
    """Five proofs of three instances in both packages, two honest and three
    tampered, and the JAX package's host verdicts. The final degree 2 gives
    one committed FRI layer."""
    params = dict(PARAMS, zk=zk, final_degree=2)
    cs, jcs = [tiny(gadget, 3 + k, 5 + k) for k in range(3)], [tiny(jgadget, 3 + k, 5 + k)
                                                               for k in range(3)]
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**params), PERM)
    jpk, jvk = jfri.preprocess_succinct(jcs[0], jfri.FriParams(**params), JPERM)
    kinds = ["honest", "node", "honest", "layer node" if not zk else "swapped blocks", "eval"]
    proofs, jproofs, pis = [], [], []
    for k, kind in enumerate(kinds):
        i = k % 3
        good = fri.prove_succinct(cs[i], pk, PERM, rng=np.random.default_rng(11 + k))
        jgood = jfri.prove_succinct(jcs[i], jpk, JPERM, rng=np.random.default_rng(11 + k))
        assert serialize.proof_to_bytes(good, vk) == jser.proof_to_bytes(jgood, jvk)
        proofs.append(good if kind == "honest" else _tamper(kind, good))
        jproofs.append(jgood if kind == "honest" else _tamper(kind, jgood))
        pis.append(_pis([cs[i]])[0])
    want = jfri.verify_succinct_batched(jvk, jproofs, pis, JPERM)
    assert list(want) == [kind == "honest" for kind in kinds]
    return vk, jvk, proofs, jproofs, pis, want


@functools.cache
def _aggregates(zk: bool):
    params = dict(PARAMS, zk=zk)
    cs, jcs = [tiny(gadget, 2 + k, 9 - k) for k in range(2)], [tiny(jgadget, 2 + k, 9 - k)
                                                               for k in range(2)]
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**params), PERM)
    jpk, jvk = jfri.preprocess_succinct(jcs[0], jfri.FriParams(**params), JPERM)
    agg = aggregate.prove_aggregate(cs, pk, PERM, rng=np.random.default_rng(5))
    jagg_ = jagg.prove_aggregate(jcs, jpk, JPERM, rng=np.random.default_rng(5))
    assert serialize.aggregate_to_bytes(agg, vk) == jser.aggregate_to_bytes(jagg_, jvk)
    return vk, jvk, agg, jagg_, _pis(cs)


# -- the sibling-opening chain -------------------------------------------------------


@pytest.mark.parametrize("n_leaves", [16, 200])
def test_chain_nodes_body_matches_jax_and_the_host_loop(calls, n_leaves):
    rng = np.random.default_rng(n_leaves)
    leaves = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n_leaves)]
    levels = fri.tree_build(leaves, PERM)
    root, h = fri.tree_root(levels), len(levels) - 1
    idx = sorted(int(i) for i in rng.choice(n_leaves, 5, replace=False))
    sibs, poss = fri.tree_open_batched(levels, idx)
    values = [leaves[i] for i in idx]
    node = ints_to_digits(values, shape=(len(idx),))
    got = merkle.chain_nodes(
        torch.from_numpy(node.astype(np.int32)), torch.from_numpy(sibs.astype(np.int32)),
        torch.from_numpy(poss.astype(np.int64)), fri_cuda._node_tag(CPU), native_perm)
    jgot = jfri_tpu._chain_nodes_body(node, sibs, poss, jperm_rows, pad_to=1)
    assert np.array_equal(got.numpy(), np.asarray(jgot).astype(np.int32))
    assert all(np.array_equal(row, ints_to_digits([root], shape=(1,))[0]) for row in got.numpy())

    chain = functools.partial(fri_cuda.device_chain_fn, schedule="hybp", device="cpu")
    calls.clear()
    loop = fri.tree_verify_batched(root, values, sibs, poss, h, idx, PERM)
    fused = fri.tree_verify_batched(root, values, sibs, poss, h, idx, PERM, chain)
    assert calls == [("hybp", len(idx))] * h  # one launch a level
    assert bool(fused.all()) and np.array_equal(loop, fused)
    bad = list(values)
    bad[1] = (bad[1] + 1) % P
    assert list(fri.tree_verify_batched(root, bad, sibs, poss, h, idx, PERM, chain)) == \
        [True, False, True, True, True]
    for wrong in (fri.ARITY, -1):  # clamped in the chain, refused by the range check
        poss_bad = poss.copy()
        poss_bad[2, 0] = wrong
        got = fri.tree_verify_batched(root, values, sibs, poss_bad, h, idx, PERM, chain)
        assert np.array_equal(got, fri.tree_verify_batched(root, values, sibs, poss_bad, h, idx,
                                                           PERM))
        assert not got[2] and int(got.sum()) == len(idx) - 1


# -- the fused plan -----------------------------------------------------------------------


def _entries(verify, *args):
    """The entries a host verifier hands its entries_check, and its verdict."""
    seen = []

    def spy(entries):
        seen.append(entries)
        return fri.pooled_entries_verify(entries, PERM)

    verdict = verify(*args, entries_check=spy)
    (entries,) = seen
    return entries, verdict


def _plan_equal(plan, jplan):
    for mine, theirs in zip(plan[:3], jplan[:3]):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(plan[3]) == len(jplan[3])
    assert all(a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
               for a, b in zip(plan[3], jplan[3]))
    assert plan[4] == jplan[4]


@pytest.mark.parametrize("zk", [False, True])
def test_fused_plan_equals_the_jax_packages(zk):
    vk, jvk, proofs, jproofs, pis, want = _batch(zk)
    entries, got = _entries(fri.verify_succinct_batched, vk, proofs, pis, PERM)
    jentries, jgot = _entries(jfri.verify_succinct_batched, jvk, jproofs, pis, JPERM)
    assert np.array_equal(got, want) and np.array_equal(jgot, want)
    q = vk.params.n_queries
    plan = fri_cuda._fused_verify_plan(entries, q)
    _plan_equal(plan, jfri_tpu._fused_verify_plan(jentries, q))
    assert {b.dtype for b in plan[0]} | {x.dtype for x in plan[1]} == {np.dtype(np.uint16)}

    vk, jvk, agg, jagg_, apis = _aggregates(zk)
    entries, ok = _entries(aggregate.verify_aggregate, vk, agg, apis, PERM)
    jentries, jok = _entries(jagg.verify_aggregate, jvk, jagg_, apis, JPERM)
    assert ok and jok
    _plan_equal(fri_cuda._fused_verify_plan(entries, q), jfri_tpu._fused_verify_plan(jentries, q))


def test_fused_plan_shapes_are_the_same_for_every_query_set():
    """The shapes depend on schema facts only, so one graph serves every
    query set of a batch shape."""
    pk, vk, _, _ = _keys(True)
    c = tiny(gadget)

    def shapes(seed):
        proof = fri.prove_succinct(c, pk, PERM, rng=np.random.default_rng(seed))
        entries, ok = _entries(fri.verify_succinct_batched, vk, [proof], _pis([c]), PERM)
        assert ok[0]
        plan = fri_cuda._fused_verify_plan(entries, vk.params.n_queries)
        return [tuple(a.shape for a in part) for part in plan[:4]]

    assert shapes(1) == shapes(2) == shapes(3)


@pytest.mark.parametrize("fault", ["ungrouped", "two widths", "unsorted", "node count",
                                   "wide digit"])
def test_fused_plan_guards_as_the_jax_package(fault):
    vk, _, proofs, _, pis, _ = _batch(False)
    entries, _ = _entries(fri.verify_succinct_batched, vk, proofs[:2], pis[:2], PERM)
    entries = list(entries)
    gid, root, blocks, idx, nodes, height = entries[0]
    if fault == "ungrouped":
        entries.append(entries[0])
    elif fault == "two widths":
        entries[1] = (gid, root, blocks[:, :-1], idx, nodes, height)
    elif fault == "unsorted":
        entries[0] = (gid, root, blocks, list(idx)[::-1], nodes, height)
    elif fault == "node count":
        entries[0] = (gid, root, blocks, idx, np.asarray(nodes)[1:], height)
    else:
        wide = np.array(blocks, copy=True)
        wide[0, 0, 0] = 1 << 16
        entries[0] = (gid, root, wide, idx, nodes, height)
    q = vk.params.n_queries
    with pytest.raises(ValueError) as mine:
        fri_cuda._fused_verify_plan(entries, q)
    with pytest.raises(ValueError) as theirs:
        jfri_tpu._fused_verify_plan(entries, q)
    assert str(mine.value) == str(theirs.value)


# -- the fused pooled phase -----------------------------------------------------------------


@pytest.mark.parametrize("zk", [False, True])
def test_fused_pool_body_matches_the_jax_body(calls, zk):
    vk, jvk, proofs, jproofs, pis, _ = _batch(zk)
    entries, _ = _entries(fri.verify_succinct_batched, vk, proofs, pis, PERM)
    plan = fri_cuda._fused_verify_plan(entries, vk.params.n_queries)
    calls.clear()
    roots = fri_cuda._fused_pool_run(plan, "hybp", CPU)
    assert len(calls) == chip_smoke.pooled_merkle_launches(vk)
    assert {s for s, _ in calls} == {"hybp"}
    jroots = jfri_tpu._fused_pool_body(*plan[:4], jperm_rows, pad_to=1)
    assert len(roots) == len(jroots) == len(plan[4])
    for mine, theirs in zip(roots, jroots):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), np.asarray(theirs).astype(np.int32))


def test_fused_entries_check_takes_a_pool_fn_and_an_empty_list(calls):
    vk, _, proofs, _, pis, want = _batch(False)
    seen = []

    def pool_fn(plan):
        seen.append(plan)
        return fri_cuda._fused_pool_run(plan, "opt", CPU)

    check = fri_cuda.fused_entries_check(vk, pool_fn, device="cpu")
    got = fri.verify_succinct_batched(vk, proofs, pis, PERM, entries_check=check)
    assert np.array_equal(got, want) and len(seen) == 1
    assert len(check([])) == 0 and len(seen) == 1


# -- the device verifiers ----------------------------------------------------------------------


@pytest.mark.parametrize("zk", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_verify_succinct_device_batch_verdicts_equal_the_hosts(calls, zk, fused):
    vk, jvk, proofs, jproofs, pis, want = _batch(zk)
    got = fri_cuda.verify_succinct_device_batch(vk, proofs, pis, fused, schedule="hybp",
                                                device="cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    assert np.array_equal(got, fri.verify_succinct_batched(vk, proofs, pis, PERM))
    # one pooled Merkle phase: as many launches, fused or not
    assert len(calls) == chip_smoke.pooled_merkle_launches(vk)
    assert {s for s, _ in calls} == {"hybp"}
    # the JAX package's bytes, decoded by the port
    decoded = [serialize.proof_from_bytes(jser.proof_to_bytes(p, jvk), vk) for p in jproofs]
    got = fri_cuda.verify_succinct_device_batch(vk, decoded, pis, fused, device="cpu")
    assert np.array_equal(got, want)
    one = fri_cuda.verify_succinct_device_batch(vk, proofs[:1], pis[:1], fused, device="cpu")
    assert list(one) == [True]


@pytest.mark.parametrize("zk", [False, True])
@pytest.mark.parametrize("kind", ["honest", "node", "opening", "eval", "statement"])
def test_verify_aggregate_device_verdicts_equal_the_hosts(calls, zk, kind):
    vk, jvk, agg, jagg_, pis = _aggregates(zk)
    data = jser.aggregate_to_bytes(jagg_, jvk)
    mine, theirs = serialize.aggregate_from_bytes(data, vk), jser.aggregate_from_bytes(data, jvk)
    statements = [list(p) for p in pis]
    for proof in (mine, theirs):
        if kind == "node":
            nodes = {k: np.array(v, copy=True) for k, v in proof.open_nodes.items()}
            nodes["z"][0, 0] ^= 1
            proof.open_nodes = nodes
        elif kind == "opening":
            blocks = [list(b) for b in proof.open_blocks["t"]]
            blocks[0][0] = (blocks[0][0] + 1) % P
            proof.open_blocks["t"] = blocks
        elif kind == "eval":
            proof.evals[1]["z"] = (proof.evals[1]["z"] + 1) % P
    if kind == "statement":
        statements[0][-1] = (statements[0][-1] + 1) % P
    got = fri_cuda.verify_aggregate_device(vk, mine, statements, schedule="hybp", device="cpu")
    assert got == aggregate.verify_aggregate(vk, mine, statements, PERM) \
        == jagg.verify_aggregate(jvk, theirs, statements, JPERM) == (kind == "honest")
    if kind in ("honest", "node", "opening"):  # these reach the pooled phase
        assert len(calls) == chip_smoke.pooled_merkle_launches(vk, agg.n_instances)
    assert serialize.aggregate_to_bytes(agg, vk) == data


def test_device_verifiers_refuse_a_bad_device_or_schedule(calls):
    vk, _, proofs, _, pis, _ = _batch(False)
    _, _, agg, _, apis = _aggregates(False)
    node, sibs, poss = np.zeros((1, 16)), np.zeros((1, 1, 3, 16)), np.zeros((1, 1))
    entry_points = [
        lambda **kw: fri_cuda.device_chain_fn(node, sibs, poss, **kw),
        lambda **kw: fri_cuda.fused_entries_check(vk, **kw),
        lambda **kw: fri_cuda.verify_succinct_device_batch(vk, proofs, pis, **kw),
        lambda **kw: fri_cuda.verify_succinct_device_batch(vk, proofs, pis, False, **kw),
        lambda **kw: fri_cuda.verify_aggregate_device(vk, agg, apis, **kw),
    ]
    for call in entry_points:
        with pytest.raises(ValueError, match="no kernel for device"):
            call(device="meta")
        with pytest.raises(ValueError, match="unknown schedule"):
            call(schedule="nope", device="cpu")
        if not torch.cuda.is_available():  # the default is the card
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert calls == []
