"""The port's sharded paths (`hades252_tpu_torch/parallel/dist.py`, and the
provers' and verifiers' `mesh`) on gloo process groups on the CPU, against
the JAX package's unsharded functions and the port's own, exactly.

One group a world size runs all of that size's checks in its spawned ranks
(tests/torch_dist_worker.py, which import no JAX), while this process
computes what they must equal: the Merkle roots of 64 leaves and of 37
(padded) at world sizes 1, 2 and 4; at world size 2 also the permutation,
the sponge, the cipher with its decrypt round trip, the verification
chains (and `mesh_chain_fn` on a pool that does not divide by the mesh),
`prove_batched(mesh=)` and the device succinct and aggregate provers with
their verifiers, at the tiny sizes of tests/test_torch_prover.py and
tests/test_torch_aggregate_cuda.py. Every rank must return every result,
bit for bit and byte for byte (tolerance 0). The provers' permutations run
through the native engine (the seam `fri_cuda.permute_cuda`, as those
tests swap it); the other paths run the kernels' plain versions.

The divisibility errors are held to the JAX package's messages, word for
word, and the Merkle build's counters to the values of `dist.py:307-314`.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu import aggregate as jagg
from hades252_tpu import fri as jfri
from hades252_tpu import fri_tpu as jfri_tpu
from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu import prover_tpu as jprover
from hades252_tpu import serialize as jser
from hades252_tpu.models import cipher as jcipher
from hades252_tpu.models import merkle as jmerkle
from hades252_tpu.models import sponge as jsponge
from hades252_tpu.ops import perm_ref as jperm_ref
from hades252_tpu.parallel import dist as jdist
from hades252_tpu_torch import field, fri, fri_cuda, gadget, plonk, prover_cuda, serialize
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.parallel import dist
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils.encoding import ints_to_digits

import torch_dist_worker as worker

torch.set_num_threads(1)

PARAMS = dict(blowup=4, n_queries=3, final_degree=8, pow_bits=2)
INSTANCES = [(3 + i, 5 + 2 * i) for i in range(4)]
CHAIN_OPENINGS, CHAIN_POOL = 8, 5
#: dist.collective_bytes of a 64-leaf build (37 leaves pad to 64): each rank
#: receives the 64 / 4^h_local nodes of the gathered level but its own
#: (h_local = 3, 2, 2 at 1, 2, 4 ranks), 64 bytes a node
COLLECTIVE_BYTES = {1: 0, 2: (4 - 2) * 64, 4: (4 - 1) * 64}


def _elements(shape, seed):
    return field.np_random_elements(shape, np.random.default_rng(seed))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _inputs() -> dict:
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(16)]
    levels = fri.tree_build(vals, fri.default_pcs_perm())
    idx = list(range(CHAIN_OPENINGS))
    sibs, poss = fri.tree_open_batched(levels, idx)
    return {
        "merkle": [_elements((64,), 1), _elements((37,), 2)],
        "perm": _elements((8, 5), 3),
        "msgs": _elements((8, 8), 4),
        "cipher": (_elements((4, 2), 5), _elements((4,), 6), _elements((4, 8), 8)),
        "chain": (ints_to_digits([vals[i] for i in idx], shape=(len(idx),)),
                  np.asarray(sibs, np.uint32), np.asarray(poss, np.int64)),
        "chain_values": vals,
        "chain_pool": CHAIN_POOL,
        "instances": INSTANCES,
        "params": PARAMS,
    }


def _tiny(g, a_val, b_val):
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(1).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-((a_val + b_val) % P)))
    return c


def _jax_chain(vals, node, k):
    """The JAX package's host per-level loop over the first k openings
    (as tests/test_dist.py computes it)."""
    perm = jfri.default_pcs_perm()
    levels = jfri.tree_build(vals, perm)
    sibs, poss = jfri.tree_open_batched(levels, list(range(k)))
    ref = np.asarray(node[:k])
    tag = np.broadcast_to(jfri._tag_digits(), (k, 1, ref.shape[-1]))
    for lvl in range(poss.shape[1]):
        children = jfri._insert_at(ref, np.asarray(sibs)[:, lvl], np.asarray(poss)[:, lvl])
        ref = np.asarray(perm(np.concatenate([tag, children], axis=1).astype(np.uint32)))
        ref = ref[:, jfri.DIGEST_INDEX, :]
    return ref


def _expected(inp) -> dict:
    """What every rank must return: (the JAX package's, the port's) for each
    path, computed here without a group."""
    exp = {"roots": [(np.asarray(jmerkle.merkle_root(jnp.asarray(leaves))),
                      merkle.merkle_root(_t(leaves)).numpy()) for leaves in inp["merkle"]]}
    x = inp["perm"]
    exp["perm"] = (np.asarray(jperm_ref.permute(jnp.asarray(x))),
                   perm_cuda.permute_cuda(_t(x)).numpy())
    msgs = inp["msgs"]
    exp["sponge"] = (np.asarray(jsponge.sponge_hash(jnp.asarray(msgs))),
                     sponge.sponge_hash(_t(msgs)).numpy())
    key, nonce, msg = inp["cipher"]
    ct_j, tag_j = jcipher.encrypt(*(jnp.asarray(a) for a in (key, nonce, msg)))
    ct, tag = cipher.encrypt(_t(key), _t(nonce), _t(msg))
    exp["cipher"] = ((np.asarray(ct_j), np.asarray(tag_j)), (ct.numpy(), tag.numpy()))
    node, sibs, poss = inp["chain"]
    exp["chain"] = (_jax_chain(inp["chain_values"], node, CHAIN_OPENINGS),
                    fri_cuda.device_chain_fn(node, sibs, poss, device="cpu"))

    cs = [_tiny(gadget, a, b) for a, b in INSTANCES]
    jcs = [_tiny(jgadget, a, b) for a, b in INSTANCES]
    jkey = jplonk.preprocess(jcs[0])
    key_ = plonk.preprocess(cs[0])
    exp["plonk"] = ([(p.wires, p.z, p.t, p.commitments) for p in (jplonk.prove(c, jkey) for c in jcs)],
                    [(p.wires, p.z, p.t, p.commitments)
                     for p in prover_cuda.prove_batched(cs, key_, device="cpu")])
    jpk, jvk = jfri.preprocess_succinct(jcs[0], jfri.FriParams(**PARAMS))
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**PARAMS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fri_cuda, "permute_cuda", worker.native_kernel)
        succinct = fri_cuda.prove_succinct_device_batch(cs, pk, device="cpu")
        agg = fri_cuda.prove_aggregate_device(cs, pk, device="cpu")
    exp["succinct"] = ([jser.proof_to_bytes(jfri.prove_succinct(c, jpk), jvk) for c in jcs],
                       [serialize.proof_to_bytes(p, vk) for p in succinct])
    exp["aggregate"] = (jser.aggregate_to_bytes(jagg.prove_aggregate(jcs, jpk), jvk),
                        serialize.aggregate_to_bytes(agg, vk))
    return exp


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world: the ranks' results, or the exception its group raised} for
    the groups of 1, 2 and 4 ranks, and what they must equal. The groups of
    1 and 2 run while this process computes the expected values, the group
    of 4 after them, so that at most four ranks share the host's cores."""
    inp = _inputs()
    # made here, not in the threads: tmp_path_factory is not thread-safe
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (1, 2, 4)}

    def run(world, job):
        return worker.run_group(job, world, inp, dirs[world])

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(run, w, job) for w, job in ((1, "merkle"), (2, "world2"))}
        expected = _expected(inp)
        concurrent.futures.wait(futures.values())
        futures[4] = pool.submit(run, 4, "merkle")
        results = {w: f.exception() or f.result() for w, f in futures.items()}
    return results, expected, inp


def _ranks(groups, world: int) -> list:
    results = groups[0][world]
    if isinstance(results, BaseException):
        raise results
    assert [r["rank"] for r in results] == list(range(world))
    return results


def _both_equal(got, pair) -> None:
    """got (a numpy array) equals the JAX package's and the port's."""
    theirs, ours = pair
    assert np.array_equal(got, ours) and np.array_equal(got.astype(np.uint32), np.asarray(theirs))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_merkle_root_sharded_equals_unsharded_roots(groups, world):
    for rank in _ranks(groups, world):
        for (root, _, _), pair in zip(rank["roots"], groups[1]["roots"]):
            assert root.dtype == np.int32 and root.shape == (16,)
            _both_equal(root, pair)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_merkle_root_sharded_counts_and_times(groups, world):
    for rank in _ranks(groups, world):
        for _, counters, spans in rank["roots"]:
            assert counters == {"dist.merkle_builds": 1, "perms.executed": 21,
                                "dist.collective_bytes": COLLECTIVE_BYTES[world]}
            assert spans == ["dist.merkle", "merkle.level"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_import_no_jax_and_rank_0_is_primary(groups, world):
    ranks = _ranks(groups, world)
    assert not any(r["jax_loaded"] for r in ranks)
    assert [r["primary"] for r in ranks] == [True] + [False] * (world - 1)


def test_permute_sharded(groups):
    for rank in _ranks(groups, 2):
        _both_equal(rank["perm"], groups[1]["perm"])


def test_sponge_hash_sharded(groups):
    for rank in _ranks(groups, 2):
        _both_equal(rank["sponge"], groups[1]["sponge"])


def test_cipher_sharded_and_its_round_trip(groups):
    (ct_j, tag_j), (ct_p, tag_p) = groups[1]["cipher"]
    msg = groups[2]["cipher"][2]
    for rank in _ranks(groups, 2):
        ct, tag, pt, tag_back = rank["cipher"]
        _both_equal(ct, (ct_j, ct_p))
        _both_equal(tag, (tag_j, tag_p))
        assert np.array_equal(pt, msg) and np.array_equal(tag_back, tag)


def test_chain_nodes_sharded(groups):
    for rank in _ranks(groups, 2):
        _both_equal(rank["chain"], groups[1]["chain"])


def test_mesh_chain_fn_pads_a_pool_that_does_not_divide(groups):
    theirs, ours = groups[1]["chain"]
    for rank in _ranks(groups, 2):
        got = rank["chain_pool"]
        assert got.dtype == np.uint32 and got.shape == (CHAIN_POOL, 16)
        assert np.array_equal(got, ours[:CHAIN_POOL]) and np.array_equal(got, theirs[:CHAIN_POOL])


def test_prove_batched_with_a_mesh(groups):
    theirs, ours = groups[1]["plonk"]
    for rank in _ranks(groups, 2):
        assert rank["plonk"] == ours == theirs


def test_device_succinct_prover_with_a_mesh(groups):
    theirs, ours = groups[1]["succinct"]
    for rank in _ranks(groups, 2):
        assert rank["succinct"] == ours == theirs


def test_device_aggregate_prover_with_a_mesh(groups):
    theirs, ours = groups[1]["aggregate"]
    for rank in _ranks(groups, 2):
        assert rank["aggregate"] == ours == theirs


def test_device_verifiers_with_a_mesh(groups):
    for rank in _ranks(groups, 2):
        assert rank["verified"] == ([True] * len(INSTANCES), True)


@pytest.mark.slow
def test_provers_and_verifiers_with_a_mesh_of_4(groups, tmp_path):
    ranks = worker.run_group("provers", 4, groups[2], tmp_path)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for key in ("plonk", "succinct"):
        theirs, ours = groups[1][key]
        assert all(r[key] == ours == theirs for r in ranks)
    theirs, ours = groups[1]["aggregate"]
    assert all(r["aggregate"] == ours == theirs for r in ranks)
    assert all(r["verified"] == ([True] * len(INSTANCES), True) for r in ranks)


def _cpu_mesh(size: int) -> dist.Mesh:
    """A mesh as rank 0 of `size` sees it, without a group: every call
    below refuses its input before any collective."""
    return dist.Mesh(group=None, size=size, rank=0, device=torch.device("cpu"))


def _refusals(jmesh, mesh, case):
    """(the JAX package's call, the port's) of one refused input."""
    z = lambda *shape: (jnp.zeros(shape, jnp.uint32),  # noqa: E731
                        torch.zeros(shape, dtype=torch.int32))
    if case == "permute":
        (jx, x) = z(10, 5, 16)
        return (lambda: jdist.permute_sharded(jx, jmesh), lambda: dist.permute_sharded(x, mesh))
    if case == "sponge":
        (jx, x) = z(10, 4, 16)
        return (lambda: jdist.sponge_hash_sharded(jx, jmesh),
                lambda: dist.sponge_hash_sharded(x, mesh))
    if case == "cipher":
        (jk, k), (jn, n), (jd, d) = z(10, 2, 16), z(10, 16), z(10, 4, 16)
        return (lambda: jdist.cipher_sharded(jk, jn, jd, jmesh),
                lambda: dist.cipher_sharded(k, n, d, mesh))
    if case == "chain":
        (jn, n), (js, s), (jp, p) = z(10, 16), z(10, 2, 3, 16), z(10, 2)
        return (lambda: jdist.chain_nodes_sharded(jn, js, jp, jmesh),
                lambda: dist.chain_nodes_sharded(n, s, p, mesh))
    if case == "merkle":
        (jx, x) = z(2, 16)  # pads to 4 leaves, over 8 ranks
        return (lambda: jdist.merkle_root_sharded(jx, jmesh),
                lambda: dist.merkle_root_sharded(x, mesh))
    jcs = [_tiny(jgadget, a, b) for a, b in INSTANCES[:3]]
    cs = [_tiny(gadget, a, b) for a, b in INSTANCES[:3]]
    if case == "prove_batched":
        jkey, key = jplonk.preprocess(jcs[0]), plonk.preprocess(cs[0])
        return (lambda: jprover.prove_batched(jcs, jkey, mesh=jmesh),
                lambda: prover_cuda.prove_batched(cs, key, device="cpu", mesh=mesh))
    jpk = jfri.preprocess_succinct(jcs[0], jfri.FriParams(**PARAMS))[0]
    pk = fri.preprocess_succinct(cs[0], fri.FriParams(**PARAMS))[0]
    name = {"succinct": "prove_succinct_device_batch", "aggregate": "prove_aggregate_device"}[case]
    return (lambda: getattr(jfri_tpu, name)(jcs, jpk, mesh=jmesh),
            lambda: getattr(fri_cuda, name)(cs, pk, device="cpu", mesh=mesh))


@pytest.mark.parametrize("case", ["permute", "sponge", "cipher", "chain", "merkle",
                                  "prove_batched", "succinct", "aggregate"])
def test_refusals_carry_the_jax_messages(case):
    size = 8 if case == "merkle" else 4
    theirs, ours = _refusals(jdist.make_mesh(size), _cpu_mesh(size), case)
    with pytest.raises(ValueError) as jax_error:
        theirs()
    with pytest.raises(ValueError) as port_error:
        ours()
    assert "not divisible" in str(jax_error.value)
    assert str(port_error.value) == str(jax_error.value)


def test_a_mesh_sets_the_device_and_nothing_falls_back():
    mesh = _cpu_mesh(1)
    assert dist.mesh_device(mesh, "cpu") == torch.device("cpu")
    assert mesh.shape == {dist.AXIS: 1} and dist.AXIS == jdist.AXIS
    cs = [_tiny(gadget, 3, 5)]
    key = plonk.preprocess(cs[0])
    with pytest.raises(ValueError, match="contradicts the mesh's device cpu"):
        prover_cuda.prove_batched(cs, key, mesh=mesh)  # the default, the card
    with pytest.raises(ValueError, match="contradicts"):
        prover_cuda.prove_batched(cs, key, device="cuda:1", mesh=mesh)
    pk = fri.preprocess_succinct(cs[0], fri.FriParams(**PARAMS))[0]
    for prove in (fri_cuda.prove_succinct_device_batch, fri_cuda.prove_aggregate_device):
        with pytest.raises(ValueError, match="contradicts"):
            prove(cs, pk, device="cuda:0", mesh=mesh)
    with pytest.raises(RuntimeError, match="not initialized"):
        dist.make_mesh(device="cpu")
    from hades252_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="one axis 'data'"):
        multihost.global_mesh("model", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl backend needs a CUDA device"):
            multihost.initialize("127.0.0.1:1", 1, 0)


def test_a_mesh_waits_as_long_as_the_default_group(groups):
    for world in (1, 2):
        assert all(r["mesh_timeout_s"] == worker.TIMEOUT_S for r in _ranks(groups, world))


def test_the_default_device_of_a_mesh_is_the_card(groups):
    for rank in _ranks(groups, 1):
        if torch.cuda.is_available():
            assert rank["default_device"] == "cuda:0"
        else:
            assert "no CUDA device" in rank["default_device"]
