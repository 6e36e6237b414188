"""The port's multi-process set-up (`hades252_tpu_torch/parallel/multihost.py`),
the counterpart of tests/test_multihost.py: two OS processes join one gloo
group through `multihost.initialize(..., backend="gloo")`, build
`global_mesh()` on the CPU and compute the sharded Merkle root of the leaves
0..15, which must equal the exact int oracle's on both (tolerance 0). The
ranks (tests/torch_dist_worker.py) import no JAX.

The slow case holds the port's counters of a build at world size 4 to the
JAX package's own `dist.merkle_root_sharded` on the 4-device virtual CPU
mesh of tests/conftest.py.
"""

import numpy as np
import pytest
import torch

from hades252_tpu_torch import field
from hades252_tpu_torch.parallel import multihost
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

import torch_dist_worker as worker

LEAVES = list(range(16))


def _int_root(leaves: list[int]) -> int:
    """The arity-4 root by the int oracle: parent = perm([4, c0..c3])[1]."""
    strat, level = ScalarStrategy(), list(leaves)
    while len(level) > 1:
        level = [strat.perm([4] + level[i : i + 4])[1] for i in range(0, len(level), 4)]
    return level[0]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    leaves = ints_to_digits(LEAVES, shape=(len(LEAVES),))
    return worker.run_group("merkle", 2, {"merkle": [leaves]}, tmp_path_factory.mktemp("mh"))


def test_two_process_merkle_root_matches_the_int_oracle(two_ranks):
    want = _int_root(LEAVES)
    for rank in two_ranks:
        (root, _, _), = rank["roots"]
        assert int(digits_to_ints(root)) == want


def test_is_primary_on_rank_0_only(two_ranks):
    assert [r["primary"] for r in two_ranks] == [True, False]
    assert not any(r["jax_loaded"] for r in two_ranks)
    assert multihost.is_primary()  # a process that joined no group


@pytest.mark.slow
def test_counters_equal_the_jax_package_on_a_mesh_of_4(tmp_path):
    import jax.numpy as jnp

    from hades252_tpu.parallel import dist as jdist
    from hades252_tpu.utils import metrics as jmetrics

    leaf_sets = [ints_to_digits(LEAVES, shape=(16,)),
                 field.np_random_elements((37,), np.random.default_rng(37))]
    ranks = worker.run_group("merkle", 4, {"merkle": leaf_sets}, tmp_path)
    mesh = jdist.make_mesh(4)
    for i, leaves in enumerate(leaf_sets):
        jmetrics.reset()
        jmetrics.enable()
        try:
            root = np.asarray(jdist.merkle_root_sharded(jnp.asarray(leaves), mesh))
            counters = jmetrics.snapshot()["counters"]
        finally:
            jmetrics.disable()
            jmetrics.reset()
        for rank in ranks:
            got, port_counters, spans = rank["roots"][i]
            assert np.array_equal(got.astype(np.uint32), root)
            assert port_counters == counters
            assert spans == ["dist.merkle", "merkle.level"]
    assert torch.equal(torch.from_numpy(ranks[0]["roots"][0][0]),
                       torch.from_numpy(ints_to_digits([_int_root(LEAVES)])[0].astype(np.int32)))
