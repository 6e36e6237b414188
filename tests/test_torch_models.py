"""The port's Merkle tree against the JAX package's, exactly (the sponge's
tests are in test_torch_sponge.py).

The JAX side runs its Pallas kernel as the JAX package's own tests do on
the CPU (`make_perm_mont_fn("pallas", block=128, emulate=True)`); the port
runs its wrappers, which take the plain versions of its CUDA kernels on the
CPU, and its torch oracle.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu.models import merkle as jmerkle
from hades252_tpu.ops import make_perm_mont_fn as jax_make_perm_mont_fn
from hades252_tpu_torch import field
from hades252_tpu_torch.models import merkle, sponge
from hades252_tpu_torch.ops import make_perm_mont_fn

torch.set_num_threads(1)


@functools.cache
def _jax_perm():
    """The JAX package's emulated kernel, memoized on its input, so that
    calls fed the same data share its (slow) CPU runs."""
    fn = jax_make_perm_mont_fn("pallas", block=128, emulate=True)
    memo = {}

    def perm(x):
        x = np.asarray(x)
        key = (x.shape, x.tobytes())
        if key not in memo:
            memo[key] = np.asarray(fn(jnp.asarray(x)))
        return jnp.asarray(memo[key])

    return perm


def _elements(shape, seed):
    return field.np_random_elements(shape, np.random.default_rng(seed))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _same(ours: torch.Tensor, theirs) -> None:
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy().astype(np.uint32), np.asarray(theirs))


@pytest.mark.parametrize("n", [1, 16, 37, 64])
def test_merkle_root_matches_jax(n):
    leaves = _elements((n,), 100 + n)
    theirs = jmerkle.merkle_root(jnp.asarray(leaves), _jax_perm())
    _same(merkle.merkle_root(_t(leaves), make_perm_mont_fn("cuda")), theirs)
    if n == 16:
        _same(merkle.merkle_root(_t(leaves)), theirs)  # the CPU default: the oracle


@pytest.mark.parametrize("n", [1, 16, 37, 64])
def test_merkle_levels_match_jax(n):
    leaves = _elements((n,), 100 + n)
    theirs = jmerkle.merkle_levels(jnp.asarray(leaves), _jax_perm())
    ours = merkle.merkle_levels(_t(leaves), make_perm_mont_fn("cuda", schedule="naive"))
    assert len(ours) == len(theirs) == merkle.tree_levels(n) + 1
    for a, b in zip(ours, theirs):
        _same(a, b)


def test_model_input_validation():
    with pytest.raises(ValueError):
        sponge.sponge_hash(torch.zeros((3, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        merkle.merkle_root(torch.zeros((4, 4, 16), dtype=torch.int32))
    st = sponge.SpongeState(1, 4)
    with pytest.raises(ValueError):
        st.absorb(torch.zeros((1, 5, 16), dtype=torch.int32))
    st.absorb(torch.zeros((1, 2, 16), dtype=torch.int32))
    with pytest.raises(RuntimeError):
        st.digest()
