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


@functools.cache
def _opened(n: int):
    """Leaves, both packages' levels (through the oracle), the opened
    indices and both packages' batched openings of an n-leaf tree."""
    leaves = _elements((n,), 300 + n)
    jlevels = jmerkle.merkle_levels(jnp.asarray(leaves), jax_make_perm_mont_fn("ref"))
    levels = merkle.merkle_levels(_t(leaves))
    size = levels[0].shape[0]
    idx = [0, n - 1, size - 1, 5, 17, n // 2, 5]  # a padding leaf and a repeat among them
    return (leaves, jlevels, levels, idx, jmerkle.merkle_open_batched(jlevels, idx),
            merkle.merkle_open_batched(levels, torch.tensor(idx)))


@pytest.mark.parametrize("n", [64, 50])
def test_merkle_openings_match_jax(n):
    _, jlevels, levels, idx, (jsibs, jposs), (sibs, poss) = _opened(n)
    height = merkle.tree_levels(n)
    assert sibs.shape == (len(idx), height, 3, 16) and poss.shape == (len(idx), height)
    assert poss.dtype == torch.int32
    _same(sibs, jsibs)
    assert np.array_equal(poss.numpy(), np.asarray(jposs))
    for i in idx[:3]:
        s, p = merkle.merkle_open_compact(levels, i)
        js, jp = jmerkle.merkle_open_compact(jlevels, i)
        _same(s, js)
        assert p.dtype == torch.int32 and np.array_equal(p.numpy(), np.asarray(jp))
        for (g, pos), (jg, jpos) in zip(merkle.merkle_open(levels, i),
                                        jmerkle.merkle_open(jlevels, i)):
            _same(g, jg)
            assert pos == jpos


@pytest.mark.parametrize("n", [64, 50])
def test_merkle_open_batched_equals_the_loop(n):
    _, _, levels, idx, _, (sibs, poss) = _opened(n)
    loop = [merkle.merkle_open_compact(levels, i) for i in idx]
    assert torch.equal(sibs, torch.stack([s for s, _ in loop]))
    assert torch.equal(poss, torch.stack([p for _, p in loop]))
    # any sequence of indices will do
    again = merkle.merkle_open_batched(levels, np.asarray(idx))
    assert torch.equal(again[0], sibs) and torch.equal(again[1], poss)
    for bad in (-1, levels[0].shape[0]):
        with pytest.raises(ValueError):
            merkle.merkle_open_batched(levels, [0, bad])
        with pytest.raises(ValueError):
            merkle.merkle_open_compact(levels, bad)
        with pytest.raises(ValueError):
            merkle.merkle_open(levels, bad)


def _verdicts(n, fn, jfn, sibs_edit=None, poss_edit=None, height_delta=0):
    """The port's verdicts and the JAX package's on the same, possibly
    edited, openings."""
    leaves, jlevels, levels, idx, _, (sibs, poss) = _opened(n)
    height = merkle.tree_levels(n) + height_delta
    sibs, poss = sibs.clone(), poss.clone()
    if sibs_edit:
        sibs_edit(sibs)
    if poss_edit:
        poss_edit(poss)
    padded = np.zeros((levels[0].shape[0], 16), np.uint32)
    padded[:n] = leaves
    opened = padded[idx]
    root = field.from_mont(levels[-1][0])
    ours = merkle.merkle_verify_batched(root, _t(opened), sibs, poss, height, fn)
    theirs = jmerkle.merkle_verify_batched(
        jnp.asarray(root.numpy().astype(np.uint32)), jnp.asarray(opened),
        jnp.asarray(sibs.numpy().astype(np.uint32)), jnp.asarray(poss.numpy()), height, jfn)
    assert ours.dtype == torch.bool and ours.shape == (len(idx),)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    return ours


def _tamper(sibs):
    sibs[1, 1, 2, 3] ^= 1


def _pos_low(poss):
    poss[2, 0] = -1


def _pos_high(poss):
    poss[3, 1] = 4


_PERMS = {
    "oracle": lambda: (None, jax_make_perm_mont_fn("ref")),
    "hybp": lambda: (make_perm_mont_fn("cuda", schedule="hybp"), _jax_perm()),
}


@pytest.mark.parametrize("n", [64, 50])
@pytest.mark.parametrize("through", ["oracle", "hybp"])
@pytest.mark.parametrize("case", ["honest", "tampered", "position -1", "position 4",
                                  "wrong height"])
def test_merkle_verify_batched_matches_jax(n, through, case):
    fn, jfn = _PERMS[through]()
    k = 7
    if case == "honest":
        assert bool(_verdicts(n, fn, jfn).all())
    elif case == "wrong height":
        assert not bool(_verdicts(n, fn, jfn, height_delta=-1).any())
    else:
        edit, row = {"tampered": (dict(sibs_edit=_tamper), 1),
                     "position -1": (dict(poss_edit=_pos_low), 2),
                     "position 4": (dict(poss_edit=_pos_high), 3)}[case]
        ok = _verdicts(n, fn, jfn, **edit)
        assert not bool(ok[row]) and int(ok.sum()) == k - 1  # its row only


@pytest.mark.parametrize("n", [64, 50])
def test_merkle_verify_matches_jax(n):
    leaves, jlevels, levels, idx, _, _ = _opened(n)
    height = merkle.tree_levels(n)
    root = field.from_mont(levels[-1][0])
    jroot = jnp.asarray(root.numpy().astype(np.uint32))
    jfn = jax_make_perm_mont_fn("ref")
    for i, leaf_i, h in ((5, 5, height), (5, 6, height), (n - 1, n - 1, height),
                         (5, 5, height - 1)):
        path, jpath = merkle.merkle_open(levels, i), jmerkle.merkle_open(jlevels, i)
        ours = merkle.merkle_verify(root, _t(leaves[leaf_i]), path, h)
        theirs = jmerkle.merkle_verify(jroot, jnp.asarray(leaves[leaf_i]), jpath, h, jfn)
        assert ours is (leaf_i == i and h == height) and ours == theirs
    # an internal node with a truncated path must not verify as a leaf
    node = field.from_mont(levels[1][1])
    assert not merkle.merkle_verify(root, node, merkle.merkle_open(levels, 5)[1:], height)
    assert merkle.merkle_verify(root, node, merkle.merkle_open(levels, 5)[1:], height - 1)


def test_model_input_validation():
    with pytest.raises(ValueError):
        sponge.sponge_hash(torch.zeros((3, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        merkle.merkle_root(torch.zeros((4, 4, 16), dtype=torch.int32))
    st = sponge.SpongeState(1, 4, device="cpu")
    with pytest.raises(ValueError):
        st.absorb(torch.zeros((1, 5, 16), dtype=torch.int32))
    st.absorb(torch.zeros((1, 2, 16), dtype=torch.int32))
    with pytest.raises(RuntimeError):
        st.digest()
