"""The port's sponge against the JAX package's, exactly.

The JAX side runs its Pallas kernel as the JAX package's own tests do on
the CPU (`make_perm_mont_fn("pallas", block=128, emulate=True)`, with
`scan=False` for the sponge); the port runs its wrappers, which take the
plain versions of its CUDA kernels on the CPU, and its torch oracle.
"""

import jax.numpy as jnp
import pytest
import torch

from hades252_tpu.models import sponge as jsponge
from hades252_tpu_torch.models import sponge
from hades252_tpu_torch.ops import make_perm_mont_fn
from hades252_tpu_torch.utils import metrics
from tests.test_torch_models import _elements, _jax_perm, _same, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("length", [1, 4, 5, 9])
def test_sponge_hash_matches_jax(length):
    msgs = _elements((4, length), 200 + length)
    theirs = jsponge.sponge_hash(jnp.asarray(msgs), _jax_perm(), scan=False)
    _same(sponge.sponge_hash(_t(msgs), make_perm_mont_fn("cuda")), theirs)


def test_sponge_squeeze_matches_jax():
    msgs = _elements((2, 5), 300)
    jst = jsponge.SpongeState(2, 5, _jax_perm()).absorb(jnp.asarray(msgs[:, :2]))
    jst.absorb(jnp.asarray(msgs[:, 2:]))
    theirs = jst.squeeze(6)  # crosses a permutation boundary at word 4
    st = sponge.SpongeState(2, 5, make_perm_mont_fn("cuda"))
    st.absorb(_t(msgs[:, :2])).absorb(_t(msgs[:, 2:]))
    ours = st.squeeze(6)
    assert ours.shape == (2, 6, 16)
    _same(ours, theirs)
    _same(st.digest(), theirs[:, 0])


def test_sponge_streaming_matches_oneshot_and_counts():
    msgs = _t(_elements((2, 7), 400))
    metrics.reset()
    metrics.enable()
    try:
        oneshot = sponge.sponge_hash(msgs)
        counts = metrics.snapshot()["counters"]
    finally:
        metrics.disable()
        metrics.reset()
    assert counts == {"sponge.messages": 2, "sponge.elements_absorbed": 14,
                      "perms.executed": 4}
    st = sponge.SpongeState(2, 7)
    for lo, hi in ((0, 1), (1, 4), (4, 6), (6, 7)):
        st.absorb(msgs[:, lo:hi])
    assert torch.equal(st.digest(), oneshot)
    assert sponge.sponge_hash_ints([7, 8, 9]) != sponge.sponge_hash_ints([7, 8, 9, 0])
