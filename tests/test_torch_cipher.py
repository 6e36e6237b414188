"""The port's duplex cipher against the JAX package's (`models/cipher.py`)
and the native engine's (through the port's own `utils/native.cipher_digits`),
bit for bit, and its
authentication behaviour, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu.models import cipher as jcipher
from hades252_tpu_torch.models import cipher
from hades252_tpu_torch.ops import make_perm_mont_fn, perm_cuda
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils import metrics, native
from hades252_tpu_torch.utils.encoding import ints_to_digits

torch.set_num_threads(1)


def _inputs(b: int, l: int, seed: int):
    """Seeded (key (b, 2, 16), nonce (b, 16), msgs (b, l, 16)) uint32 digits."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: ints_to_digits(  # noqa: E731
        [int.from_bytes(rng.bytes(40), "little") % P for _ in range(int(np.prod(shape)))],
        shape=shape)
    return draw(b, 2), draw(b), draw(b, l)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


@pytest.mark.parametrize("b,l", [(3, 6), (2, 8)])
def test_cipher_matches_jax_and_native(b, l):
    key, nonce, msgs = _inputs(b, l, 100 + l)
    ct, tag = cipher.encrypt(_t(key), _t(nonce), _t(msgs))
    ct_j, tag_j = jcipher.encrypt(jnp.asarray(key), jnp.asarray(nonce), jnp.asarray(msgs))
    assert ct.dtype == torch.int32 and ct.shape == (b, 8, 16) and tag.shape == (b, 16)
    assert np.array_equal(ct.numpy(), np.asarray(ct_j))
    assert np.array_equal(tag.numpy(), np.asarray(tag_j))

    pt, ok = cipher.decrypt(_t(key), _t(nonce), ct, tag)
    pt_j, ok_j = jcipher.decrypt(jnp.asarray(key), jnp.asarray(nonce), ct_j, tag_j)
    assert np.array_equal(pt.numpy(), np.asarray(pt_j))
    assert ok.tolist() == np.asarray(ok_j).tolist() == [True] * b

    if not native.available():
        pytest.skip("no native toolchain")
    padded = np.pad(msgs, ((0, 0), (0, 8 - l), (0, 0)))
    ct_n, tag_n = native.cipher_digits(key, nonce, padded)
    assert np.array_equal(ct.numpy(), ct_n) and np.array_equal(tag.numpy(), tag_n)
    pt_n, _ = native.cipher_digits(key, nonce, ct_n, decrypt=True)
    assert np.array_equal(pt.numpy(), pt_n)


def test_cipher_roundtrip_and_rejection():
    key, nonce, msgs = (_t(a) for a in _inputs(3, 6, 7))
    ct, tag = cipher.encrypt(key, nonce, msgs)
    pt, ok = cipher.decrypt(key, nonce, ct, tag)
    assert bool(ok.all()) and torch.equal(pt[:, :6], msgs)
    assert not bool(pt[:, 6:].any())  # the padding decrypts to zeros

    bad_key = key.clone()
    bad_key[0, 0, 0] += 1
    _, ok2 = cipher.decrypt(bad_key, nonce, ct, tag)
    assert ok2.tolist() == [False, True, True]

    bad_ct = ct.clone()
    bad_ct[1, 2, 0] += 1
    _, ok3 = cipher.decrypt(key, nonce, bad_ct, tag)
    assert ok3.tolist() == [True, False, True]

    _, ok4 = cipher.decrypt(key, nonce, ct[:, :4], tag)  # the tag binds the length
    assert not bool(ok4.any())


def test_cipher_rejects_bad_shapes():
    key, nonce, msgs = (_t(a) for a in _inputs(2, 4, 8))
    with pytest.raises(ValueError, match="key"):
        cipher.encrypt(key[:, :1], nonce, msgs)
    with pytest.raises(ValueError, match="nonce"):
        cipher.encrypt(key, nonce[:1], msgs)
    with pytest.raises(ValueError, match="data"):
        cipher.encrypt(key, nonce, msgs[:, :, :8])
    with pytest.raises(ValueError, match="data"):
        cipher.encrypt(key, nonce, msgs[0])
    with pytest.raises(ValueError, match="multiple of the rate"):
        cipher.decrypt(key, nonce, msgs[:, :3], msgs[:, 0])


def test_cipher_counts():
    key, nonce, msgs = (_t(a) for a in _inputs(2, 5, 9))
    metrics.reset()
    metrics.enable()
    try:
        ct, tag = cipher.encrypt(key, nonce, msgs)
        cipher.decrypt(key, nonce, ct, tag)
        counters = metrics.snapshot()["counters"]
    finally:
        metrics.disable()
        metrics.reset()
    assert counters == {"cipher.encrypts": 2, "cipher.decrypts": 2, "perms.executed": 12}


def test_cipher_through_mxu8_on_cpu_takes_the_plain_path():
    key, nonce, msgs = (_t(a) for a in _inputs(2, 7, 10))
    want_ct, want_tag = cipher.encrypt(key, nonce, msgs)
    perm_cuda.reset_launches()
    fn = make_perm_mont_fn("cuda", schedule="mxu8")
    ct, tag = cipher.encrypt(key, nonce, msgs, fn)
    assert torch.equal(ct, want_ct) and torch.equal(tag, want_tag)
    pt, ok = cipher.decrypt(key, nonce, ct, tag, fn)
    assert bool(ok.all()) and torch.equal(pt[:, :7], msgs)
    assert perm_cuda.launches == {s: 0 for s in perm_cuda.SCHEDULES}
