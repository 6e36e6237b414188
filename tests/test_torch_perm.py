"""The port's permutation against the JAX package: the torch oracle against
`ops.perm_ref.permute`, and the plain versions of the CUDA kernels against
the JAX package's own CPU harness for its Pallas kernels
(`permute_planar_emulated`), all exact. The kernels themselves run only on
a CUDA card; their tests are in test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu.ops.perm_pallas import permute_planar_emulated
from hades252_tpu.ops.perm_ref import permute as jax_permute
from hades252_tpu_torch import field, selftest
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.ops.perm_ref import permute, permute_mont
from hades252_tpu_torch.params import P
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

torch.set_num_threads(1)


def _states(n: int, seed: int) -> np.ndarray:
    """(n, 5, 16) uint32 canonical states from a seed."""
    return field.np_random_elements((n, 5), np.random.default_rng(seed))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def test_oracle_matches_jax_oracle():
    x = _states(8, 1)
    x[0] = ints_to_digits([[0, 1, P - 1, P - 2, 0]], shape=(1, 5))[0]
    ours = permute(_t(x))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(jax_permute(jnp.asarray(x))))


def test_oracle_kats():
    inputs = ints_to_digits([list(k) for k in selftest.KATS], shape=(4, 5))
    out = permute(_t(inputs))
    for row, expected in zip(out.numpy(), selftest.KATS.values()):
        assert tuple(digits_to_ints(row)) == expected


def test_oracle_mont_path():
    x = _t(_states(3, 2))
    assert torch.equal(field.from_mont(permute_mont(field.to_mont(x))), permute(x))


@pytest.mark.parametrize("schedule", ["naive", "opt"])
@pytest.mark.parametrize("convert", [True, False])
def test_plain_kernel_matches_jax_kernel_harness(schedule, convert):
    x = np.ascontiguousarray(_states(128, 3).transpose(1, 2, 0))  # planar (5, 16, B)
    ours = perm_cuda.permute_planar_plain(_t(x), convert=convert, schedule=schedule)
    theirs = permute_planar_emulated(x, convert=convert, schedule=schedule)
    assert ours.dtype == torch.int32 and ours.shape == (5, 16, 128)
    assert np.array_equal(ours.numpy().astype(np.uint32), theirs)


@functools.cache
def _oracle_outputs(b: int):
    """(x, permute(x), to_mont(x), permute_mont(to_mont(x))) for b states."""
    x = _t(_states(b, 10 + b))
    xm = field.to_mont(x)
    return x, permute(x), xm, permute_mont(xm)


@pytest.mark.parametrize("b", [1, 5, 130])
@pytest.mark.parametrize("schedule", ["naive", "opt"])
def test_batch_major_wrappers_on_cpu(b, schedule):
    x, want, xm, want_m = _oracle_outputs(b)
    perm_cuda.reset_launches()
    out = perm_cuda.permute_cuda(x, schedule=schedule)
    assert out.shape == (b, 5, 16) and out.dtype == torch.int32
    assert torch.equal(out, want)
    assert torch.equal(perm_cuda.permute_cuda_mont(xm, schedule=schedule), want_m)
    # the CPU takes the plain version: no kernel was launched
    assert perm_cuda.launches == {"naive": 0, "opt": 0}


def test_scalar_strategy_batched_ref_backend():
    x, want, _, _ = _oracle_outputs(5)
    assert torch.equal(ScalarStrategy().perm(x.numpy().astype(np.uint32)), want)
    assert torch.equal(ScalarStrategy("ref").perm(x[None]), want[None])
    with pytest.raises(ValueError):
        ScalarStrategy("pallas")


def test_wrapper_rejects_bad_input():
    x = _t(_states(2, 4))
    with pytest.raises(ValueError):
        perm_cuda.permute_cuda(x.to(torch.int64))
    with pytest.raises(ValueError):
        perm_cuda.permute_cuda(x[:, :4])
    with pytest.raises(ValueError):
        perm_cuda.permute_cuda(x, schedule="hybp")
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x.permute(1, 2, 0).to("meta"))


def test_kernel_tables_layout():
    tables = perm_cuda.kernel_tables()
    # p, R^2, dense ARK and MDS, then ark_fr, c0, u, w, m, d, final
    words = 8 * (1 + 1 + 67 * 5 + 25 + 8 * 5 + 5 + 59 * 4 * 2 + 1 + 59 * 5 + 16)
    assert tables.dtype == np.uint32 and tables.shape == (words,)
