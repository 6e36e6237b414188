"""The port's root, its ScalarStrategy("native"), the KAT gate's arguments
and the native engine's extras, held against the JAX package on the CPU."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import hades252_tpu as jh
import hades252_tpu_torch as th
from hades252_tpu.utils import native as jnative
from hades252_tpu_torch import fri, selftest, serialize
from hades252_tpu_torch.gadget import Composer, Constraint
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.utils import native
from hades252_tpu_torch.utils.encoding import ints_to_digits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a host C++ compiler")
    assert native.available() and jnative.available()
    return native


def _states(seed: int, b: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(40), "little") % th.P for _ in range(th.WIDTH)]
            for _ in range(b)]
    return ints_to_digits(vals, shape=(b, th.WIDTH))


@pytest.mark.parametrize("name", ["WIDTH", "TOTAL_FULL_ROUNDS", "PARTIAL_ROUNDS", "ROUNDS",
                                  "N_DIGITS", "P", "__version__"])
def test_root_constants_equal_jax(name):
    assert getattr(th, name) == getattr(jh, name)


@pytest.mark.parametrize("name", ["ROUND_CONSTANTS", "MDS_MATRIX"])
def test_lazy_root_arrays_equal_jax(name):
    got, want = getattr(th, name), getattr(jh, name)
    assert np.array_equal(np.array(got, dtype=object), np.array(want, dtype=object))
    assert len(th.ROUND_CONSTANTS) == 960 and len(th.MDS_MATRIX) == th.WIDTH
    with pytest.raises(AttributeError, match="no attribute 'NOT_A_NAME'"):
        th.NOT_A_NAME  # noqa: B018


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(jh.HadesParams)]
                         + ["rounds", "constants_per_perm"])
def test_params_equal_jax(field):
    assert getattr(th.PARAMS, field) == getattr(jh.PARAMS, field)
    assert getattr(th.HadesParams(), field) == getattr(jh.HadesParams(), field)


def test_params_are_frozen():
    assert th.PARAMS == th.HadesParams() and th.PARAMS.rounds == 67
    with pytest.raises(dataclasses.FrozenInstanceError):
        th.PARAMS.width = 3


@pytest.mark.parametrize("seed,b", [(1, 1), (2, 4), (3, 33)])
def test_native_strategy_equals_jax_native_and_ref(engine, seed, b):
    x = _states(seed, b)
    got = th.ScalarStrategy("native").perm(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32 and got.shape == (b, 5, 16)
    assert np.array_equal(got.numpy(), np.asarray(jh.ScalarStrategy("native").perm(x)))
    # the port's own oracle on a torch tensor, and a leading batch axis
    assert torch.equal(th.ScalarStrategy("native").perm(torch.from_numpy(x.astype(np.int32))), got)
    assert torch.equal(th.ScalarStrategy("native").perm(x[None])[0], got)
    assert torch.equal(th.ScalarStrategy("ref").perm(x), got)


def test_native_strategy_equals_jax_ref(engine):
    x = _states(4, 4)
    got = th.ScalarStrategy("native").perm(x)
    assert np.array_equal(got.numpy(), np.asarray(jh.ScalarStrategy("ref").perm(x)))


def test_native_strategy_raises_where_the_engine_cannot_build(monkeypatch):
    monkeypatch.setenv("HADES_NO_NATIVE", "1")
    native._lib.cache_clear()
    try:
        with pytest.raises(native.NativeUnavailable):
            th.ScalarStrategy("native").perm(_states(5, 2))
    finally:
        monkeypatch.delenv("HADES_NO_NATIVE")
        native._lib.cache_clear()
    with pytest.raises(ValueError, match="unknown backend"):
        th.ScalarStrategy("pallas")


@pytest.mark.parametrize("schedules,lanes,include_mont", [
    (("opt",), None, False),
    (("opt", "hybp"), 5, True),
    (("mxu8",), 200, False),
])
def test_kat_gate_arguments(schedules, lanes, include_mont, monkeypatch):
    """verify_device runs the named schedules, on `lanes` vectors, the
    Montgomery path only with include_mont; on the CPU the plain versions."""
    calls = []
    for name in ("permute_cuda", "permute_cuda_mont"):
        fn = getattr(selftest, name)

        def spy(x, *, schedule, _fn=fn, _name=name):
            calls.append((_name, schedule, x.shape[0]))
            return _fn(x, schedule=schedule)

        monkeypatch.setattr(selftest, name, spy)
    perm_cuda.reset_launches()
    assert selftest.verify_device(schedules, device="cpu", lanes=lanes,
                                  include_mont=include_mont) == []
    selftest.assert_device_correct(schedules, device="cpu", lanes=lanes, include_mont=include_mont)
    assert perm_cuda.launches == {s: 0 for s in perm_cuda.SCHEDULES}
    n = selftest.N_VECTORS if lanes is None else lanes
    paths = ["permute_cuda"] + (["permute_cuda_mont"] if include_mont else [])
    want = [(p, s, n) for s in schedules for p in paths]
    assert calls == want + want


def test_kat_gate_reports_a_wrong_kernel(monkeypatch):
    monkeypatch.setattr(selftest, "permute_cuda", lambda x, *, schedule: x)
    assert selftest.verify_device(("opt",), device="cpu", include_mont=False) == [
        "schedule 'opt' (convert=True): lane 0 mismatch"]
    with pytest.raises(RuntimeError, match="KAT verification FAILED"):
        selftest.assert_device_correct(("opt",), device="cpu", include_mont=False)


@pytest.mark.parametrize("seed,n", [(6, 1), (7, 3), (8, 16)])
def test_perm_batch_bytes_equals_jax(engine, seed, n):
    states = _states(seed, n)
    data = states.astype("<u2").tobytes()  # 16-bit LE digits: the 32-byte LE layout
    got = native.perm_batch_bytes(data, n)
    assert got == jnative.perm_batch_bytes(data, n)
    assert np.array_equal(np.frombuffer(got, "<u2").reshape(n, 5, 16),
                          native.perm_batch_digits(states))
    with pytest.raises(ValueError, match="bytes for"):
        native.perm_batch_bytes(data, n + 1)


@pytest.mark.parametrize("n_threads", [None, 1, 3])
def test_threaded_perm_proves_the_default_seams_bytes(engine, n_threads):
    c = Composer()
    a = c.append_witness(3)
    b = c.append_witness(5)
    c.gate_mul(Constraint().mult(1).a(a).b(b))
    c.append_gate(Constraint().left(1).a(a).public(-3))
    pk, vk = fri.preprocess_succinct(c, fri.FriParams(blowup=4, n_queries=4, final_degree=8,
                                                      pow_bits=2))
    perm = native.threaded_perm(n_threads)
    x = _states(9, 300)
    assert np.array_equal(perm(x), native.perm_batch_digits(x))
    got = serialize.proof_to_bytes(fri.prove_succinct(c, pk, perm), vk)
    assert got == serialize.proof_to_bytes(fri.prove_succinct(c, pk), vk)
    assert fri.verify_succinct(vk, serialize.proof_from_bytes(got, vk), [g.pi for g in c.gates],
                               perm)
