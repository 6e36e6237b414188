"""The port's own copy of the native engine's binding (`utils/native.py`)
against the port's plain kernels, sponge, Merkle root and cipher, bit for
bit, on the CPU. The binding imports neither JAX nor the JAX package; the
engine is built with the host C++ compiler into the ignored build
directory, never under `native/`."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from hades252_tpu_torch import field, params, selftest
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import perm_cuda, permute
from hades252_tpu_torch.utils import native

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a host C++ compiler")
    assert native.available()
    return native


def _elements(shape, seed: int) -> np.ndarray:
    return field.np_random_elements(shape, np.random.default_rng(seed))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def test_library_is_built_outside_the_native_directory(engine):
    so = engine._build()
    root = Path(native.__file__).resolve().parents[2]
    assert so.parent == root / "build" / "hades252_tpu_torch" and so.exists()
    assert so.name.startswith(f"libhades_cpu_{engine._cpu_key()}_") and so == engine._build()
    assert [p.name for p in so.parent.glob(".libhades_cpu_*")] == []  # no temporary is left
    assert engine.has_ifma() in (True, False)


@pytest.mark.parametrize("fn", ["perm_batch_digits", "perm_batch_digits_naive",
                                "perm_batch_digits_mt"])
def test_kat_vectors(engine, fn):
    inputs, expected, _, _ = selftest._vectors()
    got = getattr(engine, fn)(inputs)
    assert got.dtype == np.uint32 and np.array_equal(got, expected)


@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
def test_engine_matches_plain_kernel(engine, schedule):
    x = _elements((6, 5), 40)
    ours = perm_cuda.permute_cuda(_t(x), schedule=schedule)
    assert np.array_equal(engine.perm_batch_digits(x), ours.numpy())
    assert np.array_equal(engine.perm_batch_digits(_t(x)), ours.numpy())  # int32 tensor in


def test_threaded_engine_matches_on_every_split(engine):
    x = _elements((300, 5), 41)
    want = engine.perm_batch_digits(x)
    assert np.array_equal(want[:8], permute(_t(x[:8])).numpy())
    for n_threads in (None, 1, 3, 7):
        assert np.array_equal(engine.perm_batch_digits_mt(x, n_threads), want)
    assert np.array_equal(engine.perm_batch_digits_naive(x), want)
    assert engine.perm_batch_digits(x[:0]).shape == (0, 5, 16)


def test_engine_rejects_bad_digits(engine):
    x = _elements((2, 5), 42).astype(np.int32)
    for value in (-1, 65536):
        bad = x.copy()
        bad[1, 2, 3] = value
        with pytest.raises(ValueError, match="not normalized"):
            engine.perm_batch_digits(bad)
    bad = x.copy()
    bad[0, 0] = [(params.P >> (16 * i)) & 0xFFFF for i in range(16)]
    with pytest.raises(ValueError, match="value >= p"):
        engine.perm_batch_digits(bad)
    with pytest.raises(ValueError, match="expected"):
        engine.perm_batch_digits(x[:, :4])


@pytest.mark.parametrize("b,length", [(3, 8), (2, 5), (1, 1)])
def test_sponge_matches(engine, b, length):
    msgs = _elements((b, length), 43 + length)
    assert np.array_equal(engine.sponge_hash_digits(msgs), sponge.sponge_hash(_t(msgs)).numpy())


@pytest.mark.parametrize("n,schedule", [(1, "opt"), (16, "mxu"), (64, "hyb13"), (100, "hybp13")])
def test_merkle_root_matches(engine, n, schedule):
    from hades252_tpu_torch.ops import make_perm_mont_fn

    leaves = _elements((n,), 50 + n)
    ours = merkle.merkle_root(_t(leaves), make_perm_mont_fn("cuda", schedule=schedule))
    assert np.array_equal(engine.merkle_root_digits(leaves), ours.numpy())


def test_cipher_matches(engine):
    key, nonce, msgs = _elements((3, 2), 60), _elements((3,), 61), _elements((3, 8), 62)
    ct, tag = cipher.encrypt(_t(key), _t(nonce), _t(msgs))
    ct_n, tag_n = engine.cipher_digits(key, nonce, msgs)
    assert np.array_equal(ct.numpy(), ct_n) and np.array_equal(tag.numpy(), tag_n)
    pt_n, tag_d = engine.cipher_digits(key, nonce, ct_n, decrypt=True)
    assert np.array_equal(pt_n, msgs) and np.array_equal(tag_d, tag_n)


def test_opt_payload_is_the_ports_schedule(engine):
    opt = params.optimized_partial_int()
    payload = engine._opt_payload()
    assert len(payload) == 32 * (5 + 59 * 4 * 2 + 1 + 58 * 5 + 16)
    assert int.from_bytes(payload[:32], "little") == opt["c0"][0]
    assert int.from_bytes(payload[-32:], "little") == opt["final"][-1][-1]


def test_bench_rates_are_positive(engine):
    assert engine.bench_perms_per_sec(200) > 0 and engine.bench_perms_per_sec_opt(200) > 0
    assert (engine.bench_perms_per_sec_opt8(200) > 0) == engine.has_ifma()


def test_disabled_engine_is_unavailable(monkeypatch):
    monkeypatch.setenv("HADES_NO_NATIVE", "1")
    native._lib.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(native.NativeUnavailable, match="disabled"):
            native.perm_batch_digits(np.zeros((1, 5, 16), np.uint32))
    finally:
        monkeypatch.delenv("HADES_NO_NATIVE")
        native._lib.cache_clear()


def test_missing_compiler_is_unavailable(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeUnavailable, match="no C\\+\\+ compiler"):
        native._build()
    assert not (tmp_path / "build").exists() or os.listdir(tmp_path / "build") == []


@pytest.mark.parametrize("fault", ["uncreatable build directory", "library the loader refuses"])
def test_unbuildable_engine_leaves_the_transcripts_on_the_int_oracle(monkeypatch, tmp_path,
                                                                     fault):
    """A build directory that cannot be made, or a library that cannot be
    loaded, makes the engine unavailable instead of raising, and the
    transcripts fall back to ScalarStrategy: the same challenges."""
    from hades252_tpu_torch import plonk
    from hades252_tpu_torch.strategy import ScalarStrategy

    if fault == "uncreatable build directory":
        monkeypatch.setattr(native, "_BUILD_DIR", Path("/proc/no_such_dir/build"))
    else:
        bad = tmp_path / "not_a_library.so"
        bad.write_bytes(b"not an ELF file")
        monkeypatch.setattr(native, "_build", lambda: bad)
    monkeypatch.setattr(plonk, "_TRANSCRIPT_PERM", None)
    monkeypatch.setattr(plonk, "_TRANSCRIPT_PERM_BATCH", None)
    native._lib.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(native.NativeUnavailable):
            native._lib()
        strat = ScalarStrategy()
        label = 0x4841444553
        tr = plonk.Transcript()
        tr.absorb(7, 11)
        want = strat.perm([label, 7, 11, 0, 0])
        assert tr.challenge() == want[1]
        bt = plonk.BatchedTranscript(2)
        bt.absorb_each([5, 9])
        states = [strat.perm([label, v, 0, 0, 0]) for v in (5, 9)]
        assert bt.challenge_each() == [s[1] for s in states]
        assert bt.states == [strat.perm(s) for s in states]
    finally:
        monkeypatch.undo()
        native._lib.cache_clear()
    assert native.available() == any(shutil.which(cxx) for cxx in ("g++", "c++"))
