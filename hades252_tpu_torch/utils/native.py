"""ctypes bindings for the native C++ host engine (`native/hades_cpu.cpp`).

Port of `hades252_tpu/utils/native.py`, which imports no JAX but lives in
the JAX package: the port keeps its own copy, so that it can be held
against the native engine on a host without JAX. The engine is the
independent CPU implementation every slice is checked against, and its
single-thread naive schedule is the pinned `vs_baseline` denominator.

The source and the asset blobs are read by path and never copied. The
library is built at first use with the host C++ compiler into
`build/hades252_tpu_torch/`, never under `native/`. Where it cannot be
built or loaded (no compiler, a build directory that cannot be made or
written, a library the loader refuses), `NativeUnavailable` is raised and
`available()` is false, so the transcripts fall back to the int oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import cache
from pathlib import Path

import numpy as np

from ..params import _ASSET_DIR, N_DIGITS
from .encoding import bytes_to_digits, check_canonical_digits, digits_to_bytes

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "hades_cpu.cpp"
_BUILD_DIR = _ROOT / "build" / "hades252_tpu_torch"
#: The flags of native/Makefile.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")


class NativeUnavailable(RuntimeError):
    pass


def _cpu_key() -> str:
    """Short hash of this host's CPU feature flags. The library is built
    with -march=native, so each feature set gets its own artifact: machine
    code compiled on a richer host would SIGILL on a poorer one."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = [line for line in f if line.startswith("flags")][0]
    except (OSError, IndexError):
        flags = "unknown"
    return hashlib.sha1(flags.encode()).hexdigest()[:12]


def _build() -> Path:
    """Compile the engine unless it exists for this CPU and this source.
    The artifact's name carries both hashes, so a stale library never
    matches; it appears atomically, so a concurrent loader sees all of it
    or none."""
    try:
        src_key = hashlib.sha1(_SOURCE.read_bytes()).hexdigest()[:10]
    except OSError as e:
        raise NativeUnavailable(f"cannot read the native source: {e}") from e
    so = _BUILD_DIR / f"libhades_cpu_{_cpu_key()}_{src_key}.so"
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise NativeUnavailable("cannot build native engine: no C++ compiler")
    tmp = so.with_name(f".{so.stem}.{os.getpid()}.so")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(f"cannot build native engine: {e.stderr}") from e
    except OSError as e:  # a build directory that cannot be made or written
        raise NativeUnavailable(f"cannot build native engine: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return so


@cache
def _lib() -> ctypes.CDLL:
    if os.environ.get("HADES_NO_NATIVE"):
        raise NativeUnavailable("disabled via HADES_NO_NATIVE")
    try:
        lib = ctypes.CDLL(str(_build()))
    except OSError as e:
        raise NativeUnavailable(f"cannot load native engine: {e}") from e
    lib.hades_init.restype = ctypes.c_int
    lib.hades_init.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.hades_perm_batch.restype = ctypes.c_int
    lib.hades_perm_batch.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.hades_bench.restype = ctypes.c_double
    lib.hades_bench.argtypes = [ctypes.c_long]
    lib.hades_sponge_hash.restype = ctypes.c_int
    lib.hades_sponge_hash.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_void_p,
    ]
    lib.hades_merkle_root.restype = ctypes.c_int
    lib.hades_merkle_root.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_void_p,
    ]
    lib.hades_cipher.restype = ctypes.c_int
    lib.hades_cipher.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hades_init_opt.restype = ctypes.c_int
    lib.hades_init_opt.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.hades_perm_batch_opt.restype = ctypes.c_int
    lib.hades_perm_batch_opt.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.hades_bench_opt.restype = ctypes.c_double
    lib.hades_bench_opt.argtypes = [ctypes.c_long]
    lib.hades_has_ifma.restype = ctypes.c_int
    lib.hades_has_ifma.argtypes = []
    lib.hades_bench_opt8.restype = ctypes.c_double
    lib.hades_bench_opt8.argtypes = [ctypes.c_long]
    with open(os.path.join(_ASSET_DIR, "ark.bin"), "rb") as f:
        ark = f.read()
    with open(os.path.join(_ASSET_DIR, "mds.bin"), "rb") as f:
        mds = f.read()
    if lib.hades_init(ark, len(ark), mds, len(mds)) != 0:
        raise NativeUnavailable("hades_init failed")
    if lib.hades_init_opt(_opt_payload(), len(_opt_payload())) != 0:
        raise NativeUnavailable("hades_init_opt failed")
    return lib


@cache
def _opt_payload() -> bytes:
    """The sparse partial-round schedule for the optimized engine, in the
    layout of hades_cpu.cpp's hades_init_opt, serialized from the port's
    exact int transform (params.optimized_partial_int)."""
    from ..params import optimized_partial_int

    opt = optimized_partial_int()
    flat = list(opt["c0"])
    for row in opt["u"]:
        flat += list(row)
    for row in opt["w"]:
        flat += list(row)
    flat.append(opt["m"])
    for row in opt["d"]:
        flat += list(row)
    for row in opt["final"]:
        flat += list(row)
    return b"".join(int(v).to_bytes(32, "little") for v in flat)


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def perm_batch_bytes(states: bytes | bytearray, n: int) -> bytes:
    """Permute n width-5 states serialized as n*5*32 canonical LE bytes."""
    if len(states) != n * 5 * 32:
        raise ValueError(f"{len(states)} bytes for {n} states of {5 * 32}")
    buf = ctypes.create_string_buffer(bytes(states), len(states))
    if _lib().hades_perm_batch(buf, n) != 0:
        raise NativeUnavailable("hades_perm_batch failed")
    return buf.raw


def _digits_u16_buf(digits, validate: bool = True) -> np.ndarray:
    """(B, 5, N_DIGITS) canonical digits (numpy array or CPU tensor) -> a
    contiguous little-endian uint16 buffer whose bytes are the n*5*32-byte
    canonical layout the engine works on. The engine assumes reduced
    inputs: they are checked unless the caller vouches for them with
    validate=False. A negative int32 digit wraps above 2^16 and is caught."""
    arr = np.asarray(digits).astype(np.uint32, copy=False)
    if arr.ndim != 3 or arr.shape[1:] != (5, N_DIGITS):
        raise ValueError(f"expected (B, 5, {N_DIGITS}) digits")
    if validate:
        if arr.size and not bool((arr < 65536).all()):
            raise ValueError("digits not normalized (outside [0, 2^16))")
        check_canonical_digits(
            arr.reshape(-1, N_DIGITS), "not a canonical field element: value >= p"
        )
    return np.ascontiguousarray(arr).astype("<u2")


def _perm_batch(symbol: str, digits, validate: bool = True) -> np.ndarray:
    b = int(digits.shape[0])
    if b == 0:
        return np.zeros(tuple(digits.shape), np.uint32)
    buf = _digits_u16_buf(digits, validate)
    if getattr(_lib(), symbol)(buf.ctypes.data_as(ctypes.c_void_p), b) != 0:
        raise NativeUnavailable(f"{symbol} failed")
    return buf.astype(np.uint32)


def perm_batch_digits(digits, validate: bool = True) -> np.ndarray:
    """Permute (B, 5, N_DIGITS) canonical digits through the engine's
    sparse-factored schedule (hades_perm_batch_opt: about half the field
    products of the dense schedule, bit-identical outputs). Returns uint32
    digits. validate=False skips the canonicality scan for a caller that
    owns the proof that every input is canonical."""
    return _perm_batch("hades_perm_batch_opt", digits, validate)


def perm_batch_digits_naive(digits) -> np.ndarray:
    """The engine's naive dense schedule (hades_perm_batch): the stand-in
    for the reference crate's performance class and the pinned vs_baseline
    denominator. Serving paths use the optimized engine above."""
    return _perm_batch("hades_perm_batch", digits)


#: Below this batch size the multi-thread path falls through to one
#: thread (starting threads costs more than the permutations).
_MT_MIN_BATCH = 256


def perm_batch_digits_mt(digits, n_threads: int | None = None,
                         validate: bool = True) -> np.ndarray:
    """perm_batch_digits across OS threads, each on its contiguous slice of
    one shared buffer. The engine keeps no state beyond its read-only
    constants and ctypes releases the GIL during a foreign call, so the
    shards run in parallel; the output is bit-identical. With n_threads=None
    the host's core count is taken, and batches below _MT_MIN_BATCH stay on
    one thread; an explicit n_threads is honored as given."""
    b = int(digits.shape[0])
    auto = n_threads is None
    if auto:
        n_threads = os.cpu_count() or 1
    n_threads = max(1, min(int(n_threads), b))
    if n_threads == 1 or (auto and b < _MT_MIN_BATCH):
        return perm_batch_digits(digits, validate)
    lib = _lib()
    buf = _digits_u16_buf(digits, validate)
    base = buf.ctypes.data
    bounds = [b * t // n_threads for t in range(n_threads + 1)]
    # -1: a shard whose thread dies before the foreign call reads as a
    # failure, never as an unpermuted success (no shard is empty)
    errs = [-1] * n_threads

    def run(t: int) -> None:
        lo, hi = bounds[t], bounds[t + 1]
        errs[t] = lib.hades_perm_batch_opt(base + lo * 5 * 32, hi - lo)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if any(errs):
        raise NativeUnavailable("hades_perm_batch_opt failed in a shard")
    return buf.astype(np.uint32)


def threaded_perm(n_threads: int | None = None):
    """perm_fn factory over perm_batch_digits_mt for the fri/aggregate
    perm_fn seams (pooled_entries_verify, verify_succinct_batched, the tree
    builds). Raises NativeUnavailable up front when the engine cannot be
    built."""
    _lib()
    return lambda s: perm_batch_digits_mt(np.asarray(s, np.uint32), n_threads)


def sponge_hash_digits(msgs) -> np.ndarray:
    """Native rate-4 sponge: (B, L, N_DIGITS) canonical digits -> (B,
    N_DIGITS). Same spec, and bit-identical digests, as
    models.sponge.sponge_hash."""
    b, length = msgs.shape[0], msgs.shape[1]
    out = ctypes.create_string_buffer(b * 32)
    if _lib().hades_sponge_hash(digits_to_bytes(msgs), b, length, out) != 0:
        raise NativeUnavailable("hades_sponge_hash failed")
    return bytes_to_digits(out.raw, (b,))


def merkle_root_digits(leaves) -> np.ndarray:
    """Native arity-4 Merkle root: (N, N_DIGITS) canonical digits ->
    (N_DIGITS,). Same spec, and bit-identical root, as
    models.merkle.merkle_root."""
    n = leaves.shape[0]
    out = ctypes.create_string_buffer(32)
    if _lib().hades_merkle_root(digits_to_bytes(leaves), n, out) != 0:
        raise NativeUnavailable("hades_merkle_root failed")
    return bytes_to_digits(out.raw, (1,))[0]


def cipher_digits(key, nonce, data, decrypt: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Native duplex cipher (same spec and bit-identical outputs as
    models.cipher). key (B, 2, D), nonce (B, D), data (B, L, D) canonical
    digits, L a multiple of 4. Returns (out (B, L, D), tags (B, D))."""
    b, length = data.shape[0], data.shape[1]
    out = ctypes.create_string_buffer(b * length * 32)
    tags = ctypes.create_string_buffer(b * 32)
    rc = _lib().hades_cipher(
        digits_to_bytes(key), digits_to_bytes(nonce), digits_to_bytes(data),
        b, length, int(decrypt), out, tags,
    )
    if rc != 0:
        raise NativeUnavailable("hades_cipher failed")
    return bytes_to_digits(out.raw, (b, length)), bytes_to_digits(tags.raw, (b,))


def bench_perms_per_sec(n: int = 20000) -> float:
    """Single-thread permutations a second of the naive dense schedule, the
    CPU reference class and the pinned vs_baseline denominator."""
    return float(_lib().hades_bench(n))


def bench_perms_per_sec_opt(n: int = 20000) -> float:
    """Single-thread rate of the scalar sparse-factored schedule (reported
    beside the baseline, never as its denominator)."""
    return float(_lib().hades_bench_opt(n))


def has_ifma() -> bool:
    """True when the AVX-512 IFMA batch-8 engine is compiled into this
    host's artifact (hades_perm_batch_opt then runs groups of 8 states
    through it, with bit-identical outputs)."""
    return bool(_lib().hades_has_ifma())


def bench_perms_per_sec_opt8(n: int = 20000) -> float:
    """Single-thread rate of the AVX-512 IFMA batch-8 engine; -1.0 where it
    is not compiled in."""
    return float(_lib().hades_bench_opt8(n))
