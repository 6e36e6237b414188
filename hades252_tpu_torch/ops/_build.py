"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources (`ops/csrc/*.cu`, which include `*.cuh`) compile into one
shared library with a plain C interface, under `build/hades252_tpu_torch/`
at the root of the checkout. The build runs at first use, and again
whenever the sources or flags change: the library's name carries their
hash. A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hades252_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def source_hash() -> str:
    """Hash of every source and header under csrc/ and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the library unless it exists for the current sources.
    Returns its path and the compiler's report (ptxas register counts)."""
    lib = BUILD_DIR / f"libhades252_kernels_{source_hash()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.stem}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, report


def ptxas_summary(report: str) -> list[str]:
    """The lines of a build report that give each kernel's registers and
    spills, with the kernel's name in front."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, with every entry point's C signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.hades_init.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.hades_init.restype = ctypes.c_int
    for name in ("hades_perm_naive_launch", "hades_perm_opt_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.hades_error_string.argtypes = [ctypes.c_int]
    lib.hades_error_string.restype = ctypes.c_char_p
    return lib
