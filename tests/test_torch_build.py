"""The kernels' build helpers, the arithmetic of `perm.cuh` compiled for the
host, and the independent oracles of `chip_smoke.py`, all on the CPU."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from hades252_tpu_torch import selftest
from hades252_tpu_torch.models import merkle, sponge
from hades252_tpu_torch.ops import _build, perm_cuda
from hades252_tpu_torch.params import digits_to_limbs
from hades252_tpu_torch.utils.encoding import digits_to_ints

torch.set_num_threads(1)

# Runs perm.cuh's per-state permutation over states given as 32-bit limbs:
# harness TABLES STATES SCHEDULE(0 naive, 1 opt) CONVERT -> limbs on stdout.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "perm.cuh"
using namespace hades;
static std::vector<uint32_t> read_words(const char* path) {
  FILE* f = fopen(path, "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  return v;
}
#define TAKE(sym) memcpy(sym, src, sizeof(sym)); src += sizeof(sym) / 4;
int main(int argc, char** argv) {
  std::vector<uint32_t> tables = read_words(argv[1]), states = read_words(argv[2]);
  const int opt = atoi(argv[3]), convert = atoi(argv[4]);
  const uint32_t* src = tables.data();
  for (int j = 0; j < kLimbs; ++j) if (src[j] != p_limb(j)) return 2;
  src += kLimbs;
  TAKE(c_r2) TAKE(c_ark) TAKE(c_mds) TAKE(c_ark_fr) TAKE(c_c0) TAKE(c_u) TAKE(c_w)
  TAKE(c_m) TAKE(c_d) TAKE(c_final)
  if (src != tables.data() + tables.size()) return 3;
  for (size_t b = 0; b * 40 < states.size(); ++b) {
    uint32_t s[kWidth][kLimbs];
    memcpy(s, &states[b * 40], sizeof(s));
    if (opt) perm_opt(s, convert != 0); else perm_naive(s, convert != 0);
    memcpy(&states[b * 40], s, sizeof(s));
  }
  fwrite(states.data(), 4, states.size(), stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("harness")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(d / "harness"), str(d / "harness.cpp")], check=True, timeout=300)
    perm_cuda.kernel_tables().astype("<u4").tofile(d / "tables.bin")
    return d


@pytest.mark.parametrize("schedule", ["naive", "opt"])
@pytest.mark.parametrize("convert", [True, False])
def test_kernel_math_on_host_matches_int_oracle(harness, schedule, convert):
    inputs, expected, inputs_m, expected_m = selftest._vectors()
    x, want = (inputs, expected) if convert else (inputs_m, expected_m)
    digits_to_limbs(x).astype("<u4").tofile(harness / "states.bin")
    out = subprocess.run(
        [str(harness / "harness"), str(harness / "tables.bin"), str(harness / "states.bin"),
         str(int(schedule == "opt")), str(int(convert))],
        capture_output=True, check=True, timeout=300,
    ).stdout
    got = np.frombuffer(out, "<u4").reshape(-1, 5, 8)
    assert np.array_equal(got, digits_to_limbs(want))


def test_source_hash_covers_every_source():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    names = sorted(p.name for p in _build.CSRC.glob("*.cu*"))
    assert names == ["perm.cu", "perm.cuh"]


def test_ptxas_summary():
    report = (
        "ptxas info    : Compiling entry function '_Z14hades_perm_optPKiPixi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z14hades_perm_optPKiPixi\n"
        "    24 bytes stack frame, 44 bytes spill stores, 32 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 0 barriers\n"
    )
    assert _build.ptxas_summary(report) == [
        "_Z14hades_perm_optPKiPixi: 24 bytes stack frame, 44 bytes spill stores, "
        "32 bytes spill loads",
        "_Z14hades_perm_optPKiPixi: Used 255 registers, used 0 barriers",
    ]


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_plain_planar_slices(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PERM_BATCH", 3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(chip_smoke.random_elements((5, 7), rng).transpose(0, 2, 1).copy())
    got = chip_smoke.plain_planar(x, convert=False, schedule="opt")
    assert torch.equal(got, perm_cuda.permute_planar_plain(x, convert=False, schedule="opt"))


def test_chip_smoke_oracles_agree_with_the_port():
    rng = np.random.default_rng(3)
    leaves = chip_smoke.random_elements((16,), rng)
    assert (leaves[:, 15] < 0x73ED).all() and leaves.dtype == np.int32
    root = merkle.merkle_root(torch.from_numpy(leaves), chip_smoke.plain_mont_fn("opt"))
    assert int(digits_to_ints(root.numpy())) == chip_smoke.int_merkle_root(
        list(digits_to_ints(leaves)))
    msgs = torch.from_numpy(chip_smoke.random_elements((2, 6), rng))
    digests = sponge.sponge_hash(msgs, chip_smoke.plain_mont_fn("naive"))
    assert int(digits_to_ints(digests[1].numpy())) == chip_smoke.int_sponge(
        list(digits_to_ints(msgs[1].numpy())))
