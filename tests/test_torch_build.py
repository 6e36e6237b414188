"""The kernels' build helpers, the per-state code of `perm.cuh`,
`perm_mxu8.cuh` and `perm_hyb.cuh` compiled for the host, and the independent oracles of
`chip_smoke.py`, all on the CPU."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from hades252_tpu_torch import field, selftest
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import _build, perm_cuda
from hades252_tpu_torch.params import digits_to_limbs
from hades252_tpu_torch.utils.encoding import digits_to_ints

torch.set_num_threads(1)

# Runs the per-state permutation over states given as 32-bit limbs:
# harness TABLES STATES SCHEDULE(the index in perm_cuda.SCHEDULES: 0 naive, 1 opt,
# 2 mxu8, 3 hyb, 4 hybp, 5 mxu, 6 hyb13, 7 hybp13) CONVERT CONSTS WEIGHTS [CHAIN]
# -> limbs on stdout. mxu8 and mxu run perm_mxu8.cuh and the chained schedules
# perm_hyb.cuh with their host dots, plain loops over the kernels' byte weights in
# the MMA's place (so mxu, whose kernel differs from mxu8's only in the MMA, runs
# mxu8's host code); hyb13 and hybp13 take the base-2^13 S-box.
# HARNESS13 runs the base-2^13 products alone: to13 and mul13 over pairs of
# 8-limb values -> the 20 digits of the first, its square and the product.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "perm.cuh"
#include "perm_mxu8.cuh"
#include "perm_hyb.cuh"
using namespace hades;
template <typename T>
static std::vector<T> read_file(const char* path) {
  FILE* f = fopen(path, "rb");
  std::vector<T> v;
  T w;
  while (fread(&w, sizeof(T), 1, f) == 1) v.push_back(w);
  fclose(f);
  return v;
}
static std::vector<uint32_t> read_words(const char* path) { return read_file<uint32_t>(path); }
#define TAKE(sym) memcpy(sym, src, sizeof(sym)); src += sizeof(sym) / 4;
int main(int argc, char** argv) {
  std::vector<uint32_t> tables = read_words(argv[1]), states = read_words(argv[2]);
  const int schedule = atoi(argv[3]), convert = atoi(argv[4]);
  std::vector<uint32_t> consts = read_words(argv[5]);
  std::vector<uint8_t> weights = read_file<uint8_t>(argv[6]);
  std::vector<uint8_t> chain;
  const bool chained = schedule == 3 || schedule == 4 || schedule >= 6;
  const bool pipelined = schedule == 4 || schedule == 7;
  if (chained) chain = read_file<uint8_t>(argv[7]);
  if ((int)consts.size() != (chained ? hyb::kConstWords : mxu8::kConstWords) ||
      (int)weights.size() != mxu8::kWeightBytes ||
      (chained && (int)chain.size() != hyb::chain_bytes(pipelined)))
    return 4;
  hyb::HostDot dot{{weights.data(), weights.data() + mxu8::kLinBytes,
                    weights.data() + mxu8::kLinBytes + mxu8::kPpBytes, {}, {}}, {}};
  const uint32_t* src = tables.data();
  for (int j = 0; j < kLimbs; ++j) if (src[j] != p_limb(j)) return 2;
  src += kLimbs;
  TAKE(c_r2) TAKE(c_ark) TAKE(c_mds) TAKE(c_ark_fr) TAKE(c_c0) TAKE(c_u) TAKE(c_w)
  TAKE(c_m) TAKE(c_d) TAKE(c_final)
  if (src != tables.data() + tables.size()) return 3;
  for (size_t b = 0; b * 40 < states.size(); ++b) {
    uint32_t s[kWidth][kLimbs];
    memcpy(s, &states[b * 40], sizeof(s));
    if (schedule == 7) hyb::perm<true, true>(dot, s, consts.data(), chain.data(), convert != 0);
    else if (schedule == 6) hyb::perm<false, true>(dot, s, consts.data(), chain.data(), convert != 0);
    else if (schedule == 4) hyb::perm<true>(dot, s, consts.data(), chain.data(), convert != 0);
    else if (schedule == 3) hyb::perm<false>(dot, s, consts.data(), chain.data(), convert != 0);
    else if (schedule == 2 || schedule == 5) mxu8::perm(dot, s, consts.data(), convert != 0);
    else if (schedule == 1) perm_opt(s, convert != 0);
    else perm_naive(s, convert != 0);
    memcpy(&states[b * 40], s, sizeof(s));
  }
  fwrite(states.data(), 4, states.size(), stdout);
  return 0;
}
"""


HARNESS13 = r"""
#include <cstdio>
#include <vector>
#include "perm_mxu8.cuh"
using namespace hades;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  for (size_t i = 0; i + 16 <= v.size(); i += 16) {
    uint32_t a[mxu8::kD13], b[mxu8::kD13], sq[16], pr[16];
    mxu8::to13(a, &v[i]);
    mxu8::to13(b, &v[i + 8]);
    mxu8::mul13<true>(sq, a, a);
    mxu8::mul13<false>(pr, a, b);
    fwrite(a, 4, mxu8::kD13, stdout);
    fwrite(sq, 4, 16, stdout);
    fwrite(pr, 4, 16, stdout);
  }
  return 0;
}
"""


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    return cxx


def test_base13_products_on_host_are_exact(tmp_path):
    """to13 and mul13 (the S-box body of hyb13 and hybp13) compiled for the
    host, on canonical values, on un-normalised ones just below 2p, which
    the S-box's x^2 and x^4 may be, and on the limits of 256 bits."""
    from hades252_tpu_torch.params import P

    (tmp_path / "h.cpp").write_text(HARNESS13)
    subprocess.run([_cxx(), "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(tmp_path / "h"), str(tmp_path / "h.cpp")], check=True, timeout=300)
    rng = np.random.default_rng(9)
    vals = [0, 1, P - 1, P, 2 * P - 1, 2 * P - 2, (1 << 256) - 1, (1 << 255) + 1]
    vals += [int.from_bytes(rng.bytes(32), "little") % (2 * P) for _ in range(24)]
    pairs = list(zip(vals, reversed(vals)))
    limbs = [[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for pair in pairs for x in pair]
    np.asarray(limbs, "<u4").tofile(tmp_path / "in.bin")
    out = subprocess.run([str(tmp_path / "h"), str(tmp_path / "in.bin")], capture_output=True,
                         check=True, timeout=60).stdout
    rows = np.frombuffer(out, "<u4").reshape(len(pairs), 20 + 16 + 16)
    for (x, y), row in zip(pairs, rows):
        assert [int(d) for d in row[:20]] == [(x >> (13 * k)) & 0x1FFF for k in range(20)]
        assert sum(int(v) << (32 * i) for i, v in enumerate(row[20:36])) == x * x
        assert sum(int(v) << (32 * i) for i, v in enumerate(row[36:])) == x * y


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = _cxx()
    d = tmp_path_factory.mktemp("harness")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(d / "harness"), str(d / "harness.cpp")], check=True, timeout=300)
    perm_cuda.kernel_tables().astype("<u4").tofile(d / "tables.bin")
    consts, weights = perm_cuda.mxu8_kernel_tables()
    consts.astype("<u4").tofile(d / "mxu8_consts.bin")
    weights.tofile(d / "mxu8_weights.bin")
    for schedule in ("hyb", "hybp"):
        consts, _, chain = perm_cuda.hyb_kernel_tables(schedule)
        consts.astype("<u4").tofile(d / f"{schedule}_consts.bin")
        chain.tofile(d / f"{schedule}_chain.bin")
    return d


@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
@pytest.mark.parametrize("convert", [True, False])
def test_kernel_math_on_host_matches_int_oracle(harness, schedule, convert):
    inputs, expected, inputs_m, expected_m = selftest._vectors()
    x, want = (inputs, expected) if convert else (inputs_m, expected_m)
    digits_to_limbs(x).astype("<u4").tofile(harness / "states.bin")
    chained = schedule in perm_cuda._CHAINED
    tables = schedule.removesuffix("13")
    out = subprocess.run(
        [str(harness / "harness"), str(harness / "tables.bin"), str(harness / "states.bin"),
         str(perm_cuda.SCHEDULES.index(schedule)), str(int(convert)),
         str(harness / (f"{tables}_consts.bin" if chained else "mxu8_consts.bin")),
         str(harness / "mxu8_weights.bin"), str(harness / f"{tables}_chain.bin")],
        capture_output=True, check=True, timeout=300,
    ).stdout
    got = np.frombuffer(out, "<u4").reshape(-1, 5, 8)
    assert np.array_equal(got, digits_to_limbs(want))


def test_source_hash_covers_every_source():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    names = sorted(p.name for p in _build.CSRC.glob("*.cu*"))
    assert names == ["field.cuh", "mma_tile.cuh", "perm.cu", "perm.cuh", "perm_hyb.cu",
                     "perm_hyb.cuh", "perm_hyb13.cu", "perm_hyb_block.cuh", "perm_mxu.cu",
                     "perm_mxu8.cu", "perm_mxu8.cuh"]


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


# Stands in for nvcc: logs its arguments, creates the file after -o, and
# fails for a source named in FAIL_ON.
FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$(dirname "$0")/calls.log"
for a in "$@"; do case "$a" in *"$FAIL_ON") echo "error in $a"; exit 2;; esac; done
while [ $# -gt 0 ]; do [ "$1" = "-o" ] && : > "$2"; shift; done
echo "ptxas info    : Used 8 registers"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "calls.log"


def test_build_runs_one_nvcc_per_source_then_links(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "no-such-source")
    lib, report = _build.build()
    calls = fake_nvcc.read_text().splitlines()
    sources = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    compiles, link = calls[:-1], calls[-1]
    assert sorted(c.split()[-1] for c in compiles) == sources
    assert all(" -c -o " in c and "arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert link.startswith("-shared -o ") and link.count(".o") == len(sources)
    assert lib.exists() and report.count("Used 8 registers") == len(sources) + 1
    assert sorted(lib.parent.iterdir()) == sorted([lib, lib.with_suffix(".log")])
    assert _build.build() == (lib, report)  # built once for these sources
    assert len(fake_nvcc.read_text().splitlines()) == len(calls)


def test_build_failure_raises_and_leaves_nothing(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "perm_mxu8.cu")
    with pytest.raises(RuntimeError, match=r"exit code 2 \(perm_mxu8\.cu\):\nerror in"):
        _build.build()
    assert list((fake_nvcc.parent / "build").iterdir()) == []


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


def test_chip_smoke_cipher_oracle_agrees_with_the_port():
    rng = np.random.default_rng(5)
    key = torch.from_numpy(chip_smoke.random_elements((2, 2), rng))
    nonce = torch.from_numpy(chip_smoke.random_elements((2,), rng))
    msgs = torch.from_numpy(chip_smoke.random_elements((2, 6), rng))
    ct, tag = cipher.encrypt(key, nonce, msgs, chip_smoke.plain_mont_fn("mxu8"))
    for i in range(2):
        want_ct, want_tag = chip_smoke.int_cipher(list(digits_to_ints(key[i].numpy())),
                                                  int(digits_to_ints(nonce[i].numpy())),
                                                  list(digits_to_ints(msgs[i].numpy())))
        assert list(digits_to_ints(ct[i].numpy())) == want_ct
        assert int(digits_to_ints(tag[i].numpy())) == want_tag


def test_chip_smoke_path_walk_agrees_with_the_port():
    rng = np.random.default_rng(6)
    leaves = torch.from_numpy(chip_smoke.random_elements((50,), rng))
    levels = merkle.merkle_levels(leaves, chip_smoke.plain_mont_fn("hybp"))
    root = int(digits_to_ints(field.from_mont(levels[-1][0]).numpy()))
    assert root == chip_smoke.int_merkle_root(list(digits_to_ints(leaves.numpy())) + [0] * 14)
    sibs, poss = merkle.merkle_open_batched(levels, [49, 7])
    for row, leaf in zip(range(2), (49, 7)):
        siblings = [list(digits_to_ints(g)) for g in field.from_mont(sibs[row]).numpy()]
        walk = chip_smoke.int_merkle_walk(int(digits_to_ints(leaves[leaf].numpy())), siblings,
                                          poss[row].tolist())
        assert walk == root
        assert chip_smoke.int_merkle_walk(1 + int(digits_to_ints(leaves[leaf].numpy())),
                                          siblings, poss[row].tolist()) != root


@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
def test_chip_smoke_bound(schedule):
    one, many = chip_smoke.bound(schedule, 1 << 14), chip_smoke.bound(schedule, 1 << 18)
    parts = ("tensor_ms", "cores_ms", "bytes_ms")
    assert one["bound_ms"] == max(one[k] for k in parts) > 0
    assert one["bound_by"] in ("bytes", "operations")
    # operations scale with the batch; the tables' bytes do not
    assert many["cores_ms"] == pytest.approx(16 * one["cores_ms"])
    assert many["bytes_ms"] < 16 * one["bytes_ms"]
    assert (one["tensor_ms"] > 0) == (schedule not in ("naive", "opt"))
    mxu8 = chip_smoke.bound("mxu8", 1 << 14)
    if schedule in ("hyb", "hybp"):
        # 401 REDCs against mxu8's 632; the chain's dots outweigh the MDS dots they replace
        assert one["cores_ms"] < mxu8["cores_ms"] and one["tensor_ms"] > mxu8["tensor_ms"]
    if schedule == "mxu":
        # mxu8's work, its dots at the bf16 rate, half the int8 one
        assert one["cores_ms"] == mxu8["cores_ms"] and one["bytes_ms"] == mxu8["bytes_ms"]
        assert one["tensor_ms"] == pytest.approx(mxu8["tensor_ms"] * 1979 / 989)
    if schedule.endswith("13"):
        # the same dots and tables; 99 S-boxes of 1,420 operations in place of 192
        base = chip_smoke.bound(schedule.removesuffix("13"), 1 << 14)
        assert one["tensor_ms"] == base["tensor_ms"] and one["bytes_ms"] == base["bytes_ms"]
        extra = 99 * (1420 - 192) * (1 << 14) / chip_smoke.INT32_OPS_PER_S * 1e3
        assert one["cores_ms"] - base["cores_ms"] == pytest.approx(extra)


def test_chip_smoke_damage_leaves_the_level_below_whole(tmp_path):
    """The damage chip_smoke does between the resumes: the files above
    CKPT_KEEP go, CKPT_KEEP's own is cut short and so ignored, and a resume
    recomputes the levels from CKPT_KEEP - 1 up."""
    from hades252_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(8)
    leaves = torch.from_numpy(chip_smoke.random_elements((4 ** 5,), rng))
    d = str(tmp_path / "ckpt")
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return chip_smoke.plain_mont_fn("opt")(x)

    root = checkpoint.merkle_root_checkpointed(leaves, d, fn)
    assert calls == [256, 64, 16, 4, 1]
    chip_smoke.damage(d, 5)
    keep = chip_smoke.CKPT_KEEP
    assert checkpoint.highest_saved_level(d, 5, 4 ** 5) == keep - 1
    calls.clear()
    assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, d, fn), root)
    assert calls == [4 ** (5 - keep), 1] and checkpoint.highest_saved_level(d, 5, 4 ** 5) == 5


def test_chip_smoke_names_the_host_cpu():
    name = chip_smoke.cpu_model()
    assert isinstance(name, str) and name.strip()


def test_chip_smoke_lists_every_kernel():
    assert set(chip_smoke.SOURCES) == set(chip_smoke.REPLACES) == set(perm_cuda.SCHEDULES)
    root = _build.CSRC.parents[2]
    for schedule in perm_cuda.SCHEDULES:
        src = root / chip_smoke.SOURCES[schedule]
        assert src.exists() and f"hades_perm_{schedule}_launch" in src.read_text()
        assert chip_smoke.REPLACES[schedule].startswith("hades252_tpu/ops/perm_pallas.py:")
