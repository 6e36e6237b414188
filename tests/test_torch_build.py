"""The kernels' build helpers, the carry-chain arithmetic and the base-2^13
S-box of `field.cuh` and the per-state code of `perm.cuh` (a lane group's
lanes run in turn), `perm_dense.cuh` and `perm_hybp.cuh` (the producer's jobs
run in sequence) compiled for the host, and the independent oracles of
`chip_smoke.py`, all on the CPU."""

import contextlib
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import chip_smoke
from hades252_tpu_torch import field, selftest
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import _build, perm_cuda
from hades252_tpu_torch.params import P, digits_to_limbs, int_to_digits, mxu8_tables
from hades252_tpu_torch.utils import roofline
from hades252_tpu_torch.utils.encoding import digits_to_ints

torch.set_num_threads(1)

# Runs the per-state permutation over states given as 32-bit limbs:
# harness TABLES STATES SCHEDULE(the index in perm_cuda.SCHEDULES: 0 naive, 1 opt,
# 2 mxu8, 3 hyb, 4 hybp, 5 mxu, 6 hyb13, 7 hybp13) CONVERT CONSTS WEIGHTS [CHAIN
# or, for mxu, W_LIN_BF16] -> limbs on stdout. mxu8 and mxu run perm_dense.cuh
# (the reductions and the S-box on field.cuh's carry chains) with its host dot, a
# plain loop over w_lin in the MMA's place: bytes for mxu8, bf16 with float sums
# for mxu, as their kernels read it. naive and opt run a group of HADES_GROUP lanes
# (default 4; the kernels run 4, 2 or 1 by the batch) a state, the lanes in turn and
# the shuffles as array reads. The chained schedules run perm_hybp.cuh, the
# consumer's code of their kernel, with each of the producer's jobs run at the
# signal that allows it, from hyb's table (each round's whole dot: hyb, hyb13) or
# hybp's (the split: hybp, hybp13); hyb13 and hybp13 take field.cuh's sbox13.
# HARNESS13 runs the base-2^13 products alone: to13 and mul13 over pairs of
# 8-limb values -> the 20 digits of the first, its square and the product; then
# sbox and sbox13 of the first.
HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "perm.cuh"
#include "perm_hybp.cuh"
#include "perm_dense.cuh"
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
  const bool split = schedule == 4 || schedule == 7;
  if (chained) chain = read_file<uint8_t>(argv[7]);
  std::vector<uint16_t> lin_bf16;
  if (schedule == 5) lin_bf16 = read_file<uint16_t>(argv[7]);
  if (schedule == 5 && (int)lin_bf16.size() != mxu8::kLinBytes) return 4;
  if ((int)consts.size() != (chained ? hybp::kConstWords : mxu8::kConstWords) ||
      (int)weights.size() != mxu8::kWeightBytes ||
      (chained && (int)chain.size() != hybp::chain_bytes(split)))
    return 4;
  const uint32_t* src = tables.data();
  for (int j = 0; j < kLimbs; ++j) if (src[j] != p_limb(j)) return 2;
  src += kLimbs;
  TAKE(g_r2) TAKE(g_ark) TAKE(g_mds) TAKE(g_ark_fr) TAKE(g_c0) TAKE(g_u) TAKE(g_w)
  TAKE(g_m) TAKE(g_d) TAKE(g_final)
  if (src != tables.data() + tables.size()) return 3;
  const int group = getenv("HADES_GROUP") ? atoi(getenv("HADES_GROUP")) : 4;
  for (size_t b = 0; b * 40 < states.size(); ++b) {
    uint32_t s[kWidth][kLimbs];
    memcpy(s, &states[b * 40], sizeof(s));
    if (split) {
      // the consumer's code, with the producer's jobs run at their signals
      hybp::HostDot<true> dot{{weights.data()}, chain.data()};
      if (schedule == 7) hybp::perm<true>(dot, s, consts.data(), convert != 0);
      else hybp::perm<false>(dot, s, consts.data(), convert != 0);
    }
    else if (chained) {
      // the same block without the split: each round's whole dot a job
      hybp::HostDot<false> dot{{weights.data()}, chain.data()};
      if (schedule == 6) hybp::perm<true>(dot, s, consts.data(), convert != 0);
      else hybp::perm<false>(dot, s, consts.data(), convert != 0);
    }
    else if (schedule == 2) {
      dense::HostDot<> lin{weights.data()};
      dense::perm(lin, s, consts.data(), convert != 0);
    }
    else if (schedule == 5) {
      dense::HostDot<uint16_t> lin{lin_bf16.data()};
      dense::perm(lin, s, consts.data(), convert != 0);
    }
    else {
      // naive (dense) or opt: the lanes of a group in turn; their copies of
      // word 4 must agree
      const bool dense = schedule == 0;
      const bool same = group == 4 ? (dense ? perm_lanes_host<4, true>(s, convert != 0)
                                            : perm_lanes_host<4, false>(s, convert != 0))
                      : group == 2 ? (dense ? perm_lanes_host<2, true>(s, convert != 0)
                                            : perm_lanes_host<2, false>(s, convert != 0))
                                   : (dense ? perm_lanes_host<1, true>(s, convert != 0)
                                            : perm_lanes_host<1, false>(s, convert != 0));
      if (!same) return 5;
    }
    memcpy(&states[b * 40], s, sizeof(s));
  }
  fwrite(states.data(), 4, states.size(), stdout);
  return 0;
}
"""


HARNESS13 = r"""
#include <cstdio>
#include <vector>
#include "field.cuh"
using namespace hades;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  for (size_t i = 0; i + 16 <= v.size(); i += 16) {
    uint32_t a[kD13], b[kD13], sq[16], pr[16], x5[8], y5[8];
    to13(a, &v[i]);
    to13(b, &v[i + 8]);
    mul13<true>(sq, a, a);
    mul13<false>(pr, a, b);
    sbox(x5, &v[i]);
    sbox13(y5, &v[i]);
    fwrite(a, 4, kD13, stdout);
    fwrite(sq, 4, 16, stdout);
    fwrite(pr, 4, 16, stdout);
    fwrite(x5, 4, 8, stdout);
    fwrite(y5, 4, 8, stdout);
  }
  return 0;
}
"""


# The carry-chain arithmetic of field.cuh alone, over pairs (a, b) of 8-limb
# values: mul_wide8 (16 limbs), sqr_wide8 of a (16), redc_steps<16> of a b in
# place (16), mont_mul (8), mont_sqr of a (8), add_mod (8), and redc_steps<17>
# of a b with a 17th limb of a's low 6 bits (17).
HARNESS_FIELD = r"""
#include <cstdio>
#include <vector>
#include "field.cuh"
using namespace hades;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  for (size_t i = 0; i + 16 <= v.size(); i += 16) {
    uint32_t t[16], s[16], r[16], m[8], q[8], a[8], u[17];
    mul_wide8(t, &v[i], &v[i + 8]);
    sqr_wide8(s, &v[i]);
    for (int j = 0; j < 16; ++j) r[j] = u[j] = t[j];
    redc_steps<16>(r);
    mont_mul(m, &v[i], &v[i + 8]);
    mont_sqr(q, &v[i]);
    add_mod(a, &v[i], &v[i + 8]);
    u[16] = v[i] & 63u;
    redc_steps<17>(u);
    fwrite(t, 4, 16, stdout);
    fwrite(s, 4, 16, stdout);
    fwrite(r, 4, 16, stdout);
    fwrite(m, 4, 8, stdout);
    fwrite(q, 4, 8, stdout);
    fwrite(a, 4, 8, stdout);
    fwrite(u, 4, 17, stdout);
  }
  return 0;
}
"""


# field.cuh's fermat_invert over 8-limb values: harness IN MONT_IN -> 8 limbs
# a value on stdout.
HARNESS_INV = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "field.cuh"
using namespace hades;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  const bool mont_in = atoi(argv[2]) != 0;
  for (size_t i = 0; i + kLimbs <= v.size(); i += kLimbs) {
    uint32_t r[kLimbs];
    fermat_invert(r, &v[i], mont_in);
    fwrite(r, 4, kLimbs, stdout);
  }
  return 0;
}
"""


# field.cuh's mont_convert (the body of hades_field_convert) over 8-limb
# values: harness IN TO(1: into the Montgomery form, 0: out of it) -> 8 limbs
# a value on stdout.
HARNESS_CONV = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "field.cuh"
using namespace hades;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  const bool to = atoi(argv[2]) != 0;
  for (size_t i = 0; i + kLimbs <= v.size(); i += kLimbs) {
    uint32_t r[kLimbs];
    if (to) {
      mont_convert<true>(r, &v[i]);
    } else {
      mont_convert<false>(r, &v[i]);
    }
    fwrite(r, 4, kLimbs, stdout);
  }
  return 0;
}
"""


# field.cuh's new sub_mod and field_arith, the per-element bodies of
# hades_field_arith (field_arith.cu), over pairs of 8-limb values: harness IN
# -> for each pair field_arith<kArithMul>, <kArithAdd>, <kArithSub> and
# sub_mod, 8 limbs each, on stdout.
HARNESS_ARITH = r"""
#include <cstdio>
#include <vector>
#include "field.cuh"
using namespace hades;
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> v;
  uint32_t w;
  while (fread(&w, 4, 1, f) == 1) v.push_back(w);
  fclose(f);
  for (size_t i = 0; i + 2 * kLimbs <= v.size(); i += 2 * kLimbs) {
    uint32_t r[4][kLimbs];
    field_arith<kArithMul>(r[0], &v[i], &v[i + kLimbs]);
    field_arith<kArithAdd>(r[1], &v[i], &v[i + kLimbs]);
    field_arith<kArithSub>(r[2], &v[i], &v[i + kLimbs]);
    sub_mod(r[3], &v[i], &v[i + kLimbs]);
    fwrite(r, 4, 4 * kLimbs, stdout);
  }
  return 0;
}
"""


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    return cxx


@pytest.fixture(scope="module")
def harness13(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness13")
    (d / "h.cpp").write_text(HARNESS13)
    subprocess.run([_cxx(), "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(d / "h"), str(d / "h.cpp")], check=True, timeout=300)
    return d / "h"


def _run13(harness13, pairs, path):
    """HARNESS13 over (a, b) pairs: per pair a row of the 20 digits of a, a^2,
    a b, sbox(a) and sbox13(a)."""
    limbs = [[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for pair in pairs for x in pair]
    np.asarray(limbs, "<u4").tofile(path)
    out = subprocess.run([str(harness13), str(path)], capture_output=True, check=True,
                         timeout=60).stdout
    return np.frombuffer(out, "<u4").reshape(len(pairs), 20 + 16 + 16 + 8 + 8)


def test_base13_products_on_host_are_exact(harness13, tmp_path):
    """to13 and mul13 (the S-box body of hyb13 and hybp13) compiled for the
    host, on canonical values, on un-normalised ones just below 2p, and on
    the limits of 256 bits."""
    rng = np.random.default_rng(9)
    vals = [0, 1, P - 1, P, 2 * P - 1, 2 * P - 2, (1 << 256) - 1, (1 << 255) + 1]
    vals += [int.from_bytes(rng.bytes(32), "little") % (2 * P) for _ in range(24)]
    pairs = list(zip(vals, reversed(vals)))
    rows = _run13(harness13, pairs, tmp_path / "in.bin")
    for (x, y), row in zip(pairs, rows):
        assert [int(d) for d in row[:20]] == [(x >> (13 * k)) & 0x1FFF for k in range(20)]
        assert sum(int(v) << (32 * i) for i, v in enumerate(row[20:36])) == x * x
        assert sum(int(v) << (32 * i) for i, v in enumerate(row[36:52])) == x * y


@pytest.mark.parametrize("x", [0, 1, P - 1, (P + 1) // 2, 1 << 254, "seeded"])
def test_sbox13_on_host_equals_sbox(harness13, tmp_path, x):
    """field.cuh's sbox13 (the S-box of the hyb13 and hybp13 kernels: the raw
    products in base-2^13 digits, each reduced at once) against its sbox and
    the int x^5 R^-4 mod p (a Montgomery-domain x^5), bit for bit."""
    rng = np.random.default_rng(15)
    vals = ([int.from_bytes(rng.bytes(32), "little") % P for _ in range(16)] if x == "seeded"
            else [x])
    rows = _run13(harness13, [(v, v) for v in vals], tmp_path / "in.bin")
    rinv = pow(1 << 256, -1, P)
    for v, row in zip(vals, rows):
        assert np.array_equal(row[52:60], row[60:68])
        assert sum(int(w) << (32 * i) for i, w in enumerate(row[60:68])) == v ** 5 * rinv ** 4 % P


def test_field_chains_on_host_are_exact(tmp_path):
    """The product, the squaring and the special-p reduction of field.cuh,
    whose steps are single PTX instructions on the card and plain C with the
    carry in a variable here: 0, 1, p - 1, limb edges and random values, and
    the raw products also on the limits of 256 bits."""
    from hades252_tpu_torch.params import P

    (tmp_path / "h.cpp").write_text(HARNESS_FIELD)
    subprocess.run([_cxx(), "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(tmp_path / "h"), str(tmp_path / "h.cpp")], check=True, timeout=300)
    rng = np.random.default_rng(10)
    r = 1 << 256
    edge = [0, 1, P - 1, P - 2, 2, (1 << 32) - 1, 1 << 32, 1 << 64]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(120)]
    canonical = [(a, b) for a in edge for b in edge] + list(zip(vals, reversed(vals)))
    wide = [r - 1, P, 2 * P - 1, (1 << 255) + 1]
    pairs = canonical + [(a, b) for a in wide for b in wide + edge[:4]]
    limbs = [[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for pair in pairs for x in pair]
    np.asarray(limbs, "<u4").tofile(tmp_path / "in.bin")
    out = subprocess.run([str(tmp_path / "h"), str(tmp_path / "in.bin")], capture_output=True,
                         check=True, timeout=60).stdout
    rows = np.frombuffer(out, "<u4").reshape(len(pairs), 16 + 16 + 16 + 8 + 8 + 8 + 17)

    def value(limbs):
        return sum(int(v) << (32 * i) for i, v in enumerate(limbs))

    rinv = pow(r, -1, P)
    for k, ((a, b), row) in enumerate(zip(pairs, rows)):
        assert value(row[:16]) == a * b
        assert value(row[16:32]) == a * a
        if a * b < r * P:
            # the quotient q with q R = T + M p for some 0 <= M < R
            for t, q in ((a * b, value(row[40:48])),
                         (a * b + ((a & 63) << 512), value(row[80:89]))):
                assert (q * r - t) % P == 0 and 0 <= (q * r - t) // P < r
        if k < len(canonical):
            assert value(row[48:56]) == a * b * rinv % P
            assert value(row[56:64]) == a * a * rinv % P
            assert value(row[64:72]) == (a + b) % P


@pytest.fixture(scope="module")
def harness_inv(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness_inv")
    (d / "h.cpp").write_text(HARNESS_INV)
    subprocess.run([_cxx(), "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(d / "h"), str(d / "h.cpp")], check=True, timeout=300)
    return d / "h"


_R = 1 << 256
_SEEDED_X = int.from_bytes(np.random.default_rng(19).bytes(32), "little") % P
#: the kernel's inputs: seeded canonical elements, the edges, R and R^2 mod p
#: (the Montgomery forms of 1 and of R), DEEP's x - point where the point is
#: x itself (0, which Fermat maps to 0), 2 and its inverse (p + 1) / 2, the
#: exponent p - 2 itself, and the largest power of two below p
INV_INPUTS = {
    "seeded": [int.from_bytes(np.random.default_rng(17).bytes(32), "little") % P
               for _ in range(24)],
    "zero": [0], "one": [1], "p_minus_1": [P - 1], "r_mod_p": [_R % P],
    "r2_mod_p": [_R * _R % P], "x_minus_point_zero": [(_SEEDED_X - _SEEDED_X) % P],
    "two": [2], "half": [(P + 1) // 2], "p_minus_2": [P - 2],
    "top_power_of_two": [1 << (P.bit_length() - 1)],
}


@pytest.mark.parametrize("inputs", INV_INPUTS)
@pytest.mark.parametrize("mont_in", [0, 1])
def test_fermat_invert_on_host_matches_pow(harness_inv, tmp_path, inputs, mont_in):
    """field.cuh's fermat_invert (the body of hades_field_invert) compiled
    for the host: a^(p-2) mod p in the Montgomery form, for a canonical or
    Montgomery-form a, against Python's pow."""
    vals = INV_INPUTS[inputs]
    given = [v * _R % P if mont_in else v for v in vals]
    limbs = [[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for x in given]
    np.asarray(limbs, "<u4").tofile(tmp_path / "in.bin")
    out = subprocess.run([str(harness_inv), str(tmp_path / "in.bin"), str(mont_in)],
                         capture_output=True, check=True, timeout=60).stdout
    rows = np.frombuffer(out, "<u4").reshape(len(vals), 8)
    for v, row in zip(vals, rows, strict=True):
        inv = pow(v, P - 2, P)
        assert sum(int(w) << (32 * i) for i, w in enumerate(row)) == inv * _R % P


@pytest.fixture(scope="module")
def harness_conv(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness_conv")
    (d / "h.cpp").write_text(HARNESS_CONV)
    subprocess.run([_cxx(), "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(d / "h"), str(d / "h.cpp")], check=True, timeout=300)
    return d / "h"


#: the conversion's inputs: seeded canonical elements, the edges, R mod p (the
#: Montgomery form of 1) and the largest 256-bit value, which the product by
#: a constant below p also reduces
CONV_INPUTS = {
    "seeded": [int.from_bytes(np.random.default_rng(21).bytes(32), "little") % P
               for _ in range(24)],
    "zero": [0], "one": [1], "p_minus_1": [P - 1], "r_mod_p": [_R % P], "top": [_R - 1],
}


@pytest.mark.parametrize("inputs", CONV_INPUTS)
@pytest.mark.parametrize("to", [1, 0])
def test_mont_convert_on_host_matches_int_oracle(harness_conv, tmp_path, inputs, to):
    """field.cuh's mont_convert (the body of hades_field_convert) compiled
    for the host: a R mod p into the Montgomery form and a R^-1 mod p out of
    it, against Python's ints, and the same as field.py's torch ops."""
    vals = CONV_INPUTS[inputs]
    limbs = [[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for x in vals]
    np.asarray(limbs, "<u4").tofile(tmp_path / "in.bin")
    out = subprocess.run([str(harness_conv), str(tmp_path / "in.bin"), str(to)],
                         capture_output=True, check=True, timeout=60).stdout
    rows = np.frombuffer(out, "<u4").reshape(len(vals), 8)
    factor = _R % P if to else pow(_R, -1, P)
    got = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in rows]
    assert got == [v * factor % P for v in vals]
    digits = torch.from_numpy(np.stack([int_to_digits(v) for v in vals]).astype(np.int32))
    plain = (field.to_mont if to else field.from_mont)(digits)
    assert [int(v) for v in digits_to_ints(plain.numpy().astype(np.uint32))] == got


@pytest.fixture(scope="module")
def harness_arith(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness_arith")
    (d / "h.cpp").write_text(HARNESS_ARITH)
    subprocess.run([_cxx(), "-O1", "-std=c++17", "-w", f"-I{_build.CSRC}", "-o",
                    str(d / "h"), str(d / "h.cpp")], check=True, timeout=300)
    return d / "h"


_ARITH_RNG = np.random.default_rng(23)
#: the element-wise kernel's operand pairs: 0, 1 and p - 1 against each
#: other, a pair whose sum crosses p, one whose difference borrows (and its
#: mirror, which does not), R mod p (the Montgomery form of 1) by seeded
#: values, and seeded pairs
ARITH_PAIRS = {
    "edges": [(a, b) for a in (0, 1, P - 1) for b in (0, 1, P - 1)],
    "sum_crosses_p": [(P - 5, 9), ((P + 1) // 2, (P + 1) // 2)],
    "difference_borrows": [(3, 7), (7, 3), (0, P - 1), ((1 << 255) % P, (1 << 255) % P + 1)],
    "mont_one": [(_R % P, int.from_bytes(_ARITH_RNG.bytes(32), "little") % P) for _ in range(4)],
    "seeded": [(int.from_bytes(_ARITH_RNG.bytes(32), "little") % P,
                int.from_bytes(_ARITH_RNG.bytes(32), "little") % P) for _ in range(12)],
}


@pytest.mark.parametrize("pairs", ARITH_PAIRS)
def test_field_arith_on_host_matches_int_oracle(harness_arith, tmp_path, pairs):
    """field.cuh's field_arith (the bodies of hades_field_arith: mont_mul,
    add_mod and the new sub_mod) compiled for the host, against Python's
    ints: a b R^-1, a + b and a - b mod p; sub_mod alone gives field_arith's
    difference; and the same as field.py's torch ops."""
    vals = ARITH_PAIRS[pairs]
    limbs = [[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for pair in vals for x in pair]
    np.asarray(limbs, "<u4").tofile(tmp_path / "in.bin")
    out = subprocess.run([str(harness_arith), str(tmp_path / "in.bin")], capture_output=True,
                         check=True, timeout=60).stdout
    rows = np.frombuffer(out, "<u4").reshape(len(vals), 4, 8)
    got = [[sum(int(w) << (32 * i) for i, w in enumerate(r)) for r in row] for row in rows]
    rinv = pow(_R, -1, P)
    assert got == [[a * b * rinv % P, (a + b) % P, (a - b) % P, (a - b) % P] for a, b in vals]
    da, db = (torch.from_numpy(np.stack([int_to_digits(v[k]) for v in vals]).astype(np.int32))
              for k in (0, 1))
    plain = [field.mont_mul(da, db), field.add_mod(da, db), field.sub_mod(da, db)]
    assert [[int(v) for v in digits_to_ints(x.numpy().astype(np.uint32))] for x in plain] == \
        [list(col) for col in zip(*got)][:3]


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
    w_lin = torch.from_numpy(mxu8_tables()["w_lin"])
    perm_cuda.widen_bf16(w_lin).numpy().tofile(d / "mxu_chain.bin")  # w_lin as bf16, row-major
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


@pytest.mark.parametrize("schedule", ["mxu8", "mxu"])
@pytest.mark.parametrize("convert", [True, False])
def test_dense_math_on_host_takes_edge_states(harness, schedule, convert):
    """perm_dense.cuh, the per-state code of the mxu8 and mxu kernels, on the
    states at the ends of the field: all 0, all p - 1, p - 1 beside 0 and 1,
    and words that drive x^2 and x^4 of the S-box near p, against the int
    oracle (for convert=False the inputs and outputs are Montgomery-domain)."""
    from hades252_tpu_torch.strategy import ScalarStrategy

    r = (1 << 256) % P
    states = [[0] * 5, [P - 1] * 5, [P - 1, 0, 1, P - 1, 0], [1, P - 2, (P + 1) // 2, 2, P - 1],
              [(1 << 255) % P, P - 1, 0, 0, P - 1]]
    strat = ScalarStrategy()
    if convert:
        want = [strat.perm(list(st)) for st in states]  # perm works in place
    else:
        rinv = pow(r, -1, P)
        want = [[v * r % P for v in strat.perm([w * rinv % P for w in st])] for st in states]
    limbs = [[(w >> (32 * i)) & 0xFFFFFFFF for w in st for i in range(8)] for st in states]
    path = harness / f"edge_{schedule}_{int(convert)}.bin"
    np.asarray(limbs, "<u4").tofile(path)
    out = subprocess.run(
        [str(harness / "harness"), str(harness / "tables.bin"), str(path),
         str(perm_cuda.SCHEDULES.index(schedule)), str(int(convert)),
         str(harness / "mxu8_consts.bin"), str(harness / "mxu8_weights.bin"),
         str(harness / f"{schedule}_chain.bin")],
        capture_output=True, check=True, timeout=300,
    ).stdout
    got = np.frombuffer(out, "<u4").reshape(len(states), 5, 8).astype(object)
    for row, st in zip(got, want):
        assert [sum(int(v) << (32 * i) for i, v in enumerate(word)) for word in row] == st


@pytest.mark.parametrize("schedule", ["mxu8", "mxu"])
def test_dense_weights_are_w_lin_in_wgmma_order(schedule):
    """perm_cuda.dense_kernel_tables, which the dense kernels stage into
    shared memory: w_lin alone, each 64-row block cut into 16-byte vectors,
    byte j of vector v of row r at v * 1024 + (r // 8) * 128 + (r % 8) * 16 + j
    (the order of wgmma's operand without swizzle); for mxu every byte widened
    to the bf16 of its value, little-endian. Unpacked, it is w_lin."""
    consts, packed = perm_cuda.dense_kernel_tables(schedule)
    w_lin = mxu8_tables()["w_lin"]
    assert np.array_equal(consts, perm_cuda.mxu8_kernel_tables()[0])
    width = 2 * 160 if schedule == "mxu" else 160
    assert packed.dtype == np.uint8 and packed.size == 320 * width
    at = np.arange(packed.size)
    blk, v = at // (64 * width), at % (64 * width) // 1024
    r, j = at % 1024 // 128 * 8 + at % 128 // 16, at % 16
    unpacked = np.zeros((320, width), np.uint8)
    unpacked[64 * blk + r, 16 * v + j] = packed
    if schedule == "mxu":
        bits = unpacked.view("<u2").astype(np.uint32) << 16
        unpacked = bits.view(np.float32)
        assert np.array_equal(unpacked, unpacked.round())
    assert np.array_equal(unpacked.astype(np.int64), w_lin.astype(np.int64))


def _run_lanes(harness, schedule, group, convert):
    """The harness's naive (0) or opt (1) on a group of `group` lanes over the
    128 KATs; the harness returns 5 where the lanes' copies of word 4
    disagree at the end."""
    inputs, expected, inputs_m, expected_m = selftest._vectors()
    x, want = (inputs, expected) if convert else (inputs_m, expected_m)
    states = harness / f"states_{schedule}_g{group}_{int(convert)}.bin"
    digits_to_limbs(x).astype("<u4").tofile(states)
    out = subprocess.run(
        [str(harness / "harness"), str(harness / "tables.bin"), str(states),
         str(perm_cuda.SCHEDULES.index(schedule)), str(int(convert)),
         str(harness / "mxu8_consts.bin"), str(harness / "mxu8_weights.bin")],
        capture_output=True, check=True, timeout=300, env={"HADES_GROUP": str(group)},
    ).stdout
    assert np.array_equal(np.frombuffer(out, "<u4").reshape(-1, 5, 8), digits_to_limbs(want))


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("convert", [True, False])
def test_opt_lane_groups_on_host_match_int_oracle(harness, group, convert):
    """perm_opt_lanes for every group size the kernel runs (4, 2 or 1 lanes a
    state, by the batch): the words spread over the lanes, the sum over the group and the
    all-gathers as array reads; every lane's copy of word 4 must agree."""
    _run_lanes(harness, "opt", group, convert)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("convert", [True, False])
def test_naive_lane_groups_on_host_match_int_oracle(harness, group, convert):
    """perm_naive_lanes, the dense schedule, for every group size its kernel
    runs: each lane's own words and word 4 through the ARK and the S-boxes,
    the all-gather as array reads, each lane's MDS rows; every lane's copy of
    word 4 must agree."""
    _run_lanes(harness, "naive", group, convert)


@pytest.mark.parametrize("split", [True, False])
def test_hybp_jobs_cover_their_rounds(split):
    """The producer's job table of perm_hybp.cuh, mirrored here. With the
    split (hybp), job q stops at the last older element of its round, and
    w_new holds what it leaves to the consumer's small dot; without it
    (hyb), job q holds its round's whole dot, the newest element included.
    Everything a job leaves out of the table's padded width is zero, and
    `job_k` matches the table."""
    from hades252_tpu_torch.params import hyb_tables, hybp_tables

    t = hybp_tables() if split else hyb_tables()
    seg1, seg2 = (t["wo_seg1"], t["wo_seg2"]) if split else (t["w_seg1"], t["w_seg2"])
    for q in range(59):
        w = seg1[q] if q < 27 else seg2[q - 27]
        elems = (6 if q == 0 else 5 + q) if split else 6 + q
        k = (32 * elems + 63) & ~63
        assert perm_cuda.job_k(q, split) == k
        assert k <= w.shape[1] and not w[:, k:].any() and not w[:, 32 * elems:].any()
        assert w[:, : 32 * elems].any()
        if split and q:
            assert not w[:, 32 * (5 + q): 32 * (6 + q)].any() and t["w_new"][q].any()
        if not split:
            assert w[:, 32 * (5 + q): 32 * (6 + q)].any()  # the newest element's weights
    assert all(perm_cuda.job_k(q, split) == 2112 for q in range(59, 64))
    assert t["w_out"].shape == (320, 2112)
    if split:
        assert not t["w_new"][0].any()


@pytest.mark.parametrize("split", [True, False])
def test_hybp_packed_weights_hold_every_job_in_stage_order(split):
    """perm_cuda.packed_weights, which the bulk copies of the hybp and hyb
    kernels read: job after job, K filled up with zeros to whole stages of
    256 bytes, byte k of row r of a job at (k // 16) * 1024 + (r // 8) * 128
    + (r % 8) * 16 + k % 16 (the operand order of the kernel's wgmma), so a
    stage's 16,384 bytes are contiguous."""
    from hades252_tpu_torch.params import hyb_tables, hybp_tables

    t = hybp_tables() if split else hyb_tables()
    seg1, seg2 = (t["wo_seg1"], t["wo_seg2"]) if split else (t["w_seg1"], t["w_seg2"])
    packed = perm_cuda.packed_weights("hybp" if split else "hyb")
    assert packed.dtype == np.uint8 and packed.flags.c_contiguous
    at = 0
    rng = np.random.default_rng(12)
    for q in range(64):
        w = (seg1[q] if q < 27 else seg2[q - 27] if q < 59
             else t["w_out"][64 * (q - 59): 64 * (q - 58)])
        k = perm_cuda.job_k(q, split)
        padded = -(-k // 256) * 256
        job = packed[at: at + 64 * padded]
        for r, kk in zip(rng.integers(0, 64, 200), rng.integers(0, padded, 200)):
            want = w[r, kk] if kk < k else 0
            assert job[(kk // 16) * 1024 + (r // 8) * 128 + (r % 8) * 16 + kk % 16] == want
        assert int(job.astype(np.int64).sum()) == int(w[:, :k].astype(np.int64).sum())
        at += 64 * padded
    assert at == packed.size and at % 16384 == 0


def test_hyb_takes_packed_weights_and_no_scratch(monkeypatch):
    """The chained kernels' tables and launches as the wrapper makes them (no
    card: the tables on the CPU, the library a stand-in that records its
    calls): hyb's tables with its packed jobs appended, no scratch tensor for
    any schedule, one signature for hyb, hybp, hyb13 and hybp13."""
    tables = perm_cuda._device_tables("hyb", torch.device("cpu"))
    assert len(tables) == 4 and tables[3].dtype == torch.uint8
    assert np.array_equal(tables[3].numpy(), perm_cuda.packed_weights("hyb"))
    assert tables[2].numel() == sum(v.size for v in perm_cuda.hyb_tables().values()
                                    if v.dtype == np.uint8)
    assert not np.array_equal(perm_cuda.packed_weights("hyb"), perm_cuda.packed_weights("hybp"))

    real = perm_cuda._device_tables
    monkeypatch.setattr(perm_cuda, "_device_tables",
                        lambda schedule, device: real(schedule, torch.device("cpu")))
    calls = {}

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls[name] = args
                return 0
            return launch

    monkeypatch.setattr(perm_cuda._build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(perm_cuda, "launches", dict.fromkeys(perm_cuda.SCHEDULES, 0))
    x = torch.zeros((5, 16, 3), dtype=torch.int32)
    chained = ("hyb", "hybp", "hyb13", "hybp13")
    for schedule in chained:
        perm_cuda._launch(x, torch.empty_like(x), convert=True, schedule=schedule)
    # x, out, B, convert; consts, weights, chain, packed; the stream
    for schedule in chained:
        args = calls[f"hades_perm_{schedule}_launch"]
        assert len(args) == 9 and args[2:4] == (3, 1) and args[-1] == 7
    assert calls["hades_perm_hyb_launch"][4:8] == tuple(t.data_ptr() for t in tables)
    assert calls["hades_perm_hyb13_launch"][4:8] == tuple(t.data_ptr() for t in tables)
    assert perm_cuda.launches == {**dict.fromkeys(perm_cuda.SCHEDULES, 0),
                                  **dict.fromkeys(chained, 1)}


@pytest.mark.parametrize("schedule", ["hyb13", "hybp13"])
def test_base13_schedules_take_the_base_schedules_tables(schedule):
    """hyb13 and hybp13 launch with hyb's and hybp's tables, packed jobs
    included (perm_pallas.py:1333-1342: the `13` schedules take the same
    constants); they differ from the other base's."""
    base = schedule.removesuffix("13")
    other = "hybp" if base == "hyb" else "hyb"
    cpu = torch.device("cpu")
    got, want = perm_cuda._device_tables(schedule, cpu), perm_cuda._device_tables(base, cpu)
    assert len(got) == len(want) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[3], perm_cuda._device_tables(other, cpu)[3])


def test_packed_weights_follow_the_base_schedule():
    """packed_weights decides the split from the base schedule: hybp13's
    jobs are hybp's, hyb13's hyb's, and the two tables differ."""
    hybp, hyb = perm_cuda.packed_weights("hybp"), perm_cuda.packed_weights("hyb")
    assert np.array_equal(perm_cuda.packed_weights("hybp13"), hybp)
    assert np.array_equal(perm_cuda.packed_weights("hyb13"), hyb)
    assert not np.array_equal(hybp, hyb)
    with pytest.raises(ValueError):
        perm_cuda.packed_weights("mxu8")


def test_source_hash_covers_every_source():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    names = sorted(p.name for p in _build.CSRC.glob("*.cu*"))
    assert names == ["field.cuh", "field_arith.cu", "field_conv.cu", "field_inv.cu", "perm.cu",
                     "perm.cuh", "perm_dense.cuh", "perm_dense_block.cuh", "perm_hybp.cu",
                     "perm_hybp.cuh", "perm_mxu.cu", "perm_mxu8.cu", "perm_mxu8.cuh", "wgmma.cuh"]


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


@pytest.mark.parametrize("layout", ["rows", "column", "padded"])
def test_chip_smoke_convert_inputs(layout):
    """Phase 4b's conversion inputs: n elements in the layout the kernel's
    callers pass, the first three 0, 1 and p - 1, the rest below p."""
    x = chip_smoke.convert_inputs(1000, layout, np.random.default_rng(6), torch.device("cpu"))
    rows = {"rows": 1000, "column": 1000, "padded": 1024}[layout]
    assert x.shape == (rows, 16) and x.dtype == torch.int32
    assert x.stride(0) == (80 if layout == "column" else 16)
    vals = digits_to_ints(x.numpy())
    assert [int(v) for v in vals[:3]] == [0, 1, P - 1]
    assert all(int(v) < P for v in vals) and not x[1000:].any()


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
    one, many = roofline.bound(schedule, 1 << 14), roofline.bound(schedule, 1 << 18)
    parts = ("tensor_ms", "cores_ms", "bytes_ms")
    assert one["bound_ms"] == max(one[k] for k in parts) > 0
    assert one["bound_by"] in ("bytes", "operations")
    # operations scale with the batch; the tables' bytes do not
    assert many["cores_ms"] == pytest.approx(16 * one["cores_ms"])
    assert many["bytes_ms"] < 16 * one["bytes_ms"]
    assert (one["tensor_ms"] > 0) == (schedule not in ("naive", "opt"))
    mxu8 = roofline.bound("mxu8", 1 << 14)

    def cores_ms(ops):
        return ops * (1 << 14) / roofline.INT32_OPS_PER_S * 1e3

    if schedule == "mxu8":
        # 632 REDCs on the CUDA cores (81 operations each), 99 S-boxes of 136, the 10
        # conversion products, 2 adds a recombined column, the ARK; the tensor cores
        # keep the 67 MDS dots alone
        assert one["cores_ms"] == pytest.approx(cores_ms(113_586))
        assert one["tensor_ms"] == pytest.approx(
            2 * 67 * 315 * 160 * (1 << 14) / roofline.INT8_OPS_PER_S * 1e3)
    if schedule in ("hyb", "hybp"):
        # one block, split or not: 401 REDCs on the CUDA cores (81 operations each), 99
        # S-boxes of 136, the 10 conversion products, 2 adds a recombined column of the
        # 8 MDS dots and the 64 chain dots, the ARK and five 9-limb subtracts a chain
        # reduction; the tensor cores keep the MDS dots and the chain's, the same work
        # whether hybp's small dot is split off or not
        assert one["cores_ms"] == pytest.approx(cores_ms(63_929))
        assert one["cores_ms"] < mxu8["cores_ms"]
        chain = sum(63 * 32 * (6 + r) for r in range(59)) + 315 * 2080
        assert one["tensor_ms"] == pytest.approx(
            2 * (8 * 315 * 160 + chain) * (1 << 14) / roofline.INT8_OPS_PER_S * 1e3)
        other = roofline.bound("hybp" if schedule == "hyb" else "hyb", 1 << 14)
        assert one["tensor_ms"] == other["tensor_ms"] and one["cores_ms"] == other["cores_ms"]
    if schedule in ("naive", "opt"):
        # 198 of the products are the S-boxes' squares: 36 raw products, not 64
        products, adds = (1982, 1675) if schedule == "naive" else (1054, 984)
        ops = 136 * products - 28 * 198 + 16 * adds
        assert one["cores_ms"] == pytest.approx(ops * (1 << 14) / roofline.INT32_OPS_PER_S * 1e3)
    if schedule == "mxu":
        # mxu8's work, its dots at the bf16 rate, half the int8 one; w_lin read as bf16
        assert one["cores_ms"] == mxu8["cores_ms"]
        assert one["tensor_ms"] == pytest.approx(mxu8["tensor_ms"] * 1979 / 989)
        assert one["bytes_ms"] - mxu8["bytes_ms"] == pytest.approx(
            320 * 160 / roofline.HBM_BYTES_PER_S * 1e3)
    if schedule.endswith("13"):
        # hyb's and hybp's block with 99 S-boxes of 1,420 operations in place of 136:
        # 191,045 operations a state on the cores, the same for both; the tensor cores
        # and the bytes are their base's
        base = roofline.bound(schedule.removesuffix("13"), 1 << 14)
        assert one["cores_ms"] == pytest.approx(cores_ms(191_045))
        assert one["cores_ms"] == pytest.approx(cores_ms(63_929 + 99 * (1420 - 136)))
        assert one["tensor_ms"] == base["tensor_ms"] and one["bytes_ms"] == base["bytes_ms"]
        other = roofline.bound("hybp13" if schedule == "hyb13" else "hyb13", 1 << 14)
        assert one["cores_ms"] == other["cores_ms"] and one["tensor_ms"] == other["tensor_ms"]


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
