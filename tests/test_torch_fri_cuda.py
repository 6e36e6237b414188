"""The port's device-resident succinct prover (`hades252_tpu_torch.fri_cuda`,
the counterpart of `hades252_tpu/fri_tpu.py:93-1179`) against the JAX
package, on the CPU.

Each body gets the same seeded inputs as its JAX twin; where the JAX
function is a jitted program whose XLA:CPU compile costs more than the test
(`_inv_mont_dev`, `_eval_rows_dev`), it is held to the host big-int
definition the JAX tests use instead. The whole prover, plain and zk, at
B = 1 and 3 with an rng an instance, gives proofs whose bytes equal the
port's `fri.prove_succinct` and the JAX package's (through both packages'
`serialize`), and that verify. Tolerance: none; every digit, byte and nonce
must be equal.

Sizes are the JAX tests' (the two-gate circuit, blowup 4, 3 queries). The
plain PyTorch permutation takes about 0.7 s a call on a CPU, so the
prover's permutations run through the native engine on CPU tensors (the
same bits as the plain version and the kernels: tests/test_torch_native.py,
the KAT gate); `tests/test_torch_isolation.py` proves a tiny proof through
the plain version itself, with JAX blocked.
"""

import gc
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from hades252_tpu import fri as jfri
from hades252_tpu import fri_tpu as jfri_tpu
from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu import serialize as jser
from hades252_tpu_torch import fri, fri_cuda, gadget, plonk, serialize
from hades252_tpu_torch.params import P, R
from hades252_tpu_torch.utils import native
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its main does not run on import)

torch.set_num_threads(1)

JPERM = jfri.default_pcs_perm()
PERM = fri.default_pcs_perm()
CPU = torch.device("cpu")
PARAMS = dict(blowup=4, n_queries=3, final_degree=8)


def native_perm(states: torch.Tensor) -> torch.Tensor:
    """(B, 5, 16) int32 CPU states through the native engine."""
    out = native.perm_batch_digits(states.numpy().astype(np.uint32))
    return torch.from_numpy(out.astype(np.int32))


def jperm_rows(states):
    return np.asarray(JPERM(np.asarray(states, np.uint32)))


@pytest.fixture
def calls(monkeypatch):
    """The prover's kernel seam on the native engine: records the schedule
    and batch of every call."""
    seen = []

    def kernel(states, schedule):
        seen.append((schedule, states.shape[0]))
        return native_perm(states)

    monkeypatch.setattr(fri_cuda, "permute_cuda", kernel)
    return seen


def _ints(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _dev(vals, shape) -> torch.Tensor:
    return torch.from_numpy(ints_to_digits(vals, shape=shape).astype(np.int32))


def _rows(t: torch.Tensor) -> list:
    return digits_to_ints(t.numpy()).tolist()


def tiny(g, a_val: int = 3, b_val: int = 5):
    """The JAX tests' two-gate circuit, built with either package's gadget
    module: a * b, then a + b against a public input."""
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(1).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-(a_val + b_val)))
    return c


# -- constant tables ---------------------------------------------------------


def test_constant_tables_equal_the_jax_packages():
    params = dict(PARAMS, pow_bits=0)
    jpk, _ = jfri.preprocess_succinct(tiny(jgadget), jfri.FriParams(**params), JPERM)
    pk, _ = fri.preprocess_succinct(tiny(gadget), fri.FriParams(**params), PERM)
    assert np.array_equal(fri_cuda._xs_digits(64), jfri_tpu._xs_digits(64))
    for s in (1, 5, 9):
        assert np.array_equal(fri_cuda._pow_mont(64, s), jfri_tpu._pow_mont(64, s))
    for m, shift in ((64, fri.G0), (32, fri.G0 ** 2 % P)):
        assert np.array_equal(fri_cuda._xinv_mont(m, shift), jfri_tpu._xinv_mont(m, shift))
    assert np.array_equal(fri_cuda._scalar_mont((P + 1) // 2), jfri_tpu._scalar_mont((P + 1) // 2))
    assert np.array_equal(fri_cuda._pk_key_evals(pk), jfri_tpu._pk_key_evals(jpk))
    assert np.array_equal(fri_cuda._key_coeff_digits(pk), jfri_tpu._key_coeff_digits(jpk))


def test_constant_caches_are_bounded_and_weak():
    """The O(m0) tables are bounded caches (the JAX package's are
    unbounded); a proving key's tables and their device copies go with it."""
    for fn in (fri_cuda._xs_digits, fri_cuda._pow_mont, fri_cuda._xinv_mont,
               fri_cuda._on_device, fri_cuda.fri_phase_graph):
        assert fn.cache_info().maxsize is not None
    pk, _ = fri.preprocess_succinct(tiny(gadget), fri.FriParams(**PARAMS, pow_bits=0), PERM)
    tab = fri_cuda._pk_table(pk, fri_cuda._pk_key_evals, CPU)
    m0 = fri.proof_schema(pk.key.n, pk.params)["m0"]
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (10, m0, 16)
    assert fri_cuda._pk_table(pk, fri_cuda._pk_key_evals, CPU) is tab
    assert pk in fri_cuda._PK_HOST and pk in fri_cuda._PK_DEV
    n_host = len(fri_cuda._PK_HOST)
    del pk, tab
    gc.collect()
    assert len(fri_cuda._PK_HOST) == n_host - 1


# -- device trees --------------------------------------------------------------


@pytest.mark.parametrize("n_leaves", [16, 64])
def test_tree_levels_body_matches_jax_and_host(n_leaves):
    b = 2
    leaves = ints_to_digits(_ints(b * n_leaves, n_leaves), shape=(b, n_leaves))
    got = fri_cuda._tree_levels_body(torch.from_numpy(leaves.astype(np.int32)), native_perm,
                                     fri_cuda._node_tag(CPU))
    jax_levels = jfri_tpu._tree_levels_body(leaves, jperm_rows, pad_to=1)
    assert len(got) == len(jax_levels) == fri._tree_height(n_leaves) + 1
    for i in range(b):
        host = fri.tree_build_digits(leaves[i], PERM)
        for lvl, jlvl, hlvl in zip(got, jax_levels, host):
            assert np.array_equal(lvl[i].numpy(), hlvl)
            assert np.array_equal(lvl[i].numpy(), np.asarray(jlvl[i]))


@pytest.mark.parametrize("n_cols,m0", [(1, 32), (3, 32), (4, 128)])
def test_block_tree_body_matches_jax_and_host(n_cols, m0):
    """The paired-block tree (leaf sponges of 2C values, zero-padded to a
    power of 4, then the levels) against fri._commit_paired and the JAX
    body run eagerly on the native engine."""
    b = 2
    cols_int = [[_ints(m0, 10 * i + j) for j in range(n_cols)] for i in range(b)]
    cols = ints_to_digits(cols_int, shape=(b, n_cols, m0))
    got = fri_cuda._build_paired_levels(torch.from_numpy(cols.astype(np.int32)), native_perm)
    jax_levels = jfri_tpu._block_tree_body(
        np.asarray(jfri_tpu._paired_blocks_dev(cols)), jperm_rows, 1)
    for i in range(b):
        host = fri._commit_paired(cols_int[i], PERM)
        assert len(got) == len(host) == len(jax_levels)
        for lvl, jlvl, hlvl in zip(got, jax_levels, host):
            assert np.array_equal(lvl[i].numpy(), hlvl)
            assert np.array_equal(lvl[i].numpy(), np.asarray(jlvl[i]))
    assert fri_cuda._root_ints(got) == [fri.tree_root(fri._commit_paired(c, PERM)) for c in cols_int]


# -- gathers and openings ----------------------------------------------------------


def test_openings_match_host_and_jax():
    b, n_cols, m0 = 2, 2, 64
    cols_int = [[_ints(m0, 50 + 10 * i + j) for j in range(n_cols)] for i in range(b)]
    cols = ints_to_digits(cols_int, shape=(b, n_cols, m0))
    s_lists = [[1, 7, 30], [0, 2, 3, 17, 31]]
    levels = fri_cuda._build_paired_levels(torch.from_numpy(cols.astype(np.int32)), native_perm)
    blocks = fri_cuda._open_blocks_dev(torch.from_numpy(cols.astype(np.int32)), s_lists)
    nodes = fri_cuda._open_nodes_dev(levels, s_lists)
    jblocks = jfri_tpu._open_blocks_dev(cols, s_lists, 5)
    jnodes = jfri_tpu._open_nodes_dev([lv.numpy().astype(np.uint32) for lv in levels], s_lists)
    for i, s in enumerate(s_lists):
        host_levels = fri._commit_paired(cols_int[i], PERM)
        host_blocks, host_nodes = fri._open_paired(cols_int[i], host_levels, s)
        assert blocks[i] == host_blocks == jblocks[i]
        assert nodes[i].dtype == np.uint32
        assert np.array_equal(nodes[i], host_nodes) and np.array_equal(nodes[i], jnodes[i])
    # a one-level tree opens no node
    flat = [torch.zeros((b, 1, 16), dtype=torch.int32)]
    assert [n.shape for n in fri_cuda._open_nodes_dev(flat, [[0], [0]])] == [(0, 16), (0, 16)]


def test_layer_openings_match_host():
    """A committed FRI layer's opened blocks: block b holds
    cur[b + t * m_k/bs] (fri._fri_proof's layout)."""
    b, m_k, bs = 2, 32, 4
    cur_int = [_ints(m_k, 70 + i) for i in range(b)]
    s_lists = [[0, 3, 7], [5]]
    got = fri_cuda._open_layer_blocks(_dev(cur_int, (b, m_k)), bs, s_lists)
    npos = m_k // bs
    for i, s in enumerate(s_lists):
        assert got[i] == [[cur_int[i][p + t * npos] for t in range(bs)] for p in s]


# -- claimed evaluations, blinding, DEEP, inversion, folds --------------------------


def test_eval_rows_dev_matches_poly_eval():
    b, r, ln = 2, 3, 13  # an odd length pads the reduction
    coeffs = [[_ints(ln, 100 + 10 * i + j) for j in range(r)] for i in range(b)]
    pts = [_ints(r, 200 + i) for i in range(b)]
    got = _rows(fri_cuda._eval_rows_dev(_dev(coeffs, (b, r, ln)), _dev(pts, (b, r))))
    for i in range(b):
        for j in range(r):
            assert got[i][j] == plonk.poly_eval(coeffs[i][j], pts[i][j]) \
                == jplonk.poly_eval(coeffs[i][j], pts[i][j])


@pytest.mark.parametrize("n,k", [(4, 6), (8, 3)])
def test_blind_dev_matches_host_and_jax(n, k):
    """k > n overlaps the two shifted ranges (the tiny-circuit case)."""
    b = 2
    coeffs = [_ints(n, 300 + i) for i in range(b)]
    r = [_ints(k, 310 + i) for i in range(b)]
    got = _rows(fri_cuda._blind_dev(_dev(coeffs, (b, n)), _dev(r, (b, k))))
    jgot = digits_to_ints(np.asarray(jfri_tpu._blind_dev(ints_to_digits(coeffs, shape=(b, n)),
                                                         ints_to_digits(r, shape=(b, k)))))
    for i in range(b):
        draws = iter(r[i])
        want = fri._blind(coeffs[i], n, k, lambda: next(draws))
        draws = iter(r[i])
        assert got[i] == want == jfri._blind(coeffs[i], n, k, lambda: next(draws))
        assert [int(v) for v in jgot[i]] == want


def test_inv_mont_dev_matches_fermat():
    m0, k = 16, 3
    xs = fri_cuda._xs_digits(m0)
    x_ints = [int(v) for v in digits_to_ints(xs)]
    points = _ints(k - 1, 400) + [x_ints[5]]  # x - point = 0 inverts to 0
    got = _rows(fri_cuda._inv_mont_dev(torch.from_numpy(xs.astype(np.int32)), _dev(points, (k,))))
    for j, pt in enumerate(points):
        assert got[j] == [pow(x - pt, P - 2, P) * R % P for x in x_ints]
    assert got[2][5] == 0


def test_deep_dev_matches_host_composition_and_jax(monkeypatch):
    """F on L0 from the device tables (x^s, 1/(x - zeta), gdeep powers)
    against fri._deep_compose_terms, the JAX package's term loop on the same
    inputs, and chunked (DEEP_CHUNK = 4) against one slab."""
    b, m0, d_bound = 2, 16, 8
    omega = plonk._domain_root(4)
    spec_terms = [(0, False, 6), (1, True, 6), (2, False, 3), (0, False, 8)]  # (row, shifted, d_j)
    evals = [[_ints(m0, 500 + 10 * i + row) for row in range(3)] for i in range(b)]
    claims = [_ints(len(spec_terms), 600 + i) for i in range(b)]
    zetas, gdeeps = _ints(b, 700), _ints(b, 701)
    s_values = sorted({d_bound + 1 - dj for (_, _, dj) in spec_terms})
    spec = [(row, s_values.index(d_bound + 1 - dj), shifted) for (row, shifted, dj) in spec_terms]
    pows = np.stack([fri_cuda._pow_mont(m0, s) for s in s_values])
    gammas = [[pow(g, j, P) * R % P for j in range(len(spec_terms))] for g in gdeeps]
    xs = torch.from_numpy(fri_cuda._xs_digits(m0).astype(np.int32))
    inv = fri_cuda._inv_mont_dev(xs, _dev(zetas + [z * omega % P for z in zetas], (2 * b,)))
    args = [_dev(evals, (b, 3, m0)), _dev(claims, (b, len(spec_terms))),
            _dev(gammas, (b, len(spec_terms))), torch.from_numpy(pows.astype(np.int32)),
            inv[:b], inv[b:], spec]
    one_slab = fri_cuda._deep_dev(*args)
    jax_terms = jfri_tpu._deep_terms_chunk(*[np.asarray(a).astype(np.uint32) for a in args[:6]],
                                          tuple(spec))
    monkeypatch.setattr(fri_cuda, "DEEP_CHUNK", 4)
    chunked = fri_cuda._deep_dev(*args)
    assert torch.equal(one_slab, chunked)
    assert np.array_equal(one_slab.numpy(), np.asarray(jax_terms).astype(np.int32))
    got = _rows(one_slab)
    for i in range(b):
        term_list = [(evals[i][row], claims[i][j], shifted, dj)
                     for j, (row, shifted, dj) in enumerate(spec_terms)]
        want = fri._deep_compose_terms(m0, d_bound, term_list, zetas[i], omega, gdeeps[i])
        assert got[i] == want == jfri._deep_compose_terms(m0, d_bound, term_list, zetas[i],
                                                           omega, gdeeps[i])


def test_fold_dev_matches_fold_evals_and_jax():
    b, m = 2, 32
    shift = fri.G0 ** 4 % P
    evals = [_ints(m, 800 + i) for i in range(b)]
    betas = _ints(b, 810)
    xinv = fri_cuda._xinv_mont(m, shift)
    inv2 = fri_cuda._scalar_mont((P + 1) // 2)
    beta_m = [v * R % P for v in betas]
    got = _rows(fri_cuda._fold_dev(_dev(evals, (b, m)), _dev(beta_m, (b,)),
                                   torch.from_numpy(xinv.astype(np.int32)),
                                   torch.from_numpy(inv2.astype(np.int32))))
    jgot = digits_to_ints(np.asarray(jfri_tpu._fold_dev(
        ints_to_digits(evals, shape=(b, m)), ints_to_digits(beta_m, shape=(b,)), xinv, inv2)))
    for i in range(b):
        want = fri.fold_evals(evals[i], shift, betas[i])
        assert got[i] == want == jfri.fold_evals(evals[i], shift, betas[i])
        assert [int(v) for v in jgot[i]] == want


# -- the FRI commit phase with its in-trace transcript ---------------------------------


@pytest.mark.parametrize("n_folds", [1, 3, 4])
def test_fri_phase_body_matches_the_host_chain(n_folds):
    """challenge -> fold -> scheduled block tree -> absorb its root, as
    fri._fri_commit does for each instance (in both packages); the host
    transcript resumed from the body's state, after absorbing the final
    coefficients, is the host chain's."""
    b, m0 = 2, 64
    sched = fri.layer_schedule(n_folds)
    evals = [_ints(m0, 900 + i) for i in range(b)]
    states0 = []
    for i in range(b):
        tr = plonk.Transcript()
        tr.absorb(1000 + i)
        states0.append(tr.state)
    host, jhost = [], []
    for i in range(b):
        for pkg, perm, out in ((fri, PERM, host), (jfri, JPERM, jhost)):
            tr = (plonk if pkg is fri else jplonk).Transcript()
            tr.set_state(states0[i])
            layers, final_coeffs = pkg._fri_commit(tr, list(evals[i]), m0, n_folds,
                                                   m0 >> n_folds, sched, perm)
            out.append((layers, final_coeffs, tr.state))
    cur, state, layer_evals, layer_levels = fri_cuda._fri_phase_body(
        _dev(evals, (b, m0)), _dev(states0, (b, 5)), *fri_cuda._fri_phase_consts(m0, n_folds, CPU),
        native_perm)
    assert len(layer_evals) == len(layer_levels) == len(sched)
    finals, states = _rows(cur), _rows(state)
    for i in range(b):
        layers, final_coeffs, end_state = host[i]
        assert jhost[i][1] == final_coeffs and jhost[i][2] == end_state
        for li, (k, bs, host_evals, host_levels) in enumerate(layers):
            assert (k, bs) == sched[li]
            assert _rows(layer_evals[li])[i] == host_evals
            assert len(layer_levels[li]) == len(host_levels)
            for lvl, hlvl in zip(layer_levels[li], host_levels):
                assert np.array_equal(lvl[i].numpy(), hlvl)
        shift = pow(fri.G0, 1 << n_folds, P)
        assert plonk._coset_interp(finals[i], shift)[: m0 >> n_folds] == final_coeffs
        resumed = plonk.Transcript()
        resumed.set_state(states[i])
        resumed.absorb(*final_coeffs)
        assert resumed.state == end_state


# -- grinding --------------------------------------------------------------------------


def test_grind_batch_matches_host_and_jax(calls):
    """The windowed search finds each transcript's smallest nonce, as
    fri.grind_transcript and the JAX package's _grind_batch_dev (on the same
    native engine) do; _apply_grinding leaves each transcript where
    grind_transcript does, one kernel call a window."""
    pow_bits = 6

    def transcripts(pkg):
        out = []
        for seed in (424242, 17):
            tr = pkg.Transcript()
            tr.absorb(seed)
            out.append(tr)
        return out

    def window(states, nd, pb):
        return fri_cuda._grind_window_body(states, nd, pb, native_perm)

    def jwindow(states, nd, pb):
        return jfri_tpu._grind_window_body(states, nd, pb, jperm_rows, 1)

    got = fri_cuda._grind_batch_dev(transcripts(plonk), pow_bits, CPU, window)
    assert got == jfri_tpu._grind_batch_dev(transcripts(jplonk), pow_bits, window_fn=jwindow)
    hosts = transcripts(plonk)
    assert got == [fri.grind_transcript(tr, pow_bits, PERM, batch=16) for tr in hosts]
    trs = transcripts(plonk)
    assert fri_cuda._apply_grinding(trs, pow_bits, "hybp", CPU) == got
    assert [tr.state for tr in trs] == [tr.state for tr in hosts]
    assert calls == [("hybp", 2 * 4096)] * (max(got) // 4096 + 1)
    assert fri_cuda._grind_batch_dev(transcripts(plonk), 0, CPU, window) == [0, 0]


# -- the whole prover -------------------------------------------------------------------


def _instances(g, b):
    return [tiny(g, 3 + k, 5 + 2 * k) for k in range(b)]


def _prove_alike(params, b, calls):
    jcs, cs = _instances(jgadget, b), _instances(gadget, b)
    jpk, jvk = jfri.preprocess_succinct(jcs[0], jfri.FriParams(**params), JPERM)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**params), PERM)
    proofs = fri_cuda.prove_succinct_device_batch(
        cs, pk, [np.random.default_rng(100 + k) for k in range(b)], device="cpu")
    assert len(proofs) == b
    for k, (jc, c, proof) in enumerate(zip(jcs, cs, proofs)):
        data = serialize.proof_to_bytes(proof, vk)
        host = fri.prove_succinct(c, pk, PERM, rng=np.random.default_rng(100 + k))
        jproof = jfri.prove_succinct(jc, jpk, JPERM, rng=np.random.default_rng(100 + k))
        assert data == serialize.proof_to_bytes(host, vk) == jser.proof_to_bytes(jproof, jvk)
        pi = [g.pi for g in c.gates]
        assert fri.verify_succinct(vk, proof, pi, PERM)
        assert jfri.verify_succinct(jvk, jser.proof_from_bytes(data, jvk), pi, JPERM)
        bad = list(pi)
        bad[-1] += 1
        assert not fri.verify_succinct(vk, proof, bad, PERM)
    # every permutation went through the kernel seam, as many calls as planned
    eager, in_graph = chip_smoke.device_proof_launches(vk, [p.pow_nonce for p in proofs])
    assert len(calls) == eager + in_graph and {s for s, _ in calls} == {"opt"}
    return proofs


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("final_degree", [8, 2])
def test_device_prover_equals_host_and_jax(calls, b, final_degree):
    """Plain mode, B = 1 and 3: final degree 8 commits no FRI layer, 2 one
    quad layer."""
    _prove_alike(dict(PARAMS, final_degree=final_degree, pow_bits=2), b, calls)


@pytest.mark.parametrize("b", [1, 3])
def test_device_prover_zk_equals_host_and_jax(calls, b):
    """zk at blowup 2 and one query (m0 = 128, three folds, a quad and a
    pair layer): each instance's blinding and mask draws from its own rng,
    as the host prover draws them."""
    _prove_alike(dict(blowup=2, n_queries=1, final_degree=8, pow_bits=2, zk=True), b, calls)


@pytest.mark.slow
def test_device_prover_zk_at_the_jax_tests_size(calls):
    """zk at the JAX tests' own preset (m0 = 512, four folds), B = 3:
    about 15 s on a CPU, most of it the Fermat inversions of the DEEP
    denominators over 3 x 2 x 512 points."""
    _prove_alike(dict(PARAMS, pow_bits=2, zk=True), 3, calls)


def test_device_prover_takes_the_schedule_asked_for(calls):
    cs = _instances(gadget, 2)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**PARAMS, pow_bits=0), PERM)
    got = fri_cuda.prove_succinct_device_batch(cs, pk, schedule="hyb13", device="cpu")
    assert calls and {s for s, _ in calls} == {"hyb13"}
    assert serialize.proof_to_bytes(got[1], vk) == serialize.proof_to_bytes(
        fri.prove_succinct(cs[1], pk, PERM), vk)
    one = fri_cuda.prove_succinct_device(cs[0], pk, device="cpu")
    assert serialize.proof_to_bytes(one, vk) == serialize.proof_to_bytes(got[0], vk)


def _inverted_by_a_device_proof(monkeypatch, zk: bool):
    """Two instances through prove_succinct_device_batch on the CPU, zk or
    not: (every field_cuda.invert call's (elements, mont_in), the key)."""
    from hades252_tpu_torch.ops import field_cuda

    seen, real = [], field_cuda.invert

    def spy(a, *, mont_in):
        seen.append((a.numel() // 16, mont_in))
        return real(a, mont_in=mont_in)

    monkeypatch.setattr(field_cuda, "invert", spy)
    cs = _instances(gadget, 2)
    pk, vk = fri.preprocess_succinct(cs[0], fri.FriParams(**PARAMS, pow_bits=0, zk=zk), PERM)
    rngs = [np.random.default_rng(7 + k) for k in range(2)] if zk else None
    fri_cuda.prove_succinct_device_batch(cs, pk, rngs, device="cpu")
    return seen, vk


def test_device_prover_inverts_phase2s_and_deeps_denominators(calls, monkeypatch):
    """A device proof hands field_cuda.invert phase 2's B n denominators
    (Montgomery in) and DEEP's 2 B m0 (canonical in), one call each:
    chip_smoke.device_proof_inverted's count, which phase 7f holds the
    kernel's counter to."""
    seen, vk = _inverted_by_a_device_proof(monkeypatch, zk=False)
    m0 = fri.proof_schema(vk.n, vk.params)["m0"]
    assert sorted(seen) == sorted([(2 * vk.n, True), (2 * 2 * m0, False)])
    assert sum(n for n, *_ in seen) == chip_smoke.device_proof_inverted(vk, 2)


def test_device_prover_with_zk_inverts_what_device_proof_inverted_counts(calls, monkeypatch):
    """The same with zk, as phase 7f's zk run proves: its blinded key's n
    and m0 in device_proof_inverted's count."""
    seen, vk = _inverted_by_a_device_proof(monkeypatch, zk=True)
    m0 = fri.proof_schema(vk.n, vk.params)["m0"]
    assert vk.params.zk and sorted(seen) == sorted([(2 * vk.n, True), (2 * 2 * m0, False)])
    assert sum(n for n, *_ in seen) == chip_smoke.device_proof_inverted(vk, 2)


class _InvertingGraph:
    """utils/graphs.CudaGraph's inversion counts, for chip_smoke.inversions:
    the launches and elements one replay holds, and the replays."""

    def __init__(self, held_inverts, held_inverted):
        self.held_inverts, self.held_inverted, self.replays = held_inverts, held_inverted, 0


@pytest.mark.parametrize("case", ["eager", "captured_and_replayed", "replayed", "one_too_many"])
def test_inversions_counts_the_main_paths_launches(monkeypatch, case):
    """chip_smoke.inversions, as phases 7d-7i hold hades_field_invert's
    launches: each inversion step is one launch, eager or in a graph's
    replay; a graph captured in the run adds its warm-up's launch (its
    capture's runs nothing) and its warm-up's elements, which the count
    of the run's elements leaves out."""
    from hades252_tpu_torch.ops import field_cuda
    from hades252_tpu_torch.utils import graphs

    monkeypatch.setattr(field_cuda, "launches", 10)
    monkeypatch.setattr(field_cuda, "inverted", 1000)
    monkeypatch.setattr(chip_smoke, "main_inverts", 0)
    live = weakref.WeakSet()
    monkeypatch.setattr(graphs, "_LIVE_GRAPHS", live)
    old = _InvertingGraph(1, 64)
    live.add(old)
    state = chip_smoke.invert_state()
    field_cuda.launches += 1  # DEEP, eager: 2 x 32 elements
    field_cuda.inverted += 64
    if case == "captured_and_replayed":  # phase 2's graph: warm-up, capture, one replay
        new = _InvertingGraph(1, 128)
        live.add(new)
        field_cuda.launches += 2
        field_cuda.inverted += 128 + 128
        new.replays += 1
    elif case in ("replayed", "one_too_many"):
        old.replays += 1
        field_cuda.inverted += 64
        if case == "one_too_many":
            field_cuda.launches += 1
            field_cuda.inverted += 64
    if case == "one_too_many":
        with pytest.raises(RuntimeError, match="inversion steps"):
            chip_smoke.inversions(case, state, 2)
        return
    steps = 1 if case == "eager" else 2
    got = chip_smoke.inversions(case, state, steps)
    assert got == {"eager": 64, "captured_and_replayed": 64 + 128, "replayed": 64 + 64}[case]
    assert chip_smoke.main_inverts == {"eager": 1, "captured_and_replayed": 3, "replayed": 2}[case]


def test_unsatisfied_witness_raises_as_the_host_prover_does(calls):
    c = tiny(gadget)
    pk, _ = fri.preprocess_succinct(c, fri.FriParams(**PARAMS, pow_bits=0), PERM)
    c._values[c.gates[0].w_a.index] = 4  # a * b no longer equals the product wire
    with pytest.raises(ValueError, match="degree bound"):
        fri.prove_succinct(c, pk, PERM)
    with pytest.raises(ValueError, match="degree bound"):
        fri_cuda.prove_succinct_device(c, pk, device="cpu")


def test_device_prover_refusals(calls):
    c1 = tiny(gadget)
    c2 = gadget.Composer()
    w = c2.append_witness(3)
    c2.gate_mul(gadget.Constraint().mult(1).a(w).b(w))  # another structure
    pk, _ = fri.preprocess_succinct(c1, fri.FriParams(**PARAMS, pow_bits=0), PERM)
    with pytest.raises(ValueError, match="circuit structure"):
        fri_cuda.prove_succinct_device_batch([c1, c2], pk, device="cpu")
    with pytest.raises(ValueError, match="unknown schedule"):
        fri_cuda.prove_succinct_device(c1, pk, schedule="nope", device="cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        fri_cuda.prove_succinct_device(c1, pk, device="meta")
    assert fri_cuda.prove_succinct_device_batch([], pk, device="cpu") == []
    assert calls == []


def test_default_device_is_the_card_and_raises_without_one(calls):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    c = tiny(gadget)
    pk, _ = fri.preprocess_succinct(c, fri.FriParams(**PARAMS, pow_bits=0), PERM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fri_cuda.prove_succinct_device(c, pk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fri_cuda.prove_succinct_device_batch([c, tiny(gadget, 2, 9)], pk)
    assert calls == []


def test_one_device_rule_gives_a_key_one_table_entry(monkeypatch, calls):
    """ops.resolve_device gives "cuda" the current card's index, so that
    prove_batched and the device provers read a key's device tables from
    one cache entry. The card's queries are stubbed and the tables stay
    host tensors; each entry point stops at its first table."""
    from hades252_tpu_torch import prover_cuda
    from hades252_tpu_torch.ops import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    assert resolve_device("t", "cuda") == card and resolve_device("t", "cuda:0") == card
    assert resolve_device("t", "cpu") == CPU
    with pytest.raises(ValueError, match="no kernel for device meta"):
        resolve_device("t", "meta")

    def host(digits, device):
        return torch.from_numpy(digits.astype(np.int32))

    monkeypatch.setattr(prover_cuda, "_to_device", host)
    monkeypatch.setattr(fri_cuda, "_to_device", host)
    tables, real = [], prover_cuda._device_tables

    class Stop(Exception):
        pass

    def first_table(key, device, m=None, d_z=None):
        tables.append((device, real(key, device, m, d_z)))
        raise Stop

    monkeypatch.setattr(prover_cuda, "_device_tables", first_table)
    c = tiny(gadget)
    pk, _ = fri.preprocess_succinct(c, fri.FriParams(**PARAMS, pow_bits=0), PERM)
    for prove in (lambda: prover_cuda.prove_batched([c], pk.key),
                  lambda: fri_cuda.prove_succinct_device(c, pk),
                  lambda: fri_cuda.prove_aggregate_device([c], pk)):
        with pytest.raises(Stop):
            prove()
    assert [d for d, _ in tables] == [card] * 3
    assert tables[1][1] is tables[0][1] and tables[2][1] is tables[0][1]
    assert calls == []
