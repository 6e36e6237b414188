"""The port's batched prover (prover_cuda.py) on the CPU against the host
prover of the JAX package and of the port, object for object.

`prove_batched(device="cpu")` runs the same torch code as on the card.
The JAX package's own `prove_batched` is not called here: it costs minutes
of XLA compile on the CPU, and tests/test_prover_tpu.py holds it to the
same host prover.
"""

import gc
import inspect
import weakref

import numpy as np
import pytest
import torch

from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu import prover_tpu as jprover
from hades252_tpu_torch import field, gadget, plonk, prover_cuda
from hades252_tpu_torch.gadget import Composer, Constraint
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _instance(mod, v1, v2):
    """The circuit of tests/test_prover_tpu.py, through `mod`'s Composer."""
    c = mod.Composer()
    a = c.append_witness(v1)
    b = c.append_witness(v2)
    c.gate_mul(mod.Constraint().mult(1).a(a).b(b))
    c.gate_add(mod.Constraint().left(1).a(a).right(1).b(b).public(-((v1 + v2) % P)))
    return c


def _chain(mod, values):
    """A longer circuit with shared wires: 2 len(values) gates."""
    c = mod.Composer()
    ws = [c.append_witness(v) for v in values]
    acc = ws[0]
    for w in ws[1:]:
        prod = c.gate_mul(mod.Constraint().mult(1).a(acc).b(w))
        acc = c.gate_add(mod.Constraint().left(1).a(prod).right(2).b(w).fourth(3).d(ws[0]).constant(5))
    c.append_gate(mod.Constraint().left(1).a(acc).public(-c.value(acc)))
    return c


def _ints(rng, k):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]


def _circuits(rng, which):
    """(JAX package composers, port composers) of one circuit, three
    instances."""
    if which == "tiny":
        args = [(3, 5), (11, 13), (2**200, 7)]
        return ([_instance(jgadget, *a) for a in args], [_instance(gadget, *a) for a in args])
    values = [_ints(rng, 30) for _ in range(3)]
    return [_chain(jgadget, v) for v in values], [_chain(gadget, v) for v in values]


def _t(digits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(digits.astype(np.int32))


def _rows(t: torch.Tensor) -> list:
    return digits_to_ints(t.numpy()).tolist()


@pytest.mark.parametrize("which", ["tiny", "chain"])
def test_prove_batched_equals_jax_host_prover(rng, which):
    jcs, cs = _circuits(rng, which)
    jkey, key = jplonk.preprocess(jcs[0]), plonk.preprocess(cs[0])
    assert key.n == (4 if which == "tiny" else 64)
    proofs = prover_cuda.prove_batched(cs, key, device="cpu")
    assert len(proofs) == len(cs)
    for jc, c, pr in zip(jcs, cs, proofs):
        want = jplonk.prove(jc, jkey)
        assert pr.wires == want.wires
        assert pr.z == want.z
        assert pr.t == want.t
        assert pr.commitments == want.commitments
        host = plonk.prove(c, key)
        assert (pr.wires, pr.z, pr.t, pr.commitments) == (host.wires, host.z, host.t, host.commitments)
        pi = [g.pi for g in c.gates]
        assert plonk.verify(key, pr, pi) and jplonk.verify(jkey, pr, pi)
    # the key is optional, as in plonk.prove
    again = prover_cuda.prove_batched(cs[:1], device="cpu")
    assert again[0].t == proofs[0].t and again[0].commitments == proofs[0].commitments


def test_prove_batched_empty():
    assert prover_cuda.prove_batched([]) == []


def test_prove_batched_rejects_mixed_circuits():
    c1 = _instance(gadget, 3, 5)
    c2 = Composer()
    a = c2.append_witness(3)
    c2.gate_mul(Constraint().mult(1).a(a).b(a))  # different structure
    with pytest.raises(ValueError, match="circuit structure"):
        prover_cuda.prove_batched([c1, c2], device="cpu")


def test_prove_batched_defaults_to_the_card(monkeypatch):
    """The default device is the card; without one, the default raises and
    nothing falls back to the CPU."""
    assert inspect.signature(prover_cuda.prove_batched).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover_cuda.prove_batched([_instance(gadget, 3, 5)])


def test_prove_batched_refuses_a_device_with_no_kernel():
    with pytest.raises(ValueError, match="no kernel for device"):
        prover_cuda.prove_batched([_instance(gadget, 3, 5)], device="meta")


def test_key_tables_equal_jax(rng):
    jcs, cs = _circuits(rng, "chain")
    key, jkey = plonk.preprocess(cs[0]), jplonk.preprocess(jcs[0])
    for m, d_z in ((None, None), (512, 80)):
        got, want = prover_cuda._key_tables(key, m, d_z), jprover._key_tables(jkey, m, d_z)
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], dict):
                assert all(np.array_equal(got[k][q], want[k][q]) for q in want[k])
            else:
                assert np.array_equal(got[k], want[k]), k
    dev = prover_cuda._device_tables(key, CPU)
    assert dev["kx_mont"].dtype == torch.int32
    assert np.array_equal(dev["kx_mont"].numpy(), prover_cuda._key_tables(key)["kx_mont"])
    assert prover_cuda._device_tables(key, CPU) is dev


def test_caches_release_dead_keys():
    """The per-key table cache holds its key weakly, host tables and
    device copies alike, and drops the entry when the key dies."""
    key = plonk.preprocess(_instance(gadget, 3, 5))
    prover_cuda._key_tables(key)
    prover_cuda._key_tables(key, m=64, d_z=key.n)
    prover_cuda._device_tables(key, CPU)
    kid = id(key)
    assert kid in prover_cuda._TABLE_CACHE
    assert len(prover_cuda._TABLE_CACHE[kid][1]) == 3
    ref_key = weakref.ref(key)
    del key
    gc.collect()
    assert ref_key() is None
    assert kid not in prover_cuda._TABLE_CACHE


@pytest.mark.parametrize("n", [1, 2, 5, 64])
def test_log_step_scan_equals_sequential_prefix_products(rng, n):
    vals = [_ints(rng, n) for _ in range(2)]
    x = field.to_mont(_t(ints_to_digits(vals, shape=(2, n))))
    got = field.from_mont(prover_cuda._prefix_products(x))
    want = []
    for row in vals:
        acc, out = 1, []
        for v in row:
            acc = acc * v % P
            out.append(acc)
        want.append(out)
    assert _rows(got) == want


def _phase_inputs(rng, which="chain"):
    _, cs = _circuits(rng, which)
    key = plonk.preprocess(cs[0])
    wire_evals = [plonk._wire_polys(c, key)[0] for c in cs]
    betas, gammas, alphas = _ints(rng, 3), _ints(rng, 3), _ints(rng, 3)
    return cs, key, wire_evals, betas, gammas, alphas


def test_phase2_equals_host_grand_product(rng):
    cs, key, wire_evals, betas, gammas, _ = _phase_inputs(rng)
    tables = prover_cuda._device_tables(key, CPU)
    z = prover_cuda._phase2_grand_product(
        _t(ints_to_digits(wire_evals, shape=(3, 4, key.n))),
        _t(ints_to_digits(betas, shape=(3,))), _t(ints_to_digits(gammas, shape=(3,))),
        tables["ids_mont"], tables["sigma_n_mont"], tables["one_mont"])
    assert _rows(z) == [plonk._grand_product(w, key, b, g)
                        for w, b, g in zip(wire_evals, betas, gammas)]


def test_phase3_equals_host_quotient(rng):
    cs, key, wire_evals, betas, gammas, alphas = _phase_inputs(rng)
    wires = [plonk._wire_polys(c, key)[1] for c in cs]
    zs = [plonk._grand_product(w, key, b, g) for w, b, g in zip(wire_evals, betas, gammas)]
    pis = [plonk._public_input_column(c, key.n) for c in cs]
    tables = prover_cuda._device_tables(key, CPU)
    wires_t = prover_cuda._phase1_wires(_t(ints_to_digits(wire_evals, shape=(3, 4, key.n))))
    assert _rows(wires_t) == [list(w) for w in wires]
    t = prover_cuda._phase3_quotient(
        wires_t, _t(ints_to_digits(zs, shape=(3, key.n))),
        _t(ints_to_digits([[v % P for v in pi] for pi in pis], shape=(3, key.n))),
        *(_t(ints_to_digits(v, shape=(3,))) for v in (betas, gammas, alphas)),
        tables["kx_mont"], tables["sigma_m_mont"], tables["q_mont"], tables["zh_inv_mont"],
        tables["l1_mont"], tables["omega_mont"], tables["one_mont"])
    assert _rows(t) == [plonk._quotient(key, w, z, pi, b, g, a)
                        for w, z, pi, b, g, a in zip(wires, zs, pis, betas, gammas, alphas)]
