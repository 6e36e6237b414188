"""Batched PLONK proving on the card: many instances, bit-identical proofs.

Port of `hades252_tpu/prover_tpu.py`. The prover's heavy polynomial passes
(wire interpolation, the copy-constraint grand product and the 4n-coset
quotient) run as batched digit arithmetic on the port's element-wise field
ops (`ops/field_cuda.py`: one kernel launch each on the card, `field`'s
torch ops on the CPU) and `ops/ntt.py` transforms, over B independent
instances of the SAME circuit.
The same code runs on a CPU tensor, which is how the tests hold it against
the host prover; the entry point runs on the card unless asked otherwise.

Fiat-Shamir splits the argument into three device phases with host
transcript stops between them. Each phase's outputs are copied to the host
once, for the commitments and the proofs' int lists; the transcript stops
advance all B instances in lock-step (plonk.BatchedTranscript, statement
digests hashed straight from the digit buffer):

  phase 1: wire columns -> coefficient forms          (4 iNTTs, batched)
  phase 2: (beta, gamma) -> grand-product z           (a log-step scan of
           Montgomery ratios and one batched Fermat inversion, one
           kernel launch on the card: ops/field_cuda.py)
  phase 3: (alpha) -> quotient t on the 4n coset      (coset NTTs and the
           gate/permutation/boundary combination, batched)

On the card each phase is one CUDA graph a shape (`phase_graph`), as the
JAX package jits each into one program; on the CPU the same bodies run
eagerly, and they are the graphs' plain version.

Spans (utils/metrics.span): `prove.phase1` .. `prove.phase3` around each
phase as `_select_phases` hands it out (so the device provers of fri_cuda
get them too), `prove.fetch` around each copy of a phase's output to the
host and `prove.host` around the host stops between them.

Montgomery-domain discipline inside a phase: additions happen on canonical
digits, every chained product runs in the Montgomery domain (constants are
lifted on the host), and each phase's outputs convert back to canonical
before the transcript touches them, so each Proof is BIT-IDENTICAL to
plonk.prove's for the same instance (tests/test_torch_prover.py).
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from . import plonk
from .gadget import Composer
from .ops import field_cuda, ntt, resolve_device
from .params import P, R
from .plonk import (
    CircuitKey,
    K_SHIFTS,
    Proof,
    _coset_eval,
    _public_input_column,
    _wire_indices,
    key_digest,
)
from .utils import metrics
from .utils.encoding import digits_to_ints, ints_to_digits
from .utils.graphs import _GRAPHS, CudaGraph

QUOTIENT_SHIFT = 7  # the 4n-coset shift used by plonk._quotient


# ---------------------------------------------------------------------------
# Host-side per-key constant tables (ints -> Montgomery digit arrays)
# ---------------------------------------------------------------------------


def _mont(vals, shape) -> np.ndarray:
    return ints_to_digits([v % P * R % P for v in vals], shape=shape)


#: CircuitKey holds dicts (its generated __hash__ raises), so the table
#: cache is keyed by object identity, holds only a WEAK reference to the
#: key, and evicts itself via weakref.finalize the moment the key is
#: collected: a long-running prover does not retain one table set per
#: circuit ever seen. The finalize runs before the id can be reused
#: (CPython refcounting), and the stored weakref is re-checked anyway. The
#: device copies of a key's tables live in the same entry, so they die
#: with the key too.
_TABLE_CACHE: dict = {}


def _key_entry(key: CircuitKey) -> dict:
    per_key = _TABLE_CACHE.get(id(key))
    if per_key is None or per_key[0]() is not key:
        per_key = (weakref.ref(key), {})
        _TABLE_CACHE[id(key)] = per_key
        weakref.finalize(key, _TABLE_CACHE.pop, id(key), None)
    return per_key[1]


def _key_tables(key: CircuitKey, m: int | None = None,
                d_z: int | None = None):
    """Host constants derived from the circuit key, as numpy digit arrays
    (weakly cached per key object: the one-time host cost of lifting the
    preprocessed polynomials into Montgomery digit tables). m: the quotient
    coset size (default 4n; a zero-knowledge prover passes a larger
    bound); d_z: length of the omega table (default n; a blinded grand
    product is longer, and entries are omega^(i mod n) since omega^n = 1)."""
    n = key.n
    if m is None:
        m = 4 * n
    if d_z is None:
        d_z = n
    entry = _key_entry(key)
    cached = entry.get((m, d_z))
    if cached is not None:
        return cached
    g = QUOTIENT_SHIFT
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * key.omega % P

    # phase 2: wire-position ids k_c * omega^i and sigma evaluations on H
    ids = [k * omega_pows[i] % P for k in K_SHIFTS for i in range(n)]
    sigma_evals = [v for s in key.sigmas for v in _coset_eval(s, n, 1)]

    # phase 3: coset points, selector/sigma/L1/Z_H^-1 tables on g*H_m
    w_m = plonk._domain_root(m)
    xs, x = [], g
    for _ in range(m):
        xs.append(x)
        x = x * w_m % P
    kxs = [k * x % P for k in K_SHIFTS for x in xs]
    s_c = [v for s in key.sigmas for v in _coset_eval(s, m, g)]
    q_c = {
        name: _coset_eval(poly, m, g)
        for name, poly in key.selectors.items()
    }
    zh = [(pow(x, n, P) - 1) % P for x in xs]
    zh_inv = plonk.batch_inverse(zh)
    l1_den_inv = plonk.batch_inverse([n * (x - 1) % P for x in xs])
    l1 = [zh[i] * l1_den_inv[i] % P for i in range(m)]

    omega_ext = [omega_pows[i % n] for i in range(d_z)]
    tables = {
        "ids_mont": _mont(ids, (4, n)),
        "sigma_n_mont": _mont(sigma_evals, (4, n)),
        "omega_mont": _mont(omega_ext, (d_z,)),
        "kx_mont": _mont(kxs, (4, m)),
        "sigma_m_mont": _mont(s_c, (4, m)),
        "q_mont": {name: _mont(v, (m,)) for name, v in q_c.items()},
        "zh_inv_mont": _mont(zh_inv, (m,)),
        "l1_mont": _mont(l1, (m,)),
        "one_mont": _mont([1], (1,))[0],
    }
    entry[(m, d_z)] = tables
    return tables


def _to_device(digits: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(digits.astype(np.int32)).to(device)


def _device_tables(key: CircuitKey, device: torch.device, m: int | None = None,
                   d_z: int | None = None) -> dict:
    """_key_tables' arrays as int32 tensors on `device`, cached in the
    key's entry beside them."""
    host = _key_tables(key, m, d_z)
    entry = _key_entry(key)
    tag = (host["kx_mont"].shape[1], host["omega_mont"].shape[0], device)
    cached = entry.get(tag)
    if cached is None:
        cached = {name: ({k: _to_device(v, device) for k, v in t.items()}
                         if isinstance(t, dict) else _to_device(t, device))
                  for name, t in host.items()}
        entry[tag] = cached
    return cached


# ---------------------------------------------------------------------------
# Device phases
# ---------------------------------------------------------------------------


def _phase1_wires(wire_evals: torch.Tensor) -> torch.Tensor:
    """(B, 4, n, D) canonical wire columns -> coefficient forms."""
    return ntt.ntt_batched(wire_evals, invert=True)


def _prefix_products(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix Montgomery products along axis 1 of (B, n, D)
    Montgomery digits, by a log-step (Hillis-Steele) scan: ceil(log2 n)
    batched mont_muls. Montgomery products are exact, hence associative and
    commutative, so any order of the products gives the same bits as the
    sequential one."""
    step = 1
    while step < x.shape[1]:
        x = torch.cat([x[:, :step], field_cuda.mont_mul(x[:, step:], x[:, :-step])], dim=1)
        step <<= 1
    return x


def _phase2_grand_product(wire_evals, beta, gamma, ids_mont, sigma_n_mont,
                          one_mont):
    """(B, 4, n, D) wire columns + per-instance (B, D) challenges ->
    (B, n, D) grand-product coefficients (canonical). The field ops
    broadcast, so the challenges and tables are not expanded."""
    b4 = beta[:, None, None, :]
    g4 = gamma[:, None, None, :]
    # numerator / denominator factors on H (canonical adds, then lift)
    beta_id = field_cuda.mont_mul(b4, ids_mont[None])
    beta_sig = field_cuda.mont_mul(b4, sigma_n_mont[None])
    num_f = field_cuda.to_mont(field_cuda.add_mod(field_cuda.add_mod(wire_evals, beta_id), g4))
    den_f = field_cuda.to_mont(field_cuda.add_mod(field_cuda.add_mod(wire_evals, beta_sig), g4))
    num = field_cuda.mont_mul(
        field_cuda.mont_mul(num_f[:, 0], num_f[:, 1]),
        field_cuda.mont_mul(num_f[:, 2], num_f[:, 3]),
    )  # (B, n, D) Montgomery
    den = field_cuda.mont_mul(
        field_cuda.mont_mul(den_f[:, 0], den_f[:, 1]),
        field_cuda.mont_mul(den_f[:, 2], den_f[:, 3]),
    )
    den_inv = field_cuda.invert(den, mont_in=True)
    ratio = field_cuda.mont_mul(num, den_inv)  # Montgomery
    # prefix products: z(omega^i) = prod_{j<i} ratio_j, z(1) = 1
    one = one_mont.expand(ratio.shape[0], 1, -1)
    shifted = torch.cat([one, ratio[:, :-1]], dim=1)
    z_evals = field_cuda.from_mont(_prefix_products(shifted))
    return ntt.ntt_batched(z_evals, invert=True)


def _pad_poly(coeffs: torch.Tensor, m: int) -> torch.Tensor:
    return F.pad(coeffs, (0, 0, 0, m - coeffs.shape[-2]))


def _phase3_quotient(wires, z, pi_evals, beta, gamma, alpha, kx_mont,
                     sigma_m_mont, q_mont, zh_inv_mont, l1_mont,
                     omega_mont, one_mont):
    """(B, 4, d_w, D) wire coeffs + (B, d_z, D) z coeffs + (B, n, D) PI
    columns -> (B, m, D) quotient coefficients (canonical). m comes from
    the table shapes (4n unblinded; a zero-knowledge prover passes larger
    tables), so blinded inputs of length d_w/d_z > n work unchanged."""
    m = kx_mont.shape[1]
    g = QUOTIENT_SHIFT

    def ce(c):
        return ntt.coset_eval_batched(_pad_poly(c, m), g)

    w_c = ce(wires)                       # (B, 4, m, D)
    z_c = ce(z)                           # (B, m, D)
    zw = field_cuda.mont_mul(z, omega_mont)    # z(omega X) coeffs
    zw_c = ce(zw)
    pi_c = ce(ntt.ntt_batched(pi_evals, invert=True))

    b4 = beta[:, None, None, :]
    g4 = gamma[:, None, None, :]
    beta_kx = field_cuda.mont_mul(b4, kx_mont[None])
    beta_sig = field_cuda.mont_mul(b4, sigma_m_mont[None])
    num_f = field_cuda.to_mont(field_cuda.add_mod(field_cuda.add_mod(w_c, beta_kx), g4))
    den_f = field_cuda.to_mont(field_cuda.add_mod(field_cuda.add_mod(w_c, beta_sig), g4))
    z_m = field_cuda.to_mont(z_c)
    zw_m = field_cuda.to_mont(zw_c)
    num = field_cuda.mont_mul(
        field_cuda.mont_mul(field_cuda.mont_mul(num_f[:, 0], num_f[:, 1]),
                            field_cuda.mont_mul(num_f[:, 2], num_f[:, 3])),
        z_m,
    )
    den = field_cuda.mont_mul(
        field_cuda.mont_mul(field_cuda.mont_mul(den_f[:, 0], den_f[:, 1]),
                            field_cuda.mont_mul(den_f[:, 2], den_f[:, 3])),
        zw_m,
    )
    perm = field_cuda.sub_mod(num, den)

    a_m, b_m, o_m, d_m = field_cuda.to_mont(w_c).unbind(1)
    gate = field_cuda.add_mod(
        field_cuda.add_mod(
            field_cuda.add_mod(
                field_cuda.mont_mul(field_cuda.mont_mul(q_mont["q_m"], a_m), b_m),
                field_cuda.mont_mul(q_mont["q_l"], a_m),
            ),
            field_cuda.add_mod(
                field_cuda.mont_mul(q_mont["q_r"], b_m),
                field_cuda.mont_mul(q_mont["q_o"], o_m),
            ),
        ),
        field_cuda.add_mod(
            field_cuda.add_mod(field_cuda.mont_mul(q_mont["q_4"], d_m), q_mont["q_c"]),
            field_cuda.to_mont(pi_c),
        ),
    )
    boundary = field_cuda.mont_mul(l1_mont, field_cuda.sub_mod(z_m, one_mont))
    alpha_m = field_cuda.to_mont(alpha)[:, None, :]
    alpha2_m = field_cuda.mont_mul(alpha_m, alpha_m)
    combined = field_cuda.add_mod(
        field_cuda.add_mod(gate, field_cuda.mont_mul(alpha_m, perm)),
        field_cuda.mont_mul(alpha2_m, boundary),
    )
    t_evals = field_cuda.from_mont(field_cuda.mont_mul(combined, zh_inv_mont))
    return ntt.coset_interp_batched(t_evals, g)


# ---------------------------------------------------------------------------
# The batched prover
# ---------------------------------------------------------------------------


def _digits_to_int_rows(arr: np.ndarray) -> list:
    """(..., n, D) host digits -> nested lists of ints over the last-2 axis."""
    return digits_to_ints(arr).tolist()


def _commit_rows(arr: np.ndarray) -> np.ndarray:
    """sha commitments of each (n, D) polynomial row of a (..., n, D) host
    copy of a phase output, hashed straight from the digit buffer
    (bit-identical to plonk.commit on the int lists: canonical digits
    < 2^16 serialize to exactly the 32-byte-LE stream commit hashes)."""
    a = np.ascontiguousarray(arr).astype("<u2")
    lead = a.shape[:-2]
    flat = a.reshape((-1,) + a.shape[-2:])
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = plonk.commit_bytes(flat[i].tobytes())
    return out.reshape(lead)


_PHASES = (_phase1_wires, _phase2_grand_product, _phase3_quotient)

#: The argument of each phase whose shape is (B, ..., n, D): the instances
#: and the domain that name a phase's group of graphs.
_SIZE_ARG = (0, 0, 2)

#: The phases' graphs on the card: (B, n, device) -> (its memory pool, its
#: graphs by (phase, argument layout, every tensor argument's shape and
#: dtype)), the most recently used last, at most _GRAPHS groups.
_PHASE_GRAPHS: OrderedDict = OrderedDict()


def _flatten(args: tuple) -> tuple:
    """A phase's arguments as (a flat tuple of tensors, the layout that
    rebuilds them): a dict of tables (phase 3's q_mont) in the order of
    its sorted keys."""
    flat, layout = [], []
    for a in args:
        if isinstance(a, dict):
            names = tuple(sorted(a))
            flat.extend(a[k] for k in names)
            layout.append(names)
        else:
            flat.append(a)
            layout.append(None)
    return tuple(flat), tuple(layout)


def _unflatten(flat: tuple, layout: tuple) -> list:
    args, i = [], 0
    for names in layout:
        if names is None:
            args.append(flat[i])
            i += 1
        else:
            args.append(dict(zip(names, flat[i : i + len(names)])))
            i += len(names)
    return args


def phase_graph(phase: int, flat: tuple, layout: tuple) -> CudaGraph:
    """The CUDA graph of prover phase `phase` (0, 1, 2) for these flat
    arguments' shapes, captured at its first use: the counterpart of the
    JAX package's jitted phase (`prover_tpu.py:149,155,201`).

    Every tensor argument, the proving key's tables included, is a static
    input buffer copied in at each call, so one graph serves every key of a
    shape and no graph keeps a key alive. The graphs of one (B, n, device)
    are captured in the order they replay and share one memory pool; the
    cache keeps the _GRAPHS groups used last."""
    size = flat[_SIZE_ARG[phase]]
    group_key = (size.shape[0], size.shape[-2], size.device)
    group = _PHASE_GRAPHS.pop(group_key, None)
    if group is None:
        group = (torch.cuda.graph_pool_handle(), {})
    _PHASE_GRAPHS[group_key] = group
    while len(_PHASE_GRAPHS) > _GRAPHS:
        _PHASE_GRAPHS.popitem(last=False)
    pool, graphs = group
    key = (phase, layout, tuple((tuple(x.shape), x.dtype) for x in flat))
    graph = graphs.get(key)
    if graph is None:
        body = _PHASES[phase]
        inputs = tuple(torch.zeros(x.shape, dtype=x.dtype, device=x.device) for x in flat)
        graph = CudaGraph(lambda *xs: body(*_unflatten(xs, layout)), inputs, pool=pool)
        graphs[key] = graph
    return graph


def _replayed(phase: int):
    def run(*args):
        flat, layout = _flatten(args)
        return phase_graph(phase, flat, layout)(*flat)
    return run


def _spanned(name: str, phase):
    """phase(*args) inside the span `name`; `__wrapped__` is the phase."""
    def run(*args):
        with metrics.span(name):
            return phase(*args)
    run.__wrapped__ = phase
    return run


def _select_phases(mesh, device) -> tuple:
    """The three device phases for `device`, each in its span
    `prove.phase<k>`: on a card each replays its graph (phase_graph), with
    no eager fallback; elsewhere the eager bodies, which are the plain
    version. With a mesh (parallel/dist.Mesh) their drop-ins sharded over
    the instance axis (dist.sharded_phases: proving is data parallelism,
    each phase's one collective the gather of its output, which no graph
    holds; the bits are the same). The first sharded phase refuses a batch
    that does not divide by the mesh size, with the JAX package's
    message."""
    if mesh is not None:
        from .parallel.dist import sharded_phases

        phases = sharded_phases(mesh)
    elif torch.device(device).type == "cuda":
        phases = tuple(_replayed(i) for i in range(len(_PHASES)))
    else:
        phases = _PHASES
    return tuple(_spanned(f"prove.phase{k}", f) for k, f in enumerate(phases, start=1))


def _fetch(x: torch.Tensor, name: str = "prove.fetch") -> np.ndarray:
    """A device tensor copied to the host in the span `name` (the host waits
    for the card)."""
    with metrics.span(name):
        return x.cpu().numpy()


def prove_batched(composers: list[Composer],
                  key: CircuitKey | None = None,
                  device="cuda", mesh=None) -> list[Proof]:
    """Prove B instances of one circuit with `device` doing the polynomial
    work: the card unless the caller asks for the CPU (`device="cpu"`);
    without a card the default raises. Every composer must share the first
    one's gate/wire structure (same circuit, different witnesses); the
    returned proofs are bit-identical to [plonk.prove(c, key) for c in
    composers].

    mesh: an optional parallel/dist.Mesh. Every rank of it calls with the
    same composers, the three device phases shard over the instances (B
    must divide by the mesh size) on the mesh's device, which `device` may
    not contradict ("cuda" agrees with any card's mesh; a CPU mesh needs
    device="cpu"), and every rank returns all B proofs."""
    if not composers:
        return []
    if mesh is None:
        device = resolve_device("prove_batched", device)
    else:
        from .parallel.dist import mesh_device

        device = mesh_device(mesh, device)
    phase1, phase2, phase3 = _select_phases(mesh, device)
    if key is None:
        key = plonk.preprocess(composers[0])
    n = key.n
    ref_idx = _wire_indices(composers[0])
    for c in composers[1:]:
        if _wire_indices(c) != ref_idx:
            raise ValueError(
                "prove_batched requires all composers to share one "
                "circuit structure"
            )
    b = len(composers)
    with metrics.span("prove.host"):
        tables = _device_tables(key, device)
        digest = key_digest(key)
        wire_int = [
            [
                [c._values[idx] % P for idx in col] + [0] * (n - key.n_gates)
                for col in _wire_indices(c)
            ]
            for c in composers
        ]
        wire_evals = _to_device(ints_to_digits(wire_int, shape=(b, 4, n)), device)
        pi_cols = [
            [v % P for v in _public_input_column(c, n)] for c in composers
        ]
        pi_evals = ints_to_digits(pi_cols, shape=(b, n))

    # phase 1: wire coefficient forms
    wires_dev = phase1(wire_evals)
    wires_host = _fetch(wires_dev)
    with metrics.span("prove.host"):
        wires_int = _digits_to_int_rows(wires_host)
        wire_cms = _commit_rows(wires_host)          # (B, 4) object ints

        # Fiat-Shamir for all B instances in lock-step: one batched host
        # permutation per stream step (absorb statement digest, absorb each
        # of the 4 wire commitments, draw beta/gamma): the same streams as B
        # per-instance Transcripts, without B sequential perm calls each
        tr = plonk.BatchedTranscript(b)
        tr.absorb_each(plonk.statement_digest_rows(digest, pi_evals))
        cms = [{} for _ in range(b)]
        for j, name in enumerate("abod"):
            for i in range(b):
                cms[i][name] = wire_cms[i, j]
            tr.absorb_each([wire_cms[i, j] for i in range(b)])
        betas = tr.challenge_each()
        gammas = tr.challenge_each()

        beta_d = _to_device(ints_to_digits(betas, shape=(b,)), device)
        gamma_d = _to_device(ints_to_digits(gammas, shape=(b,)), device)

    # phase 2: grand product
    z_dev = phase2(
        wire_evals, beta_d, gamma_d,
        tables["ids_mont"], tables["sigma_n_mont"], tables["one_mont"],
    )
    z_host = _fetch(z_dev)
    with metrics.span("prove.host"):
        z_int = _digits_to_int_rows(z_host)
        z_cms = _commit_rows(z_host)

        for i in range(b):
            cms[i]["z"] = z_cms[i]
        tr.absorb_each([z_cms[i] for i in range(b)])
        alphas = tr.challenge_each()
        alpha_d = _to_device(ints_to_digits(alphas, shape=(b,)), device)
        pi_d = _to_device(pi_evals, device)

    # phase 3: quotient
    t_dev = phase3(
        wires_dev, z_dev, pi_d, beta_d, gamma_d, alpha_d,
        tables["kx_mont"], tables["sigma_m_mont"], tables["q_mont"],
        tables["zh_inv_mont"], tables["l1_mont"], tables["omega_mont"],
        tables["one_mont"],
    )
    t_host = _fetch(t_dev)
    with metrics.span("prove.host"):
        t_int = _digits_to_int_rows(t_host)
        t_cms = _commit_rows(t_host)

        proofs = []
        for i in range(b):
            cms[i]["t"] = t_cms[i]
            proofs.append(
                Proof(wires=tuple(wires_int[i]), z=z_int[i], t=t_int[i],
                      commitments=cms[i])
            )
    return proofs
