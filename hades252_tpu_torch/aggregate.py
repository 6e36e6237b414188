"""Aggregated succinct proofs: ONE proof for B instances of the same
circuit.

Port of `hades252_tpu/aggregate.py`, host code the port carries its own
copy of: proofs are byte-identical to the JAX package's through
`serialize.aggregate_to_bytes`; `perm_fn` takes the card's kernels
through `fri_cuda.device_pool_perm`.

The reference's prove/verify cycle (dusk-plonk KZG, reference
src/strategies/gadget.rs:198-223) emits one proof per circuit instance;
a server proving B preimages ships B full proofs. This module is the
batch-serving extension on top of the self-hosted PCS (fri.py): all B
instances share every Merkle PATH and the entire FRI low-degree
argument, so the per-instance marginal proof cost is just the claimed
evaluations and the opened leaf values — the paths and FRI layers, which
dominate a single succinct proof, are paid once.

Construction (the HSP2 layout, same soundness model as fri.py):

  * **Paired block commitments.** Each phase commits ONE Merkle tree
    whose leaf block at position j in [0, m0/2) holds ALL the phase's
    polynomials across ALL instances at x_j, then at -x_j: the w tree
    carries the 4B wire columns, z the B grand products, t the B
    quotients (+ the shared zk FRI mask R), and the key tree the 10
    shared preprocessed polynomials. One pruned multiproof per tree per
    proof (fri.multiproof_open) serves every instance and both fold
    inputs of each query.
  * **Shared challenges.** beta/gamma/alpha/zeta are drawn once, after
    the block roots (which bind every instance's wires) are absorbed;
    each instance keeps its own grand product z_j and quotient t_j, and
    its own PLONK zeta identity is checked by the verifier. Sharing
    challenges across independently-committed instances is the standard
    batching argument: each identity holds with the usual
    Schwartz-Zippel error, union-bounded over B
    (aggregate_security_bits).
  * **One DEEP-FRI.** All B*7 wire claims plus the 10 shared key claims
    (plus the zk mask) are batched into a single DEEP composition with
    consecutive powers of one post-evaluation challenge gdeep, then
    folded by one FRI argument with one set of pruned query openings
    and one proof-of-work nonce.

Zero knowledge: FriParams(zk=True) blinds each instance's wires and
grand product exactly as fri.prove_succinct does, and ONE shared mask
polynomial R covers the FRI interior (fri._bounds' ledger applies with
the same counts — the interior reveal count depends on queries and
layers, not on B).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .params import P
from .plonk import (
    Transcript,
    _coset_eval,
    _grand_product,
    _public_input_column,
    _quotient,
    _wire_indices,
    _wire_polys,
    poly_eval,
    statement_digest,
)
from .fri import (
    EVAL_ORDER,
    G0,
    SELECTOR_NAMES,
    SIGMA_NAMES,
    TREE_ORDER,
    FriProof,
    ProvingKey,
    VerifyingKey,
    _blind,
    _check_opening,
    _commit_paired,
    _deep_compose_terms,
    _deep_eval_terms,
    _fold_check,
    _fold_inv_table,
    _fri_commit,
    _fri_proof,
    _open_paired,
    _rand_field_fn,
    _terms,
    _zeta_identity_ok,
    default_pcs_perm,
    grind_transcript,
    layer_positions,
    pooled_entries_verify,
    pow_mask_ok,
    proof_schema,
    tree_root,
)
from .utils.encoding import ints_to_digits

#: Per-instance claimed evaluations (the key evaluations are shared).
WIRE_EVAL_ORDER = ("a", "b", "o", "d", "z", "zw", "t")
KEY_EVAL_ORDER = tuple(n for n in EVAL_ORDER if n not in WIRE_EVAL_ORDER)
WIRE_NAMES = ("a", "b", "o", "d", "z", "t")


def agg_tree_specs(zk: bool, n_instances: int) -> dict:
    """Block width (both sides) per tree of an aggregate: the w tree
    interleaves poly-major instance columns [a_0..a_{B-1}, b_0.., ...],
    z/t are instance columns (t gains the shared zk mask R as its last
    column), k matches the single-proof key tree."""
    return {
        "w": 2 * 4 * n_instances,
        "z": 2 * n_instances,
        "t": 2 * (n_instances + (1 if zk else 0)),
        "k": 2 * len(SELECTOR_NAMES + SIGMA_NAMES),
    }


@dataclass
class AggregateProof:
    """One succinct argument for n_instances same-circuit witnesses."""

    n_instances: int
    roots: dict        # "w", "z", "t" -> block-tree root int
    evals: list        # per instance: dict over WIRE_EVAL_ORDER
    key_evals: dict    # selector/sigma name -> shared evaluation at zeta
    r_eval: int | None  # shared zk mask evaluation (zk only)
    pow_nonce: int
    fri: FriProof      # single shared FRI argument (pruned openings)
    open_blocks: dict  # tree name -> (U0, agg_tree_specs[name]) ints
    open_nodes: dict   # tree name -> (T, N_DIGITS) pruned digits


def aggregate_security_bits(params, n: int = 1024,
                            n_instances: int = 1,
                            proven: bool = False) -> float:
    """Soundness estimate for an aggregate of n_instances — CONJECTURED
    by default (list-decoding capacity, the same stance as
    FriParams.security_bits), the Johnson-bound PROVEN figure with
    proven=True.

    The FRI query soundness is UNCHANGED from a single proof (one
    composition, the same spot checks): n_queries * log2(blowup) bits
    conjectured / half that proven, plus pow_bits of grinding. What
    aggregation costs is the Schwartz-Zippel union bound: the B
    instances' zeta identities (and the DEEP batching) share one
    challenge draw, so the field-side error grows linearly in B — i.e.
    the ~240-bit field term loses log2(B) bits. For every practical B
    the minimum is still the query term; the function exists to make
    that argument checkable rather than implicit."""
    import math

    per_query = math.log2(params.blowup) / (2 if proven else 1)
    query_bits = params.n_queries * per_query + params.pow_bits
    field_bits = math.log2(
        P / (5 * max(n, 2) * max(n_instances, 1))
    )
    return min(query_bits, field_bits)


def aggregate_size_field_elements(proof: AggregateProof) -> int:
    """Proof size in field elements, same accounting rules as
    fri.proof_size_field_elements."""
    from .params import N_DIGITS

    total = len(proof.roots) + len(proof.key_evals)
    total += sum(len(e) for e in proof.evals)
    total += 1 if proof.r_eval is not None else 0
    total += len(proof.fri.layer_roots) + len(proof.fri.final_coeffs)
    for blocks in proof.open_blocks.values():
        total += sum(len(b) for b in blocks)
    for nodes in proof.open_nodes.values():
        total += int(np.asarray(nodes).reshape(-1, N_DIGITS).shape[0])
    for blocks, nodes in zip(proof.fri.layer_blocks,
                             proof.fri.layer_nodes):
        total += sum(len(b) for b in blocks)
        total += int(np.asarray(nodes).reshape(-1, N_DIGITS).shape[0])
    return total


def _agg_terms(bounds: dict, n_instances: int):
    """DEEP term schedule: every instance's 7 wire claims (instance-major,
    fri._terms order), then the 10 shared key claims, then the shared zk
    mask. The enumeration order fixes each claim's gdeep power on both
    sides. Entries: (instance or None, poly name, eval name, shifted,
    d_j)."""
    base = [t for t in _terms(bounds) if t[0] != "r"]
    wire_terms = base[: len(WIRE_EVAL_ORDER)]
    key_terms = base[len(WIRE_EVAL_ORDER):]
    out = []
    for j in range(n_instances):
        out += [(j, pname, ename, shifted, dj)
                for pname, ename, shifted, dj in wire_terms]
    out += [(None, pname, ename, shifted, dj)
            for pname, ename, shifted, dj in key_terms]
    if bounds.get("zk"):
        out.append((None, "r", "r", False, bounds["d_r"]))
    return out


def _agg_col(pname: str, j, n_instances: int):
    """(tree, column index) of a polynomial's LO-side slot in the
    aggregate block layout (HI side = column + block_width/2)."""
    if pname in ("a", "b", "o", "d"):
        return "w", "abod".index(pname) * n_instances + j
    if pname == "z":
        return "z", j
    if pname == "t":
        return "t", j
    if pname == "r":
        return "t", n_instances
    return "k", (SELECTOR_NAMES + SIGMA_NAMES).index(pname)


def _absorb_statement(tr: Transcript, digest: int, n: int, n_gates: int,
                      pi_cols):
    """Bind the aggregate statement: the instance count and every
    instance's (circuit digest, public inputs) in order, before any
    challenge is drawn."""
    tr.absorb(len(pi_cols))
    for pi in pi_cols:
        col = [int(v) % P for v in pi][:n_gates]
        tr.absorb(statement_digest(digest, col + [0] * (n - len(col))))


def prove_aggregate(composers, pk: ProvingKey, perm_fn=None,
                    rng=None) -> AggregateProof:
    """Prove all composers' witnesses (same circuit structure as pk) in
    one aggregated succinct argument. With pk.params.zk each instance's
    witness polynomials are Z_H-blinded first and one shared FRI mask
    is committed."""
    if not composers:
        raise ValueError("at least one composer required")
    if perm_fn is None:
        perm_fn = default_pcs_perm()
    key, params = pk.key, pk.params
    n, omega = key.n, key.omega
    schema = proof_schema(n, params)
    bounds = schema["bounds"]
    d_bound = bounds["D"]
    m0, half0 = schema["m0"], schema["half0"]
    final_degree, n_folds = schema["final_degree"], schema["n_folds"]
    sched = schema["sched"]
    n_inst = len(composers)

    ref_idx = _wire_indices(composers[0])
    for c in composers[1:]:
        if _wire_indices(c) != ref_idx:
            raise ValueError(
                "prove_aggregate requires all composers to share one "
                "circuit structure"
            )

    rand_field = _rand_field_fn(rng)
    inst = []
    for c in composers:
        wire_evals, wires = _wire_polys(c, key)
        if params.zk:
            wires = tuple(_blind(w, n, bounds["zkw"], rand_field)
                          for w in wires)
        inst.append({"wire_evals": wire_evals, "wires": wires,
                     "pi": _public_input_column(c, n)})

    tr = Transcript()
    _absorb_statement(tr, pk.digest, n, key.n_gates,
                      [i["pi"] for i in inst])

    # L0 evaluations, poly-major then instance (the w-tree column order)
    wire_l0 = {
        pname: [_coset_eval(list(i["wires"][w_i]), m0, G0) for i in inst]
        for w_i, pname in enumerate("abod")
    }
    levels, roots = {}, {}
    w_cols = [wire_l0[pname][j] for pname in "abod" for j in range(n_inst)]
    levels["w"] = _commit_paired(w_cols, perm_fn)
    roots["w"] = tree_root(levels["w"])
    tr.absorb(roots["w"])
    beta = tr.challenge()
    gamma = tr.challenge()

    for i in inst:
        z = _grand_product(i["wire_evals"], key, beta, gamma)
        if params.zk:
            z = _blind(z, n, bounds["zkz"], rand_field)
        i["z"] = z
    z_l0 = [_coset_eval(list(i["z"]), m0, G0) for i in inst]
    levels["z"] = _commit_paired(z_l0, perm_fn)
    roots["z"] = tree_root(levels["z"])
    tr.absorb(roots["z"])
    alpha = tr.challenge()

    for i in inst:
        i["t"] = _quotient(key, i["wires"], i["z"], i["pi"], beta, gamma,
                           alpha, m=d_bound)
    t_l0 = [_coset_eval(list(i["t"]), m0, G0) for i in inst]
    r_poly = None
    t_cols = list(t_l0)
    if params.zk:
        r_poly = [rand_field() for _ in range(d_bound)]
        t_cols.append(_coset_eval(list(r_poly), m0, G0))
    levels["t"] = _commit_paired(t_cols, perm_fn)
    roots["t"] = tree_root(levels["t"])
    tr.absorb(roots["t"])
    zeta = tr.challenge()

    evals = []
    for i in inst:
        evals.append({
            "a": poly_eval(i["wires"][0], zeta),
            "b": poly_eval(i["wires"][1], zeta),
            "o": poly_eval(i["wires"][2], zeta),
            "d": poly_eval(i["wires"][3], zeta),
            "z": poly_eval(i["z"], zeta),
            "zw": poly_eval(i["z"], zeta * omega % P),
            "t": poly_eval(i["t"], zeta),
        })
    key_evals = {}
    for name in SELECTOR_NAMES:
        key_evals[name] = poly_eval(key.selectors[name], zeta)
    for i, name in enumerate(SIGMA_NAMES):
        key_evals[name] = poly_eval(key.sigmas[i], zeta)
    r_eval = poly_eval(r_poly, zeta) if params.zk else None
    for e in evals:
        tr.absorb(*[e[name] for name in WIRE_EVAL_ORDER])
    tr.absorb(*[key_evals[name] for name in KEY_EVAL_ORDER])
    if params.zk:
        tr.absorb(r_eval)
    gdeep = tr.challenge()

    term_list = []
    for j, pname, ename, shifted, dj in _agg_terms(bounds, n_inst):
        if pname == "r":
            term_list.append((t_cols[n_inst], r_eval, shifted, dj))
        elif j is None:
            term_list.append((pk.key_evals[pname], key_evals[ename],
                              shifted, dj))
        elif pname == "z":
            term_list.append((z_l0[j], evals[j][ename], shifted, dj))
        elif pname == "t":
            term_list.append((t_l0[j], evals[j][ename], shifted, dj))
        else:
            term_list.append((wire_l0[pname][j], evals[j][ename],
                              shifted, dj))
    f = _deep_compose_terms(m0, d_bound, term_list, zeta, omega, gdeep)

    layer_coms, final_coeffs = _fri_commit(tr, f, m0, n_folds,
                                           final_degree, sched, perm_fn)
    pow_nonce = grind_transcript(tr, params.pow_bits, perm_fn)
    queries = [tr.challenge() % half0 for _ in range(params.n_queries)]
    s0 = sorted(set(queries))

    open_blocks, open_nodes = {}, {}
    tree_cols = {"w": w_cols, "z": z_l0, "t": t_cols,
                 "k": [pk.key_evals[c]
                       for c in SELECTOR_NAMES + SIGMA_NAMES]}
    tree_levels = {"w": levels["w"], "z": levels["z"], "t": levels["t"],
                   "k": pk.key_levels}
    for tname in TREE_ORDER:
        open_blocks[tname], open_nodes[tname] = _open_paired(
            tree_cols[tname], tree_levels[tname], s0
        )

    fri_pf = _fri_proof(layer_coms, final_coeffs, queries, m0, sched)
    return AggregateProof(
        n_instances=n_inst,
        roots=roots,
        evals=evals,
        key_evals=key_evals,
        r_eval=r_eval,
        pow_nonce=pow_nonce,
        fri=fri_pf,
        open_blocks=open_blocks,
        open_nodes=open_nodes,
    )


def verify_aggregate(vk: VerifyingKey, proof: AggregateProof,
                     public_inputs_list, perm_fn=None,
                     entries_check=None) -> bool:
    """Check the aggregated argument against the SAME VerifyingKey that
    verifies single succinct proofs. All-or-nothing: every instance's
    zeta identity, the proof-of-work gate, every pruned multiproof, and
    the shared fold checks must hold. entries_check: optional backend
    for the pooled sponge+multiproof phase (fri.pooled_entries_verify
    signature): a fused device twin may be passed."""
    if perm_fn is None:
        perm_fn = default_pcs_perm()
    n, omega, params = vk.n, vk.omega, vk.params
    schema = proof_schema(n, params)
    bounds = schema["bounds"]
    d_bound = bounds["D"]
    m0, half0 = schema["m0"], schema["half0"]
    final_degree, n_folds = schema["final_degree"], schema["n_folds"]
    sched = schema["sched"]
    q_n = params.n_queries
    n_inst = proof.n_instances
    if n_inst < 1 or len(public_inputs_list) != n_inst:
        return False
    if len(proof.evals) != n_inst:
        return False
    if any(sorted(e) != sorted(WIRE_EVAL_ORDER) for e in proof.evals):
        return False
    if sorted(proof.key_evals) != sorted(KEY_EVAL_ORDER):
        return False
    if sorted(proof.roots) != sorted(("w", "z", "t")):
        return False
    if params.zk != (proof.r_eval is not None):
        return False
    if len(proof.fri.final_coeffs) > final_degree:
        return False
    if any(
        len(part) != len(sched)
        for part in (proof.fri.layer_roots, proof.fri.layer_blocks,
                     proof.fri.layer_nodes)
    ):
        return False

    # 1. replay the transcript (PoW gate included)
    pis = [[int(v) % P for v in pi][:vk.n_gates]
           for pi in public_inputs_list]
    tr = Transcript()
    _absorb_statement(tr, vk.digest, n, vk.n_gates, pis)
    tr.absorb(proof.roots["w"])
    beta = tr.challenge()
    gamma = tr.challenge()
    tr.absorb(proof.roots["z"])
    alpha = tr.challenge()
    tr.absorb(proof.roots["t"])
    zeta = tr.challenge()
    evals = [{name: e[name] % P for name in WIRE_EVAL_ORDER}
             for e in proof.evals]
    key_evals = {name: proof.key_evals[name] % P for name in KEY_EVAL_ORDER}
    for e in evals:
        tr.absorb(*[e[name] for name in WIRE_EVAL_ORDER])
    tr.absorb(*[key_evals[name] for name in KEY_EVAL_ORDER])
    r_eval = None
    if params.zk:
        r_eval = proof.r_eval % P
        tr.absorb(r_eval)
    gdeep = tr.challenge()
    betas = []
    committed = dict(sched)
    li = 0
    for k in range(1, n_folds + 1):
        betas.append(tr.challenge())
        if k in committed:
            tr.absorb(proof.fri.layer_roots[li])
            li += 1
    tr.absorb(*proof.fri.final_coeffs)
    tr.absorb(int(proof.pow_nonce))
    if not pow_mask_ok(tr.challenge(), params.pow_bits):
        return False
    queries = [tr.challenge() % half0 for _ in range(q_n)]
    s0 = sorted(set(queries))
    pos_chains = [layer_positions(q, m0, sched) for q in queries]

    # 2. every instance's PLONK identity at zeta (shared key evals)
    for e, pi in zip(evals, pis):
        ev = dict(e)
        ev.update(key_evals)
        if not _zeta_identity_ok(vk, ev, pi, zeta, beta, gamma, alpha):
            return False

    # 3. structural checks + pooled pruned multiproofs
    specs = agg_tree_specs(params.zk, n_inst)
    blocks_by = {}
    entries = []
    for gid, tname in enumerate(TREE_ORDER):
        checked = _check_opening(
            proof.open_blocks.get(tname), proof.open_nodes.get(tname),
            s0, specs[tname], schema["h_pos"],
        )
        if checked is None:
            return False
        blocks, nodes = checked
        blocks_by[tname] = dict(zip(s0, blocks))
        digits = ints_to_digits(
            [v for b in blocks for v in b],
            shape=(len(blocks), specs[tname]),
        )
        root = vk.k_root if tname == "k" else proof.roots[tname]
        entries.append((gid, root, digits, s0, nodes, schema["h_pos"]))
    layer_by = []
    for li, (k, bs) in enumerate(sched):
        s_k = sorted({pc[li] for pc in pos_chains})
        checked = _check_opening(
            proof.fri.layer_blocks[li], proof.fri.layer_nodes[li],
            s_k, bs, schema["layer_heights"][li],
        )
        if checked is None:
            return False
        blocks, nodes = checked
        layer_by.append(dict(zip(s_k, blocks)))
        digits = ints_to_digits(
            [v for b in blocks for v in b], shape=(len(blocks), bs)
        )
        entries.append((len(TREE_ORDER) + li, proof.fri.layer_roots[li],
                        digits, s_k, nodes, schema["layer_heights"][li]))
    if entries_check is None:
        ok = pooled_entries_verify(entries, perm_fn)
    else:
        ok = entries_check(entries)
    if not bool(np.all(ok)):
        return False

    # 4. fold each query through the shared layers (one batched inversion
    # covers every DEEP denominator and fold point — _fold_inv_table)
    agg_terms = _agg_terms(bounds, n_inst)
    inv_of = _fold_inv_table(queries, m0, sched, zeta, omega)

    def deep_pair(qi, x):
        q = queries[qi]
        lo_terms, hi_terms = [], []
        for j, pname, ename, shifted, dj in agg_terms:
            tname, col = _agg_col(pname, j, n_inst)
            blk = blocks_by[tname][q]
            half = len(blk) // 2
            if pname == "r":
                v = r_eval
            elif j is None:
                v = key_evals[ename]
            else:
                v = evals[j][ename]
            lo_terms.append((blk[col], v, shifted, dj))
            hi_terms.append((blk[half + col], v, shifted, dj))
        f_lo = _deep_eval_terms(x, d_bound, lo_terms, zeta, omega, gdeep,
                                inv_of)
        f_hi = _deep_eval_terms((P - x) % P, d_bound, hi_terms, zeta,
                                omega, gdeep, inv_of)
        return f_lo, f_hi

    return _fold_check(queries, betas, m0, n_folds, sched, layer_by,
                       proof.fri.final_coeffs, deep_pair, inv_of)
