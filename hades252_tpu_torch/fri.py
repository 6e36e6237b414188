"""Self-hosted polynomial commitment scheme: Hades-Merkle vector
commitments + a DEEP-FRI low-degree argument, and the succinct PLONK
prove/verify cycle built on them.

Port of `hades252_tpu/fri.py`, host code the port carries its own copy of
(importing anything from `hades252_tpu` imports JAX). Keys, proofs and
verdicts are bit-identical to the JAX package's. Every permutation goes
through a pluggable `perm_fn`: `default_pcs_perm()` (the native engine, the
plain PyTorch permutation where it cannot be built) or the card's kernels
through `fri_cuda.device_pool_perm`.

The reference's prove/verify cycle runs through dusk-plonk's KZG
polynomial commitment scheme (reference: src/strategies/gadget.rs:198-223,
dep at Cargo.toml:13): constant-size proofs whose commitments actually
bind polynomials. `plonk.py` alone is a transparent PIOP: its proofs ship
full polynomials and `commit()` is a bare hash. This module closes that
capability gap with machinery the framework already owns — no elliptic
curves, no trusted setup:

  * **Vector commitments** are arity-4 Merkle trees over the polynomials'
    evaluations on a blown-up coset L0 = g*H_m (m = blowup * D), hashed
    with the framework's own Hades permutation (node rule below), so the
    same CUDA kernels that serve hashing traffic also build and verify
    proof commitments. The HSP2 layout commits each
    PROVING PHASE as one paired-block tree — position j holds every
    phase polynomial's evaluations at (x_j, -x_j), the two inputs of the
    first FRI fold — so one opening per query serves a whole phase;
    openings ship as pruned MULTIPROOFS (multiproof_open: no digest
    derivable from another opened path, no positions — the verifier
    rebuilds the plan from its transcript-derived indices), FRI layers
    commit every second fold in quad blocks (layer_schedule), and a
    proof-of-work nonce (grind_transcript) buys pow_bits of soundness
    before query sampling. Together ~10x smaller proofs than a per-leaf
    layout at production parameters.
  * **Low-degree + evaluation proofs** use the DEEP-ALI + FRI pattern
    (the STARK construction): all committed polynomials p_j with claimed
    evaluations v_j = p_j(zeta_j) are batched into one composition
        F(X) = sum_j gdeep^j * X^{D+1-d_j} * (p_j(X) - v_j)/(X - zeta_j),
    which is a polynomial of degree < D iff every claim is true (the
    degree shift X^{D+1-d_j} simultaneously enforces each p_j's individual
    degree bound d_j). FRI then folds F log2(D/final_degree) times —
    committing each intermediate layer — and spot-checks the folds at
    transcript-derived query indices against Merkle openings.
  * **Fiat-Shamir** runs through the same Hades-sponge `Transcript` as the
    transparent mode, statement-bound (circuit digest + public inputs
    absorbed before any challenge).

Soundness model (documented honestly): FRI
proximity soundness gives per-query error (1 - delta) against vectors
delta-far from the code. Taking delta up to 1 - rate is the standard
LIST-DECODING-CAPACITY CONJECTURE of deployed STARKs — under it the
defaults (blowup 8, 35 queries, 16 PoW bits) give 121 bits
(FriParams.security_bits). The PROVEN Johnson-bound figure (delta up to
1 - sqrt(rate), [BCIKS20]) is half the query bits: ~68 bits
(FriParams.proven_security_bits). Both are reported; neither is
mislabeled "conservative". The Schwartz-Zippel terms of the PLONK
identity are 240+ bits and never bind. Unlike the reference's KZG this
needs no pairing assumption and no trusted setup; like every FRI system
the commitments bind vectors *close to* low-degree polynomials rather
than exact ones.

Zero-knowledge: FriParams(zk=True) Z_H-blinds the wire and grand-product
polynomials AND commits a uniformly random degree-<D mask polynomial R
into the DEEP batch, covering both the direct reveals (query openings,
zeta evaluations, the shifted z evaluations implied by the opened
quotient) and the FRI-interior reveals (layer blocks, final
coefficients) — the exact ledger is in _bounds and is tested against
real proofs (tests/test_fri.py::test_zk_leak_ledger). This is the
ethSTARK masking construction, the counterpart of dusk-plonk's hiding
commitments and blinded wires. Unopened leaves stay behind the Hades
Merkle digests (random-oracle model). Without zk the proof leaks
evaluations of the witness polynomials and must not be used when the
witness is secret.

Node rule (our spec, domain-separated from the models/ trees):
    parent = perm([TAG_PCS, c0, c1, c2, c3])[DIGEST_INDEX],  TAG_PCS = 5
over CANONICAL-domain children (Merkle trees use tag 4, the cipher 6);
leaf blocks hash through a rate-4 sponge tagged TAG_PCS_LEAF + width
(block_digests).
Trees are built host-side in numpy with a pluggable batched permutation —
the CUDA kernels on the card (fri_cuda.device_pool_perm), the native C++
oracle on CPU hosts, the plain PyTorch permutation as the dependency-free
fallback (all bit-identical; the selftest KATs).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cache, lru_cache

import numpy as np

from .params import N_DIGITS, P, digits_to_int
from .plonk import (
    CircuitKey,
    Transcript,
    _coset_eval,
    _coset_interp,
    _domain_root,
    _grand_product,
    _public_input_column,
    _quotient,
    _wire_polys,
    K_SHIFTS,
    batch_inverse,
    key_digest,
    poly_eval,
    preprocess,
)
from .utils.encoding import ints_to_digits

ARITY = 4
TAG_PCS = 5  # capacity-word domain tag (Merkle: 4, cipher: 6)
DIGEST_INDEX = 1
G0 = 7  # L0 coset shift: the F_r^* generator, so G0*H_m never meets H_m
INV2 = (P + 1) // 2

#: Domains above this size fall back to pow() instead of a cached table
#: (the table is O(m) ints; verifier domains are m0 = n*blowup, well
#: below this for every preset, but _domain_root accepts up to 2^32).
_ROOT_POW_MAX = 1 << 21
#: Tables kept at once: one per domain size a process verifies against;
#: the least recently used goes first, so a server that meets many sizes
#: holds at most this many O(m) tables.
_ROOT_POW_TABLES = 8


@lru_cache(maxsize=_ROOT_POW_TABLES)
def _root_pows(m: int) -> list[int]:
    """table[e] = w_m^e for the order-m domain root, e in [0, m). One
    O(m) build per domain size; afterwards every verifier-side
    pow(_domain_root(m), e, P) is a list index. The verifier previously
    paid ~25 modexps per query on these (plus one per nonzero public
    input in _pi_eval)."""
    w = _domain_root(m)
    t = [1] * m
    for i in range(1, m):
        t[i] = t[i - 1] * w % P
    return t


def _root_pow_at(m: int, e: int) -> int:
    """w_m^e via the cached table (modexp fallback for huge domains)."""
    if m <= _ROOT_POW_MAX:
        return _root_pows(m)[e % m]
    return pow(_domain_root(m), e, P)


@cache
def _g0_pow(e: int) -> int:
    """G0^e mod p (few distinct exponents per verification: the layer
    coset shifts G0^(2^k) and the DEEP degree-shift bases)."""
    return pow(G0, e, P)

SELECTOR_NAMES = ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c")
SIGMA_NAMES = ("s0", "s1", "s2", "s3")
#: Fixed transcript order for the claimed evaluations ("zw" = z(omega*zeta)).
EVAL_ORDER = ("a", "b", "o", "d", "z", "zw", "t") + SELECTOR_NAMES + SIGMA_NAMES


# ---------------------------------------------------------------------------
# Permutation backend for commitment trees (canonical domain, batched)
# ---------------------------------------------------------------------------


def _pcs_perm_native(digits):
    """Single-thread native engine with the per-call canonicality scan
    skipped: every admission point into this seam proves canonicality
    (wire bytes via bytes_to_digits, proof openings via _check_opening,
    prover-side digits via ints_to_digits), and the engine's outputs
    are canonical by construction. Module-level so its identity is
    stable across default_pcs_perm() calls."""
    from .utils import native

    return native.perm_batch_digits(digits, validate=False)


def _pcs_perm_native_mt(digits):
    """Multi-core variant of _pcs_perm_native (same admission-point
    canonicality contract)."""
    from .utils import native

    return native.perm_batch_digits_mt(digits, validate=False)


def _pcs_perm_plain(digits):
    """The plain PyTorch permutation (the `opt` schedule's plain version,
    on the CPU) on (B, WIDTH, N_DIGITS) canonical digits; uint32 out."""
    import torch

    from .ops.perm_cuda import permute_cuda

    x = torch.from_numpy(np.asarray(digits, np.uint32).astype(np.int32))
    return permute_cuda(x).numpy().astype(np.uint32)


def default_pcs_perm():
    """(B, WIDTH, N_DIGITS) canonical batched permutation for HOST-
    orchestrated commitment trees: the native C++ oracle when it builds,
    the plain PyTorch permutation on the CPU otherwise. Deliberately NOT
    the card's kernel even on a GPU host: the card's path is
    fri_cuda.device_pool_perm, which the caller passes as perm_fn. On
    hosts with more than one CPU core the native engine shards each batch
    across OS threads (native.perm_batch_digits_mt — bit-identical, ctypes
    releases the GIL), so pooled verification hashing scales with the
    serving host's cores by default. All backends are bit-identical
    (selftest KATs), so trees built by any backend verify against roots
    built by any other."""
    import os

    from .utils import native

    if native.available():
        # validate=False (see _pcs_perm_native*): every admission point
        # into this seam already proves canonicality, so the per-call
        # scan is redundant — it cost ~20% of a single-proof host
        # verification.
        if (os.cpu_count() or 1) > 1:
            return _pcs_perm_native_mt
        return _pcs_perm_native
    return _pcs_perm_plain


@cache
def _tag_digits() -> np.ndarray:
    return ints_to_digits([TAG_PCS], shape=(1,))[0]


# ---------------------------------------------------------------------------
# Arity-4 commitment trees (canonical domain, numpy host orchestration)
# ---------------------------------------------------------------------------


def _tree_height(n_leaves: int) -> int:
    h, m = 0, 1
    while m < n_leaves:
        m *= ARITY
        h += 1
    return h


def tree_build_digits(leaves: np.ndarray, perm_fn) -> list[np.ndarray]:
    """Commit a digit-array vector: all tree levels, leaves first.

    leaves: (N, N_DIGITS) canonical digits; zero-padded to a power of 4."""
    n = leaves.shape[0]
    full = ARITY ** _tree_height(n)
    level = np.concatenate(
        [np.asarray(leaves, np.uint32),
         np.zeros((full - n, N_DIGITS), np.uint32)]
    )
    levels = [level]
    while level.shape[0] > 1:
        k = level.shape[0] // ARITY
        children = level.reshape(k, ARITY, N_DIGITS)
        tag = np.broadcast_to(_tag_digits(), (k, 1, N_DIGITS))
        states = np.concatenate([tag, children], axis=1).astype(np.uint32)
        level = np.asarray(perm_fn(states))[:, DIGEST_INDEX, :].astype(
            np.uint32
        )
        levels.append(level)
    return levels


def tree_build(values, perm_fn) -> list[np.ndarray]:
    """Commit a vector of field elements: all tree levels, leaves first.

    values: list of canonical ints. Leaves beyond len(values) are
    zero-padded to a power of 4."""
    return tree_build_digits(
        ints_to_digits(list(values), shape=(len(values),)), perm_fn
    )


def tree_root(levels) -> int:
    return digits_to_int(levels[-1][0])


def tree_open_batched(levels, indices):
    """Compact openings (3 siblings + position per level) for many leaves:
    (K, h, ARITY-1, N_DIGITS) digits and (K, h) int32 positions."""
    sibs_all, poss_all = [], []
    for idx in indices:
        i = int(idx)
        if not 0 <= i < levels[0].shape[0]:
            raise ValueError(f"leaf index {i} out of range")
        sibs, poss = [], []
        for level in levels[:-1]:
            g, pos = divmod(i, ARITY)
            grp = level[g * ARITY : (g + 1) * ARITY]
            sibs.append(np.concatenate([grp[:pos], grp[pos + 1 :]], axis=0))
            poss.append(pos)
            i = g
        sibs_all.append(np.stack(sibs))
        poss_all.append(poss)
    return np.stack(sibs_all), np.asarray(poss_all, np.int32)


def _insert_at(node, sibs, pos):
    """Rebuild the ARITY-child groups: node (K, D) placed at pos (K,) among
    siblings (K, ARITY-1, D)."""
    cols = []
    for j in range(ARITY):
        idx = np.clip(np.where(j > pos, j - 1, j), 0, ARITY - 2)
        s = np.take_along_axis(sibs, idx[:, None, None], axis=1)[:, 0]
        cols.append(np.where((pos == j)[:, None], node, s))
    return np.stack(cols, axis=1)


def poss_to_indices(poss) -> np.ndarray:
    """Leaf index encoded by each position path (little-endian base-4)."""
    poss = np.asarray(poss, np.int64)
    weights = ARITY ** np.arange(poss.shape[1], dtype=np.int64)
    return (poss * weights[None, :]).sum(axis=1)


def _tree_verify_nodes(root, node: np.ndarray, sibs, poss, height: int,
                       expected_indices, perm_fn, chain_fn=None) -> np.ndarray:
    """Core of tree_verify_batched on pre-digested nodes: node is
    (K, N_DIGITS) canonical digits of the starting level's entries (leaf
    values, or block-subtree roots for block openings).

    chain_fn, if given, replaces the per-level perm_fn loop: it receives
    (node, sibs, poss) and must return the final (K, N_DIGITS) root-level
    digests, bit-identical to the loop (a device backend may run all
    levels in one program: per-level round trips dominate batched
    verification)."""
    k = node.shape[0]
    sibs = np.asarray(sibs)
    poss = np.asarray(poss)
    if sibs.shape != (k, height, ARITY - 1, N_DIGITS) or poss.shape != (
        k,
        height,
    ):
        return np.zeros(k, bool)
    pos_ok = np.all((poss >= 0) & (poss < ARITY), axis=1)
    idx_ok = poss_to_indices(poss) == np.asarray(expected_indices, np.int64)
    if chain_fn is not None and height > 0:
        node = np.asarray(chain_fn(node, sibs, poss), np.uint32)
    else:
        tag = np.broadcast_to(_tag_digits(), (k, 1, N_DIGITS))
        for lvl in range(height):
            children = _insert_at(node, sibs[:, lvl], poss[:, lvl])
            states = np.concatenate([tag, children], axis=1).astype(np.uint32)
            node = np.asarray(perm_fn(states))[:, DIGEST_INDEX, :].astype(
                np.uint32
            )
    if isinstance(root, (int, np.integer)):
        root_digits = ints_to_digits([int(root)], shape=(1,))[0][None]
    else:
        if len(root) != k:
            return np.zeros(k, bool)
        root_digits = ints_to_digits([int(r) for r in root], shape=(k,))
    digest_ok = np.all(node == root_digits, axis=-1)
    return pos_ok & idx_ok & digest_ok


def tree_verify_batched(root, values, sibs, poss, height: int,
                        expected_indices, perm_fn, chain_fn=None) -> np.ndarray:
    """Verify K compact openings with one batched permutation per level.

    root: one int (all openings against the same tree) or a length-K
    sequence of per-row roots — the pooled form lets a caller verify
    openings from MANY trees (different polynomials, different proofs)
    in the same per-level permutation batch.
    values: list of K claimed leaf ints; expected_indices: the K leaf
    indices the VERIFIER demands (transcript-derived) — the position path
    must both hash to the root AND encode exactly that index, and every
    attacker-supplied position is range-checked (see models/merkle.py's
    range-check note). chain_fn: see _tree_verify_nodes. Returns (K,)
    bool."""
    node = ints_to_digits(list(values), shape=(len(values),))
    return _tree_verify_nodes(root, node, sibs, poss, height,
                              expected_indices, perm_fn, chain_fn)


# ---------------------------------------------------------------------------
# Paired-block leaf digests + Merkle multiproofs (the HSP2 commitment
# layout: proofs shrink toward the reference's
# KZG class by (a) pruned multiproofs, (b) transcript-derived positions,
# (c) grinding; see grind_transcript)
# ---------------------------------------------------------------------------

TAG_PCS_LEAF = 7  # leaf-digest sponge domain tag (tree nodes keep TAG_PCS)


def leaf_tag_int(block_size: int) -> int:
    """Capacity word of the leaf-digest sponge: domain tag + block width,
    so blocks of different widths can never collide across trees."""
    return TAG_PCS_LEAF + (int(block_size) << 8)


@cache
def _p_digits_i64() -> np.ndarray:
    from .params import int_to_digits

    return int_to_digits(P).astype(np.int64)


def add_mod_digits_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Canonical mod-p addition on (..., N_DIGITS) 16-bit digit arrays —
    vectorized host numpy (both operands canonical)."""
    s = np.asarray(a).astype(np.int64) + np.asarray(b).astype(np.int64)
    out = np.empty_like(s)
    carry = np.zeros(s.shape[:-1], np.int64)
    for i in range(N_DIGITS):
        t = s[..., i] + carry
        out[..., i] = t & 0xFFFF
        carry = t >> 16
    pd = _p_digits_i64()
    ge = np.zeros(s.shape[:-1], bool)
    eq = np.ones(s.shape[:-1], bool)
    for i in range(N_DIGITS - 1, -1, -1):
        ge |= eq & (out[..., i] > pd[i])
        eq &= out[..., i] == pd[i]
    ge |= eq  # sum == p reduces to 0
    borrow = np.zeros(s.shape[:-1], np.int64)
    sub = np.empty_like(out)
    for i in range(N_DIGITS):
        t = out[..., i] - pd[i] - borrow
        sub[..., i] = t & 0xFFFF
        borrow = (t < 0).astype(np.int64)
    return np.where(ge[..., None], sub, out).astype(np.uint32)


def block_digests(blocks: np.ndarray, perm_fn) -> np.ndarray:
    """(K, bs, N_DIGITS) canonical value blocks -> (K, N_DIGITS) leaf
    digests. Sponge rule (the HSP2 leaf spec): capacity word
    leaf_tag_int(bs); absorb ceil(bs/4) rate-4 chunks (zero-padded) — add
    into words 1..4, permute — digest = word DIGEST_INDEX of the final
    state. One batched permutation per chunk for any K."""
    blocks = np.asarray(blocks, np.uint32)
    if blocks.ndim != 3 or blocks.shape[2] != N_DIGITS:
        raise ValueError(f"blocks must be (K, bs, {N_DIGITS})")
    k, bs = blocks.shape[0], blocks.shape[1]
    if k == 0:
        return np.zeros((0, N_DIGITS), np.uint32)
    n_chunks = max(1, -(-bs // 4))
    pad = n_chunks * 4 - bs
    if pad:
        blocks = np.concatenate(
            [blocks, np.zeros((k, pad, N_DIGITS), np.uint32)], axis=1
        )
    from .params import int_to_digits

    state = np.zeros((k, 5, N_DIGITS), np.uint32)
    state[:, 0] = int_to_digits(leaf_tag_int(bs))
    for c in range(n_chunks):
        state[:, 1:5] = add_mod_digits_np(
            state[:, 1:5], blocks[:, 4 * c : 4 * c + 4]
        )
        state = np.asarray(perm_fn(state)).astype(np.uint32)
    return state[:, DIGEST_INDEX]


def multiproof_plan(indices, height: int) -> list[list[int]]:
    """Canonical pruned-node plan for a batched opening: per level, the
    node indices whose digests the proof must supply for the verifier to
    climb from the (sorted, deduplicated) opened positions to the root.
    At each level every 4-child group containing a known node needs only
    its unknown children; nodes derivable from another opened path are
    never shipped. Order within a level: ascending node index — canonical
    on both sides, so NO positions travel on the wire (the verifier
    rebuilds this plan from its own transcript-derived indices)."""
    known = sorted({int(i) for i in indices})
    plan = []
    for _ in range(height):
        kset = set(known)
        groups = sorted({i >> 2 for i in known})
        plan.append(
            [ARITY * g + j for g in groups for j in range(ARITY)
             if ARITY * g + j not in kset]
        )
        known = groups
    return plan


def multiproof_nodes_total(indices, height: int) -> int:
    return sum(len(lvl) for lvl in multiproof_plan(indices, height))


def multiproof_open(levels, indices) -> np.ndarray:
    """Pruned sibling set for the sorted-unique opened positions:
    (total, N_DIGITS) digits in multiproof_plan order."""
    height = len(levels) - 1
    plan = multiproof_plan(indices, height)
    parts = [np.asarray(levels[lvl])[need]
             for lvl, need in enumerate(plan) if need]
    if not parts:
        return np.zeros((0, N_DIGITS), np.uint32)
    return np.concatenate(parts).astype(np.uint32)


def multiproof_verify_many(entries, perm_fn) -> np.ndarray:
    """Verify many pruned batched openings with POOLED hashing: at each
    level step, every still-active entry's 4-child groups join ONE
    batched permutation call (entries with shorter trees simply retire
    early), so the call count is max(height), independent of how many
    trees/proofs are pooled.

    entries: (root, leaf_digests, indices, nodes, height) per entry —
    root an int or (N_DIGITS,) digits; leaf_digests (U, N_DIGITS) for the
    sorted-unique indices; nodes (total, N_DIGITS) in multiproof_plan
    order. Returns (len(entries),) bool; malformed entries are False."""
    n = len(entries)
    ok = np.ones(n, bool)
    state = []
    for e_i, (root, leaf_dig, idx, nodes, height) in enumerate(entries):
        idx = [int(i) for i in idx]
        leaf_dig = np.asarray(leaf_dig, np.uint32)
        nodes = np.asarray(nodes, np.uint32).reshape(-1, N_DIGITS)
        plan = multiproof_plan(idx, height)
        total = sum(len(lvl) for lvl in plan)
        if (not idx or sorted(set(idx)) != idx or min(idx) < 0
                or max(idx) >= ARITY ** height
                or leaf_dig.shape != (len(idx), N_DIGITS)
                or nodes.shape != (total, N_DIGITS)):
            ok[e_i] = False
            continue
        state.append({
            "i": e_i, "plan": plan, "nodes": nodes, "off": 0,
            "idx": np.asarray(idx, np.int64), "dig": leaf_dig,
            "height": height, "root": root,
        })
    max_h = max((s["height"] for s in state), default=0)
    tag_row = _tag_digits()
    for lvl in range(max_h):
        active = [s for s in state if s["height"] > lvl]
        if not active:
            break
        batches = []
        for s in active:
            need = s["plan"][lvl]
            sup = s["nodes"][s["off"] : s["off"] + len(need)]
            s["off"] += len(need)
            all_idx = np.concatenate(
                [s["idx"], np.asarray(need, np.int64)]
            )
            all_dig = (np.concatenate([s["dig"], sup])
                       if len(need) else s["dig"])
            order = np.argsort(all_idx, kind="stable")
            all_dig = all_dig[order]
            s["idx"] = all_idx[order][::ARITY] >> 2
            batches.append(all_dig.reshape(-1, ARITY, N_DIGITS))
        sizes = [x.shape[0] for x in batches]
        groups = np.concatenate(batches)
        tag = np.broadcast_to(tag_row, (groups.shape[0], 1, N_DIGITS))
        states = np.concatenate([tag, groups], axis=1).astype(np.uint32)
        out = np.asarray(perm_fn(states))[:, DIGEST_INDEX].astype(np.uint32)
        offi = 0
        for s, sz in zip(active, sizes):
            s["dig"] = out[offi : offi + sz]
            offi += sz
    for s in state:
        root = s["root"]
        root_digits = (
            ints_to_digits([int(root)], shape=(1,))[0]
            if isinstance(root, (int, np.integer))
            else np.asarray(root, np.uint32)
        )
        ok[s["i"]] = (s["dig"].shape[0] == 1
                      and bool(np.array_equal(s["dig"][0], root_digits)))
    return ok


def multiproof_verify(root, leaf_digests, indices, nodes, height: int,
                      perm_fn) -> bool:
    return bool(multiproof_verify_many(
        [(root, leaf_digests, indices, nodes, height)], perm_fn
    )[0])


def pooled_entries_verify(entries, perm_fn) -> np.ndarray:
    """Host backend for the batched verifiers' pooled Merkle phase: leaf
    sponges batched per entry group (gid), then ONE pooled multiproof
    pass. entries: (gid, root, blocks (U, bs, N_DIGITS) digits, idx,
    nodes, height) — gid groups entries sharing a block width so their
    sponge chunks ride one batched permutation stream (the grouping the
    batched verifier uses per tree kind / FRI layer). A device backend
    may supply a fused twin of this function through the same seam."""
    order = []
    by_gid = {}
    for e_i, e in enumerate(entries):
        by_gid.setdefault(e[0], []).append(e_i)
        order.append(e_i)
    digs_of = {}
    for gid, idxs in by_gid.items():
        batch = np.concatenate([entries[i][2] for i in idxs])
        digs = block_digests(batch, perm_fn)
        off = 0
        for i in idxs:
            u = entries[i][2].shape[0]
            digs_of[i] = digs[off : off + u]
            off += u
    mp = [
        (entries[i][1], digs_of[i], entries[i][3], entries[i][4],
         entries[i][5])
        for i in order
    ]
    return multiproof_verify_many(mp, perm_fn)


# ---------------------------------------------------------------------------
# Proof-of-work grinding (ethSTARK-style: ~pow_bits soundness bits per
# transcript attempt, letting n_queries shrink at equal claimed level)
# ---------------------------------------------------------------------------


def pow_mask_ok(value: int, pow_bits: int) -> bool:
    return (int(value) & ((1 << pow_bits) - 1)) == 0


def _grind_search(state_digits: np.ndarray, pow_bits: int, perm_fn,
                  batch: int) -> int:
    """Smallest nonce n >= 0 with perm(state + n*e1)[1] ending in
    pow_bits zero bits — the value Transcript.challenge() would return
    after absorb(n). Batched over candidates (one permutation per
    candidate, checked on raw digits without int materialization)."""
    if pow_bits == 0:
        return 0
    if not 0 <= pow_bits <= 32:
        raise ValueError("pow_bits must be in [0, 32]")
    mask = (1 << pow_bits) - 1
    base = np.broadcast_to(
        np.asarray(state_digits, np.uint32), (batch, 5, N_DIGITS)
    )
    start = 0
    while True:
        nonces = np.arange(start, start + batch, dtype=np.int64)
        nd = np.zeros((batch, N_DIGITS), np.uint32)
        for i in range(4):  # nonce < 2^64 by construction
            nd[:, i] = (nonces >> (16 * i)) & 0xFFFF
        states = base.copy()
        states[:, 1] = add_mod_digits_np(states[:, 1], nd)
        out = np.asarray(perm_fn(states))
        low = (out[:, 1, 0].astype(np.int64)
               | (out[:, 1, 1].astype(np.int64) << 16))
        hits = np.nonzero((low & mask) == 0)[0]
        if hits.size:
            return int(start + hits[0])
        start += batch


def grind_transcript(tr, pow_bits: int, perm_fn=None,
                     batch: int = 4096, search_fn=None) -> int:
    """Grind lever (c): find the smallest nonce such that absorbing it
    makes the transcript's next challenge end in pow_bits zero bits;
    absorb it and consume the check challenge. Deterministic — host and
    device provers find the same nonce, so proofs stay bit-identical.
    The verifier replays: absorb(proof.pow_nonce), then
    pow_mask_ok(challenge(), pow_bits). search_fn(state_digits) overrides
    the search backend (a device prover may supply one)."""
    if perm_fn is None:
        perm_fn = default_pcs_perm()
    state = ints_to_digits(tr.state, shape=(5,))
    if search_fn is not None:
        nonce = int(search_fn(state))
    else:
        nonce = _grind_search(state, pow_bits, perm_fn, batch)
    tr.absorb(nonce)
    c = tr.challenge()
    if not pow_mask_ok(c, pow_bits):
        raise AssertionError("grind search returned a non-working nonce")
    return nonce


def layer_schedule(n_folds: int) -> list[tuple[int, int]]:
    """Committed FRI layers and their block widths: quad blocks (the
    opened block carries the coset {b, b+m/4, b+m/2, b+3m/4}, verifying
    TWO fold steps per opening) while >= 2 folds remain, a final pair
    block when parity leaves a single fold. Halves the committed tree
    count vs per-fold commitment at equal checkable structure."""
    out, k = [], 1
    while k < n_folds:
        if n_folds - k >= 2:
            out.append((k, 4))
            k += 2
        else:
            out.append((k, 2))
            k += 1
    return out


def layer_positions(q: int, m0: int, sched) -> list[int]:
    """Per committed layer, the opened block position for query q (the
    fold-path index chain: i_1 = q; a (k, bs) layer maps i_k to block
    b = i_k mod (m_k/bs) and re-enters the chain at i_{k+log2(bs)} = b)."""
    i, out = int(q), []
    for k, bs in sched:
        b = i % ((m0 >> k) // bs)
        out.append(b)
        i = b
    return out


# ---------------------------------------------------------------------------
# FRI parameters + folding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FriParams:
    """blowup: inverse code rate (power of two); n_queries: spot checks;
    final_degree: fold until the degree bound reaches this (power of
    two), then ship coefficients directly; pow_bits: proof-of-work
    grinding (the prover searches ~2^pow_bits nonces before query
    sampling, adding pow_bits to the soundness of the query phase —
    ethSTARK's standard lever, here worth ~5 queries' worth of openings
    at blowup 8); zk: Z_H-blind the witness polynomials AND mask the
    DEEP composition with a committed random polynomial so every value
    the proof reveals is statistically independent of the witness (see
    _bounds for the leak ledger — this is the capability dusk-plonk gets
    from KZG's hiding commitments).

    Soundness of the defaults (see security_bits/proven_security_bits):
    35 queries * log2(8) + 16 PoW bits = 121 bits under the standard
    list-decoding-capacity CONJECTURE (delta up to 1 - rate), ~68 bits
    under the PROVEN Johnson bound (delta up to 1 - sqrt(rate)). The
    reference's claimed 117-120-bit level (reference README.md:37,
    "[NCCG]") is matched at the conjectured figure; callers wanting
    ~120 proven bits should use n_queries=70."""

    blowup: int = 8
    n_queries: int = 35
    final_degree: int = 64
    pow_bits: int = 16
    zk: bool = False

    def __post_init__(self):
        for v, name in ((self.blowup, "blowup"),
                        (self.final_degree, "final_degree")):
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name} must be a power of two: {v}")
        if self.blowup < 2:
            raise ValueError("blowup must be >= 2")
        if self.n_queries < 1:
            raise ValueError("n_queries must be >= 1")
        if not 0 <= self.pow_bits <= 32:
            raise ValueError("pow_bits must be in [0, 32]")

    @classmethod
    def proven(cls, target_bits: int = 120, blowup: int = 8,
               pow_bits: int = 20, final_degree: int = 64,
               zk: bool = False) -> "FriParams":
        """Production preset sized by the PROVEN (Johnson-bound)
        soundness figure rather than the list-decoding conjecture: the
        smallest n_queries with proven_security_bits >= target_bits.
        Defaults (blowup 8 / 67 queries / 20 PoW bits) give ~120.5
        PROVEN bits (~221 conjectured) — the apples-to-proven-apples
        counterpart of the reference's claimed 117-120-bit level
        (reference README.md:37, itself a conjectured "[NCCG]" figure
        matched by FriParams()'s 121 conjectured bits). Costs roughly
        67/35 of the default preset in proof bytes and verification
        hashing.

        Targets near/above the field term's ~240-bit Schwartz-Zippel
        cap (see proven_security_bits) are unreachable by adding
        queries and are rejected rather than silently under-delivered."""
        import math

        if not 1 <= target_bits <= 200:
            raise ValueError(
                "target_bits must be in [1, 200]: above that the "
                "field/Schwartz-Zippel term (~240 bits at n=1024, "
                "shrinking with n) caps proven_security_bits no matter "
                "how many queries are added"
            )
        q = math.ceil((target_bits - pow_bits)
                      / (math.log2(blowup) / 2))
        return cls(blowup=blowup, n_queries=max(1, q),
                   final_degree=final_degree, pow_bits=pow_bits, zk=zk)

    def security_bits(self, n: int = 1024) -> float:
        """CONJECTURED soundness in bits for a domain of size n (the
        circuit's padded gate count; enters only through the negligible
        field terms).

        Query soundness: a committed layer-0 vector that is delta-far
        from every degree-<D polynomial survives one transcript-derived
        spot check with probability <= 1 - delta. Taking delta up to
        1 - rate (rate = 1/blowup) — the LIST-DECODING-CAPACITY
        CONJECTURE, the standard operating assumption of deployed STARKs,
        NOT a proven bound — gives n_queries * log2(blowup) bits, plus
        pow_bits from grinding (each transcript attempt costs the
        attacker ~2^pow_bits work). The proven figure is
        proven_security_bits (Johnson bound); tests/test_fri.py asserts
        both. The DEEP/PLONK Schwartz-Zippel terms (challenge collisions
        with roots of the <= 5n-degree identity polynomials over the
        255-bit field) and the Hades-Merkle binding term are
        ~log2(|F|/5n) ~ 240+ bits and never bind."""
        import math

        query_bits = (self.n_queries * math.log2(self.blowup)
                      + self.pow_bits)
        field_bits = math.log2(P / (5 * max(n, 2)))
        return min(query_bits, field_bits)

    def proven_security_bits(self, n: int = 1024) -> float:
        """PROVEN soundness in bits: FRI's per-query error under the
        Johnson bound (delta up to 1 - sqrt(rate), [BCIKS20] "Proximity
        Gaps for Reed-Solomon Codes") is sqrt(rate), i.e.
        log2(blowup)/2 bits per query — half the conjectured rate —
        plus the same pow_bits and field terms. Defaults: ~68 bits
        proven vs 121 conjectured; the gap is the conjecture, not the
        code."""
        import math

        query_bits = (self.n_queries * math.log2(self.blowup) / 2
                      + self.pow_bits)
        field_bits = math.log2(P / (5 * max(n, 2)))
        return min(query_bits, field_bits)


def _bounds(n: int, params: FriParams) -> dict:
    """Per-polynomial coefficient-count bounds d_j and the FRI degree
    bound D (power of two), non-zk and zk.

    zk leak ledger (why these pads suffice; tests/test_fri.py's
    test_zk_leak_ledger enumerates a real proof against it):

      * each committed WITNESS polynomial is directly opened at the 2Q
        query points (x_q, -x_q) and evaluated once at zeta. The
        quotient's opened values t(+-x_q) and claimed t(zeta)
        additionally involve z at the SHIFTED points omega*(+-x_q) and
        omega*zeta — 2Q+1 indirect z evaluations (zw is claimed anyway)
        — while the wires appear there only at already-revealed points.
        Adding r(X)*Z_H(X) with c random coefficients hides any c-1
        revealed off-H evaluations (Z_H != 0 off H, so the revealed
        vector is shifted by a full-rank Vandermonde image of r). Hence
        wires get zkw = 2Q+5 blinding coefficients (2Q+1 revealed),
        z gets zkz = 4Q+9 (4Q+2 revealed).
      * the FRI INTERIOR leaks too: every committed layer's opened block
        and the final coefficients are linear functionals of the DEEP
        composition F at points beyond the query set (the off-path block
        entries fold F over fresh preimage cosets). Blinding the inputs
        does NOT cover these, so zk mode commits an extra uniformly
        random polynomial R of degree < D alongside t and adds it to
        the DEEP batch (the ethSTARK masking construction): every
        layer value is then shifted by the corresponding functional of
        R, which — conditioned on R's own 2Q+1 direct reveals — ranges
        over D - 2Q - 1 free dimensions. _bounds enforces
        2Q*n_folds + final_degree <= D - 2Q - 1 (raises otherwise)."""
    q = params.n_queries
    zkw = 2 * q + 5 if params.zk else 0
    zkz = 4 * q + 9 if params.zk else 0
    d_w = n + zkw
    d_z = n + zkz
    # honest quotient degree: deg t <= (d_z-1) + 4(d_w-1) - n, +1 slack
    # to match plonk._t_degree_bound's 4n-4 in the unblinded case
    d_t = d_z + 4 * d_w - n - 3
    d_cap = max(d_t, d_w, d_z, 2)
    big_d = 1 << (d_cap - 1).bit_length()
    out = {"d_w": d_w, "d_z": d_z, "d_t": d_t, "d_key": n, "D": big_d,
           "zkw": zkw, "zkz": zkz, "zk": params.zk, "d_r": big_d}
    if params.zk:
        fd = min(params.final_degree, big_d // 2)
        n_folds = (big_d // fd).bit_length() - 1
        revealed = 2 * q * n_folds + fd
        mask_dims = big_d - 2 * q - 1
        if revealed > mask_dims:
            raise ValueError(
                "zk mask budget exceeded: the FRI interior reveals "
                f"{revealed} functionals but the masking polynomial has "
                f"only {mask_dims} free dimensions — lower n_queries or "
                "raise final_degree/D"
            )
    return out


def fold_evals(evals: list[int], shift: int, beta: int) -> list[int]:
    """One FRI fold: evaluations of f on shift*H_m -> evaluations of
    f_even + beta*f_odd on shift^2*H_{m/2}, where f(X) = f_even(X^2)
    + X*f_odd(X^2). Uses x_{i+m/2} = -x_i on the half-pairing."""
    m = len(evals)
    half = m // 2
    w_inv = pow(_domain_root(m), P - 2, P)
    x_inv = pow(shift, P - 2, P)
    out = []
    for i in range(half):
        a, b = evals[i], evals[i + half]
        even = (a + b) % P
        odd = (a - b) * x_inv % P
        out.append((even + beta * odd) % P * INV2 % P)
        x_inv = x_inv * w_inv % P
    return out


def _fold_pair(a: int, b: int, beta: int, x: int, inv_of=None) -> int:
    """Verifier-side single fold at x (= the point whose pair is -x).
    inv_of, if given, maps x -> x^{-1} (precomputed via ONE batched
    inversion per verification, _fold_inv_table) instead of a Fermat
    exponentiation per fold step."""
    x_inv = inv_of[x] if inv_of is not None else pow(x, P - 2, P)
    return ((a + b) + beta * (a - b) % P * x_inv) % P * INV2 % P


def _batch_inverse0(vals: list[int]) -> list[int]:
    """batch_inverse with pow(0, P-2, P) == 0 semantics for zero entries
    (the verifier's denominators are attacker-influenced; a zero must
    yield the same garbage-then-reject behavior as the per-term modexp
    it replaces, not an exception)."""
    nz = [v % P or 1 for v in vals]
    inv = batch_inverse(nz)
    return [iv if v % P else 0 for v, iv in zip(vals, inv)]


def _fold_inv_table(queries, m0: int, sched, zeta: int, omega: int) -> dict:
    """Every modular inverse the DEEP + fold phase needs for these
    queries — the layer-0 points +-x_q, their DEEP denominators
    (+-x_q - zeta), (+-x_q - omega*zeta), and each committed layer's
    on-path fold points — computed with ONE batched inversion
    (Montgomery's trick). Keyed by the point itself, so _fold_check /
    _deep_eval just look up what they previously exponentiated (the
    host verifier's per-query algebra was ~half its latency, almost all
    of it Fermat inversions)."""
    zw = zeta * omega % P
    pts = set()
    chains = [layer_positions(q, m0, sched) for q in queries]
    for q in set(int(q) for q in queries):
        x = G0 * _root_pow_at(m0, q) % P
        pts.add(x)
        for y in (x, (P - x) % P):
            pts.add((y - zeta) % P)
            pts.add((y - zw) % P)
    for li, (k, bs) in enumerate(sched):
        m_k = m0 >> k
        npos = m_k // bs
        base = _g0_pow(1 << k)
        wnp = _root_pow_at(m_k, npos)
        for b_pos in {c[li] for c in chains}:
            xk = base * _root_pow_at(m_k, b_pos) % P
            pts.add(xk)
            if bs == 4:
                pts.add(xk * wnp % P)
                pts.add(xk * xk % P)
    pts = sorted(pts)
    return dict(zip(pts, _batch_inverse0(pts)))


# ---------------------------------------------------------------------------
# Keys and proof containers (the HSP2 layout)
# ---------------------------------------------------------------------------

#: Wire order of the per-phase commitment trees. Each tree's leaf block
#: at position j in [0, m0/2) holds the tree's COLUMN polynomials'
#: evaluations at x_j, then at x_{j+m0/2} = -x_j (one opening per query
#: serves both fold inputs AND every polynomial of the phase):
#:   w: the four wire polynomials (committed before beta/gamma)
#:   z: the grand product (committed before alpha)
#:   t: the quotient, plus the zk FRI mask R when params.zk
#:   k: the 10 preprocessed selector/sigma polynomials (preprocessing)
TREE_ORDER = ("w", "z", "t", "k")


def tree_columns(zk: bool) -> dict:
    return {
        "w": ("a", "b", "o", "d"),
        "z": ("z",),
        "t": ("t", "r") if zk else ("t",),
        "k": SELECTOR_NAMES + SIGMA_NAMES,
    }


def eval_order(zk: bool) -> tuple:
    """Transcript order of the claimed evaluations (zk appends the FRI
    mask's R(zeta))."""
    return EVAL_ORDER + (("r",) if zk else ())


@dataclass(eq=False)  # identity hash: ProvingKeys key weak device caches
class ProvingKey:
    key: CircuitKey
    params: FriParams
    key_evals: dict   # selector/sigma name -> L0 evaluation list
    key_levels: list  # the k-tree's digest levels (levels[0] = leaves)
    digest: int

    @property
    def key_root(self) -> int:
        return tree_root(self.key_levels)


@dataclass(frozen=True)
class VerifyingKey:
    """Everything the verifier needs — NO full polynomials (the succinct
    point): domain facts, the statement digest, and the single Merkle
    root of the preprocessed selector/sigma block tree."""

    n: int
    omega: int
    n_gates: int
    digest: int
    k_root: int
    params: FriParams


@dataclass
class FriProof:
    layer_roots: list   # committed layers per layer_schedule
    final_coeffs: list  # <= final_degree coefficients of the last layer
    layer_blocks: list  # per committed layer: (U_k, bs) ints at the
                        # sorted-unique opened block positions
    layer_nodes: list   # per committed layer: (T_k, N_DIGITS) pruned
                        # multiproof digits (multiproof_plan order)


@dataclass
class SuccinctProof:
    """Sublinear proof: roots + claimed evaluations + the PoW nonce +
    FRI transcript + pruned query openings. No full polynomial, no
    positions, no derivable digest ever ships (compare plonk.Proof)."""

    roots: dict         # "w", "z", "t" -> block-tree root int
    evals: dict         # eval_order name -> claimed evaluation
    pow_nonce: int
    fri: FriProof
    open_blocks: dict   # tree name (TREE_ORDER) -> (U0, bs) ints at the
                        # sorted-unique opened positions
    open_nodes: dict    # tree name -> (T, N_DIGITS) pruned digits


def proof_size_field_elements(proof: SuccinctProof) -> int:
    """Proof size in field elements (32 bytes each): roots, evals, FRI
    roots + final coefficients, opened block values, and every shipped
    multiproof digest. The nonce and counts are a few bytes, not
    counted."""
    total = len(proof.roots) + len(proof.evals)
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


# ---------------------------------------------------------------------------
# DEEP composition
# ---------------------------------------------------------------------------


def _terms(bounds: dict):
    """The batched DEEP terms: (poly name, eval name, at-shifted-point?,
    d_j = coefficient-count bound from _bounds)."""
    d_w, d_z, d_t = bounds["d_w"], bounds["d_z"], bounds["d_t"]
    out = [
        ("a", "a", False, d_w),
        ("b", "b", False, d_w),
        ("o", "o", False, d_w),
        ("d", "d", False, d_w),
        ("z", "z", False, d_z),
        ("z", "zw", True, d_z),
        ("t", "t", False, d_t),
    ]
    out += [(s, s, False, bounds["d_key"])
            for s in SELECTOR_NAMES + SIGMA_NAMES]
    if bounds.get("zk"):
        # the FRI masking polynomial rides the same batch: its own degree
        # bound (< D) is enforced for free, and every FRI-interior value
        # is shifted by a fresh functional of it (see _bounds' ledger)
        out.append(("r", "r", False, bounds["d_r"]))
    return out


def _deep_compose_terms(m0: int, d_bound: int, term_list, zeta: int,
                        omega: int, gdeep: int) -> list[int]:
    """Prover: F on L0 from generic terms (e_vector, v, shifted, dj) —
    e_vector the committed polynomial's L0 evaluations, v the claimed
    evaluation at zeta (or omega*zeta when shifted), dj its coefficient-
    count bound. Term order fixes the gdeep power per claim."""
    w = _domain_root(m0)
    xs = []
    x = G0
    for _ in range(m0):
        xs.append(x)
        x = x * w % P
    inv_z = batch_inverse([(x - zeta) % P for x in xs])
    inv_wz = batch_inverse([(x - zeta * omega) % P for x in xs])
    f = [0] * m0
    gpow = 1
    for e, v, shifted, dj in term_list:
        s = d_bound + 1 - dj
        inv = inv_wz if shifted else inv_z
        xp = pow(G0, s, P)
        wstep = pow(w, s, P)
        for i in range(m0):
            f[i] = (f[i] + gpow * xp % P * ((e[i] - v) % P) % P
                    * inv[i]) % P
            xp = xp * wstep % P
        gpow = gpow * gdeep % P
    return f


def _deep_compose(m0: int, bounds: dict, poly_evals: dict, evals: dict,
                  zeta: int, omega: int, gdeep: int) -> list[int]:
    """Prover: F on L0 from each committed polynomial's L0 evaluations."""
    term_list = [
        (poly_evals[pname], evals[ename], shifted, dj)
        for pname, ename, shifted, dj in _terms(bounds)
    ]
    return _deep_compose_terms(m0, bounds["D"], term_list, zeta, omega,
                               gdeep)


def _deep_eval_terms(x: int, d_bound: int, term_list, zeta: int,
                     omega: int, gdeep: int, inv_of=None, pos=None) -> int:
    """Verifier: F at one query point from generic terms
    (opened_value, v, shifted, dj); same order as _deep_compose_terms.
    inv_of (see _fold_inv_table) replaces the two per-point Fermat
    inversions; the degree-shift powers x^s are shared across the terms
    with equal bounds (only ~5 distinct exponents). pos=(m0, p) asserts
    x == G0 * w_m0^p, turning each x^s modexp into two cached-table
    lookups (x^s = G0^s * w^(p*s mod m0)); callers with arbitrary x
    omit it."""
    zw = zeta * omega % P
    den_z, den_wz = (x - zeta) % P, (x - zw) % P
    if inv_of is not None:
        inv_z, inv_wz = inv_of[den_z], inv_of[den_wz]
    else:
        inv_z = pow(den_z, P - 2, P)
        inv_wz = pow(den_wz, P - 2, P)
    xpow: dict[int, int] = {}
    acc = 0
    gpow = 1
    for opened, v, shifted, dj in term_list:
        s = d_bound + 1 - dj
        xs = xpow.get(s)
        if xs is None:
            if pos is not None:
                xs = _g0_pow(s) * _root_pow_at(pos[0], pos[1] * s) % P
            else:
                xs = pow(x, s, P)
            xpow[s] = xs
        diff = (opened - v) % P
        term = xs * diff % P * (inv_wz if shifted else inv_z) % P
        acc = (acc + gpow * term) % P
        gpow = gpow * gdeep % P
    return acc


def _deep_eval(x: int, bounds: dict, opened: dict, evals: dict, zeta: int,
               omega: int, gdeep: int, inv_of=None, pos=None) -> int:
    """Verifier: F at one query point from the opened leaf values."""
    term_list = [
        (opened[pname], evals[ename], shifted, dj)
        for pname, ename, shifted, dj in _terms(bounds)
    ]
    return _deep_eval_terms(x, bounds["D"], term_list, zeta, omega, gdeep,
                            inv_of, pos)


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------


def _commit_paired(eval_lists, perm_fn) -> list:
    """Commit a phase's column polynomials as ONE paired-block tree:
    position j in [0, m0/2) holds every column's evaluation at x_j, then
    every column's at x_{j+m0/2} = -x_j — so a single opening per query
    serves all the phase's polynomials AND both inputs of the first FRI
    fold. Returns the digest levels (levels[0] = the leaf digests)."""
    m0 = len(eval_lists[0])
    half = m0 // 2
    cols = [ints_to_digits(list(e), shape=(m0,)) for e in eval_lists]
    arr = np.stack(cols, axis=1)  # (m0, C, N_DIGITS)
    blocks = np.concatenate([arr[:half], arr[half:]], axis=1)
    return tree_build_digits(block_digests(blocks, perm_fn), perm_fn)


def _open_paired(eval_lists, levels, s0):
    """(blocks, nodes) opening the paired tree at the sorted-unique
    positions s0: blocks (U0, 2C) claimed ints, nodes the pruned
    multiproof digits."""
    half = len(eval_lists[0]) // 2
    blocks = [
        [e[j] for e in eval_lists] + [e[j + half] for e in eval_lists]
        for j in s0
    ]
    return blocks, multiproof_open(levels, s0)


def preprocess_succinct(composer_or_key, params: FriParams | None = None,
                        perm_fn=None):
    """Commit the preprocessed circuit: (ProvingKey, VerifyingKey).

    The reference analogue is Compiler::compile producing (prover,
    verifier) keys (gadget.rs:198-205); here the verifier key carries
    ONE Merkle root of the paired selector/sigma block tree over L0
    instead of KZG commitments."""
    params = params or FriParams()
    key = (composer_or_key if isinstance(composer_or_key, CircuitKey)
           else preprocess(composer_or_key))
    if perm_fn is None:
        perm_fn = default_pcs_perm()
    m0 = params.blowup * _bounds(key.n, params)["D"]
    key_evals = {}
    for name in SELECTOR_NAMES:
        key_evals[name] = _coset_eval(list(key.selectors[name]), m0, G0)
    for i, name in enumerate(SIGMA_NAMES):
        key_evals[name] = _coset_eval(list(key.sigmas[i]), m0, G0)
    k_cols = tree_columns(False)["k"]
    key_levels = _commit_paired([key_evals[c] for c in k_cols], perm_fn)
    digest = key_digest(key)
    pk = ProvingKey(key=key, params=params, key_evals=key_evals,
                    key_levels=key_levels, digest=digest)
    vk = VerifyingKey(
        n=key.n, omega=key.omega, n_gates=key.n_gates, digest=digest,
        k_root=tree_root(key_levels), params=params,
    )
    return pk, vk


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


def _rand_field_fn(rng):
    if rng is None:
        import secrets

        return lambda: secrets.randbelow(P)
    return lambda: int.from_bytes(rng.bytes(40), "little") % P


def _blind(poly, n: int, n_coeffs: int, rand_field) -> list[int]:
    """poly + r(X)*(X^n - 1) with deg r < n_coeffs: unchanged on H (so
    every PLONK identity survives), while the n_coeffs fresh random
    coefficients statistically hide up to n_coeffs-1 revealed off-H
    evaluations (Z_H is nonzero there, so the revealed vector is shifted
    by a full-rank Vandermonde image of r)."""
    out = list(poly) + [0] * (n + n_coeffs - len(poly))
    for k in range(n_coeffs):
        r = rand_field()
        out[k + n] = (out[k + n] + r) % P
        out[k] = (out[k] - r) % P
    return out


def _fri_commit(tr: Transcript, f: list[int], m0: int, n_folds: int,
                final_degree: int, sched, perm_fn):
    """FRI commit phase: fold the composition n_folds times, committing
    the scheduled layers (quad/pair blocks, layer_schedule) into the
    transcript. Returns (layer_coms, final_coeffs) with layer_coms =
    [(k, bs, evals, levels)]."""
    committed = dict(sched)
    layer_coms = []
    cur, shift = f, G0
    for k in range(1, n_folds + 1):
        beta_k = tr.challenge()
        cur = fold_evals(cur, shift, beta_k)
        shift = shift * shift % P
        bs = committed.get(k)
        if bs:
            npos = len(cur) // bs
            # block b holds the fold coset {b + t*npos : t < bs}
            digits = np.stack(
                [ints_to_digits(cur[t * npos : (t + 1) * npos],
                                shape=(npos,)) for t in range(bs)],
                axis=1,
            )
            levels = tree_build_digits(block_digests(digits, perm_fn),
                                       perm_fn)
            layer_coms.append((k, bs, cur, levels))
            tr.absorb(tree_root(levels))
    final_coeffs = _coset_interp(cur, shift)
    if any(c % P for c in final_coeffs[final_degree:]):
        # the DEEP composition is only a degree-<D polynomial when every
        # claimed evaluation is true and every committed polynomial meets
        # its degree bound — for an unsatisfiable witness the quotient
        # "polynomial" fails its bound and the folds can't reach the
        # final degree: an honest prover cannot emit a proof at all
        raise ValueError(
            "FRI final layer exceeds its degree bound — the witness does "
            "not satisfy the circuit (the quotient is not a polynomial)"
        )
    final_coeffs = final_coeffs[:final_degree]
    tr.absorb(*final_coeffs)
    return layer_coms, final_coeffs


def _fri_proof(layer_coms, final_coeffs, queries, m0: int,
               sched) -> FriProof:
    """Committed-layer openings along each query's fold path: per layer,
    the blocks at the sorted-unique opened positions + one pruned
    multiproof."""
    pos_chains = [layer_positions(q, m0, sched) for q in queries]
    layer_blocks, layer_nodes, layer_roots = [], [], []
    for li, (k, bs, evals, levels) in enumerate(layer_coms):
        npos = (m0 >> k) // bs
        s_k = sorted({pc[li] for pc in pos_chains})
        layer_blocks.append(
            [[evals[b + t * npos] for t in range(bs)] for b in s_k]
        )
        layer_nodes.append(multiproof_open(levels, s_k))
        layer_roots.append(tree_root(levels))
    return FriProof(
        layer_roots=layer_roots,
        final_coeffs=final_coeffs,
        layer_blocks=layer_blocks,
        layer_nodes=layer_nodes,
    )


def prove_succinct(composer, pk: ProvingKey, perm_fn=None,
                   rng=None) -> SuccinctProof:
    """Produce the succinct argument for the composer's witness (the
    reference analogue: prover.prove via KZG, gadget.rs:217). With
    pk.params.zk the witness polynomials are Z_H-blinded and the DEEP
    composition is masked by a fresh committed random polynomial (rng:
    an optional np.random.Generator for deterministic tests; default
    uses the OS CSPRNG)."""
    if perm_fn is None:
        perm_fn = default_pcs_perm()
    key, params = pk.key, pk.params
    n, omega = key.n, key.omega
    bounds = _bounds(n, params)
    d_bound = bounds["D"]
    m0 = params.blowup * d_bound
    half0 = m0 // 2
    final_degree = min(params.final_degree, d_bound // 2)
    n_folds = (d_bound // final_degree).bit_length() - 1
    sched = layer_schedule(n_folds)
    cols = tree_columns(params.zk)

    wire_evals, wires = _wire_polys(composer, key)
    pi_col = _public_input_column(composer, n)
    rand_field = _rand_field_fn(rng)
    if params.zk:
        wires = tuple(_blind(w, n, bounds["zkw"], rand_field)
                      for w in wires)

    from .plonk import statement_digest

    tr = Transcript()
    tr.absorb(statement_digest(pk.digest, pi_col))

    poly_evals: dict[str, list] = {}
    levels: dict[str, list] = {}
    roots: dict[str, int] = {}
    for name, poly in zip("abod", wires):
        poly_evals[name] = _coset_eval(list(poly), m0, G0)
    levels["w"] = _commit_paired([poly_evals[c] for c in cols["w"]],
                                 perm_fn)
    roots["w"] = tree_root(levels["w"])
    tr.absorb(roots["w"])
    beta = tr.challenge()
    gamma = tr.challenge()

    z = _grand_product(wire_evals, key, beta, gamma)
    if params.zk:
        z = _blind(z, n, bounds["zkz"], rand_field)
    poly_evals["z"] = _coset_eval(list(z), m0, G0)
    levels["z"] = _commit_paired([poly_evals["z"]], perm_fn)
    roots["z"] = tree_root(levels["z"])
    tr.absorb(roots["z"])
    alpha = tr.challenge()

    # quotient of the (possibly blinded) polynomials — the identities hold
    # on H exactly as before, but the degree needs the larger coset
    t = _quotient(key, wires, z, pi_col, beta, gamma, alpha, m=d_bound)
    poly_evals["t"] = _coset_eval(list(t), m0, G0)
    r_poly = None
    if params.zk:
        # the FRI masking polynomial (see _bounds' ledger): uniformly
        # random of degree < D, committed alongside t
        r_poly = [rand_field() for _ in range(d_bound)]
        poly_evals["r"] = _coset_eval(list(r_poly), m0, G0)
    levels["t"] = _commit_paired([poly_evals[c] for c in cols["t"]],
                                 perm_fn)
    roots["t"] = tree_root(levels["t"])
    tr.absorb(roots["t"])
    zeta = tr.challenge()

    evals = {
        "a": poly_eval(wires[0], zeta),
        "b": poly_eval(wires[1], zeta),
        "o": poly_eval(wires[2], zeta),
        "d": poly_eval(wires[3], zeta),
        "z": poly_eval(z, zeta),
        "zw": poly_eval(z, zeta * omega % P),
        "t": poly_eval(t, zeta),
    }
    for name in SELECTOR_NAMES:
        evals[name] = poly_eval(key.selectors[name], zeta)
    for i, name in enumerate(SIGMA_NAMES):
        evals[name] = poly_eval(key.sigmas[i], zeta)
    if params.zk:
        evals["r"] = poly_eval(r_poly, zeta)
    tr.absorb(*[evals[name] for name in eval_order(params.zk)])
    gdeep = tr.challenge()

    all_evals = dict(poly_evals)
    all_evals.update(pk.key_evals)
    f = _deep_compose(m0, bounds, all_evals, evals, zeta, omega, gdeep)

    layer_coms, final_coeffs = _fri_commit(tr, f, m0, n_folds,
                                           final_degree, sched, perm_fn)

    pow_nonce = grind_transcript(tr, params.pow_bits, perm_fn)
    queries = [tr.challenge() % half0 for _ in range(params.n_queries)]
    s0 = sorted(set(queries))

    open_blocks, open_nodes = {}, {}
    for tname in ("w", "z", "t"):
        open_blocks[tname], open_nodes[tname] = _open_paired(
            [poly_evals[c] for c in cols[tname]], levels[tname], s0
        )
    open_blocks["k"], open_nodes["k"] = _open_paired(
        [pk.key_evals[c] for c in cols["k"]], pk.key_levels, s0
    )

    fri = _fri_proof(layer_coms, final_coeffs, queries, m0, sched)
    return SuccinctProof(
        roots=roots,
        evals=evals,
        pow_nonce=pow_nonce,
        fri=fri,
        open_blocks=open_blocks,
        open_nodes=open_nodes,
    )


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


def _pi_eval(public_inputs, n_gates: int, n: int, omega: int,
             zeta: int, zh_z: int) -> int:
    """interp(PI)(zeta) by barycentric evaluation over the NONZERO public
    inputs only — O(#PI), not O(n) (L_i(zeta) = Z_H(zeta) omega^i /
    (n (zeta - omega^i)))."""
    terms = [(i, v % P) for i, v in enumerate(public_inputs[:n_gates])
             if v % P]
    if not terms:
        return 0
    # vk.omega is always the order-n domain root (plonk.preprocess), so
    # the cached powers table applies — the gadget circuits put an ARK
    # constant on most gates' public-input column, so this loop runs
    # over ~n_gates nonzero terms. Guarded for robustness.
    if omega == _domain_root(n):
        omega_pows = {i: _root_pow_at(n, i) for i, _ in terms}
    else:
        omega_pows = {i: pow(omega, i, P) for i, _ in terms}
    dens = [n * (zeta - omega_pows[i]) % P for i, _ in terms]
    invs = batch_inverse(dens)
    acc = 0
    for (i, v), inv in zip(terms, invs):
        acc = (acc + v * omega_pows[i] % P * inv) % P
    return acc * zh_z % P


def verify_succinct(vk: VerifyingKey, proof: SuccinctProof,
                    public_inputs, perm_fn=None) -> bool:
    """Check the succinct argument (reference analogue: verifier.verify,
    gadget.rs:220). The verifier touches NO full polynomial: its work is
    the transcript, the zeta identity over claimed evaluations, and
    n_queries Merkle/fold spot checks. One-proof form of
    verify_succinct_batched (identical acceptance set)."""
    return bool(
        verify_succinct_batched(vk, [proof], [public_inputs], perm_fn)[0]
    )


def _zeta_identity_ok(vk: VerifyingKey, ev: dict, pi, zeta: int, beta: int,
                      gamma: int, alpha: int) -> bool:
    """The PLONK identity at zeta over claimed evaluations (ev carries
    every EVAL_ORDER name, already reduced mod P; pi truncated to the
    gate count)."""
    n, omega = vk.n, vk.omega
    zh_z = (pow(zeta, n, P) - 1) % P
    if zh_z == 0:
        return False
    pi_z = _pi_eval(pi, vk.n_gates, n, omega, zeta, zh_z)
    l1_z = zh_z * pow(n * (zeta - 1) % P, P - 2, P) % P
    gate = (
        ev["q_m"] * ev["a"] % P * ev["b"]
        + ev["q_l"] * ev["a"]
        + ev["q_r"] * ev["b"]
        + ev["q_o"] * ev["o"]
        + ev["q_4"] * ev["d"]
        + ev["q_c"]
        + pi_z
    ) % P
    num, den = ev["z"], ev["zw"]
    for c, name in enumerate(("a", "b", "o", "d")):
        num = num * (ev[name] + beta * K_SHIFTS[c] * zeta + gamma) % P
        den = den * (ev[name] + beta * ev[SIGMA_NAMES[c]] + gamma) % P
    perm = (num - den) % P
    boundary = l1_z * (ev["z"] - 1) % P
    combined = (gate + alpha * perm + alpha * alpha % P * boundary) % P
    return combined == ev["t"] * zh_z % P


def proof_schema(n: int, params: FriParams) -> dict:
    """Shared shape facts (prover / verifier / serializer): degree
    bounds, the L0 size, effective final degree, fold count, committed-
    layer schedule, and tree heights."""
    bounds = _bounds(n, params)
    d_bound = bounds["D"]
    m0 = params.blowup * d_bound
    final_degree = min(params.final_degree, d_bound // 2)
    n_folds = (d_bound // final_degree).bit_length() - 1
    sched = layer_schedule(n_folds)
    return {
        "bounds": bounds,
        "m0": m0,
        "half0": m0 // 2,
        "final_degree": final_degree,
        "n_folds": n_folds,
        "sched": sched,
        "h_pos": _tree_height(m0 // 2),
        "layer_heights": [_tree_height((m0 >> k) // bs)
                          for (k, bs) in sched],
    }


def _check_opening(blocks, nodes, s_idx, bs: int, height: int):
    """Normalize + structurally validate one pruned opening; returns
    ([[int]], nodes (T, N_DIGITS)) or None. Node digits must be
    canonical (16-bit digits, value < p) — the digit contract of every
    permutation backend; rejecting here keeps host and fused-device
    verdicts identical for programmatically constructed non-canonical
    proofs (wire deserialization already enforces this)."""
    if blocks is None or nodes is None:
        return None
    if len(blocks) != len(s_idx) or any(len(b) != bs for b in blocks):
        return None
    nodes = np.asarray(nodes, np.uint32)
    if nodes.ndim != 2 or nodes.shape[1] != N_DIGITS:
        return None
    if nodes.shape[0] != multiproof_nodes_total(s_idx, height):
        return None
    if nodes.size:
        from .utils.encoding import check_canonical_digits

        if bool((nodes >> 16).any()):
            return None
        try:
            check_canonical_digits(nodes, "non-canonical")
        except ValueError:
            return None
    return [[int(v) % P for v in b] for b in blocks], nodes


def _verify_prepare(vk: VerifyingKey, proof: SuccinctProof, public_inputs,
                    shapes: dict):
    """Per-proof host algebra: structural checks, transcript replay
    (including the proof-of-work check), and the PLONK zeta identity.
    Returns the context the Merkle/fold phases need, or None if the
    proof is already rejected."""
    n, omega, params = vk.n, vk.omega, vk.params
    n_folds, half0, final_degree, sched = (
        shapes["n_folds"], shapes["half0"], shapes["final_degree"],
        shapes["sched"],
    )
    names = eval_order(params.zk)

    if sorted(proof.evals) != sorted(names):
        return None
    if sorted(proof.roots) != sorted(("w", "z", "t")):
        return None
    if len(proof.fri.final_coeffs) > final_degree:
        return None
    if any(
        len(part) != len(sched)
        for part in (proof.fri.layer_roots, proof.fri.layer_blocks,
                     proof.fri.layer_nodes)
    ):
        return None

    # 1. replay the transcript (the statement: PI column truncated to the
    # gate count and padded to the domain, exactly as the prover absorbed)
    from .plonk import statement_digest

    pi = [int(v) % P for v in public_inputs][:vk.n_gates]
    tr = Transcript()
    tr.absorb(statement_digest(vk.digest, pi + [0] * (n - len(pi))))
    tr.absorb(proof.roots["w"])
    beta = tr.challenge()
    gamma = tr.challenge()
    tr.absorb(proof.roots["z"])
    alpha = tr.challenge()
    tr.absorb(proof.roots["t"])
    zeta = tr.challenge()
    tr.absorb(*[proof.evals[name] % P for name in names])
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
    # proof-of-work gate: the nonce must make this challenge end in
    # pow_bits zeros, or query sampling never happens
    tr.absorb(int(proof.pow_nonce))
    if not pow_mask_ok(tr.challenge(), params.pow_bits):
        return None
    queries = [tr.challenge() % half0 for _ in range(params.n_queries)]

    # 2. the PLONK identity at zeta over the claimed evaluations
    ev = {name: proof.evals[name] % P for name in names}
    if not _zeta_identity_ok(vk, ev, pi, zeta, beta, gamma, alpha):
        return None

    # 3. structural validation of every pruned opening (indices are
    # DERIVED from the transcript — nothing position-like is read from
    # the proof)
    cols = tree_columns(params.zk)
    s0 = sorted(set(queries))
    pos_chains = [layer_positions(q, m0=shapes["m0"], sched=sched)
                  for q in queries]
    blocks_by = {}
    tree_nodes = {}
    for tname in TREE_ORDER:
        checked = _check_opening(
            proof.open_blocks.get(tname), proof.open_nodes.get(tname),
            s0, 2 * len(cols[tname]), shapes["h_pos"],
        )
        if checked is None:
            return None
        blocks, nodes = checked
        blocks_by[tname] = dict(zip(s0, blocks))
        tree_nodes[tname] = nodes
    s_ks, layer_by, layer_nodes = [], [], []
    for li, (k, bs) in enumerate(sched):
        s_k = sorted({pc[li] for pc in pos_chains})
        checked = _check_opening(
            proof.fri.layer_blocks[li], proof.fri.layer_nodes[li],
            s_k, bs, shapes["layer_heights"][li],
        )
        if checked is None:
            return None
        blocks, nodes = checked
        s_ks.append(s_k)
        layer_by.append(dict(zip(s_k, blocks)))
        layer_nodes.append(nodes)
    return {
        "queries": queries, "betas": betas, "gdeep": gdeep, "zeta": zeta,
        "ev": ev, "s0": s0, "s_ks": s_ks, "blocks_by": blocks_by,
        "tree_nodes": tree_nodes, "layer_by": layer_by,
        "layer_nodes": layer_nodes,
    }


def verify_succinct_batched(vk: VerifyingKey, proofs, public_inputs_list,
                            perm_fn=None, entries_check=None,
                            timings: dict | None = None) -> np.ndarray:
    """Verify MANY succinct proofs against one verifying key with pooled
    Merkle hashing: every proof's every tree (phase trees, the key tree,
    the FRI layer trees) becomes one pruned-multiproof entry, and ALL
    entries' per-level hash groups ride the same batched permutation
    calls (multiproof_verify_many) — the call count is the maximum tree
    height, independent of the batch size. Leaf-block sponge digests are
    pooled per tree kind the same way. Per-proof transcript replay and
    the zeta/fold algebra stay host-side. Returns a (B,) bool array;
    entry b is exactly verify_succinct(vk, proofs[b],
    public_inputs_list[b]).

    entries_check: optional backend for the pooled sponge+multiproof
    phase — callable(entries) -> (len(entries),) bool, entries as in
    pooled_entries_verify (the default). A fused device twin may be
    passed here; verdicts must be identical.

    timings: optional dict; on return it carries the per-phase wall
    seconds {"prepare_s": transcript replay + structural checks + the
    zeta identity, "merkle_s": pooled leaf sponges + multiproof climbs,
    "algebra_s": the per-query DEEP/fold/final-poly algebra}."""
    import time as _time

    if len(proofs) != len(public_inputs_list):
        raise ValueError("one public-input list per proof required")
    if perm_fn is None:
        perm_fn = default_pcs_perm()
    n_proofs = len(proofs)
    verdict = np.zeros(n_proofs, bool)
    if timings is not None:
        timings.update(prepare_s=0.0, merkle_s=0.0, algebra_s=0.0)
    if not n_proofs:
        return verdict

    n, omega, params = vk.n, vk.omega, vk.params
    shapes = proof_schema(n, params)
    bounds = shapes["bounds"]
    m0, n_folds, sched = shapes["m0"], shapes["n_folds"], shapes["sched"]
    cols = tree_columns(params.zk)

    t0 = _time.perf_counter()
    ctx = [
        _verify_prepare(vk, proof, pis, shapes)
        for proof, pis in zip(proofs, public_inputs_list)
    ]
    if timings is not None:
        timings["prepare_s"] = _time.perf_counter() - t0
    alive = [b for b in range(n_proofs) if ctx[b] is not None]
    if not alive:
        return verdict

    # 4. pooled leaf digests + ONE pooled multiproof pass over every
    # (proof, tree) pair
    t0 = _time.perf_counter()
    entries, owners = [], []

    def add_entries(gid, height, root_of, blocks_of, idx_of, nodes_of):
        for b in alive:
            blocks = ints_to_digits(
                [v for blk in blocks_of(b) for v in blk],
                shape=(len(blocks_of(b)), len(blocks_of(b)[0])),
            )
            entries.append((gid, root_of(b), blocks, idx_of(b),
                            nodes_of(b), height))
            owners.append(b)

    for gid, tname in enumerate(TREE_ORDER):
        add_entries(
            gid,
            shapes["h_pos"],
            (lambda b, t=tname: vk.k_root if t == "k"
             else proofs[b].roots[t]),
            (lambda b, t=tname: [ctx[b]["blocks_by"][t][pos]
                                 for pos in ctx[b]["s0"]]),
            (lambda b: ctx[b]["s0"]),
            (lambda b, t=tname: ctx[b]["tree_nodes"][t]),
        )
    for li in range(len(sched)):
        add_entries(
            len(TREE_ORDER) + li,
            shapes["layer_heights"][li],
            (lambda b, li=li: proofs[b].fri.layer_roots[li]),
            (lambda b, li=li: [ctx[b]["layer_by"][li][pos]
                               for pos in ctx[b]["s_ks"][li]]),
            (lambda b, li=li: ctx[b]["s_ks"][li]),
            (lambda b, li=li: ctx[b]["layer_nodes"][li]),
        )
    if entries_check is None:
        ok = pooled_entries_verify(entries, perm_fn)
    else:
        ok = entries_check(entries)
    failed = {b for b, good in zip(owners, ok) if not good}
    if timings is not None:
        timings["merkle_s"] = _time.perf_counter() - t0

    # 5. fold each query through the layers to the final polynomial
    t0 = _time.perf_counter()
    for b in alive:
        if b in failed:
            continue
        c = ctx[b]
        ev, zeta, gdeep = c["ev"], c["zeta"], c["gdeep"]
        inv_of = _fold_inv_table(c["queries"], m0, sched, zeta, omega)

        def deep_pair(qi, x, c=c, ev=ev, zeta=zeta, gdeep=gdeep,
                      inv_of=inv_of):
            q = c["queries"][qi]
            opened_lo, opened_hi = {}, {}
            for tname, colnames in cols.items():
                blk = c["blocks_by"][tname][q]
                nc = len(colnames)
                for ci, pname in enumerate(colnames):
                    opened_lo[pname] = blk[ci]
                    opened_hi[pname] = blk[nc + ci]
            # positions: x = G0*w^q, -x = G0*w^(q + m0/2) — lets
            # _deep_eval take its degree-shift powers from the cached
            # root tables instead of two modexps per term bound
            f_lo = _deep_eval(x, bounds, opened_lo, ev, zeta, omega, gdeep,
                              inv_of, pos=(m0, q))
            f_hi = _deep_eval((P - x) % P, bounds, opened_hi, ev, zeta,
                              omega, gdeep, inv_of, pos=(m0, q + m0 // 2))
            return f_lo, f_hi

        verdict[b] = _fold_check(
            c["queries"], c["betas"], m0, n_folds, sched, c["layer_by"],
            proofs[b].fri.final_coeffs, deep_pair, inv_of,
        )
    if timings is not None:
        timings["algebra_s"] = _time.perf_counter() - t0
    return verdict


def _fold_check(queries, betas, m0: int, n_folds: int, sched, layer_by,
                final_coeffs, deep_pair_fn, inv_of=None) -> bool:
    """Fold every query through the committed layers to the final
    polynomial. deep_pair_fn(qi, x) -> (F(x), F(-x)) from the opened
    layer-0 blocks; layer_by[li] maps a committed layer's opened block
    position to its bs claimed values (the fold coset {b + t*npos}).
    Quad blocks verify two fold steps per opening: the running value
    must equal the block's on-path entry, then both in-block pairs fold
    (same beta) and the two results fold once more. inv_of: the
    precomputed inverse table (_fold_inv_table); without it every fold
    pays a Fermat exponentiation."""
    for qi, q in enumerate(queries):
        x = G0 * _root_pow_at(m0, q) % P
        f_lo, f_hi = deep_pair_fn(qi, x)
        v = _fold_pair(f_lo, f_hi, betas[0], x, inv_of)
        i = q  # position in layer 1 (size m0/2)
        for li, (k, bs) in enumerate(sched):
            m_k = m0 >> k
            npos = m_k // bs
            b_pos = i % npos
            block = layer_by[li].get(b_pos)
            if block is None:
                return False
            if block[i // npos] != v:
                return False
            xk = _g0_pow(1 << k) * _root_pow_at(m_k, b_pos) % P
            if bs == 4:
                # pairs (slot0, slot2) at x_k and (slot1, slot3) at
                # x_k * w^{m/4}; their folds land at (b, b + m'/2) with
                # coordinates (x_k^2, -x_k^2)
                x1 = xk * _root_pow_at(m_k, npos) % P
                u0 = _fold_pair(block[0], block[2], betas[k], xk, inv_of)
                u1 = _fold_pair(block[1], block[3], betas[k], x1, inv_of)
                v = _fold_pair(u0, u1, betas[k + 1], xk * xk % P, inv_of)
            else:
                v = _fold_pair(block[0], block[1], betas[k], xk, inv_of)
            i = b_pos
        m_l = m0 >> n_folds
        x_final = (_g0_pow(1 << n_folds)
                   * _root_pow_at(m_l, i % m_l) % P)
        if v != poly_eval(list(final_coeffs), x_final):
            return False
    return True
