"""The succinct argument's device side: the counterpart of
`hades252_tpu/fri_tpu.py`.

Four parts live here.

* `device_pool_perm`: the card's permutation seam for the host-orchestrated
  paths of `fri` and `aggregate`. Their commitment trees, leaf-block
  sponges, proof-of-work grinding and pooled multiproof checks all take a
  batched canonical `perm_fn`, and this one runs the hand-written kernels.
* `prove_succinct_device_batch` / `prove_succinct_device`: the
  device-resident succinct prover (`fri_tpu.py:93-1179`). It re-executes
  `fri.prove_succinct`'s protocol with every O(m0)-sized object on the
  device as (..., 16) int32 digit tensors with a leading instance axis:
    - the wire, grand-product and quotient polynomials come from
      `prover_cuda`'s three phases, their coset evaluations on L0 from
      `ops/ntt.py`;
    - each phase's paired-block commitment tree (leaf-block sponges, then
      every arity-4 level) is one batched permutation call a sponge chunk
      and a level, for all B instances together; only the roots cross to
      the host transcripts;
    - all claimed evaluations are one device evaluation and one fetch;
    - the DEEP composition and its inversions are pointwise field ops
      (`ops/field_cuda.py`: one kernel launch each on the card);
    - the whole FRI commit phase (per fold: the challenge from an in-trace
      transcript, the fold, and on the scheduled layers the block tree and
      its root's absorb) is one CUDA graph a shape on the card, the
      counterpart of the one jitted program `_fri_phase_dev`; the host
      `plonk.Transcript`s resume from the returned sponge states;
    - proof-of-work grinding tries a window of nonces for every instance
      in one permutation call;
    - opened blocks and pruned multiproof nodes are gathers, one fetch a
      tree.
  Every permutation goes through the kernel of `schedule`
  (`perm_cuda.permute_cuda`); there is no host fallback. On a CPU tensor
  the same code runs the kernel's plain version, which is how the tests
  hold it to the JAX package. Each proof is byte-identical to
  `fri.prove_succinct`'s for the same (composer, pk, rng).
* `prove_aggregate_device`: the same protocol for one aggregated argument
  over B instances (`fri_tpu.py:1187-1465`), byte-identical to
  `aggregate.prove_aggregate`'s.
* The device verifiers (`fri_tpu.py:1467-1821`): `device_chain_fn`, the
  sibling chain of compact openings, and `fused_entries_check`, the whole
  pooled leaf-sponge and multiproof phase of `fri.verify_succinct_batched`
  and `aggregate.verify_aggregate` run blind from a host gather plan, each
  one CUDA graph a shape on the card; `verify_succinct_device_batch` and
  `verify_aggregate_device` give the host verifiers' verdicts;
  `mesh_chain_fn` shards the sibling chain over a mesh.

The provers take the JAX package's `mesh` (a `parallel/dist.Mesh`): their
three polynomial phases then shard over the instances
(`_select_phases`, `fri_tpu.py:827`). The sharded phases already return
global tensors, so `fri_tpu._unshard` has no counterpart.

The JAX package pads every permutation batch to the kernel's block so that
the TPU keeps one executable; the CUDA kernels mask their tail, so nothing
is padded here.

The provers mark their stages with spans (utils/metrics.span): `fri.witness`
(the three phases and blinding), `fri.coset` (the coset evaluations on L0),
`fri.commit` (each paired-block tree and its root), `fri.evals`, `fri.deep`
with `fri.deep.invert` inside, `fri.fold` (the FRI phase and its roots),
`fri.grind`, `fri.open` (the device trees' openings), `fri.fetch` (each copy
to the host, inside the others) and `fri.host` (transcripts, the final
interpolation, the key tree's host openings, assembly).
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from . import aggregate, fri, plonk, prover_cuda
from .aggregate import (
    KEY_EVAL_ORDER,
    WIRE_EVAL_ORDER,
    AggregateProof,
    _absorb_statement,
    _agg_terms,
)
from .fri import (
    ARITY,
    DIGEST_INDEX,
    G0,
    SELECTOR_NAMES,
    SIGMA_NAMES,
    TREE_ORDER,
    FriProof,
    ProvingKey,
    SuccinctProof,
    _tree_height,
    eval_order,
    layer_positions,
    tree_columns,
)
from .models.merkle import chain_nodes, node_hash
from .models.sponge import absorb
from .ops import field_cuda, ntt, resolve_device
from .ops.perm_cuda import DEFAULT_SCHEDULE, _check_schedule, permute_cuda
from .params import N_DIGITS, P, R, int_to_digits
from .plonk import Transcript, _domain_root, statement_digest
from .prover_cuda import _select_phases, _to_device
from .utils import metrics
from .utils.encoding import digits_to_ints, ints_to_digits
from .utils.graphs import _GRAPHS, CudaGraph


def _entry_device(who: str, schedule: str, device, mesh=None) -> torch.device:
    """An entry point's device after checking its schedule: with a mesh
    (parallel/dist.Mesh) the mesh's, which `device` may not contradict;
    else ops.resolve_device's."""
    _check_schedule(schedule)
    if mesh is not None:
        from .parallel.dist import mesh_device

        return mesh_device(mesh, device)
    return resolve_device(who, device)


def device_pool_perm(schedule: str = DEFAULT_SCHEDULE, device="cuda"):
    """A batched canonical permutation for `fri` and `aggregate`'s
    `perm_fn`: (B, WIDTH, N_DIGITS) uint32 digits in, the same out,
    through the CUDA kernel of `schedule` on the card. It runs on the
    card unless the caller asks for the CPU (device="cpu": the kernel's
    plain version, for the tests); without a card it raises, and it never
    falls back to the native engine or to the plain version."""
    dev = _entry_device("device_pool_perm", schedule, device)

    def perm(states):
        x = torch.from_numpy(np.asarray(states, np.uint32).astype(np.int32)).to(dev)
        return permute_cuda(x, schedule=schedule).cpu().numpy().astype(np.uint32)

    return perm


def _perm_fn(schedule: str):
    """(B, WIDTH, N_DIGITS) int32 canonical states -> the same, through the
    kernel of `schedule` on their device (the plain version on the CPU)."""

    def perm(states: torch.Tensor) -> torch.Tensor:
        return permute_cuda(states, schedule=schedule)

    return perm


# ---------------------------------------------------------------------------
# Host-side constant tables (Montgomery digit arrays) and their device copies
# ---------------------------------------------------------------------------

#: Proof shapes whose O(m0) tables are kept at once, as `fri._root_pows`
#: bounds its own: a prover that meets many circuit sizes holds at most
#: this many L0 point tables, five x^s tables and sixteen fold tables a
#: shape (the JAX package's are unbounded `functools.cache`s).
_SHAPES = 4


@functools.lru_cache(maxsize=_SHAPES)
def _xs_digits(m0: int) -> np.ndarray:
    """(m0, D) canonical digits of the L0 points x_i = G0 * w^i."""
    w = _domain_root(m0)
    xs, x = [], G0
    for _ in range(m0):
        xs.append(x)
        x = x * w % P
    return ints_to_digits(xs, shape=(m0,))


@functools.lru_cache(maxsize=5 * _SHAPES)
def _pow_mont(m0: int, s: int) -> np.ndarray:
    """(m0, D) Montgomery digits of x_i^s on L0."""
    w = pow(_domain_root(m0), s, P)
    out, x = [], pow(G0, s, P)
    for _ in range(m0):
        out.append(x * R % P)
        x = x * w % P
    return ints_to_digits(out, shape=(m0,))


@functools.lru_cache(maxsize=16 * _SHAPES)
def _xinv_mont(m: int, shift: int) -> np.ndarray:
    """(m/2, D) Montgomery digits of (shift * w_m^i)^-1, i < m/2: the
    fold's 1/x stream for a layer on the coset shift*H_m."""
    w_inv = pow(_domain_root(m), P - 2, P)
    out, x = [], pow(shift, P - 2, P)
    for _ in range(m // 2):
        out.append(x * R % P)
        x = x * w_inv % P
    return ints_to_digits(out, shape=(m // 2,))


def _scalar_mont(v: int) -> np.ndarray:
    return ints_to_digits([v % P * R % P], shape=(1,))[0]


@functools.lru_cache(maxsize=32 * _SHAPES)
def _on_device(table, args: tuple, device: torch.device) -> torch.Tensor:
    """table(*args), a host digit array, as an int32 tensor on device."""
    return _to_device(table(*args), device)


#: Per-ProvingKey tables. ProvingKey is identity-hashed (dataclass
#: eq=False), so a WeakKeyDictionary drops a key's entry, its device
#: copies included, the moment the key itself is released.
_PK_HOST: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_PK_DEV: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _pk_key_evals(pk: ProvingKey) -> np.ndarray:
    """(10, m0, D) canonical digits of the preprocessed selector and sigma
    evaluations on L0."""
    rows = [pk.key_evals[name] for name in SELECTOR_NAMES + SIGMA_NAMES]
    return ints_to_digits([v for row in rows for v in row], shape=(len(rows), len(rows[0])))


def _key_coeff_digits(pk: ProvingKey) -> np.ndarray:
    """(10, n, D) canonical coefficient digits of the selector and sigma
    polynomials."""
    key = pk.key
    rows = [key.selectors[name] for name in SELECTOR_NAMES]
    rows += [key.sigmas[j] for j in range(len(SIGMA_NAMES))]
    return ints_to_digits([v % P for row in rows for v in row], shape=(len(rows), key.n))


def _pk_table(pk: ProvingKey, table, device: torch.device) -> torch.Tensor:
    """table(pk) on device, weakly cached per key on the host and per
    (key, device) on the device."""
    host = _PK_HOST.setdefault(pk, {})
    if table not in host:
        host[table] = table(pk)
    dev = _PK_DEV.setdefault(pk, {})
    if (table, device) not in dev:
        dev[(table, device)] = _to_device(host[table], device)
    return dev[(table, device)]


# ---------------------------------------------------------------------------
# Device primitives (leading instance axis B everywhere)
# ---------------------------------------------------------------------------


def _coset_eval_dev(coeffs: torch.Tensor, m0: int) -> torch.Tensor:
    """(..., L, D) coefficients (L <= m0) -> evaluations on L0."""
    return ntt.coset_eval_batched(F.pad(coeffs, (0, 0, 0, m0 - coeffs.shape[-2])), G0)


def _node_tag(device: torch.device) -> torch.Tensor:
    """The tree nodes' capacity word (fri.TAG_PCS) as digits on device."""
    return _on_device(fri._tag_digits, (), device)


def _leaf_tag(bs: int, device: torch.device) -> torch.Tensor:
    """The leaf sponge's capacity word for blocks of bs values."""
    return _on_device(int_to_digits, (fri.leaf_tag_int(bs),), device)


def _tree_levels_body(level: torch.Tensor, perm_fn, node_tag: torch.Tensor) -> list:
    """All arity-4 tree levels from (B, N, D) leaf digests (N a power of
    4), node rule identical to fri.tree_build_digits: every level is one
    batched permutation over all B rows' nodes (merkle.node_hash)."""
    levels = [level]
    while level.shape[1] > 1:
        b, k = level.shape[0], level.shape[1] // ARITY
        level = node_hash(level.reshape(b, k, ARITY, N_DIGITS), node_tag, perm_fn)
        levels.append(level)
    return levels


def _sponge_digests_body(blocks: torch.Tensor, perm_fn, leaf_tag: torch.Tensor) -> torch.Tensor:
    """(K, bs, D) canonical value blocks -> (K, D) leaf digests: the device
    twin of fri.block_digests (a rate-4 sponge tagged with the width), one
    batched permutation a chunk."""
    k, bs = blocks.shape[0], blocks.shape[1]
    n_chunks = max(1, -(-bs // 4))
    blocks = F.pad(blocks, (0, 0, 0, n_chunks * 4 - bs))
    state = perm_fn(torch.cat([leaf_tag.expand(k, 1, N_DIGITS), blocks[:, 0:4]], dim=1))
    for c in range(1, n_chunks):
        state = absorb(state, blocks[:, 4 * c : 4 * c + 4], perm_fn)
    return state[:, DIGEST_INDEX]


def _block_tree_body(blocks: torch.Tensor, perm_fn, node_tag: torch.Tensor,
                     leaf_tag: torch.Tensor) -> list:
    """(B, npos, bs, D) value blocks -> every digest level, (B, n_l, D)
    each: the leaf sponges, zero-padded to a power of 4, then the tree."""
    b, npos, bs = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    digs = _sponge_digests_body(blocks.reshape(b * npos, bs, N_DIGITS), perm_fn, leaf_tag)
    digs = F.pad(digs.reshape(b, npos, N_DIGITS), (0, 0, 0, ARITY ** _tree_height(npos) - npos))
    return _tree_levels_body(digs, perm_fn, node_tag)


def _paired_blocks_dev(cols: torch.Tensor) -> torch.Tensor:
    """(B, C, m0, D) column evaluations -> (B, m0/2, 2C, D) paired blocks:
    position j holds every column at x_j, then at x_{j+m0/2}
    (fri._commit_paired's layout)."""
    half = cols.shape[2] // 2
    return torch.cat([cols[:, :, :half], cols[:, :, half:]], dim=1).permute(0, 2, 1, 3)


def _layer_blocks(cur: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, m_k, D) layer evaluations -> (B, m_k/bs, bs, D) blocks: block b
    holds the fold coset {b + t * m_k/bs : t < bs}."""
    b, m_k = cur.shape[0], cur.shape[1]
    return cur.reshape(b, bs, m_k // bs, N_DIGITS).permute(0, 2, 1, 3)


def _build_paired_levels(cols: torch.Tensor, perm_fn) -> list:
    """Every digest level of the paired-block tree of (B, C, m0, D) column
    evaluations."""
    dev = cols.device
    return _block_tree_body(_paired_blocks_dev(cols), perm_fn, _node_tag(dev),
                            _leaf_tag(2 * cols.shape[1], dev))


_fetch = functools.partial(prover_cuda._fetch, name="fri.fetch")


def _root_ints(levels: list) -> list:
    """(B,) root ints from the last (B, 1, D) level."""
    return [int(v) for v in digits_to_ints(_fetch(levels[-1][:, 0]))]


# ---------------------------------------------------------------------------
# Gathers and openings: one device gather and one fetch a tree
# ---------------------------------------------------------------------------


def _gather_cols_dev(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows (B, C, m, D), idx (B, U) int64 -> (B, C, U, D): the values at
    each instance's positions."""
    b, c = rows.shape[0], rows.shape[1]
    return torch.gather(rows, 2, idx[:, None, :, None].expand(b, c, idx.shape[1], N_DIGITS))


def _gather_levels_dev(levels: list, idx: list) -> list:
    """levels (B, n_l, D) each, idx (B, cap) int64 each -> (B, cap, D) each."""
    return [torch.gather(lv, 1, ix[:, :, None].expand(-1, -1, N_DIGITS))
            for lv, ix in zip(levels, idx)]


def _open_nodes_dev(levels: list, s_lists: list) -> list:
    """The pruned multiproof node sets of every instance from its device
    levels: levels (B, n_l, D) each, s_lists[i] instance i's sorted-unique
    opened positions. Each level's plan is padded to the batch's largest,
    gathered, and the gathers fetched at once. Equal to
    fri.multiproof_open(levels_i, s_lists[i]) per instance."""
    b, height = levels[0].shape[0], len(levels) - 1
    if height == 0:
        return [np.zeros((0, N_DIGITS), np.uint32) for _ in range(b)]
    plans = [fri.multiproof_plan(s, height) for s in s_lists]
    cap = max(1, max(len(need) for plan in plans for need in plan))
    idx = np.zeros((height, b, cap), np.int64)
    for i, plan in enumerate(plans):
        for lvl, need in enumerate(plan):
            idx[lvl, i, : len(need)] = need
    idx_dev = torch.from_numpy(idx).to(levels[0].device)
    got = _fetch(torch.stack(_gather_levels_dev(levels[:height], list(idx_dev))))
    out = []
    for i, plan in enumerate(plans):
        parts = [got[lvl, i, : len(need)] for lvl, need in enumerate(plan) if need]
        out.append(np.concatenate(parts).astype(np.uint32) if parts
                   else np.zeros((0, N_DIGITS), np.uint32))
    return out


def _gather_blocks(rows: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """rows (B, C, m, D) on the device, idx (B, U) host positions -> (B, C, U)
    object array of the ints there (one gather, one fetch)."""
    return digits_to_ints(_fetch(_gather_cols_dev(rows, torch.from_numpy(idx).to(rows.device))))


def _open_blocks_dev(cols: torch.Tensor, s_lists: list) -> list:
    """The opened paired blocks of every instance: cols (B, C, m0, D)
    column evaluations; per instance a (U_i, 2C) int list in
    fri._open_paired's layout (every column at x_j, then at x_{j+m0/2})."""
    b, c, half = cols.shape[0], cols.shape[1], cols.shape[2] // 2
    u = max(len(s) for s in s_lists)
    idx = np.zeros((b, 2 * u), np.int64)
    for i, s in enumerate(s_lists):
        idx[i, : len(s)] = s
        idx[i, u : u + len(s)] = np.asarray(s, np.int64) + half
    ints = _gather_blocks(cols, idx)
    return [[[int(ints[i, col, j]) for col in range(c)]
             + [int(ints[i, col, u + j]) for col in range(c)] for j in range(len(s))]
            for i, s in enumerate(s_lists)]


def _open_layer_blocks(cur: torch.Tensor, bs: int, s_lists: list) -> list:
    """The opened blocks of a committed FRI layer (B, m_k, D): per instance
    a (U_i, bs) int list, block b = [cur[b + t * m_k/bs] for t < bs]
    (fri._fri_proof's layout)."""
    b, m_k = cur.shape[0], cur.shape[1]
    idx = np.zeros((b, max(len(s) for s in s_lists)), np.int64)
    for i, s in enumerate(s_lists):
        idx[i, : len(s)] = s
    ints = _gather_blocks(cur.reshape(b, bs, m_k // bs, N_DIGITS), idx)
    return [[[int(ints[i, t, j]) for t in range(bs)] for j in range(len(s))]
            for i, s in enumerate(s_lists)]


# ---------------------------------------------------------------------------
# Claimed evaluations (one device call) and blinding
# ---------------------------------------------------------------------------


def _eval_rows_dev(polys: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Evaluate R polynomials per instance at per-row points: polys
    (B, R, L, D) canonical coefficient digits (zero-padded on the
    coefficient axis), pts (B, R, D) canonical points -> (B, R, D)
    canonical values, exactly poly_eval(coeffs, point) per row (Montgomery
    products are exact mod p). The power table by doubling (log L
    mont_muls), then one product and a log-depth modular-add reduction."""
    b, r, ln = polys.shape[0], polys.shape[1], polys.shape[2]
    ptm = field_cuda.to_mont(pts)[:, :, None]
    pows = _on_device(_scalar_mont, (1,), polys.device).expand(b, r, 1, N_DIGITS)
    while pows.shape[2] < ln:
        xk = field_cuda.mont_mul(pows[:, :, -1:], ptm)  # x^m in Montgomery form
        pows = torch.cat([pows, field_cuda.mont_mul(pows, xk)], dim=2)
    terms = field_cuda.mont_mul(pows[:, :, :ln], polys)  # x^i c_i, canonical
    while terms.shape[2] > 1:
        if terms.shape[2] % 2:
            terms = F.pad(terms, (0, 0, 0, 1))
        m = terms.shape[2] // 2
        terms = field_cuda.add_mod(terms[:, :, :m], terms[:, :, m:])
    return terms[:, :, 0]


def _claimed_eval_ints(wires, z, t, r, key_tab, zetas: list, omega: int) -> np.ndarray:
    """Every claimed evaluation of B instances in one device call and one
    small fetch: per instance the rows a, b, o, d, z @ zeta_i,
    z @ omega*zeta_i, t @ zeta_i, the 10 key polynomials @ zeta_i and (zk)
    the FRI mask r @ zeta_i. Returns a (B, 17 or 18) object array of
    canonical ints, equal to plonk.poly_eval's."""
    b = wires.shape[0]
    parts = [wires, z[:, None], z[:, None], t[:, None], key_tab.expand(b, -1, -1, -1)]
    if r is not None:
        parts.append(r[:, None])
    ln = max(x.shape[2] for x in parts)
    rows = torch.cat([F.pad(x, (0, 0, 0, ln - x.shape[2])) for x in parts], dim=1)
    n_rows = rows.shape[1]
    pts = [[z_] * 5 + [z_ * omega % P] + [z_] * (n_rows - 6) for z_ in zetas]
    pts_dev = _to_device(ints_to_digits(pts, shape=(b, n_rows)), rows.device)
    return digits_to_ints(_fetch(_eval_rows_dev(rows, pts_dev)))


def _blind_dev(coeffs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Device twin of fri._blind: (..., n, D) coefficients and (..., k, D)
    blinding digits -> (..., n + k, D) with out[n + j] += r[j] and
    out[j] -= r[j]. Two shifted pads of r, so overlapping ranges (k > n,
    the tiny-circuit case) come out as the host loop's."""
    n, k = coeffs.shape[-2], r.shape[-2]
    out = F.pad(coeffs, (0, 0, 0, k))
    return field_cuda.sub_mod(field_cuda.add_mod(out, F.pad(r, (0, 0, n, 0))),
                              F.pad(r, (0, 0, 0, n)))


# ---------------------------------------------------------------------------
# DEEP composition
# ---------------------------------------------------------------------------

#: L0 positions the DEEP composition takes at once. On the card a product
#: is one kernel launch with no temporaries; `field.mont_mul`'s torch ops
#: (the CPU's) hold, for each element of its operands, the 16 x 16 int64
#: digit products (2,048 B) and their skewed pad (4,224 B): 6,272 B, so a
#: slab of B = 8 instances x 2^15 positions holds 1.64 GB (2^18 x 6,272 B)
#: in one product, and the next slab reuses it; a prod proof (B = 1, m0 =
#: 2^15) is one slab. The composition is pointwise along L0, so the slabs
#: give the same values.
DEEP_CHUNK = 1 << 15


def _deep_terms_chunk(stack, vs, gammas, pows, inv_a, inv_b, spec) -> torch.Tensor:
    """The DEEP term loop on one L0 slab (shapes as _deep_dev's, m0 = the
    slab)."""
    acc = torch.zeros((stack.shape[0],) + stack.shape[2:], dtype=torch.int32, device=stack.device)
    for j, (row, s_idx, shifted) in enumerate(spec):
        diff = field_cuda.sub_mod(stack[:, row], vs[:, j, None])
        term = field_cuda.mont_mul(diff, pows[s_idx])
        term = field_cuda.mont_mul(term, inv_b if shifted else inv_a)
        term = field_cuda.mont_mul(term, gammas[:, j, None])
        acc = field_cuda.add_mod(acc, term)
    return acc


def _deep_dev(stack, vs, gammas, pows, inv_a, inv_b, spec) -> torch.Tensor:
    """F on L0 per instance: stack (B, T_rows, m0, D) polynomial
    evaluations; vs (B, T, D) claimed values; gammas (B, T, D) Montgomery
    gdeep powers; pows (S, m0, D) shared Montgomery x^s tables;
    inv_a / inv_b (B, m0, D) Montgomery 1/(x - zeta_i) and
    1/(x - omega*zeta_i); spec: (row, s_index, shifted) a term. Returns
    (B, m0, D), DEEP_CHUNK positions at a time."""
    slabs = [
        _deep_terms_chunk(stack[:, :, s : s + DEEP_CHUNK], vs, gammas, pows[:, s : s + DEEP_CHUNK],
                          inv_a[:, s : s + DEEP_CHUNK], inv_b[:, s : s + DEEP_CHUNK], spec)
        for s in range(0, stack.shape[2], DEEP_CHUNK)
    ]
    return slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=1)


def _inv_mont_dev(xs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Montgomery-form 1/(x_i - point) over the L0 point table, by Fermat
    per element (field_cuda.invert: one kernel launch on a card): xs (m0,
    D), points (K, D) -> (K, m0, D)."""
    with metrics.span("fri.deep.invert"):
        return field_cuda.invert(field_cuda.sub_mod(xs[None], points[:, None]), mont_in=False)


# ---------------------------------------------------------------------------
# Folds, the in-trace transcript and the FRI commit phase
# ---------------------------------------------------------------------------


def _fold_dev(evals, beta_mont, xinv_mont, inv2_mont) -> torch.Tensor:
    """One FRI fold, batched: evals (B, m, D), beta_mont (B, D) the
    instances' challenges, xinv_mont (m/2, D) the shared 1/x table ->
    (B, m/2, D), equal to fri.fold_evals per instance."""
    half = evals.shape[1] // 2
    a, b = evals[:, :half], evals[:, half:]
    even = field_cuda.add_mod(a, b)
    odd = field_cuda.mont_mul(field_cuda.sub_mod(a, b), xinv_mont)
    scaled = field_cuda.mont_mul(odd, beta_mont[:, None])
    return field_cuda.mont_mul(field_cuda.add_mod(even, scaled), inv2_mont)


# The in-trace Fiat-Shamir transcript, the device twin of plonk.Transcript:
# a (B, WIDTH, D) canonical state, one independent transcript an instance.
# absorb and challenge do what plonk.Transcript's do (add into the rate
# word, permute; read the rate word, permute), so a host Transcript takes
# the state over through set_state and continues the same stream.


def _tr_absorb1(state, val, perm_fn) -> torch.Tensor:
    """Transcript.absorb of one value an instance: state (B, 5, D), val
    (B, D), canonical."""
    word = field_cuda.add_mod(state[:, 1], val)
    return perm_fn(torch.cat([state[:, :1], word[:, None], state[:, 2:]], dim=1))


def _tr_challenge(state, perm_fn) -> tuple:
    """Transcript.challenge: ((B, D) canonical challenge, the new state)."""
    return state[:, 1], perm_fn(state)


def _fri_phase_consts(m0: int, n_folds: int, device: torch.device) -> tuple:
    """The FRI phase's constant tensors on device: the n_folds fold tables
    (m_k/2, D), the Montgomery 1/2, the node tag and the leaf tag of every
    committed layer's block width."""
    xinvs, shift, size = [], G0, m0
    for _ in range(n_folds):
        xinvs.append(_on_device(_xinv_mont, (size, shift), device))
        shift, size = shift * shift % P, size // 2
    leaf_tags = {bs: _leaf_tag(bs, device) for _, bs in fri.layer_schedule(n_folds)}
    return xinvs, _on_device(_scalar_mont, ((P + 1) // 2,), device), _node_tag(device), leaf_tags


def _fri_phase_body(f0, tr_state, xinvs, inv2, node_tag, leaf_tags, perm_fn) -> tuple:
    """The whole FRI commit phase: per fold k, draw beta_k from the
    in-trace transcript, fold the (B, m_k, D) evaluations and, on the
    scheduled layers, build the quad or pair block tree and absorb its
    root: the host prover's challenge / fold / absorb sequence
    (fri._fri_commit), so the returned state continues its stream.

    f0 (B, m0, D) canonical DEEP evaluations; tr_state (B, 5, D); xinvs,
    inv2, node_tag, leaf_tags from _fri_phase_consts (the schedule is
    fri.layer_schedule(len(xinvs))). Every tensor it reads is an argument,
    so that the body can be captured into a CUDA graph. Returns
    (final evaluations, tr_state, layer evaluations, layer levels)."""
    committed = dict(fri.layer_schedule(len(xinvs)))
    cur = f0
    layer_evals, layer_levels = [], []
    for k, xinv in enumerate(xinvs, start=1):
        beta, tr_state = _tr_challenge(tr_state, perm_fn)
        cur = _fold_dev(cur, field_cuda.to_mont(beta), xinv, inv2)
        bs = committed.get(k)
        if bs:
            levels = _block_tree_body(_layer_blocks(cur, bs), perm_fn, node_tag, leaf_tags[bs])
            tr_state = _tr_absorb1(tr_state, levels[-1][:, 0], perm_fn)
            layer_evals.append(cur)
            layer_levels.append(levels)
    return cur, tr_state, layer_evals, layer_levels


@functools.lru_cache(maxsize=_GRAPHS)
def fri_phase_graph(b: int, m0: int, n_folds: int, schedule: str,
                    device: torch.device) -> CudaGraph:
    """_fri_phase_body of one (B, m0, n_folds, schedule, device) shape as one
    CUDA graph, captured at its first use: the counterpart of the JAX
    package's one jitted program `_fri_phase_dev`. The constant tables are
    device tensors before the capture, so the captured work holds no
    host-to-device copy."""
    consts = _fri_phase_consts(m0, n_folds, device)
    perm_fn = _perm_fn(schedule)
    inputs = (torch.zeros((b, m0, N_DIGITS), dtype=torch.int32, device=device),
              torch.zeros((b, 5, N_DIGITS), dtype=torch.int32, device=device))
    return CudaGraph(lambda f0, tr: _fri_phase_body(f0, tr, *consts, perm_fn), inputs)


def _run_fri_phase(f_dev, trs: list, m0: int, n_folds: int, schedule: str) -> tuple:
    """Fold and commit the scheduled layers on f_dev's device (one graph
    replay on the card, the eager body on the CPU); the host transcripts
    resume from the returned sponge states. Returns (final evaluations
    (B, m_final, D), [(layer evaluations, layer levels)], each instance's
    layer roots)."""
    with metrics.span("fri.fold"):
        b, dev = len(trs), f_dev.device
        tr_state = _to_device(ints_to_digits([v for tr in trs for v in tr.state], shape=(b, 5)),
                              dev)
        if dev.type == "cuda":
            out = fri_phase_graph(b, m0, n_folds, schedule, dev)(f_dev, tr_state)
        else:
            out = _fri_phase_body(f_dev, tr_state, *_fri_phase_consts(m0, n_folds, dev),
                                  _perm_fn(schedule))
        cur, tr_state, layer_evals, layer_levels = out
        roots = [[] for _ in range(b)]
        if layer_levels:
            # one fetch for every layer's root
            got = digits_to_ints(_fetch(torch.stack([lv[-1][:, 0] for lv in layer_levels], dim=1)))
            roots = [[int(v) for v in got[i]] for i in range(b)]
        states = digits_to_ints(_fetch(tr_state))
        for i in range(b):
            trs[i].set_state([int(v) for v in states[i]])
        return cur, list(zip(layer_evals, layer_levels)), roots


# ---------------------------------------------------------------------------
# Batched proof-of-work grinding
# ---------------------------------------------------------------------------


def _grind_window_body(states, nonce_digits, pow_bits: int, perm_fn) -> tuple:
    """Try a window of candidate nonces for every instance in one batched
    permutation: states (B, 5, D) canonical transcript states,
    nonce_digits (C, D) canonical candidates. Returns ((B,) any hit,
    (B,) first hit's index), which keeps the host's smallest-nonce rule."""
    b, c = states.shape[0], nonce_digits.shape[0]
    word = field_cuda.add_mod(states[:, None, 1], nonce_digits[None])
    full = torch.cat([states[:, None, :1].expand(b, c, 1, N_DIGITS), word[:, :, None],
                      states[:, None, 2:].expand(b, c, 3, N_DIGITS)], dim=2)
    out = perm_fn(full.reshape(b * c, 5, N_DIGITS))
    low = out[:, 1, 0].to(torch.int64) | (out[:, 1, 1].to(torch.int64) << 16)
    ok = ((low & ((1 << pow_bits) - 1)) == 0).reshape(b, c)
    return ok.any(dim=1), ok.to(torch.int32).argmax(dim=1)


def _grind_batch_dev(trs: list, pow_bits: int, device: torch.device, window_fn) -> list:
    """The smallest working proof-of-work nonce of every transcript,
    searched in shared windows of max(4096, min(2^(pow_bits+1), 2^17))
    candidates: one window_fn call (one permutation launch) a window for
    all instances. window_fn(states, nonce_digits, pow_bits) is
    _grind_window_body on the prover's permutation; the tests pass others."""
    b = len(trs)
    if pow_bits == 0:
        return [0] * b
    states = _to_device(ints_to_digits([v for tr in trs for v in tr.state], shape=(b, 5)), device)
    window = max(4096, min(2 << pow_bits, 1 << 17))
    shifts = torch.arange(0, 64, 16, device=device)
    nonces, start = [None] * b, 0
    while any(v is None for v in nonces):
        cand = torch.arange(start, start + window, dtype=torch.int64, device=device)
        nd = F.pad(((cand[:, None] >> shifts) & 0xFFFF).to(torch.int32), (0, N_DIGITS - 4))
        found, first = window_fn(states, nd, pow_bits)
        found, first = _fetch(found), _fetch(first)
        for i in range(b):
            if nonces[i] is None and found[i]:
                nonces[i] = start + int(first[i])
        start += window
    return nonces


def _apply_grinding(trs: list, pow_bits: int, schedule: str, device: torch.device) -> list:
    """Grind, absorb the nonce and consume the check challenge for every
    transcript, as fri.grind_transcript does on each, with the search on
    the device."""
    with metrics.span("fri.grind"):
        window_fn = functools.partial(_grind_window_body, perm_fn=_perm_fn(schedule))
        nonces = _grind_batch_dev(trs, pow_bits, device, window_fn)
        pool = device_pool_perm(schedule, device)  # not called: the search is done
        return [fri.grind_transcript(tr, pow_bits, pool, search_fn=lambda _s, v=v: v)
                for tr, v in zip(trs, nonces)]


# ---------------------------------------------------------------------------
# The device prover (batched over instances)
# ---------------------------------------------------------------------------


def prove_succinct_device_batch(composers, pk: ProvingKey, rngs=None, *,
                                schedule: str = DEFAULT_SCHEDULE, device="cuda",
                                mesh=None) -> list:
    """Prove B instances of one circuit with the succinct argument, on the
    device: the card unless the caller asks for the CPU (device="cpu", the
    kernel's plain version); without a card the default raises. rngs: one
    np.random.Generator an instance (zk determinism for tests), else the
    OS's randomness. Every permutation runs through the kernel of
    `schedule`. Each returned proof is byte-identical to
    fri.prove_succinct(composers[i], pk, rng=rngs[i])'s.

    mesh: an optional parallel/dist.Mesh, whose every rank calls with the
    same composers: the three polynomial phases then shard over the
    instances (B must divide by the mesh size) and return global tensors,
    the rest runs replicated on the mesh's device, and every rank returns
    all B proofs."""
    if not composers:
        return []
    dev = _entry_device("prove_succinct_device_batch", schedule, device, mesh)
    phase1, phase2, phase3 = _select_phases(mesh, dev)
    perm_fn = _perm_fn(schedule)
    key, params = pk.key, pk.params
    n, omega = key.n, key.omega
    b = len(composers)
    schema = fri.proof_schema(n, params)
    bounds = schema["bounds"]
    d_bound = bounds["D"]
    m0, half0 = schema["m0"], schema["half0"]
    final_degree, n_folds, sched = schema["final_degree"], schema["n_folds"], schema["sched"]
    cols_spec = tree_columns(params.zk)
    rand_fields = [fri._rand_field_fn(r) for r in (rngs or [None] * b)]

    ref_idx = plonk._wire_indices(composers[0])
    for c in composers[1:]:
        if plonk._wire_indices(c) != ref_idx:
            raise ValueError("batched proving requires all composers to share one circuit "
                             "structure")

    def digits(vals, shape):
        return _to_device(ints_to_digits(vals, shape=shape), dev)

    def draws(count):  # per instance, the host prover's randomness stream
        return digits([rand_fields[i]() for i in range(b) for _ in range(count)], (b, count))

    # --- witness polynomials through the batched prover's phases -----------
    with metrics.span("fri.witness"):
        wire_evals = digits([[[c._values[idx] % P for idx in col] + [0] * (n - key.n_gates)
                              for col in plonk._wire_indices(c)] for c in composers], (b, 4, n))
        pi_cols = [[v % P for v in plonk._public_input_column(c, n)] for c in composers]
        tables_n = prover_cuda._device_tables(key, dev)
        tables_m = prover_cuda._device_tables(key, dev, m=d_bound, d_z=bounds["d_z"])

        wires = phase1(wire_evals)                                   # (B, 4, n, D)
        if params.zk:
            # the wires a..d (zkw draws each), later z (zkz), then the mask r (D)
            wires = _blind_dev(wires, draws(4 * bounds["zkw"]).reshape(b, 4, -1, N_DIGITS))

    with metrics.span("fri.host"):
        trs = []
        for i in range(b):
            tr = Transcript()
            tr.absorb(statement_digest(pk.digest, pi_cols[i]))
            trs.append(tr)

    def commit(name, cols):
        with metrics.span("fri.commit"):
            levels[name] = _build_paired_levels(cols, perm_fn)
            roots[name] = _root_ints(levels[name])
            for i in range(b):
                trs[i].absorb(roots[name][i])

    levels, roots = {}, {}
    with metrics.span("fri.coset"):
        wires_l0 = _coset_eval_dev(wires, m0)                        # (B, 4, m0, D)
    commit("w", wires_l0)
    with metrics.span("fri.host"):
        betas = [tr.challenge() for tr in trs]
        gammas_fs = [tr.challenge() for tr in trs]
        bd, gd = digits(betas, (b,)), digits(gammas_fs, (b,))
    with metrics.span("fri.witness"):
        z = phase2(wire_evals, bd, gd, tables_n["ids_mont"], tables_n["sigma_n_mont"],
                   tables_n["one_mont"])
        if params.zk:
            z = _blind_dev(z, draws(bounds["zkz"]))
    with metrics.span("fri.coset"):
        z_l0 = _coset_eval_dev(z, m0)                                # (B, m0, D)
    commit("z", z_l0[:, None])
    with metrics.span("fri.host"):
        alphas = [tr.challenge() for tr in trs]
        pi_d, alpha_d = digits(pi_cols, (b, n)), digits(alphas, (b,))

    with metrics.span("fri.witness"):
        t = phase3(
            wires, z, pi_d, bd, gd, alpha_d, tables_m["kx_mont"], tables_m["sigma_m_mont"],
            tables_m["q_mont"], tables_m["zh_inv_mont"], tables_m["l1_mont"],
            tables_m["omega_mont"], tables_n["one_mont"])           # (B, d_bound, D)
        r = None
        if params.zk:
            r = draws(d_bound)
    with metrics.span("fri.coset"):
        t_l0 = _coset_eval_dev(t, m0)
        r_l0 = None
        t_cols = t_l0[:, None]
        if params.zk:
            r_l0 = _coset_eval_dev(r, m0)
            t_cols = torch.stack([t_l0, r_l0], dim=1)
    commit("t", t_cols)
    with metrics.span("fri.host"):
        zetas = [tr.challenge() for tr in trs]

    # --- claimed evaluations: one device call, one small fetch -------------
    row_names = (["a", "b", "o", "d", "z", "zw", "t"] + list(SELECTOR_NAMES) + list(SIGMA_NAMES)
                 + (["r"] if params.zk else []))
    with metrics.span("fri.evals"):
        vals = _claimed_eval_ints(wires, z, t, r, _pk_table(pk, _key_coeff_digits, dev), zetas,
                                  omega)
    with metrics.span("fri.host"):
        evals_all = []
        for i in range(b):
            ev = {name: int(vals[i, j]) for j, name in enumerate(row_names)}
            trs[i].absorb(*[ev[name] for name in eval_order(params.zk)])
            evals_all.append(ev)
        gdeeps = [tr.challenge() for tr in trs]

    # --- DEEP composition ---------------------------------------------------
    with metrics.span("fri.deep"):
        key_rows = _pk_table(pk, _pk_key_evals, dev)              # (10, m0, D)
        stack_parts = [wires_l0, z_l0[:, None], t_l0[:, None], key_rows.expand(b, -1, -1, -1)]
        row_of = {"a": 0, "b": 1, "o": 2, "d": 3, "z": 4, "t": 5}
        for j, name in enumerate(SELECTOR_NAMES + SIGMA_NAMES):
            row_of[name] = 6 + j
        if params.zk:
            stack_parts.append(r_l0[:, None])
            row_of["r"] = 16
        stack = torch.cat(stack_parts, dim=1)
        terms = fri._terms(bounds)
        s_values = sorted({d_bound + 1 - dj for (_, _, _, dj) in terms})
        pows = torch.stack([_on_device(_pow_mont, (m0, s), dev) for s in s_values])
        spec = [(row_of[pname], s_values.index(d_bound + 1 - dj), shifted)
                for (pname, _, shifted, dj) in terms]
        vs = digits([evals_all[i][ename] for i in range(b) for (_, ename, _, _) in terms],
                    (b, len(terms)))
        gpow = []
        for i in range(b):
            g_acc = 1
            for _ in terms:
                gpow.append(g_acc * R % P)
                g_acc = g_acc * gdeeps[i] % P
        gammas = digits(gpow, (b, len(terms)))
        # both denominators' points in one Fermat pass: zeta_i, then omega*zeta_i
        inv = _inv_mont_dev(_on_device(_xs_digits, (m0,), dev),
                            digits(zetas + [z_ * omega % P for z_ in zetas], (2 * b,)))
        f_dev = _deep_dev(stack, vs, gammas, pows, inv[:b], inv[b:], spec)

    # --- FRI commit phase: one graph replay on the card --------------------
    final, layer_data, layer_roots_all = _run_fri_phase(f_dev, trs, m0, n_folds, schedule)
    with metrics.span("fri.host"):
        final_ints = digits_to_ints(_fetch(final))
        shift_final = pow(G0, 1 << n_folds, P)
        final_coeffs_all = []
        for i in range(b):
            fc = plonk._coset_interp([int(v) for v in final_ints[i]], shift_final)
            if any(c_ % P for c_ in fc[final_degree:]):
                raise ValueError("FRI final layer exceeds its degree bound: the witness does not "
                                 f"satisfy the circuit (instance {i})")
            fc = fc[:final_degree]
            final_coeffs_all.append(fc)
            trs[i].absorb(*fc)

    # --- grinding and queries -----------------------------------------------
    nonces = _apply_grinding(trs, params.pow_bits, schedule, dev)
    with metrics.span("fri.host"):
        queries_all = [[tr.challenge() % half0 for _ in range(params.n_queries)] for tr in trs]
        s0_all = [sorted(set(qs)) for qs in queries_all]

    # --- openings: gathers, one fetch a tree ---------------------------------
    tree_cols = {"w": wires_l0, "z": z_l0[:, None], "t": t_cols}
    open_blocks, open_nodes = {}, {}
    with metrics.span("fri.open"):
        for tname in ("w", "z", "t"):
            open_blocks[tname] = _open_blocks_dev(tree_cols[tname], s0_all)
            open_nodes[tname] = _open_nodes_dev(levels[tname], s0_all)
    with metrics.span("fri.host"):
        # the key tree: the proving key's host levels, shared by the instances
        k_lists = [pk.key_evals[c] for c in cols_spec["k"]]
        k_open = [fri._open_paired(k_lists, pk.key_levels, s0) for s0 in s0_all]
        open_blocks["k"] = [blk for blk, _ in k_open]
        open_nodes["k"] = [nod for _, nod in k_open]
        pos_chains_all = [[layer_positions(q, m0, sched) for q in qs] for qs in queries_all]

    layer_blocks_all = [[] for _ in range(b)]
    layer_nodes_all = [[] for _ in range(b)]
    with metrics.span("fri.open"):
        for li, (_, bs) in enumerate(sched):
            s_k_all = [sorted({pc[li] for pc in chains}) for chains in pos_chains_all]
            cur_k, lv = layer_data[li]
            blocks = _open_layer_blocks(cur_k, bs, s_k_all)
            nodes = _open_nodes_dev(lv, s_k_all)
            for i in range(b):
                layer_blocks_all[i].append(blocks[i])
                layer_nodes_all[i].append(nodes[i])

    with metrics.span("fri.host"):
        return [
            SuccinctProof(
                roots={name: roots[name][i] for name in roots},
                evals=evals_all[i],
                pow_nonce=nonces[i],
                fri=FriProof(layer_roots=layer_roots_all[i], final_coeffs=final_coeffs_all[i],
                             layer_blocks=layer_blocks_all[i], layer_nodes=layer_nodes_all[i]),
                open_blocks={t_: open_blocks[t_][i] for t_ in TREE_ORDER},
                open_nodes={t_: open_nodes[t_][i] for t_ in TREE_ORDER},
            )
            for i in range(b)
        ]


def prove_succinct_device(composer, pk: ProvingKey, rng=None, *,
                          schedule: str = DEFAULT_SCHEDULE, device="cuda") -> SuccinctProof:
    """One instance through prove_succinct_device_batch."""
    return prove_succinct_device_batch([composer], pk, None if rng is None else [rng],
                                       schedule=schedule, device=device)[0]


# ---------------------------------------------------------------------------
# The device aggregate prover (aggregate.py's argument, on the device)
# ---------------------------------------------------------------------------


def prove_aggregate_device(composers, pk: ProvingKey, rng=None, *,
                           schedule: str = DEFAULT_SCHEDULE, device="cuda",
                           mesh=None) -> AggregateProof:
    """ONE succinct argument for B instances of one circuit, on the device:
    the card unless the caller asks for the CPU (device="cpu", the kernel's
    plain version); without a card the default raises. The counterpart of
    `fri_tpu.prove_aggregate_device`: the polynomial phases, the instance
    block trees, the DEEP composition, the folds (one graph replay) and the
    grinding on the device, through the kernel of `schedule`. The proof is
    byte-identical to aggregate.prove_aggregate(composers, pk, rng=rng)'s.

    Against prove_succinct_device_batch: one transcript, so the challenges
    are shared; the w, z and t trees hold every instance's columns (w
    poly-major then instance); one DEEP-FRI covers all B x 7 wire claims,
    the 10 key claims and (zk) the shared mask; the zk draws come from one
    stream (B x 4 x zkw wire coefficients instance-major, then B x zkz for
    z, then d_bound for the mask).

    mesh: as prove_succinct_device_batch's; every rank returns the one
    aggregate."""
    if not composers:
        raise ValueError("at least one composer required")
    dev = _entry_device("prove_aggregate_device", schedule, device, mesh)
    phase1, phase2, phase3 = _select_phases(mesh, dev)
    perm_fn = _perm_fn(schedule)
    key, params = pk.key, pk.params
    n, omega = key.n, key.omega
    b = len(composers)
    schema = fri.proof_schema(n, params)
    bounds = schema["bounds"]
    d_bound = bounds["D"]
    m0, half0 = schema["m0"], schema["half0"]
    final_degree, n_folds, sched = schema["final_degree"], schema["n_folds"], schema["sched"]
    rand_field = fri._rand_field_fn(rng)

    ref_idx = plonk._wire_indices(composers[0])
    for c in composers[1:]:
        if plonk._wire_indices(c) != ref_idx:
            raise ValueError("prove_aggregate requires all composers to share one circuit "
                             "structure")

    def digits(vals, shape):
        return _to_device(ints_to_digits(vals, shape=shape), dev)

    def draws(count, shape):  # the host aggregate prover's one stream
        return digits([rand_field() for _ in range(count)], shape)

    def shared(v):  # one challenge for every instance
        return digits([v] * b, (b,))

    # --- witness polynomials through the batched prover's phases -----------
    with metrics.span("fri.witness"):
        wire_evals = digits([[[c._values[idx] % P for idx in col] + [0] * (n - key.n_gates)
                              for col in plonk._wire_indices(c)] for c in composers], (b, 4, n))
        pi_cols = [[v % P for v in plonk._public_input_column(c, n)] for c in composers]
        tables_n = prover_cuda._device_tables(key, dev)
        tables_m = prover_cuda._device_tables(key, dev, m=d_bound, d_z=bounds["d_z"])

        wires = phase1(wire_evals)                                   # (B, 4, n, D)
        if params.zk:
            zkw = bounds["zkw"]
            wires = _blind_dev(wires, draws(b * 4 * zkw, (b, 4, zkw)))

    with metrics.span("fri.host"):
        tr = Transcript()
        _absorb_statement(tr, pk.digest, n, key.n_gates, pi_cols)
    levels, roots = {}, {}

    def commit(name, cols):
        with metrics.span("fri.commit"):
            levels[name] = _build_paired_levels(cols, perm_fn)
            roots[name] = _root_ints(levels[name])[0]
            tr.absorb(roots[name])

    with metrics.span("fri.coset"):
        wires_l0 = _coset_eval_dev(wires, m0)                        # (B, 4, m0, D)
        # the w tree's columns: poly-major, then instance (a_0..a_{B-1}, b_0, ...)
        w_cols = wires_l0.transpose(0, 1).reshape(1, 4 * b, m0, N_DIGITS)
    commit("w", w_cols)
    with metrics.span("fri.host"):
        beta = tr.challenge()
        gamma = tr.challenge()
        beta_d, gamma_d = shared(beta), shared(gamma)
    with metrics.span("fri.witness"):
        z = phase2(wire_evals, beta_d, gamma_d, tables_n["ids_mont"], tables_n["sigma_n_mont"],
                   tables_n["one_mont"])                             # (B, n, D)
        if params.zk:
            z = _blind_dev(z, draws(b * bounds["zkz"], (b, bounds["zkz"])))
    with metrics.span("fri.coset"):
        z_l0 = _coset_eval_dev(z, m0)                                # (B, m0, D)
        z_cols = z_l0[None]
    commit("z", z_cols)
    with metrics.span("fri.host"):
        alpha = tr.challenge()
        pi_d, alpha_d = digits(pi_cols, (b, n)), shared(alpha)

    with metrics.span("fri.witness"):
        t = phase3(
            wires, z, pi_d, beta_d, gamma_d, alpha_d,
            tables_m["kx_mont"], tables_m["sigma_m_mont"], tables_m["q_mont"],
            tables_m["zh_inv_mont"], tables_m["l1_mont"], tables_m["omega_mont"],
            tables_n["one_mont"])                                    # (B, d_bound, D)
        r = None
        if params.zk:
            # ONE shared mask polynomial, drawn after every instance's z blinds
            r = draws(d_bound, (1, d_bound))
    with metrics.span("fri.coset"):
        t_l0 = _coset_eval_dev(t, m0)
        r_l0 = None
        t_cols = t_l0[None]
        if params.zk:
            r_l0 = _coset_eval_dev(r, m0)                            # (1, m0, D)
            t_cols = torch.cat([t_cols, r_l0[:, None]], dim=1)       # (1, B + 1, m0, D)
    commit("t", t_cols)
    with metrics.span("fri.host"):
        zeta = tr.challenge()

    # --- claimed evaluations: one device call, one small fetch -------------
    with metrics.span("fri.evals"):
        vals = _claimed_eval_ints(wires, z, t, None if r is None else r.expand(b, -1, -1),
                                  _pk_table(pk, _key_coeff_digits, dev), [zeta] * b, omega)
    wire_rows = ("a", "b", "o", "d", "z", "zw", "t")
    key_names = SELECTOR_NAMES + SIGMA_NAMES
    with metrics.span("fri.host"):
        evals = [{name: int(vals[i, j]) for j, name in enumerate(wire_rows)} for i in range(b)]
        key_evals = {name: int(vals[0, len(wire_rows) + j]) for j, name in enumerate(key_names)}
        r_eval = int(vals[0, len(wire_rows) + len(key_names)]) if params.zk else None
        for e in evals:
            tr.absorb(*[e[name] for name in WIRE_EVAL_ORDER])
        tr.absorb(*[key_evals[name] for name in KEY_EVAL_ORDER])
        if params.zk:
            tr.absorb(r_eval)
        gdeep = tr.challenge()

    # --- one DEEP composition over all B x 7 + 10 (+1) claims ----------------
    wire_row = {"a": 0, "b": 1, "o": 2, "d": 3, "z": 4, "t": 5}

    def term_row(j, pname):
        if pname == "r":
            return 6 * b + len(key_names)
        if j is None:
            return 6 * b + key_names.index(pname)
        return 6 * j + wire_row[pname]

    with metrics.span("fri.deep"):
        inst_rows = torch.cat([wires_l0, z_l0[:, None], t_l0[:, None]], dim=1)   # (B, 6, m0, D)
        stack_parts = [inst_rows.reshape(6 * b, m0, N_DIGITS), _pk_table(pk, _pk_key_evals, dev)]
        if params.zk:
            stack_parts.append(r_l0)
        stack = torch.cat(stack_parts)[None]                         # (1, 6B + 10 (+1), m0, D)
        terms = _agg_terms(bounds, b)
        s_values = sorted({d_bound + 1 - dj for (*_, dj) in terms})
        pows = torch.stack([_on_device(_pow_mont, (m0, s), dev) for s in s_values])
        spec = [(term_row(j, pname), s_values.index(d_bound + 1 - dj), shifted)
                for (j, pname, _, shifted, dj) in terms]
        vs = digits([r_eval if pname == "r" else key_evals[ename] if j is None
                     else evals[j][ename] for (j, pname, ename, _, _) in terms], (1, len(terms)))
        gpow, g_acc = [], 1
        for _ in terms:
            gpow.append(g_acc * R % P)
            g_acc = g_acc * gdeep % P
        # both denominators' points in one Fermat pass: zeta, then omega*zeta
        inv = _inv_mont_dev(_on_device(_xs_digits, (m0,), dev),
                            digits([zeta, zeta * omega % P], (2,)))
        f_dev = _deep_dev(stack, vs, digits(gpow, (1, len(terms))), pows, inv[:1], inv[1:], spec)

    # --- one FRI commit phase (one graph replay on the card) and grinding -----
    final, layer_data, layer_roots = _run_fri_phase(f_dev, [tr], m0, n_folds, schedule)
    with metrics.span("fri.host"):
        final_coeffs = plonk._coset_interp([int(v) for v in digits_to_ints(_fetch(final[0]))],
                                           pow(G0, 1 << n_folds, P))
        if any(c_ % P for c_ in final_coeffs[final_degree:]):
            raise ValueError("FRI final layer exceeds its degree bound — the witness does not "
                             "satisfy the circuit (the quotient is not a polynomial)")
        final_coeffs = final_coeffs[:final_degree]
        tr.absorb(*final_coeffs)
    pow_nonce = _apply_grinding([tr], params.pow_bits, schedule, dev)[0]
    with metrics.span("fri.host"):
        queries = [tr.challenge() % half0 for _ in range(params.n_queries)]
        s0 = sorted(set(queries))

    # --- openings: gathers, one fetch a tree ---------------------------------
    tree_cols = {"w": w_cols, "z": z_cols, "t": t_cols}
    open_blocks, open_nodes = {}, {}
    for tname in TREE_ORDER:
        if tname == "k":  # the proving key's host levels
            with metrics.span("fri.host"):
                open_blocks[tname], open_nodes[tname] = fri._open_paired(
                    [pk.key_evals[c] for c in key_names], pk.key_levels, s0)
        else:
            with metrics.span("fri.open"):
                open_blocks[tname] = _open_blocks_dev(tree_cols[tname], [s0])[0]
                open_nodes[tname] = _open_nodes_dev(levels[tname], [s0])[0]
    pos_chains = [layer_positions(q, m0, sched) for q in queries]
    layer_blocks, layer_nodes = [], []
    with metrics.span("fri.open"):
        for li, (_, bs) in enumerate(sched):
            s_k = sorted({pc[li] for pc in pos_chains})
            cur_k, lv = layer_data[li]
            layer_blocks.append(_open_layer_blocks(cur_k, bs, [s_k])[0])
            layer_nodes.append(_open_nodes_dev(lv, [s_k])[0])

    return AggregateProof(
        n_instances=b, roots=roots, evals=evals, key_evals=key_evals, r_eval=r_eval,
        pow_nonce=pow_nonce,
        fri=FriProof(layer_roots=layer_roots[0], final_coeffs=final_coeffs,
                     layer_blocks=layer_blocks, layer_nodes=layer_nodes),
        open_blocks=open_blocks, open_nodes=open_nodes)


# ---------------------------------------------------------------------------
# The device verifiers: the sibling-opening chain and the fused pooled phase
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=_GRAPHS)
def chain_graph(k: int, h: int, schedule: str, device: torch.device) -> CudaGraph:
    """merkle.chain_nodes of K openings of height h under the tree nodes'
    tag, as one CUDA graph captured at its first use: the counterpart of the
    jitted `_chain_nodes_dev`."""
    tag, perm_fn = _node_tag(device), _perm_fn(schedule)
    inputs = (torch.zeros((k, N_DIGITS), dtype=torch.int32, device=device),
              torch.zeros((k, h, ARITY - 1, N_DIGITS), dtype=torch.int32, device=device),
              torch.zeros((k, h), dtype=torch.int64, device=device))
    return CudaGraph(lambda node, sibs, poss: chain_nodes(node, sibs, poss, tag, perm_fn), inputs)


def device_chain_fn(node, sibs, poss, *, schedule: str = DEFAULT_SCHEDULE,
                    device="cuda") -> np.ndarray:
    """fri.tree_verify_batched's chain_fn with the whole sibling chain on the
    device: node (K, D), sibs (K, h, 3, D), poss (K, h) host arrays in,
    the (K, D) uint32 root-level digests out, one fetch. On the card it is
    one graph replay a (K, h) shape; device="cpu" runs the eager body on
    the kernel's plain version; without a card the default raises."""
    dev = _entry_device("device_chain_fn", schedule, device)
    args = (torch.from_numpy(np.asarray(node, np.uint32).astype(np.int32)),
            torch.from_numpy(np.asarray(sibs, np.uint32).astype(np.int32)),
            torch.from_numpy(np.asarray(poss, np.int64)))
    k, h = args[2].shape
    if dev.type == "cuda" and k and h:
        out = chain_graph(k, h, schedule, dev)(*args)
    else:
        out = chain_nodes(*(a.to(dev) for a in args), _node_tag(dev), _perm_fn(schedule))
    return out.cpu().numpy().astype(np.uint32)


def mesh_chain_fn(mesh, *, schedule: str = DEFAULT_SCHEDULE):
    """fri.tree_verify_batched's chain_fn with each pooled chain group
    sharded over a mesh (parallel/dist.chain_nodes_sharded, every rank
    calling with the same openings): the rows are padded with zero chains
    to a multiple of the mesh size and the padding's digests sliced off
    (they never reach a verdict). Host arrays in, (K, D) uint32 digests
    out, as device_chain_fn's."""
    from .parallel import dist

    _check_schedule(schedule)
    n_dev, perm_fn = mesh.shape[dist.AXIS], _perm_fn(schedule)

    def chain(node, sibs, poss):
        node = torch.from_numpy(np.asarray(node, np.uint32).astype(np.int32))
        sibs = torch.from_numpy(np.asarray(sibs, np.uint32).astype(np.int32))
        poss = torch.from_numpy(np.asarray(poss, np.int64))
        k = node.shape[0]
        pad = (-k) % n_dev
        if pad:
            node = F.pad(node, (0, 0, 0, pad))
            sibs = F.pad(sibs, (0, 0, 0, 0, 0, 0, 0, pad))
            poss = F.pad(poss, (0, 0, 0, pad))
        out = dist.chain_nodes_sharded(node, sibs, poss, mesh, perm_fn)
        return out[:k].cpu().numpy().astype(np.uint32)

    return chain


def _fused_verify_plan(entries, q_cap: int):
    """Host index bookkeeping for the fused pooled verifier: mirror
    fri.multiproof_verify_many's per-level merge exactly, as gather
    programs the device runs blind. Shapes depend only on (entry count,
    heights, block widths, q_cap), all schema facts, so one graph serves
    every query set.

    At level l the digest buffer is [pool | supplied nodes | zero row]:
    pool rows are the previous level's permutation outputs (level 0: the
    leaf sponges, every entry padded to q_cap rows), node rows are the
    proof's pruned digits padded to 3x the group cap, and every padding
    group gathers the zero row (digests no root extraction reads). Entry
    e's level-l group cap is min(q_cap, 4^(h_e-l-1)).

    Returns (leaf_blocks per gid, nodes per level, sels per level,
    root_sels indexed by levels climbed (0 = the leaf pool, for single-leaf
    trees), root_owner per slot). Entries must satisfy the invariants
    fri._check_opening enforces (sorted unique in-range indices, exact
    node counts, <= q_cap openings); a violation raises. Digits travel as
    uint16; a digit of 16 bits or more raises rather than wraps."""
    n_entries = len(entries)
    heights = [int(e[5]) for e in entries]
    max_h = max(heights) if heights else 0
    bs_of_gid = {}
    gid_rows = {}
    last_gid = None
    for e_i, e in enumerate(entries):
        gid, _root, blocks, idx, nodes, height = e
        if gid != last_gid and gid in gid_rows:
            raise ValueError("entries must be grouped by gid")
        last_gid = gid
        bs = e[2].shape[1]
        if bs_of_gid.setdefault(gid, bs) != bs:
            raise ValueError("one block width per gid required")
        gid_rows.setdefault(gid, []).append(e_i)
        idx = [int(i) for i in idx]
        if (not idx or sorted(set(idx)) != idx or len(idx) > q_cap
                or min(idx) < 0 or max(idx) >= ARITY ** int(height)
                or blocks.shape[0] != len(idx)
                or np.asarray(nodes).reshape(-1, N_DIGITS).shape[0]
                != fri.multiproof_nodes_total(idx, int(height))):
            raise ValueError("malformed pooled entry (the batched verifier validates proofs "
                             "before building entries)")
        if ((np.asarray(blocks, np.uint32) >> 16).any()
                or (np.asarray(nodes, np.uint32) >> 16).any()):
            raise ValueError("non-canonical (>16-bit) digit in pooled entry")

    def g_cap(h, lvl):
        return min(q_cap, ARITY ** (h - lvl - 1)) if lvl < h else 0

    # leaf sponge inputs: per gid, entries padded to q_cap rows each
    leaf_blocks = []
    for gid, idxs in gid_rows.items():
        bs = bs_of_gid[gid]
        blk = np.zeros((len(idxs) * q_cap, bs, N_DIGITS), np.uint16)
        for k, e_i in enumerate(idxs):
            rows = entries[e_i][2]
            blk[k * q_cap : k * q_cap + rows.shape[0]] = rows
        leaf_blocks.append(blk)

    # static per-level geometry
    off_out, off_nd, g_tot, n_tot = [], [], [], []
    for lvl in range(max_h):
        oo, on = [], []
        go = no = 0
        for h in heights:
            oo.append(go)
            on.append(no)
            g = g_cap(h, lvl)
            go += g
            no += 3 * g
        off_out.append(oo)
        off_nd.append(on)
        g_tot.append(go)
        n_tot.append(no)

    pool_rows = [n_entries * q_cap] + g_tot[:-1]
    nodes_lvls = [np.zeros((n_tot[lvl], N_DIGITS), np.uint16) for lvl in range(max_h)]
    sels = [np.full((g_tot[lvl], ARITY), pool_rows[lvl] + n_tot[lvl], np.int32)
            for lvl in range(max_h)]
    root_sels = [[] for _ in range(max_h + 1)]
    root_owner = [[] for _ in range(max_h + 1)]

    for e_i, (gid, root, blocks, idx, nodes, height) in enumerate(entries):
        plan = fri.multiproof_plan(idx, height)
        nodes = np.asarray(nodes, np.uint32).reshape(-1, N_DIGITS)
        # per-level merge of known rows with supplied nodes: known and node
        # indices are disjoint and each level's survivor count is a
        # multiple of ARITY, so one argsort of the concatenated keys gives
        # multiproof_verify_many's sorted merge, and the groups a reshape
        keys = np.asarray(idx, np.int64)
        vals = e_i * q_cap + np.arange(len(idx), dtype=np.int64)
        off = 0
        for lvl in range(height):
            need = np.asarray(plan[lvl], np.int64).reshape(-1)
            base = off_nd[lvl][e_i]
            k = len(need)
            nodes_lvls[lvl][base : base + k] = nodes[off : off + k]
            off += k
            all_keys = np.concatenate([keys, need])
            all_vals = np.concatenate([vals, pool_rows[lvl] + base + np.arange(k, dtype=np.int64)])
            order = np.argsort(all_keys)  # keys are disjoint, so unique
            out0 = off_out[lvl][e_i]
            g = len(all_keys) // ARITY
            sels[lvl][out0 : out0 + g] = all_vals[order].reshape(g, ARITY)
            keys = all_keys[order][::ARITY] >> 2
            vals = out0 + np.arange(g, dtype=np.int64)
        # root row: the entry's one level-(h-1) group output, or its lone
        # leaf digest for a single-leaf tree (height 0)
        row = off_out[height - 1][e_i] if height else e_i * q_cap
        root_sels[height].append(row)
        root_owner[height].append(e_i)

    return (leaf_blocks, nodes_lvls, sels,
            [np.asarray(r, np.int32) for r in root_sels], root_owner)


def _widen(digits16: torch.Tensor) -> torch.Tensor:
    """uint16 digits uploaded as their int16 view -> int32 digits."""
    return digits16.to(torch.int32) & 0xFFFF


def _fused_pool_body(leaf_blocks, nodes_lvls, sels, root_sels, perm_fn, node_tag,
                     leaf_tags: dict) -> tuple:
    """The verifier's whole pooled Merkle phase: every gid's leaf sponges,
    then one permutation a tree level over the plan's gather program
    (_fused_verify_plan). leaf_blocks and nodes_lvls are the plan's uint16
    digits as int16 tensors (widened here), sels and root_sels its int64
    index tensors; leaf_tags maps each block width to its sponge's
    capacity word. Returns the extracted root digests a slot."""
    digs = [_sponge_digests_body(_widen(blk), perm_fn, leaf_tags[blk.shape[1]])
            for blk in leaf_blocks]
    pool = torch.cat(digs)
    zero = pool.new_zeros((1, N_DIGITS))
    roots = [pool[root_sels[0]]]  # single-leaf trees: the root is the leaf digest
    for lvl, sel in enumerate(sels):
        children = torch.cat([pool, _widen(nodes_lvls[lvl]), zero])[sel]   # (G, ARITY, D)
        pool = node_hash(children, node_tag, perm_fn)
        roots.append(pool[root_sels[lvl + 1]])
    return tuple(roots)


def _pool_tensors(plan) -> tuple:
    """The plan's arrays as CPU tensors, flat: the leaf blocks and the
    level nodes as int16 views of their uint16 digits, the selections as
    int64; then the counts that split the flat tuple back."""
    leaf_blocks, nodes_lvls, sels, root_sels = plan[:4]
    flat = ([torch.from_numpy(b.view(np.int16)) for b in leaf_blocks]
            + [torch.from_numpy(x.view(np.int16)) for x in nodes_lvls]
            + [torch.from_numpy(s.astype(np.int64)) for s in sels]
            + [torch.from_numpy(r.astype(np.int64)) for r in root_sels])
    return tuple(flat), (len(leaf_blocks), len(sels))


def _split(flat: tuple, counts: tuple) -> tuple:
    n_gid, n_lvl = counts
    return (flat[:n_gid], flat[n_gid : n_gid + n_lvl], flat[n_gid + n_lvl : n_gid + 2 * n_lvl],
            flat[n_gid + 2 * n_lvl :])


def _fused_pool_consts(widths, device: torch.device) -> tuple:
    """The node tag and the leaf tag of every block width, on device."""
    return _node_tag(device), {bs: _leaf_tag(bs, device) for bs in widths}


@functools.lru_cache(maxsize=_GRAPHS)
def fused_pool_graph(shapes: tuple, counts: tuple, schedule: str,
                     device: torch.device) -> CudaGraph:
    """_fused_pool_body of one plan shape as one CUDA graph, captured at its
    first use: the counterpart of the jitted `_fused_pool_dev`. shapes:
    (shape, dtype) of every flat input of _pool_tensors; the plan's shapes
    depend only on schema facts, so one graph serves every query set of a
    batch shape. The selections are graph inputs, like the digits."""
    inputs = tuple(torch.zeros(shape, dtype=dtype, device=device) for shape, dtype in shapes)
    node_tag, leaf_tags = _fused_pool_consts({blk.shape[1] for blk in inputs[: counts[0]]}, device)
    perm_fn = _perm_fn(schedule)

    def run(*flat):
        return _fused_pool_body(*_split(flat, counts), perm_fn, node_tag, leaf_tags)

    return CudaGraph(run, inputs)


def _pool_graph(flat: tuple, counts: tuple, schedule: str, device: torch.device) -> CudaGraph:
    """The fused pool's graph for the shapes of _pool_tensors' flat tuple."""
    shapes = tuple((tuple(x.shape), x.dtype) for x in flat)
    return fused_pool_graph(shapes, counts, schedule, device)


def _fused_pool_run(plan, schedule: str, device: torch.device) -> tuple:
    """The fused pooled phase of a plan on device: one graph replay on the
    card, the eager body on the CPU. Returns the root digests a slot."""
    flat, counts = _pool_tensors(plan)
    if device.type == "cuda":
        return _pool_graph(flat, counts, schedule, device)(*flat)
    consts = _fused_pool_consts({b.shape[1] for b in plan[0]}, device)
    return _fused_pool_body(*_split(flat, counts), _perm_fn(schedule), *consts)


def fused_entries_check(vk, pool_fn=None, *, schedule: str = DEFAULT_SCHEDULE, device="cuda"):
    """The entries_check of fri.verify_succinct_batched and
    aggregate.verify_aggregate with the whole pooled leaf-sponge and
    multiproof phase on the device: one graph replay on the card and one
    fetch of the roots, which are compared on the host. Verdicts equal
    fri.pooled_entries_verify's: the gather program replays
    multiproof_verify_many's merge order. pool_fn(plan) -> root digests a
    slot overrides the default run (the tests pass the eager body); without
    a card the default device raises."""
    dev = _entry_device("fused_entries_check", schedule, device)
    q_cap = vk.params.n_queries

    def check(entries):
        ok = np.zeros(len(entries), bool)
        if not entries:
            return ok
        plan = _fused_verify_plan(entries, q_cap)
        roots = (pool_fn(plan) if pool_fn is not None
                 else _fused_pool_run(plan, schedule, dev))
        got = torch.cat(roots).cpu().numpy().astype(np.uint32)  # one fetch
        row = 0
        for slot, owners in enumerate(plan[4]):
            for e_i in owners:
                root = entries[e_i][1]
                want = (ints_to_digits([int(root)], shape=(1,))[0]
                        if isinstance(root, (int, np.integer)) else np.asarray(root, np.uint32))
                ok[e_i] = bool(np.array_equal(got[row], want))
                row += 1
        return ok

    return check


def verify_succinct_device_batch(vk, proofs, public_inputs_list, fused: bool = True, *,
                                 schedule: str = DEFAULT_SCHEDULE, device="cuda",
                                 mesh=None) -> np.ndarray:
    """fri.verify_succinct_batched with the pooled Merkle phase on the
    device: the card unless the caller asks for the CPU (device="cpu", the
    kernel's plain version); without a card the default raises. Verdicts
    are identical: the transcript replay, proof-of-work gate and fold
    algebra are the same host code. fused=True runs the whole leaf-sponge
    and multiproof phase as one graph replay and one fetch
    (fused_entries_check); fused=False the host-pooled path with one kernel
    launch a sponge chunk and a level (device_pool_perm). A mesh gives
    only its device, as the JAX package drops its mesh: the pooled phase is
    already one batched call."""
    device = _entry_device("verify_succinct_device_batch", schedule, device, mesh)
    pool = device_pool_perm(schedule, device)
    check = fused_entries_check(vk, schedule=schedule, device=device) if fused else None
    return fri.verify_succinct_batched(vk, proofs, public_inputs_list, pool, entries_check=check)


def verify_aggregate_device(vk, proof, public_inputs_list, *, schedule: str = DEFAULT_SCHEDULE,
                            device="cuda", mesh=None) -> bool:
    """aggregate.verify_aggregate with its pooled Merkle phase as one graph
    replay on the device (fused_entries_check): the same verdict. The card
    unless the caller asks for the CPU; without a card the default raises.
    A mesh gives only its device, as verify_succinct_device_batch's."""
    device = _entry_device("verify_aggregate_device", schedule, device, mesh)
    return aggregate.verify_aggregate(
        vk, proof, public_inputs_list, device_pool_perm(schedule, device),
        entries_check=fused_entries_check(vk, schedule=schedule, device=device))
