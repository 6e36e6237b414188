"""The succinct argument's device side: the counterpart of
`hades252_tpu/fri_tpu.py`.

Two parts live here.

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
    - the DEEP composition and its inversions are pointwise field ops;
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

The JAX package pads every permutation batch to the kernel's block so that
the TPU keeps one executable; the CUDA kernels mask their tail, so nothing
is padded here.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from . import field, fri, plonk, prover_cuda
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
from .ops import ntt, perm_cuda
from .ops.perm_cuda import DEFAULT_SCHEDULE, _check_schedule, permute_cuda
from .params import N_DIGITS, P, R, int_to_digits
from .plonk import Transcript, _domain_root, statement_digest
from .prover_cuda import _to_device
from .utils.encoding import digits_to_ints, ints_to_digits


def _device(device) -> torch.device:
    """The device to run on: the card unless the caller asks for the CPU.
    Raises without a card and for a device with no kernel; a CUDA device
    gets its index, so that caches keyed by it meet one key."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu' for the plain version)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"no kernel for device {dev}")
    return dev


def device_pool_perm(schedule: str = DEFAULT_SCHEDULE, device="cuda"):
    """A batched canonical permutation for `fri` and `aggregate`'s
    `perm_fn`: (B, WIDTH, N_DIGITS) uint32 digits in, the same out,
    through the CUDA kernel of `schedule` on the card. It runs on the
    card unless the caller asks for the CPU (device="cpu": the kernel's
    plain version, for the tests); without a card it raises, and it never
    falls back to the native engine or to the plain version."""
    _check_schedule(schedule)
    try:
        dev = _device(device)
    except RuntimeError as e:
        raise RuntimeError(f"device_pool_perm: {e}") from None

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
    batched permutation over all B rows' nodes."""
    levels = [level]
    while level.shape[1] > 1:
        b, k = level.shape[0], level.shape[1] // ARITY
        children = level.reshape(b * k, ARITY, N_DIGITS)
        states = torch.cat([node_tag.expand(b * k, 1, N_DIGITS), children], dim=1)
        level = perm_fn(states)[:, DIGEST_INDEX].reshape(b, k, N_DIGITS)
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
        word = field.add_mod(state[:, 1:5], blocks[:, 4 * c : 4 * c + 4])
        state = perm_fn(torch.cat([state[:, :1], word], dim=1))
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


def _root_ints(levels: list) -> list:
    """(B,) root ints from the last (B, 1, D) level."""
    return [int(v) for v in digits_to_ints(levels[-1][:, 0].cpu().numpy())]


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
    got = torch.stack(_gather_levels_dev(levels[:height], list(idx_dev))).cpu().numpy()
    out = []
    for i, plan in enumerate(plans):
        parts = [got[lvl, i, : len(need)] for lvl, need in enumerate(plan) if need]
        out.append(np.concatenate(parts).astype(np.uint32) if parts
                   else np.zeros((0, N_DIGITS), np.uint32))
    return out


def _gather_blocks(rows: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """rows (B, C, m, D) on the device, idx (B, U) host positions -> (B, C, U)
    object array of the ints there (one gather, one fetch)."""
    return digits_to_ints(_gather_cols_dev(rows, torch.from_numpy(idx).to(rows.device)).cpu().numpy())


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
    ptm = field.to_mont(pts)[:, :, None]
    pows = field.to_mont(field._const("one", polys.device).expand(b, r, 1, N_DIGITS))
    while pows.shape[2] < ln:
        xk = field.mont_mul(pows[:, :, -1:], ptm)  # x^m in Montgomery form
        pows = torch.cat([pows, field.mont_mul(pows, xk)], dim=2)
    terms = field.mont_mul(pows[:, :, :ln], polys)  # x^i c_i, canonical
    while terms.shape[2] > 1:
        if terms.shape[2] % 2:
            terms = F.pad(terms, (0, 0, 0, 1))
        m = terms.shape[2] // 2
        terms = field.add_mod(terms[:, :, :m], terms[:, :, m:])
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
    return digits_to_ints(_eval_rows_dev(rows, pts_dev).cpu().numpy())


def _blind_dev(coeffs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Device twin of fri._blind: (..., n, D) coefficients and (..., k, D)
    blinding digits -> (..., n + k, D) with out[n + j] += r[j] and
    out[j] -= r[j]. Two shifted pads of r, so overlapping ranges (k > n,
    the tiny-circuit case) come out as the host loop's."""
    n, k = coeffs.shape[-2], r.shape[-2]
    out = F.pad(coeffs, (0, 0, 0, k))
    return field.sub_mod(field.add_mod(out, F.pad(r, (0, 0, n, 0))), F.pad(r, (0, 0, 0, n)))


# ---------------------------------------------------------------------------
# DEEP composition
# ---------------------------------------------------------------------------

#: L0 positions the DEEP composition takes at once. One field.mont_mul
#: holds, for each element of its operands, the 16 x 16 int64 digit
#: products (2,048 B) and their skewed pad (4,224 B): 6,272 B. A slab of
#: B = 8 instances x 2^15 positions then holds 1.64 GB (2^18 x 6,272 B) in
#: one product, 2% of the H100's 80 GB, and the next slab reuses it; a
#: prod proof (B = 1, m0 = 2^15) is one slab. The composition is pointwise
#: along L0, so the slabs give the same values.
DEEP_CHUNK = 1 << 15


def _deep_terms_chunk(stack, vs, gammas, pows, inv_a, inv_b, spec) -> torch.Tensor:
    """The DEEP term loop on one L0 slab (shapes as _deep_dev's, m0 = the
    slab)."""
    acc = torch.zeros((stack.shape[0],) + stack.shape[2:], dtype=torch.int32, device=stack.device)
    for j, (row, s_idx, shifted) in enumerate(spec):
        diff = field.sub_mod(stack[:, row], vs[:, j, None])
        term = field.mont_mul(diff, pows[s_idx])
        term = field.mont_mul(term, inv_b if shifted else inv_a)
        term = field.mont_mul(term, gammas[:, j, None])
        acc = field.add_mod(acc, term)
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
    per element (field.invert): xs (m0, D), points (K, D) -> (K, m0, D)."""
    return field.to_mont(field.invert(field.sub_mod(xs[None], points[:, None])))


# ---------------------------------------------------------------------------
# Folds, the in-trace transcript and the FRI commit phase
# ---------------------------------------------------------------------------


def _fold_dev(evals, beta_mont, xinv_mont, inv2_mont) -> torch.Tensor:
    """One FRI fold, batched: evals (B, m, D), beta_mont (B, D) the
    instances' challenges, xinv_mont (m/2, D) the shared 1/x table ->
    (B, m/2, D), equal to fri.fold_evals per instance."""
    half = evals.shape[1] // 2
    a, b = evals[:, :half], evals[:, half:]
    even = field.add_mod(a, b)
    odd = field.mont_mul(field.sub_mod(a, b), xinv_mont)
    return field.mont_mul(field.add_mod(even, field.mont_mul(odd, beta_mont[:, None])), inv2_mont)


# The in-trace Fiat-Shamir transcript, the device twin of plonk.Transcript:
# a (B, WIDTH, D) canonical state, one independent transcript an instance.
# absorb and challenge do what plonk.Transcript's do (add into the rate
# word, permute; read the rate word, permute), so a host Transcript takes
# the state over through set_state and continues the same stream.


def _tr_absorb1(state, val, perm_fn) -> torch.Tensor:
    """Transcript.absorb of one value an instance: state (B, 5, D), val
    (B, D), canonical."""
    word = field.add_mod(state[:, 1], val)
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
        cur = _fold_dev(cur, field.to_mont(beta), xinv, inv2)
        bs = committed.get(k)
        if bs:
            levels = _block_tree_body(_layer_blocks(cur, bs), perm_fn, node_tag, leaf_tags[bs])
            tr_state = _tr_absorb1(tr_state, levels[-1][:, 0], perm_fn)
            layer_evals.append(cur)
            layer_levels.append(levels)
    return cur, tr_state, layer_evals, layer_levels


class FriPhaseGraph:
    """_fri_phase_body of one (B, m0, n_folds, schedule, device) shape,
    captured as one CUDA graph: the counterpart of the JAX package's one
    jitted program `_fri_phase_dev`.

    Before the capture one eager run over zero inputs (on a side stream)
    makes every first-use upload: perm_cuda's `hades_init` and dot tables,
    field's constants. The constant tables are device tensors before the
    capture, so the captured work holds no host-to-device copy. A call
    copies its inputs into the graph's static buffers, replays, and
    returns clones of the outputs.

    `held` counts the kernel launches of one replay per schedule (what the
    wrappers counted during the capture); `replays` counts the replays."""

    def __init__(self, b: int, m0: int, n_folds: int, schedule: str, device: torch.device):
        # held for the graph's life: the captured work reads their memory
        self._consts = consts = _fri_phase_consts(m0, n_folds, device)
        perm_fn = _perm_fn(schedule)
        self._f0 = torch.zeros((b, m0, N_DIGITS), dtype=torch.int32, device=device)
        self._tr = torch.zeros((b, 5, N_DIGITS), dtype=torch.int32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _fri_phase_body(self._f0, self._tr, *consts, perm_fn)
        torch.cuda.current_stream(device).wait_stream(side)
        before = dict(perm_cuda.launches)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._out = _fri_phase_body(self._f0, self._tr, *consts, perm_fn)
        self.held = {s: perm_cuda.launches[s] - before[s] for s in perm_cuda.SCHEDULES}
        self.replays = 0

    def __call__(self, f0: torch.Tensor, tr_state: torch.Tensor) -> tuple:
        self._f0.copy_(f0)
        self._tr.copy_(tr_state)
        self._graph.replay()
        self.replays += 1
        cur, tr, evals, levels = self._out
        return (cur.clone(), tr.clone(), [e.clone() for e in evals],
                [[lv.clone() for lv in lvls] for lvls in levels])


#: FRI-phase graphs kept at once (each holds its shape's buffers on the card).
_GRAPHS = 4


@functools.lru_cache(maxsize=_GRAPHS)
def fri_phase_graph(b: int, m0: int, n_folds: int, schedule: str,
                    device: torch.device) -> FriPhaseGraph:
    """The FRI phase's graph for this shape, captured at its first use."""
    return FriPhaseGraph(b, m0, n_folds, schedule, device)


def _run_fri_phase(f_dev, trs: list, m0: int, n_folds: int, schedule: str) -> tuple:
    """Fold and commit the scheduled layers on f_dev's device (one graph
    replay on the card, the eager body on the CPU); the host transcripts
    resume from the returned sponge states. Returns (final evaluations
    (B, m_final, D), [(layer evaluations, layer levels)], each instance's
    layer roots)."""
    b, dev = len(trs), f_dev.device
    tr_state = _to_device(ints_to_digits([v for tr in trs for v in tr.state], shape=(b, 5)), dev)
    if dev.type == "cuda":
        out = fri_phase_graph(b, m0, n_folds, schedule, dev)(f_dev, tr_state)
    else:
        out = _fri_phase_body(f_dev, tr_state, *_fri_phase_consts(m0, n_folds, dev),
                              _perm_fn(schedule))
    cur, tr_state, layer_evals, layer_levels = out
    roots = [[] for _ in range(b)]
    if layer_levels:
        # one fetch for every layer's root
        got = digits_to_ints(torch.stack([lv[-1][:, 0] for lv in layer_levels], dim=1).cpu().numpy())
        roots = [[int(v) for v in got[i]] for i in range(b)]
    states = digits_to_ints(tr_state.cpu().numpy())
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
    word = field.add_mod(states[:, None, 1], nonce_digits[None])
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
        found, first = found.cpu().numpy(), first.cpu().numpy()
        for i in range(b):
            if nonces[i] is None and found[i]:
                nonces[i] = start + int(first[i])
        start += window
    return nonces


def _apply_grinding(trs: list, pow_bits: int, schedule: str, device: torch.device) -> list:
    """Grind, absorb the nonce and consume the check challenge for every
    transcript, as fri.grind_transcript does on each, with the search on
    the device."""
    window_fn = functools.partial(_grind_window_body, perm_fn=_perm_fn(schedule))
    nonces = _grind_batch_dev(trs, pow_bits, device, window_fn)
    pool = device_pool_perm(schedule, device)  # not called: the search is done
    return [fri.grind_transcript(tr, pow_bits, pool, search_fn=lambda _s, v=v: v)
            for tr, v in zip(trs, nonces)]


# ---------------------------------------------------------------------------
# The device prover (batched over instances)
# ---------------------------------------------------------------------------


def prove_succinct_device_batch(composers, pk: ProvingKey, rngs=None, *,
                                schedule: str = DEFAULT_SCHEDULE, device="cuda") -> list:
    """Prove B instances of one circuit with the succinct argument, on the
    device: the card unless the caller asks for the CPU (device="cpu", the
    kernel's plain version); without a card the default raises. rngs: one
    np.random.Generator an instance (zk determinism for tests), else the
    OS's randomness. Every permutation runs through the kernel of
    `schedule`. Each returned proof is byte-identical to
    fri.prove_succinct(composers[i], pk, rng=rngs[i])'s."""
    if not composers:
        return []
    _check_schedule(schedule)
    try:
        dev = _device(device)
    except RuntimeError as e:
        raise RuntimeError(f"prove_succinct_device_batch: {e}") from None
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
    wire_evals = digits([[[c._values[idx] % P for idx in col] + [0] * (n - key.n_gates)
                          for col in plonk._wire_indices(c)] for c in composers], (b, 4, n))
    pi_cols = [[v % P for v in plonk._public_input_column(c, n)] for c in composers]
    tables_n = prover_cuda._device_tables(key, dev)
    tables_m = prover_cuda._device_tables(key, dev, m=d_bound, d_z=bounds["d_z"])

    wires = prover_cuda._phase1_wires(wire_evals)                    # (B, 4, n, D)
    if params.zk:
        # the wires a..d (zkw draws each), later z (zkz), then the mask r (D)
        wires = _blind_dev(wires, draws(4 * bounds["zkw"]).reshape(b, 4, -1, N_DIGITS))

    trs = []
    for i in range(b):
        tr = Transcript()
        tr.absorb(statement_digest(pk.digest, pi_cols[i]))
        trs.append(tr)

    def commit(name, cols):
        levels[name] = _build_paired_levels(cols, perm_fn)
        roots[name] = _root_ints(levels[name])
        for i in range(b):
            trs[i].absorb(roots[name][i])

    levels, roots = {}, {}
    wires_l0 = _coset_eval_dev(wires, m0)                            # (B, 4, m0, D)
    commit("w", wires_l0)
    betas = [tr.challenge() for tr in trs]
    gammas_fs = [tr.challenge() for tr in trs]
    bd, gd = digits(betas, (b,)), digits(gammas_fs, (b,))
    z = prover_cuda._phase2_grand_product(wire_evals, bd, gd, tables_n["ids_mont"],
                                          tables_n["sigma_n_mont"], tables_n["one_mont"])
    if params.zk:
        z = _blind_dev(z, draws(bounds["zkz"]))
    z_l0 = _coset_eval_dev(z, m0)                                    # (B, m0, D)
    commit("z", z_l0[:, None])
    alphas = [tr.challenge() for tr in trs]

    t = prover_cuda._phase3_quotient(
        wires, z, digits(pi_cols, (b, n)), bd, gd, digits(alphas, (b,)), tables_m["kx_mont"],
        tables_m["sigma_m_mont"], tables_m["q_mont"], tables_m["zh_inv_mont"],
        tables_m["l1_mont"], tables_m["omega_mont"], tables_n["one_mont"])  # (B, d_bound, D)
    t_l0 = _coset_eval_dev(t, m0)
    r = r_l0 = None
    t_cols = t_l0[:, None]
    if params.zk:
        r = draws(d_bound)
        r_l0 = _coset_eval_dev(r, m0)
        t_cols = torch.stack([t_l0, r_l0], dim=1)
    commit("t", t_cols)
    zetas = [tr.challenge() for tr in trs]

    # --- claimed evaluations: one device call, one small fetch -------------
    row_names = (["a", "b", "o", "d", "z", "zw", "t"] + list(SELECTOR_NAMES) + list(SIGMA_NAMES)
                 + (["r"] if params.zk else []))
    vals = _claimed_eval_ints(wires, z, t, r, _pk_table(pk, _key_coeff_digits, dev), zetas, omega)
    evals_all = []
    for i in range(b):
        ev = {name: int(vals[i, j]) for j, name in enumerate(row_names)}
        trs[i].absorb(*[ev[name] for name in eval_order(params.zk)])
        evals_all.append(ev)
    gdeeps = [tr.challenge() for tr in trs]

    # --- DEEP composition ---------------------------------------------------
    key_rows = _pk_table(pk, _pk_key_evals, dev)                  # (10, m0, D)
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
    final_ints = digits_to_ints(final.cpu().numpy())
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
    queries_all = [[tr.challenge() % half0 for _ in range(params.n_queries)] for tr in trs]
    s0_all = [sorted(set(qs)) for qs in queries_all]

    # --- openings: gathers, one fetch a tree ---------------------------------
    tree_cols = {"w": wires_l0, "z": z_l0[:, None], "t": t_cols}
    open_blocks, open_nodes = {}, {}
    for tname in ("w", "z", "t"):
        open_blocks[tname] = _open_blocks_dev(tree_cols[tname], s0_all)
        open_nodes[tname] = _open_nodes_dev(levels[tname], s0_all)
    # the key tree: the proving key's host levels, shared by the instances
    k_lists = [pk.key_evals[c] for c in cols_spec["k"]]
    k_open = [fri._open_paired(k_lists, pk.key_levels, s0) for s0 in s0_all]
    open_blocks["k"] = [blk for blk, _ in k_open]
    open_nodes["k"] = [nod for _, nod in k_open]

    pos_chains_all = [[layer_positions(q, m0, sched) for q in qs] for qs in queries_all]
    layer_blocks_all = [[] for _ in range(b)]
    layer_nodes_all = [[] for _ in range(b)]
    for li, (_, bs) in enumerate(sched):
        s_k_all = [sorted({pc[li] for pc in chains}) for chains in pos_chains_all]
        cur_k, lv = layer_data[li]
        blocks = _open_layer_blocks(cur_k, bs, s_k_all)
        nodes = _open_nodes_dev(lv, s_k_all)
        for i in range(b):
            layer_blocks_all[i].append(blocks[i])
            layer_nodes_all[i].append(nodes[i])

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
