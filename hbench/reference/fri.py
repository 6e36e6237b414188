"""The plain reference of the succinct (DEEP-FRI) proof of the preimage circuit.

A frozen copy, cut to what one proof needs, of the package's host code
(`fri.py`'s key, commitment trees, DEEP composition, FRI commit phase,
grinding and openings, and `serialize.py`'s proof bytes), in exact Python
ints and numpy digit arrays. The trees' permutations run through
`hbench/reference/hades.permute` on the given device; the transcript through
`hades.perm_int`. It imports nothing of the package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from hbench.reference import hades
from hbench.reference import plonk as pl

P = hades.P
ARITY, DIGEST_INDEX = 4, 1
TAG_PCS, TAG_PCS_LEAF = 5, 7
G0 = 7
INV2 = (P + 1) // 2
SELECTOR_NAMES = pl.SELECTORS
SIGMA_NAMES = ("s0", "s1", "s2", "s3")
EVAL_ORDER = ("a", "b", "o", "d", "z", "zw", "t") + SELECTOR_NAMES + SIGMA_NAMES
TREE_ORDER = ("w", "z", "t", "k")
TREE_COLUMNS = {"w": ("a", "b", "o", "d"), "z": ("z",), "t": ("t",),
                "k": SELECTOR_NAMES + SIGMA_NAMES}


@dataclass(frozen=True)
class Params:
    blowup: int = 8
    n_queries: int = 35
    final_degree: int = 64
    pow_bits: int = 16
    zk: bool = False


class Hasher:
    """The trees' batched permutation ((B, 5, 16) canonical digits, numpy)
    on `device`, with `partial_rounds` rounds (below 59 only for the
    control)."""

    def __init__(self, device, partial_rounds: int = hades.PARTIAL_ROUNDS):
        self.device, self.partial_rounds = device, partial_rounds

    def __call__(self, states: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(states, np.uint32).astype(np.int32))
        out = hades.permute(x.to(self.device), self.partial_rounds)
        return out.cpu().numpy().astype(np.uint32)


def _digits(values) -> np.ndarray:
    return hades.ints_to_digits(list(values)).astype(np.uint32).reshape(-1, 16)


def _int(d) -> int:
    return int.from_bytes(np.asarray(d).astype("<u2").tobytes(), "little")


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _height(n: int) -> int:
    h, m = 0, 1
    while m < n:
        m, h = m * ARITY, h + 1
    return h


def tree_build(leaves: np.ndarray, perm) -> list:
    full = ARITY ** _height(leaves.shape[0])
    level = np.concatenate([leaves.astype(np.uint32),
                            np.zeros((full - leaves.shape[0], 16), np.uint32)])
    levels = [level]
    tag = _digits([TAG_PCS])[0]
    while level.shape[0] > 1:
        k = level.shape[0] // ARITY
        states = np.concatenate([np.broadcast_to(tag, (k, 1, 16)),
                                 level.reshape(k, ARITY, 16)], axis=1)
        level = perm(states)[:, DIGEST_INDEX]
        levels.append(level)
    return levels


def tree_root(levels) -> int:
    return _int(levels[-1][0])


def _add_mod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Canonical mod-p addition of digit arrays."""
    s = a.astype(np.int64) + b.astype(np.int64)
    out, carry = np.empty_like(s), np.zeros(s.shape[:-1], np.int64)
    for i in range(16):
        t = s[..., i] + carry
        out[..., i], carry = t & 0xFFFF, t >> 16
    p = np.asarray(hades.int_digits(P, 16), np.int64)
    sub, borrow = np.empty_like(out), np.zeros(s.shape[:-1], np.int64)
    for i in range(16):
        t = out[..., i] - p[i] - borrow
        sub[..., i], borrow = t & 0xFFFF, (t < 0).astype(np.int64)
    return np.where((borrow == 0)[..., None], sub, out).astype(np.uint32)


def block_digests(blocks: np.ndarray, perm) -> np.ndarray:
    """(K, bs, 16) -> (K, 16): a sponge a block, capacity word 7 + (bs << 8),
    rate-4 chunks zero-padded, the digest word 1."""
    k, bs = blocks.shape[:2]
    chunks = max(1, -(-bs // 4))
    blocks = np.concatenate([blocks, np.zeros((k, 4 * chunks - bs, 16), np.uint32)], axis=1)
    state = np.zeros((k, 5, 16), np.uint32)
    state[:, 0] = _digits([TAG_PCS_LEAF + (bs << 8)])[0]
    for c in range(chunks):
        state[:, 1:5] = _add_mod(state[:, 1:5], blocks[:, 4 * c:4 * c + 4])
        state = perm(state)
    return state[:, DIGEST_INDEX]


def multiproof_open(levels, indices) -> np.ndarray:
    known, parts = sorted({int(i) for i in indices}), []
    for lvl in range(len(levels) - 1):
        kset = set(known)
        groups = sorted({i >> 2 for i in known})
        need = [ARITY * g + j for g in groups for j in range(ARITY) if ARITY * g + j not in kset]
        if need:
            parts.append(np.asarray(levels[lvl])[need])
        known = groups
    return np.concatenate(parts).astype(np.uint32) if parts else np.zeros((0, 16), np.uint32)


def commit_paired(eval_lists, perm) -> list:
    m0 = len(eval_lists[0])
    arr = np.stack([_digits(e) for e in eval_lists], axis=1)
    blocks = np.concatenate([arr[:m0 // 2], arr[m0 // 2:]], axis=1)
    return tree_build(block_digests(blocks, perm), perm)


def open_paired(eval_lists, levels, s0):
    half = len(eval_lists[0]) // 2
    blocks = [[e[j] for e in eval_lists] + [e[j + half] for e in eval_lists] for j in s0]
    return blocks, multiproof_open(levels, s0)


# ---------------------------------------------------------------------------
# Shapes, keys, DEEP, folds, grinding
# ---------------------------------------------------------------------------


def schema(n: int, params: Params) -> dict:
    d_w = d_z = n
    d_t = d_z + 4 * d_w - n - 3
    big_d = 1 << (max(d_t, d_w, d_z, 2) - 1).bit_length()
    final_degree = min(params.final_degree, big_d // 2)
    n_folds = (big_d // final_degree).bit_length() - 1
    sched, k = [], 1
    while k < n_folds:
        bs = 4 if n_folds - k >= 2 else 2
        sched.append((k, bs))
        k += 2 if bs == 4 else 1
    m0 = params.blowup * big_d
    return {"d_w": d_w, "d_z": d_z, "d_t": d_t, "D": big_d, "m0": m0,
            "final_degree": final_degree, "n_folds": n_folds, "sched": sched,
            "h_pos": _height(m0 // 2),
            "layer_heights": [_height((m0 >> k) // bs) for k, bs in sched]}


@dataclass
class ProvingKey:
    key: pl.Key
    params: Params
    key_evals: dict
    key_levels: list
    digest: int


def preprocess(cs: pl.Composer, params: Params, perm) -> ProvingKey:
    key = pl.preprocess(cs)
    m0 = schema(key.n, params)["m0"]
    evals = {name: pl.coset_eval(list(key.selectors[name]), m0, G0) for name in SELECTOR_NAMES}
    for i, name in enumerate(SIGMA_NAMES):
        evals[name] = pl.coset_eval(list(key.sigmas[i]), m0, G0)
    levels = commit_paired([evals[c] for c in TREE_COLUMNS["k"]], perm)
    return ProvingKey(key=key, params=params, key_evals=evals, key_levels=levels,
                      digest=pl.key_digest(key))


def deep_compose(m0: int, s: dict, poly_evals: dict, evals: dict, zeta: int, omega: int,
                 gdeep: int) -> list[int]:
    terms = [("a", "a", False, s["d_w"]), ("b", "b", False, s["d_w"]),
             ("o", "o", False, s["d_w"]), ("d", "d", False, s["d_w"]),
             ("z", "z", False, s["d_z"]), ("z", "zw", True, s["d_z"]), ("t", "t", False, s["d_t"])]
    terms += [(k, k, False, s["d_w"]) for k in SELECTOR_NAMES + SIGMA_NAMES]
    w = pl.domain_root(m0)
    xs, x = [], G0
    for _ in range(m0):
        xs.append(x)
        x = x * w % P
    inv_z = pl.batch_inverse([(x - zeta) % P for x in xs])
    inv_wz = pl.batch_inverse([(x - zeta * omega) % P for x in xs])
    f, gpow = [0] * m0, 1
    for pname, ename, shifted, dj in terms:
        e, v, sh = poly_evals[pname], evals[ename], s["D"] + 1 - dj
        inv, xp, wstep = (inv_wz if shifted else inv_z), pow(G0, sh, P), pow(w, sh, P)
        for i in range(m0):
            f[i] = (f[i] + gpow * xp % P * ((e[i] - v) % P) % P * inv[i]) % P
            xp = xp * wstep % P
        gpow = gpow * gdeep % P
    return f


def fold(evals: list[int], shift: int, beta: int) -> list[int]:
    m = len(evals)
    half = m // 2
    w_inv, x_inv = pow(pl.domain_root(m), P - 2, P), pow(shift, P - 2, P)
    out = []
    for i in range(half):
        a, b = evals[i], evals[i + half]
        out.append(((a + b) % P + beta * ((a - b) * x_inv % P)) % P * INV2 % P)
        x_inv = x_inv * w_inv % P
    return out


def fri_commit(tr: pl.Transcript, f, s: dict, perm):
    committed, coms = dict(s["sched"]), []
    cur, shift = f, G0
    for k in range(1, s["n_folds"] + 1):
        cur = fold(cur, shift, tr.challenge())
        shift = shift * shift % P
        bs = committed.get(k)
        if bs:
            npos = len(cur) // bs
            digits = np.stack([_digits(cur[t * npos:(t + 1) * npos]) for t in range(bs)], axis=1)
            levels = tree_build(block_digests(digits, perm), perm)
            coms.append((k, bs, cur, levels))
            tr.absorb(tree_root(levels))
    final = pl.coset_interp(cur, shift)
    if any(c % P for c in final[s["final_degree"]:]):
        raise ValueError("the final FRI layer exceeds its degree bound")
    final = final[:s["final_degree"]]
    tr.absorb(*final)
    return coms, final


def grind(tr: pl.Transcript, pow_bits: int, perm, batch: int = 4096) -> int:
    """The smallest nonce whose absorption makes the next challenge end in
    pow_bits zero bits; absorbs it and draws that challenge."""
    nonce = 0
    if pow_bits:
        base = np.broadcast_to(_digits(tr.state), (batch, 5, 16))
        start = 0
        while True:
            nonces = np.arange(start, start + batch, dtype=np.int64)
            nd = np.zeros((batch, 16), np.uint32)
            for i in range(4):
                nd[:, i] = (nonces >> (16 * i)) & 0xFFFF
            states = base.copy()
            states[:, 1] = _add_mod(states[:, 1], nd)
            out = perm(states)
            low = out[:, 1, 0].astype(np.int64) | (out[:, 1, 1].astype(np.int64) << 16)
            hits = np.nonzero((low & ((1 << pow_bits) - 1)) == 0)[0]
            if hits.size:
                nonce = start + int(hits[0])
                break
            start += batch
    tr.absorb(nonce)
    if tr.challenge() & ((1 << pow_bits) - 1):
        raise AssertionError("the grinding nonce does not work")
    return nonce


def layer_positions(q: int, m0: int, sched) -> list[int]:
    i, out = int(q), []
    for k, bs in sched:
        i = i % ((m0 >> k) // bs)
        out.append(i)
    return out


# ---------------------------------------------------------------------------
# The prover and the proof's bytes
# ---------------------------------------------------------------------------


def prove(cs: pl.Composer, pk: ProvingKey, perm, partial_rounds: int) -> dict:
    key, params = pk.key, pk.params
    n, omega = key.n, key.omega
    s = schema(n, params)
    m0, half0 = s["m0"], s["m0"] // 2
    cols = pl.wire_columns(cs)
    wire_evals = [[cs.values[i] for i in col] + [0] * (n - key.n_gates) for col in cols]
    wires = tuple(pl.ntt(v, invert=True) for v in wire_evals)
    pi_col = [g.pi for g in cs.gates] + [0] * (n - key.n_gates)
    tr = pl.Transcript(partial_rounds)
    tr.absorb(pl.statement_digest(pk.digest, pi_col))
    poly_evals, levels, roots = {}, {}, {}
    for name, poly in zip("abod", wires):
        poly_evals[name] = pl.coset_eval(list(poly), m0, G0)
    levels["w"] = commit_paired([poly_evals[c] for c in TREE_COLUMNS["w"]], perm)
    roots["w"] = tree_root(levels["w"])
    tr.absorb(roots["w"])
    beta, gamma = tr.challenge(), tr.challenge()
    z = pl.grand_product(wire_evals, key, beta, gamma)
    poly_evals["z"] = pl.coset_eval(list(z), m0, G0)
    levels["z"] = commit_paired([poly_evals["z"]], perm)
    roots["z"] = tree_root(levels["z"])
    tr.absorb(roots["z"])
    alpha = tr.challenge()
    t = pl.quotient(key, wires, z, pi_col, beta, gamma, alpha, m=s["D"])
    poly_evals["t"] = pl.coset_eval(list(t), m0, G0)
    levels["t"] = commit_paired([poly_evals["t"]], perm)
    roots["t"] = tree_root(levels["t"])
    tr.absorb(roots["t"])
    zeta = tr.challenge()
    evals = {"a": pl.poly_eval(wires[0], zeta), "b": pl.poly_eval(wires[1], zeta),
             "o": pl.poly_eval(wires[2], zeta), "d": pl.poly_eval(wires[3], zeta),
             "z": pl.poly_eval(z, zeta), "zw": pl.poly_eval(z, zeta * omega % P),
             "t": pl.poly_eval(t, zeta)}
    for name in SELECTOR_NAMES:
        evals[name] = pl.poly_eval(key.selectors[name], zeta)
    for i, name in enumerate(SIGMA_NAMES):
        evals[name] = pl.poly_eval(key.sigmas[i], zeta)
    tr.absorb(*[evals[name] for name in EVAL_ORDER])
    gdeep = tr.challenge()
    f = deep_compose(m0, s, {**poly_evals, **pk.key_evals}, evals, zeta, omega, gdeep)
    coms, final = fri_commit(tr, f, s, perm)
    nonce = grind(tr, params.pow_bits, perm)
    queries = [tr.challenge() % half0 for _ in range(params.n_queries)]
    s0 = sorted(set(queries))
    open_blocks, open_nodes = {}, {}
    for name in ("w", "z", "t"):
        open_blocks[name], open_nodes[name] = open_paired(
            [poly_evals[c] for c in TREE_COLUMNS[name]], levels[name], s0)
    open_blocks["k"], open_nodes["k"] = open_paired(
        [pk.key_evals[c] for c in TREE_COLUMNS["k"]], pk.key_levels, s0)
    chains = [layer_positions(q, m0, s["sched"]) for q in queries]
    layer_blocks, layer_nodes, layer_roots = [], [], []
    for li, (k, bs, lev_evals, lev) in enumerate(coms):
        npos = (m0 >> k) // bs
        s_k = sorted({c[li] for c in chains})
        layer_blocks.append([[lev_evals[b + t * npos] for t in range(bs)] for b in s_k])
        layer_nodes.append(multiproof_open(lev, s_k))
        layer_roots.append(tree_root(lev))
    return {"roots": roots, "evals": evals, "pow_nonce": nonce, "layer_roots": layer_roots,
            "final_coeffs": final, "layer_blocks": layer_blocks, "layer_nodes": layer_nodes,
            "open_blocks": open_blocks, "open_nodes": open_nodes}


def _scalar(x: int) -> bytes:
    if not 0 <= x < P:
        raise ValueError("not a canonical field element")
    return int(x).to_bytes(32, "little")


def _nodes(nodes) -> bytes:
    arr = np.asarray(nodes, np.uint32).reshape(-1, 16)
    return struct.pack("<I", arr.shape[0]) + arr.astype("<u2").tobytes()


def proof_bytes(proof: dict, n: int, params: Params) -> bytes:
    """The proof's wire format ("HSP2")."""
    out = bytearray(b"HSP2")
    out += struct.pack("<IIIIBBH", n, params.blowup, params.n_queries, params.final_degree,
                       params.pow_bits, int(params.zk), len(proof["final_coeffs"]))
    for name in ("w", "z", "t"):
        out += _scalar(proof["roots"][name])
    for name in EVAL_ORDER:
        out += _scalar(proof["evals"][name])
    for v in proof["layer_roots"] + list(proof["final_coeffs"]):
        out += _scalar(v)
    out += struct.pack("<Q", proof["pow_nonce"])
    out += struct.pack("<H", len(proof["open_blocks"]["w"]))
    for name in TREE_ORDER:
        out += b"".join(_scalar(int(v)) for b in proof["open_blocks"][name] for v in b)
        out += _nodes(proof["open_nodes"][name])
    for blocks, nodes in zip(proof["layer_blocks"], proof["layer_nodes"]):
        out += struct.pack("<H", len(blocks))
        out += b"".join(_scalar(int(v)) for b in blocks for v in b)
        out += _nodes(nodes)
    return bytes(out)


def prove_instances(words: list, images: list, ids: list, params: Params, device,
                    partial_rounds: int = hades.PARTIAL_ROUNDS) -> dict:
    """{id: the proof bytes of that instance}, with one key for all. The
    circuits are the true ones; `partial_rounds` sets the permutation of
    the trees and the transcript (below 59 only for the control)."""
    perm = Hasher(device, partial_rounds)
    circuits = [pl.preimage_circuit(w, e) for w, e in zip(words, images)]
    pk = preprocess(circuits[0], params, perm)
    return {i: proof_bytes(prove(c, pk, perm, partial_rounds), pk.key.n, params)
            for i, c in zip(ids, circuits)}
