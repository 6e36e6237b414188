"""Byte wire format for the succinct proof system (proofs + verifier keys).

Port of `hades252_tpu/serialize.py`, host code the port carries its own
copy of: the same HSP2 / HVK2 / HAP2 layouts, byte for byte.

Reference parity: the reference's prove/verify cycle runs through
dusk-plonk, whose `Proof` and verifier data implement
`to_bytes`/`from_bytes` (dusk-plonk's `Serializable`; the cycle the
reference exercises at src/strategies/gadget.rs:198-223) — a user of the
reference can move proofs and keys across processes/network as bytes.
This module gives the self-hosted DEEP-FRI argument (`fri.py`) the same
capability with a deterministic, strictly-validated layout.

Conventions (all little-endian):
  * field elements: canonical 32-byte LE (`BlsScalar::to_bytes` format,
    reference src/lib.rs:33-44) — non-canonical (>= p) encodings are
    REJECTED on read, mirroring `BlsScalar::from_bytes` returning None;
  * Merkle digests: the digest's canonical field-element encoding;
  * NO Merkle positions travel on the wire: the verifier derives every
    opened index from the transcript and rebuilds the pruned multiproof
    plan itself (fri.multiproof_plan) — a supplied position would be
    pure attack surface;
  * opened values are stored per SORTED-UNIQUE index (u16 count), pruned
    node sets per tree carry an explicit u32 count; the verifier later
    rejects any count that disagrees with its derived plan;
  * every other size/shape is derived from the `VerifyingKey`'s
    (n, FriParams) schema — trailing bytes, truncation, or a header that
    disagrees with the key are hard `ValueError`s, never silent
    acceptance.

The layout is versioned by magic tags (HSP2 = Hades Succinct Proof v2 —
v1 shipped per-leaf sibling paths and positions; v2's pruned multiproof
layout is ~7x smaller at production parameters — HVK2 / HAP2 likewise).
"""

from __future__ import annotations

import struct

import numpy as np

from .fri import (
    ARITY,
    FriParams,
    FriProof,
    SuccinctProof,
    TREE_ORDER,
    VerifyingKey,
    eval_order,
    proof_schema,
    tree_columns,
)
from .params import N_DIGITS
from .utils.encoding import (
    bytes_to_digits,
    digits_to_bytes,
    scalar_from_bytes,
    scalar_to_bytes,
)

MAGIC_PROOF = b"HSP2"
MAGIC_VK = b"HVK2"
MAGIC_AGG = b"HAP2"

#: Wire order of the proof's own commitment roots.
ROOT_NAMES = ("w", "z", "t")

# n, blowup, q, final_degree, pow_bits, zk, n_final
_PROOF_HEADER = struct.Struct("<IIIIBBH")
# n, n_gates, blowup, q, final_degree, pow_bits, zk
_VK_HEADER = struct.Struct("<IIIIIBB")
# n, blowup, q, final_degree, pow_bits, zk, n_final, n_instances
_AGG_HEADER = struct.Struct("<IIIIBBHI")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _tree_block_sizes(params: FriParams) -> dict:
    return {name: 2 * len(cols)
            for name, cols in tree_columns(params.zk).items()}


def expected_proof_size(n: int, params: FriParams,
                        n_final: int | None = None) -> int:
    """Upper bound on the serialized size in bytes (header included):
    assumes all n_queries indices distinct and zero cross-path merging —
    real proofs are smaller (multiproof pruning merges paths toward the
    root; `len(proof_to_bytes(...))` is the exact figure)."""
    schema = proof_schema(n, params)
    if n_final is None:
        n_final = schema["final_degree"]
    q = params.n_queries
    sizes = _tree_block_sizes(params)

    def worst_nodes(height: int) -> int:
        # level l has 4^(height-l) slots; <= q covered groups, each
        # supplying <= ARITY-1 children
        return sum(
            (ARITY - 1) * min(q, ARITY ** (height - lvl - 1))
            for lvl in range(height)
        )

    size = len(MAGIC_PROOF) + _PROOF_HEADER.size
    size += 32 * (len(ROOT_NAMES) + len(eval_order(params.zk))
                  + len(schema["sched"]) + n_final)
    size += _U64.size  # pow nonce
    size += _U16.size  # n_unique0
    for name in TREE_ORDER:
        size += q * sizes[name] * 32
        size += _U32.size + worst_nodes(schema["h_pos"]) * 32
    for (k, bs), h in zip(schema["sched"], schema["layer_heights"]):
        size += _U16.size + q * bs * 32
        size += _U32.size + worst_nodes(h) * 32
    return size


def proof_byte_breakdown(proof: SuccinctProof, vk: VerifyingKey) -> dict:
    """Where the bytes go: per-section byte counts of `proof_to_bytes`'
    exact layout. The sections sum to `len(proof_to_bytes(proof, vk))`
    (asserted in tests), so this is the instrument for choosing the next
    wire lever. Keys:

      header / roots / evals / fri_layer_roots / final_coeffs /
      pow_nonce / counts — fixed-shape scaffolding;
      tree_blocks[name] — the opened leaf-block values per phase tree;
      tree_nodes[name] — that tree's pruned multiproof digests;
      fri_layer_blocks / fri_layer_nodes — per committed FRI layer;
      total — the full serialized size.
    """
    params = vk.params
    schema = proof_schema(vk.n, params)
    sizes = _tree_block_sizes(params)
    u0 = len(proof.open_blocks["w"])
    out = {
        "header": len(MAGIC_PROOF) + _PROOF_HEADER.size,
        "roots": 32 * len(ROOT_NAMES),
        "evals": 32 * len(eval_order(params.zk)),
        "fri_layer_roots": 32 * len(schema["sched"]),
        "final_coeffs": 32 * len(proof.fri.final_coeffs),
        "pow_nonce": _U64.size,
        "counts": (_U16.size + len(TREE_ORDER) * _U32.size
                   + len(schema["sched"]) * (_U16.size + _U32.size)),
        "tree_blocks": {}, "tree_nodes": {},
        "fri_layer_blocks": [], "fri_layer_nodes": [],
    }
    for name in TREE_ORDER:
        out["tree_blocks"][name] = 32 * u0 * sizes[name]
        out["tree_nodes"][name] = 32 * int(
            np.asarray(proof.open_nodes[name]).reshape(-1, N_DIGITS).shape[0]
        )
    for li, (k, bs) in enumerate(schema["sched"]):
        out["fri_layer_blocks"].append(
            32 * bs * len(proof.fri.layer_blocks[li])
        )
        out["fri_layer_nodes"].append(32 * int(
            np.asarray(proof.fri.layer_nodes[li])
            .reshape(-1, N_DIGITS).shape[0]
        ))
    out["total"] = (
        sum(v for v in out.values() if isinstance(v, int))
        + sum(out["tree_blocks"].values())
        + sum(out["tree_nodes"].values())
        + sum(out["fri_layer_blocks"])
        + sum(out["fri_layer_nodes"])
    )
    return out


def _blocks_bytes(blocks, bs: int, q: int, u: int) -> bytes:
    if len(blocks) != u or any(len(b) != bs for b in blocks):
        raise ValueError(
            f"opened-block set must be ({u}, {bs}) canonical values"
        )
    return b"".join(scalar_to_bytes(int(v)) for b in blocks for v in b)


def _nodes_bytes(nodes, height: int, q: int) -> bytes:
    arr = np.asarray(nodes, np.uint32).reshape(-1, N_DIGITS)
    if arr.shape[0] > (ARITY - 1) * height * q:
        raise ValueError("pruned node set larger than any valid plan")
    return _U32.pack(arr.shape[0]) + digits_to_bytes(arr)


def proof_to_bytes(proof: SuccinctProof, vk: VerifyingKey) -> bytes:
    """Serialize a succinct proof against the key's schema. Malformed
    structure (wrong shapes, non-canonical values, impossible node
    counts) raises instead of producing undecodable bytes."""
    params = vk.params
    schema = proof_schema(vk.n, params)
    q = params.n_queries
    sizes = _tree_block_sizes(params)
    n_final = len(proof.fri.final_coeffs)
    if n_final > schema["final_degree"]:
        raise ValueError("final_coeffs exceeds the effective final degree")
    if len(proof.fri.layer_roots) != len(schema["sched"]):
        raise ValueError("layer_roots count disagrees with the key schema")
    u0 = len(proof.open_blocks.get("w", ()))
    if not 1 <= u0 <= q:
        raise ValueError("opened-position count out of range")
    out = bytearray()
    out += MAGIC_PROOF
    out += _PROOF_HEADER.pack(vk.n, params.blowup, q, params.final_degree,
                              params.pow_bits, int(params.zk), n_final)
    for name in ROOT_NAMES:
        if name not in proof.roots:
            raise ValueError(f"missing commitment root {name!r}")
        out += scalar_to_bytes(int(proof.roots[name]))
    for name in eval_order(params.zk):
        if name not in proof.evals:
            raise ValueError(f"missing claimed evaluation {name!r}")
        out += scalar_to_bytes(int(proof.evals[name]))
    for root in proof.fri.layer_roots:
        out += scalar_to_bytes(int(root))
    for c in proof.fri.final_coeffs:
        out += scalar_to_bytes(int(c))
    out += _U64.pack(int(proof.pow_nonce))
    out += _U16.pack(u0)
    for name in TREE_ORDER:
        if (name not in proof.open_blocks
                or name not in proof.open_nodes):
            raise ValueError(f"missing opening for tree {name!r}")
        out += _blocks_bytes(proof.open_blocks[name], sizes[name], q, u0)
        out += _nodes_bytes(proof.open_nodes[name], schema["h_pos"], q)
    for part in (proof.fri.layer_blocks, proof.fri.layer_nodes):
        if len(part) != len(schema["sched"]):
            raise ValueError("FRI layer blocks disagree with the key schema")
    for li, ((k, bs), h) in enumerate(zip(schema["sched"],
                                          schema["layer_heights"])):
        u_k = len(proof.fri.layer_blocks[li])
        if not 1 <= u_k <= q:
            raise ValueError("layer opened-position count out of range")
        out += _U16.pack(u_k)
        out += _blocks_bytes(proof.fri.layer_blocks[li], bs, q, u_k)
        out += _nodes_bytes(proof.fri.layer_nodes[li], h, q)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated encoding")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def scalar(self) -> int:
        return scalar_from_bytes(self.take(32))

    def scalars(self, n: int) -> list[int]:
        return [self.scalar() for _ in range(n)]

    def u16(self) -> int:
        return _U16.unpack(self.take(_U16.size))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(_U32.size))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(_U64.size))[0]

    def blocks(self, u: int, bs: int) -> list[list[int]]:
        flat = self.scalars(u * bs)
        return [flat[i * bs : (i + 1) * bs] for i in range(u)]

    def nodes(self, height: int, q: int) -> np.ndarray:
        count = self.u32()
        if count > (ARITY - 1) * height * q:
            raise ValueError("pruned node set larger than any valid plan")
        raw = self.take(count * 32)
        # bytes_to_digits appends the trailing N_DIGITS axis itself;
        # it rejects non-canonical digests
        return bytes_to_digits(raw, (count,))

    def done(self):
        if self.pos != len(self.data):
            raise ValueError(
                f"{len(self.data) - self.pos} trailing bytes after proof"
            )


def proof_from_bytes(data: bytes, vk: VerifyingKey) -> SuccinctProof:
    """Strict inverse of `proof_to_bytes`: header must agree with the
    key, every scalar canonical, every count within schema bounds, and
    the byte count exact. Plan-exactness of the pruned node sets is the
    verifier's job (it derives the indices from the transcript)."""
    r = _Reader(data)
    if r.take(len(MAGIC_PROOF)) != MAGIC_PROOF:
        raise ValueError("not a Hades succinct proof (bad magic)")
    params = vk.params
    n, blowup, q, final_degree, pow_bits, zk, n_final = (
        _PROOF_HEADER.unpack(r.take(_PROOF_HEADER.size))
    )
    if (n, blowup, q, final_degree, pow_bits, bool(zk)) != (
        vk.n, params.blowup, params.n_queries, params.final_degree,
        params.pow_bits, params.zk,
    ):
        raise ValueError("proof header disagrees with the verifying key")
    schema = proof_schema(vk.n, params)
    sizes = _tree_block_sizes(params)
    if n_final > schema["final_degree"]:
        raise ValueError("final_coeffs exceeds the effective final degree")
    roots = {name: r.scalar() for name in ROOT_NAMES}
    evals = {name: r.scalar() for name in eval_order(params.zk)}
    layer_roots = r.scalars(len(schema["sched"]))
    final_coeffs = r.scalars(n_final)
    pow_nonce = r.u64()
    u0 = r.u16()
    if not 1 <= u0 <= q:
        raise ValueError("opened-position count out of range")
    open_blocks, open_nodes = {}, {}
    for name in TREE_ORDER:
        open_blocks[name] = r.blocks(u0, sizes[name])
        open_nodes[name] = r.nodes(schema["h_pos"], q)
    layer_blocks, layer_nodes = [], []
    for (k, bs), h in zip(schema["sched"], schema["layer_heights"]):
        u_k = r.u16()
        if not 1 <= u_k <= q:
            raise ValueError("layer opened-position count out of range")
        layer_blocks.append(r.blocks(u_k, bs))
        layer_nodes.append(r.nodes(h, q))
    r.done()
    return SuccinctProof(
        roots=roots,
        evals=evals,
        pow_nonce=pow_nonce,
        fri=FriProof(
            layer_roots=layer_roots,
            final_coeffs=final_coeffs,
            layer_blocks=layer_blocks,
            layer_nodes=layer_nodes,
        ),
        open_blocks=open_blocks,
        open_nodes=open_nodes,
    )


def vk_to_bytes(vk: VerifyingKey) -> bytes:
    """Serialize the verifier key (domain facts + statement digest + the
    preprocessed block tree's single root); the reference analogue is
    moving dusk-plonk's verifier data as bytes."""
    out = bytearray()
    out += MAGIC_VK
    out += _VK_HEADER.pack(vk.n, vk.n_gates, vk.params.blowup,
                           vk.params.n_queries, vk.params.final_degree,
                           vk.params.pow_bits, int(vk.params.zk))
    out += scalar_to_bytes(int(vk.digest))
    out += scalar_to_bytes(int(vk.k_root))
    return bytes(out)


def vk_from_bytes(data: bytes) -> VerifyingKey:
    """Strict inverse of `vk_to_bytes` (omega is recomputed from n — it
    is a domain fact, not free data)."""
    from .plonk import _domain_root

    r = _Reader(data)
    if r.take(len(MAGIC_VK)) != MAGIC_VK:
        raise ValueError("not a Hades verifying key (bad magic)")
    n, n_gates, blowup, q, final_degree, pow_bits, zk = _VK_HEADER.unpack(
        r.take(_VK_HEADER.size)
    )
    if n < 1 or n & (n - 1):
        raise ValueError("domain size must be a power of two")
    if not 0 < n_gates <= n:
        raise ValueError("gate count out of range for the domain")
    params = FriParams(blowup=blowup, n_queries=q,
                       final_degree=final_degree, pow_bits=pow_bits,
                       zk=bool(zk))
    digest = r.scalar()
    k_root = r.scalar()
    r.done()
    return VerifyingKey(n=n, omega=_domain_root(n), n_gates=n_gates,
                        digest=digest, k_root=k_root, params=params)


# ---------------------------------------------------------------------------
# Aggregated proofs (aggregate.py): HAP2
# ---------------------------------------------------------------------------


def expected_aggregate_size(n: int, params: FriParams, n_instances: int,
                            n_final: int | None = None) -> int:
    """Upper bound on the serialized aggregate size in bytes (same
    no-merging assumption as expected_proof_size)."""
    from .aggregate import KEY_EVAL_ORDER, WIRE_EVAL_ORDER, agg_tree_specs

    schema = proof_schema(n, params)
    if n_final is None:
        n_final = schema["final_degree"]
    q = params.n_queries
    specs = agg_tree_specs(params.zk, n_instances)

    def worst_nodes(height: int) -> int:
        return sum(
            (ARITY - 1) * min(q, ARITY ** (height - lvl - 1))
            for lvl in range(height)
        )

    size = len(MAGIC_AGG) + _AGG_HEADER.size
    size += 32 * (
        len(ROOT_NAMES)
        + n_instances * len(WIRE_EVAL_ORDER)
        + len(KEY_EVAL_ORDER)
        + (1 if params.zk else 0)
        + len(schema["sched"])
        + n_final
    )
    size += _U64.size + _U16.size
    for name in TREE_ORDER:
        size += q * specs[name] * 32
        size += _U32.size + worst_nodes(schema["h_pos"]) * 32
    for (k, bs), h in zip(schema["sched"], schema["layer_heights"]):
        size += _U16.size + q * bs * 32
        size += _U32.size + worst_nodes(h) * 32
    return size


def aggregate_to_bytes(proof, vk: VerifyingKey) -> bytes:
    """Serialize an `aggregate.AggregateProof` against the key's schema.
    Same strictness contract as `proof_to_bytes`."""
    from .aggregate import KEY_EVAL_ORDER, WIRE_EVAL_ORDER, agg_tree_specs

    params = vk.params
    schema = proof_schema(vk.n, params)
    q = params.n_queries
    n_inst = int(proof.n_instances)
    if n_inst < 1:
        raise ValueError("aggregate proof needs at least one instance")
    if len(proof.evals) != n_inst:
        raise ValueError("per-instance evaluation count != n_instances")
    specs = agg_tree_specs(params.zk, n_inst)
    n_final = len(proof.fri.final_coeffs)
    if n_final > schema["final_degree"]:
        raise ValueError("final_coeffs exceeds the effective final degree")
    if len(proof.fri.layer_roots) != len(schema["sched"]):
        raise ValueError("layer_roots count disagrees with the key schema")
    u0 = len(proof.open_blocks.get("w", ()))
    if not 1 <= u0 <= q:
        raise ValueError("opened-position count out of range")
    out = bytearray()
    out += MAGIC_AGG
    out += _AGG_HEADER.pack(vk.n, params.blowup, q, params.final_degree,
                            params.pow_bits, int(params.zk), n_final,
                            n_inst)
    for name in ROOT_NAMES:
        if name not in proof.roots:
            raise ValueError(f"missing commitment root {name!r}")
        out += scalar_to_bytes(int(proof.roots[name]))
    for e in proof.evals:
        for name in WIRE_EVAL_ORDER:
            if name not in e:
                raise ValueError(f"missing claimed evaluation {name!r}")
            out += scalar_to_bytes(int(e[name]))
    for name in KEY_EVAL_ORDER:
        if name not in proof.key_evals:
            raise ValueError(f"missing key evaluation {name!r}")
        out += scalar_to_bytes(int(proof.key_evals[name]))
    if params.zk:
        if proof.r_eval is None:
            raise ValueError("missing zk mask evaluation")
        out += scalar_to_bytes(int(proof.r_eval))
    for root in proof.fri.layer_roots:
        out += scalar_to_bytes(int(root))
    for c in proof.fri.final_coeffs:
        out += scalar_to_bytes(int(c))
    out += _U64.pack(int(proof.pow_nonce))
    out += _U16.pack(u0)
    for name in TREE_ORDER:
        if (name not in proof.open_blocks
                or name not in proof.open_nodes):
            raise ValueError(f"missing opening for tree {name!r}")
        out += _blocks_bytes(proof.open_blocks[name], specs[name], q, u0)
        out += _nodes_bytes(proof.open_nodes[name], schema["h_pos"], q)
    for part in (proof.fri.layer_blocks, proof.fri.layer_nodes):
        if len(part) != len(schema["sched"]):
            raise ValueError("FRI layer blocks disagree with the key schema")
    for li, ((k, bs), h) in enumerate(zip(schema["sched"],
                                          schema["layer_heights"])):
        u_k = len(proof.fri.layer_blocks[li])
        if not 1 <= u_k <= q:
            raise ValueError("layer opened-position count out of range")
        out += _U16.pack(u_k)
        out += _blocks_bytes(proof.fri.layer_blocks[li], bs, q, u_k)
        out += _nodes_bytes(proof.fri.layer_nodes[li], h, q)
    return bytes(out)


def aggregate_from_bytes(data: bytes, vk: VerifyingKey):
    """Strict inverse of `aggregate_to_bytes` (same contract as
    `proof_from_bytes`)."""
    from .aggregate import (
        AggregateProof,
        KEY_EVAL_ORDER,
        WIRE_EVAL_ORDER,
        agg_tree_specs,
    )

    r = _Reader(data)
    if r.take(len(MAGIC_AGG)) != MAGIC_AGG:
        raise ValueError("not a Hades aggregated proof (bad magic)")
    params = vk.params
    n, blowup, q, final_degree, pow_bits, zk, n_final, n_inst = (
        _AGG_HEADER.unpack(r.take(_AGG_HEADER.size))
    )
    if (n, blowup, q, final_degree, pow_bits, bool(zk)) != (
        vk.n, params.blowup, params.n_queries, params.final_degree,
        params.pow_bits, params.zk,
    ):
        raise ValueError("proof header disagrees with the verifying key")
    if n_inst < 1:
        raise ValueError("aggregate proof needs at least one instance")
    schema = proof_schema(vk.n, params)
    specs = agg_tree_specs(params.zk, n_inst)
    if n_final > schema["final_degree"]:
        raise ValueError("final_coeffs exceeds the effective final degree")
    roots = {name: r.scalar() for name in ROOT_NAMES}
    evals = [
        {name: r.scalar() for name in WIRE_EVAL_ORDER}
        for _ in range(n_inst)
    ]
    key_evals = {name: r.scalar() for name in KEY_EVAL_ORDER}
    r_eval = r.scalar() if params.zk else None
    layer_roots = r.scalars(len(schema["sched"]))
    final_coeffs = r.scalars(n_final)
    pow_nonce = r.u64()
    u0 = r.u16()
    if not 1 <= u0 <= q:
        raise ValueError("opened-position count out of range")
    open_blocks, open_nodes = {}, {}
    for name in TREE_ORDER:
        open_blocks[name] = r.blocks(u0, specs[name])
        open_nodes[name] = r.nodes(schema["h_pos"], q)
    layer_blocks, layer_nodes = [], []
    for (k, bs), h in zip(schema["sched"], schema["layer_heights"]):
        u_k = r.u16()
        if not 1 <= u_k <= q:
            raise ValueError("layer opened-position count out of range")
        layer_blocks.append(r.blocks(u_k, bs))
        layer_nodes.append(r.nodes(h, q))
    r.done()
    return AggregateProof(
        n_instances=n_inst,
        roots=roots,
        evals=evals,
        key_evals=key_evals,
        r_eval=r_eval,
        pow_nonce=pow_nonce,
        fri=FriProof(
            layer_roots=layer_roots,
            final_coeffs=final_coeffs,
            layer_blocks=layer_blocks,
            layer_nodes=layer_nodes,
        ),
        open_blocks=open_blocks,
        open_nodes=open_nodes,
    )
