"""Quickstart: everything a dusk-network/Hades252 user needs, in one file,
on the PyTorch port.

    python -m hades252_tpu_torch.examples.quickstart               # on the card
    python -m hades252_tpu_torch.examples.quickstart --device cpu  # anywhere

The steps, sizes and printed lines are those of `examples/quickstart.py`
(the JAX package's). On the card the batched permutation, the sponge, the
Merkle trees and the cipher run the CUDA kernels, and the succinct proofs
are verified by the device verifiers; on the CPU the same calls run the
kernels' plain versions. Without a card the default raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart: no CUDA device; pass --device cpu")

    import hades252_tpu_torch as h
    from hades252_tpu_torch import aggregate, circuits, fri, fri_cuda, plonk, serialize
    from hades252_tpu_torch.models import cipher
    from hades252_tpu_torch.models.merkle import (
        merkle_levels,
        merkle_open,
        merkle_open_batched,
        merkle_root,
        merkle_verify,
        merkle_verify_batched,
    )
    from hades252_tpu_torch.models.sponge import SpongeState, sponge_hash_ints
    from hades252_tpu_torch.ops.perm_cuda import permute_cuda
    from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

    def on_device(values, shape):
        return torch.from_numpy(ints_to_digits(values, shape=shape).astype(np.int32)).to(device)

    # --- the permutation, reference-style (ScalarStrategy::perm) ------------
    state = [1, 2, 3, 4, 5]
    h.ScalarStrategy().perm(state)  # in place, like &mut [BlsScalar; 5]
    print("perm([1..5])[0] =", hex(state[0]))

    # --- batched, through the kernel (its plain version on the CPU) ---------
    x = on_device([[i, i, i, i, i] for i in range(8)], (8, 5))
    out = permute_cuda(x)
    print("batched:", tuple(out.shape))

    # --- sponge hashing -------------------------------------------------------
    print("sponge([1..5]) =", hex(sponge_hash_ints([1, 2, 3, 4, 5], device=device))[:20], "...")

    # streaming absorb + extendable squeeze
    st = SpongeState(n_streams=1, total_length=6, device=device)
    st.absorb(on_device([[1, 2]], (1, 2)))
    st.absorb(on_device([[3, 4, 5, 6]], (1, 4)))
    stream = st.squeeze(3)  # 3 output words
    print("squeeze(3):", [hex(int(digits_to_ints(w.cpu().numpy())))[:14] for w in stream[0]])

    # --- Merkle tree + inclusion proofs ---------------------------------------
    leaves = on_device(list(range(64)), (64,))
    root = merkle_root(leaves)
    levels = merkle_levels(leaves)
    path = merkle_open(levels, index=17)
    ok = merkle_verify(root, on_device([17], (1,))[0], path, height=3)
    print("merkle proof for leaf 17:", ok)

    # compact batched openings: 3 siblings a level, one permutation call a
    # level for the whole batch of proofs
    sibs, poss = merkle_open_batched(levels, [3, 17, 42])
    ok_b = merkle_verify_batched(root, leaves[[3, 17, 42]], sibs, poss, height=3)
    print("batched compact proofs:", [bool(v) for v in ok_b])

    # --- authenticated encryption (duplex cipher over the permutation) -------
    key = on_device([[11, 22]], (1, 2))
    nonce = on_device([33], (1,))
    msg = on_device([[1, 2, 3, 4]], (1, 4))
    ct, tag = cipher.encrypt(key, nonce, msg)
    pt, ok = cipher.decrypt(key, nonce, ct, tag)
    print("cipher roundtrip:", bool(ok[0]) and bool((pt[:, :4] == msg).all()))

    # --- PLONK constraint synthesis (GadgetStrategy) --------------------------
    c = h.Composer()
    ws = [c.append_witness(v) for v in (1, 2, 3, 4, 5)]
    h.GadgetStrategy.gadget(c, ws)
    print(f"gadget: {len(c)} gates, satisfied={c.check_satisfied()}, "
          f"out[0]={hex(c.value(ws[0]))[:14]}...")

    # --- polynomial prove/verify (curve-free PLONK argument) ------------------
    key_ck = plonk.preprocess(c)
    proof = plonk.prove(c, key_ck)
    print("plonk proof verifies:", plonk.verify(key_ck, proof, [g.pi for g in c.gates]))

    # --- succinct + zero-knowledge proofs (Hades-Merkle + DEEP-FRI PCS) ------
    # a tiny circuit and light parameters; production uses fri.FriParams()
    # or fri.FriParams.proven()
    tiny = h.Composer()
    a = tiny.append_witness(3)
    b = tiny.append_witness(5)
    tiny.gate_mul(h.Constraint().mult(1).a(a).b(b))
    params = fri.FriParams(blowup=4, n_queries=4, final_degree=8, zk=True)
    pk, vk = fri.preprocess_succinct(tiny, params)
    sp = fri.prove_succinct(tiny, pk)
    print("succinct zk proof verifies:",
          fri.verify_succinct(vk, sp, [g.pi for g in tiny.gates]),
          f"({fri.proof_size_field_elements(sp)} field elements)")

    # --- proofs and keys as bytes ---------------------------------------------
    wire_vk = serialize.vk_to_bytes(vk)
    wire_sp = serialize.proof_to_bytes(sp, vk)
    vk2 = serialize.vk_from_bytes(wire_vk)        # another process or host
    sp2 = serialize.proof_from_bytes(wire_sp, vk2)
    print("wire roundtrip verifies:",
          fri.verify_succinct(vk2, sp2, [g.pi for g in tiny.gates]),
          f"({len(wire_sp)} proof bytes, {len(wire_vk)} key bytes)")

    # --- in-circuit gadgets: prove statements ABOUT the models ---------------
    small = on_device(list(range(100, 116)), (16,))
    small_levels = merkle_levels(small)
    leaf, groups, positions, mroot = circuits.merkle_path_ints(small_levels, 9)
    mc = circuits.merkle_membership_circuit(leaf, groups, positions, mroot, index=9)
    mkey = plonk.preprocess(mc)
    mproof = plonk.prove(mc, mkey)
    print(f"merkle membership circuit ({len(mc)} gates, n={mkey.n}) verifies:",
          plonk.verify(mkey, mproof, circuits.public_input_column(mc)))

    # --- aggregated proofs: ONE argument for B same-circuit instances ---------
    def tiny_instance(x: int, y: int):
        ci = h.Composer()
        wa = ci.append_witness(x)
        wb = ci.append_witness(y)
        ci.gate_mul(h.Constraint().mult(1).a(wa).b(wb))
        return ci

    batch = [tiny_instance(3, 5), tiny_instance(2, 9), tiny_instance(7, 11)]
    agg = aggregate.prove_aggregate(batch, pk)
    pis = [[g.pi for g in ci.gates] for ci in batch]
    wire_agg = serialize.aggregate_to_bytes(agg, vk)
    print("aggregate of", agg.n_instances, "instances verifies:",
          aggregate.verify_aggregate(vk, agg, pis),
          f"({aggregate.aggregate_size_field_elements(agg)} field elements, "
          f"{len(wire_agg)} wire bytes, vs "
          f"{3 * fri.proof_size_field_elements(sp)} for 3 separate proofs)")

    # --- the device verifiers --------------------------------------------------
    # every pooled opening chain below runs as one CUDA graph replay on the
    # card (the plain version on the CPU); verdicts equal the host path's
    verdicts = fri_cuda.verify_succinct_device_batch(
        vk, [sp, sp], [[g.pi for g in tiny.gates]] * 2, device=device)
    print("device verification entry points:", list(map(bool, verdicts)),
          "| aggregate:", fri_cuda.verify_aggregate_device(vk, agg, pis, device=device))


if __name__ == "__main__":
    main()
