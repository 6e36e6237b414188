"""Driver: prove batches of the permutation-preimage circuit with
`prover_cuda.prove_batched`.

Set-up draws a pool of instances from the seed (5 words each and their
image, which the reference computes), builds each instance's circuit with
the package's gadget (the permutation, then one public gate binding each
output to its image), preprocesses the key once and proves one batch to
warm up (its graph captures). A step proves the next `batch` instances of
the pool; the proofs come back as host objects.

The check draws one of the pool's batches from the seed, so that every slot
of a step is checked, builds the circuits, the key and the proofs of its
instances again in the reference (`hbench/reference/plonk.py`) and holds
every proof of those instances that the window made to them: its wires, z,
t and commitments.

Traffic: `batch`, `pool` (a multiple of `batch`).
"""

from __future__ import annotations

import random

import torch

from hbench import inputs


def composer(words: list, image: list):
    """One instance's circuit, built by the package's gadget."""
    from hades252_tpu_torch.gadget import Composer, Constraint, GadgetStrategy

    c = Composer()
    ws = [c.append_witness(w) for w in words]
    GadgetStrategy.gadget(c, ws)             # ws now holds the output wires
    for w, e in zip(ws, image):
        c.append_gate(Constraint().left(1).a(w).public(-e))
    return c


class Driver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from hades252_tpu_torch import plonk, prover_cuda

        self.prover, self.device = prover_cuda, device
        self.partial_rounds = int(conf["partial_rounds"])
        self.b, pool = int(traffic["batch"]), int(traffic["pool"])
        self.words, self.images = inputs.preimages(seed, pool)
        self.composers = [composer(w, e) for w, e in zip(self.words, self.images)]
        self.key = plonk.preprocess(self.composers[0])
        if self.key.n != conf["domain"] or self.key.n_gates != conf["gates"]:
            raise RuntimeError(f"the circuit has {self.key.n_gates} gates, n = {self.key.n}")
        first = random.Random(seed).randrange(pool // self.b) * self.b
        self.checked = list(range(first, first + self.b))
        self.proofs: list[tuple[int, object]] = []
        self.steps = 0
        self._prove(0)

    def _prove(self, first: int) -> list:
        return self.prover.prove_batched(self.composers[first:first + self.b], self.key,
                                         device=self.device)

    def step(self) -> int:
        first = self.steps * self.b % len(self.composers)
        self.steps += 1
        for j, proof in enumerate(self._prove(first)):
            if first + j in self.checked:
                self.proofs.append((first + j, proof))
        return self.b

    def release(self) -> None:
        self.composers = self.key = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _expected(self, partial_rounds: int) -> dict:
        from hbench.reference import plonk as ref

        return ref.prove_instances([self.words[i] for i in self.checked],
                                   [self.images[i] for i in self.checked],
                                   self.checked, partial_rounds)

    def control(self) -> dict:
        return self._expected(self.partial_rounds - 1)

    def check(self, outputs: dict | None = None) -> tuple[dict, int]:
        """(the numbers compared with their limits, the steps found wrong);
        outputs: proofs by instance to judge in the program's place."""
        want = self._expected(self.partial_rounds)
        wrong = 0
        for i, proof in self.proofs:
            got = proof if outputs is None else outputs[i]
            wrong += _parts(got) != _parts(want[i])
        return {"proofs_wrong": {"value": wrong, "limit": 0}}, wrong


def _parts(proof) -> tuple:
    """What is compared of a proof: its wires, z, t and commitments."""
    return ([list(map(int, w)) for w in proof.wires], list(map(int, proof.z)),
            list(map(int, proof.t)), {k: int(v) for k, v in proof.commitments.items()})
