"""Driver: succinct proofs of the permutation-preimage circuit with
`fri_cuda.prove_succinct_device`, one at a time.

Set-up draws a pool of instances from the seed (as `plonk_batch` does),
builds their circuits with the package's gadget, makes the succinct key at
the cell's preset with `fri.preprocess_succinct` and proves one instance to
warm up (the FRI phase's graph capture, the kernels). A step proves the next
instance of the pool with a generator seeded for that proof.

The check draws `checked_proofs` of the instances that the window proved
from the seed, proves them again in the reference (`hbench/reference/fri.py`:
its own circuit, key, trees and transcript) and holds the bytes of every
proof of those instances that the window made to the reference's.

Traffic: `pool`, `checked_proofs`, `preset` (FriParams' fields).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from hbench import inputs
from hbench.drivers.plonk_batch import composer


class Driver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from hades252_tpu_torch import fri, fri_cuda, serialize

        self.fri_cuda, self.serialize, self.device = fri_cuda, serialize, device
        self.partial_rounds = int(conf["partial_rounds"])
        pool = int(traffic["pool"])
        self.preset = dict(traffic["preset"])
        self.seed = seed
        self.words, self.images = inputs.preimages(seed, pool)
        self.composers = [composer(w, e) for w, e in zip(self.words, self.images)]
        self.pk, self.vk = fri.preprocess_succinct(self.composers[0], fri.FriParams(**self.preset))
        if self.vk.n != conf["domain"] or self.vk.n_gates != conf["gates"]:
            raise RuntimeError(f"the circuit has {self.vk.n_gates} gates, n = {self.vk.n}")
        self.n_checked = int(traffic["checked_proofs"])
        self.proofs: list[tuple[int, object]] = []
        self.steps = 0
        self._prove(0)

    def _prove(self, i: int):
        rng = np.random.default_rng([self.seed % (1 << 64), self.steps])
        return self.fri_cuda.prove_succinct_device(self.composers[i], self.pk, rng,
                                                   device=self.device)

    def step(self) -> int:
        i = self.steps % len(self.composers)
        proof = self._prove(i)
        self.steps += 1
        self.proofs.append((i, proof))
        return 1

    def release(self) -> None:
        proven = sorted({i for i, _ in self.proofs})
        self.checked = sorted(random.Random(self.seed).sample(proven, min(self.n_checked,
                                                                          len(proven))))
        self.proofs = [(i, self.serialize.proof_to_bytes(p, self.vk))
                       for i, p in self.proofs if i in self.checked]
        self.composers = self.pk = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _expected(self, partial_rounds: int) -> dict:
        from hbench.reference import fri as ref

        return ref.prove_instances([self.words[i] for i in self.checked],
                                   [self.images[i] for i in self.checked], self.checked,
                                   ref.Params(**self.preset), self.device, partial_rounds)

    def control(self) -> dict:
        return self._expected(self.partial_rounds - 1)

    def check(self, outputs: dict | None = None) -> tuple[dict, int]:
        """(the numbers compared with their limits, the steps found wrong);
        outputs: proof bytes by instance to judge in the program's place."""
        want = self._expected(self.partial_rounds)
        wrong = sum((data if outputs is None else outputs[i]) != want[i] for i, data in self.proofs)
        return {"proofs_wrong": {"value": wrong, "limit": 0}}, wrong
