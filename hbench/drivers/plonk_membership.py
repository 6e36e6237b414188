"""Driver: prove batches of note-membership circuits with
`prover_cuda.prove_batched`.

Set-up makes the configuration's leaves on the card from the seed and builds
the populated subtree with `merkle_levels`; draws a pool of uniform leaf
positions from the seed; takes every one's path in the tree of the
configuration's height with `circuits.merkle_path_ints(..., height)` (one
gather a level, one conversion and one copy to the host for the whole
pool); builds each instance's circuit with
`circuits.merkle_membership_circuit` (private leaf and position, public
root); preprocesses the key once and proves one batch to warm up (its
graphs capture). A step proves the next `batch` instances of
the pool, in turn; the proofs come back as host objects.

The check draws one of the pool's batches and two of its slots from the
seed, one from each half of the batch; the warm-up proves the batch before
it and the window starts at it, so every window proves it and no proof of
the warm-up's stands in for it. The check builds the tree, the paths, the
circuits, the key and the proofs of those two instances again in the
reference (`hbench/reference/membership.py`), one process an instance, and
holds every proof of those instances that the window made to them: its
wires, z, t and commitments.

Configuration: `leaves`, `height`, `gates`, `domain`, `partial_rounds`.
Traffic: `batch`, `pool` (a multiple of `batch`).
"""

from __future__ import annotations

import concurrent.futures
import inspect
import multiprocessing
import random

import torch

from hbench import inputs
from hbench.drivers.plonk_batch import _parts


class Driver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from hades252_tpu_torch import circuits, plonk, prover_cuda
        from hades252_tpu_torch.models import merkle

        if "height" not in inspect.signature(circuits.merkle_path_ints).parameters:
            raise RuntimeError("the package opens only its built tree: merkle_path_ints "
                               "takes no height")
        self.prover, self.device = prover_cuda, device
        self.partial_rounds = int(conf["partial_rounds"])
        self.height, n = int(conf["height"]), int(conf["leaves"])
        self.b, pool = int(traffic["batch"]), int(traffic["pool"])
        g = inputs.generator(seed, device)
        self.leaves = inputs.leaves(g, (n,), device)
        self.index = torch.randint(0, n, (pool,), generator=g, device=device).tolist()
        levels = merkle.merkle_levels(self.leaves)
        paths = circuits.merkle_path_ints(levels, self.index, self.height)
        del levels
        self.composers = [circuits.merkle_membership_circuit(*p) for p in paths]
        self.key = plonk.preprocess(self.composers[0])
        if self.key.n != conf["domain"] or self.key.n_gates != conf["gates"]:
            raise RuntimeError(f"the circuit has {self.key.n_gates} gates, n = {self.key.n}")
        rng = random.Random(seed)
        self.start = rng.randrange(pool // self.b) * self.b
        half = self.b // 2
        self.checked = [self.start + rng.randrange(half),
                        self.start + half + rng.randrange(self.b - half)]
        self.proofs: list[tuple[int, object]] = []
        self.steps = 0
        self._prove((self.start - self.b) % pool)

    def _prove(self, first: int) -> list:
        return self.prover.prove_batched(self.composers[first:first + self.b], self.key,
                                         device=self.device)

    def step(self) -> int:
        first = (self.start + self.steps * self.b) % len(self.composers)
        self.steps += 1
        proofs = self._prove(first)
        for j, proof in enumerate(proofs):
            if first + j in self.checked:
                self.proofs.append((first + j, proof))
        return self.b

    def release(self) -> None:
        self.composers = self.key = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _expected(self, partial_rounds: int) -> dict:
        """{instance: the reference's proof}, the tree, the paths and the
        transcripts with `partial_rounds` (below the configuration's only
        for the control), one spawned process an instance."""
        from hbench.reference import membership as ref

        paths = ref.paths(self.leaves, [self.index[i] for i in self.checked], self.height,
                          partial_rounds)
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(len(paths), mp_context=ctx) as pool:
            proofs = list(pool.map(ref.prove_path, paths, [partial_rounds] * len(paths)))
        return dict(zip(self.checked, proofs))

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
