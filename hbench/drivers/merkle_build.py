"""Driver: build arity-4 trees of the configuration's height, one a step.

The configuration's leaves populate the tree from its left; every other leaf
is 0. Set-up makes a pool of leaf sets on the card from the seed, works out
with the package the digests of the empty subtrees above the populated
subtree, and builds one tree to warm up. A step builds the populated
subtree over the next set of the pool with `merkle_levels`, lifts its root
to the tree's height (`Lift`) and reads the root back to the host. The
check holds every root of the sets drawn from the seed to the reference's
root of that set, and every other root to the first root of its own set.

Configuration: `leaves`, `height`, `arity`, `partial_rounds`. Traffic: `pool`
(leaf sets), `checked_sets`.
"""

from __future__ import annotations

import random

import torch

from hbench import inputs, roofline
from hbench.reference import hades


class Lift:
    """The levels of a tree above its populated subtree, by the package:
    each parent is the package's permutation of the node rule's state (the
    tag, the node, and the digest of an empty subtree of the node's height
    three times), in its Montgomery form, as `merkle_levels` builds a
    level; the root is converted out once. The empty subtrees' digests are
    the package's roots of zero leaves (`merkle_root` of four of the digest
    below). A `merkle_root` call a level instead costs some 7 ms of host
    launches on an NVIDIA H100 host, 40 ms a tree."""

    def __init__(self, merkle, n_leaves: int, height: int, device):
        from hades252_tpu_torch import field, ops

        self.merkle, self.field = merkle, field
        self.perm = ops.default_perm_mont_fn(device)
        self.dense, self.height = roofline.tree_height(n_leaves, merkle.ARITY), height
        z = [torch.zeros(16, dtype=torch.int32, device=device)]
        while len(z) < height:
            z.append(merkle.merkle_root(z[-1].expand(merkle.ARITY, 16).contiguous()))
        #: (height - dense, 16) Montgomery digits of the empty siblings above
        self.top = field.to_mont(torch.stack(z[self.dense:])) if height > self.dense else \
            torch.empty((0, 16), dtype=torch.int32, device=device)
        tag = torch.zeros((1, 1, 16), dtype=torch.int32, device=device)
        tag[..., 0] = merkle.TAG
        self.tag = field.to_mont(tag)

    def root(self, node: torch.Tensor) -> torch.Tensor:
        """(1, 16) Montgomery root of the populated subtree -> (16,)
        canonical root of the whole tree."""
        for zm in self.top:
            sibs = zm.expand(1, self.merkle.ARITY - 1, 16)
            state = torch.cat([self.tag, node[:, None], sibs], 1)
            node = self.perm(state)[:, self.merkle.DIGEST_INDEX]
        return self.field.from_mont(node[0])


class Driver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from hades252_tpu_torch.models import merkle

        self.merkle, self.device = merkle, device
        self.n, pool = int(conf["leaves"]), int(traffic["pool"])
        self.height = int(conf["height"])
        self.leaves = inputs.leaves(inputs.generator(seed, device), (pool, self.n), device)
        self.checked = sorted(random.Random(seed).sample(range(pool), int(traffic["checked_sets"])))
        self.partial_rounds = int(conf["partial_rounds"])
        self.perms_per_step = roofline.tree_perms(self.n, self.height, conf["arity"])
        self.lift = Lift(merkle, self.n, self.height, device)
        self.roots: list[tuple[int, torch.Tensor]] = []
        self._root(0).cpu()

    def _root(self, i: int) -> torch.Tensor:
        return self.lift.root(self.merkle.merkle_levels(self.leaves[i])[-1])

    def step(self) -> int:
        i = len(self.roots) % self.leaves.shape[0]
        self.roots.append((i, self._root(i).cpu()))
        return self.n

    def release(self) -> None:
        self.lift = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def expected_roots(self, partial_rounds: int) -> dict:
        return {i: hades.lift_root(hades.tree_levels(self.leaves[i], partial_rounds)[-1][0],
                                   roofline.tree_height(self.n), self.height,
                                   partial_rounds).cpu()
                for i in self.checked}

    def control(self) -> dict:
        """The control's roots: the reference one partial round short."""
        return self.expected_roots(self.partial_rounds - 1)

    def check(self, outputs: dict | None = None) -> tuple[dict, int]:
        """(the numbers compared with their limits, the steps found wrong);
        outputs: roots to judge in the program's place (the control's)."""
        want = self.expected_roots(self.partial_rounds)
        first: dict[int, torch.Tensor] = {}
        wrong = 0
        for i, root in self.roots:
            got = outputs[i] if outputs is not None and i in outputs else root
            ok = torch.equal(got, want[i]) if i in want else torch.equal(got, first.setdefault(i, got))
            wrong += not ok
        return {"roots_wrong": {"value": wrong, "limit": 0}}, wrong
