"""Driver: open and verify memberships of one arity-4 tree of the
configuration's height.

The configuration's leaves populate the tree from its left; every other leaf
is 0. Set-up makes the leaves on the card from the seed, builds the levels
of the populated subtree, works out with the package the digests of the
empty subtrees above it (in its Montgomery form, as openings carry them) and
the tree's root, and makes a pool of batches of uniform leaf indices with a
seeded share of the openings marked for tampering. A step runs
`merkle_open_batched` on its batch, extends each opening to the tree's
height with the empty subtrees' digests (the node is child 0 at each level
above the populated subtree), changes one bit of one sibling of each marked
opening at any level (as a client that forges a proof would), runs
`merkle_verify_batched` against the root and reads the verdicts back to the
host.

The check builds the tree again in the reference and holds to it the root,
the siblings and positions opened (in the package's Montgomery form, worked
out again) of the batches drawn from the seed, and every verdict of those
batches to the reference's own walk of the same (tampered) openings.

Configuration: `leaves`, `height`, `arity`, `partial_rounds`. Traffic: `batch`,
`batches` (the pool), `tamper_share`, `checked_batches`.
"""

from __future__ import annotations

import random

import torch

from hbench import inputs, roofline
from hbench.drivers.merkle_build import Lift
from hbench.reference import hades


class Driver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        from hades252_tpu_torch.models import merkle

        self.merkle, self.device = merkle, device
        self.partial_rounds = int(conf["partial_rounds"])
        n, k = int(conf["leaves"]), int(traffic["batch"])
        self.k, pool = k, int(traffic["batches"])
        g = inputs.generator(seed, device)
        self.leaves = inputs.leaves(g, (n,), device)
        self.index = torch.randint(0, n, (pool, k), generator=g, device=device)
        height, self.dense = int(conf["height"]), roofline.tree_height(n, conf["arity"])
        marked = int(k * float(traffic["tamper_share"]))
        self.rows = torch.stack([torch.randperm(k, generator=g, device=device)[:marked]
                                 for _ in range(pool)])
        self.lvls = torch.randint(0, height, (pool, marked), generator=g, device=device)
        self.slots = torch.randint(0, conf["arity"] - 1, (pool, marked), generator=g,
                                   device=device)
        self.checked = sorted(random.Random(seed).sample(range(pool),
                                                         int(traffic["checked_batches"])))
        self.height, self.perms_per_step = height, roofline.openings_perms(k, height)
        self.levels = merkle.merkle_levels(self.leaves)
        lift = Lift(merkle, n, height, device)
        self.root = lift.root(self.levels[-1])
        self.top_sibs = lift.top[:, None].expand(-1, conf["arity"] - 1, -1)
        self.top_poss = torch.zeros(height - self.dense, dtype=torch.int32, device=device)
        self.opened: dict[int, tuple] = {}
        self.verdicts: list[tuple[int, torch.Tensor]] = []
        self._batch(0)

    def _batch(self, b: int, keep: bool = False) -> torch.Tensor:
        idx = self.index[b]
        sibs, poss = self.merkle.merkle_open_batched(self.levels, idx)
        k = idx.shape[0]
        sibs = torch.cat([sibs, self.top_sibs.expand(k, -1, -1, -1)], 1)
        poss = torch.cat([poss, self.top_poss.expand(k, -1)], 1)
        if keep:
            self.opened[b] = (sibs.clone(), poss.clone())
        sibs[self.rows[b], self.lvls[b], self.slots[b], 0] ^= 1
        return self.merkle.merkle_verify_batched(self.root, self.leaves[idx], sibs, poss,
                                                 self.height).cpu()

    def step(self) -> int:
        b = len(self.verdicts) % self.index.shape[0]
        keep = b in self.checked and b not in self.opened
        self.verdicts.append((b, self._batch(b, keep)))
        return self.k

    def release(self) -> None:
        self.levels = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _expected(self, partial_rounds: int) -> dict:
        """What the reference (with `partial_rounds`) opens and decides for
        each checked batch: (root, {batch: (sibs, poss, verdicts)})."""
        levels = hades.tree_levels(self.leaves, partial_rounds)
        root = hades.lift_root(levels[-1][0], self.dense, self.height, partial_rounds)
        z = hades.empty_digests(self.height, root.device, partial_rounds)[self.dense:]
        out = {}
        for b in self.checked:
            idx = self.index[b]
            sibs, poss, node = [], [], idx
            for level in levels[:-1]:
                group, pos = node // 4, node % 4
                groups = level.reshape(-1, 4, 16)[group]
                slot = torch.arange(3, device=idx.device)
                others = slot + (slot >= pos[:, None])
                sibs.append(torch.gather(groups, 1, others[:, :, None].expand(-1, -1, 16)))
                poss.append(pos)
                node = group
            for digest in z:                        # the levels above: 3 empty subtrees
                sibs.append(digest.expand(idx.shape[0], 3, 16))
                poss.append(torch.zeros_like(node))
            sibs, poss = torch.stack(sibs, 1), torch.stack(poss, 1)
            # the verdicts: the same openings, tampered as the step tampers them
            forged = sibs.clone()
            bad = forged[self.rows[b], self.lvls[b], self.slots[b]]
            forged[self.rows[b], self.lvls[b], self.slots[b]] = hades.from_mont256(
                _flip(hades.to_mont256(bad)))
            ok = (hades.walk(self.leaves[idx], forged, poss, partial_rounds) == root).all(-1)
            out[b] = (hades.to_mont256(sibs), poss, ok.cpu())
        return root, out

    def control(self) -> tuple:
        return self._expected(self.partial_rounds - 1)

    def check(self, outputs: tuple | None = None) -> tuple[dict, int]:
        """(the numbers compared with their limits, the steps found wrong);
        outputs: `_expected`'s result to judge in the program's place."""
        root, want = self._expected(self.partial_rounds)
        got_root = self.root.cpu() if outputs is None else outputs[0].cpu()
        opened = self.opened if outputs is None else \
            {b: (s, p.to(torch.int32)) for b, (s, p, _) in outputs[1].items()}
        openings_wrong = sum(
            int((~((opened[b][0] == want[b][0]).flatten(1).all(1)
                   & (opened[b][1].long() == want[b][1]).all(1))).sum())
            for b in self.checked)
        verdicts_wrong, bad_steps = 0, 0
        for b, got in self.verdicts:
            if b in want:
                got = got if outputs is None else outputs[1][b][2]
                n = int((got != want[b][2]).sum())
                verdicts_wrong += n
                bad_steps += n > 0
        root_wrong = int(not torch.equal(got_root, root.cpu()))
        return {"root_wrong": {"value": root_wrong, "limit": 0},
                "openings_wrong": {"value": openings_wrong, "limit": 0},
                "verdicts_wrong": {"value": verdicts_wrong, "limit": 0}}, \
            bad_steps + (openings_wrong > 0) + root_wrong


def _flip(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 0] ^= 1
    return x
