"""The least time the card could take for the permutations a cell needs.

Frozen here, apart from the package: the count is the work the cell's shapes
need, whatever schedule or kernel does it, so a kernel's share of this
roofline reads the same work before and after a change that moves work
between kernels.

One permutation of BLS12-381 scalars (width 5, 8 full and 59 partial
rounds), canonical in and out:

- bytes: its 5 words read and its 5 written, 32 B each, 320 B;
- operations: the 297 products of its 99 S-boxes (x^2, x^4, x^4 x), and the
  products by constants of its linear layers in the fewest that any schedule
  of the package uses (`opt`'s: 25 in each of the 8 full rounds, 9 in each of
  the 59 sparse partial rounds, and the 16 of the final 4 x 4 matrix, 747 in
  all). A 255-bit product counts its byte multiply-adds, 32 x 32 (528 for a
  square: each pair of bytes once), and its reduction: a byte-wise Montgomery
  reduction multiplies each of its 32 quotient bytes by the 28 bytes of p
  that are not 0 or 1, 896. A multiply-add is 2 operations.

The least time is the larger of the bytes over the card's memory rate and
the operations over its fastest published rate, int8 on the tensor cores
(NVIDIA H100 SXM data sheet, dense, at 700 W). It is below every schedule's
own bound per state in `hades252_tpu_torch.utils.roofline.bound`, so no
schedule can read a share above 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

WIDTH, FULL_ROUNDS, PARTIAL_ROUNDS = 5, 8, 59
BYTES_PER_PERM = 2 * WIDTH * 32
SBOXES = WIDTH * FULL_ROUNDS + PARTIAL_ROUNDS                    # 99
CONST_PRODUCTS = 25 * FULL_ROUNDS + 9 * PARTIAL_ROUNDS + 16      # 747
PRODUCT_MACS, SQUARE_MACS, REDUCTION_MACS = 32 * 32, 32 * 33 // 2, 32 * 28
MACS_PER_PERM = (2 * SBOXES * (SQUARE_MACS + REDUCTION_MACS)
                 + (SBOXES + CONST_PRODUCTS) * (PRODUCT_MACS + REDUCTION_MACS))
OPS_PER_PERM = 2 * MACS_PER_PERM


def least_perm_s() -> float:
    """The least seconds of one permutation on the card."""
    return max(BYTES_PER_PERM / HBM_BYTES_PER_S, OPS_PER_PERM / INT8_OPS_PER_S)


def tree_height(n_leaves: int, arity: int = 4) -> int:
    """The height of the dense subtree over n leaves, zero-padded to a power
    of the arity."""
    h, full = 0, 1
    while full < n_leaves:
        h, full = h + 1, full * arity
    return h


def tree_perms(n_leaves: int, height: int | None = None, arity: int = 4) -> int:
    """Permutations of one tree of `height` over n leaves (the dense subtree's
    height where None): one for each inner node of the dense subtree over
    the leaves, zero-padded to a power of the arity, and one a level above
    it, whose other children are empty subtrees."""
    dense = tree_height(n_leaves, arity)
    return (arity ** dense - 1) // (arity - 1) + (height or dense) - dense


def openings_perms(k: int, height: int) -> int:
    """Permutations of verifying k openings of a tree of `height`: one a
    level each."""
    return k * height
