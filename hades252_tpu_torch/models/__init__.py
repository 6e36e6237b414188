"""Models over the permutation: the arity-4 Merkle tree and the sponge."""
