"""Data parallelism over `torch.distributed`: the sharded permutation,
sponge, cipher, verification chains, prover phases and Merkle build
(`dist`), and the process group's set-up (`multihost`)."""
