"""hades252_tpu_torch: the Hades252 permutation in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a).

A port of `hades252_tpu` (JAX, TPU), which stays the reference. This
package imports neither JAX nor `hades252_tpu`: the GPU host has neither.
Its public functions take the JAX package's layout, (..., 5, 16) int32
tensors of 16-bit little-endian digits, so every output can be compared
with it directly.

Ported so far: the field layer, the torch oracle permutation, the `naive`
and `opt` permutation kernels (`ops/perm_cuda.py`, `ops/csrc/perm.cu`),
the Merkle tree and the sponge.
"""

from .params import N_DIGITS, P, WIDTH  # noqa: F401
from .strategy import ScalarStrategy, Strategy  # noqa: F401
from .ops import permute, permute_mont  # noqa: F401
