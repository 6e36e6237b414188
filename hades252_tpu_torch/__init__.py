"""hades252_tpu_torch: the Hades252 permutation in PyTorch, with hand-written
CUDA kernels for the NVIDIA H100 (sm_90a), the batched PLONK prover and the
succinct DEEP-FRI argument.

A port of `hades252_tpu` (JAX, TPU), which stays the reference. This
package imports neither JAX nor `hades252_tpu`: the GPU host has neither.
Its public functions take the JAX package's layout, (..., 5, 16) int32
tensors of 16-bit little-endian digits, so every output can be compared
with it directly.

Ported so far: the field layer, the torch oracle permutation, a CUDA
kernel for each of the eight permutation schedules (`ops/perm_cuda.py`,
`ops/csrc/`), the Merkle tree with its openings, the sponge, the duplex
cipher, the checkpointed tree build and the native engine's binding; the
host proof layers (`gadget`, `circuits`, `plonk`, `utils/asset_gen`), the
batched NTT (`ops/ntt.py`) and the batched prover (`prover_cuda.py`),
whose three phases run as torch ops on the card; the succinct and
aggregated argument with its wire format (`fri`, `aggregate`,
`serialize`), whose trees, leaf sponges, grinding and pooled multiproof
checks run on the kernels through `fri_cuda.device_pool_perm`; the
device-resident succinct and aggregate provers
(`fri_cuda.prove_succinct_device[_batch]`, `prove_aggregate_device`),
which keep every O(m0) object of the argument on the card and run the FRI
commit phase as one CUDA graph; and the device verifiers
(`verify_succinct_device_batch`, `verify_aggregate_device`,
`device_chain_fn`), whose pooled Merkle phase or sibling chain is one CUDA
graph replay.
"""

from .params import N_DIGITS, P, WIDTH  # noqa: F401
from .gadget import Composer, Constraint, GadgetStrategy, Witness  # noqa: F401
from .strategy import ScalarStrategy, Strategy  # noqa: F401
from .ops import permute, permute_mont  # noqa: F401
