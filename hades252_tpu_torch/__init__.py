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
graph replay; the sharded paths (`parallel/`), the entry points
(`entry.py`) and the examples (`examples/`).

The root exports what the JAX package's does (the reference crate's
surface): WIDTH, TOTAL_FULL_ROUNDS, PARTIAL_ROUNDS, ROUNDS, PARAMS, the
strategies, the gadget and `permute`, and the lazy ROUND_CONSTANTS and
MDS_MATRIX. Importing it touches no device and builds nothing.
"""

from .params import (  # noqa: F401
    N_DIGITS,
    P,
    PARAMS,
    PARTIAL_ROUNDS,
    ROUNDS,
    TOTAL_FULL_ROUNDS,
    WIDTH,
    HadesParams,
)
from .gadget import Composer, Constraint, GadgetStrategy, Witness  # noqa: F401
from .strategy import ScalarStrategy, Strategy  # noqa: F401
from .ops import permute, permute_mont  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    """The reference's exported arrays as canonical Python ints, decoded at
    first use (`hades252_tpu/__init__.py:48-63`): ROUND_CONSTANTS (960) and
    MDS_MATRIX (5 x 5)."""
    if name == "ROUND_CONSTANTS":
        from .params import round_constants_int

        return round_constants_int()
    if name == "MDS_MATRIX":
        from .params import mds_matrix_int

        return mds_matrix_int()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
