"""The harness's own tests. They import neither JAX nor the JAX package, so
they also run where the repository's `tests/conftest.py` cannot."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# The whole-run tests drive the package's plain kernels on the CPU; under
# several pytest workers, every worker's full thread pool would oversubscribe
# the cores many times over.
torch.set_num_threads(2)
