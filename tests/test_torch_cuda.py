"""The port's CUDA kernels on the card: each against its plain PyTorch
version and the int oracle, exactly.

Every test here needs a CUDA device and carries the `cuda` marker; without
a card they skip. The file imports neither JAX nor `hades252_tpu`, so on
the GPU host (which has neither) it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from hades252_tpu_torch import field, selftest
from hades252_tpu_torch.models import merkle, sponge
from hades252_tpu_torch.ops import make_perm_mont_fn, perm_cuda, permute
from hades252_tpu_torch.strategy import ScalarStrategy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _elements(shape, seed: int) -> torch.Tensor:
    """Seeded canonical field elements, (..., 16) int32 on the CPU."""
    x = field.np_random_elements(shape, np.random.default_rng(seed))
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 1000, 4096])
@pytest.mark.parametrize("schedule", ["naive", "opt"])
@pytest.mark.parametrize("convert", [True, False])
def test_kernel_matches_plain(cuda_device, b, schedule, convert):
    x = _elements((5, b), 20 + b).permute(0, 2, 1).contiguous().to(cuda_device)
    before = perm_cuda.launches[schedule]
    got = perm_cuda.permute_planar(x, convert=convert, schedule=schedule)
    torch.cuda.synchronize()
    assert perm_cuda.launches[schedule] == before + 1
    want = perm_cuda.permute_planar_plain(x, convert=convert, schedule=schedule)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kat_gate(cuda_device):
    selftest.assert_device_correct(cuda_device)


@pytest.mark.cuda
def test_scalar_strategy_cuda_backend(cuda_device):
    x = _elements((7, 5), 2)
    got = ScalarStrategy("cuda").perm(x)
    assert got.is_cuda and torch.equal(got.cpu(), permute(x))


@pytest.mark.cuda
def test_wrapper_rejects_bad_cuda_input(cuda_device):
    x = _elements((5, 8), 1).permute(0, 2, 1).contiguous().to(cuda_device)
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x.to(torch.int64))
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x[:, :, ::2])  # not contiguous
    assert perm_cuda.permute_planar(x[:, :, :0].contiguous()).shape == (5, 16, 0)


@pytest.mark.cuda
def test_merkle_and_sponge(cuda_device):
    leaves = _elements((256,), 500)
    msgs = _elements((8, 9), 501)
    perm_cuda.reset_launches()
    root = merkle.merkle_root(leaves.to(cuda_device))
    digest = sponge.sponge_hash(msgs.to(cuda_device))
    assert perm_cuda.launches == {"naive": 0, "opt": merkle.tree_levels(256) + 3}
    naive = merkle.merkle_root(leaves.to(cuda_device), make_perm_mont_fn("cuda", schedule="naive"))
    assert perm_cuda.launches["naive"] == merkle.tree_levels(256)
    assert torch.equal(root.cpu(), merkle.merkle_root(leaves))
    assert torch.equal(naive, root)
    assert torch.equal(digest.cpu(), sponge.sponge_hash(msgs))
