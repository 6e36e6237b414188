"""The port's checkpointed, resumable Merkle build against the JAX package's
(`utils/checkpoint.py`): equal roots, byte-identical `meta.json` and level
files, a directory written by either package resumed by the other, resume
after deleted and truncated levels with the permutation calls counted, and
the refusal of a directory built from other leaves. All exact, on the CPU;
the JAX side runs its emulated kernel
(`make_perm_mont_fn("pallas", block=128, emulate=True)`), the port the plain
versions of the three kernels this path was ported for."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu.models import merkle as jmerkle
from hades252_tpu.ops import make_perm_mont_fn as jax_make_perm_mont_fn
from hades252_tpu.utils import checkpoint as jcheckpoint
from hades252_tpu_torch import field
from hades252_tpu_torch.models import merkle
from hades252_tpu_torch.ops import make_perm_mont_fn, perm_cuda
from hades252_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def _leaves(n: int, seed: int) -> np.ndarray:
    """(n, 16) uint32 canonical leaves from a seed."""
    return field.np_random_elements((n,), np.random.default_rng(seed))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _jax_perm():
    return jax_make_perm_mont_fn("pallas", block=128, emulate=True)


class Counted:
    """A permutation function that counts its calls (one a tree level)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


def _files(d) -> dict[str, bytes]:
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("save_leaves", [False, True])
@pytest.mark.parametrize("n,schedule", [(16, "mxu"), (64, "hyb13"), (100, "hybp13")])
def test_checkpointed_build_matches_jax_byte_for_byte(tmp_path, n, schedule, save_leaves):
    leaves = _leaves(n, 900 + n)
    ours_dir, theirs_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    fn = Counted(make_perm_mont_fn("cuda", schedule=schedule))
    perm_cuda.reset_launches()
    root = checkpoint.merkle_root_checkpointed(_t(leaves), ours_dir, fn, save_leaves=save_leaves)
    theirs = jcheckpoint.merkle_root_checkpointed(jnp.asarray(leaves), theirs_dir, _jax_perm(),
                                                  save_leaves=save_leaves)
    height = merkle.tree_levels(n)
    assert root.dtype == torch.int32 and root.shape == (16,)
    assert np.array_equal(root.numpy(), np.asarray(theirs))
    assert torch.equal(root, merkle.merkle_root(_t(leaves)))
    assert fn.calls == height
    assert perm_cuda.launches == {s: 0 for s in perm_cuda.SCHEDULES}  # the CPU: plain versions
    ours_files, theirs_files = _files(ours_dir), _files(theirs_dir)
    want = ["meta.json"] + [f"level_{k}.bin" for k in range(0 if save_leaves else 1, height + 1)]
    assert sorted(ours_files) == sorted(theirs_files) == sorted(want)
    for name in want:
        assert ours_files[name] == theirs_files[name], name
    padded = 4 ** height
    assert json.loads(ours_files["meta.json"]) == {
        "n_leaves_padded": padded, "height": height, "arity": 4,
        "leaves_sha256": json.loads(theirs_files["meta.json"])["leaves_sha256"]}
    assert len(ours_files[f"level_{height}.bin"]) == 32
    assert np.array_equal(checkpoint.load_level(ours_dir, height, 1)[0], root.numpy())
    assert checkpoint.highest_saved_level(ours_dir, height, padded) == height


def _damage(d, height: int, keep: int, truncate: int) -> None:
    """Delete the level files above `keep` and cut level `truncate` short."""
    for k in range(keep + 1, height + 1):
        os.remove(os.path.join(d, f"level_{k}.bin"))
    with open(os.path.join(d, f"level_{truncate}.bin"), "r+b") as f:
        f.truncate(31)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_resumes_the_others_directory(tmp_path, writer):
    """256 leaves, height 4: the writer builds, levels 3 and 4 are deleted
    and level 2 is truncated, and the other package resumes from level 1
    with three permutation calls and rewrites the same bytes."""
    leaves, d = _leaves(256, 77), str(tmp_path / "shared")
    jfn, fn = Counted(_jax_perm()), Counted(make_perm_mont_fn("cuda", schedule="hyb13"))
    if writer == "jax":
        root = np.asarray(jcheckpoint.merkle_root_checkpointed(jnp.asarray(leaves), d, jfn))
    else:
        root = checkpoint.merkle_root_checkpointed(_t(leaves), d, fn).numpy()
    whole = _files(d)
    _damage(d, 4, keep=2, truncate=2)
    assert checkpoint.highest_saved_level(d, 4, 256) == 1
    assert jcheckpoint.highest_saved_level(d, 4, 256) == 1
    jfn.calls = fn.calls = 0
    if writer == "jax":
        again = checkpoint.merkle_root_checkpointed(_t(leaves), d, fn).numpy()
        assert (fn.calls, jfn.calls) == (3, 0)
    else:
        again = np.asarray(jcheckpoint.merkle_root_checkpointed(jnp.asarray(leaves), d, jfn))
        assert (fn.calls, jfn.calls) == (0, 3)
    assert np.array_equal(again, root)
    assert _files(d) == whole
    # a complete directory: nothing is recomputed by either package
    jfn.calls = fn.calls = 0
    assert np.array_equal(checkpoint.merkle_root_checkpointed(_t(leaves), d, fn).numpy(), root)
    assert np.array_equal(
        np.asarray(jcheckpoint.merkle_root_checkpointed(jnp.asarray(leaves), d, jfn)), root)
    assert (fn.calls, jfn.calls) == (0, 0)


@pytest.mark.parametrize("schedule", ["mxu", "hyb13", "hybp13"])
def test_resume_after_deleted_and_truncated_levels(tmp_path, schedule):
    leaves, d = _t(_leaves(100, 5)), str(tmp_path / "c")
    fn = Counted(make_perm_mont_fn("cuda", schedule=schedule))
    root = checkpoint.merkle_root_checkpointed(leaves, d, fn)
    assert fn.calls == 4  # 100 leaves pad to 256
    whole = _files(d)
    # the second damage finds level 1 still cut short by the first and starts
    # from the leaves, which makes every level whole again
    for keep, truncate, calls in ((3, 1, 1), (2, 2, 4), (2, 2, 3), (1, 1, 4)):
        _damage(d, 4, keep, truncate)
        fn.calls = 0
        assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, d, fn), root)
        assert fn.calls == calls
        after = _files(d)
        # every level from the resume point up is whole again
        assert all(after[f"level_{k}.bin"] == whole[f"level_{k}.bin"]
                   for k in range(5 - calls, 5))
    assert torch.equal(root, merkle.merkle_root(leaves))


def test_save_leaves_resumes_from_level_0(tmp_path):
    leaves = _t(_leaves(16, 6))
    with_leaves, without = str(tmp_path / "a"), str(tmp_path / "b")
    fn = Counted(make_perm_mont_fn("ref"))
    root = checkpoint.merkle_root_checkpointed(leaves, with_leaves, fn, save_leaves=True)
    checkpoint.merkle_root_checkpointed(leaves, without, fn)
    assert os.path.exists(os.path.join(with_leaves, "level_0.bin"))
    assert not os.path.exists(os.path.join(without, "level_0.bin"))
    assert np.array_equal(checkpoint.load_level(with_leaves, 0, 16), leaves.numpy())
    for d in (with_leaves, without):
        os.remove(os.path.join(d, "level_1.bin"))
        os.remove(os.path.join(d, "level_2.bin"))
    fn.calls = 0
    assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, with_leaves, fn,
                                                           save_leaves=True), root)
    assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, without, fn), root)
    assert fn.calls == 4
    # level 0 on disk is ignored when the caller does not vouch for it
    assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, with_leaves, fn), root)


def test_other_leaves_are_refused(tmp_path):
    d = str(tmp_path / "c")
    leaves = _leaves(64, 7)
    checkpoint.merkle_root_checkpointed(_t(leaves), d)
    before = _files(d)
    other = leaves.copy()
    other[5, 0] ^= 1
    with pytest.raises(ValueError, match="different build"):
        checkpoint.merkle_root_checkpointed(_t(other), d)
    with pytest.raises(ValueError, match="different build"):
        checkpoint.merkle_root_checkpointed(_t(_leaves(256, 7)), d)
    with pytest.raises(ValueError, match="different build"):
        jcheckpoint.merkle_root_checkpointed(jnp.asarray(other), d, _jax_perm())
    assert _files(d) == before


def test_bad_input_and_bad_files_raise(tmp_path):
    d = str(tmp_path / "c")
    with pytest.raises(ValueError, match="expected"):
        checkpoint.merkle_root_checkpointed(torch.zeros((4, 8), dtype=torch.int32), d)
    leaves = _t(_leaves(16, 8))
    checkpoint.merkle_root_checkpointed(leaves, d)
    with pytest.raises(ValueError, match="expected 64 bytes"):
        checkpoint.load_level(d, 1, 2)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_level(d, 0, 16)
    # a level file of the right size that holds a value >= p does not load
    with open(os.path.join(d, "level_2.bin"), "wb") as f:
        f.write(b"\xff" * 32)
    with pytest.raises(ValueError, match="non-canonical"):
        checkpoint.merkle_root_checkpointed(leaves, d)
    assert checkpoint.highest_saved_level(str(tmp_path / "none"), 2, 16) is None


def test_single_leaf_and_default_perm(tmp_path):
    one = _t(_leaves(1, 9))
    assert torch.equal(checkpoint.merkle_root_checkpointed(one, str(tmp_path / "one")), one[0])
    assert sorted(os.listdir(tmp_path / "one")) == ["meta.json"]
    leaves = _leaves(16, 10)
    root = checkpoint.merkle_root_checkpointed(_t(leaves), str(tmp_path / "d"))  # the CPU oracle
    assert np.array_equal(root.numpy(), np.asarray(jmerkle.merkle_root(jnp.asarray(leaves),
                                                                        _jax_perm())))


def test_truncated_temporary_meta_does_not_stop_a_resume(tmp_path):
    """meta.json is written through a temporary file and a rename, bytes as
    the JAX package writes them. A kill mid-write leaves a cut-short
    `meta.json.tmp`: beside a good meta.json it must not stop a resume, and
    alone (the first build died before the rename) not a fresh build either."""
    leaves, d = _t(_leaves(64, 11)), str(tmp_path / "c")
    jd = str(tmp_path / "j")
    fn = Counted(make_perm_mont_fn("ref"))
    root = checkpoint.merkle_root_checkpointed(leaves, d, fn)
    jcheckpoint.merkle_root_checkpointed(jnp.asarray(_leaves(64, 11)), jd, _jax_perm())
    meta = open(os.path.join(d, "meta.json"), "rb").read()
    assert meta == open(os.path.join(jd, "meta.json"), "rb").read()
    assert not os.path.exists(os.path.join(d, "meta.json.tmp"))
    with open(os.path.join(d, "meta.json.tmp"), "wb") as f:
        f.write(meta[:7])
    os.remove(os.path.join(d, "level_3.bin"))
    fn.calls = 0
    assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, d, fn), root)
    assert fn.calls == 1 and open(os.path.join(d, "meta.json"), "rb").read() == meta
    alone = str(tmp_path / "alone")
    os.makedirs(alone)
    with open(os.path.join(alone, "meta.json.tmp"), "wb") as f:
        f.write(meta[:7])
    assert torch.equal(checkpoint.merkle_root_checkpointed(leaves, alone, fn), root)
    assert json.load(open(os.path.join(alone, "meta.json"))) == json.loads(meta)
