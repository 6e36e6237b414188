"""The port's entry points (`hades252_tpu_torch/entry.py`) on the CPU:
`entry` against the JAX package's `__graft_entry__.entry`, and the dry run
on gloo ranks spawned by `parallel/multihost.spawn`."""

import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hades252_tpu_torch import entry
from hades252_tpu_torch.parallel import multihost

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__  # noqa: E402

torch.set_num_threads(1)


def test_entry_on_the_cpu_equals_the_jax_entry():
    fn, (x,) = entry.entry(device="cpu")
    jfn, (jx,) = __graft_entry__.entry()
    assert x.shape == (256, 5, 16) and x.dtype == torch.int32
    assert np.array_equal(x.numpy().astype(np.uint32), jx)
    assert np.array_equal(fn(x).numpy().astype(np.uint32), np.asarray(jfn(jx)))


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


@pytest.mark.parametrize("world", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_dryrun_multichip_on_gloo_ranks(world):
    ranks = entry.dryrun_multichip(world, backend="gloo", device="cpu")
    # the plain versions launch no kernel
    assert len(ranks) == world and all(not any(r.values()) for r in ranks)


@pytest.mark.parametrize("n", [1, 2])
def test_nccl_without_enough_cards_raises_with_the_counts(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"need {n} CUDA devices for NCCL, have 0"):
        entry.dryrun_multichip(n)


def test_spawn_raises_with_a_failed_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 0 of 1 failed:(.|\n)*Traceback"):
        multihost.spawn(entry._dryrun_rank, 1, "no-such-backend", "cpu", wall_s=120)


def _exit_at_once(rank, world, coordinator):
    os._exit(3)


def test_spawn_raises_at_once_for_ranks_that_die_without_reporting():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[[01, ]+\] of 2 exited with \[3"):
        multihost.spawn(_exit_at_once, 2, wall_s=600)
    assert time.monotonic() - t0 < 120
