"""The frozen roofline count of hbench/roofline.py."""

from __future__ import annotations

import pytest

from hbench import roofline

SCHEDULES = ("naive", "opt", "mxu8", "hyb", "hybp", "mxu", "hyb13", "hybp13")


@pytest.mark.parametrize("leaves, height, perms", [
    (1 << 20, None, 349_525),                  # a dense 2^20-leaf tree
    (1 << 22, 17, (4**11 - 1) // 3 + 6),       # the build cell's: 1,398,107
    (13, None, 5),
    (13, 4, 7),
])
def test_tree_counts(leaves, height, perms):
    assert roofline.tree_perms(leaves, height) == perms


@pytest.mark.parametrize("k, height, perms", [
    (1 << 14, 10, 163_840),                    # 2^14 openings of a dense 2^20-leaf tree
    (1 << 14, 17, 278_528),                    # the openings cell's
])
def test_openings_counts(k, height, perms):
    assert roofline.openings_perms(k, height) == perms
    assert roofline.tree_height(13) == 2 and roofline.tree_height(1 << 22) == 11


def test_least_time_is_the_operations():
    assert roofline.SBOXES == 99 and roofline.CONST_PRODUCTS == 747
    assert roofline.least_perm_s() == roofline.OPS_PER_PERM / roofline.INT8_OPS_PER_S
    assert roofline.least_perm_s() > roofline.BYTES_PER_PERM / roofline.HBM_BYTES_PER_S


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("b", [1 << 10, 1 << 14, 1 << 18])
def test_no_schedule_can_read_above_100(schedule, b):
    """The least time a permutation is at most every schedule's own bound a
    state, so a share of this roofline stays at or below 100%."""
    from hades252_tpu_torch.ops import perm_cuda
    from hades252_tpu_torch.utils import roofline as own

    assert schedule in perm_cuda.SCHEDULES
    assert roofline.least_perm_s() * 1e3 <= own.bound(schedule, b)["bound_ms"] / b
