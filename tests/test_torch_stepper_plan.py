"""The launch plan of ``csrc/stepper_chunk.cu``, on the CPU.

The kernel runs only on the card (and, under a host shim, in
``tests/test_torch_stepper_host.py``, which also holds the C entry's
refusal of a plan it cannot launch), so what is held here is the plan it
is launched with: one warp a lane, the warps of a block sharing one staged
copy of the batch's step table when it fits beside their stacks, else the
table in device memory; warps per block enough to reach every SM; the
shared bytes and the blocks an SM holds."""

from __future__ import annotations

import pytest

from qsm_tpu_torch.ops.dfs_kernel import H100_SMS, SMEM_BLOCK_MAX
from qsm_tpu_torch.ops.stepper_kernel import (MAX_WARPS_PER_BLOCK,
                                              stepper_blocks_per_sm,
                                              stepper_launch_plan,
                                              table_bytes, warp_stack_bytes)


def test_table_and_stack_bytes():
    # the queue headline: 1280 packed states, 13 distinct (cmd, arg, resp)
    assert table_bytes(1280, 13) == 4 * 1280 * 14 == 71_680
    assert table_bytes(5, 60) == 4 * 5 * 62
    assert warp_stack_bytes(48) == 8 * 49
    assert warp_stack_bytes(128) == 8 * 129


def test_queue_headline_plan_stages_the_table_and_fills_the_card():
    plan = stepper_launch_plan(4096, 48, 1280, 13, H100_SMS)
    assert plan.stage_tables
    assert plan.warps_per_block == MAX_WARPS_PER_BLOCK == 16
    assert plan.grid == 256
    assert plan.smem_bytes == 71_680 + 16 * 392 == 77_952
    assert stepper_blocks_per_sm(plan) == 2
    # one wave: every block resident at once, 32 warps an SM
    assert plan.grid <= stepper_blocks_per_sm(plan) * H100_SMS


@pytest.mark.parametrize("B,warps,grid", [
    (4096, 16, 256), (1024, 8, 128), (256, 2, 128), (32, 1, 32),
    (300, 3, 100), (1, 1, 1), (0, 1, 0)])
def test_warps_per_block_spread_the_lanes_over_every_sm(B, warps, grid):
    plan = stepper_launch_plan(B, 48, 1280, 13, H100_SMS)
    assert (plan.warps_per_block, plan.grid) == (warps, grid)
    assert plan.grid * plan.warps_per_block >= B
    assert plan.smem_bytes == 71_680 + warps * 392


def test_a_table_too_large_to_stage_stays_in_device_memory():
    S, V = 256, 400  # 411,648 bytes: above what a block may have
    assert table_bytes(S, V) > SMEM_BLOCK_MAX
    plan = stepper_launch_plan(4096, 32, S, V, H100_SMS)
    assert not plan.stage_tables
    assert plan.warps_per_block == 16
    assert plan.smem_bytes == 16 * warp_stack_bytes(32)
    assert stepper_blocks_per_sm(plan) == 4  # by resident warps


def test_staging_leaves_room_for_every_warps_stacks():
    # a table that leaves room for only a few warps' stacks beside it
    S, V = 1000, 54
    room = SMEM_BLOCK_MAX - table_bytes(S, V)
    assert 0 < room < 16 * warp_stack_bytes(128)
    plan = stepper_launch_plan(4096, 128, S, V, H100_SMS)
    assert plan.stage_tables
    assert plan.warps_per_block == room // warp_stack_bytes(128)
    assert plan.smem_bytes <= SMEM_BLOCK_MAX
