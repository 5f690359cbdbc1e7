"""The launch plan of kernel 9 (``resident_bookkeeping_probe``,
``csrc/resident_bookkeeping_probe.cu``), a pure function tested on the CPU.

``staged_rows_plan`` picks the path (the c2v rows through a TMA ring in
shared memory, "bulk", or kernel 2's direct loads, "thread"), the threads
(consumer warps and one producer warp), lanes a consumer thread, stages,
where the frame's totals live, the shared memory, the blocks an SM and the
grid; the kernel checks the plan against its own layout and limits at
launch (the ``cuda`` test of ``test_torch_cuda.py`` shows the refusal).
Plain PyTorch and numpy only; no JAX.
"""

import pytest
import torch

from qamreconciliation_tpu_torch.ops import kernels
from qamreconciliation_tpu_torch.ops.kernels import (
    H100_SMS, SMEM_BLOCK_MAX, SMEM_SM, resident_plan, staged_rows_plan,
    staged_rows_smem,
)
from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

torch.set_num_threads(1)

# (n of the probe's QC(3,6) code, so z = n / 36; B): the probe's shape,
# the z = 64 code with B = 40 of chip_smoke.py's phase 21, two z that are
# not a multiple of 8, a z too wide for three stages beside the totals and
# one whose totals leave shared memory
CASES = {
    "probe z=1800 B=128": (36 * 1800, 128),
    "smoke z=64 B=40": (36 * 64, 40),
    "z=60 not a multiple of 8": (36 * 60, 40),
    "z=1804 not a multiple of 8": (36 * 1804, 128),
    "z=2400 too wide for three stages": (36 * 2400, 128),
    "z=3200 totals in device memory": (36 * 3200, 3),
}
EXPECT = {  # path, totals, stages
    "probe z=1800 B=128": ("bulk", "shared", 4),
    "smoke z=64 B=40": ("bulk", "shared", 4),
    "z=60 not a multiple of 8": ("thread", "shared", 0),
    "z=1804 not a multiple of 8": ("thread", "shared", 0),
    "z=2400 too wide for three stages": ("bulk", "shared", 2),
    "z=3200 totals in device memory": ("bulk", "global", 4),
}


def plan_of(n, B, **kw):
    tables = P.code_tables(n)
    dv_max = kernels._var_degree_max(tables)
    return tables, dv_max, staged_rows_plan(
        B, tables.nb_v, tables.nb_c, tables.E, tables.z, tables.dc_max,
        dv_max, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_holds_the_kernel_limits(case):
    n, B = CASES[case]
    tables, dv_max, plan = plan_of(n, B)
    z = tables.z
    assert (plan.path, plan.totals, plan.stages) == EXPECT[case]
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_SM
    assert plan.blocks_per_sm * plan.threads <= kernels.THREADS_SM
    assert (plan.blocks_per_sm * plan.threads * kernels.RES_REGS
            <= kernels.REGS_SM)
    assert plan.grid == min(B, plan.blocks_per_sm * H100_SMS)
    if plan.path == "thread":
        r = resident_plan(B, tables.nb_v, tables.nb_c, tables.E, z,
                          tables.dc_max, 2, "minsum", layered=False)
        assert (plan.threads, plan.smem, plan.totals, plan.blocks_per_sm,
                plan.grid) == (r.threads, r.smem, r.totals, r.blocks_per_sm,
                               r.grid)
        assert (plan.lanes, plan.rows) == (1, 0)
        return
    # the bulk path: 16-byte rows, a ring of at least two stages, one
    # producer warp beside the consumer warps, at least two lanes each
    assert z % 8 == 0 and (z * 2) % 16 == 0
    assert plan.stages >= 2
    assert plan.rows == max(tables.dc_max, dv_max + 1)
    consumers = plan.threads - kernels.ROW_PRODUCER
    assert consumers >= 32 and consumers % 32 == 0 and plan.threads <= 1024
    assert plan.lanes == -(-z // consumers) >= 2
    assert plan.smem == staged_rows_smem(
        tables.nb_v, tables.nb_c, tables.E, z, plan.rows, plan.stages,
        totals_shared=plan.totals == "shared")
    # the deepest ring that fits: one more stage would not
    if plan.stages < kernels.ROW_STAGES_MAX:
        assert staged_rows_smem(tables.nb_v, tables.nb_c, tables.E, z,
                                plan.rows, plan.stages + 1,
                                totals_shared=plan.totals == "shared") \
            > SMEM_BLOCK_MAX


def test_probe_shape_holds_totals_and_three_check_blocks():
    """At [36, 1800, 128]: the frame's totals (129.6 KB) and three stages
    of a check block's six rows (3 x 21.6 KB) with the counts and the
    code's tables (E = 108 edges) fit in the 232,448 bytes a block may use;
    the plan takes a fourth stage too."""
    tables, dv_max, plan = plan_of(36 * 1800, 128)
    tabs = 864 + 2 * 432 + 80 + 160
    assert staged_rows_smem(36, 18, 108, 1800, 6, 3, totals_shared=True) \
        == 129600 + 3 * 21600 + 3 * 16 + 16 + tabs <= SMEM_BLOCK_MAX
    assert (plan.threads, plan.lanes, plan.rows, plan.smem,
            plan.blocks_per_sm, plan.grid) \
        == (960, 2, 6, 216080 + tabs, 1, 128)


@pytest.mark.parametrize("z, path, totals", [
    (9600, "bulk", "global"),     # two stages of 6 x 9600 bf16 still fit
    (9608, "thread", "global"),   # they do not: kernel 2's direct loads
])
def test_plan_leaves_the_ring_where_two_stages_do_not_fit(z, path, totals):
    plan = staged_rows_plan(8, 36, 18, 108, z, 6, 3)
    assert (plan.path, plan.totals) == (path, totals)
    assert plan.stages == (2 if path == "bulk" else 0)


def test_plan_takes_the_thread_path_for_wide_columns():
    """A variable block of more than 32 edges (a warp's lanes hold a
    block's shifts) takes kernel 2's direct loads."""
    assert staged_rows_plan(8, 36, 18, 108, 64, 6, 32).path == "bulk"
    assert staged_rows_plan(8, 36, 18, 108, 64, 6, 33).path == "thread"


def test_plan_is_pure_and_counts_the_card():
    """No device: the same arguments give the same plan, and the grid
    follows the card's SMs."""
    _, _, a = plan_of(36 * 64, 40)
    _, _, b = plan_of(36 * 64, 40)
    assert a is b
    _, _, small = plan_of(36 * 64, 40, sms=2)
    assert small.grid == min(40, 2 * small.blocks_per_sm)
    with pytest.raises(ValueError):
        staged_rows_plan(8, 36, 18, 108, 64, 33, 3)
    with pytest.raises(ValueError):
        staged_rows_plan(0, 36, 18, 108, 64, 6, 3)
