"""The launch plan of the frame-owning multi-step kernels (kernels 2 and 3,
``csrc/bp_resident.cuh``), a pure function tested on the CPU, and the
level-local deferred-row tables the layered kernel reads.

``resident_plan`` picks threads, where the frame's totals live and the
blocks an SM; the kernel checks the plan against its own layout and limits
at launch (the ``cuda`` test of ``test_torch_cuda.py`` shows the refusal).
Plain PyTorch and numpy only; no JAX.
"""

import itertools

import pytest
import torch

from qamreconciliation_tpu_torch.models.qc_decoder import (
    make_qc_ira, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import kernels
from qamreconciliation_tpu_torch.ops.kernels import (
    QCTables, resident_plan, resident_smem,
)

torch.set_num_threads(1)


def rows_of(base):
    rows = [[] for _ in range(max(c for c, _, _ in base) + 1)]
    for c, v, s in base:
        rows[c].append((v, s))
    return rows


# (nb_v, nb_c, E, z, deferred slots of a level at most) of the headline
# code, the z = 360 QC-IRA code and the knee code (QCTables of each)
SHAPES = {
    "headline": (180, 90, 540, 360, 6),
    "ira z=360": (180, 60, 539, 360, 16),
    "knee z=1800": (36, 18, 108, 1800, 12),
}
RULES = ("sumproduct", "tanhfb", "minsum")


@pytest.mark.parametrize("layered", [False, True], ids=["rounds", "sweeps"])
@pytest.mark.parametrize("dc_max", [6, 32])
@pytest.mark.parametrize("t_size", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("code", list(SHAPES))
def test_plan_fields_hold_the_kernel_limits(code, t_size, dc_max, layered):
    nb_v, nb_c, E, z, defer = SHAPES[code]
    for B, rule in itertools.product((1, 40, 128, 256), RULES):
        plan = resident_plan(B, nb_v, nb_c, E, z, dc_max, t_size, rule,
                             layered=layered,
                             defer_slots=defer if layered else 0)
        assert (plan.frames, plan.cluster, plan.layout) == (1, 1, "a")
        assert plan.threads % 32 == 0
        assert 32 <= plan.threads <= kernels.RES_THREADS_MAX
        assert plan.totals in ("shared", "global")
        tsz = 4 if layered else t_size       # layered totals are f32
        assert plan.smem == resident_smem(
            plan.threads, nb_v, z, dc_max, tsz, rule, layered=layered,
            defer_slots=defer if layered else 0,
            totals_shared=plan.totals == "shared")
        assert plan.smem <= kernels.SMEM_BLOCK_MAX
        # the largest block whose scratch fits, up to 1024 threads
        if plan.threads < kernels.RES_THREADS_MAX:
            assert resident_smem(
                plan.threads + 32, nb_v, z, dc_max, tsz, rule,
                layered=layered, defer_slots=defer if layered else 0,
                totals_shared=plan.totals == "shared") \
                > kernels.SMEM_BLOCK_MAX
        bps = plan.blocks_per_sm
        assert bps >= 1
        assert bps * plan.threads <= kernels.THREADS_SM
        assert bps * plan.threads * kernels.RES_REGS <= kernels.REGS_SM
        assert bps * (plan.smem + 1024) <= kernels.SMEM_SM
        assert plan.grid == min(B, bps * 132)
        # f32 totals of 64800 values (259 KB) never fit shared memory
        if tsz * nb_v * z > kernels.SMEM_BLOCK_MAX:
            assert plan.totals == "global"


def test_main_path_plans():
    """The headline engine (bf16 tanh-F/B flooding) keeps its totals in
    shared memory at 1024 threads; the layered main path (f32 totals, bf16
    min-sum) keeps them in device memory at 1024 threads."""
    nb_v, nb_c, E, z, defer = SHAPES["headline"]
    rounds = resident_plan(128, nb_v, nb_c, E, z, 6, 2, "tanhfb",
                           layered=False)
    assert (rounds.totals, rounds.threads, rounds.grid) == ("shared", 1024,
                                                            128)
    assert rounds.smem == 129600 + 3 * 6 * 1024 * 4 + 16
    sweeps = resident_plan(128, nb_v, nb_c, E, z, 6, 4, "minsum",
                           layered=True, defer_slots=defer)
    assert (sweeps.totals, sweeps.threads) == ("global", 1024)
    assert sweeps.smem == 3 * 6 * 1024 * 4 + defer * z * 4 + 16
    # a small code's f32 totals fit with the scratch: shared
    small = resident_plan(40, 12, 6, 36, 40, 6, 4, "minsum",
                          layered=True, defer_slots=6)
    assert small.totals == "shared" and small.threads == 1024
    # bf16 totals that would leave fewer than 512 threads stay in device
    # memory: 130 KB of totals beside 32-wide tanh-F/B rows
    wide = resident_plan(128, 180, 90, 540, 360, 32, 2, "tanhfb",
                         layered=False)
    assert wide.totals == "global" and wide.threads == 576


@pytest.mark.parametrize("bad", [
    dict(dc_max=33), dict(dc_max=0), dict(B=0), dict(z=0),
    dict(rule="bogus"), dict(defer_slots=20000, layered=True),
], ids=["dc 33", "dc 0", "B 0", "z 0", "rule", "deltas too large"])
def test_plan_refuses_what_no_block_holds(bad):
    args = dict(B=40, nb_v=12, nb_c=6, E=36, z=40, dc_max=6, t_size=4,
                rule="minsum", layered=False, defer_slots=0)
    args.update(bad)
    with pytest.raises(ValueError):
        resident_plan(**args)


@pytest.mark.parametrize("code", ["regular", "ira", "knee"])
def test_deferred_tables_are_level_local(code):
    """defer_base and app_e index the deferred slots of the row's own level
    (the kernel keeps one level's deltas in shared memory); every slot of a
    deferred row is listed once, under its own variable block."""
    base, z = {
        "regular": (make_qc_ldpc(12, 40, 3, 6, seed=4)[0], 40),
        "ira": (make_qc_ira(8, 4, 40, dv=3, seed=2)[0], 40),
        "knee": (make_qc_ldpc(36, 1800, 3, 6, seed=12345)[0], 1800),
    }[code]
    t = QCTables(rows_of(base), z)
    assert t.n_defer_slots > 0
    per_level = []
    for lev, level in enumerate(t.levels):
        deferred = [cb for cb in level if t.defer_base[cb] >= 0]
        slots = sorted((int(t.defer_base[cb]) + d, cb, d) for cb in deferred
                       for d in range(len(t.rows[cb])))
        assert [s for s, _, _ in slots] == list(range(len(slots)))
        per_level.append(len(slots))
        listed = []
        for i in range(t.app_level_off[lev], t.app_level_off[lev + 1]):
            for a in range(t.app_off[i], t.app_off[i + 1]):
                _, cb, d = slots[t.app_e[a]]
                assert t.rows[cb][d] == (t.app_vb[i], t.app_s[a])
                listed.append(int(t.app_e[a]))
        assert sorted(listed) == list(range(len(slots)))
    assert sum(per_level) == t.n_defer_slots
    assert max(per_level) == t.defer_level_slots
    assert len(t.level_off) == len(t.levels) + 1
