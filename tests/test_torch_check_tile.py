"""The launch plans of the staged-tile check phase (kernels 1 and 4,
``csrc/bp_check_tile.cuh``, and kernel 6, the check-math probe on the same
tiles) and of kernel 5's check-major tiles (``check_major_plan``): pure
functions of the call's shape, held here on the CPU.  Plain torch, no
JAX."""

import itertools

import pytest
import torch

from qamreconciliation_tpu_torch.ops.kernels import (
    CM_ILP, CM_THREADS_MAX, CM_THREADS_SM, GENERIC_BLOCK_C, MAX_DC,
    PROBE_MATHS, RULES as KERNEL_RULES, SMEM_BLOCK_MAX, SMEM_SM,
    check_major_plan, check_major_smem, check_tile_plan, tile_smem,
)

torch.set_num_threads(1)

RULES = ["sumproduct", "tanhfb", "minsum"]
SIZES = {"f32": (4, 4), "bf16": (2, 2), "f32/bf16": (4, 2)}

# (label, groups, dc, rows, B, masked): the main-path shapes of kernel 1
# (dense QC headline [90, 6, 360, 128]) and kernel 4 (DVB-S2 rate 1/2
# [7, 32400, 128], rate 3/4 [14, 16200, 128], the MAXD 32 width), and
# ragged ones
MAIN = [
    ("k1 headline", 90, 6, 360, 128, False),
    ("k4 rate 1/2", 1, 7, 32400, 128, True),
    ("k4 rate 3/4", 1, 14, 16200, 128, True),
]
RAGGED = [
    ("k1 z=70 B=40", 3, 6, 70, 40, False),
    ("k1 dc=1", 2, 1, 37, 40, False),
    ("k1 dc=32", 2, 32, 21, 64, False),
    ("k4 C=150 B=1", 1, 7, 150, 1, True),
    ("k4 C=150 B=100", 1, 7, 150, 100, True),
    ("k4 C=150 B=256", 1, 7, 150, 256, True),
    ("k4 C=70 B=1000", 1, 7, 70, 1000, True),
    ("k4 dc=1", 1, 1, 70, 40, True),
    ("k4 dc=32", 1, 32, 70, 64, True),
]
SHAPES = MAIN + RAGGED


def plan_of(shape, rule, sizes, **kw):
    _, groups, dc, rows, B, masked = shape
    return check_tile_plan(groups, dc, rows, B, *SIZES[sizes], rule,
                           masked=masked, **kw)


def all_plans(shape):
    """The plan of ``shape`` for every rule and element-size pair."""
    return [plan_of(shape, rule, sizes)
            for rule, sizes in itertools.product(RULES, SIZES)]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_tiles_cover_every_check_and_frame_once(shape):
    """The tiles of a plan partition the groups' checks by the frames: the
    kernel's cursor steps through tile indices 0 .. tiles - 1, each block
    a run of them (the ragged-shape ``cuda`` cases hold that on the card)."""
    _, groups, dc, rows, B, masked = shape
    for plan in all_plans(shape):
        assert 1 <= plan.frames <= B and 1 <= plan.checks <= 64
        assert plan.tiles == (groups * -(-rows // plan.checks)
                              * -(-B // plan.frames))
        assert 1 <= plan.grid <= min(plan.tiles, plan.blocks_per_sm * 132)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_tile_divides_64_so_violation_blocks_are_never_split(shape):
    """Tiles start at multiples of ``checks`` within a group, so a tile
    size dividing 64 never straddles a 64-check violation row."""
    for plan in all_plans(shape):
        assert GENERIC_BLOCK_C % plan.checks == 0


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_stages_fit_shared_memory(shape):
    _, groups, dc, rows, B, masked = shape
    for (rule, sizes), plan in zip(itertools.product(RULES, SIZES),
                                   all_plans(shape)):
        assert plan.smem <= SMEM_BLOCK_MAX
        assert plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_SM
        assert plan.smem == tile_smem(dc, plan.checks, plan.frames,
                                      plan.stages, *SIZES[sizes], masked,
                                      {"sumproduct": 1, "tanhfb": 3,
                                       "minsum": 0}[rule])
        if plan.path == "staged":
            assert 2 <= plan.stages <= 4
            assert (plan.frames * SIZES[sizes][0]) % 16 == 0
            assert (plan.frames * SIZES[sizes][1]) % 16 == 0
        else:
            assert plan.stages == 1


@pytest.mark.parametrize("sizes", list(SIZES))
@pytest.mark.parametrize("shape", MAIN, ids=[s[0] for s in MAIN])
def test_main_path_shapes_take_the_staged_path(shape, sizes):
    for rule in RULES:
        plan = plan_of(shape, rule, sizes)
        assert plan.path == "staged"
        assert plan.frames == 128 and plan.stages >= 2
        assert plan.blocks_per_sm in (2, 3)
        assert plan.grid == plan.blocks_per_sm * 132
        # every thread of the block holds a pair, up to four
        assert plan.checks * plan.frames in (256, 512, 1024)


@pytest.mark.parametrize("B", [1, 100])
@pytest.mark.parametrize("rule", RULES)
def test_unaligned_frames_take_the_per_thread_path(rule, B):
    plan = check_tile_plan(1, 7, 150, B, 2, 2, rule, masked=True)
    assert plan.path == "thread" and plan.stages == 1
    # f32 at B = 100 lines up in 16-byte units (400 bytes a row)
    f32 = check_tile_plan(1, 7, 150, B, 4, 4, rule, masked=True)
    assert f32.path == ("staged" if B == 100 else "thread")
    # an unaligned pointer also takes it
    assert check_tile_plan(1, 7, 150, 128, 4, 4, rule, masked=True,
                           aligned=False).path == "thread"


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dc", [1, MAX_DC])
def test_degree_one_and_widest_rows_are_planned(dc, masked):
    for rule, B, sizes in itertools.product(RULES, (1, 100, 128, 256),
                                            SIZES):
        plan = check_tile_plan(1 if masked else 4, dc, 150, B,
                               *SIZES[sizes], rule, masked=masked)
        assert plan.tiles >= 1 and plan.smem <= SMEM_BLOCK_MAX


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="rule"):
        check_tile_plan(1, 7, 150, 128, 4, 4, "box", masked=True)
    with pytest.raises(ValueError):
        check_tile_plan(1, MAX_DC + 1, 150, 128, 4, 4, "minsum", masked=True)
    with pytest.raises(ValueError):
        check_tile_plan(1, 7, 0, 128, 4, 4, "minsum", masked=True)


def test_tile_smem_matches_the_layout_by_hand():
    # kernel 4, f32 phi, 4 checks x 128 frames, 3 stages: per stage t, c2v
    # 7*512*4 bytes each, synd 512*4, mask 7*4*4 (rounded to 16); the phi
    # scratch 7*512*4; violation counts 128*4; one mbarrier a stage
    stage = 2 * 14336 + 2048 + 112
    assert tile_smem(7, 4, 128, 3, 4, 4, True, 1) == \
        3 * stage + 14336 + 512 + 48


# ---------------------------------------------------------------- kernel 5

# (label, C, dc, B): the main-path shapes of kernel 5 (the DVB-S2 rate-1/2
# and rate-3/4 H, a dc = 32 case) and ragged ones
CM_MAIN = [("rate 1/2", 32400, 7, 128), ("rate 3/4", 16200, 14, 128),
           ("dc 32", 8100, 32, 128)]
CM_SHAPES = CM_MAIN + [
    ("C=150 B=40", 150, 6, 40), ("C=150 B=6", 150, 7, 6),
    ("C=70 B=100", 70, 7, 100), ("C=70 B=512", 70, 7, 512),
    ("C=70 B=1000", 70, 32, 1000), ("dc=1", 70, 1, 64), ("B=1", 9, 32, 1),
]
CM_SIZES = {"f32": 4, "bf16": 2}


@pytest.mark.parametrize("size", list(CM_SIZES))
@pytest.mark.parametrize("shape", CM_SHAPES, ids=[s[0] for s in CM_SHAPES])
def test_check_major_plan_covers_and_fits(shape, size):
    """Kernel 5's tiles partition the checks by the frames; the ring fits
    the blocks an SM in shared memory and their threads in the register
    budget; a block has a thread for every CM_ILP pairs of its tile."""
    _, C, dc, B = shape
    v = CM_SIZES[size]
    plan = check_major_plan(C, dc, B, v)
    assert 1 <= plan.checks <= 64 and plan.checks & (plan.checks - 1) == 0
    assert 1 <= plan.frames <= min(B, 256)
    assert plan.tiles == -(-C // plan.checks) * -(-B // plan.frames)
    assert 1 <= plan.grid == min(plan.tiles, plan.blocks_per_sm * 132)
    assert plan.smem == check_major_smem(dc, plan.checks, plan.frames,
                                         plan.stages, v)
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_SM
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= CM_THREADS_MAX
    assert plan.blocks_per_sm * plan.threads <= CM_THREADS_SM
    assert plan.threads * CM_ILP >= min(plan.checks * plan.frames,
                                        CM_ILP * CM_THREADS_MAX)
    if plan.path == "staged":
        assert (B * v) % 16 == 0 and (plan.frames * v) % 16 == 0
        assert 2 <= plan.stages <= 4
    else:
        assert (B * v) % 16 and plan.stages == 1


@pytest.mark.parametrize("size", list(CM_SIZES))
def test_check_major_plan_of_the_main_path(size):
    """At [32400, 7, 128] a tile is 4 checks by all 128 frames (512 pairs,
    one for every thread lane of a 256-thread block twice), and 1024
    threads an SM fit: four blocks an SM of 2-4 stages, a persistent grid
    of 528 blocks."""
    plan = check_major_plan(32400, 7, 128, CM_SIZES[size])
    assert (plan.checks, plan.frames, plan.threads) == (4, 128, 256)
    assert plan.path == "staged" and plan.stages >= 3
    assert plan.blocks_per_sm == 4 and plan.grid == 528
    # unaligned pointers take the per-thread path
    assert check_major_plan(32400, 7, 128, CM_SIZES[size],
                            aligned=False).path == "thread"
    # every main-path case keeps 384 threads an SM or more
    for _, C, dc, B in CM_MAIN:
        p = check_major_plan(C, dc, B, CM_SIZES[size])
        assert p.blocks_per_sm * p.threads >= 384


def test_check_major_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        check_major_plan(100, MAX_DC + 1, 128, 4)
    with pytest.raises(ValueError):
        check_major_plan(0, 7, 128, 4)


def test_check_major_smem_matches_the_layout_by_hand():
    # f32, 4 checks x 128 frames x 7 slots, 3 stages: per stage the slab
    # 4*7*128*4 bytes, the syndrome 4*128*4, the mask 4*7*4 (rounded to 16);
    # one mbarrier a stage
    assert check_major_smem(7, 4, 128, 3, 4) == \
        3 * (14336 + 2048 + 112) + 48


@pytest.mark.parametrize("size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("math_", sorted(PROBE_MATHS))
def test_check_math_probe_plan_is_kernel_1s(math_, size):
    """Kernel 6 takes the plan of kernel 1's rule with its scratch (phi:
    the phi rule's one f32 a slot; copy and the probe's min-sum: none), is
    staged at the probe's shape [18, 6, 1800, 128], and its rule numbers
    are none of the decoders' but phi's."""
    rule, plan_rule = PROBE_MATHS[math_]
    assert (rule == KERNEL_RULES["sumproduct"]) == (math_ == "phi")
    assert rule not in (KERNEL_RULES["tanhfb"], KERNEL_RULES["minsum"])
    plan = check_tile_plan(18, 6, 1800, 128, size, size, plan_rule,
                           masked=False)
    scratch = 1 if math_ == "phi" else 0
    assert plan.smem == tile_smem(6, plan.checks, plan.frames, plan.stages,
                                  size, size, False, scratch)
    assert plan.path == "staged" and plan.frames == 128
    assert plan.tiles == 18 * -(-1800 // plan.checks)
    assert plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_SM
