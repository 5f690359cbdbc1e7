"""The launch plans of the staged-tile check phase (kernels 1 and 4,
``csrc/bp_check_tile.cuh``), of kernel 5's check-major tiles
(``check_major_plan``) and of kernel 6's warp-specialised tiles
(``probe_tile_plan``), and the shared-memory attribute's record
(``SmemGrants``, kernels 6 and 8): pure functions of the call's shape, held
here on the CPU.  Plain torch, no JAX."""

import itertools

import pytest
import torch

from qamreconciliation_tpu_torch.ops.kernels import (
    CM_ILP, CM_THREADS_MAX, CM_THREADS_SM, GENERIC_BLOCK_C, MAX_DC,
    PROBE_BLOCKS_PER_SM, PROBE_CONSUMERS, PROBE_MATHS, PROBE_PAIRS_MAX,
    PROBE_PRODUCER, PROBE_REGISTER_DC, PROBE_STAGES_MAX, SMEM_BLOCK_MAX,
    SMEM_SM, SmemGrants, check_major_plan, check_major_smem, check_tile_plan,
    probe_instance, probe_tile_plan, probe_tile_smem, tile_smem,
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


# ---------------------------------------------------------------- kernel 6

# (label, nb_c, dc, z, B, aligned): the probe's shape [18, 6, 1800, 128],
# ragged ones (z off the tile, B off 16 bytes, past one tile's frames), an
# unaligned pointer, and rows wider than the register slots
PROBE_SHAPES = [
    ("probe", 18, 6, 1800, 128, True),
    ("z=70 B=40", 5, 6, 70, 40, True),
    ("z=70 B=37", 3, 6, 70, 37, True),
    ("z=21 B=300", 2, 6, 21, 300, True),
    ("z=64 B=100", 18, 6, 64, 100, True),
    ("unaligned", 18, 6, 64, 128, False),
    ("dc=12", 3, 12, 70, 40, True),
    ("dc=32", 2, 32, 21, 64, True),
]
PROBE_SIZES = {"bf16": 2, "f32": 4}
probe_cases = pytest.mark.parametrize(
    "shape,size,math_",
    [(shape, size, m) for shape in PROBE_SHAPES for size in PROBE_SIZES
     for m in sorted(PROBE_MATHS)],
    ids=[f"{shape[0]}-{size}-{m}" for shape in PROBE_SHAPES
         for size in PROBE_SIZES for m in sorted(PROBE_MATHS)])


def probe_plan_of(shape, size, math_):
    _, nb_c, dc, z, B, aligned = shape
    return probe_tile_plan(nb_c, dc, z, B, PROBE_SIZES[size], math_,
                           aligned=aligned)


@probe_cases
def test_probe_plan_path_and_slots(shape, size, math_):
    """The bulk path where 16-byte units line up, with a producer warp
    beside the 256 consumers; phi and min-sum keep their slot values in
    registers there up to dc 8, else in the scratch; copy keeps none."""
    _, nb_c, dc, z, B, aligned = shape
    plan = probe_plan_of(shape, size, math_)
    bulk = aligned and (B * PROBE_SIZES[size]) % 16 == 0
    assert plan.path == ("bulk" if bulk else "thread")
    assert plan.threads == PROBE_CONSUMERS + (PROBE_PRODUCER if bulk else 0)
    if math_ == "copy":
        assert plan.slots == "none"
    else:
        assert plan.slots == ("registers" if bulk and dc <= PROBE_REGISTER_DC
                              else "scratch")
    if bulk:
        assert 2 <= plan.stages <= PROBE_STAGES_MAX
        assert (plan.frames * PROBE_SIZES[size]) % 16 == 0
    else:
        assert plan.stages == 0


@probe_cases
def test_probe_plan_smem_is_its_layout(shape, size, math_):
    """Per stage the t and c2v tiles ([dc][checks][frames], each rounded
    to 16 bytes) and the int32 syndrome tile, a full and an empty mbarrier
    a stage, and the scratch: one f32 column of dc values a consumer."""
    _, nb_c, dc, z, B, aligned = shape
    plan = probe_plan_of(shape, size, math_)
    pairs = plan.checks * plan.frames
    tile = -(-dc * pairs * PROBE_SIZES[size] // 16) * 16
    synd = -(-pairs * 4 // 16) * 16
    scratch = dc * 256 * 4 if plan.slots == "scratch" else 0
    assert plan.smem == plan.stages * (2 * tile + synd + 16) + scratch
    assert plan.smem == probe_tile_smem(dc, plan.checks, plan.frames,
                                        plan.stages, PROBE_SIZES[size],
                                        plan.slots == "scratch")


@probe_cases
def test_probe_plan_tiles_and_grid(shape, size, math_):
    """A consumer thread owns one frame of a tile and the same number
    (1..PROBE_PAIRS_MAX) of its checks; the tiles cover every (check,
    frame) of each block row once; a persistent grid."""
    _, nb_c, dc, z, B, aligned = shape
    plan = probe_plan_of(shape, size, math_)
    assert plan.frames == min(B, PROBE_CONSUMERS)
    rows = PROBE_CONSUMERS // plan.frames
    assert plan.checks % rows == 0
    assert 1 <= plan.checks // rows <= PROBE_PAIRS_MAX
    if plan.path == "thread":
        assert plan.checks == rows
    assert plan.tiles == nb_c * -(-z // plan.checks) * -(-B // plan.frames)
    assert plan.grid == min(plan.tiles, plan.blocks_per_sm * 132)


@probe_cases
def test_probe_plan_fits_the_sm(shape, size, math_):
    """No more blocks an SM than the launch bounds' register budget and the
    SM's shared memory take, and no block over the opt-in limit; no tile
    of two pairs a thread more would fit as many blocks (warps first, tile
    second)."""
    _, nb_c, dc, z, B, aligned = shape
    plan = probe_plan_of(shape, size, math_)
    assert 1 <= plan.blocks_per_sm <= PROBE_BLOCKS_PER_SM
    assert plan.smem <= SMEM_BLOCK_MAX
    assert plan.blocks_per_sm * (plan.smem + 1024) <= SMEM_SM
    if plan.path == "bulk":
        bigger = probe_tile_smem(dc, 2 * plan.checks, plan.frames, 2,
                                 PROBE_SIZES[size], plan.slots == "scratch")
        assert (2 * plan.checks // (PROBE_CONSUMERS // plan.frames)
                > PROBE_PAIRS_MAX
                or plan.blocks_per_sm * (bigger + 1024) > SMEM_SM)


@pytest.mark.parametrize("math_", sorted(PROBE_MATHS))
@pytest.mark.parametrize("size", list(PROBE_SIZES))
def test_probe_plan_at_the_probes_shape(size, math_):
    """At [18, 6, 1800, 128]: bulk, four blocks of 288 threads an SM (36
    warps), a tile of 4 checks by all 128 frames (two pairs a consumer),
    three stages in bf16 (14,352 B a stage with its mbarriers) and two in
    f32 (26,640 B), a persistent grid of 528 blocks."""
    plan = probe_tile_plan(18, 6, 1800, 128, PROBE_SIZES[size], math_)
    assert plan.path == "bulk"
    assert plan.slots == ("none" if math_ == "copy" else "registers")
    assert plan.blocks_per_sm * plan.threads // 32 == 36 >= 32
    assert (plan.checks, plan.frames) == (4, 128)
    assert (plan.stages, plan.smem) == ((3, 43056) if size == "bf16"
                                        else (2, 53280))
    assert plan.tiles == 18 * 450 and plan.grid == 528


def test_probe_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        probe_tile_plan(18, 6, 1800, 128, 2, "tanhfb")
    with pytest.raises(ValueError):
        probe_tile_plan(18, MAX_DC + 1, 1800, 128, 2, "phi")
    with pytest.raises(ValueError):
        probe_tile_plan(18, 6, 1800, 128, 8, "phi")


@pytest.mark.parametrize("math_", sorted(PROBE_MATHS))
def test_probe_instance_names_the_register_rows(math_):
    """The instance a plan launches: the compile-time dc only for register
    slots, so every scratch or copy plan of a dtype and path shares one."""
    reg = probe_tile_plan(18, 6, 1800, 128, 2, math_)
    wide = probe_tile_plan(3, 12, 70, 40, 2, math_)
    assert probe_instance(reg, torch.bfloat16, math_, 6)[2] == \
        (6 if math_ != "copy" else 0)
    assert probe_instance(wide, torch.bfloat16, math_, 12)[2] == 0
    assert probe_instance(reg, torch.bfloat16, math_, 6)[3] == "bulk"


# -------------------------------------- the shared-memory attribute, once

def test_grants_ascending_sizes_each_set_the_attribute():
    g = SmemGrants()
    for nbytes in (8192, 49152, 98304, 232448):
        assert g.needs(0, nbytes)
        g.grant(0, nbytes)
        assert not g.needs(0, nbytes)
    assert g.granted == {0: 232448}


def test_grants_descending_sizes_after_a_grant_set_nothing():
    g = SmemGrants()
    g.grant(0, 232448)
    for nbytes in (204800, 98304, 49152, 8192, 0):
        assert not g.needs(0, nbytes)
    assert g.granted == {0: 232448}


def test_grants_a_refusal_records_nothing():
    """A request past the card's limit is asked for (and refused by the
    card, so never granted); it is asked for again next time, and the
    sizes granted before still need nothing."""
    g = SmemGrants()
    g.grant(0, 232448)
    assert g.needs(0, 233472)
    assert g.needs(0, 233472)
    assert not g.needs(0, 232448)
    assert g.granted == {0: 232448}


def test_grants_are_per_device_and_instance():
    g = SmemGrants()
    g.grant(0, 98304)
    assert g.needs(1, 8192) and not g.needs(0, 8192)
    g.grant(1, 8192)
    assert g.needs(1, 98304) and not g.needs(0, 98304)
    a, b = ("bf16", "phi", 6, "bulk"), ("bf16", "copy", 0, "bulk")
    g.grant((a, 0), 43056)
    assert g.needs((b, 0), 43056) and not g.needs((a, 0), 43056)
    # the first request of a key always sets the attribute, even of 0 bytes
    assert g.needs((b, 1), 0)
