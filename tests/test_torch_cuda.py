"""The port's CUDA kernels against their plain versions, and the wrappers'
dispatch.  Imports no JAX, so it also runs on a GPU host without jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tests marked ``cuda`` skip without a card.  Tolerances as in
test_torch_check_phase.py: min-sum and the convergence counts are exact,
phi/tanhfb within rtol/atol 1e-5 in f32 (two libms: the kernel's and
PyTorch's CUDA ops) or one bf16 ulp with bf16 messages; the staged-tile
kernels 1 and 4 are also held bit for bit on ragged shapes, every rule and
dtype, both load paths (``test_*_tiles_bit_equal``).  The multi-step
kernels 2 and 3 (blocks owning frames, ``csrc/bp_resident.cuh``) are held
bit for bit on all four state tensors (totals, messages, done, iters) for
every rule and dtype pair, B off every block size, z off the warp, rows
wider than 8, K = 1, steps past maxiter, every frame done, and the frame's
totals in shared and in device memory.  The generic check phase (kernel 4)
and the check-major update (kernel 5, float32 and bfloat16) are held bit
for bit, as the card runs them, and so are the probes' kernels 6-9 (kernel
9 on all eight state tensors in its four variants, kernel 8 up to the
card's shared-memory limit and refused past it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ira, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import cuda_build, kernels
from qamreconciliation_tpu_torch.ops.kernels import (
    QCTables, bp_check_phase_generic, bp_check_phase_generic_ref,
    check_tile_plan, resident_smem,
    bp_check_phase_qc, bp_check_phase_qc_ref, bp_decode_rounds_qc,
    bp_decode_rounds_qc_ref, bp_layered_sweeps_qc, bp_layered_sweeps_qc_ref,
    check_node_update_fused, check_node_update_fused_ref,
)

torch.set_num_threads(1)

RULES = [
    ("sumproduct", {}),
    ("tanhfb", {}),
    ("minsum", {}),
    ("minsum", dict(ms_alpha=1.0, ms_beta=0.3)),
]
DTYPES = [  # (t, c2v) storage pairs
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),
]


def make_inputs(seed, shape, irregular=True):
    """numpy (t, c2v, synd); short rows carry the +1e30 padded-slot
    sentinel in t, as the decoder's gather writes it."""
    nb_c, dc, z, b = shape
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 3, shape).astype(np.float32)
    c2v = rng.normal(0, 1, shape).astype(np.float32)
    synd = rng.integers(0, 2, (nb_c, z, b)).astype(np.int32)
    if irregular:
        for cb in range(0, nb_c, 2):
            t[cb, dc - 1 - cb % 3:] = 1e30
    return t, c2v, synd


def assert_close(got, want, rule, m_dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if rule == "minsum":
        assert torch.equal(got, want)
    elif m_dtype == torch.bfloat16:
        a = want.abs()
        ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                          torch.full_like(a, 2.0 ** -133))
        assert bool(((got - want).abs() <= ulp).all()), \
            float((got - want).abs().max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_cpu_tensors_run_the_plain_version():
    t, c2v, synd = (torch.from_numpy(a)
                    for a in make_inputs(1, (3, 6, 10, 5)))
    n0 = bp_check_phase_qc.launches
    got = bp_check_phase_qc(t, c2v, synd, rule="minsum")
    want = bp_check_phase_qc_ref(t, c2v, synd, rule="minsum")
    assert bp_check_phase_qc.launches == n0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_build_keys_library_by_source_and_reports_missing_nvcc(
        tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = cuda_build._library_path(src)
    src.write_text("// b\n")
    second = cuda_build._library_path(src)
    assert second != first
    assert first.parent == cuda_build.BUILD_DIR
    # a shared header beside the source is part of the key
    header = tmp_path / "common.cuh"
    header.write_text("// x\n")
    with_header = cuda_build._library_path(src)
    assert with_header != second
    header.write_text("// y\n")
    assert cuda_build._library_path(src) not in (with_header, second)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build._nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype,m_dtype", DTYPES)
@pytest.mark.parametrize("rule,kw", RULES)
def test_cuda_kernel_matches_plain(rule, kw, t_dtype, m_dtype):
    """A ragged shape: z and B not multiples of the kernel's tiles."""
    need_cuda()
    t, c2v, synd = make_inputs(13, (5, 7, 70, 40))
    args = (torch.from_numpy(t).to("cuda", t_dtype),
            torch.from_numpy(c2v).to("cuda", m_dtype),
            torch.from_numpy(synd).cuda())
    n0 = bp_check_phase_qc.launches
    got, gviol = bp_check_phase_qc(*args, rule=rule, **kw)
    assert bp_check_phase_qc.launches == n0 + 1
    want, wviol = bp_check_phase_qc_ref(*args, rule=rule, **kw)
    torch.cuda.synchronize()
    assert got.dtype == m_dtype and gviol.dtype == torch.int32
    assert torch.equal(gviol, wviol)
    assert_close(got, want, rule, m_dtype)


# (nb_c, dc, z, B): z not a multiple of the tile, B off the 16-byte units
# (1, and 100 in bf16: the per-thread path) and beyond one tile's frames
# (256), degree-1 rows, the MAXD 32 width
QC_TILE_SHAPES = [(3, 6, 70, 1), (3, 6, 70, 100), (3, 6, 70, 256),
                  (2, 1, 37, 40), (2, 32, 21, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QC_TILE_SHAPES,
                         ids=["x".join(map(str, s)) for s in QC_TILE_SHAPES])
@pytest.mark.parametrize("t_dtype,m_dtype", DTYPES)
@pytest.mark.parametrize("rule,kw", RULES)
def test_qc_tiles_bit_equal(rule, kw, t_dtype, m_dtype, shape):
    """Kernel 1 on staged tiles, bit for bit, +1e30 padded slots included;
    the plan's load path as check_tile_plan gives it."""
    need_cuda()
    t, c2v, synd = make_inputs(23, shape)
    args = (torch.from_numpy(t).to("cuda", t_dtype),
            torch.from_numpy(c2v).to("cuda", m_dtype),
            torch.from_numpy(synd).cuda())
    got, gviol = bp_check_phase_qc(*args, rule=rule, **kw)
    want, wviol = bp_check_phase_qc_ref(*args, rule=rule, **kw)
    torch.cuda.synchronize()
    nb_c, dc, z, B = shape
    plan = bp_check_phase_qc.plan
    assert plan == check_tile_plan(
        nb_c, dc, z, B, args[0].element_size(), args[1].element_size(),
        rule, masked=False,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.path == ("staged" if (B * args[1].element_size()) % 16 == 0
                         and (B * args[0].element_size()) % 16 == 0
                         else "thread")
    assert torch.equal(gviol, wviol)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    need_cuda()
    t = torch.zeros(2, 6, 8, 4, device="cuda")
    synd = torch.zeros(2, 8, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        bp_check_phase_qc(t.double(), t.double(), synd)
    with pytest.raises(TypeError):
        bp_check_phase_qc(t, t, synd.long())
    with pytest.raises(ValueError, match="contiguous"):
        bp_check_phase_qc(t.transpose(2, 3).contiguous().transpose(2, 3),
                          t, synd)
    wide = torch.zeros(2, 33, 8, 4, device="cuda")
    with pytest.raises(ValueError, match="degree"):
        bp_check_phase_qc(wide, wide, synd)


@pytest.mark.cuda
@pytest.mark.parametrize("change", [dict(blocks_per_sm=4),
                                    dict(blocks_per_sm=0),
                                    dict(smem_delta=16)],
                         ids=["blocks 4", "blocks 0", "smem"])
def test_tile_launch_refuses_a_plan_the_kernel_does_not_take(monkeypatch,
                                                             change):
    """The launch holds the plan to the kernel's own limits and layout:
    more blocks an SM than its register budget allows, or a shared-memory
    size other than its layout's, is refused."""
    need_cuda()
    plan_fn = kernels.check_tile_plan

    def altered(*args, **kw):
        plan = plan_fn(*args, **kw)
        smem = plan.smem + change.get("smem_delta", 0)
        return dataclasses.replace(
            plan, smem=smem,
            blocks_per_sm=change.get("blocks_per_sm", plan.blocks_per_sm))

    monkeypatch.setattr(kernels, "check_tile_plan", altered)
    t, c2v, synd = (torch.from_numpy(a).cuda()
                    for a in make_inputs(5, (3, 6, 40, 128)))
    with pytest.raises(RuntimeError, match="launch failed"):
        bp_check_phase_qc(t, c2v, synd)
    mask = torch.ones(6, 40, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        bp_check_phase_generic(t[0], c2v[0], synd[0], mask)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(check_rule="minsum"), dict(),
                                dict(check_phi="tanhfb")],
                         ids=["minsum", "phi", "tanhfb"])
def test_cuda_decode_matches_cpu(kw):
    """The decoder on the card (kernel) against the CPU (plain version)."""
    need_cuda()
    base, vid, cid = make_qc_ldpc(12, 32, 3, 6, seed=7)
    rng = np.random.default_rng(4)
    B = 24
    word = rng.integers(0, 2, (B, 12 * 32))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    llr = torch.from_numpy(
        (1 - 2 * word) * 2.5 + rng.normal(0, 2.2, word.shape)
    ).float()
    cpu = QCDecoder(base, 32, device="cpu", **kw).decode_batch(llr, synd, 25)
    n0 = bp_check_phase_qc.launches
    dec = QCDecoder(base, 32, device="cuda", **kw)
    gpu = dec.decode_batch(llr, synd, 25)
    assert bp_check_phase_qc.launches - n0 == dec.iterations_run > 0
    assert torch.equal(gpu[0].cpu(), cpu[0])
    assert torch.equal(gpu[1].cpu(), cpu[1])
    assert 0 < int(cpu[0].sum()) < B
    if kw.get("check_rule") == "minsum":
        assert torch.equal(gpu[2].cpu(), cpu[2])
    else:
        torch.testing.assert_close(gpu[2].cpu(), cpu[2], rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------- multi-step kernels


def rows_of(base):
    rows = [[] for _ in range(max(c for c, _, _ in base) + 1)]
    for c, v, s in base:
        rows[c].append((v, s))
    return rows


# ragged z and B; rows 1, 2 and 5 of the regular code hold a repeated
# variable block, the IRA code's I + P^1 cells do too
STEP_CODES = {
    "regular": (rows_of(make_qc_ldpc(12, 40, 3, 6, seed=4)[0]), 40),
    "ira": (rows_of(make_qc_ira(8, 4, 40, dv=3, seed=2)[0]), 40),
}
STEP_B = 40


def step_state(tables, m_dtype, t_dtype, seed, layered, B=STEP_B):
    """CPU state from numpy-seeded channel LLRs (per-frame noise 0.8-3.2,
    so some frames converge within a few steps and others do not)."""
    z = tables.z
    rng = np.random.default_rng(seed)
    shape = (tables.nb_v, z, B)
    word = rng.integers(0, 2, shape)
    llr = ((1 - 2 * word) * 3.0 + rng.normal(0, 1.0, shape)
           * np.linspace(0.8, 3.2, B)).astype(np.float32)
    synd = np.zeros((tables.nb_c, z, B), np.int8)
    for cb, row in enumerate(tables.rows):
        for v, s in row:
            synd[cb] ^= np.roll(word[v], s, axis=0).astype(np.int8)
    prior = torch.from_numpy(llr).to(m_dtype)
    c2v = torch.zeros((tables.E, z, B), dtype=m_dtype)
    flags = [torch.zeros(B, dtype=torch.int32) for _ in range(2)]
    if layered:
        return [prior.float(), c2v, torch.from_numpy(synd), *flags]
    return [prior.to(t_dtype, copy=True), c2v, prior,
            torch.from_numpy(synd), *flags]


def assert_state_equal(got, want):
    """Bit-equality of (total, c2v, done, iters)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


STEP_RULES = ["sumproduct", "tanhfb", "minsum"]


def test_multi_step_cpu_tensors_run_the_plain_versions():
    rows, z = STEP_CODES["regular"]
    tables = QCTables(rows, z)
    for layered, fn, ref in ((False, bp_decode_rounds_qc,
                              bp_decode_rounds_qc_ref),
                             (True, bp_layered_sweeps_qc,
                              bp_layered_sweeps_qc_ref)):
        a = step_state(tables, torch.float32, torch.float32, 1, layered)
        b = [x.clone() for x in a]
        n0 = (fn.launches, fn.iterations, fn.device_launches)
        fn(tables, 0, 50, *a, rule="minsum")
        ref(tables, 0, 50, *b, rule="minsum")
        assert (fn.launches, fn.iterations, fn.device_launches) == n0
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("code", list(STEP_CODES))
@pytest.mark.parametrize("t_dtype,m_dtype", DTYPES)
@pytest.mark.parametrize("rule", STEP_RULES)
def test_rounds_kernel_matches_plain(rule, t_dtype, m_dtype, code):
    need_cuda()
    rows, z = STEP_CODES[code]
    tables = QCTables(rows, z)
    state = [x.cuda() for x in step_state(tables, m_dtype, t_dtype, 3,
                                          False)]
    bp_decode_rounds_qc_ref(tables, 0, 50, *state, rule=rule, k_rounds=2)
    want = [x.clone() for x in state]
    fn = bp_decode_rounds_qc
    n0 = (fn.launches, fn.iterations, fn.device_launches)
    bp_decode_rounds_qc(tables, 2, 50, *state, rule=rule, k_rounds=4)
    # one call: the copy in, the 4 iterations, the copy out
    assert (fn.launches - n0[0], fn.iterations - n0[1],
            fn.device_launches - n0[2]) == (1, 4, 3)
    bp_decode_rounds_qc_ref(tables, 2, 50, *want, rule=rule, k_rounds=4)
    torch.cuda.synchronize()
    assert 0 < int(want[4].sum()) < STEP_B
    assert_state_equal(state[:2] + state[4:], want[:2] + want[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("code", list(STEP_CODES))
@pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", STEP_RULES)
def test_sweeps_kernel_matches_plain(rule, m_dtype, code):
    need_cuda()
    rows, z = STEP_CODES[code]
    tables = QCTables(rows, z)
    assert tables.n_defer_slots > 0
    state = [x.cuda() for x in step_state(tables, m_dtype, None, 5, True)]
    bp_layered_sweeps_qc_ref(tables, 0, 50, *state, rule=rule, k_sweeps=1)
    want = [x.clone() for x in state]
    fn = bp_layered_sweeps_qc
    n0 = (fn.launches, fn.device_launches)
    bp_layered_sweeps_qc(tables, 1, 50, *state, rule=rule, k_sweeps=3)
    assert (fn.launches - n0[0], fn.device_launches - n0[1]) == (1, 3)
    bp_layered_sweeps_qc_ref(tables, 1, 50, *want, rule=rule, k_sweeps=3)
    torch.cuda.synchronize()
    assert 0 < int(want[3].sum()) < STEP_B
    assert_state_equal(state[:2] + state[3:], want[:2] + want[3:])


# z off the warp and off 8; the IRA code holds rows 12 wide (beyond the
# first design's MAXD 8 instance) and repeated variable blocks, like the
# regular one
EDGE_CODES = {
    "regular z=37": (rows_of(make_qc_ldpc(12, 37, 3, 6, seed=4)[0]), 37),
    "ira z=45": (rows_of(make_qc_ira(8, 4, 45, dv=3, seed=2)[0]), 45),
}
# (rule, totals dtype, message dtype) per kernel: every rule, each dtype
RES_CASES = {
    "rounds": [("minsum", torch.bfloat16, torch.bfloat16),
               ("tanhfb", torch.float32, torch.bfloat16),
               ("sumproduct", torch.float32, torch.float32)],
    "sweeps": [("minsum", torch.float32, torch.bfloat16),
               ("tanhfb", torch.float32, torch.bfloat16),
               ("sumproduct", torch.float32, torch.float32)],
}


def run_pair(kernel, tables, state, want, rule, it0, maxiter, k):
    """The kernel on ``state`` and its plain version on ``want``."""
    if kernel == "rounds":
        bp_decode_rounds_qc(tables, it0, maxiter, *state, rule=rule,
                            k_rounds=k)
        bp_decode_rounds_qc_ref(tables, it0, maxiter, *want, rule=rule,
                                k_rounds=k)
    else:
        bp_layered_sweeps_qc(tables, it0, maxiter, *state, rule=rule,
                             k_sweeps=k)
        bp_layered_sweeps_qc_ref(tables, it0, maxiter, *want, rule=rule,
                                 k_sweeps=k)
    torch.cuda.synchronize()


def flags_of(kernel, state):
    return state[4:] if kernel == "rounds" else state[3:]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 40, 100, 129, 256])
@pytest.mark.parametrize("code", list(EDGE_CODES))
@pytest.mark.parametrize("case", [0, 1, 2], ids=["minsum", "tanhfb", "phi"])
@pytest.mark.parametrize("kernel", ["rounds", "sweeps"])
def test_resident_kernels_bit_equal_across_batches(kernel, case, code, B):
    """Blocks own frames: any B, a grid of fewer blocks than frames (256 >
    132 SMs), z off the warp, rows wider than 8; bit for bit on all four
    state tensors after plain steps that leave some frames done."""
    need_cuda()
    rule, t_dtype, m_dtype = RES_CASES[kernel][case]
    rows, z = EDGE_CODES[code]
    tables = QCTables(rows, z)
    layered = kernel == "sweeps"
    warm = [x.cuda() for x in step_state(tables, m_dtype, t_dtype, 7,
                                         layered, B=B)]
    if layered:
        bp_layered_sweeps_qc_ref(tables, 0, 50, *warm, rule=rule, k_sweeps=1)
    else:
        bp_decode_rounds_qc_ref(tables, 0, 50, *warm, rule=rule, k_rounds=2)
    it0 = 1 if layered else 2
    state = [x.clone() for x in warm]
    run_pair(kernel, tables, state, warm, rule, it0, 50, 3)
    plan = (bp_layered_sweeps_qc if layered else bp_decode_rounds_qc).plan
    assert plan.grid == min(B, plan.blocks_per_sm * torch.cuda
                            .get_device_properties(0).multi_processor_count)
    assert_state_equal(state, warm)
    if B >= 40:
        assert 0 < int(flags_of(kernel, warm)[0].sum()) < B


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["K=1", "past maxiter", "all done",
                                      "totals global", "totals shared"])
@pytest.mark.parametrize("kernel", ["rounds", "sweeps"])
def test_resident_kernels_bit_equal_at_the_edges(kernel, scenario,
                                                 monkeypatch):
    """K = 1; a call whose K runs past maxiter (only maxiter - it0 steps
    run); a state where every frame is done (totals frozen, messages still
    updated); and each placement of the frame's totals, forced through the
    plan."""
    need_cuda()
    rule, t_dtype, m_dtype = RES_CASES[kernel][0]
    rows, z = EDGE_CODES["ira z=45"]
    tables = QCTables(rows, z)
    layered = kernel == "sweeps"
    state = [x.cuda() for x in step_state(tables, m_dtype, t_dtype, 9,
                                          layered)]
    it0, maxiter, k = 0, 50, 4
    if scenario == "K=1":
        k = 1
    elif scenario == "past maxiter":
        it0, maxiter, k = 3, 5, 8
    elif scenario == "all done":
        flags_of(kernel, state)[0].fill_(1)
        flags_of(kernel, state)[1].fill_(2)
    else:
        plan_fn = kernels.resident_plan

        def forced(*args, **kw):
            plan = plan_fn(*args, **kw)
            shared = scenario == "totals shared"
            smem = resident_smem(
                plan.threads, tables.nb_v, z, tables.dc_max,
                4 if layered else args[6], rule, layered=layered,
                defer_slots=kw.get("defer_slots", 0), totals_shared=shared)
            return dataclasses.replace(
                plan, smem=smem, totals="shared" if shared else "global")

        monkeypatch.setattr(kernels, "resident_plan", forced)
    want = [x.clone() for x in state]
    before = [x.clone() for x in state]
    fn = bp_layered_sweeps_qc if layered else bp_decode_rounds_qc
    n0 = fn.iterations
    run_pair(kernel, tables, state, want, rule, it0, maxiter, k)
    assert fn.iterations - n0 == min(k, maxiter - it0)
    assert_state_equal(state, want)
    if scenario.startswith("totals"):
        assert fn.plan.totals == scenario.split()[1]
    if scenario == "all done":
        assert torch.equal(state[0], before[0])        # totals frozen
        assert not torch.equal(state[1], before[1])    # messages updated
        assert_state_equal(flags_of(kernel, state),
                           flags_of(kernel, before))


@pytest.mark.cuda
@pytest.mark.parametrize("change", [dict(blocks_per_sm=3),
                                    dict(smem_delta=16), dict(cluster=2),
                                    dict(threads=1056), dict(frames=2)],
                         ids=["blocks 3", "smem", "cluster", "threads",
                              "frames"])
def test_resident_launch_refuses_a_plan_beyond_its_limits(monkeypatch,
                                                          change):
    """The launch holds the plan to the kernel's own limits: more blocks an
    SM than its registers allow, a shared-memory size other than its
    layout's, a cluster, more than 1024 threads, several frames a block."""
    need_cuda()
    plan_fn = kernels.resident_plan

    def altered(*args, **kw):
        plan = plan_fn(*args, **kw)
        return dataclasses.replace(
            plan, smem=plan.smem + change.get("smem_delta", 0),
            **{k: v for k, v in change.items() if k != "smem_delta"})

    monkeypatch.setattr(kernels, "resident_plan", altered)
    rows, z = STEP_CODES["regular"]
    tables = QCTables(rows, z)
    st = [x.cuda() for x in step_state(tables, torch.float32,
                                       torch.float32, 1, False)]
    with pytest.raises(RuntimeError, match="launch failed"):
        bp_decode_rounds_qc(tables, 0, 5, *st, rule="minsum")
    lay = [x.cuda() for x in step_state(tables, torch.float32, None, 1,
                                        True)]
    with pytest.raises(RuntimeError, match="launch failed"):
        bp_layered_sweeps_qc(tables, 0, 5, *lay, rule="minsum")


@pytest.mark.cuda
def test_multi_step_kernels_reject_what_they_do_not_take():
    need_cuda()
    rows, z = STEP_CODES["regular"]
    tables = QCTables(rows, z)
    st = [x.cuda() for x in step_state(tables, torch.float32, torch.float32,
                                       1, False)]
    with pytest.raises(TypeError, match="synd"):
        bp_decode_rounds_qc(tables, 0, 5, st[0], st[1], st[2],
                            st[3].int(), st[4], st[5])
    with pytest.raises(TypeError):
        bp_decode_rounds_qc(tables, 0, 5, st[0], st[1], st[2].bfloat16(),
                            st[3], st[4], st[5])
    with pytest.raises(ValueError, match="contiguous"):
        nc = st[1].transpose(1, 2).contiguous().transpose(1, 2)
        bp_decode_rounds_qc(tables, 0, 5, st[0], nc, st[2], st[3], st[4],
                            st[5])
    lay = [x.cuda() for x in step_state(tables, torch.float32, None, 1,
                                        True)]
    with pytest.raises(TypeError, match="float32"):
        bp_layered_sweeps_qc(tables, 0, 5, lay[0].bfloat16(), lay[1],
                             *lay[2:])


def _card_frames(base, z, B, seed, noise):
    nb_v = max(v for _, v, _ in base) + 1
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, nb_v * z))
    dec = QCDecoder(base, z, device="cpu")
    synd = dec.syndrome_from_bits(torch.from_numpy(word.T)).T
    llr = torch.from_numpy(
        (1 - 2 * word) * 3.0 + rng.normal(0, noise, word.shape)).float()
    return llr, synd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_resident_decoders_match_their_plain_loops(dtype):
    """On the card: resident min-sum == dense min-sum (kernel 2 against
    kernel 1), resident layered == the serial plain layered loop."""
    need_cuda()
    base = make_qc_ldpc(12, 32, 3, 6, seed=7)[0]
    llr, synd = _card_frames(base, 32, 24, 4, 2.2)
    kw = dict(dtype=dtype, device="cuda", check_rule="minsum")
    dense = QCDecoder(base, 32, **kw).decode_batch(llr, synd, 25)
    n0 = bp_decode_rounds_qc.iterations
    dec = QCDecoder(base, 32, resident=True, resident_chunk=6, **kw)
    res = dec.decode_batch(llr, synd, 25)
    assert bp_decode_rounds_qc.iterations - n0 == dec.iterations_run > 0
    for g, w in zip(res, dense):
        assert torch.equal(g.cpu(), w.cpu())
    assert 0 < int(dense[0].sum()) < 24
    plain = QCDecoder(base, 32, schedule="layered", layered_groups=False,
                      **kw).decode_batch(llr, synd, 25)
    n0 = bp_layered_sweeps_qc.iterations
    dec = QCDecoder(base, 32, schedule="layered", resident=True, **kw)
    lay = dec.decode_batch(llr, synd, 25)
    assert bp_layered_sweeps_qc.iterations - n0 == dec.iterations_run > 0
    for g, w in zip(lay, plain):
        assert torch.equal(g.cpu(), w.cpu())


# ------------------------------------------- kernels 4 and 5 (generic)


def generic_inputs(seed, dc, C, B):
    """numpy (t, c2v, synd, mask [dc, C]): a random non-prefix mask with a
    degree-1 check and an empty one."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 3, (dc, C, B)).astype(np.float32)
    c2v = rng.normal(0, 1, (dc, C, B)).astype(np.float32)
    synd = rng.integers(0, 2, (C, B)).astype(np.int32)
    mask = (rng.random((dc, C)) < 0.8).astype(np.float32)
    mask[:, 0] = 0.0
    mask[dc - 1, 0] = 1.0
    mask[:, 1] = 0.0
    par = np.sum((t < 0) * mask[:, :, None].astype(np.int64), 0) & 1
    synd[:, :5] = par[:, :5]
    return t, c2v, synd, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dc", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule,kw", RULES)
def test_generic_kernel_matches_plain(rule, kw, dtype, dc):
    """Kernel 4 bit for bit: a ragged C and B, MAXD 8 and 32."""
    need_cuda()
    t, c2v, synd, mask = (torch.from_numpy(a).cuda()
                          for a in generic_inputs(17, dc, 150, 40))
    args = (t.to(dtype), c2v.to(dtype), synd, mask)
    n0 = bp_check_phase_generic.launches
    got, gviol = bp_check_phase_generic(*args, rule=rule, **kw)
    assert bp_check_phase_generic.launches == n0 + 1
    want, wviol = bp_check_phase_generic_ref(*args, rule=rule, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and gviol.dtype == torch.int32
    assert torch.equal(gviol, wviol)
    conv = gviol.sum(0) == 0
    assert bool(conv[:5].all()) and not bool(conv.all())
    assert torch.equal(got, want)


# (dc, C, B): C not a multiple of the tile, B of the per-thread path (1,
# and 100 in bf16) and beyond one tile's frames (256), degree-1 checks
# (dc = 1) beside the empty and degree-1 checks of every mask, MAXD 32
GENERIC_TILE_SHAPES = [(7, 150, 1), (7, 150, 100), (7, 150, 256),
                       (1, 70, 40), (32, 70, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GENERIC_TILE_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in GENERIC_TILE_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule,kw", RULES)
def test_generic_tiles_bit_equal(rule, kw, dtype, shape):
    """Kernel 4 on staged tiles, bit for bit, with a random non-prefix
    mask holding an empty check and a degree-1 one."""
    need_cuda()
    dc, C, B = shape
    t, c2v, synd, mask = (torch.from_numpy(a).cuda()
                          for a in generic_inputs(29, dc, C, B))
    args = (t.to(dtype), c2v.to(dtype), synd, mask)
    got, gviol = bp_check_phase_generic(*args, rule=rule, **kw)
    want, wviol = bp_check_phase_generic_ref(*args, rule=rule, **kw)
    torch.cuda.synchronize()
    size = args[0].element_size()
    assert bp_check_phase_generic.plan.path == (
        "staged" if (B * size) % 16 == 0 else "thread")
    assert torch.equal(gviol, wviol)
    assert torch.equal(got, want)


# (C, dc, B) of kernel 5: ragged C and B, the per-thread path (B = 6, and
# 100 in bf16), frames beyond one tile (B = 512: a tile a row), dc = 32
CHECK_MAJOR_SHAPES = [(150, 6, 40), (150, 14, 40), (150, 7, 6),
                      (70, 7, 100), (70, 7, 512), (70, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHECK_MAJOR_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in CHECK_MAJOR_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_major_kernel_matches_plain(dtype, shape):
    """Kernel 5 bit for bit in float32 and bfloat16 (every bf16 operation
    rounded as the plain version rounds it), on a random non-prefix mask
    with an empty check and a degree-1 one, and the plan's load path as
    check_major_plan gives it."""
    need_cuda()
    C, dc, B = shape
    t, _, synd, mask = generic_inputs(19, dc, C, B)
    v = torch.from_numpy(t).transpose(0, 1).contiguous().cuda().to(dtype)
    args = (v, torch.from_numpy(synd).cuda(),
            torch.from_numpy(mask).T.contiguous().cuda())
    n0 = check_node_update_fused.launches
    got = check_node_update_fused(*args)
    assert check_node_update_fused.launches == n0 + 1
    want = check_node_update_fused_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    plan = check_node_update_fused.plan
    assert plan.path == ("staged" if (B * v.element_size()) % 16 == 0
                         else "thread")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_generic_kernels_reject_what_they_do_not_take():
    need_cuda()
    t = torch.zeros(6, 70, 8, device="cuda")
    synd = torch.zeros(70, 8, dtype=torch.int32, device="cuda")
    mask = torch.ones(6, 70, device="cuda")
    with pytest.raises(TypeError):
        bp_check_phase_generic(t.double(), t.double(), synd, mask)
    with pytest.raises(TypeError, match="synd"):
        bp_check_phase_generic(t, t, synd.long(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        bp_check_phase_generic(t.transpose(1, 2).contiguous().transpose(1, 2),
                               t, synd, mask)
    wide = torch.zeros(33, 70, 8, device="cuda")
    with pytest.raises(ValueError, match="degree"):
        bp_check_phase_generic(wide, wide, synd, torch.ones(33, 70,
                                                            device="cuda"))
    v = t.transpose(0, 1).contiguous()
    with pytest.raises(TypeError, match="float64"):
        check_node_update_fused(v.double(), synd, mask.T)
    with pytest.raises(TypeError, match="synd"):
        check_node_update_fused(v, synd.long(), mask.T)
    with pytest.raises(ValueError, match="degree"):
        check_node_update_fused(torch.zeros(70, 33, 8, device="cuda"), synd,
                                torch.ones(70, 33, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(check_rule="minsum"), dict()],
                         ids=["minsum", "phi"])
def test_cuda_generic_decode_matches_plain_and_cpu(kw, dtype):
    """The generic decoder on the card (kernel 4) against the same decoder
    with the plain check phase on the card (bit for bit) and on the CPU
    (min-sum bit for bit; f32 phi: equal success and iters)."""
    need_cuda()
    _, vid, cid = make_qc_ira(12, 6, 16, dv=3, seed=1)
    rng = np.random.default_rng(4)
    B = 24
    word = rng.integers(0, 2, (B, 18 * 16))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    llr = torch.from_numpy(
        (1 - 2 * word) * 2.5 + rng.normal(0, 2.0, word.shape)
        * np.linspace(0.5, 1.6, B)[:, None]).float()
    n0 = bp_check_phase_generic.launches
    dec = Decoder(vid, cid, dtype, device="cuda", **kw)
    gpu = dec.decode_batch(llr, synd, 25)
    assert bp_check_phase_generic.launches - n0 == dec.iterations_run > 0
    plain = Decoder(vid, cid, dtype, device="cuda", **kw)
    plain.check_phase = bp_check_phase_generic_ref
    ref = plain.decode_batch(llr, synd, 25)
    for g, w in zip(gpu, ref):
        assert torch.equal(g, w)
    assert 0 < int(gpu[0].sum()) < B
    if dtype == torch.bfloat16 and "check_rule" not in kw:
        return
    cpu = Decoder(vid, cid, dtype, device="cpu", **kw).decode_batch(
        llr, synd, 25)
    assert torch.equal(gpu[0].cpu(), cpu[0])
    assert torch.equal(gpu[1].cpu(), cpu[1])
    if "check_rule" in kw:
        assert torch.equal(gpu[2].cpu(), cpu[2])
    else:
        torch.testing.assert_close(gpu[2].cpu(), cpu[2], rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------- the flooding loop's one-late read


def _late_read_decoders(loop, device):
    """``(decoder, (its check kernel, its variable kernel), llr, synd)``: a
    bf16 min-sum flooding decoder (min-sum, so that the card and the CPU
    agree bit for bit) on a small code, and frames whose noise grows frame
    by frame, so that they converge at staggered iterations."""
    rng = np.random.default_rng(8)
    B = 24
    if loop == "generic":
        _, vid, cid = make_qc_ira(12, 6, 16, dv=3, seed=1)
        dec = Decoder(vid, cid, torch.bfloat16, device=device,
                      check_rule="minsum")
        ks = (bp_check_phase_generic, kernels.bp_var_totals_generic)
        n = 18 * 16
    else:
        base, vid, cid = make_qc_ldpc(12, 32, 3, 6, seed=7)
        dec = QCDecoder(base, 32, "bfloat16", device=device,
                        check_rule="minsum")
        ks = (bp_check_phase_qc, kernels.bp_var_pass_qc)
        n = 12 * 32
    word = rng.integers(0, 2, (B, n))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    llr = torch.from_numpy(
        (1 - 2 * word) * 2.5 + rng.normal(0, 1.0, word.shape)
        * np.linspace(0.4, 1.5, B)[:, None]).float()
    return dec, ks, llr, synd


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["generic", "dense"])
def test_the_late_read_on_the_card_equals_the_cpu(loop):
    """The flooding loop on the card, which reads each iteration's flags
    after the next iteration is enqueued, returns the CPU twin's (success,
    iters, final) bit for bit; each kernel launches once an iteration run,
    one iteration past the slowest frame's, and no more reads waited than
    ran."""
    need_cuda()
    dec, ks, llr, synd = _late_read_decoders(loop, "cuda")
    cpu_dec, _, _, _ = _late_read_decoders(loop, "cpu")
    n0 = [k.launches for k in ks]
    got = dec.decode_batch(llr, synd, 25)
    want = cpu_dec.decode_batch(llr, synd, 25)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    iters = got[1].cpu()
    assert bool(got[0].all()) and len(set(iters.tolist())) >= 4
    runs = dec.iterations_run
    assert runs == cpu_dec.iterations_run == int(iters.max()) + 2 < 25
    assert dec.overrun_iterations == cpu_dec.overrun_iterations == 1
    assert [k.launches - n for k, n in zip(ks, n0)] == [runs, runs]
    assert 0 <= dec.polls_waited <= runs
    assert cpu_dec.polls_waited == 0


# ------------------------------------ gather 2 (bp_var_totals_generic)

FOLD_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def fold_edges(seed, V, C, dv_max):
    """(e_to_v, e_to_c) in shuffled edge-id order: degrees 1 to dv_max
    (variable 0 at dv_max, variable 1 at 1), variable 3 with no edge."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, dv_max + 1, V)
    deg[0], deg[1], deg[3] = dv_max, 1, 0
    vid = np.repeat(np.arange(V), deg)
    cid = np.concatenate([rng.choice(C, d, replace=False) for d in deg])
    order = rng.permutation(vid.size)
    return vid[order], cid[order]


def fold_args(g, dtype, B, seed, offset=0):
    """(prior [V, B] f32, c2v [dc_max, C, B], table, degree) on the card:
    c2v zero on padded slots with a share of exact +-0, the prior rounded
    to ``dtype``; ``offset`` elements shift c2v off 16-byte alignment."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                           device="cuda")[:, :, None]
    c2v = 4.0 * torch.randn((g.dc_max, g.cnum, B), generator=gen,
                            device="cuda")
    pick = torch.rand(c2v.shape, generator=gen, device="cuda")
    c2v = torch.where(pick < 0.05, 0.0, torch.where(pick < 0.1, -0.0, c2v))
    c2v = (c2v * mask).to(dtype)
    if offset:
        buf = torch.empty(c2v.numel() + offset, dtype=dtype, device="cuda")
        buf[offset:] = c2v.reshape(-1)
        c2v = buf[offset:].view(c2v.shape)
    prior = 3.0 * torch.randn((g.vnum, B), generator=gen, device="cuda")
    prior = torch.where(torch.rand(prior.shape, generator=gen,
                                   device="cuda") < 0.1, -0.0, prior)
    tb = g.on("cuda")
    return (prior.to(dtype).float(), c2v, tb["v_from_c_T_i"], tb["dv_i"])


def assert_fold_equal(args):
    n0 = kernels.bp_var_totals_generic.launches
    got = kernels.bp_var_totals_generic(*args)
    assert kernels.bp_var_totals_generic.launches == n0 + 1
    want = kernels.bp_var_totals_generic_ref(*args)
    torch.cuda.synchronize()
    bits = FOLD_BITS[got.dtype]
    assert got.dtype == want.dtype == args[1].dtype
    assert torch.equal(got.view(bits), want.view(bits))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel_bit_equal_on_the_dvbs2_graph(dtype):
    """The exact DVB-S2 rate-1/2 H (degrees 8/3/2/1) at B = 128, 16 bytes
    of a row a thread."""
    need_cuda()
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.models.dvbs2 import (
        expanded_edges, make_table,
    )

    g = TannerGraph(*expanded_edges(make_table("1/2", seed=0)),
                    device="cuda")
    assert g.dv_max == 8 and int(g.dv.min()) == 1
    args = fold_args(g, dtype, 128, seed=11)
    assert_fold_equal(args)
    assert kernels.bp_var_totals_generic.vec == 16 // args[1].element_size()


# (dv_max, B, c2v offset): dv_max 13 (past one batch of 8 in flight), B = 1,
# B off 8 (the f32 path's 16 bytes still fit at 100, not at 37), unaligned
FOLD_SHAPES = [(13, 128, 0), (13, 1, 0), (13, 100, 0), (13, 37, 0),
               (13, 128, 1), (8, 64, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FOLD_SHAPES,
                         ids=["x".join(map(str, s)) for s in FOLD_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel_bit_equal_on_random_graphs(dtype, shape):
    need_cuda()
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph

    dv_max, B, offset = shape
    g = TannerGraph(*fold_edges(dv_max, 300, 120, dv_max), device="cuda")
    assert g.dv_max == dv_max and g.dv[3] == 0
    args = fold_args(g, dtype, B, seed=dv_max + B, offset=offset)
    assert_fold_equal(args)
    wide = 16 // args[1].element_size()
    aligned = offset == 0
    assert kernels.bp_var_totals_generic.vec == (
        wide if aligned and B % wide == 0 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [1.5, -1.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel_keeps_the_padded_slots_zero_sign(dtype, row0):
    """Every real message and prior -0: a variable with padded slots takes
    row 0's sign of zero (+0 for a positive row 0), one without keeps -0;
    the kernel as the plain version, at B = 8 (16 bytes a thread) and 3."""
    need_cuda()
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph

    edges = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (2, 2), (4, 3),
             (4, 1), (5, 0), (5, 1), (5, 2), (5, 3)]
    g = TannerGraph(*(np.array(x) for x in zip(*edges)), device="cuda")
    for B in (8, 3):
        mask = torch.as_tensor(g._c_mask_T_np, device="cuda")
        c2v = torch.full((g.dc_max, g.cnum, B), -0.0, device="cuda") \
            * mask[:, :, None].float()
        c2v[0, 0] = row0
        prior = torch.full((g.vnum, B), -0.0, device="cuda")
        tb = g.on("cuda")
        got = assert_fold_equal((prior, c2v.to(dtype), tb["v_from_c_T_i"],
                                 tb["dv_i"]))
        negative = torch.signbit(got.float()).all(dim=1).tolist()
        assert negative[1:] == [row0 < 0] * 4 + [True]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [
    (torch.bfloat16, dict(check_phi="tanhfb")), (torch.float32, dict())],
    ids=["bf16-tanhfb", "f32-phi"])
def test_generic_decode_with_the_fold_kernel_equals_the_plain_fold(dtype,
                                                                  kw):
    """50 iterations of the generic decoder on the exact DVB-S2 rate-1/2 H:
    the fold kernel against ``var_fold`` set to the plain version on the
    card, bit for bit on (done, iters, final), one launch an iteration."""
    need_cuda()
    from qamreconciliation_tpu_torch.models.dvbs2 import (
        expanded_edges, make_table,
    )

    vid, cid = expanded_edges(make_table("1/2", seed=0))
    rng = np.random.default_rng(6)
    B = 32
    word = rng.integers(0, 2, (B, 64800))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    sigma = np.linspace(0.75, 1.05, B)[:, None]
    llr = torch.from_numpy(
        2 * ((1 - 2 * word) + rng.normal(0, 1, word.shape) * sigma)
        / sigma ** 2).float()
    dec = Decoder(vid, cid, dtype, device="cuda", **kw)
    plain = Decoder(vid, cid, dtype, device="cuda", **kw)
    plain.var_fold = kernels.bp_var_totals_generic_ref
    n0, it0 = kernels.bp_var_totals_generic.launches, dec.iterations_run
    got = dec.decode_batch(llr, synd, 50)
    assert kernels.bp_var_totals_generic.launches - n0 \
        == dec.iterations_run - it0 == 50
    n1 = kernels.bp_var_totals_generic.launches
    want = plain.decode_batch(llr, synd, 50)
    assert kernels.bp_var_totals_generic.launches == n1
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bits = FOLD_BITS[dtype]
    assert torch.equal(got[2].contiguous().view(bits),
                       want[2].contiguous().view(bits))
    assert 0 < int(got[0].sum()) < B


@pytest.mark.cuda
def test_fold_kernel_rejects_what_it_does_not_take():
    need_cuda()
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph

    g = TannerGraph(*fold_edges(2, 60, 30, 5), device="cuda")
    prior, c2v, table, dv = fold_args(g, torch.bfloat16, 16, seed=2)
    fold = kernels.bp_var_totals_generic
    with pytest.raises(TypeError, match="float64"):
        fold(prior.double(), c2v.double(), table, dv)
    with pytest.raises(TypeError, match="sum dtype"):
        fold(prior.bfloat16(), c2v, table, dv)
    with pytest.raises(TypeError, match="int32"):
        fold(prior, c2v, table.long(), dv)
    with pytest.raises(TypeError, match="int32"):
        fold(prior, c2v, table, dv.long())
    with pytest.raises(ValueError, match="match"):
        fold(prior[:, :8].contiguous(), c2v, table, dv)
    with pytest.raises(ValueError, match="one device"):
        fold(prior.cpu(), c2v, table, dv)
    with pytest.raises(ValueError, match="contiguous"):
        fold(prior.t().contiguous().t(), c2v, table, dv)
    with pytest.raises(ValueError, match="contiguous"):
        fold(prior, c2v.transpose(1, 2).contiguous().transpose(1, 2), table,
             dv)


# ------------------------------------------------ the streaming batches


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("rule,dtype", [("minsum", torch.bfloat16),
                                        ("sumproduct", torch.float32)])
def test_qc_kernel_at_stream_batches(rule, dtype, B):
    """Kernel 1 at the headline check-phase shape [90, 6, 360, B] with the
    stream's batch (64) and a test batch (8)."""
    need_cuda()
    t, c2v, synd = (torch.from_numpy(a).cuda()
                    for a in make_inputs(41, (90, 6, 360, B),
                                         irregular=False))
    args = (t.to(dtype), c2v.to(dtype), synd)
    n0 = bp_check_phase_qc.launches
    got = bp_check_phase_qc(*args, rule=rule)
    assert bp_check_phase_qc.launches == n0 + 1
    want = bp_check_phase_qc_ref(*args, rule=rule)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_qc_kernel_at_the_dense_cell_shape():
    """Kernel 1 as the dense QC benchmark cell runs it: [90, 6, 360, 128],
    bf16 totals and messages, the phi rule; bit for bit on the messages'
    bit patterns and the violations."""
    need_cuda()
    t, c2v, synd = (torch.from_numpy(a).cuda()
                    for a in make_inputs(43, (90, 6, 360, 128),
                                         irregular=False))
    args = (t.to(torch.bfloat16), c2v.to(torch.bfloat16), synd)
    n0 = bp_check_phase_qc.launches
    got, gviol = bp_check_phase_qc(*args, rule="sumproduct")
    assert bp_check_phase_qc.launches == n0 + 1
    want, wviol = bp_check_phase_qc_ref(*args, rule="sumproduct")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(gviol, wviol)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_layered_decoder_at_the_layered_cell_shape():
    """The resident layered decoder as the benchmark cell
    ``qc36.layered-4.0dB`` runs it (z = 360, B = 128, bf16 min-sum, 4
    sweeps a call), bit for bit against the benchmark's plain reference
    on the card, with frames converging at staggered sweeps, frames
    running to the limit and one consistent prior; three device launches
    a call."""
    need_cuda()
    from rrbench import codes, decoders
    from rrbench.decoders import qc_layered
    from rrbench.ref import Precision

    code = codes.build({"kind": "qc_ldpc", "nb_v": 180, "z": 360, "dv": 3,
                        "dc": 6, "seed": 12345})
    spec = {"kind": "qc_layered", "check_rule": "minsum",
            "minsum_alpha": 0.8125, "minsum_beta": 0.0, "chunk": 4}
    B, maxiter = 128, 50
    g = torch.Generator().manual_seed(29)
    word = torch.randint(0, 2, (code.vnum, B), generator=g,
                         dtype=torch.int32)
    sigma = torch.linspace(0.6, 1.6, B)
    prior = (1 - 2 * word).float() + sigma * torch.randn(
        (code.vnum, B), generator=g)
    prior[:, 0] = 2.0 * (1 - 2 * word[:, 0]).float()
    prior = prior.to(torch.bfloat16).cuda()
    synd = decoders.syndrome(code, word).cuda()
    dec = qc_layered.program(code, spec, "bfloat16", "cuda")
    calls = []
    step = dec.sweeps_step

    def counted(*args, **kw):
        calls.append(kw["k_sweeps"])
        return step(*args, **kw)
    dec.sweeps_step = counted
    n0 = bp_layered_sweeps_qc.launches
    d0 = bp_layered_sweeps_qc.device_launches
    got = dec.decode_batched(prior, synd, maxiter)
    want = qc_layered.Reference(code, spec, Precision("bfloat16"),
                                "cuda").decode(prior, synd, maxiter)
    torch.cuda.synchronize()
    assert bp_layered_sweeps_qc.launches - n0 == len(calls) > 0
    assert bp_layered_sweeps_qc.device_launches - d0 == 3 * len(calls)
    success, iters = got[0].cpu(), got[1].cpu()
    assert bool(success[0]) and int(iters[0]) == 0
    assert len(set(iters[success].tolist())) >= 3
    assert not bool(success.all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_resident_minsum_decoder_at_the_cell_widths():
    """Kernel 2's min-sum instance as the benchmark cell
    ``qc36.minsum-3.5dB`` runs it (z = 360, N = 64800, bf16, alpha 13/16,
    50 steps a call), at B = 8, bit for bit against the benchmark's plain
    reference on the card, with frames converging at staggered steps,
    frames running to the limit and one consistent prior."""
    need_cuda()
    from rrbench import codes, decoders
    from rrbench.decoders import qc_resident_minsum
    from rrbench.ref import Precision

    code = codes.build({"kind": "qc_ldpc", "nb_v": 180, "z": 360, "dv": 3,
                        "dc": 6, "seed": 12345})
    spec = {"kind": "qc_resident_minsum", "check_rule": "minsum",
            "minsum_alpha": 0.8125, "minsum_beta": 0.0, "chunk": 50}
    B, maxiter = 8, 50
    g = torch.Generator().manual_seed(31)
    word = torch.randint(0, 2, (code.vnum, B), generator=g,
                         dtype=torch.int32)
    sigma = torch.linspace(0.5, 1.3, B)
    prior = (1 - 2 * word).float() + sigma * torch.randn(
        (code.vnum, B), generator=g)
    prior[:, 0] = 2.0 * (1 - 2 * word[:, 0]).float()
    prior = prior.to(torch.bfloat16).cuda()
    synd = decoders.syndrome(code, word).cuda()
    dec = qc_resident_minsum.program(code, spec, "bfloat16", "cuda")
    rules = []
    step = dec.rounds_step

    def recorded(*args, **kw):
        rules.append(kw["rule"])
        return step(*args, **kw)
    dec.rounds_step = recorded
    n0 = bp_decode_rounds_qc.launches
    got = dec.decode_batched(prior, synd, maxiter)
    want = qc_resident_minsum.Reference(
        code, spec, Precision("bfloat16"), "cuda").decode(prior, synd,
                                                          maxiter)
    torch.cuda.synchronize()
    assert rules == ["minsum"]
    assert bp_decode_rounds_qc.launches - n0 == 1
    success, iters = got[0].cpu(), got[1].cpu()
    assert bool(success[0]) and int(iters[0]) == 0
    assert len(set(iters[success].tolist())) >= 3
    assert not bool(success.all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int16), want[2].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("rule,m_dtype", [("minsum", torch.bfloat16),
                                          ("tanhfb", torch.bfloat16),
                                          ("sumproduct", torch.float32)])
@pytest.mark.parametrize("kernel", ["rounds", "sweeps"])
def test_resident_kernels_at_stream_batches(kernel, rule, m_dtype, B):
    """Kernels 2 and 3 at B = 8 and 64 (fewer blocks than SMs), bit for
    bit on all four state tensors after plain steps."""
    need_cuda()
    rows, z = STEP_CODES["regular"]
    tables = QCTables(rows, z)
    layered = kernel == "sweeps"
    warm = [x.cuda() for x in step_state(tables, m_dtype, m_dtype, 11,
                                         layered, B=B)]
    if layered:
        bp_layered_sweeps_qc_ref(tables, 0, 50, *warm, rule=rule, k_sweeps=1)
    else:
        bp_decode_rounds_qc_ref(tables, 0, 50, *warm, rule=rule, k_rounds=2)
    state = [x.clone() for x in warm]
    run_pair(kernel, tables, state, warm, rule, 1 if layered else 2, 50, 6)
    assert (bp_layered_sweeps_qc if layered else bp_decode_rounds_qc
            ).plan.grid == B
    assert_state_equal(state, warm)


@pytest.mark.cuda
@pytest.mark.parametrize("rule,dtype", [("minsum", torch.bfloat16),
                                        ("sumproduct", torch.float32)])
def test_generic_kernel_at_the_stream_batch(rule, dtype):
    """Kernel 4 at the DVB-S2 rate-1/2 check-phase shape [7, 32400, 64]."""
    need_cuda()
    t, c2v, synd, mask = (torch.from_numpy(a).cuda()
                          for a in generic_inputs(43, 7, 32400, 64))
    args = (t.to(dtype), c2v.to(dtype), synd, mask)
    got = bp_check_phase_generic(*args, rule=rule)
    want = bp_check_phase_generic_ref(*args, rule=rule)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _stream_run(dec, mat, plain=None, frames=10, batch=4):
    """stream_fused of ``dec`` on the card over misaligned chunks of a
    numpy-seeded 4-PAM stream at 3.5 dB; ``plain`` replaces the decoder's
    check phase."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
    from qamreconciliation_tpu_torch.sims.streaming import StreamReconciler

    if plain is not None:
        dec.check_phase = plain
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10 ** (-3.5 / 10) / 2
    nm = NoiseMapper(pa, N0, dtype=dec.dtype, device="cuda")
    S = mat.vnum // 2
    rng = np.random.default_rng(6)
    x = rng.integers(0, 4, frames * S)
    y = pa.constellation[x] + np.sqrt(N0) * rng.standard_normal(x.size)
    cut = int(1.7 * S)
    chunks = range(0, x.size, cut)
    return StreamReconciler(dec, mat, pa, nm, batch=batch).stream_fused(
        [y[a:a + cut] for a in chunks], [x[a:a + cut] for a in chunks], 20)


def _same_stream(a, b):
    assert (a.frames, a.success, a.iterations, a.bit_errors) == \
        (b.frames, b.success, b.iterations, b.bit_errors)
    assert all(np.array_equal(u, v) for u, v in
               zip(a.decoded_words, b.decoded_words))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_fused_on_the_card_equals_the_plain_check_phase(dtype):
    """The fused stream driver on the card: the dense QC decoder through
    kernel 1 == through its plain check phase; the resident decoder
    (kernel 2) == dense, the resident layered one (kernel 3) == the serial
    plain layered loop, in min-sum; the generic decoder through kernel 4
    == through its plain check phase."""
    need_cuda()
    base, vid, cid = make_qc_ldpc(12, 32, 3, 6, seed=7)
    mat = Matrix(vid, cid)
    kw = dict(dtype=dtype, device="cuda", check_rule="minsum")
    n0 = bp_check_phase_qc.launches
    dense = _stream_run(QCDecoder(base, 32, **kw), mat)
    assert bp_check_phase_qc.launches > n0
    assert 0 < sum(dense.success) < dense.frames
    _same_stream(dense, _stream_run(QCDecoder(base, 32, **kw), mat,
                                    plain=bp_check_phase_qc_ref))
    n0 = bp_decode_rounds_qc.launches
    _same_stream(dense, _stream_run(QCDecoder(
        base, 32, resident=True, resident_chunk=6, **kw), mat))
    assert bp_decode_rounds_qc.launches > n0
    n0 = bp_layered_sweeps_qc.launches
    lay = _stream_run(QCDecoder(base, 32, schedule="layered",
                                resident=True, **kw), mat)
    assert bp_layered_sweeps_qc.launches > n0
    _same_stream(lay, _stream_run(QCDecoder(
        base, 32, schedule="layered", layered_groups=False, **kw), mat))
    n0 = bp_check_phase_generic.launches
    gen = _stream_run(Decoder(vid, cid, **kw), mat)
    assert bp_check_phase_generic.launches > n0
    _same_stream(gen, _stream_run(Decoder(vid, cid, **kw), mat,
                                  plain=bp_check_phase_generic_ref))


# --------------------------------------------------------------------- #
# The attribution probes' kernels: kernel 6 (check_math_probe, the QC check
# phase's memory pattern with the probe's slot maths, on warp-specialised
# tiles of its own) and kernel 7 (elementwise_chain, the packed-bf16
# chain), bit for bit

PROBE_MATHS = ["phi", "copy", "minsum"]
PROBE_DTYPES = [torch.float32, torch.bfloat16]
# shape -> the path its plan takes in (f32, bf16): the probe's shape; z off
# the tile, B = 40 on the bulk path; B = 37 (and 100 and 300 in bf16) on
# the thread path; B = 300 past one tile's frames (f32: per-row bulk
# copies); rows wider than the register slots (dc 12) on the scratch
PROBE_TILE_SHAPES = {(18, 6, 1800, 128): ("bulk", "bulk"),
                     (3, 6, 70, 40): ("bulk", "bulk"),
                     (3, 6, 70, 37): ("thread", "thread"),
                     (2, 6, 21, 300): ("bulk", "thread"),
                     (18, 6, 64, 100): ("bulk", "thread"),
                     (3, 12, 70, 40): ("bulk", "bulk")}


def probe_inputs(shape, dtype, offset=0):
    """t, c2v and synd on the card, with tied magnitudes in half the frames
    (integer-valued t, zero c2v); t and c2v start ``offset`` elements into
    their buffers (an unaligned view when not 0)."""
    t, c2v, synd = make_inputs(31, shape, irregular=False)
    half = shape[-1] // 2
    t[..., :half] = np.round(t[..., :half])
    c2v[..., :half] = 0.0

    def at(a):
        flat = torch.zeros(a.size + offset, dtype=dtype, device="cuda")
        flat[offset:] = torch.from_numpy(a.reshape(-1)).to("cuda", dtype)
        return flat[offset:].view(shape)

    return at(t), at(c2v), torch.from_numpy(synd).cuda()


def test_probe_kernels_on_cpu_tensors_run_their_plain_versions():
    t, c2v, synd = (torch.from_numpy(a)
                    for a in make_inputs(5, (3, 6, 10, 5), irregular=False))
    n6, n7 = kernels.check_math_probe.launches, \
        kernels.elementwise_chain.launches
    for math_ in PROBE_MATHS:
        got = kernels.check_math_probe(t, c2v, synd, math_)
        want = kernels.check_math_probe_ref(t, c2v, synd, math_)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    x = t.reshape(-1)
    assert torch.equal(kernels.elementwise_chain(x, "exp", 2, 3),
                       kernels.elementwise_chain_ref(x, "exp", 2, 3))
    assert kernels.check_math_probe.launches == n6
    assert kernels.elementwise_chain.launches == n7


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PROBE_TILE_SHAPES),
                         ids=["x".join(map(str, s)) for s in PROBE_TILE_SHAPES])
@pytest.mark.parametrize("dtype", PROBE_DTYPES)
@pytest.mark.parametrize("math_", PROBE_MATHS)
def test_check_math_probe_kernel_bit_equal(math_, dtype, shape):
    """Kernel 6 on its paths: out and the violation counts bit for bit,
    with tied magnitudes in half the frames; the plan that of
    probe_tile_plan, on the path and slots each shape takes."""
    need_cuda()
    args = probe_inputs(shape, dtype)
    n0 = kernels.check_math_probe.launches
    got, gviol = kernels.check_math_probe(*args, math_)
    assert kernels.check_math_probe.launches == n0 + 1
    want, wviol = kernels.check_math_probe_ref(*args, math_)
    torch.cuda.synchronize()
    assert got.dtype == dtype and gviol.dtype == torch.int32
    assert torch.equal(gviol, wviol)
    assert torch.equal(got, want)
    nb_c, dc, z, B = shape
    plan = kernels.check_math_probe.plan
    assert plan == kernels.probe_tile_plan(
        nb_c, dc, z, B, args[0].element_size(), math_,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.path == PROBE_TILE_SHAPES[shape][dtype == torch.bfloat16]
    assert plan.slots == ("none" if math_ == "copy" else
                          "registers" if plan.path == "bulk" and dc <= 8
                          else "scratch")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PROBE_DTYPES)
@pytest.mark.parametrize("math_", PROBE_MATHS)
def test_check_math_probe_kernel_unaligned_view(math_, dtype):
    """t and c2v one element into their buffers: a shape whose rows line
    up takes the thread path, bit for bit."""
    need_cuda()
    shape = (3, 6, 70, 40)
    args = probe_inputs(shape, dtype, offset=1)
    got, gviol = kernels.check_math_probe(*args, math_)
    want, wviol = kernels.check_math_probe_ref(*args, math_)
    torch.cuda.synchronize()
    assert kernels.check_math_probe.plan.path == "thread"
    assert torch.equal(gviol, wviol) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(stages=5), dict(stages=1), dict(checks=3), dict(smem_delta=16),
    dict(blocks_per_sm=5), dict(slots="scratch"), dict(path="thread"),
    dict(threads=256),
], ids=["stages 5", "stages 1", "checks", "smem", "blocks 5",
        "scratch at dc 6", "thread with a ring", "no producer"])
def test_check_math_probe_launch_refuses_a_plan_beyond_its_limits(
        monkeypatch, change):
    """Kernel 6's launch holds the plan to its own layout and limits."""
    need_cuda()
    plan_fn = kernels.probe_tile_plan

    def altered(*args, **kw):
        plan = plan_fn(*args, **kw)
        return dataclasses.replace(
            plan, smem=plan.smem + change.get("smem_delta", 0),
            **{k: v for k, v in change.items() if k != "smem_delta"})

    monkeypatch.setattr(kernels, "probe_tile_plan", altered)
    args = probe_inputs((3, 6, 70, 40), torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.check_math_probe(*args, "phi")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512 * 1024, 1001])
@pytest.mark.parametrize("dtype", PROBE_DTYPES)
@pytest.mark.parametrize("mode", ["mac", "exp"])
def test_elementwise_chain_kernel_bit_equal(mode, dtype, n):
    """Kernel 7 bit for bit: whole 16-byte groups and a ragged tail, and an
    unaligned view (every element on the one-element path)."""
    need_cuda()
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 2, n)).to(
        "cuda", dtype)
    for xx in (x, x[1:]):
        n0 = kernels.elementwise_chain.launches
        got = kernels.elementwise_chain(xx, mode, 3, 16)
        assert kernels.elementwise_chain.launches == n0 + 1
        want = kernels.elementwise_chain_ref(xx, mode, 3, 16)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_probe_kernels_reject_what_they_do_not_take():
    need_cuda()
    t = torch.zeros(2, 6, 8, 4, device="cuda")
    synd = torch.zeros(2, 8, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        kernels.check_math_probe(t, t.bfloat16(), synd, "copy")
    with pytest.raises(TypeError):
        kernels.check_math_probe(t.double(), t.double(), synd, "copy")
    with pytest.raises(ValueError):
        kernels.check_math_probe(t, t, synd, "tanhfb")
    with pytest.raises(TypeError):
        kernels.elementwise_chain(t.double(), "mac", 1, 1)
    with pytest.raises(ValueError):
        kernels.elementwise_chain(t.transpose(0, 3), "mac", 1, 1)


# --------------------------------------------------------------------- #
# The last probes' kernels: kernel 8 (smem_ceiling_probe, a shared-memory
# scratch of N bytes) and kernel 9 (resident_bookkeeping_probe, kernel 2's
# min-sum check pass in four bookkeeping variants), bit for bit

BOOK_VARIANTS = list(kernels.BOOKKEEPING_VARIANTS)
# z off the warp with 5 frames; B past one block an SM (130); the frame's
# totals too large for shared memory (z = 3200: 230 KB in bf16); the
# probe's width with z not a multiple of 8 (1804).  The c2v rows of z = 64
# and 3200 take the TMA ring (bulk path), those of z = 37 and 1804 the
# direct loads (thread path).
BOOK_SHAPES = [(36 * 37, 5), (36 * 64, 130), (36 * 3200, 3), (36 * 1804, 8)]
BOOK_PATHS = {37: "thread", 64: "bulk", 3200: "bulk", 1804: "thread"}


def test_probe_kernels_8_9_on_cpu_tensors_run_their_plain_versions():
    from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (8, 128))
                         .astype(np.float32))
    n8, n9 = kernels.smem_ceiling_probe.launches, \
        kernels.resident_bookkeeping_probe.launches
    assert torch.equal(kernels.smem_ceiling_probe(x, 65536),
                       kernels.smem_ceiling_probe_ref(x, 65536))
    tables = P.code_tables(36 * 8)
    for variant in BOOK_VARIANTS:
        got = P.mixed_state(tables, 6, 3, "cpu")
        want = [t.clone() for t in got]
        kernels.resident_bookkeeping_probe(tables, 1, 9, *got,
                                           variant=variant, k_rounds=3)
        kernels.resident_bookkeeping_probe_ref(tables, 1, 9, *want,
                                               variant=variant, k_rounds=3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.smem_ceiling_probe.launches == n8
    assert kernels.resident_bookkeeping_probe.launches == n9


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", BOOK_SHAPES,
                         ids=[f"z{n // 36}xB{B}" for n, B in BOOK_SHAPES])
@pytest.mark.parametrize("variant", BOOK_VARIANTS)
def test_resident_bookkeeping_probe_kernel_bit_equal(variant, n, B):
    """Kernel 9 bit for bit on all eight state tensors from a state whose
    frames converge at the first step, later and never (it0 = 1, K = 5),
    the frame's totals in shared memory and (z = 3200) in device memory, on
    the path its plan takes for each z."""
    need_cuda()
    from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

    tables = P.code_tables(n)
    got = P.mixed_state(tables, B, 5, "cuda")
    want = [t.clone() for t in got]
    n0 = kernels.resident_bookkeeping_probe.launches
    kernels.resident_bookkeeping_probe(tables, 1, 10 ** 6, *got,
                                       variant=variant, k_rounds=5)
    assert kernels.resident_bookkeeping_probe.launches == n0 + 1
    plan = kernels.resident_bookkeeping_probe.plan
    assert plan.totals == ("global" if tables.z == 3200 else "shared")
    assert plan.path == BOOK_PATHS[tables.z]
    kernels.resident_bookkeeping_probe_ref(tables, 1, 10 ** 6, *want,
                                           variant=variant, k_rounds=5)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(stages=5), dict(stages=1), dict(rows=5), dict(lanes=3),
    dict(smem_delta=16), dict(blocks_per_sm=17), dict(path="thread"),
    dict(path="bulk", z=37),
], ids=["stages 5", "stages 1", "rows", "lanes", "smem", "blocks 17",
        "thread with a ring", "bulk at z 37"])
def test_bookkeeping_launch_refuses_a_plan_beyond_its_limits(monkeypatch,
                                                             change):
    """Kernel 9's launch holds the plan to its own layout and limits: a
    ring deeper than 4 stages or of one, stages too short for a check
    block, lanes that do not cover z, a shared-memory size other than the
    layout's, more blocks an SM than registers allow, the thread path with
    a ring, the bulk path where z is not a multiple of 8."""
    need_cuda()
    from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

    plan_fn = kernels.staged_rows_plan

    def altered(*args, **kw):
        plan = plan_fn(*args, **kw)
        return dataclasses.replace(
            plan, smem=plan.smem + change.get("smem_delta", 0),
            **{k: v for k, v in change.items()
               if k not in ("smem_delta", "z")})

    monkeypatch.setattr(kernels, "staged_rows_plan", altered)
    tables = P.code_tables(36 * change.get("z", 64))
    state = P.mixed_state(tables, 8, 1, "cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.resident_bookkeeping_probe(tables, 0, 5, *state)


@pytest.mark.cuda
def test_smem_ceiling_probe_kernel_up_to_the_limit():
    """Kernel 8 bit for bit from the least scratch to the opt-in limit
    (through the 48 KB static limit); past the limit the card refuses, and
    the refusal leaves no error behind."""
    need_cuda()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 2, (8, 128))
                         .astype(np.float32)).cuda()
    for nbytes in (8192, 48 * 1024, 48 * 1024 + 512, optin):
        n0 = kernels.smem_ceiling_probe.launches
        got = kernels.smem_ceiling_probe(x, nbytes)
        assert kernels.smem_ceiling_probe.launches == n0 + 1
        want = kernels.smem_ceiling_probe_ref(x, nbytes)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with pytest.raises(kernels.SharedMemoryRefused) as e:
        kernels.smem_ceiling_probe(x, optin + 512)
    assert e.value.name == "cudaErrorInvalidValue"
    assert torch.equal(x + x, 2 * x)


@pytest.mark.cuda
def test_smem_ceiling_probe_kernel_descending_after_a_grant():
    """Once the opt-in limit is granted, smaller sizes launch without the
    attribute call, bit for bit; past the limit the card still refuses,
    and the sizes granted before still run."""
    need_cuda()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 2, (8, 128))
                         .astype(np.float32)).cuda()
    grants = kernels._SMEM_PROBE_GRANTS
    kernels.smem_ceiling_probe(x, optin)
    assert not grants.needs(0, optin)
    for nbytes in (optin - 512, 160 * 1024, 48 * 1024, 8192):
        assert not grants.needs(0, nbytes)
        got = kernels.smem_ceiling_probe(x, nbytes)
        want = kernels.smem_ceiling_probe_ref(x, nbytes)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with pytest.raises(kernels.SharedMemoryRefused) as e:
        kernels.smem_ceiling_probe(x, optin + 1024)
    assert e.value.name == "cudaErrorInvalidValue"
    assert grants.granted[0] == optin
    assert torch.equal(kernels.smem_ceiling_probe(x, optin),
                       kernels.smem_ceiling_probe_ref(x, optin))


@pytest.mark.cuda
def test_last_probe_kernels_reject_what_they_do_not_take():
    need_cuda()
    from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

    x = torch.ones(8, 128, device="cuda")
    with pytest.raises(ValueError):
        kernels.smem_ceiling_probe(x, 8192 + 100)
    with pytest.raises(ValueError):
        kernels.smem_ceiling_probe(x.t().contiguous(), 8192)
    tables = P.code_tables(36 * 8)
    state = list(P.mixed_state(tables, 4, 1, "cuda"))
    bad_synd = list(state)
    bad_synd[3] = state[3].int()
    with pytest.raises(TypeError):
        kernels.resident_bookkeeping_probe(tables, 0, 9, *bad_synd)
    bad_total = list(state)
    bad_total[0] = state[0].float()
    with pytest.raises(TypeError):
        kernels.resident_bookkeeping_probe(tables, 0, 9, *bad_total)
    strided = list(state)
    strided[1] = state[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        kernels.resident_bookkeeping_probe(tables, 0, 9, *strided)


# --------------------------------------------------------------------- #
# The softening inputs (csrc/softening_inputs.cu) against their plain
# version, bit for bit, and their launches on the main path

SOFT_ALT = [0, 1] * 8


def soft_round(bps, dtype, S, B, snr, seed, planted=True):
    """The symbols, samples and bit table of a round drawn as the engine
    draws them, with 1 sample in 32 set to an interior threshold or a
    constellation point."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import bf16_normal

    pa = PAMAlphabet(bps, 2.0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = pa.random_symbols(gen, (S, B), "cuda")
    sigma = float(np.sqrt(pa.variance * 10 ** (-snr / 10) / 2))
    noise = (bf16_normal(gen, (S, B), "cuda") if dtype == torch.bfloat16
             else torch.randn((S, B), generator=gen, device="cuda",
                              dtype=dtype))
    y = pa.index_to_value(x, dtype) + torch.tensor(sigma, dtype=dtype) * noise
    if planted:
        spots = torch.tensor([float(t) for t in pa.thresholds[1:-1]]
                             + list(pa.constellation), dtype=dtype,
                             device="cuda")
        pick = torch.randint(0, spots.numel(), (S, B), generator=gen,
                             device="cuda")
        y = torch.where(torch.rand((S, B), generator=gen, device="cuda")
                        < 1 / 32, spots[pick], y)
    s2b = torch.as_tensor(pa.s_to_b.astype(np.int32), device="cuda")
    return pa, x, y.contiguous(), s2b


def soft_mapper(pa, snr, signs, dtype):
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper

    return NoiseMapper(pa, pa.variance * 10 ** (-snr / 10) / 2, signs,
                       dtype=dtype, device="cuda")


def soft_equal(nm, x, y, alpha, s2b):
    got = kernels.softening_inputs(nm, x, y, alpha, s2b)
    want = kernels.softening_inputs_ref(nm, x, y, alpha, s2b)
    torch.cuda.synchronize()
    bits = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[0].view(bits), want[0].view(bits)), \
        int((got[0].view(bits) != want[0].view(bits)).sum())
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("signs", [None, SOFT_ALT], ids=["zeros", "alt"])
@pytest.mark.parametrize("snr", [3.5, 4.0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_softening_inputs_kernel_bit_equal_at_the_cells_shape(dtype, snr,
                                                               signs):
    need_cuda()
    for r in range(4):
        pa, x, y, s2b = soft_round(2, dtype, 32400, 128, snr, 100 + r)
        nm = soft_mapper(pa, snr, signs, dtype)
        for alpha in ((1.0, 0.8) if r == 0 else (1.0,)):
            soft_equal(nm, x, y, alpha, s2b)
            assert kernels.softening_inputs.vec == 16 // y.element_size()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(333, 37), (5, 8), (64, 24), "unaligned"],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_softening_inputs_kernel_bit_equal_on_ragged_shapes(bps, dtype,
                                                             shape):
    need_cuda()
    S, B = (97, 128) if shape == "unaligned" else shape
    pa, x, y, s2b = soft_round(bps, dtype, S, B, 12.0 if bps == 4 else 4.0,
                               7 * bps + S)
    if shape == "unaligned":
        xb = torch.empty(S * B + 1, dtype=x.dtype, device="cuda")[1:]
        yb = torch.empty(S * B + 1, dtype=y.dtype, device="cuda")[1:]
        x = xb.view(S, B).copy_(x)
        y = yb.view(S, B).copy_(y)
    nm = soft_mapper(pa, 4.0, SOFT_ALT[:pa.order], dtype)
    soft_equal(nm, x, y, 0.7, s2b)
    wide = 16 // y.element_size()
    assert kernels.softening_inputs.vec == (
        wide if shape != "unaligned" and B % wide == 0 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("snr", [3.5, 4.0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bps", [3, 4])
def test_softening_inputs_kernel_bit_equal_at_eight_and_sixteen_levels(
        bps, dtype, snr):
    """8- and 16-PAM at low SNR, each at its own variance, a code of 64800
    bits: most erf terms lie inside (0, p), so the order in which the M
    terms are summed shows in the LLRs."""
    need_cuda()
    for r in range(2):
        pa, x, y, s2b = soft_round(bps, dtype, 64800 // bps, 128, snr,
                                   300 + 10 * bps + r)
        nm = soft_mapper(pa, snr, SOFT_ALT[:pa.order] if r else None, dtype)
        soft_equal(nm, x, y, 1.0 if r else 0.75, s2b)


@pytest.mark.cuda
def test_softening_inputs_launch_once_a_softening_round():
    need_cuda()
    base, vid, cid = make_qc_ldpc(24, 16, 3, 6, seed=5)
    dec = QCDecoder(base, 16, "bfloat16", device="cuda")
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

    eng = ReconciliationEngine(dec, Matrix(vid, cid), PAMAlphabet(2, 2.0),
                               batch=8, dtype="bfloat16",
                               rounds_per_dispatch=2)
    for mode, rounds in (("softening", 6), ("hard", 0)):
        n0 = kernels.softening_inputs.launches
        res = eng.run_point(mode, 3.5, 12, 48, 49, nmconfig=[0, 0, 0, 0],
                            seed=2 ** 31 + 9)
        assert res.frames == 48
        assert kernels.softening_inputs.launches - n0 == rounds, mode
    # the point's set-up built the table on the card
    nm = eng.make_noisemapper(3.5, [0, 1, 0, 1])
    assert nm._softening_tab is not None and nm._softening_tab.is_cuda


@pytest.mark.cuda
def test_softening_inputs_refuse_what_they_do_not_take_on_the_card():
    need_cuda()
    pa, x, y, s2b = soft_round(2, torch.float32, 64, 16, 4.0, 3)
    nm64 = soft_mapper(pa, 4.0, None, torch.float64)
    with pytest.raises(TypeError):
        kernels.softening_inputs(nm64, x, y.double(), 1.0, s2b)
    nm = soft_mapper(pa, 4.0, None, torch.float32)
    with pytest.raises(ValueError):
        kernels.softening_inputs(nm, x.t().contiguous().t(),
                                 y.t().contiguous().t(), 1.0, s2b)
    with pytest.raises(ValueError):
        kernels.softening_inputs(nm, x.cpu(), y, 1.0, s2b)
