"""Hand-written CUDA kernels of the BP hot loop, with their plain versions.

Five wrappers of the decoders' kernels, each replacing a Pallas TPU kernel of
``qamreconciliation_tpu/ops/pallas_kernels.py``:

* ``bp_check_phase_qc`` (``csrc/bp_check_phase_qc.cu``): the fused check
  phase of the dense QC flooding decoder;
* ``bp_decode_rounds_qc`` (``csrc/bp_decode_rounds_qc.cu``): K flooding
  iterations per call over the flat decode state (the resident decoder);
* ``bp_layered_sweeps_qc`` (``csrc/bp_layered_sweeps_qc.cu``): K serial-C
  layered sweeps per call (the resident layered decoder);
* ``bp_check_phase_generic`` (``csrc/bp_check_phase_generic.cu``): the
  fused check phase of the generic decoder, slot-major and masked;
* ``check_node_update_fused`` (a second kernel in the same source): the
  check-major phi check update of the JAX package's
  ``check_node_update_pallas``, in float32 or bfloat16;

three for steps that the JAX package leaves to XLA:

* ``bp_var_totals_generic`` (``csrc/bp_var_totals_generic.cu``): gather 2,
  each variable's new totals folded from its real edges' messages;
* ``bp_var_pass_qc`` (the same source's QC entry): the dense QC decoder's
  variable pass, the same fold plus the prior, its totals also written into
  the check phase's next input;
* ``softening_inputs`` (``csrc/softening_inputs.cu``): a softening round's
  hard decision, softening metric, word and poly LLRs in one pass;

and four more replacing the Pallas kernels of the JAX package's probes
(``scripts/``):

* ``check_math_probe`` (``csrc/check_math_probe.cu``): kernel 1's memory
  pattern with ``probe_check_math.py``'s slot maths (phi, copy, its
  min-sum), on warp-specialised staged tiles of its own;
* ``elementwise_chain`` (``csrc/elementwise_chain.cu``): the chain of
  ``probe_bf16pack.py`` in float32 or packed bfloat16;
* ``smem_ceiling_probe`` (``csrc/smem_ceiling_probe.cu``): the copy kernel
  of ``probe_vmem.py`` with an N-byte shared-memory scratch;
* ``resident_bookkeeping_probe`` (``csrc/resident_bookkeeping_probe.cu``):
  ``probe_resident_vmem.py``'s K min-sum flooding iterations in four
  bookkeeping variants.

A tensor on the CPU goes to the plain PyTorch version (``*_ref``), which
uses the kernel's operation and summation order; a CUDA tensor goes to the
kernel, or the call raises.  Each wrapper counts its kernel launches in
``.launches``; the three multi-step wrappers also count the BP iterations or
sweeps they ran on the device in ``.iterations``, and the device kernels
their calls launched (the copies of the state in and out included) in
``.device_launches``.  The multi-step kernels
update their state tensors in place (the plain versions too) and return
them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.trace import span
from .boxplus import (
    BIG, MINSUM_ALPHA, minsum_extrinsic_mag, minsum_mag, phi_llr,
    tanhfb_extrinsic_mag,
)

__all__ = [
    "RULES", "MAX_DC", "GENERIC_BLOCK_C", "QCTables", "layered_levels",
    "TilePlan", "check_tile_plan", "tile_smem",
    "CheckMajorPlan", "check_major_plan", "check_major_smem",
    "ResidentPlan", "resident_plan", "resident_smem",
    "bp_check_phase_qc", "bp_check_phase_qc_ref",
    "bp_decode_rounds_qc", "bp_decode_rounds_qc_ref",
    "bp_layered_sweeps_qc", "bp_layered_sweeps_qc_ref",
    "bp_check_phase_generic", "bp_check_phase_generic_ref",
    "check_node_update_fused", "check_node_update_fused_ref",
    "var_totals_vec", "bp_var_totals_generic", "bp_var_totals_generic_ref",
    "VAR_PASS_DTYPES", "bp_var_pass_qc", "bp_var_pass_qc_ref",
    "SOFTENING_DTYPES", "SOFTENING_ORDERS", "softening_takes",
    "softening_table_size", "softening_inputs", "softening_inputs_ref",
    "SmemGrants", "PROBE_MATHS", "ProbeTilePlan", "probe_tile_plan",
    "probe_tile_smem", "probe_instance", "check_math_probe",
    "check_math_probe_ref",
    "CHAIN_MODES", "elementwise_chain", "elementwise_chain_ref",
    "SharedMemoryRefused", "smem_ceiling_probe", "smem_ceiling_probe_ref",
    "empty_launch",
    "BOOKKEEPING_VARIANTS", "StagedRowsPlan", "staged_rows_plan",
    "staged_rows_smem", "resident_bookkeeping_probe",
    "resident_bookkeeping_probe_ref",
]

# magnitude rules, in the kernels' numbering
RULES = {"sumproduct": 0, "tanhfb": 1, "minsum": 2}
# widest check row the kernels take (a row's sign bits fill one word)
MAX_DC = 32


def _spanned(entry):
    """A kernel's entry, each call inside the profiler span
    ``rr.kernel.<name>`` (:func:`~qamreconciliation_tpu_torch.utils.trace.
    span`), on the card and on the CPU alike."""
    name = f"rr.kernel.{entry.__name__}"

    @functools.wraps(entry)
    def call(*args, **kw):
        with span(name):
            return entry(*args, **kw)
    return call


# (totals dtype, message dtype) pairs the kernels take, in their numbering
_KERNEL_DTYPES = {
    (torch.float32, torch.float32): (0, 0),
    (torch.bfloat16, torch.bfloat16): (1, 1),
    (torch.float32, torch.bfloat16): (0, 1),
}


def _fold_sum(x, dim: int):
    """Left-fold sum over ``dim`` (keepdim): ``((x0 + x1) + x2) + ...``,
    the order the kernels and the JAX package's reduction use."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.unsqueeze(dim)


def _check_messages(v2c, synd, dim: int, rule: str, tiny: float,
                    ms_alpha: float, ms_beta: float):
    """New check->variable messages from ``v2c`` (slots along ``dim``) and
    the syndrome (``v2c``'s shape without ``dim``): the rule's all-but-one
    magnitude, the XOR sign parity and the ``(1 - 2*synd)`` prefactor, in
    ``v2c``'s dtype."""
    absm = torch.abs(v2c)
    if rule == "minsum":
        mag = minsum_mag(minsum_extrinsic_mag(absm, dim), ms_alpha, ms_beta)
    elif rule == "tanhfb":
        mag = tanhfb_extrinsic_mag(absm, dim)
    else:
        phim = phi_llr(absm, tiny)
        mag = phi_llr(_fold_sum(phim, dim) - phim, tiny)
    return _signed(v2c, synd, dim, mag)


def _signed(v2c, synd, dim: int, mag):
    """``mag`` times the XOR sign parity of ``v2c`` over ``dim`` and the
    ``(1 - 2*synd)`` prefactor, in ``v2c``'s dtype."""
    neg = (v2c < 0).to(torch.int32)
    par = torch.sum(neg, dim=dim, keepdim=True) & 1
    sign = (1 - 2 * torch.bitwise_xor(par, neg)).to(v2c.dtype)
    pref = (1 - 2 * synd.to(torch.int32)).to(v2c.dtype).unsqueeze(dim)
    return sign * pref * mag


# --------------------------------------------------------------------- #
# Launch plan of the staged-tile check phase (kernels 1 and 4,
# csrc/bp_check_tile.cuh)

H100_SMS = 132              # SMs of the H100 SXM: the plans' default card
SMEM_BLOCK_MAX = 232448     # 227 KB: the most shared memory a block may use
SMEM_SM = 233472            # 228 KB per SM; each resident block takes 1 KB more
TILE_PAIRS = 1024           # (check, frame) pairs a tile holds at most
TILE_FRAMES_MAX = 256       # frames per tile at most
TILE_BLOCKS_PER_SM = 3      # persistent blocks per SM; the launch refuses
                            # more than the source's kTileBlocksPerSm
# f32 scratch values per slot (tile_scratch): phi(|v|); the two forward
# products of tanh-F/B and e^-|v|; none for min-sum
_TILE_SCRATCH = {"sumproduct": 1, "tanhfb": 3, "minsum": 0}


@dataclass(frozen=True)
class TilePlan:
    """Launch shape of the staged-tile check phase (one call)."""

    checks: int         # checks per tile: a power of two dividing 64
    frames: int         # frames per tile
    stages: int         # tiles in the shared-memory ring (1: per-thread)
    path: str           # "staged" (TMA bulk copies) or "thread" (plain loads)
    smem: int           # dynamic shared memory per block, bytes
    blocks_per_sm: int  # persistent blocks resident on one SM
    tiles: int          # tiles of the call
    grid: int           # persistent blocks launched


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def tile_smem(dc: int, checks: int, frames: int, stages: int, t_size: int,
              m_size: int, masked: bool, scratch: int) -> int:
    """Dynamic shared memory of a tile plan, bytes: ``stages`` stages of
    [t, c2v, synd, mask] tiles, the f32 scratch, the per-frame violation
    counts and one mbarrier per stage (``tile_layout`` in the source)."""
    pairs = checks * frames
    stage = (_up16(dc * pairs * t_size) + _up16(dc * pairs * m_size)
             + _up16(pairs * 4) + (_up16(dc * checks * 4) if masked else 0))
    return (stages * stage + _up16(scratch * dc * pairs * 4)
            + _up16(frames * 4) + 16 * stages)


@functools.lru_cache(maxsize=256)
def check_tile_plan(groups: int, dc: int, rows: int, B: int, t_size: int,
                    m_size: int, rule: str, *, masked: bool,
                    aligned: bool = True, sms: int = H100_SMS) -> TilePlan:
    """The launch plan of one staged-tile check phase: ``groups`` groups of
    ``rows`` checks with ``dc`` slots over ``B`` frames (kernel 1: nb_c
    block rows of z; kernel 4: one group of C checks, ``masked``), element
    sizes ``t_size``/``m_size`` bytes, on a card with ``sms`` SMs.

    A tile is ``checks`` checks by ``frames`` frames: all B frames up to
    ``TILE_FRAMES_MAX``, and ``checks`` a power of two up to 64.  The
    staged path (TMA bulk copies) needs 16-byte units: B times each element
    size a multiple of 16 and ``aligned`` pointers; else the per-thread
    path, with one stage.  The tile is the largest, from ``TILE_PAIRS``
    pairs down, whose two-stage ring fits ``TILE_BLOCKS_PER_SM`` blocks an
    SM, else two; a staged ring then takes as many stages, up to 4, as that
    many blocks still fit.  Where no tile fits two blocks, one check a tile
    and one block an SM, with fewer frames if one block does not fit.  The
    grid is persistent: that many blocks an SM."""
    if rule not in _TILE_SCRATCH:
        raise ValueError(f"unknown rule {rule!r}")
    if not (1 <= dc <= MAX_DC) or min(groups, rows, B) < 1:
        raise ValueError(f"no tile plan for groups={groups} dc={dc} "
                         f"rows={rows} B={B}")
    staged = (aligned and (B * t_size) % 16 == 0
              and (B * m_size) % 16 == 0)
    least = 2 if staged else 1
    frames = min(B, TILE_FRAMES_MAX)
    while True:
        def smem(checks, stages):
            return tile_smem(dc, checks, frames, stages, t_size, m_size,
                             masked, _TILE_SCRATCH[rule])

        def fits(checks, stages, blocks):
            return blocks * (smem(checks, stages) + 1024) <= SMEM_SM

        top = 1
        while top < 64 and 2 * top * frames <= TILE_PAIRS:
            top *= 2
        choices = [(top >> k, blocks) for k in range(top.bit_length())
                   for blocks in (TILE_BLOCKS_PER_SM, 2)] + [(1, 1)]
        checks, blocks = next(((c, b) for c, b in choices
                               if fits(c, least, b)), (0, 0))
        if checks:
            break
        half = frames // 2
        if half < 1 or (staged and (half * t_size % 16 or half * m_size % 16)):
            raise ValueError(f"no tile of dc={dc} fits {SMEM_BLOCK_MAX} "
                             f"bytes of shared memory")
        frames = half
    stages = least
    while staged and stages < 4 and fits(checks, stages + 1, blocks):
        stages += 1
    tiles = groups * -(-rows // checks) * -(-B // frames)
    return TilePlan(checks, frames, stages, "staged" if staged else "thread",
                    smem(checks, stages), blocks, tiles,
                    min(tiles, blocks * sms))


def _tile_launch_args(plan: TilePlan):
    return (plan.checks, plan.frames, plan.stages,
            int(plan.path == "staged"), plan.grid, plan.blocks_per_sm,
            plan.smem)


def _plan_for(groups, dc, rows, B, t, m, rule, masked, *tensors):
    """check_tile_plan of one call: totals ``t``, messages ``m``, and
    ``tensors`` whose pointers the bulk copies need 16-byte aligned."""
    aligned = all(y.data_ptr() % 16 == 0 for y in tensors)
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return check_tile_plan(groups, dc, rows, B, t.element_size(),
                           m.element_size(), rule, masked=masked,
                           aligned=aligned, sms=sms)


# --------------------------------------------------------------------- #
# Launch plan of kernel 5's check-major staged tiles
# (csrc/bp_check_phase_generic.cu, check_node_update_launch)

CM_THREADS_MAX = 256        # threads a block at most (kCmThreadsMax)
CM_THREADS_SM = 1024        # threads an SM at most (kCmThreadsPerSm: the
                            # register budget of the launch bounds)
CM_ILP = 2                  # (check, frame) pairs a thread runs (kCmIlp)
CM_THREADS_WANTED = 512     # threads an SM a plan settles for


@dataclass(frozen=True)
class CheckMajorPlan:
    """Launch shape of kernel 5 (one call)."""

    checks: int         # checks per tile: a power of two up to 64
    frames: int         # frames per tile
    stages: int         # tiles in the shared-memory ring (1: per-thread)
    path: str           # "staged" (TMA bulk copies) or "thread" (plain loads)
    threads: int        # threads a block
    smem: int           # dynamic shared memory per block, bytes
    blocks_per_sm: int  # persistent blocks resident on one SM
    tiles: int          # tiles of the call
    grid: int           # persistent blocks launched


def check_major_smem(dc: int, checks: int, frames: int, stages: int,
                     v_size: int) -> int:
    """Dynamic shared memory of a kernel 5 plan, bytes: ``stages`` stages
    of [slab, syndrome, mask] tiles and one mbarrier a stage
    (``cm_layout`` in the source)."""
    stage = (_up16(checks * dc * frames * v_size) + _up16(checks * frames * 4)
             + _up16(checks * dc * 4))
    return stages * stage + 16 * stages


@functools.lru_cache(maxsize=256)
def check_major_plan(C: int, dc: int, B: int, v_size: int, *,
                     aligned: bool = True,
                     sms: int = H100_SMS) -> CheckMajorPlan:
    """The launch plan of one check-major update (kernel 5) of ``C``
    checks with ``dc`` slots over ``B`` frames, element size ``v_size``
    bytes, on a card with ``sms`` SMs.

    A tile is ``checks`` consecutive checks (a power of two up to 64) by
    ``frames`` frames (all B up to ``TILE_FRAMES_MAX``), and a block runs
    one thread for every ``CM_ILP`` pairs of it (32 to ``CM_THREADS_MAX``
    threads).  The staged path (TMA bulk copies) needs 16-byte units: B
    times the element size a multiple of 16 and ``aligned`` pointers; else
    the per-thread path, with one stage.  From the largest tile of at most
    ``CM_ILP * CM_THREADS_MAX`` pairs down, the first whose ring of the
    least stages fits blocks of ``CM_THREADS_WANTED`` threads an SM or
    more, else the tile with the most threads an SM (blocks an SM capped
    at ``CM_THREADS_SM`` threads); a staged ring then takes as many stages,
    up to 4, as those blocks still fit.  The grid is persistent: that many
    blocks an SM."""
    if not (1 <= dc <= MAX_DC) or min(C, B) < 1:
        raise ValueError(f"no check-major plan for C={C} dc={dc} B={B}")
    staged = aligned and (B * v_size) % 16 == 0
    least = 2 if staged else 1
    frames = min(B, TILE_FRAMES_MAX)

    def smem(checks, stages):
        return check_major_smem(dc, checks, frames, stages, v_size)

    def fits(checks, stages, blocks):
        return blocks * (smem(checks, stages) + 1024) <= SMEM_SM

    top = 1
    while top < 64 and 2 * top * frames <= CM_ILP * CM_THREADS_MAX:
        top *= 2
    # one check of MAX_DC slots by TILE_FRAMES_MAX frames fits a block, so
    # some tile always fits
    best = None
    for k in range(top.bit_length()):
        checks = top >> k
        threads = min(CM_THREADS_MAX,
                      32 * -(-checks * frames // (32 * CM_ILP)))
        blocks = CM_THREADS_SM // threads
        while blocks and not fits(checks, least, blocks):
            blocks -= 1
        if blocks and (best is None or blocks * threads > best[1] * best[2]):
            best = (checks, blocks, threads)
        if blocks * threads >= CM_THREADS_WANTED:
            break
    checks, blocks, threads = best
    stages = least
    while staged and stages < 4 and fits(checks, stages + 1, blocks):
        stages += 1
    tiles = -(-C // checks) * -(-B // frames)
    return CheckMajorPlan(checks, frames, stages,
                          "staged" if staged else "thread", threads,
                          smem(checks, stages), blocks, tiles,
                          min(tiles, blocks * sms))


# --------------------------------------------------------------------- #
# Kernel 1: the fused check phase of the dense flooding decoder


def _check_args(t, c2v, synd, rule):
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    if t.dim() != 4 or c2v.shape != t.shape:
        raise ValueError(
            f"t and c2v must both be [nb_c, dc, z, B], got {tuple(t.shape)} "
            f"and {tuple(c2v.shape)}"
        )
    nb_c, _, z, B = t.shape
    if tuple(synd.shape) != (nb_c, z, B):
        raise ValueError(
            f"synd must be [nb_c, z, B] = {(nb_c, z, B)}, got "
            f"{tuple(synd.shape)}"
        )
    if not (t.device == c2v.device == synd.device):
        raise ValueError("t, c2v and synd must be on one device")


def bp_check_phase_qc_ref(t, c2v, synd, tiny: float = 1e-30, *,
                          rule: str = "sumproduct",
                          ms_alpha: float = MINSUM_ALPHA,
                          ms_beta: float = 0.0):
    """Plain PyTorch fused check phase (any device); see
    :func:`bp_check_phase_qc` for the contract."""
    _check_args(t, c2v, synd, rule)
    out_dtype = c2v.dtype
    compute = (
        torch.float32 if torch.bfloat16 in (out_dtype, t.dtype) else t.dtype
    )
    t = t.to(compute)
    synd = synd.to(torch.int32)

    # 1. convergence: parity of hard decisions vs the syndrome
    parity = torch.sum((t < 0).to(torch.int32), dim=1) & 1
    viol = torch.sum((parity != synd).to(torch.int32), dim=1,
                     dtype=torch.int32)                        # [nb_c, B]

    # 2./3. extrinsic check update
    new = _check_messages(t - c2v.to(compute), synd, 1, rule, tiny,
                          ms_alpha, ms_beta)
    return new.to(out_dtype), viol


@_spanned
def bp_check_phase_qc(t, c2v, synd, tiny: float = 1e-30, *,
                      rule: str = "sumproduct",
                      ms_alpha: float = MINSUM_ALPHA, ms_beta: float = 0.0):
    """Fused check phase in the QC decoder's native layout.

    Args:
      t:    [nb_c, dc, z, B] gathered variable totals (padded slots of
            irregular rows hold +1e30).
      c2v:  [nb_c, dc, z, B] previous check->variable messages.
      synd: [nb_c, z, B] syndrome bits (0/1 int).
      rule: "sumproduct" (phi form), "tanhfb" (tanh forward/backward
            sum-product) or "minsum" (``max(ms_alpha*min - ms_beta, 0)``).

    Returns ``(c2v_new [nb_c, dc, z, B] in c2v's dtype, viol [nb_c, B]
    int32)``; ``viol.sum(0) == 0`` is the per-frame convergence mask.

    CPU tensors run :func:`bp_check_phase_qc_ref`.  CUDA tensors run the
    kernel, which takes contiguous (t, c2v) dtype pairs (f32, f32),
    (bf16, bf16) and (f32, bf16), int32 synd and dc <= ``MAX_DC``; anything
    else raises.
    """
    if t.device.type == "cpu":
        return bp_check_phase_qc_ref(t, c2v, synd, tiny, rule=rule,
                                     ms_alpha=ms_alpha, ms_beta=ms_beta)
    _check_args(t, c2v, synd, rule)
    _require_cuda("bp_check_phase_qc", t)
    codes = _dtype_codes("bp_check_phase_qc", t.dtype, c2v.dtype)
    if synd.dtype != torch.int32:
        raise TypeError(f"synd must be int32, got {synd.dtype}")
    _require_contiguous(t=t, c2v=c2v, synd=synd)
    nb_c, dc, z, B = t.shape
    if dc > MAX_DC:
        raise ValueError(f"check degree {dc} exceeds the kernel's {MAX_DC}")

    out = torch.empty_like(c2v)
    viol = torch.zeros((nb_c, B), dtype=torch.int32, device=t.device)
    plan = _plan_for(nb_c, dc, z, B, t, c2v, rule, False, t, c2v, synd, out)
    lib = _library("bp_check_phase_qc", "ppppp" + "i" * 7 + "fff"
                   + "i" * 7 + "p")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.bp_check_phase_qc_launch(
            t.data_ptr(), c2v.data_ptr(), synd.data_ptr(), out.data_ptr(),
            viol.data_ptr(), codes[0], codes[1], nb_c, dc, z, B, RULES[rule],
            float(tiny), float(ms_alpha), float(ms_beta),
            *_tile_launch_args(plan), stream,
        )
    _raise_on(err, "bp_check_phase_qc")
    bp_check_phase_qc.launches += 1
    bp_check_phase_qc.plan = plan
    return out, viol


bp_check_phase_qc.launches = 0
bp_check_phase_qc.plan = None


# --------------------------------------------------------------------- #
# Index tables of the multi-step kernels


def layered_levels(rows):
    """Dependency levels of the serial layered sweep over ``rows``
    (``rows[cb] = [(vb, shift), ...]``): a row's level is 1 + the highest
    level of the earlier rows that share a variable block with it.

    Rows of one level touch pairwise-disjoint variable blocks, and along
    every variable block the levels of its rows increase with the row
    index, so processing the levels in order (the rows of a level in any
    order) gives the serial sweep's result bit for bit.  Returns a list of
    levels, each a list of row indices (ascending).
    """
    last = {}
    level_of = []
    for row in rows:
        lev = 1 + max((last.get(v, -1) for v, _ in row), default=-1)
        for v, _ in row:
            last[v] = lev
        level_of.append(lev)
    levels = [[] for _ in range(max(level_of) + 1)]
    for cb, lev in enumerate(level_of):
        levels[lev].append(cb)
    return levels


def _i32(values):
    return np.asarray(values, dtype=np.int32)


class QCTables:
    """Index tables of a QC base graph, built once on the host and moved to
    a device once.

    ``rows[cb] = [(vb, shift), ...]``; base edges are numbered flat in row
    order, ``e = row_off[cb] + d``, the layout of the messages ``c2v
    [E, z, B]``.  Shifts are reduced mod z.  Tables:

    * rows: ``row_off [nb_c+1]``, ``edge_v``/``edge_s [E]``;
    * cols: each variable block's edges in (row ascending, slot ascending)
      order, the order of the totals' sums: ``col_off [nb_v+1]``,
      ``col_e``/``col_s [E]``;
    * layered: the dependency levels (:func:`layered_levels`) as
      ``level_off`` and ``level_rows``; rows with a repeated variable block
      are *deferred*: ``defer_base[cb]`` is the first of the row's delta
      slots among its level's deferred rows (-1 for other rows), and
      ``app_*`` list per level (``app_level_off``), per deferred row, per
      distinct variable block its level slots in slot order.
      ``n_defer_slots`` counts the deferred slots of all levels,
      ``defer_level_slots`` those of the level with the most.
    """

    def __init__(self, rows, z: int):
        self.z = int(z)
        self.rows = [[(int(v), int(s) % self.z) for v, s in row]
                     for row in rows]
        self.nb_c = len(self.rows)
        self.nb_v = max(v for row in self.rows for v, _ in row) + 1
        degs = [len(row) for row in self.rows]
        if min(degs) < 1:
            raise ValueError("empty check block row")
        self.dc_max = max(degs)
        self.row_off = _i32(np.concatenate([[0], np.cumsum(degs)]))
        self.E = int(self.row_off[-1])
        self.edge_v = _i32([v for row in self.rows for v, _ in row])
        self.edge_s = _i32([s for row in self.rows for _, s in row])
        cols = [[] for _ in range(self.nb_v)]
        for cb, row in enumerate(self.rows):
            for d, (v, s) in enumerate(row):
                cols[v].append((int(self.row_off[cb]) + d, s))
        self.cols = cols
        self.col_off = _i32(np.concatenate(
            [[0], np.cumsum([len(c) for c in cols])]))
        self.col_e = _i32([e for c in cols for e, _ in c])
        self.col_s = _i32([s for c in cols for _, s in c])

        self.levels = layered_levels(self.rows)
        self.level_off = _i32(np.concatenate(
            [[0], np.cumsum([len(lev) for lev in self.levels])]))
        self.level_rows = _i32([cb for lev in self.levels for cb in lev])
        deferred = [len({v for v, _ in row}) < len(row) for row in self.rows]
        self.defer_base = np.full(self.nb_c, -1, np.int32)
        self.n_defer_slots = 0
        self.defer_level_slots = 0
        app_vb, app_off, app_e, app_s, app_level_off = [], [0], [], [], [0]
        for lev in self.levels:
            n_slots = 0
            for cb in lev:
                if not deferred[cb]:
                    continue
                self.defer_base[cb] = n_slots
                row = self.rows[cb]
                for v in dict.fromkeys(v for v, _ in row):
                    app_vb.append(v)
                    for d, (vd, s) in enumerate(row):
                        if vd == v:
                            app_e.append(n_slots + d)
                            app_s.append(s)
                    app_off.append(len(app_e))
                n_slots += len(row)
            app_level_off.append(len(app_vb))
            self.n_defer_slots += n_slots
            self.defer_level_slots = max(self.defer_level_slots, n_slots)
        self.app_vb, self.app_off = _i32(app_vb), _i32(app_off)
        self.app_e, self.app_s = _i32(app_e), _i32(app_s)
        self.app_level_off = _i32(app_level_off)
        self._cache = {}

    _DEVICE_TABLES = ("row_off", "edge_v", "edge_s", "col_off", "col_e",
                      "col_s", "level_off", "level_rows", "defer_base",
                      "app_level_off", "app_vb", "app_off", "app_e", "app_s")

    def on(self, device) -> dict:
        """The int32 tables on ``device`` (uploaded once per device; an
        empty table becomes one 0 so that its pointer is valid)."""
        device = torch.device(device)
        key = ("tables", device)
        if key not in self._cache:
            self._cache[key] = {
                name: torch.as_tensor(
                    getattr(self, name) if getattr(self, name).size
                    else _i32([0]), device=device,
                )
                for name in self._DEVICE_TABLES
            }
        return self._cache[key]

    def row_groups(self, batches, device):
        """Gather plans of the plain versions: every batch of rows (a list
        of row indices) split by degree into ``(cbs, gidx, eidx, deg)``
        with ``gidx [R, deg, z]`` the flat totals index ``v*z + (j - s) %
        z`` each slot reads and ``eidx [R*deg]`` the rows' edges."""
        device = torch.device(device)
        key = ("rows", tuple(map(tuple, batches)), device)
        if key not in self._cache:
            z, j = self.z, np.arange(self.z)
            plan = []
            for batch in batches:
                by_deg = {}
                for cb in batch:
                    by_deg.setdefault(len(self.rows[cb]), []).append(cb)
                for deg, cbs in sorted(by_deg.items()):
                    gidx = np.stack([
                        np.stack([v * z + (j - s) % z
                                  for v, s in self.rows[cb]])
                        for cb in cbs
                    ])
                    eidx = np.concatenate([
                        self.row_off[cb] + np.arange(deg) for cb in cbs
                    ])
                    plan.append(tuple(
                        torch.as_tensor(a, dtype=torch.int64, device=device)
                        for a in (cbs, gidx, eidx)) + (deg,))
            self._cache[key] = plan
        return self._cache[key]

    def var_groups(self, device):
        """Scatter plan of the plain flooding step: variable blocks grouped
        by degree as ``(vbs, cidx [V, deg, z], deg)`` with the flat message
        index ``e*z + (k + s) % z`` of each incoming edge in cols order;
        isolated blocks have ``deg == 0``."""
        device = torch.device(device)
        key = ("vars", device)
        if key not in self._cache:
            z, k = self.z, np.arange(self.z)
            by_deg = {}
            for v, col in enumerate(self.cols):
                by_deg.setdefault(len(col), []).append(v)
            plan = []
            for deg, vbs in sorted(by_deg.items()):
                cidx = np.stack([
                    np.stack([e * z + (k + s) % z for e, s in self.cols[v]])
                    if deg else np.zeros((0, z), np.int64)
                    for v in vbs
                ])
                plan.append((torch.as_tensor(vbs, dtype=torch.int64,
                                             device=device),
                             torch.as_tensor(cidx, dtype=torch.int64,
                                             device=device), deg))
            self._cache[key] = plan
        return self._cache[key]

    def syndrome_violations(self, total, synd):
        """[B] int32: per frame, the checks whose parity of ``total < 0``
        differs from ``synd`` (total [nb_v, z, B], synd [nb_c, z, B])."""
        B = total.shape[-1]
        bits = (total < 0).to(torch.int32).reshape(-1, B)
        synd = synd.to(torch.int32)
        viol = torch.zeros(B, dtype=torch.int32, device=total.device)
        for cbs, gidx, _, deg in self.row_groups([range(self.nb_c)],
                                                 total.device):
            par = bits.index_select(0, gidx.reshape(-1)).view(
                len(cbs), deg, self.z, B).sum(1) & 1
            viol += torch.sum(par != synd.index_select(0, cbs), dim=(0, 1),
                              dtype=torch.int32)
        return viol


def _n_steps(k: int, it0: int, maxiter: int) -> int:
    """Steps a call advances: ``max(min(K, maxiter - it0), 0)``."""
    return max(min(int(k), int(maxiter) - int(it0)), 0)


def _check_state(tables, total, c2v, synd, done, iters, prior=None):
    z, B = tables.z, total.shape[-1]
    want = {"total": (total, (tables.nb_v, z, B)),
            "c2v": (c2v, (tables.E, z, B)),
            "synd": (synd, (tables.nb_c, z, B)),
            "done": (done, (B,)), "iters": (iters, (B,))}
    if prior is not None:
        want["prior"] = (prior, (tables.nb_v, z, B))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != total.device:
            raise ValueError("the state tensors must be on one device")


# --------------------------------------------------------------------- #
# Launch plan of the frame-owning multi-step kernels (kernels 2 and 3,
# csrc/bp_resident.cuh)

RES_THREADS_MAX = 1024      # threads a block at most
RES_REGS = 64               # registers a thread at most (the kernels'
                            # __launch_bounds__(1024, 1))
REGS_SM = 65536
THREADS_SM = 2048
RES_THREADS_PREFERRED = 512  # totals in shared memory unless that leaves
                             # fewer threads than this (and than without)


def _res_scratch(rule: str, layered: bool) -> int:
    """f32 scratch values per slot and thread (res_scratch in the source):
    the rule's pass-1 values (phi(|v|); tanh-F/B's two forward products and
    e^-|v|; min-sum |v|), and for the layered kernel the slot's total and
    old message."""
    return (3 if rule == "tanhfb" else 1) + (2 if layered else 0)


@dataclass(frozen=True)
class ResidentPlan:
    """Launch shape of one call of kernel 2 or 3."""

    frames: int         # frames a block owns at a time
    threads: int        # threads a block
    cluster: int        # blocks a cluster (1: no cluster)
    smem: int           # dynamic shared memory a block, bytes
    totals: str         # "shared": the frame's totals in shared memory for
                        # the call; "global": in the frame-major scratch
    layout: str         # "a": the state copied into frame-major scratch
    blocks_per_sm: int  # blocks resident on one SM
    grid: int           # persistent blocks launched


def resident_smem(threads: int, nb_v: int, z: int, dc_max: int,
                  t_size: int, rule: str, *, layered: bool,
                  defer_slots: int = 0, totals_shared: bool) -> int:
    """Dynamic shared memory of a resident plan, bytes: the frame's totals
    (when in shared memory), the rule scratch, one level's deferred deltas
    [defer_slots, z] f32 and the block's two counts (``res_layout`` in the
    source)."""
    return ((_up16(nb_v * z * t_size) if totals_shared else 0)
            + _up16(_res_scratch(rule, layered) * dc_max * threads * 4)
            + _up16(defer_slots * z * 4) + 16)


@functools.lru_cache(maxsize=256)
def resident_plan(B: int, nb_v: int, nb_c: int, E: int, z: int,
                  dc_max: int, t_size: int, rule: str, *,
                  layered: bool, defer_slots: int = 0,
                  sms: int = H100_SMS) -> ResidentPlan:
    """The launch plan of one call of kernel 2 (``layered=False``) or
    kernel 3 over ``B`` frames of a QC code (``nb_v``/``nb_c`` block
    columns/rows of circulant size ``z``, ``E`` base edges, rows up to
    ``dc_max`` wide, ``defer_slots`` deferred slots in a level at most),
    totals of ``t_size`` bytes, on a card with ``sms`` SMs.

    Layout (a): the call copies its state into frame-major scratch, and a
    persistent block owns one frame at a time for all K steps (no cluster).
    A block runs as many threads, a multiple of 32 up to
    ``RES_THREADS_MAX``, as its shared memory holds scratch for.  The
    frame's totals live in shared memory when they fit with at least
    ``RES_THREADS_PREFERRED`` threads (or with as many as without them),
    else in the scratch in device memory.  As many blocks share an SM as
    threads, registers (``RES_REGS`` a thread) and shared memory allow;
    the grid is that many blocks an SM, at most B."""
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    if not (1 <= dc_max <= MAX_DC) or min(B, nb_v, nb_c, E, z) < 1:
        raise ValueError(f"no resident plan for B={B} nb_v={nb_v} "
                         f"nb_c={nb_c} E={E} z={z} dc_max={dc_max}")
    if max(nb_v, nb_c, E) * z >= 2 ** 31:
        raise ValueError("a frame's state exceeds 2^31 elements")
    t_size = 4 if layered else t_size

    def threads_for(shared):
        smem = functools.partial(resident_smem, nb_v=nb_v, z=z,
                                 dc_max=dc_max, t_size=t_size, rule=rule,
                                 layered=layered, defer_slots=defer_slots,
                                 totals_shared=shared)
        per_warp = smem(32) - smem(0)
        return min(RES_THREADS_MAX,
                   32 * ((SMEM_BLOCK_MAX - smem(0)) // per_warp))

    shared, plain = threads_for(True), threads_for(False)
    if plain < 32:
        raise ValueError(f"no resident plan of dc_max={dc_max} fits "
                         f"{SMEM_BLOCK_MAX} bytes of shared memory")
    in_smem = shared >= min(RES_THREADS_PREFERRED, plain)
    threads = shared if in_smem else plain
    smem = resident_smem(threads, nb_v, z, dc_max, t_size, rule,
                         layered=layered, defer_slots=defer_slots,
                         totals_shared=in_smem)
    blocks = max(1, min(THREADS_SM // threads,
                        REGS_SM // (RES_REGS * threads),
                        SMEM_SM // (smem + 1024)))
    return ResidentPlan(1, threads, 1, smem,
                        "shared" if in_smem else "global", "a", blocks,
                        min(B, blocks * sms))


def _resident_launch_args(plan: ResidentPlan):
    return (plan.threads, int(plan.totals == "shared"), plan.smem,
            plan.blocks_per_sm, plan.grid, plan.cluster, plan.frames)


def _resident_plan_for(tables, B, t, rule, layered):
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return resident_plan(B, tables.nb_v, tables.nb_c, tables.E, tables.z,
                         tables.dc_max, t.element_size(), rule,
                         layered=layered,
                         defer_slots=tables.defer_level_slots if layered
                         else 0, sms=sms)


# --------------------------------------------------------------------- #
# Kernel 2: K flooding iterations per call


def _flooding_check_pass(tables, total, c2v, synd, rule, tiny, ms_alpha,
                         ms_beta):
    """Pass 1 of a flooding step of the plain versions, in place: every
    row's new messages from rolled reads of ``total`` (in f32) and the old
    ``c2v``, stored in c2v's dtype.  Returns [B] int32, the checks per
    frame whose parity of ``total < 0`` differs from the int32 ``synd``."""
    z, B, dev = tables.z, total.shape[-1], total.device
    t_flat = total.view(-1, B)
    viol = torch.zeros(B, dtype=torch.int32, device=dev)
    for cbs, gidx, eidx, deg in tables.row_groups([range(tables.nb_c)], dev):
        shape = (len(cbs), deg, z, B)
        t = t_flat.index_select(0, gidx.reshape(-1)).view(shape).float()
        s = synd.index_select(0, cbs)
        parity = torch.sum((t < 0).to(torch.int32), dim=1) & 1
        viol += torch.sum((parity != s).to(torch.int32), dim=(0, 1),
                          dtype=torch.int32)
        old = c2v.index_select(0, eidx).view(shape).float()
        new = _check_messages(t - old, s, 1, rule, tiny, ms_alpha, ms_beta)
        c2v.index_copy_(0, eidx, new.to(c2v.dtype).view(-1, z, B))
    return viol


def bp_decode_rounds_qc_ref(tables, it0: int, maxiter: int, total, c2v,
                            prior, synd, done, iters, *,
                            rule: str = "sumproduct", k_rounds: int = 8,
                            tiny: float = 1e-30,
                            ms_alpha: float = MINSUM_ALPHA,
                            ms_beta: float = 0.0):
    """Plain PyTorch flooding steps (any device); see
    :func:`bp_decode_rounds_qc` for the contract."""
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    _check_state(tables, total, c2v, synd, done, iters, prior)
    z, B, dev = tables.z, total.shape[-1], total.device
    c_flat = c2v.view(-1, B)
    synd = synd.to(torch.int32)
    for k in range(_n_steps(k_rounds, it0, maxiter)):
        # pass 1: check phase on rolled reads of the totals
        viol = _flooding_check_pass(tables, total, c2v, synd, rule, tiny,
                                    ms_alpha, ms_beta)
        # bookkeeping: iters at the first convergence, done
        conv = viol == 0
        iters.copy_(torch.where(conv & (done == 0), it0 + k, iters))
        done.copy_(done | conv.to(torch.int32))
        frozen = done.bool()
        # pass 2: totals from the new messages, frozen where done
        for vbs, cidx, deg in tables.var_groups(dev):
            new = prior.index_select(0, vbs).float()
            if deg:
                g = c_flat.index_select(0, cidx.reshape(-1)).view(
                    len(vbs), deg, z, B).float()
                new = new + _fold_sum(g, 1).squeeze(1)
            old = total.index_select(0, vbs)
            total.index_copy_(0, vbs,
                              torch.where(frozen, old, new.to(total.dtype)))
    return total, c2v, done, iters


@_spanned
def bp_decode_rounds_qc(tables, it0: int, maxiter: int, total, c2v, prior,
                        synd, done, iters, *, rule: str = "sumproduct",
                        k_rounds: int = 8, tiny: float = 1e-30,
                        ms_alpha: float = MINSUM_ALPHA,
                        ms_beta: float = 0.0):
    """Advance ``n = max(min(k_rounds, maxiter - it0), 0)`` flooding BP
    iterations of the QC decoder, in place.

    Args:
      tables: :class:`QCTables` of the code.
      it0, maxiter: host ints; iteration ``it0 + k`` runs for ``k < n``.
      total: [nb_v, z, B] running totals (message dtype, or f32 over bf16
        messages).
      c2v: [E, z, B] messages, base edges flat in row order.
      prior: [nb_v, z, B] channel LLRs in the message dtype.
      synd: [nb_c, z, B] syndrome bits (int8 for the kernel).
      done, iters: [B] int32.
      rule: "sumproduct" (phi form), "tanhfb" or "minsum".

    Per iteration: the check phase on rolled reads of the totals (the
    convergence test counts checks whose parity of ``total < 0`` differs
    from the syndrome) stores new messages for every frame; a frame with no
    violation converges (``iters = it`` the first time, ``done = 1``);
    then frames not done get ``total = round(f32(prior) + sum of their
    rolled incoming messages)`` in (row, slot) order.  Returns
    ``(total, c2v, done, iters)``.

    CPU tensors run :func:`bp_decode_rounds_qc_ref`.  CUDA tensors run the
    kernel, which takes contiguous tensors with (total, c2v) dtype pairs
    (f32, f32), (bf16, bf16) and (f32, bf16), prior in c2v's dtype, int8
    synd, int32 done/iters and rows up to ``MAX_DC`` wide; anything else
    raises.  The call launches the copy of the state into frame-major
    scratch, the K steps (blocks owning frames, :func:`resident_plan`; the
    wrapper keeps the last plan in ``.plan``) and the copy back:
    ``.device_launches`` counts them.
    """
    if total.device.type == "cpu":
        return bp_decode_rounds_qc_ref(
            tables, it0, maxiter, total, c2v, prior, synd, done, iters,
            rule=rule, k_rounds=k_rounds, tiny=tiny, ms_alpha=ms_alpha,
            ms_beta=ms_beta)
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    _check_state(tables, total, c2v, synd, done, iters, prior)
    _require_cuda("bp_decode_rounds_qc", total)
    codes = _dtype_codes("bp_decode_rounds_qc", total.dtype, c2v.dtype)
    if prior.dtype != c2v.dtype:
        raise TypeError(f"prior must be {c2v.dtype}, got {prior.dtype}")
    _require_int_state(synd, done, iters)
    _require_contiguous(total=total, c2v=c2v, prior=prior, synd=synd,
                        done=done, iters=iters)
    _require_tables(tables)
    n = _n_steps(k_rounds, it0, maxiter)
    if n == 0:
        return total, c2v, done, iters
    B, z, dev = total.shape[-1], tables.z, total.device
    plan = _resident_plan_for(tables, B, total, rule, False)
    tb = tables.on(dev)
    # frame-major scratch [B, ...] of totals, messages, prior and synd
    scratch = [torch.empty(B * rows * z, dtype=x.dtype, device=dev)
               for rows, x in ((tables.nb_v, total), (tables.E, c2v),
                               (tables.nb_v, prior), (tables.nb_c, synd))]
    n_launched = ctypes.c_int(0)
    lib = _library("bp_decode_rounds_qc", "p" * 16 + "i" * 11 + "fff"
                   + "i" * 7 + "pp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bp_decode_rounds_qc_launch(
            total.data_ptr(), c2v.data_ptr(), prior.data_ptr(),
            synd.data_ptr(), done.data_ptr(), iters.data_ptr(),
            *(x.data_ptr() for x in scratch),
            *(tb[name].data_ptr() for name in (
                "row_off", "edge_v", "edge_s", "col_off", "col_e", "col_s")),
            codes[0], codes[1], tables.nb_c, tables.nb_v, tables.E,
            tables.dc_max, z, B, RULES[rule], int(it0), n, float(tiny),
            float(ms_alpha), float(ms_beta), *_resident_launch_args(plan),
            ctypes.addressof(n_launched), stream,
        )
    _raise_on(err, "bp_decode_rounds_qc")
    bp_decode_rounds_qc.launches += 1
    bp_decode_rounds_qc.iterations += n
    bp_decode_rounds_qc.device_launches += n_launched.value
    bp_decode_rounds_qc.plan = plan
    return total, c2v, done, iters


bp_decode_rounds_qc.launches = 0
bp_decode_rounds_qc.iterations = 0
bp_decode_rounds_qc.device_launches = 0
bp_decode_rounds_qc.plan = None


# --------------------------------------------------------------------- #
# Kernel 3: K serial-C layered sweeps per call


def layered_sweep(groups, total, c2v, synd, frozen, *, rule: str,
                  tiny: float = 1e-30, ms_alpha: float = MINSUM_ALPHA,
                  ms_beta: float = 0.0):
    """One layered sweep, in place, over ``groups`` (a
    :meth:`QCTables.row_groups` plan whose batches are variable-disjoint
    rows, in sweep order).

    Per row: ``t`` the rolled totals, ``old`` the row's messages, ``stored
    = messages(t - old)`` in the message dtype, ``c2v = stored``, and
    ``total[v_d] += roll(f32(stored) - old, -s_d)`` slot by slot, except in
    ``frozen`` frames ([B] bool, or None to update every frame).  Totals
    compute in their own dtype (f32, or f64 for float64 parity runs)."""
    z, B = total.shape[1], total.shape[-1]
    t_flat = total.view(-1, B)
    for cbs, gidx, eidx, deg in groups:
        shape = (len(cbs), deg, z, B)
        t = t_flat.index_select(0, gidx.reshape(-1)).view(shape)
        old = c2v.index_select(0, eidx).view(shape).to(t.dtype)
        stored = _check_messages(t - old, synd.index_select(0, cbs), 1,
                                 rule, tiny, ms_alpha,
                                 ms_beta).to(c2v.dtype)
        delta = stored.to(t.dtype) - old
        for d in range(deg):
            idx = gidx[:, d].reshape(-1)
            cur = t_flat.index_select(0, idx)
            upd = cur + delta[:, d].reshape(-1, B)
            if frozen is not None:
                upd = torch.where(frozen, cur, upd)
            t_flat.index_copy_(0, idx, upd)
        c2v.index_copy_(0, eidx, stored.view(-1, z, B))


def bp_layered_sweeps_qc_ref(tables, it0: int, maxiter: int, total, c2v,
                             synd, done, iters, *, rule: str = "sumproduct",
                             k_sweeps: int = 4, tiny: float = 1e-30,
                             ms_alpha: float = MINSUM_ALPHA,
                             ms_beta: float = 0.0):
    """Plain PyTorch layered sweeps (any device); see
    :func:`bp_layered_sweeps_qc` for the contract.  Rows run by dependency
    level, as the kernel runs them (bit-identical to row order)."""
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    _check_state(tables, total, c2v, synd, done, iters)
    synd = synd.to(torch.int32)
    groups = tables.row_groups(tables.levels, total.device)
    for k in range(_n_steps(k_sweeps, it0, maxiter)):
        layered_sweep(groups, total, c2v, synd, done.bool(), rule=rule,
                      tiny=tiny, ms_alpha=ms_alpha, ms_beta=ms_beta)
        conv = tables.syndrome_violations(total, synd) == 0
        iters.copy_(torch.where(conv & (done == 0), it0 + k + 1, iters))
        done.copy_(done | conv.to(torch.int32))
    return total, c2v, done, iters


@_spanned
def bp_layered_sweeps_qc(tables, it0: int, maxiter: int, total, c2v, synd,
                         done, iters, *, rule: str = "sumproduct",
                         k_sweeps: int = 4, tiny: float = 1e-30,
                         ms_alpha: float = MINSUM_ALPHA,
                         ms_beta: float = 0.0):
    """Advance ``n = max(min(k_sweeps, maxiter - it0), 0)`` serial-C
    layered sweeps of the QC decoder, in place.

    Args:
      tables: :class:`QCTables` of the code.
      it0, maxiter: host ints; sweep ``swp = it0 + k + 1`` runs for
        ``k < n``.
      total: [nb_v, z, B] float32 totals, prior included.
      c2v: [E, z, B] messages, base edges flat in row order.
      synd: [nb_c, z, B] syndrome bits (int8 for the kernel).
      done, iters: [B] int32.
      rule: "sumproduct" (phi form), "tanhfb" or "minsum".

    Per sweep, frames done at its start are frozen; each block row in
    serial order updates its messages (every frame) and folds the deltas of
    the stored messages into the totals (frames not frozen); then the
    syndrome of ``total < 0`` is tested and a frame with no violation
    converges (``iters = swp`` the first time, ``done = 1``).  Returns
    ``(total, c2v, done, iters)``.

    CPU tensors run :func:`bp_layered_sweeps_qc_ref`.  CUDA tensors run the
    kernel, which takes contiguous tensors with f32 totals, f32 or bf16
    messages, int8 synd, int32 done/iters and rows up to ``MAX_DC`` wide;
    anything else raises.  As :func:`bp_decode_rounds_qc`, one call
    launches the copy in, the K sweeps and the copy out (``.plan``,
    ``.device_launches``).
    """
    if total.device.type == "cpu":
        return bp_layered_sweeps_qc_ref(
            tables, it0, maxiter, total, c2v, synd, done, iters, rule=rule,
            k_sweeps=k_sweeps, tiny=tiny, ms_alpha=ms_alpha,
            ms_beta=ms_beta)
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    _check_state(tables, total, c2v, synd, done, iters)
    _require_cuda("bp_layered_sweeps_qc", total)
    if total.dtype != torch.float32:
        raise TypeError(f"total must be float32, got {total.dtype}")
    codes = _dtype_codes("bp_layered_sweeps_qc", total.dtype, c2v.dtype)
    _require_int_state(synd, done, iters)
    _require_contiguous(total=total, c2v=c2v, synd=synd, done=done,
                        iters=iters)
    _require_tables(tables)
    n = _n_steps(k_sweeps, it0, maxiter)
    if n == 0:
        return total, c2v, done, iters
    B, z, dev = total.shape[-1], tables.z, total.device
    plan = _resident_plan_for(tables, B, total, rule, True)
    tb = tables.on(dev)
    # frame-major scratch [B, ...] of totals, messages and synd
    scratch = [torch.empty(B * rows * z, dtype=x.dtype, device=dev)
               for rows, x in ((tables.nb_v, total), (tables.E, c2v),
                               (tables.nb_c, synd))]
    n_launched = ctypes.c_int(0)
    lib = _library("bp_layered_sweeps_qc", "p" * 19 + "i" * 12 + "fff"
                   + "i" * 7 + "pp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bp_layered_sweeps_qc_launch(
            total.data_ptr(), c2v.data_ptr(), synd.data_ptr(),
            done.data_ptr(), iters.data_ptr(),
            *(x.data_ptr() for x in scratch),
            *(tb[name].data_ptr() for name in (
                "row_off", "edge_v", "edge_s", "level_off", "level_rows",
                "defer_base", "app_level_off", "app_vb", "app_off", "app_e",
                "app_s")),
            len(tables.levels), codes[1], tables.nb_c, tables.nb_v,
            tables.E, tables.dc_max, z, B, RULES[rule], int(it0), n,
            tables.defer_level_slots, float(tiny), float(ms_alpha),
            float(ms_beta), *_resident_launch_args(plan),
            ctypes.addressof(n_launched), stream,
        )
    _raise_on(err, "bp_layered_sweeps_qc")
    bp_layered_sweeps_qc.launches += 1
    bp_layered_sweeps_qc.iterations += n
    bp_layered_sweeps_qc.device_launches += n_launched.value
    bp_layered_sweeps_qc.plan = plan
    return total, c2v, done, iters


bp_layered_sweeps_qc.launches = 0
bp_layered_sweeps_qc.iterations = 0
bp_layered_sweeps_qc.device_launches = 0
bp_layered_sweeps_qc.plan = None


# --------------------------------------------------------------------- #
# Kernel 4: the fused check phase of the generic decoder (slot-major, masked)
# and kernel 5, the check-major phi update (the same source)

# checks per violation block of kernel 4 (csrc kChecksPerBlock)
GENERIC_BLOCK_C = 64


def _masked_messages(v2c, synd, mask, dim: int, rule: str, tiny: float,
                     ms_alpha: float, ms_beta: float):
    """New check->variable messages over padded rows: ``v2c`` with slots
    along ``dim``, ``mask`` broadcast like it (> 0 marks a real slot), in
    ``v2c``'s dtype.  phi multiplies by the mask before the left-fold sum
    (in at least float32, rounded once); min-sum and tanh-F/B select the
    +1e30 sentinel for padded slots; the sign parity runs over the real
    slots; the result is ``sign * pref * mag * mask``."""
    absv = torch.abs(v2c)
    if rule == "sumproduct":
        phim = phi_llr(absv, tiny) * mask
        # the sum runs in at least float32 and rounds once, as jnp.sum
        # does for bf16
        acc = torch.promote_types(phim.dtype, torch.float32)
        total = _fold_sum(phim.to(acc), dim).to(phim.dtype)
        mag = phi_llr(total - phim, tiny)
    else:
        absm = torch.where(mask > 0, absv, torch.tensor(
            BIG, dtype=v2c.dtype, device=v2c.device))
        if rule == "minsum":
            mag = minsum_mag(minsum_extrinsic_mag(absm, dim), ms_alpha,
                             ms_beta)
        else:
            mag = tanhfb_extrinsic_mag(absm, dim)
    neg = ((v2c < 0) & (mask > 0)).to(torch.int32)
    par = torch.sum(neg, dim=dim, keepdim=True) & 1
    sign = (1 - 2 * torch.bitwise_xor(par, neg)).to(v2c.dtype)
    pref = (1 - 2 * synd.to(torch.int32)).to(v2c.dtype).unsqueeze(dim)
    return sign * pref * mag * mask


def _generic_args(t, c2v, synd, c_mask, rule):
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    if t.dim() != 3 or c2v.shape != t.shape:
        raise ValueError(
            f"t and c2v must both be [dc, C, B], got {tuple(t.shape)} and "
            f"{tuple(c2v.shape)}"
        )
    dc, C, B = t.shape
    if tuple(synd.shape) != (C, B) or tuple(c_mask.shape) != (dc, C):
        raise ValueError(
            f"synd must be [C, B] = {(C, B)} and c_mask [dc, C] = "
            f"{(dc, C)}, got {tuple(synd.shape)} and {tuple(c_mask.shape)}"
        )
    if t.dtype != c2v.dtype:
        raise TypeError(f"t and c2v must share a dtype, got {t.dtype} and "
                        f"{c2v.dtype}")
    if not (t.device == c2v.device == synd.device == c_mask.device):
        raise ValueError("t, c2v, synd and c_mask must be on one device")


def bp_check_phase_generic_ref(t, c2v, synd, c_mask, tiny: float = 1e-30,
                               *, rule: str = "sumproduct",
                               ms_alpha: float = MINSUM_ALPHA,
                               ms_beta: float = 0.0):
    """Plain PyTorch generic check phase (any device); see
    :func:`bp_check_phase_generic` for the contract."""
    _generic_args(t, c2v, synd, c_mask, rule)
    out_dtype = t.dtype
    compute = torch.float32 if out_dtype == torch.bfloat16 else out_dtype
    t = t.to(compute)
    mask = c_mask.to(compute)[:, :, None]
    synd = synd.to(torch.int32)
    dc, C, B = t.shape

    # 1. convergence: parity of the real slots' hard decisions vs synd,
    # counted per block of GENERIC_BLOCK_C checks
    neg_t = (t < 0).to(torch.int32) * mask.to(torch.int32)
    viol = (torch.sum(neg_t, dim=0) & 1) != synd                # [C, B]
    n = -(-C // GENERIC_BLOCK_C)
    viol = torch.cat([viol.to(torch.int32), viol.new_zeros(
        (n * GENERIC_BLOCK_C - C, B), dtype=torch.int32)])
    viol = torch.sum(viol.view(n, GENERIC_BLOCK_C, B), dim=1,
                     dtype=torch.int32)

    # 2./3. extrinsic check update over the real slots
    new = _masked_messages(t - c2v.to(compute), synd, mask, 0, rule, tiny,
                           ms_alpha, ms_beta)
    return new.to(out_dtype), viol


@_spanned
def bp_check_phase_generic(t, c2v, synd, c_mask, tiny: float = 1e-30, *,
                           rule: str = "sumproduct",
                           ms_alpha: float = MINSUM_ALPHA,
                           ms_beta: float = 0.0):
    """Fused check phase in the generic decoder's slot-major layout.

    Args:
      t:      [dc, C, B] gathered variable totals.
      c2v:    [dc, C, B] previous check->variable messages, in t's dtype.
      synd:   [C, B] syndrome bits (0/1 int).
      c_mask: [dc, C] 1.0 on real slots, 0.0 on padding (any float mask:
              > 0 marks a real slot; the convergence parity weighs slots by
              its int cast, the messages are multiplied by it).
      rule:   "sumproduct" (phi form), "tanhfb" or "minsum"
              (``max(ms_alpha*min - ms_beta, 0)``).

    Per check: the parity of ``t < 0`` over the real slots against the
    syndrome (the convergence test); ``v2c = t - c2v`` (bf16 computes in
    f32); the all-but-one magnitude over the real slots (phi multiplies by
    the mask before its left-fold sum; min-sum and tanh-F/B give padded
    slots the +1e30 sentinel); the sign parity over the real slots; the
    ``(1 - 2*synd)`` prefactor; the product with the mask, so padded slots
    come out zero.  The same contract as the JAX package's
    ``bp_check_phase_generic``.

    Returns ``(c2v_new [dc, C, B] in t's dtype, viol [n, B] int32)`` with
    ``n = ceil(C / GENERIC_BLOCK_C)`` per-block violation counts;
    ``viol.sum(0) == 0`` is the per-frame convergence mask.

    CPU tensors run :func:`bp_check_phase_generic_ref`.  CUDA tensors run
    the kernel, which takes contiguous f32 or bf16 t/c2v, int32 synd and
    dc <= ``MAX_DC`` (the mask is read as float32); anything else raises.
    """
    if t.device.type == "cpu":
        return bp_check_phase_generic_ref(t, c2v, synd, c_mask, tiny,
                                          rule=rule, ms_alpha=ms_alpha,
                                          ms_beta=ms_beta)
    _generic_args(t, c2v, synd, c_mask, rule)
    _require_cuda("bp_check_phase_generic", t)
    code = _dtype_codes("bp_check_phase_generic", t.dtype, t.dtype)[0]
    if synd.dtype != torch.int32:
        raise TypeError(f"synd must be int32, got {synd.dtype}")
    _require_contiguous(t=t, c2v=c2v, synd=synd)
    dc, C, B = t.shape
    if dc > MAX_DC:
        raise ValueError(f"check degree {dc} exceeds the kernel's {MAX_DC}")
    mask = c_mask.to(torch.float32).contiguous()
    n = -(-C // GENERIC_BLOCK_C)
    out = torch.empty_like(t)
    viol = torch.zeros((n, B), dtype=torch.int32, device=t.device)
    plan = _plan_for(1, dc, C, B, t, t, rule, True, t, c2v, synd, out)
    lib = _library("bp_check_phase_generic", "pppppp" + "i" * 5 + "fff"
                   + "i" * 7 + "p")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.bp_check_phase_generic_launch(
            t.data_ptr(), c2v.data_ptr(), synd.data_ptr(), mask.data_ptr(),
            out.data_ptr(), viol.data_ptr(), code, dc, C, B, RULES[rule],
            float(tiny), float(ms_alpha), float(ms_beta),
            *_tile_launch_args(plan), stream,
        )
    _raise_on(err, "bp_check_phase_generic")
    bp_check_phase_generic.launches += 1
    bp_check_phase_generic.plan = plan
    return out, viol


bp_check_phase_generic.launches = 0
bp_check_phase_generic.plan = None


def _check_major_args(v2c_c, synd, c_mask):
    if v2c_c.dim() != 3:
        raise ValueError(f"v2c_c must be [C, dc, B], got {tuple(v2c_c.shape)}")
    C, dc, B = v2c_c.shape
    if tuple(synd.shape) != (C, B) or tuple(c_mask.shape) != (C, dc):
        raise ValueError(
            f"synd must be [C, B] = {(C, B)} and c_mask [C, dc] = "
            f"{(C, dc)}, got {tuple(synd.shape)} and {tuple(c_mask.shape)}"
        )
    if not (v2c_c.device == synd.device == c_mask.device):
        raise ValueError("v2c_c, synd and c_mask must be on one device")


def check_node_update_fused_ref(v2c_c, synd, c_mask, tiny: float = 1e-30):
    """Plain PyTorch check-major phi update (any device); see
    :func:`check_node_update_fused` for the contract."""
    _check_major_args(v2c_c, synd, c_mask)
    mask = c_mask.to(v2c_c.dtype)[:, :, None]
    return _masked_messages(v2c_c, synd, mask, 1, "sumproduct", tiny,
                            MINSUM_ALPHA, 0.0)


@_spanned
def check_node_update_fused(v2c_c, synd, c_mask, tiny: float = 1e-30):
    """Check-major phi sum-product check update, the counterpart of the JAX
    package's ``check_node_update_pallas`` (body ``_kernel``).

    Args:
      v2c_c:  [C, dc, B] variable->check messages.
      synd:   [C, B] syndrome bits (0/1 int).
      c_mask: [C, dc] 1.0 on real slots, 0.0 on padding.

    Returns ``c2v [C, dc, B]``: per check, ``phi(sum of phi(|v|) * mask -
    phi(|v_d|) * mask)`` with the sign parity over the real slots and the
    ``(1 - 2*synd)`` prefactor, times the mask.  As in the JAX kernel the
    arithmetic runs in the input dtype, with no upcast (in bf16 every
    operation rounds to bf16), and there is no convergence output.

    CPU tensors run :func:`check_node_update_fused_ref`.  CUDA tensors run
    kernel 5 (its plan from :func:`check_major_plan`, kept in ``.plan``),
    which takes contiguous float32 or bfloat16 messages, int32 synd and
    dc <= ``MAX_DC``; anything else raises.
    """
    if v2c_c.device.type == "cpu":
        return check_node_update_fused_ref(v2c_c, synd, c_mask, tiny)
    _check_major_args(v2c_c, synd, c_mask)
    _require_cuda("check_node_update_fused", v2c_c)
    code = _dtype_codes("check_node_update_fused", v2c_c.dtype,
                        v2c_c.dtype)[0]
    if synd.dtype != torch.int32:
        raise TypeError(f"synd must be int32, got {synd.dtype}")
    _require_contiguous(v2c_c=v2c_c, synd=synd)
    C, dc, B = v2c_c.shape
    if dc > MAX_DC:
        raise ValueError(f"check degree {dc} exceeds the kernel's {MAX_DC}")
    # the mask as the plain version holds it: in the messages' dtype
    mask = c_mask.to(v2c_c.dtype).to(torch.float32).contiguous()
    out = torch.empty_like(v2c_c)
    aligned = all(y.data_ptr() % 16 == 0 for y in (v2c_c, synd, out))
    sms = torch.cuda.get_device_properties(
        v2c_c.device).multi_processor_count
    plan = check_major_plan(C, dc, B, v2c_c.element_size(), aligned=aligned,
                            sms=sms)
    lib = _library("bp_check_phase_generic", "pppp" + "iiii" + "f"
                   + "i" * 8 + "p", "check_node_update_launch")
    with torch.cuda.device(v2c_c.device):
        stream = torch.cuda.current_stream(v2c_c.device).cuda_stream
        err = lib.check_node_update_launch(
            v2c_c.data_ptr(), synd.data_ptr(), mask.data_ptr(),
            out.data_ptr(), code, dc, C, B, float(tiny), plan.checks,
            plan.frames, plan.stages, int(plan.path == "staged"),
            plan.threads, plan.grid, plan.blocks_per_sm, plan.smem, stream,
        )
    _raise_on(err, "check_node_update_fused")
    check_node_update_fused.launches += 1
    check_node_update_fused.plan = plan
    return out


check_node_update_fused.launches = 0
check_node_update_fused.plan = None


# --------------------------------------------------------------------- #
# Gather 2 of the generic decoder: each variable's totals from its real
# edges (csrc/bp_var_totals_generic.cu; no Pallas kernel: the JAX package
# leaves this step to XLA)


def var_totals_vec(B: int, size: int, aligned: bool) -> int:
    """Frames a thread of the fold kernel takes: 16 bytes of a message row
    (``16 // size``) where B fills whole 16-byte units and every pointer is
    16-byte aligned, else 1."""
    wide = 16 // size
    return wide if aligned and B % wide == 0 else 1


def _var_totals_args(prior, c2v, table, degree):
    if prior.dim() != 2 or c2v.dim() < 2 or table.dim() != 2 \
            or degree.dim() != 1:
        raise ValueError(
            f"prior must be [V, B], c2v [..., B], table [dv_max, V] and "
            f"degree [V], got {tuple(prior.shape)}, {tuple(c2v.shape)}, "
            f"{tuple(table.shape)} and {tuple(degree.shape)}")
    V, B = prior.shape
    if c2v.shape[-1] != B or table.shape[1] != V or degree.shape[0] != V:
        raise ValueError(
            f"c2v [..., {B}], table [dv_max, {V}] and degree [{V}] must "
            f"match prior [V, B] = {(V, B)}, got {tuple(c2v.shape)}, "
            f"{tuple(table.shape)} and {tuple(degree.shape)}")
    want = torch.float64 if c2v.dtype == torch.float64 else torch.float32
    if prior.dtype != want:
        raise TypeError(f"prior must be in the sum dtype {want} of "
                        f"{c2v.dtype} messages, got {prior.dtype}")
    if not (prior.device == c2v.device == table.device == degree.device):
        raise ValueError("prior, c2v, table and degree must be on one "
                         "device")


def bp_var_totals_generic_ref(prior, c2v, table, degree):
    """Plain PyTorch gather 2 (any device): the masked left fold over every
    one of the dv_max slots; see :func:`bp_var_totals_generic`."""
    _var_totals_args(prior, c2v, table, degree)
    flat = c2v.reshape(-1, c2v.shape[-1])
    mask = (torch.arange(table.shape[0], device=table.device)[:, None]
            < degree).to(prior.dtype)
    acc = None
    for d in range(table.shape[0]):
        x = flat.index_select(0, table[d]).to(prior.dtype) \
            * mask[d][:, None]
        acc = x if acc is None else acc + x
    return (prior + acc).to(c2v.dtype)


@_spanned
def bp_var_totals_generic(prior, c2v, table, degree):
    """Gather 2 of the generic decoder: each variable's new totals.

    Args:
      prior:  [V, B] the decode's prior in the sum dtype (float32; float64
              for float64 messages).
      c2v:    [dc_max, C, B] (any shape [..., B] whose flat rows ``table``
              indexes) check->variable messages, in the storage dtype.
      table:  [dv_max, V] integer: the flat row of c2v of each variable's
              d-th edge in edge-id order (0 on padded slots).
      degree: [V] integer: each variable's real edges, ``table``'s first
              rows.

    Returns ``round(prior + fold)`` [V, B] in c2v's dtype, where ``fold``
    is the left fold in the sum dtype over the dv_max slots of ``c2v[table[
    d]] * (d < degree)``: the real messages in slot order, and for a
    variable with fewer edges the padded slots' ``c2v row 0 * 0.0`` (a +-0
    that can turn a fold of -0 into +0).

    CPU tensors run :func:`bp_var_totals_generic_ref`.  CUDA tensors run
    the kernel, which reads only each variable's real rows and is bit-equal
    to it, zero signs included; it takes contiguous float32 or bfloat16
    messages, a float32 prior and int32 ``table`` and ``degree``; anything
    else raises.
    """
    if c2v.device.type == "cpu":
        return bp_var_totals_generic_ref(prior, c2v, table, degree)
    _var_totals_args(prior, c2v, table, degree)
    _require_cuda("bp_var_totals_generic", c2v)
    code = _dtype_codes("bp_var_totals_generic", c2v.dtype, c2v.dtype)[0]
    if table.dtype != torch.int32 or degree.dtype != torch.int32:
        raise TypeError(f"table and degree must be int32, got {table.dtype} "
                        f"and {degree.dtype}")
    _require_contiguous(prior=prior, c2v=c2v, table=table, degree=degree)
    (V, B), dv_max = prior.shape, table.shape[0]
    out = torch.empty((V, B), dtype=c2v.dtype, device=c2v.device)
    if B == 0:
        return out
    aligned = all(x.data_ptr() % 16 == 0 for x in (prior, c2v, out))
    vec = var_totals_vec(B, c2v.element_size(), aligned)
    lib = _library("bp_var_totals_generic", "ppppp" + "i" * 5 + "p")
    with torch.cuda.device(c2v.device):
        stream = torch.cuda.current_stream(c2v.device).cuda_stream
        err = lib.bp_var_totals_generic_launch(
            prior.data_ptr(), c2v.data_ptr(), table.data_ptr(),
            degree.data_ptr(), out.data_ptr(), code, V, B, dv_max, vec,
            stream)
    _raise_on(err, "bp_var_totals_generic")
    bp_var_totals_generic.launches += 1
    bp_var_totals_generic.vec = vec
    return out


bp_var_totals_generic.launches = 0
bp_var_totals_generic.vec = None


# --------------------------------------------------------------------- #
# The variable pass of the dense QC decoder: gather 2 and the next gather 1
# in one (the same source's QC entry)


# the dtypes the pass takes, plain or on the card; the dense loop keeps its
# earlier steps for the others
VAR_PASS_DTYPES = (torch.float32, torch.bfloat16)


def _var_pass_args(prior, c2v, rows, degree, t):
    if c2v.dim() < 2 or rows.dim() != 2 or degree.dim() != 1:
        raise ValueError(
            f"c2v must be [..., B], rows [dv_max, V] and degree [V], got "
            f"{tuple(c2v.shape)}, {tuple(rows.shape)} and "
            f"{tuple(degree.shape)}")
    B, V = c2v.shape[-1], rows.shape[1]
    if t.shape != c2v.shape or prior.shape[-1:] != (B,) \
            or prior.numel() != V * B or degree.shape[0] != V:
        raise ValueError(
            f"t {tuple(t.shape)} must match c2v {tuple(c2v.shape)}, and "
            f"prior [..., B] {tuple(prior.shape)} and degree "
            f"{tuple(degree.shape)} the {V} variables of rows")
    if not (prior.dtype == c2v.dtype == t.dtype):
        raise TypeError(f"prior, c2v and t must share one dtype, got "
                        f"{prior.dtype}, {c2v.dtype} and {t.dtype}")
    if c2v.dtype not in VAR_PASS_DTYPES:
        raise TypeError(f"the variable pass takes float32 or bfloat16, got "
                        f"{c2v.dtype}")
    if not (prior.device == c2v.device == rows.device == degree.device
            == t.device):
        raise ValueError("prior, c2v, rows, degree and t must be on one "
                         "device")
    _require_contiguous(t=t)


def bp_var_pass_qc_ref(prior, c2v, rows, degree, t):
    """Plain PyTorch variable pass (any device, no host sync): each
    variable's messages left-folded slot by slot in float32, the order of
    ``models/qc_decoder.fold_incoming``, plus the prior, then each real
    row of t set to its variable's total; see :func:`bp_var_pass_qc`."""
    _var_pass_args(prior, c2v, rows, degree, t)
    (dv_max, V), B = rows.shape, c2v.shape[-1]
    flat, t_rows = c2v.reshape(-1, B), t.view(-1, B)
    real = degree.unsqueeze(0) > torch.arange(
        dv_max, device=degree.device).unsqueeze(1)            # [dv_max, V]
    fold = torch.zeros((V, B), dtype=torch.float32, device=c2v.device)
    for d in range(dv_max):
        m = flat.index_select(0, rows[d]).float()
        fold = torch.where(real[d].unsqueeze(1), m if d == 0 else fold + m,
                           fold)
    total = (prior.reshape(V, B).float() + fold).to(c2v.dtype)
    # each row of t -> the variable whose message it holds, -1 for the
    # padded slots; the table's padded entries land on a spare last row
    R = t_rows.shape[0]
    lanes = torch.arange(V, device=c2v.device).expand(dv_max, V)
    owner = torch.full((R + 1,), -1, dtype=torch.long, device=c2v.device)
    owner.scatter_(0, torch.where(real, rows.long(), R).reshape(-1),
                   lanes.reshape(-1))
    owner = owner[:R]
    t_rows.copy_(torch.where(owner.unsqueeze(1) >= 0,
                             total.index_select(0, owner.clamp(min=0)),
                             t_rows))
    return total.view(prior.shape)


@_spanned
def bp_var_pass_qc(prior, c2v, rows, degree, t):
    """The dense QC decoder's variable pass: each variable lane's new
    totals, also written into the check phase's next input.

    Args:
      prior:  [..., B] (V flat rows) the decode's prior, in c2v's dtype.
      c2v:    [nb_c, dc, z, B] (any shape [..., B] whose flat rows ``rows``
              indexes) check->variable messages.
      rows:   [dv_max, V] integer: the flat row of c2v of each variable's
              d-th message, in the fold's order (the check block, then the
              slot, ascending); 0 on padded slots.
      degree: [V] integer: each variable's messages, ``rows``' first rows.
      t:      c2v's shape and dtype, contiguous: the check phase's input,
              updated in place; the same flat rows as the messages hold
              each variable's total, other rows (the +1e30 padded slots of
              short check rows) are not written.

    Returns ``round(prior + fold)`` in prior's shape and c2v's dtype, where
    ``fold`` is the left fold in float32 of the variable's messages in
    slot order, +0 for a variable without messages; and writes it to
    ``t``'s row ``rows[d, v]`` for every ``d < degree[v]``.

    CPU tensors run :func:`bp_var_pass_qc_ref`.  CUDA tensors run the
    kernel, which is bit-equal to it, zero signs included; it takes
    contiguous tensors and int32 ``rows`` and ``degree``; anything else
    raises.  Both take float32 or bfloat16 (``VAR_PASS_DTYPES``).
    """
    if c2v.device.type == "cpu":
        return bp_var_pass_qc_ref(prior, c2v, rows, degree, t)
    _var_pass_args(prior, c2v, rows, degree, t)
    _require_cuda("bp_var_pass_qc", c2v)
    code = _dtype_codes("bp_var_pass_qc", c2v.dtype, c2v.dtype)[0]
    if rows.dtype != torch.int32 or degree.dtype != torch.int32:
        raise TypeError(f"rows and degree must be int32, got {rows.dtype} "
                        f"and {degree.dtype}")
    _require_contiguous(prior=prior, c2v=c2v, rows=rows, degree=degree)
    (dv_max, V), B = rows.shape, c2v.shape[-1]
    out = torch.empty_like(prior)
    if B == 0:
        return out
    aligned = all(x.data_ptr() % 16 == 0 for x in (prior, c2v, out, t))
    vec = var_totals_vec(B, c2v.element_size(), aligned)
    lib = _library("bp_var_totals_generic", "pppppp" + "i" * 5 + "p",
                   "bp_var_pass_qc_launch")
    with torch.cuda.device(c2v.device):
        stream = torch.cuda.current_stream(c2v.device).cuda_stream
        err = lib.bp_var_pass_qc_launch(
            prior.data_ptr(), c2v.data_ptr(), rows.data_ptr(),
            degree.data_ptr(), out.data_ptr(), t.data_ptr(), code, V, B,
            dv_max, vec, stream)
    _raise_on(err, "bp_var_pass_qc")
    bp_var_pass_qc.launches += 1
    bp_var_pass_qc.vec = vec
    return out


bp_var_pass_qc.launches = 0
bp_var_pass_qc.vec = None


# --------------------------------------------------------------------- #
# The softening round's inputs: hard decision, softening metric, word and
# poly LLRs in one pass (csrc/softening_inputs.cu; no Pallas kernel: the JAX
# package leaves this step to XLA)


# the sample dtypes and the orders M whose kernel was shown bit-equal to the
# plain version on the card; other mappers keep the plain version
SOFTENING_DTYPES = (torch.float32, torch.bfloat16)
SOFTENING_ORDERS = (2, 4, 8, 16)
# the kernel's grid: at most this many blocks of 256 threads an SM (the
# blocks stride over the rows, so each fills its table once)
SOFTENING_BLOCKS_PER_SM = 8
# the kernel's sample dtypes, in its numbering
_SAMPLE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def softening_takes(nm, llr_mode: str) -> bool:
    """Whether :func:`softening_inputs` takes a softening round of mapper
    ``nm`` with ``llr_mode`` LLRs: poly LLRs on the erf marginal CDF, a
    float32 or bfloat16 mapper, an order in ``SOFTENING_ORDERS``.  Every
    other round runs :func:`softening_inputs_ref`."""
    return (llr_mode == "poly" and nm.fy_mode == "erf"
            and nm.dtype in SOFTENING_DTYPES
            and nm.order in SOFTENING_ORDERS)


def softening_table_size(M: int, bps: int) -> int:
    """Floats of the kernel's table (``NoiseMapper._ensure_softening_tab``)
    at order ``M``."""
    from ..models.noisemapper import _POLY_DEG, _POLY_NSEG

    return 7 * M + _POLY_NSEG * M * (_POLY_DEG + 1) * bps


def _softening_args(nm, x, y, s2b):
    if y.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"x and y must be [S, B] of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if y.dtype != nm.dtype or x.dtype != torch.int32:
        raise TypeError(f"y must be in the mapper's dtype {nm.dtype} and x "
                        f"int32, got {y.dtype} and {x.dtype}")
    if tuple(s2b.shape) != (nm.order, nm.bit_per_symbol) \
            or s2b.dtype != torch.int32:
        raise ValueError(f"s2b must be int32 [{nm.order}, "
                         f"{nm.bit_per_symbol}], got {s2b.dtype} "
                         f"{tuple(s2b.shape)}")
    if not (x.device == y.device == s2b.device == nm._c.device):
        raise ValueError("x, y, s2b and the mapper must be on one device")
    if not softening_takes(nm, "poly"):
        raise TypeError(
            f"softening_inputs takes float32 or bfloat16 mappers of order "
            f"{SOFTENING_ORDERS} on the erf CDF, got {nm.dtype}, order "
            f"{nm.order}, fy_mode {nm.fy_mode!r}")


def softening_inputs_ref(nm, x, y, alpha, s2b):
    """Plain PyTorch softening inputs with poly LLRs (any device, any
    mapper): Bob's word [N, B] and Alice's softening LLRs [N, B] from the
    transmitted symbols ``x`` and received samples ``y`` ([S, B]),
    ``N = S * bps``; the engine's plain poly path."""
    bps = nm.bit_per_symbol
    shape_nb = (x.shape[0] * bps, x.shape[1])

    def bits_nb(table_col_fn, idx_sb):
        cols = [table_col_fn(b, idx_sb) for b in range(bps)]
        return torch.stack(cols, dim=1).reshape(shape_nb)

    x_hat = nm.hard_decide_index(y)
    n_hat = nm.map_noise(y, x_hat)
    word = bits_nb(lambda b, idx: s2b[:, b][idx.long()], x_hat)
    alpha = torch.tensor(alpha, dtype=nm.dtype)
    llr_bits = nm._poly_llr_bits(n_hat, x)
    lappr = alpha * bits_nb(lambda b, _: llr_bits[b], x_hat)
    return lappr, word


@_spanned
def softening_inputs(nm, x, y, alpha, s2b):
    """A softening round's inputs with poly LLRs on the erf CDF: Bob's word
    and Alice's LLRs, as :func:`softening_inputs_ref` computes them.

    Args:
      nm:    the point's NoiseMapper (``softening_takes(nm, "poly")``).
      x:     [S, B] int32 Alice's symbols.
      y:     [S, B] Bob's samples, in the mapper's dtype.
      alpha: the LLR scale (a Python number).
      s2b:   [M, bps] int32 each symbol's Gray bits.

    Returns ``(lappr, word)``, each [S * bps, B]: row ``s * bps + b`` holds
    bit ``b`` of symbol ``s``; the LLRs in y's dtype, the word int32.

    CPU tensors run :func:`softening_inputs_ref`.  CUDA tensors run the
    kernel on the mapper's table (``NoiseMapper._ensure_softening_tab``,
    built at the point's set-up, else on the first call), bit-equal to it;
    it takes contiguous
    x and y; anything else, and any mapper ``softening_takes`` refuses,
    raises on either device.
    """
    _softening_args(nm, x, y, s2b)
    if y.device.type == "cpu":
        return softening_inputs_ref(nm, x, y, alpha, s2b)
    _require_cuda("softening_inputs", y)
    _require_contiguous(x=x, y=y, s2b=s2b)
    from ..models.noisemapper import _POLY_D, _POLY_NSEG

    (S, B), M, bps = y.shape, nm.order, nm.bit_per_symbol
    nm._ensure_softening_tab()
    tab = nm._softening_tab
    if tab.numel() != softening_table_size(M, bps):
        raise ValueError(f"the mapper's table holds {tab.numel()} floats, "
                         f"not {softening_table_size(M, bps)}")
    lappr = torch.empty((S * bps, B), dtype=y.dtype, device=y.device)
    word = torch.empty((S * bps, B), dtype=torch.int32, device=y.device)
    if S == 0 or B == 0:
        return lappr, word
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, lappr, word))
    vec = var_totals_vec(B, y.element_size(), aligned)
    # each host constant as the plain version's Python float operand
    d = _POLY_D
    wlo = float(np.log(d) - np.log1p(d))
    scale = float(1.0 / (-2.0 * wlo)) * _POLY_NSEG
    tmax = _POLY_NSEG * (1.0 - 1e-7)
    alpha_dt = float(torch.tensor(alpha, dtype=y.dtype))   # a host tensor
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    lib = _library("softening_inputs", "pppppp" + "i" * 6 + "f" * 6 + "p")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.softening_inputs_launch(
            y.data_ptr(), x.data_ptr(), tab.data_ptr(), s2b.data_ptr(),
            lappr.data_ptr(), word.data_ptr(), _SAMPLE_CODES[y.dtype], M, S,
            B, vec, SOFTENING_BLOCKS_PER_SM * sms, d, 1.0 + d, wlo, scale,
            tmax, alpha_dt, stream)
    _raise_on(err, "softening_inputs")
    softening_inputs.launches += 1
    softening_inputs.vec = vec
    return lappr, word


softening_inputs.launches = 0
softening_inputs.vec = None


# --------------------------------------------------------------------- #
# Shared-memory attribute, set once per (kernel instance, device, size)


class SmemGrants:
    """The most dynamic shared memory each key (a kernel instance on a
    device) has been granted by ``cudaFuncSetAttribute`` in this process.
    The attribute is a ceiling, so a launch sets it only when it asks for
    more than the key was granted (:meth:`needs`), and records it once the
    card took it (:meth:`grant`); a refused request records nothing."""

    def __init__(self):
        self.granted = {}

    def needs(self, key, nbytes: int) -> bool:
        return nbytes > self.granted.get(key, -1)

    def grant(self, key, nbytes: int) -> None:
        if self.needs(key, nbytes):
            self.granted[key] = nbytes


# --------------------------------------------------------------------- #
# Kernel 6: the check-math attribution probe, on warp-specialised staged
# tiles of its own (csrc/check_math_probe.cu)

# the probe's slot maths, in the kernel's numbering (none is a decoder rule
# but phi)
PROBE_MATHS = {"phi": 0, "copy": 3, "minsum": 4}
PROBE_MINSUM_SCALE = 0.8125     # the probe's min-sum normalisation
_PROBE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PROBE_CONSUMERS = 256       # consumer threads a block (kConsumers)
PROBE_PRODUCER = 32         # the bulk path's producer warp (kProducer)
PROBE_BLOCKS_PER_SM = 4     # blocks an SM at most (kBlocksPerSm: the launch
                            # bounds' budget, 56 registers a thread)
PROBE_REGISTER_DC = 8       # widest row whose slot values stay in registers
PROBE_PAIRS_MAX = 8         # pairs a consumer thread takes a tile at most
PROBE_STAGES_MAX = 4        # stages of the bulk path's ring at most
_PROBE_SLOTS = {"none": 0, "registers": 1, "scratch": 2}
# pairs a consumer thread takes a tile, largest first
_PROBE_PAIRS = tuple(PROBE_PAIRS_MAX >> k
                     for k in range(PROBE_PAIRS_MAX.bit_length()))
_PROBE_GRANTS = SmemGrants()


@dataclass(frozen=True)
class ProbeTilePlan:
    """Launch shape of one call of kernel 6."""

    path: str           # "bulk": TMA loads and stores through a ring that a
                        # producer warp keeps; "thread": plain loads/stores
    slots: str          # where a pair's slot values wait for pass 2:
                        # "registers", "scratch" (shared memory) or "none"
                        # (copy has no pass 2)
    threads: int        # threads a block: PROBE_CONSUMERS, plus the
                        # producer warp on the bulk path
    checks: int         # checks per tile: (PROBE_CONSUMERS // frames) times
                        # the pairs a consumer thread takes
    frames: int         # frames per tile
    stages: int         # stages of the ring (0 on the thread path)
    smem: int           # dynamic shared memory a block, bytes
    blocks_per_sm: int  # blocks resident on one SM
    tiles: int          # tiles of the call
    grid: int           # persistent blocks launched


def probe_tile_smem(dc: int, checks: int, frames: int, stages: int,
                    size: int, scratch: bool) -> int:
    """Dynamic shared memory of a kernel 6 plan, bytes: ``stages`` stages
    of [t, c2v, syndrome] tiles (the new messages overwrite the c2v tile),
    a full and an empty mbarrier a stage, and, for the scratch slots, one
    f32 column of ``dc`` values a consumer thread (``probe_layout`` in the
    source)."""
    pairs = checks * frames
    stage = 2 * _up16(dc * pairs * size) + _up16(pairs * 4)
    return (stages * (stage + 16)
            + (dc * PROBE_CONSUMERS * 4 if scratch else 0))


@functools.lru_cache(maxsize=256)
def probe_tile_plan(nb_c: int, dc: int, z: int, B: int, size: int,
                    math: str, *, aligned: bool = True,
                    sms: int = H100_SMS) -> ProbeTilePlan:
    """The launch plan of one call of kernel 6 on [nb_c, dc, z, B] tensors
    of element size ``size`` bytes with slot math ``math``, on a card with
    ``sms`` SMs.

    A tile is ``checks`` checks of one block row by ``frames`` frames (all
    B up to ``PROBE_CONSUMERS``); a consumer thread owns one frame of it
    and every ``PROBE_CONSUMERS // frames``-th check.  The bulk path needs
    16-byte units (B times ``size`` a multiple of 16 and ``aligned``
    pointers); else the thread path, with no ring, plain loads and one
    pair a thread a tile.  Phi and min-sum keep a pair's slot values from
    pass 1 to pass 2 in registers on the bulk path for dc <=
    ``PROBE_REGISTER_DC``, else in a shared-memory scratch; copy keeps
    none.  Warps an SM come first: from ``PROBE_BLOCKS_PER_SM`` blocks an
    SM down, the largest tile (up to ``PROBE_PAIRS_MAX`` pairs a thread)
    whose ring of two stages fits that many blocks; the ring then takes as
    many stages, up to ``PROBE_STAGES_MAX``, as still fit.  The grid is
    persistent: that many blocks an SM, each a contiguous run of tiles.

    The bound is the bytes (t, c2v and synd in, out and the counts out:
    166 MB in bf16 at [18, 6, 1800, 128], 0.050 ms at 3.35 TB/s); phi's
    two precise transcendental chains a slot need the card to issue far
    more instructions than copy, and warps an SM hide their latency,
    hence warps first."""
    if math not in PROBE_MATHS:
        raise ValueError(f"unknown probe math {math!r}")
    if not (1 <= dc <= MAX_DC) or min(nb_c, z, B) < 1 or size not in (2, 4):
        raise ValueError(f"no probe tile plan for nb_c={nb_c} dc={dc} "
                         f"z={z} B={B} size={size}")
    bulk = aligned and (B * size) % 16 == 0
    frames = min(B, PROBE_CONSUMERS)
    rows = PROBE_CONSUMERS // frames
    if math == "copy":
        slots = "none"
    else:
        slots = ("registers" if bulk and dc <= PROBE_REGISTER_DC
                 else "scratch")
    scratch = slots == "scratch"

    def smem(checks, stages):
        return probe_tile_smem(dc, checks, frames, stages, size, scratch)

    def fits(checks, stages, blocks):
        need = smem(checks, stages)
        return need <= SMEM_BLOCK_MAX and blocks * (need + 1024) <= SMEM_SM

    if bulk:
        checks, blocks = next(
            (rows * m, blocks)
            for blocks in range(PROBE_BLOCKS_PER_SM, 0, -1)
            for m in _PROBE_PAIRS if fits(rows * m, 2, blocks))
        stages = 2
        while stages < PROBE_STAGES_MAX and fits(checks, stages + 1, blocks):
            stages += 1
    else:
        checks, stages = rows, 0
        blocks = next(b for b in range(PROBE_BLOCKS_PER_SM, 0, -1)
                      if fits(checks, 0, b))
    tiles = nb_c * -(-z // checks) * -(-B // frames)
    return ProbeTilePlan(
        "bulk" if bulk else "thread", slots,
        PROBE_CONSUMERS + (PROBE_PRODUCER if bulk else 0), checks, frames,
        stages, smem(checks, stages), blocks, tiles,
        min(tiles, blocks * sms))


def probe_instance(plan: ProbeTilePlan, dtype, math: str, dc: int):
    """The kernel instance a plan launches: (dtype, math, the compile-time
    dc of the register slots, 0 for the others, path)."""
    return (str(dtype), math, dc if plan.slots == "registers" else 0,
            plan.path)


def _probe_args(t, c2v, synd, math):
    if math not in PROBE_MATHS:
        raise ValueError(f"unknown probe math {math!r}; one of "
                         f"{sorted(PROBE_MATHS)}")
    _check_args(t, c2v, synd, "sumproduct")
    if c2v.dtype != t.dtype:
        raise TypeError(f"t and c2v must share a dtype, got {t.dtype} and "
                        f"{c2v.dtype}")


def check_math_probe_ref(t, c2v, synd, math: str):
    """Plain PyTorch version of :func:`check_math_probe` (any device)."""
    _probe_args(t, c2v, synd, math)
    tf = t.float()
    synd = synd.to(torch.int32)
    parity = torch.sum((tf < 0).to(torch.int32), dim=1) & 1
    viol = torch.sum((parity != synd).to(torch.int32), dim=1,
                     dtype=torch.int32)                        # [nb_c, B]
    v2c = tf - c2v.float()
    if math == "copy":
        out = v2c
    elif math == "phi":
        out = _check_messages(v2c, synd, 1, "sumproduct", 1e-30,
                              MINSUM_ALPHA, 0.0)
    else:
        m = torch.abs(v2c)
        min1 = torch.amin(m, dim=1, keepdim=True)
        at_min = m <= min1
        min2 = torch.amin(torch.where(at_min, m.new_tensor(BIG), m), dim=1,
                          keepdim=True)
        mag = PROBE_MINSUM_SCALE * torch.where(at_min, min2, min1)
        out = _signed(v2c, synd, 1, mag)
    return out.to(t.dtype), viol


def check_math_probe(t, c2v, synd, math: str):
    """The check-math attribution probe: the QC check phase's memory
    pattern (kernel 1's) with one of the probe's slot maths.

    Args:
      t, c2v: [nb_c, dc, z, B], both float32 or both bfloat16.
      synd:   [nb_c, z, B] syndrome bits (0/1 int).
      math:   "phi" (kernel 1's phi sum-product), "copy" (``t - c2v``) or
              "minsum" (the probe's own normalized min-sum: a slot at the
              minimum magnitude, ties included, gets the least magnitude
              strictly above it, 1e30 if none, every other slot the
              minimum; times 0.8125, the sign parity and ``1 - 2*synd``).

    Everything computes in float32; returns ``(out [nb_c, dc, z, B] in t's
    dtype, viol [nb_c, B] int32)``, the violated checks per (block row,
    frame) of t's hard decisions.

    CPU tensors run :func:`check_math_probe_ref`.  CUDA tensors run the
    kernel (contiguous, int32 synd, dc <= ``MAX_DC``) with the plan of
    :func:`probe_tile_plan` (kept in ``.plan``); anything else raises.
    """
    if t.device.type == "cpu":
        return check_math_probe_ref(t, c2v, synd, math)
    _probe_args(t, c2v, synd, math)
    _require_cuda("check_math_probe", t)
    if t.dtype not in _PROBE_DTYPES:
        raise TypeError(f"check_math_probe kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    if synd.dtype != torch.int32:
        raise TypeError(f"synd must be int32, got {synd.dtype}")
    _require_contiguous(t=t, c2v=c2v, synd=synd)
    nb_c, dc, z, B = t.shape
    if dc > MAX_DC:
        raise ValueError(f"check degree {dc} exceeds the kernel's {MAX_DC}")
    out = torch.empty_like(c2v)
    viol = torch.zeros((nb_c, B), dtype=torch.int32, device=t.device)
    aligned = all(y.data_ptr() % 16 == 0 for y in (t, c2v, synd, out))
    plan = probe_tile_plan(
        nb_c, dc, z, B, t.element_size(), math, aligned=aligned,
        sms=torch.cuda.get_device_properties(t.device).multi_processor_count)
    key = (probe_instance(plan, t.dtype, math, dc), t.device.index)
    set_attr = _PROBE_GRANTS.needs(key, plan.smem)
    lib = _library("check_math_probe", "ppppp" + "i" * 16 + "p")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.check_math_probe_launch(
            t.data_ptr(), c2v.data_ptr(), synd.data_ptr(), out.data_ptr(),
            viol.data_ptr(), _PROBE_DTYPES[t.dtype], nb_c, dc, z, B,
            PROBE_MATHS[math], int(plan.path == "bulk"),
            _PROBE_SLOTS[plan.slots], plan.threads, plan.checks, plan.frames,
            plan.stages, plan.smem, plan.blocks_per_sm, plan.grid,
            int(set_attr), stream,
        )
    _raise_on(err, "check_math_probe")
    if set_attr:
        _PROBE_GRANTS.grant(key, plan.smem)
    check_math_probe.launches += 1
    check_math_probe.plan = plan
    return out, viol


check_math_probe.launches = 0
check_math_probe.plan = None


# --------------------------------------------------------------------- #
# Kernel 7: the packed-bf16 elementwise probe

CHAIN_MODES = {"mac": 0, "exp": 1}
# the chain's constants, exact in bfloat16: 1 - 2^-8 and 2^-6
CHAIN_A, CHAIN_B = 0.99609375, 0.015625


def _chain_args(x, mode, iters, chain):
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}; one of "
                         f"{sorted(CHAIN_MODES)}")
    if iters < 0 or chain < 0:
        raise ValueError(f"iters and chain must be >= 0, got {iters}, "
                         f"{chain}")
    if x.dtype not in _PROBE_DTYPES:
        raise TypeError(f"elementwise_chain takes float32 or bfloat16, got "
                        f"{x.dtype}")


def elementwise_chain_ref(x, mode: str, iters: int, chain: int):
    """Plain PyTorch version of :func:`elementwise_chain` (any device): one
    operation at a time, each rounding to x's dtype."""
    _chain_args(x, mode, iters, chain)
    a = torch.tensor(CHAIN_A, dtype=x.dtype, device=x.device)
    b = torch.tensor(CHAIN_B, dtype=x.dtype, device=x.device)
    out = x.clone()
    for _ in range(iters * chain):
        if mode == "mac":
            out = out * a + b
        else:
            out = torch.exp(-torch.abs(out)) * a + out * b
    return out


def elementwise_chain(x, mode: str, iters: int, chain: int):
    """``iters * chain`` elementwise steps on x (float32 or bfloat16): "mac"
    is ``x * a + b``, "exp" is ``exp(-|x|) * a + x * b``, with ``a = 1 -
    2^-8`` and ``b = 2^-6``; every operation rounds to x's dtype (no
    fused multiply-add).  Returns a new tensor of x's shape and dtype.

    CPU tensors run :func:`elementwise_chain_ref`.  CUDA tensors run the
    kernel (contiguous); anything else raises.
    """
    if x.device.type == "cpu":
        return elementwise_chain_ref(x, mode, iters, chain)
    _chain_args(x, mode, iters, chain)
    _require_cuda("elementwise_chain", x)
    _require_contiguous(x=x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library("elementwise_chain", "ppiliiip")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.elementwise_chain_launch(
            x.data_ptr(), out.data_ptr(), _PROBE_DTYPES[x.dtype], x.numel(),
            CHAIN_MODES[mode], int(iters), int(chain), stream)
    _raise_on(err, "elementwise_chain")
    elementwise_chain.launches += 1
    return out


elementwise_chain.launches = 0


# --------------------------------------------------------------------- #
# Kernel 8: the shared-memory ceiling probe

SMEM_PROBE_ROWS, SMEM_PROBE_COLS = 8, 128   # x and out [8, 128] f32


class SharedMemoryRefused(RuntimeError):
    """The card refused a block of ``nbytes`` of dynamic shared memory
    (``cudaFuncSetAttribute`` failed with CUDA error ``code``, ``name``)."""

    def __init__(self, nbytes: int, code: int, name: str):
        super().__init__(f"{name} ({code}): {nbytes} bytes of dynamic shared "
                         "memory refused")
        self.nbytes, self.code, self.name = nbytes, code, name


def _smem_probe_args(x, nbytes):
    want = (SMEM_PROBE_ROWS, SMEM_PROBE_COLS)
    if tuple(x.shape) != want or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 {want}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if nbytes % (4 * SMEM_PROBE_COLS) or \
            nbytes < 2 * x.numel() * x.element_size():
        raise ValueError(f"nbytes must be a multiple of 512 and at least "
                         f"8192, got {nbytes}")


def smem_ceiling_probe_ref(x, nbytes: int):
    """Plain PyTorch version of :func:`smem_ceiling_probe` (any device):
    ``2x + (x + 1)``, which needs no scratch."""
    _smem_probe_args(x, nbytes)
    return x * 2.0 + (x + 1.0)


def smem_ceiling_probe(x, nbytes: int):
    """The shared-memory ceiling probe: one block takes ``nbytes`` of
    dynamic shared memory as a [nbytes / 512, 128] f32 scratch, writes
    ``2x`` into its first 8 rows and ``x + 1`` into its last 8 and returns
    their sum, ``2x + (x + 1)`` (x [8, 128] float32; ``nbytes`` a multiple
    of 512, at least 8192).

    CPU tensors run :func:`smem_ceiling_probe_ref`.  CUDA tensors run the
    kernel (contiguous); the launch sets the kernel's shared-memory
    attribute only when ``nbytes`` exceeds what the device has granted it
    (:class:`SmemGrants`); a size the card refuses raises
    :class:`SharedMemoryRefused`, any other failure RuntimeError.
    """
    nbytes = int(nbytes)
    if x.device.type == "cpu":
        return smem_ceiling_probe_ref(x, nbytes)
    _smem_probe_args(x, nbytes)
    _require_cuda("smem_ceiling_probe", x)
    _require_contiguous(x=x)
    out = torch.empty_like(x)
    stage = ctypes.c_int(0)
    set_attr = _SMEM_PROBE_GRANTS.needs(x.device.index, nbytes)
    lib = _library("smem_ceiling_probe", "pplipp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.smem_ceiling_probe_launch(
            x.data_ptr(), out.data_ptr(), nbytes, int(set_attr),
            ctypes.addressof(stage), stream)
    if err and stage.value == 1:
        name_fn = lib.smem_ceiling_probe_error_name
        name_fn.argtypes, name_fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise SharedMemoryRefused(nbytes, err, name_fn(err).decode())
    _raise_on(err, "smem_ceiling_probe")
    if set_attr:
        _SMEM_PROBE_GRANTS.grant(x.device.index, nbytes)
    smem_ceiling_probe.launches += 1
    return out


smem_ceiling_probe.launches = 0
_SMEM_PROBE_GRANTS = SmemGrants()


def empty_launch(device) -> None:
    """Launch an empty kernel (one thread, no work) on ``device``'s current
    stream through the same C interface as kernel 8: the floor of a
    launch, timed beside kernel 8's call.  Counts nowhere."""
    lib = _library("smem_ceiling_probe", "p", "smem_ceiling_probe_empty")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(lib.smem_ceiling_probe_empty(stream), "empty_launch")


# --------------------------------------------------------------------- #
# Kernel 9: the resident bookkeeping probe (kernel 2's min-sum check pass in
# four bookkeeping variants)

BOOKKEEPING_VARIANTS = {"nobook": 0, "violonly": 1, "nocapture": 2,
                        "full": 3}
ROW_LANES = 2               # lanes a consumer thread runs at a time: a
                            # pair, one 32-bit word of a staged row
ROW_STAGES_MAX = 4          # stages of the ring at most (kRowStagesMax)
ROW_PRODUCER = 32           # threads of the producer warp (kProducer)


@dataclass(frozen=True)
class StagedRowsPlan:
    """Launch shape of one call of kernel 9."""

    path: str           # "bulk": the c2v rows through a TMA ring in shared
                        # memory; "thread": kernel 2's direct loads
    threads: int        # threads a block: the consumers and, on the bulk
                        # path, one producer warp (ROW_PRODUCER threads)
    lanes: int          # lanes a consumer thread runs (1 on the thread path)
    stages: int         # stages of the ring (0 on the thread path)
    rows: int           # rows of z values a stage holds (0 on the thread
                        # path)
    smem: int           # dynamic shared memory a block, bytes
    totals: str         # "shared": the frame's totals in shared memory for
                        # the call; "global": in the frame-major scratch
    blocks_per_sm: int  # blocks resident on one SM
    grid: int           # persistent blocks launched


def staged_rows_smem(nb_v: int, nb_c: int, E: int, z: int, rows: int,
                     stages: int, *, totals_shared: bool) -> int:
    """Dynamic shared memory of a bulk-path plan of kernel 9, bytes: the
    frame's bf16 totals (when in shared memory), ``stages`` stages of
    ``rows`` bf16 rows of z, a full and an empty mbarrier per stage, the
    block's counts and the code's tables (two ints an edge in row order,
    two in column order, and the row and column offsets; ``rows_layout``
    in the source)."""
    return ((_up16(nb_v * z * 2) if totals_shared else 0)
            + stages * _up16(rows * z * 2) + 16 * stages + 16
            + _up16(8 * E) + 2 * _up16(4 * E) + _up16(4 * (nb_c + 1))
            + _up16(4 * (nb_v + 1)))


@functools.lru_cache(maxsize=256)
def staged_rows_plan(B: int, nb_v: int, nb_c: int, E: int, z: int,
                     dc_max: int, dv_max: int, *,
                     sms: int = H100_SMS) -> StagedRowsPlan:
    """The launch plan of one call of kernel 9 over ``B`` frames of a QC
    code (``nb_v``/``nb_c`` block columns/rows of circulant size ``z``,
    ``E`` base edges, check rows up to ``dc_max`` and variable blocks up to
    ``dv_max`` edges), bf16 state, on a card with ``sms`` SMs.

    The bulk path needs a c2v row of z bf16 values to be whole 16-byte
    units (z a multiple of 8) and variable blocks of at most ``MAX_DC``
    edges (a warp's lanes hold a block's shifts).  A stage holds ``rows =
    max(dc_max, dv_max + 1)`` rows: a check block's rows, or a variable
    block's and its prior row.  The consumers are the fewest warps that
    give every thread ``ROW_LANES`` lanes (one pair) of a row, up to 31
    warps, beside one producer warp; a consumer runs ``lanes = ceil(z /
    consumers)`` lanes, at least two wherever z >= 64.  The frame's totals
    stay in shared memory when a ring of two stages fits beside them, and
    the ring takes as many stages, up to ``ROW_STAGES_MAX``, as fit; else
    the totals move to device memory with the deepest ring that fits.
    Where the bulk path does not apply, or no two-stage ring fits, the
    plan is the thread path: kernel 2's direct loads with
    :func:`resident_plan`'s min-sum layout.  As many blocks share an SM as
    threads, registers (``RES_REGS`` a thread) and shared memory allow; the
    grid is that many blocks an SM, at most B."""
    if not (1 <= dc_max <= MAX_DC) or min(B, nb_v, nb_c, E, z) < 1 \
            or dv_max < 0:
        raise ValueError(f"no staged-rows plan for B={B} nb_v={nb_v} "
                         f"nb_c={nb_c} E={E} z={z} dc_max={dc_max} "
                         f"dv_max={dv_max}")
    if max(nb_v, nb_c, E) * z >= 2 ** 31:
        raise ValueError("a frame's state exceeds 2^31 elements")
    rows = max(dc_max, dv_max + 1)
    consumers = min(RES_THREADS_MAX - ROW_PRODUCER,
                    32 * -(-z // (32 * ROW_LANES)))
    threads = consumers + ROW_PRODUCER
    for shared in ((True, False) if z % 8 == 0 and dv_max <= MAX_DC
                   else ()):
        stages = next((n for n in range(ROW_STAGES_MAX, 1, -1)
                       if staged_rows_smem(nb_v, nb_c, E, z, rows, n,
                                           totals_shared=shared)
                       <= SMEM_BLOCK_MAX), 0)
        if stages:
            smem = staged_rows_smem(nb_v, nb_c, E, z, rows, stages,
                                    totals_shared=shared)
            blocks = max(1, min(THREADS_SM // threads,
                                REGS_SM // (RES_REGS * threads),
                                SMEM_SM // (smem + 1024)))
            return StagedRowsPlan("bulk", threads, -(-z // consumers),
                                  stages, rows, smem,
                                  "shared" if shared else "global", blocks,
                                  min(B, blocks * sms))
    r = resident_plan(B, nb_v, nb_c, E, z, dc_max, 2, "minsum",
                      layered=False, sms=sms)
    return StagedRowsPlan("thread", r.threads, 1, 0, 0, r.smem, r.totals,
                          r.blocks_per_sm, r.grid)


def _staged_rows_launch_args(plan: StagedRowsPlan):
    return (int(plan.path == "bulk"), plan.threads,
            int(plan.totals == "shared"), plan.smem, plan.blocks_per_sm,
            plan.grid, plan.stages, plan.rows, plan.lanes)


def _var_degree_max(tables) -> int:
    """The most edges of one variable block of ``tables``."""
    return int(np.diff(tables.col_off).max())


def _bookkeeping_args(tables, total, c2v, prior, synd, final, done, iters,
                      viol, variant):
    if variant not in BOOKKEEPING_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{list(BOOKKEEPING_VARIANTS)}")
    _check_state(tables, total, c2v, synd, done, iters, prior)
    for name, x in (("final", final), ("viol", viol)):
        want = (total.shape if name == "final" else done.shape)
        if tuple(x.shape) != tuple(want) or x.device != total.device:
            raise ValueError(f"{name} must be {tuple(want)} on "
                             f"{total.device}, got {tuple(x.shape)} on "
                             f"{x.device}")
    bad = [n for n, x in (("total", total), ("c2v", c2v), ("prior", prior),
                          ("final", final)) if x.dtype != torch.bfloat16]
    if bad:
        raise TypeError(f"{', '.join(bad)} must be bfloat16")
    if viol.dtype != torch.int32:
        raise TypeError(f"viol must be int32, got {viol.dtype}")


def resident_bookkeeping_probe_ref(tables, it0: int, maxiter: int, total,
                                   c2v, prior, synd, final, done, iters,
                                   viol, *, variant: str = "full",
                                   k_rounds: int = 8,
                                   ms_alpha: float = MINSUM_ALPHA):
    """Plain PyTorch version of :func:`resident_bookkeeping_probe` (any
    device)."""
    _bookkeeping_args(tables, total, c2v, prior, synd, final, done, iters,
                      viol, variant)
    level = BOOKKEEPING_VARIANTS[variant]
    dev = total.device
    synd = synd.to(torch.int32)
    z, B = tables.z, total.shape[-1]
    c_flat = c2v.view(-1, B)
    for k in range(_n_steps(k_rounds, it0, maxiter)):
        count = _flooding_check_pass(tables, total, c2v, synd, "minsum",
                                     1e-30, ms_alpha, 0.0)
        if level >= 1:
            viol.copy_(count)
        if level >= 2:
            conv = count == 0
            newly = conv & (done == 0)
            iters.copy_(torch.where(newly, it0 + k, iters))
            done.copy_(done | conv.to(torch.int32))
            if level >= 3:
                final.copy_(torch.where(newly, total, final))
        # variable pass in every frame: a bf16 left fold, each sum rounded
        for vbs, cidx, deg in tables.var_groups(dev):
            new = prior.index_select(0, vbs)
            if deg:
                g = c_flat.index_select(0, cidx.reshape(-1)).view(
                    len(vbs), deg, z, B)
                new = new + _fold_sum(g, 1).squeeze(1)
            total.index_copy_(0, vbs, new)
    return total, c2v, final, done, iters, viol


def resident_bookkeeping_probe(tables, it0: int, maxiter: int, total, c2v,
                               prior, synd, final, done, iters, viol, *,
                               variant: str = "full", k_rounds: int = 8,
                               ms_alpha: float = MINSUM_ALPHA):
    """Advance ``n = max(min(k_rounds, maxiter - it0), 0)`` normalized
    min-sum flooding iterations of a QC code in bfloat16, with the
    bookkeeping of ``variant``, in place (the JAX package's
    ``scripts/probe_resident_vmem.py`` kernel).

    Args:
      tables: :class:`QCTables` of the code.
      it0, maxiter: host ints; iteration ``it0 + k`` runs for ``k < n``.
      total, prior, final: [nb_v, z, B] bfloat16; c2v [E, z, B] bfloat16.
      synd: [nb_c, z, B] syndrome bits (int8 for the kernel).
      done, iters, viol: [B] int32.
      variant: "nobook", "violonly", "nocapture" or "full" (cumulative).

    Per iteration: kernel 2's min-sum check pass (``ms_alpha`` times the
    all-but-one minimum, the sign parity and ``1 - 2*synd``, stored in
    bf16); from "violonly" on, ``viol`` = the frame's checks whose parity
    of ``total < 0`` differs from the syndrome; from "nocapture" on, a
    frame with no violation converges (``iters = it`` the first time,
    ``done = 1``); in "full", a frame converging now gets ``final =
    total`` before the variable pass; then, in every frame (no freeze),
    ``total = bf16(prior + acc)`` with ``acc`` the bf16 left fold of the
    rolled incoming messages in (row, slot) order.  Returns ``(total, c2v,
    final, done, iters, viol)``.

    CPU tensors run :func:`resident_bookkeeping_probe_ref`.  CUDA tensors
    run the kernel (contiguous, int8 synd, rows up to ``MAX_DC`` wide;
    anything else raises) with the launch plan of
    :func:`staged_rows_plan` (in ``.plan``; its path, bulk or thread, is
    the plan's choice, never a retry): the copy of the state into
    frame-major scratch (final too in "full"), the K steps and the copy
    back, counted in ``.device_launches``.
    """
    if total.device.type == "cpu":
        return resident_bookkeeping_probe_ref(
            tables, it0, maxiter, total, c2v, prior, synd, final, done,
            iters, viol, variant=variant, k_rounds=k_rounds,
            ms_alpha=ms_alpha)
    _bookkeeping_args(tables, total, c2v, prior, synd, final, done, iters,
                      viol, variant)
    _require_cuda("resident_bookkeeping_probe", total)
    _require_int_state(synd, done, iters)
    _require_contiguous(total=total, c2v=c2v, prior=prior, synd=synd,
                        final=final, done=done, iters=iters, viol=viol)
    _require_tables(tables)
    n = _n_steps(k_rounds, it0, maxiter)
    if n == 0:
        return total, c2v, final, done, iters, viol
    B, z, dev = total.shape[-1], tables.z, total.device
    dv_max = _var_degree_max(tables)
    plan = staged_rows_plan(
        B, tables.nb_v, tables.nb_c, tables.E, z, tables.dc_max, dv_max,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    tb = tables.on(dev)
    full = variant == "full"
    scratch = [torch.empty(B * rows * z, dtype=x.dtype, device=dev)
               for rows, x in ((tables.nb_v, total), (tables.E, c2v),
                               (tables.nb_v, prior), (tables.nb_c, synd))]
    f_fm = (torch.empty(B * tables.nb_v * z, dtype=final.dtype, device=dev)
            if full else None)
    n_launched = ctypes.c_int(0)
    lib = _library("resident_bookkeeping_probe", "p" * 19 + "i" * 10 + "f"
                   + "i" * 9 + "pp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.resident_bookkeeping_probe_launch(
            total.data_ptr(), c2v.data_ptr(), prior.data_ptr(),
            synd.data_ptr(), final.data_ptr(), done.data_ptr(),
            iters.data_ptr(), viol.data_ptr(),
            *(x.data_ptr() for x in scratch),
            f_fm.data_ptr() if full else None,
            *(tb[name].data_ptr() for name in (
                "row_off", "edge_v", "edge_s", "col_off", "col_e", "col_s")),
            tables.nb_c, tables.nb_v, tables.E, tables.dc_max, dv_max, z,
            B, BOOKKEEPING_VARIANTS[variant], int(it0), n, float(ms_alpha),
            *_staged_rows_launch_args(plan), ctypes.addressof(n_launched),
            stream,
        )
    _raise_on(err, "resident_bookkeeping_probe")
    resident_bookkeeping_probe.launches += 1
    resident_bookkeeping_probe.iterations += n
    resident_bookkeeping_probe.device_launches += n_launched.value
    resident_bookkeeping_probe.plan = plan
    return total, c2v, final, done, iters, viol


resident_bookkeeping_probe.launches = 0
resident_bookkeeping_probe.iterations = 0
resident_bookkeeping_probe.device_launches = 0
resident_bookkeeping_probe.plan = None


# --------------------------------------------------------------------- #
# Wrapper checks and the libraries


def _require_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _dtype_codes(name, t_dtype, m_dtype):
    codes = _KERNEL_DTYPES.get((t_dtype, m_dtype))
    if codes is None:
        raise TypeError(
            f"{name} kernel takes (totals, messages) dtypes "
            f"{[(str(a), str(b)) for a, b in _KERNEL_DTYPES]}, got "
            f"({t_dtype}, {m_dtype}); float64 decodes run on the CPU"
        )
    return codes


def _require_int_state(synd, done, iters):
    if synd.dtype != torch.int8:
        raise TypeError(f"synd must be int8, got {synd.dtype}")
    if done.dtype != torch.int32 or iters.dtype != torch.int32:
        raise TypeError("done and iters must be int32")


def _require_contiguous(**tensors):
    bad = [name for name, x in tensors.items() if not x.is_contiguous()]
    if bad:
        raise ValueError(f"{', '.join(bad)} must be contiguous")


def _require_tables(tables):
    if tables.dc_max > MAX_DC:
        raise ValueError(
            f"check degree {tables.dc_max} exceeds the kernel's {MAX_DC}")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "l": ctypes.c_longlong}


def _library(name: str, signature: str, entry: str | None = None):
    """The loaded library of ``csrc/<name>.cu`` with the argument types of
    its function ``entry`` (default ``<name>_launch``) set from
    ``signature`` (p pointer, i int, f float, l long long)."""
    from .cuda_build import load_library

    lib = load_library(name)
    fn = getattr(lib, entry or f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
    return lib
