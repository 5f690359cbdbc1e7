"""The H100's data-sheet rates and the work of each kernel's call.

The counterpart of the JAX package's ``utils/perf.py`` for the card the
port runs on.  It holds no model of the chip's layout: a bound here is the
least time the card could take for a call's work, the larger of

* the bytes the call must move (each input read once, each output written
  once) over the memory rate, and
* the f32 operations of the plain version over the f32 rate (and kernel
  7's exp steps also by their MUFU.EX2s over the special-function units'
  rate),

with the rates of NVIDIA's H100 SXM data sheet at its full 700 W (a card
set to a lower power limit runs slower than these rates under load).  The
operations of a check slot count each elementwise operation once, a
transcendental too: at least one instruction each, so the operation time
is a lower bound.  ``chip_smoke.py`` and ``qamreconciliation_tpu_torch.
bench`` both take their bounds from here.

The ``*_work`` functions give ``(bytes, ops)`` of one call at the shapes
the decoders pass: kernels 1 and 4 per call, kernels 2 and 3 the bytes of
one call (the state in and out once) and the operations of one step.
"""

from __future__ import annotations

import torch

from ..ops.kernels import (
    BOOKKEEPING_VARIANTS, GENERIC_BLOCK_C, softening_table_size,
)

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "BF16_OPS_PER_S",
           "SFU_OPS_PER_S",
           "OPS_PER_SLOT", "tensor_bytes", "bound", "check_phase_qc_work",
           "decode_rounds_work", "layered_sweeps_work",
           "check_phase_generic_work", "check_node_update_work",
           "var_totals_generic_work", "var_pass_qc_work",
           "softening_inputs_ops", "softening_inputs_work",
           "check_math_probe_work",
           "elementwise_chain_work", "smem_ceiling_probe_work",
           "resident_bookkeeping_work"]

# H100 SXM data-sheet rates: HBM3 bytes/s, and f32 instructions/s outside
# the tensor cores (67 TFLOP/s counts an FMA as two operations; none of the
# rules' operations is an FMA, so each takes an instruction of its own)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
# packed bf16 element operations/s outside the tensor cores: 133.8 TFLOP/s
# of non-tensor bf16 (the Hopper architecture white paper's H100 SXM5
# figure, twice the f32 rate: two elements an instruction), an FMA counted
# as two
BF16_OPS_PER_S = 133.8e12 / 2
# MUFU.EX2 instructions/s of the special-function units: 16 a clock an SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) on the H100 SXM's 132 SMs at its 1.98 GHz boost clock.
# Every exp step of kernel 7 needs an f32 expf, and so one, in both dtypes.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# f32 operations per check slot of the plain versions' rules
OPS_PER_SLOT = {"sumproduct": 30, "tanhfb": 20, "minsum": 12}
# ... and of kernel 6's slot maths (copy: the subtraction and t's sign)
PROBE_OPS_PER_SLOT = {"phi": 30, "copy": 2, "minsum": 12}
# elementwise operations a step of kernel 7's chain: mac a multiply and an
# add (two roundings, no FMA); exp -|x|, exp, two multiplies and an add
CHAIN_OPS = {"mac": 2, "exp": 5}

_I32 = 4        # syndromes of kernels 1, 4 and 5, violation counts, flags
_I8 = 1         # syndromes of kernels 2, 3 and 9
_BF16 = 2       # kernel 9's state


def tensor_bytes(*tensors) -> int:
    """Bytes of ``tensors``, each counted once."""
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(nbytes: float, ops: float, steps: int = 1,
          ops_per_s: float = F32_OPS_PER_S, sfu_ops: float = 0):
    """``(bound_ms, bound_by)``: the largest of ``nbytes / steps`` over the
    memory rate, ``ops`` over ``ops_per_s`` (default the f32 rate) and
    ``sfu_ops`` over the special-function units' rate, and which it is
    ("bytes", or "operations" for either of the other two).  A multi-step
    call passes its bytes and its steps with the operations of one step,
    for a bound per step."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S / steps
    t_ops = max(1e3 * ops / ops_per_s, 1e3 * sfu_ops / SFU_OPS_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def check_phase_qc_work(nb_c, dc, z, B, t_dtype, m_dtype, rule):
    """Kernel 1 (``bp_check_phase_qc``): t [nb_c, dc, z, B] and c2v in,
    int32 syndrome [nb_c, z, B] in, c2v out, violations [nb_c, B] out."""
    slots = nb_c * dc * z * B
    nbytes = (slots * (_size(t_dtype) + 2 * _size(m_dtype))
              + nb_c * z * B * _I32 + nb_c * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * slots


def decode_rounds_work(nb_v, nb_c, E, z, B, total_dtype, m_dtype, rule):
    """Kernel 2 (``bp_decode_rounds_qc``): a call's state in (totals
    [nb_v, z, B], c2v [E, z, B], prior in c2v's dtype, int8 syndrome
    [nb_c, z, B], done and iters [B]) and out (totals, c2v, done, iters);
    the operations of one step over every slot."""
    t, m = _size(total_dtype), _size(m_dtype)
    nbytes = (2 * nb_v * z * B * t + 2 * E * z * B * m + nb_v * z * B * m
              + nb_c * z * B * _I8 + 4 * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * E * z * B


def layered_sweeps_work(nb_v, nb_c, E, z, B, m_dtype, rule):
    """Kernel 3 (``bp_layered_sweeps_qc``): a call's state in (f32 totals
    [nb_v, z, B], c2v [E, z, B], int8 syndrome [nb_c, z, B], done and
    iters [B]) and out (totals, c2v, done, iters); the operations of one
    sweep over every slot."""
    m = _size(m_dtype)
    nbytes = (2 * nb_v * z * B * 4 + 2 * E * z * B * m
              + nb_c * z * B * _I8 + 4 * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * E * z * B


def check_phase_generic_work(dc, C, B, m_dtype, rule):
    """Kernel 4 (``bp_check_phase_generic``): t and c2v [dc, C, B] in, int32
    syndrome [C, B] and f32 mask [dc, C] in, c2v out, violations per block
    of ``GENERIC_BLOCK_C`` checks [ceil(C / GENERIC_BLOCK_C), B] out."""
    slots = dc * C * B
    blocks = -(-C // GENERIC_BLOCK_C)
    nbytes = (3 * slots * _size(m_dtype) + C * B * _I32 + dc * C * 4
              + blocks * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * slots


def check_node_update_work(C, dc, B, dtype):
    """Kernel 5 (``check_node_update_fused``): v2c [C, dc, B] in, int32
    syndrome [C, B] and f32 mask [C, dc] in, the phi update [C, dc, B]
    out."""
    slots = C * dc * B
    nbytes = 2 * slots * _size(dtype) + C * B * _I32 + C * dc * 4
    return nbytes, OPS_PER_SLOT["sumproduct"] * slots


def var_totals_generic_work(E, V, B, m_dtype, padded):
    """Gather 2's fold (``bp_var_totals_generic``): the E real edges'
    message rows [E, B] in, c2v's row 0 once for the ``padded`` variables
    with fewer than dv_max edges, the f32 prior [V, B] in, the int32 table
    entries of the real edges and the degrees [V] in, the totals [V, B]
    out; an f32 addition per real edge and per variable, and a product and
    an addition per padded variable, per frame."""
    size = _size(m_dtype)
    nbytes = (E * B * size + (B * size if padded else 0) + V * B * 4
              + E * _I32 + V * _I32 + V * B * size)
    return nbytes, (E + V + 2 * padded) * B


def var_pass_qc_work(E, V, B, dtype):
    """The dense QC variable pass (``bp_var_pass_qc``): the E real edges'
    message rows [E, B] in, the prior [V, B] in, the int32 table entries
    of the real edges and the degrees [V] in, the totals [V, B] out and
    the E real rows of t out, all but the int32s in ``dtype``; an f32
    addition per edge and frame (a lane's fold adds dv - 1, the prior
    one more)."""
    size = _size(dtype)
    nbytes = 2 * (E + V) * B * size + (E + V) * _I32
    return nbytes, E * B


def softening_inputs_ops(M: int, bps: int) -> int:
    """Operations of :func:`softening_inputs_work` a sample: the hard
    decision's M - 1 compares and adds; each of the M erf terms'
    difference, division, erf, 1 + erf, product and the sum's add to 0, and
    the M - 1 adds of the sum; g's difference and division; the clamp; the
    warped coordinate's two adds, two logs and difference; the segment's
    difference, product, clamp, floor and the abscissa's difference,
    product, subtraction and doubling; and per bit 10 Clenshaw steps of a
    product, a difference and an add, the last step's three and the scale's
    product."""
    return (2 * (M - 1) + 6 * M + (M - 1) + 2 + 2 + 5 + 9
            + bps * (10 * 3 + 3 + 1))


def softening_inputs_work(S, B, M, bps, dtype):
    """The softening inputs (``softening_inputs``): y [S, B] in ``dtype``
    and the int32 symbols x in, the LLRs [S * bps, B] in ``dtype`` and the
    int32 word out, the mapper's f32 table and the int32 bit table [M,
    bps] in once; :func:`softening_inputs_ops` a sample."""
    size = _size(dtype)
    nbytes = (S * B * (size + _I32) + S * bps * B * (size + _I32)
              + 4 * softening_table_size(M, bps) + _I32 * M * bps)
    return nbytes, softening_inputs_ops(M, bps) * S * B


def check_math_probe_work(nb_c, dc, z, B, dtype, math):
    """Kernel 6 (``check_math_probe``): t and c2v [nb_c, dc, z, B] in,
    int32 syndrome [nb_c, z, B] in, out [nb_c, dc, z, B] and violations
    [nb_c, B] out, all but the int32s in ``dtype``."""
    slots = nb_c * dc * z * B
    nbytes = 3 * slots * _size(dtype) + nb_c * z * B * _I32 + nb_c * B * _I32
    return nbytes, PROBE_OPS_PER_SLOT[math] * slots


def elementwise_chain_work(numel, dtype, iters, chain, mode):
    """Kernel 7 (``elementwise_chain``): the array in and out once, and
    ``iters * chain`` steps of ``mode`` on every element; returns ``(bytes,
    ops, ops_per_s, sfu_ops)``, the rate that of ``dtype`` (packed bf16 or
    f32) and ``sfu_ops`` the steps' MUFU.EX2s, one an exp step in either
    dtype (for :func:`bound`)."""
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    steps = numel * iters * chain
    return (2 * numel * _size(dtype), CHAIN_OPS[mode] * steps, rate,
            steps if mode == "exp" else 0)


def smem_ceiling_probe_work():
    """Kernel 8 (``smem_ceiling_probe``): x [8, 128] f32 in, out out; a
    multiply and two adds an element.  The scratch is the kernel's own and
    moves nothing to or from device memory."""
    numel = 8 * 128
    return 2 * numel * 4, 3 * numel


def resident_bookkeeping_work(nb_v, nb_c, E, z, B, variant, captured=0):
    """Kernel 9 (``resident_bookkeeping_probe``): a call's bf16 totals
    [nb_v, z, B], c2v [E, z, B] and prior and its int8 syndrome [nb_c, z, B]
    in, totals and c2v out; from "violonly" on the violation counts [B]
    out, from "nocapture" on done and iters [B] in and out, and in "full"
    the totals of the ``captured`` frames that converged in the call
    written to final; the min-sum operations of one step over every slot."""
    level = BOOKKEEPING_VARIANTS[variant]
    nbytes = (2 * nb_v * z * B * _BF16 + 2 * E * z * B * _BF16
              + nb_v * z * B * _BF16 + nb_c * z * B * _I8)
    if level >= 1:
        nbytes += B * _I32
    if level >= 2:
        nbytes += 4 * B * _I32
    if level >= 3:
        nbytes += captured * nb_v * z * _BF16
    return nbytes, OPS_PER_SLOT["minsum"] * E * z * B
