"""The H100's data-sheet rates and the work of the decoders' kernel calls.

Frozen copy of the rates, ``bound``, ``decode_rounds_work`` and
``check_phase_generic_work`` of ``qamreconciliation_tpu_torch/utils/
perf.py`` at commit bdbe956, with one change: kernel 2's operations are
counted per frame and per BP step that frame ran (:func:`frame_steps`),
not per call for every frame, so steps that frozen frames skip are not
charged.  A bound is the least time the card could take for the work: the
larger of the bytes over the memory rate and the f32 operations (each
elementwise operation of the plain version once) over the f32 rate, at the
H100 SXM's published rates at 700 W.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
OPS_PER_SLOT = {"sumproduct": 30, "tanhfb": 20, "minsum": 12}
GENERIC_BLOCK_C = 64
_I32 = 4
_I8 = 1


def _size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bound(nbytes: float, ops: float):
    """``(seconds, by)``: the larger of the bytes' and the operations'
    time, and which it is ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def decode_rounds_work(nb_v, nb_c, E, z, B, total_dtype, m_dtype, rule,
                       frame_steps):
    """Kernel 2, one call: the state in (totals [nb_v, z, B], c2v [E, z,
    B], prior in c2v's dtype, int8 syndrome [nb_c, z, B], done and iters
    [B]) and out (totals, c2v, done, iters) once; the operations of every
    slot of a frame's rows for each of the ``frame_steps`` (frame, step)
    pairs the call ran."""
    t, m = _size(total_dtype), _size(m_dtype)
    nbytes = (2 * nb_v * z * B * t + 2 * E * z * B * m + nb_v * z * B * m
              + nb_c * z * B * _I8 + 4 * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * E * z * frame_steps


def frame_steps(done_before, done_after, iters, it0: int, n: int):
    """The (frame, step) pairs a kernel-2 call of ``n`` steps from
    iteration ``it0`` ran: none for a frame done before the call, ``iters
    - it0 + 1`` for one that converged in it (its last step tests and
    freezes it), ``n`` for the others; a 0-dim tensor on their device."""
    fresh = done_after.bool() & ~done_before.bool()
    steps = torch.where(fresh, iters.to(torch.int64) - it0 + 1,
                        torch.full_like(iters, n, dtype=torch.int64))
    return torch.where(done_before.bool(), 0, steps).sum()


def check_phase_generic_work(dc, C, B, m_dtype, rule):
    """Kernel 4, one call: t and c2v [dc, C, B] in, int32 syndrome [C, B]
    and f32 mask [dc, C] in, c2v out and the violations per block of
    ``GENERIC_BLOCK_C`` checks out; the operations of every slot."""
    slots = dc * C * B
    blocks = -(-C // GENERIC_BLOCK_C)
    nbytes = (3 * slots * _size(m_dtype) + C * B * _I32 + dc * C * 4
              + blocks * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * slots
