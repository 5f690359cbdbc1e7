"""Graph-sharded BP decoding: one code's Tanner graph split over a mesh.

The counterpart of the JAX package's ``parallel/graph_shard.py``, for
codes too large for one device: the graph is split over the ranks while
every frame stays whole on every rank.

* :class:`ShardedDecoder` (generic edge lists): the checks are split into
  contiguous blocks, one a rank, held slot-major ``[dc, Cd, B]``.  The
  variable totals are replicated; each rank runs its block's check phase
  (``ops.kernels.bp_check_phase_generic``: kernel 4 on the card, its plain
  version on the CPU) and its block's check-to-variable partial sums, and
  one all-reduce an iteration sums the partials (and one the violation
  counts of the convergence test).  The partial sums reorder the
  variable's additions, so results agree with the single-device decoder
  to float rounding, not bit for bit, as in the JAX package.
* :class:`ShardedQCDecoder` (quasi-cyclic codes): the circulant lane axis z
  is split, each rank holding ``z / D`` lanes of every block's totals and
  messages and running the dense flooding check phase
  (``ops.kernels.bp_check_phase_qc``, kernel 1) on them.  Each circulant
  roll reads lanes of other ranks, and only those move, point to point
  (``parallel/halo.py``): the check phase's windows of the totals, and the
  variable pass's windows of the messages, which each variable lane folds
  in the single-device ``(cb, slot)`` order: the decode is bit-equal to
  the single-device ``QCDecoder``'s, as the JAX package's is.

Every rank issues the same collectives in the same order, and the
decoders' one host read an iteration ("all done?") reads counts already
summed over the ranks, so every rank leaves the loop at the same
iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from ..models.decoder import Decoder
from ..models.qc_decoder import QCDecoder
from .halo import roll_plan

__all__ = ["ShardedDecoder", "ShardedQCDecoder"]


class ShardedDecoder(Decoder):
    """Check-sharded flooding decoder over a 1-D mesh (slot-major blocks).

    Args:
      e_to_v, e_to_c: the expanded edge list (as ``Decoder``).
      mesh: ``parallel.mesh.Mesh``; the decode state lives on its device.
      dtype: message dtype: float32, bfloat16 (f32 math) or float64 (CPU).
      check_rule: "sumproduct" or "minsum" (normalized/offset min-sum with
        ``minsum_alpha``/``minsum_beta``).
      check_phi: sum-product magnitude form, "phi" or "tanhfb".

    The decode loop is the single-device ``Decoder``'s
    (``models/flooding.flood``); this rank's block of checks replaces its
    gather, syndrome rows and masks, and the mesh sums the violation counts
    and the variable partials.  ``check_phase`` is the fused check phase
    of the block, kernel 4 on the card; a test may put its plain version
    (``ops.kernels.bp_check_phase_generic_ref``) there to run it on the
    card.
    """

    def __init__(self, e_to_v, e_to_c, mesh, dtype=DEFAULT_DTYPE,
                 check_rule: str = "sumproduct", check_phi: str = "phi",
                 minsum_alpha: float | None = None,
                 minsum_beta: float = 0.0):
        super().__init__(e_to_v, e_to_c, dtype, device=mesh.device,
                         check_rule=check_rule, check_phi=check_phi,
                         minsum_alpha=minsum_alpha, minsum_beta=minsum_beta)
        self.mesh = mesh
        self.axis = mesh.axis_name
        self.n_dev = D = mesh.world
        g = self.graph
        C_pad = -(-g.cnum // D) * D
        self.c_per_dev = Cd = C_pad // D
        dc, dv = g.dc_max, g.dv_max
        lo = mesh.rank * Cd
        self._c_lo, self._c_rows = lo, max(0, min(g.cnum, lo + Cd) - lo)

        # this rank's slot-major check metadata [dc, Cd] (padded checks
        # have no real slot)
        c_vids = np.zeros((C_pad, dc), np.int64)
        c_mask = np.zeros((C_pad, dc), np.float64)
        c_vids[: g.cnum] = g._c_vids.reshape(g.cnum, dc)
        c_mask[: g.cnum] = g._c_mask_np
        dev = self.device
        self._c_vids_T = torch.as_tensor(
            np.ascontiguousarray(c_vids[lo:lo + Cd].T).reshape(-1),
            device=dev)
        mask_T = np.ascontiguousarray(c_mask[lo:lo + Cd].T)
        self._c_mask_T = torch.as_tensor(mask_T, dtype=torch.float32,
                                         device=dev)
        self._c_mask_T_i = torch.as_tensor(mask_T.astype(np.int32),
                                           device=dev)

        # each variable slot's message in this rank's slot-major block
        # (d * Cd + local check), or slot 0 masked out where the edge's
        # check lies on another rank: the slot-major twin of
        # TannerGraph._v_from_c_T
        chk_slot = g.chk_slot_of_edge
        c_of_edge, d_of_edge = chk_slot // dc, chk_slot % dc
        mine = c_of_edge // Cd == mesh.rank
        v_from_c = np.zeros(g.vnum * dv, np.int64)
        v_valid = np.zeros(g.vnum * dv, np.float64)
        v_from_c[g.var_slot_of_edge[mine]] = (
            d_of_edge[mine] * Cd + c_of_edge[mine] - lo)
        v_valid[g.var_slot_of_edge[mine]] = 1.0
        self._v_from_c_T = torch.as_tensor(
            np.ascontiguousarray(v_from_c.reshape(g.vnum, dv).T), device=dev)
        self._v_valid_T = torch.as_tensor(
            np.ascontiguousarray(v_valid.reshape(g.vnum, dv).T),
            device=dev).to(self.sum_dtype)

    # ------------------------------------------------------------------ #
    # The steps of the flooding loop, on this rank's block

    def _local(self, synd):
        """synd [C, B] -> this rank's rows [Cd, B], padded checks 0."""
        block = torch.zeros((self.c_per_dev, synd.shape[1]),
                            dtype=torch.int32, device=synd.device)
        block[: self._c_rows] = synd[self._c_lo:self._c_lo + self._c_rows]
        return block

    def _check_inputs(self, total):
        """total [V, B] -> this rank's t [dc, Cd, B]."""
        return total.index_select(0, self._c_vids_T).view(
            self.graph.dc_max, self.c_per_dev, total.shape[-1])

    def _frame_violations(self, viol):
        """This block's violation counts [B], summed over the ranks."""
        return self.mesh.all_reduce_sum(viol)

    def var_partial(self, c2v):
        """This rank's check-to-variable partial sums [V, B] in
        ``sum_dtype``: a left fold over the dv_max slots of its block's
        messages, slots of other ranks' checks masked out."""
        flat = c2v.reshape(-1, c2v.shape[-1])
        acc = None
        for d in range(self.graph.dv_max):
            x = flat.index_select(0, self._v_from_c_T[d]).to(self.sum_dtype) \
                * self._v_valid_T[d][:, None]
            acc = x if acc is None else acc + x
        return acc

    def _variable_side(self, prior, c2v, t):
        """``prior`` plus the partial sums of every rank, rounded once to
        the storage dtype: [V, B], replicated; no t."""
        return (prior + self.mesh.all_reduce_sum(self.var_partial(c2v))
                ).to(self.dtype), None


class ShardedQCDecoder(QCDecoder):
    """Quasi-cyclic graph sharding: the circulant lane axis z over the mesh.

    The decode loop is the single-device ``QCDecoder``'s dense one, on
    sharded state: each rank holds ``z / D`` lanes, ``prior``, ``total``
    and ``final`` as ``[nb_v, z / D, B]`` and the messages as ``[nb_c, dc,
    z / D, B]``, and runs the check phase on its lanes of every check block
    (kernel 1 at ``[nb_c, dc, z / D, B]`` on the card).  An iteration moves
    the roll windows of :func:`~.halo.roll_plan` with two
    ``Mesh.exchange`` calls (the totals before the check phase, the
    messages before the variable pass) and sums the violation counts over
    the ranks; each variable lane folds its messages in the single-device
    ``(cb, slot)`` order, so the decode is bit-equal to the single-device
    dense ``QCDecoder``'s.  Every frame stays whole; one all-gather at the
    end of a decode makes the finals, like the counters, replicated.  With
    ``sr_messages`` each rank still draws every lane's random bits and
    keeps its own, so that it stays bit-equal to one device: that draw is
    the one full-z tensor of the loop.

    Dense flooding only, as in the JAX package: ``resident=True``, the
    layered schedule, ``compressed=True`` and an explicit
    ``use_pallas=True`` raise ``ValueError``, as does a z that the mesh
    size does not divide.  The port has no ``use_pallas`` switch: the
    check phase is the decoder's ``check_phase`` (kernel 1 on a CUDA rank,
    ``ops.kernels.bp_check_phase_qc_ref`` on the CPU), which already runs
    on each rank's lanes.  Other keywords are ``QCDecoder``'s; the device
    is the mesh's.
    """

    def __init__(self, base_edges, z: int, mesh, *, use_pallas=None, **kw):
        D = mesh.world
        if int(z) % D:
            raise ValueError(f"z={z} must be divisible by the mesh size {D}")
        if kw.get("resident"):
            raise ValueError("ShardedQCDecoder is incompatible with "
                             "resident=True (the resident kernels decode "
                             "whole frames on one device)")
        if kw.get("schedule", "flooding") != "flooding":
            raise ValueError("ShardedQCDecoder supports only the flooding "
                             "schedule")
        if kw.get("compressed"):
            raise ValueError("ShardedQCDecoder is incompatible with "
                             "compressed=True")
        if use_pallas:
            raise ValueError(
                "ShardedQCDecoder takes no use_pallas=True: the port has no "
                "such switch; its check phase is the decoder's check_phase "
                "(kernel 1 on a CUDA rank, ops.kernels.bp_check_phase_qc_ref "
                "on the CPU), run on each rank's z / D lanes")
        device = torch.device(kw.pop("device", mesh.device))
        if device.type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.use_pallas = False
        self.mesh = mesh
        self.axis = mesh.axis_name
        super().__init__(base_edges, z, device=mesh.device, **kw)
        self.z_local = self.z // D
        self.plan = roll_plan(self._rows, self.z, D, mesh.rank,
                              device=self.device)
        self._lanes = self.plan.lanes

    # ------------------------------------------------------------------ #
    # The steps of the flooding loop, on this rank's lanes

    def _local(self, x):
        """x [..., z, B] of every lane -> this rank's [..., z / D, B]."""
        return x[..., self._lanes[0]:self._lanes[1], :].contiguous()

    def _check_inputs(self, total):
        """This rank's totals [nb_v, z / D, B] and the check-side windows
        of its peers' -> its t [nb_c, dc, z / D, B], padded slots holding
        the +1e30 sentinel."""
        B = total.shape[-1]
        recvs = self.mesh.exchange(
            self.plan.pack_totals(total),
            {q: (n, B) for q, n in self.plan.totals_recv.items()},
            total.dtype)
        return self.plan.check_inputs(total, recvs)

    def _frame_violations(self, viol):
        return self.mesh.all_reduce_sum(viol)

    def _variable_side(self, prior, c2v, t):
        """This rank's messages [nb_c, dc, z / D, B] and the variable-side
        windows of its peers' -> the new totals of its variable lanes, each
        folded in the single-device (cb, slot) order, plus the prior; no t,
        so every iteration gathers (and exchanges) the totals' windows
        again."""
        B = c2v.shape[-1]
        recvs = self.mesh.exchange(
            self.plan.pack_messages(c2v),
            {q: (n, B) for q, n in self.plan.messages_recv.items()},
            c2v.dtype)
        sums = self.plan.var_sums(c2v, recvs, self.sum_dtype)
        return (prior.to(self.sum_dtype) + sums).to(self.acc_dtype), None

    def _whole_finals(self, final):
        """This rank's [nb_v, z / D, B] -> every rank's [nb_v, z, B]: the
        decode's one all-gather, after its last iteration."""
        g = self.mesh.all_gather(final)            # [D, nb_v, zl, B]
        return g.permute(1, 0, 2, 3).reshape(self.nb_v, self.z,
                                             final.shape[-1])
