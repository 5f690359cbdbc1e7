"""Syndrome belief-propagation LDPC decoder over an expanded edge list.

The counterpart of ``qamreconciliation_tpu.models.decoder``: the Tanner
graph's jagged adjacency becomes static padded layouts (variable-major
``[V, dv_max]`` and check-major ``[C, dc_max]`` slot grids, their
slot-major transposes and two flat maps between them), messages are
``[slots, B]`` tensors with the frame batch last, and one flooding
iteration is

* gather 1: the totals of each check's variables, ``t = total[c_vids_T]``
  ([dc_max, C, B]);
* the fused check phase (ops/kernels.bp_check_phase_generic: the kernel on
  the card, its plain version on the CPU): the convergence test of the
  current totals and the new check->variable messages;
* gather 2 (ops/kernels.bp_var_totals_generic: a kernel on the card that
  reads only each variable's real edges, the masked loop over the dv_max
  slots on the CPU): each variable's incoming messages ``c2v[v_from_c_T]``
  summed in f32 (f64 for float64 decodes) in slot order, plus the prior,
  rounded once to the storage dtype;

then one host read of "all done?", taken once the next iteration is
enqueued, in the loop every flooding decoder runs
(``models/flooding.flood``).

Semantics as the JAX decoder: ``iters == 0`` and the LLRs passed through
for a consistent input; a frame's ``iters`` is the 0-based iteration at
which it first satisfied its syndrome, and ``final`` holds its totals from
that moment; failures report ``max_iterations`` and the totals after the
last iteration.  Min-sum decodes are bit-identical to the JAX decoder's,
sum-product ones agree to float rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, as_dtype
from ..ops.boxplus import MINSUM_ALPHA, box_plus
from ..ops.kernels import bp_check_phase_generic, bp_var_totals_generic
from ..utils.trace import span
from .flooding import flood

__all__ = ["TannerGraph", "Decoder"]


def _slot_positions(ids: np.ndarray) -> np.ndarray:
    """Position of each element within its id-group, in original order.

    For ids = [0,0,1,0,1] returns [0,1,0,2,1]: edges appear in each node's
    table in increasing edge-id order.
    """
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    first_idx = np.concatenate(
        [[0], np.flatnonzero(sorted_ids[1:] != sorted_ids[:-1]) + 1]
    )
    group_first = np.repeat(
        first_idx, np.diff(np.concatenate([first_idx, [sorted_ids.size]]))
    )
    pos_sorted = np.arange(sorted_ids.size) - group_first
    pos = np.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


class TannerGraph:
    """Static dual-layout index arrays of one LDPC code, built once on the
    host (numpy) from the edge list ``(e_to_v, e_to_c)``.

    Attributes (as the JAX ``TannerGraph``):
      vnum, cnum, ednum: node/edge counts (``max(id) + 1``).
      dv, dc: node degrees; dv_max, dc_max: the padding widths.
      _c_from_v [C*dc_max]: for each check-major slot the var-major flat
        slot of the same edge (padding -> 0, masked); _v_from_c [V*dv_max]
        the inverse map; _c_vids [C*dc_max] the variable of each check slot.
      _c_vids_T [dc_max, C], _v_from_c_T [dv_max, V]: the slot-major forms
        (``_v_from_c_T`` indexes the flat slot-major ``d*C + c``).
      _v_mask_np [V, dv_max], _c_mask_np [C, dc_max] and their transposes
        ``_v_mask_T_np``/``_c_mask_T_np``: float64 1.0 real / 0.0 padding.
      var_slot_of_edge, chk_slot_of_edge [E]: edge -> flat slot.
    The index arrays are numpy int64; :meth:`on` gives them as tensors on a
    device, uploaded once per device, the first time on ``device``.
    """

    def __init__(self, e_to_v, e_to_c, device="cpu"):
        vid = np.asarray(e_to_v, dtype=np.int64).reshape(-1)
        cid = np.asarray(e_to_c, dtype=np.int64).reshape(-1)
        if vid.size != cid.size:
            raise ValueError("Sizes don't match")

        self.ednum = int(vid.size)
        self.vnum = int(vid.max()) + 1
        self.cnum = int(cid.max()) + 1

        v_pos = _slot_positions(vid)
        c_pos = _slot_positions(cid)
        self.dv = np.bincount(vid, minlength=self.vnum)
        self.dc = np.bincount(cid, minlength=self.cnum)
        self.dv_max = int(self.dv.max())
        self.dc_max = int(self.dc.max())

        var_slot = vid * self.dv_max + v_pos   # flat var-major slot per edge
        chk_slot = cid * self.dc_max + c_pos   # flat check-major slot per edge

        self._c_from_v = np.zeros(self.cnum * self.dc_max, dtype=np.int64)
        self._c_from_v[chk_slot] = var_slot
        self._v_from_c = np.zeros(self.vnum * self.dv_max, dtype=np.int64)
        self._v_from_c[var_slot] = chk_slot

        v_mask = np.zeros(self.vnum * self.dv_max, dtype=np.float64)
        v_mask[var_slot] = 1.0
        c_mask = np.zeros(self.cnum * self.dc_max, dtype=np.float64)
        c_mask[chk_slot] = 1.0

        self._c_vids = np.zeros(self.cnum * self.dc_max, dtype=np.int64)
        self._c_vids[chk_slot] = vid

        self.e_to_v = vid
        self.e_to_c = cid
        self.var_slot_of_edge = var_slot
        self.chk_slot_of_edge = chk_slot
        self._v_mask_np = v_mask.reshape(self.vnum, self.dv_max)
        self._c_mask_np = c_mask.reshape(self.cnum, self.dc_max)

        # slot-major layouts [dc_max, C] / [dv_max, V]: every message tensor
        # of the decode loop keeps (nodes, frames) minor
        self._c_vids_T = np.ascontiguousarray(
            self._c_vids.reshape(self.cnum, self.dc_max).T)
        # flat check-major slot c*dc_max + d -> slot-major flat d*C + c
        v_from_c_T = (
            (self._v_from_c % self.dc_max) * self.cnum
            + self._v_from_c // self.dc_max
        )
        self._v_from_c_T = np.ascontiguousarray(
            v_from_c_T.reshape(self.vnum, self.dv_max).T)
        self._c_mask_T_np = np.ascontiguousarray(self._c_mask_np.T)
        self._v_mask_T_np = np.ascontiguousarray(self._v_mask_np.T)

        self._cache = {}
        self.device = torch.device(device)
        self.on(self.device)

    _INDEX = ("c_from_v", "v_from_c", "c_vids", "c_vids_T", "v_from_c_T")

    def on(self, device) -> dict:
        """The int64 index tensors (keyed without the leading underscore),
        the int32 slot-major check mask ``c_mask_T_i`` and gather 2's int32
        ``v_from_c_T_i`` and variable degrees ``dv_i`` on ``device``,
        uploaded once per device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._cache:
            tb = {name: torch.as_tensor(getattr(self, "_" + name),
                                        device=device)
                  for name in self._INDEX}
            tb["c_mask_T_i"] = torch.as_tensor(
                self._c_mask_T_np.astype(np.int32), device=device)
            tb["v_from_c_T_i"] = torch.as_tensor(
                self._v_from_c_T.astype(np.int32), device=device)
            tb["dv_i"] = torch.as_tensor(self.dv.astype(np.int32),
                                         device=device)
            self._cache[device] = tb
        return self._cache[device]

    def _masks(self, dtype, device=None):
        """``(v_mask [V, dv_max], c_mask [C, dc_max])`` in ``dtype``."""
        device = self.device if device is None else device
        return (torch.as_tensor(self._v_mask_np, device=device).to(dtype),
                torch.as_tensor(self._c_mask_np, device=device).to(dtype))

    # ------------------------------------------------------------------ #
    # Layout conversions

    def permute_v_to_c(self, flat_v):
        """[V*dv_max, B] var-major -> [C, dc_max, B] check-major."""
        idx = self.on(flat_v.device)["c_from_v"]
        return flat_v.index_select(0, idx).reshape(self.cnum, self.dc_max, -1)

    def permute_c_to_v(self, flat_c):
        """[C*dc_max, B] check-major -> [V, dv_max, B] var-major."""
        idx = self.on(flat_c.device)["v_from_c"]
        return flat_c.index_select(0, idx).reshape(self.vnum, self.dv_max, -1)

    # ------------------------------------------------------------------ #

    def gather_checks(self, x):
        """x [V, B] -> [dc_max, C, B]: each check slot's variable (padded
        slots read variable 0 and are masked by the caller)."""
        idx = self.on(x.device)["c_vids_T"]
        return x.index_select(0, idx.reshape(-1)).view(
            self.dc_max, self.cnum, x.shape[-1])

    def syndrome_from_bits(self, bits):
        """Syndrome of hard bits: [V, B] int (0/1) -> [C, B] int32, the
        parity over each check's neighbourhood (gather and masked
        popcount), on the bits' device."""
        mask = self.on(bits.device)["c_mask_T_i"][:, :, None]
        g = self.gather_checks(bits.to(torch.int32)) * mask
        return torch.sum(g, dim=0, dtype=torch.int32) & 1

    def lappr_consistent(self, total, synd):
        """Per-frame syndrome test of hard decisions from LLRs (bit = 1 iff
        lappr < 0): total [V, B], synd [C, B] -> [B] bool."""
        bits = (total < 0).to(torch.int32)
        return torch.all(self.syndrome_from_bits(bits)
                         == synd.to(torch.int32), dim=0)


class Decoder:
    """Flooding BP syndrome decoder over a :class:`TannerGraph`.

    Args:
      e_to_v, e_to_c: the expanded edge list.
      dtype: message/LLR storage: float32, bfloat16 (f32 math) or float64
        (the CPU only).
      device: where the decode state lives.
      check_rule: "sumproduct" or "minsum" (normalized/offset min-sum).
      check_phi: sum-product magnitude form, "phi" or "tanhfb".
      minsum_alpha, minsum_beta: min-sum magnitude ``max(alpha*m - beta,
        0)`` (alpha defaults to 13/16).

    The JAX decoder's ``use_pallas`` switch is not taken: the check phase
    is always ``check_phase`` (kernel 4 on the card, its plain version on
    the CPU), which a test may replace with
    ``ops.kernels.bp_check_phase_generic_ref`` to run the plain version on
    the card; gather 2's fold is ``var_fold`` in the same way
    (``bp_var_totals_generic`` / ``bp_var_totals_generic_ref``).
    """

    def __init__(self, e_to_v, e_to_c, dtype=DEFAULT_DTYPE, *,
                 device="cuda",
                 check_rule: str = "sumproduct",
                 check_phi: str = "phi",
                 minsum_alpha: float | None = None,
                 minsum_beta: float = 0.0):
        self.device = torch.device(device)
        self.graph = TannerGraph(e_to_v, e_to_c, device=self.device)
        self.dtype = as_dtype(dtype)
        if check_rule not in ("sumproduct", "minsum"):
            raise ValueError(f"unknown check_rule {check_rule!r}")
        self.check_rule = check_rule
        if check_phi not in ("phi", "tanhfb"):
            raise ValueError(f"unknown check_phi {check_phi!r}")
        self.check_phi = check_phi
        self.minsum_alpha = float(
            MINSUM_ALPHA if minsum_alpha is None else minsum_alpha
        )
        self.minsum_beta = float(minsum_beta)
        if self.minsum_beta < 0:
            raise ValueError("minsum_beta must be >= 0")
        # the kernels' rule name
        self.rule = (
            "tanhfb"
            if check_rule == "sumproduct" and check_phi == "tanhfb"
            else check_rule
        )
        self.sum_dtype = (
            torch.float64 if self.dtype == torch.float64 else torch.float32
        )
        g = self.graph
        # the check phase's mask, float32 in every dtype (0/1 exactly)
        self._c_mask_T = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                                         device=self.device)
        self._c_mask_T_i = g.on(self.device)["c_mask_T_i"]
        # the fused check phase and gather 2's fold; a test may put the
        # plain versions (ops/kernels.bp_check_phase_generic_ref,
        # bp_var_totals_generic_ref) here to run them on the card
        self.check_phase = bp_check_phase_generic
        self.var_fold = bp_var_totals_generic
        # BP iterations run on the device by this decoder
        self.iterations_run = 0
        # of those, iterations the flooding loop ran after its one-late read
        # found every frame done, and its reads that waited on the device
        # (models/flooding.flood)
        self.overrun_iterations = 0
        self.polls_waited = 0

    # Properties of the reference decoder
    @property
    def cnum(self):
        return self.graph.cnum

    @property
    def vnum(self):
        return self.graph.vnum

    @property
    def ednum(self):
        return self.graph.ednum

    # ------------------------------------------------------------------ #
    # Core batched decode

    def var_totals(self, prior, c2v):
        """Gather 2: ``round(prior + sum_d c2v[v_from_c_T[d]] * v_mask[d])``
        with the sum a left fold over the dv_max slots in ``sum_dtype``
        (``var_fold``); prior [V, B] in ``sum_dtype``, c2v [dc_max, C, B]
        -> [V, B] in the storage dtype."""
        tb = self.graph.on(c2v.device)
        return self.var_fold(prior, c2v, tb["v_from_c_T_i"], tb["dv_i"])

    def decode_batched(self, prior_vb, synd_cb, max_iterations: int):
        """prior [V, B], synd [C, B] -> (success [B], iters [B] int32,
        final [V, B]), on the decoder's device: the flooding loop
        (:func:`~.flooding.flood`) over this decoder's steps."""
        with span("rr.decoder.decode"):
            dev, B = self.device, prior_vb.shape[1]
            prior = prior_vb.to(dev, self.dtype)
            # contiguous once a decode, as gather 2's kernel reads it
            prior_sum = prior.to(self.sum_dtype).contiguous()
            synd = self._local(synd_cb.to(dev, torch.int32))
            c2v = torch.zeros((self.graph.dc_max, synd.shape[0], B),
                              dtype=self.dtype, device=dev)
            return flood(self, prior, synd, c2v, max_iterations,
                         self._check_step,
                         functools.partial(self._variable_side, prior_sum))

    # The decoder's steps of the flooding loop; a mesh of ranks overrides
    # _local, _check_inputs, _frame_violations and _variable_side
    # (parallel/graph_shard.ShardedDecoder).  On one device they cover
    # every check.

    def _local(self, synd):
        """synd [C, B] -> the syndrome rows of the checks updated here."""
        return synd.contiguous()

    def _check_inputs(self, total):
        """total [V, B] -> the check phase's t [dc_max, C, B] of the checks
        updated here (gather 1)."""
        return self.graph.gather_checks(total)

    def _check_step(self, t, c2v, synd):
        """The fused check phase: ``(c2v, viol)``."""
        return self.check_phase(
            t, c2v, synd, self._c_mask_T, rule=self.rule,
            ms_alpha=self.minsum_alpha, ms_beta=self.minsum_beta,
        )

    def _frame_violations(self, viol):
        """[B] violated checks among those updated here -> among all."""
        return viol

    def _variable_side(self, prior, c2v, t):
        """Gather 2: ``(var_totals(prior, c2v), None)``, so that every
        iteration gathers its t."""
        return self.var_totals(prior, c2v), None

    def _tail_consistent(self, total, synd):
        """[B] bool: every check's hard-decision parity equals its
        syndrome."""
        bits = (self._check_inputs(total) < 0).to(torch.int32) \
            * self._c_mask_T_i[:, :, None]
        parity = torch.sum(bits, dim=0, dtype=torch.int32) & 1
        return self._frame_violations((parity != synd).sum(0)) == 0

    def _whole_finals(self, final):
        """The finals [V, B]: every rank holds every variable's."""
        return final

    def _build_decode(self):
        """The [V, B] decode entry the engine calls."""
        return self.decode_batched

    def decode_batch(self, lappr, synd, max_iterations: int):
        """lappr [B, V], synd [B, C] -> (success [B], iters [B], final [B, V])."""
        lappr, synd = torch.as_tensor(lappr), torch.as_tensor(synd)
        success, iters, total = self.decode_batched(
            lappr.to(self.device, self.dtype).T, synd.to(self.device).T,
            max_iterations,
        )
        return success, iters, total.T

    def decode(self, lappr_data, synd, max_iterations: int):
        """Single-frame API: ``(success, iters, final_lappr)``."""
        lappr = torch.as_tensor(np.asarray(lappr_data))[None, :]
        synd = torch.as_tensor(np.asarray(synd))[None, :]
        success, iters, final = self.decode_batch(lappr, synd, max_iterations)
        final = final[0].cpu()
        if final.dtype == torch.bfloat16:      # numpy has no bf16
            final = final.float()
        return bool(success[0]), int(iters[0]), final.numpy()

    # ------------------------------------------------------------------ #
    # Per-node API in the reference's edge-indexed message format (host)

    def check_synd_node(self, check_node_index, word, synd) -> bool:
        """Parity test of one check node."""
        g = self.graph
        word = np.asarray(word).astype(np.int64)
        if word.size != g.vnum:
            raise ValueError("Size of word does not match number of vnodes")
        synd = np.asarray(synd).astype(np.int64)
        if synd.size != g.cnum:
            raise ValueError("Size of synd does not match number of cnodes")
        members = g.e_to_v[g.e_to_c == check_node_index]
        return bool((word[members].sum() + synd[check_node_index]) % 2 == 0)

    def check_word(self, word, synd) -> bool:
        """All-checks parity test."""
        word = torch.as_tensor(np.asarray(word).astype(np.int64))[:, None]
        synd_hat = self.graph.syndrome_from_bits(word)
        synd = torch.as_tensor(np.asarray(synd).astype(np.int32))
        return bool(torch.all(synd_hat[:, 0] == synd))

    def check_lappr(self, lappr, synd) -> bool:
        """Syndrome test of LLR hard decisions."""
        lappr = np.asarray(lappr, dtype=np.float64)
        if lappr.size != self.graph.vnum:
            raise ValueError("Size of lappr does not match number of vnodes")
        synd = np.asarray(synd).astype(np.int64)
        if synd.size != self.graph.cnum:
            raise ValueError("Size of synd does not match number of cnodes")
        return bool(self.graph.lappr_consistent(
            torch.as_tensor(lappr)[:, None], torch.as_tensor(synd)[:, None]
        )[0])

    def process_var_node(self, node_index, lappr_data, check_to_var,
                         var_to_check, updated_lappr):
        """Single variable-node update; returns updated copies of
        ``(var_to_check, updated_lappr)``."""
        g = self.graph
        check_to_var = np.asarray(check_to_var, np.float64)
        var_to_check = np.array(var_to_check, np.float64, copy=True)
        updated_lappr = np.array(updated_lappr, np.float64, copy=True)
        edges = np.flatnonzero(g.e_to_v == node_index)
        total = (float(np.asarray(lappr_data)[node_index])
                 + check_to_var[edges].sum())
        updated_lappr[node_index] = total
        var_to_check[edges] = total - check_to_var[edges]
        return var_to_check, updated_lappr

    def process_check_node(self, node_index, synd, check_to_var,
                           var_to_check):
        """Single check-node update (exact float64 box-plus over the other
        edges, pairwise); returns an updated copy of ``check_to_var``."""
        g = self.graph
        check_to_var = np.array(check_to_var, np.float64, copy=True)
        var_to_check = np.asarray(var_to_check, np.float64)
        synd = np.asarray(synd).astype(np.int64)
        edges = np.flatnonzero(g.e_to_c == node_index)
        msgs = var_to_check[edges]
        pref = -1.0 if synd[node_index] else 1.0
        for pos, e in enumerate(edges):
            others = np.delete(msgs, pos)
            acc = others[0]
            for m in others[1:]:
                acc = float(box_plus(torch.tensor(acc, dtype=torch.float64),
                                     torch.tensor(m, dtype=torch.float64)))
            check_to_var[e] = pref * acc
        return check_to_var
