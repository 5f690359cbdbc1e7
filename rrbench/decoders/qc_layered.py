"""The quasi-cyclic decoder's resident layered loop (kernel 3), min-sum.

``program`` builds ``QCDecoder`` with ``schedule="layered"`` and
``resident=True``: ``sim_reconciliation --qc --schedule layered --resident
--check-rule minsum``.  ``Reference`` is a frozen copy of
``QCDecoder._decode_resident_layered`` (``qamreconciliation_tpu_torch/
models/qc_decoder.py``), of ``bp_layered_sweeps_qc_ref``,
``layered_sweep``, ``layered_levels``, ``QCTables.row_groups`` and
``syndrome_violations`` and of the min-sum branch of ``_check_messages``
(``ops/kernels.py``) with ``minsum_mag`` and ``minsum_extrinsic_mag``
(``ops/boxplus.py``) at commit 5855af2: f32 totals, prior included; the
frames whose prior is consistent start done with ``iters`` 0; per sweep
the frames done at its start frozen, the block rows by dependency level,
each row's new messages stored in the message dtype and their deltas
folded into the totals slot by slot, then the syndrome tested (``iters``
the 1-based sweep); a host test of "all done?" every ``chunk`` sweeps.
:func:`layered_sweeps_work` is a frozen copy of ``utils/perf.
layered_sweeps_work`` at the same commit, with one change: the operations
are counted per (frame, sweep) pair the call ran (:func:`frame_sweeps`),
not for every frame every sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ref.checks import BIG, _signed
from ..work import _I8, _I32, OPS_PER_SLOT, _size

# the decoder's attribute that calls kernel 3 (``ops/kernels.
# bp_layered_sweeps_qc``): bp_layered_sweeps_qc(tables, it0, maxiter,
# total, c2v, synd, done, iters, *, rule, k_sweeps, ...)
KERNEL_HOOK = "sweeps_step"


def program(code, spec, dtype, device):
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    return QCDecoder(code.base_edges, code.z, dtype, device=device,
                     check_rule=spec["check_rule"],
                     minsum_alpha=spec["minsum_alpha"],
                     minsum_beta=spec["minsum_beta"], schedule="layered",
                     resident=True, layered_chunk=spec["chunk"])


def pre_call(args, kw):
    """What a traced call's record needs from before the call: ``done``."""
    return args[6].clone()


def call_record(args, kw, done_before):
    """A traced kernel-3 call: its state's sizes, its message dtype, its
    rule, the sweeps it ran and the (frame, sweep) pairs of frames not
    done at a sweep's start."""
    tables, it0, maxiter, total, c2v = args[:5]
    done, iters = args[6], args[7]
    n = max(min(int(kw["k_sweeps"]), int(maxiter) - int(it0)), 0)
    return {"hook": KERNEL_HOOK, "kernel": "bp_layered_sweeps_qc",
            "dims": (tables.nb_v, tables.nb_c, tables.E, tables.z,
                     total.shape[-1]),
            "m_dtype": c2v.dtype, "rule": kw["rule"], "sweeps": n,
            "frame_sweeps": frame_sweeps(done_before, done, iters,
                                         int(it0), n)}


def frame_sweeps(done_before, done_after, iters, it0: int, n: int):
    """The (frame, sweep) pairs a kernel-3 call of ``n`` sweeps from sweep
    ``it0`` ran on frames not done at the sweep's start: none for a frame
    done before the call, ``iters - it0`` for one that converged in it
    (``iters`` is the 1-based sweep that converged it), ``n`` for the
    others; a 0-dim tensor on their device."""
    fresh = done_after.bool() & ~done_before.bool()
    sweeps = torch.where(fresh, iters.to(torch.int64) - it0,
                         torch.full_like(iters, n, dtype=torch.int64))
    return torch.where(done_before.bool(), 0, sweeps).sum()


def layered_sweeps_work(nb_v, nb_c, E, z, B, m_dtype, rule, frame_sweeps):
    """Kernel 3, one call: the state in (f32 totals [nb_v, z, B], c2v [E,
    z, B], int8 syndrome [nb_c, z, B], done and iters [B]) and out
    (totals, c2v, done, iters) once; the operations of every slot of a
    frame's rows for each of the ``frame_sweeps`` (frame, sweep) pairs the
    call ran."""
    m = _size(m_dtype)
    nbytes = (2 * nb_v * z * B * 4 + 2 * E * z * B * m
              + nb_c * z * B * _I8 + 4 * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * E * z * frame_sweeps


def layered_levels(rows):
    """Dependency levels of the serial sweep: a row's level is 1 + the
    highest level of the earlier rows that share a variable block with
    it; a list of levels, each a list of row indices (ascending)."""
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


def minsum_messages(v2c, synd, dim: int, alpha: float, beta: float):
    """New check->variable messages of the normalized/offset min-sum
    rule: each slot's least magnitude among the other slots of ``dim``
    (the unique argmin sees the second least), ``max(alpha*m - beta, 0)``
    (a bare multiply for beta 0), with the XOR sign parity."""
    absm = torch.abs(v2c)
    big = torch.tensor(BIG, dtype=absm.dtype, device=absm.device)
    min1 = torch.amin(absm, dim=dim, keepdim=True)
    is_min = absm == min1
    cnt = torch.sum(is_min, dim=dim, keepdim=True)
    min2 = torch.amin(torch.where(is_min, big, absm), dim=dim, keepdim=True)
    mag = alpha * torch.where(is_min & (cnt == 1), min2, min1)
    if beta:
        mag = torch.clamp_min(mag - beta, 0.0)
    return _signed(v2c, (v2c < 0).to(torch.int32), synd, dim, mag)


class Reference:
    def __init__(self, code, spec, prec, device):
        if spec["check_rule"] != "minsum":
            raise ValueError("the reference has the min-sum rule only")
        z = self.z = int(code.z)
        rows = {}
        for c, v, s in code.base_edges:
            rows.setdefault(int(c), []).append((int(v), int(s) % z))
        self.nb_c = len(rows)
        self.rows = [rows[c] for c in range(self.nb_c)]
        self.nb_v = max(v for row in self.rows for v, _ in row) + 1
        off = np.concatenate([[0], np.cumsum([len(r) for r in self.rows])])
        self.E = int(off[-1])
        self.alpha = float(spec["minsum_alpha"])
        self.beta = float(spec["minsum_beta"])
        self.chunk = int(spec["chunk"])
        self.prec = prec
        j = np.arange(z)

        def groups(batches):
            """Each batch of rows split by degree: ``(cbs, gidx [R, deg,
            z], eidx [R*deg], deg)``, gidx the flat totals index each
            slot reads, eidx the rows' edges."""
            out = []
            for batch in batches:
                by_deg = {}
                for cb in batch:
                    by_deg.setdefault(len(self.rows[cb]), []).append(cb)
                for deg, cbs in sorted(by_deg.items()):
                    gidx = np.stack([np.stack([v * z + (j - s) % z
                                               for v, s in self.rows[cb]])
                                     for cb in cbs])
                    eidx = np.concatenate([off[cb] + np.arange(deg)
                                           for cb in cbs])
                    out.append(tuple(
                        torch.as_tensor(a, dtype=torch.int64, device=device)
                        for a in (cbs, gidx, eidx)) + (deg,))
            return out

        self.sweep_groups = groups(layered_levels(self.rows))
        self.check_groups = groups([range(self.nb_c)])

    def _violations(self, total, synd):
        B = total.shape[-1]
        bits = (total < 0).to(torch.int32).reshape(-1, B)
        viol = torch.zeros(B, dtype=torch.int32, device=total.device)
        for cbs, gidx, _, deg in self.check_groups:
            par = bits.index_select(0, gidx.reshape(-1)).view(
                len(cbs), deg, self.z, B).sum(1) & 1
            viol += torch.sum(par != synd.index_select(0, cbs), dim=(0, 1),
                              dtype=torch.int32)
        return viol

    def _sweep(self, total, c2v, synd, frozen):
        z, B = self.z, total.shape[-1]
        t_flat = total.view(-1, B)
        for cbs, gidx, eidx, deg in self.sweep_groups:
            shape = (len(cbs), deg, z, B)
            t = t_flat.index_select(0, gidx.reshape(-1)).view(shape)
            old = c2v.index_select(0, eidx).view(shape).to(t.dtype)
            stored = self.prec.cast(minsum_messages(
                t - old, synd.index_select(0, cbs), 1, self.alpha,
                self.beta))
            delta = stored.to(t.dtype) - old
            for d in range(deg):
                idx = gidx[:, d].reshape(-1)
                cur = t_flat.index_select(0, idx)
                upd = torch.where(frozen, cur,
                                  cur + delta[:, d].reshape(-1, B))
                t_flat.index_copy_(0, idx, upd)
            c2v.index_copy_(0, eidx, stored.view(-1, z, B))

    @torch.no_grad()
    def decode(self, prior_nb, synd_cb, max_iterations: int):
        z, B = self.z, prior_nb.shape[1]
        maxiter = int(max_iterations)
        prior = prior_nb.to(torch.float32).reshape(self.nb_v, z, B)
        synd = synd_cb.to(torch.int32).reshape(self.nb_c, z, B)
        total = prior.clone(memory_format=torch.contiguous_format)
        c2v = torch.zeros((self.E, z, B), dtype=self.prec.dtype,
                          device=prior.device)
        done = (self._violations(prior, synd) == 0).to(torch.int32)
        iters = torch.zeros(B, dtype=torch.int32, device=prior.device)
        it = 0
        while it < maxiter and not bool(done.all()):
            for k in range(min(self.chunk, maxiter - it)):
                self._sweep(total, c2v, synd, done.bool())
                conv = self._violations(total, synd) == 0
                iters = torch.where(conv & (done == 0), it + k + 1, iters)
                done = done | conv.to(torch.int32)
            it += self.chunk
        done = done.bool()
        iters = torch.where(done, iters, maxiter)
        return done, iters, total.reshape(self.nb_v * z, B)
