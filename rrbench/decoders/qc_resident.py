"""The quasi-cyclic decoder's resident flooding loop (kernel 2).

``program`` builds ``QCDecoder`` with ``resident=True``.  ``Reference`` is a
frozen copy of ``bp_decode_rounds_qc_ref`` and ``_flooding_check_pass``
(``qamreconciliation_tpu_torch/ops/kernels.py``) and of
``QCDecoder._decode_resident`` (``models/qc_decoder.py``) at commit
bdbe956: per step, the check pass on rolled reads of the totals (its
parity test first), then the totals of the frames not yet done from the
new messages, in (row, slot) order; a host test of "all done?" every
``chunk`` steps; the consistency test of the last totals at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import work
from ..ref.checks import fold_sum, messages

# the decoder's attribute that calls kernel 2 (``ops/kernels.
# bp_decode_rounds_qc``): bp_decode_rounds_qc(tables, it0, maxiter, total,
# c2v, prior, synd, done, iters, *, rule, k_rounds, ...)
KERNEL_HOOK = "rounds_step"


def program(code, spec, dtype, device):
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    return QCDecoder(code.base_edges, code.z, dtype, device=device,
                     check_rule=spec["check_rule"],
                     resident=True, resident_chunk=spec["chunk"],
                     resident_phi=spec["resident_phi"])


def pre_call(args, kw):
    """What a traced call's record needs from before the call: ``done``."""
    return args[7].clone()


def call_record(args, kw, done_before):
    """A traced kernel-2 call: its state's sizes and dtypes, its rule and
    the (frame, step) pairs it ran."""
    tables, it0, maxiter, total, c2v = args[:5]
    done, iters = args[7], args[8]
    n = max(min(int(kw["k_rounds"]), int(maxiter) - int(it0)), 0)
    return {"hook": KERNEL_HOOK,
            "dims": (tables.nb_v, tables.nb_c, tables.E, tables.z,
                     total.shape[-1]),
            "total_dtype": total.dtype, "m_dtype": c2v.dtype,
            "rule": kw["rule"],
            "frame_steps": work.frame_steps(done_before, done, iters,
                                            int(it0), n)}


class Reference:
    def __init__(self, code, spec, prec, device):
        if (spec["check_rule"], spec["resident_phi"]) != ("sumproduct",
                                                          "tanhfb"):
            raise ValueError("the reference has the tanh-F/B sum-product "
                             "rule only")
        z = self.z = int(code.z)
        rows = {}
        for c, v, s in code.base_edges:
            rows.setdefault(int(c), []).append((int(v), int(s) % z))
        self.nb_c = len(rows)
        self.rows = [rows[c] for c in range(self.nb_c)]
        self.nb_v = max(v for row in self.rows for v, _ in row) + 1
        off = np.concatenate([[0], np.cumsum([len(r) for r in self.rows])])
        self.E = int(off[-1])
        self.chunk = int(spec["chunk"])
        self.prec, self.device = prec, device
        j = np.arange(z)
        # rows of one degree at a time: gidx [R, deg, z] the flat totals
        # index each slot reads, eidx [R*deg] the rows' edges
        by_deg = {}
        for cb, row in enumerate(self.rows):
            by_deg.setdefault(len(row), []).append(cb)
        self.row_groups = []
        for deg, cbs in sorted(by_deg.items()):
            gidx = np.stack([np.stack([v * z + (j - s) % z
                                       for v, s in self.rows[cb]])
                             for cb in cbs])
            eidx = np.concatenate([off[cb] + np.arange(deg) for cb in cbs])
            self.row_groups.append(tuple(
                torch.as_tensor(a, dtype=torch.int64, device=device)
                for a in (cbs, gidx, eidx)) + (deg,))
        # variable blocks of one degree at a time: cidx [V, deg, z] the
        # flat message index of each incoming edge in (row, slot) order
        cols = [[] for _ in range(self.nb_v)]
        for cb, row in enumerate(self.rows):
            for d, (v, s) in enumerate(row):
                cols[v].append((int(off[cb]) + d, s))
        by_deg = {}
        for v, col in enumerate(cols):
            by_deg.setdefault(len(col), []).append(v)
        self.var_groups = []
        for deg, vbs in sorted(by_deg.items()):
            cidx = np.stack([np.stack([e * z + (j + s) % z
                                       for e, s in cols[v]])
                             if deg else np.zeros((0, z), np.int64)
                             for v in vbs])
            self.var_groups.append((
                torch.as_tensor(vbs, dtype=torch.int64, device=device),
                torch.as_tensor(cidx, dtype=torch.int64, device=device),
                deg))

    def _violations(self, total, synd):
        B = total.shape[-1]
        bits = (total < 0).to(torch.int32).reshape(-1, B)
        viol = torch.zeros(B, dtype=torch.int32, device=total.device)
        for cbs, gidx, _, deg in self.row_groups:
            par = bits.index_select(0, gidx.reshape(-1)).view(
                len(cbs), deg, self.z, B).sum(1) & 1
            viol += torch.sum(par != synd.index_select(0, cbs), dim=(0, 1),
                              dtype=torch.int32)
        return viol

    def _step(self, it, total, c2v, prior, synd, done, iters):
        z, B = self.z, total.shape[-1]
        t_flat = total.view(-1, B)
        viol = torch.zeros(B, dtype=torch.int32, device=total.device)
        for cbs, gidx, eidx, deg in self.row_groups:
            shape = (len(cbs), deg, z, B)
            t = t_flat.index_select(0, gidx.reshape(-1)).view(shape).float()
            s = synd.index_select(0, cbs)
            parity = torch.sum((t < 0).to(torch.int32), dim=1) & 1
            viol += torch.sum((parity != s).to(torch.int32), dim=(0, 1),
                              dtype=torch.int32)
            old = c2v.index_select(0, eidx).view(shape).float()
            new = messages(t - old, s, 1)
            c2v.index_copy_(0, eidx, self.prec.cast(new).view(-1, z, B))
        conv = viol == 0
        iters.copy_(torch.where(conv & (done == 0), it, iters))
        done.copy_(done | conv.to(torch.int32))
        frozen = done.bool()
        c_flat = c2v.view(-1, B)
        for vbs, cidx, deg in self.var_groups:
            new = prior.index_select(0, vbs).float()
            if deg:
                g = c_flat.index_select(0, cidx.reshape(-1)).view(
                    len(vbs), deg, z, B).float()
                new = new + fold_sum(g, 1).squeeze(1)
            old = total.index_select(0, vbs)
            total.index_copy_(0, vbs, torch.where(frozen, old,
                                                  self.prec.cast(new)))

    @torch.no_grad()
    def decode(self, prior_nb, synd_cb, max_iterations: int):
        z, B = self.z, prior_nb.shape[1]
        maxiter = int(max_iterations)
        prior = prior_nb.reshape(self.nb_v, z, B)
        synd = synd_cb.to(torch.int32).reshape(self.nb_c, z, B)
        total = prior.clone()
        c2v = torch.zeros((self.E, z, B), dtype=self.prec.dtype,
                          device=prior.device)
        done = torch.zeros(B, dtype=torch.int32, device=prior.device)
        iters = torch.zeros(B, dtype=torch.int32, device=prior.device)
        it = 0
        while it < maxiter:
            for k in range(min(self.chunk, maxiter - it)):
                self._step(it + k, total, c2v, prior, synd, done, iters)
            it += self.chunk
            if bool(done.all()):
                break
        conv = self._violations(total, synd) == 0
        done = done.bool()
        iters = torch.where(conv & ~done, min(it, maxiter), iters)
        done = done | conv
        iters = torch.where(done, iters, maxiter)
        return done, iters, total.reshape(self.nb_v * z, B)
