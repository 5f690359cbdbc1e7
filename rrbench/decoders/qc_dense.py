"""The quasi-cyclic decoder's dense flooding loop (kernel 1).

``program`` builds ``QCDecoder`` with ``resident=False``: the default
decoder of ``sim_reconciliation --qc``.  ``Reference`` is a frozen copy of
``QCDecoder._build_indices``, ``_gather``, ``_decode_dense``,
``_record_converged``, ``_finish_flooding`` and ``fold_incoming``
(``qamreconciliation_tpu_torch/models/qc_decoder.py``), of
``bp_check_phase_qc_ref`` with its phi rule (``ops/kernels.py``) and of
``phi_llr`` (``ops/boxplus.py``) at commit 1dcd87c: per iteration the
totals gathered to [nb_c, dc, z, B] (short rows padded with +1e30), the
check phase (its parity test first), a host read of "newly converged?"
and "all done?", each variable's messages left-folded in (row, slot)
order plus the prior; one consistency test at the end.
:func:`check_phase_qc_work` is a frozen copy of ``utils/perf.
check_phase_qc_work`` at the same commit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ref.checks import BIG, _signed, fold_sum
from ..work import _I32, OPS_PER_SLOT, _size

# the decoder's attribute that calls kernel 1 (``ops/kernels.
# bp_check_phase_qc``): (t [nb_c, dc, z, B], c2v, synd, *, rule, ...)
KERNEL_HOOK = "check_phase"
# phi's input floor: the kernel's default ``tiny``, which the decoder keeps
TINY = 1e-30


def program(code, spec, dtype, device):
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    return QCDecoder(code.base_edges, code.z, dtype, device=device,
                     check_rule=spec["check_rule"],
                     check_phi=spec["check_phi"], totals_dtype="storage",
                     resident=False)


def pre_call(args, kw):
    return None


def call_record(args, kw, pre):
    """A traced kernel-1 call: its shape [nb_c, dc, z, B], its t and c2v
    dtypes and its rule."""
    t, c2v = args[:2]
    return {"hook": KERNEL_HOOK, "kernel": "bp_check_phase_qc",
            "shape": tuple(t.shape), "t_dtype": t.dtype,
            "m_dtype": c2v.dtype, "rule": kw["rule"]}


def check_phase_qc_work(nb_c, dc, z, B, t_dtype, m_dtype, rule):
    """Kernel 1, one call: t [nb_c, dc, z, B] and c2v in, int32 syndrome
    [nb_c, z, B] in, c2v out, violations [nb_c, B] out; the operations of
    every slot."""
    slots = nb_c * dc * z * B
    nbytes = (slots * (_size(t_dtype) + 2 * _size(m_dtype))
              + nb_c * z * B * _I32 + nb_c * B * _I32)
    return nbytes, OPS_PER_SLOT[rule] * slots


def phi_llr(x):
    """phi(x) = -log(tanh(x/2)), inputs clamped to [TINY, inf): below 10
    the tanh form, from 10 up ``log1p(e^-x) - log1p(-e^-x)``."""
    x = torch.clamp_min(x, TINY)
    ex = torch.exp(-torch.clamp_min(x, 10.0))
    big = torch.log1p(ex) - torch.log1p(-ex)
    small = -torch.log(torch.tanh(torch.clamp_max(x, 10.0) / 2.0))
    return torch.where(x < 10.0, small, big)


def phi_messages(v2c, synd, dim: int):
    """New check->variable messages of the phi sum-product rule:
    ``phi(sum phi(|m|) - phi(|m_e|))`` with the XOR sign parity."""
    phim = phi_llr(torch.abs(v2c))
    mag = phi_llr(fold_sum(phim, dim) - phim)
    return _signed(v2c, (v2c < 0).to(torch.int32), synd, dim, mag)


class Reference:
    def __init__(self, code, spec, prec, device):
        if (spec["check_rule"], spec["check_phi"]) != ("sumproduct", "phi"):
            raise ValueError("the reference has the phi sum-product rule "
                             "only")
        z = self.z = int(code.z)
        rows = {}
        for c, v, s in code.base_edges:
            rows.setdefault(int(c), []).append((int(v), int(s)))
        self.nb_c = max(rows) + 1
        self.rows = [rows[c] for c in range(self.nb_c)]
        self.nb_v = max(v for row in self.rows for v, _ in row) + 1
        self.vnum = self.nb_v * z
        dc = self.dc = max(len(r) for r in self.rows)
        self.prec = prec
        # gather: t[cb, d, j] = total[vb, (j - s) % z], padded slots at the
        # appended row vnum; each variable's messages c2v[cb, d, (k + s) %
        # z] in (cb, slot) order, variables grouped by degree
        j = np.arange(z)
        gidx = np.full((self.nb_c, dc, z), self.vnum, np.int64)
        incoming = [[] for _ in range(self.nb_v)]
        for cb, row in enumerate(self.rows):
            for d, (v, s) in enumerate(row):
                gidx[cb, d] = v * z + (j - s) % z
                incoming[v].append((cb * dc + d) * z + (j + s) % z)
        self.gidx = torch.as_tensor(gidx.reshape(-1), device=device)
        by_deg = {}
        for v, parts in enumerate(incoming):
            if parts:
                by_deg.setdefault(len(parts), []).append(v)
        self.groups = [
            (torch.as_tensor(vbs, device=device),
             torch.as_tensor(np.stack([np.stack(incoming[v]) for v in vbs])
                             .reshape(-1), device=device), deg)
            for deg, vbs in sorted(by_deg.items())]

    def _gather(self, total):
        B = total.shape[-1]
        flat = torch.cat([total.reshape(self.vnum, B),
                          torch.full((1, B), BIG, dtype=total.dtype,
                                     device=total.device)])
        return flat.index_select(0, self.gidx).view(self.nb_c, self.dc,
                                                     self.z, B)

    def _check_phase(self, t, c2v, synd):
        t = t.to(torch.float32)
        parity = torch.sum((t < 0).to(torch.int32), dim=1) & 1
        viol = torch.sum((parity != synd).to(torch.int32), dim=1,
                         dtype=torch.int32)
        new = phi_messages(t - c2v.to(torch.float32), synd, 1)
        return self.prec.cast(new), viol

    def _fold(self, c2v):
        """Each variable's messages left-folded in (cb, slot) order, f32."""
        B = c2v.shape[-1]
        flat = c2v.reshape(-1, B)
        acc = torch.zeros((self.nb_v, self.z, B), dtype=torch.float32,
                          device=c2v.device)
        for vbs, idx, deg in self.groups:
            g = flat.index_select(0, idx).view(len(vbs), deg, -1, B)
            acc.index_copy_(0, vbs, fold_sum(g.to(torch.float32),
                                             1).squeeze(1))
        return acc

    def _consistent(self, total, synd):
        t = self._gather(total)
        parity = torch.sum((t < 0).to(torch.int32), dim=1) & 1
        return torch.all((parity == synd).reshape(-1, t.shape[-1]), dim=0)

    @torch.no_grad()
    def decode(self, prior_nb, synd_cb, max_iterations: int):
        z, B = self.z, prior_nb.shape[1]
        maxiter = int(max_iterations)
        prior = self.prec.cast(prior_nb).reshape(self.nb_v, z, B)
        synd = synd_cb.to(torch.int32).reshape(self.nb_c, z, B).contiguous()
        c2v = torch.zeros((self.nb_c, self.dc, z, B), dtype=self.prec.dtype,
                          device=prior.device)
        total = final = prior
        done = torch.zeros(B, dtype=torch.bool, device=prior.device)
        iters = torch.zeros(B, dtype=torch.int32, device=prior.device)
        it, all_done = 0, False
        while it < maxiter and not all_done:
            c2v, viol = self._check_phase(self._gather(total), c2v, synd)
            conv = viol.sum(0) == 0
            newly = conv & ~done
            iters = torch.where(newly, it, iters)
            done = done | conv
            any_new, all_done = torch.stack([newly.any(),
                                             done.all()]).tolist()
            if any_new:
                final = torch.where(newly, total, final)
            total = self.prec.cast(prior.to(torch.float32)
                                   + self._fold(c2v))
            it += 1
        conv = self._consistent(total, synd)
        newly = conv & ~done
        iters = torch.where(newly, min(it, maxiter), iters)
        final = torch.where(newly, total, final)
        done = done | conv
        iters = torch.where(done, iters, maxiter)
        final = torch.where(done, final, total)
        return done, iters, final.reshape(self.vnum, B)
