"""The generic flooding decoder over an expanded edge list (kernel 4).

``program`` builds ``Decoder``.  ``Reference`` is a frozen copy of
``TannerGraph``'s slot layouts, ``Decoder.decode_batched``, ``var_totals``
and ``_consistent`` (``qamreconciliation_tpu_torch/models/decoder.py``) and
of ``bp_check_phase_generic_ref`` (``ops/kernels.py``) at commit bdbe956:
per iteration gather 1, the masked check phase (its parity test first),
the snapshot of frames that newly satisfy their syndrome, gather 2 with
its left-fold sum in slot order; one consistency test at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ref.checks import masked_messages

# the decoder's attribute that calls kernel 4 (``ops/kernels.
# bp_check_phase_generic``): (t [dc, C, B], c2v, synd, c_mask, *, rule, ...)
KERNEL_HOOK = "check_phase"


def program(code, spec, dtype, device):
    from qamreconciliation_tpu_torch.models.decoder import Decoder

    return Decoder(code.vid, code.cid, dtype, device=device,
                   check_rule=spec["check_rule"],
                   check_phi=spec["check_phi"])


def pre_call(args, kw):
    return None


def call_record(args, kw, pre):
    """A traced kernel-4 call: its shape, dtype and rule."""
    t = args[0]
    return {"hook": KERNEL_HOOK, "shape": tuple(t.shape), "m_dtype": t.dtype,
            "rule": kw["rule"]}


def _slot_positions(ids):
    """Position of each edge among its node's edges, in edge-id order."""
    order = np.argsort(ids, kind="stable")
    pos = np.empty(ids.size, np.int64)
    sorted_ids = ids[order]
    starts = np.flatnonzero(np.r_[True, sorted_ids[1:] != sorted_ids[:-1]])
    first = np.repeat(starts, np.diff(np.r_[starts, ids.size]))
    pos[order] = np.arange(ids.size) - first
    return pos


class Reference:
    def __init__(self, code, spec, prec, device):
        if (spec["check_rule"], spec["check_phi"]) != ("sumproduct",
                                                       "tanhfb"):
            raise ValueError("the reference has the tanh-F/B sum-product "
                             "rule only")
        vid = np.asarray(code.vid, np.int64)
        cid = np.asarray(code.cid, np.int64)
        V, C = int(vid.max()) + 1, int(cid.max()) + 1
        vpos, cpos = _slot_positions(vid), _slot_positions(cid)
        dv_max = int(np.bincount(vid).max())
        dc_max = int(np.bincount(cid).max())
        # slot-major check layout [dc_max, C]: each slot's variable (0 in
        # padding) and mask; variable layout [dv_max, V]: the flat
        # check-layout index d*C + c of each incoming edge, and its mask
        c_vids = np.zeros((dc_max, C), np.int64)
        c_vids[cpos, cid] = vid
        c_mask = np.zeros((dc_max, C), np.float32)
        c_mask[cpos, cid] = 1.0
        v_from_c = np.zeros((dv_max, V), np.int64)
        v_from_c[vpos, vid] = cpos * C + cid
        v_mask = np.zeros((dv_max, V), np.float32)
        v_mask[vpos, vid] = 1.0
        t = dict(device=device)
        self.c_vids = torch.as_tensor(c_vids, **t)
        self.c_mask = torch.as_tensor(c_mask, **t)
        self.c_mask_i = torch.as_tensor(c_mask.astype(np.int32), **t)
        self.v_from_c = torch.as_tensor(v_from_c, **t)
        self.v_mask = torch.as_tensor(v_mask, **t)
        self.dc_max, self.dv_max, self.C = dc_max, dv_max, C
        self.prec = prec

    def _gather(self, x):
        return x.index_select(0, self.c_vids.reshape(-1)).view(
            self.dc_max, self.C, x.shape[-1])

    def _check_phase(self, t, c2v, synd):
        t = t.float()
        mask = self.c_mask[:, :, None]
        neg_t = (t < 0).to(torch.int32) * mask.to(torch.int32)
        viol = ((torch.sum(neg_t, dim=0) & 1) != synd).sum(0)
        new = masked_messages(t - c2v.float(), synd, mask, 0)
        return self.prec.cast(new), viol

    def _var_totals(self, prior, c2v):
        flat = c2v.reshape(-1, c2v.shape[-1])
        acc = None
        for d in range(self.dv_max):
            x = flat.index_select(0, self.v_from_c[d]).to(torch.float32) \
                * self.v_mask[d][:, None]
            acc = x if acc is None else acc + x
        return self.prec.cast(prior + acc)

    def _consistent(self, total, synd):
        bits = (self._gather(total) < 0).to(torch.int32) \
            * self.c_mask_i[:, :, None]
        parity = torch.sum(bits, dim=0, dtype=torch.int32) & 1
        return (parity != synd).sum(0) == 0

    @torch.no_grad()
    def decode(self, prior, synd, max_iterations: int):
        maxiter, B = int(max_iterations), prior.shape[1]
        prior_sum = prior.to(torch.float32)
        synd = synd.to(torch.int32).contiguous()
        c2v = torch.zeros((self.dc_max, self.C, B), dtype=self.prec.dtype,
                          device=prior.device)
        total = final = prior
        done = torch.zeros(B, dtype=torch.bool, device=prior.device)
        iters = torch.zeros(B, dtype=torch.int32, device=prior.device)
        it, all_done = 0, False
        while it < maxiter and not all_done:
            c2v, viol = self._check_phase(self._gather(total), c2v, synd)
            conv = viol == 0
            newly = conv & ~done
            iters = torch.where(newly, it, iters)
            done = done | conv
            all_done = bool(done.all())
            final = torch.where(newly, total, final)
            total = self._var_totals(prior_sum, c2v)
            it += 1
        conv = self._consistent(total, synd)
        newly = conv & ~done
        iters = torch.where(newly, min(it, maxiter), iters)
        final = torch.where(newly, total, final)
        done = done | conv
        iters = torch.where(done, iters, maxiter)
        return done, iters, torch.where(done, final, total)
