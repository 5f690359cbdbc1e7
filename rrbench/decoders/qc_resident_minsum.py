"""The quasi-cyclic decoder's resident flooding loop (kernel 2), min-sum.

``program`` builds ``QCDecoder`` with ``resident=True`` and
``check_rule="minsum"``: ``sim_reconciliation --qc --resident --check-rule
minsum``.  ``Reference`` is a frozen copy of ``bp_decode_rounds_qc_ref``,
of the min-sum branch of ``_flooding_check_pass`` and ``_check_messages``
(``qamreconciliation_tpu_torch/ops/kernels.py``) and of
``QCDecoder._decode_resident`` (``models/qc_decoder.py``) at commit
86cb161: per step, the check pass on rolled reads of the totals (its
parity test first) with the normalized/offset min-sum magnitude, then the
totals of the frames not yet done from the new messages, in (row, slot)
order; a host test of "all done?" every ``chunk`` steps; the consistency
test of the last totals at the end.  The loop, the index tables and the
tail are the tanh-F/B reference's (``qc_resident.Reference``), which
match the program at this commit; the step is its own.
"""

from __future__ import annotations

import torch

from ..ref.checks import fold_sum
from . import qc_resident
from .qc_layered import minsum_messages
from .qc_resident import KERNEL_HOOK, call_record, pre_call

__all__ = ["KERNEL_HOOK", "Reference", "call_record", "pre_call",
           "program"]


def program(code, spec, dtype, device):
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    return QCDecoder(code.base_edges, code.z, dtype, device=device,
                     check_rule=spec["check_rule"],
                     minsum_alpha=spec["minsum_alpha"],
                     minsum_beta=spec["minsum_beta"],
                     resident=True, resident_chunk=spec["chunk"])


class Reference(qc_resident.Reference):
    def __init__(self, code, spec, prec, device):
        if spec["check_rule"] != "minsum":
            raise ValueError("the reference has the min-sum rule only")
        # the parent builds the index tables and takes its own rule alone
        super().__init__(code, {"check_rule": "sumproduct",
                                "resident_phi": "tanhfb",
                                "chunk": spec["chunk"]}, prec, device)
        self.alpha = float(spec["minsum_alpha"])
        self.beta = float(spec["minsum_beta"])

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
            new = minsum_messages(t - old, s, 1, self.alpha, self.beta)
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
