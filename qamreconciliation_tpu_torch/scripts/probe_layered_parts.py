"""Split the layered sweep's cost from its convergence test.

The port's counterpart of the JAX package's
``scripts/probe_layered_parts.py``: loops of ``--iters`` steps on the (3, 6)
QC code ``make_qc_ldpc(36, n / 36, 3, 6, seed=12345)``, each step fed by
the last,

  sweep  -- the probe's own layered sweep (rolled totals of each group's
            check blocks, the slot-major check update
            ``ops.boxplus.check_node_minsum_sm`` or ``check_node_update_sm``,
            the totals updated by the rolled deltas in group order), with no
            convergence test,
  parity -- the end-of-sweep int8 syndrome parity test alone,
  full   -- sweep and parity.

``--grouped 1`` runs the probe's greedy grouping of check blocks that share
no variable block (it lives only in the probe); ``--grouped 0`` one block a
group.  The sweep updates the totals and messages in place (each loop starts
from copies of the initial state).

    python -m qamreconciliation_tpu_torch.scripts.probe_layered_parts \\
        --part sweep|parity|full [--grouped 0] [--device cuda]

One record after the device record: ``{part, grouped, check, dtype,
ms_per_iter, compile_s, n_groups}`` (the mean of ``--reps`` loops in one
CUDA-event window, divided by ``--iters``).  Exits 2 without a card unless
``--device cpu``.
"""

import argparse
import sys

import numpy as np
import torch

from ._probe import add_device, emit, first_call, open_device, window_ms
from ..config import as_dtype
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..ops.boxplus import check_node_minsum_sm, check_node_update_sm

__all__ = ["greedy_groups", "LayeredProbe", "main"]


def greedy_groups(rows, grouped: bool):
    """Lists of check blocks: with ``grouped``, each block joins the first
    group that shares no variable block with it (the JAX probe's order),
    else one block a group."""
    if not grouped:
        return [[cb] for cb in range(len(rows))]
    var_sets = [{v for (v, _) in row} for row in rows]
    groups, used = [], []
    for cb in range(len(rows)):
        for i in range(len(groups)):
            if not (used[i] & var_sets[cb]):
                groups[i].append(cb)
                used[i] |= var_sets[cb]
                break
        else:
            groups.append([cb])
            used.append(set(var_sets[cb]))
    return groups


class LayeredProbe:
    """The probe's sweep and parity test on ``rows`` (the decoder's
    ``(v, shift)`` lists, one degree ``dc``) at lift ``z``, for syndromes
    ``synd`` [nb_c, z, B] int32 and messages of ``dtype``."""

    def __init__(self, rows, groups, synd, dtype, check: str):
        self.rows, self.groups, self.synd = rows, groups, synd
        self.dtype, self.check = dtype, check
        self.dc = len(rows[0])
        self.z = synd.shape[1]
        perm = [cb for grp in groups for cb in grp]
        self.synd_p = synd[torch.as_tensor(perm, device=synd.device)]
        self.offsets = np.cumsum([0] + [len(grp) for grp in groups])

    def layer_update(self, v2c, sg, g: int):
        ones = torch.ones((self.dc, g * self.z), device=v2c.device)
        if self.check == "minsum":
            return check_node_minsum_sm(v2c, sg, ones)
        return check_node_update_sm(v2c, sg, ones)

    def sweep(self, total, c2v):
        """One sweep over the groups; updates total [nb_v, z, B] (float32)
        and c2v [nb_c, dc, z, B] in place and returns them."""
        dc, z = self.dc, self.z
        B = total.shape[-1]
        for gi, grp in enumerate(self.groups):
            g = len(grp)
            off = int(self.offsets[gi])
            t = torch.cat(
                [torch.stack([torch.roll(total[v], s, 0)
                              for (v, s) in self.rows[cb]]) for cb in grp],
                dim=1)
            old = (c2v[off:off + g].transpose(0, 1)
                   .reshape(dc, g * z, B).float())
            sg = self.synd_p[off:off + g].reshape(g * z, B)
            stored = self.layer_update(t - old, sg, g).to(self.dtype)
            delta = stored.float() - old
            for i, cb in enumerate(grp):
                for d, (v, s) in enumerate(self.rows[cb]):
                    total[v] += torch.roll(delta[d, i * z:(i + 1) * z], -s, 0)
            c2v[off:off + g] = stored.reshape(dc, g, z, B).transpose(0, 1)
        return total, c2v

    def parity_ok(self, total):
        """[B] bool: every check's int8 XOR parity of the hard decisions
        equals its syndrome bit."""
        bits = (total < 0).to(torch.int8)
        ok = torch.zeros(total.shape[-1], dtype=torch.int32,
                         device=total.device)
        for cb, row in enumerate(self.rows):
            par = None
            for (v, s) in row:
                slab = torch.roll(bits[v], s, 0)
                par = slab if par is None else par ^ slab
            ok = ok + torch.sum((par.to(torch.int32) != self.synd[cb])
                                .to(torch.int32), dim=0)
        return ok == 0

    def body(self, part: str):
        """The loop body of ``part``: ``(total, c2v) -> (total, c2v)`` for
        sweep and full, ``total -> total`` for parity."""
        if part == "sweep":
            return lambda st: self.sweep(*st)
        if part == "parity":
            return lambda total: total + self.parity_ok(total).float()[
                None, None, :] * 1e-6

        def full(st):
            total, c2v = self.sweep(*st)
            okf = self.parity_ok(total).float()
            return total + okf[None, None, :] * 0.0, c2v

        return full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_layered_parts")
    ap.add_argument("--part", choices=["sweep", "parity", "full"],
                    required=True)
    ap.add_argument("--grouped", type=int, default=1)
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--check", default="minsum")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_layered_parts", args.device)
    if device is None:
        return 2

    dt = as_dtype(args.dtype)
    z = args.n // 36
    base, _, _ = make_qc_ldpc(36, z, dv=3, dc=6, seed=12345)
    dec = QCDecoder(base, z, dtype=dt, device=device, schedule="layered",
                    check_rule=args.check)
    nb_c, nb_v, dc = dec.nb_c, dec.nb_v, dec.dc
    B = args.batch
    groups = greedy_groups(dec._rows, bool(args.grouped))
    print(f"groups: {[len(g) for g in groups]}", file=sys.stderr)

    rng = np.random.default_rng(0)
    synd = torch.as_tensor(rng.integers(0, 2, (nb_c, z, B)),
                           dtype=torch.int32, device=device)
    prior = torch.as_tensor(rng.normal(0, 3.0, (nb_v, z, B)),
                            dtype=torch.float32, device=device)
    c2v0 = torch.zeros((nb_c, dc, z, B), dtype=dt, device=device)
    probe = LayeredProbe(dec._rows, groups, synd, dt, args.check)
    body = probe.body(args.part)

    def loop():
        x = (prior.clone() if args.part == "parity"
             else (prior.clone(), c2v0.clone()))
        for _ in range(args.iters):
            x = body(x)
        return x

    compile_s = first_call(loop, device)
    print(f"compile+first: {compile_s:.1f}s", file=sys.stderr, flush=True)
    ms = window_ms(loop, args.reps, device) / args.iters
    emit({"part": args.part, "grouped": args.grouped, "check": args.check,
          "dtype": args.dtype, "ms_per_iter": round(ms, 4),
          "compile_s": round(compile_s, 1), "n_groups": len(groups)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
