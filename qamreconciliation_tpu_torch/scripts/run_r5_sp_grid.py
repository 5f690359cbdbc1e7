"""Decode-probe grid of the resident engines at z = 360.

The port's counterpart of the JAX package's ``scripts/run_r5_sp_grid.py``:
eight probes of ``QCDecoder._build_decode()`` (bf16, B = 128, a random
syndrome so that every probe runs all ``--probe-iters`` iterations), each
the minimum over ``--reps`` host-clock calls between two synchronizes:

  rate-3/4 QC-IRA resident sum-product and min-sum; the regular (3,6)
  code resident sum-product at chunk 50 and 250, with the phi magnitude
  (``resident_phi="phi"``) in place of tanh-F/B, and min-sum; the rate-1/2
  QC-IRA resident sum-product; the resident layered sum-product.

    python -m qamreconciliation_tpu_torch.scripts.run_r5_sp_grid \\
        [--configs "sp reg tree c50"] [--reps 4] [--device cuda] \
        > r5_sp_grid.jsonl

Where the JAX record has ``rowgroup`` (a TPU register-pressure split) the
port's has ``plan``: the launch plan of the kernel the probe ran
(``ops.kernels.resident_plan``; null where no kernel ran, as on the CPU).
One JSON record a probe after the device record; exit 1 when one failed.
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from . import _codes
from ._runner import Campaign, add_args, time_decode
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..ops import kernels as K

__all__ = ["PROBES", "main"]

# (name, code, decoder keywords)
PROBES = [
    ("rate34 resident rowgroup-fix", "r34",
     dict(check_rule="sumproduct", resident=True, resident_chunk=50)),
    ("rate34 resident minsum", "r34",
     dict(check_rule="minsum", resident=True, resident_chunk=50)),
    ("sp reg tree c50", "reg",
     dict(check_rule="sumproduct", resident=True, resident_chunk=50)),
    ("sp reg tree c250", "reg",
     dict(check_rule="sumproduct", resident=True, resident_chunk=250)),
    ("sp reg phi c50", "reg",
     dict(check_rule="sumproduct", resident=True, resident_chunk=50,
          resident_phi="phi")),
    ("minsum reg control c50", "reg",
     dict(check_rule="minsum", resident=True, resident_chunk=50)),
    ("sp ira tree c50", "ira",
     dict(check_rule="sumproduct", resident=True, resident_chunk=50)),
    ("sp reg layered-resident", "reg",
     dict(check_rule="sumproduct", schedule="layered", resident=True)),
]


def kernel_plan(dec):
    """The plan of the last launch of the decoder's resident kernel, as a
    dict, or None."""
    wrapper = (K.bp_layered_sweeps_qc if dec.schedule == "layered"
               else K.bp_decode_rounds_qc)
    return None if wrapper.plan is None else dataclasses.asdict(wrapper.plan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_r5_sp_grid")
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--nbv", type=int, default=180)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--probe-iters", type=int, default=250)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--configs", default="",
                    help="substring filter on config names")
    add_args(ap)
    args = ap.parse_args(argv)

    camp = Campaign("run_r5_sp_grid", args.device)
    z = args.n // args.nbv
    B = args.batch
    reg, _, _ = make_qc_ldpc(args.nbv, z, dv=3, dc=6, seed=_codes.SEED)
    codes = {"reg": reg, "ira": _codes.ira_base(args.nbv, z, "1/2"),
             "r34": _codes.ira_base(args.nbv, z, "3/4")}
    rng = np.random.default_rng(0)
    flt = [s for s in args.configs.split(",") if s]
    for name, code, kw in PROBES:
        if flt and not any(s in name for s in flt):
            continue
        with camp.config({"config": name}):
            dec = QCDecoder(codes[code], z, dtype=torch.bfloat16,
                            device=args.device, **kw)
            lappr = torch.as_tensor(rng.normal(0, 3.0, (dec.vnum, B)),
                                    dtype=torch.bfloat16, device=dec.device)
            synd = torch.as_tensor(rng.integers(0, 2, (dec.cnum, B)),
                                   dtype=torch.int32, device=dec.device)
            K.bp_decode_rounds_qc.plan = K.bp_layered_sweeps_qc.plan = None
            compile_s, ms = time_decode(dec, lappr, synd, args.probe_iters,
                                        args.reps)
            camp.emit({
                "config": name, "z": z, "batch": B,
                "dc": sorted({len(r) for r in dec._rows}),
                "plan": kernel_plan(dec),
                "compile_s": round(compile_s, 1),
                "ms_per_iter": round(min(ms) / args.probe_iters, 4),
                "reps_ms_per_iter": [round(m / args.probe_iters, 4)
                                     for m in ms],
            })
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
