"""Readings that the limits of a cell's ``correct`` are set from.

    python3 -m rrbench.control --workload <cell> --seeds S1,S2,... \\
        [--seconds 3] [--controls 3] [--precision float8_e4m3fn]

In one process, on the card: the cell's set-up once, then for each seed a
window of ``--seconds`` at the cell's own sizes and load, checked as a run
checks it (the sound readings of the program), and for the first
``--controls`` seeds the control: the plain reference in ``--precision``
(the precision below the configuration's bf16) put in the program's place
on the same sampled rounds and held to the same reference.  Prints one
JSON object: each seed's numbers, and the largest sound and the smallest
control reading of each number.  ``rrbench/tests/test_rrbench_control.py``
runs the same at a size a test run holds.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run, spec


def readings(cell, seeds, seconds, controls, precision, device):
    """``{"sound": [...], "control": [...]}`` of each seed's numbers."""
    device = torch.device(device)
    session = run.Session(cell, seeds[0], device)
    checker = run.Checker(cell, session.code, device)
    lower = run.Checker(cell, session.code, device, precision=precision)
    out = {"sound": [], "control": []}
    for k, seed in enumerate(seeds):
        win = session.window(seed, seconds)
        rec = session.recorder
        nums = run.check(checker, win["seeds"], rec.captures,
                         rec.point_rounds, win["results"])
        out["sound"].append({"seed": seed, "points": len(win["results"]),
                             **{n: c["value"] for n, c in nums.items()}})
        run.log(f"sound seed {seed}: {out['sound'][-1]}")
        if k < controls:
            pre = dec = cnt = 0
            for cap in rec.captures.values():
                s, r = win["seeds"][cap["point"]], cap["round"]
                p, d, c = run.round_diff(lower.round(s, r),
                                         checker.round(s, r))
                pre, dec, cnt = pre + p, dec + d, cnt + c
            out["control"].append({"seed": seed, "preamble_diff": pre,
                                   "decode_diff": dec, "counter_diff": cnt,
                                   "rounds": len(rec.captures)})
            run.log(f"control seed {seed}: {out['control'][-1]}")
    names = ("preamble_diff", "decode_diff", "counter_diff")
    out["lower"] = {n: max(r[n] for r in out["sound"]) for n in names}
    if out["control"]:
        out["upper"] = {n: min(r[n] for r in out["control"]) for n in names}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--precision", default="float8_e4m3fn")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    cell = spec.cell(spec.load_benchmark(run.ROOT), run.ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = readings(cell, seeds, args.seconds, args.controls, args.precision,
                   "cuda")
    out.update(workload=args.workload, precision=args.precision,
               seconds=args.seconds,
               device=run.device_record(torch.device("cuda", 0), 1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
