"""BSC hard-decision BP sanity sweep CLI.

    python -m qamreconciliation_tpu_torch.sims.sim_bsc EDGEFILE [--qc |
        --lift-qc] [--out out.csv] [--maxiter 30] [--minerr 20]
        [--simloops 30] [--rber 0.01 0.04] [--rpoints 31] [--device cuda]
        [--devices D] ...

Output CSV: an unnamed index column then ``f,ber,fer,iters``; the LLRs
have the constant log-base-2 magnitude of the reference (see
bitchannel.py).
"""

import argparse

import numpy as np

from ..models.matrix import Matrix
from .bitchannel import BitChannelEngine
from .common import (
    add_engine_args, add_qc_arg, bit_channel_kwargs, load_decoder, run_cli,
    sweep,
)

__all__ = ["build_parser", "main"]


def build_parser():
    parser = argparse.ArgumentParser(
        prog="sim_bsc",
        description="Evaluate BER for LDPC codes vs Raw BER",
    )
    parser.add_argument("edgefile")
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--maxiter", default=30, type=int)
    parser.add_argument("--minerr", default=20, type=int)
    parser.add_argument(
        "--first_row", default=True, action="store_true",
        help="Flag: does the first line of the csv contain the number of edges",
    )
    parser.add_argument("--simloops", default=30, type=int)
    parser.add_argument("--rber", type=float, nargs=2, default=[0.01, 0.04])
    parser.add_argument("--rpoints", type=int, default=31)
    add_qc_arg(parser)
    add_engine_args(parser)
    return parser


def main(argv=None):
    """Run the sweep; returns the list of per-point :class:`PointResult`
    (``snr_dB`` holds the flip probability f)."""
    args = build_parser().parse_args(argv)
    started = run_cli(main, argv, args)
    if started is not None:
        return started
    kw = bit_channel_kwargs(args)
    dec, vid, cid = load_decoder(args)
    eng = BitChannelEngine(dec, Matrix(vid, cid), **kw)
    return sweep(
        args.out, args.resume, "f",
        np.linspace(args.rber[0], args.rber[1], args.rpoints),
        lambda i, f: eng.run_bsc_point(f, args.maxiter, args.simloops,
                                       args.minerr),
        profile_dir=args.profile_dir, device=args.device, mesh=eng.mesh,
    )


if __name__ == "__main__":
    main()
