"""BI-AWGN decode sweep CLI (syndrome decoding of BPSK over AWGN).

    python -m qamreconciliation_tpu_torch.sims.sim_decode EDGEFILE [--qc |
        --lift-qc] [--out out.csv] [--maxiter 30] [--minerr 20]
        [--simloops 30] [--snr 0 5] [--nsnr 11] [--alpha 1.0] [--hard]
        [--device cuda] [--devices D] ...

Output CSV: an unnamed index column then ``EbN0dB,ber,fer,iters``; soft
LLRs ``2*alpha/v*r``, or ``LLR0*sign(r)`` with ``--hard``.
"""

import argparse

import numpy as np

from ..models.matrix import Matrix
from .bitchannel import BitChannelEngine
from .common import (
    add_engine_args, add_qc_arg, bit_channel_kwargs, load_decoder, run_cli,
    sweep,
)

__all__ = ["build_parser", "run_sweep", "main"]


def build_parser():
    parser = argparse.ArgumentParser(
        prog="sim_decode",
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
    parser.add_argument("--snr", type=float, nargs=2, default=[0, 5])
    parser.add_argument("--nsnr", type=int, default=11)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--hard", action="store_true", default=False)
    add_qc_arg(parser)
    add_engine_args(parser)
    return parser


def run_sweep(args, snr_column: str):
    """The BI-AWGN sweep of parsed ``args``, the CSV's point column named
    ``snr_column``; returns the list of per-point :class:`PointResult`.
    This process is one rank of the sweep (``common.run_cli``)."""
    kw = bit_channel_kwargs(args)
    dec, vid, cid = load_decoder(args)
    eng = BitChannelEngine(dec, Matrix(vid, cid), **kw)
    return sweep(
        args.out, args.resume, snr_column,
        np.linspace(args.snr[0], args.snr[1], args.nsnr),
        lambda i, snr: eng.run_biawgn_point(
            snr, args.maxiter, args.simloops, args.minerr,
            alpha=args.alpha, hard=args.hard),
        profile_dir=args.profile_dir, device=args.device, mesh=eng.mesh,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    started = run_cli(main, argv, args)
    if started is not None:
        return started
    return run_sweep(args, "EbN0dB")


if __name__ == "__main__":
    main()
