"""BI-AWGN direct sweep CLI.

The same sweep as sim_decode (BPSK over AWGN, soft ``2*alpha/v*r`` or hard
``LLR0*sign(r)``), but the output CSV's point column is named ``EsN0dB``,
the reference's quirk, kept for its display scripts.
"""

from .common import run_cli
from .sim_decode import build_parser, run_sweep

__all__ = ["main"]


def main(argv=None):
    args = build_parser().parse_args(argv)
    started = run_cli(main, argv, args)
    if started is not None:
        return started
    return run_sweep(args, "EsN0dB")


if __name__ == "__main__":
    main()
