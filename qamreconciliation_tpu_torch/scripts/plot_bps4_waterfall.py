"""The 16-PAM (bps 4) mode and sign-configuration waterfall figure.

The port's counterpart of the JAX package's
``scripts/plot_bps4_waterfall.py``, from four ``sim_reconciliation`` CSVs
on the same code, seeds and maxiter: softening with the Alternating sign
configuration (the CLI default) and with the Base one
(``--configuration-base``), hard reverse (``--hard``) and soft direct
(``--direct``):

    python -m qamreconciliation_tpu_torch.scripts.plot_bps4_waterfall \\
        ALT.csv BASE.csv HARD.csv DIRECT.csv OUT.png [--records CAMPAIGN.jsonl]
"""

from ._plot import card, draw, parser

__all__ = ["main"]


def main(argv=None):
    args = parser("plot_bps4_waterfall", "alt_csv", "base_csv", "hard_csv",
                  "direct_csv").parse_args(argv)
    draw([(args.alt_csv, "o-", "softening, Alternating config"),
          (args.base_csv, "v-", "softening, Base config"),
          (args.hard_csv, "s--", "hard reverse"),
          (args.direct_csv, "d-.", "soft direct")],
         args.out_png,
         "16-PAM (bps=4) reconciliation modes, QC(3,6) N=64800 rate-1/2, "
         "maxiter=50, 1024 frames/point" + card(args.records))


if __name__ == "__main__":
    main()
