"""Sum-product against normalized min-sum: the BER/FER waterfall figure.

The port's counterpart of the JAX package's
``scripts/plot_checkrule_waterfall.py``, from two ``sim_reconciliation``
CSVs (``,EsN0dB,ber,fer,iters``) on the same code and seeds:

    python -m qamreconciliation_tpu_torch.scripts.plot_checkrule_waterfall \\
        SP.csv MS.csv OUT.png [--records CAMPAIGN.jsonl]
"""

from ._plot import card, draw, parser

__all__ = ["main"]


def main(argv=None):
    args = parser("plot_checkrule_waterfall", "sp_csv",
                  "ms_csv").parse_args(argv)
    draw([(args.sp_csv, "o-", "exact sum-product (reference math)"),
          (args.ms_csv, "s--", "normalized min-sum (alpha=13/16)")],
         args.out_png,
         "Softening reverse reconciliation, QC(3,6) N=64800 rate-1/2, "
         "maxiter=50" + card(args.records))


if __name__ == "__main__":
    main()
