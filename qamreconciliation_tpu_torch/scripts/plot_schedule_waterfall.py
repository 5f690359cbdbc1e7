"""Flooding against layered: the BER / FER / mean-iterations figure.

The port's counterpart of the JAX package's
``scripts/plot_schedule_waterfall.py``, from three ``sim_reconciliation``
CSVs on the same code, seeds and maxiter (sum-product flooding, min-sum
flooding, min-sum layered):

    python -m qamreconciliation_tpu_torch.scripts.plot_schedule_waterfall \\
        SP.csv MS.csv LAY.csv OUT.png [--records CAMPAIGN.jsonl]
"""

from ._plot import card, draw, parser

__all__ = ["main"]


def main(argv=None):
    args = parser("plot_schedule_waterfall", "sp_csv", "ms_csv",
                  "lay_csv").parse_args(argv)
    draw([(args.sp_csv, "o-", "sum-product, flooding (reference math)"),
          (args.ms_csv, "s--", "min-sum, flooding"),
          (args.lay_csv, "d-.", "min-sum, layered (serial-C)")],
         args.out_png,
         "Softening reverse reconciliation, QC(3,6) N=64800 rate-1/2, "
         "maxiter=50, 1024 frames/point" + card(args.records),
         iterations=True)


if __name__ == "__main__":
    main()
