"""The irregular-code engine figure: the resident kernel against the dense
path on a QC-IRA code.

The port's counterpart of the JAX package's
``scripts/plot_irregular_waterfall.py``, from two ``sim_reconciliation``
CSVs of ``run_waterfall --irregular`` (with and without ``--resident``) on
the same seeds:

    python -m qamreconciliation_tpu_torch.scripts.plot_irregular_waterfall \\
        RESIDENT.csv DENSE.csv OUT.png [--records CAMPAIGN.jsonl]
"""

from ._plot import card, draw, parser

__all__ = ["main"]


def main(argv=None):
    args = parser("plot_irregular_waterfall", "res_csv",
                  "dense_csv").parse_args(argv)
    draw([(args.dense_csv, "o-", "dense path"),
          (args.res_csv, "^--", "resident kernel")],
         args.out_png,
         "Irregular QC-IRA rate-1/2 N=64800 (mixed check degrees 4..10), "
         "bf16 tanh-F/B, maxiter=50" + card(args.records),
         dpi=130, fontsize=None)


if __name__ == "__main__":
    main()
