"""The sum-product decode engines: the BER/FER waterfall figure.

The port's counterpart of the JAX package's
``scripts/plot_sumproduct_engines_waterfall.py``, from
``sim_reconciliation`` CSVs on the same code and seeds: the dense phi form
in bf16, the resident tanh-F/B kernel in bf16, the dense phi form in
float32 and, optionally, the resident f32-totals hybrid
(``--totals-dtype float32``):

    python -m qamreconciliation_tpu_torch.scripts.plot_sumproduct_engines_waterfall \\
        SP_BF16.csv FB_RES.csv SP_F32.csv OUT.png [HYBRID.csv] \\
        [--records CAMPAIGN.jsonl]
"""

from ._plot import card, draw, parser

__all__ = ["main"]


def main(argv=None):
    args = parser("plot_sumproduct_engines_waterfall", "sp_csv", "fb_csv",
                  "f32_csv", optional=("hybrid_csv",)).parse_args(argv)
    curves = [(args.sp_csv, "o-", "dense, phi form, bf16"),
              (args.fb_csv, "^-.", "resident, tanh-F/B, bf16"),
              (args.f32_csv, "s--", "dense, phi form, float32")]
    if args.hybrid_csv:
        curves.append((args.hybrid_csv, "x:",
                       "resident, f32-totals hybrid"))
    draw(curves, args.out_png,
         "Sum-product decode engines: softening reverse reconciliation, "
         "QC(3,6) N=64800 rate-1/2, maxiter=50" + card(args.records))


if __name__ == "__main__":
    main()
