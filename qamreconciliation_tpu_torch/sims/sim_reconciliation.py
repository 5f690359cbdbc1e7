"""Reconciliation BER/FER sweep CLI: soft reverse (default), hard reverse
(``--hard``) or soft direct (``--direct``, which overrides ``--hard``).

    python -m qamreconciliation_tpu_torch.sims.sim_reconciliation EDGEFILE \
        [--qc | --lift-qc] [--out out.csv] [--maxiter 50] [--ferr-count-min 100]
        [--alpha 1.0] [--simloops 5000] [--snr 0 5] [--nsnr 11] [--bps 2]
        [--configuration-base] [--hard | --direct] [--device cuda]
        [--resident [--resident-chunk 50]]
        [--schedule layered [--layered-chunk 4] [--layered-groups -1]]
        [--llr-exact | --llr-mode poly|table|interp|search]
        [--fy-mode erf|erf_flat|poly] [--rounds-per-dispatch 1]
        [--point-batch] [--profile-dir DIR] [--devices D [--graph-shard]] ...

EDGEFILE is an expanded ``eid,cid,vid`` edge list (the generic decoder,
or the QC decoder with a successful ``--lift-qc``) or, with ``--qc``, a
quasi-cyclic base-edge CSV.  Output CSV: an unnamed index column then
``EsN0dB,ber,fer,iters``.  SNR points run sequentially, each a frame batch
per round, or with ``--point-batch`` all pending points together, one
decode over all their frames per round (the same frames and counters per
point; ``frames_per_s`` is then the grid's on every row).

``--devices D`` runs D ranks (``torchrun --nproc-per-node D``, or started
by the CLI itself from a plain command): each runs a full batch a round and
the counters are summed over the ranks.  With ``--graph-shard`` the ranks
split the code's Tanner graph instead (``parallel/graph_shard.py``: the
circulant lanes of a QC code, the checks of any other), frames whole.
Rank 0 writes the CSV and the journal.
"""

import argparse

import numpy as np

from ..config import as_dtype
from ..models.alphabet import PAMAlphabet
from ..models.matrix import Matrix
from .common import (
    add_engine_args, add_qc_arg, engine_kwargs, load_decoder, run_cli, sweep,
)
from .engine import ReconciliationEngine, point_seed

__all__ = ["build_parser", "main"]


def build_parser():
    parser = argparse.ArgumentParser(
        prog="decode",
        description="Evaluate BER for LDPC codes vs Raw BER",
    )
    parser.add_argument(
        "edgefile",
        help="Expanded edge-list CSV (eid,cid,vid with a totals first "
        "row), or a quasi-cyclic base-edge CSV with --qc",
    )
    add_qc_arg(parser)
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--maxiter", default=50, type=int,
                        help="Maximum number of iterations for the decoder")
    parser.add_argument("--ferr-count-min", default=100, type=int,
                        help="Minimum number of frame errors for early exit")
    parser.add_argument("--alpha", type=float, default=1.0,
                        help="Extra multiplicative coefficient for the LLR")
    parser.add_argument("--simloops", default=5000, type=int,
                        help="Number of frames per SNR point")
    parser.add_argument("--snr", type=float, nargs=2, default=[0, 5],
                        help="Initial and final SNR [dB] values of the range "
                        "to evaluate the BER at")
    parser.add_argument("--nsnr", type=int, default=11,
                        help="Number of equally spaced SNR [dB] points to "
                        "evaluate the BER at")
    parser.add_argument("--bps", type=int, default=2,
                        help="Bit Per Symbol (=log_2(PAM Order))")
    parser.add_argument("--hard", action="store_true",
                        help="Simulate hard reverse reconciliation")
    parser.add_argument("--direct", action="store_true",
                        help="Simulate the soft direct reconciliation "
                        "(overrides --hard)")
    parser.add_argument("--configuration-base", action="store_true",
                        help="Instead of the Alternating configuration, use "
                        "the Base configuration")
    parser.add_argument("--graph-shard", action="store_true",
                        help="Partition the Tanner graph over the --devices "
                        "ranks (for codes too large for one device); frames "
                        "stay whole.  Generic codes shard check nodes (the "
                        "variable partial sums all-reduced an iteration); "
                        "--qc/--lift-qc codes shard the circulant lane axis "
                        "(the messages all-gathered an iteration, bit-equal "
                        "to one device).  Composes with --check-rule/"
                        "--check-phi/--minsum-alpha/--minsum-beta; mutually "
                        "exclusive with frame sharding and --point-batch")
    parser.add_argument("--point-batch", action="store_true",
                        help="Advance all pending SNR points per dispatch, "
                        "one decode over all their frames (each point "
                        "keeps its own seed and early exit).  The "
                        "journal's frames_per_s then reports the grid's "
                        "throughput on every row")
    add_engine_args(parser)
    return parser


def main(argv=None):
    """Run the sweep; returns the list of per-point :class:`PointResult`."""
    args = build_parser().parse_args(argv)
    if args.graph_shard and args.point_batch:
        raise SystemExit(
            "--graph-shard is mutually exclusive with --point-batch"
        )
    if args.graph_shard and args.schedule != "flooding":
        raise SystemExit("--graph-shard supports only --schedule flooding")
    if args.graph_shard and args.resident:
        raise SystemExit("--graph-shard is incompatible with --resident "
                         "(the resident decode runs on one device)")
    if args.resident and args.point_batch:
        raise SystemExit(
            "--resident is incompatible with --point-batch (the SNR-point "
            "batch cannot wrap the resident decode kernel)"
        )
    started = run_cli(main, argv, args)
    if started is not None:
        return started
    eng_kw = engine_kwargs(args)
    mesh = eng_kw["mesh_axis"][0] if "mesh_axis" in eng_kw else None
    if args.graph_shard:
        from ..parallel import make_mesh

        # --devices carries the graph shards here, not frame sharding
        eng_kw.pop("mesh_axis", None)
        mesh = make_mesh(args.devices, axis_name="gs", device=args.device)
        args.device = str(mesh.device)
    dec, vid, cid = load_decoder(args)
    if args.graph_shard:
        from ..models.qc_decoder import QCDecoder
        from ..parallel.graph_shard import ShardedDecoder, ShardedQCDecoder

        gs_kw = dict(dtype=as_dtype(args.dtype), check_rule=args.check_rule,
                     check_phi=args.check_phi,
                     minsum_alpha=args.minsum_alpha,
                     minsum_beta=args.minsum_beta)
        if isinstance(dec, QCDecoder):
            dec = ShardedQCDecoder(dec.base_edges, dec.z, mesh, **gs_kw)
        else:
            dec = ShardedDecoder(vid, cid, mesh, **gs_kw)
    mat = Matrix(vid, cid)
    pa = PAMAlphabet(args.bps, 2)

    mode = "direct" if args.direct else ("hard" if args.hard else "softening")
    nmconfig = None
    if mode == "softening":
        nmconfig = np.zeros(pa.order, dtype=np.uint8)
        if not args.configuration_base:
            nmconfig[1::2] = 1  # Alternating configuration

    eng = ReconciliationEngine(dec, mat, pa, **eng_kw)
    kw = dict(alpha=args.alpha, nmconfig=nmconfig)
    if args.point_batch:
        def run(indices, snrs):
            return eng.run_sweep_batched(
                mode, snrs, args.maxiter, args.simloops, args.ferr_count_min,
                seeds=[point_seed(args.seed, i) for i in indices], **kw)
    else:
        def run(i, snr):
            return eng.run_point(
                mode, snr, args.maxiter, args.simloops, args.ferr_count_min,
                seed=point_seed(args.seed, i), **kw)
    return sweep(
        args.out, args.resume, "EsN0dB",
        np.linspace(args.snr[0], args.snr[1], args.nsnr), run,
        batched=args.point_batch, profile_dir=args.profile_dir,
        device=args.device, mesh=mesh,
    )


if __name__ == "__main__":
    main()
