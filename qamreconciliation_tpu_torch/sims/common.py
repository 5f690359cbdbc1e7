"""Shared CLI plumbing for the sweep CLIs.

``--devices D`` runs a sweep on D ranks (``parallel.mesh``): under a
launcher such as ``torchrun --nproc-per-node D`` each CLI process is a rank
of the launcher's process group, and from a plain command the CLI starts
the D ranks itself (:func:`ranks_to_start`).  Only rank 0 prints the
per-point lines and writes the CSV and the resume journal.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import sys
import warnings

import torch

from ..config import as_dtype
from ..utils.checkpoint import SweepState
from .engine import PointResult

__all__ = ["add_engine_args", "add_qc_arg", "init_runtime",
           "ranks_to_start", "run_cli", "engine_kwargs",
           "bit_channel_kwargs", "load_decoder", "write_table", "write_csv",
           "pyplot", "sweep", "profiled"]


def add_engine_args(parser: argparse.ArgumentParser):
    """Engine flags shared by the sweep CLIs."""
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device of the decode state and every round (default "
        "cuda; 'cpu' runs the kernels' plain versions)",
    )
    parser.add_argument(
        "--batch", type=int, default=128,
        help="Frames per round",
    )
    parser.add_argument(
        "--dtype", choices=["float32", "float64", "bfloat16"], default="float32",
        help="LLR/message dtype (float64 runs on the CPU only)",
    )
    parser.add_argument(
        "--devices", type=int, default=1,
        help="Shard each round over this many ranks, one a device, their "
        "counters summed (under a launcher such as torchrun: its "
        "WORLD_SIZE; else the CLI starts the ranks itself)",
    )
    parser.add_argument(
        "--llr-exact", action="store_true",
        help="Softening LLRs with the exact Newton g^-1 (the reference's "
        "g_inv_search contract; --llr-mode search)",
    )
    parser.add_argument(
        "--llr-mode", choices=["poly", "table", "interp", "search"],
        default=None,
        help="Softening LLR path: 'poly' (piecewise-Chebyshev fit of the "
        "LLR curves, default), 'table' (precomputed (n,j)->LLR map), "
        "'interp' (per-sample LLRs on the interpolated g^-1) or 'search' "
        "(per-sample LLRs on the Newton g^-1; float32/float64).  Overrides "
        "--llr-exact.",
    )
    parser.add_argument(
        "--fy-mode", choices=["erf", "erf_flat", "poly"], default="erf",
        help="Marginal-CDF implementation for the softening metric: 'erf' "
        "(exact mixture over a component axis, default), 'erf_flat' (the "
        "same M erfs unrolled, in the sample dtype) or 'poly' (probit-"
        "warped Chebyshev fit: one erf and one Clenshaw chain a sample; CDF "
        "fit error <~1e-4 at operating SNRs)",
    )
    parser.add_argument(
        "--rounds-per-dispatch", type=int, default=1,
        help="Rounds of --batch frames summed on the device per host read "
        "of the counters; early exit coarsens to batch * R frames, and the "
        "frames drawn do not depend on R",
    )
    parser.add_argument(
        "--check-rule", choices=["sumproduct", "minsum"],
        default="sumproduct",
        help="Check-node update rule: 'sumproduct' or 'minsum' (normalized "
        "min-sum, alpha=13/16)",
    )
    parser.add_argument(
        "--minsum-alpha", type=float, default=None,
        help="Min-sum normalization scale (default 13/16); "
        "mag = max(alpha*min - beta, 0)",
    )
    parser.add_argument(
        "--minsum-beta", type=float, default=0.0,
        help="Min-sum offset correction (default 0)",
    )
    parser.add_argument(
        "--check-phi", choices=["phi", "tanhfb"], default="phi",
        help="Sum-product magnitude form: 'phi' (default) or 'tanhfb' "
        "(tanh forward/backward products; saturates near 16.6)",
    )
    parser.add_argument("--seed", type=int, default=0, help="Sweep PRNG seed")
    parser.add_argument(
        "--resume", action="store_true",
        help="Resume a partially completed sweep from the .partial.jsonl journal",
    )
    parser.add_argument(
        "--profile-dir", default=None,
        help="Write a torch.profiler trace (CPU and CUDA activities, Chrome "
        "format) of the first SNR point into this directory",
    )


def init_runtime(device="cuda") -> bool:
    """Per-CLI runtime init: join a launcher's process group
    (``parallel.mesh.maybe_distributed_init``).  Every sweep ``main()``
    calls this before touching devices.  True iff a process group is up."""
    from ..parallel import mesh

    return bool(mesh.maybe_distributed_init(device=device))


def ranks_to_start(args) -> int:
    """How many ranks a CLI run of ``args`` must start itself: 0 when this
    process runs the sweep (one device, a launcher's rank or a rank this
    CLI started), else ``args.devices``.  Under a process group
    ``--devices`` must equal its world size; a launcher whose group failed
    to start (:func:`init_runtime` warned) cannot run ``--devices > 1``."""
    import torch.distributed as dist

    from ..parallel.mesh import LAUNCHER_VARS

    if init_runtime(args.device):
        world = dist.get_world_size()
        if args.devices != world:
            raise SystemExit(f"--devices {args.devices} must equal the "
                             f"process group's world size {world}")
        return 0
    if args.devices <= 1:
        return 0
    if any(v in os.environ for v in LAUNCHER_VARS):
        raise SystemExit(f"--devices {args.devices}: a launcher set "
                         f"{'/'.join(LAUNCHER_VARS)} but its process group "
                         "did not start (see the warning above)")
    return args.devices


def run_cli(main, argv, args):
    """Start ``args.devices`` ranks, each running ``main(argv)``, and return
    rank 0's result; None when this process runs the sweep itself
    (:func:`ranks_to_start`)."""
    n = ranks_to_start(args)
    if not n:
        return None
    from ..parallel.mesh import run_ranks

    argv = list(sys.argv[1:] if argv is None else argv)
    return run_ranks(main, n, (argv,), device=args.device)[0]


def engine_kwargs(args):
    """The engine's keywords of ``args``; with ``--devices > 1``, the
    frame-shard mesh ``mesh_axis=(mesh, "dp")`` over the running ranks, and
    ``args.device`` becomes this rank's device."""
    llr_mode = args.llr_mode or ("search" if args.llr_exact else "poly")
    kw = dict(
        batch=args.batch,
        dtype=as_dtype(args.dtype),
        llr_mode=llr_mode,
        fy_mode=args.fy_mode,
        rounds_per_dispatch=args.rounds_per_dispatch,
    )
    if args.devices > 1:
        from ..parallel import make_mesh

        mesh = make_mesh(args.devices, "dp", device=args.device)
        args.device = str(mesh.device)
        kw["mesh_axis"] = (mesh, "dp")
    return kw


def bit_channel_kwargs(args):
    """:func:`engine_kwargs` for the ``BitChannelEngine`` (no LLR or
    marginal-CDF mode)."""
    kw = engine_kwargs(args)
    del kw["llr_mode"], kw["fy_mode"]
    return kw


def add_qc_arg(parser: argparse.ArgumentParser):
    """Decoder-selection flags."""
    parser.add_argument(
        "--qc", action="store_true",
        help="Treat EDGEFILE as a quasi-cyclic base-edge CSV "
        "(eid,cb,vb,shift with a (n_edges,z,nb_c) totals row) and decode "
        "with the QCDecoder",
    )
    parser.add_argument(
        "--schedule", choices=["flooding", "layered"], default="flooding",
        help="BP update schedule: 'flooding' (the reference's schedule) or "
        "'layered' (row-layered serial-C over check blocks; converges in "
        "roughly half the sweeps for the same quality)",
    )
    parser.add_argument(
        "--layered-chunk", type=int, default=4,
        help="Layered schedule only: sweeps per host check of 'all done?' "
        "(and per kernel call with --resident); early exit coarsens to this "
        "granularity, iters/success stay sweep-exact",
    )
    parser.add_argument(
        "--layered-groups", type=int, default=-1,
        help="Layered schedule without --resident: process variable-disjoint "
        "check rows as one batched layer (bit-equivalent to a reordered "
        "serial sweep).  -1 auto (on for codes with >= 32 check "
        "block-rows), 0 serial, 1 force grouped",
    )
    parser.add_argument(
        "--resident", action="store_true",
        help="Multi-iteration decode kernel: --resident-chunk flooding "
        "iterations (or --layered-chunk layered sweeps) per kernel call, "
        "with the convergence test, iters and the freeze of converged frames "
        "inside the kernel and one host read per call",
    )
    parser.add_argument(
        "--resident-chunk", type=int, default=50,
        help="Resident flooding kernel only: max BP iterations per kernel "
        "call (convergence stays iteration-exact inside the kernel; one "
        "call per decode when it covers --maxiter)",
    )
    parser.add_argument(
        "--resident-rowgroup", type=int, default=None,
        help="Accepted for the JAX CLI's flag set and without effect: the "
        "row split is a TPU register-pressure device the GPU kernels do "
        "not need (1 is refused as in the JAX decoder)",
    )
    parser.add_argument(
        "--totals-dtype", choices=["storage", "float32"], default="storage",
        help="Dtype of the running LLR totals: 'storage' keeps them in "
        "--dtype; 'float32' keeps f32 totals over narrower messages",
    )
    parser.add_argument(
        "--sr-messages", action="store_true",
        help="QC dense flooding + bfloat16 only: stochastically round the "
        "bf16 check->variable message stores (ops/boxplus."
        "stochastic_round_bf16) instead of round-to-nearest; runs the "
        "plain check update, as the JAX package runs its XLA one",
    )
    parser.add_argument(
        "--lift-qc", action="store_true",
        help="Detect circulant structure in an expanded edge list and decode "
        "with the QCDecoder (falls back to the generic decoder with a "
        "warning when there is none)",
    )


def load_decoder(args):
    """Build the decoder named by ``args.edgefile``: the QCDecoder for a
    base-edge CSV (``--qc``) or a lifted expanded list (``--lift-qc``),
    else the generic :class:`~qamreconciliation_tpu_torch.models.decoder.
    Decoder` on the expanded ``eid,cid,vid`` list.

    Returns ``(dec, vid, cid)`` with the expanded edge list.
    """
    lg = getattr(args, "layered_groups", -1)
    dec_kw = dict(dtype=as_dtype(args.dtype), device=args.device,
                  check_rule=args.check_rule, check_phi=args.check_phi,
                  minsum_alpha=args.minsum_alpha,
                  minsum_beta=args.minsum_beta)
    qc_kw = dict(
        totals_dtype=args.totals_dtype, schedule=args.schedule,
        layered_chunk=getattr(args, "layered_chunk", 4),
        layered_groups=None if lg < 0 else bool(lg),
        resident=args.resident,
        resident_chunk=getattr(args, "resident_chunk", 16),
        resident_rowgroup=getattr(args, "resident_rowgroup", None),
        sr_messages=args.sr_messages,
    )
    from ..models.qc_decoder import QCDecoder

    if args.qc:
        from ..models.qc_decoder import load_qc_csv

        base_edges, z = load_qc_csv(args.edgefile)
        dec = QCDecoder(base_edges, z, **dec_kw, **qc_kw)
        return dec, dec.vid, dec.cid
    from ..models.decoder import Decoder
    from ..utils.edgefile import load_edge_csv

    vid, cid = load_edge_csv(
        args.edgefile, num_data_first_row=getattr(args, "first_row", True))
    if args.lift_qc:
        from ..models.qc_decoder import detect_qc

        lifted = detect_qc(vid, cid)
        if lifted is not None:
            base_edges, z = lifted
            try:
                dec = QCDecoder(base_edges, z, **dec_kw, **qc_kw)
                print(f"[lift-qc] detected z={z} circulant lifting "
                      f"({len(base_edges)} base edges)")
                return dec, vid, cid
            except ValueError as e:   # e.g. degree-1 check blocks (min-sum)
                warnings.warn(f"--lift-qc: lifting found but unusable "
                              f"({e}); using the generic decoder")
        else:
            warnings.warn("--lift-qc: no circulant structure detected; "
                          "using the generic decoder")
    if args.resident:
        raise SystemExit(
            "--resident requires a quasi-cyclic decoder (--qc or a "
            "successful --lift-qc); the generic gather decoder has no "
            "multi-iteration kernel"
        )
    if args.schedule != "flooding":
        raise SystemExit(
            "--schedule layered requires a quasi-cyclic decoder "
            "(--qc or a successful --lift-qc); the generic gather decoder "
            "is flooding-only"
        )
    if args.sr_messages:
        raise SystemExit(
            "--sr-messages requires a quasi-cyclic decoder (--qc or a "
            "successful --lift-qc): the stochastic message rounding "
            "lives in the QC dense check update"
        )
    return Decoder(vid, cid, **dec_kw), vid, cid


def write_table(path: str, columns, rows):
    """Write ``rows`` under the header ``, *columns``, each row led by its
    index (the layout of a pandas ``DataFrame.to_csv``)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", *columns])
        for i, row in enumerate(rows):
            w.writerow([i, *(float(v) for v in row)])


def write_csv(path: str, column: str, rows):
    """Write ``rows`` of (point, ber, fer, iters) under the header ``,
    column, ber, fer, iters``, each row led by its index."""
    write_table(path, [column, "ber", "fer", "iters"], rows)


def pyplot():
    """``matplotlib.pyplot``, imported on first use, or None (with a
    message on stderr) where matplotlib is not installed."""
    try:
        from matplotlib import pyplot as plt
    except ImportError:
        print("--display needs matplotlib, which is not installed; the CSV "
              "was written, nothing is shown", file=sys.stderr)
        return None
    return plt


def _report(column, point, r):
    print(
        f"[{column}={point:.4g}] frames={r.frames} ber={r.ber:.3e} "
        f"fer={r.fer:.3e} iters={r.iters:.2f} "
        f"({r.frames_per_s:.1f} frames/s)"
    )


def sweep(out: str, resume: bool, column: str, points, run_point, *,
          device, batched: bool = False, profile_dir=None, mesh=None):
    """Run the points of the grid that the resume journal of ``out`` does
    not hold, journal each one, write the CSV with ``column`` as the
    point's name, and return the list of :class:`PointResult` in grid
    order.

    ``run_point(i, point) -> PointResult`` runs point ``i``; with
    ``batched``, ``run_point(indices, points) -> [PointResult]`` runs all
    the pending points at once (their grid indices and values).  With
    ``profile_dir``, the first call of ``run_point`` is profiled
    (:func:`profiled` on ``device``, the device every caller names).

    With a ``mesh`` of several ranks every rank runs the same points:
    rank 0 alone prints the per-point lines, profiles, and writes the
    journal and the CSV; the other ranks read the journal and check, by a
    sum over the ranks, that they skip the points rank 0 skips."""
    writer = mesh is None or mesh.rank == 0
    state = SweepState(out, resume=resume, writer=writer)
    if mesh is not None and mesh.world > 1:
        done = torch.tensor([state.done(p) is not None for p in points],
                            dtype=torch.int64, device=mesh.device)
        if not torch.equal(mesh.all_reduce_sum(done.clone()),
                           done * mesh.world):
            raise RuntimeError("the ranks read different resume journals")
    fresh = {}
    first = [profile_dir if writer else None]

    def run(*a):
        with profiled(first.pop() if first else None, device):
            return run_point(*a)

    def report(point, r):
        if writer:
            _report(column, point, r)

    if batched:
        pending = [i for i, point in enumerate(points)
                   if state.done(point) is None]
        if pending:
            batch = run(pending, [float(points[i]) for i in pending])
            for i, r in zip(pending, batch):
                fresh[i] = r
                report(points[i], r)
                state.record(points[i], dict(
                    ber=r.ber, fer=r.fer, iters=r.iters, frames=r.frames,
                    frames_per_s=r.frames_per_s))
    results = []
    for i, point in enumerate(points):
        if i in fresh:
            results.append(fresh[i])
            continue
        prev = state.done(point)
        if prev is not None:
            results.append(PointResult(
                prev["point"], prev["ber"], prev["fer"], prev["iters"],
                frames=prev.get("frames", 0),
                frames_per_s=prev.get("frames_per_s", 0.0),
            ))
            continue
        r = run(i, float(point))
        report(point, r)
        state.record(point, dict(ber=r.ber, fer=r.fer, iters=r.iters,
                                 frames=r.frames,
                                 frames_per_s=r.frames_per_s))
        results.append(r)
    if writer:
        write_csv(out, column, [r.as_tuple() for r in results])
    state.cleanup()
    return results


@contextlib.contextmanager
def profiled(profile_dir, device):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA on
    a CUDA ``device``) and write its Chrome trace to
    ``profile_dir/trace.json``; a no-op when ``profile_dir`` is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
