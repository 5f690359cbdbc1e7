"""Entry points: one soft reverse-reconciliation round of the flagship
workload, and a dry run of every multi-device mode.

    python -m qamreconciliation_tpu_torch.entry [--device cuda]
    python -m qamreconciliation_tpu_torch.entry --multichip N [--device cuda]

``entry()`` returns ``(fn, (generator,))``: ``fn(generator)`` runs one full
softening round (shaped 4-PAM symbols and AWGN, Bob's hard decision and
softening metric, the word's syndrome, Alice's poly LLRs, the syndrome BP
decode, the counters) on a random (3,6)-regular code of length 1024 with the
generic decoder, 32 frames at 4.0 dB and at most 50 iterations, and returns
the four counters ``[bit errors, frame errors, iterations of successes,
successes]`` as one int64 tensor.  On the card the decode runs the generic
check-phase kernel at ``[6, 512, 32]``.

``dryrun_multichip(n)`` runs the seven multi-device modes of the JAX
package's ``__graft_entry__.dryrun_multichip`` at their tiny shapes on
``n`` ranks (``parallel/``), one line each: frame-shard data parallelism
(the softening round, the layered and resident QC decoders, the DVB-S2
construction at N = 64800), the check-sharded and z-sharded decoders in an
engine round, and the frame-sharded fused stream.  Without a process group
it starts its own ranks.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

__all__ = ["entry", "dryrun_multichip", "main"]


def entry(device="cuda"):
    """(fn, example_args): the round function and its generator."""
    from .models.alphabet import PAMAlphabet
    from .models.decoder import Decoder
    from .models.matrix import Matrix
    from .sims.engine import ReconciliationEngine, round_generator
    from .utils.edgefile import make_regular_ldpc

    vid, cid = make_regular_ldpc(1024, dv=3, dc=6, seed=0)
    eng = ReconciliationEngine(Decoder(vid, cid, device=device),
                               Matrix(vid, cid), PAMAlphabet(2, 2.0),
                               batch=32, llr_mode="poly")
    snr_dB = 4.0
    nm = eng.make_noisemapper(snr_dB)
    sigma = math.sqrt(eng.noise_var(snr_dB))

    def step(generator):
        return eng.softening_round(nm, sigma, 1.0, 50, generator=generator)

    return step, (round_generator(0, 0, device),)


def _regular_round(n_code, batch, snr_dB, seed, device, dec_fn,
                   mesh_axis=None):
    """(engine, round function of a generator) of a softening round on a
    random (3,6)-regular code, the decoder ``dec_fn(vid, cid)``."""
    from .models.alphabet import PAMAlphabet
    from .models.matrix import Matrix
    from .sims.engine import ReconciliationEngine
    from .utils.edgefile import make_regular_ldpc

    vid, cid = make_regular_ldpc(n_code, dv=3, dc=6, seed=seed)
    eng = ReconciliationEngine(dec_fn(vid, cid), Matrix(vid, cid),
                               PAMAlphabet(2, 2.0), batch=batch,
                               mesh_axis=mesh_axis)
    return eng, _softening(eng, snr_dB)


def _softening(eng, snr_dB, max_iterations=10):
    nm = eng.make_noisemapper(snr_dB)
    sigma = math.sqrt(eng.noise_var(snr_dB))
    return lambda gen: eng.softening_round(nm, sigma, 1.0, max_iterations,
                                           generator=gen)


def _dryrun_lines(n_devices: int, device) -> list:
    """The seven modes on this process's ranks; rank 0 prints a line a
    mode.  Returns the lines."""
    from .models.alphabet import PAMAlphabet
    from .models.decoder import Decoder
    from .models.dvbs2 import Z as DVB_Z, make_table, to_qc_base
    from .models.matrix import Matrix
    from .models.qc_decoder import QCDecoder, make_qc_ldpc
    from .parallel import (
        ShardedDecoder, ShardedQCDecoder, make_mesh, shard_round,
    )
    from .sims.engine import ReconciliationEngine, round_generator
    from .sims.streaming import StreamReconciler

    mesh = make_mesh(n_devices, "dp", device=device)
    dev = mesh.device
    lines = []

    def show(text, counters, frames):
        errs, ferrs, iters, succ = (int(c) for c in counters)
        assert 0 <= ferrs <= frames and 0 <= succ <= frames, \
            (text, ferrs, succ, frames)
        lines.append(f"dryrun_multichip({n_devices}) {text}: {frames} "
                     f"frames, bit_errs={errs} frame_errs={ferrs} "
                     f"iters={iters} success={succ}")
        if mesh.rank == 0:
            print(lines[-1], flush=True)

    def frame_shard(text, eng, round_fn, seed):
        show(text, shard_round(round_fn, mesh)(seed, 0),
             eng.batch * mesh.world)

    # 1. frame-shard softening round: each rank a batch on its generator,
    # the counters summed over the ranks
    eng, fn = _regular_round(96, 4, 3.0, 0, dev,
                             lambda v, c: Decoder(v, c, device=dev))
    frame_shard("frame-shard softening round", eng, fn, 0)

    # 2. graph sharding: checks split over the ranks, through an engine
    # round (every rank draws the same frames)
    gs = make_mesh(n_devices, "gs", device=device)
    eng, fn = _regular_round(96, 4, 3.0, 1, dev,
                             lambda v, c: ShardedDecoder(v, c, gs))
    show("graph-shard sweep round", fn(round_generator(1, 0, dev)),
         eng.batch)

    # 3. and 4. the layered min-sum and the resident QC decoders under
    # frame sharding (resident_rowgroup is accepted and without effect)
    qc_base, qc_vid, qc_cid = make_qc_ldpc(nb_v=12, z=8, dv=3, dc=6, seed=2)
    pa = PAMAlphabet(2, 2.0)
    qdec = QCDecoder(qc_base, 8, device=dev, schedule="layered",
                     check_rule="minsum")
    for text, dec in (
            ("layered-QC frame-shard round", qdec),
            ("resident QC frame-shard round", QCDecoder(
                qc_base, 8, device=dev, check_rule="minsum", resident=True,
                resident_chunk=4, resident_rowgroup=2))):
        eng = ReconciliationEngine(dec, Matrix(qc_vid, qc_cid), pa, batch=4,
                                   mesh_axis=(mesh, "dp"))
        frame_shard(text, eng, _softening(eng, 3.0), 2)

    # 5. QC graph sharding: the circulant lane axis split over the ranks
    zq_base, zq_vid, zq_cid = make_qc_ldpc(nb_v=12, z=2 * n_devices, dv=3,
                                           dc=6, seed=3)
    gz = make_mesh(n_devices, "gz", device=device)
    zdec = ShardedQCDecoder(zq_base, 2 * n_devices, gz, check_phi="tanhfb")
    eng = ReconciliationEngine(zdec, Matrix(zq_vid, zq_cid), pa, batch=4)
    show("z-sharded QC graph round",
         _softening(eng, 3.0)(round_generator(3, 0, dev)), eng.batch)

    # 6. the frame-sharded fused stream: each rank decodes its share of
    # every batch, the outputs all-gathered in frame order
    s_mesh = make_mesh(n_devices, "sdp", device=device)
    q_eng = ReconciliationEngine(qdec, Matrix(qc_vid, qc_cid), pa, batch=4)
    sr = StreamReconciler(qdec, Matrix(qc_vid, qc_cid), pa,
                          q_eng.make_noisemapper(3.0), batch=n_devices,
                          mesh_axis=(s_mesh, "sdp"))
    rng = np.random.default_rng(5)
    frames = n_devices + 2
    sx = rng.integers(0, pa.order, frames * sr.N_symb)
    sy = pa.constellation[sx] + math.sqrt(q_eng.noise_var(3.0)) \
        * rng.standard_normal(sx.size)
    res = sr.stream_fused(sy, sx, max_iterations=10)
    assert res.frames == frames, res.frames
    lines.append(f"dryrun_multichip({n_devices}) frame-sharded fused "
                 f"stream: {res.frames} frames, success={sum(res.success)} "
                 f"bit_errs={res.bit_errors}")
    if mesh.rank == 0:
        print(lines[-1], flush=True)

    # 7. the DVB-S2 standard construction (full-wrap z = 360 QC base, 630
    # circulants at N = 64800) under frame sharding, 2 iterations
    ddec = QCDecoder(to_qc_base(make_table("1/2", seed=0), wrap="full"),
                     DVB_Z, device=dev, check_rule="minsum")
    eng = ReconciliationEngine(ddec, Matrix(ddec.vid, ddec.cid), pa,
                               batch=2, mesh_axis=(mesh, "dp"))
    show_text = ("DVB-S2-construction frame-shard round (N=64800, "
                 f"{len(ddec.base_edges)} circulants)")
    frame_shard(show_text, eng, _softening(eng, 3.5, 2), 4)
    return lines


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the seven multi-device modes on ``n_devices`` ranks and return
    the printed lines.  Inside a process group of ``n_devices`` ranks each
    rank runs them; without one, the ranks are started here
    (``parallel.mesh.run_ranks``) and rank 0's lines are returned."""
    import torch.distributed as dist

    if dist.is_initialized() or n_devices == 1:
        return _dryrun_lines(n_devices, device)
    from .parallel.mesh import run_ranks

    return run_ranks(_dryrun_lines, n_devices, (n_devices, device),
                     device=device)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run one softening round and print its counters, or "
        "with --multichip N the dry run of the multi-device modes")
    parser.add_argument("--device", default="cuda",
                        help="Torch device (default cuda)")
    parser.add_argument("--multichip", type=int, default=None, metavar="N",
                        help="Run dryrun_multichip(N) instead: the seven "
                        "multi-device modes on N ranks")
    args = parser.parse_args(argv)
    if args.multichip is not None:
        return dryrun_multichip(args.multichip, args.device)
    fn, example = entry(args.device)
    counters = fn(*example).tolist()
    print(dict(zip(("bit_errors", "frame_errors", "iter_sum",
                    "success_sum"), counters)))
    return counters


if __name__ == "__main__":
    main()
