"""Entry point: one soft reverse-reconciliation round of the flagship workload.

    python -m qamreconciliation_tpu_torch.entry [--device cuda]

``entry()`` returns ``(fn, (generator,))``: ``fn(generator)`` runs one full
softening round (shaped 4-PAM symbols and AWGN, Bob's hard decision and
softening metric, the word's syndrome, Alice's poly LLRs, the syndrome BP
decode, the counters) on a random (3,6)-regular code of length 1024 with the
generic decoder, 32 frames at 4.0 dB and at most 50 iterations, and returns
the four counters ``[bit errors, frame errors, iterations of successes,
successes]`` as one int64 tensor.  On the card the decode runs the generic
check-phase kernel at ``[6, 512, 32]``.
"""

from __future__ import annotations

import argparse
import math

__all__ = ["entry", "main"]


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


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run one softening round and print its counters")
    parser.add_argument("--device", default="cuda",
                        help="Torch device (default cuda)")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    counters = fn(*example).tolist()
    print(dict(zip(("bit_errors", "frame_errors", "iter_sum",
                    "success_sum"), counters)))
    return counters


if __name__ == "__main__":
    main()
