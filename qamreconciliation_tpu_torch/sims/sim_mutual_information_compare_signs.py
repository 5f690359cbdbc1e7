"""Sign-configuration comparison sweep CLI.

    python -m qamreconciliation_tpu_torch.sims.sim_mutual_information_compare_signs
        [--out out.csv] [--snr 0 5] [--nsnr 11] [--bps 2] [--montecarlo]
        [--nmontecarlo 4096] [--nloops 64] [--mc-ginv poly|interp]
        [--config-chunk 4096] [--seed 0] [--resume] [--device cuda]

Mirrors the reference (reference: sims/sim_mutual_information_compare_signs.py):
enumerate all monotonicity sign configurations up to flip-reversal symmetry
(config_count = 2^(M/2-1) * (2^(M/2)+1) kept configs out of 2^M) and evaluate
I(X,N;Xhat) for each, analytically (quad) or by Monte-Carlo.

The Monte-Carlo path evaluates the configurations of a chunk together: one
mapper per SNR point, cloned per configuration with every table shared
(``NoiseMapper.with_sign_config``), and one stacked estimator call over the
chunk's ``[configs, samples]`` draw (``montecarlo_information_batched``).
``--resume`` restarts from the per-SNR-point journal.
"""

import argparse
import time

import numpy as np
import torch

from ..models.alphabet import PAMAlphabet
from ..models.mutual_information import (
    P_xhat,
    montecarlo_information_batched,
    mutual_information_base_scheme,
)
from ..models.noisemapper import NoiseMapper
from ..utils.checkpoint import SweepState
from .common import write_table

__all__ = ["build_parser", "main", "enumerate_configs"]


def reverse_flip_bits(n: int, M: int) -> int:
    """Bit-reverse + complement over M bits: the flip-reversal symmetry that
    maps a sign configuration to its equivalent mirror
    (reference: sim_mutual_information_compare_signs.py:33-37)."""
    res = 0
    for k in range(M):
        res += (((n >> k) & 0b1) ^ 0b1) << (M - 1 - k)
    return res


def index_to_config(n: int, M: int) -> np.ndarray:
    return np.array([(n >> i) & 0b1 for i in range(M)], dtype=np.uint8)


def enumerate_configs(M: int):
    """Keep one representative per flip-reversal orbit."""
    config_list = []
    kept_ids = []
    for c in range(1 << M):
        if reverse_flip_bits(c, M) >= c:
            config_list.append(index_to_config(c, M))
            kept_ids.append(c)
    return np.array(config_list), kept_ids


def build_parser():
    parser = argparse.ArgumentParser(
        prog="mutual_information_base_scheme",
        description="Evaluate mutual information vs SNR of the base scheme",
    )
    parser.add_argument("--out", default="out.csv")
    parser.add_argument("--snr", type=float, nargs=2, default=[0, 5])
    parser.add_argument("--nsnr", type=int, default=11)
    parser.add_argument("--bps", type=int, default=2)
    parser.add_argument("--montecarlo", action="store_true")
    parser.add_argument("--nmontecarlo", type=int, default=1 << 12)
    parser.add_argument("--nloops", type=int, default=1 << 6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--mc-ginv", choices=["poly", "interp"], default="poly",
        help="Candidate-inverse reconstruction inside the MC estimator: "
        "'poly' (probit-warped Chebyshev fit of the same inverse table, fit "
        "error ~1e-5 of the constellation scale, far below MC noise) or "
        "'interp' (the reference's grid interpolation)",
    )
    parser.add_argument("--config-chunk", type=int, default=4096,
                        help="Configurations per stacked estimator call "
                        "(bounds device memory at bps=4's 32,896 configs)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the per-SNR-point journal")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the estimator (cuda or cpu)")
    return parser


def main(argv=None):
    """Run the sweep; returns the CSV's rows (point, one value a config)."""
    args = build_parser().parse_args(argv)
    M = 1 << args.bps

    config_array, kept_ids = enumerate_configs(M)
    column_list = ["EsN0dB"] + [f"I(X,N;Xhat)_{c}" for c in kept_ids]
    config_count = (1 << ((M >> 1) - 1)) * ((1 << (M >> 1)) + 1)
    assert config_array.shape[0] == config_count
    print(config_count)
    print(config_array)

    EsN0dB = np.linspace(args.snr[0], args.snr[1], args.nsnr)
    pa = PAMAlphabet(args.bps, 2)
    Es = pa.variance
    state = SweepState(args.out, resume=args.resume)
    rows = []
    for i, esn0db in enumerate(EsN0dB):
        prev = state.done(esn0db)
        if prev is not None:
            rows.append(tuple([prev["point"]] + list(prev["values"])))
            continue
        t_point = time.perf_counter()
        N0 = Es * (10 ** (-esn0db / 10)) / 2
        # one table build per SNR point: no table depends on the sign
        # configuration, so every configuration is a clone sharing them
        base_nm = NoiseMapper(pa, N0, dtype="float64", device=args.device)
        if args.montecarlo and args.mc_ginv == "poly":
            base_nm._ensure_ginv_poly()     # shared by every clone
        nms = [base_nm.with_sign_config(config_array[k])
               for k in range(config_count)]
        if args.montecarlo:
            # P{Xhat} does not depend on the signs: one row, broadcast
            p_base = P_xhat(base_nm)
            p_Xhats = np.broadcast_to(p_base, (config_count, p_base.size))
            acc = np.zeros(config_count)
            gen = torch.Generator(device=args.device).manual_seed(
                args.seed + 104729 * i)
            CH = max(1, min(args.config_chunk, config_count))
            for lo in range(0, config_count, CH):
                hi = min(lo + CH, config_count)
                for _ in range(args.nloops):
                    out = montecarlo_information_batched(
                        gen, pa, nms[lo:hi], p_Xhats[lo:hi],
                        args.nmontecarlo, which=(False, False, True),
                        ginv_mode=args.mc_ginv,
                    )
                    acc[lo:hi] += out[:, 2]
            values = [float(v) for v in acc / args.nloops]
        else:
            p_base = P_xhat(base_nm)
            values = [
                mutual_information_base_scheme(nm, p_base) for nm in nms
            ]
        state.record(esn0db, dict(values=values))
        rows.append(tuple([float(esn0db)] + values))
        dt_s = time.perf_counter() - t_point
        print(f"[EsN0dB={esn0db:.3f}] {config_count} configs in "
              f"{dt_s:.1f}s ({config_count / dt_s:.0f} configs/s)")

    write_table(args.out, column_list, rows)
    state.cleanup()
    return rows


if __name__ == "__main__":
    main()
