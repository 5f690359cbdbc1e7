"""Stage-by-stage cost of the softening round's preamble.

The port's counterpart of the JAX package's ``scripts/probe_preamble.py``:
five cumulative stages on the engine's [S, B] layout (S = n / bps symbols
by B frames), each timed on its own, so that a stage's cost is the
difference of adjacent rows:

  sample           -- the channel draw: ``PAMAlphabet.random_symbols``,
                      ``index_to_value`` plus sigma times standard normal
                      noise (bf16 noise by JAX's own bf16 rule,
                      ``sims.engine.bf16_normal``);
  +hard_decide     -- ``NoiseMapper.hard_decide_index``;
  +map_noise       -- ``NoiseMapper.map_noise``;
  +word_bits       -- the Gray bits ``s_to_b[:, b][x_hat]`` stacked over b;
  +poly_llr(full)  -- ``NoiseMapper._poly_llr_bits`` after
                      ``_ensure_llr_poly`` (and ``_ensure_fy_poly`` for
                      ``--fy-mode poly``), stacked into the LLR word.

Every call draws from a ``torch.Generator`` seeded 0, as every JAX call
reuses one key.

    python -m qamreconciliation_tpu_torch.scripts.probe_preamble \\
        [--bps 4] [--dtype bfloat16] [--fy-mode poly] [--device cuda]

One record a stage after the device record: ``{stage, bps, fy_mode, ms,
compile_s}`` (``ms`` the mean of ``--reps`` calls in one CUDA-event
window).  Exits 2 without a card unless ``--device cpu``.
"""

import argparse
import math
import sys

import numpy as np
import torch

from ._probe import add_device, emit, first_call, open_device, window_ms
from ..config import as_dtype
from ..models.alphabet import PAMAlphabet
from ..models.noisemapper import NoiseMapper
from ..sims.engine import bf16_normal

__all__ = ["sample", "word_bits", "STAGES", "main"]


def sample(pa, gen, shape, sig):
    """``(x, y)``: symbol indices and ``index_to_value(x) + sig * noise``
    in sig's dtype on its device (``sig`` the noise's sigma as a 0-d
    tensor), drawn from ``gen`` (symbols first)."""
    dtype, device = sig.dtype, sig.device
    x = pa.random_symbols(gen, shape, device)
    if dtype == torch.bfloat16:
        noise = bf16_normal(gen, shape, device)
    else:
        noise = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return x, pa.index_to_value(x, dtype) + sig * noise


def word_bits(s2b, x_hat):
    """[bps * S, B] Gray bits of the decisions, bit b's rows in block b."""
    return torch.cat([s2b[:, b][x_hat.long()] for b in range(s2b.shape[1])])


def _hard(nm, s2b, x, y):
    return nm.hard_decide_index(y).to(y.dtype) + y


def _noise(nm, s2b, x, y):
    return nm.map_noise(y, nm.hard_decide_index(y))


def _word(nm, s2b, x, y):
    x_hat = nm.hard_decide_index(y)
    n_hat = nm.map_noise(y, x_hat)
    return n_hat + word_bits(s2b, x_hat).to(y.dtype)[:y.shape[0]]


def _llr(nm, s2b, x, y):
    x_hat = nm.hard_decide_index(y)
    n_hat = nm.map_noise(y, x_hat)
    word = word_bits(s2b, x_hat)
    lappr = torch.cat(nm._poly_llr_bits(n_hat, x))
    return lappr + word.to(y.dtype)


# (name, stage(nm, s2b, x, y) after the draw)
STAGES = [
    ("sample", lambda nm, s2b, x, y: y),
    ("+hard_decide", _hard),
    ("+map_noise", _noise),
    ("+word_bits", _word),
    ("+poly_llr(full)", _llr),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_preamble")
    ap.add_argument("--n", type=int, default=64800)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--bps", type=int, default=2)
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--fy-mode", default="erf",
                    choices=["erf", "erf_flat", "poly"])
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_preamble", args.device)
    if device is None:
        return 2
    snr = args.snr if args.snr is not None else (3.5 if args.bps == 2
                                                 else 10.0)

    dt = as_dtype(args.dtype)
    pa = PAMAlphabet(args.bps, 2.0)
    N0 = pa.variance * (10.0 ** (-snr / 10.0)) / 2.0
    sigma = math.sqrt(N0)
    nm = NoiseMapper(pa, N0, dtype=dt, device=device, fy_mode=args.fy_mode)
    nm._ensure_llr_poly()
    if args.fy_mode == "poly":
        nm._ensure_fy_poly()
    shape = (args.n // args.bps, args.batch)
    s2b = torch.as_tensor(pa.s_to_b.astype(np.int32), device=device)
    gen = torch.Generator(device=device)
    # made once: a host scalar copied to the card each call would
    # synchronize the stream
    sig = torch.tensor(sigma, dtype=dt, device=device)

    for name, stage in STAGES:
        def call(stage=stage):
            gen.manual_seed(0)
            return stage(nm, s2b, *sample(pa, gen, shape, sig))

        compile_s = first_call(call, device)
        ms = window_ms(call, args.reps, device)
        emit({"stage": name, "bps": args.bps, "fy_mode": args.fy_mode,
              "ms": round(ms, 4), "compile_s": round(compile_s, 1)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
