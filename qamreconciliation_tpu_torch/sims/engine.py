"""Monte-Carlo reconciliation sweep engine, batched.

Each round processes a batch of ``B`` frames in the decoder's layouts
(samples ``[S, B]``, bits and LLRs ``[N, B]``): symbol sampling and AWGN,
the word and its syndrome, the decoder's LLRs, the syndrome BP decode and
four exact integer counters.  The three modes:

* softening -- reverse reconciliation with the softening metric: Bob's
  hard decision is the word, Alice's softening LLRs feed the decoder;
* hard -- reverse reconciliation with Alice's bare-LLR table, indexed by
  the symbols she sent;
* direct -- Alice's symbols are the word, Bob's Gray LLRs of his samples
  feed the decoder.

After each round the host applies the batch-granular early-exit rule
``frame_errors >= ferr_count_min and frames > simloops/20``.  Randomness
comes from one ``torch.Generator`` per (seed, round).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, as_dtype, not_ported
from ..models.alphabet import PAMAlphabet
from ..models.matrix import Matrix
from ..models.noisemapper import NoiseMapper
from ..ops.llr import y_to_lappr_gray_bits

__all__ = ["ReconciliationEngine", "PointResult", "round_generator",
           "bf16_normal", "run_rounds", "simulate_softening_snr_dB",
           "simulate_direct_snr_dB", "simulate_hard_reverse_snr_dB"]

MODES = ("softening", "hard", "direct")


@dataclass
class PointResult:
    """Per-point result (CSV columns ``EsN0dB,ber,fer,iters``; a bit
    channel's point may be a flip probability or an Eb/N0)."""

    snr_dB: float
    ber: float
    fer: float
    iters: float
    frames: int = 0
    frames_per_s: float = 0.0
    bp_iterations: int = 0

    def as_tuple(self):
        return (self.snr_dB, self.ber, self.fer, self.iters)


def round_generator(seed: int, r: int, device) -> torch.Generator:
    """The generator of round ``r`` of a sweep seeded ``seed``."""
    state = np.random.SeedSequence([int(seed), int(r)]).generate_state(
        1, np.uint64
    )[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _bf16_normal_table() -> torch.Tensor:
    """The 128 values of JAX's bf16 normal draw, indexed by its 7 random
    mantissa bits m (float32 on the host CPU, each rounding of JAX's bf16
    arithmetic done in bf16)."""
    bf = torch.bfloat16
    m = torch.arange(128, dtype=torch.int32)
    # the bf16 value 1 + m/128, then minus 1: m/128 exactly
    u = (m | 0x3F80).to(torch.int16).view(bf) - torch.tensor(1.0, dtype=bf)
    lo = torch.tensor(-1.0 + 2.0 ** -8, dtype=bf)      # nextafter(-1, 0)
    hi = torch.tensor(1.0, dtype=bf)
    u = torch.maximum(lo, u * (hi - lo) + lo)
    # erf_inv of a bf16 computes in float32 and rounds to bf16; the product
    # with bf16(sqrt 2) rounds again
    e = torch.erfinv(u.float()).to(bf)
    return (torch.tensor(math.sqrt(2.0), dtype=bf) * e).float()


_BF16_NORMAL = _bf16_normal_table()


def bf16_normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal samples in bf16 as ``jax.random.normal(key, shape,
    jnp.bfloat16)`` draws them (``jax._src.random._normal_real`` over
    ``_uniform``): 7 random mantissa bits make a bf16 uniform ``u`` on
    [nextafter(-1, 0), 1), and the sample is ``sqrt(2) * erf_inv(u)``, so
    it takes 128 distinct values.  The bits come from ``generator``
    (``torch.randint(0, 128)``), the values from a 128-entry table built by
    JAX's arithmetic, so the card and the CPU give the same values."""
    idx = torch.randint(0, 128, tuple(shape), generator=generator,
                        device=device)
    return _BF16_NORMAL.to(device)[idx].to(torch.bfloat16)


def run_rounds(round_fn, n_rounds: int, frames_per_round: int, stop):
    """Issue ``round_fn(r)`` (counters ``[bit errors, frame errors,
    iterations of successes, successes]``) for r = 0, 1, ... up to
    ``n_rounds`` rounds, reading each round's counters after the next round
    was issued, so the stopping decision ``stop(bit errors, frame errors,
    frames)`` lags one round (the rounds already issued are counted).

    Returns ``(counters [4] as ints, frames, seconds)``.
    """
    total = [0, 0, 0, 0]
    frames = 0

    def accumulate(out):
        nonlocal frames
        for i, v in enumerate(out.tolist()):    # one host read
            total[i] += v
        frames += frames_per_round

    t0 = time.perf_counter()
    pending = None
    for r in range(n_rounds):
        out = round_fn(r)
        if pending is not None:
            accumulate(pending)
            if stop(total[0], total[1], frames):
                pending = out
                break
        pending = out
    if pending is not None:
        accumulate(pending)
    return total, frames, time.perf_counter() - t0


def point_result(point, total, frames, elapsed, bits_per_frame,
                 bp_iterations=0) -> PointResult:
    """The :class:`PointResult` of a point's summed counters; the BER
    divides by ``bits_per_frame``."""
    errs, ferrs, iters, succ = total
    return PointResult(
        snr_dB=point,
        ber=errs / (frames * bits_per_frame),
        fer=ferrs / frames,
        iters=0.0 if succ == 0 else iters / succ,
        frames=frames,
        frames_per_s=frames / elapsed if elapsed > 0 else 0.0,
        bp_iterations=bp_iterations,
    )


class ReconciliationEngine:
    """Batched Monte-Carlo engine bound to (code, alphabet).

    Args:
      dec: decoder, a ``QCDecoder`` or the generic ``Decoder`` (its
        ``device`` is the engine's device; ``iterations_run`` counts the BP
        iterations it ran there).
      mat: parity matrix (sizes).
      pa: alphabet.
      batch: frames per round.
      dtype: LLR/sample dtype.
      llr_mode: "poly" (piecewise-Chebyshev LLR fit, default) or "table"
        (tabulated (n, j) -> LLR map + lerp).
      fy_mode: marginal-CDF form of the softening metric ("erf").
    """

    def __init__(self, dec, mat: Matrix, pa: PAMAlphabet, batch: int = 128,
                 dtype=DEFAULT_DTYPE, llr_mode: str = "poly",
                 fy_mode: str = "erf"):
        if mat.vnum % pa.bit_per_symbol != 0:
            raise ValueError(
                f"code length {mat.vnum} not divisible by bits/symbol "
                f"{pa.bit_per_symbol}"
            )
        if llr_mode not in ("poly", "table"):
            raise not_ported(f"llr_mode={llr_mode!r}",
                             "Rest of NoiseMapper")
        if fy_mode != "erf":
            raise not_ported(f"fy_mode={fy_mode!r}", "Rest of NoiseMapper")
        self.dec = dec
        self.mat = mat
        self.pa = pa
        self.device = dec.device
        self.batch = int(batch)
        self.dtype = as_dtype(dtype)
        self.llr_mode = llr_mode
        self.fy_mode = fy_mode
        self.N = mat.vnum
        self.K = mat.vnum - mat.cnum
        self.N_symb = mat.vnum // pa.bit_per_symbol
        if self.batch * self.K >= 2 ** 31:
            raise ValueError(
                "batch * K must stay below 2^31 (int32 bit-error counts)"
            )
        self.frames_per_round = self.batch
        self._s2b = torch.as_tensor(pa.s_to_b.astype(np.int32),
                                    device=self.device)

    # -- layout-native helpers: samples live as [S, B], bits/LLRs as [N, B]

    def _bits_nb(self, table_col_fn, idx_sb):
        """Per-bit columns + leading-axis interleave: [S, B] -> [N, B]."""
        cols = [table_col_fn(b, idx_sb) for b in range(self.pa.bit_per_symbol)]
        return torch.stack(cols, dim=1).reshape(self.N, -1)

    def _decode_and_count_nb(self, lappr_nb, word_nb, max_iterations):
        """[N, B] decode + the four counters as one int64 tensor
        ``[bit errors, frame errors, iterations of successes, successes]``.

        Bit errors are an exact integer XOR count, never a sum in the LLR
        dtype (bf16 sums round above ~256)."""
        # the decoder's own structure-aware syndrome (QC circulant rolls)
        # where it has one, else the generic graph's gather
        synd_fn = getattr(self.dec, "syndrome_from_bits", None) \
            or self.dec.graph.syndrome_from_bits
        synd = synd_fn(word_nb.to(torch.int32))
        success, iters, final = self.dec._build_decode()(
            lappr_nb, synd, max_iterations
        )
        K = self.K
        errb = (final[:K] < 0).to(torch.int32) ^ word_nb[:K].to(torch.int32)
        errors = torch.sum(errb, dim=0)
        return torch.stack([
            torch.sum(errors),
            torch.sum(errors > 0),
            torch.sum(torch.where(success, iters, 0)),
            torch.sum(success),
        ])

    def _sample_sb(self, generator, sigma):
        """Shaped PAM symbols x [S, B] and their AWGN samples y: the
        symbols from float32 uniforms in every dtype, as the JAX package
        draws them; bf16 noise by JAX's bf16 draw (:func:`bf16_normal`)."""
        shape = (self.N_symb, self.batch)
        x = self.pa.random_symbols(generator, shape, self.device)
        if self.dtype == torch.bfloat16:
            noise = bf16_normal(generator, shape, self.device)
        else:
            noise = torch.randn(shape, generator=generator,
                                device=self.device, dtype=self.dtype)
        sigma = torch.tensor(sigma, dtype=self.dtype)
        y = self.pa.index_to_value(x, self.dtype) + sigma * noise
        return x, y

    def _softening_inputs(self, nm, x, y, alpha):
        """Bob's word [N, B] and Alice's softening LLRs [N, B] from the
        transmitted symbols x and received samples y ([S, B])."""
        x_hat = nm.hard_decide_index(y)
        n_hat = nm.map_noise(y, x_hat)
        word = self._bits_nb(
            lambda b, idx: self._s2b[:, b][idx.long()], x_hat
        )
        llr_fn = (nm._poly_llr_bits if self.llr_mode == "poly"
                  else nm._table_llr_bits)
        llr_bits = llr_fn(n_hat, x)
        alpha = torch.tensor(alpha, dtype=self.dtype)
        lappr = alpha * self._bits_nb(lambda b, _: llr_bits[b], x_hat)
        return lappr, word

    def _hard_inputs(self, nm, x, y):
        """Bob's word [N, B] and Alice's bare LLRs [N, B]: the LLRs of the
        symbols she sent, ``x``, read from the bare-LLR table."""
        x_hat = nm.hard_decide_index(y)
        word = self._bits_nb(
            lambda b, idx: self._s2b[:, b][idx.long()], x_hat
        )
        xl = x.long()
        lappr = self._bits_nb(lambda b, _: nm._bare_llr[:, b][xl], x_hat)
        return lappr, word

    def _direct_inputs(self, x, y, sigma):
        """Alice's word [N, B] and Bob's Gray LLRs [N, B] of his samples,
        with ``2 * sigma**2`` formed in the dtype."""
        word = self._bits_nb(lambda b, idx: self._s2b[:, b][idx.long()], x)
        two_var = 2.0 * torch.tensor(sigma, dtype=self.dtype) ** 2
        llr_bits = y_to_lappr_gray_bits(y, self.pa.constellation, two_var,
                                        self.dtype)
        lappr = self._bits_nb(lambda b, _: llr_bits[b], x)
        return lappr, word

    def round_inputs(self, mode, nm, x, y, sigma, alpha):
        """The decoder's LLRs [N, B] and the word [N, B] of a ``mode``
        round on symbols ``x`` and samples ``y`` ([S, B])."""
        if mode == "softening":
            return self._softening_inputs(nm, x, y, alpha)
        if mode == "hard":
            return self._hard_inputs(nm, x, y)
        if mode == "direct":
            return self._direct_inputs(x, y, sigma)
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")

    def round(self, mode, nm, sigma, alpha, max_iterations, generator=None,
              xy=None):
        """One round of ``mode`` -> counters [4].  ``nm`` is the point's
        NoiseMapper (:meth:`mode_noisemapper`); ``alpha`` scales the
        softening LLRs only.  ``xy=(x, y)`` injects the symbols and samples
        in place of drawing them from ``generator``."""
        x, y = xy if xy is not None else self._sample_sb(generator, sigma)
        lappr, word = self.round_inputs(mode, nm, x, y, sigma, alpha)
        return self._decode_and_count_nb(lappr, word, max_iterations)

    def softening_round(self, nm, sigma, alpha, max_iterations,
                        generator=None, xy=None):
        """:meth:`round` in softening mode."""
        return self.round("softening", nm, sigma, alpha, max_iterations,
                          generator, xy)

    def make_noisemapper(self, snr_dB: float, nmconfig=None) -> NoiseMapper:
        """The point's NoiseMapper, its LLR fit or table built."""
        nm = NoiseMapper(self.pa, self.noise_var(snr_dB), nmconfig,
                         dtype=self.dtype, device=self.device,
                         fy_mode=self.fy_mode)
        if self.llr_mode == "table":
            nm._ensure_llr_tab()
        else:
            nm._ensure_llr_poly()
        return nm

    def mode_noisemapper(self, mode: str, snr_dB: float, nmconfig=None):
        """The NoiseMapper a ``mode`` round reads at ``snr_dB``: the
        softening one with its LLR fit or table, hard's for its bare-LLR
        table alone (no sign configuration, no fit), none for direct."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        if mode == "softening":
            return self.make_noisemapper(snr_dB, nmconfig)
        if mode == "hard":
            return NoiseMapper(self.pa, self.noise_var(snr_dB), None,
                               dtype=self.dtype, device=self.device,
                               fy_mode=self.fy_mode)
        return None

    def noise_var(self, snr_dB: float) -> float:
        """N0 at Es/N0 ``snr_dB``: ``N0 = Es * 10^(-snr/10) / 2``."""
        return self.pa.variance * (10.0 ** (-snr_dB / 10.0)) / 2.0

    # ------------------------------------------------------------------ #

    def run_point(
        self,
        mode: str,
        snr_dB: float,
        decoder_iterations: int,
        simulation_loops: int,
        ferr_count_min: int,
        alpha: float = 1.0,
        nmconfig=None,
        seed: int = 0,
    ) -> PointResult:
        """Run one SNR point until the frame budget or the early-exit rule.

        Each round's counters are read after the next round was issued, so
        the early-exit decision lags one round (the rounds already issued
        are counted).
        """
        nm = self.mode_noisemapper(mode, snr_dB, nmconfig)
        sigma = math.sqrt(self.noise_var(snr_dB))
        it0 = self.dec.iterations_run
        total, frames, elapsed = run_rounds(
            lambda r: self.round(
                mode, nm, sigma, alpha, decoder_iterations,
                generator=round_generator(seed, r, self.device)),
            max(1, math.ceil(simulation_loops / self.frames_per_round)),
            self.frames_per_round,
            lambda errs, ferrs, frames: (ferrs >= ferr_count_min
                                         and frames > simulation_loops / 20),
        )
        return point_result(snr_dB, total, frames, elapsed, self.K,
                            self.dec.iterations_run - it0)


# --------------------------------------------------------------------- #
# The reference engine's free-function API


def simulate_softening_snr_dB(snr_dB, dec, mat, pa, nmconfig,
                              decoder_iterations, simulation_loops,
                              ferr_count_min, alpha: float = 1.0,
                              **engine_kw):
    """One softening point -> ``(snr_dB, ber, fer, iters)``."""
    eng = ReconciliationEngine(dec, mat, pa, **engine_kw)
    return eng.run_point("softening", snr_dB, decoder_iterations,
                         simulation_loops, ferr_count_min, alpha=alpha,
                         nmconfig=nmconfig).as_tuple()


def simulate_direct_snr_dB(snr_dB, dec, mat, pa, decoder_iterations,
                           simulation_loops, ferr_count_min, **engine_kw):
    """One soft direct point -> ``(snr_dB, ber, fer, iters)``."""
    eng = ReconciliationEngine(dec, mat, pa, **engine_kw)
    return eng.run_point("direct", snr_dB, decoder_iterations,
                         simulation_loops, ferr_count_min).as_tuple()


def simulate_hard_reverse_snr_dB(snr_dB, dec, mat, pa, decoder_iterations,
                                 simulation_loops, ferr_count_min,
                                 **engine_kw):
    """One hard reverse point -> ``(snr_dB, ber, fer, iters)``."""
    eng = ReconciliationEngine(dec, mat, pa, **engine_kw)
    return eng.run_point("hard", snr_dB, decoder_iterations,
                         simulation_loops, ferr_count_min).as_tuple()
