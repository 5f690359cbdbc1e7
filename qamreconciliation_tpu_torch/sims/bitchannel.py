"""Bit-channel sweep engines: BSC and BI-AWGN (BPSK) decoding sanity sweeps.

* BSC: a random word, its syndrome, flips with probability f, and the
  constant-magnitude LLR ``(log2(1-f) - log2 f) * (1 - 2*received bit)``
  (log base 2, the reference's quirk, kept).  Bit errors are counted over
  the whole word and the BER divides by N.
* BI-AWGN: ``r = (1 - 2*bit) + sqrt(v) * noise`` with ``v = 10^(-x/10)/2``,
  the soft LLR ``2*alpha/v * r`` or the hard LLR ``LLR0 * sign(r)`` with
  the natural-log ``LLR0 = ln((1-p)/p)``, ``p = erfc(1/sqrt(2v))/2``.  Bit
  errors are counted over the K information bits.

Rounds run layout-native: words, LLRs and noise are ``[N, B]``, the
decoder's layout.  Every point draws its rounds from the sweep seed 0 (the
reference's fixed key), one generator per round; ``rounds_per_dispatch``
rounds are summed on the device per host read of the counters.  With
``mesh_axis`` each rank runs a full batch a round on its own generator and
the counters are summed over the ranks, as in ``ReconciliationEngine``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erfc

from ..config import DEFAULT_DTYPE, as_dtype
from .engine import (
    PointResult, bf16_normal, mesh_of, point_result, run_rounds,
    seeded_dispatches,
)

__all__ = ["BitChannelEngine", "bsc_stop", "biawgn_stop"]


def bsc_stop(minerr: int, simloops: int):
    """The BSC early exit: bit errors > minerr and frames > max(20,
    simloops // 100)."""
    return lambda err, ferr, frames: (
        err > minerr and frames > max(20, simloops // 100))


def biawgn_stop(minerr: int, simloops: int):
    """The BI-AWGN early exit: bit errors >= minerr and frames >
    simloops / 20."""
    return lambda err, ferr, frames: (
        err >= minerr and frames > simloops / 20)


class BitChannelEngine:
    """Batched decoder-only Monte-Carlo engine.

    Args:
      dec: decoder, a ``QCDecoder`` or the generic ``Decoder`` (its
        ``device`` is the engine's device).
      mat: parity matrix (sizes, and the syndrome of a decoder without its
        own).
      batch: frames per round.
      dtype: LLR/noise dtype.
      rounds_per_dispatch: rounds summed on the device per host read of
        the counters (early exit at ``batch * rounds_per_dispatch``
        frames, times the ranks on a mesh).
      mesh_axis: optional ``(mesh, axis_name)``: frame-shard data
        parallelism over the mesh's ranks, as ``ReconciliationEngine``'s.
    """

    def __init__(self, dec, mat, batch: int = 128, dtype=DEFAULT_DTYPE,
                 rounds_per_dispatch: int = 1, mesh_axis=None):
        self.dec = dec
        self.mat = mat
        self.device = dec.device
        # the decoder's structure-aware syndrome (QC circulant rolls) where
        # it has one, else the graph's gather: word [N, B] -> synd [C, B]
        self._synd_nb = getattr(dec, "syndrome_from_bits", None) \
            or mat.graph.syndrome_from_bits
        self.batch = int(batch)
        self.dtype = as_dtype(dtype)
        self.N = mat.vnum
        self.K = mat.vnum - mat.cnum
        if rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1")
        self.rounds_per_dispatch = int(rounds_per_dispatch)
        # BSC counts bit errors over the whole word (N, not K); the JAX
        # package's bound on a dispatch's sum
        if self.rounds_per_dispatch * self.batch * self.N >= 2 ** 31:
            raise ValueError(
                "rounds_per_dispatch * batch * N must stay below 2^31 "
                "(int32 bit-error counts)"
            )
        self.mesh = mesh_of(mesh_axis)
        # frames a point advances per dispatch, over every rank
        self.frames_per_round = self.batch * self.rounds_per_dispatch * (
            1 if self.mesh is None else self.mesh.world)

    def _bernoulli(self, generator, p):
        """int32 [N, B]: float32 uniforms < p (a float32 ``p``)."""
        u = torch.rand((self.N, self.batch), generator=generator,
                       device=self.device, dtype=torch.float32)
        return (u < torch.tensor(p, dtype=torch.float32)).to(torch.int32)

    def _normal(self, generator):
        shape = (self.N, self.batch)
        if self.dtype == torch.bfloat16:
            return bf16_normal(generator, shape, self.device)
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=self.dtype)

    def _decode_and_count(self, lappr, word, synd, max_iterations, span):
        """Decode [N, B] and the four counters, bit errors counted over the
        first ``span`` bits of each frame."""
        success, iters, final = self.dec._build_decode()(
            lappr, synd, max_iterations
        )
        errb = (final[:span] < 0).to(torch.int32) ^ word[:span]
        errors = torch.sum(errb, dim=0)
        return torch.stack([
            torch.sum(errors),
            torch.sum(errors > 0),
            torch.sum(torch.where(success, iters, 0)),
            torch.sum(success),
        ])

    def bsc_llrs(self, word, flips, rber):
        """The BSC channel's LLRs [N, B] of ``word`` received with ``flips``
        (0/1 int32): ``(log2(1-f) - log2 f)`` in the dtype, times ``1 - 2 *
        received bit``."""
        rx = word ^ flips
        llr0 = torch.tensor(math.log2(1.0 - rber) - math.log2(rber),
                            dtype=self.dtype)
        return llr0 * (1 - 2 * rx).to(self.dtype)

    def biawgn_llrs(self, word, noise, ebn0_db, alpha=1.0, hard=False):
        """The BI-AWGN channel's LLRs [N, B] of ``word`` (0/1 int32) over
        standard normal ``noise`` in the dtype: ``r = (1 - 2*bit) +
        sqrt(v) * noise``, then ``2*alpha/v * r`` or, with ``hard``,
        ``LLR0 * sign(r)`` (0 where ``r`` rounds to exactly 0)."""
        v = (10.0 ** (-float(ebn0_db) / 10.0)) / 2.0
        dt = self.dtype
        rx = (1 - 2 * word).to(dt) + torch.tensor(math.sqrt(v),
                                                  dtype=dt) * noise
        if hard:
            p = 0.5 * erfc(1.0 / (math.sqrt(2.0) * math.sqrt(v)))
            llr0 = float(np.log((1.0 - p) / p))
            return torch.tensor(llr0, dtype=dt) * torch.sign(rx)
        return torch.tensor(2.0 * alpha / v, dtype=dt) * rx

    def bsc_round(self, rber, max_iterations, generator=None, inputs=None):
        """One BSC round at flip probability ``rber`` -> counters [4].
        ``inputs=(word, flips)`` ([N, B] 0/1) injects the word and the flips
        in place of drawing them from ``generator``."""
        if inputs is None:
            word = self._bernoulli(generator, 0.5)
            flips = self._bernoulli(generator, rber)
        else:
            word, flips = (x.to(self.device, torch.int32) for x in inputs)
        return self._decode_and_count(self.bsc_llrs(word, flips, rber), word,
                                      self._synd_nb(word), max_iterations,
                                      self.N)

    def biawgn_round(self, ebn0_db, max_iterations, alpha=1.0, hard=False,
                     generator=None, inputs=None):
        """One BI-AWGN round at Eb/N0 ``ebn0_db`` -> counters [4].
        ``inputs=(word, noise)`` ([N, B] 0/1 and standard normal samples)
        injects them in place of drawing them from ``generator``."""
        if inputs is None:
            word = self._bernoulli(generator, 0.5)
            noise = self._normal(generator)
        else:
            word = inputs[0].to(self.device, torch.int32)
            noise = inputs[1].to(self.device, self.dtype)
        lappr = self.biawgn_llrs(word, noise, ebn0_db, alpha, hard)
        return self._decode_and_count(lappr, word, self._synd_nb(word),
                                      max_iterations, self.K)

    def _run(self, round_fn, point, simloops, stop, ber_div, seed):
        it0 = self.dec.iterations_run
        total, frames, elapsed = run_rounds(
            seeded_dispatches(round_fn, seed, self.rounds_per_dispatch,
                              self.device, self.mesh),
            max(1, math.ceil(simloops / self.frames_per_round)),
            self.frames_per_round, stop,
        )
        return point_result(point, total, frames, elapsed, ber_div,
                            self.dec.iterations_run - it0)

    def run_bsc_point(self, rber, max_iterations, simloops, minerr,
                      seed: int = 0) -> PointResult:
        """One BSC point (early exit :func:`bsc_stop`; BER over N)."""
        rber = float(rber)
        return self._run(
            lambda gen: self.bsc_round(rber, max_iterations, generator=gen),
            rber, simloops, bsc_stop(minerr, simloops), self.N, seed)

    def run_biawgn_point(self, ebn0_db, max_iterations, simloops, minerr,
                         alpha=1.0, hard=False, seed: int = 0) -> PointResult:
        """One BI-AWGN point (early exit :func:`biawgn_stop`; BER over
        K)."""
        return self._run(
            lambda gen: self.biawgn_round(ebn0_db, max_iterations, alpha,
                                          hard, generator=gen),
            float(ebn0_db), simloops, biawgn_stop(minerr, simloops), self.K,
            seed)
