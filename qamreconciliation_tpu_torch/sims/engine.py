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

After each dispatch of ``rounds_per_dispatch`` rounds the host reads the
summed counters once and applies the early-exit rule ``frame_errors >=
ferr_count_min and frames > simloops/20``.  Randomness comes from one
``torch.Generator`` per (seed, round), so a point's frames do not depend on
how its rounds are grouped into dispatches.  ``run_sweep_batched`` advances
every SNR point of a grid in each dispatch, one decode over all their
frames.  With ``mesh_axis`` every rank of the mesh runs a full batch a
round on its own generator and the counters are summed over the ranks
(frame-shard data parallelism).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, as_dtype
from ..models.alphabet import PAMAlphabet
from ..models.matrix import Matrix
from ..models.noisemapper import NoiseMapper
from ..ops import kernels
from ..ops.llr import y_to_lappr_gray_bits
from ..utils.trace import span

__all__ = ["ReconciliationEngine", "PointResult", "round_generator",
           "point_seed", "bf16_normal", "run_rounds", "dispatched",
           "seeded_dispatches", "mesh_of",
           "simulate_softening_snr_dB", "simulate_direct_snr_dB",
           "simulate_hard_reverse_snr_dB"]

MODES = ("softening", "hard", "direct")
LLR_MODES = ("poly", "table", "interp", "search")
FY_MODES = ("erf", "erf_flat", "poly")


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


def round_generator(seed: int, r: int, device, rank=None) -> torch.Generator:
    """The generator of round ``r`` of a sweep seeded ``seed``: from
    ``np.random.SeedSequence([seed, r])`` on one device, and from
    ``SeedSequence([seed, r, rank])`` on rank ``rank`` of a mesh, so the
    ranks draw decorrelated frames that do not depend on the world size
    (the JAX package folds the key with the mesh axis index, whose streams
    torch cannot reproduce)."""
    entropy = [int(seed), int(r)] + ([] if rank is None else [int(rank)])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def point_seed(seed: int, i: int) -> int:
    """The seed of point ``i`` of a sweep seeded ``seed`` (the CLIs')."""
    return int(seed) + 1000003 * int(i)


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

    Returns ``(counters [4] as ints, frames, seconds)``.  With
    :func:`dispatched`, a "round" here is a dispatch of several rounds.
    """
    total = [0, 0, 0, 0]
    frames = 0

    def accumulate(out):
        nonlocal frames
        with span("rr.engine.read"):
            counts = out.tolist()               # one host read
        for i, v in enumerate(counts):
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


def seeded_dispatches(round_fn, seed: int, rounds_per_dispatch: int, device,
                      mesh=None):
    """``round_fn(generator) -> counters`` as dispatches of
    :func:`dispatched`, round ``r`` on ``round_generator(seed, r, device)``.
    On a mesh, round ``r`` runs on this rank's generator
    ``round_generator(seed, r, device, mesh.rank)`` and each dispatch's
    counters are summed over the ranks (one all-reduce a dispatch), so
    every rank reads the same totals and takes the same stopping
    decisions."""
    rank = None if mesh is None else mesh.rank
    fn = dispatched(lambda r: round_fn(round_generator(seed, r, device, rank)),
                    rounds_per_dispatch)
    if mesh is None:
        return fn
    return lambda d: mesh.all_reduce_sum(fn(d))


def mesh_of(mesh_axis):
    """The :class:`~qamreconciliation_tpu_torch.parallel.mesh.Mesh` of a
    ``(mesh, axis_name)`` pair (None for None); the axis must be the
    mesh's."""
    if mesh_axis is None:
        return None
    mesh, axis = mesh_axis
    if axis != mesh.axis_name:
        raise ValueError(f"axis {axis!r} is not the mesh's axis "
                         f"{mesh.axis_name!r}")
    return mesh


def dispatched(round_fn, rounds_per_dispatch: int):
    """``round_fn(r) -> counters`` grouped into dispatches: dispatch ``d``
    sums rounds ``d*R .. d*R + R - 1`` on the device (no host read between
    them), so a dispatch of R rounds draws exactly the frames of those R
    rounds."""
    R = int(rounds_per_dispatch)
    if R == 1:
        return round_fn

    def dispatch(d):
        with span("rr.engine.dispatch"):
            out = round_fn(d * R)
            for s in range(1, R):
                out = out + round_fn(d * R + s)
        return out

    return dispatch


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
      llr_mode: Alice's softening LLRs: "poly" (piecewise-Chebyshev LLR
        fit, default), "table" (tabulated (n, j) -> LLR map + lerp),
        "interp" or "search" (``NoiseMapper.demap_lappr_array`` with the
        interpolated or the Newton g^-1; "search" needs float32 or float64).
      fy_mode: marginal-CDF form of the softening metric: "erf",
        "erf_flat" or "poly" (``NoiseMapper.F_Y``).
      rounds_per_dispatch: rounds summed on the device per host read of
        the counters; early exit coarsens to ``batch * rounds_per_dispatch``
        frames (times the ranks on a mesh).
      mesh_axis: optional ``(mesh, axis_name)``
        (``parallel.mesh.make_mesh``): each rank runs ``batch`` frames a
        round on its own generator (``round_generator(..., rank)``) and the
        counters of each dispatch are summed over the ranks, so every rank
        takes the same stopping decisions; ``frames_per_round`` is
        ``batch * rounds_per_dispatch * world``.  The decoder lives on this
        rank's device.
    """

    def __init__(self, dec, mat: Matrix, pa: PAMAlphabet, batch: int = 128,
                 dtype=DEFAULT_DTYPE, llr_mode: str = "poly",
                 fy_mode: str = "erf", rounds_per_dispatch: int = 1,
                 mesh_axis=None):
        if mat.vnum % pa.bit_per_symbol != 0:
            raise ValueError(
                f"code length {mat.vnum} not divisible by bits/symbol "
                f"{pa.bit_per_symbol}"
            )
        if llr_mode not in LLR_MODES:
            raise ValueError(f"unknown llr_mode {llr_mode!r}; one of "
                             f"{LLR_MODES}")
        if fy_mode not in FY_MODES:
            raise ValueError(f"unknown fy_mode {fy_mode!r}; one of "
                             f"{FY_MODES}")
        if rounds_per_dispatch < 1:
            raise ValueError("rounds_per_dispatch must be >= 1")
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
        self.rounds_per_dispatch = int(rounds_per_dispatch)
        # the JAX package's bound on a dispatch's bit-error sum (int32
        # on-device counters there)
        if self.rounds_per_dispatch * self.batch * self.K >= 2 ** 31:
            raise ValueError(
                "rounds_per_dispatch * batch * K must stay below 2^31 "
                "(int32 bit-error counts)"
            )
        self.mesh = mesh_of(mesh_axis)
        # frames a point advances per dispatch, over every rank
        self.frames_per_round = self.batch * self.rounds_per_dispatch * (
            1 if self.mesh is None else self.mesh.world)
        self._s2b = torch.as_tensor(pa.s_to_b.astype(np.int32),
                                    device=self.device)

    # -- layout-native helpers: samples live as [S, B], bits/LLRs as [N, B]

    def _bits_nb(self, table_col_fn, idx_sb):
        """Per-bit columns + leading-axis interleave: [S, B] -> [N, B]."""
        cols = [table_col_fn(b, idx_sb) for b in range(self.pa.bit_per_symbol)]
        return torch.stack(cols, dim=1).reshape(self.N, -1)

    def _decode_and_count_nb(self, lappr_nb, word_nb, max_iterations,
                             points=None):
        """[N, B] decode + the four counters as one int64 tensor
        ``[bit errors, frame errors, iterations of successes, successes]``;
        with ``points``, the frames are ``points`` equal groups (one per SNR
        point) and the counters ``[points, 4]``.

        Bit errors are an exact integer XOR count, never a sum in the LLR
        dtype (bf16 sums round above ~256)."""
        # the decoder's own structure-aware syndrome (QC circulant rolls)
        # where it has one, else the generic graph's gather
        synd_fn = getattr(self.dec, "syndrome_from_bits", None) \
            or self.dec.graph.syndrome_from_bits
        with span("rr.engine.syndrome"):
            synd = synd_fn(word_nb.to(torch.int32))
        success, iters, final = self.dec._build_decode()(
            lappr_nb, synd, max_iterations
        )
        K = self.K
        with span("rr.engine.count"):
            errb = (final[:K] < 0).to(torch.int32) \
                ^ word_nb[:K].to(torch.int32)
            errors = torch.sum(errb, dim=0)               # [B] int64
            per_frame = torch.stack([
                errors, (errors > 0).to(errors.dtype),
                torch.where(success, iters, 0).to(errors.dtype),
                success.to(errors.dtype),
            ])                                             # [4, B]
            if points is None:
                return per_frame.sum(dim=1)
            return per_frame.reshape(4, points, -1).sum(dim=2).T

    def _sample_sb(self, generator, sigma):
        """Shaped PAM symbols x [S, B] and their AWGN samples y: the
        symbols from float32 uniforms in every dtype, as the JAX package
        draws them; bf16 noise by JAX's bf16 draw (:func:`bf16_normal`)."""
        shape = (self.N_symb, self.batch)
        with span("rr.engine.sample"):
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
        transmitted symbols x and received samples y ([S, B]): the fused
        kernel (``ops/kernels.softening_inputs``) where it takes the
        mapper and the LLR mode.  The "interp"/"search" LLRs are the JAX
        package's [B, N] function (``demap_lappr_array``) on the samples'
        transpose."""
        if kernels.softening_takes(nm, self.llr_mode):
            return kernels.softening_inputs(nm, x, y, alpha, self._s2b)
        x_hat = nm.hard_decide_index(y)
        n_hat = nm.map_noise(y, x_hat)
        word = self._bits_nb(
            lambda b, idx: self._s2b[:, b][idx.long()], x_hat
        )
        alpha = torch.tensor(alpha, dtype=self.dtype)
        if self.llr_mode in ("interp", "search"):
            llr = nm.demap_lappr_array(n_hat.T, x.T, mode=self.llr_mode)
            return alpha * llr.T.contiguous(), word
        llr_fn = (nm._poly_llr_bits if self.llr_mode == "poly"
                  else nm._table_llr_bits)
        llr_bits = llr_fn(n_hat, x)
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
        with span("rr.engine.inputs"):
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
        with span("rr.engine.round"):
            x, y = (xy if xy is not None
                    else self._sample_sb(generator, sigma))
            lappr, word = self.round_inputs(mode, nm, x, y, sigma, alpha)
            return self._decode_and_count_nb(lappr, word, max_iterations)

    def softening_round(self, nm, sigma, alpha, max_iterations,
                        generator=None, xy=None):
        """:meth:`round` in softening mode."""
        return self.round("softening", nm, sigma, alpha, max_iterations,
                          generator, xy)

    def make_noisemapper(self, snr_dB: float, nmconfig=None) -> NoiseMapper:
        """The point's NoiseMapper, with the LLR fit or table and the CDF
        fit its modes read built."""
        nm = NoiseMapper(self.pa, self.noise_var(snr_dB), nmconfig,
                         dtype=self.dtype, device=self.device,
                         fy_mode=self.fy_mode)
        if self.llr_mode == "table":
            nm._ensure_llr_tab()
        elif self.llr_mode == "poly":
            nm._ensure_llr_poly()
        if nm.device.type == "cuda" and kernels.softening_takes(
                nm, self.llr_mode):
            nm._ensure_softening_tab()
        if self.fy_mode == "poly":
            nm._ensure_fy_poly()
        return nm

    def mode_noisemapper(self, mode: str, snr_dB: float, nmconfig=None):
        """The NoiseMapper a ``mode`` round reads at ``snr_dB``: the
        softening one with its LLR fit or table, hard's for its bare-LLR
        table alone (no sign configuration, no fit), none for direct."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        with span("rr.engine.setup"):
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
        timer=None,
    ) -> PointResult:
        """Run one SNR point until the frame budget or the early-exit rule.

        Round ``r`` draws from ``round_generator(seed, r)`` (on a mesh,
        rank ``k`` from ``round_generator(seed, r, rank=k)``, the dispatch's
        counters summed over the ranks); dispatch ``d`` runs rounds ``d*R
        .. d*R + R - 1`` (``R = rounds_per_dispatch``).
        Each dispatch's counters are read after the next dispatch was
        issued, so the early-exit decision lags one dispatch (the dispatches
        already issued are counted).  ``timer``, a list, gets the point's
        seconds appended.
        """
        with span("rr.engine.point"):
            nm = self.mode_noisemapper(mode, snr_dB, nmconfig)
            sigma = math.sqrt(self.noise_var(snr_dB))
            it0 = self.dec.iterations_run
            total, frames, elapsed = run_rounds(
                seeded_dispatches(
                    lambda gen: self.round(mode, nm, sigma, alpha,
                                           decoder_iterations,
                                           generator=gen),
                    seed, self.rounds_per_dispatch, self.device, self.mesh),
                max(1, math.ceil(simulation_loops / self.frames_per_round)),
                self.frames_per_round,
                lambda errs, ferrs, frames: (
                    ferrs >= ferr_count_min
                    and frames > simulation_loops / 20),
            )
        if timer is not None:
            timer.append(elapsed)
        return point_result(snr_dB, total, frames, elapsed, self.K,
                            self.dec.iterations_run - it0)

    def run_sweep_batched(
        self,
        mode: str,
        snr_points,
        decoder_iterations: int,
        simulation_loops: int,
        ferr_count_min: int,
        alpha: float = 1.0,
        nmconfig=None,
        seed: int = 0,
        seeds=None,
    ) -> list[PointResult]:
        """Run every SNR point of ``snr_points`` together: each dispatch
        advances every unfinished point by ``rounds_per_dispatch`` rounds,
        and each round decodes all their frames in one ``[N, P*B]`` call.

        Point ``p`` draws its rounds from ``round_generator(seeds[p], r)``
        (default ``seeds[p] = point_seed(seed, p)``, the sequential CLI's
        seed of grid point ``p``) and runs each round's preamble alone, so
        its frames are those of ``run_point`` with that seed.  Its early
        exit is ``run_point``'s, one dispatch late; a finished point leaves
        the batch.  Since a frame's decode does not depend on the frames
        decoded beside it, each point's counters equal a sequential
        sweep's.  ``frames_per_s`` and ``bp_iterations`` are the grid's
        (total frames over the wall time, the shared decodes' iterations)
        on every row: the points share each dispatch.  On a mesh every
        rank runs all the points, rank ``k`` on ``round_generator(seeds[p],
        r, rank=k)``, and the ``[P, 4]`` counters are summed over the
        ranks.
        """
        points = [float(s) for s in snr_points]
        P = len(points)
        seeds = ([point_seed(seed, p) for p in range(P)] if seeds is None
                 else [int(s) for s in seeds])
        if len(seeds) != P:
            raise ValueError("one seed per SNR point")
        R = self.rounds_per_dispatch
        rank = None if self.mesh is None else self.mesh.rank
        n_dispatches = max(1, math.ceil(simulation_loops
                                        / self.frames_per_round))
        totals = np.zeros((P, 4), np.int64)
        frames = np.zeros(P, np.int64)
        issuing = list(range(P))       # points that issue the next dispatch

        def dispatch(d, pts):
            out = None
            with span("rr.engine.dispatch"):
                for s in range(R):
                    ins = []
                    for p in pts:
                        gen = round_generator(seeds[p], d * R + s,
                                              self.device, rank)
                        x, y = self._sample_sb(gen, sigmas[p])
                        ins.append(self.round_inputs(mode, nms[p], x, y,
                                                     sigmas[p], alpha))
                    counters = self._decode_and_count_nb(
                        torch.cat([lappr for lappr, _ in ins], dim=1),
                        torch.cat([word for _, word in ins], dim=1),
                        decoder_iterations, points=len(pts))
                    out = counters if out is None else out + counters
            return out if self.mesh is None else self.mesh.all_reduce_sum(out)

        def accumulate(pts, out):
            with span("rr.engine.read"):
                counts = out.tolist()                   # one host read
            totals[pts] += np.asarray(counts, np.int64)
            frames[pts] += self.frames_per_round
            for p in pts:
                if (p in issuing and totals[p, 1] >= ferr_count_min
                        and frames[p] > simulation_loops / 20):
                    issuing.remove(p)

        with span("rr.engine.point"):
            nms = [self.mode_noisemapper(mode, s, nmconfig) for s in points]
            sigmas = [math.sqrt(self.noise_var(s)) for s in points]
            it0 = self.dec.iterations_run
            t0 = time.perf_counter()
            pending = None
            for d in range(n_dispatches):
                if not issuing:
                    break
                out = (list(issuing), dispatch(d, issuing))
                if pending is not None:
                    accumulate(*pending)
                pending = out
            if pending is not None:
                accumulate(*pending)
            elapsed = time.perf_counter() - t0
        fps = float(frames.sum()) / elapsed if elapsed > 0 else 0.0
        iterations = self.dec.iterations_run - it0
        results = []
        for p, snr in enumerate(points):
            r = point_result(snr, totals[p].tolist(), int(frames[p]),
                             elapsed, self.K, iterations)
            r.frames_per_s = fps
            results.append(r)
        return results


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
