"""Softening / noise-mapping layer: the subset on the soft reverse path.

Tables are built once per (alphabet, noise variance) on the host in float64
(numpy/scipy, copied from the JAX package) and moved to the device.  The
per-sample methods are tensor ops over any sample shape:

* ``hard_decide_index`` — Bob's decision interval,
* ``F_Y`` (erf form), ``g``/``map_noise`` — Bob's softening metric,
* ``_poly_llr_bits`` / ``_table_llr_bits`` — Alice's softening LLRs from
  the piecewise-Chebyshev fit or the tabulated (n, j) -> LLR map,
* ``bare_llr`` — hard reverse reconciliation's LLRs of a symbol, from the
  bare-LLR table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erf as np_erf

from .alphabet import PAMAlphabet
from .bicm import generate_table_s_to_b
from ..config import (
    DEFAULT_DTYPE, INDEX_DTYPE, as_dtype, finite_llr_max, not_ported,
)

__all__ = ["NoiseMapper"]


def _np_F_Z(z, mu, sigma):
    """Gaussian CDF (host float64)."""
    return 0.5 * (1.0 + np_erf((z - mu) / (np.sqrt(2.0) * sigma)))


# Piecewise-Chebyshev softening-LLR evaluation ("poly" llr_mode): segment
# count / degree / boundary-layer warp width.  The LLR curves have log-type
# boundary layers at n -> 0/1; fitting in the warped coordinate
# w = log(n+d) - log(1-n+d) resolves them.
_POLY_NSEG = 8
_POLY_DEG = 10
_POLY_D = 1e-4


class NoiseMapper:
    """Precomputed softening tables + batched mapping/demapping ops.

    Args:
      pa: the alphabet.
      noise_var: N0 (noise variance per real dimension).
      sign_config: [M] 0/1 monotonicity directions of g (None = all 0, the
        Base configuration; the CLI default is the Alternating one).
      dtype: sample/LLR dtype.
      device: where the device tables live.
      fy_mode: marginal-CDF form; only "erf" is ported.
    """

    def __init__(
        self,
        pa: PAMAlphabet,
        noise_var: float,
        sign_config=None,
        trunkation_threshold: float = 1e-21,
        n_intervals_per_step: int = 1000,
        dtype=DEFAULT_DTYPE,
        device="cuda",
        fy_mode: str = "erf",
    ):
        if noise_var <= 0:
            raise ValueError(
                f"noise variance must be strictly positive, got {noise_var}"
            )
        if fy_mode != "erf":
            raise not_ported(f"fy_mode={fy_mode!r}", "Rest of NoiseMapper")
        self.fy_mode = fy_mode
        M = pa.order
        if sign_config is None:
            self.sign_config = np.zeros(M, dtype=np.uint8)
        else:
            self.sign_config = np.asarray(sign_config, dtype=np.uint8).reshape(-1)
            if self.sign_config.size < M:
                raise ValueError(
                    "Not enough data for a monotonicity sign configuration"
                )
            self.sign_config = self.sign_config[:M].copy()

        self.dtype = as_dtype(dtype)
        self.device = torch.device(device)
        self.alphabet = pa
        self.order = M
        self.half_order = M >> 1
        self.bit_per_symbol = pa.bit_per_symbol
        self.variance = pa.variance
        self.noise_var = float(noise_var)
        self._sigma = float(np.sqrt(noise_var))
        self.noise_sigma = self._sigma

        c = pa.constellation
        thr = pa.thresholds
        p = pa.probabilities
        sq2s = np.sqrt(2.0) * self._sigma

        # --- y grid + marginal CDF for inverse interpolation -------------- #
        if trunkation_threshold > 1.0:
            y_low, y_high = c[0] * 10.0, c[-1] * 10.0
        else:
            tmp = np.sqrt(-2.0 * np.log(trunkation_threshold)) * self._sigma
            y_low, y_high = c[0] - tmp, c[-1] + tmp
        n_points = int(np.ceil((y_high - y_low) * n_intervals_per_step / pa.step)) + 1
        y_range = np.linspace(y_low, y_high, n_points)
        F_Y_grid = np.zeros(n_points)
        for i in range(M):
            F_Y_grid += p[i] * _np_F_Z(y_range, c[i], self._sigma)

        # --- threshold CDF values + interval masses ----------------------- #
        F_thr = np.empty(M + 1)
        F_thr[0], F_thr[M] = 0.0, 1.0
        for i in range(1, M):
            F_thr[i] = np.sum(p * _np_F_Z(thr[i], c, self._sigma))
        delta_F_Y = np.diff(F_thr)

        # --- symbol transition matrices ----------------------------------- #
        # fwd[j, i] = P{Xhat = a_i | X = a_j}
        erf_grid = np.empty((M + 1, M))
        erf_grid[0, :] = -1.0
        erf_grid[M, :] = 1.0
        for i in range(1, M):
            erf_grid[i, :] = np_erf((thr[i] - c) / sq2s)
        fwd = 0.5 * (erf_grid[1:, :] - erf_grid[:-1, :]).T
        marg = p @ fwd
        back = ((p[:, None] * fwd) / marg[None, :]).T

        # --- hard-decision bare-LLR table --------------------------------- #
        bits = generate_table_s_to_b(pa.bit_per_symbol).astype(np.float64)
        Nsum = fwd @ (1.0 - bits)
        Dsum = fwd @ bits
        with np.errstate(divide="ignore"):
            bare = np.where(Dsum == 0.0, 1e300,
                            np.log(np.maximum(Nsum, 0.0)) - np.log(Dsum))
        llr_cap = finite_llr_max(self.dtype)
        bare = np.clip(bare, -llr_cap, llr_cap)

        self.np_tables = dict(
            y_range=y_range,
            F_Y=F_Y_grid,
            F_Y_thresholds=F_thr,
            delta_F_Y=delta_F_Y,
            fwrd_transition_probability=fwd,
            back_transition_probability=back,
            bare_llr_table=bare,
            inf_erf_table=erf_grid[:M, :].copy(),
            constellation=c,
            thresholds=thr,
            probabilities=p,
        )

        # --- device copies ------------------------------------------------ #
        def dev(a, dtype=self.dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        self._F_thr = dev(F_thr)
        self._delta_F_Y = dev(delta_F_Y)
        self._c = dev(c)
        self._p = dev(p)
        self._sign_cfg = dev(self.sign_config.astype(np.bool_), torch.bool)
        self._sigma_dev = dev(self._sigma)
        self._bare_llr = dev(bare)                      # [M, bps]
        self._thr_tuple = tuple(float(t) for t in thr[1:-1])

        # inverse marginal CDF on a uniform u-grid (the LLR builders' g^-1)
        self._inv_K = 1 << 14
        y_of_u = np.interp(
            np.linspace(0.0, 1.0, self._inv_K), F_Y_grid, y_range
        )
        # tabulated / polynomial softening LLRs, built on first use
        self._llr_K = 1 << 13
        self._llr_tab = None
        self._llr_poly = None
        self._llr_tab_inputs = (F_thr, delta_F_Y, y_of_u, c, p, bits, llr_cap)

    @property
    def bare_llr_table(self):
        """The hard-decision bare-LLR table [M, bps] (host float64):
        ``log P{bit 0 | sent j} - log P{bit 1 | sent j}`` over Bob's
        decisions, clipped to the dtype's finite LLR cap."""
        return np.asarray(self.np_tables["bare_llr_table"])

    # ------------------------------------------------------------------ #
    # Effective monotonicity direction used by g / g^-1.

    def _g_signs(self):
        return self._sign_cfg

    # ------------------------------------------------------------------ #
    # Host LLR tables

    def _llr_eval_f64(self, n_full):
        """Exact float64 softening LLRs on an arbitrary n-grid (host).

        The Formulation-2 per-(n, j) LLR in the log domain, clipped to the
        dtype's finite LLR cap.  Returns [len(n_full), M, bps] float64.
        """
        F_thr, delta_F_Y, y_of_u, c, p, bits, llr_cap = self._llr_tab_inputs
        n_full = np.asarray(n_full, np.float64)
        signs_b = self._g_signs().cpu().numpy().astype(bool)
        b1 = bits.astype(bool)                                 # [M_i, bps]

        def lse(x, axis):
            mm = x.max(axis=axis, keepdims=True)
            return np.squeeze(mm, axis) + np.log(
                np.sum(np.exp(x - mm), axis=axis)
            )

        # chunk the n-grid so the [chunk, M, M, M] temporaries stay small
        chunk = max(1, (1 << 22) // max(1, self.order ** 3))
        out = np.empty((n_full.size, self.order, bits.shape[1]))
        for lo in range(0, n_full.size, chunk):
            n_grid = n_full[lo:lo + chunk]
            tgt = np.where(
                signs_b[None, :],
                F_thr[1:][None, :] - n_grid[:, None] * delta_F_Y[None, :],
                n_grid[:, None] * delta_F_Y[None, :] + F_thr[:-1][None, :],
            )                                                  # [k, M_i]
            y_hat_g = np.interp(np.clip(tgt, 0.0, 1.0),
                                np.linspace(0.0, 1.0, self._inv_K), y_of_u)
            # expo[k, M_i, M_j, M_k]
            expo = (
                (2.0 * y_hat_g[:, :, None, None] - c[None, None, None, :]
                 - c[None, None, :, None])
                * (c[None, None, None, :] - c[None, None, :, None])
            ) / (2.0 * self.noise_var)
            m = expo.max(axis=-1, keepdims=True)
            denom = np.squeeze(m, -1) + np.log(
                np.sum(np.exp(expo - m) * p[None, None, None, :], axis=-1)
            )                                                  # [k, M_i, M_j]
            log_w = np.log(delta_F_Y)[None, :, None] - denom
            num = lse(np.where(b1[None, :, None, :], -np.inf,
                               log_w[..., None]), axis=1)      # [k, M_j, bps]
            den = lse(np.where(b1[None, :, None, :], log_w[..., None],
                               -np.inf), axis=1)
            out[lo:lo + chunk] = num - den
        return np.clip(out, -llr_cap, llr_cap)

    def _ensure_llr_tab(self):
        if self._llr_tab is not None:
            return
        self._llr_tab = torch.as_tensor(
            self._llr_eval_f64(np.linspace(0.0, 1.0, self._llr_K)),
            dtype=self.dtype, device=self.device,
        )

    def _table_llr_bits(self, n, j):
        """Per-bit tabulated LLRs: list of ``bps`` tensors shaped like ``n``
        (clip/floor/lerp over the flattened [K*M, bps] table)."""
        self._ensure_llr_tab()
        K, M = self._llr_K, self.order
        t = torch.clamp(n.to(self.dtype), 0.0, 1.0) * (K - 1)
        i0 = torch.clamp(torch.floor(t).to(INDEX_DTYPE), 0, K - 2)
        frac = t - i0.to(self.dtype)
        tab = self._llr_tab.reshape(-1, self.bit_per_symbol)
        base = (i0 * M + j).long()
        out = []
        for b in range(self.bit_per_symbol):
            lo = tab[:, b][base]
            hi = tab[:, b][base + M]
            out.append(lo + (hi - lo) * frac)
        return out

    def _ensure_llr_poly(self):
        """Host build of the piecewise-Chebyshev LLR coefficients
        ``[nseg * M, (deg + 1) * bps]``: degree-``_POLY_DEG`` series per
        (segment, symbol j, bit) fitted to the exact float64 LLR at
        oversampled Chebyshev nodes in the warped coordinate.  The max fit
        residual is kept in ``_llr_poly_fit_err``."""
        if self._llr_poly is not None:
            return
        nseg, deg, d = _POLY_NSEG, _POLY_DEG, _POLY_D
        M, bps = self.order, self.bit_per_symbol
        wlo = np.log(d) - np.log1p(d)
        whi = -wlo
        nn = 4 * (deg + 1)  # 4x oversampled least-squares fit
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]    # [-1, 1]
        C = np.empty((nseg * M, (deg + 1) * bps))
        fit_err = 0.0
        for s in range(nseg):
            wn = (s + (xs + 1.0) / 2.0) / nseg
            ew = np.exp(wlo + wn * (whi - wlo))
            n_nodes = np.clip((ew * (1.0 + d) - d) / (1.0 + ew), 0.0, 1.0)
            vals = self._llr_eval_f64(n_nodes)                 # [nn, M, bps]
            for j in range(M):
                for b in range(bps):
                    c = np.polynomial.chebyshev.chebfit(xs, vals[:, j, b], deg)
                    fit = np.polynomial.chebyshev.chebval(xs, c)
                    fit_err = max(fit_err, np.abs(fit - vals[:, j, b]).max())
                    C[s * M + j, np.arange(deg + 1) * bps + b] = c
        self._llr_poly_fit_err = fit_err
        if fit_err > 1.0:
            import warnings

            warnings.warn(
                f"piecewise-Chebyshev LLR fit residual {fit_err:.3g} is "
                "unusually large for this (alphabet, SNR, sign-config); "
                "prefer llr_mode='table'",
                stacklevel=2,
            )
        pdt = torch.float64 if self.dtype == torch.float64 else torch.float32
        self._llr_poly = torch.as_tensor(C, dtype=pdt, device=self.device)

    def _poly_llr_bits(self, n, j):
        """Per-bit softening LLRs from the piecewise-Chebyshev fit: list of
        ``bps`` tensors shaped like ``n``.  The (segment, j) coefficient row
        is a gather ``C[combo]`` and the series is summed by Clenshaw
        recurrence.  Max deviation from the exact f64 LLR <= ~2e-3."""
        self._ensure_llr_poly()
        nseg, deg, d = _POLY_NSEG, _POLY_DEG, _POLY_D
        M, bps = self.order, self.bit_per_symbol
        compute = self._llr_poly.dtype
        wlo = float(np.log(d) - np.log1p(d))
        inv_range = float(1.0 / (-2.0 * wlo))

        nf = torch.clamp(n.to(compute), 0.0, 1.0)
        w = torch.log(nf + d) - torch.log((1.0 + d) - nf)
        t = torch.clamp((w - wlo) * (inv_range * nseg), 0.0,
                        nseg * (1.0 - 1e-7))
        sidx = torch.floor(t)
        x = 2.0 * (t - sidx) - 1.0
        combo = sidx.to(INDEX_DTYPE) * M + j.to(INDEX_DTYPE)
        cf = self._llr_poly[combo.long()]            # [..., (deg+1)*bps]
        cf = cf.reshape(*combo.shape, deg + 1, bps)
        xx = x[..., None]
        b1 = torch.zeros_like(cf[..., 0, :])
        b2 = b1
        for k in range(deg, 0, -1):
            b1, b2 = 2.0 * xx * b1 - b2 + cf[..., k, :], b1
        vals = (xx * b1 - b2 + cf[..., 0, :]).to(self.dtype)
        return [vals[..., b] for b in range(bps)]

    # ------------------------------------------------------------------ #
    # Per-sample ops

    def F_Y(self, y):
        """Marginal CDF of Y, probability-weighted (the exact M-component
        erf mixture; any sample shape).

        Evaluated in at least float32, as the JAX package does: its
        denominator multiplies a float64 numpy scalar, which promotes bf16
        samples to float32, so a bf16 mapper returns a float32 CDF (and
        softening metric).  The differences ``y - c`` and the weights
        ``p / 2`` are still formed in the sample dtype first."""
        y = y.to(self.dtype)
        wide = torch.float64 if self.dtype == torch.float64 else torch.float32
        z = (y[..., None] - self._c).to(wide) / (
            math.sqrt(2.0) * self._sigma_dev.to(wide))
        return torch.sum((self._p * 0.5).to(wide) * (1.0 + torch.erf(z)),
                         dim=-1)

    def hard_decide_index(self, y_samples):
        """Decision-interval index of each sample: #{interior thresholds
        <= y}, in [0, M-1] (int32)."""
        y = y_samples.to(self.dtype)
        idx = torch.zeros(y.shape, dtype=INDEX_DTYPE, device=y.device)
        for t in self._thr_tuple:
            idx += y >= torch.tensor(t, dtype=self.dtype)
        return idx

    def g(self, y, i):
        """Softening metric n = g(y, decided interval i)."""
        y = y.to(self.dtype)
        i = i.long()
        F = self.F_Y(y)
        lo, hi = self._F_thr[i], self._F_thr[i + 1]
        d = self._delta_F_Y[i]
        flip = self._g_signs()[i]
        return torch.where(flip, (hi - F) / d, (F - lo) / d)

    def map_noise(self, y_samples, index):
        """n = g(y, index) elementwise."""
        return self.g(y_samples, index)

    def bare_llr(self, symb):
        """Hard-decision LLRs of symbol indices from the bare-LLR table:
        ``[..., S]`` -> ``[..., S*bps]`` (per-symbol blocks contiguous)."""
        llr = self._bare_llr[symb.long()]              # [..., S, bps]
        return llr.reshape(*llr.shape[:-2], -1)
