"""Softening / noise-mapping layer (the paper's central object).

Tables are built once per (alphabet, noise variance) on the host in float64
(numpy/scipy, copied from the JAX package) and moved to the device.  The
per-sample methods are tensor ops over any sample shape, with the JAX
package's dtype rules (its float32/bfloat16 paths as they run with x64 off,
as on an accelerator; float64 throughout for a float64 mapper):

* ``hard_decide_index`` -- Bob's decision interval;
* ``F_Y`` in three forms (``fy_mode``: the exact erf mixture, the same
  mixture unrolled over host floats, a probit-warped Chebyshev fit) and
  ``g``/``map_noise`` -- Bob's softening metric;
* ``g_inv`` (uniform-in-CDF inverse table), ``g_inv_poly`` (Chebyshev fit
  of the inverse CDF), ``g_inv_search`` (safeguarded Newton on the exact
  CDF) and ``demap_noise`` -- the softening metric's inverse;
* Alice's softening LLRs: ``_poly_llr_bits`` / ``_table_llr_bits`` (the
  piecewise-Chebyshev fit or the tabulated (n, j) -> LLR map) and
  ``demap_lappr_array`` in all four modes, with the reference's
  "Formulation 1" (``demap_lappr_simplified_array``) and "Formulation 3"
  (``demap_lappr_sofisticated_array``);
* ``bare_llr`` -- hard reverse reconciliation's LLRs of a symbol.

``NoiseMapperFlipSign``/``NoiseMapperAntiFlipSign`` fix the monotonicity
directions of g; ``with_sign_config`` clones a mapper with other directions,
sharing its tables.
"""

from __future__ import annotations

import copy
import math
import warnings

import numpy as np
import torch
from scipy.special import erf as np_erf, ndtr, ndtri

from .alphabet import PAMAlphabet
from .bicm import generate_table_s_to_b
from ..config import DEFAULT_DTYPE, INDEX_DTYPE, as_dtype, finite_llr_max

__all__ = [
    "NoiseMapper",
    "NoiseDemapper",
    "NoiseMapperFlipSign",
    "NoiseMapperAntiFlipSign",
]


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
# gather-free g^-1: one global Chebyshev fit of the inverse marginal CDF
# y(u) in the probit coordinate t = ndtri(u) (exactly linear for a single
# Gaussian; smooth for realistic mixture overlap)
_GINV_DEG = 96
# "poly" fy_mode: one global Chebyshev fit of the probit-warped marginal CDF
# h(y) = ndtri(F_Y(y)), evaluated as one Clenshaw chain + one erf a sample
_FY_DEG = 64


def _wide(dtype):
    """float64 for float64, else float32: the dtype a float64 host scalar
    promotes the JAX package's samples to (x64 off)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _clenshaw(x, coeffs):
    """sum_k coeffs[k] T_k(x) by Clenshaw's recurrence, in the order of the
    JAX package's ``lax.scan`` over the reversed coefficients."""
    deg = coeffs.shape[0] - 1
    b1 = torch.zeros_like(x)
    b2 = b1
    for k in range(deg, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + coeffs[k], b1
    return x * b1 - b2 + coeffs[0]


def _logsumexp(a, dim):
    """``jax.scipy.special.logsumexp`` over ``dim``: the max (0 where not
    finite) taken out, ``log(|sum exp|) + max``."""
    amax = a.amax(dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = torch.exp(a - amax).sum(dim=dim)
    return torch.log(s.abs()) + amax.squeeze(dim)


class NoiseMapper:
    """Precomputed softening tables + batched mapping/demapping ops.

    Args:
      pa: the alphabet.
      noise_var: N0 (noise variance per real dimension).
      sign_config: [M] 0/1 monotonicity directions of g (None = all 0, the
        Base configuration; the CLI default is the Alternating one).
      trunkation_threshold, n_intervals_per_step: the host CDF grid's
        extent and density (the reference's parameters).
      dtype: sample/LLR dtype.
      device: where the device tables live ("cpu" keeps them on the host).
      fy_mode: marginal-CDF form of ``F_Y``: "erf" (the exact mixture over
        a trailing component axis), "erf_flat" (the same M erfs unrolled
        over host floats, computed in the dtype) or "poly" (the fit of
        :meth:`_ensure_fy_poly`).
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
        if fy_mode not in ("erf", "erf_flat", "poly"):
            raise ValueError(f"unknown fy_mode {fy_mode!r}")
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
        self._fwd = dev(fwd)
        self._back = dev(back)
        self._bare_llr = dev(bare)                      # [M, bps]
        self._inf_erf = dev(self.np_tables["inf_erf_table"])
        self._c = dev(c)
        self._thr_interior = dev(thr[1:M])
        self._p = dev(p)
        self._log_p = dev(np.log(p))
        self._sign_cfg = dev(self.sign_config.astype(np.bool_), torch.bool)
        self._bits_mask = dev(bits)                     # [M, bps]
        self._sigma_dev = dev(self._sigma)
        self._noise_var_dev = dev(self.noise_var)
        self._thr_tuple = tuple(float(t) for t in thr[1:-1])
        # constellation and priors as host floats for the unrolled F_Y
        self._c_tuple = tuple(float(v) for v in c)
        self._p_tuple = tuple(float(v) for v in p)

        # inverse marginal CDF on a uniform u-grid, for g^-1 by one lerp
        self._inv_K = 1 << 14
        y_of_u = np.interp(
            np.linspace(0.0, 1.0, self._inv_K), F_Y_grid, y_range
        )
        self._y_of_u = dev(y_of_u)
        # tabulated / polynomial softening LLRs, built on first use; they
        # depend on the sign configuration
        self._llr_K = 1 << 13
        self._llr_tab = None
        self._llr_poly = None
        # the softening kernel's table (_ensure_softening_tab), built on
        # first use; it holds the sign configuration too
        self._softening_tab = None
        self._llr_tab_inputs = (F_thr, delta_F_Y, y_of_u, c, p, bits, llr_cap)
        # the fits of the inverse CDF and of the CDF, built on first use;
        # they do not depend on the sign configuration (clones share them)
        self._ginv_poly = None
        self._fy_poly = None
        self._fy_dom = None

    def with_sign_config(self, sign_config) -> "NoiseMapper":
        """A clone of this mapper with another sign configuration.

        The signs only choose the direction of g/g^-1 as they are read; no
        constructor table depends on them, so every table is shared by
        reference.  The LLR table and fit bake the directions in, so the
        clone builds its own; the inverse-CDF and CDF fits are shared.
        """
        M = self.order
        cfg = np.asarray(sign_config, dtype=np.uint8).reshape(-1)
        if cfg.size < M:
            raise ValueError(
                "Not enough data for a monotonicity sign configuration"
            )
        cfg = cfg[:M].copy()
        clone = copy.copy(self)
        clone.sign_config = cfg
        clone._sign_cfg = torch.as_tensor(cfg.astype(np.bool_),
                                          device=self.device)
        clone._llr_tab = None
        clone._llr_poly = None
        clone._softening_tab = None
        return clone

    # ------------------------------------------------------------------ #
    # Host tables (float64) under the reference's names

    @property
    def y_range(self):
        return np.asarray(self.np_tables["y_range"])

    @property
    def F_Y_values(self):
        return np.asarray(self.np_tables["F_Y"])

    @property
    def F_Y_thresholds(self):
        return np.asarray(self.np_tables["F_Y_thresholds"])

    @property
    def delta_F_Y(self):
        return np.asarray(self.np_tables["delta_F_Y"])

    @property
    def fwrd_transition_probability(self):
        return np.asarray(self.np_tables["fwrd_transition_probability"])

    @property
    def back_transition_probability(self):
        return np.asarray(self.np_tables["back_transition_probability"])

    @property
    def bare_llr_table(self):
        """The hard-decision bare-LLR table [M, bps] (host float64):
        ``log P{bit 0 | sent j} - log P{bit 1 | sent j}`` over Bob's
        decisions, clipped to the dtype's finite LLR cap."""
        return np.asarray(self.np_tables["bare_llr_table"])

    @property
    def inf_erf_table(self):
        return np.asarray(self.np_tables["inf_erf_table"])

    @property
    def constellation(self):
        return np.asarray(self.np_tables["constellation"])

    @property
    def thresholds(self):
        return np.asarray(self.np_tables["thresholds"])

    @property
    def probabilities(self):
        return np.asarray(self.np_tables["probabilities"])

    def _as(self, x, dtype=None):
        """``x`` as a tensor on the mapper's device (in ``dtype``)."""
        x = torch.as_tensor(x, device=self.device)
        return x if dtype is None else x.to(dtype)

    # ------------------------------------------------------------------ #
    # Effective monotonicity direction used by g / g^-1 (the subclasses
    # fix theirs; g_inv_search always reads sign_config).

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
        (clip/floor/lerp over the flattened [K*M, bps] table; ``K - 1``
        rounded to the mapper's dtype, as the JAX package's weak-typed
        integer is)."""
        self._ensure_llr_tab()
        K, M = self._llr_K, self.order
        t = torch.clamp(n.to(self.dtype), 0.0, 1.0) * torch.tensor(
            K - 1, dtype=self.dtype, device=self.device)
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

    def _ensure_softening_tab(self):
        """Build the table of the fused softening kernel
        (``ops/kernels.softening_inputs``): float32 on the mapper's device,
        with no host read, laid out as ``csrc/softening_inputs.cu`` reads
        it.  It holds the interior thresholds as the hard decision rounds
        them, the constellation, ``p / 2``, the lower and upper threshold
        CDFs and the interval masses in the mapper's dtype, g's signs,
        ``sqrt(2) * sigma`` as ``F_Y`` forms it, and the poly LLR
        coefficients ``[nseg * M, (deg + 1) * bps]``."""
        if self._softening_tab is not None:
            return
        self._ensure_llr_poly()
        f32 = torch.float32
        thr = torch.stack([torch.tensor(t, dtype=self.dtype)
                           for t in self._thr_tuple])
        den = math.sqrt(2.0) * self._sigma_dev.to(f32)
        parts = (thr.to(self.device), self._c, self._p * 0.5,
                 self._F_thr[:-1], self._F_thr[1:], self._delta_F_Y,
                 self._g_signs(), den, self._llr_poly)
        self._softening_tab = torch.cat([t.reshape(-1).to(f32)
                                         for t in parts])

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
    # Marginal CDF of Y

    def F_Y(self, y):
        """Marginal CDF of Y, probability-weighted, in the constructor's
        ``fy_mode``.

        "erf" is evaluated in at least float32, as the JAX package does: its
        denominator multiplies a float64 numpy scalar, which promotes bf16
        samples to float32, so a bf16 mapper returns a float32 CDF (and
        softening metric).  The differences ``y - c`` and the weights
        ``p / 2`` are still formed in the sample dtype first.  "erf_flat"
        and "poly" return the mapper's dtype."""
        if self.fy_mode == "poly":
            return self.F_Y_poly(y)
        if self.fy_mode == "erf_flat":
            return self.F_Y_flat(y)
        y = self._as(y, self.dtype)
        wide = _wide(self.dtype)
        z = (y[..., None] - self._c).to(wide) / (
            math.sqrt(2.0) * self._sigma_dev.to(wide))
        return torch.sum((self._p * 0.5).to(wide) * (1.0 + torch.erf(z)),
                         dim=-1)

    single_F_Y = F_Y

    def F_Y_flat(self, y):
        """Exact marginal CDF with the M components unrolled over host
        floats: every tensor keeps the sample shape, and every operation
        rounds to the mapper's dtype (the JAX package's weak-typed host
        floats), so the result is that dtype.  Same math as the "erf" form
        to rounding; the summation order differs."""
        dt = self.dtype
        y = self._as(y, dt)
        inv = (1.0 / (math.sqrt(2.0) * self._sigma_dev.to(_wide(dt)))).to(dt)
        acc = None
        for ck, pk in zip(self._c_tuple, self._p_tuple):
            t = torch.tensor(0.5 * pk, dtype=dt, device=self.device) * (
                1.0 + torch.erf(
                    (y - torch.tensor(ck, dtype=dt, device=self.device))
                    * inv))
            acc = t if acc is None else acc + t
        return acc

    def _ensure_fy_poly(self):
        """Host build of the "poly" CDF fit: one global degree-``_FY_DEG``
        Chebyshev series of the probit-warped CDF ``h(y) = ndtri(F_Y(y))``
        over ``[c_0 - 6.5 sigma, c_{M-1} + 6.5 sigma]`` (exactly linear for a
        single Gaussian, smooth while the components overlap).  The fit's
        error on the CDF scale is kept in ``_fy_poly_fit_err``, with a
        warning above 5e-4 (well-separated components at high SNR)."""
        if self._fy_poly is not None:
            return
        deg = _FY_DEG
        c = self.np_tables["constellation"]
        p = self.np_tables["probabilities"]
        s = self.noise_sigma
        y_lo = float(c[0] - 6.5 * s)
        y_hi = float(c[-1] + 6.5 * s)
        nn = 4 * (deg + 1)
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]     # [-1, 1]
        yn = y_lo + (xs + 1.0) / 2.0 * (y_hi - y_lo)
        F = np.zeros_like(yn)
        for ck, pk in zip(c, p):
            F += pk * _np_F_Z(yn, ck, s)
        h = ndtri(np.clip(F, 1e-10, 1.0 - 1e-10))
        C = np.polynomial.chebyshev.chebfit(xs, h, deg)
        fit_err = float(
            np.abs(ndtr(np.polynomial.chebyshev.chebval(xs, C)) - F).max()
        )
        self._fy_poly_fit_err = fit_err
        if fit_err > 5e-4:
            warnings.warn(
                f"gather-free F_Y fit residual {fit_err:.3g} on the CDF "
                "scale is large for this (alphabet, N0) — well-separated "
                "mixture components at high SNR; prefer fy_mode='erf'",
                stacklevel=2,
            )
        pdt = _wide(self.dtype)
        self._fy_poly = torch.as_tensor(C, dtype=pdt, device=self.device)
        self._fy_dom = torch.as_tensor([y_lo, y_hi], dtype=pdt,
                                       device=self.device)

    def F_Y_poly(self, y):
        """Marginal CDF from the fit of :meth:`_ensure_fy_poly`: Clenshaw
        over the coefficients and one erf, in float32 (float64 for a
        float64 mapper), returned in the mapper's dtype."""
        self._ensure_fy_poly()
        compute = self._fy_poly.dtype
        y = self._as(y, compute)
        lo, hi = self._fy_dom[0], self._fy_dom[1]
        x = torch.clamp(2.0 * (y - lo) / (hi - lo) - 1.0, -1.0, 1.0)
        h = _clenshaw(x, self._fy_poly)
        F = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
        return F.to(self.dtype)

    # ------------------------------------------------------------------ #
    # Hard decision and the softening metric

    def hard_decide_index(self, y_samples):
        """Decision-interval index of each sample: #{interior thresholds
        <= y}, in [0, M-1] (int32)."""
        y = self._as(y_samples, self.dtype)
        idx = torch.zeros(y.shape, dtype=INDEX_DTYPE, device=y.device)
        for t in self._thr_tuple:
            idx += y >= torch.tensor(t, dtype=self.dtype)
        return idx

    def index_to_val(self, index):
        return self._c[self._as(index).long()]

    def g(self, y, i):
        """Softening metric n = g(y, decided interval i)."""
        y = self._as(y, self.dtype)
        i = self._as(i).long()
        F = self.F_Y(y)
        lo, hi = self._F_thr[i], self._F_thr[i + 1]
        d = self._delta_F_Y[i]
        flip = self._g_signs()[i]
        return torch.where(flip, (hi - F) / d, (F - lo) / d)

    def map_noise(self, y_samples, index):
        """n = g(y, index) elementwise."""
        return self.g(y_samples, index)

    # ------------------------------------------------------------------ #
    # The inverse softening g^-1: n -> y_hat

    def _g_target(self, n_hat, i, signs):
        """The CDF value g^-1 inverts, in the mapper's dtype: ``hi - n d``
        where the sign flips interval ``i``, else ``n d + lo``."""
        lo, hi = self._F_thr[i], self._F_thr[i + 1]
        d = self._delta_F_Y[i]
        n = self._as(n_hat, self.dtype)
        return torch.where(signs[i], hi - n * d, n * d + lo)

    def _interp_inverse(self, target):
        """y(target) by one lerp on the uniform-in-CDF inverse table, in
        the mapper's dtype (``K - 1`` rounded to it too, as the JAX
        package's weak-typed integer is)."""
        dt, K = self.dtype, self._inv_K
        t = torch.clamp(target, 0.0, 1.0) * torch.tensor(
            K - 1, dtype=dt, device=self.device)
        i0 = torch.clamp(torch.floor(t).to(INDEX_DTYPE), 0, K - 2).long()
        frac = t - i0.to(dt)
        y0 = self._y_of_u[i0]
        return y0 + (self._y_of_u[i0 + 1] - y0) * frac

    def g_inv(self, n_hat, i):
        """Inverse softening y_hat = g^-1(n, i) by interpolation on the
        uniform-in-CDF inverse table (clamped, not extrapolated, beyond
        the grid)."""
        i = self._as(i).long()
        return self._interp_inverse(self._g_target(n_hat, i, self._g_signs()))

    def _ensure_ginv_poly(self):
        """Host build of the inverse-CDF fit: one global degree-
        ``_GINV_DEG`` Chebyshev series of the table ``g_inv`` interpolates,
        in the probit coordinate ``t = ndtri(u)`` over ``u in [0.5/K, 1 -
        0.5/K]``.  The residual is kept in ``_ginv_poly_fit_err``, with a
        warning above 1e-2 of the constellation step."""
        if self._ginv_poly is not None:
            return
        deg = _GINV_DEG
        u_eps = 0.5 / self._inv_K
        t_lo, t_hi = float(ndtri(u_eps)), float(ndtri(1.0 - u_eps))
        nn = 4 * (deg + 1)
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]     # [-1, 1]
        tn = t_lo + (xs + 1.0) / 2.0 * (t_hi - t_lo)
        yn = np.interp(ndtr(tn), self.np_tables["F_Y"],
                       self.np_tables["y_range"])
        C = np.polynomial.chebyshev.chebfit(xs, yn, deg)
        fit_err = float(np.abs(np.polynomial.chebyshev.chebval(xs, C)
                               - yn).max())
        self._ginv_poly_fit_err = fit_err
        if fit_err > 1e-2 * float(self.alphabet.step):
            warnings.warn(
                f"gather-free g_inv fit residual {fit_err:.3g} is large "
                "for this (alphabet, N0) — well-separated mixture "
                "components at high SNR; prefer ginv mode 'interp'",
                stacklevel=2,
            )
        self._ginv_poly = torch.as_tensor(C, dtype=_wide(self.dtype),
                                          device=self.device)

    def g_inv_poly(self, n_hat, i):
        """Inverse softening from the fit of :meth:`_ensure_ginv_poly`
        (same contract as :meth:`g_inv`, no table gathers): the target in
        the mapper's dtype, the fit in float32 (float64), the result in the
        mapper's dtype."""
        self._ensure_ginv_poly()
        compute = self._ginv_poly.dtype
        u_eps = 0.5 / self._inv_K
        t_lo, t_hi = float(ndtri(u_eps)), float(ndtri(1.0 - u_eps))
        target = self._g_target(n_hat, self._as(i).long(), self._g_signs())
        u = torch.clamp(target.to(compute), u_eps, 1.0 - u_eps)
        t = torch.special.ndtri(u)
        x = torch.clamp(2.0 * (t - t_lo) / (t_hi - t_lo) - 1.0, -1.0, 1.0)
        return _clenshaw(x, self._ginv_poly).to(self.dtype)

    def _f_Y_pdf(self, y):
        """Mixture pdf of Y (float32 or float64 mappers)."""
        y = self._as(y, self.dtype)
        inv_s = 1.0 / self._sigma_dev
        z = (y[..., None] - self._c) * inv_s
        norm = inv_s / math.sqrt(2.0 * math.pi)
        return torch.sum(self._p * norm * torch.exp(-0.5 * z * z), dim=-1)

    def g_inv_search(self, n_hat, i, y_accuracy: float = 1e-9,
                     iters: int = 12):
        """Inverse softening on the exact CDF: the interpolated inverse,
        then ``iters`` safeguarded Newton steps on the log of the nearer
        CDF tail (log F below 1/2, log(1 - F) above; plain Newton once
        within a decade of the target), each step clipped to +-20.  The
        tails use erfc, so they keep their relative precision.  Always reads
        ``sign_config``, as the reference's subclasses do not override it.

        ``y_accuracy`` is accepted for the reference's signature.  A bf16
        mapper raises TypeError: the step is float32, so the Newton carry
        would change dtype, which the JAX package's loop refuses too."""
        del y_accuracy
        dt = self.dtype
        if dt == torch.bfloat16:
            raise TypeError(
                "g_inv_search needs a float32 or float64 mapper: in bf16 "
                "the Newton step is float32 and the carry would change dtype"
            )
        i = self._as(i).long()
        target = self._g_target(n_hat, i, self._sign_cfg)
        y = self._interp_inverse(target)

        f_floor = torch.tensor(1e-300 if dt == torch.float64 else 1e-38,
                               dtype=dt, device=self.device)
        lower = target <= 0.5
        log_t_lo = torch.log(torch.maximum(target, f_floor))
        log_t_hi = torch.log(torch.maximum(1.0 - target, f_floor))
        inv_sq2s = 1.0 / (math.sqrt(2.0) * self._sigma_dev)
        p_half = self._p * 0.5
        for _ in range(iters):
            z = (y[..., None] - self._c) * inv_sq2s
            F_lo = torch.sum(p_half * torch.special.erfc(-z), dim=-1)
            F_hi = torch.sum(p_half * torch.special.erfc(z), dim=-1)
            pdf = torch.maximum(self._f_Y_pdf(y), f_floor)
            F_lo = torch.maximum(F_lo, f_floor)
            F_hi = torch.maximum(F_hi, f_floor)
            ld_lo = torch.log(F_lo) - log_t_lo
            ld_hi = torch.log(F_hi) - log_t_hi
            step_lo = torch.where(ld_lo.abs() < 1.0, (F_lo - target) / pdf,
                                  ld_lo * (F_lo / pdf))
            step_hi = torch.where(ld_hi.abs() < 1.0,
                                  ((1.0 - target) - F_hi) / pdf,
                                  -ld_hi * (F_hi / pdf))
            step = torch.where(lower, step_lo, step_hi)
            y = y - torch.clamp(step, -20.0, 20.0)
        return y

    def demap_noise(self, n_hat, symb):
        """y_hat = g_inv(n, symb) elementwise."""
        return self.g_inv(n_hat, symb)

    def demap_noise_search(self, n_hat, symb, y_accuracy: float = 1e-9):
        return self.g_inv_search(n_hat, symb, y_accuracy)

    # ------------------------------------------------------------------ #
    # Softening LLRs: n, j of shape [..., S] -> [..., S*bps] flat bit LLRs
    # (per-symbol blocks contiguous), the reference's layout

    def bare_llr(self, symb):
        """Hard-decision LLRs of symbol indices from the bare-LLR table:
        ``[..., S]`` -> ``[..., S*bps]`` (per-symbol blocks contiguous)."""
        llr = self._bare_llr[self._as(symb).long()]    # [..., S, bps]
        return llr.reshape(*llr.shape[:-2], -1)

    def _y_hat_all_candidates(self, n, mode: str):
        """y_hat[..., s, i] = g^-1(n_s, i) for every candidate decision i."""
        n = self._as(n, self.dtype)
        ii = torch.arange(self.order, device=self.device).expand(
            *n.shape, self.order)
        nn = n[..., None].expand(ii.shape)
        if mode == "search":
            return self.g_inv_search(nn, ii)
        if mode == "poly":
            return self.g_inv_poly(nn, ii)
        return self.g_inv(nn, ii)

    def _gray_group_llr(self, log_w):
        """log_w [..., M] -> LLR [..., bps]: log-sum-exp over the Gray-bit
        groups."""
        neg_inf = torch.tensor(-math.inf, dtype=self.dtype,
                               device=self.device)
        lw = log_w[..., None]                          # [..., M, 1]
        mask1 = self._bits_mask > 0                    # [M, bps]
        num = _logsumexp(torch.where(mask1, neg_inf, lw), -2)
        den = _logsumexp(torch.where(mask1, lw, neg_inf), -2)
        return num - den

    def demap_lappr_array(self, n, j, mode: str = "search",
                          ref_compat: bool = False):
        """Softening LLRs, "Formulation 2/4".

        For each sample (softening metric n, Alice's symbol j) and each
        candidate decision i of Bob: y_hat = g^-1(n, i), the interval mass
        ``delta_F_Y[i]`` weighted by the probability-weighted exponential
        sum over the true symbol k, grouped by Gray bit in the log domain.

        mode: "poly" / "table" (the fit or the table of
        :meth:`_poly_llr_bits` / :meth:`_table_llr_bits`), "interp" (the
        interpolated g^-1) or "search" (the Newton g^-1).
        ref_compat: the reference's formula, whose k < j exponents miss the
        ``/ 2 sigma^2`` (it takes the "interp" path for "poly"/"table").

        The candidates are flattened into the sample axis (each sample
        repeated M times, the candidates tiled), so the output's per-symbol
        blocks are contiguous.
        """
        n = torch.atleast_1d(self._as(n, self.dtype))
        j = torch.atleast_1d(self._as(j)).long()
        M, bps = self.order, self.bit_per_symbol
        S = n.shape[-1]
        lead = n.shape[:-1]

        if mode in ("table", "poly") and not ref_compat:
            fn = (self._table_llr_bits if mode == "table"
                  else self._poly_llr_bits)
            llr = torch.stack(fn(n, j), dim=-1)                # [..., S, bps]
            return llr.reshape(*lead, S * bps)
        if mode in ("table", "poly"):
            mode = "interp"

        nf = n.reshape(-1)                                     # [T]
        jf = j.reshape(-1)
        T = nf.shape[0]
        nn = nf.repeat_interleave(M)                           # [T*M]
        ii = torch.arange(M, device=self.device).repeat(T)     # [T*M]
        if mode == "search":
            y_hat = self.g_inv_search(nn, ii)
        else:
            y_hat = self.g_inv(nn, ii)

        c_j = self._c[jf].repeat_interleave(M)
        j_rep = jf.repeat_interleave(M) if ref_compat else None
        two_var = 2.0 * self._noise_var_dev

        def expo_k(k):
            ck = self._c[k]
            base = (2.0 * y_hat - ck - c_j) * (ck - c_j)
            e = base / two_var
            if ref_compat:
                # the reference's k < j terms keep the raw exponent
                e = torch.where(j_rep > k, base, e)
            return e + self._log_p[k]

        expos = [expo_k(k) for k in range(M)]                  # each [T*M]
        m = expos[0]
        for e in expos[1:]:
            m = torch.maximum(m, e)
        acc = torch.zeros_like(m)
        for e in expos:
            acc = acc + torch.exp(e - m)
        log_sums = torch.log(acc) + m
        log_w = torch.log(self._delta_F_Y).repeat(T) - log_sums
        llr = self._gray_group_llr(log_w.reshape(T, M))        # [T, bps]
        return llr.reshape(*lead, S * bps)

    def demap_lappr(self, n, j, mode: str = "search",
                    ref_compat: bool = False):
        """:meth:`demap_lappr_array` of one sample -> [bps]."""
        return self.demap_lappr_array(self._as([n], self.dtype),
                                      self._as([j]), mode, ref_compat)

    def demap_lappr_simplified_array(self, n, j):
        """"Formulation 1": plain Gaussian kernels at the interpolated
        y_hat candidates, grouped by Gray bit."""
        n = torch.atleast_1d(self._as(n, self.dtype))
        j = torch.atleast_1d(self._as(j)).long()
        y_hat = self._y_hat_all_candidates(n, "interp")        # [..., M]
        a_j = self._c[j][..., None]
        log_w = -((y_hat - a_j) ** 2) / (2.0 * self._noise_var_dev)
        llr = self._gray_group_llr(log_w)
        return llr.reshape(*llr.shape[:-2], -1)

    def demap_lappr_simplified(self, n, j):
        return self.demap_lappr_simplified_array(self._as([n], self.dtype),
                                                 self._as([j]))

    def demap_lappr_sofisticated_array(self, n, j, ref_compat: bool = False):
        """"Formulation 3": the beta / delta-F_Z coefficients, in the
        linear domain because the A coefficients are signed (a negative
        group sum gives a NaN LLR, as in the reference).
        ref_compat: the reference's y_hat, built from index j for every
        candidate i."""
        Nk, Dk = self._formulation3_sums(n, j, ref_compat)
        llr = torch.log(Nk) - torch.log(Dk)
        return llr.reshape(*llr.shape[:-2], -1)

    def _formulation3_sums(self, n, j, ref_compat: bool):
        """The Gray-group sums (N_k, D_k) [..., S, bps] of the A
        coefficients; they add to 0 (sum_m A_m = Sz B - Sz B), so one is
        negative wherever rounding does not decide the sign."""
        n = torch.atleast_1d(self._as(n, self.dtype))
        j = torch.atleast_1d(self._as(j)).long()
        M = self.order
        if ref_compat:
            y_hat = self.g_inv(n, j)[..., None].expand(*n.shape, M)
        else:
            y_hat = self._y_hat_all_candidates(n, "interp")

        c_j = self._c[j][..., None, None]
        c_m = self._c[None, :]
        expo = (2.0 * y_hat[..., None] - c_m - c_j) * (c_m - c_j) / (
            2.0 * self._noise_var_dev
        )
        e_coeff = torch.sum(self._p * torch.exp(expo), dim=-1)  # [..., M]
        beta = self._delta_F_Y / e_coeff
        B = torch.sum(beta, dim=-1, keepdim=True)

        a_j = self._c[j][..., None]
        sq2s = torch.sqrt(2.0 * self._noise_var_dev)
        inf_erf_cols = self._inf_erf.T[j]                      # [..., M]
        dFZ = 0.5 * (torch.erf((y_hat - a_j) / sq2s) - inf_erf_cols)
        Sz = torch.sum(dFZ, dim=-1, keepdim=True)

        A = beta * Sz - dFZ * B                                # [..., M]
        bits1 = self._bits_mask                                # [M, bps]
        Nk = torch.einsum("...m,mk->...k", A, 1.0 - bits1)
        Dk = torch.einsum("...m,mk->...k", A, bits1)
        return Nk, Dk

    def demap_lappr_sofisticated(self, n, j, ref_compat: bool = False):
        return self.demap_lappr_sofisticated_array(
            self._as([n], self.dtype), self._as([j]), ref_compat)


class NoiseDemapper(NoiseMapper):
    """Kept-for-compat alias (reference: qamreconciliation/noisemapper.pxd)."""


class NoiseMapperFlipSign(NoiseMapper):
    """g decreasing on the lower half of the constellation."""

    def _g_signs(self):
        return torch.arange(self.order, device=self.device) < self.half_order


class NoiseMapperAntiFlipSign(NoiseMapper):
    """The complement of :class:`NoiseMapperFlipSign`."""

    def _g_signs(self):
        return torch.arange(self.order, device=self.device) >= self.half_order
