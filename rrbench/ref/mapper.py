"""Bob's hard decision and softening metric, Alice's softening LLRs and
the hard mode's bare LLRs, for one (alphabet, noise variance).

Frozen copy of the parts of ``NoiseMapper`` (``qamreconciliation_tpu_torch/
models/noisemapper.py`` at commit bdbe956) that a softening round with the
"erf" marginal CDF and the "poly" LLR fit, and a hard round, read: the
float64 host tables, ``_llr_eval_f64``, ``_ensure_llr_poly``,
``hard_decide_index``, ``F_Y`` ("erf"), ``g`` and ``_poly_llr_bits``, with
the sign configuration all zeros.  The host fit runs in NumPy from the
same inputs, so its coefficients are the program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erf as np_erf

from .channel import Pam

POLY_NSEG = 8
POLY_DEG = 10
POLY_D = 1e-4
INV_K = 1 << 14


def _np_F_Z(z, mu, sigma):
    return 0.5 * (1.0 + np_erf((z - mu) / (np.sqrt(2.0) * sigma)))


def llr_cap(dtype) -> float:
    """A quarter of the dtype's largest finite value (at most 1e300)."""
    return min(1e300, float(torch.finfo(dtype).max) / 4)


class Mapper:
    """Tables of one (PAM, N0) in ``dtype`` on ``device``."""

    def __init__(self, pam: Pam, noise_var: float, dtype, device,
                 trunc: float = 1e-21, per_step: int = 1000):
        M = pam.order
        self.pam, self.dtype, self.device = pam, dtype, device
        self.noise_var = float(noise_var)
        self.sigma = float(np.sqrt(noise_var))
        c, thr, p = pam.c, pam.thr, pam.p
        sq2s = np.sqrt(2.0) * self.sigma
        tmp = np.sqrt(-2.0 * np.log(trunc)) * self.sigma
        y_low, y_high = c[0] - tmp, c[-1] + tmp
        n_points = int(np.ceil((y_high - y_low) * per_step / pam.step)) + 1
        y_range = np.linspace(y_low, y_high, n_points)
        F_grid = np.zeros(n_points)
        for i in range(M):
            F_grid += p[i] * _np_F_Z(y_range, c[i], self.sigma)
        F_thr = np.empty(M + 1)
        F_thr[0], F_thr[M] = 0.0, 1.0
        for i in range(1, M):
            F_thr[i] = np.sum(p * _np_F_Z(thr[i], c, self.sigma))
        delta = np.diff(F_thr)
        erf_grid = np.empty((M + 1, M))
        erf_grid[0, :] = -1.0
        erf_grid[M, :] = 1.0
        for i in range(1, M):
            erf_grid[i, :] = np_erf((thr[i] - c) / sq2s)
        fwd = 0.5 * (erf_grid[1:, :] - erf_grid[:-1, :]).T
        bits = pam.s_to_b.astype(np.float64)
        Nsum = fwd @ (1.0 - bits)
        Dsum = fwd @ bits
        with np.errstate(divide="ignore"):
            bare = np.where(Dsum == 0.0, 1e300,
                            np.log(np.maximum(Nsum, 0.0)) - np.log(Dsum))
        self.cap = llr_cap(dtype)
        bare = np.clip(bare, -self.cap, self.cap)
        self.F_thr_np, self.delta_np, self.bits = F_thr, delta, bits
        self.y_of_u = np.interp(np.linspace(0.0, 1.0, INV_K), F_grid,
                                y_range)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        self.F_thr = dev(F_thr)
        self.delta = dev(delta)
        self.bare = dev(bare)
        self.c = dev(c)
        self.p = dev(p)
        self.sigma_dev = dev(self.sigma)
        self.thr_tuple = tuple(float(t) for t in thr[1:-1])
        self.poly = None

    # -- Bob: hard decision and softening metric

    def hard_decide(self, y):
        """Decision interval of each sample (int32)."""
        idx = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
        for t in self.thr_tuple:
            idx += y >= torch.tensor(t, dtype=self.dtype)
        return idx

    def F_Y(self, y):
        """Marginal CDF of Y by the erf mixture, in float32."""
        f32 = torch.float32
        z = (y[..., None] - self.c).to(f32) / (
            math.sqrt(2.0) * self.sigma_dev.to(f32))
        return torch.sum((self.p * 0.5).to(f32) * (1.0 + torch.erf(z)),
                         dim=-1)

    def metric(self, y, i):
        """Softening metric n = (F_Y(y) - F(lower threshold)) / interval
        mass (every sign of the configuration is 0)."""
        i = i.long()
        F = self.F_Y(y)
        lo = self.F_thr[i]
        return (F - lo) / self.delta[i]

    # -- Alice: softening LLRs

    def llr_exact(self, n_full):
        """[len(n), M, bps] float64: the exact softening LLRs on an n-grid
        (log domain), clipped to the LLR cap."""
        F_thr, delta, y_of_u = self.F_thr_np, self.delta_np, self.y_of_u
        c, p, bits = self.pam.c, self.pam.p, self.bits
        M = self.pam.order
        n_full = np.asarray(n_full, np.float64)
        signs_b = np.zeros(M, bool)
        b1 = bits.astype(bool)

        def lse(x, axis):
            mm = x.max(axis=axis, keepdims=True)
            return np.squeeze(mm, axis) + np.log(
                np.sum(np.exp(x - mm), axis=axis))

        chunk = max(1, (1 << 22) // max(1, M ** 3))
        out = np.empty((n_full.size, M, bits.shape[1]))
        for lo in range(0, n_full.size, chunk):
            n_grid = n_full[lo:lo + chunk]
            tgt = np.where(
                signs_b[None, :],
                F_thr[1:][None, :] - n_grid[:, None] * delta[None, :],
                n_grid[:, None] * delta[None, :] + F_thr[:-1][None, :],
            )
            y_hat = np.interp(np.clip(tgt, 0.0, 1.0),
                              np.linspace(0.0, 1.0, INV_K), y_of_u)
            expo = (
                (2.0 * y_hat[:, :, None, None] - c[None, None, None, :]
                 - c[None, None, :, None])
                * (c[None, None, None, :] - c[None, None, :, None])
            ) / (2.0 * self.noise_var)
            m = expo.max(axis=-1, keepdims=True)
            denom = np.squeeze(m, -1) + np.log(
                np.sum(np.exp(expo - m) * p[None, None, None, :], axis=-1))
            log_w = np.log(delta)[None, :, None] - denom
            num = lse(np.where(b1[None, :, None, :], -np.inf,
                               log_w[..., None]), axis=1)
            den = lse(np.where(b1[None, :, None, :], log_w[..., None],
                               -np.inf), axis=1)
            out[lo:lo + chunk] = num - den
        return np.clip(out, -self.cap, self.cap)

    def fit_poly(self):
        """The piecewise-Chebyshev LLR coefficients [nseg * M, (deg + 1) *
        bps]: a least-squares fit per (segment, symbol, bit) to the exact
        LLRs at oversampled Chebyshev nodes of the warped coordinate."""
        if self.poly is not None:
            return self.poly
        nseg, deg, d = POLY_NSEG, POLY_DEG, POLY_D
        M, bps = self.pam.order, self.pam.bps
        wlo = np.log(d) - np.log1p(d)
        whi = -wlo
        nn = 4 * (deg + 1)
        xs = np.cos(np.pi * np.arange(nn) / (nn - 1))[::-1]
        C = np.empty((nseg * M, (deg + 1) * bps))
        for s in range(nseg):
            wn = (s + (xs + 1.0) / 2.0) / nseg
            ew = np.exp(wlo + wn * (whi - wlo))
            n_nodes = np.clip((ew * (1.0 + d) - d) / (1.0 + ew), 0.0, 1.0)
            vals = self.llr_exact(n_nodes)
            for j in range(M):
                for b in range(bps):
                    cf = np.polynomial.chebyshev.chebfit(xs, vals[:, j, b],
                                                         deg)
                    C[s * M + j, np.arange(deg + 1) * bps + b] = cf
        self.poly = torch.as_tensor(C, dtype=torch.float32,
                                    device=self.device)
        return self.poly

    def poly_llr(self, n, j, cast):
        """Per-bit LLRs of metric ``n`` and Alice's symbols ``j`` by the
        fit, summed by Clenshaw's recurrence; ``cast`` rounds the float32
        values to the LLRs' storage."""
        poly = self.fit_poly()
        nseg, deg, d = POLY_NSEG, POLY_DEG, POLY_D
        M, bps = self.pam.order, self.pam.bps
        wlo = float(np.log(d) - np.log1p(d))
        inv_range = float(1.0 / (-2.0 * wlo))
        nf = torch.clamp(n.to(poly.dtype), 0.0, 1.0)
        w = torch.log(nf + d) - torch.log((1.0 + d) - nf)
        t = torch.clamp((w - wlo) * (inv_range * nseg), 0.0,
                        nseg * (1.0 - 1e-7))
        sidx = torch.floor(t)
        x = 2.0 * (t - sidx) - 1.0
        combo = sidx.to(torch.int32) * M + j.to(torch.int32)
        cf = poly[combo.long()].reshape(*combo.shape, deg + 1, bps)
        xx = x[..., None]
        b1 = torch.zeros_like(cf[..., 0, :])
        b2 = b1
        for k in range(deg, 0, -1):
            b1, b2 = 2.0 * xx * b1 - b2 + cf[..., k, :], b1
        vals = cast(xx * b1 - b2 + cf[..., 0, :])
        return [vals[..., b] for b in range(bps)]
