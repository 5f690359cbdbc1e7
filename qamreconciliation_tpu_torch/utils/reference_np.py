"""Host-side numpy oracle of the softening pipeline (float64, exact).

A copy of the JAX package's ``utils/reference_np.py`` (numpy and scipy
only).  Scalar-semantics reimplementation of the reference's per-frame
chain (reference: sims/reconciliation.pyx:127-146): sample shaped symbols,
AWGN, hard-decide, softening metric, Gray word, interpolated-inverse LLRs.
Used

* to feed the native single-core baseline decoder and the numpy oracle
  decoder (``models/decoder_np.DecoderNp``) with the input distribution
  the device round sees, and
* in tests as an independent float64 oracle for the batched device ops.

Everything reads the NoiseMapper's host float64 tables (``np_tables``); no
device involved.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erf, logsumexp

__all__ = ["softening_frames_np", "softening_chain_np"]


def _f_y(nm, y):
    """Probability-weighted marginal CDF of Y (float64, any shape)."""
    t = nm.np_tables
    z = (y[..., None] - t["constellation"]) / (np.sqrt(2.0) * nm.noise_sigma)
    return np.sum(t["probabilities"] * 0.5 * (1.0 + erf(z)), axis=-1)


def softening_frames_np(nm, alphabet, n_frames: int, n_symb: int, seed: int = 0):
    """Generate ``n_frames`` softening-reconciliation frames.

    Returns ``(lappr [F, n_symb*bps], word [F, n_symb*bps] uint8)`` in
    float64; the caller computes syndromes against its parity matrix.
    """
    t = nm.np_tables
    rng = np.random.default_rng(seed)
    M = nm.order
    c = t["constellation"]
    p = t["probabilities"]
    x = rng.choice(M, size=(n_frames, n_symb), p=p)
    y = c[x] + nm.noise_sigma * rng.standard_normal((n_frames, n_symb))
    return softening_chain_np(nm, alphabet, x, y)


def softening_chain_np(nm, alphabet, x, y):
    """The softening chain on GIVEN samples ``x`` [F, S] int, ``y`` [F, S]
    float64 (same math as :func:`softening_frames_np`; split out so golden
    tests can drive every oracle on identical hand-picked inputs)."""
    t = nm.np_tables
    M = nm.order
    c = t["constellation"]
    p = t["probabilities"]
    thr_int = t["thresholds"][1:M]
    F_thr = t["F_Y_thresholds"]
    dF = t["delta_F_Y"]
    signs = nm.sign_config.astype(bool)
    n_frames = x.shape[0]

    # Bob: hard decision + softening metric n = g(y, x_hat)
    x_hat = np.searchsorted(thr_int, y, side="right")
    F = _f_y(nm, y)
    lo, hi, d = F_thr[x_hat], F_thr[x_hat + 1], dF[x_hat]
    n_hat = np.where(signs[x_hat], (hi - F) / d, (F - lo) / d)

    word = nm.alphabet.s_to_b[x_hat].reshape(n_frames, -1).astype(np.uint8)

    # Alice: per-candidate inverse softening + probability-weighted LLRs
    # (interp flavor — the engine's default llr_mode is "poly", a
    # piecewise-Chebyshev fit of this same chain; "table" is its dense
    # tabulation; tests compare all of them).
    u = np.linspace(0.0, 1.0, 1 << 14)
    y_of_u = np.interp(u, t["F_Y"], t["y_range"])
    ii = np.arange(M)
    target = np.where(
        signs[ii], F_thr[ii + 1] - n_hat[..., None] * dF[ii],
        n_hat[..., None] * dF[ii] + F_thr[ii],
    )
    y_hat = np.interp(np.clip(target, 0.0, 1.0), u, y_of_u)   # [F, S, M]

    c_j = c[x][..., None, None]
    c_k = c[None, :]
    expo = (2.0 * y_hat[..., None] - c_k - c_j) * (c_k - c_j) / (
        2.0 * nm.noise_var
    )
    log_sums = logsumexp(expo + np.log(p), axis=-1)           # [F, S, M]
    log_w = np.log(dF) - log_sums

    bits = alphabet.s_to_b.astype(bool)                        # [M, bps]
    lw = log_w[..., None]                                      # [F, S, M, 1]
    num = logsumexp(np.where(bits, -np.inf, lw), axis=-2)
    den = logsumexp(np.where(bits, lw, -np.inf), axis=-2)
    lappr = (num - den).reshape(n_frames, -1)
    return lappr, word
