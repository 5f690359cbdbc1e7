"""Mutual-information estimators (analytic + Monte-Carlo).

Capability parity with reference: qamreconciliation/mutual_information.pyx.

* The analytic estimators (``scipy.integrate.quad`` over scalar integrands)
  stay on the host in float64, copied from the JAX package: tiny M x M
  computations where exactness matters more than throughput.
* ``montecarlo_information`` is one batched reduction on the mapper's
  device; the per-sample M x M loops (reference: mutual_information.pyx:
  251-292) are tensor dimensions, with randomness from an explicit
  ``torch.Generator``.  ``montecarlo_information_batched`` evaluates P
  mappers of one alphabet at once on ``[P, N]`` samples.

Sign conventions are the reference's: the MC accumulators for I(X;Xhat)
and I(X;Y) sum ``log2(p_Xhat/p_cond)`` and ``log2(sum p_k LR)``, the
*negatives* of the pointwise information, while I(X,N;Xhat) accumulates
with ``-=`` and comes out positive (reference: mutual_information.pyx:259,
269, 292).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from scipy.integrate import quad
from scipy.special import logsumexp as np_logsumexp

from .alphabet import PAMAlphabet
from .noisemapper import NoiseMapper, _logsumexp

__all__ = [
    "P_xhat",
    "mutual_information_base_scheme_arg",
    "mutual_information_base_scheme",
    "mutual_information_X_Xhat",
    "mutual_information_X_Y_int_arg",
    "mutual_information_X_Y",
    "montecarlo_information",
    "montecarlo_information_batched",
    "row_view",
]


def P_xhat(nm: NoiseMapper) -> np.ndarray:
    """Marginal of Bob's decisions: P{Xhat=a_i} = sum_j p_j fwd[j, i]
    (reference: mutual_information.pyx:29-39)."""
    t = nm.np_tables
    return t["probabilities"] @ t["fwrd_transition_probability"]


def _host_g_inv(nm: NoiseMapper, n: float, i: int) -> float:
    """Host float64 grid-interpolated inverse softening (base sign_config)."""
    t = nm.np_tables
    F_thr, dF = t["F_Y_thresholds"], t["delta_F_Y"]
    if nm.sign_config[i]:
        target = F_thr[i + 1] - n * dF[i]
    else:
        target = n * dF[i] + F_thr[i]
    return float(np.interp(target, t["F_Y"], t["y_range"]))


def mutual_information_base_scheme_arg(n: float, nm: NoiseMapper, p_Xhat) -> float:
    """Integrand of I(X,N;Xhat) over n in [0,1]
    (reference: mutual_information.pyx:43-119)."""
    t = nm.np_tables
    c, p, dF = t["constellation"], t["probabilities"], t["delta_F_Y"]
    M = nm.order
    two_var = 2.0 * nm.noise_var

    y_hat = np.array([_host_g_inv(nm, n, i) for i in range(M)])    # [M]
    # denom[i, j] = sum_k p_k exp(-(2 y_i - c_j - c_k)(c_j - c_k)/2v) in
    # the log domain: the raw exp overflows for far-apart (y_hat, c_j)
    # pairs; an overflowed denom gives f == 0, dropped by the q > 0 mask
    expo = -(
        (2.0 * y_hat[:, None, None] - c[None, :, None] - c[None, None, :])
        * (c[None, :, None] - c[None, None, :])
    ) / two_var
    with np.errstate(divide="ignore"):                 # log(p_k = 0) -> -inf
        log_denom = np_logsumexp(expo + np.log(p)[None, None, :], axis=2)
        f_N_Xhat_cond_X = np.exp(np.log(dF)[:, None] - log_denom)  # [i, j]
    f_N_cond_X = f_N_Xhat_cond_X.sum(axis=0)                       # [j]

    res = 0.0
    for j in range(M):
        q = f_N_Xhat_cond_X[:, j] * p[j]
        pos = q > 0.0
        res += np.sum(q[pos] * np.log2(q[pos] / np.asarray(p_Xhat)[pos]))
        tj = p[j] * f_N_cond_X[j]
        if tj > 0.0:
            res -= tj * np.log2(tj)
    return float(res)


def mutual_information_base_scheme(nm: NoiseMapper, p_Xhat) -> float:
    """quad of the integrand over [0, 1]
    (reference: mutual_information.pyx:123-148)."""
    I, _ = quad(mutual_information_base_scheme_arg, 0.0, 1.0, args=(nm, p_Xhat))
    return I


def mutual_information_X_Xhat(nm: NoiseMapper, p_Xhat) -> float:
    """Discrete-channel MI (reference: mutual_information.pyx:152-172)."""
    t = nm.np_tables
    fwd, p = t["fwrd_transition_probability"], t["probabilities"]
    p_Xhat = np.asarray(p_Xhat)
    res = 0.0
    for j in range(nm.order):
        tmp = np.zeros(nm.order)
        pos = fwd[j] > 0.0
        tmp[pos] += np.log2(fwd[j][pos])
        posx = p_Xhat > 0.0
        tmp[posx] -= np.log2(p_Xhat[posx])
        res += p[j] * np.sum(tmp * fwd[j])
    return float(res)


def mutual_information_X_Y_int_arg(y: float, nm: NoiseMapper) -> float:
    """Continuous-channel MI integrand
    (reference: mutual_information.pyx:175-199)."""
    t = nm.np_tables
    c, p = t["constellation"], t["probabilities"]
    two_var = 2.0 * nm.noise_var
    res = 0.0
    for j in range(nm.order):
        # log-domain inner sum: far from the constellation log_tmp stays
        # finite and the Gaussian weight underflows to exactly 0, so the
        # term vanishes; a non-finite term is still dropped, as the
        # reference drops its NaNs (mutual_information.pyx:202-208)
        expo = (2.0 * y - c - c[j]) * (c - c[j]) / two_var
        with np.errstate(divide="ignore"):             # log(p_k = 0) -> -inf
            log_tmp = float(np_logsumexp(expo + np.log(p)))
        tmp2 = (
            p[j] * np.exp(-((y - c[j]) ** 2) / two_var)
            * (log_tmp / np.log(2.0))
        )
        if not np.isnan(tmp2):
            res -= tmp2
    return res / (np.sqrt(2.0 * np.pi) * nm.noise_sigma)


def mutual_information_X_Y(nm: NoiseMapper) -> float:
    I, _ = quad(mutual_information_X_Y_int_arg, -np.inf, np.inf, args=(nm,))
    return I


# --------------------------------------------------------------------- #


def _tensor(v, device):
    """``v`` (a tensor or an array) as a tensor on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device)


def _draw(generator, pa: PAMAlphabet, nm: NoiseMapper, shape):
    """Symbol indices and standard normal noise of ``shape`` (the symbols
    first), in the mapper's dtype (bf16 noise by the JAX package's bf16
    draw)."""
    x_ind = pa.random_symbols(generator, shape, nm.device)
    if nm.dtype == torch.bfloat16:
        from ..sims.engine import bf16_normal

        noise = bf16_normal(generator, shape, nm.device)
    else:
        noise = torch.randn(shape, generator=generator, device=nm.device,
                            dtype=nm.dtype)
    return x_ind, noise


def _mc_terms(pa, nm, p_rows, x_ind, noise, which, ginv_mode):
    """Per-sample terms of the three MC estimators on samples ``[R, N]``
    (``p_rows [R, M]``: each row's decision marginal); each estimate is the
    mean of its terms over N.  Unselected estimators return None.

    ``nm`` may read a per-row sign configuration (see
    :func:`montecarlo_information_batched`); every other table is shared
    by the R rows."""
    dtype = nm.dtype
    x_ind = x_ind.long()
    y = pa.index_to_value(x_ind, dtype) + nm._sigma_dev * noise.to(dtype)
    xhat_ind = nm.hard_decide_index(y).long()
    n = nm.map_noise(y, xhat_ind)

    c, p = nm._c, nm._p
    x_val = c[x_ind]
    two_var = 2.0 * nm._noise_var_dev
    dF = nm._delta_F_Y
    p_hat = torch.gather(p_rows, 1, xhat_ind)                  # [R, N]

    terms = [None, None, None]
    if which[0]:
        terms[0] = torch.log2(p_hat / nm._fwd[x_ind, xhat_ind])
    if which[1]:
        expo = ((2.0 * y[..., None] - c - x_val[..., None])
                * (c - x_val[..., None]) / two_var)
        terms[1] = _logsumexp(expo + nm._log_p, -1) * (1.0 / np.log(2.0))
    if which[2]:
        # y_hat for every candidate decision k: the grid or fitted inverse
        # for k != xhat (the reference's g_inv there) and the exact Newton
        # inverse at k == xhat (its g_inv_search)
        y_hat_all = nm._y_hat_all_candidates(n, ginv_mode)     # [R, N, M]
        y_hat_hat = nm.g_inv_search(n, xhat_ind)               # [R, N]
        is_hat = (torch.arange(nm.order, device=nm.device)
                  == xhat_ind[..., None])
        y_hat_all = torch.where(is_hat, y_hat_hat[..., None], y_hat_all)
        # denom[.., k] = sum_m p_m exp((2 y_hat_k - x - c_m)(c_m - x) / 2v),
        # accumulated over m without an [R, N, M, M] temporary
        xv = x_val[..., None]
        denom = None
        for m in range(nm.order):
            e = p[m] * torch.exp((2.0 * y_hat_all - xv - c[m])
                                 * (c[m] - xv) / two_var)
            denom = e if denom is None else denom + e
        tmp_sum = torch.sum(torch.where(is_hat, 0.0, dF / denom), dim=-1)
        denom_hat = torch.gather(denom, -1, xhat_ind[..., None])[..., 0]
        val = (tmp_sum * denom_hat / dF[xhat_ind] + 1.0) * p_hat
        terms[2] = -torch.log2(val)
    return terms


def _mc_info_impl(generator, pa, nm, p_Xhat_dev, N, which,
                  ginv_mode="interp", xy=None):
    """MC estimator core: ``(I_X_Xhat, I_X_Y, I_XN_Xhat)`` as 0-d tensors
    of the mapper's dtype (0 where ``which`` leaves one out).

    Draws N symbol indices then N standard normals from ``generator``, or
    takes them from ``xy = (x_ind [N], noise [N])``, the seam a test feeds
    identical samples through.

    ginv_mode selects how the I(X,N;Xhat) estimator reconstructs the
    candidate inverses y_hat[s, k != xhat]: "interp" (the reference's g_inv
    grid interpolation) or "poly" (the probit-warped Chebyshev fit of the
    same inverse table).  The k == xhat slot always uses the exact Newton
    ``g_inv_search`` (the reference's contract).
    """
    if xy is None:
        xy = _draw(generator, pa, nm, (int(N),))
    x_ind, noise = (_tensor(v, nm.device) for v in xy)
    p_rows = torch.as_tensor(p_Xhat_dev, device=nm.device).to(nm.dtype)
    terms = _mc_terms(pa, nm, p_rows[None, :], x_ind[None, :],
                      noise[None, :], which, ginv_mode)
    zero = torch.zeros((), dtype=nm.dtype, device=nm.device)
    return tuple(zero if t is None else t[0].mean() for t in terms)


def montecarlo_information(
    generator,
    pa: PAMAlphabet,
    nm: NoiseMapper,
    p_Xhat,
    N: int,
    which=(True, True, True),
    ginv_mode: str = "interp",
    xy=None,
):
    """Monte-Carlo estimators of (I_X_Xhat, I_X_Y, I_XN_Xhat), batched.

    Batched re-design of reference: mutual_information.pyx:212-300, with
    the reference's sign conventions (see module docstring).  ``which`` is
    a 3-tuple of bools selecting the estimators (the reference's uint8
    mask); unselected entries return 0.0.

    ``generator``: a ``torch.Generator`` on the mapper's device (None: the
    global torch generator, as the reference uses the global np.random).
    The estimates run on the mapper's device (``cuda`` unless it was built
    on the CPU).
    """
    p_Xhat_dev = torch.as_tensor(np.asarray(p_Xhat), dtype=nm.dtype,
                                 device=nm.device)
    a, b, c = _mc_info_impl(generator, pa, nm, p_Xhat_dev, int(N),
                            tuple(which), ginv_mode, xy=xy)
    return float(a), float(b), float(c)


class _RowSigns:
    """A per-row sign table ``[R, M]`` read like a mapper's ``[M]`` one:
    ``signs[i]`` for indices ``i [R, ...]`` reads row r's entry i."""

    def __init__(self, stacked):
        self.stacked = stacked

    def __getitem__(self, i):
        R = self.stacked.shape[0]
        rows = torch.arange(R, device=i.device).view(R, *([1] * (i.dim() - 1)))
        return self.stacked[rows, i]


def row_view(nms):
    """A view of ``nms[0]`` whose sign tables read row r's mapper's signs
    for indices of a leading row dimension r (``[R, ...]``), so that the
    mapper's methods evaluate the R mappers at once on ``[R, ...]`` samples.
    Every other table is ``nms[0]``'s: the mappers must share them (e.g.
    ``with_sign_config`` clones)."""
    view = copy.copy(nms[0])
    signs = _RowSigns(torch.stack([nm._g_signs() for nm in nms]))
    view._g_signs = lambda: signs
    view._sign_cfg = _RowSigns(torch.stack([nm._sign_cfg for nm in nms]))
    return view


# a mapper's lazily built fits: functions of its tables, built on first use
_FITS = ("_ginv_poly", "_fy_poly", "_fy_dom", "_llr_tab", "_llr_poly",
         "_softening_tab")


def _tables(nm):
    """The mapper's tensor tables by name: the sign table and the lazy
    fits aside."""
    return {k: v for k, v in vars(nm).items()
            if isinstance(v, torch.Tensor) and k != "_sign_cfg"
            and k not in _FITS}


def _structure(nm):
    return (type(nm), nm.dtype, nm.device, nm.order, nm.fy_mode,
            tuple(sorted((k, tuple(v.shape)) for k, v in _tables(nm).items())))


# rows a batched call evaluates at once: R * N * M elements a temporary
_ROW_ELEMENTS = 1 << 27


def montecarlo_information_batched(generator, pa, nms, p_Xhats, N, which,
                                   ginv_mode="interp", xy=None):
    """Batched MC estimators over a list of NoiseMappers (e.g. one per sign
    configuration) sharing one alphabet and one noise variance.

    Args:
      generator: a ``torch.Generator`` on the mappers' device (None: the
        global one); row p of one ``[P, N]`` draw (symbols, then noise) is
        mapper p's samples.  ``xy = (x_ind [P, N], noise [P, N])`` feeds
        given samples instead.
      nms: list of P NoiseMappers of one structure (alphabet, dtype, device,
        CDF form, table shapes); another structure raises ValueError.
      p_Xhats: [P, M] decision marginals (one per mapper).
      N: samples per mapper.  which: 3-bool mask.

    Returns a [P, 3] numpy array of (I_X_Xhat, I_X_Y, I_XN_Xhat) rows.

    Tables identical by reference across the mappers (every table of a
    ``NoiseMapper.with_sign_config`` clone) are read once; only the sign
    configurations are stacked, ``[P, M]``.  Mappers whose tables are
    separate objects are evaluated in groups of those that share theirs.
    """
    nms = list(nms)
    s0 = _structure(nms[0])
    for k, nm in enumerate(nms[1:], 1):
        if _structure(nm) != s0:
            raise ValueError(
                f"montecarlo_information_batched: NoiseMapper {k}'s "
                f"structure differs from mapper 0's (different alphabet / "
                f"dtype / static config?); batch only same-config mappers"
            )
    nm0 = nms[0]
    P = len(nms)
    if xy is None:
        xy = _draw(generator, pa, nm0, (P, int(N)))
    x_ind, noise = (_tensor(v, nm0.device) for v in xy)
    p_rows = torch.as_tensor(np.ascontiguousarray(p_Xhats), dtype=nm0.dtype,
                             device=nm0.device)
    which = tuple(which)
    out = np.zeros((P, 3))
    # mappers sharing every table by reference form one group
    groups = {}
    for k, nm in enumerate(nms):
        key = tuple(id(v) for _, v in sorted(_tables(nm).items()))
        groups.setdefault(key, []).append(k)
    step = max(1, _ROW_ELEMENTS // (int(N) * nm0.order))
    for rows in groups.values():
        for lo in range(0, len(rows), step):
            part = rows[lo:lo + step]
            first = nms[part[0]]
            # the fits the estimator reads, built once on the group's
            # first mapper (its tables are the whole group's)
            if ginv_mode == "poly":
                first._ensure_ginv_poly()
            if first.fy_mode == "poly":
                first._ensure_fy_poly()
            view = row_view([nms[k] for k in part])
            idx = torch.as_tensor(part, device=nm0.device)
            terms = _mc_terms(pa, view, p_rows[idx], x_ind[idx], noise[idx],
                              which, ginv_mode)
            for e, t in enumerate(terms):
                if t is not None:
                    out[part, e] = t.mean(dim=1).double().cpu().numpy()
    return out
