"""Channel-observation LLRs (Bob-side, direct reconciliation).

For each sample y and Gray bit k of an M-PAM constellation {a_i},

    LLR_k = log sum_{i: gray_k(i)=0} e^{-(y-a_i)^2 / 2v}
          - log sum_{i: gray_k(i)=1} e^{-(y-a_i)^2 / 2v}

Both functions compute in the given dtype with the JAX package's order of
roundings, so a bf16 call rounds where the JAX one does.
"""

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, as_dtype
from ..models.bicm import gray_bit_masks

__all__ = ["y_to_lappr_gray", "y_to_lappr_gray_bits"]


def _logsumexp(a, dim):
    """``jax.scipy.special.logsumexp`` over ``dim``: a non-finite max is
    replaced by 0, and the sum of a bf16/f16 input accumulates in float32
    and rounds once, as ``jnp.sum`` does."""
    amax = torch.amax(a, dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    wide = torch.float32 if a.element_size() < 4 else a.dtype
    s = torch.sum(torch.exp(a - amax), dim=dim, dtype=wide).to(a.dtype)
    return torch.log(torch.abs(s)) + amax.squeeze(dim)


def y_to_lappr_gray(y, constellation, two_variance, dtype=DEFAULT_DTYPE):
    """y: [..., S] samples -> LLRs [..., S*bps] (per-symbol blocks
    contiguous).  ``two_variance`` is 2*noise_var."""
    dtype = as_dtype(dtype)
    y = torch.as_tensor(y).to(dtype)
    c = torch.as_tensor(np.asarray(constellation), dtype=dtype,
                        device=y.device)
    M = c.shape[0]
    bps = M.bit_length() - 1
    mask1 = torch.as_tensor(gray_bit_masks(bps) > 0, device=y.device)

    log_w = -((y[..., None] - c) ** 2) / torch.as_tensor(two_variance,
                                                         dtype=dtype)
    lw = log_w[..., None]                                    # [..., S, M, 1]
    neg_inf = torch.tensor(-np.inf, dtype=dtype, device=y.device)
    num = _logsumexp(torch.where(mask1, neg_inf, lw), dim=-2)
    den = _logsumexp(torch.where(mask1, lw, neg_inf), dim=-2)
    llr = num - den                                          # [..., S, bps]
    return llr.reshape(*llr.shape[:-2], -1)


def y_to_lappr_gray_bits(y_sb, constellation, two_variance,
                         dtype=DEFAULT_DTYPE):
    """Per-bit direct-mode LLRs: y [S, B] -> [bps, S, B].

    The same math as :func:`y_to_lappr_gray`, one [S, B] slab per
    constellation point: M distance slabs, one shared running max, M exps
    and ``2*bps`` logs.  When every exponential of one Gray group
    underflows against the shared max (a far tail sample at very high SNR),
    the group sum is floored at the dtype's smallest normal, so the LLR
    saturates at a finite ~|log(tiny)| instead of becoming +-inf.
    ``two_variance`` may be a 0-dim tensor.
    """
    dtype = as_dtype(dtype)
    y = torch.as_tensor(y_sb).to(dtype)
    # each point rounded to the dtype first, as a weakly typed JAX scalar is
    cs = [torch.tensor(float(v), dtype=dtype) for v in np.asarray(constellation)]
    M = len(cs)
    bps = M.bit_length() - 1
    masks = gray_bit_masks(bps) > 0                          # [M, bps] host
    inv2v = (1.0 / torch.as_tensor(two_variance, dtype=dtype)).to(dtype)

    lw = [-torch.square(y - c_m) * inv2v for c_m in cs]      # M x [S, B]
    gmax = lw[0]
    for m in range(1, M):
        gmax = torch.maximum(gmax, lw[m])
    e = [torch.exp(lw[m] - gmax) for m in range(M)]          # M x [S, B]

    tiny = float(torch.finfo(dtype).tiny)
    out = []
    for b in range(bps):
        num = den = None
        for m in range(M):
            if masks[m, b]:
                den = e[m] if den is None else den + e[m]
            else:
                num = e[m] if num is None else num + e[m]
        out.append(torch.log(torch.clamp_min(num, tiny))
                   - torch.log(torch.clamp_min(den, tiny)))
    return torch.stack(out)                                  # [bps, S, B]
