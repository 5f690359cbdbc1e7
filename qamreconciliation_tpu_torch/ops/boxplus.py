"""Belief-propagation message math on tensors (check-node magnitudes).

Box-plus over a set S, excluding element e, in the sign/phi decomposition:

    magnitude:  phi( sum_{s in S} phi(|m_s|) - phi(|m_e|) )
    sign:       (-1)^(parity(S) - neg_e)

with ``phi(x) = -log(tanh(x/2))``, a self-inverse involution.  The tanh
forward/backward form and normalized/offset min-sum are the two other
magnitude rules.  Each function keeps the JAX package's operation order, so
min-sum is bit-identical to it and the sum-product forms agree to float
rounding.
"""

import math

import torch

__all__ = [
    "MINSUM_ALPHA",
    "minsum_mag",
    "box_plus",
    "phi_llr",
    "minsum_extrinsic_mag",
    "tanhfb_extrinsic_mag",
    "fb_allbutone_list",
    "check_node_update",
    "check_node_minsum",
    "check_node_update_sm",
    "check_node_minsum_sm",
    "check_node_tanhfb_sm",
    "var_node_update",
    "stochastic_round_bf16",
]

# Normalized min-sum scale (13/16); exactly representable in bf16/f32.
MINSUM_ALPHA = 0.8125

# Magnitude of the padded-slot sentinel (never wins a min; tanh -> 1).
BIG = 1e30

# tanh-F/B output of a degree-1 check (empty product, u = 1), in float64.
TANHFB_SAT = math.log1p(1.0 - 6e-8) - math.log1p(-(1.0 - 6e-8))


def minsum_mag(m, alpha: float, beta: float):
    """Normalized/offset min-sum magnitude: ``max(alpha*m - beta, 0)``.

    alpha=13/16, beta=0 is the normalized default; alpha=1 with beta>0 is
    classic offset min-sum.  beta=0 is a bare multiply.
    """
    scaled = alpha * m
    if beta:
        return torch.clamp_min(scaled - beta, 0.0)
    return scaled


def box_plus(a, b):
    """Exact pairwise box-plus (elementwise, any shape):
    ``sign(a) sign(b) min(|a|, |b|) + log1p(e^-|a+b|) - log1p(e^-|a-b|)``,
    for tests and small host-side use."""
    return (
        torch.sign(a) * torch.sign(b) * torch.minimum(torch.abs(a),
                                                      torch.abs(b))
        + torch.log1p(torch.exp(-torch.abs(a + b)))
        - torch.log1p(torch.exp(-torch.abs(a - b)))
    )


def phi_llr(x, tiny: float = 1e-30):
    """phi(x) = -log(tanh(x/2)) for x > 0, numerically stable, self-inverse.

    Inputs are clamped to ``[tiny, inf)``, which bounds outputs at
    ``phi(tiny)`` (~69 for tiny=1e-30).  Two regimes for full relative
    accuracy: below 10, -log(tanh(x/2)); from 10 up,
    ``log1p(e^-x) - log1p(-e^-x)`` (no cancellation).
    """
    x = torch.clamp_min(x, tiny)
    ex = torch.exp(-torch.clamp_min(x, 10.0))
    big = torch.log1p(ex) - torch.log1p(-ex)
    small = -torch.log(torch.tanh(torch.clamp_max(x, 10.0) / 2.0))
    return torch.where(x < 10.0, small, big)


def minsum_extrinsic_mag(absm, axis: int):
    """Per-slot min over the OTHER slots of ``axis`` (exact, tie-correct).

    The unique argmin slot sees the second-smallest value; every other slot
    (including every slot of a tied minimum) sees the minimum.  Padded slots
    carry a large sentinel and never win the min.
    """
    big = torch.tensor(BIG, dtype=absm.dtype, device=absm.device)
    min1 = torch.amin(absm, dim=axis, keepdim=True)
    is_min = absm == min1
    cnt = torch.sum(is_min, dim=axis, keepdim=True)
    min2 = torch.amin(torch.where(is_min, big, absm), dim=axis, keepdim=True)
    return torch.where(is_min & (cnt == 1), min2, min1)


def tanhfb_extrinsic_mag(absm, axis: int):
    """Exact sum-product all-but-one magnitude via tanh forward/backward
    products: ``mag_i = 2 artanh(prod_{j!=i} tanh(absm_j / 2))``.

    With e_j = exp(-x_j), u_i = P_i/Q_i for P_i = prod_{j!=i}(1-e_j) and
    Q_i = prod_{j!=i}(1+e_j), and 2 artanh(u_i) = log((Q_i+P_i)/(Q_i-P_i)).
    The (Q-P) floor saturates the output near -log(6e-8) ~= 16.6.  Padded
    slots carry a large sentinel, so tanh -> 1 is the neutral element.
    """
    x = torch.movedim(absm, axis, 0)
    dc = x.shape[0]
    if dc == 1:
        # empty all-but-one product: the neutral element u = 1, saturated
        return torch.movedim(torch.full_like(x, TANHFB_SAT), 0, axis)
    e = torch.exp(-x)
    pm = [1.0 - e[d] for d in range(dc)]
    qm = [1.0 + e[d] for d in range(dc)]
    P = torch.stack(fb_allbutone_list(pm)[0])
    Q = torch.stack(fb_allbutone_list(qm)[0])
    mag = torch.log((Q + P) / torch.maximum(Q - P, 6e-8 * Q))
    return torch.movedim(mag, 0, axis)


def fb_allbutone_list(terms):
    """All-but-one products of a list of same-shape tensors via serial
    forward/backward prefix chains (the P/Q product order every tanh-F/B
    path shares).

    Returns ``(allbutone, full)``: ``allbutone[i] = prod_{j != i} terms[j]``
    (length-1 input gives the neutral ``[ones]``) and
    ``full = prod_j terms[j]``.
    """
    n = len(terms)
    if n == 1:
        return [torch.ones_like(terms[0])], terms[0]
    F = [terms[0]]
    for d in range(1, n):
        F.append(F[-1] * terms[d])
    Bk = [terms[n - 1]]
    for d in range(n - 2, -1, -1):
        Bk.append(Bk[-1] * terms[d])
    Bk = Bk[::-1]
    out = [Bk[1]] + [F[d - 1] * Bk[d + 1] for d in range(1, n - 1)] \
        + [F[n - 2]]
    return out, F[n - 1]


def _sm_prepare(v2c_d, c_mask_T):
    """bf16 upcast to f32 (the magnitude math runs in f32) and the mask
    broadcast over frames; returns ``(v2c, mask, out_dtype)`` with the mask
    [dc, C, 1] (slot-major) or [C, dc, 1] (check-major)."""
    out_dtype = v2c_d.dtype
    c_mask_T = torch.as_tensor(c_mask_T, device=v2c_d.device)
    if out_dtype == torch.bfloat16:
        v2c_d = v2c_d.float()
    return v2c_d, c_mask_T.to(v2c_d.dtype)[:, :, None], out_dtype


def _sm_finish(v2c_d, synd, mask, mag, out_dtype, dim: int = 0):
    """Sign parity over the real slots of ``dim``, the (1 - 2*synd)
    prefactor, the mask, cast back to the message dtype."""
    neg = ((v2c_d < 0) & (mask > 0)).to(torch.int32)
    parity = torch.sum(neg, dim=dim, keepdim=True) & 1
    sign = (1 - 2 * torch.bitwise_xor(parity, neg)).to(v2c_d.dtype)
    pref = (1 - 2 * synd.to(torch.int32)).to(v2c_d.dtype).unsqueeze(dim)
    return (sign * pref * mag * mask).to(out_dtype)


def check_node_update(v2c_c, synd, c_mask, tiny: float = 1e-30):
    """Check-major phi sum-product check update: layout [C, dc_max, B],
    mask [C, dc_max] (1 on real slots, 0 on padding), syndrome [C, B].

    Returns the extrinsic check->variable messages with the ``(-1)^synd``
    prefactor, zero on padded slots, in the input dtype (bf16 computes in
    f32).
    """
    v2c_c, mask, out_dtype = _sm_prepare(v2c_c, c_mask)
    phim = phi_llr(torch.abs(v2c_c), tiny) * mask
    s_phi = torch.sum(phim, dim=1, keepdim=True)
    mag = phi_llr(s_phi - phim, tiny)
    return _sm_finish(v2c_c, synd, mask, mag, out_dtype, 1)


def check_node_minsum(v2c_c, synd, c_mask, alpha: float = MINSUM_ALPHA,
                      beta: float = 0.0):
    """Check-major normalized/offset min-sum check update (same contract as
    :func:`check_node_update`; padded slots ride the +1e30 sentinel)."""
    v2c_c, mask, out_dtype = _sm_prepare(v2c_c, c_mask)
    absm = torch.where(mask > 0, torch.abs(v2c_c),
                       torch.tensor(BIG, dtype=v2c_c.dtype,
                                    device=v2c_c.device))
    mag = minsum_mag(minsum_extrinsic_mag(absm, 1), alpha, beta)
    return _sm_finish(v2c_c, synd, mask, mag, out_dtype, 1)


def var_node_update(prior, c2v_v, v_mask):
    """Variable-node update in var-major layout: prior [V, B], incoming
    c2v_v [V, dv_max, B], v_mask [V, dv_max].  Returns ``(total [V, B],
    v2c_v [V, dv_max, B])`` with ``total = prior + sum of incoming`` (padded
    slots masked to 0) and the extrinsics ``v2c = total - incoming``."""
    v_mask = torch.as_tensor(v_mask, dtype=c2v_v.dtype, device=c2v_v.device)
    c2v_v = c2v_v * v_mask[:, :, None]
    total = prior + torch.sum(c2v_v, dim=1)
    return total, total[:, None, :] - c2v_v


def check_node_update_sm(v2c_d, synd, c_mask_T, tiny: float = 1e-30):
    """Slot-major phi sum-product check update: layout [dc_max, C, B],
    mask [dc_max, C] (1 on real slots, 0 on padding), syndrome [C, B].

    Returns the extrinsic check->variable messages with the ``(-1)^synd``
    prefactor, zero on padded slots, in the input dtype (bf16 computes in
    f32).
    """
    v2c_d, mask, out_dtype = _sm_prepare(v2c_d, c_mask_T)
    phim = phi_llr(torch.abs(v2c_d), tiny) * mask
    s_phi = torch.sum(phim, dim=0, keepdim=True)
    mag = phi_llr(s_phi - phim, tiny)
    return _sm_finish(v2c_d, synd, mask, mag, out_dtype)


def check_node_minsum_sm(v2c_d, synd, c_mask_T,
                         alpha: float = MINSUM_ALPHA, beta: float = 0.0):
    """Slot-major normalized/offset min-sum check update (same contract as
    :func:`check_node_update_sm`; padded slots ride the +1e30 sentinel)."""
    v2c_d, mask, out_dtype = _sm_prepare(v2c_d, c_mask_T)
    absm = torch.where(mask > 0, torch.abs(v2c_d),
                       torch.tensor(BIG, dtype=v2c_d.dtype,
                                    device=v2c_d.device))
    mag = minsum_mag(minsum_extrinsic_mag(absm, 0), alpha, beta)
    return _sm_finish(v2c_d, synd, mask, mag, out_dtype)


def check_node_tanhfb_sm(v2c_d, synd, c_mask_T):
    """Slot-major tanh-F/B sum-product check update (same contract as
    :func:`check_node_update_sm`; saturates near 16.6)."""
    v2c_d, mask, out_dtype = _sm_prepare(v2c_d, c_mask_T)
    absm = torch.where(mask > 0, torch.abs(v2c_d),
                       torch.tensor(BIG, dtype=v2c_d.dtype,
                                    device=v2c_d.device))
    mag = tanhfb_extrinsic_mag(absm, 0)
    return _sm_finish(v2c_d, synd, mask, mag, out_dtype)


def stochastic_round_bf16(x_f32, rbits):
    """Stochastically round float32 values to bfloat16.

    bfloat16 is the top 16 bits of the float32 pattern, so adding a uniform
    random 16-bit integer to the pattern and truncating the low half rounds
    x to one of its two bf16 neighbours with probability proportional to
    proximity: unbiased in expectation (within an exponent window the
    value is affine in the pattern; a carry across a window boundary lands
    on the right neighbour).  Bit-equal to the JAX package's
    ``stochastic_round_bf16`` for the same bits.

    Args:
      x_f32: float32 tensor (finite: the pattern sum then stays inside
        int32, whose two's-complement arithmetic is the JAX version's
        uint32 arithmetic).
      rbits: int32 or int64 random bits, same shape; only the low 16 bits
        are read.

    Returns the stochastically rounded values as bfloat16.
    """
    b = x_f32.to(torch.float32).contiguous().view(torch.int32)
    low = (rbits & 0xFFFF).to(torch.int32)
    y = (b + low) & -0x10000               # & 0xFFFF0000 as int32
    return y.view(torch.float32).to(torch.bfloat16)
