"""Check-node messages of the tanh forward/backward sum-product rule.

Frozen copy of ``tanhfb_extrinsic_mag`` and ``fb_allbutone_list``
(``qamreconciliation_tpu_torch/ops/boxplus.py``) and of ``_fold_sum``,
``_check_messages``, ``_signed`` and ``_masked_messages``
(``ops/kernels.py``) at commit bdbe956, in the same operation and
summation order, for the one rule the configurations run.
"""

from __future__ import annotations

import math

import torch

BIG = 1e30
TANHFB_SAT = math.log1p(1.0 - 6e-8) - math.log1p(-(1.0 - 6e-8))


def fold_sum(x, dim: int):
    """Left-fold sum over ``dim`` (keepdim)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.unsqueeze(dim)


def fb_allbutone(terms):
    """All-but-one products by forward and backward prefix chains."""
    n = len(terms)
    if n == 1:
        return [torch.ones_like(terms[0])]
    F = [terms[0]]
    for d in range(1, n):
        F.append(F[-1] * terms[d])
    Bk = [terms[n - 1]]
    for d in range(n - 2, -1, -1):
        Bk.append(Bk[-1] * terms[d])
    Bk = Bk[::-1]
    return [Bk[1]] + [F[d - 1] * Bk[d + 1] for d in range(1, n - 1)] \
        + [F[n - 2]]


def tanhfb_extrinsic(absm, axis: int):
    """2 artanh(prod over the other slots of tanh(|m|/2)) by the tanh
    forward/backward products, saturated near 16.6."""
    x = torch.movedim(absm, axis, 0)
    dc = x.shape[0]
    if dc == 1:
        return torch.movedim(torch.full_like(x, TANHFB_SAT), 0, axis)
    e = torch.exp(-x)
    P = torch.stack(fb_allbutone([1.0 - e[d] for d in range(dc)]))
    Q = torch.stack(fb_allbutone([1.0 + e[d] for d in range(dc)]))
    mag = torch.log((Q + P) / torch.maximum(Q - P, 6e-8 * Q))
    return torch.movedim(mag, 0, axis)


def _signed(v2c, neg, synd, dim, mag):
    """The magnitude with the XOR sign parity over ``dim`` and the (1 - 2
    synd) prefactor."""
    par = torch.sum(neg, dim=dim, keepdim=True) & 1
    sign = (1 - 2 * torch.bitwise_xor(par, neg)).to(v2c.dtype)
    pref = (1 - 2 * synd.to(torch.int32)).to(v2c.dtype).unsqueeze(dim)
    return sign * pref * mag


def messages(v2c, synd, dim: int):
    """New check->variable messages of full rows."""
    mag = tanhfb_extrinsic(torch.abs(v2c), dim)
    return _signed(v2c, (v2c < 0).to(torch.int32), synd, dim, mag)


def masked_messages(v2c, synd, mask, dim: int):
    """:func:`messages` over padded rows (``mask > 0`` marks a real
    slot): padded slots take the +1e30 sentinel, the sign parity runs over
    the real slots, and the result is masked."""
    absm = torch.where(mask > 0, torch.abs(v2c), torch.tensor(
        BIG, dtype=v2c.dtype, device=v2c.device))
    mag = tanhfb_extrinsic(absm, dim)
    neg = ((v2c < 0) & (mask > 0)).to(torch.int32)
    return _signed(v2c, neg, synd, dim, mag) * mask
