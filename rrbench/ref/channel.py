"""Shaped PAM symbols and their AWGN samples, drawn from a round's seed.

Frozen copy of ``round_generator``, ``_bf16_normal_table``, ``bf16_normal``
and ``_sample_sb`` of ``qamreconciliation_tpu_torch/sims/engine.py`` and of
``PAMAlphabet`` (``models/alphabet.py``) and ``generate_table_s_to_b``
(``models/bicm.py``) at commit bdbe956: the same torch calls on the same
generator, so the same seed gives the same symbols and noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gray_table(bps: int) -> np.ndarray:
    """[2**bps, bps] uint8: bit k of the Gray code of each symbol index."""
    s = np.arange(1 << bps, dtype=np.int64)
    gray = s ^ (s >> 1)
    k = np.arange(bps, dtype=np.int64)
    return ((gray[:, None] >> k[None, :]) & 1).astype(np.uint8)


class Pam:
    """Uniform M-PAM: constellation ``(i - (M-1)/2) * step``, its energy,
    decision thresholds (interior midpoints, sentinels at 100x the edge
    points) and Gray labels."""

    def __init__(self, bps: int, step: float):
        self.bps = int(bps)
        self.order = 1 << self.bps
        self.step = float(step)
        self.p = np.full(self.order, 1.0 / self.order)
        self.c = (np.arange(self.order, dtype=np.float64)
                  - (self.order - 1) / 2) * self.step
        self.variance = float(np.sum(self.p * np.abs(self.c) ** 2))
        thr = np.empty(self.order + 1)
        thr[1:self.order] = self.c[1:] - self.step / 2
        thr[0] = self.c[0] * 100
        thr[-1] = self.c[-1] * 100
        self.thr = thr
        self.s_to_b = gray_table(self.bps)
        self.cum_p = np.concatenate([[0.0], np.cumsum(self.p)])

    def noise_var(self, snr_dB: float) -> float:
        """N0 per real dimension at Es/N0 ``snr_dB``."""
        return self.variance * (10.0 ** (-snr_dB / 10.0)) / 2.0


def round_generator(seed: int, r: int, device) -> torch.Generator:
    """The generator of round ``r`` of a point seeded ``seed``."""
    state = np.random.SeedSequence([int(seed), int(r)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _bf16_normal_table() -> torch.Tensor:
    """The 128 values of a bf16 normal draw by its 7 random mantissa bits:
    ``sqrt(2) * erfinv(u)`` for the bf16 uniform ``u`` on [nextafter(-1,
    0), 1), each rounding in bf16 (float32 values on the host)."""
    bf = torch.bfloat16
    m = torch.arange(128, dtype=torch.int32)
    u = (m | 0x3F80).to(torch.int16).view(bf) - torch.tensor(1.0, dtype=bf)
    lo = torch.tensor(-1.0 + 2.0 ** -8, dtype=bf)
    hi = torch.tensor(1.0, dtype=bf)
    u = torch.maximum(lo, u * (hi - lo) + lo)
    e = torch.erfinv(u.float()).to(bf)
    return (torch.tensor(math.sqrt(2.0), dtype=bf) * e).float()


class Sampler:
    """Draws a round's symbols x [S, B] (int32) and samples y (``dtype``):
    symbols from float32 uniforms by the inverse CDF, then the noise by
    the 128-value bf16 draw."""

    def __init__(self, pam: Pam, dtype, device):
        self.pam, self.dtype, self.device = pam, dtype, device
        self.normal = _bf16_normal_table().to(device)
        self.values = torch.as_tensor(pam.c, dtype=dtype, device=device)

    def draw(self, generator, shape, sigma: float):
        u = torch.rand(shape, generator=generator, device=self.device,
                       dtype=torch.float32)
        x = torch.zeros(u.shape, dtype=torch.int32, device=self.device)
        for c in self.pam.cum_p[1:-1]:
            x += u >= torch.tensor(c, dtype=torch.float32)
        idx = torch.randint(0, 128, tuple(shape), generator=generator,
                            device=self.device)
        noise = self.normal[idx].to(torch.bfloat16)
        y = self.values[x.long()] + torch.tensor(sigma, dtype=self.dtype) \
            * noise
        return x, y
