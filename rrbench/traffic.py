"""The one generator of the benchmark's traffic mixes.

A mix (``rrbench/traffic/<name>.json``) is data: ``mode`` (a module of
``rrbench/modes/``), ``snr_dB`` (Es/N0 of every point) and
``frames_per_point``.  The loop is closed: one sweep point at a time, the
next when the last is done.  Every point runs its whole frame budget (no
early exit) with the LLRs unscaled.  Each point draws its frames from a
seed of its own, derived from the run's ``--seed`` and the point's index,
so the same seed gives the same points.
"""

from __future__ import annotations

import numpy as np

ALPHA = 1.0     # the softening LLRs' scale


class Mix:
    def __init__(self, spec: dict):
        self.mode = spec["mode"]
        self.snr_dB = float(spec["snr_dB"])
        self.frames = int(spec["frames_per_point"])
        # more frame errors than a point has frames: no early exit
        self.ferr_count_min = self.frames + 1

    @staticmethod
    def _seed(seed: int, *path: int) -> int:
        ss = np.random.SeedSequence([int(seed) % 2 ** 64, *path])
        return int(ss.generate_state(1, np.uint64)[0])

    def point_seed(self, seed: int, i: int) -> int:
        """The seed of point ``i`` of a run seeded ``seed``."""
        return self._seed(seed, 0, int(i))

    def warm_seed(self, seed: int) -> int:
        """The seed of the set-up's warm point (never a timed point's)."""
        return self._seed(seed, 1)

    def sample_rng(self, seed: int) -> np.random.Generator:
        """The generator of the rounds the reference checks."""
        return np.random.default_rng(self._seed(seed, 2))
