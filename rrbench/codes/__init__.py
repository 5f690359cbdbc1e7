"""Parity-check codes the benchmark builds and hands to both sides.

A configuration's ``code`` names a module of this package by its ``kind``;
the module's ``build(params)`` returns a :class:`Code`.  A new construction
is a new module here, found by name.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np


@dataclass
class Code:
    """An expanded edge list ``(vid, cid)`` (edge ``e`` joins variable
    ``vid[e]`` and check ``cid[e]``), and for a quasi-cyclic code its
    base edges ``[(check_block, var_block, shift), ...]`` and circulant
    size ``z``."""

    vid: np.ndarray
    cid: np.ndarray
    base_edges: list | None = None
    z: int | None = None

    @property
    def vnum(self) -> int:
        return int(self.vid.max()) + 1

    @property
    def cnum(self) -> int:
        return int(self.cid.max()) + 1


def build(spec: dict) -> Code:
    """The code of a configuration's ``code`` entry (``kind`` and the
    construction's parameters)."""
    params = dict(spec)
    kind = params.pop("kind")
    return importlib.import_module(f"{__name__}.{kind}").build(params)
