"""Random (dv, dc)-regular quasi-cyclic LDPC code.

Frozen copy of ``make_qc_ldpc`` and ``_expand`` of
``qamreconciliation_tpu_torch/models/qc_decoder.py`` at commit bdbe956, so
the benchmark builds the code without the program's constructor.
"""

from __future__ import annotations

import numpy as np

from . import Code


def make_qc_ldpc(nb_v: int, z: int, dv: int = 3, dc: int = 6, seed: int = 0):
    """Base edges ``[(check_block, var_block, shift), ...]`` of a
    configuration-model (dv, dc)-regular base graph on ``nb_v`` variable
    blocks, each edge a uniform circulant shift in [0, z), repaired so that
    no two edges share (check block, var block, shift)."""
    if (nb_v * dv) % dc != 0:
        raise ValueError("nb_v*dv must be divisible by dc")
    nb_c = nb_v * dv // dc
    rng = np.random.default_rng(seed)
    vb = np.repeat(np.arange(nb_v), dv)
    cb = np.repeat(np.arange(nb_c), dc)
    vb = vb[rng.permutation(vb.size)]
    shifts = rng.integers(0, z, vb.size)
    for _ in range(1000):
        key = (cb.astype(np.int64) * nb_v + vb) * z + shifts
        _, first = np.unique(key, return_index=True)
        dup = np.ones(key.size, bool)
        dup[first] = False
        if not dup.any():
            break
        shifts[dup] = rng.integers(0, z, int(dup.sum()))
    else:
        raise RuntimeError("could not avoid duplicate circulants")
    return [(int(c), int(v), int(s)) for c, v, s in zip(cb, vb, shifts)]


def expand(base_edges, z: int):
    """Expanded ``(vid, cid)``: variable ``v*z + k`` meets check
    ``c*z + (k + s) % z``."""
    k = np.arange(z)
    vid = np.concatenate([v * z + k for (_, v, _) in base_edges])
    cid = np.concatenate([c * z + (k + s) % z for (c, _, s) in base_edges])
    return vid, cid


def build(params: dict) -> Code:
    base = make_qc_ldpc(params["nb_v"], params["z"], params["dv"],
                        params["dc"], seed=params["seed"])
    vid, cid = expand(base, params["z"])
    return Code(vid, cid, base, int(params["z"]))
