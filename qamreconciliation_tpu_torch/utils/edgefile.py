"""LDPC edge-list IO and code construction (numpy only).

An LDPC code is a CSV with columns ``eid,cid,vid``; by convention the first
data row holds the totals ``(edge_num, cnode_num, vnode_num)`` and real
edges start at row 2.  A copy of ``qamreconciliation_tpu.utils.edgefile``
with the numpy parser only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_edge_csv", "save_edge_csv", "make_regular_ldpc"]


def load_edge_csv(path: str, num_data_first_row: bool = True):
    """Load an edge-list CSV -> ``(vid, cid)`` int64 arrays.

    When ``num_data_first_row`` is True the first data row carries
    ``(edge_num, cnode_num, vnode_num)`` and is skipped.
    """
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64,
                      ndmin=2)
    eid, cid, vid = data[:, 0], data[:, 1].copy(), data[:, 2].copy()
    if num_data_first_row:
        declared_e = int(eid[0])
        vid, cid = vid[1:], cid[1:]
        if declared_e != vid.size:
            raise ValueError(
                f"edge file declares {declared_e} edges but contains "
                f"{vid.size}"
            )
    return vid, cid


def save_edge_csv(path: str, vid, cid, num_data_first_row: bool = True):
    """Write an edge-list CSV in the shared format (first row = totals)."""
    vid = np.asarray(vid, dtype=np.int64)
    cid = np.asarray(cid, dtype=np.int64)
    e = vid.size
    c = int(cid.max()) + 1
    v = int(vid.max()) + 1
    lines = ["eid,cid,vid"]
    if num_data_first_row:
        lines.append(f"{e},{c},{v}")
    lines.extend(f"{i},{cid[i]},{vid[i]}" for i in range(e))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def make_regular_ldpc(
    n: int, dv: int = 3, dc: int = 6, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Random (dv, dc)-regular LDPC Tanner graph -> ``(vid, cid)``.

    Socket-permutation (configuration-model) construction with double-edge
    repair.  Rate = 1 - dv/dc.
    """
    if (n * dv) % dc != 0:
        raise ValueError("n*dv must be divisible by dc")
    m = n * dv // dc
    rng = np.random.default_rng(seed)

    vid = np.repeat(np.arange(n, dtype=np.int64), dv)
    cid = np.repeat(np.arange(m, dtype=np.int64), dc)
    E = vid.size

    v = vid[rng.permutation(E)]
    # Repair duplicate (v, c) pairs by swapping offending sockets with random
    # partners until the multigraph is simple.
    for _ in range(1000):
        key = v * np.int64(m) + cid
        order = np.argsort(key, kind="stable")
        dup_sorted = np.zeros(E, dtype=bool)
        dup_sorted[1:] = key[order][1:] == key[order][:-1]
        dup = np.zeros(E, dtype=bool)
        dup[order] = dup_sorted
        if not dup.any():
            return v, cid.copy()
        idx = np.flatnonzero(dup)
        partners = rng.integers(0, E, size=idx.size)
        tmp = v[idx].copy()
        v[idx] = v[partners]
        v[partners] = tmp
    raise RuntimeError("failed to build a simple regular graph")
