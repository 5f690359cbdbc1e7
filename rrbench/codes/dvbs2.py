"""DVB-S2 normal-frame LDPC structure (ETSI EN 302 307-1 Annex B).

Frozen copy of ``make_table`` (girth-6 conditioning, no girth-8 pass),
``_girth6_repair``, ``_staircase_cells``, ``to_qc_base(wrap="exact")`` and
``expanded_edges`` of ``qamreconciliation_tpu_torch/models/dvbs2.py`` at
commit bdbe956.  The parity addresses are synthetic: the standard's frame
structure (N, K, q, rows per degree, hence its degree profile) with random
addresses, because the Annex B rows are not in the repository.
"""

from __future__ import annotations

import numpy as np

from . import Code

Z = 360
# (rows, addresses a row) of the one frame and rate the configurations run
RATE_PROFILES = {(64800, "1/2"): [(36, 8), (54, 3)]}


def make_table(rate: str, n: int = 64800, seed: int = 0):
    """``(k, rows)``: the information length and the per-bit-group parity
    addresses, spread evenly over the q parity blocks, distinct within a
    row, and conditioned to a block-level base graph free of 4-cycles."""
    profile = RATE_PROFILES[(int(n), rate)]
    k = Z * sum(cnt for cnt, _ in profile)
    m = n - k
    q = m // Z
    degs = [deg for cnt, deg in profile for _ in range(cnt)]
    total = sum(degs)
    if total % q:
        raise AssertionError("profile/q mismatch: cannot balance blocks")
    rng = np.random.default_rng(seed)
    blocks = np.repeat(np.arange(q), total // q)
    for _ in range(1000):
        blocks = blocks[rng.permutation(total)]
        rows, pos, ok = [], 0, True
        for deg in degs:
            a = blocks[pos:pos + deg]
            b = rng.integers(0, Z, deg)
            x = a + q * b.astype(np.int64)
            for _ in range(100):
                _, first = np.unique(x, return_index=True)
                dup = np.ones(deg, bool)
                dup[first] = False
                if not dup.any():
                    break
                b[dup] = rng.integers(0, Z, int(dup.sum()))
                x = a + q * b.astype(np.int64)
            else:
                ok = False
                break
            rows.append([int(v) for v in x])
            pos += deg
        if ok:
            ok = _girth6_repair(rows, q, k // Z, rng)
        if ok:
            return k, rows
    raise RuntimeError("could not draw a duplicate-free table")


def _staircase_cells(nbi: int, q: int):
    cells = []
    for u in range(q):
        cells.append((u, nbi + u, 0))
        if u > 0:
            cells.append((u, nbi + u - 1, 0))
    cells.append((0, nbi + q - 1, 1))
    return cells


def _girth6_repair(rows, q, nbi, rng, max_passes: int = 500):
    """Redraw information-address shifts until the block-level base graph
    has no 4-cycles; rows are edited in place.  True on success."""
    for _ in range(max_passes):
        cells = [(a, v, b, None) for (a, v, b) in _staircase_cells(nbi, q)]
        for g, row in enumerate(rows):
            for idx, x in enumerate(row):
                cells.append((x % q, g, x // q, (g, idx)))
        by_a = {}
        for c in cells:
            by_a.setdefault(c[0], []).append(c)
        seen = {}
        redraw = set()
        for a, lst in by_a.items():
            for i in range(len(lst)):
                for j in range(i + 1, len(lst)):
                    (_, v1, b1, r1), (_, v2, b2, r2) = lst[i], lst[j]
                    if v1 == v2:
                        if (2 * (b1 - b2)) % Z == 0:
                            redraw.add(r1 if r1 is not None else r2)
                        continue
                    if v1 > v2:
                        (v1, b1, r1), (v2, b2, r2) = (v2, b2, r2), \
                            (v1, b1, r1)
                    key = (v1, v2, (b1 - b2) % Z)
                    prev = seen.get(key)
                    if prev is not None and prev[0] != a:
                        cand = [r for r in (r1, r2, prev[1]) if r]
                        if not cand:
                            return False
                        redraw.add(cand[0])
                    else:
                        seen[key] = (a, r1 if r1 is not None else r2)
        redraw.discard(None)
        if not redraw:
            return True
        for (g, idx) in redraw:
            x = rows[g][idx]
            a = x % q
            for _ in range(100):
                nb = int(rng.integers(0, Z))
                nx = a + q * nb
                if nx not in rows[g]:
                    rows[g][idx] = nx
                    break
    return False


def expanded_edges(n: int, k: int, rows):
    """The expanded H ``(vid, cid)`` in the blocked (quasi-cyclic) order:
    each address ``x = a + q*b`` of row ``g`` a shift-``b`` circulant in
    (check block ``a``, information block ``g``), the accumulator's
    identity staircase and its shift-1 wrap circulant, whose edge from
    check 0 to the last parity variable the standard does not have."""
    q = (n - k) // Z
    nbi = k // Z
    cells = {}
    for g, row in enumerate(rows):
        for x in row:
            key = (x % q, g, x // q)
            if key in cells:
                raise ValueError(f"duplicate circulant {key}")
            cells[key] = None
    base = sorted(cells)
    for u in range(q):
        base.append((u, nbi + u, 0))
        if u > 0:
            base.append((u, nbi + u - 1, 0))
    base.append((0, nbi + q - 1, 1))
    base.sort()
    miss_c, miss_v = 0, (nbi + q - 1) * Z + (Z - 1)
    kk = np.arange(Z, dtype=np.int64)
    vid = np.concatenate([v * Z + kk for (_, v, _) in base])
    cid = np.concatenate([c * Z + (kk + s) % Z for (c, _, s) in base])
    keep = ~((vid == miss_v) & (cid == miss_c))
    return vid[keep], cid[keep]


def build(params: dict) -> Code:
    n = int(params["n"])
    k, rows = make_table(params["rate"], n, seed=params["seed"])
    vid, cid = expanded_edges(n, k, rows)
    return Code(vid, cid)
