"""Pure-numpy reference BP decoder (host float64 oracle).

A copy of the JAX package's ``models/decoder_np.py`` (numpy only, so the
port carries it without importing that package).  Role parity with the
reference's pure-Python decoder (reference:
qamreconciliation/decoder_py.py:8-218, plotted as "Python Decoder" in
display_bsc): an independent, readable implementation of syndrome
sum-product decoding used to cross-validate the batched device decoders
and the native scalar decoder.  Uses the tanh/arctanh form of the
check update (reference: decoder_py.py:135-146) — numerically equal to the
box-plus prefix form within float64 tolerance.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DecoderNp"]


class DecoderNp:
    """Flooding sum-product syndrome decoder, numpy float64.

    Constructor mirrors ``Decoder(e_to_v, e_to_c)``; an optional
    ``num_data_first_row`` flag mirrors the reference's pure-Python decoder
    CSV convention (reference: qamreconciliation/decoder_py.py:19-29).
    """

    def __init__(self, e_to_v, e_to_c, num_data_first_row: bool = False):
        vid = np.asarray(e_to_v, dtype=np.int64).reshape(-1)
        cid = np.asarray(e_to_c, dtype=np.int64).reshape(-1)
        if num_data_first_row:
            vid, cid = vid[1:], cid[1:]
        if vid.size != cid.size:
            raise ValueError("Sizes don't match")
        self.e_to_v = vid
        self.e_to_c = cid
        self.ednum = int(vid.size)
        self.vnum = int(vid.max()) + 1
        self.cnum = int(cid.max()) + 1
        # edge lists per node, in edge-id order (the reference's table order,
        # reference: qamreconciliation/decoder.pyx:69-87)
        self._v_edges = [np.flatnonzero(vid == v) for v in range(self.vnum)]
        self._c_edges = [np.flatnonzero(cid == c) for c in range(self.cnum)]

    def eval_syndrome(self, word) -> np.ndarray:
        word = np.asarray(word).astype(np.int64).reshape(-1)
        synd = np.zeros(self.cnum, np.int64)
        np.bitwise_xor.at(synd, self.e_to_c, word[self.e_to_v] & 1)
        return synd

    def _consistent(self, llr, synd) -> bool:
        bits = (np.asarray(llr) < 0).astype(np.int64)
        return bool(np.array_equal(self.eval_syndrome(bits), synd))

    def decode(self, lappr, synd, max_iterations: int):
        """(success, iters, final_lappr) with the reference's convergence
        semantics (reference: qamreconciliation/decoder.pyx:391-436)."""
        lappr = np.asarray(lappr, np.float64).reshape(-1)
        synd = np.asarray(synd).astype(np.int64).reshape(-1)
        if lappr.size != self.vnum or synd.size != self.cnum:
            raise ValueError("input size mismatch")

        if self._consistent(lappr, synd):
            return True, 0, lappr.copy()

        v2c = lappr[self.e_to_v].copy()
        c2v = np.zeros(self.ednum)
        total = lappr.copy()
        for it in range(1, max_iterations + 1):
            # check update: 2*artanh(prod tanh(v2c/2)) excluding self,
            # syndrome prefactor (-1)^synd
            t = np.tanh(np.clip(v2c / 2.0, -19.0, 19.0))
            for c in range(self.cnum):
                e = self._c_edges[c]
                prod = np.prod(t[e])
                pref = -1.0 if synd[c] else 1.0
                with np.errstate(divide="ignore"):
                    ext = prod / t[e]
                c2v[e] = pref * 2.0 * np.arctanh(np.clip(ext, -1 + 1e-16, 1 - 1e-16))
            # variable update
            for v in range(self.vnum):
                e = self._v_edges[v]
                tot = lappr[v] + c2v[e].sum()
                total[v] = tot
                v2c[e] = tot - c2v[e]
            if self._consistent(total, synd):
                return True, it, total.copy()
        return False, max_iterations, total.copy()
