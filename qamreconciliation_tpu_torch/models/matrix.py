"""Parity-check matrix and syndrome evaluation, on the decoder's graph
metadata: a syndrome is a gather plus a masked popcount (no scatters)."""

from __future__ import annotations

import numpy as np
import torch

from .decoder import TannerGraph

__all__ = ["Matrix"]


class Matrix:
    """Edge-list parity-check matrix ``Matrix(vnode_array, cnode_array)``;
    node counts are ``max(id) + 1``."""

    def __init__(self, vnode_array, cnode_array):
        vid = np.asarray(vnode_array, dtype=np.int64).reshape(-1)
        cid = np.asarray(cnode_array, dtype=np.int64).reshape(-1)
        if vid.shape[0] != cid.shape[0]:
            raise ValueError("Incompatible sizes for input vectors")
        self.graph = TannerGraph(vid, cid)
        self.vnum = self.graph.vnum
        self.cnum = self.graph.cnum
        self.ednum = self.graph.ednum

    def eval_syndrome(self, word):
        """Syndrome of hard bits: word [..., V] (0/1) -> [..., C] uint8, the
        XOR of each check's variables, on the word's device."""
        word = torch.as_tensor(word)
        batch_shape = word.shape[:-1]
        bits = word.reshape(-1, self.vnum).T.to(torch.int32)      # [V, B]
        synd = self.graph.syndrome_from_bits(bits)                # [C, B]
        return synd.T.reshape(*batch_shape, self.cnum).to(torch.uint8)
