"""Edge-list parity-check matrix (the engine reads its sizes)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Matrix"]


class Matrix:
    """Edge-list parity-check matrix ``Matrix(vnode_array, cnode_array)``;
    node counts are ``max(id) + 1``."""

    def __init__(self, vnode_array, cnode_array):
        vid = np.asarray(vnode_array, dtype=np.int64).reshape(-1)
        cid = np.asarray(cnode_array, dtype=np.int64).reshape(-1)
        if vid.shape[0] != cid.shape[0]:
            raise ValueError("Incompatible sizes for input vectors")
        self.vid, self.cid = vid, cid
        self.vnum = int(vid.max()) + 1
        self.cnum = int(cid.max()) + 1

    def eval_syndrome(self, word):
        """Syndrome of hard bits: word [..., V] (0/1) -> [..., C] uint8, the
        XOR of each check's variables (integer sums, exact)."""
        word = torch.as_tensor(word)
        batch_shape = word.shape[:-1]
        bits = word.reshape(-1, self.vnum).T.to(torch.int32)      # [V, B]
        vid = torch.as_tensor(self.vid, device=bits.device)
        cid = torch.as_tensor(self.cid, device=bits.device)
        synd = torch.zeros((self.cnum, bits.shape[1]), dtype=torch.int32,
                           device=bits.device)
        synd.index_add_(0, cid, bits.index_select(0, vid))
        return (synd & 1).T.reshape(*batch_shape, self.cnum).to(torch.uint8)
