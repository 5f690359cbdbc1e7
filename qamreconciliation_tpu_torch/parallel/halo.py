"""Roll windows of the z-sharded QC decoder: what each rank sends, and to whom.

``ShardedQCDecoder`` splits the circulant lane axis z over ``world`` ranks:
rank r holds the lanes ``L_r = [r * z / D, (r + 1) * z / D)`` of every
block's totals and messages.  A circulant roll then reads lanes that other
ranks hold, and only those lanes move:

* check side: ``t[cb, d, j] = total[vb, (j - s) % z]`` for each edge
  ``(cb, d) -> (vb, s)`` and j in ``L_r``; for each variable block, rank r
  needs the union over its edges of those lanes that lie in ``L_q``, from
  each peer q;
* variable side: variable lane i in ``L_r`` sums the messages
  ``c2v[cb, d, (i + s) % z]`` of its edges in (cb, slot) order; for each
  edge, rank r needs those of its lanes that lie in ``L_q``.

:func:`roll_plan` works both out once, from the check blocks' (vb, shift)
rows, as index tensors: the rows each peer is sent (the mirror image of
what that peer needs), the rows received from each, and the gather and
fold indices into the table of local rows followed by the received ones in
rank order.  It is a pure function, so one process can play every rank.
Each variable lane folds exact copies of its messages in the single-device
order, so the sums are bit-equal to ``QCDecoder.scatter_partials``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.qc_decoder import fold_incoming
from ..ops.boxplus import BIG

__all__ = ["RollPlan", "roll_plan"]


@dataclass
class RollPlan:
    """Rank ``rank``'s roll windows (see :func:`roll_plan`).

    ``totals_send[q]`` / ``messages_send[q]``: rows of this rank's flat
    totals ``[nb_v * zl]`` / messages ``[nb_c * dc * zl]`` that peer q
    needs, in the order q reads them; ``totals_recv[q]`` /
    ``messages_recv[q]``: the rows received from q.  Peers with nothing to
    move are absent.  ``gather_idx`` [nb_c * dc * zl] indexes the table of
    the local totals, the received rows in rank order and one sentinel
    row; ``fold_groups`` the table of the local messages and the received
    rows, as ``QCDecoder._scatter_groups`` indexes the full messages.
    """

    world: int
    rank: int
    z: int
    nb_v: int
    nb_c: int
    dc: int
    totals_send: dict
    totals_recv: dict
    messages_send: dict
    messages_recv: dict
    gather_idx: torch.Tensor
    fold_groups: list

    @property
    def lanes(self) -> tuple:
        zl = self.z // self.world
        return self.rank * zl, (self.rank + 1) * zl

    def received(self) -> tuple:
        """(check-side rows, variable-side rows) this rank receives an
        iteration; times the frames B, the elements."""
        return sum(self.totals_recv.values()), sum(self.messages_recv.values())

    def all_gather_rows(self) -> int:
        """The rows of messages an all-gather of every rank's messages
        brings this rank: (world - 1) * nb_c * dc * zl."""
        return (self.world - 1) * self.nb_c * self.dc * (self.z // self.world)

    @staticmethod
    def _pack(local, send):
        flat = local.reshape(-1, local.shape[-1])
        return {q: flat.index_select(0, idx) for q, idx in send.items()}

    def pack_totals(self, total) -> dict:
        """This rank's totals [nb_v, zl, B] -> {peer: rows [n, B]}."""
        return self._pack(total, self.totals_send)

    def pack_messages(self, c2v) -> dict:
        """This rank's messages [nb_c, dc, zl, B] -> {peer: rows [n, B]}."""
        return self._pack(c2v, self.messages_send)

    def check_inputs(self, total, recvs):
        """Local totals [nb_v, zl, B] and the rows received from each peer
        -> the check phase's t [nb_c, dc, zl, B], padded slots holding the
        +1e30 sentinel."""
        B = total.shape[-1]
        table = torch.cat([
            total.reshape(-1, B), *(recvs[q] for q in sorted(recvs)),
            torch.full((1, B), BIG, dtype=total.dtype, device=total.device)])
        return table.index_select(0, self.gather_idx).view(
            self.nb_c, self.dc, self.z // self.world, B)

    def var_sums(self, c2v, recvs, sum_dtype):
        """Local messages [nb_c, dc, zl, B] and the rows received from each
        peer -> each of this rank's variable lanes' message sum [nb_v, zl,
        B] in ``sum_dtype``, folded in (cb, slot) order."""
        B = c2v.shape[-1]
        table = torch.cat([c2v.reshape(-1, B),
                           *(recvs[q] for q in sorted(recvs))])
        return fold_incoming(table, self.fold_groups, self.nb_v, sum_dtype)


def _totals_need(rows, nb_v, z, lanes):
    """[nb_v, z] bool: the totals' lanes that checks on ``lanes`` read."""
    need = np.zeros((nb_v, z), bool)
    for row in rows:
        for v, s in row:
            need[v, (lanes - s) % z] = True
    return need


def _messages_need(rows, dc, z, lanes):
    """[nb_c, dc, z] bool: the messages' lanes that variables on ``lanes``
    fold."""
    need = np.zeros((len(rows), dc, z), bool)
    for cb, row in enumerate(rows):
        for d, (_, s) in enumerate(row):
            need[cb, d, (lanes + s) % z] = True
    return need


def _windows(need_of, world, rank, zl, device):
    """(send, recv, pos): the local rows each peer needs, the rows each
    peer sends, and each lane's row in the table of the local rows and the
    received ones in rank order (-1 where this rank reads nothing)."""
    mine = need_of(rank)
    lead = mine.shape[:-1]
    pos = np.full(mine.shape, -1, np.int64)
    n_local = int(np.prod(lead)) * zl
    pos[..., rank * zl:(rank + 1) * zl] = np.arange(n_local).reshape(
        *lead, zl)
    send, recv, off = {}, {}, n_local
    for q in range(world):
        if q == rank:
            continue
        theirs = np.flatnonzero(need_of(q)[..., rank * zl:(rank + 1) * zl])
        if theirs.size:
            send[q] = torch.as_tensor(theirs, device=device)
        rows = np.flatnonzero(mine[..., q * zl:(q + 1) * zl])
        if rows.size:
            recv[q] = int(rows.size)
            window = np.full(lead + (zl,), -1, np.int64)
            window.reshape(-1)[rows] = off + np.arange(rows.size)
            pos[..., q * zl:(q + 1) * zl] = window
            off += rows.size
    return send, recv, pos


def roll_plan(rows, z: int, world: int, rank: int, device="cpu") -> RollPlan:
    """Rank ``rank``'s roll windows among ``world`` ranks.

    ``rows`` are the check blocks' ``[(vb, shift), ...]`` in slot order
    (``QCDecoder._rows``), ``z`` the circulant size, which ``world`` must
    divide.  The index tensors are built once, on ``device``.
    """
    z, world, rank = int(z), int(world), int(rank)
    if z % world:
        raise ValueError(f"z={z} must be divisible by the mesh size {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a mesh of {world}")
    zl = z // world
    nb_c = len(rows)
    dc = max(len(row) for row in rows)
    nb_v = 1 + max(v for row in rows for v, _ in row)

    def lanes(p):
        return np.arange(p * zl, (p + 1) * zl)

    t_send, t_recv, t_pos = _windows(
        lambda p: _totals_need(rows, nb_v, z, lanes(p)), world, rank, zl,
        device)
    m_send, m_recv, m_pos = _windows(
        lambda p: _messages_need(rows, dc, z, lanes(p)), world, rank, zl,
        device)

    j = lanes(rank)
    sentinel = nb_v * zl + sum(t_recv.values())
    gidx = np.full((nb_c, dc, zl), sentinel, np.int64)
    incoming = [[] for _ in range(nb_v)]
    for cb, row in enumerate(rows):
        for d, (v, s) in enumerate(row):
            gidx[cb, d] = t_pos[v, (j - s) % z]
            incoming[v].append(m_pos[cb, d, (j + s) % z])
    by_deg = {}
    for v, parts in enumerate(incoming):
        if parts:
            by_deg.setdefault(len(parts), []).append(v)
    groups = [(torch.as_tensor(vbs, device=device),
               torch.as_tensor(np.stack([np.stack(incoming[v]) for v in vbs])
                               .reshape(-1), device=device), deg)
              for deg, vbs in sorted(by_deg.items())]
    return RollPlan(world, rank, z, nb_v, nb_c, dc, t_send, t_recv, m_send,
                    m_recv, torch.as_tensor(gidx.reshape(-1), device=device),
                    groups)
