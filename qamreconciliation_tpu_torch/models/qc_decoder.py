"""Quasi-cyclic LDPC syndrome decoder: flooding and layered BP on tensors.

The parity-check matrix is a grid of z x z circulant permutations, given as
base edges ``(check_block, var_block, shift)``: variable ``vb*z + k`` meets
check ``cb*z + ((k + shift) % z)``.  The decode state keeps the JAX
package's layouts (frames last): totals ``[nb_v, z, B]``, messages
``[nb_c, dc, z, B]`` (dense path) or flat ``[E, z, B]`` (resident and
layered paths).  The decode loops of
``qamreconciliation_tpu.models.qc_decoder.QCDecoder``:

* dense flooding: the totals are gathered into the message layout once a
  decode; per iteration the fused check phase runs
  (ops/kernels.bp_check_phase_qc) and the variable pass
  (ops/kernels.bp_var_pass_qc) sums the new messages back per variable in
  a fixed order and writes the new totals into the check phase's next
  input; with ``sr_messages`` the plain check update runs instead, its
  bf16 message stores stochastically rounded, and the totals are summed
  and gathered again every iteration;
* compressed-state min-sum flooding: the messages kept as two magnitudes
  and a packed argmin/sign word per check, in plain PyTorch; both flooding
  loops run ``models/flooding.flood`` with one host read an iteration;
* resident flooding: ``resident_chunk`` iterations per call of
  ops/kernels.bp_decode_rounds_qc, with one host read per call;
* layered: serial-C sweeps over the block rows in plain PyTorch, the
  counterpart of the JAX package's XLA layered loop;
* resident layered: ``layered_chunk`` sweeps per call of
  ops/kernels.bp_layered_sweeps_qc.

Each kernel runs on the card and its plain version on the CPU.  Same
(success, iters, final) semantics as the JAX decoder; min-sum is
bit-identical to it, sum-product agrees to float rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, as_dtype
from ..ops.boxplus import (
    BIG, MINSUM_ALPHA, minsum_mag, stochastic_round_bf16,
)
from ..ops.kernels import (
    VAR_PASS_DTYPES, QCTables, bp_check_phase_qc, bp_check_phase_qc_ref,
    bp_decode_rounds_qc, bp_layered_sweeps_qc, bp_var_pass_qc, layered_sweep,
)
from ..utils.trace import span
from .flooding import flood

__all__ = ["QCDecoder", "make_qc_ldpc", "make_qc_ira", "color_disjoint_rows",
           "layered_plan", "save_qc_csv", "load_qc_csv", "detect_qc",
           "fold_incoming"]


def _all_done(done) -> bool:
    """The host read of "all done?" of a decode loop."""
    with span("rr.decoder.poll"):
        return bool(done.all())


def make_qc_ldpc(nb_v: int, z: int, dv: int = 3, dc: int = 6, seed: int = 0):
    """Random (dv, dc)-regular quasi-cyclic LDPC code.

    The base graph is a (dv, dc)-regular bipartite configuration model on
    ``nb_v`` variable blocks and ``nb_v * dv / dc`` check blocks; every base
    edge carries a uniform circulant shift in [0, z).  N = nb_v * z.

    Returns ``(base_edges, vid, cid)``: the base-edge list
    ``[(check_block, var_block, shift), ...]`` for :class:`QCDecoder` and the
    expanded edge list (edge between variable ``vb*z + k`` and check
    ``cb*z + ((k + shift) % z)`` for every k).
    """
    if (nb_v * dv) % dc != 0:
        raise ValueError("nb_v*dv must be divisible by dc")
    nb_c = nb_v * dv // dc
    rng = np.random.default_rng(seed)
    # configuration model on the base graph, repaired to avoid duplicate
    # (check_block, var_block, shift) triples (parallel circulants with the
    # same shift would cancel)
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
        raise RuntimeError(
            "could not avoid duplicate circulants (parallel base edges with "
            "equal shifts cancel mod 2); increase z or reduce dv/dc"
        )
    base_edges = [(int(c), int(v), int(s)) for c, v, s in zip(cb, vb, shifts)]
    vid, cid = _expand(base_edges, z)
    return base_edges, vid, cid


def make_qc_ira(nb_info: int, nb_acc: int, z: int, dv: int = 3,
                seed: int = 0):
    """Irregular QC-IRA code: configuration-model information part plus a
    circulant staircase accumulator.

    ``nb_info`` information variable blocks of degree ``dv`` (uniform-shift
    circulants onto random check blocks, duplicate-repaired like
    :func:`make_qc_ldpc`) and ``nb_acc`` parity blocks: check block i
    carries ``I + P^1`` on parity block i (two base edges in one cell,
    shifts {0, 1}) and ``I`` on parity block i-1.  Check-block degrees are
    irregular.  Returns ``(base_edges, vid, cid)`` as :func:`make_qc_ldpc`.
    """
    if nb_acc < 2:
        raise ValueError("need nb_acc >= 2 for a staircase accumulator")
    rng = np.random.default_rng(seed)
    vb = np.repeat(np.arange(nb_info), dv)
    vb = vb[rng.permutation(vb.size)]
    cb = rng.integers(0, nb_acc, vb.size)
    shifts = rng.integers(0, z, vb.size)
    for _ in range(1000):
        key = (cb.astype(np.int64) * nb_info + vb) * z + shifts
        _, first = np.unique(key, return_index=True)
        dup = np.ones(key.size, bool)
        dup[first] = False
        if not dup.any():
            break
        shifts[dup] = rng.integers(0, z, int(dup.sum()))
        cb[dup] = rng.integers(0, nb_acc, int(dup.sum()))
    else:
        raise RuntimeError("could not avoid duplicate circulants")
    base_edges = [(int(c), int(v), int(s)) for c, v, s in zip(cb, vb, shifts)]
    for i in range(nb_acc):
        p = nb_info + i
        base_edges.append((i, p, 0))
        base_edges.append((i, p, 1))          # I + P^1 cell
        if i > 0:
            base_edges.append((i, nb_info + i - 1, 0))
    base_edges.sort()
    vid, cid = _expand(base_edges, z)
    return base_edges, vid, cid


def fold_incoming(flat, groups, nb_v: int, sum_dtype):
    """Each variable lane's messages, left-folded in (cb, slot) order.

    ``flat`` [rows, B] holds the messages; ``groups`` lists ``(vbs, idx,
    deg)``: variable blocks of degree ``deg`` and the rows of their
    messages, ``[len(vbs), deg, lanes]`` flattened, in (cb, slot) order.
    Returns ``[nb_v, lanes, B]`` in ``sum_dtype``, zero for blocks without
    messages.  No atomics, so the sum is deterministic."""
    B = flat.shape[-1]
    acc = None
    for vbs, idx, deg in groups:
        g = flat.index_select(0, idx).view(len(vbs), deg, -1, B)
        g = g.to(sum_dtype)
        s = g[:, 0]
        for i in range(1, deg):
            s = s + g[:, i]
        if len(groups) == 1 and len(vbs) == nb_v:
            return s
        if acc is None:
            acc = torch.zeros((nb_v, s.shape[1], B), dtype=sum_dtype,
                              device=flat.device)
        acc.index_copy_(0, vbs, s)
    return acc


def color_disjoint_rows(rows):
    """Greedy first-fit coloring of block rows: rows sharing a variable
    block get different colors, so the rows of one color touch pairwise
    disjoint variable blocks and their layered updates commute exactly.

    Returns a list of colors, each a list of row indices (ascending).
    """
    colors = []          # [(touched_vb_set, [row_idx, ...]), ...]
    for cb, row in enumerate(rows):
        vbs = {v for (v, _) in row}
        for used, members in colors:
            if not (used & vbs):
                used |= vbs
                members.append(cb)
                break
        else:
            colors.append((set(vbs), [cb]))
    return [members for _, members in colors]


def layered_plan(rows):
    """``(degree, [row_idx...])`` batches of the grouped layered sweep: the
    :func:`color_disjoint_rows` colors split by row degree.  Their
    concatenation is the equivalent serial row order."""
    plan = []
    for members in color_disjoint_rows(rows):
        by_deg = {}
        for cb in members:
            by_deg.setdefault(len(rows[cb]), []).append(cb)
        for dcr, cbs in sorted(by_deg.items()):
            plan.append((dcr, cbs))
    return plan


def _expand(base_edges, z: int):
    """Expanded ``(vid, cid)`` edge list of a base-edge list."""
    k = np.arange(z)
    vid = np.concatenate([v * z + k for (_, v, _) in base_edges])
    cid = np.concatenate([c * z + (k + s) % z for (c, _, s) in base_edges])
    return vid, cid


def save_qc_csv(path: str, base_edges, z: int):
    """Write a QC base-edge CSV: header ``eid,cb,vb,shift``, first data row
    carries the totals ``(n_base_edges, z, nb_c, 0)``."""
    nb_c = max(c for c, _, _ in base_edges) + 1
    lines = ["eid,cb,vb,shift", f"{len(base_edges)},{z},{nb_c},0"]
    lines.extend(
        f"{i},{c},{v},{s}" for i, (c, v, s) in enumerate(base_edges)
    )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_qc_csv(path: str):
    """Load a QC base-edge CSV -> ``(base_edges, z)``."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    declared_e, z = int(data[0, 0]), int(data[0, 1])
    rows = data[1:]
    if rows.shape[0] != declared_e:
        raise ValueError(
            f"QC file declares {declared_e} base edges but contains "
            f"{rows.shape[0]}"
        )
    base_edges = [(int(c), int(v), int(s)) for _, c, v, s in rows]
    return base_edges, z


def detect_qc(vid, cid, z: int | None = None):
    """Detect quasi-cyclic structure in an expanded edge list.

    Real LDPC standards (DVB-S2, 5G NR, 802.11) are quasi-cyclic, but they
    ship *expanded* ``(vid, cid)`` edge lists.  This recovers the circulant
    lifting so such codes can ride the QC decoder: an edge (v, c) belongs
    to base cell ``(cb, vb) = (c // z, v // z)`` with shift
    ``s = (c % z - v % z) % z``; the list is QC at lifting size ``z`` iff
    every populated ``(cb, vb, s)`` cell contains exactly ``z`` edges (one
    per lane ``k = v % z``).  A copy of the JAX package's ``detect_qc``.

    Args:
      vid, cid: expanded edge list.
      z: try only this lifting size; default tries every common divisor of
        (vnum, cnum) from largest to smallest and returns the first hit
        (the maximal lifting).

    Returns ``(base_edges, z)`` in :class:`QCDecoder`'s convention, or
    ``None`` if no non-trivial lifting (z >= 2) exists.
    """
    vid = np.asarray(vid, np.int64).reshape(-1)
    cid = np.asarray(cid, np.int64).reshape(-1)
    V = int(vid.max()) + 1
    C = int(cid.max()) + 1
    E = vid.size
    if z is not None:
        cands = [int(z)]
    else:
        cands = [d for d in range(min(V, C), 1, -1)
                 if V % d == 0 and C % d == 0 and E % d == 0]
    for zc in cands:
        vb = vid // zc
        cb = cid // zc
        s = (cid % zc - vid % zc) % zc
        key = (cb * (V // zc) + vb) * zc + s
        uniq, counts = np.unique(key, return_counts=True)
        if not (counts == zc).all():
            continue
        # one edge per lane k within each cell (duplicate edges would slip
        # through the count check otherwise)
        lane_key = key * zc + vid % zc
        if np.unique(lane_key).size != E:
            continue
        base = [(int(k // zc) // (V // zc), int(k // zc) % (V // zc),
                 int(k % zc)) for k in uniq]
        return base, zc
    return None


class QCDecoder:
    """Flooding or layered BP syndrome decoder over a quasi-cyclic graph.

    Args:
      base_edges: ``[(check_block, var_block, shift), ...]``.  Check-block
        degrees may differ: in the dense path short rows pad to the max
        degree with a +1e30 sentinel slab, the neutral element of every
        magnitude rule; the resident and layered paths run each row at its
        own degree.  Parallel circulants (two base edges in one (cb, vb)
        cell with different shifts) are supported.
      z: circulant size.
      dtype: message dtype: float32, bfloat16 or float64 (float64 runs on
        the CPU only).
      device: where the decode state lives.
      check_rule: "sumproduct" or "minsum" (normalized/offset min-sum).
      check_phi: sum-product magnitude form of the dense and layered paths,
        "phi" or "tanhfb".
      minsum_alpha, minsum_beta: min-sum magnitude ``max(alpha*m - beta, 0)``
        (alpha defaults to 13/16).
      totals_dtype: "storage" (totals in the message dtype) or "float32"
        (f32 totals over narrower messages).  The layered schedule always
        keeps f32 totals (f64 for float64 messages).
      schedule: "flooding" or "layered" (serial-C sweeps over the block
        rows; ``iters`` counts sweeps from 1).
      layered_chunk: sweeps per host check of "all done?" in the layered
        schedule (and per kernel call when resident).
      layered_groups: layered schedule without ``resident``: process the
        variable-disjoint batches of :func:`layered_plan` (bit-equivalent
        to that reordered serial sweep); None = on when there are >= 32
        block rows.  The resident layered kernel always sweeps in row order.
      resident: run ``resident_chunk`` flooding iterations (or
        ``layered_chunk`` layered sweeps) per kernel call, with the
        convergence test, ``iters`` and the freeze of converged frames
        inside the kernel and one host read per call.
      resident_chunk: flooding iterations per resident kernel call.
      resident_phi: sum-product magnitude of the resident flooding kernel:
        "phi", "tanhfb" or "auto" (tanhfb when ``check_phi == "tanhfb"`` or
        the messages are bf16, phi otherwise).
      resident_double, resident_zchunk, resident_rowgroup: accepted for
        the JAX decoder's signature and without effect: they are TPU
        devices (a doubled VMEM totals buffer, the VMEM z-chunk and the
        register-pressure row split), and the Hopper kernels pick their
        own launch shapes.  ``resident_rowgroup == 1`` is still refused.
      compressed: the compressed-state min-sum flooding loop
        (:meth:`_decode_compressed`): each check's messages kept as two
        magnitudes and a packed argmin/sign word, bit-identical to the
        dense min-sum decode.  Flooding, min-sum, check degree <= 26 and
        not resident only.
      sr_messages: stochastically round the bf16 message stores of the
        dense flooding loop (:func:`~qamreconciliation_tpu_torch.ops.
        boxplus.stochastic_round_bf16`), with bits from a generator seeded
        0x5eed at every decode, one draw an iteration, so a decode is
        deterministic given its inputs.  bfloat16 and the dense flooding
        path only; it runs the plain check update, as the JAX package runs
        its XLA one, because kernel 1 rounds to nearest inside.
    """

    def __init__(self, base_edges, z: int, dtype=DEFAULT_DTYPE, *,
                 device="cuda",
                 check_rule: str = "sumproduct",
                 check_phi: str = "phi",
                 minsum_alpha: float | None = None,
                 minsum_beta: float = 0.0,
                 totals_dtype: str = "storage",
                 schedule: str = "flooding",
                 layered_chunk: int = 4,
                 layered_groups: bool | None = None,
                 resident: bool | None = None,
                 resident_chunk: int = 16,
                 resident_phi: str = "auto",
                 resident_double: bool | None = None,
                 resident_zchunk: int | None = None,
                 resident_rowgroup: int | None = None,
                 compressed: bool | None = None,
                 sr_messages: bool = False):
        self.z = int(z)
        self.dtype = as_dtype(dtype)
        self.device = torch.device(device)
        if check_rule not in ("sumproduct", "minsum"):
            raise ValueError(f"unknown check_rule {check_rule!r}")
        self.check_rule = check_rule
        if schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if schedule == "layered" and compressed:
            raise ValueError("compressed=True supports only the flooding "
                             "schedule")
        self.schedule = schedule
        if int(layered_chunk) < 1:
            raise ValueError("layered_chunk must be >= 1")
        self.layered_chunk = int(layered_chunk)
        self.layered_groups = layered_groups
        if resident and compressed:
            raise ValueError("resident=True is incompatible with "
                             "compressed=True")
        self.resident = bool(resident)
        if int(resident_chunk) < 1:
            raise ValueError("resident_chunk must be >= 1")
        self.resident_chunk = int(resident_chunk)
        if resident_phi not in ("auto", "phi", "tanhfb"):
            raise ValueError(f"unknown resident_phi {resident_phi!r}")
        self.resident_phi = resident_phi
        self.resident_double = resident_double
        self.resident_zchunk = resident_zchunk
        if resident_rowgroup is not None and int(resident_rowgroup) == 1:
            raise ValueError("resident_rowgroup must be None (auto), 0 "
                             "(off), or >= 2")
        self.resident_rowgroup = (
            None if resident_rowgroup is None else int(resident_rowgroup)
        )
        self.compressed = bool(compressed)
        if self.compressed and check_rule != "minsum":
            raise ValueError(
                "compressed=True requires check_rule='minsum' (exact "
                "sum-product magnitudes are not selection-compressible)")
        self.sr_messages = bool(sr_messages)
        if self.sr_messages:
            if self.dtype != torch.bfloat16:
                raise ValueError("sr_messages=True requires bfloat16 "
                                 "message storage")
            if resident or compressed or schedule != "flooding":
                raise ValueError("sr_messages=True supports only the "
                                 "dense flooding path")
        if totals_dtype not in ("storage", "float32"):
            raise ValueError(f"unknown totals_dtype {totals_dtype!r}")
        self.totals_dtype = totals_dtype
        if check_phi not in ("phi", "tanhfb"):
            raise ValueError(f"unknown check_phi {check_phi!r}")
        self.check_phi = check_phi
        self.minsum_alpha = float(
            MINSUM_ALPHA if minsum_alpha is None else minsum_alpha
        )
        self.minsum_beta = float(minsum_beta)
        if self.minsum_beta < 0:
            raise ValueError("minsum_beta must be >= 0")
        f64 = self.dtype == torch.float64
        if schedule == "layered" and self.resident and f64:
            raise ValueError(
                "resident layered supports float32/bfloat16 message "
                "storage (the in-kernel totals are float32); use the "
                "layered loop without resident for float64 parity runs"
            )

        self.base_edges = [(int(c), int(v), int(s)) for c, v, s in base_edges]
        self.nb_c = max(c for c, _, _ in self.base_edges) + 1
        self.nb_v = max(v for _, v, _ in self.base_edges) + 1
        self.vnum = self.nb_v * self.z
        self.cnum = self.nb_c * self.z

        self._rows = [[] for _ in range(self.nb_c)]
        for c, v, s in self.base_edges:
            self._rows[c].append((v, s))
        self.row_degrees = [len(r) for r in self._rows]
        if min(self.row_degrees) < 1:
            raise ValueError("empty check block (gap in check-block ids)")
        self.dc = max(self.row_degrees)
        if self.check_rule == "minsum" and min(self.row_degrees) < 2:
            raise ValueError(
                "check_rule='minsum' requires check-block degree >= 2 "
                "(degree-1 checks have no finite min-sum extrinsic)"
            )
        if self.compressed and self.dc > 26:
            raise ValueError(
                "compressed=True packs per-slot signs into an int32 meta "
                "word: check degree must be <= 26")
        # magnitude rule of the dense and layered paths
        self.rule = (
            "tanhfb"
            if check_rule == "sumproduct" and check_phi == "tanhfb"
            else check_rule
        )
        # ... and of the resident flooding kernel
        phi_impl = resident_phi
        if phi_impl == "auto":
            phi_impl = (
                "tanhfb"
                if check_phi == "tanhfb" or self.dtype == torch.bfloat16
                else "phi"
            )
        self._resident_phi_resolved = phi_impl
        self.resident_rule = (
            check_rule if check_rule == "minsum"
            else ("tanhfb" if phi_impl == "tanhfb" else "sumproduct")
        )
        # accumulation dtypes: totals (and the gathered t) ride acc_dtype;
        # the per-variable message sums run in at least f32, rounded once
        self.acc_dtype = (
            torch.float32 if totals_dtype == "float32" and not f64
            else self.dtype
        )
        self.sum_dtype = torch.float64 if f64 else torch.float32
        self.vid, self.cid = _expand(self.base_edges, self.z)
        self._build_indices()
        self.tables = QCTables(self._rows, self.z)
        use_groups = (
            layered_groups if layered_groups is not None else self.nb_c >= 32
        )
        self._layered_batches = (
            [cbs for _, cbs in layered_plan(self._rows)] if use_groups
            else self.tables.levels
        )
        # the kernels of the dense, resident and resident layered loops; a
        # test may put their plain versions (ops/kernels.*_ref) here to run
        # them on the card
        self.check_phase = bp_check_phase_qc
        self.var_pass = bp_var_pass_qc
        self.rounds_step = bp_decode_rounds_qc
        self.sweeps_step = bp_layered_sweeps_qc
        # BP iterations (or layered sweeps) run on the device by this decoder
        self.iterations_run = 0
        # of those, iterations the flooding loop ran after its one-late read
        # found every frame done, and its reads that waited on the device
        # (models/flooding.flood)
        self.overrun_iterations = 0
        self.polls_waited = 0

    def _resident_layout(self, B: int):
        """``(doubled, totals_f32)`` of the resident flooding state: the
        doubled buffer is a TPU device and always off; f32 totals under
        ``totals_dtype="float32"`` widen bf16 messages only."""
        return False, (self.totals_dtype == "float32"
                       and self.dtype == torch.bfloat16)

    def _build_indices(self):
        """Host-built gather indices, moved to the device once.

        Gather: ``t[cb, d, j] = total[vb, (j - s) % z]`` over the flattened
        totals, padded slots pointing at one appended sentinel row.
        Scatter: for each variable block its incoming messages
        ``c2v[cb, d, (k + s) % z]`` in (cb ascending, slot ascending) order,
        variable blocks grouped by degree so every group stacks
        rectangularly; for the variable pass the same rows as an int32
        table ``[dv_max, nb_v * z]`` of each lane's d-th message row (0 on
        padded slots) and each lane's degree.
        """
        z, dc = self.z, self.dc
        j = np.arange(z)
        gidx = np.full((self.nb_c, dc, z), self.vnum, np.int64)
        incoming = [[] for _ in range(self.nb_v)]
        for cb, row in enumerate(self._rows):
            for d, (v, s) in enumerate(row):
                gidx[cb, d] = v * z + (j - s) % z
                incoming[v].append((cb * dc + d) * z + (j + s) % z)
        dev = self.device
        self._gather_idx = torch.as_tensor(gidx.reshape(-1), device=dev)
        by_deg = {}
        for v, parts in enumerate(incoming):
            if parts:
                by_deg.setdefault(len(parts), []).append(v)
        self._scatter_groups = [
            (torch.as_tensor(vbs, device=dev),
             torch.as_tensor(np.stack([np.stack(incoming[v]) for v in vbs])
                             .reshape(-1), device=dev),
             deg)
            for deg, vbs in sorted(by_deg.items())
        ]
        degree = np.array([len(parts) for parts in incoming], np.int32)
        rows = np.zeros((max(degree), self.nb_v, z), np.int32)
        for v, parts in enumerate(incoming):
            if parts:
                rows[:len(parts), v] = parts
        self._var_rows = torch.as_tensor(rows.reshape(len(rows), -1),
                                         device=dev)
        self._var_degree = torch.as_tensor(np.repeat(degree, z), device=dev)

    def _gather(self, total, pad_value):
        """[nb_v, z, B] -> [nb_c, dc, z, B] by the circulant index, padded
        slots filled with ``pad_value``."""
        B = total.shape[-1]
        flat = torch.cat([
            total.reshape(self.vnum, B),
            torch.full((1, B), pad_value, dtype=total.dtype,
                       device=total.device),
        ])
        return flat.index_select(0, self._gather_idx).view(
            self.nb_c, self.dc, self.z, B)

    def gather_totals(self, total):
        """total [nb_v, z, B] -> t [nb_c, dc, z, B]; padded slots of short
        rows hold the +1e30 sentinel."""
        return self._gather(total, BIG)

    def scatter_partials(self, c2v):
        """c2v [nb_c, dc, z, B] -> per-variable sums [nb_v, z, B] in
        ``sum_dtype``: a left fold over each variable's messages in
        (cb, slot) order.  No atomics, so the sum is deterministic."""
        return fold_incoming(c2v.reshape(-1, c2v.shape[-1]),
                             self._scatter_groups, self.nb_v, self.sum_dtype)

    def syndrome_from_bits(self, bits):
        """Syndrome via the circulant index: [V, B] int (0/1) -> [C, B]
        int32 (XOR parity of each check's variables)."""
        w = bits.to(torch.int32).reshape(self.nb_v, self.z, -1)
        t = self._gather(w, 0)
        return (torch.sum(t, dim=1, dtype=torch.int32) & 1).reshape(
            self.cnum, -1
        )

    def decode_batched(self, prior_vb, synd_cb, max_iterations: int):
        """prior [V, B], synd [C, B] -> (success [B], iters [B] int32,
        final [V, B]), on the decoder's device.

        BP until every frame's hard decision satisfies its syndrome or
        ``max_iterations`` iterations (layered: sweeps) ran.  A frame's
        ``iters`` is the iteration at which it first satisfied its syndrome
        (flooding: 0-based; layered: the 1-based sweep, 0 for a consistent
        prior); ``final`` holds its totals from that moment.  Failed frames
        report ``max_iterations`` and their totals after the last one.
        """
        with span("rr.decoder.decode"):
            if self.schedule == "layered":
                if self.resident:
                    return self._decode_resident_layered(prior_vb, synd_cb,
                                                         max_iterations)
                return self._decode_layered(prior_vb, synd_cb,
                                            max_iterations)
            if self.resident:
                return self._decode_resident(prior_vb, synd_cb,
                                             max_iterations)
            if self.compressed:
                return self._decode_compressed(prior_vb, synd_cb,
                                               max_iterations)
            return self._decode_dense(prior_vb, synd_cb, max_iterations)

    def _decode_dense(self, prior_vb, synd_cb, max_iterations: int):
        """The dense flooding loop (:func:`~.flooding.flood`): one
        check-phase kernel call, one variable pass and one host read per
        iteration (with ``sr_messages``, the stochastically rounded plain
        check update in place of the kernel).  The check phase's input t is
        gathered from the totals once a decode, then written by each
        variable pass (:meth:`_variable_side`)."""
        z, B = self.z, prior_vb.shape[1]
        prior = self._local(prior_vb.to(self.device, self.dtype)
                            .to(self.acc_dtype).reshape(self.nb_v, z, B))
        synd = self._local(synd_cb.to(self.device, torch.int32)
                           .reshape(self.nb_c, z, B))
        c2v = torch.zeros((self.nb_c, self.dc, synd.shape[1], B),
                          dtype=self.dtype, device=self.device)
        check = self._check_step
        if self.sr_messages:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0x5eed)
            check = functools.partial(self._sr_check_phase, gen=gen)
        done, iters, final = flood(
            self, prior, synd, c2v, max_iterations, check,
            functools.partial(self._variable_side, prior))
        return done, iters, final.reshape(self.vnum, B)

    def _sr_check_phase(self, t, c2v, synd, gen):
        """The check phase of the stochastically rounded loop: the plain
        check update (``bp_check_phase_qc_ref``: f32 subtraction of the
        bf16-stored operands, the rule's magnitudes in f32) with its f32
        messages rounded to bf16 by :func:`stochastic_round_bf16`.  One
        draw of random bits an iteration, every lane's, of which this
        decoder's lanes are kept.

        The JAX source writes ``t - c2v`` in the totals' dtype and widens
        after, but XLA fuses the bf16 subtraction with the widening and
        drops its rounding, so the compiled JAX update subtracts in f32
        too: on the same bits the two decodes are bit-equal
        (tests/test_torch_sr.py), and a bf16-rounded ``v2c`` is not."""
        nb_c, dc, z, B = self.nb_c, self.dc, self.z, t.shape[-1]
        rbits = torch.randint(0, 1 << 16, (nb_c, dc, z, B), generator=gen,
                              device=self.device, dtype=torch.int32)
        new, viol = bp_check_phase_qc_ref(
            t, c2v.float(), synd, rule=self.rule,
            ms_alpha=self.minsum_alpha, ms_beta=self.minsum_beta)
        return stochastic_round_bf16(new, self._local(rbits)), viol

    def _decode_compressed(self, prior_vb, synd_cb, max_iterations: int):
        """Compressed-state normalized/offset min-sum flooding loop (the JAX
        package's ``_build_compressed``).

        Min-sum's check->variable messages are selections: every slot of a
        check sees ``m1`` (the scaled minimum) except the unique argmin
        slot, which sees ``m2`` (the scaled second minimum).  So the loop
        keeps three per-check tensors ``[nb_c, z, B]`` in place of the
        dense messages: ``m1`` and ``m2`` in the message dtype and an int32
        ``meta`` (bits 0-4 the argmin slot, 31 for a tie or none; bit
        ``5 + d`` the sign of slot d's message).  Each iteration rebuilds
        the old messages from them, forms ``v2c = t - c2v`` in f32, takes
        the convergence test on the pre-update totals, the new minima and
        signs, and folds the new messages per variable as the dense path
        does.  Plain PyTorch, as the JAX loop is plain XLA; the bookkeeping
        and the host read an iteration are :func:`~.flooding.flood`'s.
        Message values, schedule and (success, iters, final) are
        bit-identical to the dense min-sum decode through kernel 1.  The
        totals ride the message dtype (``totals_dtype`` is not read, as in
        the JAX loop).
        """
        z, B = self.z, prior_vb.shape[1]
        nb_c, dc, dev = self.nb_c, self.dc, self.device
        f32 = torch.float32
        prior = prior_vb.to(dev, self.dtype).reshape(self.nb_v, z, B)
        synd = synd_cb.to(dev, torch.int32).reshape(nb_c, z, B)
        slot = torch.arange(dc, dtype=torch.int32, device=dev)[:, None, None]
        shift = slot + 5
        big = torch.tensor(BIG, dtype=f32, device=dev)
        alpha, beta = self.minsum_alpha, self.minsum_beta

        def check(t, state, synd):
            """``((m1, m2, meta, c2v_new), viol)`` from the gathered
            totals t [nb_c, dc, z, B] and the last state."""
            m1, m2, meta, _ = state
            t = t.to(f32)
            # the old messages, rebuilt from (m1, m2, meta)
            idx = (meta & 31)[:, None]
            sgn_old = (meta[:, None] >> shift) & 1
            c2v_old = torch.where(idx == slot, m2.to(f32)[:, None],
                                  m1.to(f32)[:, None]) \
                * (1 - 2 * sgn_old).to(f32)
            v2c = t - c2v_old
            # convergence on the pre-update totals (padded slots hold the
            # positive sentinel)
            par_t = torch.sum((t < 0).to(torch.int32), dim=1) & 1
            viol = torch.sum(par_t != synd, dim=1)
            # the minimum, its multiplicity and the second minimum
            absm = torch.abs(v2c)
            min1 = torch.amin(absm, dim=1)
            is_min = absm == min1[:, None]
            cnt = torch.sum(is_min, dim=1, dtype=torch.int32)
            min2 = torch.amin(torch.where(is_min, big, absm), dim=1)
            idx_new = torch.sum(is_min * slot, dim=1, dtype=torch.int32)
            idx_new = torch.where(cnt == 1, idx_new, 31)
            negs = (v2c < 0).to(torch.int32)
            par = torch.sum(negs, dim=1, dtype=torch.int32) & 1
            m1 = minsum_mag(min1, alpha, beta).to(self.dtype)
            m2 = minsum_mag(min2, alpha, beta).to(self.dtype)
            sgn = par[:, None] ^ negs ^ synd[:, None]      # 1 = negative
            meta = idx_new | torch.sum(sgn << shift, dim=1,
                                       dtype=torch.int32)
            c2v_new = (torch.where(idx_new[:, None] == slot,
                                   m2.to(f32)[:, None], m1.to(f32)[:, None])
                       * (1 - 2 * sgn).to(f32)).to(self.dtype)
            return (m1, m2, meta, c2v_new), viol

        def variable(state, t):
            """The new totals from the new messages; no t, so that every
            iteration gathers its own."""
            sums = self.scatter_partials(state[3]).to(f32)
            return (prior.to(f32) + sums).to(self.dtype), None

        m1 = torch.zeros((nb_c, z, B), dtype=self.dtype, device=dev)
        m2 = torch.zeros_like(m1)
        meta = torch.full((nb_c, z, B), 31, dtype=torch.int32, device=dev)
        done, iters, final = flood(self, prior, synd, (m1, m2, meta, None),
                                   max_iterations, check, variable)
        return done, iters, final.reshape(self.vnum, B)

    # The decoder's steps of the flooding loop; a mesh of ranks overrides
    # _local, _check_inputs, _frame_violations, _variable_side and
    # _whole_finals (parallel/graph_shard.ShardedQCDecoder).  On one device
    # they cover every lane.

    def _local(self, x):
        """x [..., z, B] of every lane -> the lanes updated here."""
        return x.contiguous()

    def _check_inputs(self, total):
        """total [nb_v, z, B] -> the check phase's t [nb_c, dc, lanes, B]
        of the lanes updated here."""
        return self.gather_totals(total)

    def _check_step(self, t, c2v, synd):
        """The fused check phase (kernel 1): ``(c2v, viol)``."""
        return self.check_phase(
            t, c2v, synd, rule=self.rule, ms_alpha=self.minsum_alpha,
            ms_beta=self.minsum_beta,
        )

    def _frame_violations(self, viol):
        """[B] violated checks among the lanes updated here -> among all."""
        return viol

    def _variable_side(self, prior, c2v, t):
        """The dense loop's variable side: ``(total, t)``, the new totals
        and the check phase's next input.  Given the current t, with totals
        in the message dtype and that one of ``VAR_PASS_DTYPES`` (float32
        or bfloat16), and without ``sr_messages``, ``var_pass`` folds the
        totals and writes them into t in place; otherwise the prior plus
        the variable sums, rounded once to the totals' dtype, and no t, so
        that the next iteration gathers it."""
        if t is None or self.sr_messages or self.acc_dtype != self.dtype \
                or self.dtype not in VAR_PASS_DTYPES:
            return (prior.to(self.sum_dtype) + self.scatter_partials(c2v)
                    ).to(self.acc_dtype), None
        return self.var_pass(prior, c2v, self._var_rows, self._var_degree,
                             t), t

    def _tail_consistent(self, total, synd):
        """[B] bool: the hard decision of the totals held here satisfies
        the syndrome (``synd``: the lanes of the checks updated here) at
        every check."""
        parity = torch.sum((self._check_inputs(total) < 0).to(torch.int32),
                           dim=1) & 1
        viol = torch.sum((parity != synd).to(torch.int32), dim=(0, 1),
                         dtype=torch.int32)
        return self._frame_violations(viol) == 0

    def _whole_finals(self, final):
        """final [nb_v, lanes, B] of the variable lanes held here ->
        [nb_v, z, B] of every lane."""
        return final

    def _consistent_flat(self, total, synd):
        """[B] bool: the hard decision of total [nb_v, z, B] satisfies the
        syndrome [nb_c, z, B]."""
        return self.tables.syndrome_violations(total, synd) == 0

    def _decode_resident(self, prior_vb, synd_cb, max_iterations: int):
        """Resident flooding loop: ``resident_chunk`` iterations per call of
        ``bp_decode_rounds_qc`` (convergence, ``iters`` and the freeze of
        converged frames in the kernel), one host read of "all done?" per
        call, then the dense path's consistency tail for frames that
        converge on the last update."""
        z, B = self.z, prior_vb.shape[1]
        maxiter = int(max_iterations)
        K = self.resident_chunk
        totals_f32 = self._resident_layout(B)[1]
        dev = self.device
        prior = prior_vb.to(dev, self.dtype).reshape(
            self.nb_v, z, B).contiguous()
        synd = synd_cb.to(dev, torch.int32).reshape(self.nb_c, z, B)
        synd8 = synd.to(torch.int8).contiguous()
        total = prior.to(torch.float32 if totals_f32 else self.dtype,
                         copy=True)
        c2v = torch.zeros((self.tables.E, z, B), dtype=self.dtype,
                          device=dev)
        done = torch.zeros(B, dtype=torch.int32, device=dev)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        it = 0
        while it < maxiter:
            self.rounds_step(
                self.tables, it, maxiter, total, c2v, prior, synd8, done,
                iters, rule=self.resident_rule, k_rounds=K,
                ms_alpha=self.minsum_alpha, ms_beta=self.minsum_beta,
            )
            self.iterations_run += min(K, maxiter - it)
            it += K
            if _all_done(done):         # the one host read per call
                break
        # total IS final for every frame: frozen at convergence in done
        # frames, after the last iteration in the others
        with span("rr.decoder.tail"):
            conv = self._consistent_flat(total, synd)
            done = done.bool()
            iters = torch.where(conv & ~done, min(it, maxiter), iters)
            done = done | conv
            iters = torch.where(done, iters, maxiter)
        return done, iters, total.reshape(self.vnum, B)

    def _decode_layered(self, prior_vb, synd_cb, max_iterations: int):
        """Layered loop in plain PyTorch (the JAX package's XLA layered
        loop): f32 totals including the prior, updated by the deltas of the
        stored messages; ``layered_chunk`` sweeps per host read, the
        syndrome tested after every sweep; ``final`` captured at
        convergence or at the ``max_iterations`` sweep; a consistent prior
        passes through with ``iters == 0``."""
        z, B = self.z, prior_vb.shape[1]
        maxiter = int(max_iterations)
        dev = self.device
        acc = torch.float64 if self.dtype == torch.float64 else torch.float32
        prior = prior_vb.to(dev, acc).reshape(self.nb_v, z, B)
        synd = synd_cb.to(dev, torch.int32).reshape(self.nb_c, z, B)
        groups = self.tables.row_groups(self._layered_batches, dev)
        total = prior.clone(memory_format=torch.contiguous_format)
        final = prior
        c2v = torch.zeros((self.tables.E, z, B), dtype=self.dtype,
                          device=dev)
        done = self._consistent_flat(prior, synd)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        it = 0
        while it < maxiter and not _all_done(done):
            # sweeps past max_iterations would change nothing returned
            for swp in range(it + 1, min(it + self.layered_chunk,
                                         maxiter) + 1):
                layered_sweep(groups, total, c2v, synd, None,
                              rule=self.rule, ms_alpha=self.minsum_alpha,
                              ms_beta=self.minsum_beta)
                self.iterations_run += 1
                newly = self._consistent_flat(total, synd) & ~done
                iters = torch.where(newly, swp, iters)
                done = done | newly
                cap = newly | (~done & (swp == maxiter))
                final = torch.where(cap, total, final)
            it += self.layered_chunk
        iters = torch.where(done, iters, maxiter)
        return done, iters, final.reshape(self.vnum, B)

    def _decode_resident_layered(self, prior_vb, synd_cb,
                                 max_iterations: int):
        """Resident layered loop: ``layered_chunk`` serial sweeps per call
        of ``bp_layered_sweeps_qc`` (convergence, ``iters`` and the freeze
        of converged frames in the kernel), one host read per call.  Frames
        whose prior is already consistent start done, so they pass through
        with ``iters == 0``."""
        z, B = self.z, prior_vb.shape[1]
        maxiter = int(max_iterations)
        K = self.layered_chunk
        dev = self.device
        prior = prior_vb.to(dev, torch.float32).reshape(self.nb_v, z, B)
        synd = synd_cb.to(dev, torch.int32).reshape(self.nb_c, z, B)
        synd8 = synd.to(torch.int8).contiguous()
        total = prior.clone(memory_format=torch.contiguous_format)
        c2v = torch.zeros((self.tables.E, z, B), dtype=self.dtype,
                          device=dev)
        with span("rr.decoder.precheck"):
            done = self._consistent_flat(prior, synd).to(torch.int32)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        it = 0
        while it < maxiter and not _all_done(done):
            self.sweeps_step(
                self.tables, it, maxiter, total, c2v, synd8, done, iters,
                rule=self.rule, k_sweeps=K, ms_alpha=self.minsum_alpha,
                ms_beta=self.minsum_beta,
            )
            self.iterations_run += min(K, maxiter - it)
            it += K
        with span("rr.decoder.tail"):
            done = done.bool()
            iters = torch.where(done, iters, maxiter)
        return done, iters, total.reshape(self.vnum, B)

    def _build_decode(self):
        """The [V, B] decode entry the engine calls."""
        return self.decode_batched

    def decode_batch(self, lappr, synd, max_iterations: int):
        """lappr [B, V], synd [B, C] -> (success [B], iters [B], final [B, V])."""
        lappr, synd = torch.as_tensor(lappr), torch.as_tensor(synd)
        success, iters, total = self.decode_batched(
            lappr.to(self.device, self.dtype).T, synd.to(self.device).T,
            max_iterations,
        )
        return success, iters, total.T
