"""The code files the campaigns build, written where and as the JAX
package's scripts write them: in the temporary directory, under the same
names, byte for byte the same (``save_qc_csv`` and ``save_edge_csv`` of the
port's copies of the constructions)."""

from __future__ import annotations

import os
import tempfile

from ..models.dvbs2 import Z, expanded_edges, make_table, to_qc_base
from ..models.qc_decoder import make_qc_ira, make_qc_ldpc, save_qc_csv
from ..utils.edgefile import save_edge_csv

__all__ = ["N", "SEED", "qc_ldpc", "ira_base", "qc_ira", "dvbs2_qc",
           "dvbs2_exact"]

N = 64800       # every campaign's code length
SEED = 12345    # the QC constructions' seed (bench.py's headline code)


def _path(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def qc_ldpc(nbv: int = 36, name: str | None = None) -> str:
    """The regular QC(3,6) code of ``nbv`` block columns (z = N / nbv),
    saved as ``name`` (default ``qc{nbv}_64800.csv``); returns its path."""
    z = N // nbv
    base, _, _ = make_qc_ldpc(nbv, z, dv=3, dc=6, seed=SEED)
    path = _path(name or f"qc{nbv}_64800.csv")
    save_qc_csv(path, base, z)
    return path


def ira_base(nbv: int, z: int, rate: str):
    """The QC-IRA base of ``nbv`` block columns at rate "1/2" (half of
    them information blocks) or "3/4" (three quarters)."""
    nb_info, nb_acc = {"1/2": (nbv // 2, nbv // 2),
                       "3/4": (3 * nbv // 4, nbv // 4)}[rate]
    base, _, _ = make_qc_ira(nb_info=nb_info, nb_acc=nb_acc, z=z, dv=3,
                             seed=SEED)
    return base


def qc_ira(nbv: int = 36, rate: str = "1/2") -> str:
    """The QC-IRA code at ``rate``, saved as ``qc_ira_64800_z{z}.csv`` (rate
    1/2) or ``qc_ira34_64800_z{z}.csv`` (rate 3/4); returns its path."""
    z = N // nbv
    tag = "" if rate == "1/2" else rate.replace("/", "")
    path = _path(f"qc_ira{tag}_64800_z{z}.csv")
    save_qc_csv(path, ira_base(nbv, z, rate), z)
    return path


def dvbs2_qc(rate: str) -> str:
    """The DVB-S2 construction at ``rate`` as its full-wrap z = 360 QC base,
    saved as ``dvbs2_{rate}_qc.csv`` (``1/2`` -> ``12``); returns its path."""
    path = _path(f"dvbs2_{rate.replace('/', '')}_qc.csv")
    save_qc_csv(path, to_qc_base(make_table(rate, seed=0), wrap="full"), Z)
    return path


def dvbs2_exact(rate: str = "1/2") -> str:
    """The DVB-S2 construction's exact H as an expanded edge list, saved as
    ``dvbs2_{rate}_exact.csv``; returns its path."""
    path = _path(f"dvbs2_{rate.replace('/', '')}_exact.csv")
    save_edge_csv(path, *expanded_edges(make_table(rate, seed=0)))
    return path
