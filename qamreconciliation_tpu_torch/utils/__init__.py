"""Host utilities."""

from .edgefile import load_edge_csv, make_regular_ldpc, save_edge_csv
from .scalar import count_errors_from_lappr, dist_cut

__all__ = [
    "load_edge_csv",
    "save_edge_csv",
    "make_regular_ldpc",
    "dist_cut",
    "count_errors_from_lappr",
]
