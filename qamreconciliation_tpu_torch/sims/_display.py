"""Shared plumbing for the display CLIs.

The reference display scripts (reference: sims/display_*.py) hardcode their
experiment CSV paths and always call ``plt.show()``.  These take every input
file as an argument and support ``--save FILE`` for headless rendering.
The sweep CSVs are read with the standard library (the GPU host has no
pandas), and matplotlib is imported only to draw: a host without it can
import every display module, and a display CLI there exits with a message
that names it.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

__all__ = ["add_output_args", "get_pyplot", "finish", "binary_entropy",
           "read_table"]


def add_output_args(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--save", default=None,
        help="Write the figure to this file instead of opening a window",
    )


def get_pyplot(args):
    """Import pyplot, forcing the Agg backend when saving headless; exit
    non-zero with a message naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit(
            "the display CLIs need matplotlib, which is not installed here; "
            "copy the sweep CSVs to a host that has it") from None
    if args.save:
        matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def finish(plt, args):
    if args.save:
        plt.savefig(args.save, dpi=150, bbox_inches="tight")
        print(f"wrote {args.save}")
    else:
        plt.show()


def binary_entropy(p):
    """h2(p) in bits, safe at 0/1."""
    p = np.asarray(p, dtype=np.float64)
    out = np.zeros_like(p)
    m = (p > 0) & (p < 1)
    pm = p[m]
    out[m] = -pm * np.log2(pm) - (1 - pm) * np.log2(1 - pm)
    return out


def read_table(path: str) -> dict:
    """A sweep CSV (header row, one row a point, the unnamed index column
    first, as the sweep CLIs and ``DataFrame.to_csv`` write it) as an
    ordered ``{column: float64 array}``, the index column included, so that
    a display's "every column from the third on" skips the index and the
    point column."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], [r for r in rows[1:] if r]
    return {name: np.array([float(r[i]) for r in body], np.float64)
            for i, name in enumerate(header)}
