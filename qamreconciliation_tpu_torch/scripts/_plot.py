"""The waterfall figure the ``plot_*`` modules share: BER and FER against
Es/N0 on a log axis (values clipped below at 1e-7), optionally the mean
iterations of the points that decoded, under a title that names the card
from a campaign's device record.  The CSVs are read with the standard
library; matplotlib is imported only to draw (``sims/_display.get_pyplot``).
"""

from __future__ import annotations

import argparse
import json

from ..sims._display import get_pyplot, read_table

__all__ = ["parser", "card", "draw"]


def parser(prog: str, *csvs: str, optional: tuple = ()):
    """The plotter's arguments: the positional CSVs, OUT.png, the optional
    trailing CSVs, and ``--records`` (a campaign's JSONL whose device
    record names the card in the title)."""
    ap = argparse.ArgumentParser(prog=prog)
    for name in csvs:
        ap.add_argument(name)
    ap.add_argument("out_png")
    for name in optional:
        ap.add_argument(name, nargs="?", default=None)
    ap.add_argument("--records", default=None,
                    help="a campaign's JSONL output; its device record "
                    "names the card in the title")
    return ap


def card(records: str | None) -> str:
    """", <device name>" from the first record of ``records`` that names
    a device, or "" without one."""
    if not records:
        return ""
    with open(records) as f:
        for line in f:     # the sweep CLIs' progress lines are not JSON
            rec = json.loads(line) if line.startswith("{") else {}
            if rec.get("device"):
                return f", {rec['device']}"
    return ""


def draw(curves, out_png: str, title: str, *, iterations: bool = False,
         dpi: int = 120, fontsize: int | None = 10):
    """Draw ``curves`` ``[(csv path, format, label), ...]`` into
    ``out_png``: BER and FER panels, and with ``iterations`` a third of
    the mean iterations at the points whose FER is below 1."""
    plt = get_pyplot(argparse.Namespace(save=out_png))
    tables = [(read_table(path), fmt, label) for path, fmt, label in curves]
    fig, axes = plt.subplots(1, 3 if iterations else 2,
                             figsize=(13 if iterations else 10, 4),
                             sharex=True)
    for ax, col, ylab in zip(axes, ("ber", "fer"), ("BER", "FER")):
        for t, fmt, label in tables:
            ax.semilogy(t["EsN0dB"], [max(v, 1e-7) for v in t[col]], fmt,
                        label=label)
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel(ylab)
        ax.grid(True, which="both", alpha=0.3)
    if iterations:
        ax = axes[2]
        for t, fmt, label in tables:
            conv = t["fer"] < 1.0
            ax.plot(t["EsN0dB"][conv], t["iters"][conv], fmt, label=label)
        ax.set_xlabel("$E_s/N_0$ [dB]")
        ax.set_ylabel("mean iterations (successes)")
        ax.grid(True, alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.suptitle(title, fontsize=fontsize)
    fig.tight_layout()
    fig.savefig(out_png, dpi=dpi)
    plt.close(fig)
    print(f"wrote {out_png}")
