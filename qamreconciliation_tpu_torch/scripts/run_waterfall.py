"""One ``sim_reconciliation --qc`` waterfall sweep on a code this builds.

The port's counterpart of the JAX package's ``scripts/run_waterfall.py``:
it writes the standard QC(3,6) N = 64800 code (``--nbv`` block columns,
default 36, so z = 1800; ``scripts/_codes.py``), the QC-IRA codes
(``--irregular`` rate 1/2, ``--rate34``) or a DVB-S2 construction's
full-wrap z = 360 base (``--dvbs2 R``, which wins over the other two) into
the temporary directory, then forwards every other flag to the port's
``sims/sim_reconciliation`` with ``--qc`` and ``--out OUT.CSV``.  The
waterfall CSVs of the mode comparison and of the plotters come from here.

    python -m qamreconciliation_tpu_torch.scripts.run_waterfall OUT.CSV \\
        --dvbs2 1/2 --hard --snr 3.0 5.5 --nsnr 6 --simloops 1024 \\
        --batch 128 --maxiter 50 --ferr-count-min 1000000000 \\
        --dtype bfloat16 --check-phi tanhfb [--device cuda]

Prints the device record, then ``{"csv": OUT.CSV, "wall_s": ...}`` (or the
``"error"`` record, and exits 1).
"""

import sys
import time

from . import _codes
from ._runner import Campaign

__all__ = ["main"]


def _pop(rest, flag, default):
    """The value after ``flag`` in ``rest``, both removed, or ``default``."""
    if flag not in rest:
        return default
    k = rest.index(flag)
    value = rest[k + 1]
    del rest[k:k + 2]
    return value


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out, rest = argv[0], argv[1:]
    nbv = int(_pop(rest, "--nbv", 36))
    device = _pop(rest, "--device", "cuda")
    rate = _pop(rest, "--dvbs2", None)
    if rate is not None:
        code = _codes.dvbs2_qc(rate)
    elif "--rate34" in rest:
        rest.remove("--rate34")
        code = _codes.qc_ira(nbv, "3/4")
    elif "--irregular" in rest:
        rest.remove("--irregular")
        code = _codes.qc_ira(nbv, "1/2")
    else:
        code = _codes.qc_ldpc(nbv)
    camp = Campaign("run_waterfall", device)
    with camp.config({"csv": out}):
        t0 = time.perf_counter()
        camp.cli("sim_reconciliation", [code, "--qc", "--out", out] + rest)
        camp.emit({"csv": out, "wall_s": round(time.perf_counter() - t0, 1)})
    return camp.status()


if __name__ == "__main__":
    sys.exit(main())
