"""The one place a campaign runs its configs.

A :class:`Campaign` prints a first record naming the device (the card's
name and power limit on ``cuda``), runs each config inside
:meth:`Campaign.config`, which turns an exception into the JAX script's
``"error"`` record and counts it, and gives the exit status: 1 when any
config failed.  A config that fails is never retried on another engine.
Sweep CLIs run in this process through their ``main(argv)`` with
``--device`` appended, and their CSVs are read with the standard library.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import time
import traceback

import torch

from ..sims._display import read_table

__all__ = ["DEFAULT_OUTDIR", "add_args", "device_record", "first_row",
           "sync", "time_decode", "Campaign"]

# the campaigns' fixed outputs go here by default, under docs/img's names
DEFAULT_OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "h100")


def add_args(ap, outdir: bool = False):
    """``--device`` (and ``--outdir`` for a campaign with fixed outputs)."""
    ap.add_argument("--device", default="cuda",
                    help="Torch device of every config (default cuda; 'cpu' "
                    "runs the kernels' plain versions)")
    if outdir:
        ap.add_argument("--outdir", default=DEFAULT_OUTDIR,
                        help="Directory of the campaign's output files "
                        "(default qamreconciliation_tpu_torch/scripts/h100)")


def device_record(device: str) -> dict:
    """``{"device": name, "power_limit": ...}``: ``torch.cuda.
    get_device_name`` and nvidia-smi's power limit on a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": dev.type, "power_limit": None}
    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        index = dev.index if dev.index is not None else 0
        power = smi[index].rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        power = None
    return {"device": name, "power_limit": power}


def first_row(path: str) -> dict:
    """The first row of a sweep CSV as ``{column: float}``."""
    return {k: float(v[0]) for k, v in read_table(path).items()}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_decode(dec, lappr, synd, iterations: int, reps: int):
    """Host-clock times of the decoder's ``_build_decode()`` entry on
    ``lappr`` [V, B] and ``synd`` [C, B], each call between two
    synchronizes: (the first call's s, [each of ``reps`` calls' ms])."""
    f = dec._build_decode()
    times = []
    for _ in range(reps + 1):
        sync(dec.device)
        t0 = time.perf_counter()
        out = f(lappr, synd, iterations)
        out[1].cpu()
        sync(dec.device)
        times.append(time.perf_counter() - t0)
    return times[0], [1e3 * t for t in times[1:]]


class Campaign:
    """A campaign's run on ``device``: its records on stdout and the count
    of configs that failed."""

    def __init__(self, name: str, device: str):
        self.device = device
        self.failures = 0
        self.emit({"campaign": name, **device_record(device)})

    @staticmethod
    def emit(record: dict):
        print(json.dumps(record), flush=True)

    def cli(self, name: str, argv):
        """``sims.<name>.main(argv + ["--device", device])``."""
        module = importlib.import_module(f"..sims.{name}", __package__)
        return module.main([*argv, "--device", self.device])

    @contextlib.contextmanager
    def config(self, ident: dict | None = None):
        """Run one config.  An exception is counted, its traceback goes to
        stderr, and the campaign goes on: the yielded dict then holds
        ``{"error": "Type: message"}``, and with ``ident`` the record
        ``{**ident, "error": ...}`` is printed."""
        err = {}
        try:
            yield err
        except Exception as e:
            traceback.print_exc()
            self.failures += 1
            err["error"] = f"{type(e).__name__}: {e}"[:300]
            if ident is not None:
                self.emit({**ident, **err})

    def status(self) -> int:
        """The exit status: 1 when a config failed, else 0."""
        return 1 if self.failures else 0
