"""What the attribution probes share: the device, the timer and the records.

A probe runs on ``--device`` (default ``cuda``).  Without a card it exits 2
unless it was given ``--device cpu``, where the kernels run their plain
versions and the times are the host's.  Its first record names the device
(the card's name and power limit, as the campaigns' first record does);
the probe's own records follow, one JSON line each, with the JAX probe's
keys.

The JAX probes end each timed window with a host read.  Here a window is
a CUDA event pair around the same work, after a first call outside it
whose host seconds (to a synchronize) are the record's ``compile_s``: on
the card that is the kernels' build and load, and the first launches.  On
the CPU a window is ``time.perf_counter`` around the work.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ._runner import device_record

__all__ = ["add_device", "open_device", "emit", "first_call", "window_ms",
           "each_ms"]


def add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default cuda; 'cpu' runs the "
                    "kernels' plain versions)")


def open_device(name: str, device: str):
    """The probe's ``torch.device`` after its device record is printed, or
    None (with a message on stderr) when it asks for CUDA and there is no
    card: the caller then exits 2."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{name}: CUDA is not available; run on an NVIDIA GPU or pass "
              "--device cpu", file=sys.stderr)
        return None
    emit({"probe": name, **device_record(device)})
    return dev


def emit(record: dict):
    print(json.dumps(record), flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_call(fn, device) -> float:
    """Host seconds of ``fn()`` to a synchronize."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def window_ms(fn, reps: int, device) -> float:
    """Mean ms per call of ``reps`` calls of ``fn`` in one window."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def each_ms(fn, reps: int, device) -> list[float]:
    """ms of each of ``reps`` calls of ``fn``, one window a call."""
    return [window_ms(fn, 1, device) for _ in range(reps)]
