"""The largest shared-memory scratch a block can hold on the card.

The port's counterpart of the JAX package's ``scripts/probe_vmem.py``,
which compiled a copy kernel with an N-MiB VMEM scratch at increasing N to
find the largest residency of a TPU kernel.  On Hopper a block's fast
scratch is its shared memory, and the most it can hold is what it may opt
into as dynamic shared memory: ``torch.cuda.get_device_properties(d).
shared_memory_per_block_optin``, 227 KB (232,448 bytes) on the H100.
Kernel 8 (``ops.kernels.smem_ceiling_probe``) is the JAX probe's kernel
with an N-KiB shared-memory scratch: ``2x`` into its first 8 rows, ``x +
1`` into its last 8, ``out`` their sum.  The sizes: 32, 48, 96, 160 and 200
KiB, the opt-in limit in KiB and one KiB past it, which the card refuses.

The JAX probe holds ``out`` to 5.0 for ``x = 1``, but its kernel computes
``2x + (x + 1) = 4.0``, so it prints ``value=False`` at every size (a fault
of the reference's probe).  Here ``value`` says whether the kernel equals
its plain version, ``2x + (x + 1)``.

    python -m qamreconciliation_tpu_torch.scripts.probe_vmem [--device cuda]

Prints, after the device record, the opt-in limit and one line a size:
``N KiB scratch: OK value=<bool> compile+run Xs`` or, for a size above the
limit whose shared-memory request the card refuses, ``N KiB scratch: FAIL
<CUDA error name>: ...``.  Any other error raises.  On the CPU the plain
version runs every size (there is no shared memory to refuse).  Exits 2
without a card unless ``--device cpu``.
"""

import argparse
import sys
import time

import torch

from ._probe import add_device, open_device
from ..ops import kernels as K

__all__ = ["SIZES_KIB", "sizes_kib", "optin_bytes", "probe", "main"]

SIZES_KIB = (32, 48, 96, 160, 200)


def optin_bytes(device) -> int:
    """The card's opt-in limit of dynamic shared memory a block; on the CPU
    the H100's, ``ops.kernels.SMEM_BLOCK_MAX``."""
    if device.type != "cuda":
        return K.SMEM_BLOCK_MAX
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def sizes_kib(optin: int):
    """The probe's sizes: ``SIZES_KIB``, the limit and one KiB past it."""
    return (*SIZES_KIB, optin // 1024, optin // 1024 + 1)


def probe(kib: int, device, optin: int) -> str:
    """One size's line."""
    nbytes = kib * 1024
    x = torch.ones((K.SMEM_PROBE_ROWS, K.SMEM_PROBE_COLS),
                   dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    try:
        out = K.smem_ceiling_probe(x, nbytes)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except K.SharedMemoryRefused as e:
        if nbytes <= optin:
            raise
        return f"{kib} KiB scratch: FAIL {e.name}: {str(e)[:200]}"
    dt = time.perf_counter() - t0
    ok = torch.equal(out, K.smem_ceiling_probe_ref(x, nbytes))
    return f"{kib} KiB scratch: OK value={ok} compile+run {dt:.1f}s"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_vmem")
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_vmem", args.device)
    if device is None:
        return 2
    optin = optin_bytes(device)
    print(f"shared_memory_per_block_optin: {optin} bytes", flush=True)
    for kib in sizes_kib(optin):
        print(probe(kib, device, optin), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
