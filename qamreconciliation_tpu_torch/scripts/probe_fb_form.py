"""The resident bf16 tanh-F/B decode under two labels of the all-but-one
product form.

The port's counterpart of the JAX package's ``scripts/probe_fb_form.py``,
which timed the resident tanh-F/B kernel with the package's shared
``fb_allbutone_list`` ("tree") and with the probe's serial copy of it
("serial"), swapping the helper in and restoring it afterwards, at z = 1800
(36 block columns) and z = 360 (180).  The two labels no longer name two
forms: since the round-5 revert the reference's shared helper is itself the
serial forward/backward prefix chain
(``qamreconciliation_tpu/ops/boxplus.py:317-349``), so "tree" names the
package's form, which equals the probe's serial copy.  The port's
``ops.boxplus.fb_allbutone_list`` is that form too, and kernel 2's tanh-F/B
rule (``RuleChain<kTanhFB>``, ``csrc/bp_resident.cuh``) computes the same
product order.  On the card both labels therefore run kernel 2's one
tanh-F/B instance; on the CPU the swap reaches the plain version through
``ops.boxplus.tanhfb_extrinsic_mag``.

Each config is a ``QCDecoder`` of ``make_qc_ldpc(nbv, 64800 / nbv, 3, 6,
seed=12345)`` with bf16 messages, sum-product, ``resident=True`` and
``resident_chunk=50``, decoding B = 128 frames of ``default_rng(0)`` LLRs
~ N(0, 3) and a random syndrome (one draw a config, in order) for 250
iterations: a first call, then 4 calls each in a CUDA-event window.

    python -m qamreconciliation_tpu_torch.scripts.probe_fb_form \\
        [--device cuda] > fb.jsonl

One record a config after the device record: ``{config, nbv, compile_s,
ms_per_iter, reps}`` (``ms_per_iter`` the best call over 250, ``reps``
each call's); a config that raises prints ``{config, error}`` and the
probe exits 1.  Exits 2 without a card unless ``--device cpu``.
"""

import argparse
import sys
import traceback

import numpy as np
import torch

from ._probe import add_device, each_ms, emit, first_call, open_device
from ..models.qc_decoder import QCDecoder, make_qc_ldpc
from ..ops import boxplus

__all__ = ["N", "B", "ITERS", "REPS", "serial_fb_allbutone_list",
           "configs", "run", "main"]

N, B, ITERS, REPS = 64800, 128, 250, 4


def serial_fb_allbutone_list(terms):
    """The probe's serial forward/backward prefix-chain form."""
    n = len(terms)
    if n == 1:
        return [torch.ones_like(terms[0])], terms[0]
    F = [terms[0]]
    for d in range(1, n):
        F.append(F[-1] * terms[d])
    Bk = [terms[n - 1]]
    for d in range(n - 2, -1, -1):
        Bk.append(Bk[-1] * terms[d])
    Bk = Bk[::-1]
    out = [Bk[1]] + [F[d - 1] * Bk[d + 1] for d in range(1, n - 1)] \
        + [F[n - 2]]
    return out, F[n - 1]


def configs():
    """``(label, nbv, form)`` of the JAX probe, in order."""
    tree = boxplus.fb_allbutone_list
    return [("z1800 tree", 36, tree), ("z1800 serial", 36,
                                       serial_fb_allbutone_list),
            ("z360 tree", 180, tree), ("z360 serial", 180,
                                       serial_fb_allbutone_list)]


def run(name: str, nbv: int, form, device, rng):
    """One config with ``form`` swapped in (and the package's restored):
    ``(record, (success, iters, final))`` of its last decode."""
    tree = boxplus.fb_allbutone_list
    boxplus.fb_allbutone_list = form
    try:
        z = N // nbv
        base, _, _ = make_qc_ldpc(nbv, z, dv=3, dc=6, seed=12345)
        dec = QCDecoder(base, z, dtype=torch.bfloat16, device=device,
                        check_rule="sumproduct", resident=True,
                        resident_chunk=50)
        lappr = torch.as_tensor(rng.normal(0, 3.0, (dec.vnum, B)),
                                dtype=torch.bfloat16, device=device)
        synd = torch.as_tensor(rng.integers(0, 2, (dec.cnum, B)),
                               dtype=torch.int32, device=device)
        f = dec._build_decode()
        out = []

        def call():
            out[:] = f(lappr, synd, ITERS)

        compile_s = first_call(call, device)
        ms = each_ms(call, REPS, device)
        return {"config": name, "nbv": nbv, "compile_s": round(compile_s, 1),
                "ms_per_iter": round(min(ms) / ITERS, 4),
                "reps": [round(m / ITERS, 4) for m in ms]}, tuple(out)
    finally:
        boxplus.fb_allbutone_list = tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_fb_form")
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_fb_form", args.device)
    if device is None:
        return 2
    rng = np.random.default_rng(0)
    failed = 0
    for name, nbv, form in configs():
        try:
            rec, _ = run(name, nbv, form, device, rng)
        except Exception as e:
            traceback.print_exc()
            failed += 1
            rec = {"config": name, "error": f"{type(e).__name__}: {e}"[:250]}
        emit(rec)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
