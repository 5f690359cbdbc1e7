"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each must pass, or the script exits non-zero):
  1. environment: torch version, the card, its power limit (nvidia-smi);
  2. build: the CUDA kernels from qamreconciliation_tpu_torch/csrc with nvcc;
  3. kernel against its plain PyTorch version on the card, at the headline
     check-phase shape [90, 6, 360, 128], every rule and dtype pair, plus a
     case with +1e30 padded slots; CUDA-event times of both;
  4. decoder: the headline code decoded on the card (kernel) and on the CPU
     (plain version) from the same softening LLRs;
  5. main path: the soft reverse-reconciliation sweep CLI on the headline
     code, counting the kernel's launches.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Needs CUDA; exits 2 without it.
"""

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHAPE = (90, 6, 360, 128)              # [nb_c, dc, z, B] of the headline code
CODE = dict(nb_v=180, z=360, dv=3, dc=6, seed=12345)
ALTERNATING = np.array([0, 1, 0, 1], np.uint8)
KERNEL_SOURCE = "qamreconciliation_tpu_torch/csrc/bp_check_phase_qc.cu"
REPLACES = "qamreconciliation_tpu/ops/pallas_kernels.py:158"


def log(msg):
    print(msg, flush=True)


def bf16_ulp(x):
    a = x.abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                       torch.full_like(a, 2.0 ** -133))


def check_close(got, want, rule, m_dtype):
    """Max |got - want|; raises unless min-sum is bit-equal, f32 phi/tanhfb
    within atol 1e-5 + rtol 1e-5, bf16 within one bf16 ulp."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if rule == "minsum":
        assert torch.equal(got, want), "min-sum output is not bit-equal"
    elif m_dtype == torch.bfloat16:
        assert bool((diff <= bf16_ulp(want)).all()), "beyond one bf16 ulp"
    else:
        assert bool((diff <= 1e-5 + 1e-5 * want.abs()).all()), \
            "beyond atol 1e-5 + rtol 1e-5"
    return float(diff.max())


def time_pair(fn_a, fn_b, reps=20, warmup=3):
    """Median ms of each of two calls, timed with CUDA events in turns."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    times = ([], [])
    for _ in range(reps):
        for fn, acc in ((fn_a, times[0]), (fn_b, times[1])):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            acc.append(start.elapsed_time(stop))
    return statistics.median(times[0]), statistics.median(times[1])


def phase_kernel(kernels):
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_qc, bp_check_phase_qc_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    nb_c, dc, z, B = SHAPE
    t = 3.0 * torch.randn(SHAPE, generator=gen, device="cuda")
    c2v = torch.randn(SHAPE, generator=gen, device="cuda")
    synd = torch.randint(0, 2, (nb_c, z, B), generator=gen, device="cuda",
                         dtype=torch.int32)
    # a quarter of the frames satisfy their syndrome: both mask values occur
    par = (torch.sum(t < 0, dim=1, dtype=torch.int32) & 1)
    synd[..., : B // 4] = par[..., : B // 4]
    t_irr = t.clone()
    for cb in range(0, nb_c, 3):
        t_irr[cb, dc - 1 - cb % 2:] = 1e30

    cases = []
    for rule, kw in (("sumproduct", {}), ("tanhfb", {}), ("minsum", {}),
                     ("minsum", dict(ms_alpha=1.0, ms_beta=0.3))):
        for td, md in ((torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.bfloat16)):
            cases.append((rule, kw, td, md, t))
        cases.append((rule, kw, torch.float32, torch.float32, t_irr))

    record = None
    for rule, kw, td, md, tt in cases:
        args = (tt.to(td).contiguous(), c2v.to(md).contiguous(), synd)
        got, gviol = bp_check_phase_qc(*args, rule=rule, **kw)
        want, wviol = bp_check_phase_qc_ref(*args, rule=rule, **kw)
        torch.cuda.synchronize()
        assert torch.equal(gviol, wviol), "violation counts differ"
        if tt is t:
            conv = gviol.sum(0) == 0
            assert bool(conv[: B // 4].all()) and not bool(conv.all())
        err = check_close(got, want, rule, md)
        ms, plain_ms = time_pair(
            lambda: bp_check_phase_qc(*args, rule=rule, **kw),
            lambda: bp_check_phase_qc_ref(*args, rule=rule, **kw),
        )
        irr = " padded" if tt is t_irr else ""
        name = (f"{rule}{'(a=1,b=0.3)' if kw else ''} "
                f"t={str(td)[6:]} c2v={str(md)[6:]}{irr}")
        log(f"[kernel] {name:45s} max|diff|={err:.3e} "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if record is None:           # the headline case: f32 phi
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    bytes_moved = 3 * t.numel() * 4 + synd.numel() * 4
    log(f"[kernel] headline f32 phi: {bytes_moved / 1e6:.1f} MB moved, "
        f"{bytes_moved / record['ms'] / 1e6:.1f} GB/s")
    kernels["bp_check_phase_qc"] = dict(
        name="bp_check_phase_qc", route="cuda", source=KERNEL_SOURCE,
        replaces=REPLACES, launches=None, **record,
    )


def phase_decoder():
    """The headline code decoded three ways from the same softening LLRs:
    on the card through the kernel, on the card through the plain check
    phase, and on the CPU (plain).  Kernel and plain on the card must agree
    bit for bit.  Against the CPU, success, iters and the decoded frames'
    hard decisions must agree and min-sum totals bit for bit; sum-product
    totals drift there, since the CPU's and the card's libms differ by an
    ulp and a decode compounds it over up to 50 iterations, so their largest
    relative difference is reported."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import bp_check_phase_qc_ref
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    B, snr, maxiter = 16, 3.5, 50
    for kw in (dict(), dict(check_rule="minsum")):
        label = kw.get("check_rule", "sumproduct")
        gpu = QCDecoder(base, CODE["z"], device="cuda", **kw)
        eng = ReconciliationEngine(gpu, Matrix(vid, cid), PAMAlphabet(2, 2.0),
                                   batch=B)
        nm = eng.make_noisemapper(snr, ALTERNATING)
        x, y = eng._sample_sb(round_generator(7, 0, "cuda"),
                              math.sqrt(eng.noise_var(snr)))
        lappr, word = eng._softening_inputs(nm, x, y, 1.0)
        synd = gpu.syndrome_from_bits(word)

        t0 = time.perf_counter()
        sg, ig, fg = gpu.decode_batched(lappr, synd, maxiter)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = QCDecoder(base, CODE["z"], device="cuda", **kw)
        plain.check_phase = bp_check_phase_qc_ref
        sp, ip, fp = plain.decode_batched(lappr, synd, maxiter)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cpu = QCDecoder(base, CODE["z"], device="cpu", **kw)
        sc, ic, fc = cpu.decode_batched(lappr.cpu(), synd.cpu(), maxiter)
        t3 = time.perf_counter()

        assert torch.equal(sg, sp) and torch.equal(ig, ip), \
            f"{label}: kernel and plain decodes differ on the card"
        assert torch.equal(fg, fp), f"{label}: card totals not bit-equal"
        fg, sg, ig = fg.cpu(), sg.cpu(), ig.cpu()
        assert torch.equal(sg, sc), f"{label}: success differs from CPU"
        assert torch.equal(ig, ic), f"{label}: iters differ from CPU"
        assert torch.equal(fg[:, sc] < 0, fc[:, sc] < 0), \
            f"{label}: decoded frames' decisions differ from CPU"
        rel = float(((fg - fc).abs() / fc.abs().clamp_min(1.0)).max())
        if label == "minsum":
            assert torch.equal(fg, fc), "min-sum totals differ from CPU"
        log(f"[decoder] {label}: B={B} {snr} dB: {int(sc.sum())}/{B} "
            f"decoded, iters {ic.tolist()}; kernel == plain on the card "
            f"(bit-equal); vs CPU max rel total diff {rel:.3e}; "
            f"card kernel {1e3 * (t1 - t0):.1f} ms, card plain "
            f"{1e3 * (t2 - t1):.1f} ms, CPU {1e3 * (t3 - t2):.1f} ms")


def phase_main_path(kernels):
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        make_qc_ldpc, save_qc_csv,
    )
    from qamreconciliation_tpu_torch.ops.kernels import bp_check_phase_qc
    from qamreconciliation_tpu_torch.sims import sim_reconciliation

    with tempfile.TemporaryDirectory() as tmp:
        code = os.path.join(tmp, "code.csv")
        out = os.path.join(tmp, "out.csv")
        base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
        save_qc_csv(code, base, CODE["z"])
        bp_check_phase_qc.launches = 0
        results = sim_reconciliation.main([
            code, "--qc", "--snr", "3.5", "4.0", "--nsnr", "2",
            "--simloops", "512", "--batch", "128", "--maxiter", "50",
            "--bps", "2", "--device", "cuda", "--out", out,
        ])
        launches = bp_check_phase_qc.launches
        with open(out) as f:
            rows = list(csv.reader(f))
    iterations = sum(r.bp_iterations for r in results)
    for r in results:
        log(f"[main] {r.snr_dB} dB: ber={r.ber:.4e} fer={r.fer:.4f} "
            f"mean iters={r.iters:.2f} frames={r.frames} "
            f"{r.frames_per_s:.1f} frames/s, {r.bp_iterations} BP iterations")
    log(f"[main] kernel launches {launches}, BP iterations {iterations}")
    assert iterations > 0 and launches >= iterations
    assert rows[0] == ["", "EsN0dB", "ber", "fer", "iters"] and len(rows) == 3
    for r in results:
        # the early-exit rule may stop a point after whole rounds
        assert 0 < r.frames <= 512 and r.frames % 128 == 0
        assert 0.0 <= r.ber <= 1.0
    assert results[1].fer <= results[0].fer + 0.05
    kernels["bp_check_phase_qc"]["launches"] = launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import qamreconciliation_tpu_torch  # noqa: F401  (fails outside the repo)
    from qamreconciliation_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"device {torch.cuda.get_device_name(0)}")
    log(smi)

    t0 = time.perf_counter()
    lib = cuda_build.build("bp_check_phase_qc")
    cuda_build.load_library("bp_check_phase_qc")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")

    kernels = {}
    t0 = time.perf_counter()
    phase_kernel(kernels)
    log(f"[kernel] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_decoder()
    log(f"[decoder] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_main_path(kernels)
    log(f"[main] phase {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
