"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each must pass, or the script exits non-zero):
  1. environment: torch version, the card, its power limit (nvidia-smi);
  2. build: the CUDA sources in qamreconciliation_tpu_torch/csrc with nvcc,
     one nvcc per source, all started together;
  3. kernel 1 (bp_check_phase_qc) against its plain PyTorch version on the
     card, bit for bit, at the headline check-phase shape [90, 6, 360, 128],
     every rule and dtype pair, plus a case with +1e30 padded slots; each
     case prints its launch plan (tile, stages, load path); then the dense
     loop's variable pass (bp_var_pass_qc) against its plain version at
     the same shape, B = 128, float32 and bfloat16 with planted -0 priors
     and messages: the totals and the t it writes, bit for bit
     (phase_var_pass); then the softening inputs (softening_inputs)
     against their plain version at [32400, 128], bfloat16 and float32,
     bit for bit, and one launch a round of a softening point
     (phase_softening);
  4. kernel 2 (bp_decode_rounds_qc) against its plain version, bit for bit
     on all four state tensors: one K = 45 call at the headline shape [180,
     360, 128] (E = 540) from a mid-decode state, up to maxiter 50 as the
     main path's 50-iteration chunk runs it, for each rule and dtype pair
     the decoders use; each case prints its launch plan, the ptxas
     registers and spills of its instance, the device launches of the call
     and ms per iteration;
  5. kernel 3 (bp_layered_sweeps_qc) against its plain version, the same
     way: one K = 4 call on the headline code and on a z = 360 QC-IRA code
     (both hold rows with a repeated variable block);
  6. decoders: the dense headline decode on the card (kernel) against the
     plain check phase and the CPU; resident min-sum against dense min-sum
     and resident layered min-sum against the plain serial layered loop,
     bit for bit;
  7. main paths, each with every launch count set to 0 just before it and
     read just after: the dense (float32 and bfloat16; kernel 1 and the
     variable pass once an iteration), resident and resident-layered soft
     reverse-reconciliation sweep CLIs on the headline code, with the
     device launches per wrapper call of the resident ones;
  8. quality watch: the knee FERs of the resident and resident-layered
     CLIs at the JAX package's knee configuration, float32 and bfloat16,
     held to its figures (see phase_knee);
  9. kernel 4 (bp_check_phase_generic) against its plain version at the
     DVB-S2 shapes [7, 32400, 128] (rate 1/2) and [14, 16200, 128] (rate
     3/4) with the codes' masks and random ones, every rule and dtype, and
     kernel 5 (check_node_update_fused) in float32 and bfloat16 at [32400,
     7, 128] and [16200, 14, 128] (the codes' masks) and [8100, 32, 128]
     (a random mask), bit for bit, each case with its plan, ms and its
     instance's ptxas registers and spills (phase_check_major);
 10. the generic decoder on the exact DVB-S2 rate-1/2 H: kernels 4 and
     gather 2's fold against the plain check phase and fold on the card,
     bit for bit;
 11. main paths, counts set to 0 just before each and read just after: the
     generic sweep CLI (no --qc) on the exact rate-1/2 H and the regular
     (3,6) code, the --lift-qc CLI, and kernel 5's check-major update;
 12. quality watch: the exact rate-1/2 H at 3.75 dB in bf16 and float32
     tanh-F/B, held to the JAX package's generic-decoder FER (see
     phase_generic_quality);
 13. the other modes and the bit channels (phase_modes): hard reverse and
     soft direct reconciliation CLIs on the headline code in the dense
     (kernel 1), resident (kernel 2) and resident layered (kernel 3) forms,
     the BI-AWGN sim_decode CLI (soft and --hard) on the exact rate-1/2 H
     (kernel 4), counts set to 0 just before each CLI and read just after;
     one hard and one direct round on the same inputs through kernel 1 and
     through the plain check phase, bit for bit; quality watches of hard,
     direct (DVB-S2 rate-1/2 full-wrap QC, resident bf16) and BSC (sim_bsc
     --qc, rate-3/4 full-wrap QC, kernel 1) held to the JAX package's CPU
     FERs (see MODE_WATCHES);
 14. the sweep surface (phase_sweep_surface): the LLR modes (poly, table,
     interp, search) with the dense (kernel 1) and resident (kernel 2)
     CLIs, the CDF modes at bps 4, --rounds-per-dispatch and --point-batch
     against the plain sweep (identical rows; kernels 1 and 4 at B = 384
     bit for bit), --profile-dir, entry() (kernel 4, and kernel 4 bit for
     bit at its shape [6, 512, 32]) and the C++ oracle against the dense
     decode, counts set to 0 just before each CLI and
     read just after;
 15. streaming and mutual information (phase_streaming): kernels 1-3 at the
     stream batch B = 64 and at B = 8 and kernel 4 at B = 64 against their
     plain versions bit for bit; stream_fused at the JAX bench's streaming
     configuration with the resident (kernel 2), dense (kernel 1) and
     resident layered (kernel 3) min-sum decoders and the generic one on the
     exact rate-1/2 H (kernel 4); the split and handoff drivers identical
     to it on the same frames; a host-time breakdown of one fused batch;
     MC-MI samples/s and its estimates against the host quadrature, a
     4096-configuration batched call at bps 4, the compare-signs CLI;
 16. multi-device reconciliation (phase_multidevice): two ranks on the card
     (gloo), kernels 4 and 1 at one rank's shapes [7, 16200, 128] and [90,
     6, 180, 128] bit for bit; gloo's send/recv on CUDA tensors probed in
     two ranks of their own; the collectives' ms beside Mesh.exchange's for
     the headline code's roll windows, with the elements a rank receives an
     iteration beside an all-gather's; frame-shard rounds of kernels 1-4 whose
     world-2 counters equal the sum of the ranks' single rounds, frames/s
     at world 2 beside world 1; ShardedDecoder (DVB-S2 1/2) against the
     single-device decoder (success, iters and finals as the tests bind
     them), ShardedQCDecoder torch.equal to it, with its ms an iteration
     and each rank's peak memory over the decode below world 1's; the
     --devices 2 and --graph-shard CLIs (one CSV,
     rank 0's) and the knee watch at --devices 2; the frame-sharded
     stream_fused equal to the single-device one; dryrun_multichip(2);
 17. the Tail (phase_tail): compressed-state min-sum against the dense
     min-sum decode through kernel 1 on identical headline inputs (bf16,
     3.5 dB), torch.equal on success, iters and finals, ms an iteration of
     both; the --sr-messages CLI on the headline at 3.5 / 4.0 dB (kernel 1
     launched no time) and its knee watch held to the JAX package's CPU
     figure; 8 headline frames of the numpy softening oracle through
     DecoderNp on the host and the dense decoder on the card, success and
     hard decisions equal;
 18. the bench (phase_bench): ``python3 -m qamreconciliation_tpu_torch.bench``
     in a subprocess at its defaults, its baseline budget cut to 5 s: one
     JSON line holding every row, the card's name and power limit, each
     decode row equal to its plain version and within its bound; the line
     is printed (after "[bench] ") with the bench's progress;
 19. the experiment campaigns (phase_campaigns, qamreconciliation_tpu_torch/
     scripts), in this process with the counts set to 0 just before each
     and read just after, except the one run as a user runs it: the mode
     comparison on the DVB-S2 rate-1/2 code through run_waterfall
     (softening on the resident engine, kernel 2; hard and direct dense,
     kernel 1) at 3.0, 3.25 and 3.5 dB, 256 frames a point, with the JAX
     CLI's CSV header, hard FER >= 0.9 and softening and direct <= 0.05 at
     3.5 dB, and direct no worse than softening by 4 standard errors at
     every point; ``python -m qamreconciliation_tpu_torch.scripts.
     run_r5_dvbs2 --steps equiv --simloops 256`` in a subprocess, exit 0
     and the full-wrap QC FER within 4 standard errors of the exact H's;
     one run_r5_sp_grid probe ("sp reg tree c50", 2 repetitions) with
     kernel 2 launched;
 20. the attribution probes (phase_probes, qamreconciliation_tpu_torch/
     scripts/probe_*.py): the ptxas registers and spills of every staged-
     tile instance of kernels 1 and 4, each 80 registers and no spill, as
     the parent's, and of kernel 6's own instances (none spills); kernel 6
     (check_math_probe) against its plain version bit for bit in its three
     maths, bf16 and f32, at [18, 6, 1800, 128], on two ragged shapes and
     on a dc = 12 shape, each case asserting its plan's path and slots and
     logging its ms, plan, bytes, bound and share (the three maths timed in
     turns in one window, with kernel 1's phi on the same tiles at the
     first shape, bf16 and f32, and their ratio; the plain versions in a
     window of their own), and the issue floor of kernel 6's phi
     instances from their SASS (sims/sass_floor.py) beside the bound;
     kernel 7 (elementwise_chain) bit for bit in both modes
     and dtypes at [512, 1024] (4 x 16 steps, and an odd unaligned view),
     timed at the probe's 8000 x 16 steps (its operations bound at the
     packed bf16 rate for bf16, and the exp steps also by their MUFU.EX2s
     at the special-function units' rate, utils/perf.SFU_OPS_PER_S), the
     bf16 mac case bit for bit there too;
     then every
     variant of the six probes at N = 64800, B = 128 (--iters, --reps and
     --p cut): one of each in a subprocess, as a user runs it, all six side
     by side, and the rest through their main() in this process, every
     count set to 0 just before them and read just after (kernels 6, 7 and
     1 launched); each probe's records are logged after "[probe]", the
     first naming the card;
 21. the last probes (phase_probes_tail): kernels 2 and 3 keep the
     parent's ptxas registers with no spill (RESIDENT_PTXAS) after their
     check pass moved into bp_resident.cuh; kernel 9
     (resident_bookkeeping_probe) against its plain version bit for bit in
     its four variants (nobook, violonly, nocapture, full) on both of its
     paths (the TMA ring of c2v rows, "bulk", and the direct loads,
     "thread"; each case asserts its plan's path): on z = 64 (bulk) and
     z = 60 (thread) codes with B = 40 and at the probe's [36, 1800, 128]
     from a state whose frames converge at the first step, at later steps
     and never (iters, done and the full capture fire), and from the
     probe's own inputs at [36, 1800, 128] (bulk) and [36, 1804, 128]
     (thread), each variant timed there in turns with kernel 2's min-sum
     step on the same inputs and K (ms an iteration and their ratio) and
     with a one-step call (the time of a step beyond the first), with its
     ptxas registers and spills (none), bytes, bound and share;
     kernel 8 (smem_ceiling_probe) at every probe size:
     up to the card's opt-in limit bit-equal to its plain version (4.0 on
     ones), one KiB past it refused with cudaErrorInvalidValue, then the
     sizes again in descending order with no attribute call (bit-equal),
     and its call at the limit timed in turns with an empty kernel's
     launch (the launch floor) and its plain version, 20 calls a run; then
     probe_vmem, probe_resident_vmem, probe_fb_form, probe_decode,
     probe_round and probe_streaming, one of each in a subprocess as a user
     runs it, all six side by side, the rest through main() in this
     process with every count set to 0 just before them and read just after
     (kernels 8, 9 and 1-4 launched: probe_decode's variants run the dense
     QC, generic, resident and resident layered decoders), and
     probe_fb_form's two labels torch.equal at each z.
Kernel and plain times are CUDA-event medians, taken in turns (kernels 1, 4
and 5 over runs of 10 calls, whose host overhead the card's work hides;
kernels 2 and 3 run K steps a call and report ms per step).  Each
kernel's record holds the bytes its main-path call must move (each input
read once, each output written once; for kernels 2 and 3 once per call of
K steps), its bound (the larger of those bytes at 3.35 TB/s and its f32
operations at 33.5e12 a second, the H100 SXM's data-sheet 67 TFLOP/s with
an FMA counted as two; per step for kernels 2 and 3; kernel 7's bf16
record at the packed bf16 rate, 66.9e12 a second: 133.8 TFLOP/s of
non-tensor bf16, the Hopper white paper's figure) and its time's share
of that bound.  Kernel 6's record is the probe's default, bf16 phi at
[18, 6, 1800, 128], with kernel 1's phi time beside it; kernel 7's bf16
mac at the probe's defaults; kernel 8's at the opt-in limit, with the
empty launch's time; kernel 9's the full variant at the probe's
defaults, per iteration of a K = 8 call.  The
bound is the function's, not the build's: the
operations are those of the plain version, a transcendental counted as
one.  The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}.  Needs CUDA; exits
2 without it.

    python3 chip_smoke.py --sass DIR

also writes each kernel library's ptxas report (registers, spills) and its
SASS (cuobjdump -sass) into DIR.
"""

import contextlib
import csv
import importlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from qamreconciliation_tpu_torch.sims.time_check_phase import events_ms
from qamreconciliation_tpu_torch.utils import perf
from qamreconciliation_tpu_torch.utils.perf import (
    HBM_BYTES_PER_S, tensor_bytes as moved,
)

SHAPE = (90, 6, 360, 128)              # [nb_c, dc, z, B] of the headline code
CODE = dict(nb_v=180, z=360, dv=3, dc=6, seed=12345)
# the JAX package's knee configuration (BASELINE.md, docs/img/r5_knee.jsonl):
# QC(3,6) at z = 1800, 1024 frames at 3.5 dB, maxiter 50, early exit off
KNEE_CODE = dict(nb_v=36, z=1800, dv=3, dc=6, seed=12345)
# its FERs on the TPU (flooding: dense, which the JAX resident decoder
# equals; docs/img/r5_knee.jsonl)
KNEE_FER = {("flooding", "float32"): 0.4170, ("layered", "float32"): 0.1328,
            ("flooding", "bfloat16"): 0.5889, ("layered", "bfloat16"): 0.2783}
# the JAX package's own bf16 figures at that configuration on the CPU, whose
# IEEE bf16 roundings the card's match (scripts/run_r5_knee.py --configs
# "dense bf16 tanhfb RTN,layered bf16" with JAX_PLATFORMS=cpu): the bf16
# CLIs are held to these and printed beside the TPU figures
KNEE_FER_CPU = {("flooding", "bfloat16"): 0.5283203125,
                ("layered", "bfloat16"): 0.216796875}
ALTERNATING = np.array([0, 1, 0, 1], np.uint8)
CSRC = "qamreconciliation_tpu_torch/csrc"
PALLAS = "qamreconciliation_tpu/ops/pallas_kernels.py"
# wrapper in ops/kernels.py -> (its source in csrc/, the TPU kernel it
# replaces); kernel 5 is a second kernel in kernel 4's source; the dense
# variable pass replaces XLA's gather and sum of the JAX package's dense
# loop; kernels 6 to 9 replace the Pallas kernels of four of the JAX
# package's probes
KERNELS = {
    "bp_check_phase_qc": ("bp_check_phase_qc", f"{PALLAS}:158"),
    "bp_var_pass_qc": ("bp_var_totals_generic",
                       "qamreconciliation_tpu/models/qc_decoder.py:1218"),
    "bp_decode_rounds_qc": ("bp_decode_rounds_qc", f"{PALLAS}:580"),
    "bp_layered_sweeps_qc": ("bp_layered_sweeps_qc", f"{PALLAS}:1185"),
    "bp_check_phase_generic": ("bp_check_phase_generic", f"{PALLAS}:224"),
    "check_node_update_fused": ("bp_check_phase_generic", f"{PALLAS}:340"),
    "check_math_probe": ("check_math_probe",
                         "scripts/probe_check_math.py:82"),
    "elementwise_chain": ("elementwise_chain",
                          "scripts/probe_bf16pack.py:76"),
    "smem_ceiling_probe": ("smem_ceiling_probe", "scripts/probe_vmem.py:32"),
    "resident_bookkeeping_probe": ("resident_bookkeeping_probe",
                                   "scripts/probe_resident_vmem.py:155"),
    "softening_inputs": ("softening_inputs",
                         "qamreconciliation_tpu/sims/engine.py:262"),
}
# kernels 6-9 run only in their probes (phases 20 and 21); the softening
# inputs run before the decode (phase_softening); the rest are the decode
# paths' kernels
PROBE_KERNELS = ("check_math_probe", "elementwise_chain",
                 "smem_ceiling_probe", "resident_bookkeeping_probe")
PREAMBLE_KERNELS = ("softening_inputs",)
DECODE_KERNELS = tuple(n for n in KERNELS
                       if n not in PROBE_KERNELS + PREAMBLE_KERNELS)


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


def reset_counts():
    from qamreconciliation_tpu_torch.ops import kernels as K

    for name in KERNELS:
        fn = getattr(K, name)
        fn.launches = 0
        if hasattr(fn, "iterations"):
            fn.iterations = 0
            fn.device_launches = 0


def counts():
    from qamreconciliation_tpu_torch.ops import kernels as K

    return {name: getattr(K, name).launches for name in KERNELS}


def record(kernels, name, **kw):
    source, replaces = KERNELS[name]
    kernels.setdefault(name, dict(
        name=name, route="cuda", source=f"{CSRC}/{source}.cu",
        replaces=replaces, launches=None, library_ms=None,
    )).update(kw)


def finish_record(rec):
    """bound_ms, bound_by and bound_share from the entry's bytes, ops and
    ms (``utils/perf.bound``, at the entry's ``ops_per_s``, default the f32
    rate).  A multi-step kernel's bytes are those of its call of ``steps``
    steps and its ops and ms those of one step, so its bound is per
    step."""
    rec["bound_ms"], rec["bound_by"] = perf.bound(
        rec["bytes"], rec["ops"], rec.get("steps", 1),
        rec.get("ops_per_s", perf.F32_OPS_PER_S))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def plan_text(plan):
    """A staged-tile plan (kernels 1, 4 and 5) as text."""
    threads = getattr(plan, "threads", None)
    block = (f"{threads} threads x {plan.blocks_per_sm} an SM, "
             if threads else "")
    return (f"{plan.path} {plan.checks}x{plan.frames} tile, {plan.stages} "
            f"stage(s), {block}{plan.grid} blocks, {plan.smem} B smem")


def resident_plan_text(plan):
    return (f"layout ({plan.layout}), {plan.frames} frame a block, "
            f"{plan.threads} threads, cluster {plan.cluster}, totals in "
            f"{plan.totals} memory, {plan.smem} B smem, {plan.grid} blocks "
            f"({plan.blocks_per_sm} an SM)")


# ptxas's report of each library, by source (filled by build_all)
PTXAS = {}
# sources whose kernel instances may not spill
NO_SPILL = ("bp_decode_rounds_qc", "bp_layered_sweeps_qc",
            "bp_check_phase_qc", "bp_check_phase_generic",
            "check_math_probe", "elementwise_chain", "smem_ceiling_probe",
            "resident_bookkeeping_probe")


# mangled template argument of each message dtype
MANGLED = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16"}


def ptxas_of(source, kernel, rule, *dtypes):
    """'N registers, M bytes spill stores' of the instance of ``kernel``
    with template arguments ``dtypes`` and ``rule`` in ``source``'s
    library, from ptxas's report (its mangled name)."""
    from qamreconciliation_tpu_torch.ops.kernels import RULES

    args = "".join("S1_" if i and dt == dtypes[i - 1] == torch.bfloat16
                   else MANGLED[dt] for i, dt in enumerate(dtypes))
    return ptxas_entry(source,
                       f"{len(kernel)}{kernel}I{args}Li{RULES[rule]}E")


def ptxas_entry(source, key):
    """'N registers, M bytes spill stores' of the kernel instance whose
    mangled name holds ``key``, from ptxas's report of ``source``."""
    from qamreconciliation_tpu_torch.ops.cuda_build import ptxas_usage

    use = ptxas_usage(PTXAS[source], key)
    return (f"{use['registers']} registers, {use['spill_stores']} bytes "
            "spill stores")


def build_all(sass_dir=None):
    """Build every source in parallel and load it; print each library's
    registers and spills per kernel instance from ptxas.  With
    ``sass_dir``, write each library's ptxas report and SASS there."""
    from qamreconciliation_tpu_torch.ops import cuda_build

    sources = sorted({source for source, _ in KERNELS.values()})
    t0 = time.perf_counter()
    libs = cuda_build.build_all(sources)
    log(f"[build] {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for source, lib in zip(sources, libs):
        report = PTXAS[source] = cuda_build.ptxas_report(lib)
        if source in NO_SPILL:
            spills = re.findall(r"(\d+) bytes spill stores", report)
            assert spills and not any(map(int, spills)), \
                f"{source}: an instance spills"
        for line in report.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[ptxas] {lib.name.split('-')[0]}: "
                    f"{line.split(':', 1)[-1].strip()}")
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            stem = lib.name.split("-")[0]
            with open(os.path.join(sass_dir, f"{stem}.ptxas.txt"), "w") as f:
                f.write(report)
            sass = subprocess.run(
                [cuda_build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                capture_output=True, text=True, check=True, timeout=300)
            with open(os.path.join(sass_dir, f"{stem}.sass"), "w") as f:
                f.write(sass.stdout)


def softening_frames(dec, mat, groups, seed=7):
    """Softening LLRs [V, B] and syndromes [C, B] on the card for ``dec``,
    frames drawn in groups of (snr_dB, frames) so that a batch mixes frames
    that converge at once, within a few iterations, and not at all."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    synd_fn = getattr(dec, "syndrome_from_bits", None) \
        or dec.graph.syndrome_from_bits
    llrs, synds = [], []
    for i, (snr, frames) in enumerate(groups):
        eng = ReconciliationEngine(dec, mat, PAMAlphabet(2, 2.0),
                                   batch=frames)
        nm = eng.make_noisemapper(snr, ALTERNATING)
        x, y = eng._sample_sb(round_generator(seed, i, "cuda"),
                              math.sqrt(eng.noise_var(snr)))
        lappr, word = eng._softening_inputs(nm, x, y, 1.0)
        llrs.append(lappr)
        synds.append(synd_fn(word))
    return torch.cat(llrs, 1), torch.cat(synds, 1)


def softening_llrs(base, z, groups, seed=7):
    """:func:`softening_frames` of the QC code ``(base, z)``, with its
    QCDecoder."""
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import QCDecoder

    dec = QCDecoder(base, z, device="cuda")
    return (*softening_frames(dec, Matrix(dec.vid, dec.cid), groups, seed),
            dec)


# mixed-SNR frames of the kernel phases: 7 dB converges at once, 4.5 dB
# within a few iterations, 2.5 dB not at all
MIXED = ((7.0, 32), (4.5, 64), (2.5, 32))


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

    rec = None
    for rule, kw, td, md, tt in cases:
        args = (tt.to(td).contiguous(), c2v.to(md).contiguous(), synd)
        got, gviol = bp_check_phase_qc(*args, rule=rule, **kw)
        plan = bp_check_phase_qc.plan
        want, wviol = bp_check_phase_qc_ref(*args, rule=rule, **kw)
        torch.cuda.synchronize()
        assert torch.equal(gviol, wviol), "violation counts differ"
        if tt is t:
            conv = gviol.sum(0) == 0
            assert bool(conv[: B // 4].all()) and not bool(conv.all())
        assert plan.path == "staged", plan
        err = check_close(got, want, rule, md)
        name = (f"{rule}{'(a=1,b=0.3)' if kw else ''} "
                f"t={str(td)[6:]} c2v={str(md)[6:]}"
                f"{' padded' if tt is t_irr else ''}")
        assert torch.equal(got, want), f"kernel 1 {name}: not bit-equal"
        ms, plain_ms = events_ms(
            lambda: bp_check_phase_qc(*args, rule=rule, **kw),
            lambda: bp_check_phase_qc_ref(*args, rule=rule, **kw),
            reps=10, run=10,
        )
        nbytes = moved(*args, got, gviol)
        log(f"[kernel1] {name:45s} bit-equal kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  {nbytes / ms / 1e6:.1f} GB/s  "
            f"[{plan_text(plan)}]")
        if rec is None:              # the headline case: f32 phi
            work = perf.check_phase_qc_work(*SHAPE, td, md, rule)
            assert work[0] == nbytes, (work, nbytes)
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bytes=work[0], ops=work[1])
    record(kernels, "bp_check_phase_qc", **rec)


def phase_var_pass(kernels):
    """The dense loop's variable pass against its plain version on the
    headline code at [90, 6, 360, 128], float32 and bfloat16 (the dense
    cell's instance, 8 frames a thread): the totals and t, bit for bit,
    zero signs included; the bfloat16 case is the kernel's record."""
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_var_pass_qc, bp_var_pass_qc_ref,
    )

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    B = SHAPE[-1]
    gen = torch.Generator(device="cuda").manual_seed(3)

    def draw(shape, scale):
        """Normal draws with a share of exact +0 and -0."""
        x = scale * torch.randn(shape, generator=gen, device="cuda")
        pick = torch.rand(shape, generator=gen, device="cuda")
        return torch.where(pick < 0.05, 0.0,
                           torch.where(pick < 0.1, -0.0, x))

    prior, c2v, other = (draw((CODE["nb_v"], CODE["z"], B), 3.0),
                         draw(SHAPE, 4.0),
                         draw((CODE["nb_v"], CODE["z"], B), 2.0))
    for dtype in (torch.float32, torch.bfloat16):
        dec = QCDecoder(base, CODE["z"], dtype, device="cuda")
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        t = dec.gather_totals(other.to(dtype))
        assert tuple(t.shape) == SHAPE
        t_plain = t.clone()
        args = (prior.to(dtype), c2v.to(dtype), dec._var_rows,
                dec._var_degree)
        got = bp_var_pass_qc(*args, t)
        want = bp_var_pass_qc_ref(*args, t_plain)
        torch.cuda.synchronize()
        name = f"{str(dtype)[6:]} B={B}"
        assert torch.equal(got.view(bits), want.view(bits)), \
            f"variable pass {name}: totals not bit-equal"
        assert torch.equal(t.view(bits), t_plain.view(bits)), \
            f"variable pass {name}: t not bit-equal"
        vec = bp_var_pass_qc.vec
        assert vec == 16 // got.element_size(), vec
        ms, plain_ms = events_ms(lambda: bp_var_pass_qc(*args, t),
                                 lambda: bp_var_pass_qc_ref(*args, t_plain),
                                 reps=10, run=10)
        nbytes, ops = perf.var_pass_qc_work(int(dec._var_degree.sum()),
                                            dec.vnum, B, dtype)
        bound_ms = perf.bound(nbytes, ops)[0]
        log(f"[var pass] {name:14s} totals and t bit-equal kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({100 * bound_ms / ms:.1f}%)  {vec} frames a thread")
        if dtype == torch.bfloat16:
            record(kernels, "bp_var_pass_qc", max_abs_err=0.0, ms=ms,
                   plain_ms=plain_ms, bytes=nbytes, ops=ops)


def phase_softening(kernels):
    """The softening inputs against their plain version at the cells'
    shape [32400, 128] (4-PAM), bfloat16 and float32, at 3.5 and 4.0 dB,
    with the sign configurations 0 and alternating, 4 rounds each and 1
    sample in 32 on a threshold or a constellation point: the LLRs and the
    word bit for bit; the kernel's ms beside the plain version's and the
    bytes bound (the bfloat16 case is the kernel's record); then a
    softening point through the engine, one launch a round."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import (
        softening_inputs, softening_inputs_ref,
    )
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, bf16_normal,
    )

    pa = PAMAlphabet(2, 2.0)
    S, B = CODE["nb_v"] * CODE["z"] // 2, SHAPE[-1]
    s2b = torch.as_tensor(pa.s_to_b.astype(np.int32), device="cuda")
    spots = [float(t) for t in pa.thresholds[1:-1]] + list(pa.constellation)
    gen = torch.Generator(device="cuda").manual_seed(27)
    for dtype in (torch.bfloat16, torch.float32):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for snr in (3.5, 4.0):
            sigma = math.sqrt(pa.variance * 10 ** (-snr / 10) / 2)
            for signs in (None, ALTERNATING):
                nm = NoiseMapper(pa, sigma ** 2, signs, dtype=dtype,
                                 device="cuda")
                for r in range(4):
                    x = pa.random_symbols(gen, (S, B), "cuda")
                    noise = (bf16_normal(gen, (S, B), "cuda")
                             if dtype == torch.bfloat16 else
                             torch.randn((S, B), generator=gen,
                                         device="cuda"))
                    y = pa.index_to_value(x, dtype) \
                        + torch.tensor(sigma, dtype=dtype) * noise
                    pick = torch.randint(0, len(spots), (S, B),
                                         generator=gen, device="cuda")
                    y = torch.where(
                        torch.rand((S, B), generator=gen, device="cuda")
                        < 1 / 32,
                        torch.tensor(spots, dtype=dtype,
                                     device="cuda")[pick], y).contiguous()
                    args = (nm, x, y, 1.0 if r else 0.8, s2b)
                    got, word = softening_inputs(*args)
                    want, wword = softening_inputs_ref(*args)
                    torch.cuda.synchronize()
                    name = (f"{str(dtype)[6:]} {snr} dB signs "
                            f"{'alt' if signs is not None else 0} round {r}")
                    assert torch.equal(got.view(bits), want.view(bits)), \
                        f"softening inputs {name}: LLRs not bit-equal"
                    assert torch.equal(word, wword), \
                        f"softening inputs {name}: word not bit-equal"
            args = (nm, x, y, 1.0, s2b)
            ms, plain_ms = events_ms(lambda: softening_inputs(*args),
                                     lambda: softening_inputs_ref(*args),
                                     reps=10, run=10)
            nbytes, ops = perf.softening_inputs_work(S, B, pa.order,
                                                     pa.bit_per_symbol,
                                                     dtype)
            bound_ms = perf.bound(nbytes, ops)[0]
            log(f"[softening] {str(dtype)[6:]} {snr} dB [{S}, {B}] LLRs and "
                f"word bit-equal (16 rounds) kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({100 * bound_ms / ms:.1f}%)  "
                f"{softening_inputs.vec} frames a thread")
            if dtype == torch.bfloat16 and snr == 3.5:
                record(kernels, "softening_inputs", max_abs_err=0.0, ms=ms,
                       plain_ms=plain_ms, bytes=nbytes, ops=ops)
    # the main path: a softening point through the engine, a launch a round
    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    dec = QCDecoder(base, CODE["z"], "bfloat16", device="cuda",
                    resident=True)
    eng = ReconciliationEngine(dec, Matrix(vid, cid), pa, batch=B,
                               dtype="bfloat16", rounds_per_dispatch=2)
    reset_counts()
    res = eng.run_point("softening", 4.0, 50, 4 * B, 4 * B + 1,
                        nmconfig=[0] * 4, seed=2 ** 31 + 27)
    launches = counts()["softening_inputs"]
    assert res.frames == 4 * B and launches == 4, (res.frames, launches)
    log(f"[softening] a 4-round softening point: {launches} launches")
    record(kernels, "softening_inputs", launches=launches)


def compare_state(got, want, what):
    """Raises unless every state tensor is bit-equal to the plain
    version's; returns the largest |difference| of the float ones (0)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), \
            f"{what}: not bit-equal"
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want) if g.is_floating_point())


def phase_rounds(kernels):
    """Kernel 2 at the headline shape from a mid-decode state (5 plain
    iterations on mixed-SNR softening LLRs), one call of K = 45 iterations
    up to maxiter 50 (the main path runs 50-iteration calls), bit for bit
    on all four state tensors."""
    from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_decode_rounds_qc, bp_decode_rounds_qc_ref,
    )

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    lappr, synd, dec = softening_llrs(base, CODE["z"], MIXED)
    tables = dec.tables
    z, B, warm, maxiter = CODE["z"], lappr.shape[1], 5, 50
    K = maxiter - warm
    synd8 = synd.reshape(tables.nb_c, z, B).to(torch.int8).contiguous()
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("minsum", f32, f32), ("minsum", bf16, bf16),
             ("tanhfb", bf16, bf16), ("sumproduct", f32, f32),
             ("tanhfb", f32, bf16)]
    for rule, td, md in cases:
        prior = lappr.to(md).reshape(tables.nb_v, z, B).contiguous()
        state = [prior.to(td, copy=True),
                 torch.zeros((tables.E, z, B), dtype=md, device="cuda"),
                 prior, synd8,
                 torch.zeros(B, dtype=torch.int32, device="cuda"),
                 torch.zeros(B, dtype=torch.int32, device="cuda")]
        bp_decode_rounds_qc_ref(tables, 0, maxiter, *state, rule=rule,
                                k_rounds=warm)
        done0 = int(state[4].sum())
        want = [x.clone() for x in state]
        d0 = bp_decode_rounds_qc.device_launches
        bp_decode_rounds_qc(tables, warm, maxiter, *state, rule=rule,
                            k_rounds=K)
        launched = bp_decode_rounds_qc.device_launches - d0
        plan = bp_decode_rounds_qc.plan
        bp_decode_rounds_qc_ref(tables, warm, maxiter, *want, rule=rule,
                                k_rounds=K)
        torch.cuda.synchronize()
        done1 = int(want[4].sum())
        # frozen frames and undecided frames both occur in the call
        assert 0 < done0 <= done1 < B, (done0, done1)
        err = compare_state(state[:2] + state[4:], want[:2] + want[4:],
                            f"kernel2 {rule}")
        # the kernel and the plain version timed apart: the plain
        # version's many allocations and launches would otherwise sit
        # between the kernel's calls
        scratch = [x.clone() for x in state]
        ms, = events_ms(lambda: bp_decode_rounds_qc(
            tables, warm, maxiter, *scratch, rule=rule, k_rounds=K),
            reps=5, warmup=1)
        plain_ms, = events_ms(lambda: bp_decode_rounds_qc_ref(
            tables, warm, maxiter, *scratch, rule=rule, k_rounds=K),
            reps=2, warmup=0)
        ms, plain_ms = ms / K, plain_ms / K
        name = f"{rule} total={str(td)[6:]} c2v={str(md)[6:]}"
        log(f"[kernel2] {name:36s} done {done0}->{done1}/{B} bit-equal; "
            f"per iteration: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms; "
            f"{launched} device launches a call of {K}; "
            f"[{resident_plan_text(plan)}] [ptxas: "
            f"{ptxas_of('bp_decode_rounds_qc', 'rounds_kernel', rule, td, md)}]")
        if rule == "tanhfb" and td == md == bf16:     # the headline engine
            # per call: the state in (totals, c2v, prior, synd, done,
            # iters) and out (totals, c2v, done, iters) once; the earlier
            # per-iteration stream (totals and prior in, c2v in and out,
            # synd in, totals out) beside it
            stream = moved(state[0], state[0], prior, state[1], state[1],
                           synd8)
            log(f"[kernel2] per-iteration stream {stream / 1e6:.1f} MB -> "
                f"{1e3 * stream / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
            nbytes, ops = perf.decode_rounds_work(
                tables.nb_v, tables.nb_c, tables.E, z, B, td, md, rule)
            assert nbytes == moved(*state, state[0], state[1], state[4],
                                   state[5])
            record(kernels, "bp_decode_rounds_qc", max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, steps=K, bytes=nbytes, ops=ops)


def phase_sweeps(kernels):
    """Kernel 3, one K = 4 call (the main path's layered chunk) on the
    headline code and a z = 360 QC-IRA code, from mixed-SNR softening LLRs
    after the plain sweeps that leave the first frames done, bit for bit on
    all four state tensors."""
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        make_qc_ira, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_layered_sweeps_qc, bp_layered_sweeps_qc_ref,
    )

    codes = {
        "headline": make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                 CODE["dc"], seed=CODE["seed"])[0],
        "ira z=360": make_qc_ira(120, 60, CODE["z"], dv=3, seed=1)[0],
    }
    z, K, bf16, f32 = CODE["z"], 4, torch.bfloat16, torch.float32
    for label, base in codes.items():
        lappr, synd, dec = softening_llrs(base, z, MIXED)
        tables = dec.tables
        B = lappr.shape[1]
        assert tables.n_defer_slots > 0, "no repeated-variable-block row"
        log(f"[kernel3] {label}: {tables.nb_c} rows in "
            f"{len(tables.levels)} levels, dc_max {tables.dc_max}, "
            f"{tables.n_defer_slots} deferred slots, at most "
            f"{tables.defer_level_slots} in a level")
        synd8 = synd.reshape(tables.nb_c, z, B).to(torch.int8).contiguous()
        for rule, md in (("minsum", f32), ("minsum", bf16),
                         ("sumproduct", f32), ("tanhfb", bf16)):
            state = [lappr.float().reshape(tables.nb_v, z, B).contiguous(),
                     torch.zeros((tables.E, z, B), dtype=md, device="cuda"),
                     synd8, torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.int32, device="cuda")]
            # plain sweeps until the first frames are done (frozen)
            warm = 0
            while warm < 6 and (warm == 0 or not bool(state[3].any())):
                bp_layered_sweeps_qc_ref(tables, warm, 50, *state,
                                         rule=rule, k_sweeps=1)
                warm += 1
            done0 = int(state[3].sum())
            want = [x.clone() for x in state]
            d0 = bp_layered_sweeps_qc.device_launches
            bp_layered_sweeps_qc(tables, warm, 50, *state, rule=rule,
                                 k_sweeps=K)
            launched = bp_layered_sweeps_qc.device_launches - d0
            plan = bp_layered_sweeps_qc.plan
            bp_layered_sweeps_qc_ref(tables, warm, 50, *want, rule=rule,
                                     k_sweeps=K)
            torch.cuda.synchronize()
            done1 = int(want[3].sum())
            if label == "headline":
                assert 0 < done0 <= done1 < B, (done0, done1)
            err = compare_state(state[:2] + state[3:], want[:2] + want[3:],
                                f"kernel3 {label} {rule}")
            scratch = [x.clone() for x in state]
            ms, = events_ms(lambda: bp_layered_sweeps_qc(
                tables, warm, 50, *scratch, rule=rule, k_sweeps=K),
                reps=10, warmup=2)
            plain_ms, = events_ms(lambda: bp_layered_sweeps_qc_ref(
                tables, warm, 50, *scratch, rule=rule, k_sweeps=K),
                reps=2, warmup=0)
            ms, plain_ms = ms / K, plain_ms / K
            log(f"[kernel3] {label} {rule} c2v={str(md)[6:]:9s} done "
                f"{done0}->{done1}/{B} bit-equal; per sweep: kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms; {launched} device "
                f"launches a call of {K}; [{resident_plan_text(plan)}] "
                f"[ptxas: "
                f"{ptxas_of('bp_layered_sweeps_qc', 'sweeps_kernel', rule, md)}]")
            if label == "headline" and rule == "minsum" and md == bf16:
                # per call: the state in (totals, c2v, synd, done, iters)
                # and out (totals, c2v, done, iters) once; the earlier
                # per-sweep stream (totals and c2v in and out, synd in)
                # beside it
                stream = moved(state[0], state[0], state[1], state[1],
                               synd8)
                log(f"[kernel3] per-sweep stream {stream / 1e6:.1f} MB -> "
                    f"{1e3 * stream / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
                nbytes, ops = perf.layered_sweeps_work(
                    tables.nb_v, tables.nb_c, tables.E, z, B, md, rule)
                assert nbytes == moved(*state, state[0], state[1], state[3],
                                       state[4])
                record(kernels, "bp_layered_sweeps_qc", max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, steps=K, bytes=nbytes,
                       ops=ops)


def phase_decoder():
    """The headline code decoded three ways from the same softening LLRs:
    on the card through the kernels, on the card through the plain check
    phase and variable pass, and on the CPU (plain).  Kernels and plain on
    the card must agree bit for bit.  Against the CPU, success, iters and
    the decoded frames' hard decisions must agree and min-sum totals bit
    for bit; sum-product totals drift there, since the CPU's and the
    card's libms differ by an ulp and a decode compounds it over up to 50
    iterations, so their largest relative difference is reported."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_qc_ref, bp_var_pass_qc_ref,
    )
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
        plain.var_pass = bp_var_pass_qc_ref
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
        log(f"[decoder] dense {label}: B={B} {snr} dB: {int(sc.sum())}/{B} "
            f"decoded, iters {ic.tolist()}; kernel == plain on the card "
            f"(bit-equal); vs CPU max rel total diff {rel:.3e}; "
            f"card kernel {1e3 * (t1 - t0):.1f} ms, card plain "
            f"{1e3 * (t2 - t1):.1f} ms, CPU {1e3 * (t3 - t2):.1f} ms")


def phase_resident_decoders():
    """At the headline code, 3.5 dB, B = 128, bf16 min-sum: resident ==
    dense (kernel 2 against kernel 1) and resident layered == the plain
    serial layered loop, bit for bit on (success, iters, final)."""
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    lappr, synd, _ = softening_llrs(base, CODE["z"], ((3.5, 128),), seed=11)
    kw = dict(dtype="bfloat16", device="cuda", check_rule="minsum")
    pairs = (
        ("resident == dense", dict(resident=True, resident_chunk=50),
         dict()),
        ("resident layered == serial plain layered",
         dict(schedule="layered", resident=True),
         dict(schedule="layered", layered_groups=False)),
    )
    for label, kw_a, kw_b in pairs:
        out, ms = [], []
        for extra in (kw_a, kw_b):
            dec = QCDecoder(base, CODE["z"], **kw, **extra)
            t0 = time.perf_counter()
            out.append(dec.decode_batched(lappr, synd, 50))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        for a, b in zip(*out):
            assert torch.equal(a, b), f"{label}: not bit-equal"
        s, i, _ = out[0]
        log(f"[decoder] {label} (bf16 min-sum, B=128, 3.5 dB): bit-equal; "
            f"{int(s.sum())}/128 decoded, mean iters of the decoded "
            f"{float(i[s].float().mean()) if bool(s.any()) else 0:.2f}; "
            f"{ms[0]:.1f} ms vs {ms[1]:.1f} ms (first calls)")


def qc_code(code_base, z):
    """A writer of the QC base-edge CSV, and the flag that reads it."""
    from qamreconciliation_tpu_torch.models.qc_decoder import save_qc_csv

    return (lambda path: save_qc_csv(path, code_base, z)), ["--qc"]


def edge_code(vid, cid, flags=()):
    """A writer of the expanded edge CSV, and ``flags``."""
    from qamreconciliation_tpu_torch.utils.edgefile import save_edge_csv

    return (lambda path: save_edge_csv(path, vid, cid)), list(flags)


# each sweep CLI's CSV point column
CLI_COLUMN = {"sim_reconciliation": "EsN0dB", "sim_bsc": "f",
              "sim_decode": "EbN0dB"}


def run_cli(code, flags, label, cli="sim_reconciliation"):
    """The sweep CLI ``cli`` on a code saved by ``code = (writer, flags)``
    with ``flags``; counts reset just before and read just after.  Returns
    (results, launches, device iterations)."""
    from qamreconciliation_tpu_torch.ops import kernels as K

    module = importlib.import_module(f"qamreconciliation_tpu_torch.sims.{cli}")
    column = CLI_COLUMN[cli]
    write, code_flags = code
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "code.csv")
        out = os.path.join(tmp, "out.csv")
        write(path)
        base = ["--batch", "128", "--maxiter", "50", "--device", "cuda",
                "--out", out]
        if cli == "sim_reconciliation":
            base += ["--bps", "2"]
        reset_counts()
        results = module.main([path, *code_flags, *base, *flags])
        launches = counts()
        multi = ("bp_decode_rounds_qc", "bp_layered_sweeps_qc")
        device_iters = {n: getattr(K, n).iterations for n in multi}
        device_launches = {n: getattr(K, n).device_launches for n in multi}
        with open(out) as f:
            rows = list(csv.reader(f))
    assert rows[0] == ["", column, "ber", "fer", "iters"]
    assert len(rows) == 1 + len(results)
    for r in results:
        log(f"[{label}] {column}={r.snr_dB}: ber={r.ber:.4e} fer={r.fer:.4f} "
            f"mean iters={r.iters:.2f} frames={r.frames} "
            f"{r.frames_per_s:.1f} frames/s, {r.bp_iterations} BP "
            f"iterations on the device")
        assert 0 < r.frames and r.frames % 128 == 0
        assert 0.0 <= r.ber <= 1.0 and 0.0 <= r.fer <= 1.0
    log(f"[{label}] launches {launches}, device iterations {device_iters}")
    for n, d in device_launches.items():
        if launches[n]:
            # the copy of the state in, the K steps, the copy out
            log(f"[{label}] {n}: {d} device launches for {launches[n]} "
                f"wrapper calls, {d / launches[n]:g} a call, for "
                f"{device_iters[n] / launches[n]:.2f} steps a call")
            assert d == 3 * launches[n], (n, d, launches[n])
    return results, launches, device_iters


def phase_main_paths(kernels):
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops import kernels as K

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    z = CODE["z"]
    # dense f32 sum-product (kernel 1)
    res, launches, _ = run_cli(qc_code(base, z), [
        "--snr", "3.5", "4.0", "--nsnr", "2", "--simloops", "256"], "main dense")
    iterations = sum(r.bp_iterations for r in res)
    assert iterations > 0 and launches["bp_check_phase_qc"] == iterations
    assert res[1].fer <= res[0].fer + 0.05
    plan = K.bp_check_phase_qc.plan
    log(f"[main dense] kernel 1 plan: {plan_text(plan)}")
    assert plan.path == "staged"
    dec = QCDecoder(base, z, device="cuda")
    for snr in (3.5, 4.0):
        log_rounds("main dense", dec, Matrix(dec.vid, dec.cid), snr)
    record(kernels, "bp_check_phase_qc",
           launches=launches["bp_check_phase_qc"])
    # the variable pass once an iteration (the gather once a decode)
    assert launches["bp_var_pass_qc"] == iterations, launches
    # dense bf16, the dense cell's instances
    res, launches, _ = run_cli(qc_code(base, z), [
        "--dtype", "bfloat16", "--snr", "3.5", "3.5", "--nsnr", "1",
        "--simloops", "256"], "main dense bf16")
    iterations16 = sum(r.bp_iterations for r in res)
    assert iterations16 > 0
    assert launches["bp_check_phase_qc"] == iterations16, launches
    assert launches["bp_var_pass_qc"] == iterations16, launches
    log(f"[main dense] variable pass launches: {iterations} (float32), "
        f"{iterations16} (bfloat16), one an iteration")
    record(kernels, "bp_var_pass_qc", launches=iterations16)
    # resident bf16 (kernel 2; tanh-F/B by the auto rule), the JAX
    # package's headline engine
    res, launches, dev = run_cli(qc_code(base, z), [
        "--resident", "--dtype", "bfloat16", "--snr", "3.5", "4.0",
        "--nsnr", "2", "--simloops", "512"], "main resident")
    assert launches["bp_decode_rounds_qc"] > 0
    assert dev["bp_decode_rounds_qc"] > 0
    assert dev["bp_decode_rounds_qc"] == sum(r.bp_iterations for r in res)
    assert launches["bp_check_phase_qc"] == 0
    assert res[1].fer <= res[0].fer + 0.05
    log(f"[main resident] kernel 2 plan: "
        f"{resident_plan_text(K.bp_decode_rounds_qc.plan)}")
    assert K.bp_decode_rounds_qc.plan.totals == "shared"
    record(kernels, "bp_decode_rounds_qc",
           launches=launches["bp_decode_rounds_qc"])
    # the cost of chunk-granular early exit: chunk 10 against 50 at 4.0 dB
    res10, _, _ = run_cli(qc_code(base, z), [
        "--resident", "--resident-chunk", "10", "--dtype", "bfloat16",
        "--snr", "4.0", "4.0", "--nsnr", "1", "--simloops", "512"],
        "main resident chunk 10")
    log(f"[main resident] 4.0 dB frames/s: chunk 50 "
        f"{res[1].frames_per_s:.1f}, chunk 10 {res10[0].frames_per_s:.1f}")
    # resident layered bf16 min-sum (kernel 3)
    res, launches, dev = run_cli(qc_code(base, z), [
        "--schedule", "layered", "--resident", "--check-rule", "minsum",
        "--dtype", "bfloat16", "--snr", "3.5", "4.0", "--nsnr", "2",
        "--simloops", "256"], "main layered")
    assert launches["bp_layered_sweeps_qc"] > 0
    assert dev["bp_layered_sweeps_qc"] > 0
    assert launches["bp_check_phase_qc"] == 0
    log(f"[main layered] kernel 3 plan: "
        f"{resident_plan_text(K.bp_layered_sweeps_qc.plan)}")
    record(kernels, "bp_layered_sweeps_qc",
           launches=launches["bp_layered_sweeps_qc"])


def phase_knee():
    """Quality watch at the JAX package's knee configuration.

    The JAX figures are 1024-frame estimates like the port's, so a port FER
    agrees when it lies within 4 standard errors of their difference,
    4 * sqrt(2 p (1 - p) / 1024).  Held to them: the resident flooding and
    resident layered CLIs in float32 (the TPU figures) and in bfloat16 (the
    JAX package's CPU figures; the TPU figures printed beside them, with
    whether they are within the bound), and the same bf16 decoders fed
    float32-sampled frames (the decoders' bf16 precision alone).  With
    --dtype bfloat16 both engines draw the channel in bf16, the port by
    JAX's own bf16 rule (sims/engine.bf16_normal), so the bf16 figures are
    comparable."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine

    z = KNEE_CODE["z"]
    base, vid, cid = make_qc_ldpc(KNEE_CODE["nb_v"], z, KNEE_CODE["dv"],
                                  KNEE_CODE["dc"], seed=KNEE_CODE["seed"])
    common = ["--snr", "3.5", "3.5", "--nsnr", "1", "--simloops", "1024",
              "--ferr-count-min", "1000000000"]
    schedules = {"flooding": (["--resident"], dict(resident=True,
                                                    resident_chunk=50)),
                 "layered": (["--schedule", "layered", "--resident"],
                             dict(schedule="layered", resident=True))}

    def bound(p):
        return 4 * math.sqrt(2 * p * (1 - p) / 1024)

    def check(label, key, fer):
        held = KNEE_FER_CPU.get(key, KNEE_FER[key])
        where = "CPU" if key in KNEE_FER_CPU else "TPU"
        text = (f"[knee] {label:44s} FER {fer:.4f}  JAX {where} {key[1]} "
                f"{held:.4f} (bound +-{bound(held):.4f})")
        if where == "CPU":
            p = KNEE_FER[key]
            inside = abs(fer - p) <= bound(p)
            text += (f"; JAX TPU {p} (+-{bound(p):.4f}, "
                     f"{'within' if inside else 'outside'})")
        log(text)
        assert abs(fer - held) <= bound(held), (label, fer, held)

    for sched, (flags, kw) in schedules.items():
        for dtype in ("float32", "bfloat16"):
            res, _, _ = run_cli(qc_code(base, z),
                                flags + ["--dtype", dtype] + common,
                                f"knee {sched} {dtype}")
            assert res[0].frames == 1024
            check(f"{sched} CLI --dtype {dtype}", (sched, dtype),
                  res[0].fer)
        dec = QCDecoder(base, z, "bfloat16", device="cuda", **kw)
        r = ReconciliationEngine(dec, Matrix(vid, cid), PAMAlphabet(2, 2.0),
                                 batch=128, dtype=torch.float32).run_point(
            "softening", 3.5, 50, 1024, 10 ** 9, nmconfig=ALTERNATING,
            seed=0)
        check(f"{sched} bf16 decoder, float32 samples",
              (sched, "float32"), r.fer)

# ------------------------------------------------------------------------
# The generic decoder (kernels 4 and 5) on the DVB-S2 codes

# the JAX package's generic-decoder figure on the exact rate-1/2 H
# (docs/img/r5_dvbs2.jsonl, step wrap_equivalence, exact_generic: 1024
# frames at 3.75 dB, bf16 tanh-F/B)
DVBS2_FER, DVBS2_ITERS = 0.0009765625, 22.266862170087972
# the JAX bench's non-QC headline code (bench.py:226-230)
REGULAR = dict(n=64800, dv=3, dc=6, seed=12345)
_CODES = {}


def dvbs2_code(rate):
    """(vid, cid) of the exact DVB-S2 H at ``rate`` (models/dvbs2: the
    synthetic table of seed 0, the wrap circulant's missing edge dropped),
    built once."""
    from qamreconciliation_tpu_torch.models.dvbs2 import (
        expanded_edges, make_table,
    )

    if rate not in _CODES:
        _CODES[rate] = expanded_edges(make_table(rate, seed=0))
    return _CODES[rate]


def generic_inputs(mask, B, seed):
    """Random t, c2v [dc, C, B] and a syndrome that a quarter of the frames
    satisfy (both convergence outcomes occur)."""
    dc, C = mask.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = 3.0 * torch.randn((dc, C, B), generator=gen, device="cuda")
    c2v = torch.randn((dc, C, B), generator=gen, device="cuda") \
        * mask[:, :, None]
    synd = torch.randint(0, 2, (C, B), generator=gen, device="cuda",
                         dtype=torch.int32)
    par = torch.sum((t < 0).int() * mask.int()[:, :, None], 0) & 1
    synd[:, : B // 4] = par[:, : B // 4]
    return t, c2v, synd


def phase_generic_kernels(kernels):
    """Kernel 4 against its plain version at the rate-1/2 shape [7, 32400,
    128] and the rate-3/4 shape [14, 16200, 128] with the codes' masks,
    every rule and dtype, plus random non-prefix masks; then kernel 5
    (phase_check_major).  All bit for bit."""
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_generic, bp_check_phase_generic_ref,
    )

    B = 128
    rules = (("sumproduct", {}), ("tanhfb", {}), ("minsum", {}),
             ("minsum", dict(ms_alpha=1.0, ms_beta=0.3)))
    for rate in ("1/2", "3/4"):
        g = TannerGraph(*dvbs2_code(rate), device="cuda")
        code_mask = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                                    device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        rand_mask = (torch.rand(code_mask.shape, generator=gen,
                                device="cuda") < 0.8).float()
        cases = [(rule, kw, dt, "code") for rule, kw in rules
                 for dt in (torch.float32, torch.bfloat16)]
        cases += [("sumproduct", {}, torch.float32, "random"),
                  ("minsum", {}, torch.bfloat16, "random")]
        data = {"code": (code_mask, generic_inputs(code_mask, B, 1)),
                "random": (rand_mask, generic_inputs(rand_mask, B, 2))}
        for rule, kw, dt, which in cases:
            mask, (t, c2v, synd) = data[which]
            args = (t.to(dt), c2v.to(dt), synd, mask)
            got, gviol = bp_check_phase_generic(*args, rule=rule, **kw)
            want, wviol = bp_check_phase_generic_ref(*args, rule=rule, **kw)
            torch.cuda.synchronize()
            assert torch.equal(gviol, wviol), "violation counts differ"
            conv = gviol.sum(0) == 0
            assert bool(conv[: B // 4].all()) and not bool(conv.all())
            assert torch.equal(got, want), \
                f"kernel 4 {rate} {rule} {dt} {which}: not bit-equal"
            plan = bp_check_phase_generic.plan
            assert plan.path == "staged", plan
            err = float((got.float() - want.float()).abs().max())
            ms, plain_ms = events_ms(
                lambda: bp_check_phase_generic(*args, rule=rule, **kw),
                lambda: bp_check_phase_generic_ref(*args, rule=rule, **kw),
                reps=5, warmup=2, run=10,
            )
            name = (f"{rule}{'(a=1,b=0.3)' if kw else ''} {str(dt)[6:]} "
                    f"{which} mask")
            nbytes = moved(*args, got, gviol)
            log(f"[kernel4] rate {rate} {tuple(t.shape)} {name:34s} "
                f"bit-equal kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"{nbytes / ms / 1e6:.1f} GB/s  [{plan_text(plan)}]")
            if (rate, rule, kw, dt, which) == ("1/2", "sumproduct", {},
                                               torch.float32, "code"):
                work = perf.check_phase_generic_work(*t.shape, dt, rule)
                assert work[0] == nbytes, (work, nbytes)
                record(kernels, "bp_check_phase_generic", max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bytes=work[0],
                       ops=work[1])
    phase_check_major(kernels)


def phase_check_major(kernels):
    """Kernel 5 against its plain version, bit for bit, in float32 and
    bfloat16: [32400, 7, 128] (the exact DVB-S2 rate-1/2 H and its mask),
    [16200, 14, 128] (rate 3/4) and [8100, 32, 128] with a random mask;
    each case prints its plan, ms (CUDA events over runs of 10 calls) and
    its instance's ptxas registers and spills."""
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.ops.kernels import (
        check_node_update_fused, check_node_update_fused_ref,
    )

    B = 128
    masks = {}
    for rate in ("1/2", "3/4"):
        g = TannerGraph(*dvbs2_code(rate), device="cuda")
        masks[rate] = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    masks["dc 32"] = (torch.rand((32, 8100), generator=gen, device="cuda")
                      < 0.8).float()
    for dt in (torch.float32, torch.bfloat16):
        regs = ptxas_entry("bp_check_phase_generic",
                           f"check_major_tile_kernelI{MANGLED[dt]}E")
        log(f"[kernel5] {str(dt)[6:]} instance: ptxas {regs}")
        assert regs.endswith(" 0 bytes spill stores"), "kernel 5 spills"
    for which, mask in masks.items():
        t, _, synd = generic_inputs(mask, B, 3)
        v32 = t.transpose(0, 1).contiguous()
        cmask = mask.T.contiguous()
        for dt in (torch.float32, torch.bfloat16):
            args = (v32.to(dt), synd, cmask)
            got = check_node_update_fused(*args)
            want = check_node_update_fused_ref(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), \
                f"kernel 5 {which} {dt}: not bit-equal"
            plan = check_node_update_fused.plan
            assert plan.path == "staged", plan
            ms, plain_ms = events_ms(
                lambda: check_node_update_fused(*args),
                lambda: check_node_update_fused_ref(*args),
                reps=5, warmup=2, run=10)
            nbytes = moved(args[0], synd, cmask, got)
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            log(f"[kernel5] {which} {tuple(args[0].shape)} {str(dt)[6:]} "
                f"phi bit-equal kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                f"  {nbytes / 1e6:.1f} MB, memory bound {bound:.4f} ms "
                f"({100 * bound / ms:.1f}%)  [{plan_text(plan)}]")
            if which == "1/2" and dt == torch.float32:
                work = perf.check_node_update_work(*got.shape, dt)
                assert work[0] == nbytes, (work, nbytes)
                record(kernels, "check_node_update_fused", max_abs_err=float(
                    (got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                    bytes=work[0], ops=work[1])


def phase_generic_decoder():
    """The rate-1/2 generic decoder on the card (kernel 4 and gather 2's
    fold kernel) against the same decoder with the plain check phase and
    fold on the card, bit for bit on (success, iters, final), min-sum in
    f32 and bf16, and f32 phi; B = 128 frames at mixed SNRs around the
    knee."""
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_generic_ref, bp_var_totals_generic_ref,
    )

    vid, cid = dvbs2_code("1/2")
    mat = Matrix(vid, cid)
    probe = Decoder(vid, cid, device="cuda")
    lappr, synd = softening_frames(probe, mat, ((2.9, 32), (3.5, 64),
                                                (6.0, 32)), seed=3)
    for kw in (dict(dtype="float32", check_rule="minsum"),
               dict(dtype="bfloat16", check_rule="minsum"),
               dict(dtype="float32")):
        out, ms, its = [], [], []
        for plain in (False, True):
            dec = Decoder(vid, cid, device="cuda", **kw)
            if plain:
                dec.check_phase = bp_check_phase_generic_ref
                dec.var_fold = bp_var_totals_generic_ref
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(dec.decode_batched(lappr, synd, 50))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            its.append(dec.iterations_run)
        for a, b in zip(*out):
            assert torch.equal(a, b), f"generic {kw}: not bit-equal"
        s, i, _ = out[0]
        assert 0 < int(s.sum()) < 128
        log(f"[generic decoder] rate 1/2 {kw}: kernel == plain on the card "
            f"(bit-equal); {int(s.sum())}/128 decoded, mean iters of the "
            f"decoded {float(i[s].float().mean()):.2f}; {its[0]} "
            f"iterations, kernel {ms[0]:.1f} ms ({ms[0] / its[0]:.3f} ms "
            f"per iteration), plain {ms[1]:.1f} ms ({ms[1] / its[1]:.3f})")


def log_rounds(label, dec, mat, snr, mode="softening"):
    """Print the untraced round breakdown of ``dec`` at ``snr``."""
    from qamreconciliation_tpu_torch.sims.time_check_phase import (
        round_breakdown,
    )

    pre, dcd, read, its = round_breakdown(dec, mat, snr, mode=mode)
    log(f"[{label}] {snr} dB round: preamble {pre:.2f} ms, decode+count "
        f"{dcd:.2f} ms, host read {read:.3f} ms, iterations {its} "
        f"({dcd / max(statistics.median(its), 1):.3f} ms per iteration)")


def phase_generic_main(kernels):
    """The generic main path: sim_reconciliation without --qc on the exact
    DVB-S2 rate-1/2 H and on the regular (3,6) code at 3.5 and 4.0 dB
    (kernel 4 launched once per BP iteration), the --lift-qc CLI on an
    expanded QC code (kernel 1, no kernel 4), and kernel 5's own path: one
    check-node update of the rate-1/2 code in the check-major layout."""
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc
    from qamreconciliation_tpu_torch.ops import kernels as K
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_generic, check_node_update_fused,
    )
    from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc

    regular = make_regular_ldpc(**REGULAR)
    common = ["--snr", "3.5", "4.0", "--nsnr", "2", "--simloops", "256"]
    for label, code in (("dvbs2 1/2", dvbs2_code("1/2")),
                        ("regular (3,6)", regular)):
        res, launches, _ = run_cli(edge_code(*code), common,
                                   f"generic {label}")
        iterations = sum(r.bp_iterations for r in res)
        assert iterations > 0
        assert launches["bp_check_phase_generic"] == iterations
        assert launches["bp_check_phase_qc"] == 0
        assert res[1].fer <= res[0].fer + 0.05
        plan = K.bp_check_phase_generic.plan
        log(f"[generic {label}] kernel 4 plan: {plan_text(plan)}")
        assert plan.path == "staged"
        if label == "dvbs2 1/2":
            record(kernels, "bp_check_phase_generic",
                   launches=launches["bp_check_phase_generic"])
        for snr in (3.5, 4.0):
            log_rounds(f"generic {label}",
                       Decoder(*code, device="cuda"), Matrix(*code), snr)
    # --lift-qc on an expanded QC code rides the QC decoder (kernel 1)
    _, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                               CODE["dc"], seed=CODE["seed"])
    res, launches, _ = run_cli(edge_code(vid, cid, ["--lift-qc"]),
                               ["--snr", "3.5", "3.5", "--nsnr", "1",
                                "--simloops", "256"], "lift-qc")
    assert launches["bp_check_phase_qc"] == res[0].bp_iterations > 0
    assert launches["bp_check_phase_generic"] == 0
    # kernel 5's path: v2c = the prior on every edge, permuted into the
    # check-major layout, one update; it equals kernel 4's first iteration
    vid, cid = dvbs2_code("1/2")
    dec = Decoder(vid, cid, device="cuda")
    g = dec.graph
    lappr, synd = softening_frames(dec, Matrix(vid, cid), ((3.5, 128),),
                                   seed=5)
    flat_v = lappr.repeat_interleave(g.dv_max, dim=0)     # [V*dv_max, B]
    _, c_mask = g._masks(torch.float32)
    v2c_c = g.permute_v_to_c(flat_v).contiguous()
    reset_counts()
    c2v_c = check_node_update_fused(v2c_c, synd, c_mask)
    launches = counts()
    assert launches["check_node_update_fused"] == 1
    t = g.gather_checks(lappr)
    first, _ = bp_check_phase_generic(t, torch.zeros_like(t), synd,
                                      dec._c_mask_T)
    torch.cuda.synchronize()
    assert torch.equal(c2v_c.transpose(0, 1), first), \
        "check-major update differs from kernel 4's first iteration"
    log(f"[kernel5 path] check-major update {tuple(v2c_c.shape)}: launches "
        f"{launches['check_node_update_fused']}, equal to kernel 4's first "
        f"iteration")
    record(kernels, "check_node_update_fused",
           launches=launches["check_node_update_fused"])


def phase_generic_quality():
    """Quality watch on the exact rate-1/2 H: 1024 frames at 3.75 dB with
    the JAX figure's own flags (bf16 tanh-F/B; the port draws the bf16
    channel as JAX does) and in float32 with its magnitude rule, FER held
    within 4 standard errors of the difference from it, 4 * sqrt(2 p (1 -
    p) / 1024).  Printed beside them, not held: float32 phi, whose decodes
    diverge after near-convergence on a few frames of this code (the QC
    dense path fails on the same frames; PERF.md)."""
    p = DVBS2_FER
    bound = 4 * math.sqrt(2 * p * (1 - p) / 1024)
    common = ["--snr", "3.75", "3.75", "--nsnr", "1", "--simloops", "1024",
              "--ferr-count-min", "1000000000"]
    for flags, held in ((["--dtype", "float32", "--check-phi", "tanhfb"],
                         True),
                        (["--dtype", "float32"], False),
                        (["--dtype", "bfloat16", "--check-phi", "tanhfb"],
                         True)):
        res, launches, _ = run_cli(edge_code(*dvbs2_code("1/2")),
                                   flags + common,
                                   f"quality {' '.join(flags)}")
        r = res[0]
        assert r.frames == 1024
        assert launches["bp_check_phase_generic"] == r.bp_iterations > 0
        log(f"[quality] exact rate 1/2 {' '.join(flags)}: FER {r.fer:.6f} "
            f"(JAX {p:.7f}, bound +-{bound:.4f}{'' if held else ', not held'}"
            f"), BER {r.ber:.4e}, mean iters {r.iters:.3f} (JAX "
            f"{DVBS2_ITERS:.3f})")
        if held:
            assert abs(r.fer - p) <= bound, (r.fer, p, bound)

# ------------------------------------------------------------------------
# The other modes and the bit channels (kernels 1-4 through new rounds)

# The mode quality watches, 1024 frames each, maxiter 50, early exit off:
# hard and direct on the DVB-S2 rate-1/2 full-wrap QC code with --resident
# --dtype bfloat16 --check-phi tanhfb (docs/img/wf_dvbs2_12_{hard,direct}.csv),
# BSC on the rate-3/4 full-wrap code with --dtype bfloat16
# (docs/img/bsc_dvbs2_34.csv).  Each is held to the JAX package's own FER on
# the CPU at that point, from its CLIs on the dense path:
#   JAX_PLATFORMS=cpu python scripts/run_mode_watches_cpu.py \
#       --watches hard:4.5,hard:4.45,direct:3.0,bsc:0.0275
# hard sits at 4.45 dB: at 4.5 dB the CPU figure, 0.0176, lies below 0.05.
MODE_WATCHES = {       # mode: (point, JAX CPU FER)
    "hard": (4.45, 0.0595703125),
    "direct": (3.0, 0.2607421875),
    "bsc": (0.0275, 0.2109375),
}
# hard at 4.5 dB, printed and not held: the JAX package's CPU figure there
# and its TPU figure (docs/img/wf_dvbs2_12_hard.csv)
HARD_AT_4_5 = {"CPU": 0.017578125, "TPU": 0.1005859375}
# the JAX package's TPU figures around the other two watches, printed and
# not held: (point, FER) pairs from the CSVs above
MODE_TPU = {"hard": ((4.5, 0.1005859375),),
            "direct": ((2.85, 0.9775390625), (3.2, 0.0068359375)),
            "bsc": ((0.025, 0.0009765625), (0.03, 0.9580078125))}
# the headline code's operating points of each mode (256 frames each):
# the first of each pair near the knee, where a round mixes decoded and
# failed frames
MODE_POINTS = {"hard": ("5.0", "5.5"), "direct": ("3.5", "4.0")}
# the forms of the reconciliation CLIs, with the kernel each one runs
MODE_FORMS = {
    "dense": ([], "bp_check_phase_qc"),
    "resident": (["--resident", "--dtype", "bfloat16", "--check-phi",
                  "tanhfb"], "bp_decode_rounds_qc"),
    "layered": (["--schedule", "layered", "--resident", "--check-rule",
                 "minsum", "--dtype", "bfloat16"], "bp_layered_sweeps_qc"),
}


def phase_modes(kernels):
    """Hard reverse and soft direct reconciliation, and the bit channels,
    through the CLIs a user calls: each path's kernel launched on the card
    (kernel 1 once per dense BP iteration, kernels 2 and 3 three device
    launches a call, kernel 4 once per generic iteration), one hard and one
    direct round decoded through kernel 1 and through the plain check phase
    bit for bit, and the quality watches (MODE_WATCHES).  Each kernel's
    record gets its launches per 128-frame round on these paths under
    ``mode_launches_per_round``."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.dvbs2 import (
        Z, make_table, to_qc_base,
    )
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_qc_ref, bp_var_pass_qc_ref,
    )
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    per_round = {name: {} for name in DECODE_KERNELS}

    def note(label, res, launches):
        rounds = sum(r.frames for r in res) / 128
        for name, n in launches.items():
            # the decode kernels only: a softening point also launches the
            # preamble's kernel, which phase_softening times
            if n and name in per_round:
                per_round[name][label] = n / rounds

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    z = CODE["z"]
    kernel_dec = QCDecoder(base, z, device="cuda")
    mat = Matrix(kernel_dec.vid, kernel_dec.cid)
    for mode, (lo, hi) in MODE_POINTS.items():
        for snr in (lo, hi):
            log_rounds(f"{mode} dense", kernel_dec, mat, float(snr), mode)
        for form, (flags, kernel) in MODE_FORMS.items():
            label = f"{mode} {form}"
            res, launches, dev = run_cli(qc_code(base, z), [
                f"--{mode}", *flags, "--snr", lo, hi, "--nsnr", "2",
                "--simloops", "256"], label)
            iterations = sum(r.bp_iterations for r in res)
            assert iterations > 0 and launches[kernel] > 0, (label, launches)
            if form == "dense":
                assert launches[kernel] == iterations
            else:
                assert dev[kernel] == iterations
                assert launches["bp_check_phase_qc"] == 0
            note(label, res, launches)

    # BI-AWGN sim_decode on the exact rate-1/2 H (the generic decoder)
    for label, flags in (("sim_decode soft", ["--snr", "-2.25", "-2.0"]),
                         ("sim_decode hard", ["--hard", "--snr", "-0.25",
                                              "0.0"])):
        res, launches, _ = run_cli(edge_code(*dvbs2_code("1/2")), [
            *flags, "--nsnr", "2", "--simloops", "256", "--minerr",
            "1000000000"], label, cli="sim_decode")
        iterations = sum(r.bp_iterations for r in res)
        assert launches["bp_check_phase_generic"] == iterations > 0
        assert launches["bp_check_phase_qc"] == 0
        note(label, res, launches)

    # one hard and one direct round on the same inputs: kernel 1 == plain
    plain_dec = QCDecoder(base, z, device="cuda")
    plain_dec.check_phase = bp_check_phase_qc_ref
    plain_dec.var_pass = bp_var_pass_qc_ref
    for mode, snr in (("hard", 5.0), ("direct", 3.5)):
        outs = []
        for dec in (kernel_dec, plain_dec):
            eng = ReconciliationEngine(dec, mat, PAMAlphabet(2, 2.0),
                                       batch=128)
            nm = eng.mode_noisemapper(mode, snr)
            sigma = math.sqrt(eng.noise_var(snr))
            x, y = eng._sample_sb(round_generator(13, 0, "cuda"), sigma)
            lappr, word = eng.round_inputs(mode, nm, x, y, sigma, 1.0)
            decoded = dec.decode_batched(lappr, dec.syndrome_from_bits(word),
                                         50)
            counters = eng.round(mode, nm, sigma, 1.0, 50, xy=(x, y))
            outs.append((*decoded, counters))
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            assert torch.equal(a, b), f"{mode} round: kernel != plain"
        errs, ferrs, its, succ = outs[0][3].tolist()
        assert 0 < succ < 128, (mode, succ)      # decoded and failed frames
        log(f"[modes] {mode} round at {snr} dB, B=128, injected samples: "
            f"kernel 1 == plain check phase bit for bit (success, iters, "
            f"final, counters); {succ}/128 decoded, {ferrs} frame errors, "
            f"{errs} bit errors")

    # quality watches
    def bound(p):
        return 4 * math.sqrt(2 * p * (1 - p) / 1024)

    qc12 = qc_code(to_qc_base(make_table("1/2", seed=0), wrap="full"), Z)
    qc34 = qc_code(to_qc_base(make_table("3/4", seed=0), wrap="full"), Z)
    resident = MODE_FORMS["resident"][0]
    watches = [(mode, point, held) for mode, (point, held)
               in MODE_WATCHES.items()] + [("hard", 4.5, None)]
    for mode, point, held in watches:
        p = str(point)
        if mode == "bsc":
            res, launches, _ = run_cli(qc34, [
                "--dtype", "bfloat16", "--rber", p, p, "--rpoints", "1",
                "--simloops", "1024", "--minerr", "1000000000"],
                f"watch bsc f={p}", cli="sim_bsc")
            assert launches["bp_check_phase_qc"] == res[0].bp_iterations > 0
        else:
            res, launches, _ = run_cli(qc12, [
                f"--{mode}", *resident, "--snr", p, p, "--nsnr", "1",
                "--simloops", "1024", "--ferr-count-min", "1000000000"],
                f"watch {mode} {p} dB")
            assert launches["bp_decode_rounds_qc"] > 0
        note(f"watch {mode} {p}", res, launches)
        fer = res[0].fer
        assert res[0].frames == 1024
        if held is None:
            log(f"[watch] {mode} at {p}: FER {fer:.4f}, not held; JAX CPU "
                f"{HARD_AT_4_5['CPU']:.4f}, JAX TPU {HARD_AT_4_5['TPU']:.4f} "
                f"(+-{bound(HARD_AT_4_5['TPU']):.4f})")
            continue
        tpu = ", ".join(f"{q}: {f:.4f}" for q, f in MODE_TPU[mode])
        log(f"[watch] {mode} at {p}: FER {fer:.4f}, BER {res[0].ber:.4e}, "
            f"mean iters {res[0].iters:.2f}; JAX CPU {held:.4f} (bound "
            f"+-{bound(held):.4f}); JAX TPU at {tpu}, not held")
        assert abs(fer - held) <= bound(held), (mode, fer, held)
    for name, rec in per_round.items():
        record(kernels, name, mode_launches_per_round=rec)
        log(f"[modes] {name} launches per 128-frame round: {rec}")

# ------------------------------------------------------------------------
# The sweep surface: the other LLR and CDF modes, rounds per dispatch, point
# batching, profiling, the entry round and the C++ oracle

# the headline's softening LLR modes, each with the flags that select it
LLR_FLAGS = {"poly": [], "table": ["--llr-mode", "table"],
             "interp": ["--llr-mode", "interp"], "search": ["--llr-exact"]}


def alternating(order):
    """The CLI's default Alternating sign configuration of ``order``."""
    cfg = np.zeros(order, np.uint8)
    cfg[1::2] = 1
    return cfg


def preamble_ms(dec, mat, snr, bps=2, dtype=torch.float32, rounds=3,
                **engine_kw):
    """Host-clock ms of the softening preamble of a 128-frame round
    (sampling to Alice's LLRs and Bob's word), median over ``rounds`` after
    a warm-up round, and the most device memory (MiB) one preamble
    allocated above what was allocated before it."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )

    pa = PAMAlphabet(bps, 2.0)
    eng = ReconciliationEngine(dec, mat, pa, batch=128, dtype=dtype,
                               **engine_kw)
    nm = eng.make_noisemapper(snr, alternating(pa.order))
    sigma = math.sqrt(eng.noise_var(snr))
    times, peak = [], 0
    for r in range(rounds + 1):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x, y = eng._sample_sb(round_generator(11, r, "cuda"), sigma)
        eng.round_inputs("softening", nm, x, y, sigma, 1.0)
        torch.cuda.synchronize()
        if r:
            times.append(1e3 * (time.perf_counter() - t0))
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return statistics.median(times), peak / 2 ** 20


def fer_bound(p, frames):
    """4 standard errors of the difference of two FER estimates at ``p``
    from ``frames`` frames each."""
    return 4 * math.sqrt(2 * p * (1 - p) / frames)


def rows_of(results):
    return [(r.snr_dB, r.ber, r.fer, r.iters, r.frames) for r in results]


def grid_fps(results):
    """Frames over seconds of a sequential sweep's points."""
    return (sum(r.frames for r in results)
            / sum(r.frames / r.frames_per_s for r in results))


def phase_sweep_surface(kernels):
    """The sweep surface of the headline code through the CLIs a user
    calls, counts set to 0 just before each CLI and read just after:

    * each softening LLR mode (poly, table, interp, search by --llr-exact)
      at 3.5 and 4.0 dB, dense f32 phi (kernel 1) and resident bf16
      (kernel 2; search in float32, as a bf16 Newton g^-1 is refused as in
      the JAX package), with frames/s, the preamble's ms and peak memory;
      the interp and search FERs within 4 standard errors of poly's;
    * each CDF mode at bps 4 (12.0 and 12.5 dB, docs/img/bps4_soft_alt.csv),
      FERs within 4 standard errors of erf's;
    * --rounds-per-dispatch 4 against 1 (dense and resident; the new modes
      together on the resident layered path, kernel 3) and --point-batch
      over 3 points against the sequential CLI, early exit off: identical
      rows; kernel 1 at B = 384 and kernel 4 at [7, 32400, 384] against
      their plain versions, bit for bit;
    * --profile-dir: the trace names kernel 1's CUDA function;
    * entry() on the card (kernel 4), and kernel 4 against its plain
      version at the entry round's shape [6, 512, 32], bit for bit;
    * the C++ oracle against the f32 phi dense decode on 32 frames at 4.0
      dB: success identical, iters within 1; its frames/s on one core.

    Each kernel's record gets its launches per 128-frame round on these
    paths under ``surface_launches_per_round``."""
    from qamreconciliation_tpu_torch import _graphcore
    from qamreconciliation_tpu_torch.entry import entry
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_generic, bp_check_phase_generic_ref,
        bp_check_phase_qc, bp_check_phase_qc_ref,
    )
    from qamreconciliation_tpu_torch.utils.edgefile import make_regular_ldpc

    per_round = {name: {} for name in DECODE_KERNELS}

    def note(label, res, launches):
        rounds = sum(r.frames for r in res) / 128
        for name, n in launches.items():
            # the decode kernels only: a softening point also launches the
            # preamble's kernel, which phase_softening times
            if n and name in per_round:
                per_round[name][label] = n / rounds

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    z = CODE["z"]
    code = qc_code(base, z)
    dense = QCDecoder(base, z, device="cuda")
    mat = Matrix(dense.vid, dense.cid)
    point = ["--snr", "3.5", "4.0", "--nsnr", "2", "--simloops", "256",
             "--ferr-count-min", "1000000000"]

    # LLR modes, dense f32 phi (kernel 1) and resident bf16 (kernel 2)
    forms = {"dense": ([], "bp_check_phase_qc"),
             "resident": (["--resident", "--dtype", "bfloat16"],
                          "bp_decode_rounds_qc")}
    fer = {}
    for form, (flags, kernel) in forms.items():
        for mode, mode_flags in LLR_FLAGS.items():
            form_flags = flags
            if form == "resident" and mode == "search":
                form_flags = ["--resident", "--dtype", "float32"]
            label = f"llr {mode} {form}"
            res, launches, _ = run_cli(code, [*form_flags, *mode_flags,
                                              *point], label)
            assert launches[kernel] > 0, (label, launches)
            if form == "dense":
                assert launches[kernel] == sum(r.bp_iterations for r in res)
            note(label, res, launches)
            fer[form, mode] = res
        for mode in ("interp", "search"):
            for got, want in zip(fer[form, mode], fer[form, "poly"]):
                b = fer_bound(want.fer, want.frames)
                log(f"[surface] {form} {mode} at {got.snr_dB} dB: FER "
                    f"{got.fer:.4f} against poly {want.fer:.4f} (bound "
                    f"+-{b:.4f})")
                assert abs(got.fer - want.fer) <= b, (form, mode, got.fer)
    for mode in LLR_FLAGS:
        for snr in (3.5, 4.0):
            ms, mib = preamble_ms(dense, mat, snr, llr_mode=mode)
            log(f"[surface] preamble llr {mode} f32 bps 2 at {snr} dB: "
                f"{ms:.2f} ms, peak {mib:.1f} MiB above the decoder's")
    ms, mib = preamble_ms(dense, mat, 12.0, bps=4, llr_mode="search")
    log(f"[surface] preamble llr search f32 bps 4 at 12.0 dB: {ms:.2f} ms, "
        f"peak {mib:.1f} MiB above the decoder's")

    # CDF modes at bps 4, dense f32 phi
    bps4 = ["--bps", "4", "--snr", "12.0", "12.5", "--nsnr", "2",
            "--simloops", "256", "--ferr-count-min", "1000000000"]
    cdf = {}
    for fy in ("erf", "erf_flat", "poly"):
        label = f"bps4 fy {fy}"
        res, launches, _ = run_cli(code, ["--fy-mode", fy, *bps4], label)
        assert launches["bp_check_phase_qc"] == sum(
            r.bp_iterations for r in res) > 0
        note(label, res, launches)
        cdf[fy] = res
        ms, mib = preamble_ms(dense, mat, 12.0, bps=4, fy_mode=fy)
        log(f"[surface] preamble fy {fy} f32 bps 4 at 12.0 dB: {ms:.2f} ms, "
            f"peak {mib:.1f} MiB above the decoder's")
    for fy in ("erf_flat", "poly"):
        for got, want in zip(cdf[fy], cdf["erf"]):
            b = fer_bound(want.fer, want.frames)
            log(f"[surface] bps 4 fy {fy} at {got.snr_dB} dB: FER "
                f"{got.fer:.4f} against erf {want.fer:.4f} (bound "
                f"+-{b:.4f})")
            assert abs(got.fer - want.fer) <= b, (fy, got.fer, want.fer)

    # rounds per dispatch, early exit off: R = 4 draws the frames of R = 1
    rpd = ["--snr", "3.5", "4.0", "--nsnr", "2", "--simloops", "512",
           "--ferr-count-min", "1000000000"]
    for form, (flags, kernel) in forms.items():
        out = {}
        for R in ("1", "4"):
            label = f"rpd {R} {form}"
            res, launches, _ = run_cli(
                code, [*flags, "--rounds-per-dispatch", R, *rpd], label)
            assert launches[kernel] > 0, (label, launches)
            note(label, res, launches)
            out[R] = res
        assert rows_of(out["1"]) == rows_of(out["4"]), f"rpd {form}"
        log(f"[surface] {form} --rounds-per-dispatch 4 == 1 (rows "
            f"identical); frames/s R=1 "
            f"{[round(r.frames_per_s, 1) for r in out['1']]}, R=4 "
            f"{[round(r.frames_per_s, 1) for r in out['4']]}")
    # the new modes together on the resident layered path (kernel 3)
    label = "layered interp fy-poly rpd 2"
    res, launches, _ = run_cli(code, [
        "--schedule", "layered", "--resident", "--check-rule", "minsum",
        "--dtype", "bfloat16", "--llr-mode", "interp", "--fy-mode", "poly",
        "--rounds-per-dispatch", "2", *point], label)
    assert launches["bp_layered_sweeps_qc"] > 0, launches
    assert launches["bp_check_phase_qc"] == 0
    note(label, res, launches)

    # point batching, early exit off: the rows of the sequential CLI
    grids = {"dense": (code, ["--snr", "3.5", "4.0", "--nsnr", "3",
                              "--simloops", "256"], "bp_check_phase_qc"),
             "generic dvbs2 1/2": (edge_code(*dvbs2_code("1/2")),
                                   ["--snr", "3.5", "4.0", "--nsnr", "3",
                                    "--simloops", "128"],
                                   "bp_check_phase_generic")}
    for form, (gcode, flags, kernel) in grids.items():
        flags = [*flags, "--ferr-count-min", "1000000000"]
        seq, _, _ = run_cli(gcode, flags, f"sequential {form}")
        label = f"point-batch {form}"
        bat, launches, _ = run_cli(gcode, [*flags, "--point-batch"], label)
        assert rows_of(bat) == rows_of(seq), f"point-batch {form}"
        iterations = bat[0].bp_iterations
        assert launches[kernel] == iterations > 0, (label, launches)
        note(label, bat, launches)
        log(f"[surface] {form} --point-batch == sequential (rows "
            f"identical); frames/s {bat[0].frames_per_s:.1f} batched (B = "
            f"{128 * len(bat)}) against {grid_fps(seq):.1f} sequential; "
            f"{iterations} iterations at B = {128 * len(bat)}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (*SHAPE[:3], 384)
    t = 3.0 * torch.randn(shape, generator=gen, device="cuda")
    c2v = torch.randn(shape, generator=gen, device="cuda")
    synd = torch.randint(0, 2, (shape[0], shape[2], 384), generator=gen,
                         device="cuda", dtype=torch.int32)
    par = torch.sum(t < 0, dim=1, dtype=torch.int32) & 1
    synd[..., :96] = par[..., :96]
    for rule, dt in (("sumproduct", torch.float32),
                     ("minsum", torch.bfloat16)):
        args = (t.to(dt), c2v.to(dt), synd)
        got, gviol = bp_check_phase_qc(*args, rule=rule)
        plan = bp_check_phase_qc.plan
        want, wviol = bp_check_phase_qc_ref(*args, rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(gviol, wviol), \
            f"kernel 1 at B = 384 {rule}: not bit-equal"
        ms, plain_ms = events_ms(
            lambda: bp_check_phase_qc(*args, rule=rule),
            lambda: bp_check_phase_qc_ref(*args, rule=rule),
            reps=5, warmup=2, run=10)
        log(f"[surface] kernel 1 {shape} {rule} {str(dt)[6:]}: bit-equal, "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{plan_text(plan)}]")
    g = TannerGraph(*dvbs2_code("1/2"), device="cuda")
    mask = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                           device="cuda")
    t, c2v, synd = generic_inputs(mask, 384, 4)
    for rule, dt in (("sumproduct", torch.float32),
                     ("minsum", torch.bfloat16)):
        args = (t.to(dt), c2v.to(dt), synd, mask)
        got, gviol = bp_check_phase_generic(*args, rule=rule)
        plan = bp_check_phase_generic.plan
        want, wviol = bp_check_phase_generic_ref(*args, rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(gviol, wviol), \
            f"kernel 4 at B = 384 {rule}: not bit-equal"
        ms, plain_ms = events_ms(
            lambda: bp_check_phase_generic(*args, rule=rule),
            lambda: bp_check_phase_generic_ref(*args, rule=rule),
            reps=5, warmup=2, run=10)
        log(f"[surface] kernel 4 {tuple(t.shape)} {rule} {str(dt)[6:]}: "
            f"bit-equal, kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"[{plan_text(plan)}]")

    # profiling: the trace of the first point names kernel 1's function
    with tempfile.TemporaryDirectory() as prof:
        res, launches, _ = run_cli(code, [
            "--snr", "4.0", "4.0", "--nsnr", "1", "--simloops", "128",
            "--profile-dir", prof], "profile")
        with open(os.path.join(prof, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "check_tile_kernel<" in e.get("name", "")
          and ", false," in e.get("name", "")]
    log(f"[surface] --profile-dir: {len(events)} trace events, "
        f"{len(k1)} of kernel 1 ({k1[0]['name'] if k1 else None}) for "
        f"{launches['bp_check_phase_qc']} launches")
    assert k1 and len(k1) == launches["bp_check_phase_qc"]

    # the entry round: one softening round through kernel 4
    fn, example = entry()
    reset_counts()
    out = fn(*example).tolist()
    launches = counts()
    log(f"[surface] entry(): counters {out}, launches {launches}")
    assert launches["bp_check_phase_generic"] > 0
    assert 0 <= out[1] <= 32 and 0 < out[3] <= 32
    per_round["bp_check_phase_generic"]["entry (B = 32)"] = \
        launches["bp_check_phase_generic"]
    # kernel 4 at the entry round's shape: its code's mask, B = 32
    g = TannerGraph(*make_regular_ldpc(1024, dv=3, dc=6, seed=0),
                    device="cuda")
    mask = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                           device="cuda")
    assert tuple(mask.shape) == (6, 512), mask.shape
    t, c2v, synd = generic_inputs(mask, 32, 6)
    for rule, dt in (("sumproduct", torch.float32),
                     ("minsum", torch.bfloat16)):
        args = (t.to(dt), c2v.to(dt), synd, mask)
        got, gviol = bp_check_phase_generic(*args, rule=rule)
        plan = bp_check_phase_generic.plan
        want, wviol = bp_check_phase_generic_ref(*args, rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(gviol, wviol), \
            f"kernel 4 at the entry shape {rule}: violation counts differ"
        conv = gviol.sum(0) == 0
        assert bool(conv[:8].all()) and not bool(conv.all())
        assert torch.equal(got, want), \
            f"kernel 4 at the entry shape {rule}: not bit-equal"
        log(f"[surface] kernel 4 {tuple(t.shape)} (entry code) {rule} "
            f"{str(dt)[6:]}: bit-equal [{plan_text(plan)}]")

    # the C++ oracle against the f32 phi dense decode
    lappr, synd = softening_frames(dense, mat, ((4.0, 32),), seed=9)
    success, iters, _ = dense.decode_batched(lappr, synd, 50)
    oracle = _graphcore.ScalarDecoder(dense.vid, dense.cid)
    L = lappr.double().cpu().numpy()
    S = synd.cpu().numpy().astype(np.uint8)
    success, iters = success.cpu().tolist(), iters.cpu().tolist()
    t0 = time.perf_counter()
    got = [oracle.decode(L[:, b], S[:, b], 50)[:2] for b in range(32)]
    seconds = time.perf_counter() - t0
    bad = [(b, got[b], (success[b], iters[b])) for b in range(32)
           if got[b][0] != success[b] or abs(got[b][1] - iters[b]) > 1]
    for b, o, d in bad:
        log(f"[surface] oracle frame {b}: oracle (success, iters) {o}, "
            f"dense f32 phi {d}")
    assert not bad, f"{len(bad)} frames disagree with the oracle"
    log(f"[surface] oracle == dense f32 phi on 32 frames at 4.0 dB "
        f"({sum(success)} decoded; iters within 1, "
        f"{sum(o[1] != i for o, i in zip(got, iters))} differ by 1); "
        f"oracle {32 / seconds:.2f} frames/s on one core")

    for name, rec in per_round.items():
        record(kernels, name, surface_launches_per_round=rec)
        log(f"[surface] {name} launches per 128-frame round: {rec}")


# ------------------------------------------------------------------------
# Block-streamed reconciliation and the mutual-information estimators

# the JAX bench's streaming row (bench.py:776-865): the headline code,
# 4-PAM with the base sign configuration, 4.0 dB, bf16, batch 64, 256 frames
# fed in 2.33-frame chunks, maxiter 50, best of 3 after a warm-up
STREAM = dict(snr=4.0, batch=64, frames=256, chunk=2.33, maxiter=50)
# its MC-MI row (bench.py:867-901): bps 2, 8.0 dB, float32, 2^21 samples
MI = dict(bps=2, snr=8.0, n=1 << 21)


def stream_groups(B):
    """Mixed-SNR groups of B frames: a quarter at 7 dB (converge at once),
    half at 4.5 dB, a quarter at 2.5 dB (never converge)."""
    q = max(B // 4, 1)
    return ((7.0, q), (4.5, B - 2 * q), (2.5, q))


def stream_kernels(base, per_batch):
    """Kernels 1, 2 and 3 at the headline code with the stream's batch
    (B = 64) and a test batch (B = 8), kernel 4 on the exact DVB-S2 rate-1/2
    H at B = 64: each against its plain version, torch.equal on every
    output; min-sum bf16 and f32 phi (kernel 2: tanh-F/B bf16, the resident
    decoder's rule in bf16) as the decoders use them.  Each case's launch
    plan and ms per step go to the log and ``per_batch``."""
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_generic, bp_check_phase_generic_ref,
        bp_check_phase_qc, bp_check_phase_qc_ref, bp_decode_rounds_qc,
        bp_decode_rounds_qc_ref, bp_layered_sweeps_qc,
        bp_layered_sweeps_qc_ref,
    )

    z, bf16, f32 = CODE["z"], torch.bfloat16, torch.float32
    for B in (64, 8):
        gen = torch.Generator(device="cuda").manual_seed(B)
        shape = (*SHAPE[:3], B)
        t = 3.0 * torch.randn(shape, generator=gen, device="cuda")
        c2v = torch.randn(shape, generator=gen, device="cuda")
        synd = torch.randint(0, 2, (shape[0], z, B), generator=gen,
                             device="cuda", dtype=torch.int32)
        par = torch.sum(t < 0, dim=1, dtype=torch.int32) & 1
        synd[..., : B // 4] = par[..., : B // 4]
        for rule, dt in (("minsum", bf16), ("sumproduct", f32)):
            args = (t.to(dt), c2v.to(dt), synd)
            got = bp_check_phase_qc(*args, rule=rule)
            plan = bp_check_phase_qc.plan
            want = bp_check_phase_qc_ref(*args, rule=rule)
            torch.cuda.synchronize()
            assert all(map(torch.equal, got, want)), \
                f"kernel 1 B={B} {rule}: not bit-equal"
            ms, plain_ms = events_ms(
                lambda: bp_check_phase_qc(*args, rule=rule),
                lambda: bp_check_phase_qc_ref(*args, rule=rule),
                reps=5, warmup=2, run=10)
            per_batch["bp_check_phase_qc"][f"B={B} {rule} {str(dt)[6:]}"] = ms
            log(f"[stream kernels] kernel 1 {shape} {rule} {str(dt)[6:]}: "
                f"bit-equal, kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"[{plan_text(plan)}]")
        lappr, synd, dec = softening_llrs(base, z, stream_groups(B))
        tables = dec.tables
        synd8 = synd.reshape(tables.nb_c, z, B).to(torch.int8).contiguous()
        warm, K, maxiter = 5, 25, 50        # the stream decoder's chunk 25
        for rule, md in (("minsum", bf16), ("tanhfb", bf16)):
            prior = lappr.to(md).reshape(tables.nb_v, z, B).contiguous()
            state = [prior.clone(),
                     torch.zeros((tables.E, z, B), dtype=md, device="cuda"),
                     prior, synd8,
                     torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.int32, device="cuda")]
            bp_decode_rounds_qc_ref(tables, 0, maxiter, *state, rule=rule,
                                    k_rounds=warm)
            want = [x.clone() for x in state]
            bp_decode_rounds_qc(tables, warm, maxiter, *state, rule=rule,
                                k_rounds=K)
            plan = bp_decode_rounds_qc.plan
            bp_decode_rounds_qc_ref(tables, warm, maxiter, *want, rule=rule,
                                    k_rounds=K)
            torch.cuda.synchronize()
            compare_state(state[:2] + state[4:], want[:2] + want[4:],
                          f"kernel 2 B={B} {rule}")
            scratch = [x.clone() for x in state]
            ms, = events_ms(lambda: bp_decode_rounds_qc(
                tables, warm, maxiter, *scratch, rule=rule, k_rounds=K),
                reps=5, warmup=1)
            plain_ms, = events_ms(lambda: bp_decode_rounds_qc_ref(
                tables, warm, maxiter, *scratch, rule=rule, k_rounds=K),
                reps=2, warmup=0)
            ms, plain_ms = ms / K, plain_ms / K
            per_batch["bp_decode_rounds_qc"][f"B={B} {rule} bf16"] = ms
            log(f"[stream kernels] kernel 2 B={B} {rule} bf16: done "
                f"{int(want[4].sum())}/{B}, bit-equal; per iteration kernel "
                f"{ms:.4f} ms plain {plain_ms:.4f} ms "
                f"[{resident_plan_text(plan)}]")
        for rule, md in (("minsum", bf16), ("sumproduct", f32)):
            state = [lappr.float().reshape(tables.nb_v, z, B).contiguous(),
                     torch.zeros((tables.E, z, B), dtype=md, device="cuda"),
                     synd8, torch.zeros(B, dtype=torch.int32, device="cuda"),
                     torch.zeros(B, dtype=torch.int32, device="cuda")]
            bp_layered_sweeps_qc_ref(tables, 0, maxiter, *state, rule=rule,
                                     k_sweeps=2)
            want = [x.clone() for x in state]
            bp_layered_sweeps_qc(tables, 2, maxiter, *state, rule=rule,
                                 k_sweeps=4)
            plan = bp_layered_sweeps_qc.plan
            bp_layered_sweeps_qc_ref(tables, 2, maxiter, *want, rule=rule,
                                     k_sweeps=4)
            torch.cuda.synchronize()
            compare_state(state[:2] + state[3:], want[:2] + want[3:],
                          f"kernel 3 B={B} {rule}")
            scratch = [x.clone() for x in state]
            ms, = events_ms(lambda: bp_layered_sweeps_qc(
                tables, 2, maxiter, *scratch, rule=rule, k_sweeps=4),
                reps=5, warmup=1)
            plain_ms, = events_ms(lambda: bp_layered_sweeps_qc_ref(
                tables, 2, maxiter, *scratch, rule=rule, k_sweeps=4),
                reps=2, warmup=0)
            ms, plain_ms = ms / 4, plain_ms / 4
            per_batch["bp_layered_sweeps_qc"][
                f"B={B} {rule} {str(md)[6:]}"] = ms
            log(f"[stream kernels] kernel 3 B={B} {rule} {str(md)[6:]}: done "
                f"{int(want[3].sum())}/{B}, bit-equal; per sweep kernel "
                f"{ms:.4f} ms plain {plain_ms:.4f} ms "
                f"[{resident_plan_text(plan)}]")
    g = TannerGraph(*dvbs2_code("1/2"), device="cuda")
    mask = torch.as_tensor(g._c_mask_T_np, dtype=torch.float32,
                           device="cuda")
    t, c2v, synd = generic_inputs(mask, 64, 8)
    for rule, dt in (("minsum", bf16), ("sumproduct", f32)):
        args = (t.to(dt), c2v.to(dt), synd, mask)
        got = bp_check_phase_generic(*args, rule=rule)
        plan = bp_check_phase_generic.plan
        want = bp_check_phase_generic_ref(*args, rule=rule)
        torch.cuda.synchronize()
        assert all(map(torch.equal, got, want)), \
            f"kernel 4 B=64 {rule}: not bit-equal"
        ms, plain_ms = events_ms(
            lambda: bp_check_phase_generic(*args, rule=rule),
            lambda: bp_check_phase_generic_ref(*args, rule=rule),
            reps=5, warmup=2, run=10)
        per_batch["bp_check_phase_generic"][f"B=64 {rule} {str(dt)[6:]}"] = ms
        log(f"[stream kernels] kernel 4 {tuple(t.shape)} {rule} "
            f"{str(dt)[6:]}: bit-equal, kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms [{plan_text(plan)}]")


def stream_data(pa, N0, N_symb, frames, seed=3):
    """The bench's stream: (x, y) of ``frames`` frames (numpy, seed 3) and
    their 2.33-frame chunks."""
    rng = np.random.default_rng(seed)
    x = rng.choice(pa.order, size=frames * N_symb, p=pa.probabilities)
    y = pa.constellation[x] + math.sqrt(N0) * rng.standard_normal(x.size)
    chunk = int(STREAM["chunk"] * N_symb)
    return (x, y, [y[a:a + chunk] for a in range(0, x.size, chunk)],
            [x[a:a + chunk] for a in range(0, x.size, chunk)])


def merged(parts):
    """One StreamResult of the per-call results ``parts``."""
    from qamreconciliation_tpu_torch.sims.streaming import StreamResult

    out = StreamResult()
    for r in parts:
        out.frames += r.frames
        out.success += r.success
        out.iterations += r.iterations
        out.bit_errors += r.bit_errors
        out.decoded_words += r.decoded_words
    return out


def same_results(a, b, what):
    assert (a.frames, a.success, a.iterations, a.bit_errors) == \
        (b.frames, b.success, b.iterations, b.bit_errors), what
    assert all(np.array_equal(u, v) for u, v in
               zip(a.decoded_words, b.decoded_words)), what


def stream_fused_best(make, stream, label, reps=3):
    """stream_fused of ``make()``'s reconciler over the chunked stream, best
    of ``reps`` after a one-batch warm-up; counts set to 0 just before each
    rep and read just after (the last rep's are returned)."""
    from qamreconciliation_tpu_torch.ops import kernels as K

    x, y, ycks, xcks = stream
    warm = make()
    need = warm.batch * warm.N_symb
    warm.stream_fused(y[:need], x[:need], STREAM["maxiter"])
    times = []
    for _ in range(reps):
        sr = make()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sr.stream_fused(ycks, xcks, STREAM["maxiter"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = counts()
    multi = {n: (getattr(K, n).iterations, getattr(K, n).device_launches)
             for n in ("bp_decode_rounds_qc", "bp_layered_sweeps_qc")}
    rate = x.size / min(times)
    its = statistics.mean(res.iterations)
    log(f"[stream] {label}: {res.frames} frames, {x.size / min(times):.1f} "
        f"symbols/s best of {reps} (reps "
        f"{[round(x.size / t, 1) for t in times]}), FER {res.fer:.4f}, mean "
        f"iterations {its:.2f}, bit errors {res.bit_errors}, "
        f"{sr.decode_dispatches} decode dispatches; launches {launches}; "
        f"kernels 2/3 (steps, device launches) {multi}")
    assert res.frames == x.size // sr.N_symb
    return res, launches, rate


def stream_drivers(make, stream, fused):
    """The same frames through the split API (immediate, then defer=True)
    and the handoff API: each identical to ``fused``; returns each driver's
    (symbols/s, decode dispatches)."""
    x, _, ycks, xcks = stream
    mi_ = STREAM["maxiter"]
    empty = np.empty(0, np.int64)
    out = {}
    for driver in ("split immediate", "split defer", "handoff"):
        sr = make(defer=driver == "split defer")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = []
        if driver == "handoff":
            for yc, xc in zip(ycks, xcks):
                parts.append(sr.alice_step(sr.bob_step(yc), xc, mi_))
            parts.append(sr.alice_step(sr.bob_step_flush(), empty, mi_))
        else:
            for yc, xc in zip(ycks, xcks):
                w, s, nh = sr.bob_process(yc)
                parts.append(sr.alice_process(nh, xc, s, mi_, bob_words=w))
            if sr.defer:
                w, s, nh = sr.bob_flush()
                parts.append(sr.alice_process(nh, empty, s, mi_,
                                              bob_words=w))
                parts.append(sr.alice_flush(mi_))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        same_results(merged(parts), fused, f"{driver} != stream_fused")
        out[driver] = (x.size / seconds, sr.decode_dispatches)
        log(f"[stream] {driver}: identical to stream_fused (success, "
            f"iterations, words, bit errors); {x.size / seconds:.1f} "
            f"symbols/s, {sr.decode_dispatches} decode dispatches")
    assert out["split defer"][1] <= out["split immediate"][1]
    return out


def stream_breakdown(make, stream):
    """Host-clock ms of the stages of one fused 64-frame batch (median of
    3, each stage ended by a synchronize): the carry (the growing
    np.concatenate the JAX driver uses, and the port's preallocated carry),
    the host cast and upload, Bob's round, Alice's LLRs, the decode, the
    harvest (bit errors, packing, download, unpacking)."""
    from qamreconciliation_tpu_torch.sims.streaming import _Queue

    x, y, ycks, xcks = stream
    sr = make()
    need = sr.batch * sr.N_symb
    stages = {k: [] for k in ("concatenate carry", "preallocated carry",
                              "cast + upload", "Bob's round",
                              "Alice's LLRs", "decode", "harvest")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append(1e3 * (time.perf_counter() - t0))
        return out

    def concat():
        cy, cx, i = np.empty(0), np.empty(0, np.int64), 0
        while cy.size < need:
            cy = np.concatenate([cy, np.asarray(ycks[i], np.float64)])
            cx = np.concatenate([cx, np.asarray(xcks[i], np.int64)])
            i += 1
        return cy[:need], cx[:need]

    def prealloc():
        cy, cx, i = _Queue(np.float64), _Queue(np.int64), 0
        while len(cy) < need:
            cy.append(ycks[i])
            cx.append(xcks[i])
            i += 1
        return cy.take(need), cx.take(need)

    for _ in range(4):
        timed("concatenate carry", concat)
        yb, xb = timed("preallocated carry", prealloc)
        y_dev, x_dev = timed("cast + upload", lambda: (
            sr._upload_y(yb.reshape(sr.batch, -1)),
            sr._upload_x(xb.reshape(sr.batch, -1))))
        words, synd, n_hat = timed("Bob's round",
                                   lambda: sr._bob_round(y_dev))
        lappr = timed("Alice's LLRs", lambda: sr.nm.demap_lappr_array(
            n_hat, x_dev, mode=sr.llr_mode))
        success, iters, total = timed("decode", lambda: sr._decode_fn(
            lappr.T, synd.T, STREAM["maxiter"]))

        def harvest():
            bits = (total.T < 0).to(torch.int32)
            errs = torch.sum(bits ^ words.to(torch.int32), dim=1)
            packed = sr._pack(bits)
            return (success.cpu().numpy(), iters.cpu().numpy(),
                    errs.cpu().numpy(), np.unpackbits(
                        packed.cpu().numpy(), axis=1, bitorder="little"))
        timed("harvest", harvest)
    med = {k: statistics.median(v[1:]) for k, v in stages.items()}
    log(f"[stream breakdown] one fused {sr.batch}-frame batch, ms (median "
        f"of 3 after a warm-up): "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    return med


def phase_streaming(kernels):
    """Block-streamed reconciliation (sims/streaming.py) and the
    mutual-information estimators, each run with the counts set to 0 just
    before it and read just after:

    * kernels 1-3 at B = 64 and B = 8, kernel 4 at B = 64, bit for bit
      against their plain versions (stream_kernels);
    * stream_fused at the JAX bench's streaming configuration (STREAM) with
      the resident min-sum decoder, chunk 25 (kernel 2), the dense min-sum
      decoder (kernel 1) and the resident layered one (kernel 3), and the
      generic min-sum decoder on the exact DVB-S2 rate-1/2 H (kernel 4, 128
      frames): symbols/s, FER, mean iterations, dispatches, launches;
    * the same 256 frames through the split API (immediate and deferred)
      and the handoff API, identical to stream_fused;
    * the host-time breakdown of one fused batch (stream_breakdown);
    * MC-MI at the bench's configuration (MI), "poly" and "interp": samples/s
      best of 3, the three estimates within 4 standard errors of the host
      quadrature with the reference's signs; the peak device memory of a
      4096-configuration batched call at bps 4; the compare-signs CLI with
      --montecarlo at bps 2.

    Each kernel's record gets its stream-batch times under
    ``stream_ms_by_batch`` and its launches on the streaming paths under
    ``stream_launches``."""
    from qamreconciliation_tpu_torch.models import mutual_information as mi
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.sims import (
        sim_mutual_information_compare_signs,
    )
    from qamreconciliation_tpu_torch.sims.streaming import StreamReconciler

    per_batch = {name: {} for name in DECODE_KERNELS}
    launches_of = {name: {} for name in DECODE_KERNELS}
    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    stream_kernels(base, per_batch)

    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10 ** (-STREAM["snr"] / 10) / 2
    nm = NoiseMapper(pa, N0, dtype="bfloat16", device="cuda")
    mat = Matrix(vid, cid)
    S = mat.vnum // pa.bit_per_symbol
    stream = stream_data(pa, N0, S, STREAM["frames"])
    z, bf16 = CODE["z"], "bfloat16"
    decoders = {
        "resident min-sum chunk 25 (kernel 2)": (QCDecoder(
            base, z, bf16, device="cuda", check_rule="minsum", resident=True,
            resident_chunk=25), "bp_decode_rounds_qc"),
        "dense min-sum (kernel 1)": (QCDecoder(
            base, z, bf16, device="cuda", check_rule="minsum"),
            "bp_check_phase_qc"),
        "layered resident min-sum (kernel 3)": (QCDecoder(
            base, z, bf16, device="cuda", check_rule="minsum",
            schedule="layered", resident=True), "bp_layered_sweeps_qc"),
    }
    rates = {}
    for label, (dec, kernel) in decoders.items():
        def make(defer=False, dec=dec):
            return StreamReconciler(dec, mat, pa, nm, batch=STREAM["batch"],
                                    defer=defer)
        res, launches, rates[label] = stream_fused_best(make, stream, label)
        assert launches[kernel] > 0, (label, launches)
        launches_of[kernel][f"stream_fused {label}"] = launches[kernel]
        if kernel == "bp_decode_rounds_qc":
            assert launches["bp_check_phase_qc"] == 0
            assert res.fer <= 0.05, res.fer
            drivers = stream_drivers(make, stream, res)
            breakdown = stream_breakdown(make, stream)
    vid2, cid2 = dvbs2_code("1/2")
    gdec = Decoder(vid2, cid2, bf16, device="cuda", check_rule="minsum")
    gmat = Matrix(vid2, cid2)
    gstream = stream_data(pa, N0, gmat.vnum // 2, 128, seed=4)
    res, launches, rates["generic DVB-S2 1/2 min-sum (kernel 4)"] = \
        stream_fused_best(lambda: StreamReconciler(
            gdec, gmat, pa, nm, batch=STREAM["batch"]), gstream,
            "generic DVB-S2 1/2 min-sum (kernel 4)")
    assert launches["bp_check_phase_generic"] > 0
    assert launches["bp_check_phase_qc"] == 0
    launches_of["bp_check_phase_generic"]["stream_fused generic DVB-S2 1/2"] \
        = launches["bp_check_phase_generic"]

    # MC-MI
    mpa = PAMAlphabet(MI["bps"], 2.0)
    mnm = NoiseMapper(mpa, mpa.variance * 10 ** (-MI["snr"] / 10) / 2,
                      dtype="float32", device="cuda")
    mnm._ensure_ginv_poly()
    p = mi.P_xhat(mnm)
    quad = (-mi.mutual_information_X_Xhat(mnm, p),
            -mi.mutual_information_X_Y(mnm),
            mi.mutual_information_base_scheme(mnm, p))
    mi_rates = {}
    for mode in ("poly", "interp"):
        gen = torch.Generator(device="cuda").manual_seed(11)
        mi.montecarlo_information(gen, mpa, mnm, p, MI["n"], ginv_mode=mode)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = mi.montecarlo_information(gen, mpa, mnm, p, MI["n"],
                                            ginv_mode=mode)
            times.append(time.perf_counter() - t0)
        xy = mi._draw(gen, mpa, mnm, (1, MI["n"]))
        p_rows = torch.as_tensor(p, dtype=torch.float32,
                                 device="cuda")[None, :]
        terms = mi._mc_terms(mpa, mnm, p_rows, *xy, (True,) * 3, mode)
        mi_rates[mode] = MI["n"] / min(times)
        for e, name in enumerate(("I(X;Xhat)", "I(X;Y)", "I(X,N;Xhat)")):
            se = float(terms[e].double().std()) / math.sqrt(MI["n"])
            log(f"[mc-mi] {mode} {name}: {est[e]:.6f} against quadrature "
                f"{quad[e]:.6f} (4 SE {4 * se:.6f})")
            assert abs(est[e] - quad[e]) <= 4 * se, (mode, name, est[e])
        log(f"[mc-mi] {mode}: {mi_rates[mode]:.1f} samples/s best of 3 "
            f"({[round(MI['n'] / t, 1) for t in times]})")
    # a 4096-configuration chunk at bps 4 (the compare-signs CLI's default
    # chunk and samples): time and peak device memory of one batched call
    cpa = PAMAlphabet(4, 2.0)
    cbase = NoiseMapper(cpa, cpa.variance * 10 ** (-12.0 / 10) / 2,
                        dtype="float64", device="cuda")
    cbase._ensure_ginv_poly()
    configs, _ = sim_mutual_information_compare_signs.enumerate_configs(16)
    cnms = [cbase.with_sign_config(c) for c in configs[:4096]]
    cp = np.broadcast_to(mi.P_xhat(cbase), (4096, 16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = mi.montecarlo_information_batched(
        torch.Generator(device="cuda").manual_seed(1), cpa, cnms, cp, 4096,
        (False, False, True), "poly")
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
    assert np.isfinite(out[:, 2]).all()
    log(f"[mc-mi] batched bps 4, 12.0 dB, 4096 configurations x 4096 "
        f"samples (float64, poly): {seconds:.2f} s, peak {peak:.2f} GiB "
        f"above what was allocated; I(X,N;Xhat) {out[:, 2].min():.4f} .. "
        f"{out[:, 2].max():.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        out_csv = os.path.join(tmp, "signs.csv")
        t0 = time.perf_counter()
        rows = sim_mutual_information_compare_signs.main([
            "--montecarlo", "--bps", "2", "--snr", "4", "8", "--nsnr", "3",
            "--nloops", "4", "--device", "cuda", "--out", out_csv])
        with open(out_csv) as f:
            header = next(csv.reader(f))
    assert len(rows) == 3 and len(header) == 2 + 10
    assert all(0.0 < v < 2.0 for r in rows for v in r[1:]), rows
    log(f"[mc-mi] compare-signs --montecarlo bps 2, 3 points x 10 configs: "
        f"{time.perf_counter() - t0:.2f} s; I(X,N;Xhat) at 8 dB "
        f"{min(rows[2][1:]):.4f} .. {max(rows[2][1:]):.4f}")
    for name in DECODE_KERNELS:
        record(kernels, name, stream_ms_by_batch=per_batch[name],
               stream_launches=launches_of[name])
    log(f"[stream] symbols/s: {rates}; drivers {drivers}; breakdown ms "
        f"{breakdown}; MC-MI samples/s {mi_rates}")


# ------------------------------------------------------------------------
# Multi-device reconciliation (phase 16): two ranks on one card

MULTI = dict(world=2, snr=3.5, frames=512, seed=21, timeout=420)
# the tests' stated tolerances of the check-sharded decoder's finals
# (tests/test_torch_graph_shard.py): bf16 elementwise BF16_TOL; float32
# every hard decision equal and the magnitudes bound to F32_TOL as far as
# the phi rule lets them: its extrinsic phi(S - phi_i) moves by up to
# phi's clamp on a one-ulp change of S where one input dominates a row
# (2 of 8294400 elements beyond F32_TOL on the DVB-S2 1/2 H, one 33.3
# apart), so at most SHARD_BEYOND of the elements may lie beyond it, and
# on each converged frame the median element within it.  A wrong exchange
# (a partial lost, scaled or counted twice) moves most elements of the
# frames it touches.
SHARD_TOL = {torch.float32: dict(rtol=4e-3, atol=1e-3),
             torch.bfloat16: dict(rtol=2.0 ** -7, atol=0.0)}
SHARD_BEYOND = 1e-5


def shard_finals(got, want, success, dtype):
    """(finals [V, B] agree as the tests bind them, the largest |got -
    want|, the elements beyond the bound atol + rtol |want| of
    SHARD_TOL[dtype], the largest median |got - want| / bound of a
    converged frame):
    bf16 binds every element to that bound; float32 every hard decision,
    at most SHARD_BEYOND of the elements beyond it, and each converged
    frame's median |got - want| / bound to 1."""
    tol = SHARD_TOL[dtype]
    diff = (got.double() - want.double()).abs()
    ratio = diff / (tol["atol"] + tol["rtol"] * want.double().abs())
    beyond = int((ratio > 1).sum())
    med = float(ratio[:, success].median(dim=0).values.max()) \
        if bool(success.any()) else 0.0
    if dtype == torch.float32:
        ok = (torch.equal(got < 0, want < 0)
              and beyond <= SHARD_BEYOND * got.numel() and med <= 1)
    else:
        ok = beyond == 0
    return ok, float(diff.max()), beyond, med


def multi_paths():
    """The frame-shard paths of phase 16, label -> (decoder factory, (vid,
    cid), dtype, its kernel): the headline code dense f32 phi (kernel 1),
    --resident bf16 (kernel 2), resident layered bf16 min-sum (kernel 3),
    and the exact DVB-S2 rate-1/2 H with the generic f32 phi decoder
    (kernel 4)."""
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )

    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    z, bf16 = CODE["z"], "bfloat16"
    dvid, dcid = dvbs2_code("1/2")
    return {
        "dense f32 phi": (lambda: QCDecoder(base, z, device="cuda"),
                          (vid, cid), "float32", "bp_check_phase_qc"),
        "resident bf16": (lambda: QCDecoder(
            base, z, bf16, device="cuda", resident=True, resident_chunk=50),
            (vid, cid), bf16, "bp_decode_rounds_qc"),
        "layered resident bf16 min-sum": (lambda: QCDecoder(
            base, z, bf16, device="cuda", check_rule="minsum",
            schedule="layered", resident=True), (vid, cid), bf16,
            "bp_layered_sweeps_qc"),
        "generic DVB-S2 1/2 f32 phi": (lambda: Decoder(
            dvid, dcid, device="cuda"), (dvid, dcid), "float32",
            "bp_check_phase_generic"),
    }


def multi_point(eng):
    """run_point of phase 16's frame-shard rows (512 frames at 3.5 dB,
    Alternating signs, at most 50 iterations, no early exit)."""
    return eng.run_point("softening", MULTI["snr"], 50, MULTI["frames"],
                         10 ** 9, nmconfig=ALTERNATING, seed=MULTI["seed"])


def multi_kernels(kernels):
    """Kernels 4 and 1 at one rank's shapes against their plain versions,
    torch.equal on every output: kernel 4 at [7, 16200, 128] on the first
    half of the DVB-S2 rate-1/2 H's checks (ShardedDecoder's rank 0 block),
    kernel 1 at [90, 6, 180, 128] (ShardedQCDecoder's lanes of a rank),
    f32 phi and bf16 min-sum; launch plan and ms per call logged."""
    from qamreconciliation_tpu_torch.models.decoder import TannerGraph
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_generic, bp_check_phase_generic_ref,
        bp_check_phase_qc, bp_check_phase_qc_ref,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    g = TannerGraph(*dvbs2_code("1/2"), device="cuda")
    mask = torch.as_tensor(g._c_mask_T_np[:, : g.cnum // 2],
                           dtype=torch.float32, device="cuda").contiguous()
    t, c2v, synd = generic_inputs(mask, 128, 16)
    per_rank = {}
    for rule, dt in (("sumproduct", f32), ("minsum", bf16)):
        args = (t.to(dt), c2v.to(dt), synd, mask)
        got = bp_check_phase_generic(*args, rule=rule)
        plan = bp_check_phase_generic.plan
        want = bp_check_phase_generic_ref(*args, rule=rule)
        torch.cuda.synchronize()
        assert all(map(torch.equal, got, want)), \
            f"kernel 4 {tuple(t.shape)} {rule}: not bit-equal"
        ms, plain_ms = events_ms(
            lambda: bp_check_phase_generic(*args, rule=rule),
            lambda: bp_check_phase_generic_ref(*args, rule=rule),
            reps=5, warmup=2, run=10)
        per_rank.setdefault("bp_check_phase_generic", {})[
            f"{list(t.shape)} {rule} {str(dt)[6:]}"] = ms
        log(f"[multi kernels] kernel 4 {tuple(t.shape)} {rule} "
            f"{str(dt)[6:]}: bit-equal, kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms [{plan_text(plan)}]")
    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = (SHAPE[0], SHAPE[1], SHAPE[2] // MULTI["world"], SHAPE[3])
    t = 3.0 * torch.randn(shape, generator=gen, device="cuda")
    c2v = torch.randn(shape, generator=gen, device="cuda")
    synd = torch.randint(0, 2, (shape[0], shape[2], shape[3]), generator=gen,
                         device="cuda", dtype=torch.int32)
    par = torch.sum(t < 0, dim=1, dtype=torch.int32) & 1
    synd[..., : shape[3] // 4] = par[..., : shape[3] // 4]
    for rule, dt in (("sumproduct", f32), ("minsum", bf16)):
        args = (t.to(dt), c2v.to(dt), synd)
        got = bp_check_phase_qc(*args, rule=rule)
        plan = bp_check_phase_qc.plan
        want = bp_check_phase_qc_ref(*args, rule=rule)
        torch.cuda.synchronize()
        assert all(map(torch.equal, got, want)), \
            f"kernel 1 {shape} {rule}: not bit-equal"
        ms, plain_ms = events_ms(
            lambda: bp_check_phase_qc(*args, rule=rule),
            lambda: bp_check_phase_qc_ref(*args, rule=rule),
            reps=5, warmup=2, run=10)
        per_rank.setdefault("bp_check_phase_qc", {})[
            f"{list(shape)} {rule} {str(dt)[6:]}"] = ms
        log(f"[multi kernels] kernel 1 {shape} {rule} {str(dt)[6:]}: "
            f"bit-equal, kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"[{plan_text(plan)}]")
    for name, by_case in per_rank.items():
        record(kernels, name, multidevice_ms=by_case)


def stream_view(res):
    """A StreamResult's outputs as host values (words packed)."""
    return (res.frames, list(res.success), list(res.iterations),
            res.bit_errors,
            np.packbits(np.asarray(res.decoded_words, np.uint8), axis=1))


def _p2p_probe_rank():
    """One of two ranks probing what gloo's point-to-point does with CUDA
    tensors: rank 0 sends a CUDA tensor to rank 1, which receives into
    one.  Returns the first line of what either raises, or whether the
    bytes arrived."""
    import torch.distributed as dist

    rank = dist.get_rank()
    x = torch.arange(1 << 16, dtype=torch.float32, device="cuda")
    try:
        if rank == 0:
            dist.send(x, 1)
            return "sent"
        y = torch.zeros_like(x)
        dist.recv(y, 0)
        return "exact" if torch.equal(y, x) else "WRONG values"
    except RuntimeError as e:
        return f"raises: {str(e).splitlines()[0][:200]}"


def p2p_probe():
    """gloo's send/recv on CUDA tensors, in two ranks of their own (a
    failed send can close the pair, so not in phase 16's group)."""
    from qamreconciliation_tpu_torch.parallel.mesh import run_ranks

    try:
        got = run_ranks(_p2p_probe_rank, 2, device="cuda", timeout=120)
    except (RuntimeError, TimeoutError) as e:
        got = [f"the probe's ranks failed: {e} (a negative code is the "
               f"signal that ended the rank: -6 an abort)"]
    log(f"[multi] gloo send/recv on CUDA tensors (two ranks on one card): "
        f"{' | '.join(f'rank {r}: {g}' for r, g in enumerate(got))}; "
        f"Mesh.exchange stages a CUDA rank's gloo transfers through pinned "
        f"host buffers, decided from the backend")
    return got


def exchange_timings(mesh, say):
    """Mesh.exchange of the headline code's roll windows at this world
    size, f32 and bf16 (B = 128): ms of the check side, the variable side
    and both (median of 3 after a warm-up, ranks aligned by a barrier),
    and the elements this rank receives an iteration beside an all-gather
    of every rank's messages."""
    from qamreconciliation_tpu_torch.models.qc_decoder import make_qc_ldpc
    from qamreconciliation_tpu_torch.parallel.halo import roll_plan

    base, _, _ = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                              CODE["dc"], seed=CODE["seed"])
    rows = [[] for _ in range(SHAPE[0])]
    for c, v, sh in base:
        rows[c].append((v, sh))
    plan = roll_plan(rows, CODE["z"], mesh.world, mesh.rank,
                     device=mesh.device)
    zl, B = CODE["z"] // mesh.world, SHAPE[3]
    rt, rm = (n * B for n in plan.received())
    gathered = plan.all_gather_rows() * B
    out = {"received": (rt, rm), "all_gather": gathered}
    for dt in (torch.float32, torch.bfloat16):
        total = torch.ones((CODE["nb_v"], zl, B), dtype=dt,
                           device=mesh.device)
        c2v = torch.ones((SHAPE[0], SHAPE[1], zl, B), dtype=dt,
                         device=mesh.device)

        def check_side():
            return mesh.exchange(plan.pack_totals(total), {
                q: (n, B) for q, n in plan.totals_recv.items()}, dt)

        def variable_side():
            return mesh.exchange(plan.pack_messages(c2v), {
                q: (n, B) for q, n in plan.messages_recv.items()}, dt)

        ms = {}
        for label, fn in (("check", check_side), ("variable", variable_side),
                          ("iteration", lambda: (check_side(),
                                                 variable_side()))):
            times = []
            for _ in range(4):
                mesh.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            ms[label] = statistics.median(times[1:])
        out[str(dt)[6:]] = ms
        say(f"[multi] Mesh.exchange, headline roll windows {str(dt)[6:]} "
            f"at world {mesh.world} (backend {mesh.backend}, staged through "
            f"host: {mesh.stage_host}): check side {ms['check']:.2f} ms, "
            f"variable side {ms['variable']:.2f} ms, both "
            f"{ms['iteration']:.2f} ms an iteration (median of 3); rank "
            f"{mesh.rank} receives "
            f"{rt / 1e6:.2f} M + {rm / 1e6:.2f} M = {(rt + rm) / 1e6:.2f} M "
            f"elements an iteration, against {gathered / 1e6:.2f} M for an "
            f"all-gather of every rank's messages")
        del total, c2v
    return out


def decode_peak(dec, lappr, synd, maxiter=50):
    """(decode, seconds, peak bytes over the decode above what was
    allocated before it, that peak in all) of one decode_batched."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = dec.decode_batched(lappr, synd, maxiter)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, secs, peak - before, peak


def _multidevice_rank(work, fps1, knee1):
    """One of phase 16's two ranks (see phase_multidevice).  Returns its
    failed checks, its launches by item, and what the parent compares."""
    import torch.distributed as dist

    from qamreconciliation_tpu_torch.entry import dryrun_multichip
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.decoder import Decoder
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.parallel import (
        ShardedDecoder, ShardedQCDecoder, make_mesh, shard_round,
    )
    from qamreconciliation_tpu_torch.sims import sim_bsc, sim_reconciliation
    from qamreconciliation_tpu_torch.sims.engine import (
        ReconciliationEngine, round_generator,
    )
    from qamreconciliation_tpu_torch.sims.streaming import StreamReconciler

    world = MULTI["world"]
    mesh = make_mesh(world, "dp", device="cuda")
    rank = mesh.rank
    log(f"[multi] rank {rank}: world size {mesh.world}, backend "
        f"{mesh.backend}, device {mesh.device} "
        f"({torch.cuda.get_device_name(mesh.device)})")
    say = log if rank == 0 else (lambda msg: None)
    fails, launches = [], {name: {} for name in DECODE_KERNELS}
    out = {"rank": rank, "fails": fails, "launches": launches, "fps": {}}

    def check(ok, what):
        if not ok:
            fails.append(what)
            log(f"[multi] rank {rank} FAILED: {what}")

    def counted(label, fn):
        """fn() with the counts set to 0 just before and read just after."""
        torch.cuda.synchronize()
        reset_counts()
        result = fn()
        torch.cuda.synchronize()
        got = {n: c for n, c in counts().items() if c}
        log(f"[multi] rank {rank} {label}: launches {got}")
        for name, c in got.items():
            if name in launches:     # the decode kernels only
                launches[name][label] = c
        return result

    # what gloo does with CUDA tensors, and the collectives' cost at the
    # sharded decoders' sizes
    x = torch.arange(4, dtype=torch.float32, device=mesh.device) + 10 * rank
    try:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        exact = all(torch.equal(parts[k], x - 10 * rank + 10 * k)
                    for k in range(world))
        say(f"[multi] gloo all_gather on CUDA tensors: "
            f"{'exact' if exact else 'WRONG values'}")
    except RuntimeError as e:
        say(f"[multi] gloo all_gather on CUDA tensors raises: "
            f"{str(e).splitlines()[0][:160]}")
    for label, fn, shape in (
            ("all_reduce_sum [64800, 128] f32 (ShardedDecoder partials)",
             mesh.all_reduce_sum, (64800, 128)),
            ("all_gather [90, 6, 180, 128] f32 (ShardedQCDecoder messages)",
             mesh.all_gather, (90, 6, 180, 128))):
        buf = torch.ones(shape, device=mesh.device)
        times = []
        for _ in range(4):
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(buf)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        say(f"[multi] {label}: {statistics.median(times[1:]):.2f} ms median "
            f"of 3 (two ranks on one card, gloo)")
        out.setdefault("collective_ms", {})[label] = statistics.median(
            times[1:])
        del buf
    out["exchange"] = exchange_timings(mesh, say)

    # 2. frame-shard rounds at the headline
    pa = PAMAlphabet(2, 2.0)
    snr, seed = MULTI["snr"], MULTI["seed"]
    for label, (make, (vid, cid), dtype, kernel) in multi_paths().items():
        dec = make()
        mat = Matrix(vid, cid)
        local = ReconciliationEngine(dec, mat, pa, batch=128, dtype=dtype)
        nm = local.make_noisemapper(snr, ALTERNATING)
        sigma = math.sqrt(local.noise_var(snr))

        def one(gen):
            return local.round("softening", nm, sigma, 1.0, 50,
                               generator=gen)

        got = counted(f"{label}, world-2 round",
                      lambda: shard_round(one, mesh)(seed, 0)).tolist()
        want = [0, 0, 0, 0]
        for k in range(world):
            c = one(round_generator(seed, 0, "cuda", rank=k)).tolist()
            want = [a + b for a, b in zip(want, c)]
        check(got == want, f"{label}: world-2 counters {got} != the sum of "
              f"the rank rounds {want}")
        check(launches[kernel].get(f"{label}, world-2 round", 0) > 0,
              f"{label}: no {kernel} launch")
        sharded = ReconciliationEngine(dec, mat, pa, batch=128, dtype=dtype,
                                       mesh_axis=(mesh, "dp"))
        r = counted(f"{label}, world-2 point",
                    lambda: multi_point(sharded))
        out["fps"][label] = r.frames_per_s
        say(f"[multi] {label}: world-2 round counters {got} == sum of the "
            f"two ranks' single rounds {want}; {r.frames} frames at {snr} "
            f"dB: FER {r.fer:.4f}, {r.frames_per_s:.1f} frames/s at world 2 "
            f"against {fps1[label]:.1f} at world 1 (two ranks on one card)")
        del dec, local, sharded

    # 3. graph sharding
    gs = make_mesh(world, "gs", device="cuda")
    dvid, dcid = dvbs2_code("1/2")
    dmat = Matrix(dvid, dcid)
    lappr, synd = softening_frames(Decoder(dvid, dcid, device="cuda"), dmat,
                                   ((3.75, 128),), seed=seed)
    for dt, kw in ((torch.float32, {}),
                   (torch.bfloat16, dict(check_rule="minsum"))):
        name = f"{str(dt)[6:]} {'min-sum' if kw else 'phi'}"
        want = Decoder(dvid, dcid, dt, device="cuda", **kw).decode_batched(
            lappr, synd, 50)
        sdec = ShardedDecoder(dvid, dcid, gs, dtype=dt, **kw)
        t0 = time.perf_counter()
        got = counted(f"ShardedDecoder DVB-S2 1/2 {name}",
                      lambda: sdec.decode_batched(lappr, synd, 50))
        secs = time.perf_counter() - t0
        ok, diff, beyond, med = shard_finals(got[2], want[2], want[0], dt)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ShardedDecoder {name}: success or iters differ")
        check(ok, f"ShardedDecoder {name}: finals differ beyond the tests' "
              f"rule (max |diff| {diff:.3e}, {beyond} elements beyond "
              f"{SHARD_TOL[dt]}, largest converged-frame median {med:.3e} "
              f"of the bound)")
        say(f"[multi] ShardedDecoder DVB-S2 1/2 {name}, 128 frames at 3.75 "
            f"dB: success {int(got[0].sum())}/128, iters"
            f"{' and every hard decision' if dt == torch.float32 else ''} "
            f"equal to the single device; final max |diff| {diff:.3e}, "
            f"{beyond} of {got[2].numel()} elements beyond {SHARD_TOL[dt]} "
            f"(at most {SHARD_BEYOND:g} of them for float32), largest "
            f"converged-frame median {med:.3e} of that bound; "
            f"{sdec.iterations_run} iterations, "
            f"{1e3 * secs / max(sdec.iterations_run, 1):.2f} ms each")
    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    z = CODE["z"]
    lappr, synd, _ = softening_llrs(base, z, ((4.0, 128),), seed=seed)
    mib = 2.0 ** 20
    for dt, kw in ((torch.float32, {}),
                   (torch.bfloat16, dict(check_rule="minsum"))):
        name = f"{str(dt)[6:]} {'min-sum' if kw else 'phi'}"
        one = QCDecoder(base, z, dt, device="cuda", **kw)
        want, secs1, over1, peak1 = decode_peak(one, lappr, synd)
        sdec = ShardedQCDecoder(base, z, gs, dtype=dt, **kw)
        got, secs, over2, peak2 = counted(
            f"ShardedQCDecoder headline {name}",
            lambda: decode_peak(sdec, lappr, synd))
        check(all(map(torch.equal, got, want)),
              f"ShardedQCDecoder {name}: not torch.equal to the dense "
              f"decoder")
        check(over2 < over1, f"ShardedQCDecoder {name}: peak memory over "
              f"the decode {over2 / mib:.1f} MiB at world {world}, not below "
              f"world 1's {over1 / mib:.1f} MiB")
        its = max(sdec.iterations_run, 1)
        out.setdefault("sharded_qc", {})[name] = dict(
            ms_per_iteration=1e3 * secs / its,
            ms_per_iteration_world1=1e3 * secs1 / max(one.iterations_run, 1),
            iterations=sdec.iterations_run, peak_over_decode=over2,
            peak_over_decode_world1=over1, peak=peak2, peak_world1=peak1)
        log(f"[multi] rank {rank} ShardedQCDecoder headline {name}, 128 "
            f"frames at 4.0 dB: torch.equal to the single-device dense "
            f"decoder: {all(map(torch.equal, got, want))} "
            f"({int(got[0].sum())}/128 decoded); {sdec.iterations_run} "
            f"iterations, {1e3 * secs / its:.2f} ms each (world 1, this "
            f"rank: {1e3 * secs1 / max(one.iterations_run, 1):.2f}); "
            f"torch.cuda.max_memory_allocated over the decode "
            f"{over2 / mib:.1f} MiB above the {(peak2 - over2) / mib:.1f} MiB "
            f"allocated before it (world 1: {over1 / mib:.1f} MiB above "
            f"{(peak1 - over1) / mib:.1f})")
        del one, sdec, want, got

    # 4. the CLIs, as ranks of this group
    qc_csv = os.path.join(work, "qc.csv")
    common = ["--batch", "128", "--maxiter", "50", "--device", "cuda",
              "--devices", str(world)]
    recon = ["--snr", "3.5", "4.0", "--nsnr", "2", "--simloops", "256"]
    knee = ["--snr", "3.5", "3.5", "--nsnr", "1", "--simloops", "1024",
            "--ferr-count-min", "1000000000", "--resident", "--dtype",
            "bfloat16"]
    out["cli"] = {}
    for label, module, argv in (
            ("dense", sim_reconciliation, [qc_csv, "--qc", *recon]),
            ("resident", sim_reconciliation,
             [qc_csv, "--qc", "--resident", "--dtype", "bfloat16", *recon]),
            ("graph-shard", sim_reconciliation,
             [qc_csv, "--qc", "--graph-shard", *recon]),
            ("bsc", sim_bsc, [qc_csv, "--qc", "--rber", "0.03", "0.03",
                              "--rpoints", "1", "--simloops", "256"]),
            ("knee", sim_reconciliation,
             [os.path.join(work, "knee.csv"), "--qc", *knee])):
        res = counted(f"CLI {label}", lambda: module.main(
            argv + common + ["--out", os.path.join(work, f"{label}.out")]))
        out["cli"][label] = [(r.snr_dB, r.frames, r.fer, r.frames_per_s)
                             for r in res]
        for r in res:
            say(f"[multi] CLI {label} --devices {world}: point {r.snr_dB}: "
                f"{r.frames} frames, FER {r.fer:.4f}, mean iters "
                f"{r.iters:.2f}, {r.frames_per_s:.1f} frames/s (two ranks "
                f"on one card)")
    fer2 = out["cli"]["knee"][0][2]
    bound = fer_bound(knee1, 1024)
    say(f"[multi] knee watch, resident bf16, 1024 frames at 3.5 dB: FER "
        f"{fer2:.4f} at --devices 2 against {knee1:.4f} on one device "
        f"(4 standard errors {bound:.4f})")
    check(abs(fer2 - knee1) <= bound, f"knee FER {fer2} at world 2 against "
          f"{knee1} at world 1, beyond {bound:.4f}")

    # 5. the frame-sharded fused stream at the JAX bench's streaming row
    s_mesh = make_mesh(world, "sdp", device="cuda")
    N0 = pa.variance * 10 ** (-STREAM["snr"] / 10) / 2
    nm = NoiseMapper(pa, N0, dtype="bfloat16", device="cuda")
    mat = Matrix(vid, cid)
    sdec = QCDecoder(base, z, "bfloat16", device="cuda",
                     check_rule="minsum", resident=True, resident_chunk=25)
    stream = stream_data(pa, N0, mat.vnum // 2, STREAM["frames"])
    res, slaunch, rate = stream_fused_best(
        lambda: StreamReconciler(sdec, mat, pa, nm, batch=STREAM["batch"],
                                 mesh_axis=(s_mesh, "sdp")),
        stream, f"rank {rank} frame-sharded stream_fused, resident min-sum "
        f"chunk 25, {STREAM['batch'] // world} frames a rank")
    for name, c in slaunch.items():
        if c and name in launches:
            launches[name]["stream_fused frame-sharded"] = c
    out["stream"] = (stream_view(res), rate)

    # 6. the dry run
    out["dryrun"] = counted("dryrun_multichip(2)",
                            lambda: dryrun_multichip(world, "cuda"))
    return out


def phase_multidevice(kernels):
    """Multi-device reconciliation (parallel/) on two ranks that share the
    card (gloo: NCCL takes one rank a card), each rank with the counts set
    to 0 just before each item and read just after:

    1. kernels 4 and 1 at one rank's shapes against their plain versions
       (multi_kernels, in this process before the ranks start), and gloo's
       send/recv on CUDA tensors (p2p_probe, two ranks of its own); in the
       ranks, the collectives' ms and Mesh.exchange's for the headline
       roll windows (exchange_timings);
    2. frame-shard rounds at the headline (4-PAM softening, B = 128 a rank,
       3.5 dB, 50 iterations) on the dense f32 phi (kernel 1), resident
       bf16 (kernel 2), resident layered bf16 min-sum (kernel 3) and the
       exact DVB-S2 1/2 H's generic f32 phi (kernel 4) decoders: the
       world-2 counters equal the sum of the two ranks' single rounds, and
       frames/s at world 2 beside world 1 (this process, alone);
    3. ShardedDecoder on the DVB-S2 1/2 H (128 frames at 3.75 dB, f32 phi
       and bf16 min-sum) against the single-device Decoder: success and
       iters equal, finals as the tests bind them (bf16 within one ulp,
       f32 every hard decision, its magnitudes reported); ShardedQCDecoder
       on the headline (f32 phi, bf16 min-sum) torch.equal to the dense
       QCDecoder, its ms an iteration and each rank's peak memory over the
       decode (torch.cuda.max_memory_allocated), which must lie below the
       single-device decode's;
    4. the CLIs as ranks: sim_reconciliation --qc --devices 2 (dense,
       --resident), --graph-shard, sim_bsc --devices 2, one CSV each from
       rank 0; the knee watch at --devices 2 within 4 standard errors of
       the single-device FER;
    5. stream_fused frame-sharded at the JAX bench's streaming row (STREAM),
       equal on all 256 frames to the single-device driver (this process),
       symbols/s;
    6. dryrun_multichip(2).

    Each kernel's record gets its per-rank-shape times under
    ``multidevice_ms`` and its launches on these paths, by rank and item,
    under ``multidevice_launches``."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.matrix import Matrix
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc, save_qc_csv,
    )
    from qamreconciliation_tpu_torch.parallel.mesh import run_ranks
    from qamreconciliation_tpu_torch.sims import sim_reconciliation
    from qamreconciliation_tpu_torch.sims.engine import ReconciliationEngine
    from qamreconciliation_tpu_torch.sims.streaming import StreamReconciler

    multi_kernels(kernels)
    p2p_probe()
    pa = PAMAlphabet(2, 2.0)
    fps1 = {}
    for label, (make, (vid, cid), dtype, _) in multi_paths().items():
        eng = ReconciliationEngine(make(), Matrix(vid, cid), pa, batch=128,
                                   dtype=dtype)
        eng.run_point("softening", MULTI["snr"], 50, 128, 10 ** 9,
                      nmconfig=ALTERNATING)              # warm-up
        fps1[label] = multi_point(eng).frames_per_s
        del eng
    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    z = CODE["z"]
    N0 = pa.variance * 10 ** (-STREAM["snr"] / 10) / 2
    mat = Matrix(vid, cid)
    stream = stream_data(pa, N0, mat.vnum // 2, STREAM["frames"])
    sdec = QCDecoder(base, z, "bfloat16", device="cuda", check_rule="minsum",
                     resident=True, resident_chunk=25)
    nm = NoiseMapper(pa, N0, dtype="bfloat16", device="cuda")
    single, _, rate1 = stream_fused_best(
        lambda: StreamReconciler(sdec, mat, pa, nm, batch=STREAM["batch"]),
        stream, "single-device stream_fused, resident min-sum chunk 25")
    with tempfile.TemporaryDirectory() as work:
        save_qc_csv(os.path.join(work, "qc.csv"), base, z)
        kbase, _, _ = make_qc_ldpc(KNEE_CODE["nb_v"], KNEE_CODE["z"],
                                   KNEE_CODE["dv"], KNEE_CODE["dc"],
                                   seed=KNEE_CODE["seed"])
        save_qc_csv(os.path.join(work, "knee.csv"), kbase, KNEE_CODE["z"])
        knee1 = sim_reconciliation.main([
            os.path.join(work, "knee.csv"), "--qc", "--snr", "3.5", "3.5",
            "--nsnr", "1", "--simloops", "1024", "--ferr-count-min",
            "1000000000", "--resident", "--dtype", "bfloat16", "--batch",
            "128", "--maxiter", "50", "--device", "cuda", "--out",
            os.path.join(work, "knee1.out")])[0].fer
        os.remove(os.path.join(work, "knee1.out"))
        del sdec, nm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results = run_ranks(_multidevice_rank, MULTI["world"],
                            (work, fps1, knee1), device="cuda",
                            timeout=MULTI["timeout"])
        log(f"[multi] two ranks ran in {time.perf_counter() - t0:.1f} s")
        outs = sorted(os.listdir(work))
    want_files = sorted(["qc.csv", "knee.csv", "dense.out", "resident.out",
                         "graph-shard.out", "bsc.out", "knee.out"])
    fails = [f"rank {r['rank']}: {f}" for r in results for f in r["fails"]]
    if outs != want_files:
        fails.append(f"CLI outputs {outs}, expected one CSV a CLI")
    r0 = results[0]
    if any([row[:3] for row in rows] != [row[:3] for row in r0["cli"][k]]
           for r in results for k, rows in r["cli"].items()):
        fails.append("the ranks' CLI results differ")
    view, rate2 = r0["stream"]
    if any(r["stream"][0][:4] != view[:4]
           or not np.array_equal(r["stream"][0][4], view[4])
           for r in results):
        fails.append("the ranks' streams differ")
    want = stream_view(single)
    if view[:4] != want[:4] or not np.array_equal(view[4], want[4]):
        fails.append("the frame-sharded stream differs from the "
                     "single-device one")
    log(f"[multi] frame-sharded stream_fused == single device on all "
        f"{view[0]} frames (success, iterations, words, bit errors): "
        f"{view[:4] == want[:4] and np.array_equal(view[4], want[4])}; "
        f"{rate2:.1f} symbols/s at world 2 against {rate1:.1f} at world 1 "
        f"(two ranks on one card)")
    for line in r0["dryrun"]:
        log(f"[multi] {line}")
    if len(r0["dryrun"]) != 7:
        fails.append(f"dryrun_multichip(2) printed {len(r0['dryrun'])} lines")
    for name in DECODE_KERNELS:
        by_item = {f"rank {r['rank']}: {item}": c for r in results
                   for item, c in r["launches"][name].items()}
        record(kernels, name, multidevice_launches=by_item)
        if name != "check_node_update_fused" and not any(
                r["launches"][name] for r in results):
            fails.append(f"{name} was not launched on the multi-device "
                         f"paths")
    for f in fails:
        log(f"[multi] FAILED: {f}")
    assert not fails, f"phase 16: {len(fails)} check(s) failed"


# ------------------------------------------------------------------------
# The Tail: compressed-state min-sum, stochastically rounded messages, the
# numpy oracles (phase 17)

# the JAX package's own FER at the knee configuration with the SR flags
# (dense bf16 tanh-F/B, --sr-messages) on the CPU:
#   JAX_PLATFORMS=cpu python scripts/run_r5_knee.py \
#       --configs "dense bf16 tanhfb SR"
# and its TPU figure (BASELINE.md:727), printed beside it
KNEE_SR_FER_CPU = 0.52734375
KNEE_SR_FER_TPU = 0.5889
# the oracle frames: 8 headline frames at this point (4-PAM, Alternating)
ORACLE = dict(frames=8, snr=4.5, seed=1)


def timed_decode(dec, lappr, synd, maxiter=50):
    """(success, iters, final), ms an iteration, iterations run."""
    dec.iterations_run = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dec.decode_batched(lappr, synd, maxiter)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, ms / max(dec.iterations_run, 1), dec.iterations_run


def phase_tail():
    """Compressed-state min-sum against the dense min-sum decode through
    kernel 1 on identical headline inputs (bf16, 3.5 dB, B = 128),
    torch.equal on success, iters and finals, ms an iteration of both;
    the --sr-messages CLI on the headline at 3.5 / 4.0 dB (the plain check
    update: kernel 1 launched no time); the --sr-messages knee watch held
    to the JAX package's CPU figure; 8 headline frames of the numpy
    softening oracle through DecoderNp on the host and the dense decoder
    on the card, success and hard decisions compared."""
    from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
    from qamreconciliation_tpu_torch.models.decoder_np import DecoderNp
    from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
    from qamreconciliation_tpu_torch.models.qc_decoder import (
        QCDecoder, make_qc_ldpc,
    )
    from qamreconciliation_tpu_torch.utils.reference_np import (
        softening_frames_np,
    )

    base, vid, cid = make_qc_ldpc(CODE["nb_v"], CODE["z"], CODE["dv"],
                                  CODE["dc"], seed=CODE["seed"])
    z = CODE["z"]
    lappr, synd, _ = softening_llrs(base, z, ((3.5, 128),), seed=11)
    outs = {}
    for compressed in (False, True):
        dec = QCDecoder(base, z, "bfloat16", device="cuda",
                        check_rule="minsum", compressed=compressed)
        timed_decode(dec, lappr, synd, 3)                   # warm-up
        reset_counts()
        out, ms, its = timed_decode(dec, lappr, synd)
        launches = counts()["bp_check_phase_qc"]
        label = "compressed" if compressed else "dense"
        log(f"[tail] headline bf16 min-sum 3.5 dB, {label}: "
            f"{int(out[0].sum())}/128 decoded, {its} iterations, "
            f"{ms:.3f} ms an iteration, kernel 1 launches {launches}")
        assert launches == (0 if compressed else its) and its > 0
        outs[label] = out
    for a, b in zip(outs["compressed"], outs["dense"]):
        assert torch.equal(a, b), "compressed != dense min-sum"
    log("[tail] compressed == dense min-sum through kernel 1 (torch.equal "
        "on success, iters, finals)")

    res, launches, _ = run_cli(qc_code(base, z), [
        "--dtype", "bfloat16", "--sr-messages", "--snr", "3.5", "4.0",
        "--nsnr", "2", "--simloops", "256"], "tail sr headline")
    assert launches["bp_check_phase_qc"] == 0
    assert sum(r.bp_iterations for r in res) > 0
    assert res[1].fer <= res[0].fer + 0.05

    kz = KNEE_CODE["z"]
    kbase, _, _ = make_qc_ldpc(KNEE_CODE["nb_v"], kz, KNEE_CODE["dv"],
                               KNEE_CODE["dc"], seed=KNEE_CODE["seed"])
    res, launches, _ = run_cli(qc_code(kbase, kz), [
        "--dtype", "bfloat16", "--check-phi", "tanhfb", "--sr-messages",
        "--snr", "3.5", "3.5", "--nsnr", "1", "--simloops", "1024",
        "--ferr-count-min", "1000000000"], "tail sr knee")
    fer, p = res[0].fer, KNEE_SR_FER_CPU
    assert res[0].frames == 1024 and launches["bp_check_phase_qc"] == 0
    bound = 4 * math.sqrt(2 * p * (1 - p) / 1024)
    log(f"[knee] flooding CLI --dtype bfloat16 --check-phi tanhfb "
        f"--sr-messages FER {fer:.4f}  JAX CPU {p:.4f} (bound "
        f"+-{bound:.4f}); JAX TPU {KNEE_SR_FER_TPU}")
    assert abs(fer - p) <= bound, (fer, p, bound)

    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10 ** (-ORACLE["snr"] / 10) / 2
    nm = NoiseMapper(pa, N0, ALTERNATING, dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    oracle = DecoderNp(vid, cid)
    # 4-PAM: two bits a symbol
    lap, word = softening_frames_np(nm, pa, ORACLE["frames"],
                                    CODE["nb_v"] * z // 2,
                                    seed=ORACLE["seed"])
    host = [oracle.decode(lap[f], oracle.eval_syndrome(word[f]), 50)
            for f in range(ORACLE["frames"])]
    host_s = time.perf_counter() - t0
    dec = QCDecoder(base, z, device="cuda")
    wsynd = dec.syndrome_from_bits(torch.as_tensor(word.T, device="cuda"))
    reset_counts()
    s, i, fin = dec.decode_batched(torch.as_tensor(lap.T, device="cuda"),
                                   wsynd, 50)
    assert counts()["bp_check_phase_qc"] == dec.iterations_run > 0
    same_s = [bool(s[f]) == host[f][0] for f in range(ORACLE["frames"])]
    same_hd = [torch.equal(fin[:, f].cpu() < 0,
                           torch.from_numpy(host[f][2] < 0))
               for f in range(ORACLE["frames"])]
    log(f"[tail] oracle: {ORACLE['frames']} headline frames at "
        f"{ORACLE['snr']} dB, softening_frames_np -> DecoderNp on the host "
        f"({host_s:.1f} s; success {[h[0] for h in host]}, iters "
        f"{[h[1] for h in host]}) and the dense f32 phi decoder on the card "
        f"(iters {i.tolist()}): success agrees {sum(same_s)}/"
        f"{ORACLE['frames']}, hard decisions agree {sum(same_hd)}/"
        f"{ORACLE['frames']}")
    assert all(same_s) and all(same_hd)


# the bench's rows as its JSON names them (the decode probe and the
# headline at its top level), and those that decode through a kernel
BENCH_ROWS = ("irregular_qc", "rate34_qc", "headline_round", "waterfall",
              "minsum", "sumproduct_tanhfb_dense", "layered", "streaming",
              "mc_mi", "generic", "baseline")
BENCH_DECODE_ROWS = ("irregular_qc", "rate34_qc", "headline_round",
                     "waterfall", "minsum", "minsum.waterfall",
                     "sumproduct_tanhfb_dense",
                     "sumproduct_tanhfb_dense.waterfall", "layered",
                     "streaming", "generic")


def phase_bench():
    """The bench in a subprocess at its defaults (the baseline's budget cut
    to 5 s): one JSON line on its stdout, every row, the card's name and
    power limit, each decode row equal to its plain version (the bench
    fails otherwise) and at most its bound."""
    env = dict(os.environ, BENCH_BASELINE_S="5")
    out = subprocess.run(
        [sys.executable, "-m", "qamreconciliation_tpu_torch.bench"],
        capture_output=True, text=True, timeout=900, env=env)
    for line in out.stderr.splitlines():
        log(f"[bench] {line}")
    assert out.returncode == 0, f"bench exited {out.returncode}"
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"bench printed {len(lines)} lines"
    log(f"[bench] {lines[0]}")
    j = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline",
                "decode_ms_per_iter", *BENCH_ROWS):
        assert j.get(key) is not None, f"bench: no {key}"
    dev = j["device"]
    assert dev["platform"] == "gpu" and dev["name"] and dev["power_limit"]
    for path in ("",) + BENCH_DECODE_ROWS:
        r = j
        for key in filter(None, path.split(".")):
            r = r[key]
        assert r["plain_equal"] is True, path
        assert 0 < r["roofline_fraction"] <= 1.0, (path, r)


# ------------------------------------------------------------------------
# The experiment campaigns (qamreconciliation_tpu_torch/scripts)

# the mode comparison (run_r5_dvbs2's wf step and run_waterfall --dvbs2 1/2
# with --hard and with --direct) at three points of 256 frames
CAMPAIGN_MODES = {"softening": ["--resident", "--resident-rowgroup", "4"],
                  "hard": ["--hard"], "direct": ["--direct"]}
CAMPAIGN_FRAMES = 256
CAMPAIGN_FLAGS = ["--snr", "3.0", "3.5", "--nsnr", "3", "--simloops",
                  str(CAMPAIGN_FRAMES), "--batch", "128", "--maxiter", "50",
                  "--ferr-count-min", "1000000000", "--dtype", "bfloat16",
                  "--check-phi", "tanhfb"]


def campaign(main, argv, label):
    """A campaign's ``main(argv)`` in this process, every count set to 0
    just before and read just after; its records are logged under
    ``label`` and it must exit 0.  Returns (records, launches)."""
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        status = main(argv)
    launches = counts()
    recs = []
    for line in out.getvalue().splitlines():
        log(f"[{label}] {line}")
        if line.startswith("{"):
            recs.append(json.loads(line))
    log(f"[{label}] launches {launches}")
    assert status == 0, f"{label} exited {status}"
    return recs, launches


def phase_campaigns():
    """The campaigns of ``qamreconciliation_tpu_torch/scripts``: the mode
    comparison, the QC-against-exact-H equivalence as a user runs it, and
    one decode probe (see the module docstring, item 19)."""
    from qamreconciliation_tpu_torch.scripts import (
        run_r5_sp_grid, run_waterfall,
    )

    fers = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, flags in CAMPAIGN_MODES.items():
            out = os.path.join(tmp, f"wf_{mode}.csv")
            _, launches = campaign(run_waterfall.main, [
                out, "--dvbs2", "1/2", *flags, *CAMPAIGN_FLAGS,
                "--device", "cuda"], f"campaign {mode}")
            assert (launches["bp_check_phase_qc"]
                    + launches["bp_decode_rounds_qc"]) > 0, mode
            with open(out) as f:
                rows = list(csv.reader(f))
            assert rows[0] == ["", "EsN0dB", "ber", "fer", "iters"], rows[0]
            assert [float(r[1]) for r in rows[1:]] == [3.0, 3.25, 3.5]
            fers[mode] = [float(r[3]) for r in rows[1:]]
        for i, snr in enumerate((3.0, 3.25, 3.5)):
            log(f"[campaign modes] {snr} dB FER: " + ", ".join(
                f"{m} {fers[m][i]:.4f}" for m in CAMPAIGN_MODES))
            soft, direct = fers["softening"][i], fers["direct"][i]
            bound = fer_bound((soft + direct) / 2, CAMPAIGN_FRAMES)
            assert direct <= soft + bound, (snr, direct, soft, bound)
        assert fers["hard"][2] >= 0.9, fers["hard"]
        assert fers["softening"][2] <= 0.05, fers["softening"]
        assert fers["direct"][2] <= 0.05, fers["direct"]

        proc = subprocess.run(
            [sys.executable, "-m",
             "qamreconciliation_tpu_torch.scripts.run_r5_dvbs2", "--steps",
             "equiv", "--simloops", str(CAMPAIGN_FRAMES), "--outdir", tmp],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, TMPDIR=tmp))
        for line in proc.stdout.splitlines():
            log(f"[campaign equiv] {line}")
        assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
        rec = [json.loads(line) for line in proc.stdout.splitlines()
               if '"wrap_equivalence"' in line][0]
        qc, exact = rec["qc_full"]["fer"], rec["exact_generic"]["fer"]
        bound = fer_bound((qc + exact) / 2, CAMPAIGN_FRAMES)
        log(f"[campaign equiv] {rec['snr_dB']} dB: qc_full FER {qc:.4f}, "
            f"exact_generic FER {exact:.4f}, bound +-{bound:.4f}")
        assert abs(qc - exact) <= bound, (qc, exact, bound)

    recs, launches = campaign(run_r5_sp_grid.main, [
        "--configs", "sp reg tree c50", "--reps", "2", "--device", "cuda"],
        "campaign probe")
    assert launches["bp_decode_rounds_qc"] > 0, launches
    probe = [r for r in recs if r.get("config") == "sp reg tree c50"][0]
    assert probe["ms_per_iter"] > 0 and probe["plan"] is not None, probe


# ------------------------------------------------------------------------
# The attribution probes (qamreconciliation_tpu_torch/scripts/probe_*.py)

PROBE_SHAPE = (18, 6, 1800, 128)    # kernel 6 at N = 64800, B = 128
# z off the tile; B = 40 on the bulk path, B = 37 on the thread one; rows
# of 12 slots (scratch slots on the bulk path)
PROBE_RAGGED = ((5, 6, 70, 40), (3, 6, 70, 37), (3, 12, 70, 40))
# the path each shape's plan takes, in (f32, bf16)
PROBE_PATHS = {PROBE_SHAPE: ("bulk", "bulk"), (5, 6, 70, 40): ("bulk", "bulk"),
               (3, 6, 70, 37): ("thread", "thread"),
               (3, 12, 70, 40): ("bulk", "bulk")}
CHAIN_SHAPE = (512, 1024)           # kernel 7 at the probe's defaults
CHAIN_DEFAULTS = dict(iters=8000, chain=16)
PM = "qamreconciliation_tpu_torch.scripts"
# every variant of the six probes at N = 64800, B = 128, --iters, --reps
# and --p cut; the first of each runs in a subprocess as a user runs it
PROBE_RUNS = {
    "probe_check_math": [["--math", m, "--iters", "10", "--reps", "1"]
                         for m in ("copy", "phi", "minsum")],
    "probe_qc_parts": [["--part", "rolls", "--iters", "10", "--reps", "1"],
                       ["--part", "check", "--pallas", "1", "--iters", "10",
                        "--reps", "1"],
                       ["--part", "check", "--pallas", "0", "--iters", "10",
                        "--reps", "1"]],
    "probe_layered_parts": [["--part", p, "--grouped", g, "--iters", "5",
                             "--reps", "1"]
                            for g in ("1", "0")
                            for p in ("sweep", "parity", "full")],
    "probe_preamble": [["--reps", "3"], ["--bps", "4", "--reps", "3"],
                       ["--fy-mode", "poly", "--dtype", "bfloat16",
                        "--reps", "3"]],
    "probe_mcmi_parts": [["--variant", v, "--p", "256", "--reps", "1"]
                         for v in ("full", "poly", "nogather", "nonewton",
                                   "noexp")],
    "probe_bf16pack": [["--iters", "500", "--reps", "2"],
                       ["--iters", "500", "--reps", "2"]],
}


def probe_records(text, label):
    """The JSON records of a probe's stdout, each logged after
    ``[probe]``; the first must be the device record of the card."""
    recs = []
    for line in text.splitlines():
        log(f"[probe] {line}")
        if line.startswith("{"):
            recs.append(json.loads(line))
    dev = recs[0]
    assert dev["probe"] == label and dev["device"] \
        == torch.cuda.get_device_name(0) and dev["power_limit"], dev
    assert len(recs) > 1, label
    return recs[1:]


# registers and spill-store bytes of every staged-tile instance (kernels
# 1 and 4), as ptxas reported them for the parent's, and the instances
# each library holds; kernel 6's own instances (check_math_kernel: per
# dtype the bulk path's phi and min-sum at dc 1-8 and on the scratch, its
# copy, and the thread path's three maths), none of which may spill
TILE_PTXAS = (80, 0)
TILE_INSTANCES = {"bp_check_phase_qc": 9, "bp_check_phase_generic": 6}
PROBE_INSTANCES = 44


def ptxas_instances(source, kernel):
    """(template arguments, registers, spill-store bytes) of every
    instance of ``kernel`` in ``source``'s ptxas report."""
    lines = PTXAS[source].splitlines()
    found = []
    for i, line in enumerate(lines):
        if "entry function" not in line or kernel not in line:
            continue
        name = re.search(kernel + r"I(\w+?)EEvP", line).group(1)
        rest = " ".join(lines[i + 1:i + 5])
        found.append((name,
                      int(re.search(r"Used (\d+) registers", rest).group(1)),
                      int(re.search(r"(\d+) bytes spill stores",
                                    rest).group(1))))
    return found


def tile_ptxas():
    """Each check_tile_kernel instance's (registers, spill bytes) in the
    libraries of kernels 1 and 4, logged, and held to TILE_PTXAS: kernel
    6's move off their loop leaves them as they were; and kernel 6's own
    instances, logged, none spilling."""
    for source, instances in TILE_INSTANCES.items():
        found = ptxas_instances(source, "check_tile_kernel")
        for name, regs, spill in found:
            log(f"[kernel6] ptxas {source} check_tile_kernel<{name}>: "
                f"{regs} registers, {spill} bytes spill stores")
            assert (regs, spill) == TILE_PTXAS, (source, name, regs, spill)
        assert len(found) == instances, (source, len(found))
    found = ptxas_instances("check_math_probe", "check_math_kernel")
    for name, regs, spill in found:
        log(f"[kernel6] ptxas check_math_kernel<{name}>: {regs} registers, "
            f"{spill} bytes spill stores")
        assert spill == 0, (name, spill)
    assert len(found) == PROBE_INSTANCES, len(found)


def probe_plan_text(plan):
    """A kernel 6 plan (ops/kernels.probe_tile_plan) as text."""
    return (f"{plan.path}, {plan.slots} slots, {plan.checks}x{plan.frames} "
            f"tile, {plan.stages} stage(s), {plan.threads} threads x "
            f"{plan.blocks_per_sm} an SM, {plan.grid} blocks, {plan.smem} B "
            "smem")


# kernel 6's phi instances on the bulk path's register slots at dc = 6,
# by dtype: their mangled names in the SASS
PHI_SASS = {torch.bfloat16: "check_math_kernelI13__nv_bfloat16Li0ELi6ELb1E",
            torch.float32: "check_math_kernelIfLi0ELi6ELb1E"}


def phi_issue_floors():
    """ms the warp schedulers need to issue the slot loop of kernel 6's
    phi instances (dc 6, bulk path) once per slot at the probe's shape,
    from their SASS (sims/sass_floor.py; a loop iteration is one pair's
    six slots), by dtype."""
    from qamreconciliation_tpu_torch.ops import cuda_build
    from qamreconciliation_tpu_torch.sims import sass_floor

    sass = subprocess.run(
        [cuda_build.cuda_tool("cuobjdump"), "-sass",
         str(cuda_build.build("check_math_probe"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    slots = math.prod(PROBE_SHAPE)
    floors = {}
    for dt, name in PHI_SASS.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            floors[dt] = sass_floor.floor_of(sass, name, slots, ilp=6)
        for line in out.getvalue().splitlines():
            log(f"[kernel6] sass {str(dt)[6:]}: {line}")
    return floors


def probe_kernel6(kernels):
    """Kernel 6 against its plain version, bit for bit, in every math and
    dtype at the probe's shape, on ragged shapes and on a dc > 8 shape,
    each case asserting its plan's path and slots, with its ms, plan,
    bytes, bound and share; kernel 6's phi timed in turns with kernel 1's
    phi on the same tiles at the probe's shape, and its issue floor."""
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_check_phase_qc, check_math_probe, check_math_probe_ref,
    )

    floors = phi_issue_floors()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape in (PROBE_SHAPE, *PROBE_RAGGED):
        nb_c, dc, z, B = shape
        t = 3.0 * torch.randn(shape, generator=gen, device="cuda")
        c2v = torch.randn(shape, generator=gen, device="cuda")
        synd = torch.randint(0, 2, (nb_c, z, B), generator=gen,
                             device="cuda", dtype=torch.int32)
        for dt in (torch.bfloat16, torch.float32):
            args = (t.to(dt), c2v.to(dt), synd)
            maths = ("phi", "copy", "minsum")
            cases = {}
            for math_ in maths:
                got, gviol = check_math_probe(*args, math_)
                plan = check_math_probe.plan
                want, wviol = check_math_probe_ref(*args, math_)
                torch.cuda.synchronize()
                name = f"{math_} {str(dt)[6:]} {list(shape)}"
                assert torch.equal(gviol, wviol), f"kernel 6 {name}: viol"
                assert torch.equal(got, want), f"kernel 6 {name}: not equal"
                path = PROBE_PATHS[shape][dt == torch.bfloat16]
                slots = ("none" if math_ == "copy" else "registers"
                         if path == "bulk" and dc <= 8 else "scratch")
                assert (plan.path, plan.slots) == (path, slots), (name, plan)
                nbytes, ops = perf.check_math_probe_work(*shape, dt, math_)
                assert nbytes == moved(*args, got, gviol), nbytes
                cases[math_] = (name, plan, nbytes, ops,
                                float((got.float() - want.float()).abs().max()))
            # the three maths (and kernel 1's phi at the probe's shape) in
            # turns in one window, the plain versions in another, so that
            # no plain run sits between two kernel runs
            kernel_fns = [lambda m=m: check_math_probe(*args, m)
                          for m in maths]
            if shape == PROBE_SHAPE:
                kernel_fns.append(lambda: bp_check_phase_qc(*args))
            times = events_ms(*kernel_fns, reps=20, run=10)
            plain = events_ms(*[lambda m=m: check_math_probe_ref(*args, m)
                                for m in maths], reps=3, run=2)
            for math_, ms, plain_ms in zip(maths, times, plain):
                name, plan, nbytes, ops, err = cases[math_]
                bound_ms, by = perf.bound(nbytes, ops)
                log(f"[kernel6] {name:32s} bit-equal kernel {ms:.4f} ms  "
                    f"plain {plain_ms:.4f} ms  {nbytes / 1e6:.1f} MB, bound "
                    f"{bound_ms:.4f} ms by {by} ({100 * bound_ms / ms:.1f}%)"
                    f"  [{probe_plan_text(plan)}]")
                if shape == PROBE_SHAPE and math_ == "phi" \
                        and dt == torch.bfloat16:
                    record(kernels, "check_math_probe", max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                           shape=list(shape), dtype="bfloat16", math="phi")
            if shape == PROBE_SHAPE:
                k6_ms, k1_ms = times[0], times[3]
                bound_ms, _ = perf.bound(cases["phi"][2], 0)
                log(f"[kernel6] phi {str(dt)[6:]} {list(shape)}, same window"
                    f": kernel 6 {k6_ms:.4f} ms, kernel 1 {k1_ms:.4f} ms, "
                    f"ratio {k6_ms / k1_ms:.3f}; bound {bound_ms:.4f} ms, "
                    f"kernel 6's issue floor {floors[dt]:.4f} ms  "
                    f"[kernel 1: {plan_text(bp_check_phase_qc.plan)}]")
                if dt == torch.bfloat16:
                    record(kernels, "check_math_probe", kernel1_phi_ms=k1_ms,
                           ratio_to_kernel1=k6_ms / k1_ms,
                           issue_floor_ms=floors[dt])


def probe_kernel7(kernels):
    """Kernel 7 against its plain version, bit for bit, both modes and
    dtypes at [512, 1024] (4 iterations of the 16-step chain, and an odd
    unaligned view that takes the one-element path), then its time at the
    probe's defaults; the bf16 mac case also against its plain version at
    the defaults, and timed there."""
    from qamreconciliation_tpu_torch.ops.kernels import (
        elementwise_chain, elementwise_chain_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(7)
    base = torch.randn(CHAIN_SHAPE, generator=gen, device="cuda")
    numel = base.numel()
    for mode in ("mac", "exp"):
        for dt in (torch.float32, torch.bfloat16):
            x = base.to(dt)
            for xx in (x, x.view(-1)[1:1000]):
                got = elementwise_chain(xx, mode, 4, 16)
                want = elementwise_chain_ref(xx, mode, 4, 16)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (mode, dt, xx.shape)
            iters, chain = CHAIN_DEFAULTS["iters"], CHAIN_DEFAULTS["chain"]
            ms, = events_ms(
                lambda: elementwise_chain(x, mode, iters, chain),
                reps=3, warmup=1)
            nbytes, ops, rate, sfu = perf.elementwise_chain_work(
                numel, dt, iters, chain, mode)
            bound_ms, by = perf.bound(nbytes, ops, ops_per_s=rate,
                                      sfu_ops=sfu)
            text = (f"[kernel7] {mode} {str(dt)[6:]} {list(CHAIN_SHAPE)} "
                    f"bit-equal (4 x 16 steps); at {iters} x {chain}: kernel "
                    f"{ms:.4f} ms, bound {bound_ms:.4f} ms by {by} "
                    f"({100 * bound_ms / ms:.1f}%)")
            if sfu:
                text += (f", of which MUFU.EX2 "
                         f"{1e3 * sfu / perf.SFU_OPS_PER_S:.4f} ms and the "
                         f"{str(dt)[6:]} rate {1e3 * ops / rate:.4f} ms")
            if mode == "mac" and dt == torch.bfloat16:
                got = elementwise_chain(x, mode, iters, chain)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                want = elementwise_chain_ref(x, mode, iters, chain)
                stop.record()
                stop.synchronize()
                plain_ms = start.elapsed_time(stop)
                assert torch.equal(got, want), "kernel 7 bf16 mac: defaults"
                text += f", plain {plain_ms:.1f} ms, bit-equal there too"
                err = float((got.float() - want.float()).abs().max())
                record(kernels, "elementwise_chain", max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bytes=nbytes, ops=ops,
                       ops_per_s=rate, shape=list(CHAIN_SHAPE),
                       dtype="bfloat16", mode="mac", **CHAIN_DEFAULTS)
            log(text)


def phase_probes(kernels):
    """The attribution probes (see the module docstring, item 20)."""
    tile_ptxas()
    probe_kernel6(kernels)
    probe_kernel7(kernels)

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{PM}.{name}", *runs[0]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
        for name, runs in PROBE_RUNS.items()}
    t0 = time.perf_counter()
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        for line in err.splitlines()[-5:]:
            log(f"[probe] {name}: {line}")
        assert proc.returncode == 0, (name, proc.returncode, err[-3000:])
        probe_records(out, name)
    log(f"[probe] {len(procs)} probes as a user runs them, side by side: "
        f"{time.perf_counter() - t0:.1f} s (their times are not alone on "
        "the card)")

    reset_counts()
    for name, runs in PROBE_RUNS.items():
        module = importlib.import_module(f"{PM}.{name}")
        for argv in runs[1:]:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                status = module.main(argv)
            assert status == 0, (name, argv, status)
            for rec in probe_records(out.getvalue(), name):
                assert all(v is not None for k, v in rec.items()), rec
    launches = counts()
    log(f"[probe] launches {launches}")
    for name in ("check_math_probe", "elementwise_chain",
                 "bp_check_phase_qc"):
        assert launches[name] > 0, (name, launches)
    for name in ("check_math_probe", "elementwise_chain"):
        record(kernels, name, launches=launches[name])


# ------------------------------------------------------------------------
# The last probes: kernels 8 and 9, probe_fb_form, probe_decode,
# probe_round and probe_streaming

# registers of every instance of kernels 2 and 3 as ptxas reported them for
# the parent's build (PR 14's smoke), by mangled template arguments; none
# spills.  Moving kernel 2's check pass into bp_resident.cuh for kernel 9
# leaves them as they were.
RESIDENT_PTXAS = {
    "rounds_kernelIf13__nv_bfloat16Li2ELb0E": 56,
    "rounds_kernelIf13__nv_bfloat16Li2ELb1E": 56,
    "rounds_kernelIf13__nv_bfloat16Li1ELb0E": 53,
    "rounds_kernelIf13__nv_bfloat16Li1ELb1E": 56,
    "rounds_kernelIf13__nv_bfloat16Li0ELb0E": 48,
    "rounds_kernelIf13__nv_bfloat16Li0ELb1E": 45,
    "rounds_kernelI13__nv_bfloat16S1_Li2ELb0E": 56,
    "rounds_kernelI13__nv_bfloat16S1_Li2ELb1E": 56,
    "rounds_kernelI13__nv_bfloat16S1_Li1ELb0E": 52,
    "rounds_kernelI13__nv_bfloat16S1_Li1ELb1E": 56,
    "rounds_kernelI13__nv_bfloat16S1_Li0ELb0E": 48,
    "rounds_kernelI13__nv_bfloat16S1_Li0ELb1E": 45,
    "rounds_kernelIffLi2ELb0E": 56, "rounds_kernelIffLi2ELb1E": 56,
    "rounds_kernelIffLi1ELb0E": 50, "rounds_kernelIffLi1ELb1E": 54,
    "rounds_kernelIffLi0ELb0E": 42, "rounds_kernelIffLi0ELb1E": 44,
    "sweeps_kernelI13__nv_bfloat16Li2ELb0E": 64,
    "sweeps_kernelI13__nv_bfloat16Li2ELb1E": 64,
    "sweeps_kernelI13__nv_bfloat16Li1ELb0E": 55,
    "sweeps_kernelI13__nv_bfloat16Li1ELb1E": 64,
    "sweeps_kernelI13__nv_bfloat16Li0ELb0E": 54,
    "sweeps_kernelI13__nv_bfloat16Li0ELb1E": 60,
    "sweeps_kernelIfLi2ELb0E": 64, "sweeps_kernelIfLi2ELb1E": 64,
    "sweeps_kernelIfLi1ELb0E": 55, "sweeps_kernelIfLi1ELb1E": 64,
    "sweeps_kernelIfLi0ELb0E": 54, "sweeps_kernelIfLi0ELb1E": 60,
}
# kernel 9's (n, B, it0, K, path) from states where frames converge at
# different steps: z = 64 (bulk path) and z = 60 (thread path) with a
# ragged B, and the probe's shape (bulk)
BOOK_CASES = ((2304, 40, 3, 6, "bulk"), (2160, 40, 3, 6, "thread"),
              (64800, 128, 0, 8, "bulk"))
# kernel 9 from the probe's own inputs, timed: the probe's shape (bulk
# path, the record) and z = 1804 (the thread path at the same width)
BOOK_TIMED = ((64800, 128, 8, "bulk"), (36 * 1804, 128, 8, "thread"))
BOOK_SEED = 9


def resident_ptxas():
    """Kernels 2 and 3 keep the parent's registers and spill nothing;
    kernel 9's eight instances are logged (none spills: NO_SPILL)."""
    from qamreconciliation_tpu_torch.ops.cuda_build import ptxas_usage

    for key, regs in RESIDENT_PTXAS.items():
        source = ("bp_decode_rounds_qc" if key.startswith("rounds")
                  else "bp_layered_sweeps_qc")
        use = ptxas_usage(PTXAS[source], key)
        assert (use["registers"], use["spill_stores"]) == (regs, 0), \
            (key, use, regs)
    log(f"[kernel9] kernels 2 and 3: all {len(RESIDENT_PTXAS)} instances "
        "keep the parent's registers, no spill")


def book_case(tables, state, variant, it0, k):
    """Kernel 9 and its plain version from the same ``state`` (cloned),
    bit for bit on all six outputs; returns (kernel outputs, plain
    outputs, device launches of the call)."""
    from qamreconciliation_tpu_torch.ops.kernels import (
        resident_bookkeeping_probe, resident_bookkeeping_probe_ref,
    )

    got = [x.clone() for x in state]
    want = [x.clone() for x in state]
    d0 = resident_bookkeeping_probe.device_launches
    resident_bookkeeping_probe(tables, it0, 10 ** 6, *got, variant=variant,
                               k_rounds=k)
    launched = resident_bookkeeping_probe.device_launches - d0
    resident_bookkeeping_probe_ref(tables, it0, 10 ** 6, *want,
                                   variant=variant, k_rounds=k)
    torch.cuda.synchronize()
    names = ("total", "c2v", "prior", "synd", "final", "done", "iters",
             "viol")
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), f"kernel 9 {variant}: {name} differs"
    return got, want, launched


def rows_plan_text(plan):
    """Kernel 9's plan (ops/kernels.staged_rows_plan) as text."""
    ring = (f"one producer warp, {plan.stages} stages of {plan.rows} rows, "
            f"{plan.lanes} lanes a consumer, " if plan.path == "bulk" else "")
    return (f"{plan.path} path, {plan.threads} threads, {ring}totals in "
            f"{plan.totals} memory, {plan.smem} B smem, {plan.grid} blocks "
            f"({plan.blocks_per_sm} an SM)")


def probe_kernel9(kernels):
    """Kernel 9 against its plain version, bit for bit, in its four
    variants on both paths: from a state in which frames converge at
    different iterations (``probe_resident_vmem.mixed_state``; iters, done
    and the full capture fire) on the z = 64 (bulk) and z = 60 (thread)
    codes with B = 40 and at the probe's default shape, and from the
    probe's own inputs (random syndrome) at the probe's shape (bulk) and
    at z = 1804 (thread); each timed there, in turns with kernel 2's
    min-sum step on the same inputs and K, with its ptxas registers and
    spills, bytes, bound and share."""
    from qamreconciliation_tpu_torch.ops.cuda_build import ptxas_usage
    from qamreconciliation_tpu_torch.ops.kernels import (
        bp_decode_rounds_qc, resident_bookkeeping_probe,
        resident_bookkeeping_probe_ref,
    )
    from qamreconciliation_tpu_torch.scripts import probe_resident_vmem as P

    resident_ptxas()
    for n, B, it0, k, path in BOOK_CASES:
        tables = P.code_tables(n)
        state = P.mixed_state(tables, B, BOOK_SEED, "cuda")
        for variant in P.VARIANTS:
            got, _, launched = book_case(tables, state, variant, it0, k)
            assert resident_bookkeeping_probe.plan.path == path, \
                resident_bookkeeping_probe.plan
            done, iters, viol = got[5], got[6], got[7]
            text = (f"[kernel9] {variant:9s} n={n} B={B} it0={it0} K={k} "
                    f"{path}: bit-equal; {launched} device launches")
            if variant in ("nocapture", "full"):
                later = int((iters > it0).sum())
                # frames converge at the first step, at later steps and
                # never
                assert 0 < later and 0 < int(done.sum()) < B, \
                    (variant, done.tolist(), iters.tolist())
                text += (f"; done {int(done.sum())}/{B}, {later} converged "
                         f"after it0")
            if variant == "full":
                moved_final = int((got[4] != state[4]).flatten(0, 1)
                                  .any(0).sum())
                assert moved_final >= later, (moved_final, later)
                text += f"; final captured in {moved_final} frames"
            if variant != "nobook":
                assert bool((viol > 0).any()), viol.tolist()
            log(text)

    for n, B, k, path in BOOK_TIMED:
        tables = P.code_tables(n)
        shape = [tables.nb_v, tables.z, B]
        base = P.inputs(tables, B, "cuda")
        # kernel 2's min-sum step (the old design of the same check pass)
        # on the same inputs, timed in turns with each variant
        k2 = [x.clone() for x in base]
        k2_state = (*k2[:4], k2[5], k2[6])

        def kernel2():
            bp_decode_rounds_qc(tables, 0, 10 ** 6, *k2_state, rule="minsum",
                                k_rounds=k)

        for variant in P.VARIANTS:
            got, want, _ = book_case(tables, base, variant, 0, k)
            plan = resident_bookkeeping_probe.plan
            assert plan.path == path, plan
            scratch = [x.clone() for x in base]
            ms, k2_ms, ms1 = events_ms(
                lambda: resident_bookkeeping_probe(
                    tables, 0, 10 ** 6, *scratch, variant=variant,
                    k_rounds=k),
                kernel2,
                lambda: resident_bookkeeping_probe(
                    tables, 0, 10 ** 6, *scratch, variant=variant,
                    k_rounds=1),
                reps=10, warmup=2)
            plain_ms, = events_ms(lambda: resident_bookkeeping_probe_ref(
                tables, 0, 10 ** 6, *scratch, variant=variant, k_rounds=k),
                reps=2, warmup=0)
            # a call's own cost (the copies, the launch, the wrapper) off a
            # K-step call's time: the time of one more step
            step_ms = (ms - ms1) / (k - 1)
            ms, k2_ms, plain_ms = ms / k, k2_ms / k, plain_ms / k
            captured = int((got[5] != base[5]).sum())
            nbytes, ops = perf.resident_bookkeeping_work(
                tables.nb_v, tables.nb_c, tables.E, tables.z, B, variant,
                captured)
            bound_ms, by = perf.bound(nbytes, ops, k)
            use = ptxas_usage(PTXAS["resident_bookkeeping_probe"],
                              P.instance_key(variant, plan))
            assert use["spill_stores"] == use["spill_loads"] == 0, use
            log(f"[kernel9] {variant:9s} {shape} random syndrome: bit-equal;"
                f" per iteration kernel {ms:.4f} ms (a step beyond the "
                f"first {step_ms:.4f}), kernel 2 min-sum "
                f"{k2_ms:.4f} ms (ratio {ms / k2_ms:.3f}), plain "
                f"{plain_ms:.4f} ms; {nbytes / 1e6:.1f} MB a call of {k}, "
                f"bound {bound_ms:.4f} ms by {by} "
                f"({100 * bound_ms / ms:.1f}%); ptxas {use['registers']} "
                f"registers, {use['spill_stores']} / {use['spill_loads']} "
                f"bytes spill stores / loads; [{rows_plan_text(plan)}]")
            if variant == "full" and path == "bulk":
                err = float((got[0].float() - want[0].float()).abs().max())
                record(kernels, "resident_bookkeeping_probe",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, steps=k,
                       bytes=nbytes, ops=ops, shape=shape, dtype="bfloat16",
                       variant=variant, path=path,
                       registers=use["registers"],
                       kernel2_minsum_ms=k2_ms, step_ms=step_ms)
        log(f"[kernel9] kernel 2 min-sum {shape} K={k}: "
            f"[{resident_plan_text(bp_decode_rounds_qc.plan)}]")


def probe_kernel8(kernels):
    """Kernel 8 at every probe size: up to the opt-in limit equal to its
    plain version (on ones, 4.0, and on normals), one KiB past it refused
    with cudaErrorInvalidValue, after which the card still runs kernels;
    the sizes again from the limit down, bit-equal with no attribute call;
    its call at the limit timed in turns with an empty kernel's launch
    (the launch floor) and its plain version."""
    from qamreconciliation_tpu_torch.ops import kernels as K
    from qamreconciliation_tpu_torch.ops.kernels import (
        SharedMemoryRefused, empty_launch, smem_ceiling_probe,
        smem_ceiling_probe_ref,
    )
    from qamreconciliation_tpu_torch.scripts import probe_vmem

    dev = torch.device("cuda", 0)
    optin = probe_vmem.optin_bytes(dev)
    gen = torch.Generator(device="cuda").manual_seed(8)
    ones = torch.ones((8, 128), device="cuda")
    normal = torch.randn((8, 128), generator=gen, device="cuda")
    sizes = probe_vmem.sizes_kib(optin)
    for kib in sizes:
        nbytes = kib * 1024
        if nbytes > optin:
            try:
                smem_ceiling_probe(ones, nbytes)
            except SharedMemoryRefused as e:
                assert e.name == "cudaErrorInvalidValue", e
                log(f"[kernel8] {kib} KiB: refused ({e})")
            else:
                raise AssertionError(f"{kib} KiB was not refused")
            continue
        for x in (ones, normal):
            got = smem_ceiling_probe(x, nbytes)
            want = smem_ceiling_probe_ref(x, nbytes)
            torch.cuda.synchronize()
            assert torch.equal(got, want), kib
            err = float((got - want).abs().max())
        assert bool((smem_ceiling_probe(ones, nbytes) == 4.0).all()), kib
        log(f"[kernel8] {kib} KiB: bit-equal, 4.0 on ones")
    # no error of the refused request is left behind
    assert torch.equal(ones + ones, 2 * ones)
    # the limit granted, every smaller size launches without the attribute
    for kib in sorted((k for k in sizes if k * 1024 <= optin), reverse=True):
        assert not K._SMEM_PROBE_GRANTS.needs(0, kib * 1024), kib
        got = smem_ceiling_probe(normal, kib * 1024)
        assert torch.equal(got, smem_ceiling_probe_ref(normal, kib * 1024))
    log(f"[kernel8] {sorted(sizes, reverse=True)[1:]} KiB again, from the "
        "limit down: bit-equal, no attribute call")
    nbytes = optin
    ms, floor_ms, plain_ms = events_ms(
        lambda: smem_ceiling_probe(normal, nbytes),
        lambda: empty_launch(dev),
        lambda: smem_ceiling_probe_ref(normal, nbytes), reps=10, run=20)
    work, ops = perf.smem_ceiling_probe_work()
    assert work == moved(normal, normal)
    bound_ms, by = perf.bound(work, ops)
    log(f"[kernel8] at the limit, {optin} bytes, in turns (20 calls a run): "
        f"kernel 8's call {ms:.4f} ms, an empty kernel's launch (the launch "
        f"floor) {floor_ms:.4f} ms, {ms / floor_ms:.2f}x the floor; plain "
        f"{plain_ms:.4f} ms; bytes bound {bound_ms:.6f} ms by {by}")
    record(kernels, "smem_ceiling_probe", max_abs_err=err, ms=ms,
           plain_ms=plain_ms, bytes=work, ops=ops, smem_bytes=optin,
           launch_floor_ms=floor_ms)


# the six probes: the first run of each in a subprocess as a user runs it
# (all side by side), the rest through main() in this process, counted;
# --reps and --maxiter cut
TAIL_RUNS = {
    "probe_vmem": [[], []],
    "probe_resident_vmem": [["--variant", "full"]] + [
        ["--variant", v] for v in ("nobook", "violonly", "nocapture")],
    "probe_fb_form": [[]],
    "probe_decode": [["--reps", "1"],
                     ["--qc", "0", "--reps", "1"],
                     ["--resident", "1", "--reps", "1"],
                     ["--schedule", "layered", "--resident", "1",
                      "--check", "minsum", "--reps", "1"],
                     ["--pallas", "0", "--maxiter", "5", "--reps", "1"],
                     ["--ira", "1", "--nbv", "180", "--resident", "1",
                      "--phi", "tanhfb", "--reps", "1"]],
    "probe_round": [["--reps", "2"], ["--bps", "2", "--reps", "2"]],
    "probe_streaming": [["--frames", "128"],
                        ["--frames", "128", "--fused", "1"],
                        ["--frames", "128", "--handoff", "1"]],
}


def probe_output(text, label):
    """The output of a probe (each line logged after ``[probe]``) after its
    device record, which must name the card; returns (JSON records, other
    lines)."""
    lines = text.splitlines()
    for line in lines:
        log(f"[probe] {line}")
    dev = json.loads(lines[0])
    assert dev["probe"] == label and dev["device"] \
        == torch.cuda.get_device_name(0) and dev["power_limit"], dev
    recs = [json.loads(x) for x in lines[1:] if x.startswith("{")]
    rest = [x for x in lines[1:] if not x.startswith("{")]
    assert recs or rest, label
    return recs, rest


def check_tail_output(name, recs, rest):
    """What each probe's output must show."""
    if name == "probe_vmem":
        ok = [x for x in rest if "scratch: OK value=True" in x]
        fail = [x for x in rest if "scratch: FAIL cudaErrorInvalidValue" in x]
        assert len(ok) == len(probe_vmem_sizes()) - 1 and len(fail) == 1, rest
    elif name == "probe_resident_vmem":
        assert any("COMPILED+RAN" in x for x in rest) \
            and any("ms/iter" in x for x in rest) \
            and any(" 0 bytes spill stores, 0 bytes spill loads" in x
                    for x in rest), rest
    else:
        assert recs and all("error" not in r for r in recs), recs


def probe_vmem_sizes():
    from qamreconciliation_tpu_torch.scripts import probe_vmem

    return probe_vmem.sizes_kib(
        probe_vmem.optin_bytes(torch.device("cuda")))


def fb_form_equal():
    """probe_fb_form's two labels at each z, on the same inputs: the
    decodes' outputs torch.equal (one tanh-F/B kernel either way)."""
    from qamreconciliation_tpu_torch.scripts import probe_fb_form as P

    saved = (P.ITERS, P.REPS)
    P.ITERS, P.REPS = 50, 1
    try:
        by_nbv = {}
        for name, nbv, form in P.configs():
            rec, out = P.run(name, nbv, form, torch.device("cuda"),
                             np.random.default_rng(0))
            by_nbv.setdefault(nbv, []).append((name, out, rec))
        for nbv, ((n1, o1, r1), (n2, o2, r2)) in by_nbv.items():
            assert all(torch.equal(a, b) for a, b in zip(o1, o2)), nbv
            log(f"[probe] fb_form nbv={nbv}: {n1!r} and {n2!r} torch.equal "
                f"({r1['ms_per_iter']} / {r2['ms_per_iter']} ms an "
                "iteration at 50)")
    finally:
        P.ITERS, P.REPS = saved


def phase_probes_tail(kernels):
    """Kernels 8 and 9 and the last probes (see the module docstring, item
    21)."""
    probe_kernel9(kernels)
    probe_kernel8(kernels)

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{PM}.{name}", *runs[0]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
        for name, runs in TAIL_RUNS.items()}
    t0 = time.perf_counter()
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        for line in err.splitlines()[-5:]:
            log(f"[probe] {name}: {line}")
        assert proc.returncode == 0, (name, proc.returncode, err[-3000:])
        check_tail_output(name, *probe_output(out, name))
    log(f"[probe] {len(procs)} probes as a user runs them, side by side: "
        f"{time.perf_counter() - t0:.1f} s (their times are not alone on "
        "the card)")

    reset_counts()
    for name, runs in TAIL_RUNS.items():
        module = importlib.import_module(f"{PM}.{name}")
        for argv in runs[1:]:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                status = module.main(argv)
            assert status == 0, (name, argv, status)
            check_tail_output(name, *probe_output(out.getvalue(), name))
    fb_form_equal()
    launches = counts()
    log(f"[probe] launches {launches}")
    for name in ("smem_ceiling_probe", "resident_bookkeeping_probe",
                 "bp_check_phase_qc", "bp_decode_rounds_qc",
                 "bp_layered_sweeps_qc", "bp_check_phase_generic"):
        assert launches[name] > 0, (name, launches)
    for name in ("smem_ceiling_probe", "resident_bookkeeping_probe"):
        record(kernels, name, launches=launches[name])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sass_dir = argv[argv.index("--sass") + 1] if "--sass" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"device {torch.cuda.get_device_name(0)}")
    log(smi)

    t_all = time.perf_counter()
    build_all(sass_dir)
    kernels = {}
    for phase, args in ((phase_kernel, (kernels,)),
                        (phase_var_pass, (kernels,)),
                        (phase_softening, (kernels,)),
                        (phase_rounds, (kernels,)),
                        (phase_sweeps, (kernels,)),
                        (phase_decoder, ()),
                        (phase_resident_decoders, ()),
                        (phase_main_paths, (kernels,)),
                        (phase_knee, ()),
                        (phase_generic_kernels, (kernels,)),
                        (phase_generic_decoder, ()),
                        (phase_generic_main, (kernels,)),
                        (phase_generic_quality, ()),
                        (phase_modes, (kernels,)),
                        (phase_sweep_surface, (kernels,)),
                        (phase_streaming, (kernels,)),
                        (phase_multidevice, (kernels,)),
                        (phase_tail, ()),
                        (phase_bench, ()),
                        (phase_campaigns, ()),
                        (phase_probes, (kernels,)),
                        (phase_probes_tail, (kernels,))):
        t0 = time.perf_counter()
        phase(*args)
        log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_all:.1f} s")

    for name in KERNELS:
        finish_record(kernels[name])
        k = kernels[name]
        log(f"[bound] {name}: {k['bytes'] / 1e6:.1f} MB -> bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}, kernel {k['ms']:.4f}"
            f" ms ({100 * k['bound_share']:.1f}% of the bound), "
            f"{k['launches']} launches on its main path")
    print(json.dumps({"kernels": [kernels[n] for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
