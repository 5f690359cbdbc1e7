"""Headline bench of the port: decoded frames/s of soft reverse reconciliation.

    python3 -m qamreconciliation_tpu_torch.bench [--device cpu] [--seed S]
        [--rows decode,headline,...]

The port's counterpart of the JAX package's ``bench.py``: the same rows, in
the same order, through the port's modules, on one NVIDIA GPU (``--device
cpu`` runs the plain PyTorch versions on the CPU, for a smoke run).  The
workload is the JAX bench's: a rate-1/2 QC LDPC code of DVB-S2 size (N =
64800, a (3,6)-regular base graph lifted by z = N / BENCH_NBV), 4-PAM
softening reverse reconciliation, B = 128 frames a round, bf16 messages,
at most 50 BP iterations.  The rows (``--rows`` names, JSON keys):

* ``decode``: the headline decoder (resident sum-product, bf16 tanh-F/B,
  kernel 2) on 3-sigma LLRs and a random syndrome, so every frame runs
  ``BENCH_PROBE_ITERS`` iterations: ``decode_ms_per_iter`` and the rest of
  the JSON's top level; ``irregular_qc``, ``true_shape_qc`` (only when
  BENCH_NBV != 180) and ``rate34_qc``: the same probe on QC-IRA codes;
* ``headline``: ``run_point`` rounds at BENCH_SNR (3.5 dB, below the
  threshold: every frame runs 50 iterations), R = BENCH_RPD rounds a
  dispatch, ``nmconfig`` all zeros: the JSON's ``value``; ``waterfall``:
  the same decoder at BENCH_SNR2 (4.0 dB);
* ``minsum`` and ``sumproduct_tanhfb_dense`` (the dense QC decoder, kernel
  1), each at both points; ``layered`` (resident layered min-sum, kernel 3)
  at 4.0 dB; ``streaming`` (``StreamReconciler.stream_fused``, B = 64,
  2.33-frame chunks, 4.0 dB, resident min-sum); ``mc_mi`` (the Monte-Carlo
  mutual-information estimator, 2^21 samples, 8 dB, no kernel);
* ``generic``: the generic decoder (kernel 4) at the headline's dtype and
  rule on the exact DVB-S2 rate-1/2 H (N = 64800; at another BENCH_N the
  JAX bench's regular (3,6) code of that length);
* ``vs_baseline``: the C++ scalar decoder (``_graphcore.ScalarDecoder``) on
  one host core on softening frames of the headline code, within
  BENCH_BASELINE_S seconds and at least 3 frames; ``vs_baseline`` divides
  the headline's frames/s by its frames/s.

Knobs (the JAX bench's, less those that pick TPU layouts): BENCH_N,
BENCH_NBV, BENCH_BATCH, BENCH_QC=0 (the whole bench on the generic decoder
and ``make_regular_ldpc(BENCH_N, 3, 6, seed=12345)``), BENCH_SNR,
BENCH_SNR2, BENCH_MAXITER, BENCH_ROUNDS (rounds a repetition, a multiple
of BENCH_RPD), BENCH_RPD, BENCH_CHECK, BENCH_CHECK2, BENCH_SCHEDULE,
BENCH_SCHED2, BENCH_DTYPE, BENCH_BPS, BENCH_MODE, BENCH_LLR, BENCH_TOTALS,
BENCH_RESIDENT (auto: resident for flooding sum-product, and for min-sum
at 90 or more variable blocks), BENCH_RESIDENT_CHUNK,
BENCH_IRREGULAR_RESIDENT, BENCH_RATE34, BENCH_RATE34_RESIDENT,
BENCH_TRUE_SHAPE, BENCH_TANHFB, BENCH_LAYERED_RESIDENT, BENCH_STREAM,
BENCH_STREAM_DECODE (auto: resident at 32 or more block rows),
BENCH_STREAM_CHUNK, BENCH_STREAM_REPS, BENCH_MI, BENCH_MI_N,
BENCH_SKIP_DECODE, BENCH_SKIP_WATERFALL, BENCH_PROBE_ITERS,
BENCH_PROBE_REPS, BENCH_HEADLINE_REPS, BENCH_BASELINE_S (every other
throughput row takes 3 repetitions).  ``--seed`` is the workloads' base
seed: each row adds the JAX bench's seed to it.

Timing: the kernels are built before the first row (``build_s``); every
decoder runs one untimed call or round first.  The probes take CUDA events
(``sims/time_check_phase.events_ms``, the median of BENCH_PROBE_REPS
calls); a throughput row takes the host clock around work that ends in a
host read of its counters (which waits for the card) and reports the
median of its repetitions beside every one.  Beside the headline the
untraced round breakdown (``time_check_phase.round_breakdown``).

Correctness inside the run: each decode row's first timed batch is decoded
again through the decoder's plain version (every kernel hook swapped for
its ``*_ref``) on the same device and inputs, and (success, iters, hard
decisions) must be ``torch.equal``; frame counters must equal the frames
asked for; on the card, the row's kernel must have launched in its timed
window; the MC-MI estimates must lie within 4 standard errors of the host
quadrature.  Any failure, a kernel that does not build or launch, or a
baseline that does not build, fails the run: nothing falls back.

Bounds: each decode row reports ``bound_ms``, ``bound_by`` and
``roofline_fraction`` (bound over time): the least time the card could
take for the kernel work the row's timed window ran (``utils/perf.py``:
bytes at 3.35 TB/s or f32 operations at 33.5e12/s, whichever is larger),
per BP iteration for the probes, per round for the ``run_point`` rows and
per stream for ``streaming``.  Each row prints its FER and mean iterations
beside ``BENCH_r05.json``'s (JAX, TPU).

Output: one JSON line on stdout (``metric``, ``value``, ``unit``,
``vs_baseline``, the rows, ``device`` with the card's name and power limit
from nvidia-smi, ``build_s``); progress on stderr.  Exits 2 without a card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import platform
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .models.alphabet import PAMAlphabet
from .models.decoder import Decoder
from .models.matrix import Matrix
from .models.noisemapper import NoiseMapper
from .models.qc_decoder import QCDecoder, make_qc_ira, make_qc_ldpc
from .ops import cuda_build
from .ops import kernels as K
from .sims.engine import ReconciliationEngine, round_generator
from .sims.time_check_phase import events_ms, round_breakdown
from .utils import perf
from .utils.edgefile import make_regular_ldpc

__all__ = ["ROWS", "Settings", "WorkMeter", "plain_twin", "main"]

ROWS = ("decode", "irregular_qc", "true_shape_qc", "rate34_qc", "headline",
        "waterfall", "minsum", "sumproduct_tanhfb_dense", "layered",
        "streaming", "mc_mi", "generic", "vs_baseline")
# the decoders' kernel hooks (ops/kernels wrappers, each with a *_ref)
HOOKS = ("check_phase", "rounds_step", "sweeps_step")
# and the variable sides of the generic and dense QC decoders, which the
# meter does not count
PLAIN_HOOKS = HOOKS + ("var_fold", "var_pass")
KERNELS = ("bp_check_phase_qc", "bp_decode_rounds_qc", "bp_layered_sweeps_qc",
           "bp_check_phase_generic")
# BENCH_r05.json's (fer, mean_iters) of each row (JAX, TPU), printed beside
# the port's
JAX_TPU = {
    "headline": (1.0, 0.0), "waterfall": (0.0, 19.72),
    "minsum": (1.0, 0.0), "minsum waterfall": (0.0, 23.98),
    "sumproduct_tanhfb_dense": (1.0, 0.0),
    "sumproduct_tanhfb_dense waterfall": (0.0, 19.72),
    "layered": (0.0, 12.66), "streaming": (0.0, None),
}
BASELINE_MIN_FRAMES = 3
MIN_REPS = 3


class BenchError(RuntimeError):
    """A row failed a check: the run fails."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _flag(env, name, default):
    return env.get(name, default) == "1"


@dataclass
class Settings:
    """The BENCH_* knobs, with the JAX bench's defaults."""

    n: int
    nbv: int
    batch: int
    use_qc: bool
    snr: float
    snr2: float
    maxiter: int
    rounds: int
    rpd: int
    check: str
    check2: str
    schedule: str
    sched2: str
    dtype: str
    bps: int
    mode: str
    llr_mode: str
    totals: str
    resident: bool | None
    resident_chunk: int
    skip_decode: bool
    skip_waterfall: bool
    probe_iters: int
    probe_reps: int
    headline_reps: int
    irregular_resident: bool
    true_shape: bool
    rate34: bool
    rate34_resident: bool
    tanhfb: bool
    layered_resident: bool
    stream: bool
    stream_decode: str
    stream_chunk: int
    stream_reps: int
    mi: bool
    mi_n: int
    baseline_s: float

    @classmethod
    def from_env(cls, env):
        s = cls(
            n=int(env.get("BENCH_N", 64800)),
            nbv=int(env.get("BENCH_NBV", 180)),
            batch=int(env.get("BENCH_BATCH", 128)),
            use_qc=_flag(env, "BENCH_QC", "1"),
            snr=float(env.get("BENCH_SNR", 3.5)),
            snr2=float(env.get("BENCH_SNR2", 4.0)),
            maxiter=int(env.get("BENCH_MAXITER", 50)),
            rounds=int(env.get("BENCH_ROUNDS", 8)),
            rpd=int(env.get("BENCH_RPD", 8)),
            check=env.get("BENCH_CHECK", "sumproduct"),
            check2=env.get("BENCH_CHECK2", "minsum"),
            schedule=env.get("BENCH_SCHEDULE", "flooding"),
            sched2=env.get("BENCH_SCHED2", "layered"),
            dtype=env.get("BENCH_DTYPE", "bfloat16"),
            bps=int(env.get("BENCH_BPS", 2)),
            mode=env.get("BENCH_MODE", "softening"),
            llr_mode=env.get("BENCH_LLR", "poly"),
            totals=env.get("BENCH_TOTALS", "storage"),
            resident={"auto": None, "0": False, "1": True}[
                env.get("BENCH_RESIDENT", "auto")],
            resident_chunk=int(env.get("BENCH_RESIDENT_CHUNK", 50)),
            skip_decode=_flag(env, "BENCH_SKIP_DECODE", "0"),
            skip_waterfall=_flag(env, "BENCH_SKIP_WATERFALL", "0"),
            probe_iters=int(env.get("BENCH_PROBE_ITERS", 250)),
            probe_reps=int(env.get("BENCH_PROBE_REPS", 4)),
            headline_reps=int(env.get("BENCH_HEADLINE_REPS", 3)),
            irregular_resident=_flag(env, "BENCH_IRREGULAR_RESIDENT", "1"),
            true_shape=_flag(env, "BENCH_TRUE_SHAPE", "1"),
            rate34=_flag(env, "BENCH_RATE34", "1"),
            rate34_resident=_flag(env, "BENCH_RATE34_RESIDENT", "1"),
            tanhfb=_flag(env, "BENCH_TANHFB", "1"),
            layered_resident=_flag(env, "BENCH_LAYERED_RESIDENT", "1"),
            stream=_flag(env, "BENCH_STREAM", "1"),
            stream_decode=env.get("BENCH_STREAM_DECODE", "auto"),
            stream_chunk=int(env.get("BENCH_STREAM_CHUNK", 25)),
            stream_reps=int(env.get("BENCH_STREAM_REPS", 3)),
            mi=_flag(env, "BENCH_MI", "1"),
            mi_n=int(env.get("BENCH_MI_N", 1 << 21)),
            baseline_s=float(env.get("BENCH_BASELINE_S", 30.0)),
        )
        if min(s.headline_reps, s.stream_reps) < MIN_REPS:
            raise SystemExit(f"a throughput row takes at least {MIN_REPS} "
                             f"repetitions")
        if s.rounds % s.rpd:
            raise SystemExit(f"BENCH_ROUNDS ({s.rounds}) must be a multiple "
                             f"of BENCH_RPD ({s.rpd})")
        if s.use_qc and (s.n % s.nbv or s.nbv % 2):
            raise SystemExit(f"BENCH_QC=1 needs BENCH_N divisible by even "
                             f"BENCH_NBV, got N={s.n} nbv={s.nbv}")
        if not s.use_qc and s.schedule != "flooding":
            raise SystemExit("BENCH_SCHEDULE=layered requires BENCH_QC=1")
        return s


class WorkMeter:
    """The bytes and f32 operations (``utils/perf``) of the kernel calls a
    decoder makes at its hooks, from the tensors it passes: kernels 1 and 4
    per call, kernels 2 and 3 a call's state once and each step's
    operations."""

    def __init__(self):
        self.bytes = 0
        self.ops = 0

    def wrap(self, hook, fn):
        @functools.wraps(fn)
        def counted(*args, **kw):
            self._count(hook, args, kw)
            return fn(*args, **kw)
        return counted

    def _count(self, hook, args, kw):
        rule = kw["rule"]
        if hook == "check_phase":
            t, c2v = args[0], args[1]
            if t.dim() == 4:
                nbytes, ops = perf.check_phase_qc_work(
                    *t.shape, t.dtype, c2v.dtype, rule)
            else:
                nbytes, ops = perf.check_phase_generic_work(
                    *t.shape, t.dtype, rule)
        else:
            tables, it0, maxiter, total, c2v = args[:5]
            k = kw["k_rounds" if hook == "rounds_step" else "k_sweeps"]
            steps = max(min(k, maxiter - it0), 0)
            if not steps:
                return
            dims = (tables.nb_v, tables.nb_c, tables.E, tables.z,
                    total.shape[-1])
            if hook == "rounds_step":
                nbytes, ops = perf.decode_rounds_work(
                    *dims, total.dtype, c2v.dtype, rule)
            else:
                nbytes, ops = perf.layered_sweeps_work(*dims, c2v.dtype,
                                                       rule)
            ops *= steps
        self.bytes += nbytes
        self.ops += ops

    def bound(self, units):
        """(bound_ms, bound_by) of 1 / ``units`` of the metered work."""
        return perf.bound(self.bytes / units, self.ops / units)


@contextlib.contextmanager
def metered(dec):
    """Count the work of ``dec``'s kernel calls while the block runs."""
    meter = WorkMeter()
    saved = {h: getattr(dec, h) for h in HOOKS if hasattr(dec, h)}
    for hook, fn in saved.items():
        setattr(dec, hook, meter.wrap(hook, fn))
    try:
        yield meter
    finally:
        for hook, fn in saved.items():
            setattr(dec, hook, fn)


def plain_twin(dec):
    """A copy of ``dec`` that runs every kernel hook's plain version."""
    twin = copy.copy(dec)
    for hook in PLAIN_HOOKS:
        if hasattr(twin, hook):
            setattr(twin, hook, getattr(K, getattr(twin, hook).__name__
                                        + "_ref"))
    return twin


def kernel_of(dec):
    """The kernel ``dec``'s decode launches, or None (a plain loop)."""
    if isinstance(dec, Decoder):
        return "bp_check_phase_generic"
    if dec.schedule == "layered":
        return "bp_layered_sweeps_qc" if dec.resident else None
    return "bp_decode_rounds_qc" if dec.resident else "bp_check_phase_qc"


def launch_counts():
    return {name: getattr(K, name).launches for name in KERNELS}


def syndrome_fn(dec):
    return getattr(dec, "syndrome_from_bits", None) \
        or dec.graph.syndrome_from_bits


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev):
    """{"platform", "name", "power_limit", "count"} of the run's device;
    on the card, the name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return {"platform": "cpu", "name": platform.processor() or "cpu",
                "power_limit": None, "count": 1}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    limit = smi[dev.index or 0].rsplit(",", 1)[1].strip()
    return {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
            "power_limit": limit, "count": 1}


class Bench:
    """The bench's rows on one device; ``run()`` returns the JSON object."""

    def __init__(self, settings: Settings, device: torch.device, seed: int,
                 rows):
        self.s = settings
        self.dev = device
        self.seed = int(seed)
        self.rows = rows
        self.out = {}
        self.pa = PAMAlphabet(settings.bps, 2.0)
        self.kw = ({"nmconfig": np.zeros(self.pa.order, np.uint8)}
                   if settings.mode == "softening" else {})

    # ------------------------------------------------------------ helpers

    def qc(self, base, z, **kw):
        return QCDecoder(base, z, self.s.dtype, device=self.dev, **kw)

    def engine(self, dec, mat):
        return ReconciliationEngine(dec, mat, self.pa, batch=self.s.batch,
                                    dtype=self.s.dtype,
                                    llr_mode=self.s.llr_mode,
                                    rounds_per_dispatch=self.s.rpd)

    def time_ms(self, fn, reps):
        """Median ms of ``reps`` calls of ``fn``: CUDA events on the card,
        the host clock on the CPU."""
        if self.dev.type == "cuda":
            ms, = events_ms(fn, reps=reps, warmup=0)
            return ms
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def require_launch(self, dec, before, label):
        """The launches of each kernel since ``before``; on the card, the
        row's kernel must be among them."""
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in KERNELS
                    if after[k] != before[k]}
        kernel = kernel_of(dec)
        if self.dev.type == "cuda" and kernel and not launches.get(kernel):
            raise BenchError(f"{label}: {kernel} was not launched")
        return launches

    def check_plain(self, dec, lappr, synd, maxiter, label):
        """Decode (lappr, synd) through ``dec`` and through its plain
        version; (success, iters, hard decisions) must be equal."""
        got = dec.decode_batched(lappr, synd, maxiter)
        want = plain_twin(dec).decode_batched(lappr, synd, maxiter)
        same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2] < 0, want[2] < 0))
        if not same:
            raise BenchError(f"{label}: the decoder and its plain version "
                             f"differ on (success, iters, hard decisions)")
        return True

    def tpu_note(self, key, fer, iters):
        ref = JAX_TPU.get(key)
        if ref is None:
            return ""
        it = "" if ref[1] is None else f", mean iters {ref[1]}"
        return (f"; port fer {fer:.4f} mean iters {iters:.2f} beside "
                f"BENCH_r05.json fer {ref[0]}{it} (JAX, TPU)")

    # ------------------------------------------------------------ probes

    def probe(self, dec, label):
        """ms per BP iteration of ``dec`` on 3-sigma LLRs and a random
        syndrome (every frame runs every iteration)."""
        s, dev = self.s, self.dev
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        lappr = (3.0 * torch.randn((dec.vnum, s.batch), generator=gen,
                                   device=dev)).to(dec.dtype)
        synd = torch.randint(0, 2, (dec.cnum, s.batch), generator=gen,
                             device=dev, dtype=torch.int32)
        iters = max(s.probe_iters, s.maxiter)
        with metered(dec) as meter:
            sync(dev)
            t0 = time.perf_counter()
            dec.decode_batched(lappr, synd, iters)
            sync(dev)
            first_s = time.perf_counter() - t0
        before = launch_counts()
        ms = self.time_ms(lambda: dec.decode_batched(lappr, synd, iters),
                          s.probe_reps)
        launches = self.require_launch(dec, before, label)
        ms_iter = ms / iters
        bound_ms, bound_by = meter.bound(iters)
        row = {
            "decode_ms_per_iter": ms_iter,
            "decode_frames_per_s": s.batch / (ms_iter * s.maxiter) * 1e3,
            "probe_iters": iters, "probe_reps": s.probe_reps,
            "first_call_s": first_s, "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_fraction": bound_ms / ms_iter,
            "launches": launches,
            "plain_equal": self.check_plain(dec, lappr, synd, iters, label),
        }
        log(f"{label}: {ms_iter:.4f} ms/iter (first call {first_s:.1f} s), "
            f"bound {bound_ms:.4f} ms by {bound_by} "
            f"({100 * row['roofline_fraction']:.1f}%), launches {launches}, "
            f"plain version equal")
        return row

    # ------------------------------------------------------------ points

    def first_batch(self, eng, snr, seed):
        """The LLRs and syndrome of round 0 of a ``run_point`` seeded
        ``seed``, as the engine draws them."""
        nm = eng.mode_noisemapper(self.s.mode, snr, self.kw.get("nmconfig"))
        sigma = math.sqrt(eng.noise_var(snr))
        x, y = eng._sample_sb(round_generator(seed, 0, eng.device), sigma)
        lappr, word = eng.round_inputs(self.s.mode, nm, x, y, sigma, 1.0)
        return lappr, syndrome_fn(eng.dec)(word.to(torch.int32))

    def warm(self, eng, snr, label):
        t0 = time.perf_counter()
        eng.run_point(self.s.mode, snr, self.s.maxiter, self.s.batch,
                      10 ** 9, seed=self.seed, **self.kw)
        log(f"{label} warm-up round: {time.perf_counter() - t0:.1f} s")

    def point(self, eng, snr, seed0, reps, label, key=None):
        """``reps`` timed ``run_point``s of BENCH_ROUNDS rounds at ``snr``
        (seeds ``seed0 + 10 r``), the first round re-decoded through the
        plain version."""
        s, dec = self.s, eng.dec
        frames = s.rounds * s.batch
        res = []
        before = launch_counts()
        with metered(dec) as meter:
            for r in range(reps):
                p = eng.run_point(s.mode, snr, s.maxiter, frames, 10 ** 9,
                                  seed=seed0 + 10 * r, **self.kw)
                if p.frames != frames:
                    raise BenchError(f"{label}: {p.frames} frames counted, "
                                     f"{frames} asked for")
                res.append(p)
        launches = self.require_launch(dec, before, label)
        fps = [p.frames_per_s for p in res]
        round_ms = 1e3 * s.batch / statistics.median(fps)
        bound_ms, bound_by = meter.bound(reps * s.rounds)
        lappr, synd = self.first_batch(eng, snr, seed0)
        row = {
            "snr_dB": snr,
            "ber": statistics.fmean(p.ber for p in res),
            "fer": statistics.fmean(p.fer for p in res),
            "mean_iters": statistics.fmean(p.iters for p in res),
            "frames_per_s": statistics.median(fps), "reps": reps,
            "rep_frames_per_s": fps, "frames_per_rep": frames,
            "round_ms": round_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_fraction": bound_ms / round_ms,
            "launches": launches,
            "plain_equal": self.check_plain(dec, lappr, synd, s.maxiter,
                                            label),
        }
        log(f"{label} @ {snr} dB: {statistics.median(fps):.1f} frames/s "
            f"(reps {[round(f, 1) for f in fps]}), fer {row['fer']:.4f}, "
            f"mean iters {row['mean_iters']:.2f}, round {round_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}, launches {launches}, "
            f"plain version equal"
            + self.tpu_note(key or label, row["fer"], row["mean_iters"]))
        return row

    # ------------------------------------------------------------ rows

    def want(self, row):
        return row in self.rows

    def run(self):
        s, dev = self.s, self.dev
        log(f"device {dev}, dtype {s.dtype}, qc {s.use_qc}, bps {s.bps}, "
            f"mode {s.mode}, seed {self.seed}, rows {','.join(self.rows)}")
        build_s = None
        if dev.type == "cuda":
            t0 = time.perf_counter()
            libs = cuda_build.build_all()
            build_s = time.perf_counter() - t0
            log(f"kernels built and loaded in {build_s:.1f} s: "
                f"{', '.join(lib.name for lib in libs)}")
        self.setup_headline()
        if not s.skip_decode:
            self.decode_rows()
        value = self.headline_rows()
        self.secondary_rows()
        if self.want("generic"):
            self.generic_row()
        baseline = self.baseline_row() if self.want("vs_baseline") else None
        return {
            "metric": f"{s.mode}_decoded_frames_per_s",
            "value": value, "unit": "frames/s",
            "vs_baseline": (value / baseline if value and baseline
                            else None),
            **self.out,
            "device": device_info(dev), "build_s": build_s,
            "seed": self.seed, "rows": list(self.rows),
        }

    def resident_for(self, rule):
        """BENCH_RESIDENT, or auto: resident for flooding sum-product, and
        for flooding min-sum at 90 or more variable blocks (the JAX bench's
        choice without its TPU memory test)."""
        s = self.s
        if s.resident is not None:
            return s.resident and s.schedule == "flooding"
        if s.schedule != "flooding":
            return False
        return rule == "sumproduct" or s.nbv >= 90

    def setup_headline(self):
        s = self.s
        if s.use_qc:
            self.z = s.n // s.nbv
            self.base, vid, cid = make_qc_ldpc(s.nbv, self.z, 3, 6,
                                               seed=12345)
            self.resident = self.resident_for(s.check)
            self.dec = self.qc(self.base, self.z, check_rule=s.check,
                               schedule=s.schedule, resident=self.resident,
                               resident_chunk=s.resident_chunk,
                               totals_dtype=s.totals)
            code = f"qc(3,6) z={self.z} N={self.dec.vnum}"
        else:
            vid, cid = make_regular_ldpc(s.n, dv=3, dc=6, seed=12345)
            self.resident = False
            self.dec = Decoder(vid, cid, s.dtype, device=self.dev,
                               check_rule=s.check)
            code = f"regular(3,6) N={self.dec.vnum}"
        self.vid, self.cid = vid, cid
        self.mat = Matrix(vid, cid)
        self.eng = self.engine(self.dec, self.mat)
        self.out.update({
            "code": code, "dtype": s.dtype, "bps": s.bps, "mode": s.mode,
            "batch": s.batch, "maxiter": s.maxiter, "llr_mode": s.llr_mode,
            "rounds_per_dispatch": s.rpd, "check_rule": s.check,
            "schedule": s.schedule, "resident": bool(self.resident),
        })

    def phi_of(self, dec):
        if dec.check_rule != "sumproduct":
            return None
        if isinstance(dec, QCDecoder) and dec.resident:
            return dec._resident_phi_resolved
        return dec.check_phi

    def decode_rows(self):
        s, flooding = self.s, self.s.schedule == "flooding"
        if self.want("decode"):
            row = self.probe(self.dec, "decode probe")
            self.out.update(row)
            self.out["phi_impl"] = self.phi_of(self.dec)
            if self.resident:
                self.out["resident_chunk"] = self.dec.resident_chunk
        if not (s.use_qc and flooding):
            return
        if self.want("irregular_qc"):
            base, _, _ = make_qc_ira(nb_info=s.nbv // 2, nb_acc=s.nbv // 2,
                                     z=self.z, dv=3, seed=12345)
            res = s.irregular_resident and self.resident
            dec = self.qc(base, self.z, check_rule=s.check, resident=res,
                          resident_chunk=s.resident_chunk,
                          totals_dtype=s.totals)
            dcs = sorted(set(dec.row_degrees))
            self.out["irregular_qc"] = {
                "code": f"qc-ira dv=3 dc={dcs} z={self.z} N={dec.vnum}",
                **self.probe(dec, "irregular-QC probe"), "resident": res}
        if (self.want("true_shape_qc") and self.resident
                and s.n % 180 == 0 and s.nbv != 180 and s.true_shape):
            tz = s.n // 180
            base, _, _ = make_qc_ira(nb_info=90, nb_acc=90, z=tz, dv=3,
                                     seed=12345)
            dec = self.qc(base, tz, check_rule=s.check, resident=True,
                          resident_chunk=s.resident_chunk,
                          totals_dtype=s.totals)
            self.out["true_shape_qc"] = {
                "code": f"qc-ira dv=3 z={tz} N={dec.vnum} (DVB-S2 lifting "
                        f"shape)",
                **self.probe(dec, "true-shape probe"), "resident": True}
        if (self.want("rate34_qc") and s.nbv % 4 == 0 and s.nbv >= 8
                and s.rate34):
            base, _, _ = make_qc_ira(nb_info=3 * s.nbv // 4,
                                     nb_acc=s.nbv // 4, z=self.z, dv=3,
                                     seed=12345)
            res = self.resident and s.rate34_resident
            dec = self.qc(base, self.z, check_rule=s.check, resident=res,
                          resident_chunk=s.resident_chunk,
                          totals_dtype=s.totals)
            dcs = sorted(set(dec.row_degrees))
            self.out["rate34_qc"] = {
                "code": f"qc-ira rate-3/4 dv=3 dc={dcs[0]}..{dcs[-1]} "
                        f"z={self.z} N={dec.vnum}",
                **self.probe(dec, "rate-3/4 probe"), "resident": res}

    def llr_build_s(self):
        """Host seconds of the headline point's NoiseMapper and its LLR fit
        (or table)."""
        s = self.s
        sync(self.dev)
        t0 = time.perf_counter()
        nm = NoiseMapper(self.pa, self.eng.noise_var(s.snr),
                         self.kw["nmconfig"], dtype=s.dtype, device=self.dev)
        if s.llr_mode == "table":
            nm._ensure_llr_tab()
        else:
            nm._ensure_llr_poly()
        sync(self.dev)
        return time.perf_counter() - t0

    def headline_rows(self):
        s = self.s
        if not (self.want("headline") or self.want("waterfall")):
            return None
        if s.mode == "softening":
            self.out["llr_build_s"] = self.llr_build_s()
            log(f"host LLR {s.llr_mode} build (M={self.pa.order}): "
                f"{self.out['llr_build_s']:.2f} s")
        self.warm(self.eng, s.snr, "headline")
        value = None
        if self.want("headline"):
            row = self.point(self.eng, s.snr, self.seed + 1,
                             s.headline_reps, "headline")
            value = row["frames_per_s"]
            pre, dcd, read, its = round_breakdown(
                self.dec, self.mat, s.snr, mode=s.mode, batch=s.batch,
                dtype=s.dtype, nmconfig=self.kw.get("nmconfig"),
                maxiter=s.maxiter, seed=self.seed + 21, bps=s.bps,
                llr_mode=s.llr_mode)
            log(f"headline round breakdown (untraced, median of 4): "
                f"preamble {pre:.3f} ms, decode+count {dcd:.3f} ms, host "
                f"read {read:.3f} ms, iterations {its}")
            self.out.update({
                "snr_dB": s.snr, "fer": row["fer"],
                "mean_iters": row["mean_iters"],
                "headline_reps": s.headline_reps,
                "rep_frames_per_s": row["rep_frames_per_s"],
                "headline_round": {
                    k: row[k] for k in ("ber", "frames_per_rep", "round_ms",
                                        "bound_ms", "bound_by",
                                        "roofline_fraction", "launches",
                                        "plain_equal")},
                "round_breakdown": {"preamble_ms": pre, "decode_ms": dcd,
                                    "read_ms": read, "iterations": its},
            })
        if self.want("waterfall") and not s.skip_waterfall:
            self.out["waterfall"] = self.point(
                self.eng, s.snr2, self.seed + 2, MIN_REPS, "waterfall")
        return value

    def two_points(self, dec, name):
        """The JAX bench's secondary block: a warm-up round, the headline
        point and (unless skipped) the waterfall point."""
        s = self.s
        eng = self.engine(dec, self.mat)
        self.warm(eng, s.snr, name)
        row = self.point(eng, s.snr, self.seed + 1, MIN_REPS, name)
        if not s.skip_waterfall:
            row["waterfall"] = self.point(eng, s.snr2, self.seed + 2,
                                          MIN_REPS, f"{name} waterfall")
        return row

    def secondary_rows(self):
        s = self.s
        softening = s.mode == "softening"
        if (self.want("minsum") and s.check2 not in ("none", s.check)
                and softening):
            if s.use_qc:
                dec = self.qc(self.base, self.z, check_rule=s.check2,
                              resident=self.resident_for(s.check2))
            else:
                dec = Decoder(self.vid, self.cid, s.dtype, device=self.dev,
                              check_rule=s.check2)
            self.out[s.check2] = self.two_points(dec, s.check2)
            self.out[s.check2]["resident"] = bool(getattr(dec, "resident",
                                                          False))
        if (self.want("sumproduct_tanhfb_dense") and s.tanhfb and s.use_qc
                and softening and s.check == "sumproduct"):
            dec = self.qc(self.base, self.z, check_rule="sumproduct",
                          check_phi="tanhfb")
            self.out["sumproduct_tanhfb_dense"] = self.two_points(
                dec, "sumproduct_tanhfb_dense")
        if (self.want("layered") and s.sched2 not in ("none", s.schedule)
                and s.use_qc and softening and not s.skip_waterfall):
            res = s.layered_resident and s.sched2 == "layered"
            dec = self.qc(self.base, self.z, check_rule="minsum",
                          schedule=s.sched2, resident=res)
            eng = self.engine(dec, self.mat)
            self.warm(eng, s.snr2, s.sched2)
            self.out[s.sched2] = {
                "check_rule": "minsum", "resident": res,
                **self.point(eng, s.snr2, self.seed + 2, MIN_REPS,
                             s.sched2)}
        if self.want("streaming") and s.stream and s.use_qc and softening:
            self.streaming_row()
        if self.want("mc_mi") and s.mi and softening:
            self.mc_mi_row()

    def streaming_row(self):
        from .sims.streaming import StreamReconciler

        s, dev = self.s, self.dev
        sb = min(s.batch, 64)
        engine = s.stream_decode
        if engine == "auto":
            engine = "resident" if self.dec.nb_c >= 32 else "dense"
        if engine == "resident":
            sdec = self.qc(self.base, self.z, check_rule="minsum",
                           resident=True, resident_chunk=s.stream_chunk)
        elif engine == "layered":
            sdec = self.qc(self.base, self.z, check_rule="minsum",
                           schedule="layered", resident=True)
        else:
            sdec = self.qc(self.base, self.z, check_rule="minsum")
        n0 = self.pa.variance * 10.0 ** (-s.snr2 / 10.0) / 2.0
        snm = NoiseMapper(self.pa, n0, dtype=s.dtype, device=dev)
        n_symb = self.eng.N_symb
        rng = np.random.default_rng(self.seed + 3)
        frames = 4 * sb
        sx = rng.choice(self.pa.order, size=frames * n_symb,
                        p=np.asarray(self.pa.probabilities))
        sy = np.asarray(self.pa.constellation)[sx] \
            + math.sqrt(n0) * rng.standard_normal(sx.size)
        need = sb * n_symb

        def reconciler(dec):
            return StreamReconciler(dec, self.mat, self.pa, snm, batch=sb)

        t0 = time.perf_counter()
        reconciler(sdec).stream_fused(sy[:need], sx[:need], s.maxiter)
        log(f"stream_fused warm-up ({engine}): "
            f"{time.perf_counter() - t0:.1f} s")
        chunk = int(2.33 * n_symb)
        ycks = [sy[a:a + chunk] for a in range(0, sx.size, chunk)]
        xcks = [sx[a:a + chunk] for a in range(0, sx.size, chunk)]
        els = []
        before = launch_counts()
        with metered(sdec) as meter:
            for _ in range(s.stream_reps):
                sr = reconciler(sdec)
                sync(dev)
                t0 = time.perf_counter()
                res = sr.stream_fused(ycks, xcks, s.maxiter)
                sync(dev)
                els.append(time.perf_counter() - t0)
                if res.frames != frames:
                    raise BenchError(f"streaming: {res.frames} frames "
                                     f"reconciled, {frames} streamed")
        launches = self.require_launch(sdec, before, "streaming")
        stream_ms = 1e3 * statistics.median(els)
        bound_ms, bound_by = meter.bound(s.stream_reps)
        # the first batch through the decoder and its plain version
        got, want = (reconciler(d).stream_fused(sy[:need], sx[:need],
                                                s.maxiter)
                     for d in (sdec, plain_twin(sdec)))
        if not (got.success == want.success
                and got.iterations == want.iterations
                and all(np.array_equal(a, b) for a, b in
                        zip(got.decoded_words, want.decoded_words))):
            raise BenchError("streaming: the decoder and its plain version "
                             "differ on the first batch")
        rates = [sx.size / e for e in els]
        self.out["streaming"] = {
            "driver": "stream_fused", "decode": engine, "frames": res.frames,
            "batch": sb, "chunk_frames": 2.33, "snr_dB": s.snr2,
            "fer": res.fer, "symbols_per_s": statistics.median(rates),
            "reps": s.stream_reps, "rep_symbols_per_s": rates,
            "stream_ms": stream_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "roofline_fraction": bound_ms / stream_ms,
            "launches": launches, "plain_equal": True,
        }
        log(f"stream_fused[{engine}]: {sx.size} symbols, "
            f"{statistics.median(rates):.0f} symbols/s (reps "
            f"{[round(r) for r in rates]}), bound {bound_ms:.3f} ms by "
            f"{bound_by} of {stream_ms:.2f} ms, launches {launches}, plain "
            f"version equal on the first batch"
            + self.tpu_note("streaming", res.fer, 0.0))

    def mc_mi_row(self):
        from .models import mutual_information as mi

        s, dev = self.s, self.dev
        nm = NoiseMapper(self.pa, self.pa.variance * 10.0 ** (-8.0 / 10.0)
                         / 2.0, dtype="float32", device=dev)
        nm._ensure_ginv_poly()
        p = mi.P_xhat(nm)
        quad = (-mi.mutual_information_X_Xhat(nm, p),
                -mi.mutual_information_X_Y(nm),
                mi.mutual_information_base_scheme(nm, p))
        gen = torch.Generator(device=dev).manual_seed(self.seed + 11)
        t0 = time.perf_counter()
        mi.montecarlo_information(gen, self.pa, nm, p, s.mi_n,
                                  ginv_mode="poly")
        log(f"MC-MI first call: {time.perf_counter() - t0:.2f} s")
        times, ests = [], []
        for _ in range(MIN_REPS):
            sync(dev)
            t0 = time.perf_counter()
            ests.append(mi.montecarlo_information(gen, self.pa, nm, p,
                                                  s.mi_n, ginv_mode="poly"))
            times.append(time.perf_counter() - t0)
        # standard errors of the three estimators from one more draw
        xy = mi._draw(gen, self.pa, nm, (1, s.mi_n))
        p_rows = torch.as_tensor(p, dtype=torch.float32, device=dev)[None]
        terms = mi._mc_terms(self.pa, nm, p_rows, *xy, (True,) * 3, "poly")
        se = [float(t.double().std()) / math.sqrt(s.mi_n) for t in terms]
        for est in ests:
            for e, name in enumerate(("I(X;Xhat)", "I(X;Y)",
                                      "I(X,N;Xhat)")):
                if abs(est[e] - quad[e]) > 4 * se[e]:
                    raise BenchError(
                        f"mc_mi: {name} {est[e]} beyond 4 standard errors "
                        f"({4 * se[e]}) of the quadrature {quad[e]}")
        rates = [s.mi_n / t for t in times]
        self.out["mc_mi"] = {
            "n": s.mi_n, "snr_dB": 8.0, "ginv": "poly",
            "samples_per_s": statistics.median(rates), "reps": MIN_REPS,
            "rep_samples_per_s": rates, "estimates": list(ests[-1]),
            "quadrature": list(quad), "standard_errors": se,
        }
        log(f"MC-MI: {statistics.median(rates):.0f} samples/s (reps "
            f"{[round(r) for r in rates]}), estimates within 4 standard "
            f"errors of the quadrature {[round(q, 6) for q in quad]}")

    def generic_row(self):
        """The generic decoder (kernel 4) at the headline's dtype and rule:
        the exact DVB-S2 rate-1/2 H at N = 64800, else the JAX bench's
        regular (3,6) code of length BENCH_N."""
        s = self.s
        if s.n == 64800:
            from .models.dvbs2 import expanded_edges, make_table

            vid, cid = expanded_edges(make_table("1/2", seed=0))
            code = "DVB-S2 rate-1/2 H (exact structure) N=64800"
        else:
            vid, cid = make_regular_ldpc(s.n, dv=3, dc=6, seed=12345)
            code = f"regular(3,6) N={s.n}"
        phi = self.phi_of(self.dec) or "phi"
        dec = Decoder(vid, cid, s.dtype, device=self.dev, check_rule=s.check,
                      check_phi=phi)
        eng = self.engine(dec, Matrix(vid, cid))
        self.warm(eng, s.snr, "generic")
        self.out["generic"] = {
            "code": code, "check_rule": s.check, "check_phi": phi,
            **self.point(eng, s.snr, self.seed + 1, MIN_REPS, "generic")}

    def baseline_row(self):
        """frames/s of the C++ scalar decoder on one host core."""
        from ._graphcore import ScalarDecoder
        from .utils.reference_np import softening_frames_np

        s = self.s
        nm64 = NoiseMapper(self.pa, self.eng.noise_var(s.snr),
                           dtype=torch.float64, device="cpu")
        n_base = min(s.batch, 32)
        lappr, words = softening_frames_np(nm64, self.pa, n_base,
                                           self.eng.N_symb,
                                           seed=self.seed + 999)
        sd = ScalarDecoder(self.vid, self.cid)
        synd = np.stack([sd.eval_syndrome(w) for w in words])
        done = 0
        t0 = time.perf_counter()
        for f in range(n_base):
            sd.decode(lappr[f], synd[f], s.maxiter)
            done += 1
            if (time.perf_counter() - t0 > s.baseline_s
                    and done >= BASELINE_MIN_FRAMES):
                break
        el = time.perf_counter() - t0
        fps = done / el
        self.out["baseline"] = {"decoder": "graphcore ScalarDecoder, one "
                                "host core", "frames": done, "seconds": el,
                                "frames_per_s": fps}
        log(f"baseline (one-core scalar C++): {done} frames in {el:.2f} s "
            f"-> {fps:.3f} frames/s")
        return fps


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Headline bench of the port (one JSON line on stdout).")
    p.add_argument("--device", default="cuda",
                   help="cuda (default, the card) or cpu (a smoke run of "
                        "the plain versions)")
    p.add_argument("--seed", type=int, default=0,
                   help="the workloads' base seed (default 0)")
    p.add_argument("--rows", default=",".join(ROWS),
                   help=f"comma-separated rows to run (default all: "
                        f"{','.join(ROWS)})")
    args = p.parse_args(argv)
    rows = [r for r in args.rows.split(",") if r]
    unknown = sorted(set(rows) - set(ROWS))
    if unknown:
        p.error(f"unknown rows {unknown}; choose from {','.join(ROWS)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: CUDA is not available; run on an NVIDIA GPU or pass "
              "--device cpu", file=sys.stderr)
        return 2
    if device.type not in ("cuda", "cpu"):
        p.error(f"unsupported device {args.device!r}")
    settings = Settings.from_env(os.environ)
    t0 = time.perf_counter()
    result = Bench(settings, device, args.seed,
                   [r for r in ROWS if r in rows]).run()
    log(f"bench: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
