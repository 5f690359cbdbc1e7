"""Run one cell of ``BENCHMARK.json`` on the port and print one JSON line.

    python3 -m rrbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The program under test is ``qamreconciliation_tpu_torch`` (the PyTorch and
CUDA port) from the checkout this runs in; nothing here loads the JAX
package.  A cell is a configuration (``rrbench/configs/``: the code, the
decoder, the alphabet, batch, dispatch and precision) under a traffic mix
(``rrbench/traffic/``: a sweep point's mode, Es/N0 and frame budget).

Set-up (``setup_s``, from the start of this process to the first timed
point): the code's edge lists (``rrbench/codes/``), the program's decoder
and ``ReconciliationEngine``, and one warm point of one dispatch at the
cell's shapes, which builds or loads the cell's kernels
(``qamreconciliation_tpu_torch/csrc/_build/`` inside the checkout).

Window: ``run_point`` sweep points, one after another (a closed loop), each
on a seed of its own drawn from ``--seed``; a point that starts before
``--seconds`` is up runs to its end.  ``frames_per_s`` is every frame of
the window's points over the window's wall time (host clock, from the
first point's start to the last point's end, which ends in the host read
of its counters).  With ``--trace 1`` the points of the window's first
``TRACE_MIN_S`` seconds run once untraced before the window, then in it
under a trace of the device's activity alone, and as many more points
under a trace of the host's operations and the benchmark's ``rr.*``
spans; the per-layer metrics are read from the two
(``rrbench/tracing.py``, ``rrbench/metrics/``).

Check (after the window, once the device's peak memory is read and the
program is freed): ``CHECK_ROUNDS`` rounds of the window, drawn from the
seed, whose LLRs, word, syndrome, decode (success, iterations, hard
decisions) and counters the run kept as the program produced them, are
worked out again by the plain reference (``rrbench/ref/``,
``rrbench/decoders/``, ``rrbench/modes/``) from the same seeds and codes,
and compared exactly; every point's reported totals must add up to its
rounds' counters over its whole frame budget.  Each number compared is
printed beside its limit as the last lines on stderr and under ``checks``,
the last key of the result.

Without a CUDA device (or with fewer than the cell asks for), in a
checkout without the program, or with the JAX package, ``jax``, ``jaxlib``
or ``flax`` loaded once the window has closed, the run exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import codes, decoders, modes, spec, tracing  # noqa: E402
from .ref import Precision, counters  # noqa: E402
from .ref.channel import Pam, Sampler, round_generator  # noqa: E402
from .ref.mapper import Mapper  # noqa: E402
from .traffic import ALPHA, Mix  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "qamreconciliation_tpu_torch"
# top-level module names that may not be loaded in the process that prints
# the result, and module names that may not be loaded at all
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "qamreconciliation_tpu")
FORBIDDEN_FULL = ("qamreconciliation_tpu_torch.bench", "bench")
CHECK_ROUNDS = 8        # rounds of the window the reference works out again
TRACE_MIN_S = 1.0       # the traced points last at least this long


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules():
    """Loaded modules the run may not hold, by whole top-level name (so
    ``qamreconciliation_tpu_torch`` is not ``qamreconciliation_tpu``) and
    by full name."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_TOP
                  or m in FORBIDDEN_FULL)


# --------------------------------------------------------------------- #
# The system under test


class Program:
    """The port as the configuration runs it: its decoder, its engine
    (``sims/engine.ReconciliationEngine``) and a sweep point."""

    def __init__(self, config, code, mix, device):
        from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
        from qamreconciliation_tpu_torch.models.matrix import Matrix
        from qamreconciliation_tpu_torch.sims.engine import (
            ReconciliationEngine)

        dspec = config["decoder"]
        self.dec = decoders.load(dspec["kind"]).program(
            code, dspec, config["dtype"], device)
        pam = config["pam"]
        self.eng = ReconciliationEngine(
            self.dec, Matrix(code.vid, code.cid),
            PAMAlphabet(pam["bits_per_symbol"], pam["step"]),
            batch=config["batch"], dtype=config["dtype"],
            llr_mode=config["llr_mode"], fy_mode=config["fy_mode"],
            rounds_per_dispatch=config["rounds_per_dispatch"])
        self.mode = modes.load(mix.mode)
        self.nmconfig = (np.asarray(config["nmconfig"], np.uint8)
                         if self.mode.TAKES_NMCONFIG else None)
        self.maxiter = int(config["max_iterations"])
        self.mix = mix

    def point(self, seed, frames=None):
        mix = self.mix
        return self.eng.run_point(
            self.mode.PROGRAM_MODE, mix.snr_dB, self.maxiter,
            frames or mix.frames, mix.ferr_count_min, alpha=ALPHA,
            nmconfig=self.nmconfig, seed=seed)


class HookError(RuntimeError):
    """A hook of the benchmark's on the program is missing or is not
    called as the warm point says it has to be."""


class Recorder:
    """The benchmark's hooks on the program's objects (instance
    attributes; the program's code is unchanged).

    Always: each window round's counters as the engine's public ``round``
    returns them, and for the sampled rounds the program's own LLRs and
    word (its public ``round_inputs``) and its syndrome and decode (the
    decoder's decode function, ``_build_decode()``, built once a round),
    copied where they are produced; the point's set-up
    (``mode_noisemapper``) on the host clock.  With ``trace``, also the
    decoder's kernel hook, and while the traced points run, ``rr.*``
    profiler ranges around each round (``rr.round``), its decode
    (``rr.decode``), the kernel hook's calls (``rr.k.<hook>``) and the
    point's set-up (``rr.point_setup``), with the decoder's iteration
    counter and the kernel calls over them.

    :meth:`verify` holds the hooks to the warm point: each has to be
    there and be called once a round (the set-up once a point, the kernel
    hook at least once a round), so that a program whose structure no
    longer matches them stops the run at set-up instead of moving work
    between spans or leaving rounds unchecked."""

    def __init__(self, program, decoder_module, trace: bool):
        self.eng, self.dec = program.eng, program.dec
        self.module = decoder_module
        self.trace = trace
        self.active = False
        self.profiling = False
        self.calls_of = defaultdict(int)
        self.reset()
        self._install()

    def reset(self):
        self.point_rounds = []
        self.captures = {}
        self.counters = defaultdict(int)
        self.calls = []
        self.host = defaultdict(list)
        self._slot = None
        self._want = None
        self._point = None
        self._cap = None

    def begin_point(self, i, want_round, slot):
        self.point_rounds.append([])
        self._point, self._want, self._slot = i, want_round, slot

    def _span(self, name):
        if self.profiling:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _hooked(self, obj, attr):
        fn = getattr(obj, attr, None)
        if not callable(fn):
            raise HookError(f"{type(obj).__name__}.{attr} is gone: the "
                            f"benchmark's hook has nothing to wrap")
        return fn

    def _install(self):
        eng, dec = self.eng, self.dec
        calls = self.calls_of
        round_fn = self._hooked(eng, "round")

        def round_(*args, **kw):
            calls["round"] += 1
            rounds = self.point_rounds[-1] if self.active else None
            sampled = (rounds is not None and self._slot is not None
                       and len(rounds) == self._want)
            self._cap = {} if sampled else None
            with self._span("rr.round"):
                out = round_fn(*args, **kw)
            if rounds is not None:
                rounds.append(out)
            if sampled:
                cap, self._cap = self._cap, None
                missing = {"lappr", "synd"} - set(cap)
                if missing:
                    raise HookError(f"the sampled round left no "
                                    f"{sorted(missing)}: a hook was not "
                                    f"called in it")
                self.captures[self._slot] = dict(
                    cap, point=self._point, round=self._want,
                    counters=out.clone())
            return out

        eng.round = round_
        inputs = self._hooked(eng, "round_inputs")

        def round_inputs(*args, **kw):
            calls["round_inputs"] += 1
            lappr, word = inputs(*args, **kw)
            if self._cap is not None:
                self._cap.update(lappr=lappr.clone(),
                                 word=word.to(torch.uint8))
            return lappr, word

        eng.round_inputs = round_inputs
        build = self._hooked(dec, "_build_decode")

        def build_decode():
            fn = build()

            def decode(prior, synd, max_iterations):
                calls["decode"] += 1
                it0 = dec.iterations_run
                with self._span("rr.decode"):
                    out = fn(prior, synd, max_iterations)
                if self.profiling:
                    self.counters["decode_iterations"] += (
                        dec.iterations_run - it0)
                    self.counters["decodes"] += 1
                if self._cap is not None:
                    self._cap.update(synd=synd.to(torch.uint8),
                                     success=out[0].clone(),
                                     iters=out[1].clone(), hard=out[2] < 0)
                return out
            return decode

        dec._build_decode = build_decode
        mapper = self._hooked(eng, "mode_noisemapper")

        def mode_noisemapper(*args, **kw):
            calls["point_setup"] += 1
            t = time.perf_counter()
            with self._span("rr.point_setup"):
                out = mapper(*args, **kw)
            if self.active:
                self.host["point_setup"].append(time.perf_counter() - t)
            return out

        eng.mode_noisemapper = mode_noisemapper
        if not self.trace:
            return
        hook = self.module.KERNEL_HOOK
        kernel = self._hooked(dec, hook)

        def call(*args, **kw):
            calls["kernel"] += 1
            pre = self.module.pre_call(args, kw) if self.profiling else None
            with self._span(f"rr.k.{hook}"):
                out = kernel(*args, **kw)
            if self.profiling:
                self.calls.append(self.module.call_record(args, kw, pre))
            return out

        setattr(dec, hook, call)

    def verify(self, rounds: int, points: int = 1):
        """Raise :class:`HookError` unless the hooks were called as a run
        of ``points`` points of ``rounds`` rounds has to call them."""
        want = {"round": rounds, "round_inputs": rounds, "decode": rounds,
                "point_setup": points}
        got = dict(self.calls_of)
        bad = [f"{k}: {got.get(k, 0)} calls, {n} wanted"
               for k, n in want.items() if got.get(k, 0) != n]
        if self.trace and got.get("kernel", 0) < rounds:
            bad.append(f"kernel hook {self.module.KERNEL_HOOK}: "
                       f"{got.get('kernel', 0)} calls, {rounds} at least")
        if bad:
            raise HookError("the program no longer runs as the benchmark's "
                            "hooks expect (" + "; ".join(bad) + ")")


class Session:
    """One cell on one device: the code, the program, the hooks and the
    warm point (the set-up), then windows."""

    def __init__(self, cell, seed, device, trace=False):
        self.cell, self.device = cell, torch.device(device)
        cfg = cell.config
        self.mix = Mix(cell.traffic)
        self.code = codes.build(cfg["code"])
        self.program = Program(cfg, self.code, self.mix, self.device)
        self.recorder = Recorder(self.program,
                                 decoders.load(cfg["decoder"]["kind"]),
                                 trace)
        per_dispatch = cfg["batch"] * cfg["rounds_per_dispatch"]
        self.rounds_per_point = cfg["rounds_per_dispatch"] * math.ceil(
            self.mix.frames / per_dispatch)
        self.program.point(self.mix.warm_seed(seed), frames=per_dispatch)
        sync(self.device)
        self.recorder.verify(cfg["rounds_per_dispatch"])

    def window(self, seed, seconds, profile=False):
        """Points until ``seconds`` have passed (the last one that starts
        runs to its end).  With ``profile``, first the points of at least
        ``TRACE_MIN_S`` seconds run untraced before the window (their
        host-clock seconds); in the window the same points run again under
        the device-only trace (on a card), and as many more under the
        spans' trace.  Returns the window's seconds, the points' seeds
        and results, and the traced run (:class:`tracing.Run`)."""
        rec, mix = self.recorder, self.mix
        rng = mix.sample_rng(seed)
        rec.reset()
        untraced, n = [], 0
        if profile:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < TRACE_MIN_S:
                t = time.perf_counter()
                self.program.point(mix.point_seed(seed, len(untraced)))
                sync(self.device)
                untraced.append(time.perf_counter() - t)
            n = len(untraced)
        on_card = self.device.type == "cuda"
        stretches = {}
        open_ = None
        rec.active = True
        results, seeds, walls = [], [], []
        t0 = time.perf_counter()
        # a traced run's window holds both stretches, however short it is
        while time.perf_counter() - t0 < seconds or len(results) < 2 * n:
            i = len(results)
            want = int(rng.integers(self.rounds_per_point))
            slot = i if i < CHECK_ROUNDS else int(rng.integers(i + 1))
            rec.begin_point(i, want, slot if slot < CHECK_ROUNDS else None)
            if profile and i == 0 and on_card:
                open_ = self._start("device", i)
            elif profile and i == n:
                open_ = self._start("spans", i)
            seeds.append(mix.point_seed(seed, i))
            t = time.perf_counter()
            results.append(self.program.point(seeds[-1]))
            walls.append(time.perf_counter() - t)
            if open_ and i + 1 == open_["first"] + n:
                stretches[open_["kind"]] = self._stop(open_)
                open_ = None
        elapsed = time.perf_counter() - t0
        if open_:
            stretches[open_["kind"]] = self._stop(open_)
        rec.active = False
        run = None
        if profile:
            rec.host["untraced_point"] = untraced
            run = tracing.Run(stretches.get("device"),
                              stretches.get("spans"), rec.counters,
                              rec.calls, rec.host)
        return dict(seconds=elapsed, seeds=seeds, results=results, run=run,
                    walls=walls, point_setup=list(rec.host["point_setup"]))

    def _start(self, kind, first):
        """Start the profiler for the ``device`` stretch (CUDA activity
        alone) or the ``spans`` one (the host's operations, the device's
        and the ``rr.*`` ranges)."""
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if kind == "spans":
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                acts if self.device.type == "cuda" else [])
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        sync(self.device)
        window_range = None
        if kind == "spans":
            window_range = torch.profiler.record_function(tracing.WINDOW)
            window_range.__enter__()
            self.recorder.profiling = True
        return dict(kind=kind, first=first, prof=prof, range=window_range,
                    t0=time.perf_counter())

    def _stop(self, stretch):
        """Stop a stretch's profiler and read its :class:`tracing.Trace`
        at once (the next session clears what the profiler recorded)."""
        sync(self.device)
        seconds = time.perf_counter() - stretch["t0"]
        if stretch["range"] is not None:
            stretch["range"].__exit__(None, None, None)
            self.recorder.profiling = False
            seconds = None      # the rr.window range's
        stretch["prof"].stop()
        return tracing.Trace(tracing.chrome_events(stretch["prof"]),
                             window_s=seconds)

    def release(self):
        """Drop the program and its state; keep what the check reads."""
        kept = (self.recorder.captures, self.recorder.point_rounds)
        self.program = self.recorder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return kept


# --------------------------------------------------------------------- #
# The check


class Checker:
    """The plain reference of a cell's rounds, in precision ``precision``
    (default the configuration's), on ``device``."""

    def __init__(self, cell, code, device, precision=None):
        cfg = cell.config
        if (cfg["llr_mode"], cfg["fy_mode"], cfg["dtype"]) != (
                "poly", "erf", "bfloat16"):
            raise ValueError("the reference has the poly LLRs, the erf "
                             "marginal CDF and bf16 storage only")
        self.device = torch.device(device)
        self.mix = Mix(cell.traffic)
        self.prec = Precision(precision or cfg["dtype"])
        dtype = getattr(torch, cfg["dtype"])
        pam = Pam(cfg["pam"]["bits_per_symbol"], cfg["pam"]["step"])
        nv = pam.noise_var(self.mix.snr_dB)
        self.sigma = math.sqrt(nv)
        self.mapper = Mapper(pam, nv, dtype, self.device)
        self.sampler = Sampler(pam, dtype, self.device)
        self.mode = modes.load(self.mix.mode)
        self.decoder = decoders.load(cfg["decoder"]["kind"]).Reference(
            code, cfg["decoder"], self.prec, self.device)
        self.code = code
        self.shape = (code.vnum // pam.bps, cfg["batch"])
        self.K = code.vnum - code.cnum
        self.maxiter = int(cfg["max_iterations"])

    @torch.no_grad()
    def round(self, point_seed, r):
        """Round ``r`` of the point seeded ``point_seed``: LLRs, word,
        syndrome, decode and counters."""
        x, y = self.sampler.draw(round_generator(point_seed, r, self.device),
                                 self.shape, self.sigma)
        lappr, word = self.mode.inputs(self.mapper, x, y, self.prec.cast)
        synd = decoders.syndrome(self.code, word)
        success, iters, final = self.decoder.decode(lappr, synd,
                                                    self.maxiter)
        return dict(lappr=lappr, word=word.to(torch.uint8),
                    synd=synd.to(torch.uint8), success=success, iters=iters,
                    hard=final < 0,
                    counters=counters(final, word, success, iters, self.K))


def _differ(a, b):
    """Elements of ``a`` and ``b`` that differ: bit patterns where both
    are 2-byte floats, values otherwise; all of the larger where the
    shapes differ."""
    if a.shape != b.shape:
        return torch.ones(max(a.numel(), b.numel()), dtype=torch.bool)
    if a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16):
        return a.view(torch.int16) != b.view(torch.int16)
    if a.is_floating_point() or b.is_floating_point():
        return a.float() != b.float()
    return a != b


def round_diff(got, want):
    """(preamble, decode, counter) differences of one round: LLRs, word
    and syndrome elements; frames whose success, iterations or any hard
    decision differ; counters."""
    g = {k: v.cpu() if torch.is_tensor(v) else v for k, v in got.items()}
    w = {k: v.cpu() for k, v in want.items()}
    pre = sum(int(_differ(g[k], w[k]).sum())
              for k in ("lappr", "word", "synd"))
    if g["hard"].shape == w["hard"].shape:
        bad = int(((g["success"] != w["success"]) | (g["iters"] != w["iters"])
                   | (g["hard"] != w["hard"]).any(0)).sum())
    else:
        bad = max(g["hard"].shape[-1], w["hard"].shape[-1])
    cnt = int(_differ(g["counters"], w["counters"]).sum())
    return pre, bad, cnt


def point_faults(point_rounds, results, frames, batch, K):
    """Points whose reported totals are not the sum of their rounds'
    counters over ``frames`` frames."""
    bad = 0
    for rounds, res in zip(point_rounds, results):
        if not rounds:
            bad += 1
            continue
        errs, ferrs, its, succ = (int(v) for v in
                                  torch.stack(rounds).sum(0).tolist())
        n = len(rounds) * batch
        mean_its = 0.0 if succ == 0 else its / succ
        if (res.frames != frames or n != frames
                or abs(res.fer * n - ferrs) > 1e-6 * max(1, n)
                or abs(res.ber * n * K - errs) > 1e-6 * max(1, n * K)
                or abs(res.iters - mean_its) > 1e-9 * max(1.0, mean_its)):
            bad += 1
    return bad


def check(checker, seeds, captures, point_rounds, results):
    """The numbers compared, each ``{"value", "limit"}``: the differences
    of the captured rounds from ``checker``'s, the points whose totals do
    not add up, and the sampled rounds not captured."""
    pre = dec = cnt = 0
    for cap in captures.values():
        want = checker.round(seeds[cap["point"]], cap["round"])
        p, d, c = round_diff(cap, want)
        pre, dec, cnt = pre + p, dec + d, cnt + c
    cnt += point_faults(point_rounds, results, checker.mix.frames,
                        checker.shape[1], checker.K)
    wanted = min(CHECK_ROUNDS, len(results))
    return {"preamble_diff": {"value": pre, "limit": 0},
            "decode_diff": {"value": dec, "limit": 0},
            "counter_diff": {"value": cnt, "limit": 0},
            "rounds_short": {"value": max(0, wanted - len(captures)),
                             "limit": 0}}


# --------------------------------------------------------------------- #
# A run


def device_record(device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.split("\n")
        rec["power_limit"] = out[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        rec["power_limit"] = None
    return rec


def run_cell(cell, seed, seconds, trace, device, t_start=None):
    """One run of ``cell``: ``(result, checks)``."""
    t_start = _T_START if t_start is None else t_start
    device = torch.device(device)
    chips = int(cell.workload["chips"])
    session = Session(cell, seed, device, trace=trace)
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name}: set-up {setup_s:.2f} s; window of {seconds} s")
    win = session.window(seed, seconds, profile=trace)
    results = win["results"]
    frames = sum(r.frames for r in results)
    attempted = len(results) * session.mix.frames
    log(f"{cell.name}: {len(results)} points, {frames} frames in "
        f"{win['seconds']:.3f} s")
    walls = sorted(win["walls"])
    if len(walls) >= 2:
        q = statistics.quantiles(walls, n=4)
        log(f"{cell.name}: a point's wall s: min {walls[0]:.4f}, quartiles "
            f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, max {walls[-1]:.4f}; "
            f"host set-up of the points {sum(win['point_setup']):.4f} s")
    dev = device_record(device, chips)
    breakdown = None
    if trace:
        traced = win["run"]
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced.device is not None and traced.device.has_device:
            dev.update(busy_s=traced.device.busy_s,
                       window_s=traced.device.window_s)
            log(f"{cell.name}: the device stretch's points "
                f"{traced.device.window_s:.4f} s traced, "
                f"{sum(traced.host['untraced_point']):.4f} s untraced")
        # the device stretch's breakdown, where there is one
        shown = traced.device or traced.spans
        breakdown = shown.breakdown() if shown else None
    else:
        values = {"setup_s": setup_s,
                  "frames_per_s": frames / win["seconds"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    code = session.code
    captures, point_rounds = session.release()
    t = time.perf_counter()
    checks = check(Checker(cell, code, device), win["seeds"], captures,
                   point_rounds, results)
    log(f"{cell.name}: reference check of {len(captures)} rounds in "
        f"{time.perf_counter() - t:.2f} s")
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": attempted, "failed": attempted - frames,
              "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def program_in_checkout() -> bool:
    found = importlib.util.find_spec(PROGRAM)
    return (found is not None and found.origin is not None
            and Path(found.origin).resolve().parent.parent == ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.cell(spec.load_benchmark(ROOT), ROOT, args.workload)
    except (OSError, spec.SpecError) as exc:
        log(f"no such cell: {exc}")
        return 2
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{cell.name} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    if not program_in_checkout():
        log(f"{PROGRAM} is not in this checkout ({ROOT})")
        return 2
    torch.set_num_threads(1)
    try:
        result, checks = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0))
    except HookError as exc:
        log(f"{cell.name}: {exc}")
        return 4
    loaded = forbidden_modules()
    if loaded:
        log(f"forbidden modules loaded: {', '.join(loaded)}")
        return 3
    report(result, checks)
    return 0


def report(result, checks):
    """The checks as the last lines on stderr, the result as the last
    line on stdout."""
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
