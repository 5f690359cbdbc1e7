"""The port's attribution probes (``qamreconciliation_tpu_torch/scripts/
probe_*.py``) against the JAX package's ``scripts/probe_*.py``, on the CPU.

Each JAX probe is loaded by path and run through its ``main`` at n = 2304
(z = 64), B = 8 and 2 iterations, with its closures captured:
``pl.pallas_call`` gets ``interpret=True`` (the built call is kept), the
JAX package's ``bp_check_phase_qc`` is forced to interpret mode,
``jax.lax.fori_loop`` keeps the body it is given (and runs one step of it,
or none), and ``jax.jit`` keeps the function it is given with each call's
arguments and result.  The port's counterpart of each captured body or
stage then runs on the same numpy inputs:

* kernel 6's plain version (``check_math_probe_ref``) against the probe's
  Pallas kernel: ``copy`` and ``minsum`` bit-equal, ``phi`` within rtol and
  atol 1e-5 in f32 (the suite's kernel-1 tolerance: two libms) and one
  bf16 ulp in bf16; the violation counts exact (JAX's [18, nzb, 8, B]
  summed over nzb at sublane 0).  The loop's ``t + 0.001 out`` within one
  ulp of the dtype of the sum and of the product (XLA may fuse the two
  into one rounding);
* one ``rolls`` body (f32 equal; bf16 within 2^-6 of the magnitudes summed,
  since the JAX probe rounds each of its bf16 slab adds and the port sums in
  f32 and rounds once), one ``check`` body for each ``--pallas`` (the
  kernel-1 tolerance), and the layered sweep, parity and full bodies for
  each grouping (equal);
* each preamble stage after ``sample`` on the JAX draw (x, y) (f32: the
  decisions and bits exact, the softened noise within atol 1e-5, the LLRs
  within rtol 1e-5 and atol 1e-4: two erf and log implementations), and
  ``sample`` by its mean and variance within 4 standard errors;
* kernel 7's plain version against the probe's interpret run (4 iterations
  of a 16-step chain): bf16 and f32 ``exp`` equal, f32 ``mac`` within the
  64 steps' ulps of the largest value (XLA may contract ``x * a + b`` into
  one FMA, which the kernel and its plain version do not);
* the MC-MI variants at P = 4, N = 2048: the mean estimate within 4
  standard errors of the JAX one (``torch.Generator`` cannot reproduce
  ``jax.random``).

Flags: every JAX probe's argparse flags, defaults and choices equal the
port's, less ``--device``.  The slice: each port probe's ``main([...,
"--device", "cpu"])`` prints a device record and then records with the JAX
probe's keys, and exits 2 without a card unless given ``--device cpu``.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import qamreconciliation_tpu.ops.pallas_kernels as j_pallas
from qamreconciliation_tpu.models.alphabet import PAMAlphabet as JPAMAlphabet
from qamreconciliation_tpu_torch.models.alphabet import PAMAlphabet
from qamreconciliation_tpu_torch.models.mutual_information import (
    _draw, row_view,
)
from qamreconciliation_tpu_torch.models.noisemapper import NoiseMapper
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import kernels as K
from qamreconciliation_tpu_torch.scripts import (
    probe_bf16pack, probe_check_math, probe_layered_parts, probe_mcmi_parts,
    probe_preamble, probe_qc_parts,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 2304, 8                   # z = 64
Z = N // 36
SMALL = ["--n", str(N), "--batch", str(B)]
PORT = {"probe_check_math": probe_check_math,
        "probe_qc_parts": probe_qc_parts,
        "probe_layered_parts": probe_layered_parts,
        "probe_preamble": probe_preamble,
        "probe_mcmi_parts": probe_mcmi_parts,
        "probe_bf16pack": probe_bf16pack}
# a small run of each probe: the JAX flags (the port adds --device cpu)
SMALL_RUNS = {
    "probe_check_math": ["--math", "minsum", *SMALL, "--iters", "2",
                         "--reps", "1"],
    "probe_qc_parts": ["--part", "rolls", *SMALL, "--iters", "2",
                       "--reps", "1"],
    "probe_layered_parts": ["--part", "full", *SMALL, "--iters", "2",
                            "--reps", "1"],
    "probe_preamble": [*SMALL, "--reps", "1"],
    "probe_mcmi_parts": ["--variant", "noexp", "--p", "4", "--n", "2048",
                         "--reps", "1"],
    "probe_bf16pack": ["--rows", "16", "--cols", "128", "--iters", "2",
                       "--reps", "1"],
}


class Captured:
    """What a JAX probe's run handed to the patched JAX entry points."""

    def __init__(self):
        self.bodies = []     # fori_loop bodies
        self.pallas = []     # pallas_call-built calls (interpret mode)
        self.jits = []       # (function, jitted function)
        self.calls = []      # (function, args, result) of jitted calls


def jax_probe(name, argv, monkeypatch, loops="skip"):
    """Run ``scripts/<name>.py``'s main with ``argv`` and the patches of
    the module docstring; ``loops``: "skip" (fori_loop returns its initial
    value, its body kept), "once" (one step, traced) or "run" (unpatched).
    Returns the Captured."""
    cap = Captured()
    monkeypatch.setattr(sys, "path", list(sys.path))
    orig_pallas, orig_jit = pl.pallas_call, jax.jit
    orig_check = j_pallas.bp_check_phase_qc

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        fn = orig_pallas(kernel, **kw)
        cap.pallas.append(fn)
        return fn

    def check_phase(*a, **kw):
        kw["interpret"] = True
        return orig_check(*a, **kw)

    def jit(fn, **kw):
        jitted = orig_jit(fn, **kw)
        cap.jits.append((fn, jitted))

        def call(*a, **k):
            out = jitted(*a, **k)
            cap.calls.append((fn, a, out))
            return out
        return call

    def fori_loop(lower, upper, body, init, **kw):
        cap.bodies.append(body)
        return init if loops == "skip" else body(lower, init)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    monkeypatch.setattr(j_pallas, "bp_check_phase_qc", check_phase)
    monkeypatch.setattr(jax, "jit", jit)
    if loops != "run":
        monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    mod.main()
    return cap


def records(capsys):
    """The JSON records printed since the last read."""
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def to_jax(x, dtype):
    """A torch tensor as a JAX array of ``dtype`` (through float32, exact
    for bf16 and f32 values)."""
    return jnp.asarray(x.float().numpy()).astype(dtype)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def within_ulp(got, want, dtype, slack=0.0):
    """|got - want| <= one ulp in ``dtype`` (f32 or bf16) of the larger of
    the two, plus ``slack``."""
    got, want = f32(got), f32(want)
    bits = 7 if dtype in ("bfloat16", torch.bfloat16) else 23
    a = np.maximum(np.abs(want), np.abs(got))
    ulp = np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-38)))
                                  - bits), 2.0 ** -133)
    return bool((np.abs(got - want) <= ulp + slack).all())


def assert_phi_close(got, want, dtype):
    if dtype == "bfloat16":
        assert within_ulp(got, want, dtype)
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------- #
# Kernel 6 and the check-math loop


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("math_", ["phi", "copy", "minsum"])
def test_check_math_kernel_matches_the_jax_probe(math_, dtype, monkeypatch):
    cap = jax_probe("probe_check_math", [
        "--math", math_, *SMALL, "--dtype", dtype, "--iters", "2",
        "--reps", "1"], monkeypatch, loops="once")
    (fn, loop), phase = cap.jits[-1], cap.pallas[-1]
    assert fn.__name__ == "loop"
    tdt = getattr(torch, dtype)
    t, c2v, synd = probe_check_math.inputs(N, B, tdt, "cpu")
    # the probe's inputs, and integer-valued ones whose magnitudes tie
    ties = (torch.round(2.0 * t.float()).to(tdt) / 2, torch.zeros_like(c2v))
    for tt, cc in ((t, c2v), ties):
        tj, cj = to_jax(tt, dtype), to_jax(cc, dtype)
        sj = jnp.asarray(synd.numpy())
        jout, jviol = phase(tj, cj, sj)
        out, viol = K.check_math_probe_ref(tt, cc, synd, math_)
        assert out.dtype == tdt and viol.shape == (18, B)
        assert np.array_equal(np.asarray(jviol)[:, :, 0].sum(1), viol.numpy())
        if math_ == "phi":
            assert_phi_close(out, jout, dtype)
        else:
            assert np.array_equal(f32(out), f32(jout))
        # one step of the probe's loop: (t + 0.001 out, out), within one
        # ulp of the sum and one of the product (XLA may fuse the two into
        # one rounding) beyond what the outputs' difference carries
        jt, jo = loop(tj, cj, sj)
        pt, po = probe_check_math.step(tt, cc, synd, math_,
                                       torch.tensor(0.001, dtype=tdt))
        assert np.array_equal(f32(po), f32(out))
        eps = 2.0 ** (-7 if dtype == "bfloat16" else -23)
        assert within_ulp(pt, jt, dtype, slack=0.001 * (
            np.abs(f32(po) - f32(jo)) + eps * np.abs(f32(po))))


def test_probe_minsum_gives_tied_minima_min2():
    """The probe's min-sum is not the decoders': a tied minimum gets the
    least magnitude above it (the decoders' rule gives it the minimum)."""
    v = torch.tensor([1.0, 1.0, 3.0, 5.0, 7.0, 9.0])
    t = v.view(1, 6, 1, 1)
    out, _ = K.check_math_probe_ref(t, torch.zeros_like(t),
                                    torch.zeros((1, 1, 1), dtype=torch.int32),
                                    "minsum")
    assert out.view(-1).tolist() == [0.8125 * 3.0, 0.8125 * 3.0] + \
        [0.8125 * 1.0] * 4
    # every slot at the minimum: min2 is the 1e30 stand-in
    same = K.check_math_probe_ref(t.new_ones(t.shape), torch.zeros_like(t),
                                  torch.zeros((1, 1, 1), dtype=torch.int32),
                                  "minsum")[0]
    assert torch.equal(same.view(-1), torch.full((6,), 1e30) * 0.8125)


def test_probe_maths_stay_out_of_the_decoders():
    assert set(K.RULES) == {"sumproduct", "tanhfb", "minsum"}
    assert set(K.PROBE_MATHS.values()).isdisjoint({1, 2})
    with pytest.raises(ValueError):
        K.check_math_probe_ref(torch.zeros(1, 2, 1, 1),
                               torch.zeros(1, 2, 1, 1),
                               torch.zeros(1, 1, 1, dtype=torch.int32),
                               "tanhfb")


# --------------------------------------------------------------------- #
# QC parts


def qc_inputs(dtype):
    """The probe's (synd, prior, t0) draws, in order, as torch tensors."""
    rng = np.random.default_rng(0)
    synd = torch.as_tensor(rng.integers(0, 2, (18, Z, B)), dtype=torch.int32)
    prior = torch.as_tensor(rng.normal(0, 3.0, (36, Z, B)), dtype=dtype)
    t0 = torch.as_tensor(rng.normal(0, 3.0, (18, 6, Z, B)), dtype=dtype)
    return synd, prior, t0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qc_rolls_body_matches_the_jax_probe(dtype, monkeypatch):
    cap = jax_probe("probe_qc_parts", [
        "--part", "rolls", *SMALL, "--dtype", dtype, "--iters", "2",
        "--reps", "1"], monkeypatch)
    body = cap.bodies[-1]
    tdt = getattr(torch, dtype)
    _, prior, _ = qc_inputs(tdt)
    base, _, _ = make_qc_ldpc(36, Z, dv=3, dc=6, seed=12345)
    dec = QCDecoder(base, Z, dtype=tdt, device="cpu")
    total = prior.flip(0)      # a total other than the prior itself
    got = probe_qc_parts.rolls_body(dec, prior)(total)
    assert got.dtype == tdt
    if dtype == "float32":
        # op by op, as the probe's body reads (under jit XLA may contract
        # the product into the adds)
        assert np.array_equal(f32(got), f32(body(0, to_jax(total, dtype))))
    else:
        want = jax_jit_call(body, total, dtype)
        mags = dec.scatter_partials(dec.gather_totals(total.float().abs())
                                    * 0.33)
        bound = 2.0 ** -6 * (prior.float().abs() + mags)
        assert bool((torch.from_numpy(np.abs(f32(got) - want))
                     <= bound).all())


def jax_jit_call(body, x, dtype):
    """``body(0, x)`` under jax.jit (one compile, not one a roll shift),
    as float32 numpy."""
    fn = jax.jit(lambda v: body(0, v))
    return f32(fn(to_jax(x, dtype)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pallas", [1, 0])
def test_qc_check_body_matches_the_jax_probe(pallas, dtype, monkeypatch):
    cap = jax_probe("probe_qc_parts", [
        "--part", "check", "--pallas", str(pallas), *SMALL, "--dtype", dtype,
        "--iters", "2", "--reps", "1"], monkeypatch)
    body = cap.bodies[-1]
    tdt = getattr(torch, dtype)
    synd, _, t0 = qc_inputs(tdt)
    c2v = torch.as_tensor(np.random.default_rng(5).normal(0, 1, t0.shape),
                          dtype=tdt)
    want = f32(body(0, to_jax(c2v, dtype)))
    got = probe_qc_parts.check_body(t0, synd, bool(pallas))(c2v)
    assert got.dtype == tdt
    assert_phi_close(got, want, dtype)


# --------------------------------------------------------------------- #
# Layered parts


@pytest.mark.parametrize("grouped", [0, 1])
def test_layered_bodies_match_the_jax_probe(grouped, monkeypatch):
    bodies = {}
    for part in ("sweep", "parity", "full"):
        cap = jax_probe("probe_layered_parts", [
            "--part", part, "--grouped", str(grouped), *SMALL, "--iters",
            "2", "--reps", "1"], monkeypatch)
        bodies[part] = cap.bodies[-1]
    rng = np.random.default_rng(0)
    synd = torch.as_tensor(rng.integers(0, 2, (18, Z, B)), dtype=torch.int32)
    prior = torch.as_tensor(rng.normal(0, 3.0, (36, Z, B)),
                            dtype=torch.float32)
    base, _, _ = make_qc_ldpc(36, Z, dv=3, dc=6, seed=12345)
    dec = QCDecoder(base, Z, dtype=torch.bfloat16, device="cpu",
                    schedule="layered", check_rule="minsum")
    groups = probe_layered_parts.greedy_groups(dec._rows, bool(grouped))
    assert len(groups) == (6 if grouped else 18)
    probe = probe_layered_parts.LayeredProbe(dec._rows, groups, synd,
                                             torch.bfloat16, "minsum")
    for part, jbody in bodies.items():
        body = probe.body(part)

        def twice(state):
            return jbody(1, jbody(0, state))

        if part == "parity":
            want = twice(jnp.asarray(prior.numpy()))
            got = body(body(prior.clone()))
            assert np.array_equal(np.asarray(want), got.numpy())
            continue
        c2v0 = torch.zeros((18, 6, Z, B), dtype=torch.bfloat16)
        want = twice((jnp.asarray(prior.numpy()), to_jax(c2v0, "bfloat16")))
        got = body(body((prior.clone(), c2v0.clone())))
        assert np.array_equal(np.asarray(want[0]), got[0].numpy()), part
        assert np.array_equal(f32(want[1]), f32(got[1])), part


# --------------------------------------------------------------------- #
# Preamble


@pytest.mark.parametrize("bps,fy_mode", [(2, "erf"), (4, "poly")])
def test_preamble_stages_match_the_jax_probe(bps, fy_mode, monkeypatch):
    with jax.enable_x64(False):
        cap = jax_probe("probe_preamble", [
            *SMALL, "--reps", "1", "--bps", str(bps), "--fy-mode", fy_mode],
            monkeypatch)
        stage = {}
        for fn, args, out in cap.calls:
            stage.setdefault(fn.__name__, (args, out))
        key = stage["stage_sample"][0][0]
        kx, _ = jax.random.split(key)
        S = N // bps
        x = np.asarray(JPAMAlphabet(bps, 2.0).random_symbols(kx, (S, B)))
        y = f32(stage["stage_sample"][1])
    pa = PAMAlphabet(bps, 2.0)
    snr = 3.5 if bps == 2 else 10.0
    N0 = pa.variance * 10.0 ** (-snr / 10.0) / 2.0
    nm = NoiseMapper(pa, N0, dtype=torch.float32, device="cpu",
                     fy_mode=fy_mode)
    nm._ensure_llr_poly()
    if fy_mode == "poly":
        nm._ensure_fy_poly()
    s2b = torch.as_tensor(pa.s_to_b.astype(np.int32))
    xt, yt = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    names = ["stage_hard", "stage_noise", "stage_word", "stage_llr"]
    for (name, fn), jname in zip(probe_preamble.STAGES[1:], names):
        got = fn(nm, s2b, xt, yt).numpy()
        want = f32(stage[jname][1])
        assert got.shape == want.shape, name
        if name == "+hard_decide":
            assert np.array_equal(got, want)
        elif name == "+poly_llr(full)":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def moments(y):
    """(mean, its standard error, variance, its standard error)."""
    y = np.asarray(y, np.float64).reshape(-1)
    c = y - y.mean()
    var = (c ** 2).mean()
    return (y.mean(), math.sqrt(var / y.size), var,
            math.sqrt(((c ** 2 - var) ** 2).mean() / y.size))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preamble_sample_matches_the_jax_draw_in_distribution(dtype,
                                                              monkeypatch):
    with jax.enable_x64(False):
        cap = jax_probe("probe_preamble", [*SMALL, "--reps", "1",
                                           "--dtype", dtype], monkeypatch)
        want = f32([o for fn, _, o in cap.calls
                    if fn.__name__ == "stage_sample"][0])
    pa = PAMAlphabet(2, 2.0)
    N0 = pa.variance * 10.0 ** (-0.35) / 2.0
    gen = torch.Generator().manual_seed(0)
    x, y = probe_preamble.sample(pa, gen, (N // 2, B), torch.tensor(
        math.sqrt(N0), dtype=getattr(torch, dtype)))
    assert x.shape == y.shape == want.shape
    assert y.dtype == getattr(torch, dtype)
    mj, sj, vj, svj = moments(want)
    mp, sp, vp, svp = moments(f32(y))
    assert abs(mj - mp) <= 4 * math.hypot(sj, sp)
    assert abs(vj - vp) <= 4 * math.hypot(svj, svp)
    assert abs(vp - (pa.variance + N0)) <= 4 * svp


# --------------------------------------------------------------------- #
# MC-MI parts


@pytest.mark.parametrize("variant", probe_mcmi_parts.VARIANTS)
def test_mcmi_variant_matches_the_jax_probe_in_distribution(variant,
                                                            monkeypatch):
    P, n = 4, 2048
    cap = jax_probe("probe_mcmi_parts", [
        "--variant", variant, "--p", str(P), "--n", str(n), "--reps", "1"],
        monkeypatch, loops="run")
    want = np.asarray(cap.calls[-1][2])
    assert want.shape == (P,)
    pa, nm, p_X = probe_mcmi_parts.mapper(4, "cpu", variant)
    view = row_view([nm.with_sign_config(np.zeros(16, np.uint8))
                     for _ in range(P)])
    gen = torch.Generator().manual_seed(0)
    x_ind, noise = _draw(gen, pa, nm, (P, n))
    terms = probe_mcmi_parts.log2_terms(pa, view, torch.as_tensor(p_X),
                                        x_ind, noise, variant)
    assert terms.shape == (P, n) and bool(torch.isfinite(terms).all())
    got = -terms.mean(dim=1).numpy()
    se = terms.std().item() / math.sqrt(P * n)
    assert abs(want.mean() - got.mean()) <= 4 * math.sqrt(2) * se + 1e-15


# --------------------------------------------------------------------- #
# Kernel 7


def test_elementwise_chain_matches_the_jax_probe(monkeypatch):
    cap = jax_probe("probe_bf16pack", ["--rows", "64", "--cols", "128",
                                       "--reps", "1"], monkeypatch,
                    loops="run")
    runs = []
    for fn, args, out in cap.calls:
        if not runs or runs[-1][0] is not fn:
            runs.append((fn, args[0], out))
    assert len(runs) == 4
    iters, chain = 4, 16        # the probe's cap off the TPU
    for (_, x, out), (mode, tdt) in zip(runs, [
            ("mac", torch.float32), ("mac", torch.bfloat16),
            ("exp", torch.float32), ("exp", torch.bfloat16)]):
        xt = torch.from_numpy(f32(x)).to(tdt)
        got = f32(K.elementwise_chain_ref(xt, mode, iters, chain))
        want = f32(out)
        if mode == "mac" and tdt == torch.float32:
            tol = iters * chain * np.spacing(np.float32(np.abs(want).max()))
            assert np.abs(got - want).max() <= tol
        else:
            assert np.array_equal(got, want), (mode, tdt)


def test_elementwise_chain_rounds_every_operation():
    x = torch.tensor([1.0, -2.5, 3.0], dtype=torch.bfloat16)
    a = torch.tensor(K.CHAIN_A, dtype=torch.bfloat16)
    b = torch.tensor(K.CHAIN_B, dtype=torch.bfloat16)
    step = x * a + b
    assert torch.equal(K.elementwise_chain_ref(x, "mac", 1, 1), step)
    assert torch.equal(K.elementwise_chain_ref(x, "mac", 0, 16), x)
    assert torch.equal(K.elementwise_chain_ref(x, "exp", 1, 1),
                       torch.exp(-torch.abs(x)) * a + x * b)
    assert probe_bf16pack.elem_ops(2, 3, 4, 5, "exp") == 2 * 3 * 4 * 5 * 3


# --------------------------------------------------------------------- #
# Flags and the slice


class _Parsed(Exception):
    pass


def parser_of(main, argv, monkeypatch):
    """The ArgumentParser ``main`` builds (stopped at parse_args)."""
    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.undo()
    return seen[0]


def flags(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default,
                   tuple(a.choices) if a.choices else None,
                   getattr(a.type, "__name__", None), a.required)
                  for a in parser._actions
                  if a.dest not in ("help", "device"))


@pytest.mark.parametrize("name", sorted(PORT))
def test_flags_equal_the_jax_probe(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        f"jax_flags_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec.loader.exec_module(mod)
    jax_parser = parser_of(lambda argv: mod.main(), [], monkeypatch)
    port_parser = parser_of(PORT[name].main, [], monkeypatch)
    assert flags(port_parser) == flags(jax_parser)
    device = [a for a in port_parser._actions if a.dest == "device"][0]
    assert device.default == "cuda"


@pytest.mark.parametrize("name", sorted(PORT))
def test_port_probe_prints_the_jax_records(name, monkeypatch, capsys):
    loops = "run" if name in ("probe_mcmi_parts", "probe_bf16pack") \
        else "skip"
    if name == "probe_preamble":
        with jax.enable_x64(False):
            jax_probe(name, SMALL_RUNS[name], monkeypatch, loops=loops)
    else:
        jax_probe(name, SMALL_RUNS[name], monkeypatch, loops=loops)
    want = records(capsys)
    monkeypatch.undo()
    assert PORT[name].main([*SMALL_RUNS[name], "--device", "cpu"]) == 0
    got = records(capsys)
    assert got[0] == {"probe": name, "device": "cpu", "power_limit": None}
    assert [list(r) for r in got[1:]] == [list(r) for r in want]
    for g, w in zip(got[1:], want):
        for k in ("math", "part", "stage", "variant", "mode", "dtype",
                  "grouped", "n_groups", "zb"):
            if k in w and k != "zb":
                assert g[k] == w[k], k


@pytest.mark.parametrize("name", sorted(PORT))
def test_port_probe_exits_2_without_a_card(name, capsys):
    assert not torch.cuda.is_available()
    assert PORT[name].main(SMALL_RUNS[name]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "--device cpu" in captured.err
