"""Port parity: stochastically rounded bf16 messages (``sr_messages``).

* ``stochastic_round_bf16`` is bit-equal to the JAX package's on the same
  numpy-made bits, over values of every magnitude, both signs, patterns
  whose carry crosses an exponent (and reaches the next binade), and the
  extremes of the bits; every draw is one of the two bf16 neighbours, and
  the mean is unbiased.
* Given the same random bits, the port's SR decode is bit-equal to the JAX
  package's (success, iters and finals, min-sum, bf16 and f32 totals):
  both subtract ``t - c2v`` in f32 (XLA drops the bf16 rounding the JAX
  source writes there).
* The port's SR decode (``QCDecoder(sr_messages=True)``, the plain check
  update with its bf16 stores stochastically rounded) is deterministic
  given its inputs, differs from round-to-nearest, and its FER agrees with
  the JAX SR decode's within 4 Monte-Carlo standard errors (the two draw
  different bits).
* The CLI's ``--sr-messages`` runs, and the configuration checks are
  JAX's.  The counterpart of tests/test_sr.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qamreconciliation_tpu.models.qc_decoder import QCDecoder as JQC
from qamreconciliation_tpu.ops.boxplus import (
    stochastic_round_bf16 as j_sr,
)
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc, save_qc_csv,
)
from qamreconciliation_tpu_torch.ops.boxplus import stochastic_round_bf16
from qamreconciliation_tpu_torch.sims import sim_reconciliation

torch.set_num_threads(1)

BASE = make_qc_ldpc(12, 32, 3, 6, seed=3)[0]          # N = 384, z = 32


def sr_inputs(seed, n=4096):
    """float32 values across magnitudes and signs, with patterns whose low
    16 bits are near 0xFFFF (the carry crosses into the next bf16 value,
    at a binade's top also into the next exponent), and uint32 bits
    holding the extremes 0 and 0xFFFF in the low half."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 5, n) * 10.0 ** rng.integers(-20, 20, n)) \
        .astype(np.float32)
    pat = x.view(np.uint32)
    top = rng.random(n) < 0.25
    pat[top] = (pat[top] | 0xFFF0) | (rng.integers(0, 16, top.sum())
                                      .astype(np.uint32))
    binade = rng.random(n) < 0.1                      # mantissa all ones
    pat[binade] |= 0x007FFFF0
    x = pat.view(np.float32)
    x[:4] = [0.0, -0.0, 1.0, -2.0]
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    bits[:8] = [0, 0xFFFF, 0xFFFF0000, 0xFFFFFFFF, 1, 0x8000, 0x7FFF,
                0x10000]
    assert np.isfinite(x).all()
    return x, bits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_round_bit_equal_to_jax(seed):
    x, bits = sr_inputs(seed)
    want = np.asarray(j_sr(jnp.asarray(x), jnp.asarray(bits))
                      .astype(jnp.float32))
    tx = torch.from_numpy(x)
    for tb in (torch.from_numpy(bits.view(np.int32)),
               torch.from_numpy(bits.astype(np.int64))):
        got = stochastic_round_bf16(tx, tb)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                      want.view(np.uint32))
    # the carries did cross exponents
    exp = lambda a: (a.view(np.uint32) >> 23) & 0xFF       # noqa: E731
    assert (exp(want) != exp(x)).sum() > 10


def test_stochastic_round_neighbours_and_unbiased():
    """Every draw is one of the two enclosing bf16 neighbours, and the mean
    over draws approaches x well inside one bf16 ulp."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 5, 4096).astype(np.float32)
    pat = x.view(np.uint32)
    lo = (pat & 0xFFFF0000).view(np.float32).astype(np.float64)
    hi = ((pat.astype(np.uint64) + 0xFFFF) & 0xFFFF0000).astype(
        np.uint32).view(np.float32).astype(np.float64)
    gen = torch.Generator().manual_seed(7)
    acc = np.zeros(x.shape)
    R = 64
    for _ in range(R):
        bits = torch.randint(0, 1 << 16, x.shape, generator=gen,
                             dtype=torch.int32)
        y = stochastic_round_bf16(torch.from_numpy(x), bits).double().numpy()
        assert np.all((y == lo) | (y == hi))
        acc += y
    err = np.abs(acc / R - x.astype(np.float64))
    ulp = np.abs(x.astype(np.float64)) * 2 ** -8 + 1e-12
    assert float(np.max(err / ulp)) < 0.5


def channel(B, seed, scale=2.0, noise=1.0):
    dec = QCDecoder(BASE, 32, device="cpu")
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 2, (B, dec.vnum))
    synd = dec.syndrome_from_bits(torch.from_numpy(word.T)).T.contiguous()
    lappr = (1.0 - 2.0 * word) * scale + noise * rng.standard_normal(
        word.shape)
    return lappr, synd.numpy()


def test_sr_decode_deterministic_and_not_round_to_nearest():
    """Two decodes of the same inputs are identical (the generator is seeded
    0x5eed at every decode); round-to-nearest gives other finals."""
    lappr, synd = channel(16, 0, scale=2.0, noise=1.7)
    args = (torch.from_numpy(lappr).bfloat16(), torch.from_numpy(synd), 12)
    sr = QCDecoder(BASE, 32, torch.bfloat16, device="cpu", sr_messages=True)
    a, b = sr.decode_batch(*args), sr.decode_batch(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    rtn = QCDecoder(BASE, 32, torch.bfloat16, device="cpu").decode_batch(
        *args)
    assert not torch.equal(a[2], rtn[2])
    assert 0 < int(a[0].sum()) < 16


@pytest.mark.parametrize("totals", ["storage", "float32"])
def test_sr_decode_bit_equal_to_jax_on_injected_bits(monkeypatch, totals):
    """One table of numpy-made bits, row ``it`` for iteration ``it``, feeds
    both SR decodes: JAX's ``bits(fold_in(key, it))`` and the port's
    per-iteration ``torch.randint`` draw are replaced by the table's row.
    Min-sum (no transcendental) makes the two decodes bit-equal, success,
    iters and finals, with some frames converging and some failing."""
    B, maxiter = 16, 12
    lappr, synd = channel(B, 1, scale=2.0, noise=1.7)
    nb_c, dc, z = 6, 6, 32
    rng = np.random.default_rng(9)
    table = rng.integers(0, 2 ** 32, (maxiter, nb_c, dc, z, B),
                         dtype=np.uint64).astype(np.uint32)
    kw = dict(check_rule="minsum", totals_dtype=totals)

    rows = list(torch.from_numpy(table.view(np.int32)))
    monkeypatch.setattr(torch, "randint", lambda *a, **k: rows.pop(0))
    got = QCDecoder(BASE, 32, torch.bfloat16, device="cpu",
                    sr_messages=True, **kw).decode_batch(
        torch.from_numpy(lappr).bfloat16(), torch.from_numpy(synd), maxiter)
    assert rows == []                        # one draw an iteration

    jtable = jnp.asarray(table)
    monkeypatch.setattr(jax.random, "fold_in", lambda key, it: it)
    monkeypatch.setattr(jax.random, "bits",
                        lambda it, shape, dtype: jtable[it])
    with jax.enable_x64(False):
        want = JQC(BASE, 32, dtype=jnp.bfloat16, sr_messages=True,
                   use_pallas=False, **kw).decode_batch(
            jnp.asarray(lappr, jnp.bfloat16), jnp.asarray(synd), maxiter)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(
        got[2].float().numpy().view(np.uint32),
        np.asarray(want[2].astype(jnp.float32)).view(np.uint32))
    assert 0 < int(got[0].sum()) < B


def test_sr_decode_converges_on_easy_frames_as_jax():
    """sr_messages decodes the easy frames that round-to-nearest and the JAX
    SR decode decode (the rounding is sub-ulp noise)."""
    lappr, synd = channel(8, 0)
    ok = {}
    for sr in (False, True):
        ok[sr] = QCDecoder(BASE, 32, torch.bfloat16, device="cpu",
                           sr_messages=sr).decode_batch(
            torch.from_numpy(lappr).bfloat16(), torch.from_numpy(synd),
            50)[0].numpy()
    jok = np.asarray(JQC(BASE, 32, dtype=jnp.bfloat16, sr_messages=True,
                         use_pallas=False).decode_batch(
        jnp.asarray(lappr, jnp.bfloat16), jnp.asarray(synd), 50)[0])
    assert ok[False].all() and ok[True].all() and jok.all()


def test_sr_fer_matches_jax_statistically():
    """FER of 256 frames near the code's knee, port against JAX, within 4
    standard errors of their difference, 4 * sqrt(2 p (1 - p) / 256)."""
    B = 256
    lappr, synd = channel(B, 5, scale=2.0, noise=1.7)
    tfail = 1.0 - QCDecoder(BASE, 32, torch.bfloat16, device="cpu",
                            sr_messages=True).decode_batch(
        torch.from_numpy(lappr).bfloat16(), torch.from_numpy(synd),
        30)[0].float().mean().item()
    with jax.enable_x64(False):
        jfail = 1.0 - float(np.asarray(JQC(
            BASE, 32, dtype=jnp.bfloat16, sr_messages=True,
            use_pallas=False).decode_batch(
            jnp.asarray(lappr, jnp.bfloat16), jnp.asarray(synd),
            30)[0]).mean())
    p = (tfail + jfail) / 2
    assert 0.1 < p < 0.9, p
    assert abs(tfail - jfail) <= 4 * math.sqrt(2 * p * (1 - p) / B), \
        (tfail, jfail)


def test_sr_cli_runs(tmp_path):
    """``sim_reconciliation --qc --dtype bfloat16 --sr-messages`` on the
    CPU: one point, its CSV row."""
    path = str(tmp_path / "qc.csv")
    save_qc_csv(path, BASE, 32)
    out = str(tmp_path / "out.csv")
    res = sim_reconciliation.main([
        path, "--qc", "--dtype", "bfloat16", "--sr-messages", "--snr", "3.5",
        "3.5", "--nsnr", "1", "--simloops", "16", "--batch", "8",
        "--maxiter", "10", "--device", "cpu", "--out", out])
    assert len(res) == 1 and res[0].frames == 16
    with open(out) as f:
        assert f.readline().strip() == ",EsN0dB,ber,fer,iters"


def test_sr_config_validation():
    with pytest.raises(ValueError, match="bfloat16"):
        QCDecoder(BASE, 32, torch.float32, device="cpu", sr_messages=True)
    for kw in (dict(resident=True), dict(schedule="layered")):
        with pytest.raises(ValueError, match="dense flooding"):
            QCDecoder(BASE, 32, torch.bfloat16, device="cpu",
                      sr_messages=True, **kw)
