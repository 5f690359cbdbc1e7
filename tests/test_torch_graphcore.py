"""Port parity: the native C++ oracle (``qamreconciliation_tpu_torch.
_graphcore``) and the decoders held to it.

* The port's ``ScalarDecoder`` equals the JAX package's on the same inputs
  (the same C++ source): success, iters and final LLRs identical; the CSV
  parser and the syndrome too.
* The port's generic ``Decoder`` in float64 on the CPU matches the oracle on
  10 random decodes of a small code: identical success and iters, final LLRs
  within rtol 1e-8 + atol 1e-8 (as ``tests/test_graphcore.py`` holds the
  JAX decoder).
* The ``QCDecoder`` (sum-product phi, float64) on a small QC code, its
  expanded edge list given to the oracle, matches it the same way.
* The oracle's own semantics: ``iters == 0`` and the LLRs passed through for
  a consistent input, ``iters == max_iterations`` on failure; its library
  is cached per host CPU.

The module is imported directly, so a broken build fails here.
"""

import numpy as np
import pytest
import torch

from qamreconciliation_tpu import _graphcore as jgc
from qamreconciliation_tpu.utils import edgefile as jedgefile
from qamreconciliation_tpu_torch import _graphcore as gc
from qamreconciliation_tpu_torch.models.decoder import Decoder
from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.utils import edgefile

torch.set_num_threads(1)

REGULAR = edgefile.make_regular_ldpc(256, dv=3, dc=6, seed=3)
QC = make_qc_ldpc(16, 16, 3, 6, seed=3)                 # N = 256, z = 16


def random_decodes(sd, n, seed, noise=3.0, scale=4.0):
    """n (word, synd, llr) triples: a random word's syndrome and noisy
    LLRs of the word, some decodable at this noise and some not."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        word = rng.integers(0, 2, sd.vnum).astype(np.uint8)
        llr = (1 - 2 * word.astype(np.float64)) * scale + rng.normal(
            0, noise, sd.vnum)
        yield word, sd.eval_syndrome(word), llr


def test_scalar_decoder_equals_the_jax_packages():
    vid, cid = REGULAR
    sd, jsd = gc.ScalarDecoder(vid, cid), jgc.ScalarDecoder(vid, cid)
    assert (sd.vnum, sd.cnum, sd.ednum) == (jsd.vnum, jsd.cnum, jsd.ednum)
    for word, synd, llr in random_decodes(sd, 6, seed=5):
        np.testing.assert_array_equal(synd, jsd.eval_syndrome(word))
        got, want = sd.decode(llr, synd, 30), jsd.decode(llr, synd, 30)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])


def test_csv_parser_equals_numpy_and_the_jax_loader(tmp_path):
    vid, cid = REGULAR
    path = str(tmp_path / "code.csv")
    edgefile.save_edge_csv(path, vid, cid)
    want = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64,
                      ndmin=2).T
    for got, w in zip(gc.load_edge_csv(path), want):
        np.testing.assert_array_equal(got, w)
    v2, c2 = edgefile.load_edge_csv(path)
    jv, jc = jedgefile.load_edge_csv(path)
    np.testing.assert_array_equal(v2, vid)
    np.testing.assert_array_equal(c2, cid)
    np.testing.assert_array_equal(v2, jv)
    np.testing.assert_array_equal(c2, jc)


def test_syndrome_equals_the_graphs():
    vid, cid = REGULAR
    sd = gc.ScalarDecoder(vid, cid)
    word = np.random.default_rng(0).integers(0, 2, sd.vnum)
    got = Matrix(vid, cid).graph.syndrome_from_bits(
        torch.from_numpy(word)[:, None])[:, 0]
    np.testing.assert_array_equal(sd.eval_syndrome(word.astype(np.uint8)),
                                  got.numpy())


@pytest.mark.parametrize("which", ["generic", "qc-sumproduct"])
def test_float64_decoder_matches_the_oracle(which):
    """Success and iters identical, final LLRs within rtol 1e-8 + atol
    1e-8, over 10 random decodes (the QC decoder's expanded edge list goes
    to the oracle)."""
    if which == "generic":
        vid, cid = REGULAR
        dec = Decoder(vid, cid, torch.float64, device="cpu")
    else:
        base, vid, cid = QC
        dec = QCDecoder(base, 16, torch.float64, device="cpu")
        vid, cid = dec.vid, dec.cid
    sd = gc.ScalarDecoder(vid, cid)
    n_success = 0
    for _, synd, llr in random_decodes(sd, 10, seed=7):
        s_c, i_c, f_c = sd.decode(llr, synd, 30)
        s, i, f = dec.decode_batch(torch.from_numpy(llr)[None],
                                   torch.from_numpy(synd)[None], 30)
        assert (bool(s[0]), int(i[0])) == (s_c, i_c)
        assert f.dtype == torch.float64
        np.testing.assert_allclose(f[0].numpy(), f_c, rtol=1e-8, atol=1e-8)
        n_success += s_c
    assert 0 < n_success < 10      # decoded and failed frames both occur


def test_consistent_input_passes_through():
    vid, cid = REGULAR
    sd = gc.ScalarDecoder(vid, cid)
    word = np.random.default_rng(1).integers(0, 2, sd.vnum).astype(np.uint8)
    llr = (1 - 2 * word.astype(np.float64)) * 5.0
    success, iters, final = sd.decode(llr, sd.eval_syndrome(word), 30)
    assert success and iters == 0
    np.testing.assert_array_equal(final, llr)


def test_failure_reports_max_iterations():
    vid, cid = REGULAR
    sd = gc.ScalarDecoder(vid, cid)
    rng = np.random.default_rng(2)
    word = rng.integers(0, 2, sd.vnum).astype(np.uint8)
    success, iters, _ = sd.decode(rng.normal(0, 1.0, sd.vnum),
                                  sd.eval_syndrome(word), 5)
    assert not success and iters == 5


def test_library_is_keyed_by_the_host_cpu(monkeypatch):
    """Another CPU's target options name another library, so a checkout
    carried to another host builds its own instead of loading this one."""
    here = gc._build_lib()
    assert here == gc._build_lib()
    monkeypatch.setattr(gc, "_target_options", lambda: b"-march=other")
    monkeypatch.setattr(gc.os.path, "exists", lambda p: True)
    assert gc._build_lib() != here


def test_input_sizes_are_checked():
    sd = gc.ScalarDecoder(*REGULAR)
    with pytest.raises(ValueError):
        sd.decode(np.zeros(sd.vnum + 1), np.zeros(sd.cnum, np.uint8), 5)
    with pytest.raises(ValueError):
        sd.eval_syndrome(np.zeros(sd.vnum - 1, np.uint8))
    with pytest.raises(ValueError):
        gc.ScalarDecoder([0, 1], [0])
