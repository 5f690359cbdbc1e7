"""The resident flooding QC loop under normalized/offset min-sum, as the
benchmark's ``qc36.minsum-3.5dB`` cell runs it: bit-equality of the
port's plain loop (``QCDecoder(resident=True, check_rule="minsum")`` on
the CPU, ``bp_decode_rounds_qc_ref``) with the benchmark's frozen plain
reference (``rrbench/decoders/qc_resident_minsum.py``) on a small QC (3,6)
code, in f32 and bf16, at a chunk that covers the decode and one that
splits it; planted differences break it; the configuration's file
matches the code it builds."""

import json
from pathlib import Path

import pytest
import torch

from rrbench import codes, decoders, spec
from rrbench.decoders import qc_resident_minsum
from rrbench.ref import Precision

ROOT = Path(__file__).resolve().parents[1]
CONFIG = "qc36-minsum-n64800-4pam"
CODE = {"kind": "qc_ldpc", "nb_v": 12, "z": 16, "dv": 3, "dc": 6, "seed": 0}
SPEC = {"kind": "qc_resident_minsum", "check_rule": "minsum",
        "minsum_alpha": 0.8125, "minsum_beta": 0.0, "chunk": 50}
B, MAXITER = 16, 50
# BPSK Es/N0 in dB: below the knee of this N = 192 code every frame runs
# to the limit; in its waterfall frames converge at staggered steps
SNRS = {"below_knee": -3.0, "waterfall": 2.0}


class F32Messages:
    """A precision that keeps the LLRs, messages and totals in f32."""

    dtype = torch.float32

    def cast(self, x):
        return x.to(torch.float32)


PRECISIONS = {"float32": F32Messages(), "bfloat16": Precision("bfloat16")}


def _code():
    return codes.build(CODE)


def _program(code, dtype, spec_=SPEC):
    torch.set_num_threads(1)
    return qc_resident_minsum.program(code, spec_, dtype, "cpu")


def _inputs(code, snr_db: float, seed: int, dtype: str):
    """BPSK LLRs [N, B] of a random word at ``snr_db`` in ``dtype``, and
    its syndrome [C, B]."""
    g = torch.Generator().manual_seed(seed)
    word = torch.randint(0, 2, (code.vnum, B), generator=g,
                         dtype=torch.int32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * word).float() + sigma * torch.randn((code.vnum, B),
                                                     generator=g)
    prior = (2 * y / sigma ** 2).to(getattr(torch, dtype))
    return prior, decoders.syndrome(code, word)


def _same(got, want):
    """success, iters and the final totals all equal, bit for bit."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[2].dtype == want[2].dtype
            and torch.equal(got[2], want[2]))


@pytest.mark.parametrize("rule", [(0.8125, 0.0), (1.0, 0.5)],
                         ids=["normalized", "offset"])
@pytest.mark.parametrize("chunk", [50, 7])
@pytest.mark.parametrize("snr", list(SNRS))
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_resident_minsum_decode_is_bit_equal_to_the_reference(
        dtype, seed, snr, chunk, rule):
    code = _code()
    spec_ = {**SPEC, "minsum_alpha": rule[0], "minsum_beta": rule[1],
             "chunk": chunk}
    prior, synd = _inputs(code, SNRS[snr], seed, dtype)
    got = _program(code, dtype, spec_).decode_batched(prior, synd, MAXITER)
    want = qc_resident_minsum.Reference(
        code, spec_, PRECISIONS[dtype], "cpu").decode(prior, synd, MAXITER)
    success, iters = got[0], got[1]
    if snr == "below_knee":
        assert not bool(success.any())
    else:
        assert 0 < int(success.sum()) < B
        assert len(set(iters[success].tolist())) >= 3
    assert bool((iters[~success] == MAXITER).all())
    assert got[2].dtype == getattr(torch, dtype)
    assert _same(got, want)


@pytest.mark.parametrize("fault", ["alpha_0.75", "one_step_short"])
def test_a_planted_difference_reads_as_different(fault):
    code = _code()
    prior, synd = _inputs(code, SNRS["waterfall"], 3, "bfloat16")
    ref = qc_resident_minsum.Reference(code, SPEC, Precision("bfloat16"),
                                       "cpu")
    want = ref.decode(prior, synd, MAXITER)
    if fault == "alpha_0.75":
        dec = _program(code, "bfloat16", {**SPEC, "minsum_alpha": 0.75})
        got = dec.decode_batched(prior, synd, MAXITER)
    else:
        got = _program(code, "bfloat16").decode_batched(prior, synd,
                                                        MAXITER - 1)
    assert not _same(got, want)


def test_the_reference_takes_the_minsum_rule_alone():
    with pytest.raises(ValueError, match="min-sum"):
        qc_resident_minsum.Reference(
            _code(), {**SPEC, "check_rule": "sumproduct"},
            Precision("bfloat16"), "cpu")


def test_the_configuration_file_matches_its_code():
    bench = spec.load_benchmark(ROOT)
    entry = {c["name"]: c for c in bench["configs"]}[CONFIG]
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == CONFIG and config["reduced"] == []
    assert config["decoder"] == SPEC
    code = codes.build(config["code"])
    sizes = config["sizes"]
    B_, nb_v, z = config["batch"], config["code"]["nb_v"], code.z
    E = len(code.base_edges)
    assert (sizes["N"], sizes["K"], sizes["edges"]) == (
        code.vnum, code.vnum - code.cnum, len(code.vid))
    # bf16 totals, messages and prior, int8 syndrome
    assert sizes["decode_state_bytes_bf16"] == (
        2 * nb_v * z * B_ + 2 * E * z * B_ + 2 * nb_v * z * B_
        + code.cnum * B_)
