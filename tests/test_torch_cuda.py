"""The port's CUDA kernel against its plain version, and the wrapper's
dispatch.  Imports no JAX, so it also runs on a GPU host without jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tests marked ``cuda`` skip without a card.  Tolerances as in
test_torch_check_phase.py: min-sum and the convergence counts are exact,
phi/tanhfb within rtol/atol 1e-5 in f32 (two libms: the kernel's and
PyTorch's CUDA ops) or one bf16 ulp with bf16 messages.
"""

import numpy as np
import pytest
import torch

from qamreconciliation_tpu_torch.models.matrix import Matrix
from qamreconciliation_tpu_torch.models.qc_decoder import (
    QCDecoder, make_qc_ldpc,
)
from qamreconciliation_tpu_torch.ops import cuda_build
from qamreconciliation_tpu_torch.ops.kernels import (
    bp_check_phase_qc, bp_check_phase_qc_ref,
)

torch.set_num_threads(1)

RULES = [
    ("sumproduct", {}),
    ("tanhfb", {}),
    ("minsum", {}),
    ("minsum", dict(ms_alpha=1.0, ms_beta=0.3)),
]
DTYPES = [  # (t, c2v) storage pairs
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),
]


def make_inputs(seed, shape, irregular=True):
    """numpy (t, c2v, synd); short rows carry the +1e30 padded-slot
    sentinel in t, as the decoder's gather writes it."""
    nb_c, dc, z, b = shape
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 3, shape).astype(np.float32)
    c2v = rng.normal(0, 1, shape).astype(np.float32)
    synd = rng.integers(0, 2, (nb_c, z, b)).astype(np.int32)
    if irregular:
        for cb in range(0, nb_c, 2):
            t[cb, dc - 1 - cb % 3:] = 1e30
    return t, c2v, synd


def assert_close(got, want, rule, m_dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if rule == "minsum":
        assert torch.equal(got, want)
    elif m_dtype == torch.bfloat16:
        a = want.abs()
        ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                          torch.full_like(a, 2.0 ** -133))
        assert bool(((got - want).abs() <= ulp).all()), \
            float((got - want).abs().max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_cpu_tensors_run_the_plain_version():
    t, c2v, synd = (torch.from_numpy(a)
                    for a in make_inputs(1, (3, 6, 10, 5)))
    n0 = bp_check_phase_qc.launches
    got = bp_check_phase_qc(t, c2v, synd, rule="minsum")
    want = bp_check_phase_qc_ref(t, c2v, synd, rule="minsum")
    assert bp_check_phase_qc.launches == n0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_build_keys_library_by_source_and_reports_missing_nvcc(
        tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = cuda_build._library_path(src)
    src.write_text("// b\n")
    assert cuda_build._library_path(src) != first
    assert first.parent == cuda_build.BUILD_DIR
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build._nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype,m_dtype", DTYPES)
@pytest.mark.parametrize("rule,kw", RULES)
def test_cuda_kernel_matches_plain(rule, kw, t_dtype, m_dtype):
    """A ragged shape: z and B not multiples of the kernel's tiles."""
    need_cuda()
    t, c2v, synd = make_inputs(13, (5, 7, 70, 40))
    args = (torch.from_numpy(t).to("cuda", t_dtype),
            torch.from_numpy(c2v).to("cuda", m_dtype),
            torch.from_numpy(synd).cuda())
    n0 = bp_check_phase_qc.launches
    got, gviol = bp_check_phase_qc(*args, rule=rule, **kw)
    assert bp_check_phase_qc.launches == n0 + 1
    want, wviol = bp_check_phase_qc_ref(*args, rule=rule, **kw)
    torch.cuda.synchronize()
    assert got.dtype == m_dtype and gviol.dtype == torch.int32
    assert torch.equal(gviol, wviol)
    assert_close(got, want, rule, m_dtype)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    need_cuda()
    t = torch.zeros(2, 6, 8, 4, device="cuda")
    synd = torch.zeros(2, 8, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        bp_check_phase_qc(t.double(), t.double(), synd)
    with pytest.raises(TypeError):
        bp_check_phase_qc(t, t, synd.long())
    with pytest.raises(ValueError, match="contiguous"):
        bp_check_phase_qc(t.transpose(2, 3).contiguous().transpose(2, 3),
                          t, synd)
    wide = torch.zeros(2, 33, 8, 4, device="cuda")
    with pytest.raises(ValueError, match="degree"):
        bp_check_phase_qc(wide, wide, synd)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(check_rule="minsum"), dict(),
                                dict(check_phi="tanhfb")],
                         ids=["minsum", "phi", "tanhfb"])
def test_cuda_decode_matches_cpu(kw):
    """The decoder on the card (kernel) against the CPU (plain version)."""
    need_cuda()
    base, vid, cid = make_qc_ldpc(12, 32, 3, 6, seed=7)
    rng = np.random.default_rng(4)
    B = 24
    word = rng.integers(0, 2, (B, 12 * 32))
    synd = Matrix(vid, cid).eval_syndrome(torch.from_numpy(word))
    llr = torch.from_numpy(
        (1 - 2 * word) * 2.5 + rng.normal(0, 2.2, word.shape)
    ).float()
    cpu = QCDecoder(base, 32, device="cpu", **kw).decode_batch(llr, synd, 25)
    n0 = bp_check_phase_qc.launches
    dec = QCDecoder(base, 32, device="cuda", **kw)
    gpu = dec.decode_batch(llr, synd, 25)
    assert bp_check_phase_qc.launches - n0 == dec.iterations_run > 0
    assert torch.equal(gpu[0].cpu(), cpu[0])
    assert torch.equal(gpu[1].cpu(), cpu[1])
    assert 0 < int(cpu[0].sum()) < B
    if kw.get("check_rule") == "minsum":
        assert torch.equal(gpu[2].cpu(), cpu[2])
    else:
        torch.testing.assert_close(gpu[2].cpu(), cpu[2], rtol=1e-4,
                                   atol=1e-4)
