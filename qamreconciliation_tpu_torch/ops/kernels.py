"""Hand-written CUDA kernels of the BP hot loop, with their plain versions.

``bp_check_phase_qc`` is the fused check phase of the dense QC flooding
decoder (CUDA source ``csrc/bp_check_phase_qc.cu``; it replaces the Pallas
TPU kernel ``qamreconciliation_tpu/ops/pallas_kernels.py:bp_check_phase_qc``).
A tensor on the CPU goes to :func:`bp_check_phase_qc_ref`, the plain PyTorch
version with the same operation order; a CUDA tensor goes to the kernel, or
the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from .boxplus import (
    MINSUM_ALPHA, minsum_extrinsic_mag, minsum_mag, phi_llr,
    tanhfb_extrinsic_mag,
)

__all__ = ["RULES", "MAX_DC", "bp_check_phase_qc", "bp_check_phase_qc_ref"]

# magnitude rules, in the kernel's numbering
RULES = {"sumproduct": 0, "tanhfb": 1, "minsum": 2}
# widest check row the kernel holds in registers
MAX_DC = 32
# (t dtype, message dtype) pairs the kernel takes, in its dtype numbering
_KERNEL_DTYPES = {
    (torch.float32, torch.float32): (0, 0),
    (torch.bfloat16, torch.bfloat16): (1, 1),
    (torch.float32, torch.bfloat16): (0, 1),
}


def _check_args(t, c2v, synd, rule):
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}")
    if t.dim() != 4 or c2v.shape != t.shape:
        raise ValueError(
            f"t and c2v must both be [nb_c, dc, z, B], got {tuple(t.shape)} "
            f"and {tuple(c2v.shape)}"
        )
    nb_c, _, z, B = t.shape
    if tuple(synd.shape) != (nb_c, z, B):
        raise ValueError(
            f"synd must be [nb_c, z, B] = {(nb_c, z, B)}, got "
            f"{tuple(synd.shape)}"
        )
    if not (t.device == c2v.device == synd.device):
        raise ValueError("t, c2v and synd must be on one device")


def _fold_sum(x, dim: int):
    """Left-fold sum over ``dim`` (keepdim): ``((x0 + x1) + x2) + ...``,
    the order the kernel and the JAX package's reduction use."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.unsqueeze(dim)


def bp_check_phase_qc_ref(t, c2v, synd, tiny: float = 1e-30, *,
                          rule: str = "sumproduct",
                          ms_alpha: float = MINSUM_ALPHA,
                          ms_beta: float = 0.0):
    """Plain PyTorch fused check phase (any device); see
    :func:`bp_check_phase_qc` for the contract."""
    _check_args(t, c2v, synd, rule)
    out_dtype = c2v.dtype
    compute = (
        torch.float32 if torch.bfloat16 in (out_dtype, t.dtype) else t.dtype
    )
    t = t.to(compute)
    synd = synd.to(torch.int32)

    # 1. convergence: parity of hard decisions vs the syndrome
    parity = torch.sum((t < 0).to(torch.int32), dim=1) & 1
    viol = torch.sum((parity != synd).to(torch.int32), dim=1,
                     dtype=torch.int32)                        # [nb_c, B]

    # 2./3. extrinsic check update
    v2c = t - c2v.to(compute)
    absm = torch.abs(v2c)
    if rule == "minsum":
        mag = minsum_mag(minsum_extrinsic_mag(absm, 1), ms_alpha, ms_beta)
    elif rule == "tanhfb":
        mag = tanhfb_extrinsic_mag(absm, 1)
    else:
        phim = phi_llr(absm, tiny)
        mag = phi_llr(_fold_sum(phim, 1) - phim, tiny)
    neg = (v2c < 0).to(torch.int32)
    par = torch.sum(neg, dim=1, keepdim=True) & 1
    sign = (1 - 2 * torch.bitwise_xor(par, neg)).to(compute)
    pref = (1 - 2 * synd).to(compute).unsqueeze(1)
    return (sign * pref * mag).to(out_dtype), viol


def bp_check_phase_qc(t, c2v, synd, tiny: float = 1e-30, *,
                      rule: str = "sumproduct",
                      ms_alpha: float = MINSUM_ALPHA, ms_beta: float = 0.0):
    """Fused check phase in the QC decoder's native layout.

    Args:
      t:    [nb_c, dc, z, B] gathered variable totals (padded slots of
            irregular rows hold +1e30).
      c2v:  [nb_c, dc, z, B] previous check->variable messages.
      synd: [nb_c, z, B] syndrome bits (0/1 int).
      rule: "sumproduct" (phi form), "tanhfb" (tanh forward/backward
            sum-product) or "minsum" (``max(ms_alpha*min - ms_beta, 0)``).

    Returns ``(c2v_new [nb_c, dc, z, B] in c2v's dtype, viol [nb_c, B]
    int32)``; ``viol.sum(0) == 0`` is the per-frame convergence mask.

    CPU tensors run :func:`bp_check_phase_qc_ref`.  CUDA tensors run the
    kernel, which takes contiguous (t, c2v) dtype pairs (f32, f32),
    (bf16, bf16) and (f32, bf16), int32 synd and dc <= ``MAX_DC``; anything
    else raises.
    """
    if t.device.type == "cpu":
        return bp_check_phase_qc_ref(t, c2v, synd, tiny, rule=rule,
                                     ms_alpha=ms_alpha, ms_beta=ms_beta)
    _check_args(t, c2v, synd, rule)
    if t.device.type != "cuda":
        raise ValueError(f"bp_check_phase_qc: unsupported device {t.device}")
    codes = _KERNEL_DTYPES.get((t.dtype, c2v.dtype))
    if codes is None:
        raise TypeError(
            f"bp_check_phase_qc kernel takes (t, c2v) dtypes "
            f"{[(str(a), str(b)) for a, b in _KERNEL_DTYPES]}, got "
            f"({t.dtype}, {c2v.dtype}); float64 decodes run on the CPU"
        )
    if synd.dtype != torch.int32:
        raise TypeError(f"synd must be int32, got {synd.dtype}")
    if not (t.is_contiguous() and c2v.is_contiguous()
            and synd.is_contiguous()):
        raise ValueError("t, c2v and synd must be contiguous")
    nb_c, dc, z, B = t.shape
    if dc > MAX_DC:
        raise ValueError(f"check degree {dc} exceeds the kernel's {MAX_DC}")
    if nb_c > 65535:
        raise ValueError(f"{nb_c} check block rows exceed the grid's 65535")

    out = torch.empty_like(c2v)
    viol = torch.zeros((nb_c, B), dtype=torch.int32, device=t.device)
    lib = _library()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.bp_check_phase_qc_launch(
            t.data_ptr(), c2v.data_ptr(), synd.data_ptr(), out.data_ptr(),
            viol.data_ptr(), codes[0], codes[1], nb_c, dc, z, B, RULES[rule],
            float(tiny), float(ms_alpha), float(ms_beta), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"bp_check_phase_qc launch failed: CUDA error {err}"
        )
    bp_check_phase_qc.launches += 1
    return out, viol


bp_check_phase_qc.launches = 0


def _library():
    from .cuda_build import load_library

    lib = load_library("bp_check_phase_qc")
    fn = lib.bp_check_phase_qc_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, f, p]
        fn.restype = ctypes.c_int
    return lib
