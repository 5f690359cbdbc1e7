"""Where the config-batched MC-MI estimator's time goes.

The port's counterpart of the JAX package's ``scripts/probe_mcmi_parts.py``:
the I(X,N;X^) estimator of the sign study's inner loop over P
configurations of N samples each (16-PAM, 10 dB, float64), and ablations
that each stub out one suspected hot part:

  full     -- the estimator: every candidate's inverse g^-1 from the grid
              (``NoiseMapper._y_hat_all_candidates(n, "interp")``), the
              decided one by Newton (``g_inv_search``), the [M, M]
              exponential sums;
  poly     -- the candidates from the fitted inverse (``"poly"``);
  nogather -- the candidates replaced by y (no table reads);
  nonewton -- the decided candidate replaced by y (no Newton loop);
  noexp    -- the exponential sums replaced by ``|y_hat| + 1``.

The P configurations are a leading tensor dimension: P
``with_sign_config(zeros)`` clones, as the JAX probe makes them, evaluated
at once through ``models.mutual_information.row_view``.  Each call draws
its [P, N] symbols and noise from one ``torch.Generator`` seeded 0.  The
exponent is one [P, N, M, M] float64 tensor, transformed in place: 8.6 GB
at the defaults (P 1024, N 4096, M 16), the call's peak with a few [P, N,
M] temporaries (0.5 GB each) beside it.

    python -m qamreconciliation_tpu_torch.scripts.probe_mcmi_parts \\
        --variant full|poly|nogather|nonewton|noexp [--p 1024] [--device cuda]

One record after the device record: ``{variant, p, n, bps, dispatch_s,
samples_per_s, compile_s}``: ``dispatch_s`` the mean seconds of one call
over ``--reps`` calls in one CUDA-event window.  Exits 2 without a card
unless ``--device cpu``.
"""

import argparse
import sys

import numpy as np
import torch

from ._probe import add_device, emit, first_call, open_device, window_ms
from ..models.alphabet import PAMAlphabet
from ..models.mutual_information import P_xhat, _draw, row_view
from ..models.noisemapper import NoiseMapper

__all__ = ["VARIANTS", "mapper", "log2_terms", "main"]

VARIANTS = ["full", "poly", "nogather", "nonewton", "noexp"]


def mapper(bps: int, device, variant: str):
    """(alphabet, float64 mapper at 10 dB, its decision marginal) of the
    probe; the ``poly`` variant's inverse fit is built here."""
    pa = PAMAlphabet(bps, 2.0)
    nm = NoiseMapper(pa, pa.variance * 10 ** (-1.0), dtype=torch.float64,
                     device=device)
    if variant == "poly":
        nm._ensure_ginv_poly()
    return pa, nm, P_xhat(nm)


def log2_terms(pa, nm, p_X, x_ind, noise, variant: str):
    """``log2(val)`` [P, N] of the estimator (the estimate of config p is
    minus its row's mean), from symbols ``x_ind`` and standard normal
    ``noise`` [P, N]; ``nm`` reads row p's signs (``row_view``)."""
    M = nm.order
    dtype = nm.dtype
    x_ind = x_ind.long()
    y = pa.index_to_value(x_ind, dtype) + nm._sigma_dev * noise
    xhat_ind = nm.hard_decide_index(y).long()
    n = nm.map_noise(y, xhat_ind)
    c, p, dF = nm._c, nm._p, nm._delta_F_Y
    x_val = c[x_ind]
    two_var = 2.0 * nm._noise_var_dev
    if variant == "nogather":
        y_hat_all = y[..., None].expand(*y.shape, M)
    elif variant == "poly":
        y_hat_all = nm._y_hat_all_candidates(n, "poly")
    else:
        y_hat_all = nm._y_hat_all_candidates(n, "interp")
    y_hat_hat = y if variant == "nonewton" else nm.g_inv_search(n, xhat_ind)
    is_hat = torch.arange(M, device=y.device) == xhat_ind[..., None]
    y_hat_all = torch.where(is_hat, y_hat_hat[..., None], y_hat_all)
    if variant == "noexp":
        denom = torch.abs(y_hat_all) + 1.0
    else:
        xv = x_val[..., None, None]
        expo = 2.0 * y_hat_all[..., None] - xv - c       # [P, N, M, M]
        expo.mul_(c - xv).div_(two_var).exp_().mul_(p)
        denom = torch.sum(expo, dim=-1)
        del expo
    terms = torch.where(is_hat, 0.0, dF / denom)
    tmp_sum = torch.sum(terms, dim=-1)
    denom_hat = torch.gather(denom, -1, xhat_ind[..., None])[..., 0]
    val = (tmp_sum * denom_hat / dF[xhat_ind] + 1.0) * p_X[xhat_ind]
    return torch.log2(val)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_mcmi_parts")
    ap.add_argument("--variant", default="full", choices=VARIANTS)
    ap.add_argument("--p", type=int, default=1024)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--bps", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    add_device(ap)
    args = ap.parse_args(argv)
    device = open_device("probe_mcmi_parts", args.device)
    if device is None:
        return 2

    pa, nm, p_X = mapper(args.bps, device, args.variant)
    clones = [nm.with_sign_config(np.zeros(nm.order, np.uint8))
              for _ in range(args.p)]
    view = row_view(clones)
    p_X = torch.as_tensor(p_X, dtype=nm.dtype, device=device)
    gen = torch.Generator(device=device)

    def call():
        gen.manual_seed(0)
        x_ind, noise = _draw(gen, pa, nm, (args.p, args.n))
        return -torch.mean(log2_terms(pa, view, p_X, x_ind, noise,
                                      args.variant), dim=1)

    compile_s = first_call(call, device)
    print(f"compile+first: {compile_s:.1f}s", file=sys.stderr, flush=True)
    dt = window_ms(call, args.reps, device) / 1e3
    emit({"variant": args.variant, "p": args.p, "n": args.n, "bps": args.bps,
          "dispatch_s": round(dt, 4),
          "samples_per_s": round(args.p * args.n / dt, 1),
          "compile_s": round(compile_s, 1)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
