"""The port's bench (``python3 -m qamreconciliation_tpu_torch.bench``): the
counterpart of tests/test_bench.py, without jax.

A CPU smoke run at tests/test_bench.py's tiny settings holds the output
contract (one JSON line on stdout, bench.py's top-level keys, every row,
each decode row equal to its plain version and bounded); its keys cover
BENCH_r05.json's but for the TPU-only ones; without a card and without
``--device cpu`` the bench refuses to run; ``utils/perf.py``'s work and
bounds reproduce the kernels' figures in PERF.md; neither module imports
jax or the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch

from qamreconciliation_tpu_torch.utils import perf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "BENCH_N": "1152", "BENCH_NBV": "36", "BENCH_BATCH": "8",
    "BENCH_ROUNDS": "2", "BENCH_RPD": "1", "BENCH_BASELINE_S": "1",
    "BENCH_SNR": "4.0", "BENCH_SNR2": "5.0", "BENCH_MAXITER": "15",
    "BENCH_PROBE_ITERS": "30", "BENCH_MI_N": "65536",
}
# bench.py's keys that say how a TPU laid the work out; the port's JSON
# carries its own bound (bound_ms, bound_by, roofline_fraction) instead
TPU_ONLY = {"vpu_util_frac", "roofline_note", "achieved_GBps",
            "resident_double", "totals_f32", "rowgroup"}
PROBE_ROWS = ("irregular_qc", "rate34_qc")
POINT_ROWS = ("waterfall", "minsum", "minsum.waterfall",
              "sumproduct_tanhfb_dense", "sumproduct_tanhfb_dense.waterfall",
              "layered", "generic", "headline_round")

torch.set_num_threads(1)


def run_bench(*args, env_extra=None, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", **TINY)
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "qamreconciliation_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def one_line(out):
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE stdout line, got {lines}"
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def smoke():
    return one_line(run_bench("--device", "cpu"))


def row(j, path):
    for key in path.split("."):
        j = j[key]
    return j


def test_bench_cpu_smoke_json_contract(smoke):
    j = smoke
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert k in j, k
    assert j["metric"] == "softening_decoded_frames_per_s"
    assert j["unit"] == "frames/s" and j["value"] > 0
    assert j["vs_baseline"] > 0 and j["baseline"]["frames"] >= 3
    assert j["device"]["platform"] == "cpu" and j["device"]["count"] == 1
    assert "name" in j["device"] and "power_limit" in j["device"]
    assert j["build_s"] is None                  # nothing built on the CPU
    # every row of the table (true_shape_qc only where N % 180 == 0)
    assert j["schedule"] == "flooding" and j["resident"] is True
    assert j["probe_iters"] == 30 and j["decode_ms_per_iter"] > 0
    assert "true_shape_qc" not in j
    for name in PROBE_ROWS:
        assert row(j, name)["decode_ms_per_iter"] > 0, name
    for name in POINT_ROWS:
        r = row(j, name)
        assert r["round_ms"] > 0 and r["frames_per_rep"] == 16, name
        if name != "headline_round":
            assert r["frames_per_s"] > 0 and len(r["rep_frames_per_s"]) \
                == r["reps"] >= 3, name
    assert j["headline_reps"] == len(j["rep_frames_per_s"]) >= 3
    assert j["layered"]["check_rule"] == "minsum"
    assert j["layered"]["resident"] is True
    assert j["generic"]["code"] == "regular(3,6) N=1152"
    s = j["streaming"]
    assert s["symbols_per_s"] > 0 and s["frames"] == 32
    assert len(s["rep_symbols_per_s"]) == s["reps"] >= 3
    m = j["mc_mi"]
    assert m["samples_per_s"] > 0 and len(m["rep_samples_per_s"]) == 3
    assert set(j["round_breakdown"]) == {"preamble_ms", "decode_ms",
                                         "read_ms", "iterations"}
    # each decode row: its plain version agreed, and it has a bound
    for r in [j] + [row(j, n) for n in PROBE_ROWS + POINT_ROWS] + [s]:
        assert r["plain_equal"] is True
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert 0 < r["roofline_fraction"] <= 1.0


def test_bench_keys_cover_the_jax_bench(smoke):
    """Every key of BENCH_r05.json's parsed line and of each of its rows
    appears in the port's JSON, but for the TPU-only keys."""
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        ref = json.load(f)["parsed"]

    def missing(want, got, path=""):
        out = []
        for k, v in want.items():
            if k in TPU_ONLY:
                continue
            if k not in got:
                out.append(path + k)
            elif isinstance(v, dict):
                out += missing(v, got[k], f"{path}{k}.")
        return out

    assert missing(ref, smoke) == []
    assert not TPU_ONLY & set(smoke)
    for name in PROBE_ROWS:
        assert not TPU_ONLY & set(smoke[name])


def test_bench_rows_subset_and_true_shape(monkeypatch, capsys):
    """``--rows`` runs the rows named and no other; at N % 180 == 0 (and
    BENCH_NBV != 180) the true-shape probe runs, equal to its plain
    version.  An unknown row is refused."""
    from qamreconciliation_tpu_torch import bench

    for k, v in dict(TINY, BENCH_N="1440").items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu", "--rows", "true_shape_qc"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    j = json.loads(lines[0])
    assert j["rows"] == ["true_shape_qc"]
    t = j["true_shape_qc"]
    assert t["code"].startswith("qc-ira dv=3 z=8 N=1440")
    assert t["plain_equal"] is True and t["decode_ms_per_iter"] > 0
    for absent in ("decode_ms_per_iter", "waterfall", "minsum", "generic",
                   "mc_mi", "baseline"):
        assert absent not in j, absent
    assert j["value"] is None and j["vs_baseline"] is None
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--rows", "decode,bogus"])
    assert exc.value.code == 2
    assert not capsys.readouterr().out.strip()


def test_bench_refuses_without_a_card():
    """No card and no ``--device cpu``: exit 2 and no result."""
    out = run_bench(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr[-2000:]
    assert not out.stdout.strip()
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("kernel, work, mb, ms", [
    ("bp_check_phase_qc [90,6,360,128] f32",
     lambda: perf.check_phase_qc_work(90, 6, 360, 128, torch.float32,
                                      torch.float32, "sumproduct"),
     315.2, 0.094),
    ("bp_check_phase_generic [7,32400,128] f32",
     lambda: perf.check_phase_generic_work(7, 32400, 128, torch.float32,
                                           "sumproduct"),
     366.1, 0.109),
    ("check_node_update [32400,7,128] f32",
     lambda: perf.check_node_update_work(32400, 7, 128, torch.float32),
     249.7, 0.075),
    ("check_node_update [32400,7,128] bf16",
     lambda: perf.check_node_update_work(32400, 7, 128, torch.bfloat16),
     133.6, 0.040),
])
def test_perf_bounds_reproduce_the_kernel_table(kernel, work, mb, ms):
    """PERF.md's kernel table: bytes and memory-bound ms at 3.35 TB/s."""
    nbytes, ops = work()
    assert round(nbytes / 1e6, 1) == mb, kernel
    bound_ms, by = perf.bound(nbytes, ops)
    assert round(bound_ms, 3) == ms and by == "bytes", kernel


def test_perf_multi_step_bounds():
    """Kernels 2 and 3: a call's state once over its steps against each
    step's operations (PERF.md: kernel 2 153.4 MB a K = 45 call, 0.0149 ms
    by operations; kernel 3 170.0 MB a K = 4 call, 0.0127 ms by bytes)."""
    nbytes, ops = perf.decode_rounds_work(180, 90, 540, 360, 128,
                                          torch.bfloat16, torch.bfloat16,
                                          "tanhfb")
    assert round(nbytes / 1e6, 1) == 153.4
    bound_ms, by = perf.bound(nbytes, ops, steps=45)
    assert round(bound_ms, 4) == 0.0149 and by == "operations"
    nbytes, ops = perf.layered_sweeps_work(180, 90, 540, 360, 128,
                                           torch.bfloat16, "minsum")
    assert round(nbytes / 1e6, 1) == 170.0
    bound_ms, by = perf.bound(nbytes, ops, steps=4)
    assert round(bound_ms, 4) == 0.0127 and by == "bytes"
    # the bytes of tensors, each counted once
    assert perf.tensor_bytes(torch.zeros(3, 4), torch.zeros(
        5, dtype=torch.bfloat16)) == 58


@pytest.mark.parametrize("mode, dtype, ms, without_sfu", [
    ("exp", torch.float32, 16.05, 10.02),
    ("exp", torch.bfloat16, 16.05, 5.02),
    ("mac", torch.float32, 4.01, 4.01),
    ("mac", torch.bfloat16, 2.01, 2.01),
])
def test_perf_chain_bounds_put_exp_on_the_sfu(mode, dtype, ms, without_sfu):
    """Kernel 7 at the probe's [512, 1024] x 8000 x 16 steps: an exp step
    needs one MUFU.EX2 in either dtype, 6.71e10 of them at 16 a clock on
    132 SMs at 1.98 GHz, so both exp chains are bound at 16.05 ms (the
    FMA-rate count alone gave 10.02 and 5.02); the mac bounds stay at the
    f32 and packed-bf16 rates."""
    nbytes, ops, rate, sfu = perf.elementwise_chain_work(
        512 * 1024, dtype, 8000, 16, mode)
    assert sfu == (512 * 1024 * 8000 * 16 if mode == "exp" else 0)
    bound_ms, by = perf.bound(nbytes, ops, ops_per_s=rate, sfu_ops=sfu)
    assert round(bound_ms, 2) == ms and by == "operations"
    assert round(perf.bound(nbytes, ops, ops_per_s=rate)[0], 2) \
        == without_sfu
    assert perf.SFU_OPS_PER_S == 16 * 132 * 1.98e9


def test_bench_and_perf_import_no_jax():
    code = ("import sys\n"
            "import qamreconciliation_tpu_torch.bench\n"
            "import qamreconciliation_tpu_torch.utils.perf\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'qamreconciliation_tpu' or "
            "m.startswith('qamreconciliation_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
