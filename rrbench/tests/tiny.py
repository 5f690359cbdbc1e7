"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: the
same configuration and mix but a QC (3,6) code of N = 384 (decoded by the
cell's own decoder kind), 8 frames a round, 2 rounds a dispatch, 12
iterations at most and 32 frames a point."""

from __future__ import annotations

from pathlib import Path

from rrbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_benchmark(ROOT)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 123


def cell(name):
    c = spec.cell(BENCH, ROOT, name)
    c.config.update(batch=8, rounds_per_dispatch=2, max_iterations=12)
    c.config["code"] = {"kind": "qc_ldpc", "nb_v": 24, "z": 16, "dv": 3,
                        "dc": 6, "seed": 5}
    c.traffic["frames_per_point"] = 32
    return c
