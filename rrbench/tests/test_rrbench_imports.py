"""Nothing the benchmark loads imports JAX, the JAX package, the root
``bench.py`` or ``qamreconciliation_tpu_torch.bench``: top-level names are
compared whole, since ``qamreconciliation_tpu_torch`` begins with
``qamreconciliation_tpu``."""

import ast
import json
import subprocess
import sys

from rrbench import run
from rrbench.tests.tiny import ROOT

SCRIPT = r"""
import json, pkgutil, importlib, sys, time
import torch
import rrbench
from rrbench import run, spec, control
from rrbench.tests import tiny
for m in pkgutil.walk_packages(rrbench.__path__, "rrbench."):
    if not m.name.startswith("rrbench.tests.test_"):
        importlib.import_module(m.name)
for m in tiny.BENCH["per_layer"]:
    spec.load_reader(m["name"])
torch.set_num_threads(1)
for name in tiny.WORKLOADS:
    run.run_cell(tiny.cell(name), 5, 0.1, True, "cpu",
                 t_start=time.perf_counter())
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qamreconciliation_tpu_torch.x",
                        sys.modules[__name__])
    assert "qamreconciliation_tpu_torch.x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qamreconciliation_tpu.y",
                        sys.modules[__name__])
    monkeypatch.setitem(sys.modules, "qamreconciliation_tpu_torch.bench",
                        sys.modules[__name__])
    assert {"qamreconciliation_tpu.y", "qamreconciliation_tpu_torch.bench"} \
        <= set(run.forbidden_modules())


def test_no_source_imports_a_forbidden_module():
    for path in (ROOT / "rrbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN_TOP, (path, n)
                assert n not in run.FORBIDDEN_FULL, (path, n)
