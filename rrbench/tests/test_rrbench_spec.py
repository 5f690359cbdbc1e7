"""BENCHMARK.json keeps to the contract's names and limits, and every
entry resolves to its files by name."""

import importlib.util
import json

import pytest

from rrbench import decoders, modes, spec
from rrbench.tests.tiny import BENCH, ROOT, WORKLOADS

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves"}}
LINE_KEYS = (("configs", "source"), ("configs", "why"), ("workloads", "why"),
             ("per_layer", "layer"))


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for group, keys in METRIC_KEYS.items():
        for m in BENCH[group]:
            assert keys <= set(m) <= keys | {"workloads"}
            assert m["better"] in ("lower", "higher")


def test_names_units_and_lines_use_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w[k] for w in BENCH["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for g in METRIC_KEYS for m in BENCH[g]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME.fullmatch(n), n
    for g in METRIC_KEYS:
        for m in BENCH[g]:
            assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
    for group, key in LINE_KEYS:
        for e in BENCH[group]:
            assert _line(e[key]), (group, key)
    assert all(_line(w) for w in BENCH["command"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns)), group
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_paths_command_and_files():
    assert BENCH["paths"] == ["rrbench"]
    assert BENCH["command"] == ["python3", "-m", "rrbench.run"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("rrbench/")
        assert (ROOT / c["file"]).is_file()
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_bounds_and_run_seconds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves_to_its_files(name):
    cell = spec.cell(BENCH, ROOT, name)
    code_kind = cell.config["code"]["kind"]
    assert importlib.util.find_spec(f"rrbench.codes.{code_kind}")
    dec = decoders.load(cell.config["decoder"]["kind"])
    for attr in ("program", "Reference", "KERNEL_HOOK", "pre_call",
                 "call_record"):
        assert hasattr(dec, attr)
    mode = modes.load(cell.traffic["mode"])
    assert hasattr(mode, "inputs") and hasattr(mode, "PROGRAM_MODE")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.load_reader(m["name"]))


def test_metric_workloads_name_cells():
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
