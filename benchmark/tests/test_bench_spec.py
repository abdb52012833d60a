"""BENCHMARK.json against the benchmark's contract, and every part of a
cell found by name."""

import json
import os
import re

import pytest

from harness import core

SPEC = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_run_seconds_fit_the_full_check():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_entries_have_only_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(work):
    cell = core.Cell(work["name"])
    assert os.path.exists(os.path.join(core.BENCH_DIR, "loops",
                                       cell.traffic["loop"] + ".py"))
    cell.loop()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert hasattr(cell.reader(m["name"]), "read")
        assert m["moves"] in e2e
    loop = cell.loop()
    assert set(cell.limits) and all(
        isinstance(v, (int, float)) for v in cell.limits.values())
    assert hasattr(loop, "check") and hasattr(loop, "end_to_end")


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_yaml_as_run(conf):
    from gens_torch.config import config_to_dict, load_config

    data = core.load_json(os.path.join(core.ROOT, conf["file"]))
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
    cfg = load_config(os.path.join(core.ROOT, data["yaml"]),
                      data["overrides"])
    assert json.loads(json.dumps(config_to_dict(cfg))) == data["config"]
    w = data["weights"]
    assert os.path.exists(os.path.join(core.ROOT, w))


def test_files_are_named_from_names():
    for path, _, files in os.walk(core.BENCH_DIR):
        if "__pycache__" in path:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(path, f), core.ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


def test_import_check_passes():
    import check_imports

    assert check_imports.static_faults() == []
    assert check_imports.runtime_faults() == []


def test_import_check_sees_a_forbidden_import(tmp_path):
    import check_imports

    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom gens_torch import x\n")
    assert set(check_imports.imported_names(str(bad))) == {"jax",
                                                           "gens_torch"}
    assert "gens_tpu" in check_imports.FORBIDDEN
    assert "gens_torch" not in check_imports.FORBIDDEN
