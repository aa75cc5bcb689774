"""Every configuration, traffic mix and metric that ``BENCHMARK.json`` names
loads by its name, and the file keeps to the format it must have."""

import json
import os
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["command"][1].startswith("benchmark/")


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("workload", ["trimmed2d-fleet8192", "trimmed3d-multistart512"])
def test_cell_files_load_by_name(root, workload):
    cell = spec.load_cell(workload, root)
    assert cell.config["name"] == workload.split("-")[0]
    assert {"kind", "lanes", "distinct_batches", "perturbation", "trace_calls",
            "sample"} <= set(cell.traffic)
    system = cell.config["system"]
    generator = spec.module("generators", cell.traffic["kind"], root)
    assert callable(generator.make) and callable(generator.window)
    entry = spec.module("entries", system["entry"], root)
    assert callable(entry.call) and entry.LOOPS
    assert callable(spec.module("references/entries", system["entry"], root).register)
    method = f"{system['method']['name']}_{system['dim']}d"
    assert callable(spec.module("references/methods", method, root).step)
    assert set(cell.config["correct"]) == {"far_m", "limits"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "pairs_per_s"}
    assert len(cell.per_layer) == 5
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"], root))


def test_a_name_with_no_file_is_refused(root):
    with pytest.raises(FileNotFoundError):
        spec.module("generators", "no_such_kind", root)


def test_pinned_data_matches(root, bench):
    from harness import data

    for c in bench["configs"]:
        data.check_pinned(root, spec.load_json(os.path.join(root, c["file"]))["data"]["sha256"])
