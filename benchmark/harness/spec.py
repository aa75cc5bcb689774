"""What a run reads: ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration, whose ``file`` is
``benchmark/configs/<name>.json``, and a traffic mix, found as
``benchmark/traffic/<traffic>.json``.  Everything else a run does is found
by a name in those files, as a module of its own under ``benchmark/``:

* ``metrics/<name>.py``: every metric, end to end or per layer, a module
  with ``read(run) -> float | None`` (:class:`harness.record.RunRecord`);
* ``generators/<kind>.py``: the traffic file's ``kind``: how set-up makes
  the batches and how the window drives the calls;
* ``entries/<entry>.py``: the configuration's ``system.entry``: which entry
  of the program a call goes through;
* ``references/entries/<entry>.py`` and
  ``references/methods/<method>_<D>d.py``: the plain reference's schedule
  of driver loops for that entry, and its step of the configuration's
  method in ``D`` dimensions.

A later cell, kind of traffic, entry, method or metric is new files and a
new entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


_LOADED: dict = {}


def module(folder: str, name: str, root: str = ROOT):
    """The module ``benchmark/<folder>/<name>.py`` of the checkout at ``root``,
    loaded once per process."""
    path = os.path.join(root, "benchmark", folder, name + ".py")
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {folder} named {name!r}: {path} does not exist")
        mod_name = "benchmark_" + "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    return module("metrics", metric, root).read
