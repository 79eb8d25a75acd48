"""Everything of one cell is found by name under the root of a checkout:

  - `BENCHMARK.json`: the cells, the configurations' files, the metrics;
  - `perfbench/configs/<config>.json` (the path `BENCHMARK.json` gives):
    a configuration's sizes, with `system` naming its adapter;
  - `perfbench/traffic/<traffic>.json`: a traffic mix's parameters;
  - `perfbench/systems/<system>.py`: how the program and the reference
    are driven for a kind of proof;
  - `perfbench/metrics/<metric>.py`: a per-layer metric's reader.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; none of these is edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PERFBENCH)

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: str = REPO_ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = REPO_ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                out = json.load(fh)
            out["name"] = name
            return out
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = REPO_ROOT) -> dict:
    path = os.path.join(root, "perfbench", "traffic",
                        _checked(name) + ".json")
    with open(path) as fh:
        out = json.load(fh)
    out["name"] = name
    return out


def _load_file(kind: str, name: str, root: str):
    path = os.path.join(root, "perfbench", kind, _checked(name) + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} module {name!r} at {path}")
    mod_name = f"perfbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def system(name: str, root: str = REPO_ROOT):
    return _load_file("systems", name, root)


def metric_reader(name: str, root: str = REPO_ROOT):
    return _load_file("metrics", name, root)


def metrics_of_cell(bench: dict, workload: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that this cell reports: a
    metric with a `workloads` key in the cells it lists; one without, in
    every cell (a per-layer metric: every cell that reports the
    end-to-end metric it moves)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(m):
        if "workloads" in m:
            return workload in m["workloads"]
        if kind == "per_layer":
            return reports(e2e[m["moves"]])
        return True

    return [m for m in bench[kind] if reports(m)]
