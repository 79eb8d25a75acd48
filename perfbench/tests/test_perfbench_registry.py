"""A configuration, a traffic mix and a per-layer metric are added as
files plus entries, and found by name, with no file edited."""

import json
import os
import shutil

import pytest

from perfbench.harness import registry
from perfbench.harness.readers import ReadContext

REPO = registry.REPO_ROOT


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_resolves():
    bench = _bench()
    for cell in bench["workloads"]:
        cfg = registry.config(bench, cell["config"])
        tr = registry.traffic(cell["traffic"])
        registry.system(cfg["system"])
        assert tr["loop"] == "closed" and tr["clients"] == 1
        assert tr["pool"] >= 8
        for m in registry.metrics_of_cell(bench, cell["name"], "per_layer"):
            assert callable(registry.metric_reader(m["name"]).read)
        e2e = {m["name"].split(".")[0] for m in
               registry.metrics_of_cell(bench, cell["name"], "end_to_end")}
        assert e2e == {"setup_s", "proofs_per_s", "prove_p95_ms"}


def test_added_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"))
    before = {p: open(p, "rb").read() for p in _files(root)}
    bench = _bench()
    with open(os.path.join(root, "perfbench", "configs",
                           "stark_hi128_64_8.json"), "w") as fh:
        json.dump({"system": "stark", "schedule": [128, 64, 8], "r": 32,
                   "seed_z": 3740252845, "reduced": []}, fh)
    with open(os.path.join(root, "perfbench", "traffic",
                           "k18_host.json"), "w") as fh:
        json.dump({"k": 18, "witness": "host", "loop": "closed",
                   "clients": 1, "pool": 8}, fh)
    with open(os.path.join(root, "perfbench", "metrics",
                           "build_f0_ms.py"), "w") as fh:
        fh.write("def read(ctx):\n"
                 "    return ctx.phase_ms('fri/build_f0')\n")
    bench["configs"].append({"name": "stark_hi128_64_8", "source": "x",
                             "file": "perfbench/configs/stark_hi128_64_8"
                                     ".json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "stark_hi128_64_8.k18_host",
                               "config": "stark_hi128_64_8",
                               "traffic": "k18_host", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "build_f0_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "f0", "moves": "proofs_per_s",
                               "workloads": ["stark_hi128_64_8.k18_host"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    b = registry.load_benchmark(root)
    cell = registry.cell(b, "stark_hi128_64_8.k18_host")
    cfg = registry.config(b, cell["config"], root)
    tr = registry.traffic(cell["traffic"], root)
    assert cfg["schedule"] == [128, 64, 8] and tr["k"] == 18
    sysmod = registry.system(cfg["system"], root)
    assert sysmod.System(cfg, tr, 1, "cpu").n == 1 << 18
    names = [m["name"] for m in registry.metrics_of_cell(
        b, cell["name"], "per_layer")]
    assert names == ["build_f0_ms"]
    reader = registry.metric_reader("build_f0_ms", root)
    assert reader.read(ReadContext(cfg, tr, cell, 2,
                                   {"fri/build_f0": 3.0}, None)) == 1500.0
    from perfbench import roofline
    work = roofline.work(cfg, tr)
    assert set(work) == {"k1", "k5"} and set(work["k5"]) == {129, 65}
    # nothing that was there changed
    assert all(open(p, "rb").read() == data for p, data in before.items())


def _files(root):
    for d, _, fs in os.walk(os.path.join(root, "perfbench")):
        for f in fs:
            if f.endswith((".py", ".json")):
                yield os.path.join(d, f)


def test_names_are_checked():
    with pytest.raises(ValueError):
        registry.traffic("../configs/stark_paper")
    with pytest.raises(KeyError):
        registry.metric_reader("no_such_metric")


def test_benchmark_json_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in bench[k]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
