"""The harness is driven by data: cells, configurations, traffic mixes
and per-layer metrics are found by name, and BENCHMARK.json keeps to the
contract's form."""

import json
import os
import re
import shutil

import pytest

from benchmark.lib import spec
from benchmark.lib.spec import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture()
def bench():
    return spec.load_benchmark()


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in bench[k]]
    assert len(set(all_names)) == len(all_names), "names repeat"
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_per_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert spec.reports(moved, cell), (m["name"], cell)
        layers.setdefault(m["layer"], m["layer"])
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"]
                    if spec.reports(m, w["name"])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(spec.reports(m, w["name"]) for m in bench["per_layer"])


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix and a per-layer metric added as files of
    their own, with no file of the harness edited."""
    root = tmp_path
    bench = root / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec_json = json.load(f)
    src = spec_json["workloads"][0]
    conf = [c for c in spec_json["configs"] if c["name"] == src["config"]][0]
    shutil.copy(os.path.join(REPO, conf["file"]),
                bench / "configs" / "new_conf.json")
    shutil.copy(os.path.join(BENCH, "traffic", f"{src['traffic']}.json"),
                bench / "traffic" / "new_mix.json")
    (bench / "metrics" / "new.layer_metric.py").write_text(
        "def read(rec):\n    return rec.get('frames')\n")
    spec_json["configs"].append(dict(conf, name="new_conf",
                                     file="benchmark/configs/new_conf.json"))
    spec_json["workloads"].append(dict(src, name="new_cell",
                                       config="new_conf",
                                       traffic="new_mix"))
    spec_json["per_layer"].append(
        {"name": "new.layer_metric", "unit": "frames", "better": "higher",
         "source": "program_counter", "layer": "Engine",
         "moves": "slam_scans_per_s", "workloads": ["new_cell"]})
    for m in spec_json["end_to_end"]:
        if src["name"] in m.get("workloads", []):
            m["workloads"].append("new_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    cell = spec.cell("new_cell", str(root), str(bench))
    assert cell.config["name"] == conf["name"]
    assert cell.traffic["driver"] == "slam"
    assert spec.driver(cell.traffic).__name__ == "benchmark.drivers.slam"
    assert "new.layer_metric" in [m["name"] for m in cell.per_layer]
    got = spec.read_per_layer([m for m in cell.per_layer
                               if m["name"] == "new.layer_metric"],
                              {"frames": 12}, str(bench))
    assert got == {"new.layer_metric": {"value": 12.0, "unit": "frames"}}


def test_a_reader_that_finds_nothing_is_left_out(bench):
    for m in bench["per_layer"]:
        assert spec.metric_reader(m["name"]).read({}) is None


def test_the_command_names_only_the_benchmarks_files(bench):
    assert bench["command"][0] == "python3"
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith(tuple(p + "/" for p in bench["paths"]))
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.endswith("_torch")
