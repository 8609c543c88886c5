"""BENCHMARK.json against the benchmark's contract, and finding a cell's
parts by name, a new cell added as files in a copy too."""
import json
import re

import pytest

from benchmark.harness.spec import Bench
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_units_and_keys(key):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[key]
    names = [e["name"] for e in SPEC[key]]
    assert len(names) == len(set(names))
    for e in SPEC[key]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_parts():
    bench = Bench(ROOT)
    chips = [w["chips"] for w in SPEC["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.chips == w["chips"]
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        driver = bench.driver(cell)
        assert hasattr(driver, "Driver") and hasattr(driver, "control")
        assert driver.FAULTS
        for m in cell.per_layer:
            assert callable(bench.reader(m["name"]).read)
            assert m["moves"] in names
        assert cell.limits


def test_configs_name_their_reductions():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert set(c["reduced"]) <= set(cfg["published"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key in cfg


def test_a_new_cell_is_found_from_files_alone(small_root, tmp_path):
    """A later change adds a traffic mix, a cell, its limits and a metric
    as new files and entries: the harness finds them by name."""
    import shutil
    root = tmp_path / "root"
    shutil.copytree(small_root, root)
    b = root / "benchmark"
    traffic = json.loads((b / "workloads" / "stream-480-b16.json")
                         .read_text())
    traffic["batch_size"] = 3
    (b / "workloads" / "stream-extra.json").write_text(json.dumps(traffic))
    (b / "limits" / "seg-stream-extra.json").write_text(
        json.dumps({"label_far": 0.008}))
    (b / "metrics" / "frames_seen.extra.py").write_text(
        "def read(r):\n    return r.window.work.get('frames')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "seg-stream-extra",
                              "config": "dinoseg-vits8-3blk",
                              "traffic": "stream-extra", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "frames_seen.extra", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "api", "moves": "frames_per_s",
                              "workloads": ["seg-stream-extra"]})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("seg-stream-extra")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root)
    cell = bench.cell("seg-stream-extra")
    assert cell.traffic["batch_size"] == 3
    assert cell.config["depth"] == 1
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.extra"]
    assert bench.driver(cell).Driver
    assert bench.reader("frames_seen.extra").read
