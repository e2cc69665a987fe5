"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each cell finds by name, which cells report which metrics, and the
time a full check of 24 cells would take."""
import json
import pathlib
import re

import pytest

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [c["name"] for c in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]


def test_names_and_units():
    names = ([m["name"] for m in METRICS] + CELLS
             + [c["name"] for c in MANIFEST["configs"]]
             + [c["traffic"] for c in MANIFEST["workloads"]])
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)


def test_entry_keys_and_text_fields():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    texts = ([w["why"] for w in MANIFEST["workloads"]]
             + [c["why"] for c in MANIFEST["configs"]]
             + [c["source"] for c in MANIFEST["configs"]]
             + [m["layer"] for m in MANIFEST["per_layer"]])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_finds_its_files_by_name():
    for cell in CELLS:
        spec = harness.cell_spec(cell)
        assert spec["config"]["name"] == spec["cell"]["config"]
        assert spec["traffic"]["name"] == spec["cell"]["traffic"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(harness.load_reader(m["name"])), m["name"]


def test_each_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert used == {c["name"] for c in MANIFEST["configs"]}
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("bench/") and (ROOT / f).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_layer(cell):
    spec = harness.cell_spec(cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_moves_names_an_end_to_end_metric_of_each_listed_cell():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in target.get("workloads", CELLS), (m["name"], cell)


def test_one_layer_name_per_layer():
    by_metric_stem = {}
    for m in MANIFEST["per_layer"]:
        stem = m["name"].split(".")[0]
        by_metric_stem.setdefault(stem, set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_metric_stem.values())


def test_a_full_check_of_24_cells_fits():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_manifest_is_small():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader_of_its_own(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    assert path.is_file()
    assert callable(harness.load_reader(name))


def test_every_reader_is_a_metric():
    names = {m["name"] for m in METRICS}
    files = {f.name[:-3] for f in (ROOT / "bench" / "metrics").glob("*.py")}
    assert files == names


def test_every_traffic_file_is_used_in_a_mode_the_harness_drives():
    used = {w["traffic"] for w in MANIFEST["workloads"]}
    for f in (ROOT / "bench" / "traffic").glob("*.json"):
        traffic = json.loads(f.read_text())
        assert traffic["name"] == f.stem
        assert traffic["name"] in used, f.name
        assert traffic["mode"] == "closed_batch"


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell_spec("no-such-cell")
