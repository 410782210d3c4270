"""BENCHMARK.json keeps to the contract's form, and every name in it
finds its file: configuration, traffic mix, check limits, metric
reader, and the reference and counts modules that a configuration
names. Nothing here knows a model: what is the model's is asked of the
modules its configuration names."""

import json
import re

from s2t_bench.cell import PACKAGE, ROOT, load_cell
from s2t_bench.tests.tiny import benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    b = benchmark()
    assert set(b) == KEYS
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    # a full check of 24 cells fits the driver's 43200 s
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert b["paths"] == ["s2t_bench"]


def test_names_and_units():
    b = benchmark()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line(w["why"])
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16 and line(c["source"])


def test_entries_have_exactly_their_keys():
    b = benchmark()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])


def test_every_name_finds_its_files():
    b = benchmark()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        meta = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"s2t_bench/configs/{c['name']}.json"
        assert meta["name"] == c["name"] and meta["source"] == c["source"]
        assert sorted(meta["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        assert (PACKAGE / "traffic" / f"{w['traffic']}.json").exists()
        assert (PACKAGE / "checks" / f"{w['name']}.json").exists()
    for m in b["per_layer"]:
        assert (PACKAGE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough():
    b = benchmark()
    for w in b["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in b["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in b["per_layer"])


def test_labels_lie_in_the_vocabulary():
    """Each cell's mix draws token ids that its model takes, as the
    reference module that its configuration names judges them
    (`check_traffic`: for the flagship, ids in the predictor's and the
    joiner's vocabulary, blank (0) excluded)."""
    for w in benchmark()["workloads"]:
        cell = load_cell(w["name"], ROOT / "BENCHMARK.json")
        cell.part("reference").check_traffic(cell.train_config,
                                             cell.traffic_spec)


def test_every_configuration_names_its_modules():
    """Each cell's configuration names a reference module that takes it
    and its mix, and a counts module, as a run finds them before set-up."""
    for w in benchmark()["workloads"]:
        cell = load_cell(w["name"], ROOT / "BENCHMARK.json")
        assert cell.reference().__name__ == \
            f"s2t_bench.reference.{cell.meta['reference']}"
        assert cell.part("counts").__name__ == \
            f"s2t_bench.counts.{cell.meta['counts']}"
