"""BENCHMARK.json against the contract's form, and every name in it found
by the harness: configurations, traffic, drivers, limits, metric readers."""

import importlib
import json
import re

import pytest

from gcd_bench.harness import BENCH_DIR, ROOT
from gcd_bench.metrics import reader
from gcd_bench.run import cell_metrics

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["gcd_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    config = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())
    assert importlib.import_module(f"gcd_bench.drivers.{traffic['driver']}").run
    assert limits and all(v > 0 for v in limits.values())
    assert config["model"]["params"]["network_config"]["params"]["model_channels"] == 320
    assert w["chips"] == 1
    e2e = cell_metrics(BENCH, cell, trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert cell_metrics(BENCH, cell, trace=True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(reader(metric))


def test_configs_listed_with_their_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"gcd_bench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert c["source"].startswith("https://")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["name"] in {x["name"] for x in cell_metrics(BENCH, cell, trace=True)}
            assert m["moves"] in {x["name"] for x in cell_metrics(BENCH, cell, trace=False)}
