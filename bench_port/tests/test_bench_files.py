"""Every file of the benchmark parses and keeps to the names the benchmark
contract allows; BENCHMARK.json and the files it names agree."""

import json
import re

import pytest

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json"))
CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))
METRICS = sorted(p.stem for p in (harness.HERE / "metrics").glob("*.py"))


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", WORKLOADS)
def test_workload_file(cell):
    w = harness.workload_spec(cell)
    assert w["name"] == cell and NAME.match(cell)
    listed = {x["name"]: x for x in BENCH["workloads"]}
    assert cell in listed, f"{cell} has a file but no entry in BENCHMARK.json"
    entry = listed[cell]
    assert entry["config"] == w["config"] and entry["chips"] == w["chips"]
    assert entry["traffic"] == w["traffic"]["name"] and entry["why"] == w["why"]
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert (harness.HERE / "entries" / f"{w['entry']}.py").exists()
    assert w["config"] in CONFIGS
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())
    e2e, layer = harness.cell_metrics(BENCH, cell)
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and layer


@pytest.mark.parametrize("config", CONFIGS)
def test_config_file(config):
    c = harness.config_spec(config)
    entry = {x["name"]: x for x in BENCH["configs"]}[config]
    assert entry["file"] == f"bench_port/configs/{config}.json"
    assert entry["source"] == c["source"] and entry["reduced"] == c["reduced"]
    for sec in ("net", "render", "camera"):
        assert c[sec]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader(metric):
    names = {m["name"] for m in BENCH["per_layer"]}
    assert metric in names, f"metrics/{metric}.py names no per-layer metric"
    reader = harness.metric_reader(metric)
    assert callable(reader.read) and reader.__doc__


def test_every_per_layer_metric_has_a_reader():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["name"] in METRICS and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in WORKLOADS
