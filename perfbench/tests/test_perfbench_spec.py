"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by name."""

import json

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_names_units_and_sizes_follow_the_rules():
    assert spec.problems(BENCH) == []
    assert set(BENCH) == KEYS["top"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert set(entry) <= KEYS[group], entry["name"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    # every cell that a per-layer metric lists reports the metric it moves
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]
                                  if spec.reports(e, w)}, (m["name"], w)
    configs = {w["config"] for w in BENCH["workloads"]}
    assert configs == {c["name"] for c in BENCH["configs"]}


def test_command_names_only_files_under_paths():
    assert BENCH["command"][:3] == ["python3", "-m", "perfbench.run"]
    assert BENCH["paths"] == ["perfbench"]


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = spec.cell(workload, BENCH)
    assert cell["chips"] == 1
    for part in ("setup", "window", "measures", "readings", "control",
                 "faults"):
        assert callable(getattr(cell["loop"], part)), part
    assert isinstance(cell["loop"].TEST_ROWS, bool)
    assert callable(cell["program"].Program)
    assert callable(cell["reference"].build)
    assert cell["config"]["name"] == cell["workload"]["config"]
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    assert cell["limits"] is not None, "limits/<workload>.json"
    for name, lim in cell["limits"].items():
        assert lim["lower"] <= lim["limit"] < lim["upper"], name


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_states_its_source_and_cuts(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    cfg = json.load(open(spec.REPO / entry["file"]))
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["assumed"] and cfg["precision"]
    assert (spec.HERE / "reference" / f"{cfg['reference']}.py").exists()


def test_parts_are_found_by_the_names_in_the_files(monkeypatch):
    # a mix or a configuration that names a part with no file is refused
    with pytest.raises(SystemExit):
        spec.load_part("loops", "no_such_loop")
    with pytest.raises(SystemExit):
        spec.load_part("programs", "../run")
    cell = spec.cell("taobao.pretrain", BENCH)
    assert cell["loop"].__name__ == "perfbench.loops.train_steps"
    assert cell["program"].__name__ == "perfbench.programs.ragraph_edge"
    assert cell["reference"].__name__ == "perfbench.reference.edge"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads(metric):
    assert callable(spec.load_metric(metric).read)
