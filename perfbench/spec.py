"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each part is a file of its own, found by name, so that a later change adds a
cell, a configuration, a mix, a loop, a program, a reference or a metric by
adding files and entries:

- ``configs/<file>``: the configuration's sizes, knobs and assumptions, as
  the ``configs`` entry's ``file`` names it; its ``model`` names the
  program and its ``reference`` the plain reference;
- ``mixes/<traffic>.json``: the parameters of the traffic mix (the phase
  and the loop that drives it), read by the one generator in
  :mod:`perfbench.traffic`;
- ``loops/<loop>.py``: the loop a mix names: its set-up, its window, the
  end-to-end measures of a window, the numbers it compares with the
  reference, the control and the faults it can have;
- ``programs/<model>.py``: the program under test, built for a cell;
- ``reference/<reference>.py``: the plain reference;
- ``metrics/<metric>.py``: a per-layer metric's reader (one reader may
  serve ``<metric>.<suffix>`` names, see :func:`load_metric`);
- ``limits/<workload>.json``: the limits that decide ``correct``, each with
  the readings it was set from.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<name up to its first dot>.py``, so that one reader
    serves a quantity split by the end-to-end metric it moves
    (``idle_share.eval``, ``idle_share.finetune``). Loaded by path, since
    a name may hold dots."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_part(kind: str, name: str):
    """Module ``perfbench.<kind>.<name>``: a loop, a program or a
    reference, by the name a mix or a configuration gives."""
    if not name.isidentifier():
        raise SystemExit(f"bad {kind} name {name!r}")
    if not (HERE / kind / f"{name}.py").exists():
        raise SystemExit(f"no {kind}/{name}.py in perfbench")
    return importlib.import_module(f"perfbench.{kind}.{name}")


def reports(metric: dict, workload: str) -> bool:
    """Whether a cell reports a metric: the metric lists the cell, or lists
    no cells at all."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: dict | None = None) -> dict:
    """Everything the harness needs to run cell ``workload``."""
    bench = bench or load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(by_name)})")
    w = by_name[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(REPO / conf_entry["file"])
    mix = _load_json(HERE / "mixes" / f"{w['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = _load_json(limits_path) if limits_path.exists() else None
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload) and m["moves"] in moved]
    return {"workload": w, "config": config, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer,
            "chips": int(w["chips"]),
            "loop": load_part("loops", mix["loop"]),
            "program": load_part("programs", config["model"]),
            "reference": load_part("reference", config["reference"])}


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the naming and size rules (empty when
    none)."""
    out = []

    def need(ok, what):
        if not ok:
            out.append(what)

    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            need(NAME.match(e["name"]), f"{group}: bad name {e['name']!r}")
            names.setdefault(group, []).append(e["name"])
            for key in ("why", "layer"):
                if key in e:
                    v = e[key]
                    need(0 < len(v) <= 200 and "\n" not in v
                         and "\t" not in v, f"{group} {e['name']}: bad {key}")
    metric_names = names["end_to_end"] + names["per_layer"]
    need(len(set(metric_names)) == len(metric_names), "duplicate metric")
    for group in ("configs", "workloads"):
        need(len(set(names[group])) == len(names[group]),
             f"duplicate {group}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        need(UNIT.match(m["unit"]), f"{m['name']}: bad unit {m['unit']!r}")
        need(m["better"] in ("lower", "higher"), f"{m['name']}: better")
    for c in bench["configs"]:
        need(0 < len(c["source"]) <= 200, f"{c['name']}: source")
        need(len(c["reduced"]) <= 16 and all(NAME.match(k)
                                             for k in c["reduced"]),
             f"{c['name']}: reduced")
        need(PATH.match(c["file"]) and any(
            c["file"].startswith(p.rstrip("/") + "/")
            for p in bench["paths"]), f"{c['name']}: file not under paths")
    for w in bench["workloads"]:
        need(NAME.match(w["config"]) and NAME.match(w["traffic"]),
             f"{w['name']}: config or traffic name")
        need(w["config"] in names["configs"], f"{w['name']}: no config")
        need(w["chips"] in (1, 4), f"{w['name']}: chips")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    need(len(set(pairs)) == len(pairs), "a (config, traffic) pair repeats")
    for p in bench["paths"]:
        need(PATH.match(p) and not p.startswith("/") and ".." not in p,
             f"bad path {p!r}")
    need(isinstance(bench["run_seconds"], int)
         and 1 <= bench["run_seconds"] <= 51, "run_seconds")
    need(len(bench["command"]) <= 32, "command too long")
    return out
