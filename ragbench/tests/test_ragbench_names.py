"""``BENCHMARK.json`` against the benchmark's contract as far as a file can
show it: names, units and texts of the allowed characters and lengths, the
keys of each entry, the bounds, and every name found as a file."""
import json
import re

import pytest

from ragbench import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
# the issue's five less three, each read as a per-layer metric instead:
# ttft_p95_ms and tpot_p95_ms (as tpot_p95_ms.open), which swing too far
# from run to run for a bound, and tokens_per_s, whose closed-loop cells
# are not in the benchmark yet (PERF.md sections 2, 7)
E2E = ("goodput_rps", "setup_s")


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(text_ok(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_every_name_unit_and_text():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))
        assert all(NAME.match(n) for n in ns)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and text_ok(w["why"])
        assert w["chips"] in (1, 4)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert text_ok(m["layer"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_its_metrics_move():
    assert {m["name"] for m in BENCH["end_to_end"]} == set(E2E)
    per_layer = {m["name"] for m in BENCH["per_layer"]}
    assert {"ttft_p50_ms", "ttft_p95_ms", "tpot_p95_ms.open"} <= per_layer
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    reports = lambda m, c: "workloads" not in m or c in m["workloads"]
    for c in cells:
        assert reports(e2e["setup_s"], c)
        assert any(reports(m, c) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, c) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], c), (m["name"], c)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_s_files_are_found_by_name(cell):
    c = spec.cell(cell)
    assert c.model["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["loop"] == "open"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    for f in (spec.HERE / "metrics").glob("*.py"):
        assert NAME.match(f.name[:-3])
