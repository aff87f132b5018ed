"""A cell at smoke width run end to end on the CPU (the port's plain
versions), added from new files alone: its configuration, its mix and its
``BENCHMARK.json`` entry."""
import math

import tiny
from ragbench import spec
from ragbench.bench import run_cell

SEED = 2**31 + 11


def test_tiny_cell_runs_end_to_end(tmp_path):
    cell = tiny.tiny_cell(tmp_path)
    out = run_cell(cell, SEED, 3.0, False, device="cpu")
    assert list(out)[-1] == "check"
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == want
    assert want == {"goodput_rps", "setup_s"}
    for v in out["metrics"].values():
        assert math.isfinite(v["value"]) and v["value"] > 0
    assert out["check"]["logit_gap"]["value"] <= out["check"]["logit_gap"]["limit"]
    assert out["check"]["retrieval_mismatches"]["value"] == 0


def test_traced_run_reports_the_per_layer_metrics_it_can_read(tmp_path):
    cell = tiny.tiny_cell(tmp_path)
    out = run_cell(cell, SEED + 1, 3.0, True, device="cpu")
    assert out["correct"] is True
    names = set(out["metrics"])
    # on the CPU nothing ran on a device: the device-trace readers read nothing
    assert {"ttft_p50_ms", "ttft_p95_ms", "arrival_lag_p99_ms", "prefix_hit_rate.open",
            "tokens_per_step.open", "step_ms.open", "mfu.open"} <= names
    assert not names & {"device_idle.open", "paged_attn_share.open", "retrieval_ms.open"}
    assert names <= {m["name"] for m in cell.per_layer}


def test_a_new_cell_is_found_by_its_names(tmp_path):
    name, bench = tiny.write_cell(tmp_path, popularity="uniform", mix="tiny-uniform")
    # a new per-layer metric: its entry and its reader, a file of its own
    (tmp_path / "ragbench" / "metrics").mkdir(parents=True)
    (tmp_path / "ragbench" / "metrics" / "answers.open.py").write_text(
        "def read(run):\n    return len(run.sent)\n")
    bench["per_layer"].append({"name": "answers.open", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "client loop",
                               "moves": "goodput_rps", "workloads": [name]})
    cell = spec.cell(name, bench=bench, root=tmp_path)
    assert name == "tiny-gqa.tiny-uniform"
    assert cell.model["name"] == "tiny-gqa" and cell.traffic["loop"] == "open"
    assert cell.traffic["corpus"]["popularity"] == "uniform"
    assert "answers.open" in {m["name"] for m in cell.per_layer}
    assert spec.reader("answers.open", root=tmp_path)(type("R", (), {"sent": [1, 2]})) == 2
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "answers.open":
            assert callable(spec.reader(m["name"]))


def test_same_seed_same_requests(tmp_path):
    from ragbench.workload import Traffic

    spec_ = tiny.traffic()
    a, b = Traffic(spec_, SEED, 3.0, 500), Traffic(spec_, SEED, 3.0, 500)
    c = Traffic(spec_, SEED + 1, 3.0, 500)
    key = lambda t: [(p.due, p.max_new, p.query.tolist(), p.docs.tolist()) for p in t.plans]
    assert key(a) == key(b)
    assert key(a) != key(c)
    # the seed orders the mix's sizes over its arrival trace, it does not change them
    assert sorted(p.max_new for p in a.plans) == sorted(p.max_new for p in c.plans)
    assert sorted(len(p.docs) for p in a.plans) == sorted(len(p.docs) for p in c.plans)
    assert [p.due for p in a.plans] == [p.due for p in c.plans]
