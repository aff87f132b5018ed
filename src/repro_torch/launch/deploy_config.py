"""Deployment configuration: declarative cluster + engine + app spec.

A deployment is described by a JSON file (the 'real config system'
deliverable — JSON to stay inside the offline dependency set):

    {
      "app": "crag",
      "engine": {"name": "patchwork", "scheduler": "edf_slack",
                 "autoscale": true, "reallocate_period_s": 10.0},
      "cluster": {"nodes": 4, "node": {"cpu": 32, "gpu": 8, "ram": 256}},
      "budgets": {"GPU": 32, "CPU": 256, "RAM": 1024},
      "slo_s": 2.0,
      "workload": {"rate": 32.0, "duration_s": 30.0, "seed": 0}
    }

    PYTHONPATH=src python -m repro_torch.launch.deploy_config --config deploy.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict

from repro_torch.core.controller import EngineConfig, PatchworkRuntime

DEFAULTS: Dict[str, Any] = {
    "app": "vrag",
    "engine": {"name": "patchwork"},
    "cluster": {"nodes": 4, "node": {"cpu": 32.0, "gpu": 8.0, "ram": 256.0}},
    "budgets": {"GPU": 32, "CPU": 256, "RAM": 1024},
    "slo_s": 2.0,
    "workload": {"rate": 32.0, "duration_s": 30.0, "seed": 0},
}

_ENGINE_FIELDS = {f.name for f in dataclasses.fields(EngineConfig)}


def load_deployment(path_or_dict) -> Dict[str, Any]:
    raw = (
        dict(path_or_dict)
        if isinstance(path_or_dict, dict)
        else json.load(open(path_or_dict))
    )
    cfg = json.loads(json.dumps(DEFAULTS))  # deep copy
    for k, v in raw.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    unknown = set(cfg["engine"]) - _ENGINE_FIELDS
    if unknown:
        raise ValueError(f"unknown engine options: {sorted(unknown)}")
    return cfg


def build_runtime(cfg: Dict[str, Any]) -> PatchworkRuntime:
    from repro_torch.apps import make_app

    engine = EngineConfig(**cfg["engine"])
    app = make_app(cfg["app"])
    return PatchworkRuntime(
        app,
        cfg["budgets"],
        engine=engine,
        n_nodes=int(cfg["cluster"]["nodes"]),
        node_spec=dict(cfg["cluster"]["node"]),
        slo_s=cfg.get("slo_s"),
        seed=int(cfg["workload"].get("seed", 0)),
    )


def run_deployment(path_or_dict):
    from repro_torch.data.workload import make_workload

    cfg = load_deployment(path_or_dict)
    rt = build_runtime(cfg)
    wl = make_workload(
        cfg["workload"]["rate"], cfg["workload"]["duration_s"],
        seed=int(cfg["workload"].get("seed", 0)),
    )
    metrics = rt.run(wl)
    return rt, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    rt, m = run_deployment(args.config)
    print(json.dumps({
        "app": rt.app.name,
        "engine": rt.engine.name,
        "instances": m.instance_counts,
        "goodput_rps": round(m.goodput, 2),
        "p50_ms": round(m.latency_pct(50) * 1e3, 1),
        "p99_ms": round(m.latency_pct(99) * 1e3, 1),
        "slo_violation_pct": round(m.slo_violation_rate * 100, 2),
        "queue_time_share": {
            k: round(v, 3) for k, v in rt.telemetry.queue_time_share().items()
        },
    }, indent=1))


if __name__ == "__main__":
    main()
