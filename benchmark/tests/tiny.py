"""A checkout root for the tests: BENCHMARK.json, the traffic mixes, the
drivers and the metric readers as the benchmark has them, and each cell
cut to a size a CPU test run holds."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

from benchmark import generate

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

# nodes of each configuration in a test
TINY_NODES = {"k8s-5k-basic": 37, "k8s-5k-spread": 50}
# replicas of each traffic mix's workloads in a test, in their order
TINY_REPLICAS = {"capacity-plan": [1500], "spread-rollout": [50, 60]}


def manifest() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    conf = next(c for c in manifest()["configs"] if c["name"] == name)
    with open(REPO / conf["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def instance(config_name: str, traffic_name: str, nodes: int, replicas, seed: int = 11,
             index: int = 0) -> generate.Instance:
    """A request of the named configuration and traffic mix at `nodes`
    nodes and `replicas` a workload."""
    cfg, mix = config(config_name), traffic(traffic_name)
    cfg["nodes"] = nodes
    for w, r in zip(mix["workloads"], replicas):
        w["replicas"] = r
    return generate.make_instance(cfg, mix, seed, index)


def make_root(where) -> str:
    root = Path(where)
    for sub in ("metrics", "traffic", "drivers"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "configs").mkdir(parents=True)
    man = manifest()
    for conf in man["configs"]:
        cfg = config(conf["name"])
        cfg["nodes"] = TINY_NODES[conf["name"]]
        with open(root / conf["file"], "w") as f:
            json.dump(cfg, f)
    for name, replicas in TINY_REPLICAS.items():
        mix = traffic(name)
        for w, r in zip(mix["workloads"], replicas):
            w["replicas"] = r
        with open(root / "benchmark" / "traffic" / f"{name}.json", "w") as f:
            json.dump(mix, f)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(man, f)
    return os.fspath(root)


def argv(workload: str, seconds: float = 0.5, trace: int = 0, seed: int = 2**31 + 77) -> list:
    return ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]


def result_line(stdout: str) -> dict:
    lines = [line for line in stdout.splitlines() if line.strip()]
    return json.loads(lines[-1])
