"""The basic-whatif cell at a CPU test's size: a whole run through the
port's daemon in the harness's process, correct and exiting by itself;
its two controls not correct; and the scenario scan's frozen bound at a
hand-counted shape.

The cell's configuration and traffic mix are cut here, at import, for
`tiny.make_root`: 60 nodes holding 1,800 committed pods (30 a node, as
at the cell's size) and what-ifs of 5 replicas."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import cells, check_whatif, generate
from benchmark.cost import scenario_scan
from benchmark.reference import control_whatif
from benchmark.tests import tiny

tiny.TINY_NODES.setdefault("k8s-5k-serve", 60)
tiny.TINY_REPLICAS.setdefault("whatif-16", [5])
TINY_COMMITTED = 1800


@pytest.fixture
def whatif_root(tiny_root):
    path = Path(tiny_root, "benchmark", "configs", "k8s-5k-serve.json")
    cfg = json.loads(path.read_text())
    cfg["committed"]["replicas"] = TINY_COMMITTED
    path.write_text(json.dumps(cfg))
    return tiny_root


def _run(root, trace: int, seed: int) -> subprocess.CompletedProcess:
    code = ("import sys\nfrom benchmark import run\n"
            f"sys.exit(run.main({tiny.argv('basic-whatif', seconds=1.0, trace=trace, seed=seed)!r},"
            f" root={root!r}, device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=os.fspath(tiny.REPO))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("trace,seed", [(0, 2**31 + 77), (1, 5_000_000_017)])
def test_whole_run_is_correct_and_exits_by_itself(whatif_root, trace, seed):
    proc = _run(whatif_root, trace, seed)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = tiny.result_line(proc.stdout)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1, line
    assert set(line["checks"]) == set(check_whatif.LIMITS) | {"failed_requests"}
    # the daemon stopped by drain once the window closed
    assert "whatif_latency_ms: " in proc.stderr
    if trace:
        # no card: the device's metrics are left out, the program's read
        assert {"serve_encode_ms.whatif", "serve_scan_ms.whatif", "serve_replay_ms.whatif",
                "serve_payload_ms.whatif", "serve_unattributed_ms.whatif",
                "scan_launches_per_round.whatif"} <= set(line["metrics"])
        assert "scenario_roofline.whatif" not in line["metrics"]
        assert "device_idle_pct.deploy" not in line["metrics"]
        assert line["metrics"]["scan_launches_per_round.whatif"]["value"] >= 1
    else:
        assert set(line["metrics"]) == {"deploy_pods_per_s", "setup_s"}
        # 16 what-ifs of 5 pods a round
        rounds = line["attempted"]
        assert line["metrics"]["deploy_pods_per_s"]["value"] > 0 and rounds >= 1


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
@pytest.mark.parametrize("variant,number", [("shared", "misplaced_pods"),
                                            ("tie_last", "misplaced_pods")])
def test_controls_are_not_correct(whatif_root, variant, number, seed):
    cell = cells.load_cell(whatif_root, "basic-whatif")
    nums = control_whatif.readings(cell, seed, variant)
    assert nums[number] > 0, nums
    assert any(nums[k] > lim for k, lim in check_whatif.LIMITS.items())


def _cluster(nodes: int, workloads) -> generate.Instance:
    spec = {"cpu": "4", "memory": "32Gi", "pods": "110"}
    return generate.Instance(
        tag="t", namespace="whatif", node_names=[f"n{i}" for i in range(nodes)],
        node_cpu_m=np.full(nodes, 4000), node_mem=np.full(nodes, 32 << 30),
        node_pods=np.full(nodes, 110), tainted=np.zeros(nodes, bool),
        zone=np.arange(nodes) % 2, zone_names=["a", "b"], zone_key="zone", taint=None,
        node_spec=spec, new_node_spec=spec, new_node_zone=0, max_new=0,
        workloads=list(workloads))


def test_scenario_scan_bound_at_a_hand_counted_shape():
    """Two rows on 3 nodes: one what-if of 2 plain pods, one of 1 pod
    with a zone spread over its own label (one term row, one hard
    slot)."""
    plain = generate.Workload("a", "Deployment", 2, "100m", "500Mi")
    spread = generate.Workload("b", "Deployment", 1, "100m", "500Mi",
                               spread=[{"key": "zone", "max_skew": 1, "selector": {"app": "b"}}])
    rows = [_cluster(3, [plain]), _cluster(3, [spread])]
    # visits: 2 pods x 50 + 1 pod x (50 + 14 + 12), each over 3 nodes
    assert scenario_scan.launch_ops(rows) == (2 * 50 + 76) * 3 == 528
    nodes_b = 3 * 10 * 8  # capacities, committed state
    class_b = 2 * (6 * 8 + 3 * 33)  # two classes: requests, feasibility and score rows
    row_a = 2 * 9 + (2 * 4 + 6 * 8 * 3)  # masks, classes, pins; placements, final state
    row_b = 1 * 9 + (1 * 3 * 4 + 4 * 8 * 2) + (1 * 4 + 6 * 8 * 3)  # and one term row of 2 zones
    assert scenario_scan.launch_bytes(rows) == nodes_b + class_b + row_a + row_b == 937
    ms, what = scenario_scan.bound(rows)
    assert what == "bytes" and ms == pytest.approx(937 / 3.35e12 * 1e3)
