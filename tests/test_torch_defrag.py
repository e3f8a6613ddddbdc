"""The GPU port's pod-migration planner (`parallel/defrag.py`
plan_defrag: every drain depth one scenario of one batch launch; here
the batch kernel's plain version on the CPU) against the JAX package's,
exactly: the drain order, the unscheduled count of every depth, the
chosen depth, the drained nodes and every move. Also the snapshot file
of `apply --snapshot` and `simon defrag`'s JSON and table output,
byte-identical to the JAX CLI's.

Cases: the testing.py fixtures, bench.py's defrag shape (its run_defrag:
32 cpu nodes in 16 zones, the default scenario's pods without a
nodeSelector at six a node, max_drain 16) cut to 64 nodes, a snapshot
with daemonset pods, protected new nodes, and a batch with a custom
score plugin (its depths on the torch scan)."""

import contextlib
import copy
import importlib
import io
import json

import numpy as np
import pytest

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.testing import make_fake_node, make_fake_pod, with_node_labels
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.ops import fused_scan
from open_simulator_tpu_torch.utils.trace import GLOBAL

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _snapshot(pkg, nodes, placed, unscheduled=()):
    """A SimulateResult of `pkg` with `placed` {node index: [pods]}."""
    core = _mod(pkg, "scheduler.core")
    statuses = [core.NodeStatus(node=copy.deepcopy(n), pods=[]) for n in nodes]
    for i, pods in placed.items():
        for pod in pods:
            pod = copy.deepcopy(pod)
            pod["spec"]["nodeName"] = nodes[i]["metadata"]["name"]
            pod.setdefault("status", {})["phase"] = "Running"
            statuses[i].pods.append(pod)
    return core.SimulateResult(unscheduled_pods=list(unscheduled), node_status=statuses)


def _view(res):
    return (res.ranked_nodes, res.depths, [int(x) for x in res.unscheduled],
            res.chosen_depth, res.drained_nodes,
            [((m.pod.get("metadata") or {}).get("name"), m.from_node, m.to_node)
             for m in res.moves],
            None if res.result is None else [
                (ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
                for ns in res.result.node_status])


def _both(nodes, placed, **kw):
    out = []
    for pkg in PKGS:
        extra = {"device": "cpu"} if pkg.endswith("torch") else {}
        res = _mod(pkg, "parallel.defrag").plan_defrag(_snapshot(pkg, nodes, placed),
                                                       **kw, **extra)
        out.append(_view(res))
    return out


def _fixture_cluster():
    """testing.py fixtures: six 8-cpu nodes, three of them lightly
    used, pods of 1-3 cpu."""
    nodes = [make_fake_node(f"node-{i}", "8", "32Gi", with_node_labels({"zone": f"z{i % 2}"}))
             for i in range(6)]
    rng = np.random.RandomState(4)
    placed = {}
    for i in range(6):
        k = 1 if i % 2 else 4
        placed[i] = [make_fake_pod(f"p-{i}-{j}", "default", str(1 + rng.randint(3)), "2Gi")
                     for j in range(k)]
    return nodes, placed


def _bench_shape(n_nodes=64, per_node=6):
    """bench.py run_defrag at n_nodes: 32 cpu / 128 GiB nodes in 16
    zones, the default scenario's four nodeSelector-free pod classes
    dealt round-robin at `per_node` a node."""
    nodes = [make_fake_node(f"node-{i:05d}", "32", "128Gi",
                            with_node_labels({"zone": f"z{i % 16}"})) for i in range(n_nodes)]
    classes = [("small", "250m", "512Mi", False), ("medium", "1", "2Gi", False),
               ("large", "4", "8Gi", False), ("tolerant", "2", "4Gi", True)]
    placed = {i: [] for i in range(n_nodes)}
    for p in range(n_nodes * per_node):
        name, cpu, mem, tol = classes[p % len(classes)]
        pod = make_fake_pod(f"pod-{p:06d}", "bench", cpu, mem)
        if tol:
            pod["spec"]["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        placed[p % n_nodes].append(pod)
    return nodes, placed


def test_plan_defrag_equals_jax_on_the_fixtures():
    nodes, placed = _fixture_cluster()
    want, got = _both(nodes, placed)
    assert got == want
    assert got[3] >= 1 and got[5]  # drains something, with moves
    want, got = _both(nodes, placed, max_drain=2)
    assert got == want


def test_plan_defrag_equals_jax_on_the_bench_shape():
    nodes, placed = _bench_shape()
    GLOBAL.reset()
    launches = dict(fused_scan.LAUNCHES)
    want, got = _both(nodes, placed, max_drain=16)
    assert got == want
    assert GLOBAL.notes["defrag-kernel"] == f"{fused_scan.BATCH_KERNEL_NAME} (cpu)"
    assert fused_scan.LAUNCHES == launches  # the plain version counts no launch
    assert len(got[2]) == 17 and got[3] >= 1


def test_plan_defrag_daemonsets_and_protected_nodes():
    nodes, placed = _fixture_cluster()
    for i in placed:
        ds = make_fake_pod(f"agent-{i}", "kube-system", "100m", "64Mi")
        ds["metadata"]["ownerReferences"] = [{"kind": "DaemonSet", "name": "agent"}]
        placed[i].append(ds)
    nodes[1]["metadata"]["labels"]["simon/new-node"] = ""

    def protect(node):
        return "simon/new-node" in node["metadata"]["labels"]

    want, got = _both(nodes, placed, protect=protect)
    assert got == want and "node-1" not in got[0]


def test_plan_defrag_custom_plugin_depths_on_the_torch_scan():
    from tests.test_torch_apply import _name_plugin

    regs = [_mod(pkg, "scheduler.plugins").default_registry for pkg in PKGS]
    for pkg, reg in zip(PKGS, regs):
        reg.clear()
        reg.register(_name_plugin(pkg, 3))
    try:
        nodes, placed = _fixture_cluster()
        GLOBAL.reset()
        want, got = _both(nodes, placed)
        assert got == want
        assert GLOBAL.notes["defrag-kernel"] == "torch-scan (custom score plugins)"
    finally:
        for reg in regs:
            reg.clear()


def _cli(main, reset, argv):
    reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("cfg", ["example/simon-config.yaml",
                                 "example/simon-gpushare-config.yaml"])
def test_snapshot_and_defrag_cli_are_byte_identical(cfg, tmp_path):
    jsnap, psnap = tmp_path / "j.json", tmp_path / "p.json"
    base = ["apply", "-f", cfg, "--format", "json"]
    want = _cli(jax_cli.main, jax_reset, base + ["--snapshot", str(jsnap)])
    got = _cli(port_cli.main, port_reset, base + ["--snapshot", str(psnap), "--device", "cpu"])
    assert got == want
    assert psnap.read_bytes() == jsnap.read_bytes()
    assert json.loads(psnap.read_text())["version"] == 1
    for flags in ([], ["--max-drain", "1"], ["--keep-new-nodes"]):
        for fmt in (["--format", "json"], []):
            argv = ["defrag", "--snapshot", str(psnap), *flags, *fmt]
            assert _cli(port_cli.main, port_reset, argv + ["--device", "cpu"]) == \
                _cli(jax_cli.main, jax_reset, argv)


def test_defrag_cli_with_moves_is_byte_identical(tmp_path):
    """A snapshot whose drain needs migrations (the fixtures), through
    the port's snapshot writer: JSON and table equal the JAX CLI's."""
    nodes, placed = _fixture_cluster()
    path = tmp_path / "snap.json"
    _mod("open_simulator_tpu_torch", "scheduler.snapshot").save_snapshot(
        _snapshot("open_simulator_tpu_torch", nodes, placed), str(path))
    for fmt in (["--format", "json"], []):
        argv = ["defrag", "--snapshot", str(path), *fmt]
        got = _cli(port_cli.main, port_reset, argv + ["--device", "cpu"])
        assert got == _cli(jax_cli.main, jax_reset, argv)
    doc = json.loads(_cli(port_cli.main, port_reset, [
        "defrag", "--snapshot", str(path), "--format", "json", "--device", "cpu"])[1])
    assert doc["moves"] and doc["chosenDepth"] >= 1


def test_snapshot_round_trip_and_cluster_from_snapshot(tmp_path):
    """load_snapshot(save_snapshot(r)) re-attaches every pod to its node,
    and cluster_from_snapshot keeps the running non-daemonset pods, as
    the JAX package's does."""
    nodes, placed = _fixture_cluster()
    placed[0][0]["metadata"]["ownerReferences"] = [{"kind": "DaemonSet", "name": "x"}]
    views = []
    for pkg in PKGS:
        snap = _mod(pkg, "scheduler.snapshot")
        path = tmp_path / f"{pkg}.json"
        snap.save_snapshot(_snapshot(pkg, nodes, placed), str(path))
        back = snap.load_snapshot(str(path))
        res = snap.cluster_from_snapshot(back)
        views.append(([(ns.node["metadata"]["name"], len(ns.pods)) for ns in back.node_status],
                      [p["metadata"]["name"] for p in res.pods]))
    assert views[0] == views[1]
    assert (tmp_path / f"{PKGS[0]}.json").read_bytes() == \
        (tmp_path / f"{PKGS[1]}.json").read_bytes()
