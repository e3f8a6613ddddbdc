"""The GPU port's capacity planner (`open_simulator_tpu_torch` cli ->
apply/applier.py -> parallel/sweep.py -> the fused-scan kernels' plain
versions on the CPU) against the JAX package's, exactly:

- `apply --format json --device cpu` prints the same bytes as the JAX
  package's `apply --format json` (its XLA scan on the CPU) on the
  repo's quickstart example/simon-config.yaml (a Helm chart, inter-pod
  anti-affinity and open-local storage), on
  example/simon-gpushare-config.yaml and on small synthetic configs
  where the planner must add nodes (base plan, GPU-share, hostPorts
  plus extended resources, a daemonset, open-local storage with
  anti-affinity, a MaxVG cap that decides the count, a priority
  workload routed to the serial loop, the serial engine);
- the sweep's probes, pairs and many-count batches agree with each
  other and with the JAX sweep;
- without a card the default device exits 2 with the "needs a GPU"
  error, and out-of-slice inputs name their ROADMAP.md item.

Inputs are YAML files made in a temp dir; pod-name counters of both
packages are reset before each run."""

import contextlib
import io
import os

import numpy as np
import pytest
import yaml

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.ops import fused_scan

GPUSHARE = "example/simon-gpushare-config.yaml"
QUICKSTART = "example/simon-config.yaml"
GI = 1 << 30


def _node(name, cpu="4", mem="8Gi", extra=None, gpus=0, taint=False):
    node = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110",
                                   **(extra or {})}},
    }
    if gpus:
        g = {"alibabacloud.com/gpu-count": str(gpus),
             "alibabacloud.com/gpu-mem": f"{16 * gpus}Gi"}
        node["status"]["allocatable"].update(g)
        node["status"]["capacity"] = dict(node["status"]["allocatable"])
    if taint:
        node["spec"] = {"taints": [{"key": "dedicated", "value": "infra",
                                    "effect": "NoSchedule"}]}
    return node


def _deploy(name, replicas, cpu="1", mem="1Gi", requests=None, ports=None,
            annotations=None, priority=None, tolerate=False):
    container = {"name": "c", "image": f"img-{name}",
                 "resources": {"requests": {"cpu": cpu, "memory": mem, **(requests or {})}}}
    if ports:
        container["ports"] = [{"containerPort": p, "hostPort": p, "protocol": "TCP"}
                              for p in ports]
    spec = {"containers": [container]}
    if priority is not None:
        spec["priority"] = priority
    if tolerate:
        spec["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
    # generated pods inherit the owner's annotations (the GPU-share ask)
    meta = {"name": name, "namespace": "cap", "labels": {"app": name}}
    if annotations:
        meta["annotations"] = annotations
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta,
        "spec": {"replicas": replicas, "template": {"spec": spec}},
    }


def _daemonset(name, cpu="200m"):
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": name, "namespace": "kube-system"},
        "spec": {"template": {"spec": {"containers": [{
            "name": "c", "image": "agent",
            "resources": {"requests": {"cpu": cpu, "memory": "128Mi"}}}]}}},
    }


def _config(root, nodes, apps, new_node, cluster_extra=(), chart=False, kube=False,
            files=None):
    """Write a simon Config and its dirs under `root`; returns its path.
    `files` maps paths under `root` to their text (a node's open-local
    storage JSON beside it, for one)."""
    cluster_dir = root / "cluster"
    cluster_dir.mkdir()
    for i, obj in enumerate(list(nodes) + list(cluster_extra)):
        (cluster_dir / f"o{i:03d}.yaml").write_text(yaml.safe_dump(obj))
    app_list = []
    for name, objs in apps:
        d = root / f"app-{name}"
        d.mkdir()
        for i, obj in enumerate(objs):
            (d / f"o{i}.yaml").write_text(yaml.safe_dump(obj))
        app_list.append({"name": name, "path": str(d), **({"chart": True} if chart else {})})
    spec = {"cluster": {"customConfig": str(cluster_dir)}, "appList": app_list}
    if kube:
        kc = root / "kubeconfig"
        kc.write_text("apiVersion: v1\n")
        spec["cluster"] = {"kubeConfig": str(kc)}
    if new_node is not None:
        nn = root / "newnode"
        nn.mkdir()
        (nn / "node.yaml").write_text(yaml.safe_dump(new_node))
        spec["newNode"] = str(nn)
    for rel, text in (files or {}).items():
        (root / rel).write_text(text)
    cfg = root / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"apiVersion": "simon/v1alpha1", "kind": "Config",
                                   "metadata": {"name": "t"}, "spec": spec}))
    return str(cfg)


def _run(main, reset, argv):
    reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(cfg, *flags, port_flags=("--device", "cpu")):
    """(rc, stdout) of the JAX CLI and of the port's, same flags."""
    argv = ["apply", "-f", cfg, *flags]
    j = _run(jax_cli.main, jax_reset, argv)
    p = _run(port_cli.main, port_reset, argv + list(port_flags))
    return j[:2], p[:2]


def _synthetic(kind):
    """(nodes, apps, new_node, cluster extras) of one planner case."""
    if kind == "base":
        nodes = [_node(f"n{i}", taint=i == 0) for i in range(3)]
        apps = [("web", [_deploy("web", 14), _deploy("tol", 3, cpu="500m", tolerate=True)])]
        return nodes, apps, _node("template", cpu="4"), []
    if kind == "gpushare":
        nodes = [_node(f"g{i}", cpu="16", mem="64Gi", gpus=2) for i in range(2)]
        gpu = {"alibabacloud.com/gpu-mem": "8Gi", "alibabacloud.com/gpu-count": "1"}
        gpu2 = {"alibabacloud.com/gpu-mem": "12Gi", "alibabacloud.com/gpu-count": "2"}
        apps = [("train", [_deploy("small", 9, annotations=gpu),
                           _deploy("pair", 3, annotations=gpu2)])]
        return nodes, apps, _node("template", cpu="16", mem="64Gi", gpus=2), []
    if kind == "ports-scalars":
        accel = {"example.com/accel": "2"}
        nodes = [_node(f"n{i}", cpu="8", mem="16Gi", extra=accel) for i in range(2)]
        apps = [("svc", [_deploy("svc", 5, cpu="500m", ports=[8080]),
                         _deploy("acc", 7, cpu="500m", requests={"example.com/accel": "1"}),
                         _deploy("plain", 4)])]
        return nodes, apps, _node("template", cpu="8", mem="16Gi", extra=accel), []
    if kind == "daemonset":
        nodes = [_node(f"n{i}") for i in range(2)]
        apps = [("web", [_deploy("web", 12)])]
        return nodes, apps, _node("template"), [_daemonset("agent")]
    if kind == "storage-anti":
        return _storage_case(vg_gi=20, anti=True, replicas=5)
    if kind == "priority":
        nodes = [_node(f"n{i}") for i in range(2)]
        apps = [("web", [_deploy("web", 9, priority=100), _deploy("lo", 4, priority=1)])]
        return nodes, apps, _node("template"), []
    raise KeyError(kind)


_SC_LVM = {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
           "metadata": {"name": "open-local-lvm"}, "provisioner": "local.csi.aliyun.com",
           "parameters": {"volumeType": "LVM"}, "volumeBindingMode": "WaitForFirstConsumer"}


def _storage_json(vg_gi):
    import json

    return json.dumps({"vgs": [{"name": "pool", "capacity": str(vg_gi * GI),
                                "requested": "0"}], "devices": []})


def _storage_case(vg_gi, anti, replicas):
    """Two nodes with one `vg_gi` GiB VG each, a StatefulSet of open-local
    LVM volumeClaimTemplates (8 GiB), with or without hostname
    anti-affinity, and a Deployment; the new node has the same VG. The
    storage JSON files ride in the cluster and new-node dirs."""
    nodes = [_node(f"n{i}") for i in range(2)]
    spec = {"containers": [{"name": "kv", "image": "kv",
                            "resources": {"requests": {"cpu": "500m", "memory": "1Gi"}}}]}
    if anti:
        spec["affinity"] = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "kv"}},
             "topologyKey": "kubernetes.io/hostname"}]}}
    sts = {"apiVersion": "apps/v1", "kind": "StatefulSet",
           "metadata": {"name": "kv", "namespace": "cap", "labels": {"app": "kv"}},
           "spec": {"replicas": replicas, "serviceName": "kv",
                    "selector": {"matchLabels": {"app": "kv"}},
                    "template": {"metadata": {"labels": {"app": "kv"}}, "spec": spec},
                    "volumeClaimTemplates": [{"metadata": {"name": "data"}, "spec": {
                        "accessModes": ["ReadWriteOnce"], "storageClassName": "open-local-lvm",
                        "resources": {"requests": {"storage": "8Gi"}}}}]}}
    apps = [("kv", [sts, _deploy("web", 3, cpu="500m")])]
    files = {f"cluster/n{i}.json": _storage_json(vg_gi) for i in range(2)}
    files["newnode/template.json"] = _storage_json(vg_gi)
    return nodes, apps, _node("template"), [_SC_LVM], files


def test_quickstart_json_is_byte_identical():
    """The repo's quickstart: a Helm chart, a StatefulSet with pod
    anti-affinity, plain YAML apps and open-local LVM volumes on the
    demo cluster; the planner adds one node."""
    (jrc, jout), (prc, pout) = _both(QUICKSTART, "--format", "json")
    assert jrc == prc == 0
    assert pout == jout
    import json

    doc = json.loads(pout)
    assert doc["success"] and doc["newNodeCount"] == 1
    assert not doc["unscheduledPods"]


def test_gpushare_example_json_is_byte_identical():
    (jrc, jout), (prc, pout) = _both(GPUSHARE, "--format", "json")
    assert jrc == prc == 0
    assert pout == jout
    import json

    doc = json.loads(pout)
    assert doc["success"] and doc["newNodeCount"] == 0
    placed = [n for n in doc["nodes"] if n["pods"]]
    assert sum(len(n["pods"]) for n in placed) == 7 and len(placed) == 2


def test_gpushare_example_table_is_identical():
    (jrc, jout), (prc, pout) = _both(GPUSHARE, "--extended-resources", "gpu")
    assert jrc == prc == 0 and pout == jout
    assert "GPU Node Resource" in pout


@pytest.mark.parametrize("kind", ["base", "gpushare", "ports-scalars", "daemonset",
                                  "priority", "storage-anti"])
def test_synthetic_plan_json_is_byte_identical(kind, tmp_path):
    nodes, apps, new_node, extra, *files = _synthetic(kind)
    cfg = _config(tmp_path, nodes, apps, new_node, extra, files=files[0] if files else None)
    (jrc, jout), (prc, pout) = _both(cfg, "--format", "json")
    assert (prc, pout) == (jrc, jout)
    import json

    doc = json.loads(pout)
    assert doc["success"] and doc["newNodeCount"] > 0, doc["message"]


def test_priority_workload_takes_the_serial_route(tmp_path):
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    nodes, apps, new_node, extra = _synthetic("priority")
    cfg = _config(tmp_path, nodes, apps, new_node, extra)
    rc, _, err = _run(port_cli.main, port_reset,
                      ["apply", "-f", cfg, "--device", "cpu", "--trace"])
    assert rc == 0
    assert "priority" in GLOBAL.notes.get("apply-serial-route", "")
    assert "apply/simulate" in err


def test_serial_engine_json_is_byte_identical(tmp_path):
    nodes, apps, new_node, extra = _synthetic("base")
    cfg = _config(tmp_path, nodes, apps, new_node, extra)
    (jrc, jout), (prc, pout) = _both(cfg, "--format", "json", "--engine", "oracle",
                                     "--no-sweep", port_flags=())
    assert (prc, pout) == (jrc, jout) and prc == 0


def test_default_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(port_cli.main, port_reset,
                        ["apply", "-f", GPUSHARE, "--format", "json"])
    assert rc == 2 and not out
    assert "needs a GPU" in err


@pytest.mark.parametrize("what,item", [("chart", "A1f")])
def test_out_of_slice_config_names_its_roadmap_item(what, item, tmp_path):
    """Helm charts (A1f) are ported: a chart app that is no chart fails
    as the JAX CLI fails it, and names no ROADMAP item."""
    nodes, apps, new_node, _ = _synthetic("base")
    cfg = _config(tmp_path, nodes, apps, new_node,
                  chart=what == "chart", kube=what == "kube")
    rc, out, err = _run(port_cli.main, port_reset,
                        ["apply", "-f", cfg, "--device", "cpu"])
    if what == "chart":
        jrc, jout, jerr = _run(jax_cli.main, jax_reset, ["apply", "-f", cfg])
        assert (rc, out) == (jrc, jout) and rc != 0
        assert "ROADMAP.md" not in err and err.strip().splitlines()[-1:] == \
            jerr.strip().splitlines()[-1:]
        return
    assert rc == 2 and f"ROADMAP.md {item}" in err


def test_max_vg_cap_decides_the_count(tmp_path, monkeypatch):
    """With MaxVG=50 the planner needs two new nodes for the VG usage
    alone (32 GiB of volumes: 53% of three nodes' 60 GiB, 40% of four's
    80 GiB); without the cap none. The cap reads the scan's final VG
    usage, as the JAX package's sweep does."""
    import json

    nodes, apps, new_node, extra, files = _storage_case(vg_gi=20, anti=False, replicas=4)
    cfg = _config(tmp_path, nodes, apps, new_node, extra, files=files)
    (jrc, jout), (prc, pout) = _both(cfg, "--format", "json")
    assert (prc, pout) == (jrc, jout) and json.loads(pout)["newNodeCount"] == 0
    monkeypatch.setenv("MaxVG", "50")
    (jrc, jout), (prc, pout) = _both(cfg, "--format", "json")
    assert (prc, pout) == (jrc, jout) and prc == 0
    doc = json.loads(pout)
    assert doc["success"] and doc["newNodeCount"] == 2


def test_out_of_slice_planner_options_raise(tmp_path):
    """N+K, the journal, the multi-spec what-if and kubeConfig clusters
    are ported: the Applier takes their options and builds."""
    from open_simulator_tpu_torch.apply import applier

    config = applier.SimonConfig.from_file(GPUSHARE)
    for kw in ({"tolerate_node_failures": 1}, {"journal_path": str(tmp_path / "j.jsonl")}):
        applier.Applier(config, device="cpu", **kw)
    assert applier.probe_plan_multi(None, [], [], device="cpu") == []
    nodes, apps, new_node, _ = _synthetic("base")
    kube = applier.SimonConfig.from_file(_config(tmp_path, nodes, apps, new_node, kube=True))
    built = applier.Applier(kube, device="cpu")
    assert built.config.kube_config and not built.config.custom_cluster


def _name_plugin(pkg, weight):
    """A stateless custom score plugin of `pkg` (normalize "default"):
    the score follows the digits of the node's name and the pod's
    labels."""
    import importlib

    base = importlib.import_module(f"{pkg}.scheduler.plugins").SchedulerPlugin

    class NameScore(base):
        name = "name-score-default"
        normalize = "default"

        def score(self, pod, node):
            digits = "".join(c for c in node["metadata"]["name"] if c.isdigit())
            key = len(str((pod.get("metadata") or {}).get("labels") or {}))
            return (int(digits or 0) * 7 + key) % 11

    plug = NameScore()
    plug.weight = weight
    return plug


@pytest.fixture
def register():
    """register(weight) adds the same plugin to both packages' default
    registries; they are emptied after the test."""
    import importlib

    pkgs = ("open_simulator_tpu", "open_simulator_tpu_torch")
    regs = [importlib.import_module(f"{pkg}.scheduler.plugins").default_registry
            for pkg in pkgs]
    for reg in regs:
        reg.clear()

    def add(weight):
        for pkg, reg in zip(pkgs, regs):
            reg.register(_name_plugin(pkg, weight))

    yield add
    for reg in regs:
        reg.clear()


def test_custom_score_plugin_plans_serially_on_the_oracle_engine(register):
    """A registered custom score plugin: the serial engine plans the
    quickstart as the JAX Applier does (+5), from the hint of a sweep
    whose probes ride the torch scan (trace-noted)."""
    from open_simulator_tpu.apply import applier as japplier
    from open_simulator_tpu_torch.apply import applier
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    register(3)
    jax_reset()
    want = japplier.Applier(japplier.SimonConfig.from_file(QUICKSTART), engine="oracle").run()
    assert want.success and want.new_node_count == 5
    port_reset()
    got = applier.Applier(applier.SimonConfig.from_file(QUICKSTART), engine="oracle",
                          device="cpu").run()
    assert (got.success, got.new_node_count) == (True, want.new_node_count)
    assert GLOBAL.notes.get("sweep-kernel") == "torch-scan (custom score plugins)"
    assert "apply-serial-route" not in GLOBAL.notes
    assert sorted(len(ns.pods) for ns in got.result.node_status) == sorted(
        len(ns.pods) for ns in want.result.node_status)


def test_custom_score_plugin_plans_on_the_cuda_engine(register):
    """The cuda engine's capacity sweep probes a batch with a custom
    score plugin on the torch scan, one count at a time as the JAX
    package's XLA route does: +5 on the quickstart, the JSON report
    byte-identical to the JAX CLI's, and no kernel launch counted."""
    import json

    from open_simulator_tpu_torch.utils.trace import GLOBAL

    register(3)
    launches = dict(fused_scan.LAUNCHES)
    (jrc, jout), (prc, pout) = _both(QUICKSTART, "--format", "json")
    assert (prc, pout) == (jrc, jout) and prc == 0
    assert json.loads(pout)["newNodeCount"] == 5
    assert GLOBAL.notes.get("sweep-kernel") == "torch-scan (custom score plugins)"
    assert fused_scan.LAUNCHES == launches


def _sweeps(tmp_path):
    """The JAX package's sweep and the port's over the base case."""
    import importlib

    nodes, apps, new_node, _ = _synthetic("base")
    out = []
    for pkg, kw in (("open_simulator_tpu", {}), ("open_simulator_tpu_torch",
                                                  {"device": "cpu"})):
        importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
        core = importlib.import_module(f"{pkg}.scheduler.core")
        dec = importlib.import_module(f"{pkg}.models.decode")
        sweep_mod = importlib.import_module(f"{pkg}.parallel.sweep")
        cluster = dec.ResourceTypes()
        cluster.nodes = [dict(n) for n in nodes]
        res = dec.ResourceTypes()
        res.deployments = list(apps[0][1])
        out.append(sweep_mod.CapacitySweep(cluster, [core.AppResource("web", res)],
                                           new_node, 6, **kw))
    return out


def test_sweep_probes_equal_the_jax_sweep_and_each_other(tmp_path):
    jax_sweep, sweep = _sweeps(tmp_path)
    assert sweep.lower_bound() == jax_sweep.lower_bound()
    singles = [sweep.probe(c) for c in range(7)]
    for c, r in enumerate(singles):
        j = jax_sweep.probe(c)
        assert (r.unscheduled, r.cpu_util, r.mem_util, r.vg_util) == (
            j.unscheduled, j.cpu_util, j.mem_util, j.vg_util)
        np.testing.assert_array_equal(r.placements, np.asarray(j.placements))
    pair = sweep.probe_pair(2, 5)
    many = sweep.probe_many(list(range(7)))
    for r in pair:
        np.testing.assert_array_equal(r.placements, singles[r.count].placements)
    np.testing.assert_array_equal(many.placements,
                                  np.stack([r.placements for r in singles]))
    assert list(many.unscheduled) == [r.unscheduled for r in singles]
    # monotone: more nodes never schedule fewer pods
    assert all(a >= b for a, b in zip(many.unscheduled[:-1], many.unscheduled[1:]))


def test_find_min_count_pairs_probes_and_matches_jax(tmp_path):
    from open_simulator_tpu_torch.apply.applier import _capacity_feasible

    jax_sweep, sweep = _sweeps(tmp_path)
    feasible, caps = _capacity_feasible()
    seen = []
    launches = dict(fused_scan.LAUNCHES)
    best = sweep.find_min_count(feasible, start=sweep.lower_bound(*caps),
                                on_probe=lambda r: seen.append(r.count))
    jbest = jax_sweep.find_min_count(feasible, start=jax_sweep.lower_bound(*caps))
    assert best.count == jbest.count
    assert fused_scan.LAUNCHES == launches  # the CPU path counts no launch
    # minimality: one node fewer fails the caps predicate
    if best.count > sweep.lower_bound(*caps):
        assert not feasible(sweep.probe(best.count - 1))
    assert len(seen) == len(set(seen))


def test_module_runs_as_a_script():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "apply", "-f", GPUSHARE,
         "--format", "json", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=os.getcwd(),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('{"success": true, "newNodeCount": 0')


@pytest.fixture
def mesh_state():
    """Restore both packages' process-wide mesh selection after the
    test (`--mesh` configures it for the rest of the process)."""
    from open_simulator_tpu.parallel import mesh as jmesh
    from open_simulator_tpu_torch.parallel import mesh as pmesh

    saved = (dict(jmesh._STATE), dict(pmesh._STATE))
    yield
    for mod, state in zip((jmesh, pmesh), saved):
        mod._STATE.clear()
        mod._STATE.update(state)
    pmesh._STATE["cache"] = {}


@pytest.mark.parametrize("spec", ["auto", "off", "1", "many"])
def test_mesh_flag_gives_the_jax_bytes_and_exit_code(spec, tmp_path, mesh_state):
    """`--mesh auto|off|1` plans to the JAX CLI's bytes (the JAX one on
    its 8-device CPU mesh, the port's on its one CPU device, where each
    resolves to no mesh or splits rows without changing an answer); a
    junk spec exits 2 with the JAX message."""
    nodes, apps, new_node, extra = _synthetic("base")
    cfg = _config(tmp_path, nodes, apps, new_node, extra)
    argv = ["apply", "-f", cfg, "--format", "json", "--mesh", spec]
    j = _run(jax_cli.main, jax_reset, argv)
    p = _run(port_cli.main, port_reset, argv + ["--device", "cpu"])
    assert p == j
    assert p[0] == (2 if spec == "many" else 0)
    if spec == "many":
        assert p[2] == "error: --mesh 'many': expected auto, off, or a device count\n"


def test_mesh_beyond_the_devices_exits_2(tmp_path, mesh_state):
    """The port's CPU is one device (the JAX test process has eight):
    `--mesh 2 --device cpu` is a clean exit 2 before any work."""
    nodes, apps, new_node, extra = _synthetic("base")
    cfg = _config(tmp_path, nodes, apps, new_node, extra)
    rc, out, err = _run(port_cli.main, port_reset,
                        ["apply", "-f", cfg, "--mesh", "2", "--device", "cpu"])
    assert (rc, out) == (2, "")
    assert err == "error: --mesh 2: only 1 local device(s) available\n"
