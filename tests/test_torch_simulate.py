"""The GPU port's `simulate()` against the JAX package's, exactly: the
same per-node pod lists (names, in order) and the same unscheduled pods
with the same reasons. The port runs `engine="cuda", device="cpu"` (the
fused scan's plain PyTorch version); the JAX package runs
`engine="tpu"` on its CPU backend (the XLA scan)."""

import copy
import importlib

import numpy as np
import pytest

from chip_smoke import build_scenario
from open_simulator_tpu.testing import (
    make_fake_daemon_set,
    make_fake_deployment,
    make_fake_node,
    make_fake_pod,
    with_node_name,
    with_priority,
)

JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"


def _resources(pkg, **fields):
    res = importlib.import_module(f"{pkg}.models.decode").ResourceTypes()
    for k, v in fields.items():
        setattr(res, k, copy.deepcopy(v))
    return res


def _run(pkg, cluster_fields, apps_fields, **kw):
    core = importlib.import_module(f"{pkg}.scheduler.core")
    importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
    cluster = _resources(pkg, **cluster_fields)
    apps = [core.AppResource(name, _resources(pkg, **f)) for name, f in apps_fields]
    if pkg == PORT_PKG:
        kw.setdefault("engine", "cuda")
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("engine", "tpu")
    res = core.simulate(cluster, apps, **kw)
    return (
        [(ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
         for ns in res.node_status],
        [(u.pod["metadata"]["name"], u.reason) for u in res.unscheduled_pods],
    )


def _assert_same(cluster_fields, apps_fields, **kw):
    ref = _run(JAX_PKG, cluster_fields, apps_fields, **kw)
    port = _run(PORT_PKG, cluster_fields, apps_fields, **kw)
    assert port == ref
    return port


@pytest.mark.parametrize("n_nodes,n_pods", [(40, 200), (12, 200)])
def test_default_scenario_shrunk(n_nodes, n_pods):
    """The chip smoke's default scenario (5 classes, every 11th node
    tainted, a nodeSelector class and a tolerating class) at a size the
    CPU runs; the second size overloads the cluster."""
    nodes, pods = build_scenario(n_nodes, n_pods)
    placed, unscheduled = _assert_same({"nodes": nodes}, [("bench", {"pods": pods})])
    assert sum(len(p) for _, p in placed) + len(unscheduled) == n_pods
    if n_nodes == 12:
        assert unscheduled


def test_cluster_workloads_pins_and_two_apps():
    """Daemonset pods (pinned per node), a bound pod, and two apps in
    order: the engine's masked rounds and the bulk replay."""
    nodes, _ = build_scenario(9, 0)
    ds = make_fake_daemon_set("agent", "kube-system", "100m", "128Mi")
    bound = make_fake_pod("bound", "default", "2", "4Gi", with_node_name("node-00003"))
    web = make_fake_deployment("web", "default", 30, "500m", "1Gi")
    api = make_fake_deployment("api", "default", 20, "1", "2Gi")
    _assert_same(
        {"nodes": nodes, "daemon_sets": [ds], "pods": [bound]},
        [("web", {"deployments": [web]}), ("api", {"deployments": [api]})],
    )


def test_priority_batch_with_escapes():
    """A priority-bearing batch rides the priority scan: each failing pod
    that could preempt escapes to the serial cycle and the rest of the
    batch is re-scanned with the committed prefix masked off."""
    nodes = [make_fake_node(f"n-{i}", "4", "8Gi") for i in range(4)]
    low = [make_fake_pod(f"low-{i}", "default", "1", "1Gi", with_priority(10))
           for i in range(80)]
    high = [make_fake_pod(f"high-{i}", "default", "1", "1Gi", with_priority(1000))
            for i in range(10)]
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    GLOBAL.reset()
    placed, unscheduled = _assert_same(
        {"nodes": nodes, "pods": low[:16]}, [("mixed", {"pods": high + low[16:]})]
    )
    assert int(GLOBAL.notes["priority-scan-escapes"]) > 0
    assert unscheduled


def test_score_weights():
    from open_simulator_tpu.scheduler.schedconfig import ScoreWeights as JW
    from open_simulator_tpu_torch.scheduler.schedconfig import ScoreWeights as PW

    nodes, pods = build_scenario(20, 80, seed=3)
    w = (0, 2, 1, 1, 3, 1, 1, 1, 1, 1, 1)
    ref = _run(JAX_PKG, {"nodes": nodes}, [("a", {"pods": pods})], score_weights=JW(*w))
    port = _run(PORT_PKG, {"nodes": nodes}, [("a", {"pods": pods})], score_weights=PW(*w))
    assert port == ref


def test_serial_oracle_engine_equals_jax_oracle():
    nodes, pods = build_scenario(15, 60, seed=5)
    _assert_same({"nodes": nodes}, [("a", {"pods": pods})], engine="oracle")


def _demo(pkg):
    cl = importlib.import_module(f"{pkg}.models.cluster")
    dec = importlib.import_module(f"{pkg}.models.decode")
    cluster = cl.cluster_from_config_dir("example/cluster/demo")
    web = dec.decode_yaml_content([open("example/application/web/deployment.yaml").read()])
    return cluster, web


def test_demo_cluster_web_deployment():
    """example/cluster/demo + example/application/web/deployment.yaml,
    when the JAX package's fused kernel takes that batch."""
    from open_simulator_tpu.ops import encode as jenc
    from open_simulator_tpu.ops import pallas_scan
    from open_simulator_tpu.scheduler.oracle import Oracle

    cluster, web = _demo(JAX_PKG)
    wl = importlib.import_module(f"{JAX_PKG}.models.workloads")
    wl.reset_name_counter()
    pods = wl.generate_valid_pods_from_app("web", web, cluster.nodes)
    oracle = Oracle(copy.deepcopy(cluster.nodes))
    cs = jenc.encode_cluster(oracle)
    batch = jenc.encode_batch(oracle, cs, pods)
    plan = pallas_scan.build_plan(cs, batch, jenc.encode_dynamic(oracle, cs),
                                  jenc.features_of_batch(cs, batch))
    if plan is None:
        pytest.skip(f"the JAX kernel does not take this batch: {pallas_scan.last_reject()}")
    results = []
    for pkg, kw in ((JAX_PKG, {"engine": "tpu"}),
                    (PORT_PKG, {"engine": "cuda", "device": "cpu"})):
        core = importlib.import_module(f"{pkg}.scheduler.core")
        importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
        cluster, web = _demo(pkg)
        res = core.simulate(cluster, [core.AppResource("web", web)], **kw)
        results.append((
            [(ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
             for ns in res.node_status],
            [(u.pod["metadata"]["name"], u.reason) for u in res.unscheduled_pods],
        ))
    assert results[0] == results[1]
    assert any(pods for _, pods in results[1][0])


def test_out_of_slice_batch_raises():
    """A custom score plugin, outside the kernel, and an inter-pod
    anti-affinity batch, outside it before B4, both run and place as
    the JAX package does: the custom plugin on the eager torch scan
    (it raised OutOfSliceError before the torch scan was ported)."""
    from open_simulator_tpu.scheduler.plugins import SchedulerPlugin as JaxPlugin
    from open_simulator_tpu.scheduler.plugins import default_registry as jax_registry
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    nodes, pods = build_scenario(5, 10)
    pods[3]["spec"]["affinity"] = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"cls": "small"}},
            "topologyKey": "kubernetes.io/hostname",
        }],
    }}
    _assert_same({"nodes": nodes}, [("a", {"pods": pods})])

    def prefer(base):
        class Prefer(base):
            name = "prefer-even"
            normalize = "default"

            def filter(self, pod, node):
                return True

            def score(self, pod, node):
                return int(node["metadata"]["name"][-1]) % 2

        return Prefer()

    default_registry.register(prefer(SchedulerPlugin))
    jax_registry.register(prefer(JaxPlugin))
    try:
        GLOBAL.reset()
        placed, _failed = _assert_same({"nodes": nodes}, [("a", {"pods": pods})])
        assert GLOBAL.notes["batch-kernel"] == "torch-scan (custom score plugins)"
        assert any(p for _n, p in placed)
    finally:
        default_registry.unregister("prefer-even")
        jax_registry.unregister("prefer-even")


def test_sample_select_host_raises():
    """select_host="sample" runs on the eager torch scan and places as
    the JAX package's XLA scan does (it raised OutOfSliceError before
    the torch scan was ported)."""
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    nodes, pods = build_scenario(5, 10)
    GLOBAL.reset()
    _assert_same({"nodes": nodes}, [("a", {"pods": pods})], select_host="sample")
    assert GLOBAL.notes["batch-kernel"] == 'torch-scan (select_host="sample")'


def test_trace_names_the_plain_version_on_cpu():
    from open_simulator_tpu_torch.ops import fused_scan
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    GLOBAL.reset()
    before = dict(fused_scan.LAUNCHES)
    nodes, pods = build_scenario(6, 20)
    _run(PORT_PKG, {"nodes": nodes}, [("a", {"pods": pods})])
    assert GLOBAL.notes["batch-kernel"].startswith("torch-plain-fused_scan_base")
    # the CPU path never counts a kernel launch
    assert fused_scan.LAUNCHES == before
    assert np.isfinite(GLOBAL.phase_seconds("engine/scan"))
