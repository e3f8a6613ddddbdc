"""The port's placement report (apply/report.py `report`) against the JAX
package's, byte for byte, on the CPU.

The port writes the Node Info and Pod Info tables from runs: a node's
consecutive pods whose rows differ only in the pod's name share one
request summary and one text after the name, and column widths come
from the distinct cells. Each case below breaks or stretches those runs
(one template over many nodes, templates interleaved on a node, request
sources equal in value but not the same objects, empty nodes, long
names, a missing namespace, a new node, `select_nodes`, open-local
volumes, GPU pods with device indices) and is rendered with the replay
oracle's per-node totals and without them. `render_table` keeps its
bytes for its other callers. A small basic rollout through `simon apply`
counts its rows and runs, and enters each table's phase once."""

import contextlib
import copy
import io
import json

import pytest

from benchmark.tests import tiny
from open_simulator_tpu.apply import report as jax_report
from open_simulator_tpu.scheduler.oracle import Oracle as JaxOracle
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.apply import report as port_report
from open_simulator_tpu_torch.models import storage as stor
from open_simulator_tpu_torch.models import workloads as wl
from open_simulator_tpu_torch.scheduler.core import NodeStatus
from open_simulator_tpu_torch.scheduler.oracle import Oracle as PortOracle
from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL


def _node(name, cpu="4", mem="32Gi", new=False, gpus=0, storage=None):
    labels = {"kubernetes.io/hostname": name}
    if new:
        labels[wl.LABEL_NEW_NODE] = ""
    node = {
        "metadata": {"name": name, "labels": labels},
        "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}},
    }
    if gpus:
        gpu = {stor.GPU_COUNT_ANNO: str(gpus), stor.GPU_MEM_ANNO: f"{16 * gpus}Gi"}
        node["status"]["allocatable"].update(gpu)
        node["status"]["capacity"] = dict(node["status"]["allocatable"])
    if storage:
        node["metadata"]["annotations"] = {wl.ANNO_NODE_LOCAL_STORAGE: json.dumps(storage)}
    return node


class Template:
    """Pods of one workload as the expansion makes them: every replica
    shares the template's containers, init containers, overhead and
    labels dict."""

    def __init__(self, app, cpu="100m", mem="500Mi", init=None, overhead=None,
                 namespace="default", annotations=None):
        self.spec = {"containers": [{"name": "c", "resources": {
            "requests": {"cpu": cpu, "memory": mem}}}]}
        if init:
            self.spec["initContainers"] = [{"name": "i", "resources": {"requests": init}}]
        if overhead:
            self.spec["overhead"] = overhead
        self.labels = {wl.LABEL_APP_NAME: app} if app is not None else {}
        self.namespace = namespace
        self.annotations = annotations or {}
        self.app = app

    def pod(self, name, node, annotations=None):
        meta = {"name": name, "labels": self.labels,
                "annotations": {**self.annotations, **(annotations or {})}}
        if self.namespace is not None:
            meta["namespace"] = self.namespace
        return {"metadata": meta, "spec": dict(self.spec, nodeName=node)}


def _names(n):
    return [f"node-{i:02d}" for i in range(n)]


def _one_template():
    t = Template("web")
    nodes = [_node(n) for n in _names(12)]
    pods = [t.pod(f"web-{i:03d}", f"node-{i % 12:02d}") for i in range(84)]
    return nodes, pods, {}


def _interleaved():
    a, b, c = Template("a"), Template("b", cpu="250m", mem="1Gi"), Template("c", cpu="1")
    order = [a, a, b, a, c, c, c, b, b, a]
    nodes = [_node(n) for n in _names(5)]
    pods = [order[i % len(order)].pod(f"p-{i:03d}", f"node-{(i // 7) % 5:02d}")
            for i in range(70)]
    # one app label over two templates, two labels over one template,
    # and the same containers beside init containers of their own
    d = Template("a", cpu="300m")
    e = Template("e")
    e.spec = a.spec
    f = Template("a")
    f.spec = dict(a.spec, initContainers=[{"name": "i", "resources": {"requests": {"cpu": "3"}}}])
    pods += [d.pod("d-0", "node-00"), e.pod("e-0", "node-00"), a.pod("a-x", "node-00"),
             f.pod("f-0", "node-00"), a.pod("a-y", "node-00")]
    return nodes, pods, {}


def _equal_values():
    """As a snapshot or the live cluster loads them: every pod's sources
    are objects of its own, equal in value to the next pod's."""
    t, u = Template("web"), Template("db", cpu="2", mem="4Gi", overhead={"cpu": "10m"})
    pods = [(t if i % 5 else u).pod(f"s-{i:02d}", f"node-{i % 3:02d}") for i in range(30)]
    pods = json.loads(json.dumps(pods))
    assert pods[1]["spec"]["containers"] is not pods[2]["spec"]["containers"]
    return [_node(n) for n in _names(3)], pods, {}


def _empty_nodes():
    t = Template("web")
    nodes = [_node(n) for n in _names(8)]
    pods = [t.pod(f"w-{i}", f"node-{n:02d}") for i, n in enumerate([1, 1, 2, 5, 5, 5])]
    return nodes, pods, {}


def _no_pods():
    return [_node(n) for n in _names(3)], [], {}


def _long_names():
    t = Template("an-application-name-longer-than-its-header-" * 2)
    s = Template("x", namespace="a-namespace-of-some-length")
    nodes = [_node("n"), _node("a-node-name-longer-than-the-node-header-" * 3), _node("m")]
    pods = [t.pod(f"p{i}", "n") for i in range(4)]
    pods += [t.pod("a-pod-whose-name-is-longer-than-every-other-" * 2, "n")]
    pods += [t.pod(f"q{i}", nodes[1]["metadata"]["name"]) for i in range(3)]
    pods += [s.pod("y", "m"), s.pod("y" * 90, "m"), s.pod("z", "m")]
    return nodes, pods, {}


def _missing_namespace():
    t = Template("web", namespace=None)
    d = Template("web", namespace="default")
    k = Template(None, namespace="kube-system", init={"cpu": "2", "memory": "1Gi"})
    nodes = [_node(n) for n in _names(2)]
    pods = [t.pod("a", "node-00"), d.pod("b", "node-00"), t.pod("c", "node-00"),
            k.pod("d", "node-01"), k.pod("e", "node-01")]
    return nodes, pods, {}


def _new_node():
    t = Template("web", cpu="1500m", mem="3Gi")
    nodes = [_node("node-00"), _node("node-01", cpu="8", mem="64Gi"),
             _node("simon-new-0", new=True), _node("simon-new-1", new=True)]
    pods = [t.pod(f"w-{i}", n["metadata"]["name"]) for i, n in enumerate(nodes * 3)]
    return nodes, pods, {}


def _select_nodes():
    nodes, pods, _ = _interleaved()
    return nodes, pods, {"select_nodes": {"node-01", "node-03", "no-such-node"}}


LVM = {"vgs": [{"name": "pool0", "capacity": 100 << 30, "requested": 30 << 30}],
       "devices": [{"device": "/dev/vdb", "capacity": 200 << 30, "mediaType": "ssd",
                    "isAllocated": True}]}


def _open_local():
    def volumes(*vols):
        return {wl.ANNO_POD_LOCAL_STORAGE: json.dumps({"volumes": [
            {"size": str(size), "kind": kind, "scName": sc} for size, kind, sc in vols]})}

    t = Template("db")
    nodes = [_node("node-00", storage=LVM), _node("node-01", storage=LVM), _node("node-02")]
    one = volumes((10 << 30, "LVM", "open-local-lvm"))
    two = volumes((10 << 30, "LVM", "open-local-lvm"), (200 << 30, "SSD", "open-local-device-ssd"))
    pods = [t.pod("v-0", "node-00", one), t.pod("v-1", "node-00", one),
            t.pod("v-2", "node-00", two), t.pod("v-3", "node-00", one),
            t.pod("v-4", "node-01"), t.pod("v-5", "node-01"), t.pod("v-6", "node-02", one)]
    return nodes, pods, {"extended": ["open-local"]}


def _gpu_pods():
    share = Template("infer", annotations={stor.GPU_MEM_ANNO: str(4 << 30),
                                          stor.GPU_COUNT_ANNO: "1"})
    pair = Template("train", cpu="2", annotations={stor.GPU_MEM_ANNO: str(8 << 30),
                                                  stor.GPU_COUNT_ANNO: "2"})
    plain = Template("web")
    nodes = [_node("gpu-00", gpus=2), _node("gpu-01", gpus=4), _node("cpu-00")]
    pods = [share.pod("i-0", "gpu-00", {stor.GPU_INDEX_ANNO: "0"}),
            share.pod("i-1", "gpu-00", {stor.GPU_INDEX_ANNO: "1"}),
            share.pod("i-2", "gpu-00", {stor.GPU_INDEX_ANNO: "1"}),
            plain.pod("w-0", "gpu-00"), plain.pod("w-1", "gpu-00"),
            pair.pod("t-0", "gpu-01", {stor.GPU_INDEX_ANNO: "0-1"}),
            pair.pod("t-1", "gpu-01", {stor.GPU_INDEX_ANNO: "2-3"}),
            plain.pod("w-2", "cpu-00"), plain.pod("w-3", "cpu-00")]
    return nodes, pods, {"extended": ["gpu"]}


def _both_extended():
    nodes, pods, _ = _open_local()
    gnodes, gpods, _ = _gpu_pods()
    return nodes + gnodes, pods + gpods, {"extended": ["open-local", "gpu"]}


CASES = {
    "one_template": _one_template,
    "interleaved": _interleaved,
    "equal_values": _equal_values,
    "empty_nodes": _empty_nodes,
    "no_pods": _no_pods,
    "long_names": _long_names,
    "missing_namespace": _missing_namespace,
    "new_node": _new_node,
    "select_nodes": _select_nodes,
    "open_local": _open_local,
    "gpu": _gpu_pods,
    "open_local_and_gpu": _both_extended,
}


def _statuses(oracle_cls, nodes, pods):
    """Each node's status as a replay leaves it, and the oracle that
    holds the same node and pod objects."""
    oracle = oracle_cls(nodes)
    for pod in pods:
        oracle.place_existing_pod(pod)
    return [NodeStatus(ns.node, ns.pods) for ns in oracle.nodes], oracle


def _render(module, oracle_cls, case, with_oracle):
    nodes, pods, opts = CASES[case]()
    # one deepcopy of the whole input keeps the sharing between its pods
    nodes, pods = copy.deepcopy((nodes, pods))
    statuses, oracle = _statuses(oracle_cls, nodes, pods)
    return module.report(statuses, opts.get("extended"), select_nodes=opts.get("select_nodes"),
                         oracle=oracle if with_oracle else None), statuses, oracle


@pytest.mark.parametrize("with_oracle", [True, False], ids=["oracle", "no_oracle"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_report_equals_the_jax_package_byte_for_byte(case, with_oracle):
    want, _, _ = _render(jax_report, JaxOracle, case, with_oracle)
    got, statuses, oracle = _render(port_report, PortOracle, case, with_oracle)
    assert got == want
    # the fast path was there to take
    by_node = port_report.node_state_index(oracle)
    assert all(port_report.matched_node_state(by_node, s) is not None for s in statuses)


def test_runs_follow_the_pods_order():
    """The interleaved case's runs: a new run wherever the request
    sources, the app label or a pod's own cells change."""
    before = (COUNTERS.get("report_pod_rows_total"), COUNTERS.get("report_pod_runs_total"))
    nodes, pods, _ = _interleaved()
    statuses, _ = _statuses(PortOracle, nodes, pods)
    port_report.report(statuses)
    rows = COUNTERS.get("report_pod_rows_total") - before[0]
    runs = COUNTERS.get("report_pod_runs_total") - before[1]

    def key(pod):
        spec = pod["spec"]
        return (id(spec["containers"]), id(spec.get("initContainers")),
                pod["metadata"]["labels"].get(wl.LABEL_APP_NAME))

    want = sum(1 + sum(key(a) != key(b) for a, b in zip(s.pods, s.pods[1:]))
               for s in statuses if s.pods)
    assert rows == len(pods) and runs == want < rows


RENDER_ROWS = {
    "empty": (["A", "Bee"], []),
    "strings": (["Node", "Pod"], [["n-1", "default/p"], ["a-longer-node", "x"]]),
    "wide_header": (["A much wider header", "B"], [["a", "b"], ["", ""]]),
    "non_strings": (["Class", "Steps", "Share"], [["x", 3, 0.5], [None, 10, True]]),
    "unicode": (["Node", "New"], [["n", "√"], ["m", ""]]),
}


@pytest.mark.parametrize("case", sorted(RENDER_ROWS))
def test_render_table_keeps_its_bytes(case):
    headers, rows = RENDER_ROWS[case]
    assert port_report.render_table(headers, rows) == jax_report.render_table(headers, rows)


@pytest.fixture(scope="module")
def basic_rollout(tmp_path_factory):
    """The basic-deploy cell's request at 50 nodes: 1,500 pods of one
    Deployment, 30 a node."""
    inst = tiny.instance("k8s-5k-spread", "basic-rollout", 50, [1500])
    return inst.write(str(tmp_path_factory.mktemp("report") / inst.tag))


def test_basic_rollout_is_one_run_a_node(basic_rollout):
    before = (COUNTERS.get("report_pod_rows_total"), COUNTERS.get("report_pod_runs_total"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", basic_rollout, "--device", "cpu"])
    assert rc == 0, out.getvalue()[-2000:]
    assert COUNTERS.get("report_pod_rows_total") - before[0] == 1500
    assert COUNTERS.get("report_pod_runs_total") - before[1] == 50
    counts = {p["name"]: p["count"] for p in GLOBAL.as_dict()["phases"]}
    # each table a phase of its own, inside apply/report, once a request
    assert counts["report/nodes"] == counts["report/pods"] == counts["apply/report"] == 1
