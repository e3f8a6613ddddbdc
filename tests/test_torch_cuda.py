"""The CUDA kernel of the GPU port (csrc/fused_scan.cu) against its
plain PyTorch version, on the card: identical placements and identical
final int64 state. Marked `cuda`; skips where there is no card.

This file imports neither JAX nor the JAX package's scan, so that it
runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from open_simulator_tpu.testing import (
    make_fake_node,
    make_fake_pod,
    with_node_labels,
    with_node_name,
    with_node_selector,
    with_node_taints,
    with_tolerations,
)
from open_simulator_tpu_torch.ops import encode as enc
from open_simulator_tpu_torch.ops import fused_scan
from open_simulator_tpu_torch.scheduler.oracle import Oracle


def _scenario(n_nodes, n_pods, seed, pins):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        cpu = int(rng.choice([4, 8, 16, 32]))
        opts = [with_node_labels({"zone": f"z{i % 3}"})]
        if i % 3 == 0:
            opts.append(with_node_taints(
                [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
            ))
        nodes.append(make_fake_node(f"node-{i}", f"{cpu}", f"{cpu * 4}Gi", *opts))
    pods = []
    for i in range(n_pods):
        opts = []
        if rng.rand() < 0.3:
            opts.append(with_node_selector({"zone": f"z{rng.randint(3)}"}))
        if rng.rand() < 0.3:
            opts.append(with_tolerations([{"key": "dedicated", "operator": "Exists"}]))
        if pins and rng.rand() < 0.1:
            opts.append(with_node_name(f"node-{rng.randint(n_nodes)}"))
        pods.append(make_fake_pod(
            f"p-{i}", "default", ["250m", "500m", "1", "2"][rng.randint(4)],
            ["256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(4)], *opts,
        ))
    return nodes, pods


# (nodes, pods, seed, pins, node_frac, pod_frac): the larger cases give
# each of the block's 1024 threads several nodes
CASES = {
    "small": (8, 60, 0, False, 1.0, 1.0),
    "overload": (4, 200, 1, False, 1.0, 1.0),
    "masked-pins": (12, 120, 2, True, 0.7, 0.8),
    "multi-node-threads": (2500, 1500, 3, True, 0.9, 0.95),
    "overload-wide": (1100, 3000, 4, False, 1.0, 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_equals_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n_nodes, n_pods, seed, pins, nf, pf = CASES[name]
    nodes, pods = _scenario(n_nodes, n_pods, seed, pins)
    oracle = Oracle(copy.deepcopy(nodes))
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, pods)
    dyn = enc.encode_dynamic(oracle, cluster)
    plan = fused_scan.build_plan(cluster, batch, dyn, enc.features_of_batch(cluster, batch))
    rng = np.random.RandomState(seed + 100)
    args = (batch.class_of_pod, rng.rand(n_pods) < pf, rng.rand(n_nodes) < nf)
    ref_p, ref_f = fused_scan.fused_scan_reference(plan, *args, pinned=batch.pinned_node)
    before = fused_scan.LAUNCHES[fused_scan.KERNEL_NAME]
    cu_p, cu_f = fused_scan.run_fused_scan(plan.to("cuda"), *args, pinned=batch.pinned_node)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[fused_scan.KERNEL_NAME] == before + 1
    np.testing.assert_array_equal(cu_p.cpu().numpy(), ref_p.numpy())
    for k in fused_scan.STATE_FIELDS:
        np.testing.assert_array_equal(cu_f[k].cpu().numpy(), ref_f[k].numpy(), err_msg=k)


def _b2_scenario(n_nodes, n_pods, seed, kinds=2, devices=4, pins=True):
    """Nodes with `kinds` extended scalar resources and up to `devices`
    GPUs; pods mixing scalar requests, hostPorts (one port, several
    ports, the wildcard and a second protocol), single- and multi-GPU
    shares and plain requests, some pinned."""
    rng = np.random.RandomState(seed)
    names = [f"example.com/r{k}" for k in range(kinds)]
    nodes = []
    for i in range(n_nodes):
        node = make_fake_node(f"node-{i}", "32", "128Gi")
        node["status"]["allocatable"].update({nm: "4" for nm in names})
        g = int(rng.randint(0, devices + 1))
        if g:
            for section in ("allocatable", "capacity"):
                node["status"].setdefault(section, {}).update({
                    "alibabacloud.com/gpu-count": str(g),
                    "alibabacloud.com/gpu-mem": str(32 * g),
                })
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        pod = make_fake_pod(f"p-{i}", "default", ["250m", "1", "2"][rng.randint(3)], "1Gi")
        kind = rng.randint(4)
        if kind == 0:
            pod["spec"]["containers"][0]["resources"]["requests"][
                names[rng.randint(kinds)]] = str(1 + rng.randint(2))
        elif kind == 1:
            port = 8000 + rng.randint(40)
            entry = {"containerPort": port, "hostPort": port,
                     "protocol": "UDP" if rng.rand() < 0.2 else "TCP"}
            if rng.rand() < 0.2:
                entry["hostIP"] = "0.0.0.0" if rng.rand() < 0.5 else "10.0.0.1"
            pod["spec"]["containers"][0]["ports"] = [entry]
        elif kind == 2:
            pod["metadata"]["annotations"] = {
                "alibabacloud.com/gpu-mem": str(int(rng.choice([4, 8, 16, 32]))),
                "alibabacloud.com/gpu-count": str(int(rng.choice([1, 1, 2, 3]))),
            }
        if pins and rng.rand() < 0.05:
            pod["spec"]["nodeName"] = f"node-{rng.randint(n_nodes)}"
        pods.append(pod)
    return nodes, pods


def _plan(nodes, pods):
    oracle = Oracle(copy.deepcopy(nodes))
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return fused_scan.build_plan(cluster, batch, dyn,
                                 enc.features_of_batch(cluster, batch)), batch


def _same(got, want):
    (gp, gf), (wp, wf) = got, want
    np.testing.assert_array_equal(gp.cpu().numpy(), wp.cpu().numpy())
    assert gf.keys() == wf.keys()
    for k in gf:
        np.testing.assert_array_equal(gf[k].cpu().numpy(), wf[k].cpu().numpy(), err_msg=k)


# (nodes, pods, seed, scalar kinds, GPUs per node, node_frac, pod_frac)
B2_CASES = {
    "b2-small": (12, 300, 5, 2, 4, 1.0, 1.0),
    "b2-wide-masked": (2500, 1500, 6, 2, 8, 0.9, 0.95),
    "b2-beyond-jax-caps": (1100, 1200, 7, 10, 10, 1.0, 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(B2_CASES))
def test_cuda_ext_kernel_equals_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n_nodes, n_pods, seed, kinds, devices, nf, pf = B2_CASES[name]
    plan, batch = _plan(*_b2_scenario(n_nodes, n_pods, seed, kinds, devices))
    assert plan.has_scal and plan.has_gpu and plan.has_ports and plan.has_pins
    rng = np.random.RandomState(seed + 100)
    args = (batch.class_of_pod, rng.rand(n_pods) < pf, rng.rand(n_nodes) < nf)
    ref = fused_scan.fused_scan_reference(plan, *args, pinned=batch.pinned_node)
    before = fused_scan.LAUNCHES[fused_scan.EXT_KERNEL_NAME]
    got = fused_scan.run_fused_scan(plan.to("cuda"), *args, pinned=batch.pinned_node)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[fused_scan.EXT_KERNEL_NAME] == before + 1
    _same(got, ref)
    assert (ref[0] >= 0).any()
    if n_nodes < 100:  # the small cluster overflows
        assert (ref[0] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b2", [False, True])
def test_cuda_batch_kernel_equals_batch_plain(b2):
    """Several nodes per thread, per-scenario node masks, inactive pods
    and pins; with and without the B2 blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n_nodes, n_pods = 2500, 1500
    nodes, pods = (_b2_scenario(n_nodes, n_pods, 8) if b2
                   else _scenario(n_nodes, n_pods, 8, True))
    plan, batch = _plan(nodes, pods)
    assert plan.ext == b2 and plan.has_pins
    rng = np.random.RandomState(9)
    last_off = np.ones(n_nodes, bool)
    last_off[int(n_nodes * 0.9):] = False
    pin = np.asarray(batch.pinned_node)
    scen = [
        (np.ones(n_pods, bool), np.ones(n_nodes, bool), pin),
        (np.ones(n_pods, bool), last_off, pin),
        (rng.rand(n_pods) < 0.8, np.arange(n_nodes) % 7 != 0, pin),
        (np.ones(n_pods, bool), rng.rand(n_nodes) < 0.5, np.where(pin % 2 == 0, pin, -1)),
    ]
    ref = fused_scan.fused_scan_batch_reference(plan, batch.class_of_pod, scen)
    before = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME]
    got = fused_scan.run_fused_scan_batch(plan.to("cuda"), batch.class_of_pod, scen)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME] == before + 1
    for g, r in zip(got, ref):
        _same(g, r)


GI = 1 << 30


def _storage_anno(rng, vgs_max):
    import json

    vgs = [{"name": f"vg{k}", "capacity": str(int(rng.choice([3, 7, 50, 100, 200])) * GI),
            "requested": str(int(rng.randint(0, 3)) * GI)}
           for k in range(1 + rng.randint(vgs_max))]
    devs = [{"name": f"/dev/s{d}", "capacity": str(int(rng.choice([40, 80, 120])) * GI),
             "mediaType": "ssd", "isAllocated": "true" if rng.rand() < 0.1 else "false"}
            for d in range(rng.randint(4))]
    devs += [{"name": f"/dev/h{d}", "capacity": str(int(rng.choice([200, 500])) * GI),
              "mediaType": "hdd", "isAllocated": "false"} for d in range(rng.randint(3))]
    return json.dumps({"vgs": vgs, "devices": devs})


def _volumes(rng):
    import json

    shapes = [[("LVM", 1)], [("LVM", 5), ("LVM", 2)], [("LVM", 8), ("LVM", 4), ("LVM", 1)],
              [("SSD", 30), ("SSD", 60)], [("HDD", 150)], [("LVM", 3), ("SSD", 20), ("HDD", 10)]]
    vols = shapes[rng.randint(len(shapes))]
    return json.dumps({"volumes": [{"kind": k, "size": str(s * GI),
                                    "scName": f"open-local-{k.lower()}"} for k, s in vols]})


def _b3_scenario(n_nodes, n_pods, seed, vgs_max):
    """Nodes with 1..vgs_max VGs (up to 6: past the Pallas plan's cap),
    0-3 SSDs and 0-2 HDDs (90% of them with storage); pods with LVM,
    SSD and HDD volumes or none, some pinned."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        node = make_fake_node(f"node-{i}", "16", "64Gi")
        if rng.rand() < 0.9:
            node["metadata"].setdefault("annotations", {})["simon/node-local-storage"] = \
                _storage_anno(rng, vgs_max)
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        pod = make_fake_pod(f"p-{i}", "default", ["250m", "500m", "1"][rng.randint(3)], "1Gi")
        if rng.rand() < 0.8:
            pod["metadata"].setdefault("annotations", {})["simon/pod-local-storage"] = \
                _volumes(rng)
        if rng.rand() < 0.03:
            pod["spec"]["nodeName"] = f"node-{rng.randint(n_nodes)}"
        pods.append(pod)
    return nodes, pods


def _b4_scenario(n_nodes, n_sts, replicas, zones, seed, storage=False):
    """The affinity stress (hostname anti-affinity, hard zone spread,
    soft hostname spread, preferred zone affinity) plus a rack key with
    a second soft constraint and a required zone affinity group on some
    workloads; with `storage`, VGs on two nodes of three and volumes on
    a quarter of the pods. A few pods pinned."""
    from open_simulator_tpu.testing import build_affinity_stress
    from open_simulator_tpu_torch.models import workloads as wl
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods

    rng = np.random.RandomState(seed)
    nodes, stss = build_affinity_stress(n_nodes=n_nodes, n_sts=n_sts, replicas=replicas,
                                        zones=zones)
    for i, node in enumerate(nodes):
        node["metadata"]["labels"]["rack"] = f"r{i % 7}"
        if storage and i % 3:
            node["metadata"].setdefault("annotations", {})["simon/node-local-storage"] = \
                _storage_anno(rng, 3)
    for s, obj in enumerate(stss):
        spec = obj["spec"]["template"]["spec"]
        if s % 4 == 1:
            spec["topologySpreadConstraints"].append({
                "maxSkew": 3, "topologyKey": "rack", "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": obj["metadata"]["name"]}}})
        if s % 5 == 3:
            spec["affinity"]["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": stss[0]["metadata"]["name"]}},
                 "topologyKey": "zone"}]}
    wl.reset_name_counter()
    res = ResourceTypes()
    res.stateful_sets = stss
    pods = _sort_app_pods(wl.generate_valid_pods_from_app("t", res, nodes))
    for pod in pods:
        if storage and rng.rand() < 0.25:
            pod["metadata"] = copy.deepcopy(pod["metadata"])
            pod["metadata"].setdefault("annotations", {})["simon/pod-local-storage"] = \
                _volumes(rng)
        if rng.rand() < 0.02:
            pod["spec"] = copy.deepcopy(pod["spec"])
            pod["spec"]["nodeName"] = nodes[rng.randint(n_nodes)]["metadata"]["name"]
    return nodes, pods


# (scenario function, kernel, node_frac, pod_frac): several nodes per thread in the
# wide cases
BLOCK_CASES = {
    "b3-small": (lambda: _b3_scenario(30, 400, 10, 6), fused_scan.STORE_KERNEL_NAME, 1.0, 1.0),
    "b3-wide-masked": (lambda: _b3_scenario(2500, 1500, 11, 6), fused_scan.STORE_KERNEL_NAME,
                       0.9, 0.95),
    "b4-small": (lambda: _b4_scenario(40, 12, 6, 4, 12), fused_scan.TERMS_KERNEL_NAME,
                 1.0, 1.0),
    "b4-wide-masked": (lambda: _b4_scenario(2500, 24, 40, 16, 13),
                       fused_scan.TERMS_KERNEL_NAME, 0.9, 0.95),
    "b3-b4-wide": (lambda: _b4_scenario(2100, 16, 40, 8, 14, storage=True),
                   fused_scan.STORE_TERMS_KERNEL_NAME, 0.95, 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_cuda_store_terms_kernel_equals_plain(name):
    """B3 and B4 (and both in one plan): placements and every final row,
    base, storage and value-space term state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    build, kernel, nf, pf = BLOCK_CASES[name]
    nodes, pods = build()
    plan, batch = _plan(nodes, pods)
    assert fused_scan.kernel_name(plan) == kernel and plan.has_pins
    rng = np.random.RandomState(len(pods))
    args = (batch.class_of_pod, rng.rand(len(pods)) < pf, rng.rand(len(nodes)) < nf)
    ref = fused_scan.fused_scan_reference(plan.to("cuda"), *args, pinned=batch.pinned_node)
    before = fused_scan.LAUNCHES[kernel]
    got = fused_scan.run_fused_scan(plan.to("cuda"), *args, pinned=batch.pinned_node)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[kernel] == before + 1
    _same(got, ref)
    assert (ref[0] >= 0).sum() > len(pods) // 4


@pytest.mark.cuda
def test_cuda_batch_kernel_with_storage_and_terms_equals_batch_plain():
    """B6 with both new blocks: per-scenario node masks, inactive pods
    and pin rows, several nodes per thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    nodes, pods = _b4_scenario(2100, 16, 30, 8, 15, storage=True)
    n_nodes, n_pods = len(nodes), len(pods)
    plan, batch = _plan(nodes, pods)
    plan = plan.to("cuda")
    assert plan.has_store and plan.has_terms
    rng = np.random.RandomState(16)
    last_off = np.ones(n_nodes, bool)
    last_off[int(n_nodes * 0.9):] = False
    pin = np.asarray(batch.pinned_node)
    scen = [
        (np.ones(n_pods, bool), np.ones(n_nodes, bool), pin),
        (np.ones(n_pods, bool), last_off, pin),
        (rng.rand(n_pods) < 0.8, np.arange(n_nodes) % 7 != 0, pin),
        (np.ones(n_pods, bool), rng.rand(n_nodes) < 0.5, np.where(pin % 2 == 0, pin, -1)),
    ]
    ref = fused_scan.fused_scan_batch_reference(plan, batch.class_of_pod, scen)
    before = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME]
    got = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME] == before + 1
    for g, r in zip(got, ref):
        _same(g, r)


# ---- B7: the streaming-bandwidth probe ------------------------------------

# (rows, steps, kind): fewer rows than blocks, a ragged last slice per
# block, sums that wrap int32, and all-INT32_MIN lanes (the floor)
STREAM_CASES = {
    "few-rows": (40, 7, "tool"),
    "ragged-slices": (2100, 5, "full"),
    "wraps": (4096, 9, "high"),
    "floor": (300, 3, "floor"),
    "scan-step-probe": (936, 2000, "tool"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_cuda_stream_kernel_equals_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from open_simulator_tpu_torch.tools import stream_bench

    rows, steps, kind = STREAM_CASES[name]
    rng = np.random.RandomState(rows)
    vals = {
        "tool": lambda: rng.randint(0, 1 << 20, (rows, 128)),
        "full": lambda: rng.randint(-(2**31), 2**31 - 1, (rows, 128), dtype=np.int64),
        "high": lambda: rng.randint(1 << 29, 1 << 30, (rows, 128)),
        "floor": lambda: np.full((rows, 128), -(2**31)),
    }[kind]().astype(np.int32)
    state = torch.as_tensor(vals, device="cuda")
    before = stream_bench.LAUNCHES[stream_bench.KERNEL_NAME]
    got = stream_bench.run_stream(state, steps)
    torch.cuda.synchronize()
    assert stream_bench.LAUNCHES[stream_bench.KERNEL_NAME] == before + 1
    want = stream_bench.stream_reference(state.cpu(), steps)
    assert torch.equal(got.cpu(), want)


# ---- A2: the eager torch scan on the card ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True])
def test_cuda_torch_scan_equals_cpu(sample):
    """The torch scan on CUDA tensors against the same scan on the CPU:
    every block (GPU-share, storage, terms, ports, scalars, pins), a
    custom plugin, scenario masks and, with sample, the Go-RNG stream:
    placements, consumed words and every final row, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import build_fuzz_scenario
    from open_simulator_tpu_torch.ops import scan as scan_ops
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry
    from open_simulator_tpu_torch.utils.gorand import GoRand

    class NameScore(SchedulerPlugin):
        name = "cuda-name-score"
        normalize = "minmax"

        def score(self, pod, node):
            return sum(map(ord, node["metadata"]["name"])) % 13

    nodes, pods = build_fuzz_scenario(300, 600, seed=21)
    gi = 1 << 30
    for node in nodes[::5]:
        cap = node["status"].setdefault("capacity", dict(node["status"]["allocatable"]))
        cap["alibabacloud.com/gpu-count"] = "4"
        cap["alibabacloud.com/gpu-mem"] = str(64 * gi)
    for pod in pods[3::17]:
        if not pod["spec"].get("nodeName"):
            pod["metadata"] = dict(pod["metadata"], annotations={
                **(pod["metadata"].get("annotations") or {}),
                "alibabacloud.com/gpu-mem": str(8 * gi), "alibabacloud.com/gpu-count": "1"})
    default_registry.register(NameScore())
    try:
        oracle = Oracle(copy.deepcopy(nodes))
        cluster = enc.encode_cluster(oracle)
        batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
        dyn = enc.encode_dynamic(oracle, cluster)
    finally:
        default_registry.unregister("cuda-name-score")
    features = enc.features_of_batch(cluster, batch, sample=sample)
    assert features.custom and features.gpu and features.storage and features.ipa
    rng = np.random.RandomState(22)
    valid, active = rng.rand(cluster.n) < 0.9, rng.rand(batch.p) < 0.95
    hist = np.array(GoRand(9).history(), dtype=np.uint64).view(np.int64)
    runs = []
    for dev in ("cpu", "cuda"):
        init = enc.to_scan_state(dyn, batch, device=dev)
        if sample:
            init = init._replace(rng_hist=torch.as_tensor(hist, device=dev))
        out, final = scan_ops.run_scan_masked(
            enc.to_scan_static(cluster, batch, device=dev), init, batch.class_of_pod,
            batch.pinned_node, valid, active, features=features)
        if sample:
            out = torch.stack(out)
        runs.append((out.cpu(), {k: v.cpu() for k, v in final._asdict().items()
                                 if v is not None}))
    (want, want_rows), (got, got_rows) = runs
    assert torch.equal(got, want)
    assert sorted(got_rows) == sorted(want_rows)
    for key in want_rows:
        assert torch.equal(got_rows[key], want_rows[key]), key
    assert (want[0] if sample else want).ge(0).sum() > 300
