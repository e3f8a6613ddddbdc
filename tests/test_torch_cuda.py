"""The CUDA kernel of the GPU port (csrc/fused_scan.cu) against its
plain PyTorch version, on the card: identical placements and identical
final int64 state. The base, B2 and batch cases run at every cluster
size through the private launcher (`cluster` None is the wrapper's own
rule, through the public entry points). Marked `cuda`; skips where there
is no card.

This file imports neither JAX nor the JAX package's scan, so that it
runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import ctypes

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


def _scenario(n_nodes, n_pods, seed, pins, huge=False):
    """Random nodes (every third tainted) and pods with selectors,
    tolerations and, with `pins`, nodeName pins. `huge` nodes have
    30,000-40,000 cores and up to 40 PiB, so the scores' floor divisions
    see operands past 2^61 (the kernel's int64 path) beside small ones."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        cpu = int(rng.choice([30000, 40000] if huge else [4, 8, 16, 32]))
        mem = f"{int(rng.choice([1, 40]))}Pi" if huge else f"{cpu * 4}Gi"
        opts = [with_node_labels({"zone": f"z{i % 3}"})]
        if i % 3 == 0:
            opts.append(with_node_taints(
                [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
            ))
        nodes.append(make_fake_node(f"node-{i}", f"{cpu}", mem, *opts))
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


# (nodes, pods, seed, pins, node_frac, pod_frac, huge): the larger cases
# give each thread several nodes at small cluster sizes; "global-rows"
# does not fit one block's shared memory at cluster 1; "magnitude" has
# operands past 2^61
CASES = {
    "small": (8, 60, 0, False, 1.0, 1.0, False),
    "overload": (4, 200, 1, False, 1.0, 1.0, False),
    "masked-pins": (12, 120, 2, True, 0.7, 0.8, False),
    "multi-node-threads": (2500, 1500, 3, True, 0.9, 0.95, False),
    "overload-wide": (1100, 3000, 4, False, 1.0, 1.0, False),
    "global-rows": (3000, 600, 5, True, 0.95, 1.0, False),
    "magnitude": (700, 900, 6, False, 1.0, 1.0, True),
}
# cluster sizes the base and B2 cases run at; None = the wrapper's rule
CLUSTER_CASES = [None, 1, 2, 8, 16]
_PLAIN = {}


def _plain_once(key, fn):
    """The plain version's result, computed once per case for all the
    cluster sizes that are held against it."""
    if key not in _PLAIN:
        _PLAIN[key] = fn()
    return _PLAIN[key]


def _kernel(plan, cls, scenarios, batch, cluster):
    """The kernel at `cluster` (None: the public entry point and its
    rule); checks the launch was counted under the plan's kernel."""
    name = fused_scan.kernel_name(plan, batch)
    before = fused_scan.LAUNCHES[name]
    if cluster is None and batch:
        got = fused_scan.run_fused_scan_batch(plan, cls, scenarios)
    elif cluster is None:
        got = [fused_scan.run_fused_scan(plan, cls, *scenarios[0])]
    else:
        got = fused_scan._run_with_cluster(plan, cls, scenarios, batch, cluster)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[name] == before + 1
    if cluster is not None:
        assert fused_scan.CLUSTERS[name] == cluster
    return got


def _b1_case(name):
    n_nodes, n_pods, seed, pins, nf, pf, huge = CASES[name]
    nodes, pods = _scenario(n_nodes, n_pods, seed, pins, huge)
    plan, batch = _plan(nodes, pods)
    rng = np.random.RandomState(seed + 100)
    scen = [(rng.rand(n_pods) < pf, rng.rand(n_nodes) < nf, batch.pinned_node)]
    return plan, batch, scen


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_CASES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_equals_plain(name, cluster):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    plan, batch, scen = _b1_case(name)
    assert not plan.ext
    ref = _plain_once(("b1", name), lambda: fused_scan.fused_scan_reference(
        plan, batch.class_of_pod, *scen[0]))
    (got,) = _kernel(plan.to("cuda"), batch.class_of_pod, scen, False, cluster)
    _same(got, ref)


def _edge_nodes(n_nodes):
    """Nodes of four sizes, every fifth tainted."""
    nodes = []
    for i in range(n_nodes):
        cpu = [4, 8, 16, 32][i % 4]
        opts = []
        if i % 5 == 0:
            opts.append(with_node_taints(
                [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]))
        nodes.append(make_fake_node(f"node-{i:05d}", f"{cpu}", f"{cpu * 4}Gi", *opts))
    return nodes


def _edge_pods(n_pods):
    """Pods of three sizes, every fourth tolerating the taint: the same
    classes whatever the node count."""
    sizes = [("250m", "256Mi"), ("1", "1Gi"), ("2", "4Gi")]
    pods = []
    for i in range(n_pods):
        opts = ([with_tolerations([{"key": "dedicated", "operator": "Exists"}])]
                if i % 4 == 0 else [])
        pods.append(make_fake_pod(f"p-{i}", "default", *sizes[i % 3], *opts))
    return pods


def _last_slice(plan, cached):
    """The most nodes a block's slice may hold in the resident layout
    (with the caches, when `cached`) beside the static arrays."""
    def fits(m):
        need = fused_scan.slice_bytes(plan, m)
        if cached:
            need += fused_scan.cache_bytes(plan, m)
        return need + fused_scan.STATIC_SMEM <= fused_scan.SMEM_PER_BLOCK
    lo, hi = 1, 1 << 20
    while lo < hi:  # the largest m that fits
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


# node counts at 16 blocks: the last of the cached layout, one more (the
# rows resident without the caches), the last resident one (the most
# shared memory a block takes), and 41,300 (2,582 nodes a block: the rows
# in global memory)
LAYOUT_EDGES = {
    "cached": (True, 0, (True, True)),
    "cached+1": (True, 1, (True, False)),
    "resident": (False, 0, (True, False)),
    "global-41300": (None, 41_300, (False, False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(LAYOUT_EDGES))
def test_cuda_kernel_at_layout_edges_equals_plain(edge):
    """Each layout's last node count at 16 blocks launches (its dynamic
    shared memory beside the kernel's static arrays within what a block
    takes) and equals the plain version, as does the first node count of
    the next layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cached, extra, want = LAYOUT_EDGES[edge]
    n_pods = 64
    pods = _edge_pods(n_pods)
    probe, _ = _plan(_edge_nodes(8), pods)
    n_nodes = extra if cached is None else 16 * _last_slice(probe, cached) + extra
    plan, batch = _plan(_edge_nodes(n_nodes), pods)
    assert plan.u == probe.u and not plan.ext
    cuda_plan = plan.to("cuda")
    shape = fused_scan.launch_shape(cuda_plan, 16)
    assert (shape.resident, shape.cached) == want
    rng = np.random.RandomState(n_nodes)
    scen = [(rng.rand(n_pods) < 0.9, rng.rand(n_nodes) < 0.95, batch.pinned_node)]
    ref = fused_scan.fused_scan_reference(plan, batch.class_of_pod, *scen[0])
    (got,) = _kernel(cuda_plan, batch.class_of_pod, scen, False, 16)
    _same(got, ref)
    assert (ref[0] >= 0).sum() > n_pods // 2


@pytest.mark.cuda
def test_cuda_static_smem_within_the_wrappers_count():
    """Every instantiation, as the card's compiler built it, has at most
    the static shared memory the wrapper counts beside a resident slice
    (static_smem: STATIC_SMEM for the base and B2 ones, STATIC_SMEM_STORE
    and STATIC_SMEM_TERMS for the storage and term ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    lib = fused_scan._library()
    for flags in range(64):
        if flags >> 4 and (flags & 7) != 7:
            continue  # storage / terms: the B2 blocks are always compiled in
        out = ctypes.c_int64(-1)
        assert lib.fused_scan_static_smem(flags, ctypes.byref(out)) == 0
        want = (fused_scan.STATIC_SMEM_TERMS if flags & 32 else
                fused_scan.STATIC_SMEM_STORE if flags & 16 else fused_scan.STATIC_SMEM)
        assert 0 < out.value <= want, (flags, out.value)


def tie_shape(n_nodes, n_pods):
    """Identical untainted nodes and a mix of requests: every step ties
    across all the slices of any partition, so the lowest index among
    the best must win."""
    nodes = [make_fake_node(f"node-{i:05d}", "8", "32Gi") for i in range(n_nodes)]
    sizes = [("250m", "256Mi"), ("500m", "1Gi"), ("1", "2Gi")]
    pods = [make_fake_pod(f"p-{i}", "default", *sizes[i % 3]) for i in range(n_pods)]
    return nodes, pods


def boundary_shape(n_nodes, n_pods, cluster=16):
    """Large nodes, except a pair of identical small ones at each of two
    slice boundaries of the partition the rule's slices give for
    `cluster` blocks (the last node of one slice, the first of the next,
    and the same before the last slice): every step's best node sits on
    a boundary (the default weights prefer the node the pod fills most)
    and ties with its neighbour across it."""
    bounds = fused_scan.slices(n_nodes, cluster)
    firsts = [lo for lo, hi in bounds if hi > lo][1:]
    big = {firsts[0] - 1, firsts[0], firsts[-1] - 1, firsts[-1]}
    nodes = [make_fake_node(f"node-{i:05d}", "4" if i in big else "32",
                            "16Gi" if i in big else "128Gi") for i in range(n_nodes)]
    pods = [make_fake_pod(f"p-{i}", "default", "500m", "1Gi") for i in range(n_pods)]
    return nodes, pods, sorted(big)


# (shape, nodes, pods): ties across every slice, and the best node on a
# slice boundary of the cluster-16 partition (37 nodes: slices of 3 and
# three empty blocks; 2,501: slices of 157)
TIE_CASES = {
    "ties-37": (tie_shape, 37, 90),
    "ties-2501": (tie_shape, 2_501, 400),
    "boundary-37": (boundary_shape, 37, 80),
    "boundary-2501": (boundary_shape, 2_501, 300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_CASES)
@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_cuda_kernel_on_cluster_ties_equals_plain(name, cluster):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape, n_nodes, n_pods = TIE_CASES[name]
    nodes, pods = shape(n_nodes, n_pods)[:2]
    plan, batch = _plan(nodes, pods)
    scen = [(np.ones(n_pods, bool), np.ones(n_nodes, bool), None)]
    ref = _plain_once(("tie", name), lambda: fused_scan.fused_scan_reference(
        plan, batch.class_of_pod, *scen[0]))
    (got,) = _kernel(plan.to("cuda"), batch.class_of_pod, scen, False, cluster)
    _same(got, ref)
    assert (ref[0] >= 0).all()


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
@pytest.mark.parametrize("cluster", CLUSTER_CASES)
@pytest.mark.parametrize("name", sorted(B2_CASES))
def test_cuda_ext_kernel_equals_plain(name, cluster):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n_nodes, n_pods, seed, kinds, devices, nf, pf = B2_CASES[name]
    plan, batch = _plan(*_b2_scenario(n_nodes, n_pods, seed, kinds, devices))
    assert plan.has_scal and plan.has_gpu and plan.has_ports and plan.has_pins
    rng = np.random.RandomState(seed + 100)
    scen = [(rng.rand(n_pods) < pf, rng.rand(n_nodes) < nf, batch.pinned_node)]
    ref = _plain_once(("b2", name), lambda: fused_scan.fused_scan_reference(
        plan, batch.class_of_pod, *scen[0]))
    (got,) = _kernel(plan.to("cuda"), batch.class_of_pod, scen, False, cluster)
    _same(got, ref)
    assert (ref[0] >= 0).any()
    if n_nodes < 100:  # the small cluster overflows
        assert (ref[0] == -1).any()


def _batch_case(b2, extra=0):
    """Several nodes per thread, per-scenario node masks, inactive pods
    and pins; with and without the B2 blocks; `extra` more scenarios of
    random node and pod masks."""
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
    scen += [(rng.rand(n_pods) < 0.9, rng.rand(n_nodes) < 0.3 + 0.05 * k, pin)
             for k in range(extra)]
    return plan, batch, scen


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", CLUSTER_CASES)
@pytest.mark.parametrize("b2", [False, True])
def test_cuda_batch_kernel_equals_batch_plain(b2, cluster):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    plan, batch, scen = _batch_case(b2)
    ref = _plain_once(("b6", b2), lambda: fused_scan.fused_scan_batch_reference(
        plan, batch.class_of_pod, scen))
    got = _kernel(plan.to("cuda"), batch.class_of_pod, scen, True, cluster)
    for g, r in zip(got, ref):
        _same(g, r)


@pytest.mark.cuda
def test_cuda_batch_in_waves_equals_batch_plain():
    """12 scenarios on clusters of 16: more than the card holds at once,
    so the clusters run in waves; the same rows as the plain version and
    as single launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    plan, batch, scen = _batch_case(False, extra=8)
    assert len(scen) == 12
    cuda_plan = plan.to("cuda")
    resident = fused_scan.max_active_clusters(cuda_plan, len(scen), True, 16)
    assert resident < len(scen), f"the card holds {resident} clusters of 16"
    ref = fused_scan.fused_scan_batch_reference(plan, batch.class_of_pod, scen)
    got = _kernel(cuda_plan, batch.class_of_pod, scen, True, 16)
    for g, r in zip(got, ref):
        _same(g, r)
    # the rule steps down to a size whose 12 clusters are resident
    c = fused_scan.choose_cluster(cuda_plan, len(scen), True)
    assert fused_scan.max_active_clusters(cuda_plan, len(scen), True, c) >= len(scen)
    single = _kernel(cuda_plan, batch.class_of_pod, scen[-1:], False, 8)
    _same(single[0], ref[-1])


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


# ---- B3, B4/B5 and B6 with those flags on thread-block clusters ----------

def _expand_sts(stss, nodes, app="t"):
    """Pods of StatefulSets in simulate()'s queue order."""
    from open_simulator_tpu_torch.models import workloads as wl
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods

    wl.reset_name_counter()
    res = ResourceTypes()
    res.stateful_sets = stss
    return _sort_app_pods(wl.generate_valid_pods_from_app(app, res, nodes))


def _sts(name, replicas, affinity=None, spread=(), cpu="500m"):
    spec = {"containers": [{"name": "c", "image": f"img-{name}", "resources": {
        "requests": {"cpu": cpu, "memory": "1Gi"}}}],
        "topologySpreadConstraints": list(spread)}
    if affinity:
        spec["affinity"] = affinity
    return {"kind": "StatefulSet", "apiVersion": "apps/v1",
            "metadata": {"name": name, "namespace": "t", "labels": {"app": name}},
            "spec": {"selector": {"matchLabels": {"app": name}}, "replicas": replicas,
                     "template": {"metadata": {"labels": {"app": name}}, "spec": spec}}}


def _spread(key, skew, hard, app):
    return {"maxSkew": skew, "topologyKey": key,
            "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": app}}}


def _term(key, app, weight=None):
    term = {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}
    return term if weight is None else {"weight": weight, "podAffinityTerm": term}


def _with_volumes(pods, every=2):
    """An LVM volume on every `every`-th pod."""
    import json

    out = []
    for i, pod in enumerate(pods):
        pod = copy.deepcopy(pod)
        if i % every == 0:
            pod["metadata"].setdefault("annotations", {})["simon/pod-local-storage"] = \
                json.dumps({"volumes": [{"kind": "LVM", "size": str((1 + i % 3) * GI),
                                         "scName": "open-local-lvm"}]})
        out.append(pod)
    return out


def _fixed_storage_anno():
    """Two VGs, one SSD and one HDD on every node: the storage rows'
    count does not follow the node count."""
    import json

    return json.dumps({
        "vgs": [{"name": "vg0", "capacity": str(100 * GI), "requested": "0"},
                {"name": "vg1", "capacity": str(40 * GI), "requested": str(GI)}],
        "devices": [{"name": "/dev/s0", "capacity": str(80 * GI), "mediaType": "ssd",
                     "isAllocated": "false"},
                    {"name": "/dev/h0", "capacity": str(200 * GI), "mediaType": "hdd",
                     "isAllocated": "false"}]})


HOST = "kubernetes.io/hostname"


def term_boundary_shape(n_nodes, n_pods, cluster=16, keys="all"):
    """A storage + term plan whose decisions straddle the slices of the
    `cluster`-block partition. Each rack holds the last node of one
    slice and the nodes of the next, so a rack's hard-spread count, its
    minimum and its soft-spread domain span two blocks; the small nodes
    sit on either side of two slice boundaries, so the first maximum
    falls on a boundary; zones alternate; every node has two VGs, an SSD
    and an HDD. Workloads, by `keys`: "hostname" (required anti-affinity,
    a hard and a soft spread, all node-owned rows), "zone" (a hard and a
    soft spread, a required affinity to its own pods: the bootstrap, a
    preferred anti-affinity: all shared rows) or "all" (both, and a rack
    workload with a hard and a soft spread and a preferred affinity to
    the hostname one). LVM volumes on every other pod."""
    bounds = fused_scan.slices(n_nodes, cluster)
    starts = [lo for lo, hi in bounds if hi > lo]
    firsts = starts[1:]
    small = {firsts[0] - 1, firsts[0], firsts[-1] - 1, firsts[-1]}

    def rack(i):
        return sum(1 for lo in starts if lo <= i + 1) - 1 if i + 1 < n_nodes else len(starts) - 1

    nodes = []
    for i in range(n_nodes):
        node = make_fake_node(f"node-{i:05d}", "4" if i in small else "32",
                              "16Gi" if i in small else "128Gi",
                              with_node_labels({"zone": f"z{i % 3}", "rack": f"r{rack(i)}"}))
        node["metadata"]["annotations"]["simon/node-local-storage"] = _fixed_storage_anno()
        nodes.append(node)
    stss = []
    if keys in ("all", "hostname"):
        stss.append(_sts("host", n_pods, {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_term(HOST, "host")]}},
            [_spread(HOST, 1, True, "host"), _spread(HOST, 1, False, "host")]))
    if keys in ("all", "zone"):
        stss.append(_sts("zone", n_pods, {"podAntiAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [_term("zone", "zone", 10)]}},
            [_spread("zone", 1, True, "zone"), _spread("zone", 1, False, "zone")]))
        stss.append(_sts("zaff", n_pods, {"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_term("zone", "zaff")]}},
            [_spread("zone", 2, False, "zaff")]))
    if keys == "all":
        stss.append(_sts("rack", n_pods, {"podAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [_term("rack", "host", 30)]}},
            [_spread("rack", 1, True, "rack"), _spread("rack", 2, False, "rack")]))
    pods = _expand_sts(stss, nodes)
    # interleave the workloads, cut to n_pods
    by_app = {}
    for pod in pods:
        by_app.setdefault(pod["metadata"]["labels"]["app"], []).append(pod)
    mixed = [p for group in zip(*by_app.values()) for p in group][:n_pods]
    return nodes, _with_volumes(mixed), sorted(small)


def many_slots_shape(n_nodes, n_pods, slots=6):
    """A class with `slots` hard and `slots` soft spread constraints on
    keys k0.. (node i has value i // (j + 1) % 3 of key kj) and a soft
    hostname spread: more slots than one cluster exchange folds."""
    labels = lambda i: {f"k{j}": f"v{i // (j + 1) % 3}" for j in range(slots)}
    nodes = [make_fake_node(f"node-{i:05d}", "16", "64Gi", with_node_labels(labels(i)))
             for i in range(n_nodes)]
    spread = [_spread(f"k{j}", 2 + j % 2, True, "many") for j in range(slots)]
    spread += [_spread(f"k{j}", 1 + j % 3, False, "many") for j in range(slots)]
    spread.append(_spread(HOST, 1, False, "many"))
    pods = _expand_sts([_sts("many", n_pods, spread=spread)], nodes)
    return nodes, pods


# storage, terms and both on clusters, single and batch, at the rule's C
# (None: 4 at these node counts) and at 2, 8 and 16
CLUSTER_BLOCK_CASES = {
    "b3": (lambda: _b3_scenario(2500, 600, 21, 6), fused_scan.STORE_KERNEL_NAME),
    "b4": (lambda: _b4_scenario(2500, 24, 20, 16, 22), fused_scan.TERMS_KERNEL_NAME),
    "b3-b4": (lambda: _b4_scenario(2100, 16, 25, 8, 23, storage=True),
              fused_scan.STORE_TERMS_KERNEL_NAME),
}
BIG_CLUSTERS = [None, 2, 8, 16]
_BUILT = {}


def _built(key, fn):
    if key not in _BUILT:
        _BUILT[key] = fn()
    return _BUILT[key]


def _masked_scenarios(n_nodes, n_pods, pin, seed, count):
    rng = np.random.RandomState(seed)
    scen = [(np.ones(n_pods, bool), np.ones(n_nodes, bool), pin),
            (rng.rand(n_pods) < 0.8, np.arange(n_nodes) % 7 != 0, pin),
            (np.ones(n_pods, bool), rng.rand(n_nodes) < 0.5, np.where(pin % 2 == 0, pin, -1))]
    scen += [(rng.rand(n_pods) < 0.9, rng.rand(n_nodes) < 0.3 + 0.05 * k, pin)
             for k in range(count - 3)]
    return scen[:count]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("cluster", BIG_CLUSTERS)
@pytest.mark.parametrize("name", sorted(CLUSTER_BLOCK_CASES))
def test_cuda_storage_terms_on_clusters_equals_plain(name, cluster, batch):
    """fused_scan_store, fused_scan_terms and fused_scan_store_terms, one
    scenario and a batch of three, on clusters of C blocks: placements
    and every final row (base, storage, value-space terms) equal the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    build, kernel = CLUSTER_BLOCK_CASES[name]
    plan, batch_enc = _built(name, lambda: _plan(*build()))
    assert fused_scan.kernel_name(plan) == kernel
    n_nodes, n_pods = plan.n, len(batch_enc.class_of_pod)
    pin = np.asarray(batch_enc.pinned_node)
    scen = _masked_scenarios(n_nodes, n_pods, pin, 31, 3 if batch else 1)
    cuda_plan = _built((name, "cuda"), lambda: plan.to("cuda"))
    ref = _plain_once((name, batch), lambda: fused_scan.fused_scan_batch_reference(
        cuda_plan, batch_enc.class_of_pod, scen))
    got = _kernel(cuda_plan, batch_enc.class_of_pod, scen, batch, cluster)
    if cluster is None:
        assert fused_scan.CLUSTERS[fused_scan.kernel_name(plan, batch)] == 4
    for g, r in zip(got, ref):
        _same(g, r)
    assert (ref[0][0] >= 0).sum() > n_pods // 4


# (builder, nodes, pods): the term boundary shape with every key, with
# hostname rows only (node-owned) and with zone rows only (shared, the
# required-affinity bootstrap), and a class with more hard and soft
# slots than one exchange round holds
TERM_SHAPES = {
    "boundary-all-40": (lambda c: term_boundary_shape(40, 60, c)[:2], 40),
    "boundary-all-2501": (lambda c: term_boundary_shape(2_501, 300, c)[:2], 2_501),
    "boundary-hostname-40": (lambda c: term_boundary_shape(40, 40, c, "hostname")[:2], 40),
    "boundary-zone-40": (lambda c: term_boundary_shape(40, 40, c, "zone")[:2], 40),
    "many-slots-40": (lambda c: many_slots_shape(40, 50), 40),
    "many-slots-2501": (lambda c: many_slots_shape(2_501, 200), 2_501),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 2, 16])
@pytest.mark.parametrize("name", sorted(TERM_SHAPES))
def test_cuda_term_shapes_on_clusters_equal_plain(name, cluster):
    """Shapes where the cross-block folds decide: a soft-spread domain
    whose eligible nodes lie in two blocks, a hard-spread minimum held
    only by another block, the first maximum on a slice boundary, the
    bootstrap, node-owned and shared rows alone, and more slots than an
    exchange folds at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    build, n_nodes = TERM_SHAPES[name]
    nodes, pods = build(16 if cluster is None else cluster)
    plan, batch = _plan(nodes, pods)
    assert plan.has_terms
    scen = [(np.ones(len(pods), bool), np.ones(n_nodes, bool), None)]
    ref = fused_scan.fused_scan_reference(plan, batch.class_of_pod, *scen[0])
    (got,) = _kernel(plan.to("cuda"), batch.class_of_pod, scen, False, cluster)
    _same(got, ref)
    assert (ref[0] >= 0).sum() > len(pods) // 4


def _edge_plan(n_nodes, pair=False):
    """The term boundary shape's workloads on n_nodes nodes of fixed
    storage rows and 5 contiguous racks (a replica that does not follow
    the node count); `pair`: also a key whose values each sit on two
    nodes (a shared row of n_nodes / 2 values)."""
    nodes, pods, _ = term_boundary_shape(64, 64, 16)
    proto = nodes[-1]
    wide = []
    for i in range(n_nodes):
        node = copy.deepcopy(proto)
        name = f"node-{i:05d}"
        node["metadata"]["name"] = name
        labels = node["metadata"]["labels"]
        labels.update({HOST: name, "zone": f"z{i % 3}", "rack": f"r{i * 5 // n_nodes}"})
        if pair:
            labels["pair"] = f"p{i // 2}"
        wide.append(node)
    if pair:
        pods = pods + _expand_sts([_sts("pair", 16, spread=[_spread("pair", 1, False, "pair")])],
                                  wide, app="pair")
    return _plan(wide, pods)


def _last_big_slice(plan):
    """The most nodes a block's slice of this storage + term plan holds
    resident beside the minima, the replica and the static arrays."""
    held = fused_scan.term_bytes(plan) + fused_scan.replica_bytes(plan)
    room = fused_scan.SMEM_PER_BLOCK - fused_scan.static_smem(plan) - held
    return room // fused_scan.slice_bytes(plan, 1)


# node counts at 16 blocks: the last whose slices are resident beside the
# replica, one more (the rows in global memory, the replica resident),
# and plans whose replica does not fit (a key whose values each sit on
# two nodes): at 16,000 nodes the slices stay resident, at 20,800 they
# do not either
BIG_EDGES = {"resident": (0, (True, True)), "resident+1": (1, (False, True)),
             "replica-global": (16_000, (True, False)),
             "both-global": (20_800, (False, False))}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(BIG_EDGES))
def test_cuda_storage_terms_at_layout_edges_equals_plain(edge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    nodes, want = BIG_EDGES[edge]
    if want[1]:
        probe, _ = _edge_plan(64)
        plan, batch = _edge_plan(16 * _last_big_slice(probe) + nodes)
        assert fused_scan.replica_len(plan) == fused_scan.replica_len(probe)
    else:
        plan, batch = _edge_plan(nodes, pair=True)
    cuda_plan = plan.to("cuda")
    shape = fused_scan.launch_shape(cuda_plan, 16)
    assert (shape.resident, shape.replica) == want, shape
    n_pods = len(batch.class_of_pod)
    scen = [(np.ones(n_pods, bool), np.ones(plan.n, bool), None)]
    ref = fused_scan.fused_scan_reference(cuda_plan, batch.class_of_pod, *scen[0])
    (got,) = _kernel(cuda_plan, batch.class_of_pod, scen, False, 16)
    _same(got, ref)


@pytest.mark.cuda
def test_cuda_storage_terms_batch_in_waves_equals_batch_plain():
    """12 storage + term scenarios on clusters of 16: more than the card
    holds at once, so they run in waves; the rule steps down."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    build, _ = CLUSTER_BLOCK_CASES["b3-b4"]
    plan, batch = _built("b3-b4", lambda: _plan(*build()))
    cuda_plan = _built(("b3-b4", "cuda"), lambda: plan.to("cuda"))
    scen = _masked_scenarios(plan.n, len(batch.class_of_pod), np.asarray(batch.pinned_node),
                             41, 12)
    assert fused_scan.max_active_clusters(cuda_plan, 12, True, 16) < 12
    ref = fused_scan.fused_scan_batch_reference(cuda_plan, batch.class_of_pod, scen)
    got = _kernel(cuda_plan, batch.class_of_pod, scen, True, 16)
    for g, r in zip(got, ref):
        _same(g, r)
    c = fused_scan.choose_cluster(cuda_plan, 12, True)
    assert fused_scan.max_active_clusters(cuda_plan, 12, True, c) >= 12


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


# ---- B6's pins-first mode (the outage scenarios of chaos and N+K) ---------

def _outage_scenarios(n_nodes, n_pods, seed, count):
    """Outage-shaped rows: a few nodes off, most pods pinned (some to a
    node that is off, some inactive), the rest free."""
    rng = np.random.RandomState(seed)
    scen = []
    for k in range(count):
        valid = rng.rand(n_nodes) > 0.1
        valid[k % n_nodes] = False
        pin = np.where(rng.rand(n_pods) < 0.6, rng.randint(n_nodes, size=n_pods), -1)
        scen.append((rng.rand(n_pods) > 0.05, valid, pin))
    return scen


# every B6 instantiation: base, B2, storage, terms, storage + terms
PINS_FIRST_CASES = {
    "base": lambda: _scenario(1200, 500, 51, True),
    "b2": lambda: _b2_scenario(1100, 500, 52),
    "b3": lambda: _b3_scenario(1500, 400, 53, 6),
    "b4": lambda: _b4_scenario(1500, 16, 20, 8, 54),
    "b3-b4": lambda: _b4_scenario(1300, 12, 25, 8, 55, storage=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 2, 16])
@pytest.mark.parametrize("name", sorted(PINS_FIRST_CASES))
def test_cuda_pins_first_batch_equals_plain(name, cluster):
    """The pins-first kernel (pinned pods' pass, then the free pods')
    equals its plain version row for row at every cluster size, and
    counts its launch under its own name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses

    plan, batch = _built(("pf", name), lambda: _plan(*PINS_FIRST_CASES[name]()))
    plan = _built(("pf", name, "cuda"), lambda: dataclasses.replace(
        plan.to("cuda"), has_pins=True))
    scen = _outage_scenarios(plan.n, len(batch.class_of_pod), 61, 5)
    ref = _plain_once(("pf", name), lambda: fused_scan.fused_scan_batch_reference(
        plan, batch.class_of_pod, scen, pins_first=True))
    name_k = fused_scan.PINS_FIRST_KERNEL_NAME
    before = fused_scan.LAUNCHES[name_k]
    if cluster is None:
        got = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen, pins_first=True)
    else:
        got = fused_scan._run_with_cluster(plan, batch.class_of_pod, scen, True, cluster,
                                           pins_first=True)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[name_k] == before + 1
    for g, r in zip(got, ref):
        _same(g, r)
    # the free pods ran: some land, and the two orders differ somewhere
    assert any(((r[0].cpu().numpy() >= 0) & (s[2] < 0)).any() for r, s in zip(ref, scen))


@pytest.mark.cuda
def test_cuda_pins_first_thousands_of_scenarios_in_waves():
    """2,000 outage scenarios in one launch: far more clusters than the
    card holds at once, so they run in waves at the rule's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses

    plan, batch = _plan(*_scenario(64, 150, 62, False))
    plan = dataclasses.replace(plan.to("cuda"), has_pins=True)
    scen = _outage_scenarios(plan.n, len(batch.class_of_pod), 63, 2000)
    c = fused_scan.choose_cluster(plan, len(scen), True)
    assert fused_scan.max_active_clusters(plan, len(scen), True, c) < len(scen)
    ref = fused_scan.fused_scan_batch_reference(plan, batch.class_of_pod, scen,
                                                pins_first=True)
    got = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen, pins_first=True)
    for g, r in zip(got, ref):
        _same(g, r)


# ---- the device observatory (obs/profile.py, obs/costs.py, obs/ledger.py)

@pytest.mark.cuda
def test_cuda_instrumented_launch_counts_and_times_on_the_card():
    """Each wrapper launch is one `launches_<site>` count and one
    `device_launches_total`, its CUDA-event time lands in the
    `launch/<site>` histogram once read, and the ledger polls the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from open_simulator_tpu_torch.obs import profile
    from open_simulator_tpu_torch.obs.histo import HISTOS
    from open_simulator_tpu_torch.obs.ledger import LEDGER
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    plan, batch, scen = _b1_case("overload-wide")
    plan = plan.to("cuda")
    before = profile.snapshot()
    site_before = COUNTERS.get("launches_cudatest")
    hist = HISTOS.summary().get("launch/cudatest", {}).get("count", 0)
    samples = LEDGER.samples
    for _ in range(3):
        fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen * 2, site="cudatest")
    torch.cuda.synchronize()
    profile.resolve_pending(wait=True)
    d = profile.delta(before)
    assert d["launches_total"] == d["device_launches_total"] == 3
    assert COUNTERS.get("launches_cudatest") - site_before == 3
    row = HISTOS.summary()["launch/cudatest"]
    assert row["count"] - hist == 3 and row["p50_ms"] > 0
    assert LEDGER.samples - samples == 3 and LEDGER.peak_bytes > 0
    assert d["device_transfer_h2d_bytes_total"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind,scenarios", [("b1", 1), ("b1", 4), ("fuzz", 1), ("fuzz", 3)])
def test_cuda_workspace_estimate_covers_the_measured_peak(kind, scenarios):
    """The cost count's workspace (obs/costs.py) is at or above what the
    caching allocator's peak rises by over one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import build_fuzz_scenario
    from open_simulator_tpu_torch.obs import costs

    if kind == "b1":
        plan, batch, scen = _b1_case("multi-node-threads")
    else:
        plan, batch = _plan(*build_fuzz_scenario(400, 800, seed=5))
        p = len(batch.class_of_pod)
        scen = [(np.ones(p, bool), np.ones(plan.n, bool), batch.pinned_node)]
    plan = plan.to("cuda")
    scen = scen * scenarios
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen, site="cudatest")
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    del out
    name = fused_scan.BATCH_KERNEL_NAME
    est = costs.workspace_bytes(plan, len(batch.class_of_pod), len(scen),
                                fused_scan.CLUSTERS[name])
    assert 0 < measured <= est


@pytest.mark.cuda
def test_cuda_predicted_split_on_the_card(monkeypatch):
    """Under a budget that holds two scenarios' workspace, a sweep's
    outage rows split before launch into chunks that fit, and the rows
    equal one unsplit launch's; a single row predicted not to fit is
    launched all the same (card work never moves to the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import dataclasses

    from open_simulator_tpu_torch.obs import costs
    from open_simulator_tpu_torch.runtime import guard

    plan, batch = _plan(*_scenario(64, 150, 62, False))
    plan = dataclasses.replace(plan.to("cuda"), has_pins=True)
    p = len(batch.class_of_pod)
    scen = _outage_scenarios(plan.n, p, 63, 8)
    whole = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen, pins_first=True)
    torch.cuda.synchronize()
    in_use = torch.cuda.memory_allocated()
    two = costs.workspace_bytes(plan, p, 2)
    monkeypatch.setenv("SIMON_DEVICE_MEM_BUDGET", str(int((in_use + two) / 0.92) + 1))
    sizes = []

    def evaluate(lo, hi):
        sizes.append(hi - lo)
        return fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen[lo:hi],
                                               pins_first=True)

    est = costs.CostRegistry().chunk_estimator("cudatest", plan, p)
    rows = guard.run_chunked(evaluate, len(scen), label="cudatest", estimate=est)
    assert max(sizes) <= 2 and sum(sizes) == len(scen)
    for g, r in zip(rows, whole):
        _same(g, r)
    monkeypatch.setenv("SIMON_DEVICE_MEM_BUDGET", "1")
    sizes.clear()
    rows = guard.run_chunked(evaluate, 2, label="cudatest", estimate=est)
    assert sizes == [1, 1]
    for g, r in zip(rows, whole):
        _same(g, r)


# ---- the shadow replay's single-pod probe and the timeline's windows

@pytest.mark.cuda
def test_cuda_shadow_probe_at_ten_thousand_nodes_equals_plain():
    """Each decision of a shadow replay at the default scenario's 10,000
    nodes is one single-pod launch of the base kernel on the card, and
    every probe answers what the plain version answers on the CPU (the
    real decisions commit alike, so the mirrors stay equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import build_scenario
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.shadow.log import Step
    from open_simulator_tpu_torch.shadow.replay import ShadowReplayer
    from open_simulator_tpu_torch.twin.deltas import state_dict

    nodes, pods = build_scenario(10_000, 40)
    steps = [Step(seq=0, kind="delta", deltas=[
        {"op": "place_pod", "pod": dict(copy.deepcopy(pods[i]), spec=dict(
            pods[i]["spec"], nodeName=f"node-{i * 97:05d}"))} for i in range(10)])]
    steps += [Step(seq=i, kind="decision", pod=copy.deepcopy(pods[i]),
                   node=f"node-{(i * 389) % 10_000:05d}") for i in range(10, 40)]
    out = {}
    for device in ("cuda", "cpu"):
        cluster = ResourceTypes()
        cluster.nodes = copy.deepcopy(nodes)
        rp = ShadowReplayer(cluster, engine="cuda", device=device, explain_divergences=False)
        before = fused_scan.LAUNCHES[fused_scan.KERNEL_NAME]
        outcomes = [rp.step(copy.deepcopy(st)) for st in steps]
        launched = fused_scan.LAUNCHES[fused_scan.KERNEL_NAME] - before
        out[device] = ([(o.cls, o.simon_node) for o in outcomes if o is not None],
                       state_dict(rp._app), launched)
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][2] == 30 and out["cpu"][2] == 0


@pytest.mark.cuda
def test_cuda_timeline_windows_equal_plain():
    """A timeline at 1,000 nodes (day-0 pods on every untainted node) on
    the card: every window's and probe decision's pins-first launch
    equals run_fused_scan_batch on the CPU plain version, and the report
    equals the same run on a CPU device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import build_scenario, cap_node
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.timeline.autoscaler import parse_policies
    from open_simulator_tpu_torch.timeline.compare import run_policies
    from open_simulator_tpu_torch.timeline.events import SyntheticSpec, generate_synthetic

    nodes, _ = build_scenario(1_000, 0)
    day0 = [make_fake_pod(f"day0-{i}", "day0", str(int(n["status"]["allocatable"]["cpu"]) - 1),
                          "2Gi", with_node_name(n["metadata"]["name"]))
            for i, n in enumerate(nodes) if not n.get("spec", {}).get("taints")]
    spec = SyntheticSpec(arrivals=1_500, arrival_rate=20.0, mean_lifetime_s=300.0,
                         long_running_frac=0.7, spot_frac=0.01, spot_hazard=1 / 2000.0, seed=11)
    events = generate_synthetic(spec, [n["metadata"]["name"] for n in nodes])
    calls = []
    real = fused_scan.run_fused_scan_batch

    def recorded(plan, cls, scenarios, pins_first=False, **kw):
        outs = real(plan, cls, scenarios, pins_first=pins_first, **kw)
        if plan.device.type == "cuda":
            calls.append((plan, cls, list(scenarios), pins_first, outs))
        return outs

    reports = {}
    fused_scan.run_fused_scan_batch = recorded
    try:
        for device in ("cuda", "cpu"):
            cluster = ResourceTypes()
            cluster.nodes = copy.deepcopy(nodes)
            cluster.pods = copy.deepcopy(day0)
            cmp_ = run_policies(cluster, copy.deepcopy(events),
                                parse_policies(["static:0", "threshold", "probe"]),
                                new_node_spec=cap_node("template", 96, 384), max_nodes=6,
                                cadence_s=30.0, warmup_s=10.0, device=device)
            reports[device] = cmp_.as_dict()
    finally:
        fused_scan.run_fused_scan_batch = real
    assert reports["cuda"] == reports["cpu"]
    assert calls and len(calls) == reports["cuda"]["dispatches"]
    assert all(pf for *_x, pf, _o in calls)
    for plan, cls, scenarios, pf, outs in calls[:6] + calls[-2:]:
        want = fused_scan.run_fused_scan_batch(plan.to("cpu"), cls, scenarios, pins_first=True)
        for g, w in zip(outs, want):
            _same((g[0].cpu(), {k: v.cpu() for k, v in g[1].items()}), w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["masked-pins", "multi-node-threads"])
def test_cuda_scan_scenarios_equals_plain(name):
    """The serve tick's scenario scan on the card: rows masked at
    random, the batch's pins committed in every row, all rows ONE launch
    of the batch kernel at the site `scenario_scan`; equal to the same
    engine call on the CPU (the plain version), INACTIVE where masked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from open_simulator_tpu_torch.scheduler.engine import TorchEngine

    n_nodes, n_pods, seed, pins, _nf, pf, huge = CASES[name]
    nodes, pods = _scenario(n_nodes, n_pods, seed, pins, huge)
    rng = np.random.RandomState(seed + 7)
    actives = rng.rand(5, n_pods) < pf
    actives[0] = True
    out = {}
    for device in ("cuda", "cpu"):
        eng = TorchEngine(Oracle(copy.deepcopy(nodes)), device=device)
        eng.begin_batch(copy.deepcopy(pods))
        before = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME]
        out[device] = eng.scan_scenarios(actives)
        launched = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME] - before
        assert launched == (1 if device == "cuda" else 0)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    assert (out["cuda"][~actives] == fused_scan.INACTIVE).all()
    assert (out["cuda"][actives] >= -1).all()


@pytest.mark.cuda
def test_cuda_session_answers_the_cpu_session_bodies():
    """A serve Session on the card answers the bodies a `device="cpu"`
    session answers, before and after cluster deltas (one failing
    request, a priority one routed serial), with the same committed
    state; each coalesced tick is one batch launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import build_scenario
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.serve.session import Session, WhatIfRequest
    from open_simulator_tpu_torch.twin.deltas import ClusterDelta

    nodes, pods = build_scenario(300, 900)

    def request(name, replicas, cpu="500m", priority=None):
        spec = {"containers": [{"name": "c", "image": "i", "resources": {
            "requests": {"cpu": cpu, "memory": "1Gi"}}}]}
        if priority is not None:
            spec["priority"] = priority
        res = ResourceTypes()
        res.deployments = [{"kind": "Deployment", "metadata": {"name": name, "namespace": "q"},
                            "spec": {"replicas": replicas, "template": {"spec": spec}}}]
        return WhatIfRequest(apps=[AppResource(name, res)])

    reqs = [request("a", 20), request("b", 5, cpu="200"), request("c", 50),
            request("d", 3, priority=1000)]
    deltas = [ClusterDelta(kind="pod_evict", namespace=pods[i]["metadata"]["namespace"],
                           name=pods[i]["metadata"]["name"]) for i in (850, 870)]
    deltas.append(ClusterDelta(kind="pod_arrive", pod=copy.deepcopy(pods[0]) | {
        "metadata": {"name": "late", "namespace": "q"}}))
    out = {}
    for device in ("cuda", "cpu"):
        reset_name_counter()
        cluster = ResourceTypes()
        cluster.nodes = copy.deepcopy(nodes)
        cluster.pods = copy.deepcopy(pods)
        s = Session(cluster, device=device)
        before = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME]
        bodies = [r.body for r in s.evaluate_batch(reqs)]
        outcomes = [s.apply_delta(copy.deepcopy(d)) for d in deltas]
        bodies += [r.body for r in s.evaluate_batch(reqs)]
        launched = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME] - before
        out[device] = (bodies, outcomes, s._committed_scan().state_digest(),
                       s.state_digest(), launched)
    assert out["cuda"][:4] == out["cpu"][:4]
    assert out["cuda"][4] == 2 and out["cpu"][4] == 0


@pytest.mark.cuda
def test_cuda_twin_queries_equal_the_cpu_twin():
    """The twin on the card answers the `device="cpu"` twin's bodies: a
    feed tailed at agreement 1.0, a what-if (its one B1 launch == B1's
    plain version on its inputs), a drain of a zone (one launch), N+K
    (one launch a trial) and a forecast (one pins-first launch a window
    that places pods)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from chip_smoke import twin_cluster
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.scheduler.core import AppResource
    from open_simulator_tpu_torch.shadow.record import record_simulation
    from open_simulator_tpu_torch.twin import queries
    from open_simulator_tpu_torch.twin.mirror import ClusterMirror, FeedSource

    nodes, bound, feed = twin_cluster(300, 600, 40)
    cluster = ResourceTypes()
    cluster.nodes, cluster.pods = nodes, bound
    app = ResourceTypes()
    app.pods = feed
    reset_name_counter()
    steps = record_simulation(cluster, [AppResource("feed", app)])
    whatif_pods = ResourceTypes()
    whatif_pods.deployments = [{"kind": "Deployment", "metadata": {"name": "w", "namespace": "q"},
                                "spec": {"replicas": 30, "template": {"spec": {"containers": [{
                                    "name": "c", "image": "i", "resources": {"requests": {
                                        "cpu": "2", "memory": "4Gi"}}}]}}}}]
    out, calls = {}, []
    real = fused_scan.run_fused_scan

    def record(plan, cls, active, valid, pinned=None, site="scan"):
        outs = real(plan, cls, active, valid, pinned, site=site)
        calls.append((plan, cls, active, valid, pinned, outs))
        return outs

    for device in ("cuda", "cpu"):
        mirror = ClusterMirror(copy.deepcopy(cluster), FeedSource(steps, batch=64), device=device)
        mirror.bootstrap()
        while not mirror.source.exhausted:
            mirror.poll_once()
        mirror.drain_backlog()
        launches = []
        answers = []
        for call in (lambda: queries.whatif(mirror, [AppResource("w", whatif_pods)]),
                     lambda: queries.drain(mirror, selector={"zone": "z5"}),
                     lambda: queries.nplusk(mirror, k=1, trials=4),
                     lambda: queries.forecast(mirror, horizon_s=120.0, arrival_rate=1.0,
                                              policy="static:0")):
            fused_scan.reset_launch_counts()
            if device == "cuda" and not answers:
                fused_scan.run_fused_scan = record
            try:
                doc = call()
            finally:
                fused_scan.run_fused_scan = real
            launches.append(dict(fused_scan.LAUNCHES))
            answers.append({k: v for k, v in doc.items() if k != "mirror"})
        out[device] = (answers, mirror.state_digest(), mirror.stats()["agreementRate"],
                       launches)
    assert out["cuda"][:3] == out["cpu"][:3] and out["cuda"][2] == 1.0
    kinds = out["cuda"][3]
    assert kinds[0][fused_scan.KERNEL_NAME] == kinds[1][fused_scan.KERNEL_NAME] == 1
    assert kinds[2][fused_scan.KERNEL_NAME] == 4
    assert kinds[3][fused_scan.PINS_FIRST_KERNEL_NAME] == out["cuda"][0][3]["dispatches"] >= 1
    plan, cls, active, valid, pinned, outs = calls[0]
    want = fused_scan.fused_scan_reference(plan, cls, active, valid, pinned)
    assert torch.equal(outs[0].cpu(), want[0].cpu())
    for k in want[1]:
        assert torch.equal(outs[1][k].cpu(), want[1][k].cpu()), k


@pytest.mark.cuda
def test_cuda_store_round_trip_on_the_card(tmp_path):
    """A store filled by one process serves the next one's fused_scan.cu
    library (no nvcc build), and its B1 launch == the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SIMON_AOT_STORE=str(tmp_path / "store"))
    code = "import sys, chip_smoke; sys.exit(chip_smoke.store_child(*sys.argv[1:]))"
    docs = []
    for tag in ("fill", "load"):
        out = subprocess.run([sys.executable, "-c", code, str(tmp_path / tag), "300", "200"],
                             cwd=root, env=env, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        docs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    fill, load = docs
    assert fill["nvcc_builds_total"] == 1 and fill["aot_store_save_total"] == 1
    assert load["nvcc_builds_total"] == 0 and load["aot_store_hit_total"] == 1
    assert fill["launches"] == load["launches"] == 1
    assert fill["max_abs_err"] == load["max_abs_err"] == 0
    assert fill["library"] == load["library"]


@pytest.mark.cuda
def test_cuda_fleet_kill9_replacement_builds_nothing_and_restores_the_state(tmp_path):
    """`simon fleet --replicas 2` on the card, a fresh fleet directory:
    r0 builds the kernel library into the shared store, r1 loads it; a
    delta journaled for r0's tenant, r0 killed with SIGKILL, the probe
    loop respawns it; the replacement loads the library (0 nvcc builds),
    restores the dead replica's state digest and deltaSeq 1, and its
    ticks are batch-kernel launches; SIGTERM drains with exit 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replicas run the kernels")
    import json
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    from open_simulator_tpu_torch.fleet.hashing import HashRing

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = tmp_path / "fleet.yaml"
    cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: fleet}\n"
                   f"spec:\n  cluster: {{customConfig: {root}/example/cluster/demo}}\n")

    def http(url, doc=None, tenant=None):
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Simon-Tenant"] = tenant
        req = urllib.request.Request(url, data=None if doc is None else json.dumps(doc).encode(),
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, dict(resp.headers), resp.read()

    def sample(url, name):
        for line in http(url + "/metrics")[2].decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
        raise AssertionError(name)

    def replica(base, slot):
        doc = json.loads(http(base + "/healthz")[2])
        return next(r for r in doc["replicas"] if r["id"] == slot)

    proc = subprocess.Popen(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "fleet", "-f", str(cfg),
         "--replicas", "2", "--port", "0", "--fleet-dir", str(tmp_path / "fleet"),
         "--probe-interval", "0.5"], cwd=root, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "simon fleet listening on http://" in line, line
        base = line.split("listening on ", 1)[1].split()[0]
        tenant = next(f"t{i}" for i in range(100) if HashRing(["r0", "r1"]).route(f"t{i}") == "r0")
        pod = {"kind": "Pod", "metadata": {"name": "late", "namespace": "x"},
               "spec": {"containers": [{"name": "c", "image": "i", "resources": {
                   "requests": {"cpu": "100m", "memory": "64Mi"}}}]}}
        what_if = {"apps": [{"name": "w", "yaml": json.dumps(
            {**pod, "metadata": {"name": "w", "namespace": "x"}})}]}
        assert http(base + "/v1/simulate", what_if, tenant)[0] == 200
        status, hdrs, _b = http(base + "/v1/cluster-delta", {"kind": "pod_arrive", "pod": pod},
                                tenant)
        assert status == 200 and hdrs["X-Simon-Fleet-Replica"] == "r0"
        dead, r1 = replica(base, "r0"), replica(base, "r1")
        assert sample(dead["url"], "simon_nvcc_builds_total") == 1
        assert sample(r1["url"], "simon_nvcc_builds_total") == 0
        digest = json.loads(http(dead["url"] + "/v1/state-digest")[2])
        os.kill(dead["pid"], signal.SIGKILL)
        status, hdrs, rerouted = http(base + "/v1/simulate", what_if, tenant)
        assert status == 200 and hdrs["X-Simon-Fleet-Replica"] == "r1"
        assert http(r1["url"] + "/v1/simulate", what_if)[2] == rerouted
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            new = replica(base, "r0")
            if new["restarts"] == 1 and new["status"] == "up":
                break
            time.sleep(0.2)
        assert new["restarts"] == 1 and new["pid"] != dead["pid"]
        assert json.loads(http(new["url"] + "/v1/state-digest")[2]) == digest
        assert digest["deltaSeq"] == 1
        assert sample(new["url"], "simon_nvcc_builds_total") == 0
        assert http(base + "/v1/simulate", what_if, tenant)[1]["X-Simon-Fleet-Replica"] == "r0"
        ticks = sample(new["url"], "simon_serve_batches_total")
        b6 = sample(new["url"], 'simon_launches_site_total{site="scenario_scan"}')
        assert ticks >= 1 and b6 == ticks + 1  # each tick, and the warm-up
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        proc.stdout.close()
    assert rc == 0


# -- the device mesh (parallel/mesh.py) on the card -----------------------


def _mesh_devices(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if kind == "cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    from open_simulator_tpu_torch.parallel import mesh as pmesh

    devices = (["cuda:0", "cuda:0"] if kind == "one-card"
               else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    return pmesh.Mesh(devices)


def _mesh_sweep(n_base=40, replicas=300, max_count=8):
    from open_simulator_tpu.testing import make_fake_deployment
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep
    from open_simulator_tpu_torch.scheduler.core import AppResource

    cluster = ResourceTypes()
    cluster.nodes = [make_fake_node(f"node-{i}", "8", "32Gi",
                                    with_node_labels({"zone": f"z{i % 3}"}))
                     for i in range(n_base)]
    res = ResourceTypes()
    res.deployments = [make_fake_deployment("web", "d", replicas, "1", "2Gi")]
    reset_name_counter()
    return CapacitySweep(cluster, [AppResource("d", res)],
                         make_fake_node("template", "8", "32Gi"), max_count, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one-card", "cards"])
def test_cuda_scenario_axis_is_one_batch_launch_a_shard(kind):
    """probe_many and probe_scenarios split over the mesh: one launch of
    the batch kernel (pins-first for the rows) a shard, each share's
    answers those of the one-launch run."""
    mesh = _mesh_devices(kind)
    sweep = _mesh_sweep()
    counts = list(range(8))
    plain = sweep.probe_many(counts)
    sweep.mesh = mesh
    before = fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME]
    got = sweep.probe_many(counts)
    assert fused_scan.LAUNCHES[fused_scan.BATCH_KERNEL_NAME] - before == mesh.size
    assert (got.placements == plain.placements).all()
    assert (got.unscheduled == plain.unscheduled).all()
    assert (got.cpu_util == plain.cpu_util).all()
    valids = np.stack([sweep.node_valid(c) for c in counts])
    valids[:, 3] = False
    actives = np.stack([sweep.pod_active(v) for v in valids])
    pins = np.tile(np.asarray(sweep.batch.pinned_node), (len(counts), 1))
    before = fused_scan.LAUNCHES[fused_scan.PINS_FIRST_KERNEL_NAME]
    rows = sweep.probe_scenarios(valids, actives, pins)
    assert fused_scan.LAUNCHES[fused_scan.PINS_FIRST_KERNEL_NAME] - before == mesh.size
    sweep.mesh = None
    for g, w in zip(rows, sweep.probe_scenarios(valids, actives, pins)):
        assert (np.asarray(g) == np.asarray(w)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one-card", "cards"])
def test_cuda_node_sharded_torch_scan_equals_unsharded(kind, monkeypatch):
    """A custom-score-plugin batch past the (lowered) node threshold
    through TorchEngine.scan_active rides the node-sharded torch scan on
    the card: the placements of the unsharded torch scan on the card and
    on the CPU."""
    from open_simulator_tpu_torch.scheduler.engine import TorchEngine
    from open_simulator_tpu_torch.scheduler.plugins import SchedulerPlugin, default_registry

    mesh = _mesh_devices(kind)
    monkeypatch.setenv("SIMON_MESH_NODE_THRESHOLD", "16")

    class Digits(SchedulerPlugin):
        name = "digits"
        normalize = "minmax"

        def score(self, pod, node):
            return int("".join(c for c in node["metadata"]["name"] if c.isdigit())) % 7

    nodes, pods = _scenario(64, 120, 3, pins=True)
    default_registry.clear()
    default_registry.register(Digits())
    try:
        out = {}
        for label, dev, m in (("mesh", "cuda", mesh), ("card", "cuda", None),
                              ("cpu", "cpu", None)):
            eng = TorchEngine(Oracle(copy.deepcopy(nodes)), device=dev)
            eng.mesh = m
            eng.begin_batch(copy.deepcopy(pods))
            out[label] = eng.scan_active(np.ones(len(pods), bool))
    finally:
        default_registry.clear()
    assert (out["mesh"] == out["card"]).all() and (out["card"] == out["cpu"]).all()
