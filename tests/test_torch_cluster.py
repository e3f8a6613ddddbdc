"""The cluster design of the fused scan's instantiations
(open_simulator_tpu_torch/ops/fused_scan.py, csrc/fused_scan.cu): one
scenario runs on a thread-block cluster of C blocks, each owning a
contiguous node slice.

On the CPU: the rule that picks C, the slices, the shared-memory
layout (with the storage and term rows and the replicas of a storage
+ term plan), the split of term rows into node-owned and shared ones,
the launch's argument vector, and the plain version against the JAX
package (exactly: placements and int64 rows are integers) on shapes
where the cluster's cross-block fold decides every step — identical
nodes, where each step ties across all slices; node counts where the
best node sits on the last node of one slice and the first of the
next; storage + term plans whose racks straddle slice boundaries (a
hard-spread minimum and a soft-spread domain in two blocks); and more
spread slots than one exchange folds. The kernel itself at every C is
held against the plain version on the card (tests/test_torch_cuda.py)."""

import copy
import dataclasses
import importlib
import re

import numpy as np
import pytest

import jax.numpy as jnp

from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu.ops import scan as scan_ops
from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
from open_simulator_tpu.testing import make_fake_node, make_fake_pod
from open_simulator_tpu_torch.ops import fused_scan
from test_torch_cuda import (  # the same shapes run on the card
    boundary_shape,
    many_slots_shape,
    term_boundary_shape,
    tie_shape,
)

JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"
STATE = fused_scan.STATE_FIELDS


def _encode(pkg, nodes, pods):
    oracle_mod = importlib.import_module(f"{pkg}.scheduler.oracle")
    enc = importlib.import_module(f"{pkg}.ops.encode")
    oracle = oracle_mod.Oracle(copy.deepcopy(nodes))
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return cluster, batch, dyn, enc.features_of_batch(cluster, batch)


def _port_plan(nodes, pods):
    cluster, batch, dyn, features = _encode(PORT_PKG, nodes, pods)
    return fused_scan.build_plan(cluster, batch, dyn, features, device="cpu"), batch


# ---- the rule -----------------------------------------------------------

def _card(per_c):
    """A max_active for a card that holds per_c[c] clusters of c."""
    return lambda c: per_c[c]


# an H100-like card: 132 SMs, one block an SM, clusters of 16 limited by
# the GPCs
H100_LIKE = _card({1: 132, 2: 66, 4: 32, 8: 16, 16: 7})
ROOMY = _card({1: 10**6, 2: 10**6, 4: 10**6, 8: 10**6, 16: 10**6})


@pytest.mark.parametrize("n", [1, 37, 600, 640, 641, 1280, 1281, 2500, 2501, 5000, 10_000,
                               10_100, 25_000, 100_000])
def test_cluster_size_follows_the_node_count(n):
    c = fused_scan.cluster_size(n, 1, ROOMY)
    assert c in fused_scan.CLUSTER_SIZES
    m = -(-n // c)
    # the smallest size whose slices hold SLICE_NODES nodes, at most 16
    assert m <= fused_scan.SLICE_NODES or c == fused_scan.CLUSTER_SIZES[-1]
    if c > 1:
        assert -(-n // (c // 2)) > fused_scan.SLICE_NODES
    if n <= fused_scan.SLICE_NODES:
        assert c == 1
    # one rule for every instantiation: it reads only the node count and
    # what the card holds
    assert fused_scan.cluster_size(n, 1, _card({1: 1, 2: 1, 4: 1, 8: 1, 16: 1})) == c


def test_cluster_size_of_the_main_path_shapes():
    # the capacity plan's single probe and pair at 10,000 (+100) nodes
    assert fused_scan.cluster_size(10_000, 1, H100_LIKE) == 16
    assert fused_scan.cluster_size(10_100, 2, H100_LIKE) == 16
    assert fused_scan.cluster_size(1_000, 1, H100_LIKE) == 2
    # a storage + term plan's three scans follow the same rule
    assert fused_scan.cluster_size(10_000, 3, H100_LIKE) == 16


@pytest.mark.parametrize("scenarios", [1, 2, 7, 8, 12, 16, 17, 40, 66, 67, 132, 133, 500])
@pytest.mark.parametrize("n", [2_000, 10_000])
def test_cluster_size_keeps_a_batch_resident(scenarios, n):
    """C never exceeds what the card holds for S clusters when a smaller
    C would hold them; when none would, the batch runs in waves of
    single blocks."""
    want = fused_scan.cluster_size(n, 1, ROOMY)
    c = fused_scan.cluster_size(n, scenarios, H100_LIKE)
    assert c in fused_scan.CLUSTER_SIZES and c <= want
    fitting = [k for k in fused_scan.CLUSTER_SIZES if k <= want and H100_LIKE(k) >= scenarios]
    if fitting:
        assert c == max(fitting)
    else:
        assert c == 1


@pytest.mark.parametrize("n,c", [(1, 1), (1, 16), (37, 16), (48, 16), (2_501, 16), (2_500, 4),
                                 (10_000, 16), (10_100, 16), (10_001, 8), (7, 2), (640, 1)])
def test_slices_cover_the_node_axis(n, c):
    got = fused_scan.slices(n, c)
    assert len(got) == c
    assert got[0][0] == 0 and got[-1][1] == n
    for (lo, hi), (lo2, _hi2) in zip(got, got[1:]):
        assert lo <= hi == lo2  # contiguous, no gap, no overlap
    m = -(-n // c)
    assert all(hi - lo <= m for lo, hi in got)
    assert sum(hi - lo for lo, hi in got) == n


def _b2_nodes_pods(n_nodes=6, n_pods=8, kinds=3, devices=4):
    """A plan with all three B2 blocks (scalars, GPU share, hostPorts)."""
    names = [f"example.com/r{k}" for k in range(kinds)]
    nodes = []
    for i in range(n_nodes):
        node = make_fake_node(f"node-{i}", "32", "128Gi")
        node["status"]["allocatable"].update({nm: "4" for nm in names})
        for section in ("allocatable", "capacity"):
            node["status"].setdefault(section, {}).update({
                "alibabacloud.com/gpu-count": str(devices),
                "alibabacloud.com/gpu-mem": str(32 * devices)})
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        pod = make_fake_pod(f"p-{i}", "default", "1", "1Gi")
        if i % 3 == 0:
            pod["spec"]["containers"][0]["resources"]["requests"][names[i % kinds]] = "1"
        elif i % 3 == 1:
            pod["spec"]["containers"][0]["ports"] = [
                {"containerPort": 8000 + i, "hostPort": 8000 + i, "protocol": "TCP"}]
        else:
            pod["metadata"]["annotations"] = {"alibabacloud.com/gpu-mem": "8",
                                              "alibabacloud.com/gpu-count": "1"}
        pods.append(pod)
    return nodes, pods


@pytest.mark.parametrize("n", [37, 2_501, 10_000, 10_100, 25_000, 40_000, 100_000])
@pytest.mark.parametrize("blocks", ["base", "b2"])
def test_resident_slices_fit_in_shared_memory(n, blocks):
    """A slice marked resident fits in a block's 232,448 bytes beside
    the static arrays, with the B2 rows counted, and with the passes'
    per-(class, node) caches when it is marked cached; one that does not
    fit runs in global memory with no dynamic shared memory."""
    if blocks == "base":
        plan, _ = _port_plan([make_fake_node(f"node-{i}", "8", "32Gi") for i in range(4)],
                             [make_fake_pod("p", "default", "1", "1Gi")])
        assert not plan.ext
    else:
        plan, _ = _port_plan(*_b2_nodes_pods())
        assert plan.has_scal and plan.has_gpu and plan.has_ports
    wide = dataclasses.replace(plan, n=n)  # only the node count sizes a slice
    d = fused_scan.block_dims(plan)
    per_node = 8 * (11 + 2 * d["k"] + (3 + d["g"] if plan.has_gpu else 0)) + 4 * d["w"] + 1
    for c in fused_scan.CLUSTER_SIZES:
        shape = fused_scan.launch_shape(wide, c)
        m = -(-n // c)
        caches = 8 * ((2 * plan.u + 1) * m + 6 * plan.u)
        assert fused_scan.slice_bytes(wide, m) == m * per_node
        assert fused_scan.cache_bytes(wide, m) == caches
        if shape.resident:
            assert shape.smem == m * per_node + (caches if shape.cached else 0)
            assert shape.smem + fused_scan.STATIC_SMEM <= fused_scan.SMEM_PER_BLOCK == 232_448
            if not shape.cached:
                assert shape.smem + caches + fused_scan.STATIC_SMEM > fused_scan.SMEM_PER_BLOCK
            assert shape.layout == 1 | (2 if shape.cached else 0)
        else:
            assert shape.smem == 0 and not shape.cached and shape.layout == 0
            assert m * per_node + fused_scan.STATIC_SMEM > fused_scan.SMEM_PER_BLOCK
        assert shape.cluster == c
    # the main path's shape: 10,000 nodes on 16 blocks stay resident,
    # with the caches
    if n <= 10_100 and blocks == "base":
        assert fused_scan.launch_shape(wide, 16).cached


@pytest.mark.parametrize("kind", ["base", "store", "terms"])
def test_static_smem_counts_the_kernels_arrays(kind):
    """STATIC_SMEM, STATIC_SMEM_STORE and STATIC_SMEM_TERMS are the sums of
    the kernel's __shared__ int64 arrays as the base and B2, the storage
    and the term instantiations size them (kBig and kTerms as each has
    them)."""
    src = fused_scan.SOURCE.read_text()
    body = src[src.index("fused_scan_kernel("):]
    body = body[:body.index("extern __shared__")]
    flags = {"base": {"kBig": False, "kTerms": False}, "store": {"kBig": True, "kTerms": False},
             "terms": {"kBig": True, "kTerms": True}}[kind]
    consts = {"kWarps": 32, "kMaxCluster": 16, "kRound": fused_scan.KROUND}
    total = 0
    decls = re.findall(r"__shared__ int64_t \w+((?:\s*\[[^\]]+\])+);", body)
    assert len(decls) == 7
    for dims in decls:
        count = 1
        for dim in re.findall(r"\[([^\]]+)\]", dims):
            m = re.fullmatch(r"\s*(\w+) \? (\w+) : (\w+)\s*", dim)
            if m:
                dim = m.group(2) if flags[m.group(1)] else m.group(3)
            count *= int(consts.get(dim.strip(), dim))
        total += 8 * count
    want = {"base": fused_scan.STATIC_SMEM, "store": fused_scan.STATIC_SMEM_STORE,
            "terms": fused_scan.STATIC_SMEM_TERMS}[kind]
    assert total == want == {"base": 2_712, "store": 4_632, "terms": 7_936}[kind]
    src_round = re.search(r"constexpr int kRound = (\d+);", src)
    assert int(src_round.group(1)) == fused_scan.KROUND


def _edge(plan, c, cached):
    """The largest slice (nodes a block) of a plan at cluster size c
    whose layout is resident (and cached, when `cached`)."""
    def fits(m):
        need = fused_scan.slice_bytes(plan, m) + (fused_scan.cache_bytes(plan, m) if cached else 0)
        return need + fused_scan.STATIC_SMEM <= fused_scan.SMEM_PER_BLOCK
    m = 1
    while fits(m + 1):
        m += 1
    return m


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("blocks", ["base", "b2"])
@pytest.mark.parametrize("layout", ["resident", "cached"])
def test_layout_edges_fit_in_shared_memory(layout, blocks, cluster):
    """At the last node count of each layout (its slices as large as
    shared memory takes) the shape keeps that layout within 232,448
    bytes; one node more takes the next layout (cached -> resident ->
    global rows)."""
    if blocks == "base":
        plan, _ = _port_plan([make_fake_node(f"node-{i}", "8", "32Gi") for i in range(4)],
                             [make_fake_pod("p", "default", "1", "1Gi")])
    else:
        plan, _ = _port_plan(*_b2_nodes_pods())
    m = _edge(plan, cluster, layout == "cached")
    at = fused_scan.launch_shape(dataclasses.replace(plan, n=cluster * m), cluster)
    past = fused_scan.launch_shape(dataclasses.replace(plan, n=cluster * m + 1), cluster)
    assert at.resident and at.cached == (layout == "cached")
    assert at.smem + fused_scan.STATIC_SMEM <= fused_scan.SMEM_PER_BLOCK
    if layout == "cached":
        assert past.resident and not past.cached
    else:
        assert not past.resident and past.smem == 0
    assert past.smem + fused_scan.STATIC_SMEM <= fused_scan.SMEM_PER_BLOCK


def test_base_plan_at_41300_nodes_runs_from_global_memory():
    """41,300 nodes on 16 blocks: 2,582 nodes a slice need 229,798 bytes,
    which with the 2,712 static bytes pass the 232,448 a block takes, so
    the rows stay in global memory."""
    plan, _ = _port_plan([make_fake_node(f"node-{i}", "8", "32Gi") for i in range(4)],
                         [make_fake_pod("p", "default", "1", "1Gi")])
    wide = dataclasses.replace(plan, n=41_300)
    assert fused_scan.slice_bytes(wide, 2_582) == 229_798
    shape = fused_scan.launch_shape(wide, 16)
    assert not shape.resident and shape.smem == 0
    assert fused_scan.launch_shape(dataclasses.replace(plan, n=41_296), 16).resident


def _big_plan(n_nodes=40):
    """A storage + term plan: the term boundary shape (two VGs, an SSD
    and an HDD on every node; hostname, zone and rack rows)."""
    nodes, pods, _ = term_boundary_shape(n_nodes, 60, 16)
    plan, batch = _port_plan(nodes, pods)
    assert plan.has_store and plan.has_terms
    return plan, batch


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_storage_and_term_plans_take_a_cluster(cluster):
    """A storage + term plan's shape at C blocks: the hard-spread minima
    always in shared memory, then the replica of the shared rows' counts
    when it fits, then the slice (base, storage and scratch rows) when it
    fits beside them (180 bytes a node: 2,500 nodes on 4 blocks or more,
    10,000 on 16 blocks, 100,000 on none)."""
    plan, _ = _big_plan()
    d = fused_scan.block_dims(plan)
    per_node = (8 * (11 + 3 + 3 * d["v"] + d["ds"] + d["dh"]) + 1 + 1 + d["ds"] + d["dh"])
    assert (d["v"], d["ds"], d["dh"]) == (2, 1, 1)
    rw = 4 * d["vr"] + d["vgr"] + d["a"] + d["vsr"]
    assert fused_scan.replica_len(plan) == rw > 0
    hm = fused_scan.term_bytes(plan)
    rep = fused_scan.replica_bytes(plan)
    assert hm == 8 * (d["hm"] + d["hm"] % 2) and rep == 8 * (rw + rw % 2)
    static = fused_scan.static_smem(plan)
    assert static == fused_scan.STATIC_SMEM_TERMS
    assert per_node == 180
    for n in (2_500, 10_000, 100_000):
        wide = dataclasses.replace(plan, n=n)
        m = -(-n // cluster)
        assert fused_scan.slice_bytes(wide, m) == m * per_node
        shape = fused_scan.launch_shape(wide, cluster)
        assert shape.cluster == cluster and shape.replica and not shape.cached
        fits = hm + rep + m * per_node + static <= fused_scan.SMEM_PER_BLOCK
        assert shape.resident == fits
        assert fits == (n == 2_500 and cluster >= 4 or n == 10_000 and cluster == 16)
        if shape.resident:
            assert shape.smem == hm + rep + m * per_node
            assert shape.smem + static <= fused_scan.SMEM_PER_BLOCK
            assert shape.layout == 1 | 4
        else:
            assert shape.smem == hm + rep and shape.layout == 4
            assert hm + rep + m * per_node + static > fused_scan.SMEM_PER_BLOCK


def test_replica_that_does_not_fit_stays_in_global_memory():
    """A shared row of 20,000 values (each on two nodes) makes a replica
    past a block's shared memory: it goes to global memory, and the
    slice (16,000 nodes on 16 blocks) takes the room."""
    plan, _ = _big_plan()
    wide = dataclasses.replace(plan, n=16_000,
                               t_rep=plan.t_rep.clone(), t_off=plan.t_off.clone())
    shared = int(np.flatnonzero(plan.t_rep.numpy() >= 0)[-1])
    wide.t_off[shared + 1:] += 20_000  # the last shared row now spans 20,000 more values
    assert fused_scan.replica_len(wide) == fused_scan.replica_len(plan) + 4 * 20_000
    shape = fused_scan.launch_shape(wide, 16)
    assert not shape.replica and shape.resident
    assert shape.smem == fused_scan.term_bytes(plan) + fused_scan.slice_bytes(wide, 1_000)


def test_node_owned_rows_split_from_shared_ones():
    """The host-side split: a row whose values each sit on one node
    (hostname) is node-owned, a zone row is shared, a row with one value
    on two nodes is shared, a row of missing keys is node-owned; the
    shared rows' value ranges pack the replica in row order."""
    topo = np.array([
        [0, 1, 2, 3, 4, 5],      # hostname
        [0, 1, 0, 1, 0, 1],      # zone
        [0, 1, 2, 3, 4, 4],      # one value on two nodes
        [-1, -1, -1, -1, -1, -1],
        [3, -1, 0, -1, 1, 2],    # unique where present
    ], dtype=np.int32)
    owned = fused_scan.node_owned(topo)
    np.testing.assert_array_equal(owned, [True, False, False, True, True])
    off = fused_scan._ragged(topo)
    rep = fused_scan.replica_offsets(owned, off)
    np.testing.assert_array_equal(rep, [-1, 0, 2, -1, -1])
    # the affinity stress: its hostname rows node-owned, its zone rows
    # shared, and the plan's tables say so
    plan, _ = _big_plan()
    topo = plan.topo.numpy()
    keys = {}
    for r in range(topo.shape[0]):
        vals = topo[r][topo[r] >= 0]
        keys[r] = "host" if len(np.unique(vals)) == plan.n else "other"
    t_rep = plan.t_rep.numpy()
    assert {keys[r] for r in range(len(t_rep)) if t_rep[r] < 0} == {"host"}
    assert (t_rep >= 0).sum() == sum(k == "other" for k in keys.values()) > 0
    s_rep, s_row = plan.s_rep.numpy(), plan.s_row.numpy()
    np.testing.assert_array_equal(s_rep < 0, t_rep[s_row] < 0)


def test_storage_term_launch_arguments_carry_the_split():
    """The argument vector of a storage + term batch has the C source's
    length, the split tables at their kArg positions, the replica's
    dimensions, per-block stamps and no global replica when it sits in
    shared memory."""
    src = fused_scan.SOURCE.read_text()
    enum = src[src.index("enum {\n  kArgAlloc"):]
    enum = re.findall(r"kArg\w+", enum[:enum.index("kArgCount")])
    assert len(enum) == fused_scan._N_ARGS == 107
    plan, batch = _big_plan()
    scen = [(np.ones(len(batch.class_of_pod), bool), np.ones(plan.n, bool), None)] * 3
    inputs = fused_scan._scenario_inputs(plan, batch.class_of_pod, scen)
    shape = fused_scan.launch_shape(plan, 16)
    args, (_placements, _state, blocks, scratch) = fused_scan._launch_inputs(
        plan, *inputs, batch=True, launch=shape)
    assert len(args) == fused_scan._N_ARGS
    at = {name: i for i, name in enumerate(enum)}
    assert args[at["kArgTRep"]] == plan.t_rep.data_ptr()
    assert args[at["kArgSRep"]] == plan.s_rep.data_ptr()
    d = fused_scan.block_dims(plan)
    assert [args[at[k]] for k in ("kArgVr", "kArgVgr", "kArgVsr")] == [d["vr"], d["vgr"],
                                                                      d["vsr"]]
    assert args[at["kArgFlags"]] == 8 | 16 | 32 and args[at["kArgCluster"]] == 16
    assert args[at["kArgResident"]] == shape.layout == 5
    _partial, _aux, _take, stamps, replicas = scratch
    assert tuple(stamps.shape) == (3 * 16, d["vs"]) and replicas is None
    assert args[at["kArgRep"]] == 0
    assert {"vg_used", "tgt", "soft_counts"} <= set(blocks)


@pytest.mark.parametrize("cluster", [0, 3, 6, 12, 24, 32, 64])
def test_launch_shape_refuses_what_the_kernel_does_not_take(cluster):
    plan, _ = _port_plan([make_fake_node("node-0", "8", "32Gi")],
                         [make_fake_pod("p", "default", "1", "1Gi")])
    with pytest.raises(ValueError):
        fused_scan.launch_shape(plan, cluster)


def test_launch_arguments_carry_the_shape():
    """The argument vector has the C source's length (its kArg enum)
    and ends in the scenario count, the flags and the shape."""
    src = (fused_scan.SOURCE).read_text()
    enum = src[src.index("enum {\n  kArgAlloc"):]
    enum = enum[:enum.index("kArgCount")]
    assert len(re.findall(r"kArg\w+", enum)) == fused_scan._N_ARGS
    plan, batch = _port_plan(*_b2_nodes_pods())
    scen = [(np.ones(8, bool), np.ones(6, bool), None)] * 3
    inputs = fused_scan._scenario_inputs(plan, batch.class_of_pod, scen)
    shape = fused_scan.launch_shape(plan, 2)
    args, (placements, state, blocks, _scratch) = fused_scan._launch_inputs(
        plan, *inputs, batch=True, launch=shape)
    assert len(args) == fused_scan._N_ARGS
    assert args[-5:] == [3, 8 | 4 | 2 | 1, 2, 3, shape.smem]
    assert shape.resident and shape.cached
    assert shape.smem == fused_scan.slice_bytes(plan, 3) + fused_scan.cache_bytes(plan, 3)
    assert tuple(state.shape) == (3, 6, 6) and tuple(placements.shape) == (3, 8)
    assert sorted(blocks) == ["gpu_used", "ports_used", "used_scalar"]


# ---- the plain version against the JAX package on tie shapes ---------------

def _xla(nodes, pods, active, valid):
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods)
    placements, final = scan_ops.run_scan_masked(
        to_scan_static(cluster, batch), to_scan_state(dyn, batch),
        jnp.asarray(batch.class_of_pod), jnp.asarray(batch.pinned_node),
        jnp.asarray(valid), jnp.asarray(active), features=features)
    return np.asarray(placements), {k: np.asarray(getattr(final, k)) for k in STATE}


def _plain(nodes, pods, active, valid):
    plan, batch = _port_plan(nodes, pods)
    placements, final = fused_scan.run_fused_scan(plan, batch.class_of_pod, active, valid,
                                                  pinned=batch.pinned_node)
    return placements.numpy(), {k: v.numpy() for k, v in final.items()}


TIE_CASES = {
    # name: (shape, n_nodes, n_pods, node_frac, pod_frac)
    "ties-37": (tie_shape, 37, 90, 1.0, 1.0),
    "ties-2501-masked": (tie_shape, 2_501, 120, 0.9, 0.95),
    "boundary-37": (boundary_shape, 37, 80, 1.0, 1.0),
    "boundary-2501": (boundary_shape, 2_501, 100, 1.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(TIE_CASES))
def test_plain_equals_xla_scan_on_cluster_ties(name):
    shape, n_nodes, n_pods, nf, pf = TIE_CASES[name]
    built = shape(n_nodes, n_pods)
    nodes, pods = built[0], built[1]
    rng = np.random.RandomState(n_nodes + n_pods)
    valid = rng.rand(n_nodes) < nf
    active = rng.rand(n_pods) < pf
    xla_p, xla_f = _xla(nodes, pods, active, valid)
    port_p, port_f = _plain(nodes, pods, active, valid)
    np.testing.assert_array_equal(port_p, xla_p)
    for k in STATE:
        np.testing.assert_array_equal(port_f[k], xla_f[k], err_msg=k)
    placed = port_p[port_p >= 0]
    if shape is tie_shape:
        # the first pod takes the first valid node: every node ties
        assert port_p[np.flatnonzero(active)[0]] == np.flatnonzero(valid)[0]
        assert len(np.unique(placed)) > min(len(placed), n_nodes) // 2
    else:
        big = built[2]
        # the best nodes are the boundary pairs; the lower index of each
        # tie goes first
        assert port_p[0] == big[0] and port_p[1] == big[1]
        assert set(placed[:8].tolist()) <= set(big)


@pytest.mark.parametrize("name", ["ties-37", "boundary-37"])
def test_plain_equals_pallas_interpret_on_cluster_ties(name):
    shape, n_nodes, _, _, _ = TIE_CASES[name]
    built = shape(n_nodes, 30)
    nodes, pods = built[0], built[1]
    active, valid = np.ones(len(pods), bool), np.ones(n_nodes, bool)
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods)
    jplan = pallas_scan.build_plan(cluster, batch, dyn, features)
    assert jplan is not None
    pal_p, pal_f = pallas_scan.run_scan_pallas(jplan, batch.class_of_pod, active, valid,
                                               pinned=batch.pinned_node, interpret=True)
    port_p, port_f = _plain(nodes, pods, active, valid)
    np.testing.assert_array_equal(port_p, np.asarray(pal_p))
    for k, v in pal_f.items():
        np.testing.assert_array_equal(port_f[k], v, err_msg=k)


# ---- storage + term plans: cross-block folds on slice boundaries ----------

def _node_space(plan, final):
    """The port's value-space term rows as the XLA scan's node space."""
    topo = plan.topo.numpy()
    out = {f: fused_scan.value_to_node(final[f].numpy(), topo, plan.t_off.numpy())
           for f in fused_scan.TERM_FIELDS}
    out["group_counts"] = fused_scan.value_to_node(
        final["group_counts"].numpy(), plan.g_topo.numpy(), plan.g_off.numpy())
    out["group_total"] = final["group_total"].numpy()
    out["soft_counts"] = fused_scan.value_to_node(
        final["soft_counts"].numpy(), topo[plan.s_row.numpy()], plan.s_off.numpy())
    return out


# (builder, cluster whose slices the shape straddles): racks across the
# slice boundaries of 2 and of 16 blocks; more spread slots than one
# exchange folds
TERM_TIE_CASES = {
    "racks-2": (lambda: term_boundary_shape(40, 48, 2), 2),
    "racks-16": (lambda: term_boundary_shape(40, 48, 16), 16),
    "many-slots": (lambda: many_slots_shape(36, 40), None),
}


@pytest.mark.parametrize("name", sorted(TERM_TIE_CASES))
def test_plain_equals_xla_scan_on_term_boundaries(name):
    """The plain version against the JAX package's XLA scan on storage
    + term shapes whose hard-spread minima, soft-spread domains and
    first maxima fall across the slices of C blocks: placements, the base
    rows, the storage rows and every term row, exactly."""
    build, cluster = TERM_TIE_CASES[name]
    built = build()
    nodes, pods = built[0], built[1]
    n, p = len(nodes), len(pods)
    plan, batch = _port_plan(nodes, pods)
    assert plan.has_terms
    if cluster is not None:
        assert plan.has_store
        # every rack holds nodes of two blocks' slices
        rack = np.array([int(nd["metadata"]["labels"]["rack"][1:]) for nd in nodes])
        owner = np.zeros(n, int)
        for r, (lo, hi) in enumerate(fused_scan.slices(n, cluster)):
            owner[lo:hi] = r
        assert all(len(set(owner[rack == k])) == 2 for k in range(1, rack.max() + 1))
    else:
        d = fused_scan.block_dims(plan)
        assert d["hm"] > fused_scan.KROUND and d["sm"] > fused_scan.KROUND
    active, valid = np.ones(p, bool), np.ones(n, bool)
    cj, bj, dj, fj = _encode(JAX_PKG, nodes, pods)
    placements, final = scan_ops.run_scan_masked(
        to_scan_static(cj, bj), to_scan_state(dj, bj), jnp.asarray(bj.class_of_pod),
        jnp.asarray(bj.pinned_node), jnp.asarray(valid), jnp.asarray(active), features=fj)
    got, mine = fused_scan.run_fused_scan(plan, batch.class_of_pod, active, valid,
                                          pinned=batch.pinned_node)
    np.testing.assert_array_equal(got.numpy(), np.asarray(placements))
    for k in STATE:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(getattr(final, k)), err_msg=k)
    if plan.has_store:
        for k in fused_scan.STORE_ROWS:
            np.testing.assert_array_equal(mine[k].numpy().T,
                                          np.asarray(getattr(final, k)).astype(np.int64),
                                          err_msg=k)
    for k, v in _node_space(plan, mine).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(final, k)), err_msg=k)
    placed = got.numpy()
    assert (placed >= 0).sum() > p // 2
    if cluster is not None:
        # the first pod takes a small node on a slice boundary
        assert placed[0] in built[2]
