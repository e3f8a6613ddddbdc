"""The inter-pod affinity and topology-spread block (B4) of the GPU
port's fused scan on the CPU, exactly (placements and counts are
integers, so the tolerance is equality):

- the port's build_plan path and plain version equal the JAX package's
  XLA scan (run_scan_masked): placements, the six base rows and every
  term-state row, converted from the port's value space back to the XLA
  scan's node space;
- plan_from_scan_arrays builds the plan from the XLA scan's own
  ScanStatic / ScanState arrays (node-space state to value space), and
  equals build_plan;
- the plain version places as the Pallas kernel in interpret mode, on
  its resident and on its streamed term layout (STREAM_FORCE);
- more classes than the Pallas caps, several soft constraints per class
  whose f64 scores expose the sum order, required affinity groups,
  pins, inactive pods and scenario masks.

The CUDA kernel equals the plain version in tests/test_torch_cuda.py
(needs the card). Inputs are small clusters made from a numpy seed;
the node and pod helpers are those of tests/test_pallas_terms.py."""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu.ops import scan as scan_ops
from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
from open_simulator_tpu_torch.ops import fused_scan

ZONES = ["a", "b", "c", "d"]
STATE = fused_scan.STATE_FIELDS
JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"


def make_node(i, zone, cpu="8"):
    return {
        "kind": "Node",
        "metadata": {"name": f"n{i:03d}",
                     "labels": {"kubernetes.io/hostname": f"n{i:03d}", "zone": zone}},
        "status": {"allocatable": {"cpu": cpu, "memory": "32Gi", "pods": "110"}},
    }


def sts(name, reps, cpu="500m", anti_key=None, aff_key=None, spread=None, pref=None):
    spec = {"containers": [{"name": "c", "image": "i",
                            "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}]}
    affinity = {}
    if anti_key:
        affinity["podAntiAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": name}}, "topologyKey": anti_key}]}
    if aff_key:
        affinity["podAffinity"] = {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"grp": "hub"}}, "topologyKey": aff_key}]}
    if pref:
        weight, app, key, anti = pref
        kind = "podAntiAffinity" if anti else "podAffinity"
        affinity.setdefault(kind, {})["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": weight, "podAffinityTerm": {
                "labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}}]
    if affinity:
        spec["affinity"] = affinity
    if spread:
        spec["topologySpreadConstraints"] = spread
    labels = {"app": name, "grp": "hub" if aff_key else name}
    return {"kind": "StatefulSet", "metadata": {"name": name, "namespace": "d", "labels": labels},
            "spec": {"replicas": reps, "template": {"metadata": {"labels": labels},
                                                    "spec": spec}}}


def spread(key, when, skew=1, app=None):
    out = {"maxSkew": skew, "topologyKey": key, "whenUnsatisfiable": when}
    if app:
        out["labelSelector"] = {"matchLabels": {"app": app}}
    return out


def expand(pkg, nodes, workloads, mutate=None):
    importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
    dec = importlib.import_module(f"{pkg}.models.decode")
    wl = importlib.import_module(f"{pkg}.models.workloads")
    core = importlib.import_module(f"{pkg}.scheduler.core")
    res = dec.ResourceTypes()
    res.stateful_sets = copy.deepcopy(workloads)
    pods = core._sort_app_pods(wl.generate_valid_pods_from_app("t", res, nodes))
    if mutate is not None:
        mutate(pods)
    return pods


def encode(pkg, nodes, pods, existing=()):
    oracle = importlib.import_module(f"{pkg}.scheduler.oracle").Oracle(copy.deepcopy(nodes))
    for p in existing:
        oracle.place_existing_pod(copy.deepcopy(p))
    enc = importlib.import_module(f"{pkg}.ops.encode")
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return cluster, batch, dyn, enc.features_of_batch(cluster, batch)


def node_space(plan, final):
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


def check_case(nodes, workloads, existing=(), node_valid=None, pod_active=None,
               mutate=None, pallas=False):
    """The XLA scan, the port's plain version on build_plan and on
    plan_from_scan_arrays, and (with `pallas`) the Pallas kernel in
    interpret mode: identical placements; identical base and term
    rows. Returns the placements."""
    jpods = expand(JAX_PKG, nodes, workloads, mutate)
    ppods = expand(PORT_PKG, nodes, workloads, mutate)
    n, p = len(nodes), len(jpods)
    nv = np.ones(n, bool) if node_valid is None else node_valid
    pa = np.ones(p, bool) if pod_active is None else pod_active(p)
    cluster, batch, dyn, features = encode(JAX_PKG, nodes, jpods, existing)
    assert features.terms
    static, init = to_scan_static(cluster, batch), to_scan_state(dyn, batch)
    ref, ref_state = scan_ops.run_scan_masked(
        static, init, jnp.asarray(batch.class_of_pod), jnp.asarray(batch.pinned_node),
        jnp.asarray(nv), jnp.asarray(pa), features=features)
    ref = np.asarray(ref)
    own = fused_scan.build_plan(*encode(PORT_PKG, nodes, ppods, existing))
    from_scan = fused_scan.plan_from_scan_arrays(static, init, features)
    assert own.has_terms and not own.has_store
    for plan in (own, from_scan):
        got, final = fused_scan.run_fused_scan(plan, batch.class_of_pod, pa, nv,
                                               pinned=batch.pinned_node)
        np.testing.assert_array_equal(got.numpy(), ref)
        for k in STATE:
            np.testing.assert_array_equal(final[k].numpy(),
                                          np.asarray(getattr(ref_state, k)), err_msg=k)
        for k, v in node_space(plan, final).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(ref_state, k)), err_msg=k)
    if pallas:
        for stream in (False, True):
            prev = pallas_scan.STREAM_FORCE
            pallas_scan.STREAM_FORCE = stream
            try:
                jplan = pallas_scan.build_plan(cluster, batch, dyn, features, allow_terms=True)
                assert jplan is not None and jplan.terms is not None
                assert jplan.terms.cfg.stream == stream
                pal, _ = pallas_scan.run_scan_pallas(
                    jplan, batch.class_of_pod, pa, nv, pinned=batch.pinned_node,
                    interpret=True)
            finally:
                pallas_scan.STREAM_FORCE = prev
            np.testing.assert_array_equal(np.asarray(pal), ref)
    return ref


def _nodes(n=32, zones=4):
    return [make_node(i, ZONES[i % zones]) for i in range(n)]


def test_soft_zone_spread():
    got = check_case(_nodes(), [sts("w1", 12, spread=[
        spread("zone", "ScheduleAnyway", app="w1")])], pallas=True)
    assert (got >= 0).all()


def test_hard_zone_spread():
    check_case(_nodes(), [sts("w2", 10, spread=[spread("zone", "DoNotSchedule", 2, "w2")])])


def test_required_affinity_group():
    check_case(_nodes(), [sts("hub", 3, aff_key="zone"), sts("spoke", 9, aff_key="zone")],
               pallas=True)


def test_required_affinity_without_a_hub_stays_pending():
    """Pods whose group has no match anywhere and that do not match it
    themselves cannot bootstrap: unschedulable everywhere."""
    spoke = sts("spoke", 4, aff_key="zone")
    spoke["spec"]["template"]["metadata"]["labels"]["grp"] = "spoke"
    got = check_case(_nodes(12), [spoke])
    assert (got == -1).all()


def test_mixed_anti_affinity_and_spreads():
    check_case(_nodes(), [
        sts("a1", 8, anti_key="kubernetes.io/hostname"),
        sts("a2", 8, spread=[spread("zone", "ScheduleAnyway", 1, "a2"),
                             spread("kubernetes.io/hostname", "DoNotSchedule", 3, "a2")]),
    ], pallas=True)


def test_several_soft_constraints_sum_in_slot_order():
    """Three soft constraints on one class (zone, hostname, rack with 3
    values): each slot adds cnt * log(sz + 2) + maxSkew - 1 in f64, so
    the sum's order shows in the truncated raw score."""
    nodes = _nodes(24)
    for i, node in enumerate(nodes):
        node["metadata"]["labels"]["rack"] = f"r{i % 3}"
    got = check_case(nodes, [sts("w", 30, spread=[
        spread("zone", "ScheduleAnyway", 2, "w"),
        spread("kubernetes.io/hostname", "ScheduleAnyway", 3, "w"),
        spread("rack", "ScheduleAnyway", 1, "w"),
    ]), sts("x", 10, spread=[spread("rack", "ScheduleAnyway", 4, "w"),
                             spread("zone", "ScheduleAnyway", 1, "x")])])
    assert (got >= 0).all()


def test_preferred_affinity_and_anti_affinity_scores():
    check_case(_nodes(16), [
        sts("base", 6),
        sts("near", 8, pref=(50, "base", "zone", False)),
        sts("far", 8, pref=(30, "base", "kubernetes.io/hostname", True)),
    ], pallas=True)


def test_existing_pods_and_scenario_mask():
    existing = [{
        "metadata": {"name": f"ex{i}", "namespace": "d", "labels": {"app": "a1"}},
        "spec": {"nodeName": f"n{i:03d}", "containers": [
            {"name": "c", "image": "i", "resources": {"requests": {"cpu": "1"}}}]},
        "status": {"phase": "Running"},
    } for i in range(6)]
    nv = np.ones(32, bool)
    nv[24:] = False
    got = check_case(_nodes(), [sts("a1", 10, anti_key="kubernetes.io/hostname")],
                     existing=existing, node_valid=nv)
    assert not (set(got[got >= 0].tolist()) & set(range(6)))


def test_inactive_pods_commit_nothing():
    def active(p):
        pa = np.ones(p, bool)
        pa[[3, 7]] = False
        return pa

    got = check_case(_nodes(), [sts("w3", 10, anti_key="zone")], pod_active=active)
    assert got[3] == got[7] == fused_scan.INACTIVE


def test_pinned_pods_force_placement():
    def pin(pods):
        pods[0]["spec"]["nodeName"] = "n009"
        pods[1]["spec"]["nodeName"] = "n012"

    nv = np.ones(16, bool)
    nv[12] = False
    got = check_case(_nodes(16), [sts("w", 8, anti_key="zone")], node_valid=nv, mutate=pin)
    assert got[0] == 9 and got[1] == fused_scan.INACTIVE


@pytest.mark.parametrize("seed", range(5))
def test_randomized_mixed_conformance(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(12, 40))
    k_zones = int(rng.randint(2, 5))
    nodes = [make_node(i, ZONES[i % k_zones]) for i in range(n)]
    workloads = []
    for w in range(rng.randint(1, 4)):
        name = f"w{w}"
        kind = rng.randint(0, 5)
        kw = {}
        if kind == 0:
            kw["anti_key"] = str(rng.choice(["kubernetes.io/hostname", "zone"]))
        elif kind == 1:
            kw["aff_key"] = "zone"
        elif kind == 2:
            kw["spread"] = [spread(str(rng.choice(["zone", "kubernetes.io/hostname"])),
                                   str(rng.choice(["DoNotSchedule", "ScheduleAnyway"])),
                                   int(rng.randint(1, 4)), name)]
        elif kind == 3:
            kw["anti_key"] = "zone"
            kw["spread"] = [spread("zone", "ScheduleAnyway", 1, name)]
        else:
            kw["pref"] = (int(rng.randint(1, 100)), "w0", "zone", bool(rng.rand() < 0.5))
        workloads.append(sts(name, int(rng.randint(2, 9)), **kw))

    def pin(pods):  # the same pins for both packages' pod lists
        pick = np.random.RandomState(seed + 7)
        for p_i in pick.choice(len(pods), size=min(2, len(pods)), replace=False):
            pods[p_i]["spec"]["nodeName"] = f"n{pick.randint(0, n):03d}"

    state = np.random.RandomState(seed + 50)
    nv = state.rand(n) > 0.15
    nv[0] = True
    check_case(nodes, workloads, node_valid=nv, mutate=pin,
               pod_active=lambda p: state.rand(p) > 0.1)


def test_affinity_stress_slice():
    from open_simulator_tpu.testing import build_affinity_stress

    nodes, stss = build_affinity_stress(n_nodes=24, n_sts=6, replicas=4, zones=3)
    check_case(nodes, stss, pallas=True)


def test_many_classes_beyond_the_pallas_caps():
    """More than 128 classes, and more classes, term rows and soft
    constraint instances than one Pallas plan tile holds: the port has
    no cap on any of them."""
    from open_simulator_tpu.testing import build_affinity_stress

    nodes, stss = build_affinity_stress(n_nodes=24, n_sts=12, replicas=2, zones=3)

    def add_unique_classes(pods):
        base = pods[0]
        for i in range(130):
            p = copy.deepcopy(base)
            p["metadata"]["name"] = f"uniq-{i:03d}"
            p["spec"]["containers"][0]["resources"]["requests"]["cpu"] = f"{i + 1}m"
            if i % 2:
                p["spec"].pop("affinity", None)
            pods.append(p)

    got = check_case(nodes, stss, mutate=add_unique_classes)
    assert (got >= 0).sum() >= 100 and (got == -1).any()


def test_plan_from_scan_arrays_equals_build_plan():
    from open_simulator_tpu.testing import build_affinity_stress

    nodes, stss = build_affinity_stress(n_nodes=20, n_sts=5, replicas=3, zones=3)
    existing = [{"metadata": {"name": "ex", "namespace": "stress",
                              "labels": {"app": "sts-001"}},
                 "spec": {"nodeName": "sn-00003", "containers": [{"name": "c", "image": "i"}]},
                 "status": {"phase": "Running"}}]
    jpods, ppods = expand(JAX_PKG, nodes, stss), expand(PORT_PKG, nodes, stss)
    cluster, batch, dyn, features = encode(JAX_PKG, nodes, jpods, existing)
    from_scan = fused_scan.plan_from_scan_arrays(
        to_scan_static(cluster, batch), to_scan_state(dyn, batch), features)
    own = fused_scan.build_plan(*encode(PORT_PKG, nodes, ppods, existing))
    assert int(own.t_init.sum()) > 0
    for f in ("topo", "t_off", "t_cls", "cls_rows", "g_topo", "g_off", "g_match",
              "cls_grows", "cls_gid", "g_self", "h_row", "h_skew", "h_self", "h_cand",
              "cls_hrows", "s_row", "s_host", "s_skew", "s_q", "cls_srows", "s_haskeys",
              "s_off", "log_tab", "t_init", "g_init", "gt_init", "s_init", "alloc", "init",
              "cls_req", "feasible", "cls_tab"):
        assert torch.equal(getattr(from_scan, f), getattr(own, f)), f


def test_value_space_is_ragged_per_row():
    """Hostname rows hold one count per node, zone rows one per zone."""
    from open_simulator_tpu.testing import build_affinity_stress

    nodes, stss = build_affinity_stress(n_nodes=40, n_sts=4, replicas=2, zones=4)
    plan = fused_scan.build_plan(*encode(PORT_PKG, nodes, expand(PORT_PKG, nodes, stss)))
    widths = set(np.diff(plan.t_off.numpy()).tolist())
    assert widths == {40, 4}
    assert plan.t_init.shape[1] == int(plan.t_off[-1]) + 1


def test_normalize_score_divides_before_it_scales_unlike_the_jax_package():
    """InterPodAffinity's NormalizeScore (kube-scheduler v1.20.5,
    pkg/scheduler/framework/plugins/interpodaffinity/scoring.go) computes
    int64(float64(MaxNodeScore) * (float64(s - min) / float64(diff))).
    The port orders it so; the JAX package takes the product first. Raw
    scores 50, 29 and 0 (two placed pods the incoming pod prefers, with
    weights 50 and 29, on their hostnames) are where they part: 29 / 50
    scales to 57 in the port, 58 in the JAX package."""
    nodes = [make_node(i, "a") for i in range(3)]

    def pod(name, labels, node=None, pref=()):
        spec = {"containers": [{"name": "c", "image": "i",
                                "resources": {"requests": {"cpu": "100m"}}}]}
        if node is not None:
            spec["nodeName"] = node
        if pref:
            spec["affinity"] = {"podAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": w, "podAffinityTerm": {
                        "labelSelector": {"matchLabels": {"tier": tier}},
                        "topologyKey": "kubernetes.io/hostname"}} for w, tier in pref]}}
        return {"metadata": {"name": name, "namespace": "d", "labels": labels},
                "spec": spec, "status": {"phase": "Running"}}

    placed = [pod("a", {"tier": "a"}, "n000"), pod("b", {"tier": "b"}, "n001")]
    seeker = pod("seeker", {}, pref=((50, "a"), (29, "b")))
    scores = {}
    for pkg in (JAX_PKG, PORT_PKG):
        oracle = importlib.import_module(f"{pkg}.scheduler.oracle").Oracle(copy.deepcopy(nodes))
        for p in placed:
            oracle.place_existing_pod(copy.deepcopy(p))
        scores[pkg] = oracle._score_interpod_affinity(copy.deepcopy(seeker), oracle.nodes)
    assert scores[PORT_PKG] == [100, 57, 0]
    assert scores[JAX_PKG] == [100, 58, 0]
