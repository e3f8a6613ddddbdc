"""The pins-first mode of the GPU port's scenario batch
(`fused_scan_batch_reference(..., pins_first=True)`, the plain version
of the `fused_scan_batch (pins-first)` kernel) against the JAX
package's outage substrate, `parallel/sweep.py` `_scenario_rows_impl`
(two chained masked XLA scans a scenario: the pinned pods commit first,
then the free pods schedule), run under `jax.jit` on the CPU. Exact:
placements, unscheduled counts and cpu / mem / vg utilization are
equal.

Cases cover the base plan, the B2 blocks (scalars, hostPorts,
GPU-share), open-local storage and inter-pod terms, on 16-64 nodes and
40-200 pods, with random per-scenario pins (some to masked-out nodes),
inactive pinned pods and node masks. `pins_first=False` is checked to
be unchanged against the single-pass XLA scan. Inputs come from numpy
seeds."""

import copy
import dataclasses
import importlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from open_simulator_tpu.ops import scan as scan_ops
from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
from open_simulator_tpu.parallel import sweep as jsweep
from open_simulator_tpu.testing import (
    make_fake_node,
    make_fake_pod,
    with_node_gpu,
    with_node_labels,
    with_node_taints,
    with_tolerations,
)
from open_simulator_tpu_torch.ops import fused_scan

GI = 1 << 30


def _node(i, rng, gpu=False, storage=False, scalar=False):
    cpu = int(rng.choice([4, 8, 16]))
    opts = [with_node_labels({"zone": f"z{i % 3}", "kubernetes.io/hostname": f"node-{i}"})]
    if i % 5 == 0:
        opts.append(with_node_taints(
            [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]))
    if gpu:
        opts.append(with_node_gpu(1 + i % 3, "32"))
    node = make_fake_node(f"node-{i}", f"{cpu}", f"{cpu * 4}Gi", *opts)
    if scalar:
        node["status"]["allocatable"]["example.com/widget"] = str(1 + i % 3)
    if storage:
        node["metadata"].setdefault("annotations", {})["simon/node-local-storage"] = json.dumps({
            "vgs": [{"name": "a", "capacity": str((20 + 10 * (i % 3)) * GI), "requested": "0"}],
            "devices": [{"name": "/dev/vdb", "capacity": str(60 * GI), "mediaType": "ssd",
                         "isAllocated": "false"}],
        })
    return node


def _pod(i, rng, kind):
    opts = []
    if rng.rand() < 0.3:
        opts.append(with_tolerations([{"key": "dedicated", "operator": "Exists"}]))
    pod = make_fake_pod(f"p-{i}", "default", ["250m", "500m", "1", "2"][rng.randint(4)],
                        ["256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(4)], *opts)
    spec = pod["spec"]
    meta = pod["metadata"]
    if kind == "b2":
        r = rng.rand()
        if r < 0.3:
            meta["annotations"] = {
                "alibabacloud.com/gpu-mem": str(int(rng.choice([4, 8, 16]))),
                "alibabacloud.com/gpu-count": str(int(rng.choice([1, 1, 2]))),
            }
        elif r < 0.5:
            spec["containers"][0]["ports"] = [
                {"containerPort": 8080, "hostPort": 8080, "protocol": "TCP"}]
        elif r < 0.7:
            spec["containers"][0]["resources"]["requests"]["example.com/widget"] = "1"
    if kind == "storage" and rng.rand() < 0.5:
        vols = [("LVM", int(rng.choice([4, 8])) * GI)]
        if rng.rand() < 0.3:
            vols.append(("SSD", 20 * GI))
        meta["annotations"] = {"simon/pod-local-storage": json.dumps({"volumes": [
            {"kind": k, "size": str(sz), "scName": f"open-local-{k.lower()}"}
            for k, sz in vols]})}
    if kind == "terms":
        app = f"a{i % 3}"
        meta.setdefault("labels", {})["app"] = app
        if i % 3 == 0:
            spec["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": app}},
                     "topologyKey": "kubernetes.io/hostname"}]}}
        elif i % 3 == 1:
            spec["topologySpreadConstraints"] = [
                {"maxSkew": 2, "topologyKey": "zone", "whenUnsatisfiable": "ScheduleAnyway",
                 "labelSelector": {"matchLabels": {"app": app}}}]
        else:
            spec["affinity"] = {"podAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 10, "podAffinityTerm": {
                        "labelSelector": {"matchLabels": {"app": "a1"}},
                        "topologyKey": "zone"}}]}}
    return pod


def _case(kind, n, p, seed):
    rng = np.random.RandomState(seed)
    nodes = [_node(i, rng, gpu=kind == "b2", scalar=kind == "b2",
                   storage=kind == "storage") for i in range(n)]
    pods = [_pod(i, rng, kind) for i in range(p)]
    return nodes, pods


def _encode(pkg, nodes, pods):
    oracle = importlib.import_module(f"{pkg}.scheduler.oracle").Oracle(copy.deepcopy(nodes))
    enc = importlib.import_module(f"{pkg}.ops.encode")
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return cluster, batch, dyn, enc.features_of_batch(cluster, batch)


def _outage_rows(n, p, scenarios, seed):
    """Per-scenario (valid [N], active [P], pinned [P]) of the kinds an
    outage sweep makes: a few nodes off, most pods pinned to a node
    (some of them to a node that is off), a few pinned pods inactive."""
    rng = np.random.RandomState(seed)
    valids, actives, pins = [], [], []
    for s in range(scenarios):
        valid = rng.rand(n) > 0.15
        valid[s % n] = False
        active = rng.rand(p) > 0.1
        pin = np.where(rng.rand(p) < 0.6, rng.randint(n, size=p), -1)
        valids.append(valid)
        actives.append(active)
        pins.append(pin.astype(np.int64))
    return np.stack(valids), np.stack(actives), np.stack(pins)


def _port_rows(plan, cls, valids, actives, pins, pins_first):
    rows = fused_scan.fused_scan_batch_reference(
        plan, cls, list(zip(actives, valids, pins)), pins_first=pins_first)
    out = []
    for valid, (placements, final) in zip(valids, rows):
        placements = placements.numpy().astype(np.int64)
        alloc_c = plan.alloc[0].numpy()
        alloc_m = plan.alloc[1].numpy()
        cpu = 100.0 * float(final["used_mcpu"].numpy()[valid].sum()) / max(
            int(alloc_c[valid].sum()), 1)
        mem = 100.0 * float(final["used_mem"].numpy()[valid].sum()) / max(
            int(alloc_m[valid].sum()), 1)
        out.append((placements, int((placements == -1).sum()), cpu, mem))
    return out


KINDS = [("base", 24, 120), ("b2", 16, 80), ("storage", 20, 60), ("terms", 32, 90)]


@pytest.mark.parametrize("kind,n,p", KINDS)
def test_pins_first_equals_the_chained_xla_scans(kind, n, p):
    nodes, pods = _case(kind, n, p, seed=len(kind) * 7 + n)
    cluster, batch, dyn, features = _encode("open_simulator_tpu", nodes, pods)
    static, init = to_scan_static(cluster, batch), to_scan_state(dyn, batch)
    valids, actives, pins = _outage_rows(n, p, 4, seed=n + p)
    rows = jax.jit(jsweep._scenario_rows_impl, static_argnums=(6,))(
        static, init, jnp.asarray(batch.class_of_pod), jnp.asarray(valids),
        jnp.asarray(actives), jnp.asarray(pins), features)
    j_place, j_unsched, j_cpu, j_mem, _j_vg = (np.asarray(x) for x in rows)

    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods)
    plan = dataclasses.replace(fused_scan.build_plan(pc, pb, pd, pf), has_pins=True)
    flags = {"b2": plan.ext, "storage": plan.has_store, "terms": plan.has_terms}
    assert flags.get(kind, not (plan.ext or plan.has_store or plan.has_terms))
    got = _port_rows(plan, pb.class_of_pod, valids, actives, pins, pins_first=True)
    for s, (placements, unsched, cpu, mem) in enumerate(got):
        np.testing.assert_array_equal(placements, j_place[s], err_msg=f"scenario {s}")
        assert (unsched, cpu, mem) == (int(j_unsched[s]), float(j_cpu[s]), float(j_mem[s]))
    # the rows a pin puts outside the mask are INACTIVE, the free pods
    # placed after every pin
    off = (pins >= 0) & ~np.take_along_axis(valids, np.maximum(pins, 0), axis=1)
    assert (j_place[off & actives] == fused_scan.INACTIVE).all()


@pytest.mark.parametrize("kind,n,p", KINDS[:2] + [("terms", 20, 40)])
def test_single_pass_is_unchanged(kind, n, p):
    """pins_first=False keeps the one interleaved pass: each row equals
    the JAX package's single masked XLA scan with the same pins."""
    nodes, pods = _case(kind, n, p, seed=3 * n + p)
    cluster, batch, dyn, features = _encode("open_simulator_tpu", nodes, pods)
    static, init = to_scan_static(cluster, batch), to_scan_state(dyn, batch)
    valids, actives, pins = _outage_rows(n, p, 2, seed=p)
    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods)
    plan = dataclasses.replace(fused_scan.build_plan(pc, pb, pd, pf), has_pins=True)
    got = _port_rows(plan, pb.class_of_pod, valids, actives, pins, pins_first=False)
    feats = features._replace(pins=True)
    for s, (placements, unsched, _cpu, _mem) in enumerate(got):
        ref, _ = scan_ops.run_scan_masked(
            static, init, jnp.asarray(batch.class_of_pod), jnp.asarray(pins[s]),
            jnp.asarray(valids[s]), jnp.asarray(actives[s]), features=feats)
        np.testing.assert_array_equal(placements, np.asarray(ref), err_msg=f"scenario {s}")


def test_pins_first_differs_from_the_interleaved_pass():
    """On a full cluster the two orders disagree: interleaved, an early
    free pod takes the room a later pinned pod then overcommits; pins
    first, the free pod finds the node full and goes elsewhere."""
    nodes = [make_fake_node(f"node-{i}", "4", "16Gi") for i in range(2)]
    pods = [make_fake_pod(f"p-{i}", "default", "2", "1Gi") for i in range(4)]
    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods)
    plan = dataclasses.replace(fused_scan.build_plan(pc, pb, pd, pf), has_pins=True)
    pins = np.array([-1, 0, 0, 1])
    scen = [(np.ones(4, bool), np.ones(2, bool), pins)]
    inter = fused_scan.fused_scan_batch_reference(plan, pb.class_of_pod, scen)[0][0]
    first = fused_scan.fused_scan_batch_reference(plan, pb.class_of_pod, scen,
                                                  pins_first=True)[0][0]
    assert inter.tolist() == [0, 0, 0, 1]
    assert first.tolist() == [1, 0, 0, 1]


def test_chip_smoke_bound_leaves_the_rows_alone():
    """The bound chip_smoke.py prints (obs/costs.py bound(), where its
    count moved) counts the operations of each scenario's free pods (the
    pinned ones only commit) without touching the caller's rows: a check
    run after it on the same scenarios sees them as they were."""
    from open_simulator_tpu_torch.obs import costs

    nodes, pods = _case("base", 16, 40, seed=5)
    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods)
    plan = dataclasses.replace(fused_scan.build_plan(pc, pb, pd, pf), has_pins=True)
    valids, actives, pins = _outage_rows(16, 40, 3, seed=9)
    before = actives.copy()
    scen = list(zip(actives, valids, pins))
    ms, by = costs.bound(plan, pb.class_of_pod, scen)
    np.testing.assert_array_equal(actives, before)
    free_only = [(a & (q < 0), v, q) for a, v, q in scen]
    assert (ms, by) == costs.bound(plan, pb.class_of_pod, free_only)
    assert ms > 0 and by in ("bytes", "operations")


# ---- the orders the kernel's parallel pinned pass relies on: the plain
# version's rows and every final state row against the JAX package's
# chained scans, on shapes where the pin order, shared domains, masks or
# chunk edges matter


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


def _hold(nodes, pods, valids, actives, pins):
    """The plain version's pins-first rows against `_scenario_rows_impl`
    (placements, unscheduled counts, cpu / mem utilization) and every
    final state row against its two chained masked scans
    (`_scenario_pinned_impl`'s body), exactly. Returns (placements
    [S, P], the port's final states, the plan)."""
    cluster, batch, dyn, features = _encode("open_simulator_tpu", nodes, pods)
    static, init = to_scan_static(cluster, batch), to_scan_state(dyn, batch)
    cls = jnp.asarray(batch.class_of_pod)
    rows = jax.jit(jsweep._scenario_rows_impl, static_argnums=(6,))(
        static, init, cls, jnp.asarray(valids), jnp.asarray(actives), jnp.asarray(pins),
        features)
    j_place, j_unsched, j_cpu, j_mem, _j_vg = (np.asarray(x) for x in rows)

    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods)
    plan = dataclasses.replace(fused_scan.build_plan(pc, pb, pd, pf), has_pins=True)
    got = _port_rows(plan, pb.class_of_pod, valids, actives, pins, pins_first=True)
    finals = [f for _, f in fused_scan.fused_scan_batch_reference(
        plan, pb.class_of_pod, list(zip(actives, valids, pins)), pins_first=True)]
    feats = features._replace(pins=True)
    for s, (placements, unsched, cpu, mem) in enumerate(got):
        np.testing.assert_array_equal(placements, j_place[s], err_msg=f"scenario {s}")
        assert (unsched, cpu, mem) == (int(j_unsched[s]), float(j_cpu[s]), float(j_mem[s]))
        pin, valid, act = (jnp.asarray(x[s]) for x in (pins, valids, actives))
        _, mid = scan_ops.run_scan_masked(static, init, cls, pin, valid, act & (pin >= 0),
                                          features=feats)
        _, ref = scan_ops.run_scan_masked(static, mid, cls, pin, valid, act & (pin < 0),
                                          features=feats)
        final = finals[s]
        for k in fused_scan.STATE_FIELDS:
            np.testing.assert_array_equal(final[k].numpy(), np.asarray(getattr(ref, k)),
                                          err_msg=f"scenario {s} {k}")
        if plan.has_scal:
            np.testing.assert_array_equal(final["used_scalar"].numpy(),
                                          np.asarray(ref.used_scalar))
        if plan.has_gpu:
            np.testing.assert_array_equal(final["gpu_used"].numpy(), np.asarray(ref.gpu_used).T,
                                          err_msg=f"scenario {s} gpu_used")
        if plan.has_store:
            np.testing.assert_array_equal(final["vg_used"].numpy().T, np.asarray(ref.vg_used),
                                          err_msg=f"scenario {s} vg_used")
            for k in ("ssd_used", "hdd_used"):
                np.testing.assert_array_equal(final[k].numpy().T.astype(bool),
                                              np.asarray(getattr(ref, k)), err_msg=k)
        if plan.has_terms:
            for k, rows_k in _node_space(plan, final).items():
                np.testing.assert_array_equal(rows_k, np.asarray(getattr(ref, k)),
                                              err_msg=f"scenario {s} {k}")
    return j_place, finals, plan


def _gpu_pod(name, mem, count=1):
    pod = make_fake_pod(name, "default", "500m", "512Mi")
    pod["metadata"]["annotations"] = {"alibabacloud.com/gpu-mem": str(mem),
                                      "alibabacloud.com/gpu-count": str(count)}
    return pod


def test_pins_first_gpu_pins_on_one_node_keep_pod_order():
    """Several GPU pods pinned to one GPU-share node, where the tightest
    fit depends on their order: the same sizes (16, 20, 8) committed in
    two orders (rows 0 and 1, with no free pod) leave the node's two
    devices differently; in the other rows the free GPU pods after the
    pins fit or not by the devices the pins left."""
    nodes = [make_fake_node("node-0", "32", "128Gi", with_node_gpu(2, "64")),
             make_fake_node("node-1", "32", "128Gi", with_node_gpu(1, "32")),
             make_fake_node("node-2", "32", "128Gi")]
    mems = [16, 20, 8, 20, 8, 16]
    pods = [_gpu_pod(f"g-{i}", m) for i, m in enumerate(mems)]
    pods.append(_gpu_pod("g-pair", 10, count=2))
    pods += [_gpu_pod(f"free-{i}", m) for i, m in enumerate([24, 16, 12, 8, 4])]
    pods += [make_fake_pod(f"c-{i}", "default", "1", "1Gi") for i in range(3)]
    p, n = len(pods), len(nodes)
    pins = np.full((5, p), -1, np.int64)
    pins[0, [0, 1, 2]] = 0            # 16, 20, 8
    pins[1, [3, 4, 5]] = 0            # 20, 8, 16
    pins[2, [0, 1, 2, 3, 4, 5]] = 0   # all six (overcommitted: a pin overrides the fit)
    pins[3, [0, 2, 6]] = 0            # 16, 8, then the pair's greedy prefix
    pins[3, [1, 3]] = 1
    pins[4, [6, 1, 4]] = 0            # the pair first, then 20, 8
    pins[:, 13] = 2
    valids = np.ones((5, n), bool)
    actives = np.ones((5, p), bool)
    actives[:, [0, 1, 2, 3, 4, 5, 6]] &= pins[:, :7] >= 0  # unpinned GPU pods sit out
    actives[:2, 7:12] = False
    _, finals, plan = _hold(nodes, pods, valids, actives, pins)
    assert plan.has_gpu
    gpu0 = [f["gpu_used"].numpy()[:, 0].tolist() for f in finals]
    assert sorted(gpu0[0]) == sorted(gpu0[1]) and gpu0[0] != gpu0[1]


def _vg_node(name, caps_gi):
    node = make_fake_node(name, "32", "128Gi")
    node["metadata"].setdefault("annotations", {})["simon/node-local-storage"] = json.dumps({
        "vgs": [{"name": f"vg{k}", "capacity": str(c * GI), "requested": "0"}
                for k, c in enumerate(caps_gi)],
        "devices": [{"name": "/dev/vdb", "capacity": str(60 * GI), "mediaType": "ssd",
                     "isAllocated": "false"}],
    })
    return node


def _lvm_pod(name, sizes_gi, ssd=False):
    pod = make_fake_pod(name, "default", "250m", "256Mi")
    vols = [("LVM", s * GI) for s in sizes_gi] + ([("SSD", 20 * GI)] if ssd else [])
    pod["metadata"]["annotations"] = {"simon/pod-local-storage": json.dumps({"volumes": [
        {"kind": k, "size": str(sz), "scName": f"open-local-{k.lower()}"} for k, sz in vols]})}
    return pod


def test_pins_first_storage_pins_on_one_node_keep_pod_order():
    """Several storage pods pinned to one node's two VGs: each LVM volume
    goes to the least free VG that fits, so the order of the pins decides
    which VG each takes (rows 0 and 1, with no free pod), and so where the
    free storage pods of the other rows fit."""
    nodes = [_vg_node("node-0", [40, 30]), _vg_node("node-1", [30, 20]),
             make_fake_node("node-2", "32", "128Gi")]
    sizes = [[10], [25], [15], [20], [25], [10], [5, 5], [15]]
    pods = [_lvm_pod(f"s-{i}", s, ssd=i == 2) for i, s in enumerate(sizes)]
    pods += [_lvm_pod(f"free-{i}", s) for i, s in enumerate([[20], [12], [8], [30]])]
    pods += [make_fake_pod(f"c-{i}", "default", "1", "1Gi") for i in range(2)]
    p, n = len(pods), len(nodes)
    pins = np.full((5, p), -1, np.int64)
    pins[0, [0, 1, 2]] = 0          # 10, 25, 15
    pins[1, [3, 4, 5]] = 0          # 20, 25, 10
    pins[2, :8] = 0                 # every storage pod on node-0
    pins[3, [0, 6, 7]] = 0
    pins[3, [1, 3]] = 1
    pins[4, [2, 4]] = 1
    pins[4, [5, 6]] = 0
    pins[:, 12] = 2
    valids = np.ones((5, n), bool)
    actives = np.ones((5, p), bool)
    actives[:, :8] &= pins[:, :8] >= 0
    actives[:2, 8:12] = False
    _, finals, plan = _hold(nodes, pods, valids, actives, pins)
    assert plan.has_store
    vg0 = [f["vg_used"].numpy()[:, 0].tolist() for f in finals]
    assert vg0[0] != vg0[1]


def _zone_pod(i, app, hard):
    pod = make_fake_pod(f"z-{i}", "default", "250m", "256Mi")
    pod["metadata"].setdefault("labels", {})["app"] = app
    pod["spec"]["topologySpreadConstraints"] = [
        {"maxSkew": 1, "topologyKey": "zone",
         "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
         "labelSelector": {"matchLabels": {"app": app}}}]
    return pod


def test_pins_first_pins_into_shared_zones_with_hard_and_soft_spread():
    """Pins into zone domains that many nodes share (a replica count in
    every block of the kernel), under hard and soft topology spread: the
    free pods' skews are taken against counts that every pin fed."""
    rng = np.random.RandomState(11)
    n = 18
    nodes = [make_fake_node(f"node-{i}", "8", "32Gi", with_node_labels(
        {"zone": f"z{i % 3}", "kubernetes.io/hostname": f"node-{i}"})) for i in range(n)]
    pods = [_zone_pod(i, f"a{i % 2}", hard=i % 4 < 2) for i in range(48)]
    p = len(pods)
    valids = np.ones((4, n), bool)
    valids[1, [0, 3]] = False
    actives = np.ones((4, p), bool)
    pins = np.where(rng.rand(4, p) < 0.5, rng.randint(n, size=(4, p)), -1)
    pins[2] = np.where(pins[2] >= 0, 3 * rng.randint(6, size=p), -1)  # every pin in z0
    pins[3, ::2] = -1
    _, _finals, plan = _hold(nodes, pods, valids, actives, pins)
    assert plan.has_terms


@pytest.mark.parametrize("rows", ["masked-and-inactive", "all-pinned", "no-pins"])
def test_pins_first_masked_inactive_all_and_no_pins(rows):
    """Rows of the base and B2 plans whose pins lie on masked nodes or
    belong to inactive pods, rows with every pod pinned (no free pass),
    and rows with no pin (no pinned pass)."""
    for kind, n, p in (("base", 20, 70), ("b2", 16, 60)):
        nodes, pods = _case(kind, n, p, seed=n * 3 + p)
        rng = np.random.RandomState(n + p + len(rows))
        valids = rng.rand(4, n) > 0.3
        actives = rng.rand(4, p) > 0.2
        if rows == "masked-and-inactive":
            off = np.flatnonzero(~valids[0])
            pins = np.where(rng.rand(4, p) < 0.7, rng.randint(n, size=(4, p)), -1)
            pins[0] = np.where(pins[0] >= 0, rng.choice(off, size=p), -1)  # every pin masked
            actives[1] = pins[1] < 0  # every pinned pod inactive
        elif rows == "all-pinned":
            pins = rng.randint(n, size=(4, p))
        else:
            pins = np.full((4, p), -1, np.int64)
        place, _, _ = _hold(nodes, pods, valids, actives, pins)
        if rows == "masked-and-inactive":
            assert (place[0][pins[0] >= 0] == fused_scan.INACTIVE).all()
            assert (place[1][pins[1] >= 0] == fused_scan.INACTIVE).all()
        if rows == "all-pinned":
            ok = np.take_along_axis(valids, pins, axis=1) & actives
            np.testing.assert_array_equal(place, np.where(ok, pins, fused_scan.INACTIVE))


@pytest.mark.parametrize("p", [383, 385, 511, 513, 1025])
def test_pins_first_across_chunk_edges(p):
    """Pod counts just around the kernel's chunks (384 and 512 pods a
    block-wide round, 32 and 64 a warp's) at a few dozen nodes, most pods
    pinned: the pods either side of each edge commit or schedule alike."""
    n = 36
    rng = np.random.RandomState(p)
    nodes = [make_fake_node(f"node-{i}", "64", "256Gi") for i in range(n)]
    pods = [make_fake_pod(f"p-{i}", "default", ["100m", "250m", "500m"][i % 3], "256Mi")
            for i in range(p)]
    valids = rng.rand(2, n) > 0.1
    actives = rng.rand(2, p) > 0.05
    pins = np.where(rng.rand(2, p) < 0.85, rng.randint(n, size=(2, p)), -1)
    pins[1, -1] = -1
    pins[1, p // 2] = -1
    _hold(nodes, pods, valids, actives, pins)


def test_scenario_inputs_check_and_clamp_the_pin_rows():
    """The wrapper's host checks of a launch's rows (one pass over each
    pin row into the [S, P] int32 block the kernel reads): a pin past
    the last node, a pin on a plan built without pins and a row of the
    wrong length are refused; pins below -1 read as -1; rows without a
    pin vector are all -1."""
    nodes, pods = _case("base", 8, 12, seed=2)
    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods)
    bare = fused_scan.build_plan(pc, pb, pd, pf)
    plan = dataclasses.replace(bare, has_pins=True)
    cls = pb.class_of_pod
    act, val = np.ones(12, bool), np.ones(8, bool)
    pin = np.array([-1, -7, 0, 7, -1, 3, -2, 5, -1, -1, 1, -100])
    cls_t, act_t, val_t, pin_t = fused_scan._scenario_inputs(
        plan, cls, [(act, val, pin), (act & (np.arange(12) % 2 == 0), val, None)])
    np.testing.assert_array_equal(pin_t.numpy(), [np.maximum(pin, -1), np.full(12, -1)])
    np.testing.assert_array_equal(act_t.numpy()[1], (np.arange(12) % 2 == 0).astype(np.uint8))
    assert str(pin_t.dtype) == "torch.int32" and str(act_t.dtype) == "torch.uint8"
    with pytest.raises(ValueError, match="pinned node outside"):
        fused_scan._scenario_inputs(plan, cls, [(act, val, np.where(pin == 7, 8, pin))])
    with pytest.raises(ValueError, match="built without pins"):
        fused_scan._scenario_inputs(bare, cls, [(act, val, None), (act, val, pin)])
    fused_scan._scenario_inputs(bare, cls, [(act, val, np.full(12, -3))])  # no pin >= 0
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_scan._scenario_inputs(plan, cls, [(act, val, pin[:11])])
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_scan._scenario_inputs(plan, cls, [(act[:11], val, None)])
