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
