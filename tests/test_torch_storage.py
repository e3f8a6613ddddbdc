"""The open-local storage block (B3) of the GPU port's fused scan on the
CPU, exactly (placements, VG usage and device bits are integers, so the
tolerance is equality):

- the port's build_plan path and plain version equal the JAX package's
  XLA scan (run_scan_masked): placements, the six base rows, `vg_used`
  and the SSD/HDD bits — including 6 VGs (past the Pallas plan's cap of
  4), score fractions over 3 and 4 VGs that expose the f64 sum order,
  more volumes than the Pallas cap, pins and scenario masks;
- plan_from_jax_arrays unfolds a Pallas StorePlan (GCD scale, storage
  row dedup) into the rows build_plan makes, and the plain version on it
  equals the Pallas kernel in interpret mode;
- the CUDA kernel equals the plain version in tests/test_torch_cuda.py
  (needs the card).

Inputs are small clusters made from a numpy seed; the node and pod
helpers are those of tests/test_pallas_storage.py."""

import copy
import importlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu.ops import scan as scan_ops
from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
from open_simulator_tpu_torch.ops import fused_scan

GI = 1 << 30
STATE = fused_scan.STATE_FIELDS


def make_node(i, vgs=None, devices=None, cpu="32", storage=True):
    anno = {}
    if storage:
        anno["simon/node-local-storage"] = json.dumps({
            "vgs": vgs if vgs is not None else [
                {"name": "a", "capacity": str(100 * GI), "requested": "0"},
                {"name": "b", "capacity": str(200 * GI), "requested": "0"},
            ],
            "devices": devices if devices is not None else [
                {"name": "/dev/vdb", "capacity": str(120 * GI), "mediaType": "ssd",
                 "isAllocated": "false"},
                {"name": "/dev/vdc", "capacity": str(500 * GI), "mediaType": "hdd",
                 "isAllocated": "false"},
            ],
        })
    return {
        "kind": "Node",
        "metadata": {"name": f"n{i:04d}", "labels": {"kubernetes.io/hostname": f"n{i:04d}"},
                     "annotations": anno},
        "status": {"allocatable": {"cpu": cpu, "memory": "128Gi", "pods": "110"},
                   "capacity": {"cpu": cpu, "memory": "128Gi", "pods": "110"}},
    }


def make_pod(name, vols, cpu="100m"):
    anno = {}
    if vols:
        anno["simon/pod-local-storage"] = json.dumps({"volumes": [
            {"kind": k, "size": str(sz), "scName": f"open-local-{k.lower()}"}
            for k, sz in vols]})
    return {
        "metadata": {"name": name, "namespace": "t", "labels": {}, "annotations": anno},
        "spec": {"containers": [{"name": "c", "image": "i",
                                 "resources": {"requests": {"cpu": cpu, "memory": "128Mi"}}}]},
    }


def _encode(pkg, nodes, pods, existing=()):
    oracle = importlib.import_module(f"{pkg}.scheduler.oracle").Oracle(copy.deepcopy(nodes))
    for p in existing:
        oracle.place_existing_pod(copy.deepcopy(p))
    enc = importlib.import_module(f"{pkg}.ops.encode")
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return cluster, batch, dyn, enc.features_of_batch(cluster, batch)


def check_case(nodes, pods, existing=(), node_valid=None, pod_active=None):
    """The XLA scan and the port's plain version on the same inputs:
    identical placements, base rows, VG usage and device bits. Returns
    the placements."""
    n, p = len(nodes), len(pods)
    nv = np.ones(n, bool) if node_valid is None else node_valid
    pa = np.ones(p, bool) if pod_active is None else pod_active
    cluster, batch, dyn, features = _encode("open_simulator_tpu", nodes, pods, existing)
    assert features.storage
    ref, ref_state = scan_ops.run_scan_masked(
        to_scan_static(cluster, batch), to_scan_state(dyn, batch),
        jnp.asarray(batch.class_of_pod), jnp.asarray(batch.pinned_node),
        jnp.asarray(nv), jnp.asarray(pa), features=features)
    pc, pb, pd, pf = _encode("open_simulator_tpu_torch", nodes, pods, existing)
    plan = fused_scan.build_plan(pc, pb, pd, pf)
    assert plan.has_store and not plan.has_terms
    got, final = fused_scan.run_fused_scan(plan, pb.class_of_pod, pa, nv,
                                           pinned=pb.pinned_node)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for k in STATE:
        np.testing.assert_array_equal(final[k].numpy(), np.asarray(getattr(ref_state, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(final["vg_used"].numpy().T, np.asarray(ref_state.vg_used))
    for k in ("ssd_used", "hdd_used"):
        np.testing.assert_array_equal(final[k].numpy().T.astype(bool),
                                      np.asarray(getattr(ref_state, k)), err_msg=k)
    return got.numpy()


def test_lvm_binpack_fills_tightest_vg():
    got = check_case([make_node(0)], [make_pod(f"p{i}", [("LVM", 30 * GI)]) for i in range(9)])
    assert (got == 0).all()


def test_lvm_volume_too_big_fails_node():
    nodes = [make_node(0), make_node(1, vgs=[
        {"name": "big", "capacity": str(400 * GI), "requested": "0"}])]
    assert check_case(nodes, [make_pod("p0", [("LVM", 250 * GI)])])[0] == 1


def test_multi_volume_sequential_binpack():
    check_case([make_node(0)], [
        make_pod("p0", [("LVM", 80 * GI), ("LVM", 90 * GI), ("LVM", 150 * GI)]),
        make_pod("p1", [("LVM", 80 * GI), ("LVM", 90 * GI)]),
    ])


def test_exclusive_devices_first_fit_and_exhaustion():
    got = check_case([make_node(i) for i in range(2)],
                     [make_pod(f"s{i}", [("SSD", 100 * GI)]) for i in range(3)])
    assert (got >= 0).sum() == 2 and got[2] == -1


def test_device_preallocated_excluded():
    nodes = [make_node(0, devices=[{"name": "/dev/vdb", "capacity": str(120 * GI),
                                    "mediaType": "ssd", "isAllocated": "true"}]),
             make_node(1)]
    assert check_case(nodes, [make_pod("s0", [("SSD", 100 * GI)])])[0] == 1


def test_initial_vg_requested_honored():
    nodes = [make_node(0, vgs=[{"name": "a", "capacity": str(100 * GI),
                                "requested": str(95 * GI)}]),
             make_node(1, vgs=[{"name": "a", "capacity": str(100 * GI), "requested": "0"}])]
    assert check_case(nodes, [make_pod("p0", [("LVM", 10 * GI)])])[0] == 1


def test_non_storage_nodes_reject_storage_pods():
    got = check_case([make_node(0, storage=False), make_node(1)],
                     [make_pod("p0", [("LVM", GI)]), make_pod("p1", None)])
    assert got[0] == 1


def test_scenario_masks_apply():
    nv = np.array([False, True, True, False])
    pa = np.array([True, False, True, True, True, False])
    got = check_case([make_node(i) for i in range(4)],
                     [make_pod(f"p{i}", [("LVM", GI)]) for i in range(6)],
                     node_valid=nv, pod_active=pa)
    assert set(got[pa]) <= {1, 2}


def test_existing_pods_do_not_recharge_vgs():
    ex = make_pod("ex", [("LVM", 95 * GI), ("LVM", 190 * GI)])
    ex["spec"]["nodeName"] = "n0000"
    got = check_case([make_node(i) for i in range(2)], [make_pod("p0", [("LVM", 50 * GI)])],
                     existing=[ex])
    assert got[0] == 0


def test_pins_charge_the_pinned_node():
    """A pinned storage pod is charged its takes at the pin, as the XLA
    scan charges it, even where a volume does not fit there."""
    pods = [make_pod(f"p{i}", [("LVM", 60 * GI), ("SSD", 100 * GI)]) for i in range(6)]
    for i in (0, 2, 3):
        pods[i]["spec"]["nodeName"] = "n0001"
    got = check_case([make_node(i) for i in range(3)], pods)
    assert got[0] == got[2] == got[3] == 1


def _vgs(caps_gi, used_gi=None):
    used_gi = used_gi or [0] * len(caps_gi)
    return [{"name": f"vg{k}", "capacity": str(c * GI), "requested": str(u * GI)}
            for k, (c, u) in enumerate(zip(caps_gi, used_gi))]


@pytest.mark.parametrize("n_vgs", [3, 4, 6])
def test_many_vgs_and_the_score_sum_order(n_vgs):
    """3, 4 and 6 VGs (6 is past the Pallas plan's cap): capacities of 3,
    7, 11, ... GiB make every take/cap fraction inexact in f64, so the
    LVM score's sum over VG slots must be added in slot order to agree
    bit for bit; volumes spread over several VGs of one node."""
    caps = [3 + 4 * k for k in range(n_vgs)]
    rng = np.random.RandomState(n_vgs)
    nodes = [make_node(i, vgs=_vgs([c * (1 + i % 3) for c in caps],
                                   [int(rng.randint(0, 2)) for _ in caps]))
             for i in range(6)]
    pods = []
    for i in range(40):
        vols = [("LVM", int(rng.randint(1, 8)) * GI) for _ in range(int(rng.randint(1, 5)))]
        pods.append(make_pod(f"p{i}", vols))
    got = check_case(nodes, pods)
    assert (got >= 0).sum() > 10


def test_many_devices_and_volumes_past_the_pallas_caps():
    """5 SSDs and 3 HDDs per node, pods with 3 SSD and 3 HDD volumes and
    5 LVM volumes (the Pallas plan stops at 4 devices and 2 volumes a
    media)."""
    rng = np.random.RandomState(3)
    nodes = []
    for i in range(5):
        devs = [{"name": f"/dev/s{d}", "capacity": str(int(rng.choice([40, 80, 120])) * GI),
                 "mediaType": "ssd", "isAllocated": "true" if rng.rand() < 0.1 else "false"}
                for d in range(5)]
        devs += [{"name": f"/dev/h{d}", "capacity": str(int(rng.choice([200, 500])) * GI),
                  "mediaType": "hdd", "isAllocated": "false"} for d in range(3)]
        nodes.append(make_node(i, vgs=_vgs([50, 70, 90, 110, 130]), devices=devs))
    shapes = [
        [("SSD", 30 * GI), ("SSD", 50 * GI), ("SSD", 70 * GI)],
        [("HDD", 150 * GI), ("HDD", 190 * GI), ("HDD", 100 * GI)],
        [("LVM", 9 * GI)] * 5,
        [("SSD", 10 * GI), ("HDD", 10 * GI), ("LVM", 3 * GI)],
    ]
    pods = [make_pod(f"p{i}", shapes[int(rng.randint(len(shapes)))]) for i in range(30)]
    check_case(nodes, pods)


@pytest.mark.parametrize("seed", range(3))
def test_randomized_mixed_conformance(seed):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(24):
        vgs = [{"name": "a", "capacity": str(int(rng.choice([50, 100])) * GI),
                "requested": str(int(rng.randint(0, 10)) * GI)},
               {"name": "b", "capacity": str(int(rng.choice([100, 200])) * GI),
                "requested": "0"}]
        devices = [{"name": "/dev/vdb", "capacity": str(int(rng.choice([80, 120])) * GI),
                    "mediaType": "ssd", "isAllocated": "false"},
                   {"name": "/dev/vdc", "capacity": str(500 * GI), "mediaType": "hdd",
                    "isAllocated": "true" if rng.rand() < 0.2 else "false"}]
        nodes.append(make_node(i, vgs=vgs, devices=devices, storage=rng.rand() < 0.9))
    shapes = [[("LVM", 1 * GI)], [("LVM", 5 * GI)], [("LVM", 10 * GI), ("LVM", 2 * GI)],
              [("LVM", 8 * GI), ("LVM", 4 * GI), ("LVM", 1 * GI)], [("SSD", 100 * GI)],
              [("HDD", 400 * GI)], [("LVM", 3 * GI), ("SSD", 60 * GI)], None]
    pods = [make_pod(f"p{p:04d}", shapes[int(rng.randint(0, len(shapes)))])
            for p in range(120)]
    for i in rng.choice(len(pods), 4, replace=False):
        pods[i]["spec"]["nodeName"] = f"n{rng.randint(24):04d}"
    nv = rng.rand(24) < 0.85
    check_case(nodes, pods, node_valid=nv, pod_active=rng.rand(len(pods)) < 0.9)


def test_plain_on_a_pallas_store_plan_equals_pallas_interpret():
    """plan_from_jax_arrays on a Pallas StorePlan (GCD-scaled, storage
    rows deduplicated): the same rows as build_plan, and the plain
    version on it places as the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(5)
    nodes = [make_node(i, vgs=_vgs([100, 200], [int(rng.randint(0, 3)), 0]))
             for i in range(10)]
    shapes = [[("LVM", 20 * GI)], [("LVM", 30 * GI), ("LVM", 40 * GI)],
              [("SSD", 100 * GI)], [("HDD", 300 * GI)], None]
    pods = [make_pod(f"p{i}", shapes[int(rng.randint(len(shapes)))]) for i in range(40)]
    cluster, batch, dyn, features = _encode("open_simulator_tpu", nodes, pods)
    jplan = pallas_scan.build_plan(cluster, batch, dyn, features)
    assert jplan is not None and jplan.store is not None and jplan.store.scale > 1
    plan = fused_scan.plan_from_jax_arrays(jplan)
    own = fused_scan.build_plan(*_encode("open_simulator_tpu_torch", nodes, pods))
    for field in ("vg_cap", "vg_init", "ssd_cap", "ssd_init", "hdd_cap", "hdd_init",
                  "has_storage", "cls_lvm", "cls_ssd", "cls_hdd", "cls_wants",
                  "alloc", "init", "cls_req", "feasible", "cls_tab"):
        assert torch.equal(getattr(plan, field), getattr(own, field)), field
    assert plan.weights == own.weights
    pa, nv = rng.rand(len(pods)) < 0.9, rng.rand(10) < 0.9
    pal_p, pal_f = pallas_scan.run_scan_pallas(jplan, batch.class_of_pod, pa, nv,
                                              pinned=batch.pinned_node, interpret=True)
    got, final = fused_scan.fused_scan_reference(plan, batch.class_of_pod, pa, nv,
                                                 pinned=batch.pinned_node)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal_p))
    np.testing.assert_array_equal(final["vg_used"].numpy().T, pal_f["vg_used"])


def test_device_volumes_must_ascend():
    cluster, batch, dyn, features = _encode(
        "open_simulator_tpu_torch", [make_node(0)],
        [make_pod("p", [("SSD", 10 * GI), ("SSD", 20 * GI)])])
    batch.ssd_sizes = batch.ssd_sizes[:, ::-1].copy()
    with pytest.raises(ValueError, match="ascending"):
        fused_scan.build_plan(cluster, batch, dyn, features)
