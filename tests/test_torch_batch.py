"""The scenario batch of the GPU port's fused scan (`fused_scan_batch`,
open_simulator_tpu_torch/ops/fused_scan.py) on the CPU, exactly
(placements and states are integers, so the tolerance is equality):

- the batch plain version, fed the JAX Pallas plan through
  plan_from_jax_arrays, equals the JAX package's run_scan_pallas_batch
  in interpret mode, scenario for scenario;
- the batch equals one run_fused_scan per scenario (placements and every
  final state row), with per-scenario node masks, inactive pods and pins;
- three scenarios of the plain batch take one pass over the pods.

Inputs are small clusters and pod lists made from a numpy seed."""

import copy

import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu.testing import (
    make_fake_node,
    make_fake_pod,
    with_node_gpu,
    with_node_labels,
    with_node_name,
    with_node_selector,
    with_node_taints,
    with_tolerations,
)
from open_simulator_tpu_torch.ops import fused_scan

JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"


def _nodes(k, seed, gpu=False):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(k):
        cpu = int(rng.choice([4, 8, 16]))
        opts = [with_node_labels({"zone": f"z{i % 3}"})]
        if i % 4 == 0:
            opts.append(with_node_taints(
                [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]))
        if gpu:
            opts.append(with_node_gpu(1 + i % 3, "32"))
        nodes.append(make_fake_node(f"node-{i}", f"{cpu}", f"{cpu * 4}Gi", *opts))
    return nodes


def _pods(count, seed, pin_nodes=0, gpu=False):
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(count):
        opts = []
        if rng.rand() < 0.3:
            opts.append(with_node_selector({"zone": f"z{rng.randint(3)}"}))
        if rng.rand() < 0.3:
            opts.append(with_tolerations([{"key": "dedicated", "operator": "Exists"}]))
        if pin_nodes and rng.rand() < 0.15:
            opts.append(with_node_name(f"node-{rng.randint(pin_nodes)}"))
        pod = make_fake_pod(f"p-{i}", "default", ["250m", "500m", "1", "2"][rng.randint(4)],
                            ["256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(4)], *opts)
        if gpu and rng.rand() < 0.5:
            pod["metadata"]["annotations"] = {
                "alibabacloud.com/gpu-mem": str(int(rng.choice([4, 8, 16]))),
                "alibabacloud.com/gpu-count": str(int(rng.choice([1, 1, 2]))),
            }
        pods.append(pod)
    return pods


def _encode(pkg, nodes, pods):
    import importlib

    oracle = importlib.import_module(f"{pkg}.scheduler.oracle").Oracle(copy.deepcopy(nodes))
    enc = importlib.import_module(f"{pkg}.ops.encode")
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return cluster, batch, dyn, enc.features_of_batch(cluster, batch)


def _scenarios(n, p, pinned, seed):
    """All nodes on; the last 30% off; every 3rd node off and a fifth of
    the pods inactive — the kinds of masks a capacity sweep makes."""
    rng = np.random.RandomState(seed)
    last_off = np.ones(n, bool)
    last_off[int(n * 0.7):] = False
    every3 = np.arange(n) % 3 != 2
    return [
        (np.ones(p, bool), np.ones(n, bool), pinned),
        (np.ones(p, bool), last_off, pinned),
        (rng.rand(p) < 0.8, every3, pinned),
    ]


def _assert_same(got, want):
    (gp, gf), (wp, wf) = got, want
    np.testing.assert_array_equal(gp.numpy(), wp.numpy())
    assert gf.keys() == wf.keys()
    for k in gf:
        np.testing.assert_array_equal(gf[k].numpy(), wf[k].numpy(), err_msg=k)


@pytest.mark.parametrize("pins", [False, True])
def test_batch_plain_equals_pallas_batch_interpret(pins):
    n, p = 9, 50
    nodes, pods = _nodes(n, 1), _pods(p, 2, pin_nodes=n if pins else 0)
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods)
    jplan = pallas_scan.build_plan(cluster, batch, dyn, features)
    assert jplan is not None
    scen = _scenarios(n, p, batch.pinned_node, 3)
    ref = pallas_scan.run_scan_pallas_batch(jplan, batch.class_of_pod, scen)
    got = fused_scan.fused_scan_batch_reference(
        fused_scan.plan_from_jax_arrays(jplan), batch.class_of_pod, scen)
    assert len(got) == len(ref) == 3
    for (gp, gf), (rp, rf) in zip(got, ref):
        np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
        for k, v in rf.items():
            np.testing.assert_array_equal(gf[k].numpy(), v, err_msg=k)
    placements = [g[0].numpy() for g in got]
    # the scenarios differ and every mask took effect
    assert not np.array_equal(placements[0], placements[1])
    assert (placements[2] == fused_scan.INACTIVE).any()
    assert not np.isin(placements[1], np.arange(int(n * 0.7), n)).any()


@pytest.mark.parametrize("gpu,pins", [(False, True), (True, False), (True, True)])
def test_batch_equals_single_scans(gpu, pins):
    n, p = 10, 60
    nodes = _nodes(n, 4, gpu=gpu)
    pods = _pods(p, 5, pin_nodes=n if pins else 0, gpu=gpu)
    cluster, batch, dyn, features = _encode(PORT_PKG, nodes, pods)
    plan = fused_scan.build_plan(cluster, batch, dyn, features)
    assert plan.has_gpu == gpu and plan.has_pins == pins
    scen = _scenarios(n, p, batch.pinned_node, 6)
    # per-scenario pins too: a pin vector that differs between rows
    alt = np.asarray(batch.pinned_node).copy()
    alt[:5] = -1
    scen.append((np.ones(p, bool), np.ones(n, bool), alt))
    got = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen)
    for row, (act, val, pin) in zip(got, scen):
        _assert_same(row, fused_scan.run_fused_scan(
            plan, batch.class_of_pod, act, val, pinned=pin))
    if pins:
        # a pod pinned to a masked-off node is INACTIVE in that scenario
        pin = np.asarray(batch.pinned_node)
        off = (pin >= 0) & ~scen[1][1][np.maximum(pin, 0)]
        assert off.any()
        assert (got[1][0].numpy()[off] == fused_scan.INACTIVE).all()


def test_batch_plain_is_one_pass_over_the_pods(monkeypatch):
    """Three scenarios cost one loop over the pods, not three: count the
    per-pod argmax calls of the plain version."""
    n, p = 6, 30
    cluster, batch, dyn, features = _encode(PORT_PKG, _nodes(n, 7), _pods(p, 8))
    plan = fused_scan.build_plan(cluster, batch, dyn, features)
    calls = []
    real = torch.Tensor.argmax

    def counting(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "argmax", counting)
    fused_scan.run_fused_scan_batch(plan, batch.class_of_pod,
                                    _scenarios(n, p, None, 9))
    assert len(calls) == p


def test_batch_rejects_bad_scenarios():
    cluster, batch, dyn, features = _encode(PORT_PKG, _nodes(3, 10), _pods(5, 11))
    plan = fused_scan.build_plan(cluster, batch, dyn, features)
    with pytest.raises(ValueError, match="no scenarios"):
        fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, [])
    with pytest.raises(ValueError, match="shape"):
        fused_scan.run_fused_scan_batch(
            plan, batch.class_of_pod, [(np.ones(5, bool), np.ones(4, bool), None)])


def _store_terms_case():
    """The affinity stress slice (anti-affinity, hard and soft spread,
    preferred affinity) with open-local VGs on two nodes of three and
    LVM volumes, extended resources and hostPorts on some pods, and one
    pin: every block of the kernel in one plan."""
    import json

    from open_simulator_tpu.testing import build_affinity_stress
    from open_simulator_tpu_torch.models import workloads as wl
    from open_simulator_tpu_torch.models.decode import ResourceTypes
    from open_simulator_tpu_torch.scheduler.core import _sort_app_pods

    gi = 1 << 30
    nodes, stss = build_affinity_stress(n_nodes=18, n_sts=4, replicas=6, zones=3)
    for i, node in enumerate(nodes):
        if i % 3:
            node["metadata"].setdefault("annotations", {})["simon/node-local-storage"] = \
                json.dumps({"vgs": [{"name": "a", "capacity": str(60 * gi), "requested": "0"},
                                    {"name": "b", "capacity": str(25 * gi), "requested": "0"}],
                            "devices": [{"name": "/dev/s", "capacity": str(100 * gi),
                                         "mediaType": "ssd", "isAllocated": "false"}]})
        node["status"]["allocatable"]["example.com/accel"] = "2"
    wl.reset_name_counter()
    res = ResourceTypes()
    res.stateful_sets = stss
    pods = _sort_app_pods(wl.generate_valid_pods_from_app("t", res, nodes))
    rng = np.random.RandomState(3)
    for k, pod in enumerate(pods):
        pod["metadata"] = copy.deepcopy(pod["metadata"])
        pod["spec"] = copy.deepcopy(pod["spec"])
        r = rng.randint(4)
        if r == 0:
            pod["metadata"].setdefault("annotations", {})["simon/pod-local-storage"] = \
                json.dumps({"volumes": [{"kind": "LVM", "size": str(20 * gi),
                                         "scName": "open-local-lvm"},
                                        {"kind": "SSD", "size": str(50 * gi),
                                         "scName": "open-local-device-ssd"}]})
        elif r == 1:
            pod["spec"]["containers"][0]["resources"]["requests"]["example.com/accel"] = "1"
        elif r == 2:
            pod["spec"]["containers"][0]["ports"] = [{"containerPort": 80,
                                                      "hostPort": 8000 + k % 2}]
    pods[2]["spec"]["nodeName"] = nodes[4]["metadata"]["name"]
    return nodes, pods


def test_batch_with_storage_and_terms_equals_singles_and_xla():
    """B6 with the storage and term blocks on: each scenario of one
    batch equals its own single scan, and the XLA scan of the JAX
    package on that scenario's masks (placements, base rows, VG usage,
    device bits and every term row in node space)."""
    import jax.numpy as jnp

    from open_simulator_tpu.ops import scan as scan_ops
    from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
    from test_torch_terms import node_space

    nodes, pods = _store_terms_case()
    plan = fused_scan.build_plan(*_encode(PORT_PKG, nodes, pods))
    assert plan.has_store and plan.has_terms and plan.has_scal and plan.has_ports
    assert plan.has_pins
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods)
    n, p = len(nodes), len(pods)
    scen = _scenarios(n, p, batch.pinned_node, 12)
    got = fused_scan.run_fused_scan_batch(plan, batch.class_of_pod, scen)
    static, init = to_scan_static(cluster, batch), to_scan_state(dyn, batch)
    for row, (act, val, pin) in zip(got, scen):
        _assert_same(row, fused_scan.run_fused_scan(plan, batch.class_of_pod, act, val,
                                                    pinned=pin))
        ref, ref_state = scan_ops.run_scan_masked(
            static, init, jnp.asarray(batch.class_of_pod), jnp.asarray(pin),
            jnp.asarray(val), jnp.asarray(act), features=features)
        placements, final = row
        np.testing.assert_array_equal(placements.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(final["vg_used"].numpy().T, np.asarray(ref_state.vg_used))
        np.testing.assert_array_equal(final["ssd_used"].numpy().T.astype(bool),
                                      np.asarray(ref_state.ssd_used))
        for k, v in node_space(plan, final).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(ref_state, k)), err_msg=k)
    assert not np.array_equal(got[0][0].numpy(), got[1][0].numpy())
