"""The GPU port's fused scan (open_simulator_tpu_torch/ops/fused_scan.py)
against the JAX package, exactly (placements and int64 states are
integers, so the tolerance is equality):

- the plain PyTorch version, fed the JAX Pallas plan through
  plan_from_jax_arrays, equals the Pallas kernel in interpret mode;
- the port's own build_plan path equals the XLA scan (run_scan_masked),
  placements and the six final state rows;
- the CUDA kernel equals the plain version in tests/test_torch_cuda.py
  (needs the card).

Inputs are small clusters and pod lists made from a numpy seed."""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu.ops import scan as scan_ops
from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
from open_simulator_tpu.testing import (
    make_fake_node,
    make_fake_pod,
    with_node_labels,
    with_node_name,
    with_node_selector,
    with_node_taints,
    with_tolerations,
)
from open_simulator_tpu_torch.ops import fused_scan

JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"
STATE = ("used_mcpu", "used_mem", "used_eph", "nz_mcpu", "nz_mem", "pod_cnt")


def _nodes(k=8, seed=0, cpus=(4, 8, 16, 32)):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(k):
        cpu = int(rng.choice(cpus))
        opts = [with_node_labels({"zone": f"z{i % 3}"})]
        if i % 3 == 0:
            opts.append(with_node_taints(
                [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
            ))
        nodes.append(make_fake_node(f"node-{i}", f"{cpu}", f"{cpu * 4}Gi", *opts))
    return nodes


def _pods(count=40, seed=1, pin_nodes=0):
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(count):
        cpu = ["250m", "500m", "1", "2"][rng.randint(4)]
        mem = ["256Mi", "512Mi", "1Gi", "2Gi"][rng.randint(4)]
        opts = []
        if rng.rand() < 0.3:
            opts.append(with_node_selector({"zone": f"z{rng.randint(3)}"}))
        if rng.rand() < 0.3:
            opts.append(with_tolerations([{"key": "dedicated", "operator": "Exists"}]))
        if pin_nodes and rng.rand() < 0.2:
            opts.append(with_node_name(f"node-{rng.randint(pin_nodes)}"))
        pods.append(make_fake_pod(f"p-{i}", "default", cpu, mem, *opts))
    return pods


def _encode(pkg, nodes, pods, weights=None):
    """(cluster, batch, dyn, features) of one package on its own copy of
    the inputs."""
    oracle_mod = importlib.import_module(f"{pkg}.scheduler.oracle")
    enc = importlib.import_module(f"{pkg}.ops.encode")
    oracle = oracle_mod.Oracle(copy.deepcopy(nodes))
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    features = enc.features_of_batch(cluster, batch, weights=weights)
    return cluster, batch, dyn, features


def _masks(n, p, seed, node_frac=1.0, pod_frac=1.0):
    rng = np.random.RandomState(seed)
    valid = rng.rand(n) < node_frac
    active = rng.rand(p) < pod_frac
    return active, valid


def _xla(nodes, pods, active, valid, weights=None):
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods, weights)
    placements, final = scan_ops.run_scan_masked(
        to_scan_static(cluster, batch),
        to_scan_state(dyn, batch),
        jnp.asarray(batch.class_of_pod),
        jnp.asarray(batch.pinned_node),
        jnp.asarray(valid),
        jnp.asarray(active),
        features=features,
    )
    return np.asarray(placements), {k: np.asarray(getattr(final, k)) for k in STATE}


def _port(nodes, pods, active, valid, weights=None):
    cluster, batch, dyn, features = _encode(PORT_PKG, nodes, pods, weights)
    plan = fused_scan.build_plan(cluster, batch, dyn, features, device="cpu")
    placements, final = fused_scan.run_fused_scan(
        plan, batch.class_of_pod, active, valid, pinned=batch.pinned_node
    )
    return placements.numpy(), {k: v.numpy() for k, v in final.items()}


SCENARIOS = {
    # name: (nodes, pods, node_frac, pod_frac)
    "basic": (lambda: _nodes(8, 0), lambda: _pods(40, 1), 1.0, 1.0),
    "masked": (lambda: _nodes(10, 2), lambda: _pods(50, 3), 0.7, 0.8),
    "overload": (lambda: _nodes(4, 4), lambda: _pods(120, 5), 1.0, 1.0),
    "pins": (lambda: _nodes(6, 6), lambda: _pods(60, 7, pin_nodes=6), 0.8, 0.9),
    # 30,000-core nodes: past the JAX plan's int32 bound, inside int64
    "magnitude": (lambda: _nodes(5, 8, cpus=(30000, 40000)),
                  lambda: _pods(60, 9), 1.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plain_equals_xla_scan(name):
    mk_nodes, mk_pods, nf, pf = SCENARIOS[name]
    nodes, pods = mk_nodes(), mk_pods()
    active, valid = _masks(len(nodes), len(pods), 11, nf, pf)
    xla_p, xla_f = _xla(nodes, pods, active, valid)
    port_p, port_f = _port(nodes, pods, active, valid)
    np.testing.assert_array_equal(port_p, xla_p)
    for k in STATE:
        np.testing.assert_array_equal(port_f[k], xla_f[k], err_msg=k)
    if name == "overload":
        assert (port_p == -1).any()
    if name == "masked":
        assert (port_p[~active] == fused_scan.INACTIVE).all()
        assert not np.isin(port_p[port_p >= 0], np.flatnonzero(~valid)).any()


def test_magnitude_case_is_outside_the_jax_plan():
    mk_nodes, mk_pods, _, _ = SCENARIOS["magnitude"]
    cluster, batch, dyn, features = _encode(JAX_PKG, mk_nodes(), mk_pods())
    assert pallas_scan.build_plan(cluster, batch, dyn, features) is None


@pytest.mark.parametrize("weights", [
    (1, 0, 1, 2, 1, 1, 1, 1, 1, 1, 1),
    (0, 3, 0, 1, 0, 0, 0, 0, 0, 0, 0),
])
def test_plain_equals_xla_scan_weighted(weights):
    from open_simulator_tpu.scheduler.schedconfig import ScoreWeights as JW
    from open_simulator_tpu_torch.scheduler.schedconfig import ScoreWeights as PW

    nodes, pods = _nodes(8, 12), _pods(50, 13)
    active, valid = _masks(len(nodes), len(pods), 14)
    xla_p, _ = _xla(nodes, pods, active, valid, weights=JW(*weights))
    port_p, _ = _port(nodes, pods, active, valid, weights=PW(*weights))
    np.testing.assert_array_equal(port_p, xla_p)


@pytest.mark.parametrize("name", ["basic", "masked", "pins"])
def test_plain_equals_pallas_interpret(name):
    mk_nodes, mk_pods, nf, pf = SCENARIOS[name]
    nodes, pods = mk_nodes(), mk_pods()
    active, valid = _masks(len(nodes), len(pods), 21, nf, pf)
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods)
    jplan = pallas_scan.build_plan(cluster, batch, dyn, features)
    assert jplan is not None
    pal_p, pal_f = pallas_scan.run_scan_pallas(
        jplan, batch.class_of_pod, active, valid, pinned=batch.pinned_node,
        interpret=True,
    )
    plan = fused_scan.plan_from_jax_arrays(jplan)
    port_p, port_f = fused_scan.fused_scan_reference(
        plan, batch.class_of_pod, active, valid, pinned=batch.pinned_node
    )
    np.testing.assert_array_equal(port_p.numpy(), np.asarray(pal_p))
    for k, v in pal_f.items():
        np.testing.assert_array_equal(port_f[k].numpy(), v, err_msg=k)


def test_plan_from_jax_arrays_equals_build_plan():
    """The JAX plan's arrays, un-padded and un-scaled, are the port's
    own plan for the same batch."""
    nodes, pods = _nodes(7, 30), _pods(40, 31)
    cluster, batch, dyn, features = _encode(JAX_PKG, nodes, pods)
    from_jax = fused_scan.plan_from_jax_arrays(
        pallas_scan.build_plan(cluster, batch, dyn, features)
    )
    own = fused_scan.build_plan(*_encode(PORT_PKG, nodes, pods))
    for field in ("alloc", "init", "cls_req", "feasible", "cls_tab"):
        assert torch.equal(getattr(from_jax, field), getattr(own, field)), field
    assert from_jax.weights == own.weights


@pytest.mark.parametrize("flag", [
    "custom", "sample", "gpu", "ports", "scalars", "storage", "ipa",
    "hard_spread", "soft_spread",
])
def test_out_of_slice_features_raise(flag):
    """A feature the kernel does not carry (custom score plugins,
    sample) makes build_plan raise NotInKernelError naming the torch
    scan that carries it. The B2 blocks (GPU-share, hostPorts,
    scalars), the storage block and the term block are inside the
    kernel: they turn their plan rows on instead."""
    cluster, batch, dyn, features = _encode(PORT_PKG, _nodes(3, 40), _pods(5, 41))
    features = features._replace(**{flag: True})
    block = {"gpu": "has_gpu", "ports": "has_ports", "scalars": "has_scal",
             "storage": "has_store", "ipa": "has_terms", "hard_spread": "has_terms",
             "soft_spread": "has_terms"}.get(flag)
    if block is not None:
        if flag == "scalars":
            cluster.scalar_alloc = np.ones((1, cluster.n), dtype=np.int64)
            dyn.used_scalar = np.zeros((1, cluster.n), dtype=np.int64)
            batch.req_scalar = np.zeros((batch.u, 1), dtype=np.int64)
        plan = fused_scan.build_plan(cluster, batch, dyn, features)
        assert getattr(plan, block)
        assert plan.ext == (flag in ("gpu", "ports", "scalars"))
        # the block's rows change no placement of a batch that does not use it
        args = (batch.class_of_pod, np.ones(5, bool), np.ones(3, bool))
        base = fused_scan.build_plan(*_encode(PORT_PKG, _nodes(3, 40), _pods(5, 41)))
        np.testing.assert_array_equal(fused_scan.run_fused_scan(plan, *args)[0].numpy(),
                                      fused_scan.run_fused_scan(base, *args)[0].numpy())
        return
    with pytest.raises(fused_scan.NotInKernelError, match="torch scan") as err:
        fused_scan.build_plan(cluster, batch, dyn, features)
    assert fused_scan.torch_scan_reason(features) in str(err.value)


def test_plan_rejects_pins_it_was_not_built_for():
    cluster, batch, dyn, features = _encode(PORT_PKG, _nodes(3, 42), _pods(5, 43))
    plan = fused_scan.build_plan(cluster, batch, dyn, features)
    pinned = np.full(5, -1)
    pinned[0] = 1
    with pytest.raises(ValueError, match="pins"):
        fused_scan.run_fused_scan(plan, batch.class_of_pod, np.ones(5, bool),
                                  np.ones(3, bool), pinned=pinned)
