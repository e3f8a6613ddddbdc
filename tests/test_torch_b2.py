"""The scalar-resource, hostPort and GPU-share blocks of the GPU port's
fused scan (open_simulator_tpu_torch/ops/fused_scan.py, the `fused_scan_ext`
kernel's plain version) against the JAX package, exactly (placements and
states are integers, so the tolerance is equality):

- the port's own build_plan path equals the XLA scan (run_scan_masked):
  placements, the six base state rows, and the scalar, per-device GPU
  and port-occupancy rows;
- the plain version fed the JAX Pallas plan through plan_from_jax_arrays
  equals the Pallas kernel in interpret mode, where the JAX package
  builds a Pallas plan for the batch.

Inputs are small clusters and pod lists made from a numpy seed."""

import copy
import importlib

import numpy as np
import pytest

import jax.numpy as jnp

from open_simulator_tpu.ops import pallas_scan
from open_simulator_tpu.ops import scan as scan_ops
from open_simulator_tpu.ops.encode import to_scan_state, to_scan_static
from open_simulator_tpu.testing import make_fake_node, make_fake_pod, with_node_gpu
from open_simulator_tpu_torch.ops import fused_scan

JAX_PKG = "open_simulator_tpu"
PORT_PKG = "open_simulator_tpu_torch"
STATE = fused_scan.STATE_FIELDS
GPU_MEM = "alibabacloud.com/gpu-mem"
GPU_CNT = "alibabacloud.com/gpu-count"


def _gpu_pod(name, mem, cnt, cpu="1"):
    pod = make_fake_pod(name, "d", cpu, "1Gi")
    pod["metadata"]["annotations"] = {GPU_MEM: str(mem), GPU_CNT: str(cnt)}
    return pod


def _pinned(pod, node):
    pod["spec"]["nodeName"] = node
    return pod


def _port_pod(name, port, ip=None, proto="TCP", cpu="100m"):
    pod = make_fake_pod(name, "default", cpu, "100Mi")
    entry = {"containerPort": port, "hostPort": port, "protocol": proto}
    if ip is not None:
        entry["hostIP"] = ip
    pod["spec"]["containers"][0]["ports"] = [entry]
    return pod


def _scalar_node(name, scalars, cpu="8"):
    node = make_fake_node(name, cpu, "16Gi")
    node["status"]["allocatable"].update({k: str(v) for k, v in scalars.items()})
    return node


def _scalar_pod(name, scalars, cpu="100m"):
    pod = make_fake_pod(name, "default", cpu, "100Mi")
    pod["spec"]["containers"][0]["resources"]["requests"].update(
        {k: str(v) for k, v in scalars.items()})
    return pod


def _unpack_port_words(words: np.ndarray, t_rows: int) -> np.ndarray:
    """Inverse of fused_scan.pack_port_words: (W, N) int32 -> (T, N) bool."""
    w = np.asarray(words).view(np.uint32)
    out = np.zeros((t_rows, w.shape[1]), dtype=bool)
    for t in range(t_rows):
        out[t] = (w[t >> 5] >> np.uint32(t & 31)) & 1
    return out


def _encode(pkg, nodes, pods, bound=()):
    """(cluster, batch, dyn, features) of one package on its own copy of
    the inputs; `bound` pods are running on their spec.nodeName."""
    oracle_mod = importlib.import_module(f"{pkg}.scheduler.oracle")
    enc = importlib.import_module(f"{pkg}.ops.encode")
    oracle = oracle_mod.Oracle(copy.deepcopy(nodes))
    for pod in copy.deepcopy(list(bound)):
        oracle.place_existing_pod(pod)
    cluster = enc.encode_cluster(oracle)
    batch = enc.encode_batch(oracle, cluster, copy.deepcopy(pods))
    dyn = enc.encode_dynamic(oracle, cluster)
    return cluster, batch, dyn, enc.features_of_batch(cluster, batch)


def _xla(enc, active, valid):
    cluster, batch, dyn, features = enc
    placements, final = scan_ops.run_scan_masked(
        to_scan_static(cluster, batch), to_scan_state(dyn, batch),
        jnp.asarray(batch.class_of_pod), jnp.asarray(batch.pinned_node),
        jnp.asarray(valid), jnp.asarray(active), features=features,
    )
    return np.asarray(placements), final


def _check_against_xla(nodes, pods, bound=(), node_frac=1.0, pod_frac=1.0, seed=0):
    rng = np.random.RandomState(seed)
    active = rng.rand(len(pods)) < pod_frac
    valid = rng.rand(len(nodes)) < node_frac
    jenc = _encode(JAX_PKG, nodes, pods, bound)
    xla_p, xla_f = _xla(jenc, active, valid)
    cluster, batch, dyn, features = _encode(PORT_PKG, nodes, pods, bound)
    plan = fused_scan.build_plan(cluster, batch, dyn, features)
    assert plan.ext
    port_p, port_f = fused_scan.run_fused_scan(
        plan, batch.class_of_pod, active, valid, pinned=batch.pinned_node)
    np.testing.assert_array_equal(port_p.numpy(), xla_p)
    for k in STATE:
        np.testing.assert_array_equal(port_f[k].numpy(), np.asarray(getattr(xla_f, k)),
                                      err_msg=k)
    if plan.has_scal:
        np.testing.assert_array_equal(port_f["used_scalar"].numpy(),
                                      np.asarray(xla_f.used_scalar))
    if plan.has_gpu:
        np.testing.assert_array_equal(port_f["gpu_used"].numpy(),
                                      np.asarray(xla_f.gpu_used).T)
    if plan.has_ports:
        xla_ports = np.asarray(xla_f.ports_used)  # [N, Pt]
        np.testing.assert_array_equal(
            _unpack_port_words(port_f["ports_used"].numpy(), xla_ports.shape[1]),
            xla_ports.T)
    return port_p.numpy(), plan, (jenc, active, valid)


def _check_against_pallas(jenc, active, valid):
    cluster, batch, dyn, features = jenc
    jplan = pallas_scan.build_plan(cluster, batch, dyn, features)
    assert jplan is not None, pallas_scan.last_reject()
    pal_p, pal_f = pallas_scan.run_scan_pallas(
        jplan, batch.class_of_pod, active, valid, pinned=batch.pinned_node,
        interpret=True)
    plan = fused_scan.plan_from_jax_arrays(jplan)
    port_p, port_f = fused_scan.fused_scan_reference(
        plan, batch.class_of_pod, active, valid, pinned=batch.pinned_node)
    np.testing.assert_array_equal(port_p.numpy(), np.asarray(pal_p))
    for k, v in pal_f.items():
        np.testing.assert_array_equal(port_f[k].numpy(), v, err_msg=k)
    return plan


def _gpu_nodes(k=8):
    return [make_fake_node(f"g{i}", "64", "256Gi", with_node_gpu(2 + i % 3, "32"))
            for i in range(k)]


def _gpu_holder():
    """A running pod holding 16 units of g0's device 0 (a partial device)."""
    pod = make_fake_pod("existing", "d", "1", "1Gi")
    pod["spec"]["nodeName"] = "g0"
    pod["metadata"]["annotations"] = {
        GPU_MEM: "16", GPU_CNT: "1", "alibabacloud.com/gpu-index": "0"}
    return pod


def _gpu_mix():
    shapes = [(4, 1), (8, 1), (16, 1), (8, 2), (32, 1), (16, 2), (4, 3), (17, 1)]
    return [_gpu_pod(f"p{i:02d}", mem, cnt) for i, (mem, cnt) in enumerate(shapes * 4)]


def _gpu_random(seed):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(int(rng.randint(4, 9))):
        if rng.rand() < 0.7:
            nodes.append(make_fake_node(f"g{i}", "64", "256Gi",
                                        with_node_gpu(int(rng.randint(1, 5)), "32")))
        else:
            nodes.append(make_fake_node(f"c{i}", "64", "256Gi"))
    pods = []
    for i in range(int(rng.randint(30, 60))):
        if rng.rand() < 0.6:
            pods.append(_gpu_pod(f"p{i:02d}", int(rng.choice([2, 4, 8, 16, 32])),
                                 int(rng.choice([1, 1, 2, 3])), cpu="500m"))
        else:
            pods.append(make_fake_pod(f"p{i:02d}", "d", "500m", "512Mi"))
    return nodes, pods


# name: (nodes, pods, bound pods, node_frac, pod_frac, Pallas plan exists)
CASES = {
    "gpu-single-multi-partial": (_gpu_nodes, _gpu_mix, lambda: [_gpu_holder()],
                                 1.0, 1.0, True),
    "gpu-masked": (_gpu_nodes, _gpu_mix, lambda: [_gpu_holder()], 0.7, 0.8, True),
    "gpu-random-31": (lambda: _gpu_random(31)[0], lambda: _gpu_random(31)[1],
                      list, 1.0, 1.0, True),
    "gpu-random-32": (lambda: _gpu_random(32)[0], lambda: _gpu_random(32)[1],
                      list, 0.8, 0.9, True),
    # a pinned pod in a GPU batch: the JAX package sends it to the XLA
    # scan; the port's kernel charges the pin's devices at commit
    "gpu-pins": (lambda: _gpu_nodes(3),
                 lambda: [_gpu_pod("a", 8, 1), _pinned(_gpu_pod("pin", 16, 2), "g1")]
                 + [_gpu_pod(f"b{i}", 16, 1) for i in range(8)],
                 list, 1.0, 1.0, False),
    "ports-same": (lambda: [make_fake_node(f"pn-{i}", "8", "16Gi") for i in range(3)],
                   lambda: [_port_pod(f"web-{i}", 8080) for i in range(4)],
                   list, 1.0, 1.0, True),
    "ports-different": (lambda: [make_fake_node("pn-0", "8", "16Gi")],
                        lambda: [_port_pod("a", 8080), _port_pod("b", 8081)],
                        list, 1.0, 1.0, True),
    # the wildcard 0.0.0.0 conflicts with a specific IP on the same port
    # and protocol; another protocol or another port does not
    "ports-wildcard": (lambda: [make_fake_node(f"pn-{i}", "8", "16Gi") for i in range(3)],
                       lambda: [_port_pod("any", 9000, ip="0.0.0.0"),
                                _port_pod("ip1", 9000, ip="10.0.0.1"),
                                _port_pod("ip2", 9000, ip="10.0.0.2"),
                                _port_pod("udp", 9000, proto="UDP"),
                                _port_pod("any2", 9000),
                                _port_pod("ip3", 9000, ip="10.0.0.1")],
                       list, 1.0, 1.0, True),
    # 40 ports: two port words
    "ports-two-words": (lambda: [make_fake_node(f"n{i}", "64", "64Gi") for i in range(3)],
                        lambda: [_port_pod(f"p{i:02d}", 7000 + i % 40) for i in range(90)],
                        list, 1.0, 1.0, True),
    "scalars": (lambda: [_scalar_node(f"sn-{i}", {"example.com/widget": 2})
                         for i in range(2)],
                lambda: [_scalar_pod(f"w-{i}", {"example.com/widget": 1}) for i in range(5)],
                list, 1.0, 1.0, True),
    "scalars-ports-mixed": (
        lambda: [_scalar_node(f"mx-{i}", {"example.com/widget": 3, "example.com/accel": 1})
                 for i in range(4)],
        lambda: ([_scalar_pod(f"w-{i}", {"example.com/widget": 1 + i % 2}) for i in range(8)]
                 + [_scalar_pod(f"a-{i}", {"example.com/accel": 1}) for i in range(5)]
                 + [_port_pod(f"s-{i}", 8000 + i % 2) for i in range(9)]
                 + [make_fake_pod(f"plain-{i}", "default", "1", "1Gi") for i in range(6)]),
        list, 0.9, 0.9, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ext_plain_equals_xla_and_pallas(name):
    mk_nodes, mk_pods, mk_bound, nf, pf, has_pallas = CASES[name]
    placements, plan, jax_inputs = _check_against_xla(
        mk_nodes(), mk_pods(), mk_bound(), nf, pf, seed=7)
    assert (placements >= 0).any()
    if has_pallas:
        _check_against_pallas(*jax_inputs)
    else:
        jenc = jax_inputs[0]
        assert pallas_scan.build_plan(*jenc) is None


def test_gpu_case_packs_devices_and_fails_pods():
    """The GPU fixture really exercises the device choice: single and
    multi-GPU pods, failures, several nodes, a partial device."""
    placements, plan, _ = _check_against_xla(_gpu_nodes(), _gpu_mix(), [_gpu_holder()])
    assert plan.gpu_init.shape[0] == 4 and int(plan.gpu_init[0, 0]) == 16
    assert (placements == -1).any() and len(set(placements[placements >= 0])) > 3


def test_ports_wildcard_conflicts():
    placements, _, _ = _check_against_xla(*[CASES["ports-wildcard"][i]() for i in range(3)])
    # 3 nodes: the wildcard takes one, ip1+ip2+udp share the others where
    # they do not clash, any2 clashes with everything TCP/9000
    assert (placements == -1).any() and (placements >= 0).sum() >= 4


@pytest.mark.parametrize("kinds,devices", [(10, 1), (1, 10)])
def test_beyond_the_jax_caps(kinds, devices):
    """More than 8 scalar kinds, or more than 8 GPUs on a node: outside
    the JAX Pallas plan, inside the port's kernel (loops over rows in
    device memory), equal to the XLA scan."""
    names = [f"example.com/r{k}" for k in range(kinds)]
    nodes = [_scalar_node(f"n{i}", {nm: 2 for nm in names}, cpu="32") for i in range(3)]
    pods = [_scalar_pod(f"p{i}", {names[i % kinds]: 1 + i % 3}) for i in range(40)]
    if devices > 1:
        for i, node in enumerate(nodes):
            with_node_gpu(devices, str(16 * devices))(node)
        pods += [_gpu_pod(f"g{i}", 8 + 4 * (i % 3), 1 + i % 3) for i in range(20)]
    placements, plan, (jenc, _, _) = _check_against_xla(nodes, pods)
    assert pallas_scan.build_plan(*jenc) is None
    if devices > 1:
        assert plan.gpu_init.shape[0] == devices
    else:
        assert plan.scal_alloc.shape[0] == kinds
    assert (placements == -1).any()


def test_plan_from_jax_arrays_b2_rows():
    """The JAX plan's port bitplanes are the port's words; its scalar
    and GPU rows equal the port's own up to the JAX plan's per-kind GCD
    scale."""
    nodes = CASES["scalars-ports-mixed"][0]()
    pods = CASES["scalars-ports-mixed"][1]()
    jplan = pallas_scan.build_plan(*_encode(JAX_PKG, nodes, pods))
    from_jax = fused_scan.plan_from_jax_arrays(jplan)
    own = fused_scan.build_plan(*_encode(PORT_PKG, nodes, pods))
    assert np.array_equal(from_jax.port_init.numpy(), own.port_init.numpy())
    assert np.array_equal(from_jax.port_cls.numpy(), own.port_cls.numpy())
    for field in ("scal_alloc", "scal_init"):
        a, b = getattr(from_jax, field).numpy(), getattr(own, field).numpy()
        scale = np.where(a > 0, b // np.maximum(a, 1), 0).max(axis=1, keepdims=True)
        np.testing.assert_array_equal(a * np.maximum(scale, 1), b, err_msg=field)
