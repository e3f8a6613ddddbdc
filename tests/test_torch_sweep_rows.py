"""The outage-scenario rows of the GPU port's capacity sweep
(`CapacitySweep.probe_scenarios`, the batch kernel's pins-first mode,
here its plain version on the CPU; and `serial_scenario`, the serial
oracle) against the JAX package's sweep on the same masks, exactly:
placements, unscheduled counts and cpu / mem / vg utilization. Mirrors
tests/test_resilience.py::test_serial_scenario_matches_batched_scan.

Cases: small synthetic clusters (every single-node outage and seeded
two-node outages), the repo's quickstart (a Helm chart, anti-affinity
and open-local storage) and the GPU-share example, and a batch with a
custom score plugin, whose rows run the two chained passes on the torch
scan."""

import importlib

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch.ops import fused_scan
from open_simulator_tpu_torch.runtime.errors import DeviceOOM
from open_simulator_tpu_torch.utils.trace import GLOBAL

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _node(name, cpu="4", mem="8Gi"):
    return {"kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}}}


def _deploy(name, replicas, cpu="1"):
    return {"kind": "Deployment",
            "metadata": {"name": name, "namespace": "rz", "labels": {"app": name}},
            "spec": {"replicas": replicas, "template": {"spec": {"containers": [
                {"name": "c", "image": "i",
                 "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}]}}}}


def _synthetic(pkg, n_nodes, replicas):
    dec = _mod(pkg, "models.decode")
    core = _mod(pkg, "scheduler.core")
    cluster = dec.ResourceTypes()
    cluster.nodes = [_node(f"base-{i}") for i in range(n_nodes)]
    apps = dec.ResourceTypes()
    apps.deployments = [_deploy("web", replicas), _deploy("half", replicas // 2, "500m")]
    return cluster, [core.AppResource("rz", apps)], _node("template")


def _example(pkg, cfg):
    applier = _mod(pkg, "apply.applier")
    a = applier.Applier(applier.SimonConfig.from_file(cfg))
    return a.load_cluster(), a.load_apps(), a.load_new_node()


def _engines(build, count):
    """The JAX package's ChaosEngine and the port's (device="cpu") on
    the same inputs, each expanded from a reset pod-name counter."""
    out = []
    for pkg in PKGS:
        cluster, apps, new_node = build(pkg)
        kw = {"device": "cpu"} if pkg.endswith("torch") else {}
        out.append(_mod(pkg, "resilience.chaos").ChaosEngine.from_cluster(
            cluster, apps, new_node, count=count, **kw))
    return out


def _assert_rows(jrows, prows):
    jp, ju, jc, jm, jv = (np.asarray(x) for x in jrows)
    pp, pu, pc, pm, pv = prows
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pu, ju)
    assert pc.tolist() == jc.tolist() and pm.tolist() == jm.tolist()
    assert pv.tolist() == jv.tolist()


def _masks(engine, failures, seed=3, trials=6):
    scens, _ = engine.build_scenarios(failures, seed, trials)
    rows = [engine._masks(s) for s in scens]
    return [np.stack([r[k] for r in rows]) for k in range(3)]


CASES = {
    "3 nodes": (lambda pkg: _synthetic(pkg, 3, 7), 1),
    "5 nodes": (lambda pkg: _synthetic(pkg, 5, 12), 2),
    "quickstart": (lambda pkg: _example(pkg, "example/simon-config.yaml"), 1),
    "gpushare": (lambda pkg: _example(pkg, "example/simon-gpushare-config.yaml"), 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_scenarios_equals_the_jax_sweep(name):
    build, count = CASES[name]
    jeng, peng = _engines(build, count)
    np.testing.assert_array_equal(peng.baseline, np.asarray(jeng.baseline))
    for failures in (1, 2):
        masks = _masks(peng, failures)
        for a, b in zip(masks, _masks(jeng, failures)):
            np.testing.assert_array_equal(a, b)
        GLOBAL.reset()
        got = peng.scen.probe_scenarios(*masks)
        assert GLOBAL.notes["chaos-kernel"] == f"{fused_scan.PINS_FIRST_KERNEL_NAME} (cpu)"
        _assert_rows(jeng.scen.probe_scenarios(*masks), got)


@pytest.mark.parametrize("name", ["3 nodes", "quickstart"])
def test_serial_scenario_matches_batched_scan(name):
    """The serial oracle is conformance-identical to the batched rows
    on every single-node outage, and to the JAX package's serial
    oracle."""
    build, count = CASES[name]
    jeng, peng = _engines(build, count)
    scens, _ = peng.build_scenarios(1)
    for scen in scens:
        valid, active, pinned, _ = peng._masks(scen)
        batched = peng.scen.probe_scenarios(valid[None], active[None], pinned[None])[0]
        serial, reasons = peng.scen.serial_scenario(valid, active, pinned, pins_first=True)
        jserial, jreasons = jeng.scen.serial_scenario(valid, active, pinned, pins_first=True)
        np.testing.assert_array_equal(serial, batched[0])
        np.testing.assert_array_equal(serial, jserial)
        assert sorted(reasons) == sorted(jreasons)
        for p_i in np.flatnonzero(serial == -1):
            assert int(p_i) in reasons


def _oom(*_a, **_k):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")


def test_serial_floor_rows_equal_the_kernel_rows(monkeypatch):
    """Every chunk running out of memory on a CPU sweep: the rows halve
    down to single scenarios, which go to the serial oracle,
    trace-noted, with the same answers."""
    build, count = CASES["5 nodes"]
    _jeng, peng = _engines(build, count)
    masks = _masks(peng, 2)
    clean = peng.scen.probe_scenarios(*masks)
    monkeypatch.setattr(peng.scen.scans, "launch", _oom)
    GLOBAL.reset()
    floor = peng.scen.probe_scenarios(*masks)
    assert "chaos-serial-fallback" in GLOBAL.notes and "chaos-chunk-halving" in GLOBAL.notes
    np.testing.assert_array_equal(floor[0], clean[0])
    np.testing.assert_array_equal(floor[1], clean[1])
    np.testing.assert_allclose(floor[2], clean[2], rtol=0, atol=1e-9)


def test_rows_on_the_card_never_reach_the_serial_floor(monkeypatch):
    """A sweep on the card halves a chunk that runs out of device
    memory, but a single row that still runs out raises DeviceOOM: the
    work never moves to the host oracle."""
    build, count = CASES["5 nodes"]
    _jeng, peng = _engines(build, count)
    masks = _masks(peng, 2)
    monkeypatch.setattr(peng.scen.scans, "device", torch.device("cuda"))
    monkeypatch.setattr(peng.scen.scans, "launch", _oom)
    monkeypatch.setattr(peng.scen, "serial_scenario", _unreachable)
    GLOBAL.reset()
    with pytest.raises(DeviceOOM, match="single-item chunk"):
        peng.scen.probe_scenarios(*masks)
    assert "chaos-chunk-halving" in GLOBAL.notes
    assert not any("serial" in k for k in GLOBAL.notes)


def _unreachable(*_a, **_k):
    raise AssertionError("the serial oracle ran for work on the card")


def test_custom_plugin_rows_ride_the_torch_scan():
    """A batch the kernel does not carry (a registered custom score
    plugin): the rows run the two chained passes on the torch scan,
    trace-noted, equal to the JAX package's XLA rows."""
    from tests.test_torch_apply import _name_plugin

    regs = [_mod(pkg, "scheduler.plugins").default_registry for pkg in PKGS]
    for pkg, reg in zip(PKGS, regs):
        reg.clear()
        reg.register(_name_plugin(pkg, 3))
    try:
        build, count = CASES["5 nodes"]
        jeng, peng = _engines(build, count)
        assert peng.scen.plan is None
        masks = _masks(peng, 2)
        GLOBAL.reset()
        got = peng.scen.probe_scenarios(*masks)
        assert GLOBAL.notes["chaos-kernel"] == "torch-scan (custom score plugins)"
        _assert_rows(jeng.scen.probe_scenarios(*masks), got)
    finally:
        for reg in regs:
            reg.clear()
