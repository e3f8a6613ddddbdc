"""The GPU port's outage analysis (`resilience/chaos.py`: ChaosEngine,
N+K planning; `simon chaos`, `apply --tolerate-node-failures`) against
the JAX package's, exactly: `ChaosEngine.run(...).as_dict()` equal,
the CLI's JSON and table bytes and exit codes equal. The port runs the
kernels' plain versions (`device="cpu"`).

Cases: single-node outages (K=1), seeded two-node outages (K=2), the
replacement study (K=0), the cordon, taint and degrade perturbations, a
daemonset whose pods die with their node, N+K escalation (reachable and
provably unreachable), and `simon chaos` / `apply
--tolerate-node-failures 1` on example/simon-config.yaml and
example/simon-gpushare-config.yaml."""

import contextlib
import importlib
import io

import numpy as np
import pytest

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")
QUICKSTART = "example/simon-config.yaml"
GPUSHARE = "example/simon-gpushare-config.yaml"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _node(name, cpu="4", labels=None):
    node = {"kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": "8Gi", "pods": "110"}}}
    node["metadata"]["labels"].update(labels or {})
    return node


def _deploy(name, replicas, cpu="1", selector=None):
    spec = {"containers": [{"name": "c", "image": "i",
                            "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}]}
    if selector:
        spec["nodeSelector"] = dict(selector)
    return {"kind": "Deployment",
            "metadata": {"name": name, "namespace": "rz", "labels": {"app": name}},
            "spec": {"replicas": replicas, "template": {"spec": spec}}}


_AGENT = {"kind": "DaemonSet",
          "metadata": {"name": "agent", "namespace": "rz", "labels": {"app": "agent"}},
          "spec": {"template": {"spec": {"containers": [
              {"name": "c", "image": "i", "resources": {"requests": {"cpu": "100m"}}}]}}}}


def _inputs(pkg, n_nodes, deployments, daemonset=False, labels=None):
    dec = _mod(pkg, "models.decode")
    core = _mod(pkg, "scheduler.core")
    cluster = dec.ResourceTypes()
    cluster.nodes = [_node(f"base-{i}", labels=(labels or {}).get(i)) for i in range(n_nodes)]
    if daemonset:
        cluster.daemon_sets = [_AGENT]
    apps = dec.ResourceTypes()
    apps.deployments = [dict(d) for d in deployments]
    return cluster, [core.AppResource("rz", apps)]


def _both(fn):
    """fn(pkg, kw) for the JAX package and for the port (kw: the port's
    device="cpu"), each after a reset of its pod-name counter."""
    out = []
    for pkg in PKGS:
        _mod(pkg, "models.workloads").reset_name_counter()
        out.append(fn(pkg, {"device": "cpu"} if pkg.endswith("torch") else {}))
    return out


CHAOS = {
    "k1-survives": (3, [_deploy("web", 6)], {}, dict(failures=1)),
    "k1-strands": (2, [_deploy("web", 6)], {}, dict(failures=1)),
    "k2-seeded": (6, [_deploy("web", 14), _deploy("half", 5, "500m")], {},
                  dict(failures=2, seed=5, trials=4)),
    "k2-exhaustive": (4, [_deploy("web", 7)], {}, dict(failures=2, seed=1, trials=32)),
    "replacement-cordon": (3, [_deploy("web", 6)], dict(cordon=["base-0", "base-1"]),
                           dict(failures=0)),
    "cordon": (3, [_deploy("web", 6)], dict(cordon=["base-1"]), dict(failures=1)),
    "taint": (3, [_deploy("web", 6)],
              dict(taints=[(None, {"key": "chaos", "effect": "NoSchedule"})]),
              dict(failures=1)),
    "degrade": (3, [_deploy("web", 8)], dict(degrade=(50, ["base-2"])), dict(failures=1)),
}


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_chaos_report_equals_the_jax_engine(name):
    n_nodes, deployments, perturb, run_kw = CHAOS[name]

    def run(pkg, kw):
        cluster, apps = _inputs(pkg, n_nodes, deployments)
        engine = _mod(pkg, "resilience.chaos").ChaosEngine.from_cluster(
            cluster, apps, **perturb, **kw)
        return engine.run(**run_kw).as_dict()

    want, got = _both(run)
    assert got == want
    assert got["total"] >= 1


def test_daemonset_pods_die_with_their_node():
    def run(pkg, kw):
        cluster, apps = _inputs(pkg, 3, [_deploy("web", 3)], daemonset=True)
        engine = _mod(pkg, "resilience.chaos").ChaosEngine.from_cluster(cluster, apps, **kw)
        return engine.run(failures=1)

    want, got = _both(run)
    assert got.as_dict() == want.as_dict()
    assert got.all_survived and all(o.lost_daemonset == 1 for o in got.outcomes)


def _template():
    return _node("template")


def test_nplusk_escalation_equals_the_jax_plan():
    """2 x 4 cpu, 6 x 1 cpu pods: feasible at +0, N+1 at +1, confirmed
    by the serial re-simulation of the worst outage."""
    def run(pkg, kw):
        cluster, apps = _inputs(pkg, 2, [_deploy("web", 6)])
        sweep = _mod(pkg, "parallel.sweep").CapacitySweep(cluster, apps, _template(), 6, **kw)
        best = sweep.find_min_count(lambda r: r.unscheduled == 0, start=0)
        _mod(pkg, "utils.trace").GLOBAL.reset()
        probe, report = _mod(pkg, "resilience.chaos").raise_plan_to_nplusk(
            sweep, best, lambda r: r.unscheduled == 0, failures=1)
        notes = dict(_mod(pkg, "utils.trace").GLOBAL.notes)
        return probe.count, np.asarray(probe.placements), report.as_dict(), notes

    (jc, jp, jr, jn), (pc, pp, pr, pn) = _both(run)
    assert (pc, pr) == (jc, jr) and pc == 1
    np.testing.assert_array_equal(pp, jp)
    assert pr["serialConfirmed"] and pn["chaos-serial-confirm"].endswith("ok")
    assert pn["chaos-serial-confirm"] == jn["chaos-serial-confirm"]


def test_nplusk_unreachable_bails_with_the_same_reason():
    def run(pkg, kw):
        cluster, apps = _inputs(pkg, 2, [_deploy("pinned", 4, selector={"disk": "ssd"})],
                                labels={0: {"disk": "ssd"}})
        sweep = _mod(pkg, "parallel.sweep").CapacitySweep(cluster, apps, _template(), 20, **kw)
        best = sweep.find_min_count(lambda r: r.unscheduled == 0, start=0)
        trace = _mod(pkg, "utils.trace").GLOBAL
        trace.reset()
        probe, report = _mod(pkg, "resilience.chaos").raise_plan_to_nplusk(
            sweep, best, lambda r: r.unscheduled == 0, failures=1)
        return probe, report.as_dict(), trace.notes.get("nplusk-unreachable")

    (jprobe, jrep, jnote), (pprobe, prep, pnote) = _both(run)
    assert jprobe is None and pprobe is None
    assert prep == jrep and pnote == jnote and "statically rejected" in pnote


def _cli(main, reset, argv):
    reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


CLI_CASES = [
    [QUICKSTART, "--format", "json"],
    [QUICKSTART],
    [QUICKSTART, "--failures", "2", "--seed", "7", "--trials", "3", "--format", "json"],
    [QUICKSTART, "--failures", "0", "--cordon", "worker-1", "--format", "json"],
    [GPUSHARE, "--degrade", "40", "--format", "json"],
    [GPUSHARE, "--taint", "chaos=x:NoSchedule@gpu-node-1"],
    [GPUSHARE, "--new-node-count", "1", "--format", "json"],
    [GPUSHARE, "--failures", "2"],
]


@pytest.mark.parametrize("argv", CLI_CASES, ids=lambda a: "-".join(a[1:]) or a[0])
def test_chaos_cli_is_byte_identical(argv):
    want = _cli(jax_cli.main, jax_reset, ["chaos", "-f", *argv])
    got = _cli(port_cli.main, port_reset, ["chaos", "-f", *argv, "--device", "cpu"])
    assert got == want
    assert want[1]


@pytest.mark.parametrize("cfg", [QUICKSTART, GPUSHARE])
def test_apply_tolerate_node_failures_is_byte_identical(cfg):
    argv = ["apply", "-f", cfg, "--format", "json", "--tolerate-node-failures", "1"]
    want = _cli(jax_cli.main, jax_reset, argv)
    got = _cli(port_cli.main, port_reset, argv + ["--device", "cpu"])
    assert got == want


def test_apply_tolerate_node_failures_plans_the_spare(tmp_path):
    """A synthetic config where N+1 needs one more node than the plain
    plan: both CLIs answer +1 with the same report."""
    import json

    from tests.test_torch_apply import _config

    nodes = [_node(f"n{i}") for i in range(2)]
    cfg = _config(tmp_path, nodes, [("web", [_deploy("web", 6)])], _template())
    plain = _cli(port_cli.main, port_reset, ["apply", "-f", cfg, "--format", "json",
                                             "--device", "cpu"])
    argv = ["apply", "-f", cfg, "--format", "json", "--tolerate-node-failures", "1"]
    want = _cli(jax_cli.main, jax_reset, argv)
    got = _cli(port_cli.main, port_reset, argv + ["--device", "cpu"])
    assert got == want and got[0] == 0
    assert json.loads(plain[1])["newNodeCount"] == 0
    assert json.loads(got[1])["newNodeCount"] == 1


@pytest.fixture
def mesh_state():
    """Restore both packages' process-wide mesh selection after the
    test (`--mesh` configures it for the rest of the process)."""
    from open_simulator_tpu.parallel import mesh as jmesh
    from open_simulator_tpu_torch.parallel import mesh as pmesh

    saved = (dict(jmesh._STATE), dict(pmesh._STATE))
    yield
    for mod, state in zip((jmesh, pmesh), saved):
        mod._STATE.clear()
        mod._STATE.update(state)
    pmesh._STATE["cache"] = {}


@pytest.mark.parametrize("spec", ["auto", "off", "1", "many"])
def test_chaos_mesh_flag_gives_the_jax_bytes_and_exit_code(spec, mesh_state):
    argv = ["chaos", "-f", GPUSHARE, "--new-node-count", "1", "--format", "json",
            "--mesh", spec]
    want = _cli(jax_cli.main, jax_reset, argv)
    got = _cli(port_cli.main, port_reset, argv + ["--device", "cpu"])
    assert got == want
    assert got[0] == (2 if spec == "many" else 0) and bool(got[1]) == (spec != "many")
