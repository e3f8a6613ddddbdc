"""The GPU port's multi-spec what-if (`apply/applier.py`
probe_plan_multi, `parallel/sweep.py` find_min_count_multi: every
spec's search in lockstep, a round launching each spec's probes as one
batch launch) on the CPU, against `probe_plan` per spec and against
the JAX package's probe_plan_multi: the same new-node count, the same
placements, and every pod dict embedded in a result bound to the node it
is listed under. Mirrors
tests/test_capacity.py::test_probe_plan_multi_matches_probe_plan_and_isolates_results."""

import importlib

import pytest

from open_simulator_tpu.testing import make_fake_node

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _deploy(name, replicas, cpu, mem):
    return {"kind": "Deployment", "metadata": {"name": name, "namespace": "d"},
            "spec": {"replicas": replicas, "template": {"spec": {"containers": [
                {"name": "c", "image": "i",
                 "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}}}


def _inputs(pkg, daemonset=False):
    dec = _mod(pkg, "models.decode")
    core = _mod(pkg, "scheduler.core")
    cluster = dec.ResourceTypes()
    cluster.nodes = [make_fake_node(f"base-{i}", "4", "8Gi") for i in range(6)]
    if daemonset:
        cluster.daemon_sets = [{"kind": "DaemonSet", "metadata": {
            "name": "agent", "namespace": "kube-system"}, "spec": {"template": {"spec": {
                "containers": [{"name": "c", "image": "a", "resources": {
                    "requests": {"cpu": "200m", "memory": "128Mi"}}}]}}}}]
    res = dec.ResourceTypes()
    res.deployments = [_deploy("web", 40, "1", "1Gi"), _deploy("mem", 9, "500m", "6Gi")]
    return cluster, [core.AppResource("a", res)]


SPECS = [("tpl-big", "16", "64Gi"), ("tpl-small", "4", "8Gi"), ("tpl-mem", "4", "32Gi"),
         ("tpl-cpu", "32", "16Gi")]


def _view(r):
    return (r.success, r.new_node_count, r.message, r.report_text,
            [(ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
             for ns in r.result.node_status])


@pytest.mark.parametrize("daemonset", [False, True])
def test_probe_plan_multi_matches_probe_plan_and_the_jax_package(daemonset):
    templates = [make_fake_node(*s) for s in SPECS]
    views = {}
    for pkg in PKGS:
        applier = _mod(pkg, "apply.applier")
        reset = _mod(pkg, "models.workloads").reset_name_counter
        kw = {"device": "cpu"} if pkg.endswith("torch") else {}
        cluster, apps = _inputs(pkg, daemonset)
        reset()
        solo = [applier.probe_plan(cluster, apps, t, **kw) for t in templates]
        reset()
        multi = applier.probe_plan_multi(cluster, apps, templates, **kw)
        # isolation: every pod dict embedded in a result carries THAT
        # result's binding, not a later spec's
        for r in multi:
            for ns in r.result.node_status:
                for p in ns.pods:
                    assert (p.get("spec") or {}).get("nodeName") == ns.node["metadata"]["name"]
        views[pkg] = ([_view(r) for r in solo], [_view(r) for r in multi])
    (jsolo, jmulti), (psolo, pmulti) = views[PKGS[0]], views[PKGS[1]]
    assert [v[:2] for v in psolo] == [v[:2] for v in pmulti]
    assert pmulti == jmulti
    assert [v[1] for v in pmulti] != [pmulti[0][1]] * len(SPECS)  # the specs differ


def test_rounds_launch_one_batch_a_spec():
    """The lockstep search: every round launches one batch a live spec
    (trace notes whatif-rounds / whatif-launches), and the answers equal
    the single-spec searches."""
    from open_simulator_tpu_torch.apply.applier import _capacity_feasible
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep, find_min_count_multi
    from open_simulator_tpu_torch.utils.trace import GLOBAL

    cluster, apps = _inputs("open_simulator_tpu_torch")
    feasible, caps = _capacity_feasible()
    reset_name_counter()
    jobs = []
    for s in SPECS:
        sweep = CapacitySweep(cluster, apps, make_fake_node(*s), 100, device="cpu",
                              share_pods_from=jobs[0][0] if jobs else None)
        jobs.append((sweep, feasible, sweep.lower_bound(*caps)))
    assert all(j[0].pods_shared for j in jobs[1:])
    seen = []
    GLOBAL.reset()
    bests = find_min_count_multi(jobs, on_probe=lambda r: seen.append(r.count))
    rounds, launches = GLOBAL.notes["whatif-rounds"], GLOBAL.notes["whatif-launches"]
    assert 1 <= rounds <= launches <= rounds * len(SPECS)
    assert len(GLOBAL.notes["whatif-round-log"].split(",")) == rounds
    for (sweep, _, start), best in zip(jobs, bests):
        assert best.count == sweep.find_min_count(feasible, start=start).count
