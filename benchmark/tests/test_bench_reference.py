"""The plain reference: its serial pass equals the cycle's plain form,
it agrees with the port at a tiny size, and the comparison fails when
one pod's node is changed."""

import io
from contextlib import redirect_stdout

import pytest

from benchmark import check, generate
from benchmark.reference import kube_v120
from benchmark.tests import tiny

GREEN = {"color": "green"}
ANTI = {"key": generate.HOSTNAME_KEY, "selector": GREEN}
# scheduler_perf SchedulingPodAntiAffinity's pods (pod-with-pod-anti-affinity.yaml:
# every pod labelled color: green, anti-affinity to color: green on the
# hostname), then pods labelled alike with no terms, which the placed
# pods' terms keep off their nodes
ANTI_MIX = {"namespace": "sched", "workloads": [
    {"name": "init", "kind": "Deployment", "replicas": 10, "cpu": "100m", "memory": "500Mi",
     "labels": GREEN, "anti": [ANTI]},
    {"name": "measured", "kind": "Deployment", "replicas": 15, "cpu": "100m",
     "memory": "500Mi", "labels": GREEN, "anti": [ANTI]},
    {"name": "green", "kind": "Deployment", "replicas": 3, "cpu": "100m", "memory": "500Mi",
     "labels": GREEN}]}


def _anti_instance(seed=11):
    cfg = tiny.config("k8s-5k-spread")
    cfg["nodes"] = 12  # too few for the 28 pods: the plan adds nodes
    return generate.make_instance(cfg, ANTI_MIX, seed, 0)


# every fourth node tainted; the tolerating pods, written last, queue first
TAINT_MIX = {"namespace": "plan", "workloads": [
    {"name": "plain", "kind": "Deployment", "replicas": 700, "cpu": "100m", "memory": "500Mi"},
    {"name": "infra", "kind": "StatefulSet", "replicas": 90, "cpu": "200m", "memory": "1Gi",
     "tolerate": True}]}


def _taint_instance(seed=11):
    cfg = tiny.config("k8s-5k-basic")
    cfg.update(nodes=24, taint_every=4,
               taint={"key": "dedicated", "value": "infra", "effect": "NoSchedule"})
    return generate.make_instance(cfg, TAINT_MIX, seed, 0)


CASES = {"basic": lambda seed: tiny.instance("k8s-5k-basic", "capacity-plan", 37, [1500], seed),
         "taint": _taint_instance,
         "spread": lambda seed: tiny.instance("k8s-5k-spread", "spread-rollout", 30, [30, 45],
                                              seed),
         "anti": _anti_instance}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tie", ["first", "last"])
def test_serial_pass_equals_full_rescoring(case, tie):
    inst = CASES[case](11)
    for count in (0, 2):
        fast = kube_v120.schedule(inst, count, tie)
        full = kube_v120.schedule_full(inst, count, tie)
        assert fast.pods == full.pods and fast.unscheduled == full.unscheduled
        assert (fast.cpu_req == full.cpu_req).all() and (fast.mem_req == full.mem_req).all()


def _port_answer(inst, tmp_path):
    from open_simulator_tpu_torch import cli

    path = inst.write(str(tmp_path / inst.tag))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["apply", "-f", path, "--device", "cpu"])
    assert rc == 0
    return check.parse(out.getvalue(), inst)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_agrees_with_the_reference(case, tmp_path):
    inst = CASES[case](2**33 + 5)
    ans = _port_answer(inst, tmp_path)
    ref = check.Reference(kube_v120.schedule)
    assert check.compare(ans, inst, ref.at(inst)) == {k: 0 for k in check.LIMITS}
    assert ans.count == kube_v120.plan(inst).count
    assert ans.placed == inst.pods


def test_the_constraints_bind():
    # the plan needs new nodes at the test size (the count check reads
    # the reference at count and count - 1); the spread turns nodes away
    # at the cell's own size, the anti-affinity both ways at the test's
    assert kube_v120.plan(CASES["basic"](11)).count > 0
    spread = tiny.instance("k8s-5k-spread", "spread-rollout", 5000, [5000, 2000], 2**31 + 3)
    for inst in (spread, CASES["anti"](11)):
        free = kube_v120.schedule(inst, 0)
        for w in inst.workloads:
            w.anti, w.spread = [], []
        assert kube_v120.schedule(inst, 0).pods != free.pods


def test_anti_affinity_holds_both_ways():
    inst = _anti_instance()
    ans = kube_v120.plan(inst)
    # the 25 pods with terms take a node each, away from every green pod;
    # the 3 green pods without terms may share one
    assert ans.success and ans.count == 25 + 1 - inst.n_base
    termed = [j for (j, key), n in ans.pods.items() if not key.startswith("green")
              for _ in range(n)]
    green = {j for (j, key) in ans.pods if key.startswith("green")}
    assert len(termed) == len(set(termed)) == 25 and not green & set(termed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_moved_pod_fails_the_comparison(case):
    inst = CASES[case](11)
    ref = check.Reference(kube_v120.schedule)
    good = kube_v120.plan(inst)
    assert check.compare(good, inst, ref.at(inst)) == {k: 0 for k in check.LIMITS}
    (node, key), _ = next(iter(good.pods.items()))
    other = (node + 1) % good.nodes
    good.pods[(node, key)] -= 1
    good.pods[(other, key)] += 1
    nums = check.compare(good, inst, ref.at(inst))
    assert nums["misplaced_pods"] == 1
    assert not check.verdict(nums, failed=0)


def test_a_wrong_count_fails_the_comparison():
    inst = CASES["basic"](11)
    ref = check.Reference(kube_v120.schedule)
    best = kube_v120.plan(inst)
    more = kube_v120.schedule(inst, best.count + 1)
    assert check.compare(more, inst, ref.at(inst))["wrong_counts"] == 1


def test_every_seed_asks_for_the_same_work():
    a, b = (tiny.instance("k8s-5k-spread", "spread-rollout", 30, [30, 45], seed)
            for seed in (3, 2**40 + 1))
    assert sorted(a.zone) == sorted(b.zone) and list(a.zone) != list(b.zone)
    assert [(w.replicas, w.cpu, w.memory, w.spread) for w in a.workloads] == \
        [(w.replicas, w.cpu, w.memory, w.spread) for w in b.workloads]


def test_parse_reads_the_report_tables():
    inst = tiny.instance("k8s-5k-spread", "spread-rollout", 6, [2, 2])
    name = inst.workloads[0].name
    text = "\n".join([
        "Simulation success!", "Node Info", "+-+", "| Node | CPU Allocatable | CPU Requests "
        "| Memory Allocatable | Memory Requests | Pod Count | New Node |", "+=+",
        "| node-00001 | 4 | 300m(7%) | 32Gi | 1500Mi(4%) | 3 |  |", "+-+", "",
        "Pod Info", "+-+", "| Node | Pod | CPU Requests | Memory Requests | APP Name |", "+=+",
        f"| node-00001 | sched/{name}-5d8f7c9b4-x2k4q | 100m(2%) | 500Mi(1%) | sched |",
        "+-+"])
    ans = check.parse(text, inst)
    assert ans.success and ans.count == 0 and ans.nodes == 1
    assert int(ans.cpu_req[0]) == 300 and int(ans.mem_req[0]) == 1500 << 20
    assert ans.pods == {(1, name): 1}
