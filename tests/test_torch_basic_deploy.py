"""The benchmark's basic-deploy cell through the port: plain pods of one
Deployment (scheduler_perf's pod-default.yaml) rolled out onto nodes of
node-default.yaml that hold them all, `simon apply --device cpu` against
the plain reference (benchmark/reference/kube_v120.py) at small sizes;
and the cell's control (benchmark/reference/control_packing.py), which
scores the share of a node taken where the reference scores the share
left free, and is not correct.

This file imports neither JAX nor the JAX package."""

import contextlib
import io
import json
from pathlib import Path

import pytest

from benchmark import check, generate
from benchmark.reference import control_packing, kube_v120
from open_simulator_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
EXACT = {k: 0 for k in check.LIMITS}


def _basic(nodes: int, replicas: int, seed: int) -> generate.Instance:
    with open(REPO / "benchmark" / "configs" / "k8s-5k-spread.json") as f:
        cfg = json.load(f)
    with open(REPO / "benchmark" / "traffic" / "basic-rollout.json") as f:
        mix = json.load(f)
    cfg["nodes"] = nodes
    mix["workloads"][0]["replicas"] = replicas
    return generate.make_instance(cfg, mix, seed, 0)


def _reference(inst):
    return check.Reference(kube_v120.schedule).at(inst)


# nodes, pods, seed: every node holds 40 such pods by CPU
ROLLOUTS = {
    "even": (50, 1500, 2**31 + 77),
    "uneven": (50, 1799, 5_000_000_017),
    "full": (40, 1600, 3),
}


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_port_equals_the_reference_on_the_basic_rollout(case, tmp_path):
    nodes, pods, seed = ROLLOUTS[case]
    inst = _basic(nodes, pods, seed)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["apply", "-f", inst.write(str(tmp_path / inst.tag)), "--device", "cpu"])
    assert rc == 0
    ans = check.parse(out.getvalue(), inst)
    assert ans.success and ans.count == 0 and ans.placed == pods
    assert check.compare(ans, inst, _reference(inst)) == EXACT


def test_least_allocated_spreads_where_most_allocated_packs():
    """One pod of 100m / 500Mi: the reference scores an empty node above
    one that holds 20 such pods; the control the other way round, until
    the fortieth pod's node is full on CPU and scores below an empty
    node."""
    inst = _basic(3, 100, 5)
    shape = (inst.workloads[0].cpu_m, inst.workloads[0].mem, False)

    def scores(cluster, held):
        cl = cluster(inst, 0)
        for j, n in enumerate(held):
            for _ in range(n):
                cl.place(shape, j)
        return [cl.score(shape, j) for j in range(cl.n)]

    least = scores(kube_v120.Cluster, (0, 20, 39))
    most = scores(control_packing._MostAllocated, (0, 20, 39))
    assert least[0] > least[1] > least[2]
    assert most[1] > most[0] > most[2]


@pytest.mark.parametrize("seed", [2**31 + 9, 6, 4_000_000_007])
def test_the_packing_control_is_not_correct(seed):
    inst = _basic(50, 1500, seed)
    ref = _reference(inst)
    assert ref(0).success and set(ref(0).pod_count.tolist()) == {30}
    numbers = check.compare(control_packing.most_allocated(inst), inst, ref)
    assert numbers["misplaced_pods"] > 0 and numbers["wrong_alloc_nodes"] == 50
    assert not check.verdict(numbers, 0)
