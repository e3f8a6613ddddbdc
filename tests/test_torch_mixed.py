"""scheduler_perf's MixedSchedulingBasePod (kube-scheduler v1.20.5)
through the port: `simon apply --device cpu` against the benchmark's
plain reference of InterPodAffinity
(benchmark/reference/kube_v120_affinity.py) on the benchmark's own
inputs at small sizes; a hand case of each InterPodAffinity rule; the
reference's serial pass against its full form; the control, which is
not correct; the term encode's phase and counters; the frozen count of
the affinity scan against the program's; and, on the card (`cuda`), the
`fused_scan_terms` launch at the cell's own shape and at a shape whose
static and dynamic shared memory pass 48 KB together, each against the
plain version.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_mixed.py
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import check, generate, generate_affinity
from benchmark.cost import fused_scan as frozen_base
from benchmark.cost import fused_scan_affinity as frozen
from benchmark.reference import control_affinity, kube_v120_affinity
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

REPO = Path(__file__).resolve().parents[1]
HOST = generate.HOSTNAME_KEY
ZONE = "topology.kubernetes.io/zone"
EXACT = {k: 0 for k in check.LIMITS}


def _config(nodes: int, zones=None) -> dict:
    with open(REPO / "benchmark" / "configs" / "k8s-5k-mixed.json") as f:
        cfg = json.load(f)
    cfg["nodes"] = nodes
    if zones is not None:
        cfg["zone_values"] = list(zones)
    return cfg


def _traffic(replicas) -> dict:
    with open(REPO / "benchmark" / "traffic" / "mixed-rollout.json") as f:
        mix = json.load(f)
    for w, r in zip(mix["workloads"], replicas):
        w["replicas"] = r
    return mix


def _mixed(nodes, replicas, seed, zones=None):
    return generate_affinity.make_instance(_config(nodes, zones), _traffic(replicas), seed, 0)


def _hand(nodes, workloads, zones=None, seed=5):
    return generate_affinity.make_instance(_config(nodes, zones),
                                           {"namespace": "sched", "workloads": workloads},
                                           seed, 0)


def _apply(inst, tmp_path, device="cpu"):
    """(exit code, printed text) of `simon apply` of the request."""
    argv = ["apply", "-f", inst.write(str(tmp_path / inst.tag))]
    if device is not None:
        argv += ["--device", device]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _port(inst, tmp_path, device="cpu"):
    """The port's answer to `simon apply` of the request."""
    rc, text = _apply(inst, tmp_path, device)
    assert rc == 0
    return check.parse(text, inst)


def _against_reference(ans, inst):
    return check.compare(ans, inst, check.Reference(kube_v120_affinity.schedule).at(inst))


def _deploy(name, replicas, labels=None, cpu="100m", memory="500Mi", **terms):
    return {"name": name, "kind": "Deployment", "replicas": replicas, "cpu": cpu,
            "memory": memory, "labels": labels or {}, **terms}


# -- the port against the reference on the cell's traffic --------------------

MIXED = {
    "seed-a": (60, [20] * 6, 2**31 + 77, None),
    "seed-b": (60, [20] * 6, 5_000_000_017, None),
    "seed-c": (60, [20] * 6, 3, None),
    "two-zones": (61, [20] * 6, 2**33 + 5, ["zone1", "zone2"]),
    # the anti-affinity pods outnumber the nodes: the plan adds nodes
    "past-the-nodes": (15, [5, 5, 20, 5, 5, 5], 11, None),
}


@pytest.mark.parametrize("case", sorted(MIXED))
def test_port_equals_the_reference_on_the_mixed_traffic(case, tmp_path):
    nodes, replicas, seed, zones = MIXED[case]
    inst = _mixed(nodes, replicas, seed, zones)
    ans = _port(inst, tmp_path)
    assert ans.success and ans.placed == inst.pods
    assert (ans.count > 0) == (case == "past-the-nodes")
    assert _against_reference(ans, inst) == EXACT


# -- hand cases of each InterPodAffinity rule, reference and port -----------


def _placed_on(ans, inst, prefix):
    """The nodes of the answer's pods of the workload named `prefix`."""
    name = next(w.name for w in inst.workloads if w.name.startswith(prefix + "-"))
    return sorted(j for (j, key), c in ans.pods.items() if key == name for _ in range(c))


def _hub_and_needy(hub_matches_itself: bool):
    hub_labels = {"role": "hub"} if hub_matches_itself else {}
    return _hand(10, [
        _deploy("hub", 3, hub_labels, affinity=[{"key": ZONE, "selector": {"role": "hub"}}]),
        _deploy("needy", 4, affinity=[{"key": ZONE, "selector": {"role": "hub"}}])],
        zones=["z1", "z2"])


def test_self_match_admits_the_first_of_a_series(tmp_path):
    """The first hub passes only because it matches its own term; every
    later pod lands in its zone."""
    inst = _hub_and_needy(True)
    ref = kube_v120_affinity.schedule(inst, 0)
    assert ref.success
    placed = _placed_on(ref, inst, "hub") + _placed_on(ref, inst, "needy")
    zones = {int(inst.zone[j]) for j in placed}
    assert len(zones) == 1
    assert _against_reference(_port(inst, tmp_path), inst) == EXACT


def test_no_self_match_leaves_the_series_pending(tmp_path):
    """Pods whose terms select no pod, and not themselves, never land."""
    inst = _hub_and_needy(False)
    ref = kube_v120_affinity.schedule(inst, 0)
    assert ref.unscheduled == inst.pods
    assert kube_v120_affinity.schedule(inst, inst.max_new).unscheduled == inst.pods
    rc, text = _apply(inst, tmp_path)
    assert rc != 0 and not check.parse(text, inst).success


def test_anti_affinity_holds_both_ways(tmp_path):
    """A plain pod the placed pods' anti-affinity selects keeps off
    their nodes; a pod whose own anti-affinity selects placed pods keeps
    off theirs."""
    green = {"color": "green"}
    anti = [{"key": HOST, "selector": green}]
    inst = _hand(8, [_deploy("guard", 3, green, anti=anti),
                     _deploy("plain-green", 3, green),
                     _deploy("avoid-green", 2, {"color": "blue"}, anti=anti)])
    ref = kube_v120_affinity.schedule(inst, 0)
    assert ref.success
    guards = set(_placed_on(ref, inst, "guard"))
    greens = set(_placed_on(ref, inst, "plain-green"))
    assert not guards & greens
    assert not set(_placed_on(ref, inst, "avoid-green")) & (guards | greens)
    assert _against_reference(_port(inst, tmp_path), inst) == EXACT


def test_an_empty_label_value_is_not_a_missing_label(tmp_path):
    """`foo: ""` selects the pod labelled foo with the empty value and
    none of the pods without foo."""
    inst = _hand(4, [_deploy("plain", 3), _deploy("foo", 1, {"foo": ""}),
                     _deploy("avoid-foo", 3, anti=[{"key": HOST, "selector": {"foo": ""}}])])
    ref = kube_v120_affinity.schedule(inst, 0)
    assert ref.success
    assert not set(_placed_on(ref, inst, "avoid-foo")) & set(_placed_on(ref, inst, "foo"))
    assert set(_placed_on(ref, inst, "avoid-foo")) == set(_placed_on(ref, inst, "plain"))
    assert _against_reference(_port(inst, tmp_path), inst) == EXACT


def test_normalize_score_bounds_start_at_zero(tmp_path):
    """Every feasible node scores above 0 (the placed required-affinity
    pods lift the whole zone): NormalizeScore's min stays 0, so the
    nodes differ by a point, where the control stretches them to 100."""
    raw = np.array([2000, 2001, 2000])
    feasible = np.ones(3, dtype=bool)
    assert kube_v120_affinity.normalize(raw, feasible).tolist() == [99, 100, 99]
    assert control_affinity.normalize_from_feasible(raw, feasible).tolist() == [0, 100, 0]
    inst = _mixed(60, [30] * 6, 7)
    ref = kube_v120_affinity.schedule(inst, 0)
    assert control_affinity.bounds_from_feasible(inst).pods != ref.pods
    assert _against_reference(_port(inst, tmp_path), inst) == EXACT


def _order_case():
    """The seeker's preferred terms score 50 on big-a's node and 29 on
    big-b's; big-b's node ties the first empty node only where the
    normalised 29 is 58."""
    return _hand(4, [
        _deploy("big-a", 1, {"tier": "a"}, cpu="3500m", memory="1Gi"),
        _deploy("big-b", 1, {"tier": "b"}, cpu="1600m", memory="1Gi"),
        _deploy("seeker", 1, pref_affinity=[
            {"key": HOST, "selector": {"tier": "a"}, "weight": 50},
            {"key": HOST, "selector": {"tier": "b"}, "weight": 29}])])


def test_normalize_score_divides_before_it_scales(tmp_path):
    """int64(100 * (29 / 50)) is 57 in float64, where 100 * 29 / 50,
    the product taken first, is 58."""
    inst = _order_case()
    assert kube_v120_affinity.normalize(np.array([50, 29, 0]), np.ones(3, bool)).tolist() == [
        100, 57, 0]
    ref = kube_v120_affinity.schedule(inst, 0)
    assert _placed_on(ref, inst, "big-b") == [1] and _placed_on(ref, inst, "seeker") == [2]
    assert _against_reference(_port(inst, tmp_path), inst) == EXACT


def _sweep(inst, tmp_path, device="cpu", padded=False):
    """The request's sweep as `simon apply` builds it, padded with the
    plan's new nodes when `padded`, else with none (the scan's nodes are
    then the scenario's)."""
    from open_simulator_tpu_torch.apply.applier import Applier, SimonConfig
    from open_simulator_tpu_torch.parallel.sweep import CapacitySweep

    if not padded:
        inst.max_new = 0
    path = inst.write(str(tmp_path / inst.tag))
    app = Applier(SimonConfig.from_file(path), device=device)
    return CapacitySweep(app.load_cluster(), app.load_apps(), app.load_new_node(),
                         inst.max_new, device=device)


def test_shared_rows_are_one_row(tmp_path):
    """The preferred-affinity and preferred-anti-affinity pods name the
    same {foo: ""} row on the hostname: the tables hold it once, with
    both classes' weights on it, beside the zone row and the anti row."""
    from open_simulator_tpu_torch.ops.terms import TermTables

    inst = _mixed(20, [3] * 6, 9)
    tables: TermTables = _sweep(inst, tmp_path).batch.terms
    assert tables.t == 3 and tables.a == 1
    paff = np.nonzero(tables.carry_aff_pref_w.any(axis=1))[0]
    panti = np.nonzero(tables.carry_anti_pref_w.any(axis=1))[0]
    assert paff.tolist() == panti.tolist() and len(paff) == 1
    assert sorted(tables.carry_aff_pref_w[paff[0]].tolist()) == [0, 0, 0, 0, 0, 1]


# -- the reference's two forms, and its control ------------------------------

FORMS = {
    "mixed": lambda: _mixed(30, [12, 12, 12, 18, 18, 8], 13),
    "two-zones": lambda: _mixed(21, [8] * 6, 17, ["zone1", "zone2"]),
    "hub-and-needy": lambda: _hub_and_needy(True),
    "past-the-nodes": lambda: _mixed(6, [2, 2, 9, 3, 3, 2], 19),
}


@pytest.mark.parametrize("case", sorted(FORMS))
@pytest.mark.parametrize("tie", ["first", "last"])
def test_serial_pass_equals_the_full_form(case, tie):
    inst = FORMS[case]()
    for count in (0, 3):
        fast = kube_v120_affinity.schedule(inst, count, tie)
        full = kube_v120_affinity.schedule_full(inst, count, tie)
        assert fast.pods == full.pods and fast.unscheduled == full.unscheduled
        assert (fast.cpu_req == full.cpu_req).all() and (fast.pod_count == full.pod_count).all()


@pytest.mark.parametrize("seed", [2**31 + 77, 6])
def test_the_control_is_not_correct(seed):
    inst = _mixed(60, [30] * 6, seed)
    numbers = check.compare(control_affinity.bounds_from_feasible(inst), inst,
                            check.Reference(kube_v120_affinity.schedule).at(inst))
    assert numbers["misplaced_pods"] > 0 and numbers["wrong_alloc_nodes"] > 0
    assert not check.verdict(numbers, 0)


# -- the term encode's phase and counters -------------------------------------

COUNTED = ("terms_rows_affinity_total", "terms_rows_anti_total",
           "terms_rows_preferred_total", "terms_rows_spread_total",
           "terms_scored_classes_total")


def _counted(inst, tmp_path):
    before = {k: COUNTERS.get(k) for k in COUNTED}
    _port(inst, tmp_path)
    phases = {p["name"]: p["count"] for p in GLOBAL.as_dict()["phases"]}
    return {k: COUNTERS.get(k) - before[k] for k in COUNTED}, phases


def test_the_term_encode_is_one_phase_and_five_counts_a_request(tmp_path):
    counts, phases = _counted(_mixed(20, [3] * 6, 21), tmp_path)
    # the tables, then the plan's term arrays; never once a pod
    assert phases["encode/terms"] == 2 and phases["sweep/encode"] == 1
    assert counts == dict(zip(COUNTED, (1, 1, 1, 0, 3)))
    with open(REPO / "benchmark" / "configs" / "k8s-5k-spread.json") as f:
        cfg = json.load(f)
    with open(REPO / "benchmark" / "traffic" / "spread-rollout.json") as f:
        mix = json.load(f)
    cfg["nodes"] = 30
    for w, r in zip(mix["workloads"], (20, 30)):
        w["replicas"] = r
    counts, phases = _counted(generate.make_instance(cfg, mix, 23, 0), tmp_path)
    assert phases["encode/terms"] == 2
    assert counts == dict(zip(COUNTED, (0, 0, 0, 2, 0)))


# -- the frozen count of the affinity scan -------------------------------------


def test_the_frozen_affinity_count_is_the_programs_and_the_normalisation(tmp_path):
    """The program's count (obs/costs.py) holds the rows and group rows
    but not InterPodAffinity's normalisation: the frozen count is it
    and that normalisation at every visit of a scored class."""
    from open_simulator_tpu_torch.obs import costs

    inst = _mixed(40, [10, 10, 10, 15, 15, 5], 29)
    sweep = _sweep(inst, tmp_path)
    active, valid, pinned = sweep._scenario(0)
    program = costs.launch_ops(sweep.plan, sweep.batch.class_of_pod,
                               [(np.asarray(active), np.asarray(valid), pinned)])
    norm = sum(w.replicas for w in inst.workloads if frozen.scored(w, inst))
    assert frozen.scan_ops(inst, 0) == program + frozen.OPS_PER_NORMALISED_VISIT * norm * 40
    assert [frozen.scored(w, inst) for w in inst.workloads] == [False, True, False, True,
                                                                 True, False]


def test_the_frozen_affinity_count_adds_nothing_to_spreads():
    with open(REPO / "benchmark" / "configs" / "k8s-5k-spread.json") as f:
        cfg = json.load(f)
    with open(REPO / "benchmark" / "traffic" / "spread-rollout.json") as f:
        mix = json.load(f)
    inst = generate.make_instance(cfg, mix, 31, 0)
    assert frozen.scan_ops(inst, 0) == frozen_base.scan_ops(inst, 0)
    assert frozen.scan_bytes(inst, 0) == frozen_base.scan_bytes(inst, 0)


def test_the_mixed_cell_is_bound_by_operations():
    inst = _mixed(5000, [2000] * 5 + [1000], 37)
    ms, by = frozen.bound(inst, 0)
    assert by == "operations" and ms > frozen_base.bound(inst, 0)[0]


# -- the launch whose shared memory needs the opt-in ----------------------------


def _smem_window_rollout():
    """benchmark/tests/test_bench_run.py's request of 30 StatefulSets on
    300 nodes, on which the launch was refused."""
    from benchmark.tests.test_bench_run import _rollout

    return _rollout(300, 30)


def test_the_300_node_launch_passes_48_kb_only_with_its_static_arrays(tmp_path):
    """The plan's dynamic shared memory alone stays under 48 KB, with the
    term instantiation's static arrays it passes: the launch needs the
    opt-in the kernel now always asks for (the `cuda` test below)."""
    from open_simulator_tpu_torch.ops import fused_scan

    plan = _sweep(_smem_window_rollout(), tmp_path, padded=True).plan
    assert plan.n == 400
    shape = fused_scan.launch_shape(plan, 1)
    assert shape.resident and shape.smem <= 48 * 1024
    assert shape.smem + fused_scan.static_smem(plan) > 48 * 1024


# -- on the card ------------------------------------------------------------------


def _kernel_equals_plain(sweep):
    import torch

    from open_simulator_tpu_torch.ops import fused_scan

    active, valid, pinned = sweep._scenario(0)
    cls = sweep.batch.class_of_pod
    name = fused_scan.kernel_name(sweep.plan)
    before = fused_scan.LAUNCHES[name]
    got = fused_scan.run_fused_scan(sweep.plan, cls, active, valid, pinned)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[name] == before + 1
    want = fused_scan.fused_scan_reference(sweep.plan, cls, active, valid, pinned)
    (gp, gf), (wp, wf) = got, want
    np.testing.assert_array_equal(gp.cpu().numpy(), wp.cpu().numpy())
    assert gf.keys() == wf.keys()
    for k in gf:
        np.testing.assert_array_equal(gf[k].cpu().numpy(), wf[k].cpu().numpy(), err_msg=k)
    return gp.cpu().numpy()


@pytest.mark.cuda
def test_terms_launch_at_the_mixed_cell_shape_equals_plain(tmp_path):
    """5,000 nodes, 11,000 pods of the five kinds and the plain ones: one
    fused_scan_terms launch, placements and final state the plain
    version's, every pod placed."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sweep = _sweep(_mixed(5000, [2000] * 5 + [1000], 2**31 + 77), tmp_path, "cuda",
                   padded=True)
    assert sweep.plan.has_terms and sweep.plan.n == 5100 and sweep.plan.u == 6
    assert (_kernel_equals_plain(sweep) >= 0).all()


@pytest.mark.cuda
def test_terms_launch_past_48_kb_with_its_static_arrays_equals_plain(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _kernel_equals_plain(_sweep(_smem_window_rollout(), tmp_path, "cuda", padded=True))


ON_CARD = {case: (lambda c=case: _mixed(*MIXED[c])) for case in
           ("seed-a", "two-zones", "past-the-nodes")} | {"normalize-order": _order_case}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ON_CARD))
def test_port_equals_the_reference_on_the_card(case, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    inst = ON_CARD[case]()
    assert _against_reference(_port(inst, tmp_path, device=None), inst) == EXACT
