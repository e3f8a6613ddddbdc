"""The GPU port's delta re-simulation (`open_simulator_tpu_torch` ->
incremental/resim.py) against the JAX package's, exactly.

The inputs of tests/test_incremental.py go through both packages, the
port's scans on the CPU (the kernels' plain versions): the suffix rule
on every delta kind and flag, `CommittedScan.state_digest()` on plain,
pinned, dangling, gpushare and priority rosters, a re-simulation after
an eviction, and seeded delta streams through the serve session, where
after EVERY delta the port's committed state equals a fresh full
re-scan and the JAX session's committed state.
"""

import copy
import importlib
import json

import numpy as np
import pytest

from open_simulator_tpu.testing import make_fake_node, make_fake_pod, with_priority

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")
# the port's committed scans run on the CPU here (the plain versions)
DEV = {"open_simulator_tpu": {}, "open_simulator_tpu_torch": {"device": "cpu"}}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _port_names():
    from open_simulator_tpu_torch.models.workloads import reset_name_counter

    reset_name_counter()
    yield


def _nodes(n=8, cpu="8", mem="16Gi"):
    return [make_fake_node(f"n{i:02d}", cpu, mem) for i in range(n)]


def _pods(n, prefix="p", cpu="500m", mem="1Gi"):
    return [make_fake_pod(f"{prefix}{i:03d}", "default", cpu, mem) for i in range(n)]


def _cluster(pkg, nodes, pods):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = copy.deepcopy(nodes)
    cluster.pods = copy.deepcopy(pods)
    return cluster


def _committed(pkg, nodes, pods):
    cs = _mod(pkg, "incremental.resim").CommittedScan
    return cs(copy.deepcopy(nodes), copy.deepcopy(pods), **DEV[pkg])


def _request(pkg, name="req", n=2, cpu="250m", mem="256Mi"):
    app = _mod(pkg, "models.decode").ResourceTypes()
    app.pods = [make_fake_pod(f"{name}-{i}", "default", cpu, mem) for i in range(n)]
    s = _mod(pkg, "serve.session")
    return s.WhatIfRequest(apps=[_mod(pkg, "scheduler.core").AppResource(name, app)])


def _session(pkg, nodes, pods, **kw):
    return _mod(pkg, "serve.session").Session(_cluster(pkg, nodes, pods), **DEV[pkg], **kw)


SUFFIX_CASES = [
    ("pod_evict", 100, dict(positions=[40])),
    ("pod_arrive", 100, dict(positions=[12], insert_position=90)),
    ("pod_arrive", 100, dict(positions=[None], insert_position=90)),
    ("pod_evict", 100, dict(positions=[90], has_priority=True)),
    ("pod_evict", 100, dict(positions=[90], has_side_effects=True)),
    ("node_join", 100, {}),
    ("pod_evict", 100, dict(positions=[])),
    ("pod_delete", 100, dict(positions=[0])),
    ("pod_bind", 10, dict(insert_position=200)),
]


@pytest.mark.parametrize("kind,n,kw", SUFFIX_CASES)
def test_suffix_rule_equals_the_jax_rule(kind, n, kw):
    got = [_mod(pkg, "incremental.resim").suffix_for_delta(kind, n, **kw) for pkg in PKGS]
    jax_d, port_d = got
    assert (port_d.start, port_d.full, port_d.reason, port_d.trivial) == (
        jax_d.start, jax_d.full, jax_d.reason, jax_d.trivial)


def _gpu_roster():
    gi = 1024 ** 3
    nodes = []
    for i in range(4):
        node = make_fake_node(f"g{i}", "16", "64Gi")
        node["status"]["capacity"] = {
            "alibabacloud.com/gpu-count": "2",
            "alibabacloud.com/gpu-mem": str(2 * 32 * gi),
        }
        nodes.append(node)
    pods = _pods(6)
    for i in (1, 4):
        pods[i]["metadata"]["annotations"] = {"alibabacloud.com/gpu-mem": str(4 * gi)}
    return nodes, pods


def _pinned_roster():
    nodes, pods = _nodes(6), _pods(20)
    pods[3]["spec"]["nodeName"] = "n04"
    pods[15]["spec"]["nodeName"] = "n01"
    pods[17]["spec"]["nodeName"] = "ghost"
    return nodes, pods


def _priority_roster():
    nodes, pods = _nodes(6), _pods(12)
    pods[2] = make_fake_pod("prio-p", "default", "500m", "1Gi", with_priority(50))
    return nodes, pods


ROSTERS = {
    "plain": lambda: (_nodes(8), _pods(24)),
    "tight": lambda: (_nodes(4, cpu="4", mem="8Gi"), _pods(30, cpu="900m")),
    "pinned": _pinned_roster,
    "gpushare": _gpu_roster,
    "priority": _priority_roster,
}


@pytest.mark.parametrize("name", sorted(ROSTERS))
def test_committed_state_digest_equal_across_packages(name):
    nodes, pods = ROSTERS[name]()
    jax_c, port_c = (_committed(pkg, nodes, pods) for pkg in PKGS)
    assert port_c.state_digest() == jax_c.state_digest()
    assert port_c.bulk_eligible == jax_c.bulk_eligible
    assert list(port_c.codes) == list(jax_c.codes)


@pytest.mark.parametrize("name", sorted(ROSTERS))
def test_resimulate_after_an_eviction_equals_a_fresh_scan_and_jax(name):
    """Evict the roster's position 10 (5 on the small gpushare roster):
    the port's re-simulation (a reused prefix, or the full re-scan the
    rule forces on side-effect and priority rosters) equals a fresh
    CommittedScan of the shortened roster and the JAX package's."""
    nodes, pods = ROSTERS[name]()
    at = min(10, len(pods) - 1)
    roster2 = pods[:at] + pods[at + 1:]
    outs = []
    for pkg in PKGS:
        scan = _committed(pkg, nodes, pods)
        outs.append(scan.resimulate(copy.deepcopy(roster2), at).state_digest())
    assert outs[1] == outs[0]
    fresh = _committed("open_simulator_tpu_torch", nodes, roster2).state_digest()
    assert outs[1] == fresh


def test_resimulate_reuses_the_prefix_and_launches_one_scan():
    """On a bulk-eligible roster a re-simulation replays the prefix on
    the host and launches ONE scan over the suffix (site `scan`)."""
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    nodes, pods = _nodes(8), _pods(24)
    scan = _committed("open_simulator_tpu_torch", nodes, pods)
    assert scan.bulk_eligible
    l0 = COUNTERS.get("launches_scan")
    r0 = COUNTERS.get("incremental_prefix_reused_pods_total")
    roster2 = pods[:10] + pods[11:]
    out = scan.resimulate(copy.deepcopy(roster2), 10)
    assert COUNTERS.get("launches_scan") - l0 == 1
    assert COUNTERS.get("incremental_prefix_reused_pods_total") - r0 == 10
    assert out.device.type == "cpu"


def _random_delta(pkg, rng, session, seed, arrivals):
    dl = _mod(pkg, "twin.deltas")
    kind = rng.choice(["pod_evict", "pod_arrive", "pod_delete"])
    if kind == "pod_arrive":
        return dl.ClusterDelta(kind="pod_arrive", pod=make_fake_pod(
            f"arr-{seed}-{arrivals}", "default", "900m", "1Gi"))
    bare = session.cluster_pods[: session._bare_end]
    pick = bare[rng.randint(len(bare))] if bare else None
    return dl.ClusterDelta(kind=kind, namespace="default",
                           name=(pick or {}).get("metadata", {}).get("name", "none"))


@pytest.mark.parametrize("seed", [1, 7])
def test_seeded_delta_stream_equals_full_rescan_and_jax(seed):
    """Random evict/arrive/delete streams into both packages' serve
    sessions: after EVERY delta the port's committed state equals a
    fresh full re-scan of the mutated roster and the JAX session's, and
    the drifted session's answer equals a cold one, incremental or not,
    and the JAX package's."""
    nodes = _nodes(8, cpu="4", mem="8Gi")
    pods = _pods(30, cpu="900m", mem="1Gi")
    sessions = [_session(pkg, nodes, pods) for pkg in PKGS]
    for s in sessions:
        assert s._committed_scan() is not None
    rngs = [np.random.RandomState(seed) for _ in PKGS]
    port_cs = _mod("open_simulator_tpu_torch", "incremental.resim").CommittedScan
    arrivals = 0
    for step in range(10):
        arrivals += 1
        outs = []
        for pkg, s, rng in zip(PKGS, sessions, rngs):
            outs.append(s.apply_delta(_random_delta(pkg, rng, s, seed, arrivals)))
        assert outs[0] == outs[1]
        jax_s, port_s = sessions
        port_digest = port_s._committed_scan().state_digest()
        assert port_digest == jax_s._committed_scan().state_digest(), step
        fresh = port_cs(port_s.cluster.nodes, port_s.cluster_pods, device="cpu")
        assert port_digest == fresh.state_digest(), step
        assert port_s.state_digest() == jax_s.state_digest()
    replies = [s.evaluate_batch([_request(pkg, "drift")])[0]
               for pkg, s in zip(PKGS, sessions)]
    port_s = sessions[1]
    cold_inc = _mod("open_simulator_tpu_torch", "serve.session").Session(
        port_s.cluster, device="cpu").evaluate_batch(
        [_request("open_simulator_tpu_torch", "drift")])[0]
    cold_full = _mod("open_simulator_tpu_torch", "serve.session").Session(
        port_s.cluster, incremental=False, device="cpu").evaluate_batch(
        [_request("open_simulator_tpu_torch", "drift")])[0]
    assert replies[1].body == replies[0].body == cold_inc.body == cold_full.body


def test_committed_cluster_failures_reported_in_every_reply():
    nodes = _nodes(3, cpu="2", mem="4Gi")
    pods = _pods(4, cpu="3", mem="1Gi")  # none fit
    bodies = []
    for pkg in PKGS:
        for inc in (True, False):
            s = _session(pkg, nodes, pods, incremental=inc)
            bodies.append(s.evaluate_batch(
                [_request(pkg, "tiny", n=1, cpu="100m", mem="64Mi")])[0].body)
    assert len(set(bodies)) == 1
    doc = json.loads(bodies[0])
    assert not doc["success"] and len(doc["unscheduledPods"]) == 4


def test_priority_arrival_drops_committed_and_routes_serial():
    nodes = _nodes(6)
    bodies = []
    for pkg in PKGS:
        s = _session(pkg, nodes, _pods(8))
        assert s._committed_scan() is not None
        s.apply_delta(_mod(pkg, "twin.deltas").ClusterDelta(
            kind="pod_arrive",
            pod=make_fake_pod("prio-arr", "default", "200m", "256Mi", with_priority(100))))
        assert s.force_serial_reason and s._committed_scan() is None
        reply = s.evaluate_batch([_request(pkg, "after-prio", n=1)])[0]
        assert reply.meta.get("engine") == "serial"
        bodies.append(reply.body)
    assert bodies[0] == bodies[1]


def test_warm_delta_path_launches_one_scan_a_delta_and_one_a_tick():
    """The warm path's launch count: an arrival near the roster's end
    is one re-simulation launch (site `scan`), a query one batch launch
    (site `scenario_scan`), and nothing is built."""
    from open_simulator_tpu_torch.obs import profile
    from open_simulator_tpu_torch.twin.deltas import ClusterDelta
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    s = _session("open_simulator_tpu_torch", _nodes(6), _pods(20))
    assert s._committed_scan() is not None
    req = _request("open_simulator_tpu_torch", "warm", n=1)
    for i in range(2):
        p0 = profile.snapshot()
        scan0, tick0 = COUNTERS.get("launches_scan"), COUNTERS.get("launches_scenario_scan")
        assert s.apply_delta(ClusterDelta(kind="pod_arrive", pod=make_fake_pod(
            f"warm-arr-{i}", "default", "200m", "256Mi"))) == "applied"
        assert s.evaluate_batch([req])[0].status == 200
        assert COUNTERS.get("launches_scan") - scan0 == 1
        assert COUNTERS.get("launches_scenario_scan") - tick0 == 1
        assert profile.delta(p0)["nvcc_builds_total"] == 0
