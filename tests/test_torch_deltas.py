"""The GPU port's cluster-delta substrate (`open_simulator_tpu_torch` ->
twin/deltas.py) against the JAX package's, exactly.

The inputs of tests/test_twin.py go through both packages: every delta
kind's record round trip and validation message, the decision-log and
timeline-event conversions, the applicator's outcome and `state_dict`
after EVERY delta (each kind, the live-tail races, the seeded random
interleavings of test_random_interleavings_conform), the cold reload of
each stream, and a real decision committed through the cuda engine's
`TorchEngine.commit_host` (on the CPU) against the JAX `tpu` engine's.
"""

import copy
import importlib
import json
import random

import pytest

from open_simulator_tpu.testing import make_fake_node, with_node_labels

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")
# the applicator's engines: the JAX package's `tpu` is the port's `cuda`
# (here on the CPU, the kernels' plain versions)
ENGINES = {"open_simulator_tpu": ("tpu", {}),
           "open_simulator_tpu_torch": ("cuda", {"device": "cpu"})}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _pod(name, cpu="500m", mem="512Mi", namespace="d", node=None, port=None,
         scalar=None):
    pod = {
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"containers": [{"name": "c", "image": "img",
                                 "resources": {"requests": {"cpu": cpu, "memory": mem}}}]},
    }
    if node:
        pod["spec"]["nodeName"] = node
    if port:
        pod["spec"]["containers"][0]["ports"] = [{"hostPort": port, "protocol": "TCP"}]
    if scalar:
        pod["spec"]["containers"][0]["resources"]["requests"][scalar[0]] = str(scalar[1])
    return pod


def _cluster(pkg, n=3, cpu="8", memory="16Gi"):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [make_fake_node(f"n-{i}", cpu, memory, with_node_labels({"rack": f"r{i % 2}"}))
                     for i in range(n)]
    return cluster


def _deltas(pkg, recs):
    """ClusterDeltas of `pkg` from plain records (fresh copies)."""
    cd = _mod(pkg, "twin.deltas").ClusterDelta
    return [cd.from_record(copy.deepcopy(r)) for r in recs]


def _bind(name, node, **kw):
    return {"kind": "pod_bind", "pod": _pod(name, **kw), "node": node}


def _evict(name, node=""):
    return {"kind": "pod_evict", "namespace": "d", "name": name, "node": node}


def _join(name, cpu="4", memory="8Gi"):
    return {"kind": "node_join", "node": make_fake_node(name, cpu=cpu, memory=memory)}


# each stream of tests/test_twin.py as delta records
STREAMS = {
    "every-kind": [
        _bind("a", "n-0", port=8080),
        _bind("s", "n-1", scalar=("example.com/widget", 2)),
        {"kind": "pod_arrive", "pod": _pod("b", cpu="7")},
        _join("n-3"),
        _bind("c", "n-3"),
        _evict("a", "n-0"),
        {"kind": "pod_delete", "namespace": "d", "name": "b"},
        {"kind": "node_drain", "name": "n-2"},
    ],
    "skips": [
        _bind("ghost", "never-seen"),
        _evict("not-there"),
        {"kind": "pod_delete", "namespace": "d", "name": "not-pending"},
        _bind("real", "n-1"),
    ],
    "stale-evict": [_bind("mv", "n-0"), _evict("mv", "n-2")],
    "pending-evict": [{"kind": "pod_arrive", "pod": _pod("stuck")}, _evict("stuck")],
    "rebind": [_bind("mv", "n-0"), _bind("mv", "n-1")],
}


def _random_stream(seed, round_=0, steps=60):
    """test_random_interleavings_conform's stream for `seed + round_`,
    as delta records."""
    rng = random.Random(seed + round_)
    out = []
    node_pool = [f"x-{round_}-{j}" for j in range(3)]
    live_nodes = ["n-0", "n-1", "n-2"]
    pod_i = 0
    for _s in range(steps):
        kind = rng.choice(["pod_bind", "pod_bind", "pod_arrive", "pod_evict",
                           "pod_delete", "node_join", "node_drain"])
        if kind == "pod_bind":
            pod_i += 1
            out.append({"kind": "pod_bind",
                        "pod": _pod(f"p-{round_}-{pod_i}", cpu=rng.choice(["250m", "1", "2"])),
                        "node": rng.choice(live_nodes + ["nowhere"])})
        elif kind == "pod_arrive":
            pod_i += 1
            out.append({"kind": "pod_arrive", "pod": _pod(f"p-{round_}-{pod_i}")})
        elif kind in ("pod_evict", "pod_delete"):
            out.append({"kind": kind, "namespace": "d",
                        "name": f"p-{round_}-{rng.randint(1, max(pod_i, 1))}"})
        elif kind == "node_join" and node_pool:
            name = node_pool.pop()
            live_nodes.append(name)
            out.append(_join(name))
        elif kind == "node_drain" and len(live_nodes) > 1:
            name = rng.choice(live_nodes)
            live_nodes.remove(name)
            out.append({"kind": "node_drain", "name": name})
    return out


for _r in range(3):
    STREAMS[f"random-{7 + _r}"] = _random_stream(7, _r)


def _apply_stream(pkg, recs, engine_kind="oracle"):
    """(outcome, state_dict) after every delta of `recs`, the warm
    applicator's counts, and the cold reload's state_dict."""
    td = _mod(pkg, "twin.deltas")
    cluster = _cluster(pkg)
    engine, kw = ENGINES[pkg] if engine_kind != "oracle" else ("oracle", {})
    warm = td.MirrorApplicator(cluster, engine=engine, **kw)
    trail = []
    for d in _deltas(pkg, recs):
        out = warm.apply(d)
        trail.append((out, td.state_dict(warm)))
    cold = td.cold_reload(cluster, _deltas(pkg, recs), engine="oracle")
    return trail, (warm.applied, warm.skips, warm.reloads), td.state_dict(cold)


@pytest.mark.parametrize("engine_kind", ["oracle", "device"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_state_after_every_delta_equals_the_jax_package(stream, engine_kind):
    """Outcome and state_dict after every delta equal the JAX package's;
    the port's warm mirror equals its own cold reload at the end."""
    (jtrail, jcounts, jcold), (ptrail, pcounts, pcold) = (
        _apply_stream(pkg, STREAMS[stream], engine_kind) for pkg in PKGS)
    assert ptrail == jtrail
    assert pcounts == jcounts
    assert pcold == jcold
    assert ptrail[-1][1] == pcold


def test_delta_records_round_trip_like_the_jax_package():
    recs = [_bind("a", "n-0"), {"kind": "pod_arrive", "pod": _pod("b")}, _evict("a", "n-0"),
            {"kind": "pod_delete", "namespace": "d", "name": "b"}, _join("n-9"),
            {"kind": "node_drain", "name": "n-9"}]
    outs = []
    for pkg in PKGS:
        ds = _deltas(pkg, recs)
        rt = [json.loads(json.dumps(d.as_record())) for d in ds]
        assert [type(ds[0]).from_record(r).as_record() for r in rt] == rt
        outs.append(rt)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [
    {"kind": "pod_teleport"},
    {"kind": "pod_bind", "pod": _pod("a")},
    {"kind": "pod_arrive", "pod": _pod("a", node="n-0")},
    {"kind": "node_join", "node": {"metadata": {}}},
    {"kind": "node_drain"},
    {"kind": "pod_evict"},
])
def test_malformed_deltas_refused_with_the_jax_message(kw):
    msgs = []
    for pkg in PKGS:
        err = _mod(pkg, "models.validation").InputError
        with pytest.raises(err) as ei:
            _mod(pkg, "twin.deltas").ClusterDelta(**copy.deepcopy(kw))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_recorded_steps_convert_to_the_jax_deltas_and_events():
    """record_simulation's steps -> steps_to_deltas -> deltas_to_events
    (and from_shadow_op of every op) give the JAX package's records."""
    outs = []
    for pkg in PKGS:
        _mod(pkg, "models.workloads").reset_name_counter()
        res = _mod(pkg, "models.decode").ResourceTypes()
        res.pods = [_pod(f"p-{i}", cpu=str(3 + i)) for i in range(5)]
        app = _mod(pkg, "scheduler.core").AppResource("a", res)
        cluster = _cluster(pkg, n=2)
        cluster.pods = [_pod("pre", node="n-1")]
        steps = _mod(pkg, "shadow.record").record_simulation(cluster, [app])
        td = _mod(pkg, "twin.deltas")
        deltas = td.steps_to_deltas(steps)
        events = td.deltas_to_events(deltas, t0=2.0, spacing=0.5)
        ops = [td.from_shadow_op(op).as_record() for op in
               ({"op": "evict_pod", "namespace": "d", "name": "x", "node": "n-0"},
                {"op": "add_node", "node": make_fake_node("n-7", cpu="2", memory="4Gi")},
                {"op": "remove_node", "name": "n-7"})]
        outs.append(([d.as_record() for d in deltas], [e.as_record() for e in events], ops))
    assert outs[0] == outs[1]
    kinds = {e["event"] for e in outs[1][1]}
    assert "PodArrival" in kinds


def test_decision_commit_on_the_device_engine_equals_the_jax_package():
    """commit_decision through TorchEngine.commit_host (cuda engine, CPU
    device) and note_pending leave the JAX tpu engine's state."""
    sds = []
    for pkg in PKGS:
        td = _mod(pkg, "twin.deltas")
        engine, kw = ENGINES[pkg]
        app = td.MirrorApplicator(_cluster(pkg), engine=engine, **kw)
        assert app.engine is not None
        app.commit_decision(_pod("d0", cpu="2"), 1)
        app.commit_decision(_pod("d1", port=9000), 2)
        app.note_pending(_pod("d2", cpu="99"))
        app.apply(td.ClusterDelta.from_record(_evict("d0")))
        sds.append(td.state_dict(app))
    assert sds[0] == sds[1]
    assert sds[1]["pending"] == ["d/d2"]


def test_device_mirror_needs_a_card_or_the_cpu(monkeypatch):
    import torch

    from open_simulator_tpu_torch.ops.fused_scan import NoCardError
    from open_simulator_tpu_torch.twin.deltas import MirrorApplicator

    cluster = _cluster("open_simulator_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError, match="needs a GPU"):
        MirrorApplicator(cluster, engine="cuda")
    with pytest.raises(ValueError, match="unknown mirror engine"):
        MirrorApplicator(cluster, engine="tpu")
