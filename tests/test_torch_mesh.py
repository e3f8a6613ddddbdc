"""The GPU port's device mesh (`open_simulator_tpu_torch/parallel/mesh.py`)
against the JAX package's, exactly (tolerance 0), on the CPU:

- the layout planner's decision table (and its predicted-unfit route),
  spec parsing and `configure`, the axis tables and the node-axis
  padding;
- the node-sharded torch scan on an explicit 8-shard CPU mesh (one
  device repeated: the port's counterpart of the conftest's forced
  8-device JAX platform) equal to the unsharded torch scan and to the
  JAX package's `run_node_sharded` on its 8-device mesh: placements,
  unscheduled counts and utilisations, on a basic, a feature-rich
  (padded) and a pinned batch, through `TorchEngine.scan_active` with a
  custom score plugin, and at 100,000 nodes;
- the scenario axis (one batch-kernel launch a mesh device, here its
  plain version): `probe_many`, `probe_scenarios`, `scan_scenarios`,
  `sweep_node_counts(mesh=)` and `plan_defrag(mesh=)` equal to the
  unsharded answers and to the JAX package's sharded ones;
- the shard-aware workspace estimate, the ledger's per-device verdict
  and rows, the `/metrics` rows;
- the port's rules on the mesh: `jit.mesh_*=oom` halves a chunk and
  keeps the answer, any other injected fault propagates, and a shard
  that raises (or makes different exchanges) ends every shard thread.

The process-wide mesh selection of both packages, the ledger's watched
devices and the injection spec are restored after every test."""

import json
import threading

import numpy as np
import pytest

from open_simulator_tpu import testing as T
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.parallel import mesh as jmesh
from open_simulator_tpu_torch.models.validation import InputError
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.obs.ledger import LEDGER
from open_simulator_tpu_torch.parallel import mesh as pmesh
from open_simulator_tpu_torch.utils.trace import COUNTERS

JAX, PORT = "open_simulator_tpu", "open_simulator_tpu_torch"
SHARDS = 8
TIMEOUT = 60.0  # seconds a shard waits for its turn before the test fails


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _restore_process_state():
    from open_simulator_tpu_torch.runtime import inject

    saved = (dict(jmesh._STATE), dict(pmesh._STATE))
    watched, rows = list(LEDGER._watched), dict(LEDGER._rows)
    pmesh._STATE["cache"] = {}
    yield
    jmesh._STATE.clear()
    jmesh._STATE.update(saved[0])
    pmesh._STATE.clear()
    pmesh._STATE.update(saved[1])
    pmesh._STATE["cache"] = {}
    LEDGER._watched[:] = watched
    LEDGER._rows.clear()
    LEDGER._rows.update(rows)
    inject.INJECT.configure("")


def _port_mesh(shards=SHARDS, device="cpu"):
    return pmesh.Mesh([device] * shards)


def _jax_mesh():
    mesh = jmesh.mesh_from_spec("auto")
    assert mesh is not None and mesh.devices.size == SHARDS
    return mesh


# ------------------------------------------------------------- fixtures


def _node(name, cpu="4", mem="8Gi"):
    return {"kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}}}


def _deploy(name, replicas, cpu="1", mem="1Gi"):
    return {"kind": "Deployment",
            "metadata": {"name": name, "namespace": "cap", "labels": {"app": name}},
            "spec": {"replicas": replicas, "template": {"spec": {"containers": [
                {"name": "c", "image": "i",
                 "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}}}


def _basic(pkg, n_base=6, replicas=24, max_count=6):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [_node(f"base-{i}") for i in range(n_base)]
    res = _mod(pkg, "models.decode").ResourceTypes()
    res.deployments = [_deploy("web", replicas)]
    return cluster, [_mod(pkg, "scheduler.core").AppResource("cap", res)], _node("template"), \
        max_count


def _feature_rich(pkg):
    """inter-pod anti-affinity, hard and soft topology spread, hostPorts,
    open-local storage and taints over 15 nodes (not a multiple of 8:
    the node axis pads)."""
    nodes = []
    for i in range(10):
        opts = [T.with_node_labels({"zone": f"z{i % 3}"})]
        if i % 3 == 0:
            opts.append(T.with_node_local_storage([{"name": "vg1", "capacity": "100Gi"}]))
        if i % 5 == 0:
            opts.append(T.with_node_taints([{"key": "dedicated", "value": "x",
                                             "effect": "PreferNoSchedule"}]))
        nodes.append(T.make_fake_node(f"n{i:02d}", "8", "16Gi", *opts))
    res = _mod(pkg, "models.decode").ResourceTypes()
    res.stateful_sets = [T.make_fake_stateful_set(
        "ss", "d", 6, "500m", "512Mi", T.with_labels({"app": "ss"}),
        T.with_affinity({"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "ss"}},
             "topologyKey": "kubernetes.io/hostname"}]}}))]
    dep = T.make_fake_deployment("web", "d", 12, "1", "1Gi", T.with_labels({"app": "web"}))
    dep["spec"]["template"]["spec"]["topologySpreadConstraints"] = [
        {"maxSkew": 2, "topologyKey": "zone", "whenUnsatisfiable": "DoNotSchedule",
         "labelSelector": {"matchLabels": {"app": "web"}}},
        {"maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "ScheduleAnyway",
         "labelSelector": {"matchLabels": {"app": "web"}}}]
    porty = T.make_fake_deployment("porty", "d", 4, "100m", "128Mi")
    porty["spec"]["template"]["spec"]["containers"][0]["ports"] = [
        {"hostPort": 8080, "containerPort": 8080}]
    lvm = T.make_fake_deployment("lvm", "d", 3, "100m", "128Mi", T.with_annotations({
        "simon/pod-local-storage": json.dumps({"volumes": [
            {"kind": "LVM", "size": str(5 * 1024**3), "scName": "open-local-lvm"}]})}))
    res.deployments = [dep, porty, lvm]
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = nodes
    tpl = T.make_fake_node("template", "8", "16Gi", T.with_node_labels({"zone": "z1"}))
    return cluster, [_mod(pkg, "scheduler.core").AppResource("d", res)], tpl, 5


def _sweeps(build, **kw):
    """(JAX sweep, port sweep on the CPU) of one case, name counters
    reset before each."""
    jax_reset()
    js = _mod(JAX, "parallel.sweep").CapacitySweep(*build(JAX, **kw))
    port_reset()
    ps = _mod(PORT, "parallel.sweep").CapacitySweep(*build(PORT, **kw), device="cpu")
    return js, ps


def _node_case(case):
    """(JAX sweep, port sweep, [(valid, active, pinned, features of both)])."""
    if case == "feature-rich":
        js, ps = _sweeps(_feature_rich)
        assert ps.features.ipa and ps.features.hard_spread and ps.features.soft_spread
        assert ps.features.ports and ps.features.storage and ps.n % SHARDS
        counts = (0, 3, 5)
    else:
        js, ps = _sweeps(_basic, n_base=7 if case == "pinned" else 6,
                         replicas=20 if case == "pinned" else 24,
                         max_count=4 if case == "pinned" else 6)
        counts = (2,) if case == "pinned" else (0, 2, 5, 6)
    runs = []
    for c in counts:
        valid = ps.node_valid(c)
        active = ps.pod_active(valid)
        pinned = np.asarray(ps.batch.pinned_node).copy()
        jf, pf = js.features, ps.features
        if case == "pinned":
            # the chaos substrate's pinned pass: every third pod pinned
            # to node 2, only the pinned pods active
            pinned[::3] = 2
            active = active & (pinned >= 0)
            jf, pf = jf._replace(pins=True), pf._replace(pins=True)
        runs.append((valid, active, pinned, jf, pf))
    return js, ps, runs


# ------------------------------------------------------- layout planner


def _decisions(mod, mesh):
    thr = mod.node_threshold()
    cases = [dict(mesh=None, n_scenarios=8, n_nodes=100),
             dict(mesh=mesh, n_scenarios=8, n_nodes=100, sample=True),
             dict(mesh=mesh, n_scenarios=2, n_nodes=100),
             dict(mesh=mesh, n_scenarios=1, n_nodes=100),
             dict(mesh=mesh, n_scenarios=1, n_nodes=thr),
             dict(mesh=mesh, n_scenarios=1, n_nodes=4)]
    return [tuple(vars(mod.plan_layout("t", **c)).values()) for c in cases]


def test_plan_layout_decision_table_equals_the_jax_planner():
    got = _decisions(pmesh, _port_mesh())
    assert got == _decisions(jmesh, _jax_mesh())
    assert [g[:2] for g in got] == [("none", 1), ("none", 1), ("scenario", 8), ("none", 1),
                                    ("node", 8), ("none", 1)]
    assert pmesh.plan_layout("t", mesh=_port_mesh(1), n_scenarios=8,
                             n_nodes=100).reason == "mesh has a single device"


def test_plan_layout_node_axis_on_predicted_unfit(monkeypatch):
    """A single scenario whose declared workspace the ledger says will
    not fit on one device takes the node axis below the threshold; the
    planning probe counts no prediction."""
    from open_simulator_tpu_torch.obs.costs import COSTS

    site = "planner_unfit_fixture"
    COSTS.declare_bytes(site, 1000)
    monkeypatch.setenv("SIMON_DEVICE_MEM_BUDGET", "1000")
    preds = COUNTERS.get("ledger_predictions_total")
    d = pmesh.plan_layout(site, mesh=_port_mesh(), n_scenarios=1, n_nodes=100)
    assert (d.axis, d.shards) == ("node", SHARDS)
    assert d.reason == "ledger predicts 1000 bytes will not fit on one device"
    assert COUNTERS.get("ledger_predictions_total") == preds
    monkeypatch.setenv("SIMON_DEVICE_MEM_BUDGET", str(10**9))
    assert pmesh.plan_layout(site, mesh=_port_mesh(), n_scenarios=1,
                             n_nodes=100).axis == "none"


@pytest.mark.parametrize("spec", [None, "off", "", "0", "none", "auto", "AUTO", "1", "4",
                                  "many", "-2", "1.5"])
def test_spec_parsing_equals_the_jax_parser(spec):
    def parse(mod):
        try:
            return mod.parse_mesh_spec(spec)
        except ValueError as e:
            return f"{type(e).__name__}: {e}"

    assert parse(pmesh) == parse(jmesh)


def test_mesh_from_spec_configure_and_current_mesh(monkeypatch):
    # the CPU is one device: auto and 1 are no mesh, 2 is too many
    assert pmesh.mesh_from_spec("auto", "cpu") is None
    assert pmesh.mesh_from_spec("1", "cpu") is None
    assert pmesh.mesh_from_spec("off", "cpu") is None
    with pytest.raises(InputError, match=r"--mesh 2: only 1 local device\(s\) available"):
        pmesh.mesh_from_spec("2", "cpu")
    with pytest.raises(InputError):
        pmesh.configure("many")
    # the same rules over N devices (cards on a machine with several)
    monkeypatch.setattr(pmesh, "local_devices", lambda device=None: [
        pmesh.torch.device("cuda", i) for i in range(4)])
    assert [str(d) for d in pmesh.mesh_from_spec("auto").devices] == [
        f"cuda:{i}" for i in range(4)]
    assert pmesh.mesh_from_spec("2").size == 2
    with pytest.raises(InputError, match=r"only 4 local device"):
        pmesh.mesh_from_spec("5")
    pmesh.configure("3")
    assert pmesh.current_mesh().size == 3
    pmesh.configure(None)
    monkeypatch.setenv("SIMON_MESH", "auto")
    assert pmesh.current_mesh().size == 4
    monkeypatch.setenv("SIMON_MESH", "off")
    assert pmesh.current_mesh() is None
    assert pmesh.effective_parallelism(pmesh.mesh_from_spec("auto")) == 4
    assert pmesh.effective_parallelism(_port_mesh()) == 1  # one CPU repeated
    assert pmesh.effective_parallelism(None) == 1


def test_axis_tables_cover_every_scan_field_and_equal_the_jax_tables():
    """Every port ScanStatic/ScanState field with a node axis is in the
    tables at that axis (found by encoding a 13-node cluster), and the
    tables are the JAX package's."""
    from open_simulator_tpu_torch.ops.scan import ScanState, ScanStatic

    assert pmesh._STATIC_NODE_AXIS == jmesh._STATIC_NODE_AXIS
    assert pmesh._STATE_NODE_AXIS == jmesh._STATE_NODE_AXIS
    assert pmesh._PAD_NEG1 == jmesh._PAD_NEG1
    assert set(pmesh._STATIC_NODE_AXIS) <= set(ScanStatic._fields)
    assert set(pmesh._STATE_NODE_AXIS) <= set(ScanState._fields)
    port_reset()
    cluster, apps, tpl, _ = _feature_rich(PORT)
    cluster.nodes = cluster.nodes + [_node(f"x{i}") for i in range(3)]
    ps = _mod(PORT, "parallel.sweep").CapacitySweep(cluster, apps, tpl, 0, device="cpu")
    static, init = ps._scan_static_state()
    assert ps.n == 13
    for tup, table in ((static, pmesh._STATIC_NODE_AXIS), (init, pmesh._STATE_NODE_AXIS)):
        for name in tup._fields:
            t = getattr(tup, name)
            if t is None:
                continue
            axes = [i for i, d in enumerate(t.shape) if d == 13]
            assert axes[-1:] == ([table[name]] if name in table else []), name


def test_padding_equals_the_jax_padding():
    js, ps, _runs = _node_case("feature-rich")
    static, init = ps._scan_static_state()
    for pad, jpad, tup, jtup, table in (
            (pmesh.pad_static, jmesh.pad_static, static, js.static, pmesh._STATIC_NODE_AXIS),
            (pmesh.pad_state, jmesh.pad_state, init, js.init, pmesh._STATE_NODE_AXIS)):
        got, want = pad(tup, SHARDS), jpad(jtup, SHARDS)
        for name in table:
            a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert a.shape == b.shape and (a == b).all(), name
    valid = ps.node_valid(3)
    assert (pmesh.pad_valid(valid, SHARDS) == jmesh.pad_valid(valid, SHARDS)).all()
    assert pmesh.padded_node_count(15, 8) == jmesh.padded_node_count(15, 8) == 16


# ------------------------------------------------------------- node axis


@pytest.mark.parametrize("case", ["basic", "feature-rich", "pinned"])
def test_node_sharded_scan_equals_unsharded_and_the_jax_mesh(case):
    js, ps, runs = _node_case(case)
    static, init = ps._scan_static_state()
    mesh, jm = _port_mesh(), _jax_mesh()
    for valid, active, pinned, jf, pf in runs:
        launches = COUNTERS.get("launches_mesh_scan")
        got = pmesh.run_node_sharded(mesh, static, init, ps.batch.class_of_pod, pinned, valid,
                                     active, pf, timeout=TIMEOUT)
        assert COUNTERS.get("launches_mesh_scan") == launches + 1
        want = jmesh.run_node_sharded(jm, js.static, js.init, js.batch.class_of_pod, pinned,
                                      valid, active, jf)
        ps.features, saved = pf, ps.features
        try:
            plain = ps._torch_scan(valid, active, pinned)
        finally:
            ps.features = saved
        assert (got[0] == plain[0]).all() and (got[0] == np.asarray(want[0])).all()
        assert got[1:] == tuple(plain[1:]) == tuple(want[1:])
        if case == "pinned":
            assert (got[0][pinned >= 0] == 2).all()


def test_engine_scan_active_takes_the_node_route_with_a_custom_plugin(monkeypatch):
    """A custom-score-plugin batch (the torch scan's) past the node
    threshold rides the node-sharded scan through scan_active: one
    mesh_scan launch, the placements of the unsharded engine and of the
    JAX engine on its mesh. A kernel batch never does."""
    from test_torch_apply import _name_plugin

    monkeypatch.setenv("SIMON_MESH_NODE_THRESHOLD", "4")
    regs = [_mod(pkg, "scheduler.plugins").default_registry for pkg in (JAX, PORT)]
    for pkg, reg in zip((JAX, PORT), regs):
        reg.clear()
        reg.register(_name_plugin(pkg, 3))
    try:
        nodes = [T.make_fake_node(f"n{i}", "8", "16Gi") for i in range(9)]
        pods = [T.make_fake_pod(f"p{i}", "d", "500m", "512Mi") for i in range(20)]

        def run(pkg, engine_cls, mesh, **kw):
            eng = getattr(_mod(pkg, "scheduler.engine"), engine_cls)(
                _mod(pkg, "scheduler.oracle").Oracle([dict(n) for n in nodes]), **kw)
            eng.mesh = mesh
            if mesh is None and pkg == JAX:
                eng._mesh_retired = True
            eng.begin_batch([json.loads(json.dumps(p)) for p in pods])
            return np.asarray(eng.scan_active(np.ones(len(pods), bool)))

        launches = COUNTERS.get("launches_mesh_scan")
        got = run(PORT, "TorchEngine", _port_mesh(), device="cpu")
        assert COUNTERS.get("launches_mesh_scan") == launches + 1
        plain = run(PORT, "TorchEngine", None, device="cpu")
        want = run(JAX, "TpuEngine", _jax_mesh())
        assert (got == plain).all() and (got == want).all()
        assert (got >= 0).all()
    finally:
        for reg in regs:
            reg.clear()
    # without the plugin the batch is the kernel's: no node route
    launches = COUNTERS.get("launches_mesh_scan")
    run(PORT, "TorchEngine", _port_mesh(), device="cpu")
    assert COUNTERS.get("launches_mesh_scan") == launches


def test_100k_node_capacity_probe_on_the_8_shard_mesh():
    """The JAX package's acceptance-scale probe (tests/test_mesh.py):
    100,000 nodes x 48 pods through the node-sharded scan on the 8-shard
    mesh, equal to the port's unsharded torch scan."""
    n = 100_000
    cluster = _mod(PORT, "models.decode").ResourceTypes()
    cluster.nodes = [T.make_fake_node(f"n{i:06d}", "8", "16Gi") for i in range(n)]
    res = _mod(PORT, "models.decode").ResourceTypes()
    res.deployments = [T.make_fake_deployment("web", "d", 48, "2", "2Gi")]
    port_reset()
    sweep = _mod(PORT, "parallel.sweep").CapacitySweep(
        cluster, [_mod(PORT, "scheduler.core").AppResource("d", res)], None, 0, device="cpu")
    static, init = sweep._scan_static_state()
    valid = sweep.node_valid(0)
    active = sweep.pod_active(valid)
    got = pmesh.run_node_sharded(_port_mesh(), static, init, sweep.batch.class_of_pod,
                                 sweep.batch.pinned_node, valid, active, sweep.features,
                                 timeout=TIMEOUT)
    want = sweep._torch_scan(valid, active, sweep.batch.pinned_node)
    assert (got[0] == want[0]).all() and got[1:] == tuple(want[1:])
    assert got[1] == 0


def test_sweep_probe_takes_the_node_route_for_a_torch_scan_batch(monkeypatch):
    """CapacitySweep.probe of a torch-scan batch asks the planner
    (site sweep_probe) and rides the node-sharded scan when it picks
    the node axis: the probe of the unsharded sweep, to the bit."""
    from test_torch_apply import _name_plugin

    monkeypatch.setenv("SIMON_MESH_NODE_THRESHOLD", "4")
    reg = _mod(PORT, "scheduler.plugins").default_registry
    reg.clear()
    reg.register(_name_plugin(PORT, 2))
    try:
        port_reset()
        ps = _mod(PORT, "parallel.sweep").CapacitySweep(*_basic(PORT), device="cpu")
        assert ps.plan is None
        plain = [ps.probe(c) for c in (1, 4)]
        ps.mesh = _port_mesh()
        node = COUNTERS.get("mesh_layout_node_total")
        got = [ps.probe(c) for c in (1, 4)]
        assert COUNTERS.get("mesh_layout_node_total") == node + 2
    finally:
        reg.clear()
    for g, w in zip(got, plain):
        assert (g.placements == w.placements).all()
        assert (g.unscheduled, g.cpu_util, g.mem_util, g.vg_util) == (
            w.unscheduled, w.cpu_util, w.mem_util, w.vg_util)


# --------------------------------------------------------- scenario axis


def _rows(ps, sc):
    valids = np.stack([ps.node_valid(c % (ps.max_count + 1)) for c in range(sc)])
    actives = np.stack([ps.pod_active(v) for v in valids])
    pins = np.tile(np.asarray(ps.batch.pinned_node), (sc, 1))
    # an outage row: the first base node down, its pods free
    valids[1, 0] = False
    return valids, actives, pins


def _scenario_case(kind):
    """(port sharded, launches it made, port unsharded, JAX sharded)."""
    if kind == "probe_many":
        js, ps = _sweeps(_basic, n_base=4, replicas=26, max_count=7)
        counts = list(range(7))

        def port(mesh):
            ps.mesh = mesh
            r = ps.probe_many(counts)
            return r.placements, r.unscheduled, r.cpu_util, r.mem_util, r.vg_util

        js.mesh = _jax_mesh()
        r = js.probe_many(counts)
        want = (r.placements, r.unscheduled, r.cpu_util, r.mem_util, r.vg_util)
        return port, "launches_sweep_many", want
    if kind == "probe_scenarios":
        js, ps = _sweeps(_basic, n_base=8, replicas=30, max_count=8)
        rows = _rows(ps, 6)

        def port(mesh):
            ps.mesh = mesh
            return ps.probe_scenarios(*rows, site="chaos")

        js.mesh = _jax_mesh()
        return port, "launches_mesh_chaos_sweep", js.probe_scenarios(*rows, site="chaos")
    if kind == "scan_scenarios":
        nodes = [T.make_fake_node(f"n{i}", "8", "16Gi") for i in range(6)]
        pods = [T.make_fake_pod(f"p{i}", "d", "500m", "512Mi") for i in range(18)]
        actives = np.zeros((5, len(pods)), bool)
        for i in range(5):
            actives[i, : 3 * (i + 1)] = True

        def engine(pkg, cls, mesh, **kw):
            eng = getattr(_mod(pkg, "scheduler.engine"), cls)(
                _mod(pkg, "scheduler.oracle").Oracle([dict(n) for n in nodes]), **kw)
            eng.mesh = mesh
            eng.begin_batch([json.loads(json.dumps(p)) for p in pods])
            return eng

        def port(mesh):
            return (engine(PORT, "TorchEngine", mesh, device="cpu").scan_scenarios(actives),)

        return port, "launches_scenario_scan", (
            engine(JAX, "TpuEngine", _jax_mesh()).scan_scenarios(actives),)
    if kind == "sweep_node_counts":
        def port(mesh):
            port_reset()
            r = _mod(PORT, "parallel.sweep").sweep_node_counts(
                *_basic(PORT)[:3], list(range(6)), mesh=mesh, device="cpu")
            return r.placements, r.unscheduled, r.cpu_util, r.mem_util

        jax_reset()
        r = _mod(JAX, "parallel.sweep").sweep_node_counts(
            *_basic(JAX)[:3], list(range(6)), mesh=_jax_mesh())
        return port, "launches_sweep_many", (r.placements, r.unscheduled, r.cpu_util,
                                             r.mem_util)
    if kind == "plan_defrag":
        from test_torch_defrag import _snapshot, _view

        nodes = [T.make_fake_node(f"node-{i}", "8", "32Gi") for i in range(6)]
        placed = {i: [T.make_fake_pod(f"p{i}-{k}", "d", f"{1 + (i + k) % 3}", "1Gi")
                      for k in range(2 if i % 2 else 1)] for i in range(6)}

        def port(mesh):
            return (_view(_mod(PORT, "parallel.defrag").plan_defrag(
                _snapshot(PORT, nodes, placed), mesh=mesh, device="cpu")),)

        return port, "launches_defrag_sweep", (_view(_mod(JAX, "parallel.defrag").plan_defrag(
            _snapshot(JAX, nodes, placed), mesh=_jax_mesh())),)
    raise KeyError(kind)


def _same(a, b):
    a, b = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
    return a.shape == b.shape and all(x == y for x, y in zip(a.reshape(-1), b.reshape(-1)))


@pytest.mark.parametrize("kind", ["probe_many", "probe_scenarios", "scan_scenarios",
                                  "sweep_node_counts", "plan_defrag"])
def test_scenario_axis_is_one_launch_a_shard_and_equals_the_jax_mesh(kind):
    port, site, want = _scenario_case(kind)
    plain = port(None)
    launches = COUNTERS.get(site)
    got = port(_port_mesh(3))
    assert COUNTERS.get(site) - launches == 3, "one batch launch a mesh device"
    for g, p, w in zip(got, plain, want):
        assert _same(g, p) and _same(g, w)


def test_more_shards_than_rows_launch_only_the_rows():
    js, ps = _sweeps(_basic, n_base=4, replicas=10, max_count=3)
    plain = ps.probe_many([1, 2])
    ps.mesh = _port_mesh()
    launches = COUNTERS.get("launches_sweep_many")
    got = ps.probe_many([1, 2])
    assert COUNTERS.get("launches_sweep_many") - launches == 2
    assert (got.placements == plain.placements).all()
    shares = pmesh.shard_scenario_rows(_port_mesh(3), [np.arange(8)])
    assert [(lo, hi) for _d, lo, hi, _a in shares] == [(0, 3), (3, 6), (6, 8)]


# ------------------------------------------- shard-aware cost and ledger


def test_estimate_bytes_divides_the_rows_by_the_shards():
    from open_simulator_tpu_torch.obs.costs import COSTS, workspace_bytes

    port_reset()
    ps = _mod(PORT, "parallel.sweep").CapacitySweep(*_basic(PORT), device="cpu")
    p = len(ps.pods)
    est = COSTS.chunk_estimator("shard_estimate_fixture", ps.plan, p, shards=8)
    assert est(0, 64) == workspace_bytes(ps.plan, p, 8)
    assert COSTS.estimate_bytes("shard_estimate_fixture", 64) == workspace_bytes(ps.plan, p, 64)
    assert COSTS.estimate_bytes("shard_estimate_fixture", 9, shards=8) == workspace_bytes(
        ps.plan, p, 2)
    assert est(0, 64) < COSTS.estimate_bytes("shard_estimate_fixture", 64)


def _fake_cards(monkeypatch, in_use):
    """Allocator stats for fake cards cuda:i: `in_use[i]` bytes of a
    1000-byte limit."""
    from open_simulator_tpu_torch.obs import ledger

    def stats(device=None):
        if device is None or pmesh.torch.device(device).type != "cuda":
            return 0, 0, None, "none"
        i = pmesh.torch.device(device).index
        return in_use[i], in_use[i], 1000, "cuda_allocator"

    monkeypatch.setattr(ledger, "device_memory_stats", stats)
    return pmesh.Mesh([f"cuda:{i}" for i in range(len(in_use))])


def test_predict_fit_shards_uses_the_tightest_device(monkeypatch):
    """The JAX package's rule: a per-device estimate against the
    tightest mesh device's room (0.92 x 1000 - 600 = 320 bytes)."""
    mesh = _fake_cards(monkeypatch, [100] * 7 + [600])
    LEDGER.watch(mesh.devices)
    assert LEDGER.predict_fit(300, shards=8) is True
    assert LEDGER.predict_fit(400, shards=8) is False
    assert LEDGER.predict_fit(400, shards=2) is False
    assert LEDGER.would_fit(400, device="cuda:0") is True


def test_ledger_polls_every_mesh_device_and_metrics_export_them(monkeypatch):
    """The layout planner watches its mesh's cards; every poll reads
    each one, the ledger's rows and /metrics carry one row a device, and
    /metrics exports the planner's counters with the JAX help texts."""
    from open_simulator_tpu.serve import server as jserver
    from open_simulator_tpu_torch.serve import server as pserver

    mesh = _fake_cards(monkeypatch, [10, 20, 30])
    pmesh.plan_layout("scan", mesh=mesh, n_scenarios=2, n_nodes=10)
    LEDGER.poll()
    rows = {r["device"]: r["in_use"] for r in LEDGER.device_summary()}
    assert {d: rows[d] for d in ("cuda:0", "cuda:1", "cuda:2")} == {
        "cuda:0": 10, "cuda:1": 20, "cuda:2": 30}
    assert "per_device" in LEDGER.summary()
    text = "\n".join(pserver._observatory_lines(
        {"counts": COUNTERS.snapshot()["counts"], "gauges": {}}))
    for i in range(3):
        assert f'simon_device_mem_device_bytes_in_use{{device="cuda:{i}"}} {10 * (i + 1)}' in text
    jtext = "\n".join(jserver._observatory_lines({"counts": {}, "gauges": {}}))
    for axis in ("scenario", "node", "none"):
        help_line = next(ln for ln in jtext.splitlines()
                         if ln.startswith(f"# HELP simon_mesh_layout_{axis}_total"))
        assert help_line in text.splitlines()
        assert f"\nsimon_mesh_layout_{axis}_total " in "\n" + text


# ------------------------------------------------- the port's fault rules


def test_mesh_oom_halves_the_chunk_and_keeps_the_answer():
    from open_simulator_tpu_torch.runtime import inject

    js, ps = _sweeps(_basic, n_base=8, replicas=30, max_count=8)
    rows = _rows(ps, 6)
    plain = ps.probe_scenarios(*rows, site="chaos")
    ps.mesh = _port_mesh(2)
    reactive = COUNTERS.get("guard_oom_reactive_total")
    inject.INJECT.configure("jit.mesh_chaos_sweep=oom@1")
    got = ps.probe_scenarios(*rows, site="chaos")
    assert COUNTERS.get("guard_oom_reactive_total") == reactive + 1
    for g, p in zip(got, plain):
        assert _same(g, p)


@pytest.mark.parametrize("site,fault", [("mesh_chaos_sweep", "compile"),
                                        ("mesh_chaos_sweep", "backend"),
                                        ("mesh_scan", "error"),
                                        ("mesh_scan", "oom")])
def test_a_fault_on_the_mesh_propagates(site, fault):
    """No downgrade to one device: a non-memory fault on a sharded
    launch, and an OOM of the node-sharded scan (nothing to halve),
    raise."""
    import torch

    from open_simulator_tpu_torch.runtime import inject

    js, ps, runs = _node_case("basic")
    inject.INJECT.configure(f"jit.{site}={fault}@1")
    if site == "mesh_scan":
        static, init = ps._scan_static_state()
        valid, active, pinned, _jf, pf = runs[0]
        with pytest.raises((RuntimeError, torch.cuda.OutOfMemoryError)):
            pmesh.run_node_sharded(_port_mesh(2), static, init, ps.batch.class_of_pod, pinned,
                                   valid, active, pf, timeout=TIMEOUT)
    else:
        ps.mesh = _port_mesh(2)
        with pytest.raises(RuntimeError):
            ps.probe_scenarios(*_rows(ps, 4), site="chaos")


def _no_shard_threads():
    return not [t for t in threading.enumerate() if t.name.startswith("mesh-shard-")]


def test_a_shard_that_raises_ends_every_shard(monkeypatch):
    """A shard that raises mid-scan: the error propagates, every other
    shard stops at its next turn, and no thread is left."""
    from open_simulator_tpu_torch.ops import scan as scan_ops

    js, ps, runs = _node_case("basic")
    static, init = ps._scan_static_state()
    valid, active, pinned, _jf, pf = runs[0]
    real = scan_ops._minmax_normalize

    def boom(raw, feasible, ctx=scan_ops.LOCAL_CTX):
        if getattr(ctx, "rank", 0) == 5 and getattr(ctx, "_ex")._rounds[5] > 20:
            raise ValueError("shard 5 fails mid-scan")
        return real(raw, feasible, ctx)

    monkeypatch.setattr(scan_ops, "_minmax_normalize", boom)
    with pytest.raises(ValueError, match="shard 5 fails"):
        pmesh.run_node_sharded(_port_mesh(), static, init, ps.batch.class_of_pod, pinned,
                               valid, active, pf, timeout=TIMEOUT)
    assert _no_shard_threads()


def test_shards_that_make_different_exchanges_fail_without_a_hang(monkeypatch):
    """A step that decided something on a shard's own nodes would make
    the shards' exchanges differ: the scan raises ShardMismatch, at
    once, and no thread is left."""
    js, ps, runs = _node_case("basic")
    static, init = ps._scan_static_state()
    valid, active, pinned, _jf, pf = runs[0]
    real = pmesh._ShardCtx.combine_any
    made = []

    def extra(self, x):
        if self.rank == 3 and self._ex._rounds[3] > 5 and not made:
            made.append(real(self, x))  # one exchange more on shard 3 only
        return real(self, x)

    monkeypatch.setattr(pmesh._ShardCtx, "combine_any", extra)
    with pytest.raises(pmesh.ShardMismatch, match="exchanges differ"):
        pmesh.run_node_sharded(_port_mesh(), static, init, ps.batch.class_of_pod, pinned,
                               valid, active, pf, timeout=TIMEOUT)
    assert made and _no_shard_threads()


def test_sample_mode_never_rides_the_node_axis():
    js, ps, runs = _node_case("basic")
    static, init = ps._scan_static_state()
    valid, active, pinned, _jf, pf = runs[0]
    with pytest.raises(InputError, match="sample-mode"):
        pmesh.run_node_sharded(_port_mesh(2), static, init, ps.batch.class_of_pod, pinned,
                               valid, active, pf._replace(sample=True))
