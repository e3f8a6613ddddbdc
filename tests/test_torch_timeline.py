"""The GPU port's discrete-event timeline (`open_simulator_tpu_torch` ->
timeline/, `simon timeline`) against the JAX package's, exactly.

The inputs of tests/test_timeline.py go through both packages: the event
heap, synthetic traces (bytes and fingerprints), trace files read across
packages, policy parsing, and every stepper scenario, whose report the
port computes twice — on the cuda engine with `device="cpu"` (each
window one batch of the kernel's plain version, pins first) and on the
serial oracle — and both must equal the JAX package's `tpu` report with
only `engine` set aside, with the same placements. The CLI's four cases
(a policy comparison, a `--save-trace` / `--trace` round trip across the
packages, `--from-decision-log`, the input errors) print the JAX bytes
but for the engine's name; a journaled run resumes with zero launches;
a halted run prints the JAX partial report; an injected OOM halves a
window's chunk to the same report."""

import contextlib
import copy
import importlib
import io
import json

import numpy as np
import pytest
import yaml

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset

JAX, PORT = "open_simulator_tpu", "open_simulator_tpu_torch"
PKGS = (JAX, PORT)
QUICKSTART = "example/simon-config.yaml"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _node(name, cpu="4", mem="8Gi"):
    return {"kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}}}


def _pod(name, cpu="1", mem="1Gi", node_name=None, ns="tl"):
    pod = {"kind": "Pod", "metadata": {"name": name, "namespace": ns},
           "spec": {"containers": [{"name": "c", "image": "i",
                                    "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}
    if node_name:
        pod["spec"]["nodeName"] = node_name
    return pod


def _ev(time, kind, seq, **kw):
    rec = {"kind": "event", "event": kind, "time": float(time), "seq": seq}
    rec.update(kw)
    return rec


def _arrivals(n, t0=1.0, dt=1.0, cpu="1"):
    return [_ev(t0 + i * dt, "PodArrival", i, pod=_pod(f"p{i:03d}", cpu=cpu)) for i in range(n)]


def _events(pkg, recs):
    ev_t = _mod(pkg, "timeline.events").Event
    return [ev_t.from_record(copy.deepcopy(r)) for r in recs]


def _cluster(pkg, n, cpu="4"):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [_node(f"base-{i}", cpu=cpu) for i in range(n)]
    return cluster


TPL = _node("tpl")

# the stepper scenarios of tests/test_timeline.py: (base nodes, base
# node cpu, event records, policies, run_policies kwargs)
SCENARIOS = {
    "determinism": (3, "4", _arrivals(12) + [
        _ev(20.0, "SpotReclaim", 12, nodeName="base-2", reason="hazard")],
        ["threshold"], dict(new_node_spec=TPL, max_nodes=2, cadence_s=8.0, warmup_s=4.0)),
    "windowed-vs-serial": (3, "4", _arrivals(10) + [
        _ev(12.0, "PodDeparture", 10, podRef="tl/p002"),
        _ev(14.0, "SpotReclaim", 11, nodeName="base-1"),
        _ev(15.0, "PodArrival", 12, pod=_pod("late"))],
        ["static:1", "threshold"], dict(new_node_spec=TPL, max_nodes=2, cadence_s=6.0,
                                        warmup_s=3.0)),
    "spot-reclaim": (3, "4", _arrivals(9) + [
        _ev(60.0, "SpotReclaim", 9, nodeName="base-1", reason="hazard")],
        ["static:0"], dict(cadence_s=1e6)),
    "departure": (1, "2500m", [
        _ev(1.0, "PodArrival", 0, pod=_pod("a")), _ev(2.0, "PodArrival", 1, pod=_pod("b")),
        _ev(3.0, "PodArrival", 2, pod=_pod("c")),
        _ev(10.0, "PodDeparture", 3, podRef="tl/a"),
        _ev(20.0, "PodArrival", 4, pod=_pod("d", cpu="250m"))],
        ["static:0"], dict(cadence_s=5.0)),
    "join-drain": (1, "4", _arrivals(8) + [
        _ev(20.0, "NodeJoin", 8, node=_node("joiner"), reason="churn"),
        _ev(40.0, "NodeDrain", 9, nodeName="base-0")],
        ["static:0"], {}),
    "threshold-warmup": (1, "4", _arrivals(10) + [
        _ev(30 + i, "PodDeparture", 10 + i, podRef=f"tl/p{i:03d}") for i in range(10)] + [
        _ev(200.0, "PodArrival", 20, pod=_pod("late", cpu="100m"))],
        ["threshold:lo=40,patience=2", "static:0"],
        dict(new_node_spec=TPL, max_nodes=4, cadence_s=5.0, warmup_s=2.0)),
    "probe": (1, "4", _arrivals(12), ["probe"],
              dict(new_node_spec=TPL, max_nodes=4, cadence_s=6.0)),
    "profile-groups": (2, "4", _arrivals(6), ["static:0", "static:0@nospread"], {}),
    "recorded-decision": (2, "4", [
        _ev(1.0, "PodArrival", 0, pod=_pod("pre", node_name="base-1"), reason="prebound"),
        _ev(2.0, "AutoscaleDecision", 1, delta=2, reason="trace")] + [
        _ev(3.0 + i, "PodArrival", 2 + i, pod=_pod(f"q{i}", cpu="3")) for i in range(5)],
        ["static:0", "probe"], dict(new_node_spec=TPL, max_nodes=3, cadence_s=4.0,
                                    window_arrivals=2)),
}


def _run_policies(pkg, case, engine, **extra):
    n, cpu, recs, specs, kw = SCENARIOS[case]
    ta = _mod(pkg, "timeline.autoscaler")
    kw = dict(copy.deepcopy(kw), **extra)
    if pkg == PORT:
        kw["device"] = "cpu"
    return _mod(pkg, "timeline.compare").run_policies(
        _cluster(pkg, n, cpu), _events(pkg, recs), ta.parse_policies(specs), engine=engine, **kw)


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_windows_on_the_plain_version_and_the_oracle_equal_the_jax_rows(case):
    """The port's cuda engine (the batch kernel's plain version, pins
    first) and its serial oracle both print the JAX package's `tpu`
    report (samples, decisions, displacement, windows, dispatches) and
    text, only the engine's name aside."""
    want = _run_policies(JAX, case, "tpu")
    wdoc = want.as_dict()
    assert wdoc.pop("engine") == "tpu"
    for engine in ("cuda", "oracle"):
        got = _run_policies(PORT, case, engine)
        doc = got.as_dict()
        assert doc.pop("engine") == engine
        assert doc == wdoc, engine
        assert got.render_text().replace(f"engine {engine}", "engine tpu") == \
            want.render_text()


def _stepper(pkg, case, engine):
    n, cpu, recs, specs, kw = SCENARIOS[case]
    kw = copy.deepcopy(kw)
    if pkg == PORT:
        kw["device"] = "cpu"
    st = _mod(pkg, "timeline.stepper").TimelineStepper(
        _cluster(pkg, n, cpu), _events(pkg, recs),
        _mod(pkg, "timeline.autoscaler").parse_policies(specs), engine=engine, **kw)
    st.run()
    return st


@pytest.mark.parametrize("case", ["windowed-vs-serial", "spot-reclaim", "recorded-decision"])
def test_final_placements_equal_the_jax_stepper(case):
    want = _stepper(JAX, case, "tpu")
    for engine in ("cuda", "oracle"):
        got = _stepper(PORT, case, engine)
        for a, b in zip(got.states, want.states):
            np.testing.assert_array_equal(a.placed, b.placed)
            np.testing.assert_array_equal(a.node_up, b.node_up)
        assert (got.windows, got.dispatches) == (want.windows, want.dispatches)


def test_each_window_is_one_launch_of_the_timeline_site():
    """On the cuda engine every window and probe decision is one batch
    launch at the `timeline_sweep` site (the report's dispatches)."""
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    before = COUNTERS.get("launches_timeline_sweep")
    cmp_ = _run_policies(PORT, "recorded-decision", "cuda")
    assert COUNTERS.get("launches_timeline_sweep") - before == cmp_.dispatches > 0
    before = COUNTERS.get("launches_timeline_sweep")
    _run_policies(PORT, "recorded-decision", "oracle")
    assert COUNTERS.get("launches_timeline_sweep") == before


def test_journal_resume_launches_nothing_and_reports_the_same(tmp_path):
    from open_simulator_tpu_torch.runtime import Journal
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    path = str(tmp_path / "tl.journal")
    j1 = Journal.open(path, "tl-fp")
    first = _run_policies(PORT, "windowed-vs-serial", "cuda", journal=j1)
    j1.close()
    before = COUNTERS.get("launches_timeline_sweep")
    j2 = Journal.resume(path, "tl-fp")
    second = _run_policies(PORT, "windowed-vs-serial", "cuda", journal=j2)
    j2.close()
    assert COUNTERS.get("launches_timeline_sweep") == before
    assert second.dispatches == 0 < first.dispatches
    d1, d2 = first.as_dict(), second.as_dict()
    d1.pop("dispatches"), d2.pop("dispatches")
    assert d1 == d2


def test_budget_halt_attaches_the_jax_partial_report():
    partials = []
    for pkg, engine in ((JAX, "tpu"), (PORT, "cuda")):
        budget = _mod(pkg, "runtime").Budget(0.0)
        with pytest.raises(_mod(pkg, "runtime").ExecutionHalted) as ei:
            _run_policies(pkg, "departure", engine, budget=budget)
        partial = copy.deepcopy(ei.value.partial)
        assert partial["report"].pop("engine") == engine
        partials.append(partial)
    assert partials[0] == partials[1]
    assert partials[1]["phase"] == "timeline" and partials[1]["report"]["partial"] is True


# ------------------------------------------------------------- the events


SPECS = [dict(arrivals=40, spot_frac=0.5, spot_hazard=1 / 50.0, seed=7),
         dict(arrivals=40, spot_frac=0.5, spot_hazard=1 / 50.0, seed=8),
         dict(arrivals=300, arrival_rate=20.0, mean_lifetime_s=300.0,
              long_running_frac=0.7, spot_frac=0.01, spot_hazard=1 / 2000.0, seed=11)]


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_synthetic_traces_are_the_jax_bytes(spec, tmp_path):
    out = []
    names = [f"base-{i}" for i in range(120)]
    for pkg in PKGS:
        ev = _mod(pkg, "timeline.events")
        events = ev.generate_synthetic(ev.SyntheticSpec(**SPECS[spec]), names)
        path = tmp_path / f"{pkg}.jsonl"
        fp = ev.write_trace(str(path), events, meta={"spec": SPECS[spec]})
        out.append((fp, ev.trace_fingerprint(events), path.read_bytes()))
    assert out[1] == out[0]


def test_heap_order_and_decision_log_mapping_like_the_jax_package():
    out = []
    for pkg in PKGS:
        ev = _mod(pkg, "timeline.events")
        heap = ev.EventHeap()
        for rec in ([_ev(3.0, "PodDeparture", 0, podRef="tl/a"),
                     _ev(1.0, "PodArrival", 0, pod=_pod("a")),
                     _ev(2.0, "SpotReclaim", 0, nodeName="base-0")]
                    + [_ev(5.0, "PodArrival", 0, pod=_pod(f"f{i}")) for i in range(4)]):
            heap.push(ev.Event.from_record(rec))
        order = [e.as_record() for e in heap.drain()]
        step_t = _mod(pkg, "shadow.log").Step
        steps = [
            step_t(seq=0, kind="delta", deltas=[
                {"op": "add_node", "node": _node("joiner")},
                {"op": "place_pod", "pod": _pod("bound", node_name="base-0")}]),
            step_t(seq=1, kind="decision", pod=_pod("decided", node_name="stray"),
                   node="base-1", deltas=[{"op": "evict_pod", "namespace": "tl",
                                           "name": "old"}]),
            step_t(seq=2, kind="delta", deltas=[{"op": "remove_node", "name": "base-2"}]),
        ]
        mapped = [e.as_record() for e in ev.events_from_decision_log(steps)]
        with pytest.raises(_mod(pkg, "runtime.journal").JournalMismatch) as ei:
            ev.events_from_decision_log([step_t(seq=0, kind="delta",
                                                deltas=[{"op": "mystery"}])])
        out.append((order, mapped, str(ei.value)))
    assert out[1] == out[0]


def test_trace_files_cross_packages_and_refuse_damage_alike(tmp_path):
    """A JAX-written trace reads in the port as the same events (and
    back); a torn tail drops one record, interior damage, a foreign
    fingerprint and out-of-order events refuse with the JAX message."""
    recs = _arrivals(6) + [_ev(10.0, "SpotReclaim", 6, nodeName="base-1", reason="hazard")]
    paths = {}
    for pkg in PKGS:
        paths[pkg] = tmp_path / f"{pkg}.jsonl"
        _mod(pkg, "timeline.events").write_trace(str(paths[pkg]), _events(pkg, recs))
    assert paths[JAX].read_bytes() == paths[PORT].read_bytes()
    bad = tmp_path / "bad.jsonl"
    lines = paths[JAX].read_text().splitlines()
    lines[2] = lines[2][: len(lines[2]) // 2]
    bad.write_text("\n".join(lines) + "\n")
    order = tmp_path / "order.jsonl"
    _mod(JAX, "timeline.events").write_trace(str(order), _events(JAX, [
        _ev(5.0, "PodArrival", 0, pod=_pod("a")), _ev(2.0, "PodArrival", 1, pod=_pod("b"))]))
    torn = tmp_path / "torn.jsonl"
    torn.write_bytes(paths[JAX].read_bytes() + b'{"kind": "event", "event": "PodArr')
    out = []
    for pkg in PKGS:
        ev = _mod(pkg, "timeline.events")
        mismatch = _mod(pkg, "runtime.journal").JournalMismatch
        back, meta = ev.read_trace(str(paths[JAX]))
        back_t, meta_t = ev.read_trace(str(torn))
        errs = []
        for path, fp in ((bad, None), (paths[PORT], "not-the-fingerprint"), (order, None)):
            with pytest.raises(mismatch) as ei:
                ev.read_trace(str(path), fingerprint=fp)
            errs.append(str(ei.value))
        out.append(([e.as_record() for e in back], meta, len(back_t), meta_t["dropped"], errs))
    assert out[1] == out[0]
    assert out[1][0] == recs and out[1][3] == 1


@pytest.mark.parametrize("spec", ["static:3", "threshold:lo=20,patience=3", "probe@nospread",
                                  "threshold", "static", "static:x", "mystery",
                                  "threshold:bogus", "threshold:lo=1,zz=2", "probe:1",
                                  "probe@nope", "static:-1", "threshold:lo=200"])
def test_policy_specs_parse_like_the_jax_package(spec):
    out = []
    for pkg in PKGS:
        try:
            pol = _mod(pkg, "timeline.autoscaler").parse_policy(spec)
            out.append((pol.name, pol.profile, vars(pol).get("lo"), tuple(pol.weights or ())))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[1] == out[0]


# ------------------------------------------------------------------- CLI


def _config(tmp_path, n_nodes=3, pods=()):
    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir(exist_ok=True)
    for i in range(n_nodes):
        (cluster_dir / f"n{i}.yaml").write_text(yaml.safe_dump(_node(f"base-{i}")))
    for p in pods:
        (cluster_dir / f"{p['metadata']['name']}.yaml").write_text(yaml.safe_dump(p))
    newnode_dir = tmp_path / "newnode"
    newnode_dir.mkdir(exist_ok=True)
    (newnode_dir / "node.yaml").write_text(yaml.safe_dump(_node("template")))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "t"},
        "spec": {"cluster": {"customConfig": str(cluster_dir)}, "newNode": str(newnode_dir)}}))
    return str(cfg)


def _run(pkg, argv):
    main, reset = (jax_cli.main, jax_reset) if pkg == JAX else (port_cli.main, port_reset)
    if pkg == PORT and "--device" not in argv and argv[0] == "timeline":
        argv = argv + ["--device", "cpu"]
    reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both_json(argv):
    """(rc, JSON without `engine`) of each package's CLI on `argv`."""
    out = {}
    for pkg in PKGS:
        rc, stdout, err = _run(pkg, argv)
        doc = json.loads(stdout)
        assert doc.pop("engine") == ("tpu" if pkg == JAX else "cuda"), err
        out[pkg] = (rc, doc)
    return out[JAX], out[PORT]


@pytest.mark.parametrize("cfg_kind", ["three-nodes", "quickstart"])
def test_cli_compare_prints_the_jax_report(cfg_kind, tmp_path):
    if cfg_kind == "quickstart":
        argv = ["timeline", "-f", QUICKSTART, "--synthetic", "120", "--seed", "4",
                "--spot-frac", "0.34", "--compare", "static:1,threshold,probe",
                "--cadence", "40", "--warmup", "10", "--max-nodes", "3"]
    else:
        argv = ["timeline", "-f", _config(tmp_path), "--synthetic", "40", "--seed", "5",
                "--compare", "static:1,threshold,probe", "--cadence", "20", "--warmup", "5",
                "--max-nodes", "2"]
    want, got = _both_json(argv + ["--format", "json"])
    assert got == want and got[0] == 0
    assert [p["policy"] for p in got[1]["policies"]] == ["static:1", "threshold", "probe"]
    (jrc, jout, _), (prc, pout, _) = (_run(pkg, argv) for pkg in PKGS)
    assert (prc, pout.replace("engine cuda", "engine tpu")) == (jrc, jout)


def test_cli_saved_traces_are_the_jax_bytes_and_replay_across(tmp_path):
    cfg = _config(tmp_path)
    traces = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in PKGS}
    runs = {}
    for pkg in PKGS:
        rc, out, err = _run(pkg, ["timeline", "-f", cfg, "--synthetic", "30", "--seed", "9",
                                  "--policy", "static:0", "--save-trace", traces[pkg],
                                  "--format", "json"])
        runs[pkg] = (rc, json.loads(out), err.replace(traces[pkg], "PATH"))
    assert open(traces[JAX], "rb").read() == open(traces[PORT], "rb").read()
    assert runs[PORT][2] == runs[JAX][2]
    # each package replays the other's trace to the report it generated
    for pkg, other in ((PORT, JAX), (JAX, PORT)):
        rc, out, _err = _run(pkg, ["timeline", "-f", cfg, "--trace", traces[other],
                                   "--policy", "static:0", "--format", "json"])
        assert rc == 0 and json.loads(out) == runs[pkg][1]


def test_cli_from_decision_log_prints_the_jax_report(tmp_path):
    from open_simulator_tpu.shadow.log import DecisionLogWriter, Step

    cfg = _config(tmp_path)
    log = str(tmp_path / "decisions.jsonl")
    with DecisionLogWriter(log, "some-other-cluster") as w:
        for i in range(4):
            w.append(Step(seq=i, kind="decision", pod=_pod(f"real-{i}"), node=f"base-{i % 3}"))
    got = {pkg: _run(pkg, ["timeline", "-f", cfg, "--from-decision-log", log,
                           "--policy", "static:0"]) for pkg in PKGS}
    assert got[PORT][0] == got[JAX][0] == 2
    assert got[PORT][2].replace(log, "LOG") == got[JAX][2].replace(log, "LOG")
    want, have = _both_json(["timeline", "-f", cfg, "--from-decision-log", log,
                             "--allow-fingerprint-mismatch", "--policy", "static:0",
                             "--format", "json"])
    assert have == want and have[1]["arrivals"] == 4
    # a log the JAX CLI recorded on the quickstart: real history through
    # the policies, fingerprint checked
    qlog = str(tmp_path / "quick.jsonl")
    assert _run(JAX, ["shadow", "-f", QUICKSTART, "--record", qlog])[0] == 0
    want, have = _both_json(["timeline", "-f", QUICKSTART, "--from-decision-log", qlog,
                             "--compare", "threshold,probe", "--max-nodes", "3",
                             "--format", "json"])
    assert have == want and have[0] == 0


def test_cli_input_errors_like_the_jax_cli(tmp_path):
    cfg = _config(tmp_path)
    cases = [
        ["timeline", "-f", cfg],
        ["timeline", "-f", cfg, "--synthetic", "5", "--trace", "x"],
        ["timeline", "-f", cfg, "--synthetic", "-5"],
        ["timeline", "-f", cfg, "--synthetic", "5", "--policy", "bogus"],
        ["timeline", "-f", cfg, "--synthetic", "5", "--cadence", "0"],
        ["timeline", "-f", cfg, "--synthetic", "5", "--window-arrivals", "0"],
        ["timeline", "-f", cfg, "--synthetic", "5", "--compare", "probe,probe"],
        ["timeline", "-f", cfg, "--trace", str(tmp_path / "missing.jsonl")],
    ]
    for argv in cases:
        got = {pkg: _run(pkg, argv) for pkg in PKGS}
        assert got[PORT] == got[JAX], argv
        assert got[PORT][0] == 2 and "error:" in got[PORT][2] and not got[PORT][1]


def test_cli_without_a_card_exits_2(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["timeline", "-f", _config(tmp_path), "--synthetic", "5"]
    for device in (["--device", "cuda"], []):
        port_reset()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = port_cli.main(argv + device)
        assert rc == 2 and not out.getvalue() and "needs a GPU" in err.getvalue()


def test_cli_journal_resume_and_halt_like_the_jax_cli(tmp_path):
    """`--inject budget.check=deadline@2` halts both CLIs at the same
    window (exit 3, the JAX partial report but its engine); the port's
    `--journal` run resumed with `--resume` launches nothing and prints
    the same report."""
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    cfg = _config(tmp_path)
    argv = ["timeline", "-f", cfg, "--synthetic", "60", "--seed", "3",
            "--compare", "static:0,probe", "--cadence", "10", "--max-nodes", "2",
            "--format", "json"]
    halted = {}
    for pkg in PKGS:
        rc, out, _err = _run(pkg, argv + ["--inject", "budget.check=deadline@2"])
        doc = json.loads(out)
        doc["detail"]["report"].pop("engine")
        halted[pkg] = (rc, doc)
    assert halted[PORT] == halted[JAX] and halted[PORT][0] == 3
    journal = str(tmp_path / "tl.journal")
    rc1, out1, _ = _run(PORT, argv + ["--journal", journal])
    before = COUNTERS.get("launches_timeline_sweep")
    rc2, out2, _ = _run(PORT, argv + ["--resume", journal])
    assert COUNTERS.get("launches_timeline_sweep") == before
    d1, d2 = json.loads(out1), json.loads(out2)
    assert d2.pop("dispatches") == 0 < d1.pop("dispatches")
    assert (rc1, d1) == (rc2, d2) == (0, d2)


def test_cli_injected_oom_halves_a_chunk_to_the_same_report(tmp_path):
    cfg = _config(tmp_path)
    argv = ["timeline", "-f", cfg, "--synthetic", "40", "--seed", "5",
            "--compare", "static:1,threshold,probe", "--cadence", "20", "--max-nodes", "2",
            "--format", "json", "--trace-phases"]
    rc, clean, _ = _run(PORT, argv)
    rc2, halved, err = _run(PORT, argv + ["--inject", "jit.timeline_sweep=oom@1"])
    assert rc == rc2 == 0 and halved == clean
    assert "timeline-chunk-halving" in json.loads(err.strip().splitlines()[-1])["notes"]


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
def test_cli_mesh_flag_gives_the_jax_report_and_exit_code(spec, tmp_path, mesh_state):
    argv = ["timeline", "-f", _config(tmp_path), "--synthetic", "40", "--seed", "5",
            "--compare", "static:1,threshold", "--cadence", "20", "--warmup", "5",
            "--max-nodes", "2", "--mesh", spec]
    if spec == "many":
        got = {pkg: _run(pkg, argv) for pkg in PKGS}
        assert got[PORT] == got[JAX] and got[PORT][0] == 2
        assert got[PORT][2] == "error: --mesh 'many': expected auto, off, or a device count\n"
        return
    want, got = _both_json(argv + ["--format", "json"])
    assert got == want and got[0] == 0
