"""The GPU port's shadow auditor (`open_simulator_tpu_torch` -> shadow/,
`simon shadow`) against the JAX package's, exactly.

The inputs of tests/test_shadow.py go through both packages: recorded
decision logs are byte-identical; replay reports are equal with the
fields that name the engine or count its compiler set aside (the JAX
report's `engine`, `obs`, `recompileSteps`, `newShapeRecompiles` and
`warmRecompiles`; the port's `engine`, `obs`, `buildSteps`,
`newShapeBuilds` and `warmBuilds`); every other byte is compared. The
port replays on the cuda engine with `device="cpu"` (one single-pod
scan of the kernel's plain version a decision) and on the oracle. Logs
written by one package replay in the other; the live tailer emits the
same steps from the same fake client, and `--tail` against a stub
apiserver on 127.0.0.1 audits and records what the JAX tailer does."""

import contextlib
import copy
import importlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import urlsplit

import pytest
import yaml

from open_simulator_tpu import cli as jax_cli
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset
from open_simulator_tpu.runtime.retry import reset_io_state as jax_reset_io
from open_simulator_tpu.testing import make_fake_node
from open_simulator_tpu_torch import cli as port_cli
from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
from open_simulator_tpu_torch.runtime.retry import reset_io_state as port_reset_io

JAX, PORT = "open_simulator_tpu", "open_simulator_tpu_torch"
PKGS = (JAX, PORT)
# fields set aside when the two reports are compared: the engine's name
# and its compiler's counts (XLA dispatches and recompiles in the JAX
# package, launches and nvcc builds in the port)
ASIDE = {JAX: ("engine", "obs", "recompileSteps", "newShapeRecompiles", "warmRecompiles"),
         PORT: ("engine", "obs", "buildSteps", "newShapeBuilds", "warmBuilds")}
# the port's engines for the JAX package's
ENGINE = {"tpu": ("cuda", {"device": "cpu"}), "oracle": ("oracle", {})}
QUICKSTART = "example/simon-config.yaml"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _aside(pkg, doc):
    doc = dict(doc)
    for k in ASIDE[pkg]:
        doc.pop(k, None)
    return doc


def _pod(name, cpu="500m", mem="512Mi", namespace="d", priority_class=None, node_name=None):
    pod = {"kind": "Pod", "metadata": {"name": name, "namespace": namespace},
           "spec": {"containers": [{"name": "c", "image": "img",
                                    "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}
    if priority_class:
        pod["spec"]["priorityClassName"] = priority_class
    if node_name:
        pod["spec"]["nodeName"] = node_name
    return pod


HIGH = [{"kind": "PriorityClass", "metadata": {"name": "high"}, "value": 1000}]


def _cluster(pkg, nodes, priority_classes=None):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = copy.deepcopy(nodes)
    if priority_classes:
        cluster.priority_classes = copy.deepcopy(priority_classes)
    return cluster


def _apps(pkg, apps):
    out = []
    for name, pods in apps:
        res = _mod(pkg, "models.decode").ResourceTypes()
        res.pods = copy.deepcopy(pods)
        out.append(_mod(pkg, "scheduler.core").AppResource(name, res))
    return out


SMALL = [make_fake_node("big-0", cpu="16", memory="32Gi"),
         make_fake_node("big-1", cpu="16", memory="32Gi"),
         make_fake_node("small-0", cpu="2", memory="4Gi")]
SEEDED = [make_fake_node("big-0", cpu="16", memory="32Gi"),
          make_fake_node("small-0", cpu="2", memory="4Gi")]

# recorded fixtures of tests/test_shadow.py: (nodes, priority classes, apps)
RECORDED = {
    "round-trip": (SMALL, None, [("web", [_pod(f"web-{i}", cpu="1") for i in range(6)])]),
    "warm-shapes": (SMALL, None, [("web", [_pod(f"web-{i}", cpu="1") for i in range(8)])]),
    "preemption": ([make_fake_node("solo", cpu="2", memory="4Gi")], HIGH,
                   [("filler", [_pod("filler-0", cpu="1500m")]),
                    ("vip", [_pod("vip-0", cpu="1500m", priority_class="high")])]),
}

# hand-written logs of tests/test_shadow.py: (nodes, priority classes, step records)
SEEDED_STEPS = [
    {"kind": "decision", "seq": 0, "pod": _pod("nd"), "node": "big-0"},
    {"kind": "decision", "seq": 1, "pod": _pod("fd-a", cpu="100"), "node": "big-0"},
    {"kind": "decision", "seq": 2, "pod": _pod("fd-b", cpu="100m"), "node": None,
     "reason": "0/2 nodes are available"},
    {"kind": "delta", "seq": 3, "ops": [
        {"op": "place_pod", "pod": _pod("squat-big", cpu="15500m", node_name="big-0")},
        {"op": "place_pod", "pod": _pod("squat-small", cpu="1900m", node_name="small-0")}]},
    {"kind": "decision", "seq": 4, "pod": _pod("vip", cpu="1500m", priority_class="high"),
     "node": "small-0"},
]
WRITTEN = {
    "seeded-divergences": (SEEDED, HIGH, SEEDED_STEPS),
    "ordering-evictions": (SEEDED, HIGH, [
        {"kind": "delta", "seq": 0, "ops": [
            {"op": "place_pod", "pod": _pod("victim", cpu="1", node_name="small-0")}]},
        {"kind": "decision", "seq": 1, "pod": _pod("pusher", cpu="100m"), "node": "big-0",
         "deltas": [{"op": "evict_pod", "namespace": "d", "name": "victim",
                     "node": "small-0"}]}]),
    "node-churn": ([make_fake_node("n-0", cpu="4", memory="8Gi")], None, [
        {"kind": "delta", "seq": 0,
         "ops": [{"op": "add_node", "node": make_fake_node("n-1", cpu="4", memory="8Gi")}]},
        {"kind": "decision", "seq": 1, "pod": _pod("a"), "node": "n-0"},
        {"kind": "delta", "seq": 2, "ops": [{"op": "remove_node", "name": "n-0"}]},
        {"kind": "decision", "seq": 3, "pod": _pod("b"), "node": "n-1"}]),
}


def _record(pkg, case):
    nodes, prios, apps = RECORDED[case]
    return _mod(pkg, "shadow.record").record_simulation(_cluster(pkg, nodes, prios),
                                                        _apps(pkg, apps))


def _write_log(pkg, path, cluster, steps):
    log = _mod(pkg, "shadow.log")
    with log.DecisionLogWriter(str(path), log.cluster_fingerprint(cluster)) as w:
        for s in steps:
            w.append(s)
    return path.read_bytes()


def _replay(pkg, cluster, steps, engine):
    """The replay report of `steps`, as a dict, on `engine` (the JAX
    package's name), and the replayer."""
    name, kw = (engine, {}) if pkg == JAX else ENGINE[engine]
    rp = _mod(pkg, "shadow.replay").ShadowReplayer(cluster, engine=name, **kw)
    return rp.run(steps), rp


@pytest.mark.parametrize("case", sorted(RECORDED))
def test_recorded_log_is_byte_identical_and_replays_to_the_jax_report(case, tmp_path):
    """record_simulation writes the JAX package's log bytes; each
    package's log replays in both packages on both engines to the JAX
    report (agreement 1.0), every field but the set-aside ones equal."""
    logs, reports = {}, {}
    for pkg in PKGS:
        _mod(pkg, "models.workloads").reset_name_counter()
        nodes, prios, _apps_ = RECORDED[case]
        logs[pkg] = _write_log(pkg, tmp_path / f"{pkg}.jsonl", _cluster(pkg, nodes, prios),
                               _record(pkg, case))
    assert logs[PORT] == logs[JAX]
    for writer in PKGS:
        for pkg in PKGS:
            nodes, prios, _apps_ = RECORDED[case]
            cluster = _cluster(pkg, nodes, prios)
            steps, meta = _mod(pkg, "shadow.log").read_decision_log(
                str(tmp_path / f"{writer}.jsonl"),
                fingerprint=_mod(pkg, "shadow.log").cluster_fingerprint(cluster))
            assert meta["dropped"] == 0
            for engine in ("tpu", "oracle"):
                report, _rp = _replay(pkg, cluster, steps, engine)
                reports[(writer, pkg, engine)] = report
    want = _aside(JAX, reports[(JAX, JAX, "tpu")].as_dict())
    assert want["agreementRate"] == 1.0
    for (writer, pkg, engine), rep in reports.items():
        assert _aside(pkg, rep.as_dict()) == want, (writer, pkg, engine)
    port = reports[(JAX, PORT, "tpu")]
    # one kernel launch a decision (the plain version on the CPU), no build
    assert port.obs["launches"] == port.decisions and port.obs["deviceLaunches"] == 0
    assert port.warm_builds == 0 and port.build_steps == []
    assert reports[(JAX, PORT, "oracle")].obs["launches"] == 0


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_logs_classify_like_the_jax_package(case):
    """The seeded divergences (node, feasibility, ordering), the
    eviction-citing ordering class and the node churn with its reload
    give the JAX report, with every detail (verdicts, score vectors,
    evidence, reasons) and the replayer's final oracle state."""
    nodes, prios, recs = WRITTEN[case]
    out = []
    for pkg in PKGS:
        step_t = _mod(pkg, "shadow.log").Step
        for engine in ("tpu", "oracle"):
            steps = [step_t.from_record(copy.deepcopy(r)) for r in recs]
            report, rp = _replay(pkg, _cluster(pkg, nodes, prios), steps, engine)
            placed = {ns.name: [p["metadata"]["name"] for p in ns.pods]
                      for ns in rp.oracle.nodes}
            out.append((_aside(pkg, report.as_dict()), placed,
                        report.render_text().splitlines()))
    want = out[0]
    for doc, placed, text in out[1:]:
        assert doc == want[0] and placed == want[1]
        keep = [ln for ln in text if not ln.startswith(("  engine:", "  warm path:"))]
        assert keep == [ln for ln in want[2] if not ln.startswith(("  engine:",
                                                                    "  warm path:"))]
    if case == "seeded-divergences":
        assert want[0]["taxonomy"] == {"agree": 0, "node-divergence": 1,
                                       "feasibility-divergence": 2, "ordering-divergence": 1}


def test_fingerprint_mismatch_and_torn_tail_like_the_jax_package(tmp_path):
    msgs = []
    for pkg in PKGS:
        log = _mod(pkg, "shadow.log")
        path = tmp_path / f"{pkg}.jsonl"
        with log.DecisionLogWriter(str(path), "not-this-cluster") as w:
            w.append(log.Step(seq=0, kind="decision", pod=_pod("p"), node="big-0"))
        with pytest.raises(_mod(pkg, "runtime.journal").JournalMismatch) as ei:
            log.read_decision_log(str(path),
                                  fingerprint=log.cluster_fingerprint(_cluster(pkg, SMALL)))
        msgs.append(str(ei.value).replace(str(path), "PATH"))
        with open(path, "a") as f:
            f.write('{"kind": "decision", "seq": 1, "pod": {')
        steps, meta = log.read_decision_log(str(path))
        assert len(steps) == 1 and meta["dropped"] == 1
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- the tailer


class _FakePods:
    """tests/test_shadow.py's KubeClient stand-in."""

    def __init__(self):
        self.nodes = [make_fake_node("live-0", cpu="8", memory="16Gi")]
        self.pods = []
        self.events = None  # None = endpoint unsupported

    def list(self, path):
        if path.endswith("/nodes"):
            return copy.deepcopy(self.nodes)
        if path.endswith("/events"):
            if self.events is None:
                raise OSError("the server could not find the requested resource")
            return copy.deepcopy(self.events)
        return copy.deepcopy(self.pods)

    def list_with_rv(self, path):
        return self.list(path), "7"


def _running(name, node):
    pod = _pod(name, node_name=node)
    pod["status"] = {"phase": "Running"}
    return pod


def _stuck(name, message="0/1 nodes are available: 1 Insufficient cpu."):
    pod = _pod(name)
    pod["status"] = {"phase": "Pending", "conditions": [
        {"type": "PodScheduled", "status": "False", "reason": "Unschedulable",
         "message": message}]}
    return pod


def _event(name, reason, message):
    return {"kind": "Event", "involvedObject": {"kind": "Pod", "namespace": "d", "name": name},
            "reason": reason, "message": message}


# the tailer scenarios of tests/test_shadow.py: (rounds of (nodes, pods,
# events)); round 0 is the bootstrap
LIVE = make_fake_node("live-0", cpu="8", memory="16Gi")
NEW = make_fake_node("live-new", cpu="4", memory="8Gi")
TAILS = {
    "bindings-failures-deletions": [
        ([LIVE], [_running("pre-bound", "live-0")], None),
        ([LIVE], [_running("pre-bound", "live-0"), _running("fresh", "live-0"),
                  _stuck("stuck")], None),
        ([LIVE], [_running("pre-bound", "live-0"), _running("fresh", "live-0"),
                  _stuck("stuck")], None),
        ([LIVE], [_running("fresh", "live-0"), _stuck("stuck")], None),
    ],
    "node-race": [([LIVE], [], None), ([LIVE], [_running("racer", "live-new")], None),
                  ([LIVE, NEW], [_running("racer", "live-new")], None)],
    "event-sourced": [
        ([LIVE], [], []),
        ([LIVE], [_running("with-event", "live-0")],
         [_event("with-event", "Scheduled", "Successfully assigned d/with-event to live-0")]),
        ([LIVE], [_running("with-event", "live-0"), _running("no-event", "live-0"),
                  _stuck("stuck", "condition text")],
         [_event("stuck", "FailedScheduling", "0/1 nodes: preemption: not eligible"),
          _event("drifty", "Scheduled", "Successfully assigned d/drifty to elsewhere")]),
    ],
    "vanished-and-recreated": [
        ([LIVE], [], None), ([LIVE], [_stuck("web-0")], None), ([LIVE], [], None),
        ([LIVE], [_stuck("web-0")], None),
    ],
}


@pytest.mark.parametrize("case", sorted(TAILS))
def test_tailer_emits_the_jax_steps_and_audits_them_alike(case):
    out = []
    for pkg in PKGS:
        tailer_t = _mod(pkg, "shadow.ingest").ClusterTailer
        client = _FakePods()
        rounds = TAILS[case]
        client.nodes, client.pods, client.events = copy.deepcopy(rounds[0])
        tailer = tailer_t(client)
        nodes, boot = tailer.bootstrap()
        steps = list(boot)
        for r in rounds[1:]:
            client.nodes, client.pods, client.events = copy.deepcopy(r)
            steps += tailer.poll()
        report, _rp = _replay(pkg, _cluster(pkg, nodes), steps, "tpu")
        out.append(([s.as_record() for s in steps], tailer._events_supported,
                    _aside(pkg, report.as_dict())))
    assert out[1] == out[0]
    assert out[1][0]


# ------------------------------------------------------------------- CLI


def _run(pkg, argv):
    main, reset = (jax_cli.main, jax_reset) if pkg == JAX else (port_cli.main, port_reset)
    (jax_reset_io if pkg == JAX else port_reset_io)()
    reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv + (["--device", "cpu"] if pkg == PORT and "--device" not in argv
                          and argv[0] == "shadow" and "--record" not in argv else []))
    return rc, out.getvalue(), err.getvalue()


def _config(tmp_path, replicas=80):
    """A simon config: the test's three nodes and a Deployment of
    `replicas` mixed pods (enough for the budget's 64-step check)."""
    cl = tmp_path / "cluster"
    cl.mkdir()
    for n in SMALL:
        (cl / f"{n['metadata']['name']}.yaml").write_text(yaml.safe_dump(n))
    app = tmp_path / "app"
    app.mkdir()
    spec = {"containers": [{"name": "c", "image": "img",
                            "resources": {"requests": {"cpu": "700m", "memory": "1Gi"}}}]}
    (app / "web.yaml").write_text(yaml.safe_dump({
        "kind": "Deployment", "metadata": {"name": "web", "namespace": "d"},
        "spec": {"replicas": replicas, "template": {"spec": spec}}}))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "s"},
        "spec": {"cluster": {"customConfig": str(cl)},
                 "appList": [{"name": "web", "path": str(app)}]}}))
    return str(cfg)


def _json_both(argv_of):
    """rc and the JSON document of each package's CLI, fields set aside."""
    out = {}
    for pkg in PKGS:
        rc, stdout, err = _run(pkg, argv_of(pkg))
        out[pkg] = (rc, _aside(pkg, json.loads(stdout)) if stdout.startswith("{") else stdout,
                    err)
    return out


@pytest.mark.parametrize("cfg_kind", ["quickstart", "deployment"])
def test_cli_record_bytes_and_replay_of_either_log(cfg_kind, tmp_path):
    """`shadow --record` writes the JAX CLI's bytes (and stdout); each
    package's `--decision-log` of either log prints the JAX JSON and
    table report with only the set-aside fields and lines differing,
    and the same exit code."""
    cfg = QUICKSTART if cfg_kind == "quickstart" else _config(tmp_path)
    rec = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        rc, stdout, err = _run(pkg, ["shadow", "-f", cfg, "--record", path])
        rec[pkg] = (rc, stdout.replace(path, "PATH"), open(path, "rb").read())
    assert rec[PORT] == rec[JAX] and rec[JAX][0] == 0
    for writer in PKGS:
        log = str(tmp_path / f"{writer}.jsonl")
        got = _json_both(lambda pkg: ["shadow", "-f", cfg, "--decision-log", log,
                                      "--format", "json"])
        assert got[PORT][:2] == got[JAX][:2]
        assert got[PORT][1]["agreementRate"] == 1.0 and got[PORT][0] == 0
        texts = {}
        for pkg in PKGS:
            rc, stdout, _err = _run(pkg, ["shadow", "-f", cfg, "--decision-log", log])
            texts[pkg] = (rc, [ln for ln in stdout.splitlines()
                               if not ln.startswith(("  engine:", "  warm path:"))])
        assert texts[PORT] == texts[JAX]


def test_cli_oracle_engine_and_explain_like_the_jax_cli(tmp_path):
    cfg = _config(tmp_path, replicas=12)
    log = str(tmp_path / "log.jsonl")
    _run(JAX, ["shadow", "-f", cfg, "--record", log])
    for argv in (["--engine", "oracle"], ["--explain", "d/web"]):
        got = _json_both(lambda pkg, a=argv: ["shadow", "-f", cfg, "--decision-log", log,
                                              "--format", "json", *a])
        assert got[PORT][:2] == got[JAX][:2], argv


def test_cli_halted_replay_prints_the_jax_partial(tmp_path):
    """A replay halted at its 64-step budget check (exit 3) prints the
    JAX partial report: the audit of the first 64 steps."""
    cfg = _config(tmp_path)
    log = str(tmp_path / "log.jsonl")
    _run(JAX, ["shadow", "-f", cfg, "--record", log])
    got = {}
    for pkg in PKGS:
        rc, stdout, _err = _run(pkg, ["shadow", "-f", cfg, "--decision-log", log,
                                      "--format", "json", "--inject",
                                      "budget.check=deadline@2"])
        doc = json.loads(stdout)
        doc["detail"]["shadow"] = _aside(pkg, doc["detail"]["shadow"])
        got[pkg] = (rc, doc)
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == 3 and got[PORT][1]["detail"]["shadow"]["steps"] == 64


@pytest.mark.parametrize("argv,needle", [
    (["shadow", "-f", QUICKSTART], "pick exactly one mode"),
    (["shadow", "-f", QUICKSTART, "--record", "x", "--tail"], "pick exactly one mode"),
    (["shadow", "-f", QUICKSTART, "--tail"], "--tail needs a kubeConfig"),
    (["shadow", "-f", QUICKSTART, "--record", "x", "--max-catchup", "0"], "--max-catchup"),
    (["shadow", "-f", "missing.yaml", "--record", "x"], "error:"),
])
def test_cli_input_errors_like_the_jax_cli(argv, needle):
    got = {pkg: _run(pkg, list(argv)) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == 2 and needle in got[PORT][2]


def test_cli_without_a_card_exits_2(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = str(tmp_path / "log.jsonl")
    rc, _out, _err = _run(PORT, ["shadow", "-f", QUICKSTART, "--record", log])
    assert rc == 0  # the serial recorder needs no card
    rc, out, err = _run(PORT, ["shadow", "-f", QUICKSTART, "--decision-log", log,
                               "--device", "cuda"])
    assert rc == 2 and not out and "needs a GPU" in err
    port_reset()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()) as e:
        rc = port_cli.main(["shadow", "-f", QUICKSTART, "--decision-log", log])
    assert rc == 2 and "needs a GPU" in e.getvalue()


# ------------------------------------------------------- --tail, a stub


class _StagedApiServer:
    """A live cluster on 127.0.0.1 whose pods (and nodes) move on one
    stage a pod LIST: the tailer's bootstrap sees stage 0, its k-th poll
    stage k (the last stage repeats). No events endpoint (404)."""

    def __init__(self, stages):
        self.stages = stages
        self.pod_lists = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = urlsplit(self.path).path
                stage = outer.stages[min(outer.pod_lists, len(outer.stages) - 1)]
                if path == "/api/v1/nodes":
                    kind, items = "NodeList", stage[0]
                elif path == "/api/v1/pods":
                    kind, items = "PodList", stage[1]
                    outer.pod_lists += 1
                else:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b"{}")
                    return
                body = json.dumps({"kind": kind, "apiVersion": "v1",
                                   "metadata": {"resourceVersion": str(outer.pod_lists)},
                                   "items": items}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def test_cli_tail_against_a_stub_apiserver_audits_the_jax_steps(tmp_path):
    nodes = [make_fake_node("live-0", cpu="8", memory="16Gi"),
             make_fake_node("live-1", cpu="2", memory="4Gi")]
    stages = [
        (nodes, [_running("pre", "live-0")]),
        (nodes, [_running("pre", "live-0"), _running("fresh", "live-0"), _stuck("stuck")]),
        (nodes + [make_fake_node("live-2", cpu="4", memory="8Gi")],
         [_running("fresh", "live-0"), _stuck("stuck"), _running("late", "live-2"),
          _running("small", "live-1")]),
    ]
    srv = _StagedApiServer(stages)
    try:
        kc = tmp_path / "kubeconfig"
        kc.write_text(yaml.safe_dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "ctx",
            "contexts": [{"name": "ctx", "context": {"cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c", "cluster": {
                "server": f"http://127.0.0.1:{srv.server.server_port}"}}],
            "users": [{"name": "u", "user": {"token": "t"}}]}))
        cfg = tmp_path / "live.yaml"
        cfg.write_text(yaml.safe_dump({
            "apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "l"},
            "spec": {"cluster": {"kubeConfig": str(kc)}, "appList": []}}))
        got, logs = {}, {}
        for pkg in PKGS:
            srv.pod_lists = 0
            log = tmp_path / f"{pkg}.jsonl"
            rc, stdout, err = _run(pkg, ["shadow", "-f", str(cfg), "--tail", "--max-polls", "3",
                                         "--poll-interval", "0", "--tail-record", str(log),
                                         "--format", "json"])
            assert stdout.startswith("{"), err
            got[pkg] = (rc, _aside(pkg, json.loads(stdout)))
            logs[pkg] = log.read_bytes()
    finally:
        srv.stop()
    assert got[PORT] == got[JAX]
    assert logs[PORT] == logs[JAX]
    assert got[PORT][1]["decisions"] == 4
