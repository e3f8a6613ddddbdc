"""The digital twin of the GPU port (twin/mirror.py, twin/queries.py,
twin/server.py, `simon twin`) against the JAX package's.

The cases of tests/test_twin.py's mirror, query and daemon sections and
tests/test_checkpoint.py's twin round trip, on the port's cuda engine
with `device="cpu"` (the kernels' plain versions) and its oracle engine:
both packages record the same feed, tail it at agreement 1.0, and answer
every query with the same body (the mirror stats' warm-build count
under the port's name, `warmBuilds`; a forecast's `engine` names the
port's). A what-if, a drain and each N+K trial are one scan launch; a
forecast window that places pods one pins-first launch. `resume_simulator` equals the JAX
function's; `simon twin`'s input errors exit 2 with the JAX wording.
"""

import contextlib
import copy
import importlib
import io
import json
import os
import urllib.error
import urllib.request

import pytest

from open_simulator_tpu.testing import make_fake_node, with_node_labels

JAX = "open_simulator_tpu"
PORT = "open_simulator_tpu_torch"
PKGS = (JAX, PORT)
# each package's engine names: the device scan, the serial walk
ENGINES = {JAX: ("tpu", "oracle"), PORT: ("cuda", "oracle")}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _port_state():
    from open_simulator_tpu_torch.models.workloads import reset_name_counter
    from open_simulator_tpu_torch.runtime.inject import INJECT

    reset_name_counter()
    INJECT.clear()
    yield
    INJECT.clear()


def _pod(name, cpu="500m", mem="512Mi", namespace="d"):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": namespace},
            "spec": {"containers": [{"name": "c", "image": "img",
                                     "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}


def _cluster(pkg, n=3, cpu="8", memory="16Gi"):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [make_fake_node(f"n-{i}", cpu, memory,
                                    with_node_labels({"rack": f"r{i % 2}"}))
                     for i in range(n)]
    return cluster


def _app(pkg, name, pods):
    res = _mod(pkg, "models.decode").ResourceTypes()
    res.pods = [copy.deepcopy(p) for p in pods]
    return _mod(pkg, "scheduler.core").AppResource(name, res)


def _recorded_feed(pkg, n_pods=10):
    cluster = _cluster(pkg)
    steps = _mod(pkg, "shadow.record").record_simulation(
        cluster, [_app(pkg, "app", [_pod(f"p-{i}") for i in range(n_pods)])])
    return cluster, steps


def _mirror(pkg, engine, steps, cluster, batch=4, **kw):
    m = _mod(pkg, "twin.mirror")
    if pkg == PORT and engine == "cuda":
        kw.setdefault("device", "cpu")
    mirror = m.ClusterMirror(cluster, m.FeedSource(steps, batch=batch), engine=engine, **kw)
    mirror.bootstrap()
    return mirror


def _fed(pkg, kind=0, n_pods=10):
    cluster, steps = _recorded_feed(pkg, n_pods)
    mirror = _mirror(pkg, ENGINES[pkg][kind], steps, cluster, batch=64)
    while not mirror.source.exhausted:
        mirror.poll_once()
    mirror.drain_backlog()
    return mirror


def _norm(doc):
    """A body with the JAX mirror stats' warm count under the port's name."""
    doc = copy.deepcopy(doc)
    stats = doc.get("mirror")
    if stats and "warmRecompiles" in stats:
        stats["warmBuilds"] = stats.pop("warmRecompiles")
    return doc


def _launches(site="scan"):
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    return COUNTERS.get(f"launches_{site}")


# -- the mirror --------------------------------------------------------------


def test_both_packages_record_the_same_feed():
    logs = {pkg: [s.as_record() for s in _recorded_feed(pkg)[1]] for pkg in PKGS}
    assert logs[PORT] == logs[JAX] and len(logs[PORT]) == 10


@pytest.mark.parametrize("kind", [0, 1], ids=["device", "oracle"])
def test_mirror_tails_own_feed_at_full_agreement(kind):
    stats = {}
    for pkg in PKGS:
        cluster, steps = _recorded_feed(pkg)
        mirror = _mirror(pkg, ENGINES[pkg][kind], steps, cluster)
        polls = 0
        before = _launches()
        while not mirror.source.exhausted:
            assert mirror.poll_once() >= 0
            polls += 1
            assert polls < 100
        mirror.drain_backlog()
        if pkg == PORT:
            # one single-pod scan launch a decision on the cuda engine
            assert _launches() - before == (10 if kind == 0 else 0)
        s = _norm({"mirror": mirror.stats()})["mirror"]
        s.pop("mirrorLagSeconds")
        stats[pkg] = (s, mirror.state_digest(), mirror.applied_seq())
    assert stats[PORT] == stats[JAX]
    s = stats[PORT][0]
    assert s["agreementRate"] == 1.0 and s["divergences"] == 0
    assert s["warmBuilds"] == 0 and s["feedExhausted"]


def test_mirror_bounded_catchup_converges():
    """A giant feed batch converges across rounds under max_catchup,
    never in one stop-the-world gulp; each round as in the JAX mirror."""
    rounds = {}
    for pkg in PKGS:
        cluster, steps = _recorded_feed(pkg, n_pods=12)
        mirror = _mirror(pkg, "oracle", steps, cluster, batch=len(steps), max_catchup=3)
        applied = [mirror.poll_once()]
        assert applied[0] == 3 and mirror.stats()["backlog"] > 0
        assert mirror.mirror_lag_s() >= 0.0
        while mirror.stats()["backlog"] or not mirror.source.exhausted:
            applied.append(mirror.poll_once())
            assert len(applied) < 100
        assert mirror.stats()["agreementRate"] == 1.0
        rounds[pkg] = applied
    assert rounds[PORT] == rounds[JAX]


def test_mirror_flap_counts_and_survives():
    class FlakySource:
        exhausted = False

        def __init__(self):
            self.calls = 0

        def bootstrap(self):
            return [], []

        def poll(self):
            self.calls += 1
            if self.calls % 2:
                raise OSError("apiserver hiccup")
            return []

    m = _mod(PORT, "twin.mirror")
    mirror = m.ClusterMirror(_cluster(PORT, 2), FlakySource(), engine="oracle")
    mirror.bootstrap()
    assert mirror.poll_once() == -1  # flap
    assert mirror.poll_once() == 0
    assert mirror.flaps == 1 and mirror.stats()["polls"] == 2


def test_injected_apply_fault_degrades_not_dies():
    from open_simulator_tpu_torch.runtime.inject import INJECT

    cluster, steps = _recorded_feed(PORT, n_pods=6)
    mirror = _mirror(PORT, "cuda", steps, cluster, batch=64)
    INJECT.configure("twin.apply_delta=raise:ConformanceError@1")
    try:
        while not mirror.source.exhausted:
            mirror.poll_once()
        mirror.drain_backlog()
    finally:
        INJECT.clear()
    assert mirror.apply_errors >= 1
    assert any("could not be applied" in r for r in mirror.degraded_reasons())
    assert mirror.stats()["decisions"] >= 1


def test_mirror_needs_a_card_by_default(monkeypatch):
    import torch

    from open_simulator_tpu_torch.ops.fused_scan import NoCardError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _mod(PORT, "twin.mirror")
    with pytest.raises(NoCardError):
        m.ClusterMirror(_cluster(PORT), m.FeedSource([], batch=1))


# -- the queries -------------------------------------------------------------


def _query(pkg, kind, fn, *args, **kw):
    mirror = _fed(pkg, kind)
    return _norm(getattr(_mod(pkg, "twin.queries"), fn)(mirror, *args, **kw))


def test_whatif_equals_the_jax_twin_and_the_serial_walk():
    pods = [_pod("q-0", cpu="2"), _pod("q-big", cpu="64")]
    got = {}
    for pkg in PKGS:
        for kind in (0, 1):
            mirror = _fed(pkg, kind)
            before = _launches()
            got[pkg, kind] = _norm(_mod(pkg, "twin.queries").whatif(
                mirror, [_app(pkg, "q", pods)]))
            if pkg == PORT:
                assert _launches() - before == (1 if kind == 0 else 0)
    assert got[PORT, 0] == got[JAX, 0] == got[PORT, 1] == got[JAX, 1]
    a = got[PORT, 0]
    assert a["kind"] == "whatif" and a["unscheduledPods"]
    assert "Insufficient cpu" in a["unscheduledPods"][0]["reason"]


def test_warm_deltas_zero_builds_on_repeat_query_shape():
    """After a pod-delta stream a what-if of an already-seen shape
    launches the scan again, with zero nvcc builds."""
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    dl = _mod(PORT, "twin.deltas")
    m = _mod(PORT, "twin.mirror")
    q = _mod(PORT, "twin.queries")
    mirror = m.ClusterMirror(_cluster(PORT), m.FeedSource([], batch=8), device="cpu")
    q.whatif(mirror, [_app(PORT, "q", [_pod("q-0", cpu="1")])])
    builds, before = COUNTERS.get("nvcc_builds_total"), _launches()
    for i in range(6):
        mirror.applicator.apply(dl.ClusterDelta(kind=dl.POD_BIND, pod=_pod(f"live-{i}"),
                                                node_name=f"n-{i % 3}"))
        assert q.whatif(mirror, [_app(PORT, "q", [_pod("q-0", cpu="1")])])["success"]
    assert COUNTERS.get("nvcc_builds_total") == builds
    assert _launches() - before == 6


def test_drain_by_name_and_selector_equal_the_jax_twin():
    for kw in ({"nodes": ["n-0"]}, {"selector": {"rack": "r0"}}):
        got = {}
        for pkg in PKGS:
            for kind in (0, 1):
                mirror = _fed(pkg, kind)
                before = _launches()
                got[pkg, kind] = _norm(_mod(pkg, "twin.queries").drain(mirror, **kw))
                if pkg == PORT:
                    assert _launches() - before == (1 if kind == 0 else 0)
                assert mirror.stats()["agreementRate"] == 1.0
        assert got[PORT, 0] == got[JAX, 0] == got[PORT, 1] == got[JAX, 1]
    assert got[PORT, 0]["drainedNodes"] == ["n-0", "n-2"] and got[PORT, 0]["kind"] == "drain"


def test_drain_refuses_whole_cluster_and_unknown_nodes():
    from open_simulator_tpu_torch.models.validation import InputError

    mirror = _fed(PORT, 1)
    q = _mod(PORT, "twin.queries")
    for nodes in (["n-0", "n-1", "n-2"], ["nope"], []):
        with pytest.raises(InputError):
            q.drain(mirror, nodes=nodes)


def test_nplusk_equals_the_jax_twin_one_launch_a_trial():
    got = {}
    for pkg in PKGS:
        mirror = _fed(pkg, 0)
        before = _launches()
        got[pkg] = _norm(_mod(pkg, "twin.queries").nplusk(mirror, k=1, trials=8))
        if pkg == PORT:
            assert _launches() - before == got[pkg]["scenarios"] == 3
    assert got[PORT] == got[JAX]
    out = got[PORT]
    assert out["mode"] == "exhaustive"
    assert out["survived"] + sum(1 for o in out["outages"] if not o["safe"]) == 3


@pytest.mark.parametrize("kind", [0, 1], ids=["device", "oracle"])
def test_forecast_steps_forward_from_live_state(kind):
    """The forecast on the mirror's engine: the oracle's body is the JAX
    twin's; the cuda engine's, one pins-first launch a window that
    places pods, is the JAX twin's on its tpu engine but the engine's
    name."""
    got = {}
    for pkg in PKGS:
        mirror = _fed(pkg, 1, n_pods=8)
        pending_now = mirror.stats()["pendingPods"]
        before = _launches("timeline_sweep")
        if pkg == PORT and kind == 0:
            mirror = _fed(pkg, 0, n_pods=8)
            out = _mod(pkg, "twin.queries").forecast(
                mirror, horizon_s=60.0, arrival_rate=0.25, policy="static:0")
            assert out["engine"] == "cuda"
            # a window with arrivals to place is one launch
            assert _launches("timeline_sweep") - before == out["dispatches"] >= 1
            assert out["dispatches"] <= out["windows"]
        else:
            out = _mod(pkg, "twin.queries").forecast(
                mirror, horizon_s=60.0, arrival_rate=0.25, policy="static:0",
                engine=ENGINES[pkg][kind])
        assert out["pendingSeeded"] == pending_now and out["arrivals"] == 15
        assert out["policies"] and out["policies"][0]["final"] is not None
        got[pkg] = {k: v for k, v in out.items() if k != "engine"}
    assert got[PORT] == got[JAX]


def test_forecast_zero_rate_without_pending_is_trivial():
    got = {}
    for pkg in PKGS:
        m = _mod(pkg, "twin.mirror")
        mirror = m.ClusterMirror(_cluster(pkg, 2), m.FeedSource([], batch=4), engine="oracle")
        mirror.bootstrap()
        got[pkg] = _mod(pkg, "twin.queries").forecast(mirror, horizon_s=10.0, arrival_rate=0.0)
    assert got[PORT] == got[JAX] and got[PORT]["policies"] == [] and "note" in got[PORT]


# -- the daemon ----------------------------------------------------------------


def _post(base, path, body):
    # one request ID for both daemons: error bodies carry it
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-Simon-Request-Id": "twin-test-1"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


QUERIES = (
    ("/v1/whatif", {"apps": [{"name": "q", "yaml": json.dumps(_pod("q-0"))}]}),
    ("/v1/drain", {"nodes": ["n-1"]}),
    ("/v1/drain", {"selector": {"rack": "r1"}}),
    ("/v1/nplusk", {"k": 1, "trials": 4}),
    ("/v1/forecast", {"horizonSeconds": 20, "arrivalRate": 0.2, "engine": "oracle"}),
    ("/v1/drain", {"nodes": []}),
    ("/v1/forecast", {}),
)


def test_twin_daemon_http_surface_equals_the_jax_daemon():
    from open_simulator_tpu_torch.utils.trace import COUNTERS

    answers = {}
    for pkg in PKGS:
        cluster, steps = _recorded_feed(pkg, n_pods=8)
        mirror = _mirror(pkg, ENGINES[pkg][0], steps, cluster, batch=64)
        daemon = _mod(pkg, "twin.server").TwinDaemon(mirror, port=0, poll_interval_s=0.02)
        daemon.start()
        base = f"http://{daemon.host}:{daemon.port}"
        whatifs = COUNTERS.get("twin_whatif_total")
        try:
            for _ in range(200):
                with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                    h = json.loads(r.read())
                if h["mirror"]["feedExhausted"] and h["mirror"]["backlog"] == 0:
                    break
            assert h["mirror"]["agreementRate"] == 1.0
            answers[pkg] = [(st, _norm(b)) for st, b in
                            (_post(base, path, body) for path, body in QUERIES)]
            with urllib.request.urlopen(base + "/v1/state-digest", timeout=10) as r:
                answers[pkg].append((r.status, json.loads(r.read())))
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                metrics = r.read().decode()
        finally:
            assert daemon.shutdown() == 0
        if pkg == PORT:
            assert "simon_twin_agreement_rate 1.0" in metrics
            assert "simon_shadow_warm_builds_total 0" in metrics
            assert f"simon_twin_whatif_total {whatifs + 1}" in metrics
            assert 'simon_launches_site_total{site="scan"}' in metrics
            assert "simon_nvcc_builds_total" in metrics
    for (path, _b), port, jax in zip(QUERIES, answers[PORT], answers[JAX]):
        assert port == jax, path
    assert [a[0] for a in answers[PORT]] == [200, 200, 200, 200, 200, 400, 400, 200]


def _twin_pair(pkg, interval=2):
    """tests/test_checkpoint.py's twin rig: a mirror tailing a feed of
    6 pods over 3 nodes, and a pristine copy of its cluster."""
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [make_fake_node(f"tw-{i}", "4", "8Gi") for i in range(3)]
    cold = copy.deepcopy(cluster)
    steps = _mod(pkg, "shadow.record").record_simulation(
        cluster, [_app(pkg, "m", [_pod(f"m-{i}", "250m", "256Mi", "default")
                                  for i in range(6)])])
    m = _mod(pkg, "twin.mirror")
    mirror = m.ClusterMirror(copy.deepcopy(cold), m.FeedSource(steps, batch=3),
                             engine="oracle", max_catchup=64)
    mirror.bootstrap()
    return mirror, cold


@pytest.mark.parametrize("writer", PKGS)
def test_twin_checkpoint_restore_roundtrip(tmp_path, writer):
    """Journaled steps and interval checkpoints written by either
    package restore into the port's mirror (and the JAX package's) at
    the live mirror's state-digest triple, with a bounded suffix."""
    m = _mod(writer, "twin.mirror")
    ck = _mod(writer, "runtime.checkpoint")
    interval = 2
    mirror, cold = _twin_pair(writer, interval)
    path = str(tmp_path / "twin.snapshot.jsonl")
    mirror.journal = m.open_twin_snapshot(path)
    mgr = ck.CheckpointManager(
        ck.checkpoint_dir(path), interval=interval, keep=2,
        capture=lambda: m.capture_mirror(mirror),
        materialized_digest=m.twin_materialized_digest, journal=mirror.journal,
        keep_record=m.twin_keep_record, label="twin", synchronous=True)
    while not (mirror.stats()["feedExhausted"] and mirror.stats()["backlog"] == 0):
        mirror.poll_once()
        mgr.note_delta(mirror.applied_seq())
    mirror.journal.close()
    assert mirror.applied_seq() > interval and mgr.writes >= 1
    out = {}
    for reader in PKGS:
        rm = _mod(reader, "twin.mirror")
        replica = rm.ClusterMirror(copy.deepcopy(_cast(cold, reader)),
                                   rm.FeedSource([], batch=1), engine="oracle")
        summary = rm.replay_mirror_journal(replica, path)
        replica.bootstrap()
        assert summary["checkpoint"] is not None and summary["steps"] < interval + 1
        summary["checkpoint"].pop("path")
        out[reader] = (summary, replica.applied_seq(), replica.state_digest(),
                       replica.replayer.report.fingerprint)
    assert out[PORT] == out[JAX]
    assert out[PORT][1:] == (mirror.applied_seq(), mirror.state_digest(),
                             mirror.replayer.report.fingerprint)


def _cast(cluster, pkg):
    """`cluster`'s objects as `pkg`'s ResourceTypes."""
    out = _mod(pkg, "models.decode").ResourceTypes()
    for f in cluster.__dataclass_fields__:
        setattr(out, f, copy.deepcopy(getattr(cluster, f)))
    return out


# -- resume_simulator ----------------------------------------------------------


def test_resume_simulator_equals_the_jax_function(tmp_path):
    from open_simulator_tpu_torch.models.workloads import reset_name_counter as port_reset
    from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset

    out = {}
    for pkg, reset, kw in ((JAX, jax_reset, {"engine": "tpu"}),
                           (PORT, port_reset, {"engine": "cuda", "device": "cpu"})):
        snap = _mod(pkg, "scheduler.snapshot")
        core = _mod(pkg, "scheduler.core")
        reset()
        res = core.simulate(_cluster(pkg), [_app(pkg, "a", [_pod(f"a-{i}") for i in range(5)])],
                            **kw)
        path = tmp_path / f"{pkg}.json"
        snap.save_snapshot(res, str(path))
        sim = snap.resume_simulator(snap.load_snapshot(str(path)), **kw)
        reset()
        more = sim.schedule_app(_app(pkg, "b", [_pod(f"b-{i}", cpu="3") for i in range(8)]))
        out[pkg] = ([(ns.node["metadata"]["name"], [p["metadata"]["name"] for p in ns.pods])
                     for ns in sim.node_status()],
                    [(u.pod["metadata"]["name"], u.reason) for u in more.unscheduled_pods])
    assert out[PORT] == out[JAX]
    assert out[PORT][1]  # some of the 3-cpu pods do not fit


# -- `simon twin` ----------------------------------------------------------------


def _run(pkg, argv):
    cli = _mod(pkg, "cli")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("flags", [
    [],
    ["--feed", "x.jsonl", "--tail"],
    ["--feed", "x.jsonl", "--poll-interval", "0"],
    ["--feed", "x.jsonl", "--drain-timeout", "-1"],
    ["--feed", "x.jsonl", "--tick-budget", "0"],
    ["--feed", "x.jsonl", "--max-request-pods", "0"],
    ["--feed", "x.jsonl", "--max-catchup", "0"],
    ["--feed", "x.jsonl", "--replay-snapshot"],
    ["--feed", "x.jsonl", "--snapshot", "s.jsonl", "--checkpoint-interval", "0"],
    ["--feed", "x.jsonl", "--keep-checkpoints", "0"],
    ["--feed", "x.jsonl", "--checkpoint-interval", "3"],
    ["--feed", "missing.jsonl"],
    ["--tail"],
])
def test_twin_input_errors_exit_2_with_the_jax_wording(flags):
    port = _run(PORT, ["twin", "-f", "example/simon-config.yaml", "--port", "0",
                       "--device", "cpu", *flags])
    jax = _run(JAX, ["twin", "-f", "example/simon-config.yaml", "--port", "0", *flags])
    assert port[0] == jax[0] == 2
    assert port[1] == jax[1] == ""
    assert port[2] == jax[2] and port[2].startswith("error: ")


def test_twin_without_a_card_exits_2(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(PORT, ["twin", "-f", "example/simon-config.yaml", "--feed", "x.jsonl"])
    assert rc == 2 and "needs a GPU" in err and not out


def test_twin_cli_tails_a_recorded_feed_and_drains(tmp_path):
    """The CLI end to end in a subprocess on the CPU: record a feed, tail
    it, a what-if over HTTP, SIGTERM: exit 0 and the mirror line."""
    import signal
    import subprocess
    import sys

    log = str(tmp_path / "feed.jsonl")
    rc, _o, err = _run(PORT, ["shadow", "-f", "example/simon-config.yaml", "--record", log])
    assert rc == 0, err
    errf = open(tmp_path / "twin.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "twin", "-f",
         "example/simon-config.yaml", "--feed", log, "--feed-batch", "16",
         "--poll-interval", "0.05", "--port", "0", "--device", "cpu",
         "--snapshot", str(tmp_path / "twin-snap.jsonl"), "--checkpoint-interval", "10"],
        stdout=subprocess.PIPE, stderr=errf, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        ready = proc.stdout.readline()
        assert "simon twin listening on http://" in ready, (tmp_path / "twin.err").read_text()
        base = ready.split("listening on ", 1)[1].split()[0].rstrip("/")
        for _ in range(400):
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                h = json.loads(r.read())
            if h["mirror"]["feedExhausted"] and h["mirror"]["backlog"] == 0:
                break
        status, body = _post(base, "/v1/whatif", QUERIES[0][1])
        assert status == 200 and body["kind"] == "whatif"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    err = (tmp_path / "twin.err").read_text()
    line = next(ln for ln in err.splitlines() if ln.startswith("simon twin mirror: "))
    stats = json.loads(line[len("simon twin mirror: "):])
    assert stats["agreementRate"] == 1.0 and stats["deltaSeq"] == stats["steps"]


def test_jax_twin_answer_tool_prints_the_port_digest():
    """tools/jax_twin_answer.py --port: the port's twin at chip_smoke
    phase 27's cut, on the CPU, prints chip_smoke.JAX_TWIN_ANSWER, the
    JAX package's digest."""
    import subprocess
    import sys

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "tools/jax_twin_answer.py", "--port"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"JAX_TWIN_ANSWER {chip_smoke.JAX_TWIN_ANSWER} " in out.stdout
