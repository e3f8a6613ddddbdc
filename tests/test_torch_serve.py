"""`simon serve` of the GPU port (`open_simulator_tpu_torch.serve`)
against the JAX package's, on the CPU (the kernels' plain versions).

The scenarios of tests/test_serve.py and tests/test_serve_hardening.py
through the port: a coalesced tick's bodies equal standalone
`simulate()` runs AND the JAX `Session`'s bodies byte for byte; a
priority request routes serial; a burst of B requests launches at most
ceil(B / max_batch) times; an expired deadline sheds a PARTIAL 503; the
bounded queue sheds 503 with Retry-After; the HTTP surface (conformance,
concurrent requests, 400s, cluster deltas and the state digest, the
port's /metrics names); SIGTERM drains and exits 0, a drain timeout
exits 3, bad flags and a missing card exit 2; `--no-incremental` answers
the incremental bodies.

The port's degrade rule (runtime/guard.py) departs from the JAX
session's on purpose, and is held here through the runtime/inject.py
seams: only a device OOM degrades (the committed build or a
re-simulation falls back to the full per-tick scan; a tick's chunk
halves; a single row that still runs out raises on the card and reaches
the serial oracle only in a `device="cpu"` session); a build, backend or
external-I/O fault propagates where the JAX session degrades around it.
"""

from __future__ import annotations

import copy
import importlib
import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from open_simulator_tpu_torch.models.workloads import reset_name_counter
from open_simulator_tpu_torch.runtime.budget import Budget
from open_simulator_tpu_torch.runtime.inject import INJECT
from open_simulator_tpu_torch.scheduler.core import AppResource, simulate
from open_simulator_tpu_torch.serve.coalescer import Coalescer, PendingRequest
from open_simulator_tpu_torch.serve.server import ServeDaemon, parse_request_body
from open_simulator_tpu_torch.serve.session import Session, WhatIfRequest, result_payload
from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

JAX = "open_simulator_tpu"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _port_state():
    reset_name_counter()
    INJECT.clear()
    yield
    INJECT.clear()


def make_node(name, cpu, mem_gi):
    return {
        "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {"allocatable": {"cpu": str(cpu), "memory": f"{mem_gi}Gi", "pods": "110"}},
    }


def deployment(name, replicas, cpu="500m", mem="1Gi", priority=None):
    spec = {"containers": [{"name": "c", "image": f"img-{name}",
                            "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
    if priority is not None:
        spec["priority"] = priority
    return {"kind": "Deployment",
            "metadata": {"name": name, "namespace": "serve", "labels": {"app": name}},
            "spec": {"replicas": replicas, "template": {"spec": spec}}}


def _container(cpu, mem):
    return [{"name": "c", "image": "x", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]


def build_cluster(pkg="open_simulator_tpu_torch"):
    """tests/test_serve.py's cluster: a bound pod, a dangling pod
    (unknown nodeName) and a daemonset ride every scenario."""
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [make_node(f"serve-n-{i}", 8, 32) for i in range(4)]
    cluster.pods = [
        {"kind": "Pod", "metadata": {"name": "bound", "namespace": "d"},
         "spec": {"nodeName": "serve-n-1", "containers": _container("1", "1Gi")}},
        {"kind": "Pod", "metadata": {"name": "dangle", "namespace": "d"},
         "spec": {"nodeName": "node-that-left", "containers": _container("1", "1Gi")}},
    ]
    cluster.daemon_sets = [{
        "kind": "DaemonSet", "metadata": {"name": "ds", "namespace": "d"},
        "spec": {"template": {"spec": {"containers": _container("100m", "128Mi")}}},
    }]
    return cluster


def request_of(name, replicas, pkg="open_simulator_tpu_torch", **kw):
    res = _mod(pkg, "models.decode").ResourceTypes()
    res.deployments = [deployment(name, replicas, **kw)]
    return _mod(pkg, "serve.session").WhatIfRequest(
        apps=[_mod(pkg, "scheduler.core").AppResource(name, res)])


def serial_body(cluster, req: WhatIfRequest) -> bytes:
    """A standalone simulate() of the request on a fresh copy of the
    cluster, name counter reset: what a one-shot CLI run computes."""
    reset_name_counter()
    result = simulate(copy.deepcopy(cluster),
                      [AppResource(a.name, copy.deepcopy(a.resource)) for a in req.apps],
                      engine="cuda", device="cpu")
    return result_payload(result)


def jax_bodies(specs, **session_kw):
    """The JAX package's Session answers to request specs (name,
    replicas, kw) in one tick."""
    s = _mod(JAX, "serve.session").Session(build_cluster(JAX), **session_kw)
    return [r.body for r in s.evaluate_batch([request_of(n, k, JAX, **kw) for n, k, kw in specs])]


TICK = [("alpha", 4, {}), ("beta", 7, dict(cpu="2", mem="4Gi")),
        ("gamma", 40, dict(cpu="2")),  # overflows: failures + reasons
        ("delta", 1, dict(cpu="250m", mem="256Mi"))]


# -- coalescing conformance ------------------------------------------------


@pytest.mark.parametrize("incremental", [True, False])
def test_coalesced_batch_equals_serial_runs_and_the_jax_session(incremental):
    cluster = build_cluster()
    session = Session(cluster, incremental=incremental, device="cpu")
    reqs = [request_of(n, k, **kw) for n, k, kw in TICK]
    d0 = COUNTERS.get("serve_device_dispatches_total")
    l0 = COUNTERS.get("launches_scenario_scan")
    replies = session.evaluate_batch(reqs)
    # one coalesced tick of B batchable requests = ONE batch launch
    assert COUNTERS.get("serve_device_dispatches_total") - d0 == 1
    assert COUNTERS.get("launches_scenario_scan") - l0 == 1
    want = jax_bodies(TICK, incremental=incremental)
    for req, reply, jax_body in zip(reqs, replies, want):
        assert reply.status == 200
        assert reply.meta["engine"] == "coalesced-scan"
        assert reply.body == serial_body(cluster, req) == jax_body
    gamma = json.loads(replies[2].body)
    assert not gamma["success"] and gamma["unscheduledPods"]


def test_no_incremental_answers_the_incremental_bodies():
    inc = Session(build_cluster(), device="cpu")
    full = Session(build_cluster(), incremental=False, device="cpu")
    reqs = [request_of(n, k, **kw) for n, k, kw in TICK]
    a, b = inc.evaluate_batch(reqs), full.evaluate_batch(reqs)
    assert [r.body for r in a] == [r.body for r in b]
    assert a[0].meta.get("incremental") == "suffix" and "incremental" not in b[0].meta


def test_repeated_batches_stay_pristine():
    session = Session(build_cluster(), device="cpu")
    reqs = [request_of("alpha", 4), request_of("beta", 6)]
    first = session.evaluate_batch(reqs)
    second = session.evaluate_batch(reqs)
    assert [r.body for r in first] == [r.body for r in second]


def test_priority_request_routes_serial_with_identical_body():
    cluster = build_cluster()
    session = Session(cluster, device="cpu")
    specs = [("plain", 3, {}), ("crit", 2, dict(priority=100000))]
    reqs = [request_of(n, k, **kw) for n, k, kw in specs]
    replies = session.evaluate_batch(reqs)
    assert replies[0].meta["engine"] == "coalesced-scan"
    assert replies[1].meta["engine"] == "serial"
    for req, reply, jax_body in zip(reqs, replies, jax_bodies(specs)):
        assert reply.body == serial_body(cluster, req) == jax_body


def test_burst_launch_bound_ceil_b_over_chunk():
    cluster = build_cluster()
    session = Session(cluster, device="cpu")
    coal = Coalescer(session, max_batch=2, queue_depth=16)
    coal.hold = threading.Event()
    coal.start()
    reqs = [request_of(f"burst-{i}", 3 + i) for i in range(5)]
    pendings = [PendingRequest(request=r, budget=Budget(None)) for r in reqs]
    d0 = COUNTERS.get("serve_device_dispatches_total")
    b0 = COUNTERS.get("serve_batches_total")
    l0 = COUNTERS.get("launches_scenario_scan")
    for p in pendings:
        assert coal.submit(p)
    coal.hold.set()
    for p in pendings:
        assert p.done.wait(timeout=120), "request never answered"
    assert COUNTERS.get("serve_batches_total") - b0 == 3  # ceil(5/2)
    assert COUNTERS.get("serve_device_dispatches_total") - d0 <= 3
    assert (COUNTERS.get("launches_scenario_scan") - l0
            == COUNTERS.get("serve_device_dispatches_total") - d0)
    for req, p in zip(reqs, pendings):
        assert p.reply.status == 200
        assert p.reply.body == serial_body(cluster, req)
    coal.close()


# -- backpressure ----------------------------------------------------------


def test_queue_expired_deadline_sheds_with_partial_body():
    session = Session(build_cluster(), device="cpu")
    coal = Coalescer(session, max_batch=4, queue_depth=16)
    coal.hold = threading.Event()
    coal.start()
    doomed = PendingRequest(request=request_of("doomed", 1), budget=Budget(0.01))
    fine = PendingRequest(request=request_of("fine", 1), budget=Budget(None))
    s0 = COUNTERS.get("serve_shed_deadline_total")
    assert coal.submit(doomed) and coal.submit(fine)
    time.sleep(0.05)
    coal.hold.set()
    assert doomed.done.wait(timeout=120) and fine.done.wait(timeout=120)
    assert doomed.reply.status == 503
    body = json.loads(doomed.reply.body)
    assert body["partial"] is True and body["reason"] == "deadline"
    assert COUNTERS.get("serve_shed_deadline_total") - s0 == 1
    assert fine.reply.status == 200
    coal.close()


def test_bounded_queue_rejects_at_depth():
    session = Session(build_cluster(), device="cpu")
    coal = Coalescer(session, max_batch=4, queue_depth=2)
    coal.hold = threading.Event()
    coal.start()
    s0 = COUNTERS.get("serve_shed_overload_total")
    p1, p2, p3 = (PendingRequest(request=request_of(f"q{i}", 1), budget=Budget(None))
                  for i in range(3))
    assert coal.submit(p1) and coal.submit(p2)
    assert not coal.submit(p3), "queue beyond depth must reject"
    assert COUNTERS.get("serve_shed_overload_total") - s0 == 1
    assert coal.retry_after_s() >= 1
    assert coal.drain(timeout=0.05) is False
    assert p1.reply.status == 503 and json.loads(p1.reply.body)["reason"] == "drain"
    coal.hold.set()


# -- HTTP surface ----------------------------------------------------------


@pytest.fixture(scope="module")
def daemon():
    reset_name_counter()
    cluster = build_cluster()
    session = Session(cluster, device="cpu")
    d = ServeDaemon(session, port=0, max_batch=4, queue_depth=8, drain_timeout_s=10.0)
    d.start()
    yield d, cluster
    d.shutdown()


def _post(base, payload: dict, path="/v1/simulate", timeout=120, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _wire(name, replicas):
    return {"apps": [{"name": name, "yaml": json.dumps(deployment(name, replicas))}]}


def test_http_simulate_conformance_and_metrics(daemon):
    d, cluster = daemon
    base = f"http://{d.host}:{d.port}"
    health = json.load(urllib.request.urlopen(base + "/healthz", timeout=30))
    assert health["ok"] and health["cluster"] == d.session.fingerprint
    assert health["status"] == "ok" and health["checkpoint"] is None
    resp = _post(base, {**_wire("web", 3), "trace": True},
                 headers={"X-Simon-Request-Id": "rid-1"})
    assert resp.status == 200
    assert resp.headers["X-Simon-Engine"] == "coalesced-scan"
    assert resp.headers["X-Simon-Incremental"] == "suffix"
    assert resp.headers["X-Simon-Request-Id"] == "rid-1"
    assert json.loads(resp.headers["X-Simon-Trace"])["batchSize"] >= 1
    assert resp.read() == serial_body(cluster, request_of("web", 3)) == jax_bodies(
        [("web", 3, {})])[0]
    metrics = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    for name in ("simon_serve_requests_total", "simon_serve_shed_total",
                 "simon_serve_device_dispatches_total", "simon_serve_queue_depth",
                 "simon_serve_batch_fill_mean", "simon_serve_qps",
                 "simon_serve_latency_p50_seconds", "simon_serve_latency_p95_seconds",
                 "simon_launches_total", "simon_device_launches_total",
                 "simon_nvcc_builds_total", "simon_nvcc_cache_hits_total",
                 "simon_cost_records_total", "simon_incremental_suffix_pods_total"):
        assert f"\n{name} " in "\n" + metrics, name
    assert 'simon_launches_site_total{site="scenario_scan"}' in metrics
    assert 'simon_cost_workspace_bytes{site="scenario_scan"}' in metrics
    assert "jax" not in metrics


def _metric(text, name):
    line = next(ln for ln in text.splitlines() if ln.startswith(f"{name} "))
    return float(line.split()[-1])


def test_simon_mesh_reaches_the_daemon_and_its_metrics(daemon, monkeypatch):
    """SIMON_MESH reaches `serve` through current_mesh at its next tick,
    as in the JAX daemon: with `auto` over two CPU devices (reported by
    a stand-in for the device count; the CPU is one device) a
    one-request tick asks the layout planner, which keeps it on one
    device, and /metrics counts the decision in
    simon_mesh_layout_none_total; the body stays the standalone one."""
    import torch

    from open_simulator_tpu_torch.parallel import mesh as pmesh

    d, cluster = daemon
    base = f"http://{d.host}:{d.port}"
    saved = dict(pmesh._STATE)
    monkeypatch.setenv("SIMON_MESH", "auto")
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 2)
    pmesh._STATE["cache"] = {}
    try:
        before = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
        resp = _post(base, _wire("meshy", 2))
        assert resp.status == 200
        assert resp.read() == serial_body(cluster, request_of("meshy", 2))
        after = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    finally:
        pmesh._STATE.clear()
        pmesh._STATE.update(saved)
        pmesh._STATE["cache"] = {}
    for axis in ("scenario", "node"):
        name = f"simon_mesh_layout_{axis}_total"
        assert _metric(after, name) == _metric(before, name)
    name = "simon_mesh_layout_none_total"
    assert _metric(after, name) == _metric(before, name) + 1


def test_http_concurrent_requests_byte_identical(daemon):
    d, cluster = daemon
    base = f"http://{d.host}:{d.port}"
    bodies, errors = [None] * 4, []

    def worker(i):
        try:
            bodies[i] = _post(base, _wire(f"conc-{i}", 2 + i)).read()
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    for i in range(4):
        assert bodies[i] == serial_body(cluster, request_of(f"conc-{i}", 2 + i))


def test_http_bad_request_is_400(daemon):
    d, _ = daemon
    base = f"http://{d.host}:{d.port}"
    for payload in ({"apps": []}, {"apps": [{"name": "x", "yaml": ":\nnot yaml: ["}]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base, payload)
        assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base, {"deltas": [{"kind": "node_drain", "node": "ghost"}]},
              path="/v1/cluster-delta")
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert exc.value.code == 404


def test_http_cluster_delta_and_state_digest_equal_the_jax_session(daemon):
    """A delta over HTTP re-simulates the committed scan; the state
    digest equals the JAX session's after the same delta, and a what-if
    after it equals a fresh session over the mutated cluster."""
    d, _ = daemon
    base = f"http://{d.host}:{d.port}"
    pod = {"kind": "Pod", "metadata": {"name": "late", "namespace": "d"},
           "spec": {"containers": _container("2", "2Gi")}}
    doc = json.loads(_post(base, {"deltas": [{"kind": "pod_arrive", "pod": pod}]},
                           path="/v1/cluster-delta").read())
    assert doc["applied"] == 1 and doc["deltaSeq"] >= 1
    digest = json.loads(urllib.request.urlopen(base + "/v1/state-digest", timeout=30).read())
    js = _mod(JAX, "serve.session").Session(build_cluster(JAX))
    js.apply_delta(_mod(JAX, "twin.deltas").ClusterDelta(kind="pod_arrive",
                                                          pod=copy.deepcopy(pod)))
    assert digest["stateDigest"] == d.session.state_digest() == js.state_digest()
    assert digest["fingerprint"] == js.fingerprint
    assert (d.session._committed_scan().state_digest()
            == js._committed_scan().state_digest())
    body = _post(base, _wire("after-delta", 3)).read()
    assert body == js.evaluate_batch([request_of("after-delta", 3, JAX)])[0].body


def test_parse_request_body_equals_the_jax_parser():
    cases = [(json.dumps(deployment("raw", 2)).encode(), "application/yaml"),
             (json.dumps({**_wire("web", 2), "deadlineSeconds": 5}).encode(), ""),
             (json.dumps({**_wire("web", 2), "tenant": "a b"}).encode(), "application/json")]
    for raw, ctype in cases:
        got = [_mod(pkg, "serve.server").parse_request_body(raw, ctype)
               for pkg in (JAX, "open_simulator_tpu_torch")]
        (jr, jd, jt), (pr, pd, pt) = got
        assert (pd, pt, pr.tenant) == (jd, jt, jr.tenant)
        assert [vars(a.resource) for a in pr.apps] == [vars(a.resource) for a in jr.apps]
    with pytest.raises(ValueError, match="no recognized Kubernetes"):
        parse_request_body(b'{"kind": "NotAThing"}', "application/yaml")


# -- lifecycle -------------------------------------------------------------


def _write_serve_config(tmp_path):
    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir()
    (cluster_dir / "nodes.yaml").write_text(json.dumps(make_node("solo-node", 8, 32)))
    cfg = tmp_path / "serve-config.yaml"
    cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: serve-test}\n"
                   f"spec:\n  cluster: {{customConfig: {cluster_dir} }}\n")
    return cfg


def test_sigterm_drains_inflight_and_exits_zero(tmp_path):
    cfg = _write_serve_config(tmp_path)
    stderr_path = tmp_path / "serve-stderr.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "serve", "-f", str(cfg),
         "--port", "0", "--no-warm", "--drain-timeout", "60", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=open(stderr_path, "w"), text=True)
    try:
        ready = proc.stdout.readline()
        assert "listening on http://" in ready, (ready, stderr_path.read_text()[-2000:])
        base = ready.split("listening on ", 1)[1].split()[0].rstrip("/")
        result = {}

        def client():
            resp = _post(base, _wire("w", 2), timeout=180)
            result["status"], result["body"] = resp.status, resp.read()

        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=180)
        assert result.get("status") == 200, f"in-flight request lost: {result}"
        assert json.loads(result["body"])["success"] is True
        assert proc.wait(timeout=120) == 0
        assert "simon serve observatory: " in stderr_path.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


def test_drain_timeout_exit_code_is_partial():
    session = Session(build_cluster(), device="cpu")
    d = ServeDaemon(session, port=0, max_batch=4, queue_depth=8, drain_timeout_s=0.05)
    d.coalescer.hold = threading.Event()
    d.start()
    stuck = PendingRequest(request=request_of("stuck", 1), budget=Budget(None))
    assert d.coalescer.submit(stuck)
    assert d.shutdown() == 3
    assert stuck.reply.status == 503
    assert json.loads(stuck.reply.body)["reason"] == "drain"
    d.coalescer.hold.set()


@pytest.mark.parametrize("flags,needle", [
    (["--default-deadline", "0"], "--default-deadline"),
    (["--drain-timeout", "-1"], "--drain-timeout"),
    (["--tick-budget", "0"], "--tick-budget"),
    (["--max-request-pods", "0"], "--max-request-pods"),
    (["--max-sessions", "0"], "--max-sessions"),
    (["--checkpoint-interval", "3"], "requires --snapshot"),
    (["--keep-checkpoints", "0"], "--keep-checkpoints"),
    (["--obs-cadence", "0"], "cadence"),
    (["--slo-config", "/nonexistent/slo.json"], "slo"),
])
def test_bad_flags_exit_2_before_listening(flags, needle, tmp_path, capsys):
    from open_simulator_tpu_torch import cli

    rc = cli.main(["serve", "-f", str(_write_serve_config(tmp_path)), "--port", "0",
                   "--no-warm", "--device", "cpu", *flags])
    out = capsys.readouterr()
    assert rc == 2
    assert needle in out.err.lower() or needle in out.err
    assert "listening" not in out.out


def test_serve_without_a_card_exits_2(tmp_path, monkeypatch, capsys):
    from open_simulator_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["serve", "-f", str(_write_serve_config(tmp_path)), "--port", "0"])
    out = capsys.readouterr()
    assert rc == 2 and "needs a GPU" in out.err and "listening" not in out.out


# -- the degrade rule (runtime/guard.py) -----------------------------------


def _small_session(pkg="open_simulator_tpu_torch", **kw):
    from open_simulator_tpu.testing import make_fake_node, make_fake_pod

    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [make_fake_node(f"n{i}", "8", "16Gi") for i in range(6)]
    cluster.pods = [make_fake_pod(f"p{i:02d}", "default", "500m", "1Gi") for i in range(20)]
    dev = {"device": "cpu"} if pkg != JAX else {}
    return _mod(pkg, "serve.session").Session(cluster, **dev, **kw)


def test_committed_build_oom_degrades_to_the_full_tick():
    """A device OOM in the committed build latches the full per-tick
    scan (still on the session's device); the bodies do not change."""
    s = _small_session()
    INJECT.configure("jit.scan=oom@1")
    f0 = COUNTERS.get("incremental_fallbacks_total")
    replies = s.evaluate_batch([request_of("a", 3), request_of("b", 2)])
    INJECT.clear()
    assert s._committed_broken and s._committed is None
    assert COUNTERS.get("incremental_fallbacks_total") - f0 == 1
    assert "committed build" in GLOBAL.as_dict()["notes"]["incremental-degraded"]
    want = _small_session(incremental=False).evaluate_batch(
        [request_of("a", 3), request_of("b", 2)])
    assert [r.body for r in replies] == [r.body for r in want]
    assert all("incremental" not in r.meta for r in replies)


@pytest.mark.parametrize("fault", ["raise:CompileFailure", "raise:BackendUnavailable",
                                   "exio", "compile", "backend"])
def test_committed_build_non_memory_fault_propagates(fault):
    """A compile, backend or external I/O fault in the committed build
    propagates (a build or launch error is never answered another
    way) and leaves the incremental path armed."""
    s = _small_session()
    INJECT.configure(f"jit.scan={fault}@1")
    with pytest.raises(Exception, match="injected"):
        s.evaluate_batch([request_of("a", 3)])
    INJECT.clear()
    assert not s._committed_broken


@pytest.mark.parametrize("fault", ["raise:CompileFailure", "raise:BackendUnavailable", "exio"])
def test_the_jax_session_degrades_where_the_port_propagates(fault):
    """The departure, on the JAX side: its session latches the full
    per-tick path on the same typed faults and answers."""
    inject = _mod(JAX, "runtime.inject").INJECT
    js = _small_session(JAX)
    inject.configure(f"jit.scan={fault}@1")
    try:
        assert js.evaluate_batch([request_of("a", 3, JAX)])[0].status == 200
        assert js._committed_broken
    finally:
        inject.clear()


def test_resimulation_oom_falls_back_to_the_full_rescan():
    from open_simulator_tpu_torch.incremental.resim import CommittedScan
    from open_simulator_tpu_torch.twin.deltas import ClusterDelta

    s = _small_session()
    assert s._committed_scan() is not None
    INJECT.configure("incremental.suffix=oom@1")
    r0 = COUNTERS.get("incremental_full_rebuilds_total")
    assert s.apply_delta(ClusterDelta(kind="pod_evict", namespace="default",
                                      name="p15")) == "applied"
    INJECT.clear()
    assert COUNTERS.get("incremental_full_rebuilds_total") - r0 == 1
    fresh = CommittedScan(s.cluster.nodes, s.cluster_pods, device="cpu")
    assert s._committed_scan().state_digest() == fresh.state_digest()


@pytest.mark.parametrize("fault", ["raise:CompileFailure", "raise:BackendUnavailable",
                                   "exio"])
def test_resimulation_non_memory_fault_propagates(fault):
    from open_simulator_tpu_torch.twin.deltas import ClusterDelta

    s = _small_session()
    assert s._committed_scan() is not None
    INJECT.configure(f"incremental.suffix={fault}@1")
    with pytest.raises(Exception) as exc:
        s.apply_delta(ClusterDelta(kind="pod_evict", namespace="default", name="p15"))
    INJECT.clear()
    assert "injected" in str(exc.value)


def test_tick_oom_halves_the_chunk_with_identical_bodies():
    s = _small_session()
    reqs = [request_of(f"h{i}", 2 + i) for i in range(4)]
    want = [r.body for r in _small_session().evaluate_batch(reqs)]
    INJECT.configure("jit.scenario_scan=oom@1")
    d0 = COUNTERS.get("serve_device_dispatches_total")
    got = s.evaluate_batch(reqs)
    INJECT.clear()
    assert [r.body for r in got] == want
    # [0,4) ran out, then [0,2) and [2,4): three launches asked for
    assert COUNTERS.get("serve_device_dispatches_total") - d0 == 3
    assert "serve-chunk-halving" in GLOBAL.as_dict()["notes"]


def test_single_row_oom_reaches_the_serial_oracle_only_on_the_cpu():
    """A row that runs out of device memory alone: a `device="cpu"`
    session answers it on the serial oracle (same body); on the card
    the tick raises DeviceOOM, which the coalescer answers 500."""
    from open_simulator_tpu_torch.runtime.errors import DeviceOOM

    req = request_of("solo", 3)
    want = _small_session().evaluate_batch([req])[0].body
    s = _small_session()
    s._committed_scan()
    INJECT.configure("jit.scenario_scan=oomx*")
    try:
        assert s.evaluate_batch([req])[0].body == want
        assert "serve-serial-fallback" in GLOBAL.as_dict()["notes"]
        card = _small_session()
        card._committed_scan()
        card.device = torch.device("cuda")  # the rule reads the session's device
        with pytest.raises(DeviceOOM):
            card.evaluate_batch([req])
        coal = Coalescer(card, max_batch=2, queue_depth=4)
        coal.start()
        p = PendingRequest(request=req, budget=Budget(None))
        assert coal.submit(p) and p.done.wait(timeout=60)
        assert p.reply.status == 500
        coal.close()
    finally:
        INJECT.clear()


def test_launch_fault_in_a_tick_answers_500_not_serial():
    s = _small_session()
    coal = Coalescer(s, max_batch=2, queue_depth=4)
    INJECT.configure("jit.scenario_scan=error@1")
    coal.start()
    try:
        p = PendingRequest(request=request_of("x", 2), budget=Budget(None))
        assert coal.submit(p) and p.done.wait(timeout=60)
        assert p.reply.status == 500
        assert p.reply.meta.get("engine") != "serial"
        INJECT.clear()
        ok = PendingRequest(request=request_of("y", 2), budget=Budget(None))
        assert coal.submit(ok) and ok.done.wait(timeout=60)
        assert ok.reply.status == 200
    finally:
        INJECT.clear()
        coal.close()


# -- the engine's scenario scan (the tick's one launch) --------------------


def _engine_inputs(seed=0, n_nodes=12, n_pods=60):
    import numpy as np

    from open_simulator_tpu.testing import make_fake_node, make_fake_pod, with_node_name

    rng = np.random.RandomState(seed)
    nodes = [make_fake_node(f"e{i:02d}", str(rng.choice([2, 4, 8])), "16Gi")
             for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        opts = [with_node_name(f"e{rng.randint(n_nodes):02d}")] if rng.rand() < 0.1 else []
        pods.append(make_fake_pod(f"q{i:02d}", "default",
                                  ["250m", "500m", "1", "2"][rng.randint(4)], "1Gi", *opts))
    actives = rng.rand(5, n_pods) < 0.7
    actives[0] = True
    return nodes, pods, actives


def _scenario_rows(pkg, nodes, pods, actives):
    oracle = _mod(pkg, "scheduler.oracle").Oracle(copy.deepcopy(nodes))
    engine_mod = _mod(pkg, "scheduler.engine")
    if pkg == JAX:
        eng = engine_mod.TpuEngine(oracle)
    else:
        eng = engine_mod.TorchEngine(oracle, device="cpu")
    eng.begin_batch(copy.deepcopy(pods))
    return eng.scan_scenarios(actives)


@pytest.fixture
def score_plugin():
    """A custom score plugin in both packages' default registries."""
    regs = [_mod(pkg, "scheduler.plugins").default_registry
            for pkg in (JAX, "open_simulator_tpu_torch")]

    def plugin(pkg):
        base = _mod(pkg, "scheduler.plugins").SchedulerPlugin

        class Spread(base):
            name = "spread-by-name"
            normalize = "minmax"

            def score(self, pod, node):
                return int(node["metadata"]["name"][1:]) % 5

        return Spread()

    for reg in regs:
        reg.clear()
    for pkg, reg in zip((JAX, "open_simulator_tpu_torch"), regs):
        reg.register(plugin(pkg))
    yield
    for reg in regs:
        reg.clear()


@pytest.mark.parametrize("seed", [0, 3])
def test_scan_scenarios_equals_the_jax_engine(seed):
    """Masked rows with the batch's pins: the port's one batch launch
    (the plain version here) equals the JAX engine's vmapped scan,
    INACTIVE where a row masks a pod off."""
    import numpy as np

    nodes, pods, actives = _engine_inputs(seed)
    l0 = COUNTERS.get("launches_scenario_scan")
    got = _scenario_rows("open_simulator_tpu_torch", nodes, pods, actives)
    assert COUNTERS.get("launches_scenario_scan") - l0 == 1
    want = np.asarray(_scenario_rows(JAX, nodes, pods, actives))
    np.testing.assert_array_equal(got, want)
    assert (got[~actives] == -2).all() and (got[actives] >= -1).all()


def test_scan_scenarios_with_a_custom_plugin_runs_row_by_row_on_the_torch_scan(score_plugin):
    import numpy as np

    nodes, pods, actives = _engine_inputs(1)
    GLOBAL.reset()
    l0 = COUNTERS.get("launches_scenario_scan")
    got = _scenario_rows("open_simulator_tpu_torch", nodes, pods, actives)
    assert COUNTERS.get("launches_scenario_scan") - l0 == len(actives)
    assert GLOBAL.as_dict()["notes"]["scenario-kernel"] == "torch-scan (custom score plugins)"
    np.testing.assert_array_equal(got, np.asarray(_scenario_rows(JAX, nodes, pods, actives)))


def test_scan_scenarios_refuses_sample_and_schedule_equals_scan_active():
    from open_simulator_tpu_torch.scheduler.engine import TorchEngine
    from open_simulator_tpu_torch.scheduler.oracle import Oracle

    nodes, pods, actives = _engine_inputs(2)
    eng = TorchEngine(Oracle(copy.deepcopy(nodes)), device="cpu")
    placed = eng.schedule(copy.deepcopy(pods))
    assert list(placed) == list(eng.scan_scenarios(actives[:1])[0])
    oracle = Oracle(copy.deepcopy(nodes))
    oracle.select_host = "sample"
    eng = TorchEngine(oracle, device="cpu")
    eng.begin_batch(copy.deepcopy(pods))
    with pytest.raises(ValueError, match="sample"):
        eng.scan_scenarios(actives)
