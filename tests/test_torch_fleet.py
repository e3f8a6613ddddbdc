"""The serve fleet of the GPU port (`open_simulator_tpu_torch.fleet` and
`simon fleet`) against the JAX package's, on the CPU.

Each case runs the same inputs, made from a seed with numpy, through
both packages: the consistent-hash ring as slots join and leave; both
routers in front of the same stub replicas (statuses, bodies, request
IDs, the 503 + Retry-After shed, /healthz, the /metrics lines with
their numbers masked, probe-flap marking); slot-lock refusal and
reclaim; the failover audit under a fake clock, each package's
validator reading the other's log; the stitched trace of one request;
the four fleet injection cells. Then one `fleet --device cpu
--replicas 2` subprocess on example/cluster/demo takes a SIGKILL: the
replacement restores the dead replica's state digest and deltaSeq and
builds nothing. The router does no device work; the replicas' launches
are the serve daemon's (tests/test_torch_serve.py).

The reference's kill-9 zero-compile cases are not used as oracles: they
wait on the JAX AOT store's round trip, which fails in the suite's runs
(ROADMAP.md §C).
"""

import contextlib
import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

JAX = "open_simulator_tpu"
PORT = "open_simulator_tpu_torch"
PKGS = (JAX, PORT)
RID = "X-Simon-Request-Id"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def isolated_fleet_state(monkeypatch):
    """The fleet modules of both packages count into registries of the
    test's own: /metrics renders the process-wide counters and gauges,
    which earlier tests in the same process (pytest-xdist's loadfile)
    may have moved in one package and not the other."""
    for pkg in PKGS:
        trace = _mod(pkg, "utils.trace")
        counters = trace.Counters()
        for name in ("fleet.router", "fleet.replica", "fleet.audit"):
            monkeypatch.setattr(_mod(pkg, name), "COUNTERS", counters)
    yield
    for pkg in PKGS:
        _mod(pkg, "runtime.inject").INJECT.clear()


def _counters(pkg):
    """The registry `isolated_fleet_state` gave `pkg`'s fleet modules."""
    return _mod(pkg, "fleet.router").COUNTERS


# -- the ring ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_hash_rings_route_alike_as_slots_join_and_leave(seed):
    rng = np.random.RandomState(seed)
    keys = [f"tenant-{k}" for k in rng.randint(0, 10**9, 400)]
    vnodes = int(rng.randint(8, 96))
    rings = [_mod(pkg, "fleet.hashing").HashRing(["r0", "r1", "r2"], vnodes=vnodes)
             for pkg in PKGS]
    steps = [("add", "r3"), ("add", "r4"), ("remove", "r1"), ("remove", "r3"),
             ("add", "r1"), ("remove", "r0"), ("remove", "r4")]
    before = {k: rings[1].route(k) for k in keys}
    for op, slot in [(None, None)] + steps:
        if op:
            for ring in rings:
                getattr(ring, op)(slot)
        jax_ring, port_ring = rings
        assert port_ring.slots() == jax_ring.slots() and len(port_ring) == len(jax_ring)
        for k in keys:
            assert port_ring.route(k) == jax_ring.route(k)
            assert port_ring.route_order(k) == jax_ring.route_order(k)
        if op == "add":
            # minimal movement: every key that moved went to the new slot
            moved = [k for k in keys if before[k] != port_ring.route(k)]
            assert moved and all(port_ring.route(k) == slot for k in moved)
        before = {k: port_ring.route(k) for k in keys}
    for pkg in PKGS:
        hashing = _mod(pkg, "fleet.hashing")
        with pytest.raises(_mod(pkg, "models.validation").InputError):
            hashing.HashRing([], vnodes=0)
        with pytest.raises(_mod(pkg, "models.validation").InputError):
            hashing.HashRing([]).route("k")
        assert hashing.HashRing([]).route_order("k") == []


# -- the routers in front of stub replicas -------------------------------------

#: what a stub replica's /metrics exposes: both packages' replica
#: families, so each router's allowlist picks its own
STUB_METRICS = "\n".join([
    "# HELP simon_serve_requests_total x", "simon_serve_requests_total 7",
    "simon_serve_shed_total 1", "simon_serve_queue_depth 0",
    "simon_serve_batches_total 3", "simon_jax_recompiles_total 0",
    "simon_jax_dispatches_total 3", "simon_nvcc_builds_total 0",
    "simon_launches_total 4", "simon_aot_store_hit_total 1",
    "simon_aot_store_save_total 0", 'simon_launches_site_total{site="scan"} 1',
    "simon_serve_tenant_requests_total 9", ""])


class StubReplica:
    """An HTTP stub of a serve replica (after tests/test_fleet.py's):
    POST answers a body made only of the request's content and its
    request id, so reroutes are byte-comparable; GET /metrics answers
    STUB_METRICS, any other GET a health document. No spawn()/alive():
    the router treats it as an externally managed replica."""

    def __init__(self, slot: str):
        self.slot = slot
        self.restarts = 0
        self.probe_failures = 0
        self.retry_after_s = 0

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, status, body, ctype="application/json", headers=()):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, STUB_METRICS.encode(), "text/plain")
                else:
                    self._send(200, json.dumps({"ok": True, "status": "ok",
                                                "degraded": False}).encode())

            def do_POST(self):
                payload = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                rid = self.headers.get(RID) or ""
                body = json.dumps({"echo": json.loads(payload.decode() or "{}"),
                                   "requestId": rid}, sort_keys=True).encode()
                self._send(200, body, headers=((RID, rid),))

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def probe(self):
        return {"probeOk": True, "degraded": False}

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@contextlib.contextmanager
def _router(pkg, replicas):
    router = _mod(pkg, "fleet.router").FleetRouter(
        replicas, port=0, probe_interval_s=0, forward_timeout_s=10.0)
    router.start()
    try:
        yield router
    finally:
        router.httpd.shutdown()
        router.httpd.server_close()
        router.telemetry.stop()


@contextlib.contextmanager
def _stubs(slots=("r0", "r1")):
    reps = [StubReplica(s) for s in slots]
    try:
        yield reps
    finally:
        for r in reps:
            with contextlib.suppress(OSError):
                r.stop()


def _post(router, payload, rid, tenant=None, path="/v1/simulate"):
    """(status, request-id header, answering slot, Retry-After, body)."""
    headers = {"Content-Type": "application/json", RID: rid}
    if tenant:
        headers["X-Simon-Tenant"] = tenant
    req = urllib.request.Request(f"http://{router.host}:{router.port}{path}",
                                 data=json.dumps(payload).encode(), headers=headers)
    try:
        resp = urllib.request.urlopen(req, timeout=20)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        return (resp.status, resp.headers.get(RID), resp.headers.get("X-Simon-Fleet-Replica"),
                resp.headers.get("Retry-After"), resp.read())


def _get(router, path):
    with urllib.request.urlopen(f"http://{router.host}:{router.port}{path}",
                                timeout=20) as resp:
        return resp.status, resp.headers.get("Retry-After"), resp.read()


def _mask(text: str) -> str:
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", text)


#: the port's allowlist names where the JAX package's stand
PORT_NAMES = {"simon_fleet_jax_recompiles_total": "simon_fleet_nvcc_builds_total",
              "simon_jax_recompiles_total": "simon_nvcc_builds_total",
              "simon_fleet_jax_dispatches_total": "simon_fleet_launches_total",
              "simon_jax_dispatches_total": "simon_launches_total"}


def _as_port_names(text: str) -> str:
    for a, b in PORT_NAMES.items():
        text = text.replace(a, b)
    return text


def test_routers_answer_alike_in_front_of_the_same_replicas():
    """Seeded tenants and payloads through each package's router in
    front of the same two stubs: the same statuses, bodies, request
    IDs and answering slots; /healthz byte for byte; the /metrics
    lines with numbers masked, each router re-exporting its own
    allowlist (the port's nvcc builds and launches)."""
    rng = np.random.RandomState(12)
    tenants = [f"t-{k}" for k in rng.randint(0, 10**6, 12)]
    payloads = [{"n": int(k), "apps": []} for k in rng.randint(0, 100, 12)]
    got = {}
    with _stubs() as reps:
        for pkg in PKGS:
            with _router(pkg, reps) as router:
                answers = [_post(router, p, f"rid-{i}", tenant=t)
                           for i, (p, t) in enumerate(zip(payloads, tenants))]
                answers.append(_post(router, {"tenant": tenants[0]}, "rid-body-tenant"))
                health = _get(router, "/healthz")
                metrics = _mod(pkg, "fleet.router").render_fleet_metrics(router).decode()
                got[pkg] = (answers, health, metrics, router.ring.route_order(tenants[0]))
    jax, port = got[JAX], got[PORT]
    assert port[0] == jax[0] and port[1] == jax[1] and port[3] == jax[3]
    assert all(a[0] == 200 and a[1] == f"rid-{i}" for i, a in enumerate(port[0][:-1]))
    assert {a[2] for a in port[0]} == {"r0", "r1"}
    assert json.loads(port[1][2])["status"] == "ok" and port[1][1] is None
    assert _mask(port[2]) == _mask(_as_port_names(jax[2]))
    assert 'simon_fleet_nvcc_builds_total{replica="r0"} 0' in port[2]
    assert 'simon_fleet_launches_total{replica="r1"} 4' in port[2]
    assert "jax" not in port[2] and "tenant_requests" not in port[2]
    names = [line.split()[2] for line in port[2].splitlines() if line.startswith("# HELP")]
    assert len(names) == len(set(names))
    # the bound: the allowlist's families x the replicas, no other label
    per_replica = [line for line in port[2].splitlines()
                   if 'replica="' in line and not line.startswith("#")]
    allow = _mod(PORT, "fleet.router").REPLICA_METRIC_ALLOWLIST
    assert len(per_replica) <= (len(allow) + 2) * 2


def test_midburst_death_reroutes_with_the_original_ids_in_both_routers():
    out = {}
    for pkg in PKGS:
        with _stubs() as reps, _router(pkg, reps) as router:
            victim = next(f"t{i}" for i in range(100) if router.ring.route(f"t{i}") == "r0")
            results = {}

            def burst(i, router=router, victim=victim, results=results):
                results[i] = _post(router, {"n": i}, f"burst-{i}", tenant=victim)

            threads = []
            for i in range(16):
                if i == 8:
                    reps[0].stop()  # the owner dies mid-burst
                threads.append(threading.Thread(target=burst, args=(i,)))
                threads[-1].start()
            for t in threads:
                t.join(timeout=30)
            reroutes = _counters(pkg).get("fleet_reroutes_total")
            after = _post(router, {"n": 99}, "after-death", tenant=victim)
            out[pkg] = ([(s, r, body) for s, r, _slot, _ra, body in
                         (results[i] for i in sorted(results))], after, reroutes > 0,
                        router._health["r0"])
    assert out[PORT] == out[JAX]
    statuses, after, rerouted, health = out[PORT]
    assert len(statuses) == 16 and all(s == 200 and r == f"burst-{i}"
                                       for i, (s, r, _b) in enumerate(statuses))
    assert after[0] == 200 and after[2] == "r1" and rerouted and health == "down"


def test_shed_healthz_and_probe_flaps_alike():
    """Every replica down: 503 + Retry-After with the request id in the
    header and the body; a proxied GET carries the id too; /healthz
    degrades with Retry-After; probe failures mark a replica down only
    at the threshold."""
    out = {}
    for pkg in PKGS:
        replica_mod = _mod(pkg, "fleet.replica")
        with _stubs() as reps, _router(pkg, reps) as router:
            req = urllib.request.Request(f"http://{router.host}:{router.port}/v1/state-digest",
                                         headers={RID: "get-rid"})
            with urllib.request.urlopen(req, timeout=20) as r:
                get_rid = r.headers.get(RID)
            reps[1].stop()

            def failing_probe(rep=reps[1]):
                rep.probe_failures += 1
                return {"probeOk": False, "error": "connection refused"}

            reps[1].probe = failing_probe
            marks = []
            for _ in range(replica_mod.PROBE_FAILURE_THRESHOLD):
                router._next_probe["r1"] = 0.0
                router.probe_once()
                marks.append(dict(router._health))
            status, retry_after, body = _get(router, "/healthz")
            doc = json.loads(body)
            for r in doc["replicas"]:
                assert r.pop("url") == reps[int(r["id"][1:])].url
            degraded = (status, retry_after, doc)
            reps[0].stop()
            router._mark("r0", "down")
            shed = _post(router, {"q": 1}, "shed-rid")
            out[pkg] = (get_rid, marks, degraded, shed,
                        _counters(pkg).get("fleet_probe_failures_total"))
    assert out[PORT] == out[JAX]
    get_rid, marks, degraded, shed, _fails = out[PORT]
    assert get_rid == "get-rid"
    assert [m["r1"] for m in marks] == ["up", "up", "down"]
    assert degraded[2]["status"] == "degraded" and int(degraded[1]) >= 1
    assert degraded[2]["reasons"] == ["replica r1 is down"]
    assert shed[0] == 503 and shed[1] == "shed-rid" and int(shed[3]) >= 1
    body = json.loads(shed[4])
    assert body["partial"] is True and body["reason"] == "fleet"
    assert body["requestId"] == "shed-rid"


# -- slot locks ----------------------------------------------------------------


def test_slot_locks_refuse_a_live_holder_and_reclaim_a_dead_one(tmp_path):
    """The lock file is one format: each package refuses a lock the
    other holds for a live pid, reclaims one whose holder is dead, and
    re-acquires its own."""
    for holder_pkg, taker_pkg in ((JAX, PORT), (PORT, JAX), (PORT, PORT)):
        path = str(tmp_path / f"{holder_pkg[-5:]}-{taker_pkg[-5:]}.lock")
        held = _mod(holder_pkg, "fleet.replica").SlotLock(path)
        held.acquire(owner_pid=os.getpid())
        taker = _mod(taker_pkg, "fleet.replica")
        with pytest.raises(taker.DoubleSpawnError) as e:
            taker.SlotLock(path).acquire(owner_pid=2)
        assert isinstance(e.value, _mod(taker_pkg, "models.validation").InputError)
        again = taker.SlotLock(path)
        again.acquire()  # the same pid: not a double spawn
        held.release()
        assert not os.path.exists(path)
        with open(path, "w") as f:
            json.dump({"pid": 2**22 + 12345}, f)  # a holder that is gone
        stale = taker.SlotLock(path)
        stale.acquire(owner_pid=os.getpid())
        assert stale.held and json.load(open(path)) == {"pid": os.getpid()}
        stale.release()
        assert not os.path.exists(path)


# -- the audit timeline --------------------------------------------------------


def _audit_run(pkg, path, seed):
    rng = np.random.RandomState(seed)
    steps = iter(np.cumsum(rng.uniform(0.01, 2.0, 64)).round(6).tolist())
    mono = [100.0]

    def clock():
        mono[0] = 100.0 + next(steps)
        return mono[0]

    audit = _mod(pkg, "fleet.audit").FailoverAudit(path, clock=clock,
                                                   wall=lambda: 1.7e9 + mono[0])
    audit.note_probe_flap("r0", failures=1)
    audit.note_probe_ok("r0")  # a flap that recovered
    assert audit.note_first_200("r0") is None
    audit.note_probe_flap("r1", failures=1)
    audit.note_probe_flap("r1", failures=2)
    audit.note_declared_dead("r1", reason="3 consecutive probe failures")
    assert audit.pending("r1")
    audit.note_lock_reclaim("r1")
    audit.note_respawn("r1", ok=False, error="listening line timed out")
    audit.note_respawn("r1", ok=True, pid=4242)
    audit.note_replay_progress("r1", delta_seq=int(rng.randint(1, 9)))
    first = audit.note_first_200("r1")
    audit.note_declared_dead("r0", reason="process exited")  # straight to death
    audit.note_lock_reclaim("r0")
    audit.note_respawn("r0", ok=True, pid=4343)
    audit.note_replay_progress("r0", delta_seq=None)
    second = audit.note_first_200("r0")
    audit.close()
    counters = _mod(pkg, "fleet.audit").COUNTERS
    return (first, second, audit.completed, counters.get("fleet_failovers_audited_total"),
            counters.snapshot()["gauges"])


@pytest.mark.parametrize("seed", [1, 8])
def test_audit_timelines_equal_and_each_validator_reads_the_other_log(tmp_path, seed):
    logs, runs = {}, {}
    for pkg in PKGS:
        logs[pkg] = str(tmp_path / f"{pkg}.jsonl")
        runs[pkg] = _audit_run(pkg, logs[pkg], seed)
    assert runs[PORT] == runs[JAX]
    assert open(logs[PORT]).read() == open(logs[JAX]).read()
    first, second, completed, audited, gauges = runs[PORT]
    assert audited == 2 and completed == [first, second]
    assert abs(sum(first["phases"].values()) - first["totalSeconds"]) < 1e-5
    assert gauges["fleet_failover_seconds"] == second["totalSeconds"]
    summaries = {}
    for reader in PKGS:
        validate = _mod(reader, "fleet.audit").validate_audit_log
        for writer in PKGS:
            doc = validate(logs[writer])
            doc.pop("path")
            summaries[(reader, writer)] = doc
    assert len({json.dumps(v, sort_keys=True) for v in summaries.values()}) == 1
    assert summaries[(PORT, JAX)]["complete"] == 2
    # a torn tail is dropped and counted, interior damage refused, alike
    with open(logs[JAX], "a") as f:
        f.write('{"slot": "r0", "pha')
    lines = open(logs[PORT]).read().splitlines()
    lines[2] = '{"not json'
    open(logs[PORT], "w").write("\n".join(lines) + "\n")
    for reader in PKGS:
        audit = _mod(reader, "fleet.audit")
        assert audit.read_audit_log(logs[JAX])[1] == 1
        with pytest.raises(_mod(reader, "models.validation").InputError):
            audit.read_audit_log(logs[PORT])


# -- the stitched trace --------------------------------------------------------


def _spans(seed):
    """Router spans of two requests (one rerouted) and two replica
    dumps; r0's holds a serve/request naming r1's forward (a shared
    recorder's double), which must not stitch."""
    rng = np.random.RandomState(seed)
    t = np.cumsum(rng.uniform(0.001, 0.05, 40)).round(6).tolist()

    def ev(i, name, parent, t0, t1, **attrs):
        return {"id": i, "parent": parent, "name": name, "t0": t[t0], "t1": t[t1],
                "tid": int(rng.randint(1, 9)), "attrs": attrs}

    rid, other = "rid-stitch", "rid-other"
    router = [
        ev(1, "fleet/request", None, 0, 20, request_id=rid, method="POST", key="k"),
        ev(2, "fleet/reroute", 1, 1, 2, request_id=rid, slot="r0", attempt=1,
           error="URLError"),
        ev(3, "fleet/forward", 1, 3, 19, request_id=rid, slot="r1", attempt=2),
        ev(4, "fleet/request", None, 21, 30, request_id=other),
        ev(5, "fleet/forward", 4, 22, 29, request_id=other, slot="r0", attempt=1),
        ev(6, "serve/request", None, 0, 1, request_id=rid),  # not a fleet span
    ]
    replica = {
        "r1": [ev(10, "serve/request", None, 5, 18, request_id=rid, remote_parent=3),
               ev(11, "serve/queue_wait", 10, 6, 8, request_id=rid),
               ev(12, "serve/evaluate", 10, 8, 17, request_id=rid),
               ev(13, "serve/request", None, 31, 33, request_id=rid)],  # direct
        "r0": [ev(20, "serve/request", None, 5, 18, request_id=rid, remote_parent=3),
               ev(21, "serve/request", None, 23, 28, request_id=other, remote_parent=5)],
    }
    return rid, router, replica


@pytest.mark.parametrize("seed", [2, 9])
def test_stitched_traces_equal(seed):
    rid, router, replica = _spans(seed)
    docs = {}
    for pkg in PKGS:
        trace = _mod(pkg, "fleet.trace")
        stitched = trace.stitch_request_trace(rid, router, replica)
        docs[pkg] = (stitched, trace.chrome_trace_doc(stitched, rid))
    assert docs[PORT] == docs[JAX]
    stitched = docs[PORT][0]
    assert [s["name"] for s in stitched] == ["fleet/request", "fleet/reroute", "fleet/forward",
                                             "serve/request", "serve/queue_wait",
                                             "serve/evaluate"]
    assert stitched[3]["parent"] == stitched[2]["id"] and stitched[3]["pid"] == 2
    assert docs[PORT][1]["simonFleetTrace"] == {"requestId": rid, "spans": 6}


# -- the injection cells (tests/test_chaos_matrix.py FLEET_CELLS) ---------------

FLEET_CELLS = [
    ("ExternalIOError", "fleet.route=exio@1"),
    ("ExternalIOError", "fleet.probe=exio%3"),
    ("ConformanceError", "fleet.replay=conformance@1"),
    ("BackendUnavailable", "fleet.spawn=backend@1"),
]


def _cell(pkg, error, spec, tmp_path):
    inject = _mod(pkg, "runtime.inject").INJECT
    errors = _mod(pkg, "runtime.errors")
    site = spec.split("=")[0]
    if site == "fleet.route":
        with _stubs(("fx0", "fx1")) as reps, _router(pkg, reps) as router:
            inject.configure(spec)  # the first hop only: a reroute
            once = _post(router, {}, "cell-rid-1", tenant="cell-t")
            inject.configure("fleet.route=exio@1x*")  # every hop: the shed
            shed = _post(router, {}, "cell-rid-2", tenant="cell-t2")
            inject.clear()
            c = _counters(pkg)
            return (once[:2], once[4], shed[:2], shed[4], c.get("fleet_reroutes_total") > 0,
                    c.get("fleet_shed_total"))
    if site == "fleet.probe":
        with _stubs(("fx0", "fx1")) as reps, _router(pkg, reps) as router:
            inject.configure(spec)
            for k in range(6):
                router.probe_once(now=float(k + 1))
            inject.clear()
            after = _post(router, {}, "after-flap")
            return (_counters(pkg).get("fleet_probe_failures_total"),
                    [r.probe_failures for r in reps], dict(router._health), after[:2])
    if site == "fleet.replay":
        replay = _mod(pkg, "fleet.replay")
        sessions = _mod(pkg, "serve.sessions")
        path = str(tmp_path / f"{pkg}.snapshot.jsonl")
        sessions.open_snapshot(path).close()
        session = _serve_session(pkg)
        inject.configure(spec)
        try:
            with pytest.raises(errors.GuardError) as e:
                replay.replay_into_session(session, path)
        finally:
            inject.clear()
        return (type(e.value).__name__,)
    # fleet.spawn: a retried attempt, then the launch; and through the
    # CLI, a spawn that exhausts its attempts exits 2
    rep = _mod(pkg, "fleet.replica").ReplicaProcess(
        "cell-slot", [sys.executable, "-u", "-c",
                      "import time; print('stub listening on http://127.0.0.1:9', "
                      "flush=True); time.sleep(60)"], str(tmp_path))
    sleeps = []
    inject.configure(spec)
    try:
        url = rep.spawn(attempts=3, sleep=sleeps.append)
    finally:
        inject.clear()
        rep.kill()
        rep.release()
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: c}\n"
                   "spec:\n  cluster: {customConfig: example/cluster/demo}\n")
    argv = ["fleet", "-f", str(cfg), "--fleet-dir", str(tmp_path / f"f-{pkg}"),
            "--port", "0", "--spawn-attempts", "1", "--inject", "fleet.spawn=backend@1x*"]
    rc, _out, err = _run_cli(pkg, argv + (["--device", "cpu"] if pkg == PORT else []))
    inject.clear()
    return (url, len(sleeps), sleeps[0] > 0,
            _mod(pkg, "fleet.replica").COUNTERS.get("fleet_spawn_retry_total"), rc,
            err.strip().splitlines()[-1].split(":")[0], os.listdir(tmp_path / f"f-{pkg}"))


def _serve_session(pkg):
    decode = _mod(pkg, "models.decode")
    cluster = decode.ResourceTypes()
    cluster.nodes = [{"kind": "Node", "metadata": {"name": f"fx-n-{i}"},
                      "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}}}
                     for i in range(2)]
    kw = {"device": "cpu"} if pkg == PORT else {}
    return _mod(pkg, "serve.session").Session(cluster, **kw)


def _run_cli(pkg, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = _mod(pkg, "cli").main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("error,spec", FLEET_CELLS, ids=[s.split("=")[0] for _e, s in FLEET_CELLS])
def test_fleet_injection_cells_equal_the_jax_package(error, spec, tmp_path):
    got = {pkg: _cell(pkg, error, spec, tmp_path) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    res = got[PORT]
    if spec.startswith("fleet.route"):
        assert res[0] == (200, "cell-rid-1") and res[2] == (503, "cell-rid-2") and res[4]
    elif spec.startswith("fleet.probe"):
        assert res[0] > 0 and "down" not in res[2].values() and res[3] == (200, "after-flap")
    elif spec.startswith("fleet.replay"):
        assert res == (error,)
    else:
        assert res[:4] == ("http://127.0.0.1:9", 1, True, 2) and res[4] == 2
        assert res[5] == "error" and res[6] == []


# -- `simon fleet --device cpu` with a SIGKILL -----------------------------------


def _http(url, doc=None, headers=None, timeout=60):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json",
                                                          **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        return resp.status, dict(resp.headers), resp.read()


def _sample(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not exposed")


def _replica(base, slot):
    doc = json.loads(_http(base + "/healthz")[2])
    return next(r for r in doc["replicas"] if r["id"] == slot)


def test_fleet_cli_kill9_replacement_restores_the_dead_replicas_state(tmp_path):
    """`simon fleet --device cpu --replicas 2` on example/cluster/demo: a
    delta journaled for r0's tenant, r0 killed with SIGKILL, the probe
    loop respawns it into its slot; the replacement's state digest and
    deltaSeq equal the dead replica's, it built nothing, the audit log
    validates in both packages, `top --fleet` reads the router, and a
    SIGTERM drains the fleet with exit 0 and the slot locks released."""
    cfg = tmp_path / "fleet.yaml"
    cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: fleet}\n"
                   f"spec:\n  cluster: {{customConfig: {ROOT}/example/cluster/demo}}\n")
    fleet_dir = tmp_path / "fleet"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.cli", "fleet", "-f", str(cfg), "--replicas", "2",
         "--port", "0", "--fleet-dir", str(fleet_dir), "--probe-interval", "0.5",
         "--drain-timeout", "30", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "simon fleet listening on http://" in line, proc.stderr.read()[-3000:]
        base = line.split("listening on ", 1)[1].split()[0]
        ring = _mod(PORT, "fleet.hashing").HashRing(["r0", "r1"])
        tenant = next(f"t{i}" for i in range(100) if ring.route(f"t{i}") == "r0")
        pod = {"kind": "Pod", "metadata": {"name": "late", "namespace": "x"},
               "spec": {"containers": [{"name": "c", "image": "i", "resources": {
                   "requests": {"cpu": "100m", "memory": "64Mi"}}}]}}
        status, hdrs, body = _http(base + "/v1/cluster-delta", {"kind": "pod_arrive",
                                                                "pod": pod},
                                   {"X-Simon-Tenant": tenant})
        assert status == 200 and hdrs["X-Simon-Fleet-Replica"] == "r0", body
        dead = _replica(base, "r0")
        digest = json.loads(_http(dead["url"] + "/v1/state-digest")[2])
        assert digest["deltaSeq"] == 1
        os.kill(dead["pid"], signal.SIGKILL)
        what_if = {"apps": [{"name": "w", "yaml": json.dumps(
            {**pod, "metadata": {"name": "w", "namespace": "x"}})}]}
        status, hdrs, rerouted = _http(base + "/v1/simulate", what_if,
                                       {"X-Simon-Tenant": tenant, RID: "rerouted"})
        assert status == 200 and hdrs[RID] == "rerouted" and hdrs["X-Simon-Fleet-Replica"] == "r1"
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            new = _replica(base, "r0")
            if new["restarts"] == 1 and new["status"] == "up":
                break
            time.sleep(0.2)
        assert new["restarts"] == 1 and new["pid"] != dead["pid"], new
        assert json.loads(_http(new["url"] + "/v1/state-digest")[2]) == digest
        metrics = _http(new["url"] + "/metrics")[2].decode()
        assert _sample(metrics, "simon_nvcc_builds_total") == 0
        assert _sample(metrics, "simon_fleet_replay_deltas_total") == 1
        # the first 200 through the respawned slot closes the episode
        status, hdrs, _b = _http(base + "/v1/simulate", what_if, {"X-Simon-Tenant": tenant})
        assert status == 200 and hdrs["X-Simon-Fleet-Replica"] == "r0"
        # the rerouted answer is the survivor's own
        r1 = _replica(base, "r1")["url"]
        assert _http(r1 + "/v1/simulate", what_if)[2] == rerouted
        metrics = _http(new["url"] + "/metrics")[2].decode()
        ticks = _sample(metrics, "simon_serve_batches_total")
        # a tick is one batch-kernel launch (its plain version here),
        # beside the warm-up's
        assert ticks >= 1 and _sample(
            metrics, 'simon_launches_site_total{site="scenario_scan"}') == ticks + 1
        router_metrics = _http(base + "/metrics")[2].decode()
        assert _sample(router_metrics, "simon_fleet_failovers_total") == 1
        assert 'simon_fleet_nvcc_builds_total{replica="r0"} 0' in router_metrics
        for flags in (["--once"], ["--format", "json"]):
            rc, out, _err = _run_cli(PORT, ["top", "--fleet", "--url", base, *flags])
            assert rc == 0 and ("r0" in out)
        audit = str(fleet_dir / "failover-audit.jsonl")
        for pkg in PKGS:
            doc = _mod(pkg, "fleet.audit").validate_audit_log(audit)
            assert doc["complete"] == 1 and doc["slots"] == ["r0"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0
    assert not list(fleet_dir.glob("*.lock"))
