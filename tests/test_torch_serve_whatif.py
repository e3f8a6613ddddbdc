"""The port's `simon serve` as the benchmark's basic-whatif cell drives it,
on the CPU (the kernels' plain versions): a daemon built in process by
`cli.build_serve_daemon` from the CLI's own arguments, holding the cell's
cluster at a test's size (60 nodes of scheduler_perf's node-default.yaml,
1,800 committed pods of pod-default.yaml, 30 a node), answering 16
concurrent what-ifs over HTTP in one tick.

Every body's placements equal the plain reference's
(benchmark/reference/kube_v120_whatif.py), no body holds another
request's pods, the tick enters `serve/scan` and `serve/payload` once
and counts its bodies' bytes, it holds the cyclic collector off and
collects its young generations once, and `cmd_serve` builds the daemon
that `build_serve_daemon` builds for the same arguments.

This file imports neither JAX nor the JAX package."""

import gc
import http.client
import json
import threading
import time
from pathlib import Path

import pytest

from benchmark import check_whatif, generate, generate_whatif
from benchmark.reference import kube_v120_whatif
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.serve.server import ServeDaemon, parse_request_body
from open_simulator_tpu_torch.utils.gcscope import YOUNG
from open_simulator_tpu_torch.utils.trace import COUNTERS, GLOBAL

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 77
NODES, COMMITTED, CLIENTS = 60, 1800, 16


def _cluster() -> generate.Instance:
    with open(REPO / "benchmark" / "configs" / "k8s-5k-serve.json") as f:
        cfg = json.load(f)
    cfg["nodes"] = NODES
    cfg["committed"]["replicas"] = COMMITTED
    return generate_whatif.make_cluster(cfg, SEED)


def _round(cluster) -> generate_whatif.Round:
    """16 what-ifs of 5 replicas, the caller's c of (c + 1) x 100m: the
    first ten fit beside the committed pods (3,000m of a node's 4,000m
    taken), the rest fit nowhere."""
    with open(REPO / "benchmark" / "traffic" / "whatif-16.json") as f:
        mix = json.load(f)
    mix["workloads"][0]["replicas"] = 5
    rnd = generate_whatif.make_round(cluster, mix, SEED, 0)
    for c, inst in enumerate(rnd.whatifs):
        inst.workloads[0].cpu = f"{100 * (c + 1)}m"
    return rnd


def _args(path, *flags):
    return cli.build_parser().parse_args(
        ["serve", "-f", path, "--port", "0", "--device", "cpu", *flags])


def _post(daemon, body: bytes):
    conn = http.client.HTTPConnection(daemon.host, daemon.port, timeout=120)
    try:
        conn.request("POST", "/v1/simulate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One round of 16 concurrent POSTs, held in the queue until all
    are there so that they coalesce into one tick: (the cluster, the
    round, the replies, the tick's phase counts, the bytes counted)."""
    cluster = _cluster()
    path = generate_whatif.write_cluster(cluster, str(tmp_path_factory.mktemp("whatif")))
    daemon = cli.build_serve_daemon(_args(path, "--max-batch", str(CLIENTS)))
    daemon.coalescer.hold = threading.Event()
    daemon.start()
    try:
        rnd = _round(cluster)
        replies = [None] * CLIENTS

        def call(c):
            replies[c] = _post(daemon, generate_whatif.envelope(rnd.whatifs[c]))

        GLOBAL.reset()
        bytes0 = COUNTERS.get("serve_reply_bytes_total")
        callers = [threading.Thread(target=call, args=(c,)) for c in range(CLIENTS)]
        for t in callers:
            t.start()
        deadline = time.monotonic() + 60
        while daemon.coalescer.depth < CLIENTS and time.monotonic() < deadline:
            time.sleep(0.01)
        assert daemon.coalescer.depth == CLIENTS
        daemon.coalescer.hold.set()
        for t in callers:
            t.join(timeout=120)
            assert not t.is_alive()
        counts = {p["name"]: p["count"] for p in GLOBAL.as_dict()["phases"]}
        counted = COUNTERS.get("serve_reply_bytes_total") - bytes0
        yield cluster, rnd, replies, counts, counted
    finally:
        assert daemon.shutdown() == 0


def test_every_body_equals_the_reference(served):
    cluster, rnd, replies, _, _ = served
    committed = kube_v120_whatif.Committed(cluster)
    placed = []
    for inst, (status, body) in zip(rnd.whatifs, replies):
        assert status == 200
        ref = committed.place(inst)
        nums, own, err = check_whatif.judge(body, inst, cluster, ref)
        assert err is None and nums == {k: 0 for k in check_whatif.LIMITS}, inst.tag
        placed.append(own)
    # the first ten fit, on five nodes each; the rest fit nowhere
    assert placed == [5] * 10 + [0] * 6


def test_no_body_holds_another_requests_pods(served):
    _, rnd, replies, _, _ = served
    names = {inst.workloads[0].name for inst in rnd.whatifs}
    for inst, (_, body) in zip(rnd.whatifs, replies):
        doc = json.loads(body)
        owners = {p["name"].rsplit("-", 2)[0] for node in doc["nodes"] for p in node["pods"]
                  if p["namespace"] == inst.namespace}
        owners |= {p["name"].rsplit("-", 2)[0] for p in doc["unscheduledPods"]}
        assert owners & names == {inst.workloads[0].name}


def test_the_tick_enters_scan_and_payload_once_and_counts_its_bytes(served):
    _, _, replies, counts, counted = served
    assert counts["serve/scan"] == counts["serve/payload"] == counts["serve/replay"] == 1
    assert counts["serve/gc"] == 1
    assert counted == sum(len(body) for _, body in replies)


def test_a_tick_holds_the_collector_off_and_collects_its_young_generations_once(tmp_path):
    """At Kubernetes' size limit a tick's bodies allocate 150,000 pod
    entries each, and with the collector on they set off full
    collections, each a walk of the committed roster: the tick holds
    the collector off and ends with one collection of generations 0-1
    (`serve/gc`), leaving it on."""
    cluster = _cluster()
    path = generate_whatif.write_cluster(cluster, str(tmp_path / "cluster"))
    daemon = cli.build_serve_daemon(_args(path))
    try:
        reqs = [parse_request_body(generate_whatif.envelope(inst), "application/json")[0]
                for inst in _round(cluster).whatifs]
        seen = []

        def hook(phase, info):
            if phase == "start":
                seen.append(info["generation"])

        GLOBAL.reset()
        gc.callbacks.append(hook)
        try:
            replies = daemon.session.evaluate_batch(reqs)
        finally:
            gc.callbacks.remove(hook)
        assert [r.status for r in replies] == [200] * CLIENTS
        assert seen == [YOUNG] and gc.isenabled()
        assert {p["name"]: p["count"] for p in GLOBAL.as_dict()["phases"]}["serve/gc"] == 1
    finally:
        daemon.httpd.server_close()


def _describe(d: ServeDaemon) -> tuple:
    s = d.session
    return (d.host, s.fingerprint, s.state_digest(), s.incremental, str(s.device),
            s._committed is not None, d.coalescer.max_batch, d.coalescer.queue_depth,
            d.default_deadline_s, d.drain_timeout_s, d.admission.max_batch,
            d.admission.tick_budget_s, d.admission.max_request_pods, d.sessions.capacity)


def test_cmd_serve_builds_the_daemon_the_shared_function_builds(tmp_path, monkeypatch, capsys):
    path = generate_whatif.write_cluster(_cluster(), str(tmp_path / "cluster"))
    flags = ("--max-batch", "16", "--queue-depth", "40", "--drain-timeout", "5",
             "--max-sessions", "3", "--default-deadline", "90")
    seen = []

    def run(daemon):
        seen.append(_describe(daemon))
        return daemon.shutdown()

    monkeypatch.setattr(ServeDaemon, "run_until_signaled", run)
    assert cli.main(["serve", "-f", path, "--port", "0", "--device", "cpu", *flags]) == 0
    assert "listening on http://" in capsys.readouterr().out
    built = cli.build_serve_daemon(_args(path, *flags))
    try:
        assert seen == [_describe(built)]
        assert seen[0][5] and seen[0][6:9] == (16, 40, 90.0)
    finally:
        built.httpd.server_close()
