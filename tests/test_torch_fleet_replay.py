"""Failover of the serve daemon in the GPU port (fleet/replay.py and
`simon serve --replay-snapshot`) against the JAX package's.

Each package's session journals the same seeded delta stream with
interval checkpoints; `read_session_events`, `restore_into_session` and
`replay_into_session` then give equal records, restore summaries and
state digests on either package's journal. A port daemon killed with
SIGKILL and replaced by `serve --replay-snapshot` answers with the dead
daemon's state digest and its bodies, which are the JAX session's. The
port's sessions run on the CPU (the kernels' plain versions).
"""

import copy
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from open_simulator_tpu.testing import make_fake_pod

JAX = "open_simulator_tpu"
PORT = "open_simulator_tpu_torch"
PKGS = (JAX, PORT)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _port_names():
    from open_simulator_tpu_torch.models.workloads import reset_name_counter

    reset_name_counter()
    yield


def _node(name, cpu=8):
    return {"kind": "Node", "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": str(cpu), "memory": "32Gi", "pods": "110"}}}


def _cluster(pkg):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [_node(f"fr-n-{i}") for i in range(3)]
    cluster.pods = [make_fake_pod(f"fr-p{i:02d}", "default", "250m", "512Mi") for i in range(10)]
    return cluster


def _deltas(seed=3, n=7):
    """A seeded stream of evictions of the base pods and arrivals."""
    import random

    rng = random.Random(seed)
    names = [f"fr-p{i:02d}" for i in range(10)]
    rng.shuffle(names)
    out = []
    for k in range(n):
        if k % 3 == 2:
            out.append({"kind": "pod_arrive",
                        "pod": make_fake_pod(f"fr-new{k}", "default", "500m", "1Gi")})
        else:
            out.append({"kind": "pod_evict", "namespace": "default", "name": names.pop()})
    return out


def _session(pkg, cluster):
    kw = {"device": "cpu"} if pkg == PORT else {}
    return _mod(pkg, "serve.session").Session(cluster, **kw)


def _journaled(tmp_path, pkg, interval=3):
    """A session that applied `_deltas()` with every delta journaled and
    a synchronous checkpoint manager; returns (session, snapshot path)."""
    sessions = _mod(pkg, "serve.sessions")
    sess = _mod(pkg, "serve.session")
    ck = _mod(pkg, "runtime.checkpoint")
    dl = _mod(pkg, "twin.deltas")
    session = _session(pkg, _cluster(pkg))
    path = str(tmp_path / f"{pkg}.snapshot.jsonl")
    journal = sessions.open_snapshot(path)
    cache = sessions.SessionCache(capacity=2, snapshot=journal)
    mgr = ck.CheckpointManager(
        ck.checkpoint_dir(path), interval=interval, keep=2,
        capture=lambda: sess.session_checkpoint_state(session),
        materialized_digest=lambda p: sess.verify_payload_digest(session, p),
        journal=journal, keep_record=sessions.serve_keep_record(session.fingerprint),
        label="serve", synchronous=True)
    for rec in _deltas():
        d = dl.ClusterDelta.from_record(copy.deepcopy(rec))
        out, seq = session.apply_delta_seq(d)
        assert out == "applied"
        cache.record_delta(session.fingerprint, d.as_record(), seq=seq)
        mgr.note_delta(seq)
    journal.close()
    return session, path


def _fingerprint(pkg):
    sessions = _mod(pkg, "serve.sessions")
    return _mod(pkg, "runtime.journal").config_fingerprint(
        {"format": "serve-session-snapshot", "version": sessions.SNAPSHOT_VERSION})


def _strip(records):
    """The records without their wall-clock stamps."""
    return [{k: v for k, v in r.items() if k not in ("ts", "time", "at")} for r in records]


def test_read_session_events_equal_on_either_journal(tmp_path):
    paths = {pkg: _journaled(tmp_path, pkg)[1] for pkg in PKGS}
    got = {}
    for reader in PKGS:
        replay = _mod(reader, "fleet.replay")
        for writer in PKGS:
            records, dropped = replay.read_session_events(paths[writer], _fingerprint(reader))
            got[reader, writer] = (_strip(records), dropped)
    assert got[PORT, PORT] == got[JAX, PORT]
    assert got[PORT, JAX] == got[JAX, JAX]
    assert [r.get("seq") for r in got[PORT, PORT][0] if r.get("event") == "delta"] == \
        [r.get("seq") for r in got[JAX, JAX][0] if r.get("event") == "delta"]


def test_torn_tail_dropped_and_interior_damage_refused(tmp_path):
    _s, path = _journaled(tmp_path, PORT)
    replay = _mod(PORT, "fleet.replay")
    journal = _mod(PORT, "runtime.journal")
    with open(path, "a") as f:
        f.write('{"kind": "session", "event": "del')
    records, dropped = replay.read_session_events(path, _fingerprint(PORT))
    assert dropped == 1 and records
    lines = open(path).read().splitlines()
    lines[2] = "{corrupt"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(journal.JournalMismatch, match="corrupt journal record"):
        replay.read_session_events(path, _fingerprint(PORT))
    with pytest.raises(journal.JournalMismatch, match="fingerprint"):
        replay.read_session_events(path, "other")


@pytest.mark.parametrize("writer", PKGS)
def test_restore_and_replay_give_the_live_state_in_both_packages(tmp_path, writer):
    """Checkpoint restore, then the journal suffix, on each package's
    replica of either package's journal: every replica reaches the live
    session's delta sequence and state digest; the summaries agree."""
    live, path = _journaled(tmp_path, writer)
    summaries, digests = {}, {}
    for reader in PKGS:
        replay = _mod(reader, "fleet.replay")
        replica = _session(reader, _cluster(reader))
        restored = replay.restore_into_session(_session(reader, _cluster(reader)), path)
        assert restored is not None and restored["deltaSeq"] == 6
        summary = replay.replay_into_session(replica, path)
        summary["checkpoint"].pop("path")
        summaries[reader] = summary
        digests[reader] = (replica.delta_seq, replica.state_digest())
        if reader == PORT:
            assert (replica._committed_scan().state_digest()
                    == _session(PORT, _mod(PORT, "serve.session").cluster_from_payload(
                        _mod(PORT, "serve.session").cluster_payload(replica.cluster)))
                    ._committed_scan().state_digest())
    assert summaries[PORT] == summaries[JAX]
    # generations 6 and 3 kept: the journal was compacted past seq 3
    assert summaries[PORT]["deltas"] == 1 and summaries[PORT]["skippedPrefix"] == 3
    assert digests[PORT] == digests[JAX] == (live.delta_seq, live.state_digest())


def test_full_replay_without_checkpoints_equals_the_jax_package(tmp_path):
    paths = {pkg: _journaled(tmp_path, pkg, interval=100)[1] for pkg in PKGS}
    out = {}
    for pkg in PKGS:
        replica = _session(pkg, _cluster(pkg))
        summary = _mod(pkg, "fleet.replay").replay_into_session(
            replica, paths[pkg], use_checkpoints=False)
        out[pkg] = (summary, replica.delta_seq, replica.state_digest())
    assert out[PORT] == out[JAX]
    assert out[PORT][0]["deltas"] == len(_deltas()) and out[PORT][0]["checkpoint"] is None


# -- `simon serve --replay-snapshot` ----------------------------------------


def _write_config(tmp_path):
    import yaml

    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir()
    cluster = _cluster(PORT)
    with open(cluster_dir / "objects.yaml", "w") as f:
        yaml.safe_dump_all(cluster.nodes + cluster.pods, f)
    cfg = tmp_path / "serve-config.yaml"
    cfg.write_text("apiVersion: simon/v1alpha1\nkind: Config\nmetadata: {name: fr}\n"
                   f"spec:\n  cluster: {{customConfig: {cluster_dir} }}\n")
    return cfg


def _start(cfg, snapshot, tmp_path, tag, *extra):
    err = open(tmp_path / f"{tag}.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "serve", "-f", str(cfg),
         "--port", "0", "--device", "cpu", "--snapshot", str(snapshot),
         "--checkpoint-interval", "3", *extra],
        stdout=subprocess.PIPE, stderr=err, text=True)
    ready = proc.stdout.readline()
    assert "listening on http://" in ready, (tmp_path / f"{tag}.err").read_text()[-3000:]
    return proc, ready.split("listening on ", 1)[1].split()[0].rstrip("/")


def _http(base, path, doc=None):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def _whatif():
    dep = {"kind": "Deployment", "metadata": {"name": "w", "namespace": "fr"},
           "spec": {"replicas": 5, "template": {"spec": {"containers": [{
               "name": "c", "image": "i",
               "resources": {"requests": {"cpu": "2", "memory": "2Gi"}}}]}}}}
    return {"apps": [{"name": "w", "yaml": json.dumps(dep)}]}


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not exported")


def test_serve_replay_snapshot_answers_like_the_dead_daemon_and_the_jax_session(tmp_path):
    cfg = _write_config(tmp_path)
    snapshot = tmp_path / "snap.jsonl"
    dead, base = _start(cfg, snapshot, tmp_path, "dead")
    try:
        for rec in _deltas():
            status, _b = _http(base, "/v1/cluster-delta", {"deltas": [rec]})
            assert status == 200
        _s, digest = _http(base, "/v1/state-digest")
        _s, answer = _http(base, "/v1/simulate", _whatif())
        # the checkpoint worker writes generation 6 off the request path
        for _ in range(200):
            _s, m = _http(base, "/metrics")
            if _metric(m.decode(), "simon_ckpt_writes_total") >= 2:
                break
            time.sleep(0.05)
    finally:
        dead.send_signal(signal.SIGKILL)
        dead.wait(timeout=60)
        dead.stdout.close()
    new, base = _start(cfg, snapshot, tmp_path, "new", "--replay-snapshot")
    try:
        _s, digest2 = _http(base, "/v1/state-digest")
        _s, answer2 = _http(base, "/v1/simulate", _whatif())
        _s, m = _http(base, "/metrics")
    finally:
        new.send_signal(signal.SIGTERM)
        assert new.wait(timeout=120) == 0
        new.stdout.close()
    assert json.loads(digest2) == json.loads(digest)
    assert answer2 == answer
    text = m.decode()
    # the replayed suffix: the journal's deltas past the newest generation
    # (the checkpoint worker captures off the request path, so which
    # sequence it captured depends on timing)
    ck = _mod(PORT, "runtime.checkpoint")
    gen = ck.load_checkpoint(ck.list_checkpoints(ck.checkpoint_dir(str(snapshot)))[0][1])[0]
    suffix = sum(1 for line in snapshot.read_text().splitlines()[1:]
                 if line.strip() and json.loads(line).get("event") == "delta"
                 and json.loads(line).get("seq", 0) > gen["deltaSeq"])
    assert gen["deltaSeq"] >= 3 and suffix == len(_deltas()) - gen["deltaSeq"]
    assert _metric(text, "simon_ckpt_restore_total") == 1
    assert _metric(text, "simon_fleet_replay_deltas_total") == suffix
    err = (tmp_path / "new.err").read_text()
    assert "restored checkpoint" in err and f"replayed {suffix} cluster delta(s)" in err
    # the JAX session over the same deltas answers the same body
    jax_sess = _mod(JAX, "serve.session")
    session = jax_sess.Session(_cluster(JAX))
    for rec in _deltas():
        session.apply_delta(_mod(JAX, "twin.deltas").ClusterDelta.from_record(rec))
    req, _d, _t = _mod(JAX, "serve.server").parse_request_body(
        json.dumps(_whatif()).encode(), "application/json")
    assert session.evaluate_batch([req])[0].body == answer
    assert json.loads(digest)["stateDigest"] == session.state_digest()


def test_replay_snapshot_requires_snapshot(tmp_path, capsys):
    from open_simulator_tpu_torch import cli

    rc = cli.main(["serve", "-f", str(_write_config(tmp_path)), "--port", "0", "--no-warm",
                   "--device", "cpu", "--replay-snapshot"])
    out = capsys.readouterr()
    assert rc == 2 and "--replay-snapshot requires --snapshot PATH" in out.err
    assert os.path.exists(tmp_path / "serve-config.yaml")
