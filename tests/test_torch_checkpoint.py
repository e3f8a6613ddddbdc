"""Bounded-recovery checkpoints of the GPU port
(`open_simulator_tpu_torch.runtime.checkpoint`) against the JAX
package's: the same file format and toolchain digest, so a generation
written by either package loads in the other; write, verify, prune and
rotate under the serve session's manager; loud refusal of torn, corrupt
and stale generations; and the corrupt-newest fallback, where the
previous generation plus the journal's longer suffix reaches the live
state. The port's sessions run on the CPU (the kernels' plain versions).

The port has no restore path of its own yet (the JAX package's
fleet/replay.py is ROADMAP.md A10), so the fallback test walks the
generations newest first as that module does.
"""

import copy
import importlib
import json
import os

import pytest

from open_simulator_tpu.testing import make_fake_pod

PKGS = ("open_simulator_tpu", "open_simulator_tpu_torch")
PORT = "open_simulator_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _port_names():
    from open_simulator_tpu_torch.models.workloads import reset_name_counter

    reset_name_counter()
    yield


def _node(name):
    return {"kind": "Node", "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": "8", "memory": "32Gi", "pods": "110"}}}


def _build_cluster(pkg=PORT, pods=8):
    cluster = _mod(pkg, "models.decode").ResourceTypes()
    cluster.nodes = [_node(f"ck-n-{i}") for i in range(3)]
    cluster.pods = [make_fake_pod(f"ck-p{i:02d}", "default", "250m", "512Mi")
                    for i in range(pods)]
    return cluster


def _rig(tmp_path, pkg=PORT, interval=2, keep=2, tag="ckpt"):
    """Serve session + snapshot journal + SYNCHRONOUS manager."""
    sess = _mod(pkg, "serve.session")
    sessions = _mod(pkg, "serve.sessions")
    ck = _mod(pkg, "runtime.checkpoint")
    cluster = _build_cluster(pkg)
    cluster0 = copy.deepcopy(cluster)
    session = sess.Session(cluster, **({"device": "cpu"} if pkg == PORT else {}))
    path = str(tmp_path / f"{tag}.snapshot.jsonl")
    journal = sessions.open_snapshot(path)
    cache = sessions.SessionCache(capacity=2, snapshot=journal)
    mgr = ck.CheckpointManager(
        ck.checkpoint_dir(path), interval=interval, keep=keep,
        capture=lambda: sess.session_checkpoint_state(session),
        materialized_digest=lambda p: sess.verify_payload_digest(session, p),
        journal=journal, keep_record=sessions.serve_keep_record(session.fingerprint),
        label="serve", synchronous=True)
    return session, cluster0, cache, journal, mgr, path


def _evict(pkg, session, cache, mgr, name):
    dl = _mod(pkg, "twin.deltas")
    d = dl.ClusterDelta(kind=dl.POD_EVICT, namespace="default", name=name)
    out, seq = session.apply_delta_seq(d)
    assert out == "applied"
    cache.record_delta(session.fingerprint, d.as_record(), seq=seq)
    mgr.note_delta(seq)
    return seq


def _journal_deltas(path):
    out = []
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            rec = json.loads(line) if line.strip() else {}
            if rec.get("kind") == "session" and rec.get("event") == "delta":
                out.append(rec)
    return out


def _state(pkg, seq=7):
    return _mod(pkg, "runtime.checkpoint").CheckpointState(
        fingerprint="fp-unit", delta_seq=seq, state_digest="digest-unit",
        payload={"nodes": ["a"], "bound": []})


def test_toolchain_digest_and_format_equal_the_jax_package(tmp_path):
    """A generation written by either package loads in the other."""
    jck, pck = (_mod(pkg, "runtime.checkpoint") for pkg in PKGS)
    assert pck.toolchain_digest() == jck.toolchain_digest()
    for writer, reader, tag in ((pck, jck, "p"), (jck, pck, "j")):
        d = str(tmp_path / tag)
        path = writer.write_checkpoint(d, writer.CheckpointState(
            fingerprint="fp", delta_seq=3, state_digest="s", payload={"x": [1, 2]}))
        header, payload = reader.load_checkpoint(path, expect_fingerprint="fp")
        assert header["deltaSeq"] == 3 and payload == {"x": [1, 2]}
    names = sorted(os.listdir(tmp_path / "p")), sorted(os.listdir(tmp_path / "j"))
    assert names[0] == names[1]
    assert (open(tmp_path / "p" / names[0][0], "rb").read()
            == open(tmp_path / "j" / names[1][0], "rb").read())


def test_write_load_roundtrip(tmp_path):
    ck = _mod(PORT, "runtime.checkpoint")
    d = str(tmp_path / "gens")
    path = ck.write_checkpoint(d, _state(PORT))
    assert os.path.basename(path).startswith("gen-0000000007-")
    header, payload = ck.load_checkpoint(path, expect_fingerprint="fp-unit")
    assert header["deltaSeq"] == 7 and header["stateDigest"] == "digest-unit"
    assert header["toolchain"] == ck.toolchain_digest()
    assert payload == {"nodes": ["a"], "bound": []}
    assert ck.list_checkpoints(d) == [(7, path)]


def _tear(path):
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-6])


def _header_only(path):
    raw = open(path, "rb").read()
    open(path, "wb").write(raw.split(b"\n", 1)[0])


def _flip(path):
    raw = bytearray(open(path, "rb").read())
    raw[-4] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _bump_version(path):
    header_line, payload_line = open(path, "rb").read().split(b"\n", 1)
    header = json.loads(header_line)
    header["version"] = 99
    open(path, "wb").write(json.dumps(header).encode() + b"\n" + payload_line)


@pytest.mark.parametrize("damage,kw,match", [
    (_tear, {}, "sha256"),
    (_header_only, {}, "torn checkpoint"),
    (_flip, {}, "sha256"),
    (None, {"expect_toolchain": "deadbeef"}, "toolchain"),
    (None, {"expect_fingerprint": "someone-else"}, "fingerprint"),
    (_bump_version, {}, "version"),
])
def test_untrustworthy_generation_refused_loudly(tmp_path, damage, kw, match):
    ck = _mod(PORT, "runtime.checkpoint")
    path = ck.write_checkpoint(str(tmp_path / "gens"), _state(PORT))
    if damage is not None:
        damage(path)
    with pytest.raises(ck.CheckpointMismatch, match=match):
        ck.load_checkpoint(path, **kw)


def test_prune_ignores_foreign_names_and_clears_tmp_litter(tmp_path):
    ck = _mod(PORT, "runtime.checkpoint")
    d = str(tmp_path / "gens")
    for seq in (3, 5, 9, 11):
        ck.write_checkpoint(d, ck.CheckpointState(
            fingerprint="fp", delta_seq=seq, state_digest="x", payload={"seq": seq}))
    open(os.path.join(d, ".gen-crashed.ckpt.tmp"), "w").close()
    open(os.path.join(d, "README"), "w").close()
    assert len(ck.prune_checkpoints(d, keep=2)) == 2
    assert [s for s, _p in ck.list_checkpoints(d)] == [11, 9]
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert "README" in os.listdir(d)


def test_generation_rotation_and_compaction_equal_the_jax_package(tmp_path):
    """--keep-checkpoints 2 at interval 1 over five evictions: both
    packages keep generations 5 and 4, compact the journal to the suffix
    past the oldest, and write generations of the same state digests."""
    outs = []
    for pkg in PKGS:
        ck = _mod(pkg, "runtime.checkpoint")
        session, _c0, cache, journal, mgr, path = _rig(tmp_path, pkg, interval=1, keep=2,
                                                         tag=pkg)
        for i in range(5):
            _evict(pkg, session, cache, mgr, f"ck-p{i:02d}")
        gens = ck.list_checkpoints(ck.checkpoint_dir(path))
        assert [s for s, _p in gens] == [5, 4]
        assert mgr.writes == 5 and mgr.last_seq == 5 and mgr.compactions >= 1
        assert [r["seq"] for r in _journal_deltas(path)] == [5]
        journal.close()
        outs.append([ck.load_checkpoint(p)[0]["stateDigest"] for _s, p in gens])
        outs.append(session.state_digest())
    assert outs[0] == outs[2] and outs[1] == outs[3]


def test_corrupt_newest_generation_falls_back_to_the_previous_one(tmp_path):
    """Corrupt the newest generation: it is refused loudly, the previous
    one restores (verified against a fresh materialization first), and
    the journal still holds every delta since it, so replaying that
    suffix reaches the live session's state exactly."""
    sess = _mod(PORT, "serve.session")
    ck = _mod(PORT, "runtime.checkpoint")
    dl = _mod(PORT, "twin.deltas")
    session, cluster0, cache, journal, mgr, path = _rig(tmp_path, interval=2, keep=2)
    for i in range(4):
        _evict(PORT, session, cache, mgr, f"ck-p{i:02d}")
    gens = ck.list_checkpoints(ck.checkpoint_dir(path))
    assert [s for s, _p in gens] == [4, 2]
    journal.close()
    _flip(gens[0][1])

    replica = sess.Session(copy.deepcopy(cluster0), device="cpu")
    restored, refused = None, 0
    for seq, gen in gens:
        try:
            header, payload = ck.load_checkpoint(gen, expect_fingerprint=replica.fingerprint)
        except ck.CheckpointMismatch:
            refused += 1
            continue
        cluster = sess.cluster_from_payload(payload)
        assert sess.materialized_state_digest(cluster) == header["stateDigest"]
        replica.restore_state(cluster, header["deltaSeq"])
        restored = seq
        break
    assert refused == 1 and restored == 2
    suffix = [r for r in _journal_deltas(path) if r["seq"] > restored]
    assert [r["seq"] for r in suffix] == [3, 4]
    for rec in suffix:
        replica.apply_delta(dl.ClusterDelta.from_record(rec["delta"]))
    assert replica.delta_seq == session.delta_seq == 4
    assert replica.state_digest() == session.state_digest()
    assert (replica._committed_scan().state_digest()
            == session._committed_scan().state_digest())


def test_manager_validates_inputs(tmp_path):
    ck = _mod(PORT, "runtime.checkpoint")
    from open_simulator_tpu_torch.models.validation import InputError

    for kw in ({"interval": 0}, {"keep": 0}):
        args = dict(interval=1, keep=1, capture=lambda: None,
                    materialized_digest=lambda p: "")
        args.update(kw)
        with pytest.raises(InputError):
            ck.CheckpointManager(str(tmp_path / "g"), **args)
